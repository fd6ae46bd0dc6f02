"""Adaptive communication controller — the run-time half of
``--comm-schedule auto`` (port of ``sgcn_tpu/train/controller.py``,
unchanged in behaviour).

``parallel/plan.py::resolve_comm_schedule`` picks the transport at plan
time; this module retunes the EFFECTIVE ``--sync-every`` while the run
goes.  The stale trainer measures each layer's drift at every sync step
(the relative RMS of the fresh exchange against the stale carry it
replaces) and the controller moves the sync interval against a
hysteresis band:

  * measured relative drift above ``upper`` → halve the interval (more
    exact steps, floored at ``min_sync``);
  * below ``lower`` → double it (fewer exposed full exchanges, capped at
    ``max_sync``);
  * in between → hold.

Decisions are deterministic in the gauge sequence (no clock, no
randomness), and each retune is logged with its inputs; the trainer keeps
the log in ``comm_decision["controller"]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# default band on the max-over-layers relative drift RMS (the reference's
# values, chosen from its cora-scale runs: healthy stale runs measure
# 1e-2..1e-1); both ends are overridable
DEFAULT_UPPER = 0.5
DEFAULT_LOWER = 0.02


@dataclass
class CommController:
    """Drift-banded ``sync_every`` retuner (see the module docstring).

    ``observe(step, drift_rel_max)`` is the whole run-time surface: called
    at each NON-initializing sync step with the measured max-over-layers
    relative drift, it returns the sync interval to use from that step on.
    """

    sync_every: int                      # current target (mutated)
    upper: float = DEFAULT_UPPER
    lower: float = DEFAULT_LOWER
    min_sync: int = 1
    max_sync: int = 256
    decisions: list = field(default_factory=list)

    def __post_init__(self):
        if self.sync_every < 1:
            raise ValueError(
                f"the controller retunes a periodic sync schedule; "
                f"sync_every must be >= 1, got {self.sync_every}")
        if not (0 <= self.lower < self.upper):
            raise ValueError(
                f"need 0 <= lower < upper, got [{self.lower}, {self.upper}]")
        self.initial_sync_every = self.sync_every

    def observe(self, step: int, drift_rel_max: float) -> int:
        """One sync-step observation → the (possibly retuned) interval."""
        old = self.sync_every
        if drift_rel_max > self.upper:
            new, rule = max(self.min_sync, old // 2), "drift above band"
        elif drift_rel_max < self.lower:
            new, rule = min(self.max_sync, old * 2), "drift below band"
        else:
            new, rule = old, "inside band"
        if new != old:
            self.decisions.append({
                "step": int(step),
                "drift_rel_max": float(drift_rel_max),
                "band": [float(self.lower), float(self.upper)],
                "rule": rule,
                "sync_every": [int(old), int(new)],
            })
            self.sync_every = new
        return self.sync_every

    def log(self) -> dict:
        """The ``comm_decision['controller']`` block."""
        return {
            "kind": "drift-banded sync_every retune",
            "band": [float(self.lower), float(self.upper)],
            "initial_sync_every": int(self.initial_sync_every),
            "sync_every": int(self.sync_every),
            "retunes": list(self.decisions),
        }

    # ----------------------------------------------------- checkpoint state
    def state(self) -> dict:
        """JSON-able resume state: the effective interval and the retune
        log (a resumed run keeps every retune it already paid for)."""
        return {
            "sync_every": int(self.sync_every),
            "initial_sync_every": int(self.initial_sync_every),
            "decisions": list(self.decisions),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state()``; the retune log keeps accumulating across
        the resume seam."""
        self.sync_every = int(state["sync_every"])
        self.initial_sync_every = int(state.get("initial_sync_every",
                                                self.initial_sync_every))
        self.decisions = list(state.get("decisions", []))
