"""Preemption tolerance: durable checkpoints, bit-identical resume, faults
(port of ``sgcn_tpu/resilience``).

  * ``atomic``      — temp + fsync + rename write discipline (checkpoints
    ride it);
  * ``checkpoint``  — ``CheckpointManager``: step-stamped directory,
    keep-last-K rotation, newest-INTACT discovery with corruption fallback;
  * ``runner``      — ``run_resumable``: the per-step training loop behind
    ``--checkpoint-every`` / ``--resume auto``, with the kill point where
    fault injection lands;
  * ``faults``      — deterministic env-driven fault injection
    (kill-after-save, corrupt-after-save, stall) + the stalled-vs-slow
    heartbeat classifier.

Attribute access is lazy (PEP 562) so importing
``sgcn_tpu_torch.resilience`` never drags in the trainer stack —
``utils/checkpoint.py`` imports ``resilience.atomic`` from inside the
package and an eager ``__init__`` would cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "atomic_write": ".atomic",
    "atomic_write_json": ".atomic",
    "CheckpointManager": ".checkpoint",
    "run_resumable": ".runner",
    "save_and_record": ".runner",
    "FaultSpec": ".faults",
    "FAULT_EXIT_CODE": ".faults",
    "parse_fault": ".faults",
    "active_fault": ".faults",
    "after_checkpoint_save": ".faults",
    "corrupt_file": ".faults",
    "maybe_stall": ".faults",
    "classify_stall": ".faults",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
