"""Phase timers and nested spans (port of ``sgcn_tpu/utils/timers.py`` and
the ``SpanTimer`` of ``sgcn_tpu/obs/tracing.py`` that the serve engine
uses).

Host-clock timing: a phase that must include device work passes a
``sync`` callable (``torch.cuda.synchronize`` on the card), run after the
body and inside the timed window.  ``totals`` holds SELF time — a child
phase's time is attributed to the child only — and ``inclusive`` the wall
time per name, counting a name re-entered under itself once.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)   # SELF time
        self.counts: dict[str, int] = defaultdict(int)
        self.inclusive: dict[str, float] = defaultdict(float)
        self._stack: list[list] = []     # [name, accumulated child seconds]

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; ``sync`` (zero-arg callable) runs after the body,
        inside the window, so queued device work is counted."""
        frame = [name, 0.0]
        self._stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            try:
                if sync is not None:
                    sync()
            finally:
                dt = time.perf_counter() - t0
                self._stack.pop()
                self.totals[name] += dt - frame[1]
                self.counts[name] += 1
                if all(f[0] != name for f in self._stack):
                    self.inclusive[name] += dt
                if self._stack:
                    self._stack[-1][1] += dt

    def inclusive_total(self, name: str) -> float:
        """Wall seconds spent inside phase ``name``, nested phases
        included."""
        return self.inclusive[name]

    def report(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "avg_s": self.totals[name] / max(self.counts[name], 1),
                   "inclusive_s": self.inclusive[name]}
            for name in self.totals
        }


class SpanTimer:
    """Named nested spans over a shared ``PhaseTimer`` (the engine's
    ``serve:*`` stages)."""

    def __init__(self, timer: PhaseTimer | None = None):
        self.timer = timer if timer is not None else PhaseTimer()

    def span(self, name: str, sync=None):
        return self.timer.phase(name, sync=sync)
