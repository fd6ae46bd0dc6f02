"""Latency-budgeted dynamic micro-batching with padded size buckets
(copied from ``sgcn_tpu/serve/batcher.py``).

Two flush triggers, whichever fires first:

  * **max-batch** — ``submit`` returns the flushed batch the moment it holds
    ``max_batch`` queries;
  * **deadline** — ``poll(now)`` returns the pending batch once the OLDEST
    pending query has waited ``latency_budget_ms``.

With ``shed_factor`` set, a flushed query whose age already exceeds
``latency_budget_ms × shed_factor`` at dispatch is returned as an explicit
shed marker (``split_shed``) instead of being served; ``None`` never sheds.

Every flush is padded UP to the smallest covering bucket (``bucket_for``) —
the shape discipline the reference needs for its per-bucket compiled
programs and this port keeps for the per-bucket CUDA graphs of a later
slice.  The clock is injected (``clock=``) so deadline behavior is
deterministically testable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Doubling bucket ladder 1, 2, 4, … capped and terminated at
    ``max_batch`` (≤ 2× padding for every batch size)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def pad_pow2(x: int, lo: int = 8) -> int:
    """The same doubling rule for one dynamic dimension: the smallest power
    of two ≥ ``max(x, 1)``, floored at ``lo``.  Sub-graph serving
    (``serve/subgraph.py``) pads its compact row count and query count
    through it, so each dimension takes at most ``log2`` distinct
    values."""
    x = max(int(x), 1)
    out = lo
    while out < x:
        out *= 2
    return out


@dataclass
class Pending:
    """One queued query: global vertex id + the arrival time its latency is
    measured from."""

    qid: int
    t_arrival: float


@dataclass
class MicroBatcher:
    """See module docstring.  ``buckets`` must cover ``max_batch``."""

    max_batch: int = 64
    latency_budget_ms: float = 50.0
    buckets: tuple = None
    clock: object = time.monotonic
    # deadline shedding: shed queries older than budget × shed_factor at
    # dispatch; None = never shed
    shed_factor: float | None = None
    # flush counters — the serve report's batching gauges
    full_flushes: int = 0
    deadline_flushes: int = 0
    shed_count: int = 0
    _pending: list = field(default_factory=list)

    def __post_init__(self):
        if self.buckets is None:
            self.buckets = default_buckets(self.max_batch)
        self.buckets = tuple(sorted(int(b) for b in self.buckets))
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be positive: {self.buckets}")
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} below max_batch "
                f"{self.max_batch} — a full flush would have no bucket "
                "to run in")
        if self.latency_budget_ms < 0:
            raise ValueError(
                f"latency_budget_ms must be >= 0, got "
                f"{self.latency_budget_ms}")
        if self.shed_factor is not None and self.shed_factor < 1:
            raise ValueError(
                f"shed_factor must be >= 1 (shedding below the deadline "
                f"flush itself would drop queries the budget still "
                f"covers), got {self.shed_factor}")

    def bucket_for(self, nqueries: int) -> int:
        """Smallest bucket covering ``nqueries``."""
        for b in self.buckets:
            if b >= nqueries:
                return b
        raise ValueError(
            f"batch of {nqueries} exceeds the largest bucket "
            f"{self.buckets[-1]} (max_batch {self.max_batch})")

    def submit(self, qid: int, t_arrival: float | None = None):
        """Queue one query; returns the flushed batch (list of ``Pending``)
        when this submit fills ``max_batch``, else ``None``."""
        t = self.clock() if t_arrival is None else float(t_arrival)
        self._pending.append(Pending(int(qid), t))
        if len(self._pending) >= self.max_batch:
            self.full_flushes += 1
            return self._take()
        return None

    def next_deadline(self) -> float | None:
        """Absolute clock time the pending head's budget expires (None when
        nothing is pending)."""
        if not self._pending:
            return None
        return self._pending[0].t_arrival + self.latency_budget_ms / 1e3

    def poll(self, now: float | None = None):
        """Deadline flush: the pending batch once the oldest query's wait
        reaches the budget, else ``None``."""
        if not self._pending:
            return None
        now = self.clock() if now is None else float(now)
        if now >= self.next_deadline():
            self.deadline_flushes += 1
            return self._take()
        return None

    def flush(self):
        """Unconditional drain (end of a traffic window); ``None`` if empty.
        Not a deadline flush — counters stay untouched."""
        return self._take() if self._pending else None

    def split_shed(self, batch, now: float | None = None):
        """Partition a flushed batch into ``(dispatch, shed)`` at dispatch
        time (see module docstring)."""
        if self.shed_factor is None or not batch:
            return batch, []
        now = self.clock() if now is None else float(now)
        cutoff = self.latency_budget_ms * self.shed_factor / 1e3
        keep = [p for p in batch if now - p.t_arrival <= cutoff]
        shed = [p for p in batch if now - p.t_arrival > cutoff]
        self.shed_count += len(shed)
        return keep, shed

    def __len__(self) -> int:
        return len(self._pending)

    def _take(self):
        out, self._pending = self._pending, []
        return out
