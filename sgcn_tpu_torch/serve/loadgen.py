"""Synthetic closed/open-loop query traffic over a ``ServeEngine`` (copied
from ``sgcn_tpu/serve/loadgen.py``).

  * **open loop** (``offered_qps > 0``): queries arrive on a fixed schedule
    ``t_i = t0 + i/qps`` regardless of how fast the server drains them;
    latency is measured from the SCHEDULED arrival, so queue time counts.
  * **closed loop** (``offered_qps`` None/0): the next query is submitted as
    soon as the batcher accepts it — the saturation probe.

The loop submits on arrival, executes on a max-batch flush, and sleeps
toward whichever comes first of the next arrival and the pending head's
deadline.  An OPEN-loop tail still deadline-flushes; a CLOSED-loop tail
drains immediately.  Clock/sleep are injectable for deterministic tests.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


def synthetic_query_ids(n: int, count: int, seed: int = 0,
                        skew: float = 0.0) -> np.ndarray:
    """``count`` query vertex ids over ``[0, n)``.  ``skew=0`` is uniform;
    ``skew>0`` draws from a Zipf-like power law over a random vertex
    permutation."""
    rng = np.random.default_rng(seed)
    if skew <= 0:
        return rng.integers(0, n, size=count, dtype=np.int64)
    ranks = rng.permutation(n)
    weights = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** skew
    weights /= weights.sum()
    return ranks[rng.choice(n, size=count, p=weights)].astype(np.int64)


@dataclass
class ServeResult:
    """Measured outcome of one traffic window.  ``shed`` counts queries
    returned as shed markers; they appear in no latency quantile."""

    latencies_ms: list = field(default_factory=list)
    window_s: float = 0.0
    batches: int = 0
    batch_sizes: list = field(default_factory=list)
    shed: int = 0

    @property
    def queries(self) -> int:
        return len(self.latencies_ms)

    @property
    def achieved_qps(self) -> float:
        return self.queries / self.window_s if self.window_s > 0 else 0.0

    @property
    def mean_batch(self) -> float:
        return (sum(self.batch_sizes) / len(self.batch_sizes)
                if self.batch_sizes else 0.0)

    def _pct(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))

    @property
    def p50_ms(self) -> float:
        return self._pct(50)

    @property
    def p95_ms(self) -> float:
        return self._pct(95)

    @property
    def p99_ms(self) -> float:
        return self._pct(99)

    def summary(self) -> dict:
        out = {
            "queries": self.queries,
            "window_s": round(self.window_s, 6),
            "achieved_qps": round(self.achieved_qps, 3),
            "latency_p50_ms": round(self.p50_ms, 3),
            "latency_p95_ms": round(self.p95_ms, 3),
            "latency_p99_ms": round(self.p99_ms, 3),
            "batches": self.batches,
            "mean_batch": round(self.mean_batch, 3),
        }
        if self.shed:
            out["shed"] = self.shed
        return out


def run_loadgen(engine, qids, offered_qps: float | None = None,
                clock=time.monotonic, sleep=time.sleep,
                concurrent: bool = False) -> ServeResult:
    """Drive ``engine`` (and its batcher) through ``qids``; see the module
    docstring for the open/closed-loop semantics.

    ``concurrent=True``: double-buffered dispatch — batch t+1 is submitted
    (``engine.submit``) before batch t's result is consumed; at most one
    batch waits behind the current one, results are consumed in order,
    and a query's latency ends when ITS batch's result is consumed."""
    qids = np.asarray(qids, dtype=np.int64).reshape(-1)
    batcher = engine.batcher
    res = ServeResult()
    t0 = clock()
    inflight: list = []                  # [(handle, batch)] — ≤ 1 deep

    def account(batch):
        done = clock()
        for p in batch:
            res.latencies_ms.append((done - p.t_arrival) * 1e3)
        res.batches += 1
        res.batch_sizes.append(len(batch))

    def resolve_one():
        handle, batch = inflight.pop(0)
        handle.result()
        account(batch)

    def execute(batch):
        if not batch:
            return
        batch, shed = batcher.split_shed(batch, clock())
        res.shed += len(shed)
        if not batch:
            return
        if not concurrent:
            engine.query([p.qid for p in batch])
            account(batch)
            return
        spans = getattr(engine, "spans", None)
        cm = (spans.span("serve:overlap") if spans is not None and inflight
              else contextlib.nullcontext())
        with cm:
            handle = engine.submit([p.qid for p in batch])
        inflight.append((handle, batch))
        if len(inflight) > 1:
            resolve_one()

    i = 0
    total = len(qids)
    while i < total or len(batcher):
        now = clock()
        next_arrival = (t0 + i / offered_qps if (offered_qps and i < total)
                        else (now if i < total else None))
        deadline = batcher.next_deadline()
        if next_arrival is not None and (deadline is None
                                         or next_arrival <= deadline):
            if next_arrival > now:
                sleep(next_arrival - now)
            batch = batcher.submit(int(qids[i]), t_arrival=next_arrival)
            i += 1
            execute(batch)
        elif deadline is not None and offered_qps:
            # open-loop tail (or an arrival gap): the budget is still the
            # flush trigger — the server cannot know the trace ended
            if deadline > now:
                sleep(deadline - now)
            execute(batcher.poll(clock()))
        elif deadline is not None:
            # closed-loop tail: no future arrival can fill the batch, so
            # drain now (ordinary flush — not a deadline miss)
            execute(batcher.flush())
        else:                            # i == total, nothing pending
            break
    while inflight:                      # drain the double-buffer tail
        resolve_one()
    res.window_s = clock() - t0
    return res
