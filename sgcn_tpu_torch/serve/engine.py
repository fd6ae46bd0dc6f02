"""Partitioned inference engine, full-forward mode (port of
``sgcn_tpu/serve/engine.py``, ``mode='full'``, GCN, a2a, float32).

Each micro-batch runs the whole partitioned forward over the ``k`` parts
stacked on one device — halo exchange, tile SpMM, projection, activation
per layer — and then gathers the queried rows.  Query path per batch
(host stages spanned through ``SpanTimer``):

  * ``serve:route``   — global vertex ids → (owner, local slot) through the
    ``VertexRouter``;
  * ``serve:batch``   — pad the batch up to its bucket (owner −1 on
    padding) and copy the index vectors to the device;
  * ``serve:forward`` — wait for the forward and copy the ``(Q, nout)``
    rows back.  Kernels are queued asynchronously, so the device time of
    the forward lands in this span.

The reference's in-program gather (take + owner mask + ``psum`` across
chips) is, over the stacked ``(k, B, nout)`` logits, one advanced index
``logits[q_owner, q_local]``; padding slots are masked to zeros.  There is
no per-bucket compile (``compile_count`` stays 0); capturing one CUDA
graph per bucket is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gcn import GCN
from ..train.fullbatch import resolve_forward_setup
from ..utils.backend import device_name, resolve_device, synchronize
from ..utils.timers import PhaseTimer, SpanTimer
from .batcher import MicroBatcher, default_buckets
from .router import VertexRouter

SERVE_STAGES = ("serve:route", "serve:batch", "serve:forward",
                "serve:overlap")


class InFlightBatch:
    """Handle of one dispatched micro-batch: the forward is queued on the
    device; ``result()`` waits for it and slices off the bucket padding."""

    def __init__(self, engine, out, nq: int):
        self._engine = engine
        self._out = out
        self._nq = nq

    def result(self) -> np.ndarray:
        with self._engine.spans.span("serve:forward"):
            out = self._out.cpu().numpy()       # device → host copy waits
        return out[: self._nq]


class ServeEngine:
    """Forward-only partitioned inference over one plan + weights."""

    def __init__(
        self,
        plan,
        fin: int,
        widths: list[int],
        model: str = "gcn",
        comm_schedule: str | None = None,
        params=None,
        max_batch: int = 64,
        buckets: tuple | None = None,
        latency_budget_ms: float = 50.0,
        seed: int = 0,
        device=None,
    ):
        """The reference engine's ``mode='full'`` with its GCN defaults:
        ReLU between layers, no activation after the last.
        ``params``: a list of ``(fin, fout)`` weights (numpy arrays —
        e.g. the JAX package's — or tensors); ``None`` draws Glorot
        weights from a ``torch.Generator`` seeded with ``seed``.
        ``device``: ``None`` means ``cuda`` and raises without a GPU;
        pass ``"cpu"`` to run on the CPU.  ``model``/``comm_schedule``
        other than GCN/a2a raise "not ported yet"."""
        self.device = resolve_device(device)
        self.plan = plan
        self.fin = int(fin)
        self.widths = list(widths)
        self.setup = resolve_forward_setup(plan, model=model,
                                           comm_schedule=comm_schedule)
        self.comm_schedule = self.setup.comm_schedule
        self.router = VertexRouter(plan)
        self.batcher = MicroBatcher(
            max_batch=max_batch,
            latency_budget_ms=latency_budget_ms,
            buckets=buckets if buckets is not None
            else default_buckets(max_batch))
        self.timer = PhaseTimer()
        self.spans = SpanTimer(timer=self.timer)

        dims = list(zip([self.fin] + self.widths[:-1], self.widths))
        if params is None:
            params = self.setup.init_fn(torch.Generator().manual_seed(seed),
                                        dims)
        if [tuple(w.shape) for w in params] != dims:
            raise ValueError(
                f"param shapes {[tuple(w.shape) for w in params]} != "
                f"layer dims {dims}")
        self.model = GCN(params,
                         fwd_static=self.setup.fwd_static).to(self.device)
        self.pa = self.setup.ship_arrays(plan, self.device)
        self._h0 = None                    # set_features()
        self.compile_count = 0             # no per-bucket compile (yet)
        self.forward_count = 0             # full forwards run

    # ------------------------------------------------------------ features
    def set_features(self, features: np.ndarray) -> None:
        """Scatter the global ``(n, fin)`` feature rows to the stacked
        ``(k, B, fin)`` layout on the device, once."""
        features = np.asarray(features, dtype=np.float32)
        if features.shape != (self.plan.n, self.fin):
            raise ValueError(
                f"features shape {features.shape} != "
                f"({self.plan.n}, {self.fin})")
        self._h0 = torch.as_tensor(self.plan.scatter_rows(features)).to(
            self.device)

    # --------------------------------------------------------------- query
    def forward(self):
        """One full partitioned forward: ``(k, B, nout)`` float32 logits,
        queued on the device."""
        if self._h0 is None:
            raise ValueError(
                "no features loaded — call set_features(features) before "
                "serving queries")
        with torch.inference_mode():
            out = self.model(self._h0, self.pa)
        self.forward_count += 1
        return out

    def submit(self, qids) -> InFlightBatch:
        """Dispatch one micro-batch without waiting: route and pad on the
        host, queue the forward and the query gather on the device; the
        handle's ``result()`` waits."""
        qids = np.asarray(qids, dtype=np.int64).reshape(-1)
        nq = len(qids)
        if nq == 0:
            return InFlightBatch(
                self, torch.zeros((0, self.widths[-1])), 0)
        with self.spans.span("serve:route"):
            owners, locals_ = self.router.lookup(qids)
        with self.spans.span("serve:batch"):
            bucket = self.batcher.bucket_for(nq)
            q_owner = np.full(bucket, -1, np.int64)   # pad: matches no part
            q_local = np.zeros(bucket, np.int64)
            q_owner[:nq] = owners
            q_local[:nq] = locals_
            q_owner = torch.as_tensor(q_owner).to(self.device)
            q_local = torch.as_tensor(q_local).to(self.device)
        logits = self.forward()
        sel = logits[q_owner.clamp(min=0), q_local]          # (Q, nout)
        out = torch.where((q_owner >= 0)[:, None], sel, 0.0)
        return InFlightBatch(self, out, nq)

    def query(self, qids) -> np.ndarray:
        """Serve one micro-batch of global vertex ids → ``(len(qids),
        nout)`` float32 logits."""
        return self.submit(qids).result()

    def warmup(self, qids) -> None:
        """Serve one throwaway batch per bucket (cycling ``qids``): the
        first launch builds the kernel and initializes the device, which
        must not land in a measured window."""
        qids = np.asarray(qids, dtype=np.int64).reshape(-1)
        if qids.size == 0:
            raise ValueError("warmup needs at least one query id")
        for b in self.batcher.buckets:
            self.query(np.resize(qids, b))
        synchronize(self.device)

    # -------------------------------------------------------------- gauges
    @property
    def nlayers(self) -> int:
        return len(self.widths)

    def gauges(self) -> dict:
        """Plan-derived per-batch gauges of the full-forward mode, under
        the reference's report keys where they apply."""
        wire = self.plan.wire_rows_per_exchange(self.comm_schedule)
        true = int(self.plan.predicted_send_volume.sum())
        return {
            "serve_mode": "full",
            "comm_schedule": self.comm_schedule,
            "exchanges_per_batch": self.nlayers,
            "wire_rows_per_exchange": wire,
            "true_rows_per_exchange": true,
            "wire_rows_per_batch": self.nlayers * wire,
            "wire_rows_per_query": round(
                self.nlayers * wire / self.batcher.max_batch, 6),
            "full_rows_per_forward": int(self.plan.k * self.plan.b),
            "buckets": list(self.batcher.buckets),
            "compiles": self.compile_count,
            "forwards": self.forward_count,
            "device": device_name(self.device),
        }
