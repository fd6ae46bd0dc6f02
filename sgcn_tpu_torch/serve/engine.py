"""Partitioned inference engine, full-forward mode (port of
``sgcn_tpu/serve/engine.py``, ``mode='full'``, GCN or GAT, float32, over
the dense a2a exchange or the ragged ring; for GCN the reference's
``halo_dtype`` wire lever).

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

Weights come from a trainer checkpoint (``checkpoint=``, either package's
``.npz``: provenance verified first, then the params read off the leading
leaves through ``utils/checkpoint.py::from_leaves``), from ``params=`` or
from a seeded init.  ``swap_weights`` hot-swaps a new checkpoint in place
— every parameter tensor keeps its storage, so a forward captured once
(CUDA graphs, ROADMAP A20) stays valid — and ``attach_checkpoint_watch``
polls a ``CheckpointManager`` directory once per micro-batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pspmm import narrow_dtype
from ..train.fullbatch import (MODELS, check_param_dims,
                               resolve_forward_setup)
from ..utils.backend import device_name, resolve_device, synchronize
from ..utils.checkpoint import (check_leaves, from_leaves,
                                load_checkpoint_leaves,
                                verify_checkpoint_provenance)
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


class CheckpointWatcher:
    """Poll a ``CheckpointManager`` directory and hot-swap the newest
    INTACT checkpoint into a running engine — the ``--watch-checkpoint-dir``
    machinery: one ``poll`` per micro-batch, corrupt candidates skipped
    with a loud warning (the manager's newest-intact rule), provenance
    mismatches raised loudly (a wrong-plan checkpoint in the watched
    directory is a config bug, not something to serve past)."""

    def __init__(self, directory: str, last_step: int = -1):
        from ..resilience.checkpoint import CheckpointManager

        self.manager = CheckpointManager(directory)
        self.last_step = int(last_step)

    def poll(self, engine) -> bool:
        """Swap in the newest intact checkpoint stamped past ``last_step``;
        returns True when a swap happened.  The swap itself detects
        corruption (``load_checkpoint_leaves`` checksums every array
        BEFORE provenance checking or any engine state change), so each
        candidate is read exactly once."""
        import warnings

        from ..utils.checkpoint import CheckpointCorruptError

        for step, path in reversed(self.manager.checkpoints()):
            if step <= self.last_step:
                return False
            try:
                engine.swap_weights(path)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"checkpoint watch: {path!r} is corrupt ({e}); trying "
                    "the previous candidate", RuntimeWarning, stacklevel=2)
                continue
            self.last_step = step
            return True
        return False


class ServeEngine:
    """Forward-only partitioned inference over one plan + weights."""

    def __init__(
        self,
        plan,
        fin: int,
        widths: list[int],
        model: str = "gcn",
        activation: str | None = None,
        final_activation: str = "none",
        comm_schedule: str | None = None,
        halo_dtype: str | None = None,
        params=None,
        checkpoint: str | None = None,
        max_batch: int = 64,
        buckets: tuple | None = None,
        latency_budget_ms: float = 50.0,
        seed: int = 0,
        device=None,
    ):
        """The reference engine's ``mode='full'``.  ``activation``:
        between layers, ``None`` for the model's own (ReLU for GCN, none
        for GAT, PGAT's bare layers); ``final_activation`` after the last.
        ``checkpoint``: a trainer checkpoint ``.npz`` of either package —
        its plan digest and model config are verified against this
        engine's first, and its params replace ``params``.  ``params``:
        per layer a ``(fin, fout)`` weight (GCN) or a ``{w, a1, a2}`` dict
        (GAT), numpy arrays — e.g. the JAX package's — or tensors;
        ``None`` draws the model's init from a ``torch.Generator`` seeded
        with ``seed``.  ``device``: ``None``
        means ``cuda`` and raises without a GPU; pass ``"cpu"`` to run on
        the CPU.  ``comm_schedule``: ``'a2a'``, ``'ragged'``, ``'auto'``
        or ``None`` (``$SGCN_COMM_SCHEDULE``), resolved as the trainer
        resolves it (``resolve_forward_setup``).  ``halo_dtype``
        (``'bfloat16'``, GCN only): every exchange ships bf16 rows, every
        table and sum stays float32."""
        if halo_dtype is not None and model != "gcn":
            raise ValueError(
                "halo_dtype is a GCN wire lever; the GAT exchange ships "
                "attention tables (same rule as the trainer)")
        narrow_dtype(halo_dtype)
        self.device = resolve_device(device)
        self.plan = plan
        self.fin = int(fin)
        self.widths = list(widths)
        self.model_kind = model
        spec = MODELS.get(model)
        self.activation = (activation if activation is not None
                           else spec.activation if spec is not None
                           else None)
        self.final_activation = final_activation
        self.weights_rev = 0        # bumped by every swap_weights
        self.checkpoint_meta = None
        self._watch = None          # CheckpointWatcher
        # a checkpoint is read and verified before anything is built (the
        # plan's tile layouts included); an unknown model raises below
        leaves = (self._load_leaves(checkpoint)
                  if checkpoint is not None and spec is not None else None)
        self.setup = resolve_forward_setup(plan, model=model,
                                           comm_schedule=comm_schedule)
        self.comm_schedule = self.setup.comm_schedule
        self.halo_dtype = halo_dtype
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
        check_param_dims(params, dims)
        fwd_static = dict(self.setup.fwd_static)
        if halo_dtype is not None:
            fwd_static["halo_dtype"] = halo_dtype
        self.model = self.setup.module(
            params, activation=self.activation,
            final_activation=final_activation,
            fwd_static=fwd_static).to(self.device)
        if leaves is not None:
            from_leaves(leaves, self.model.layer_params())
        self.pa = self.setup.ship_arrays(plan, self.device)
        self._h0 = None                    # set_features()
        self.compile_count = 0             # no per-bucket compile (yet)
        self.forward_count = 0             # full forwards run

    # ------------------------------------------------------------- loading
    def _load_leaves(self, path: str) -> list:
        """The checkpoint's param leaves (Adam state skipped — inference
        has none), after verifying its plan digest and model config and
        checking every param leaf against this engine's dims — a
        wrong-plan or wrong-model file fails with a clear message before
        any engine state changes."""
        leaves, meta = load_checkpoint_leaves(path)
        verify_checkpoint_provenance(
            meta, plan=self.plan, model=self.model_kind, fin=self.fin,
            widths=self.widths, activation=self.activation,
            final_activation=self.final_activation,
            what=f"serve engine ({path!r})")
        dims = list(zip([self.fin] + self.widths[:-1], self.widths))
        template = MODELS[self.model_kind].init_fn(
            torch.Generator().manual_seed(0), dims)
        check_leaves(leaves, template, what=f"checkpoint {path!r}")
        self.checkpoint_meta = meta
        return leaves

    def swap_weights(self, checkpoint: str) -> dict:
        """Hot-swap a new checkpoint into the running engine: provenance
        and shapes are verified FIRST — a mismatch or a corrupt file
        raises before any engine state changes — then the params are
        copied into the live parameter tensors in place (each keeps its
        storage), and ``weights_rev`` goes up by one.  Returns the new
        checkpoint's meta block."""
        leaves = self._load_leaves(checkpoint)
        from_leaves(leaves, self.model.layer_params())
        self.weights_rev += 1
        return self.checkpoint_meta

    def attach_checkpoint_watch(self, directory: str) -> CheckpointWatcher:
        """Watch a ``CheckpointManager`` directory: every micro-batch polls
        once and hot-swaps the newest intact checkpoint stamped past the
        one loaded (CLI: ``--watch-checkpoint-dir``)."""
        last = -1
        if self.checkpoint_meta:
            step = self.checkpoint_meta.get("step")
            if step is not None:        # step 0 is a real stamp, not falsy
                last = int(step)
        self._watch = CheckpointWatcher(directory, last_step=last)
        return self._watch

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
        if self._watch is not None:
            # one poll per micro-batch: a newer intact checkpoint in the
            # watched directory swaps in before this batch dispatches
            self._watch.poll(self)
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
        the reference's report keys where they apply; the wire rows are
        the resolved schedule's (a2a k²·S, ragged k·Σ_d S_d)."""
        wire = self.plan.wire_rows_per_exchange(self.comm_schedule)
        true = int(self.plan.predicted_send_volume.sum())
        return {
            "serve_mode": "full",
            "comm_schedule": self.comm_schedule,
            "halo_dtype": self.halo_dtype,
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
            "weights_rev": self.weights_rev,
            "device": device_name(self.device),
        }
