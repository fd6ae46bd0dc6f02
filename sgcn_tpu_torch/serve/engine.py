"""Partitioned inference engine (port of ``sgcn_tpu/serve/engine.py``):
GCN or GAT, float32, over the dense a2a exchange or the ragged ring; for
GCN the reference's ``halo_dtype`` wire lever.

``mode='full'``: each micro-batch runs the whole partitioned forward over
the ``k`` parts stacked on one device — halo exchange, tile SpMM,
projection, activation per layer — and then gathers the queried rows.
``mode='subgraph'``: each micro-batch computes only the routed queries'
L-hop receptive rows (``serve/subgraph.py``), with no exchange, on the
same kernels — one fused-entry launch per GCN layer, K5 per GAT pass.
Query path per batch (host stages spanned through ``SpanTimer``):

  * ``serve:route``   — global vertex ids → (owner, local slot) through the
    ``VertexRouter``; in sub-graph mode also the receptive sets and the
    compact layout (``build_batch``, numpy);
  * ``serve:batch``   — pad the batch up to its bucket (owner −1 on
    padding) and copy the index vectors (sub-graph mode: the compact
    tiles) to the device;
  * ``serve:forward`` — wait for the forward and copy the ``(Q, nout)``
    rows back.  Kernels are queued asynchronously, so the device time of
    the forward lands in this span.

The reference's in-program gather (take + owner mask + ``psum`` across
chips) is, over the stacked ``(k, B, nout)`` logits, one advanced index
``logits[q_owner, q_local]``; padding slots are masked to zeros (with a
``where``: a sub-graph batch's outer-shell rows are not meant to be
read).  There is no per-bucket compile (``compile_count`` stays 0);
capturing one CUDA graph per bucket is a later slice.  A GAT sub-graph
engine keeps the per-layer softmax stabilizers of the full graph, from one
full forward per feature load or weight swap (``_refresh_stabilizers``).

Weights come from a trainer checkpoint (``checkpoint=``, either package's
``.npz``: provenance verified first, then the params read off the leading
leaves through ``utils/checkpoint.py::from_leaves``), from ``params=`` or
from a seeded init.  ``swap_weights`` hot-swaps a new checkpoint in place
— every parameter tensor keeps its storage, so a forward captured once
(CUDA graphs, ROADMAP A20) stays valid — and ``attach_checkpoint_watch``
polls a ``CheckpointManager`` directory once per micro-batch.

``mesh`` (a ``parallel/mesh.py::RankGroup``) serves one part per process,
the reference's k-chip mesh (``sgcn_tpu/serve/engine.py:186, 206-207``):
each rank holds its slice of the plan (``parallel/proxy.py``) and its
part's feature rows, the params replicated.  Rank 0 is the front: it alone
owns the batcher, the deadlines, shedding, the checkpoint watcher and the
recorder.  Per dispatched batch every rank issues the same collectives in
the same order: a header broadcast from rank 0 (``action``, bucket, query
count, the swap path's length, whether to measure memory), the swap path
if any, the padded query ids, the forward with its exchanges, and one
all-gather of every rank's ``(Q, nout)`` rows, each masked with a
``where`` to the queries its part owns.  Rank 0 then selects each query's
row from its owner's contribution: a gather, not a sum, so every bit of
the owner's row (the sign of a zero included) reaches the caller.  The
other ranks run ``follow()`` until rank 0's ``close()`` sends the stop
header.  The gather is issued with its batch, so ``--concurrent``'s
batch t+1 header follows batch t's gather on every rank alike.

``memory_budget`` holds the mode's analytic device footprint
(``obs/memory.py``) to a byte budget before any tensor ships; ``warmup``
measures the widest bucket's batch on the card against it.
``attach_recorder`` writes the ``serve:*`` spans, one ``serve`` event per
``record_window``, a ``swap`` event per hot swap and the memory block.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs.memory import (check_memory_budget, device_bytes,
                          measure_device_step, memory_model, reconcile)
from ..obs.tracing import SpanTimer
from ..ops.pspmm import narrow_dtype
from ..parallel.proxy import shard_proxy_plan
from ..train.fullbatch import (MODELS, check_param_dims, check_rank_levers,
                               resolve_forward_setup)
from ..utils.backend import device_name, resolve_device, synchronize
from ..utils.checkpoint import (check_leaves, from_leaves,
                                load_checkpoint_leaves,
                                verify_checkpoint_provenance)
from ..utils.timers import PhaseTimer
from .batcher import MicroBatcher, default_buckets
from .router import VertexRouter
from .subgraph import (SubgraphIndex, build_batch, subgraph_forward_gat,
                       subgraph_forward_gcn)

SERVE_STAGES = ("serve:route", "serve:batch", "serve:forward",
                "serve:overlap")

# the rank batch protocol's header: (action, bucket, query count, swap
# path bytes, measure the batch's memory); GAUGES all-reduces the sub-graph
# totals, STOP ends every follower's loop
HEADER_LEN = 5
SERVE, SWAP, STOP, GAUGES = 0, 1, 2, 3


class InFlightBatch:
    """Handle of one dispatched micro-batch: the forward is queued on the
    device; ``result()`` waits for it and slices off the bucket padding.
    ``finish`` (on a rank group): waits on the batch's row gather and
    selects each query's row from its owner's contribution."""

    def __init__(self, engine, out, nq: int, finish=None):
        self._engine = engine
        self._out = out
        self._nq = nq
        self._finish = finish

    def result(self) -> np.ndarray:
        with self._engine.spans.span("serve:forward"):
            if self._finish is not None:
                self._out, self._finish = self._finish(), None
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

    def pick(self):
        """``(step, path, loaded)`` of the newest INTACT checkpoint stamped
        past ``last_step`` (``loaded``: its ``load_checkpoint_leaves``,
        every array checksummed), or ``None``; corrupt candidates are
        skipped with the warning.  Each candidate is read exactly once;
        provenance is the swap's to verify."""
        import warnings

        from ..utils.checkpoint import CheckpointCorruptError

        for step, path in reversed(self.manager.checkpoints()):
            if step <= self.last_step:
                return None
            try:
                loaded = load_checkpoint_leaves(path)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"checkpoint watch: {path!r} is corrupt ({e}); trying "
                    "the previous candidate", RuntimeWarning, stacklevel=3)
                continue
            return step, path, loaded
        return None

    def poll(self, engine) -> bool:
        """Swap the newest intact checkpoint stamped past ``last_step``
        into ``engine`` (``pick``); returns True when a swap happened.  A
        provenance mismatch raises before any engine state changes.  On a
        rank group rank 0 picks and every rank swaps
        (``ServeEngine.submit``)."""
        got = self.pick()
        if got is None:
            return False
        step, path, loaded = got
        engine._swap(path, loaded)
        self.last_step = step
        return True


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
        shed_factor: float | None = None,
        seed: int = 0,
        device=None,
        mode: str = "full",
        memory_budget: int | None = None,
        mesh=None,
    ):
        """The reference engine.  ``mode``: ``'full'`` (one full
        partitioned forward per micro-batch) or ``'subgraph'`` (the routed
        queries' L-hop receptive rows only; a GCN plan must be symmetric).
        ``shed_factor``: the batcher's deadline shedding (``None``: never
        shed).  ``activation``:
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
        table and sum stays float32.  ``memory_budget`` (bytes):
        ``MemoryBudgetError`` before any tensor ships when the mode's
        analytic device footprint (``self.memory``) exceeds it.

        ``mesh`` (a ``parallel/mesh.py::RankGroup``): one process per
        part (module docstring).  Rank ``r`` of a ``k``-rank group serves
        part ``r`` of the full k-way ``plan`` (every rank builds the plan,
        the layouts are built on it and the rank keeps its slice,
        ``self.full_plan`` the whole); every rank constructs the engine
        and calls ``set_features`` alike, then rank 0 serves
        (``submit``, ``query``, ``warmup``, ``swap_weights``,
        ``attach_checkpoint_watch``, ``gauges``) while the others run
        ``follow()``, and rank 0's caller ends with ``close()``, also on
        an exception.  A one-rank group takes a one-part slice as ``plan``
        (``parallel/proxy.py``, the proxy of one card) and serves only the
        queries its part owns: a batch naming another part's vertex raises
        before anything ships (so does the stacked engine on a slice).
        Full mode (GCN and GAT, both transports, ``halo_dtype``) and
        sub-graph mode (each rank lays out its own part's receptive rows,
        ``build_batch(parts=...)``; the full k-way plan only).  A
        checkpoint's provenance is verified against the full plan on
        every rank; a swap loads on every rank before the batch its
        header announces.  ``device`` defaults to the group's.
        ``SGCN_PALLAS_SPMM=0`` serves full mode on the ELL aggregator
        over each rank's slice's chains (GCN on both transports and the
        bf16 wire, GAT on both transports; ROADMAP A2d); sub-graph mode
        raises ``ELL_MODE_DEFERRAL`` under it, as stacked."""
        if mesh is not None:
            check_rank_levers(plan, mesh)
        if mode == "subgraph" and plan.chip_ids is not None:
            raise ValueError(
                "sub-graph serving indexes the receptive sets of the full "
                "k-way plan; a one-part slice has none of its own — give "
                "the full plan (on a rank group every rank serves its "
                "part of it)")
        if halo_dtype is not None and model != "gcn":
            raise ValueError(
                "halo_dtype is a GCN wire lever; the GAT exchange ships "
                "attention tables (same rule as the trainer)")
        if mode not in ("full", "subgraph"):
            raise ValueError(f"unknown serve mode {mode!r} "
                             "(know 'full', 'subgraph')")
        narrow_dtype(halo_dtype)
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.mesh = mesh
        self.mode = mode
        # sub-graph serving state; the index refuses a GCN asymmetric plan
        self.sgindex = (SubgraphIndex(plan, model) if mode == "subgraph"
                        else None)
        self.full_plan = plan
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
        self.setup = resolve_forward_setup(
            plan, model=model, comm_schedule=comm_schedule,
            ranks=mesh is not None, serve_subgraph=mode == "subgraph")
        self.comm_schedule = self.setup.comm_schedule
        self.comm_decision = self.setup.decision
        if mesh is not None and plan.chip_ids is None:
            # the layouts were built on the full plan (above); the rank
            # keeps its part's slice
            plan = self.plan = shard_proxy_plan(plan, mesh.rank)
            self.setup = self.setup.on_slice(plan)
        # the parts this process holds, and each part's place in what the
        # forward returns: the stacked (k, B) layout, a slice's one part,
        # or on a k-rank group the rank that holds it (the row gather's
        # order); -1 for a part held nowhere here
        self.parts = (list(range(plan.k)) if plan.chip_ids is None
                      else [int(c) for c in plan.chip_ids])
        nparts = int(np.asarray(plan.send_idx).shape[1])
        self._part_pos = np.full(nparts, -1, np.int64)
        if mesh is not None and self.full_plan.chip_ids is None:
            self._part_pos[:] = np.arange(nparts)
        else:
            self._part_pos[self.parts] = np.arange(len(self.parts))
        self._closed = False           # rank 0 sent the stop header
        self._measure_next = False     # the next header asks a measure
        self._failed = False           # a collective batch raised here
        self._sg_synced = None         # GAUGES' all-reduced totals
        # the analytic footprint and the --memory-budget gate, before any
        # tensor ships; the allocator's state now is the measured side's
        # zero (obs/memory.py)
        self.memory = memory_model(
            plan, fin, widths,
            workload="serve_subgraph" if mode == "subgraph" else "serve",
            model=model, halo_dtype=halo_dtype, setup=self.setup,
            ranks=mesh is not None)
        check_memory_budget(self.memory, memory_budget,
                            what=f"{model} serve engine ({mode})")
        self._mem_base = device_bytes(self.device)
        self.memory_join = None        # reconcile() of the widest bucket
        self.recorder = None           # attach_recorder
        self.halo_dtype = halo_dtype
        self.router = VertexRouter(self.full_plan)
        self.batcher = MicroBatcher(
            max_batch=max_batch,
            latency_budget_ms=latency_budget_ms,
            buckets=buckets if buckets is not None
            else default_buckets(max_batch),
            shed_factor=shed_factor)
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
        if mesh is not None:
            fwd_static["mesh"] = mesh
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
        self._feats = None                 # (n + 1, fin): set_features()
        self._stabilizers = None           # GAT per-layer cg (L,), device
        self._sg_keys = set()              # sub-graph shape keys served
        self._sg_totals = {"queries": 0, "batches": 0, "touched_rows": 0,
                           "recipe_edges": 0, "wire_rows": 0, "flops": 0}

    # ------------------------------------------------------------- loading
    def _load_leaves(self, path: str, loaded=None) -> list:
        """The checkpoint's param leaves (Adam state skipped — inference
        has none), after verifying its plan digest (the full plan's, on a
        rank group) and model config and checking every param leaf
        against this engine's dims — a wrong-plan or wrong-model file
        fails with a clear message before any engine state changes.
        ``loaded``: the file's ``load_checkpoint_leaves``, if read
        already."""
        leaves, meta = (loaded if loaded is not None
                        else load_checkpoint_leaves(path))
        verify_checkpoint_provenance(
            meta, plan=self.full_plan, model=self.model_kind, fin=self.fin,
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
        checkpoint's meta block.  On a rank group rank 0 calls it: a
        header with the path and no queries makes every rank swap (a
        mismatch raises on every rank alike)."""
        if self.mesh is None:
            return self._swap(checkpoint)
        self._front("swap_weights")
        self._lead_batch(SWAP, np.zeros(0, np.int64), checkpoint)
        return self.checkpoint_meta

    def _swap(self, checkpoint: str, loaded=None) -> dict:
        """``swap_weights`` on this process alone (``loaded``: the file's
        leaves, if read already)."""
        t0 = time.perf_counter()
        leaves = self._load_leaves(checkpoint, loaded)
        from_leaves(leaves, self.model.layer_params())
        self.weights_rev += 1
        if self._stabilizers is not None:
            self._refresh_stabilizers()
        if self.recorder is not None:
            self.recorder.record_swap(
                path=checkpoint, weights_rev=self.weights_rev,
                checkpoint_step=self.checkpoint_meta.get("step"),
                wall_s=time.perf_counter() - t0)
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
        ``(k, B, fin)`` layout on the device, once (a slice: its part's
        ``(1, B, fin)`` rows).  On a rank group every rank calls it (a GAT
        sub-graph engine's stabilizer refresh is collective)."""
        features = np.asarray(features, dtype=np.float32)
        if features.shape != (self.plan.n, self.fin):
            raise ValueError(
                f"features shape {features.shape} != "
                f"({self.plan.n}, {self.fin})")
        # a slice (a rank's, a proxy's) keeps its own part's rows: (1, B)
        chips = None if self.plan.chip_ids is None else self.parts
        self._h0 = torch.as_tensor(self.plan.scatter_rows(
            features, chips=chips)).to(self.device)
        if self.mode == "subgraph":
            # the receptive rows' features are gathered on the device; row
            # n (zeros) feeds the pad rows and the dump row
            self._feats = torch.as_tensor(np.concatenate(
                [features, np.zeros((1, self.fin), np.float32)])).to(
                    self.device)
            if self.model_kind == "gat":
                self._refresh_stabilizers()

    # ------------------------------------------------- GAT stabilizer cache
    def _refresh_stabilizers(self) -> None:
        """The per-layer softmax stabilizers ``cg`` of the FULL graph under
        the current weights and features — the one full-graph quantity the
        compact GAT forward takes as an input
        (``gat_forward_local(collect_stabilizers=True)``): one full forward
        per feature load or weight swap, amortized over every query served
        from it; counted in ``forward_count``."""
        from ..models.gat import gat_forward_local

        with torch.inference_mode():
            _, self._stabilizers = gat_forward_local(
                self.model.layer_params(), self._h0, self.pa,
                activation=self.activation,
                final_activation=self.final_activation,
                collect_stabilizers=True, **self.model.fwd_static)
        self.forward_count += 1

    # --------------------------------------------------------------- query
    def forward(self):
        """One full partitioned forward: ``(k, B, nout)`` float32 logits,
        queued on the device (on a rank group the rank's ``(1, B, nout)``,
        its exchanges collective)."""
        if self._h0 is None:
            raise ValueError(
                "no features loaded — call set_features(features) before "
                "serving queries")
        with torch.inference_mode():
            out = self.model(self._h0, self.pa)
        self.forward_count += 1
        return out

    def _held(self, owners) -> np.ndarray:
        """Each owner part's place in what the forward returns
        (``_part_pos``); raises when a part is held nowhere here (a
        one-part slice asked for another part's vertex)."""
        pos = self._part_pos[owners]
        if (pos < 0).any():
            other = sorted({int(o) for o in np.asarray(owners)[pos < 0]})
            raise ValueError(
                f"this engine serves part(s) {self.parts} of the plan (a "
                f"one-part slice): queries owned by part(s) {other[:8]} "
                "are not served here — query the slice's own vertices, "
                "or serve the full plan")
        return pos

    def submit(self, qids) -> InFlightBatch:
        """Dispatch one micro-batch without waiting: route and pad on the
        host, queue the forward and the query gather on the device; the
        handle's ``result()`` waits.  On a rank group rank 0 calls it
        (module docstring): the batch's header, ids, forward and row
        gather are issued on every rank before it returns."""
        qids = np.asarray(qids, dtype=np.int64).reshape(-1)
        nq = len(qids)
        if nq == 0:
            return InFlightBatch(
                self, torch.zeros((0, self.widths[-1])), 0)
        if self.mesh is not None:
            self._front("submit")
            # one poll per micro-batch, on rank 0 alone: the chosen path
            # rides this batch's header and every rank swaps before it
            swap = self._watch.pick() if self._watch is not None else None
            return self._lead_batch(SERVE if swap is None else SWAP, qids,
                                    swap)
        if self._watch is not None:
            # one poll per micro-batch: a newer intact checkpoint in the
            # watched directory swaps in before this batch dispatches
            self._watch.poll(self)
        if self.mode == "subgraph":
            return self._submit_subgraph(qids)
        with self.spans.span("serve:route"):
            owners, locals_ = self.router.lookup(qids)
            pos = self._held(owners)
        with self.spans.span("serve:batch"):
            bucket = self.batcher.bucket_for(nq)
            q_owner = np.full(bucket, -1, np.int64)   # pad: matches no part
            q_local = np.zeros(bucket, np.int64)
            q_owner[:nq] = pos
            q_local[:nq] = locals_
            q_owner = torch.as_tensor(q_owner).to(self.device)
            q_local = torch.as_tensor(q_local).to(self.device)
        logits = self.forward()
        sel = logits[q_owner.clamp(min=0), q_local]          # (Q, nout)
        out = torch.where((q_owner >= 0)[:, None], sel, 0.0)
        return InFlightBatch(self, out, nq)

    # ------------------------------------------------- the rank protocol
    def _front(self, what: str) -> None:
        """Raise unless this is rank 0 of an open rank group."""
        if self.mesh.rank != 0:
            raise ValueError(
                f"{what} is rank 0's: rank {self.mesh.rank} serves rank "
                "0's batches inside follow()")
        if self._closed:
            raise ValueError(f"{what} after close(): the followers have "
                             "stopped")

    def _lead_batch(self, action: int, qids, swap=None) -> InFlightBatch:
        """Rank 0's side of one round: validate and route the ids (before
        anything ships: a bad batch raises here, the followers keep
        waiting and ``close()`` releases them), then the round
        (``_rank_round``).  ``swap``: a path, or the watcher's ``(step,
        path, loaded)``."""
        nq = len(qids)
        if nq:
            with self.spans.span("serve:route"):
                self._held(self.router.lookup(qids)[0])
        bucket = self.batcher.bucket_for(nq) if nq else 0
        step = loaded = None
        if isinstance(swap, tuple):
            step, swap, loaded = swap
        raw = swap.encode() if swap is not None else b""
        measure, self._measure_next = self._measure_next, False
        ids = np.zeros(bucket, np.int64)
        ids[:nq] = qids
        handle = self._rank_round(
            self._header(action, bucket, nq, len(raw), int(measure)), ids,
            raw, loaded)
        if step is not None:
            self._watch.last_step = step
        return handle

    def _header(self, *fields):
        """A header tensor on the group's device: ``fields`` padded with
        zeros to ``HEADER_LEN`` (a follower's all-zero receive buffer)."""
        return torch.tensor(list(fields) + [0] * (HEADER_LEN - len(fields)),
                            dtype=torch.int64, device=self.mesh.device)

    def _rank_round(self, hdr, ids=None, raw=b"", loaded=None):
        """One round of the batch protocol on every rank: the header
        broadcast from rank 0 (the followers pass a zero ``hdr`` to
        receive it), then by its action the swap path and the ids, the
        swap, the batch's forward and its row gather
        (``_rank_rows``).  Returns the batch's handle, else ``None``.  An
        exception after the header marks the engine failed: every rank
        met it alike, so ``close()`` sends no stop header."""
        m = self.mesh
        lead = m.rank == 0
        m.broadcast(hdr)
        action, bucket, nq, plen, measure = (int(x) for x in hdr.cpu())
        if action == STOP:
            return None
        try:
            if action == GAUGES:
                self._sync_subgraph_totals()
                return None
            path = None
            if plen:
                buf = (torch.tensor(list(raw), dtype=torch.uint8) if lead
                       else torch.empty(plen, dtype=torch.uint8))
                buf = m.broadcast(buf.to(m.device))
                path = bytes(buf.cpu().numpy()).decode()
            if nq:
                t = (torch.as_tensor(ids) if lead
                     else torch.empty(bucket, dtype=torch.int64))
                qids = m.broadcast(t.to(m.device))[:nq].cpu().numpy()
            if action == SWAP:
                self._swap(path, loaded)
            if not nq:
                return None
            if not measure or lead:
                # rank 0 measures around its whole query (warmup)
                return self._rank_rows(qids, bucket)
            box = []
            self._join_memory(bucket, measure_device_step(
                lambda: box.append(self._rank_rows(qids, bucket).result()),
                self.device, self._mem_base))
            return InFlightBatch(self, torch.as_tensor(box[0]), nq)
        except BaseException:
            self._failed = True
            raise

    def _rank_rows(self, qids, bucket: int) -> InFlightBatch:
        """The batch on every rank: its forward (full mode; sub-graph
        mode: the compact forward of the rank's own part), its rows
        masked with a ``where`` to the queries its part owns, and the row
        all-gather issued.  The handle's ``finish`` waits on the gather;
        on rank 0 it selects each query's row from the rank that holds
        its owner (a gather: every bit kept)."""
        m = self.mesh
        nq = len(qids)
        with self.spans.span("serve:route"):
            owners, locals_ = self.router.lookup(qids)
            pos = self._part_pos[owners]
        if self.mode == "subgraph":
            with self.spans.span("serve:route"):
                batch = self.subgraph_batch(qids)
            out = self.run_subgraph(batch)      # masked by build_batch
        else:
            with self.spans.span("serve:batch"):
                q_local = np.zeros(bucket, np.int64)
                q_local[:nq] = locals_
                mine = np.zeros(bucket, bool)
                mine[:nq] = pos == m.rank
                q_local = torch.as_tensor(q_local).to(self.device)
                mine = torch.as_tensor(mine).to(self.device)
            logits = self.forward()
            with torch.inference_mode():
                out = torch.where(mine[:, None], logits[0, q_local], 0.0)
        q = out.shape[0]
        with torch.inference_mode():
            gathered, work = m.all_gather(out, async_op=True)
        q_pos = np.full(q, -1, np.int64)
        q_pos[:nq] = pos
        q_pos = torch.as_tensor(q_pos).to(self.device)

        def finish():
            work.wait()
            if m.rank != 0:
                return out
            with torch.inference_mode():
                rows = gathered.view(m.size, q, -1)[
                    q_pos.clamp(min=0), torch.arange(q, device=q_pos.device)]
                return torch.where((q_pos >= 0)[:, None], rows, 0.0)
        return InFlightBatch(self, None, nq, finish)

    def follow(self) -> int:
        """A follower's loop (ranks 1…k−1): serve rank 0's batches, swaps
        and gauge rounds as their headers arrive, until the stop header
        (rank 0's ``close()``).  Returns the number of batches served."""
        if self.mesh is None or self.mesh.rank == 0:
            raise ValueError("follow() is the loop of ranks 1…k−1 of a "
                             "rank group; rank 0 serves (submit/query)")
        served = 0
        while True:
            hdr = self._header()
            handle = self._rank_round(hdr)
            if int(hdr[0]) == STOP:
                return served
            if handle is not None:
                handle.result()
                served += 1

    def close(self) -> None:
        """Rank 0 of a rank group: send the stop header, once, so every
        follower's ``follow()`` returns; call it also when serving failed
        (a ``finally``).  After a batch whose collectives raised here
        (every rank raised alike, a wrong-plan swap) nothing is sent.
        Elsewhere a no-op.  The group itself stays the caller's to
        close."""
        if self.mesh is None or self.mesh.rank != 0 or self._closed:
            return
        self._closed = True
        if not self._failed:
            self._rank_round(self._header(STOP))

    def _sync_subgraph_totals(self) -> None:
        """A GAUGES round: the sub-graph totals that differ by part
        (touched rows, recipe edges, FLOPs) summed over the ranks, as the
        stacked engine counts them over its k parts."""
        keys = ("touched_rows", "recipe_edges", "flops")
        mine = torch.tensor([self._sg_totals[x] for x in keys],
                            dtype=torch.int64, device=self.mesh.device)
        summed = self.mesh.all_reduce_sum(mine).cpu().tolist()
        self._sg_synced = dict(zip(keys, (int(x) for x in summed)))

    def _submit_subgraph(self, qids) -> InFlightBatch:
        """One sub-graph micro-batch: the compact layout on the host, then
        the compact forward and the query gather queued on the device."""
        with self.spans.span("serve:route"):
            batch = self.subgraph_batch(qids)
        return InFlightBatch(self, self.run_subgraph(batch), batch.nq)

    def subgraph_batch(self, qids):
        """The host half of a sub-graph micro-batch: route ``qids``, take
        each part's receptive set and cut its compact tiles
        (``serve/subgraph.py::build_batch``, numpy); on a rank group the
        rank's own part alone."""
        if self.sgindex is None:
            raise ValueError("engine was built with mode='full' — "
                             "sub-graph batches exist under "
                             "mode='subgraph'")
        if self._feats is None:
            raise ValueError(
                "sub-graph serving gathers receptive-set features — call "
                "set_features(features) first")
        return build_batch(self.sgindex, self.router, qids, self.nlayers,
                           tb=self.setup.fwd_static["pallas_tb"],
                           parts=self.parts if self.mesh is not None
                           else None)

    def run_subgraph(self, batch):
        """The device half: copy ``batch``'s compact tiles to the device,
        gather its rows' features, queue the compact forward and the query
        gather.  Returns the ``(Qb, nout)`` rows (padding slots and
        queries of parts not laid out zero), not waited for."""
        from ..obs.attribution import subgraph_batch_flops

        with self.spans.span("serve:batch"):
            arrs = batch.to_device(self.device)
        with torch.inference_mode():
            h = self._feats[arrs["gids"]]  # −1 reads the zero row n (last)
            if self.model_kind == "gat":
                h = subgraph_forward_gat(
                    self.model.layer_params(), self._stabilizers, h,
                    arrs["valid"], arrs["families"][0], batch.classes[0],
                    batch.tb, self.activation, self.final_activation)
            else:
                h = subgraph_forward_gcn(
                    self.model.layer_params(), h, arrs["families"],
                    batch.classes, batch.tb, self.activation,
                    self.final_activation, self.halo_dtype)
            q_owner = arrs["q_owner"]
            sel = h[q_owner.clamp(min=0), arrs["q_pos"]]     # (Qb, nout)
            out = torch.where((q_owner >= 0)[:, None], sel, 0.0)
        self._sg_keys.add(batch.key)
        t = self._sg_totals
        t["queries"] += batch.nq
        t["batches"] += 1
        t["touched_rows"] += batch.touched_rows
        t["recipe_edges"] += batch.recipe_edges
        t["wire_rows"] += batch.key[1]              # the padded gather rows
        t["flops"] += subgraph_batch_flops(
            batch.touched_rows, batch.recipe_edges, self.fin, self.widths,
            model=self.model_kind)
        return out

    def query(self, qids) -> np.ndarray:
        """Serve one micro-batch of global vertex ids → ``(len(qids),
        nout)`` float32 logits."""
        return self.submit(qids).result()

    def warmup(self, qids) -> None:
        """Serve one throwaway batch per bucket (cycling ``qids``): the
        first launch builds the kernel and initializes the device, which
        must not land in a measured window.  The widest bucket's batch is
        the memory join's measured step (``_join_memory``; on a rank
        group every rank measures that batch on its own device, its
        header says so)."""
        qids = np.asarray(qids, dtype=np.int64).reshape(-1)
        if qids.size == 0:
            raise ValueError("warmup needs at least one query id")
        widest = max(self.batcher.buckets)
        for b in self.batcher.buckets:
            q = np.resize(qids, b)
            if b == widest and self.memory_join is None:
                # the widest bucket's batch, measured on the card; a
                # forward updates no tensor in place, so none is named
                self._measure_next = self.mesh is not None
                self._join_memory(widest, measure_device_step(
                    lambda: self.query(q), self.device, self._mem_base))
            else:
                self.query(q)
        synchronize(self.device)

    # -------------------------------------------------------------- memory
    def resident_bytes(self) -> dict:
        """The live tensors' bytes per memory family: params, features,
        the shipped plan arrays (the per-family measured side of the
        memory block)."""
        def nb(ts):
            return int(sum(t.numel() * t.element_size() for t in ts))

        feats = [t for t in (self._h0, self._feats) if t is not None]
        return {
            "params": nb(self.model.parameters()),
            "opt_state": 0,
            "features": nb(feats),
            "plan_arrays": nb([t for f, t in self.pa.items()
                               if not f.startswith("ptile_")]),
            "pallas_tiles": nb([t for f, t in self.pa.items()
                                if f.startswith("ptile_")]),
        }

    def _join_memory(self, bucket: int, measured: dict | None) -> None:
        """Join the widest bucket's measured batch (``warmup``:
        ``obs.memory.measure_device_step``, ``None`` on the CPU; a forward
        updates no weights in place, so it aliases 0) and the live tensors
        against the model into ``memory_join``; under a recorder also the
        manifest's memory block and one ``memory`` event."""
        self.memory_join = reconcile(self.memory, measured,
                                     resident=self.resident_bytes())
        if self.recorder is not None:
            self.recorder.set_memory(self.memory_join["block"])
            self.recorder.record_memory(
                ("subgraph" if self.mode == "subgraph" else "bucket")
                + str(bucket), self.memory, measured)

    # -------------------------------------------------------------- gauges
    @property
    def nlayers(self) -> int:
        return len(self.widths)

    def gauges(self) -> dict:
        """Per-batch gauges under the reference's report keys where they
        apply.  Full mode: plan-derived, the wire rows the resolved
        schedule's (a2a k²·S, ragged k·Σ_d S_d).  Sub-graph mode:
        accumulated over the batches served (warm-up included, hence the
        ``_total`` keys): touched rows and real recipe edges per query,
        analytic FLOPs per query beside one full forward's, and the padded
        query-gather rows per query (the mode's only cross-part traffic,
        the reference's psum).  On a rank group rank 0 reports the full
        plan's figures, the stacked engine's numbers: in sub-graph mode
        one GAUGES round sums the per-part totals over the ranks (the
        ``buckets`` are rank 0's own compact shapes), and the memory
        block is the rank's, with ``layout: ranks``."""
        from ..obs.attribution import forward_flops

        plan = self.full_plan
        full_flops = forward_flops(plan, self.fin, self.widths,
                                   model=self.model_kind)
        mem = self.memory_gauge()
        if self.mesh is not None:
            mem["layout"] = "ranks"
        if self.mode == "subgraph":
            t = dict(self._sg_totals)
            if self.mesh is not None:
                if not self._closed:
                    self._front("gauges")
                    self._rank_round(self._header(GAUGES))
                t.update(self._sg_synced or {})
            nq = max(t["queries"], 1)
            return {
                "serve_mode": "subgraph",
                "memory": mem,
                "comm_schedule": self.comm_schedule,
                "halo_dtype": self.halo_dtype,
                "weights_rev": self.weights_rev,
                "subgraph_queries_total": t["queries"],
                "subgraph_batches_total": t["batches"],
                "touched_rows_total": t["touched_rows"],
                "touched_rows_per_query": round(t["touched_rows"] / nq, 6),
                "recipe_edges_total": t["recipe_edges"],
                "subgraph_flops_per_query": round(t["flops"] / nq, 3),
                "wire_rows_per_query": round(t["wire_rows"] / nq, 6),
                "full_rows_per_forward": int(plan.k * plan.b),
                "full_forward_flops": full_flops,
                "buckets": [list(key) for key in sorted(self._sg_keys)],
                "compiles": self.compile_count,
                "forwards": self.forward_count,
                "device": device_name(self.device),
            }
        wire = plan.wire_rows_per_exchange(self.comm_schedule)
        true = int(plan.predicted_send_volume.sum())
        return {
            "serve_mode": "full",
            "memory": mem,
            "comm_schedule": self.comm_schedule,
            "halo_dtype": self.halo_dtype,
            "exchanges_per_batch": self.nlayers,
            "wire_rows_per_exchange": wire,
            "true_rows_per_exchange": true,
            "wire_rows_per_batch": self.nlayers * wire,
            "wire_rows_per_query": round(
                self.nlayers * wire / self.batcher.max_batch, 6),
            "full_rows_per_forward": int(plan.k * plan.b),
            "full_forward_flops": full_flops,
            "buckets": list(self.batcher.buckets),
            "compiles": self.compile_count,
            "forwards": self.forward_count,
            "weights_rev": self.weights_rev,
            "device": device_name(self.device),
        }

    def memory_gauge(self) -> dict:
        """The report's ``memory`` block under the reference's keys: the
        analytic device total and its non-zero families, and, once the
        widest bucket was measured on the card, its peak."""
        mem = {"analytic": True,
               "model_bytes": self.memory.total_bytes,
               **{f"{name}_bytes": int(v)
                  for name, v in self.memory.families.items() if v}}
        block = (self.memory_join or {}).get("block", {})
        peak = block.get("total", {}).get("measured_bytes")
        if peak is not None:
            mem["measured"] = True
            mem["measured_peak_bytes"] = int(peak)
        return mem

    # ------------------------------------------------------------ recorder
    def attach_recorder(self, recorder) -> None:
        """Attach a ``RunRecorder``: the ``serve:*`` spans become span
        events, the transport decision and the memory block (with its
        measured join, once ``warmup`` measured the widest bucket) land in
        the manifest, ``swap_weights`` appends swap events and
        ``record_window`` serve events."""
        self.recorder = recorder
        self.spans.recorder = recorder
        if recorder is None:
            return
        if self.comm_decision:
            recorder.set_comm_schedule(self.comm_decision)
        recorder.set_memory(self.memory_join["block"]
                            if self.memory_join is not None
                            else self.memory.block())

    def record_window(self, result, offered_qps: float | None = None,
                      mode: str = "open") -> None:
        """One ``serve`` event for a completed traffic window
        (``loadgen.ServeResult``), with the batching counters and the
        analytic gauges riding along."""
        if self.recorder is None:
            return
        g = self.gauges()
        self.recorder.record_serve(
            queries=result.queries,
            achieved_qps=result.achieved_qps,
            latency_p50_ms=result.p50_ms,
            latency_p95_ms=result.p95_ms,
            latency_p99_ms=result.p99_ms,
            window_s=result.window_s,
            offered_qps=offered_qps,
            mode=mode,
            batches=result.batches,
            mean_batch=result.mean_batch,
            deadline_flushes=self.batcher.deadline_flushes,
            full_flushes=self.batcher.full_flushes,
            latency_budget_ms=self.batcher.latency_budget_ms,
            compiles=self.compile_count,
            buckets=list(self.batcher.buckets),
            comm_schedule=self.comm_schedule,
            wire_rows_per_query=g["wire_rows_per_query"],
            serve_mode=self.mode,
            weights_rev=self.weights_rev,
            touched_rows_per_query=g.get("touched_rows_per_query"),
            subgraph_flops_per_query=g.get("subgraph_flops_per_query"),
            # the window's shed count, present only when shedding is on
            shed=(result.shed if self.batcher.shed_factor is not None
                  else None),
            shed_factor=self.batcher.shed_factor,
        )
