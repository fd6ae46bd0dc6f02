"""Mini-batch partitioned GCN/GAT trainer: per-batch sampled adjacency and
per-batch plans (port of ``sgcn_tpu/train/minibatch.py``).

As in the reference, ``nbatches = 3·(n//batch + 1)`` random vertex
subsets are drawn before training (``sample_batches``), each batch's
adjacency is the graph restricted to it (``sample_adjacency``), and each
batch gets its own communication plan, so a step exchanges only the
batch's boundary rows.  Every batch plan is padded to the envelope of
all of them (``parallel/plan.py::pad_comm_plan``: the ``(b, s, r, e,
el, eh, tl)`` maxima, shared ELL buckets; for GAT a shared combined-edge
layout; on the ragged ring shared round sizes), the reference's
construction array for array.

The step is the full-batch trainer's (``FullBatchTrainer`` on the first
batch plan): the same forward, loss, backward and Adam, over the tile
layout of whichever batch it runs.  Each batch's plan arrays and tile
layouts are built and shipped to the device once (``make_batches``);
``step(batch)`` points the inner trainer at them.  The aggregation is the
port's kernels on every batch: the row pack and the fused tile launch
(``PspmmTilesSym`` on a2a, ``PspmmTilesRagged`` on the ring) for GCN,
the int8-mask pass (K5) for GAT.

One process per part (``mesh``, a ``parallel/mesh.py::RankGroup`` of
``k`` ranks; ROADMAP A2c): every rank draws the same batches, builds
every padded batch plan and its tile layouts (so every rank launches the
same tile classes on the same shapes), then keeps its part's slice of
each (``parallel/proxy.py::shard_proxy_plan``) and its part's rows of
each batch — the reference's ``shard_stacked`` of each batch plan on a
multi-process mesh.  A batch that misses a part leaves that rank a slice
with no real row, which still takes part in every collective.  The inner
trainer is the rank trainer (``FullBatchTrainer(mesh=...)``): its loss
and weight gradients are all-reduced each step.  ``part`` trains one
part's slices alone: on a one-rank group (its collectives loop back) or
stacked without one — the shard proxy of the batch set.  The comm
counters stay the full batch plans' on every rank, so each rank reports
the whole job's figures.

``memory_budget`` holds the footprint of what the trainer keeps on the
device (``obs/memory.py::minibatch_memory_model``: every batch plan's
arrays and tiles and every batch's data, beside one step's scratch) to a
byte budget before anything ships; ``attach_recorder`` writes one step
event per batch step, with the comm split merged over the batch counters
(``_comm_snapshot``), and joins the model against the card's measured
step.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..obs.memory import (check_memory_budget, measure_device_step,
                          minibatch_memory_model, reconcile)
from ..ops.pspmm import ELL_MODE_DEFERRAL, ell_selected, narrow_dtype
from ..ops.tile_spmm import choose_tile_dispatch
from ..parallel.plan import (build_comm_plan, pad_comm_plan,
                             resolve_comm_schedule, shared_ell_buckets)
from ..parallel.proxy import shard_proxy_plan
from ..utils.stats import CommStats
from .fullbatch import (FullBatchTrainer, TrainData, make_part_data,
                        make_train_data, resolve_forward_setup)


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def sample_batches(n: int, batch_size: int, nbatches: int | None = None,
                   seed: int = 0) -> list[np.ndarray]:
    """The pre-sampled vertex subsets (sorted); by default
    ``3·(n//batch_size + 1)`` of them."""
    rng = np.random.default_rng(seed)
    if nbatches is None:
        nbatches = 3 * (n // batch_size + 1)
    batch_size = min(batch_size, n)
    return [np.sort(rng.choice(n, size=batch_size, replace=False))
            for _ in range(nbatches)]


def sample_adjacency(a: sp.spmatrix, batch: np.ndarray) -> sp.csr_matrix:
    """The batch-restricted adjacency ``A[batch][:, batch]``, reindexed to
    ``0..|batch|-1``."""
    a = sp.csr_matrix(a)
    return a[batch][:, batch]


@dataclass
class Batch:
    vertices: np.ndarray
    plan: object          # the padded CommPlan over the batch subgraph
    pa: dict              # its plan arrays on the device
    fwd_static: dict      # its tile classes (and ring sizes), the forward's
    data: TrainData       # the batch's stacked per-part blocks, on device
    stats: CommStats      # the batch plan's counters


class MiniBatchTrainer:
    """The reference's mini-batch trainer over the ``k`` parts stacked on
    one device, or one part per process (``mesh``)."""

    def __init__(
        self,
        a: sp.spmatrix,
        partvec: np.ndarray,
        k: int,
        fin: int,
        widths: list[int],
        batch_size: int,
        nbatches: int | None = None,
        lr: float = 0.01,
        activation: str = "relu",
        model: str = "gcn",
        loss: str = "xent",
        optimizer=None,
        seed: int = 0,
        pad_rows_to: int = 8,
        compute_dtype: str | None = None,
        comm_schedule: str | None = None,
        replica_budget: int = 0,
        memory_budget: int | None = None,
        params=None,
        device=None,
        mesh=None,
        part: int | None = None,
    ):
        """Arguments keep the reference's names; ``optimizer``, ``params``
        and ``device`` are ``FullBatchTrainer``'s (``None`` device means
        ``cuda`` and raises without a GPU).  ``mesh``: a ``RankGroup`` of
        ``k`` ranks (rank r trains part r of every batch plan) or of one
        rank (it trains ``part``, default 0); ``part`` without ``mesh``
        trains that part's slices stacked (the shard proxy).  Data comes
        from the same global arrays on every rank (``make_batches``)."""
        if replica_budget:
            raise ValueError(
                "replica_budget is a full-batch training lever: the "
                "mini-batch trainer re-plans per batch, so replica carries "
                "have no stable identity across batch plans — run the "
                "full-batch trainer for hot-halo replication")
        if ell_selected():
            raise ValueError(ELL_MODE_DEFERRAL.format(
                mode="mini-batch trainer"))
        t0 = time.perf_counter()
        self.mesh = mesh
        if mesh is not None and mesh.size == k:
            if part not in (None, mesh.rank):
                raise ValueError(f"part {part} on rank {mesh.rank} of a "
                                 f"{k}-rank group: rank r trains part r")
            part = mesh.rank
        elif mesh is not None and mesh.size != 1:
            raise ValueError(f"a rank group of {mesh.size} ranks for k={k} "
                             f"parts: one rank per part, {k} ranks, or one")
        elif mesh is not None and part is None:
            part = 0
        if part is not None and not 0 <= part < k:
            raise ValueError(f"part {part} out of range for k={k}")
        self.part = part
        self.a = sp.csr_matrix(a)
        n = self.a.shape[0]
        self.partvec = np.asarray(partvec, dtype=np.int64)
        self.k = k
        self.batches_idx = sample_batches(n, batch_size, nbatches, seed=seed)

        # the per-batch plans, padded to the shared envelope; parts keep
        # their rank even when a batch misses one entirely
        raw = [build_comm_plan(sample_adjacency(self.a, bv),
                               self.partvec[bv], k, pad_rows_to=pad_rows_to)
               for bv in self.batches_idx]
        env = tuple(max(getattr(p, f) for p in raw)
                    for f in ("b", "s", "r", "e", "el", "eh", "tl"))
        shared = shared_ell_buckets(raw, env[0])
        self.plans = [pad_comm_plan(p, *env, ell_buckets=shared) for p in raw]
        if model == "gat":
            # the combined-edge layout with one bucket structure and one
            # tail length for every plan (the spill counted from the
            # degree profiles)
            cshared = shared_ell_buckets(self.plans, env[0], combined=True)
            caps = np.concatenate(
                [np.full(nb, wb, np.int64) for nb, wb in cshared])
            ctl_shared = 1
            for p in self.plans:
                for chip in range(k):
                    deg = np.bincount(p.edge_dst[chip][: int(p.nnz[chip])],
                                      minlength=p.b)
                    ctl_shared = max(ctl_shared, int(
                        np.maximum(deg - caps[: p.b], 0).sum()))
            for p in self.plans:
                p.ensure_cell(buckets=cshared, ctl=ctl_shared)
        # one step definition serves every batch: the symmetric backward
        # only if every batch plan is symmetric
        if not all(p.symmetric for p in self.plans):
            for p in self.plans:
                p.symmetric = False

        # the transport over the whole batch set, and on the ring every
        # plan's rounds padded to the elementwise max
        self.comm_decision: dict = {}
        comm_schedule = resolve_comm_schedule(
            comm_schedule, self.plans, model, decision=self.comm_decision)
        if comm_schedule == "ragged":
            for p in self.plans:
                p.ensure_ragged()
            if k > 1:
                shared_s = tuple(int(x) for x in np.max(
                    [p.rr_sizes for p in self.plans], axis=0))
                for p in self.plans:
                    p.ensure_ragged(rr_sizes=shared_s)
        self.plan_build_s = time.perf_counter() - t0

        # every batch plan's tile layouts and tile classes, then the
        # footprint of the whole batch set and the --memory-budget gate,
        # before anything ships
        t0 = time.perf_counter()
        setup = resolve_forward_setup(self.plans[0], model=model,
                                      comm_schedule=comm_schedule)
        self._statics = [choose_tile_dispatch(p, model=model,
                                              schedule=setup.comm_schedule)
                         for p in self.plans]
        # one part's slice of every batch plan, its layouts built above on
        # the full plan (the tile classes stay the full plan's)
        self.slices = (self.plans if part is None else
                       [shard_proxy_plan(p, part) for p in self.plans])
        # host seconds of the tile layouts (and of the shipping, added by
        # ``_plan_arrays``)
        self.layout_s = time.perf_counter() - t0
        self.memory = minibatch_memory_model(
            self.slices, fin, widths, setup=setup, model=model,
            compute_dtype=("bfloat16" if narrow_dtype(
                compute_dtype, "compute_dtype") is not None else None),
            ranks=mesh is not None)
        check_memory_budget(self.memory, memory_budget,
                            what=f"{model} mini-batch trainer")
        self.memory_budget = memory_budget
        self.memory_join = None        # reconcile() of the measured step

        # The reference runs this trainer with allow_pallas=False: one
        # compiled XLA step serves every batch, and its Pallas tile
        # statics are per plan.  The port compiles nothing per shape, so
        # each batch carries its own tile classes (``fwd_static``) and
        # every batch aggregates on the tile kernels.
        self.inner = FullBatchTrainer(
            self.plans[0] if self._ranked() else self.slices[0], fin,
            widths, lr=lr, activation=activation, model=model, loss=loss,
            optimizer=optimizer, seed=seed, compute_dtype=compute_dtype,
            comm_schedule=comm_schedule, params=params, device=device,
            mesh=mesh)
        self._pa0 = self.inner.pa      # plans[0]'s arrays: batch 0's too
        # a padded per-batch plan is no stable run identity: checkpoints
        # through ``inner`` record no plan digest (utils/checkpoint.py)
        self.inner.checkpoint_plan = None
        self.nlayers = len(widths)
        self.recorder = None          # run telemetry (attach_recorder)
        self._gstep = 0               # completed batch steps (events count
        #                               from 1, as the full-batch trainer's)
        self._comm_cum = None         # the running cross-batch comm sums
        self._narrowed = ({"compute_dtype": self.inner.compute_dtype}
                          if self.inner.compute_dtype else {})
        if mesh is not None:
            self._narrowed["mesh"] = mesh
        self._shipped = None          # per plan (pa, fwd_static), once
        self._data_bytes = None       # the last make_batches' data bytes
        self._fullgraph_eval = None   # built on first use, then cached
        self._fused_batches = None
        self._fused_key = None
        self._fused_stats = None
        self.fused_batch_losses = None

    def _ranked(self) -> bool:
        """A ``k``-rank group: the inner trainer slices the full plan."""
        return self.mesh is not None and self.mesh.size == self.k

    @property
    def device(self):
        return self.inner.device

    @property
    def comm_schedule(self) -> str:
        return self.inner.comm_schedule

    # ------------------------------------------------------------------- data
    def _plan_arrays(self) -> list:
        """Per batch plan its plan arrays on the device, with its
        forward's static kwargs — once per trainer (``plans[0]``'s are the
        inner trainer's own)."""
        if self._shipped is None:
            t0 = time.perf_counter()
            setup = self.inner.setup
            self._shipped = [
                (self._pa0 if i == 0 else setup.ship_arrays(
                    plan, self.device, self.inner.compute_dtype),
                 {**static, **self._narrowed})
                for i, (plan, static) in enumerate(zip(self.slices,
                                                       self._statics))]
            self.layout_s += time.perf_counter() - t0
        return self._shipped

    def make_batches(self, features: np.ndarray, labels: np.ndarray,
                     train_mask: np.ndarray | None = None) -> list[Batch]:
        """Scatter the global features and labels into each batch's
        stacked per-part blocks on the device (with ``part``, that part's
        block alone), beside the batch's plan arrays (shipped on the
        first call)."""
        st = self.inner.stats
        out = []
        for bv, plan, (pa, static) in zip(self.batches_idx, self.plans,
                                          self._plan_arrays()):
            tm = train_mask[bv] if train_mask is not None else None
            out.append(Batch(
                vertices=bv, plan=plan, pa=pa, fwd_static=static,
                data=(make_train_data(plan, features[bv], labels[bv], tm,
                                      device=self.device)
                      if self.part is None else
                      make_part_data(plan, self.part, features[bv],
                                     labels[bv], tm, device=self.device)),
                # the inner trainer's wire lanes, so the byte gauges of
                # every batch compare
                stats=CommStats.from_plan(
                    plan, schedule=self.comm_schedule,
                    lane_widths=st.lane_widths,
                    wire_itemsize=st.wire_itemsize,
                    wire_itemsize_bwd=st.wire_itemsize_bwd)))
        self._data_bytes = _nbytes(t for b in out
                                   for t in vars(b.data).values())
        return out

    # ----------------------------------------------------------------- memory
    def resident_bytes(self) -> dict:
        """The live tensors' bytes per memory family: the inner
        trainer's params and Adam's moments, every batch plan's shipped
        arrays and tiles, and the last ``make_batches``' data (the
        per-family measured side of the memory block)."""
        out = self.inner.resident_bytes()
        pas = [pa for pa, _ in self._plan_arrays()]
        out["plan_arrays"] = _nbytes(t for pa in pas for f, t in pa.items()
                                     if not f.startswith("ptile_"))
        out["pallas_tiles"] = _nbytes(t for pa in pas for f, t in pa.items()
                                      if f.startswith("ptile_"))
        if self._data_bytes is not None:
            out["features"] = self._data_bytes
        return out

    def publish_memory(self, measured: dict | None) -> dict:
        """Join ``measured`` (``obs.memory.measure_device_step``, ``None``
        on the CPU) and the live tensors against the model into
        ``memory_join``; under a recorder also the manifest's memory block
        and one ``memory`` event."""
        self.memory_join = reconcile(self.memory, measured,
                                     resident=self.resident_bytes())
        if self.recorder is not None:
            self.recorder.set_memory(self.memory_join["block"])
            self.recorder.record_memory(
                "train_step", self.memory, measured,
                budget_bytes=self.memory_budget)
        return self.memory_join

    # ------------------------------------------------------------------- api
    def _run(self, batch: Batch):
        """The inner trainer's step on ``batch``'s arrays; the device
        loss."""
        tr = self.inner
        tr.pa = batch.pa
        tr.model.fwd_static = batch.fwd_static
        loss, tr.last_err = tr._one_step(batch.data)
        return loss

    def attach_recorder(self, recorder) -> None:
        """Attach a ``RunRecorder``: every ``step(batch)`` appends one step
        event (loss, wall time, the comm split merged over the batch
        counters so far), ``fit`` a summary; span events ride the inner
        trainer's ``SpanTimer``.  ``run_epochs_fused`` emits no per-step
        events."""
        self.recorder = recorder
        self.inner.spans.recorder = recorder
        if recorder is None:
            return
        if self.comm_decision:
            recorder.set_comm_schedule(self.comm_decision)
        recorder.set_memory(self.memory.block())

    def _comm_snapshot(self, stats: CommStats) -> dict:
        """The running equivalent of ``CommStats.merged_report`` over every
        batch counter that has passed through ``step`` (one step advances
        one batch's counters by a fixed delta, so the cumulative grows by
        that delta instead of re-merging every counter).  Covers the
        recorded steps only."""
        d = 2 * self.nlayers
        per = (stats.send_volume_per_exchange, stats.send_msgs_per_exchange,
               stats.recv_volume_per_exchange, stats.recv_msgs_per_exchange)
        if self._comm_cum is None:
            self._comm_cum = {
                "arrs": [np.zeros_like(p, dtype=np.int64) for p in per],
                "exchanges": 0, "send_volume": 0, "wire_rows": 0,
            }
        c = self._comm_cum
        for acc, p in zip(c["arrs"], per):
            acc += p.astype(np.int64) * d
        c["exchanges"] += d
        c["send_volume"] += int(per[0].sum()) * d
        c["wire_rows"] += stats.wire_rows_per_exchange * d
        rep = CommStats.report_from_cumulative(*c["arrs"])
        rep.update(                 # mini-batch steps are never pipelined
            exchanges=c["exchanges"],
            exposed_exchanges=c["exchanges"], hidden_exchanges=0,
            exposed_send_volume=c["send_volume"], hidden_send_volume=0,
            # the current batch's per-exchange figures (the wire is one
            # envelope for every batch), the cumulative ones over every
            # recorded step
            comm_schedule=stats.schedule,
            true_rows_per_exchange=int(per[0].sum()),
            wire_rows_per_exchange=stats.wire_rows_per_exchange,
            wire_rows_total=c["wire_rows"],
            padding_efficiency=(c["send_volume"] / c["wire_rows"]
                                if c["wire_rows"] else 1.0),
        )
        return rep

    def step(self, batch: Batch) -> float:
        """One optimizer step on one batch; its counters advance as the
        full-batch trainer's do.  Returns the loss (a device readback);
        under a recorder the step runs in a ``step`` span and appends one
        step event, and the first step after Adam's state exists is
        measured and the memory block joined."""
        rec = self.recorder is not None
        join = rec and self.memory_join is None and self._gstep >= 1
        cm = (self.inner.spans.span("step", step=self._gstep + 1)
              if rec else contextlib.nullcontext())
        with cm as sp:
            if join:
                tr, out = self.inner, []
                tr.opt.zero_grad(set_to_none=True)
                measured = measure_device_step(
                    lambda: out.append(self._run(batch)), self.device,
                    tr._mem_base, tr._updated_tensors())
                loss = float(out[0])
            else:
                loss = float(self._run(batch))
        batch.stats.count_step(nlayers=self.nlayers)
        self._gstep += 1
        if rec:
            self.recorder.record_step(
                step=self._gstep, loss=loss, wall_s=sp.dur_s,
                comm=self._comm_snapshot(batch.stats))
        if join:
            self.publish_memory(measured)
        return loss

    def fit(self, features: np.ndarray, labels: np.ndarray,
            train_mask: np.ndarray | None = None, epochs: int = 1,
            warmup: int = 1, verbose: bool = True) -> dict:
        """An epoch is one pass over every pre-sampled batch; ``warmup``
        untimed steps on the first batch go first.  Returns the merged
        comm report of the batch counters plus ``epochs``, ``nbatches``,
        ``elapsed_s``, ``epoch_s``, ``loss_history`` (batch-averaged per
        epoch), ``phases`` and ``total_exchanged_rows``."""
        tr = self.inner
        batches = self.make_batches(features, labels, train_mask)
        with tr.spans.span("warmup", sync=tr._sync):
            for _ in range(warmup):
                self.step(batches[0])
        history = []
        t_prior = tr.timer.inclusive_total("train_step")
        for ep in range(epochs):
            ep_loss = 0.0
            with tr.spans.span("train_step", sync=tr._sync):
                for b in batches:
                    ep_loss += self.step(b)
            ep_loss /= len(batches)
            history.append(ep_loss)
            if verbose:
                print(f"epoch {ep}: batch-avg loss {ep_loss:.6f}", flush=True)
        elapsed = tr.timer.inclusive_total("train_step") - t_prior
        report = CommStats.merged_report([b.stats for b in batches])
        report.update(
            epochs=epochs,
            nbatches=len(batches),
            elapsed_s=elapsed,
            epoch_s=elapsed / max(epochs, 1),
            loss_history=history,
            phases=tr.timer.report(),
            # rows shipped over all exchanges (an alias of the total)
            total_exchanged_rows=report["total_send_volume"],
        )
        if self.recorder is not None:
            self.recorder.record_summary(
                {k: v for k, v in report.items() if k != "loss_history"})
        return report

    # ------------------------------------------------------ the epoch sweep
    def run_epochs_fused(self, features, labels, train_mask=None,
                         epochs: int = 1, sync: bool = True):
        """``epochs`` passes over every batch with no readback between
        steps, on batches shipped once per data: the trajectory of
        ``epochs × len(batches)`` ``step`` calls, bit for bit (the same
        launches in the same order).  ``sync=True`` returns the per-epoch
        batch-averaged losses (float64 numpy, the mean of the float32
        batch losses, as ``fit`` forms it; the batch losses stay in
        ``fused_batch_losses``); ``sync=False`` the ``(epochs, nbatches)``
        float32 batch losses on the device."""
        # a cheap content probe: other data re-ships the batches
        key = (np.asarray(features).shape, np.asarray(labels).shape,
               None if train_mask is None else np.asarray(train_mask).shape,
               float(np.asarray(features).ravel()[:16].sum()),
               int(np.asarray(labels).ravel()[:16].sum()),
               None if train_mask is None
               else float(np.asarray(train_mask).sum()))
        if self._fused_batches is None or key != self._fused_key:
            self._fused_batches = self.make_batches(features, labels,
                                                    train_mask)
            self._fused_key = key
        batches = self._fused_batches
        losses = torch.stack([self._run(b) for _ in range(epochs)
                              for b in batches]).reshape(epochs, len(batches))
        # the stepwise path's 8-number accounting, one counter per plan
        if self._fused_stats is None:
            self._fused_stats = [CommStats.from_plan(
                p, schedule=self.comm_schedule) for p in self.plans]
        for _ in range(epochs):
            for st in self._fused_stats:
                st.count_step(nlayers=self.nlayers)
        if not sync:
            return losses
        self.fused_batch_losses = losses.detach().cpu().numpy()
        return np.array([sum(float(x) for x in row) / len(row)
                         for row in self.fused_batch_losses])

    def fused_stats_report(self) -> dict:
        return CommStats.merged_report(self._fused_stats or [])

    # ----------------------------------------------- full-graph evaluation
    def evaluate_fullgraph(self, features: np.ndarray, labels: np.ndarray,
                           eval_mask: np.ndarray | None = None):
        """(loss, accuracy) of the current weights on the whole graph's
        plan (built on first use, then cached), over ``eval_mask``."""
        if self._fullgraph_eval is None:
            plan = build_comm_plan(self.a, self.partvec, self.k)
            inner = self.inner
            own = plan
            if self.part is not None and not self._ranked():
                # one part's slice, its layouts built on the full plan
                resolve_forward_setup(plan, model=inner.setup.model)
                own = shard_proxy_plan(plan, self.part)
            self._fullgraph_eval = (plan, FullBatchTrainer(
                own, features.shape[1], self._widths_from_params(),
                activation=inner.activation, model=inner.setup.model,
                loss=inner.loss_name, compute_dtype=inner.compute_dtype,
                params=inner.params, device=self.device, mesh=self.mesh))
        plan, tr = self._fullgraph_eval
        with torch.no_grad():
            for dst, src in zip(tr.model.parameters(),
                                self.inner.model.parameters()):
                dst.copy_(src)
        every = np.ones(self.a.shape[0], np.float32)
        data = (make_train_data(plan, features, labels, every, eval_mask,
                                device=self.device)
                if self.part is None else
                make_part_data(plan, self.part, features, labels, every,
                               eval_mask, device=self.device))
        return tr.evaluate(data)

    def _widths_from_params(self) -> list[int]:
        if self.inner.setup.model == "gcn":
            return [int(w.shape[1]) for w in self.inner.params]
        return [int(p["w"].shape[1]) for p in self.inner.params]

