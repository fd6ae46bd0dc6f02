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
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.tile_spmm import choose_tile_dispatch
from ..parallel.plan import (build_comm_plan, pad_comm_plan,
                             resolve_comm_schedule, shared_ell_buckets)
from ..utils.stats import CommStats
from .fullbatch import FullBatchTrainer, TrainData, make_train_data


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
    one device."""

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
    ):
        """Arguments keep the reference's names; ``optimizer``, ``params``
        and ``device`` are ``FullBatchTrainer``'s (``None`` device means
        ``cuda`` and raises without a GPU)."""
        if replica_budget:
            raise ValueError(
                "replica_budget is a full-batch training lever: the "
                "mini-batch trainer re-plans per batch, so replica carries "
                "have no stable identity across batch plans — run the "
                "full-batch trainer for hot-halo replication")
        t0 = time.perf_counter()
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

        # The reference runs this trainer with allow_pallas=False: one
        # compiled XLA step serves every batch, and its Pallas tile
        # statics are per plan.  The port compiles nothing per shape, so
        # each batch carries its own tile classes (``fwd_static``) and
        # every batch aggregates on the tile kernels.
        self.inner = FullBatchTrainer(
            self.plans[0], fin, widths, lr=lr, activation=activation,
            model=model, loss=loss, optimizer=optimizer, seed=seed,
            compute_dtype=compute_dtype, comm_schedule=comm_schedule,
            memory_budget=memory_budget, params=params, device=device)
        # a padded per-batch plan is no stable run identity: checkpoints
        # through ``inner`` record no plan digest (utils/checkpoint.py)
        self.inner.checkpoint_plan = None
        self.nlayers = len(widths)
        self._narrowed = ({"compute_dtype": self.inner.compute_dtype}
                          if self.inner.compute_dtype else {})
        self._shipped = None          # per plan (pa, fwd_static), once
        self.layout_s = None          # host seconds of the tile layouts
        self._fullgraph_eval = None   # built on first use, then cached
        self._fused_batches = None
        self._fused_key = None
        self._fused_stats = None
        self.fused_batch_losses = None

    @property
    def device(self):
        return self.inner.device

    @property
    def comm_schedule(self) -> str:
        return self.inner.comm_schedule

    # ------------------------------------------------------------------- data
    def _plan_arrays(self) -> list:
        """Per batch plan its tile layouts (built here) and plan arrays on
        the device, with its forward's static kwargs — once per trainer."""
        if self._shipped is None:
            t0 = time.perf_counter()
            setup = self.inner.setup
            out = []
            for plan in self.plans:
                static = choose_tile_dispatch(
                    plan, model=setup.model, schedule=setup.comm_schedule)
                out.append((setup.ship_arrays(plan, self.device,
                                              self.inner.compute_dtype),
                            {**static, **self._narrowed}))
            self._shipped = out
            self.layout_s = time.perf_counter() - t0
        return self._shipped

    def make_batches(self, features: np.ndarray, labels: np.ndarray,
                     train_mask: np.ndarray | None = None) -> list[Batch]:
        """Scatter the global features and labels into each batch's
        stacked per-part blocks on the device, beside the batch's plan
        arrays (shipped on the first call)."""
        st = self.inner.stats
        out = []
        for bv, plan, (pa, static) in zip(self.batches_idx, self.plans,
                                          self._plan_arrays()):
            tm = train_mask[bv] if train_mask is not None else None
            out.append(Batch(
                vertices=bv, plan=plan, pa=pa, fwd_static=static,
                data=make_train_data(plan, features[bv], labels[bv], tm,
                                     device=self.device),
                # the inner trainer's wire lanes, so the byte gauges of
                # every batch compare
                stats=CommStats.from_plan(
                    plan, schedule=self.comm_schedule,
                    lane_widths=st.lane_widths,
                    wire_itemsize=st.wire_itemsize,
                    wire_itemsize_bwd=st.wire_itemsize_bwd)))
        return out

    # ------------------------------------------------------------------- api
    def _run(self, batch: Batch):
        """The inner trainer's step on ``batch``'s arrays; the device
        loss."""
        tr = self.inner
        tr.pa = batch.pa
        tr.model.fwd_static = batch.fwd_static
        loss, tr.last_err = tr._one_step(batch.data)
        return loss

    def step(self, batch: Batch) -> float:
        """One optimizer step on one batch; its counters advance as the
        full-batch trainer's do.  Returns the loss (a device readback)."""
        loss = float(self._run(batch))
        batch.stats.count_step(nlayers=self.nlayers)
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
            self._fullgraph_eval = (plan, FullBatchTrainer(
                plan, features.shape[1], self._widths_from_params(),
                activation=inner.activation, model=inner.setup.model,
                loss=inner.loss_name, compute_dtype=inner.compute_dtype,
                params=inner.params,
                device=self.device))
        plan, tr = self._fullgraph_eval
        with torch.no_grad():
            for dst, src in zip(tr.model.parameters(),
                                self.inner.model.parameters()):
                dst.copy_(src)
        data = make_train_data(plan, features, labels,
                               np.ones(self.a.shape[0], np.float32),
                               eval_mask, device=self.device)
        return tr.evaluate(data)

    def _widths_from_params(self) -> list[int]:
        if self.inner.setup.model == "gcn":
            return [int(w.shape[1]) for w in self.inner.params]
        return [int(p["w"].shape[1]) for p in self.inner.params]

