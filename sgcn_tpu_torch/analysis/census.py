"""The launch and collective census (pass 1 of ``sgcn_tpu_torch.analysis``;
the port's counterpart of ``sgcn_tpu/analysis/hlo.py`` and
``hlo_audit.py``).

XLA's HLO has no counterpart in eager torch: what a torch step IS is the
stream of kernel launches and collectives it issues.  For every
supported mode (``modes``) this module builds the real trainer or engine
on the reference's audit fixture, runs one step (one batch, for serving;
both the carried and the sync step of a stale or replica mode) inside a
``utils/census.py::recording()`` block, and holds what it recorded
against the plan-derived ``expect`` expectation.  A violation names its rule:

  * ``exchange-census`` — stacked: one pack per dense exchange and one per
    ring exchange (its receive layout holds the live rounds only); on
    ranks: one ``all_to_all_single`` per dense exchange, one
    ``batch_isend_irecv`` per live ring round (a device copy, ``loopback``,
    on a one-rank group), one gradient all-reduce per parameter, the
    loss's pinned scalar reduces, GAT's per-layer max, one row all-gather
    per served batch, nothing else;
  * ``launch-census`` — launches per label (``utils/census.py::
    LAUNCH_LABELS``) equal to the expectation; no K1/K5/fused launch on an
    ELL mode; on the card also equal to the wrappers' ``.launches``
    counter deltas, step for step, and over the whole run to the
    profiler's device kernels under each ``obs/tracing.py::KERNEL_TABLE``
    label (``device_window``);
  * ``wire-dtype`` — bf16 packs both ways under ``halo_dtype`` and the GAT
    packed form, float32 on a ``halo_delta`` sync step's re-base;
  * ``wire-shape`` — pack outputs are ``recv_layout_shape × lanes`` (the
    shrunken layout on a replica step); rank buffers ``wire_buffer_shapes
    × lanes``;
  * ``host-sync`` — no host read (``aten::_local_scalar_dense``) inside
    the step beyond the workload's pinned count (``expect.HOST_READS``);
    on the card no device-to-host copy beyond them either;
  * ``in-place`` — params and optimizer state keep their ``data_ptr``
    across a step, and so do the carries a mode updates in place; plan
    tensors and batch data keep their ``_version``; a served batch writes
    no parameter;
  * ``halo-materialization`` — a GCN tile ring mode packs no ``(k, R, f)``
    halo table: the fused launch reads the ring's receive layout in place;
  * ``overlap-order`` — a rank's GCN tile aggregation issues its exchange,
    launches its local pass, and only then waits.

The fixture is the reference's (``hlo_audit.py:64-109``): k = 8,
n = 96, an ER graph of degree 6 on balanced random parts, and the
banded ±2 ring on contiguous parts whose ring keeps 2 of k−1 rounds.
A rank mode runs one rank (gloo on the CPU, NCCL on the card) on part 0's
slice (``parallel/proxy.py``).

``memory_pass`` (``--memory``) measures one step of each mode on the card
(``obs/memory.py::measure_device_step``) and reconciles it with the
owner's analytic model (``reconcile``); it refuses the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import Counter
from functools import lru_cache

import numpy as np

from . import expect
from .modes import Mode, banded_modes, fast_modes, supported_modes

# every rule a census violation may name (module docstring)
CENSUS_RULES = ("exchange-census", "launch-census", "wire-dtype",
                "wire-shape", "host-sync", "in-place",
                "halo-materialization", "overlap-order")

AUDIT_K = 8
AUDIT_N = 96
AUDIT_FIN = 8
AUDIT_WIDTHS = (8, 4)
# the port picks the split GAT form by width (fout + 1 past
# models/gat.py::FUSED_MAX_LANES), not by an environment switch: a split
# mode runs a first layer that wide
AUDIT_SPLIT_WIDTHS = (128, 4)
AUDIT_REPLICA_B = 12
# a served batch: one bucket of this many part-0 vertices
AUDIT_BATCH = 8
# the mini-batch entry: two batches of half the graph
AUDIT_MB_BATCH = AUDIT_N // 2
# seconds the card's profiler window settles before the census counts
# (``device_window``)
WINDOW_SETTLE_S = 1.0


@lru_cache(maxsize=None)
def audit_graph(kind: str = "er", k: int = AUDIT_K):
    """``(ahat, partvec)`` of the fixture: ``'er'`` an ER graph of degree 6
    on ``k`` balanced random parts (every part pair exchanges, every ring
    round is live), ``'banded'`` the ±2 ring on contiguous parts (only
    rounds 1 and k−1 are live)."""
    import scipy.sparse as sp

    from ..io.datasets import er_graph
    from ..partition import balanced_random_partition
    from ..prep import normalize_adjacency

    if kind == "er":
        ahat = normalize_adjacency(er_graph(AUDIT_N, 6, seed=0))
        pv = balanced_random_partition(AUDIT_N, k, seed=1)
    elif kind == "banded":
        n = AUDIT_N
        rows = np.concatenate([np.arange(n), np.arange(n)])
        cols = np.concatenate([(np.arange(n) + 1) % n,
                               (np.arange(n) + 2) % n])
        a = sp.coo_matrix((np.ones(2 * n, np.float32), (rows, cols)),
                          shape=(n, n))
        ahat = normalize_adjacency(((a + a.T) > 0).astype(np.float32))
        pv = np.arange(n) * k // n
    else:
        raise ValueError(f"unknown census fixture {kind!r}")
    return ahat, np.asarray(pv)


def audit_plan(kind: str = "er", k: int = AUDIT_K):
    """A fresh plan of the fixture (each mode builds its own layouts)."""
    from ..parallel import build_comm_plan

    ahat, pv = audit_graph(kind, k)
    return build_comm_plan(ahat, pv, k)


def audit_data(widths):
    """The fixture's features and labels, from seed 0."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((AUDIT_N, AUDIT_FIN)).astype(np.float32)
    labels = rng.integers(0, widths[-1], AUDIT_N)
    return feats, labels


def mode_widths(mode: Mode) -> tuple:
    return AUDIT_SPLIT_WIDTHS if mode.gat_form == "split" else AUDIT_WIDTHS


@contextlib.contextmanager
def aggregator_env(mode: Mode):
    """Pin ``SGCN_PALLAS_SPMM`` for the mode's aggregator while its owner
    is built and stepped (``ops/pspmm.py::ell_selected`` reads it at
    construction), restoring the caller's value after: an ambient ``0``
    must not flip a tile mode."""
    old = os.environ.get("SGCN_PALLAS_SPMM")
    os.environ["SGCN_PALLAS_SPMM"] = "0" if mode.aggregator == "ell" else "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SGCN_PALLAS_SPMM", None)
        else:
            os.environ["SGCN_PALLAS_SPMM"] = old


class RankGroupHolder:
    """The one-rank group every rank mode of a run shares, opened at first
    use (gloo on the CPU, NCCL on the card) and closed by ``close()``."""

    def __init__(self, device):
        self.device = device
        self.mesh = None
        self._dir = None

    def get(self):
        if self.mesh is None:
            import torch.distributed as dist

            from ..parallel import init_rank_group

            if dist.is_initialized():
                raise RuntimeError(
                    "the census opens its own one-rank group; a process "
                    "group is already initialized here")
            self._dir = tempfile.TemporaryDirectory(prefix="sgcn-census-")
            # NCCL on the card takes rank 0's card (cuda:0), gloo the CPU
            cpu = str(self.device) == "cpu"
            self.mesh = init_rank_group(
                "file://" + os.path.join(self._dir.name, "rendezvous"), 1,
                0, device="cpu" if cpu else None)
        return self.mesh

    def close(self):
        if self.mesh is not None:
            self.mesh.close()
            self.mesh = None
        if self._dir is not None:
            self._dir.cleanup()
            self._dir = None


# ------------------------------------------------------------ building
def build_owner(mode: Mode, device, group=None, kind: str = "er",
                k: int = AUDIT_K):
    """The real trainer or engine of ``mode`` on the ``k``-part fixture,
    with what its steps need: returns ``(owner, ctx)``; ``ctx`` holds the
    plan its expectation derives from (the slice on ranks), the data and
    the step's callable.  A rank mode takes ``group.get()``'s rank group:
    one rank runs part 0's slice, a group of ``k`` ranks its parts."""
    from ..parallel import shard_proxy_data, shard_proxy_plan
    from ..train import FullBatchTrainer
    from ..train.fullbatch import make_train_data

    widths = list(mode_widths(mode))
    feats, labels = audit_data(widths)
    full = audit_plan(kind, k)
    mesh = group.get() if mode.ranks else None
    sliced = mesh is not None and mesh.size == 1
    if mode.workload == "minibatch":
        from ..train.minibatch import MiniBatchTrainer

        ahat, pv = audit_graph(kind, k)
        mb = MiniBatchTrainer(ahat, pv, k, fin=AUDIT_FIN,
                              widths=widths, batch_size=AUDIT_MB_BATCH,
                              nbatches=2, comm_schedule=mode.schedule,
                              device=device)
        batches = mb.make_batches(feats, labels)
        return mb, {"plan": batches[0].plan, "batch": batches[0],
                    "static": batches[0].fwd_static, "data": batches[0].data,
                    "pa": batches[0].pa, "widths": widths,
                    "step": lambda: mb.step(batches[0])}
    # every lever of the mode goes to the constructor, so an unsupported
    # combination meets the constructor's own gate
    kw = {"comm_schedule": mode.schedule, "halo_dtype": mode.halo_dtype}
    carried = bool(mode.staleness or mode.replica)
    if mode.workload == "train":
        kw.update(halo_staleness=mode.staleness, halo_delta=mode.delta,
                  sync_every=2 if carried else 0,
                  replica_budget=AUDIT_REPLICA_B if mode.replica else 0,
                  compute_dtype=mode.compute_dtype)
    from ..serve import ServeEngine

    serve_kw = dict(model=mode.model, max_batch=AUDIT_BATCH,
                    buckets=(AUDIT_BATCH,), device=device,
                    mode="subgraph" if mode.workload == "serve_subgraph"
                    else "full", **kw)
    plan = full
    if sliced:
        # the stacked owner on the full plan applies every gate in the
        # constructor's order and builds the layouts; then part 0 is sliced
        if mode.workload == "train":
            FullBatchTrainer(full, fin=AUDIT_FIN, widths=widths,
                             model=mode.model, device=device, **kw)
        else:
            ServeEngine(full, fin=AUDIT_FIN, widths=widths, **serve_kw)
        plan = shard_proxy_plan(full, 0)
    if mode.workload == "train":
        tr = FullBatchTrainer(plan, fin=AUDIT_FIN, widths=widths,
                              model=mode.model, activation="relu"
                              if mode.model == "gcn" else "none",
                              device=device, mesh=mesh, **kw)
        data = (shard_proxy_data(full, mesh.rank, feats, labels,
                                 device=tr.device)
                if mesh is not None else
                make_train_data(plan, feats, labels, device=tr.device))
        return tr, {"plan": tr.plan, "data": data, "pa": tr.pa,
                    "static": tr.setup.fwd_static, "widths": widths,
                    "step": lambda: tr.step(data, sync=False)}
    eng = ServeEngine(plan, fin=AUDIT_FIN, widths=widths, mesh=mesh,
                      **serve_kw)
    eng.set_features(feats)
    own = np.flatnonzero(np.asarray(full.owner) == 0)
    rng = np.random.default_rng(1)
    qids = (rng.choice(own, AUDIT_BATCH, replace=False) if sliced
            else rng.choice(AUDIT_N, AUDIT_BATCH, replace=False))
    return eng, {"plan": eng.plan, "pa": eng.pa, "widths": widths,
                 "static": eng.setup.fwd_static, "qids": qids,
                 "step": lambda: eng.query(qids)}


def program_labels(mode: Mode) -> list[str]:
    """The steps a mode is censused on, in order, after one uncensused
    step (the Adam state and a carried mode's initializing sync): a
    carried mode's carried step and its sync step (``sync_every=2``), one
    step, or one served batch."""
    if mode.workload == "train" and mode.staleness:
        return ["stale", "sync"]
    if mode.workload == "train" and mode.replica:
        return ["rep", "sync"]
    if mode.workload in ("train", "minibatch"):
        return ["step"]
    return ["batch"]


# ------------------------------------------------------------ recording
def _inplace_snapshot(owner, ctx) -> dict:
    """What the in-place rule compares across a step: ``data_ptr`` of the
    params, the optimizer state and the in-place carries; ``_version`` of
    the plan tensors, the batch data and (serving) the params."""
    import torch

    snap = {"ptr": {}, "version": {}}
    model = owner.inner.model if hasattr(owner, "inner") else owner.model
    for i, p in enumerate(model.parameters()):
        snap["ptr"][f"param{i}"] = p.data_ptr()
        snap["version"][f"param{i}"] = p._version
    opt = getattr(owner.inner if hasattr(owner, "inner") else owner, "opt",
                  None)
    if opt is not None:
        for i, st in enumerate(opt.state.values()):
            for key, t in st.items():
                if torch.is_tensor(t) and key != "step":
                    snap["ptr"][f"opt{i}.{key}"] = t.data_ptr()
    for fam, carry in expect.inplace_carries(owner).items():
        for key, ts in carry.items():
            for j, t in enumerate(ts):
                snap["ptr"][f"{fam}.{key}{j}"] = t.data_ptr()
    for f, t in (ctx.get("pa") or {}).items():
        if torch.is_tensor(t):
            snap["version"][f"pa.{f}"] = t._version
    data = ctx.get("data")
    if data is not None:
        for f, t in vars(data).items():
            snap["version"][f"data.{f}"] = t._version
    h0 = getattr(owner, "_h0", None)
    if h0 is not None:
        snap["version"]["features"] = h0._version
    return snap


class HostReads:
    """Counts what a step reads back to the host, below autograd
    (``TorchDispatchMode``): ``reads`` — tensors read into a Python number
    (``aten::_local_scalar_dense``), and ``copies`` — device tensors copied
    to the CPU (``_to_copy`` / ``copy_``; the card only).  Two kinds of
    read are not the step's: a kernel's plain version's own host
    arithmetic (``utils/census.py::in_plain``: the CPU stand-in for a
    launch) and the optimizer's (torch's Adam keeps its step counters on
    the host and reads them in ``step()``, on the card too: host
    arithmetic, no device wait)."""

    def __init__(self):
        self.reads = 0
        self.copies = 0
        self._opt = 0

    @contextlib.contextmanager
    def watch(self):
        import torch
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)
        from torch.utils._python_dispatch import TorchDispatchMode

        from ..utils import census

        counter = self
        local = torch.ops.aten._local_scalar_dense.default
        to_copy = torch.ops.aten._to_copy.default
        copy_ = torch.ops.aten.copy_.default

        def cuda(t):
            return isinstance(t, torch.Tensor) and t.device.type == "cuda"

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if not (counter._opt or census.in_plain()):
                    if func is local:
                        counter.reads += 1
                    elif func is to_copy and cuda(args[0]) and str(
                            kwargs.get("device", "cuda")) == "cpu":
                        counter.copies += 1
                    elif func is copy_ and cuda(args[1]) \
                            and not cuda(args[0]):
                        counter.copies += 1
                return func(*args, **kwargs)

        def pre(*_a):
            counter._opt += 1

        def post(*_a):
            counter._opt -= 1

        hooks = [register_optimizer_step_pre_hook(pre),
                 register_optimizer_step_post_hook(post)]
        try:
            with Mode():
                yield self
        finally:
            for h in hooks:
                h.remove()


def _device_kernels(prof) -> dict:
    """The profiler's device kernels of the port's kernels by
    ``KERNEL_TABLE`` label, from the raw kineto events (no event tree:
    building it costs tens of seconds over a census's trace)."""
    from ..obs.tracing import kernel_label

    out = Counter()
    for ev in prof.profiler.kineto_results.events():
        if "cuda" not in str(ev.device_type()).lower():
            continue
        lab = kernel_label(ev.name())
        if lab in ("K3/K4 fused", "K1/K5", "pack"):
            out[lab] += 1
    return dict(out)


def launch_counters() -> dict:
    """The wrappers' ``.launches`` counters by census label (the card's
    kernels count there; the CPU's plain versions do not)."""
    from ..ops import row_shuffle, tile_spmm
    from ..utils.census import LAUNCH_LABELS

    fns = {"spmm_tiles": tile_spmm.spmm_tiles,
           "spmm_tiles_fused": tile_spmm.spmm_tiles_fused,
           "row_pack": row_shuffle.row_pack,
           "row_pack_into": row_shuffle.row_pack_into,
           "row_shuffle": row_shuffle.row_shuffle}
    return {label: getattr(fns[fn], attr)
            for label, (_tab, fn, attr) in LAUNCH_LABELS.items()}


def record_step(step, device, snapshot=None) -> dict:
    """Run ``step()`` once under a census recording and ``HostReads``;
    returns ``{records, host, counters, after}`` (``host``: reads and
    copies; ``counters``: the wrappers' counter deltas; ``after``:
    ``snapshot()`` taken after the step, if given)."""
    from ..utils import census
    from ..utils.backend import synchronize

    synchronize(device)
    before = launch_counters()
    host = HostReads()
    with census.recording() as recs, host.watch():
        step()
    synchronize(device)
    after = launch_counters()
    return {"records": list(recs),
            "host": {"host_reads": host.reads, "dtoh_copies": host.copies},
            "counters": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "after": snapshot() if snapshot is not None else None}


@contextlib.contextmanager
def device_window(device):
    """On the card: one ``torch.profiler`` window and a hook ``tally`` over
    the block; yields a dict that holds, after the block, the device
    kernels by ``KERNEL_TABLE`` label and the hooks' launches by the same
    labels, and a ``launch-census`` violation where they differ.  One
    window for a whole census (a window a step lost kernel events in one
    of 138 steps on the card), read from the raw kineto events (the event
    tree took most of a 60 s census on the card).  On the CPU the dict
    stays empty."""
    import torch

    from ..utils import census
    from ..utils.backend import synchronize
    from ..utils.census import LAUNCH_LABELS

    out: dict = {}
    if torch.device(device).type != "cuda":
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # let the device's activity records start before the count: in
        # the smoke script's process, which had profiled before, a window
        # that counted at once missed 3 packs and 3 fused launches (one
        # GCN step's) of 1504; run alone it missed none
        synchronize(device)
        time.sleep(WINDOW_SETTLE_S)
        with census.tally() as tally:
            yield out
            synchronize(device)
    hooks = Counter()
    for label, n in tally.items():
        hooks[LAUNCH_LABELS[label][0]] += n
    out["kernels"] = _device_kernels(prof)
    out["hooks"] = dict(hooks)
    out["violations"] = [] if out["kernels"] == out["hooks"] else [_viol(
        "launch-census", f"the profiler's device kernels {out['kernels']} "
        f"!= the hooks' launches by KERNEL_TABLE label {out['hooks']}")]


def _viol(rule: str, detail: str) -> dict:
    return {"rule": rule, "detail": detail}


def census_mode(mode: Mode, device="cpu", group=None, kind: str = "er"
                ) -> dict:
    """Build ``mode``'s owner, run its warm step, census each of its
    programs and check them; returns the mode's report entry ``{ok,
    programs: {label: {ok, violations, census}}}``."""
    own_group = group is None and mode.ranks
    if own_group:
        group = RankGroupHolder(device)
    try:
        with aggregator_env(mode):
            owner, ctx = build_owner(mode, device, group, kind)
            expect.check_selection(owner, mode)
            ctx["step"]()                           # warm, uncensused
            entry: dict = {"ok": True, "programs": {}}
            for label in program_labels(mode):
                snap = _inplace_snapshot(owner, ctx)
                rec = record_step(ctx["step"], device,
                                  lambda: _inplace_snapshot(owner, ctx))
                exp = expect.expectation(owner, ctx, mode, label, kind)
                violations = expect.check(rec, snap, exp, mode, device)
                entry["programs"][label] = {
                    "ok": not violations, "violations": violations,
                    "census": summarize(rec)}
                entry["ok"] = entry["ok"] and not violations
            _close_owner(owner, mode)
            return entry
    finally:
        if own_group:
            group.close()


def _close_owner(owner, mode) -> None:
    if mode.ranks and mode.workload != "train":
        owner.close()                   # the stop header: outside a census


def summarize(rec: dict) -> dict:
    """The report's census of one step: launches and collectives per label
    with their ``(shape, dtype)`` multisets, host reads, and on the card
    the counter deltas and device-to-host copies."""
    launches, colls = Counter(), Counter()
    shapes: dict = {}
    for r in rec["records"]:
        (launches if r.kind == "launch" else colls)[r.label] += 1
        shapes.setdefault(r.label, []).append(
            f"{'x'.join(map(str, r.shape))}:{r.dtype}")
    out = {"launches": dict(sorted(launches.items())),
           "collectives": dict(sorted(colls.items())),
           "shapes": {k: sorted(v) for k, v in sorted(shapes.items())},
           "host_reads": rec["host"]["host_reads"]}
    if rec["counters"]:
        out["counters"] = rec["counters"]
        out["dtoh_copies"] = rec["host"]["dtoh_copies"]
    return out


def run_census(modes=None, fast: bool = False, device="cpu") -> dict:
    """Census the mode matrix; returns the report's ``census`` block
    ``{modes: {mode_id: entry}, ok, n_modes, device}`` (on the card also
    ``device_window``: ``device_window``'s kernels against the hooks over
    the whole run).  ``fast``: the two-mode subset (or the ``modes``
    given, alone); the full run also censuses the banded fixture's ring
    modes (``modes.banded_modes``), whose ring keeps 2 of k−1 rounds."""
    from ..ops.pspmm import ragged_live_rounds

    if modes is None:
        modes = fast_modes() if fast else supported_modes()
    out: dict = {"modes": {}, "ok": True, "device": str(device),
                 "rules": list(CENSUS_RULES)}
    group = RankGroupHolder(device)
    try:
        with device_window(device) as window:
            for mode in modes:
                entry = census_mode(mode, device, group)
                out["modes"][mode.mode_id] = entry
                out["ok"] = out["ok"] and entry["ok"]
            if not fast:
                banded = audit_plan("banded")
                live = ragged_live_rounds(banded.ragged_round_sizes())
                if len(live) >= AUDIT_K - 1:
                    raise AssertionError("the banded fixture lost its empty "
                                         "rounds: its census checks nothing")
                for mode in banded_modes():
                    entry = census_mode(mode, device, group, kind="banded")
                    out["modes"][mode.mode_id + "@banded"] = entry
                    out["ok"] = out["ok"] and entry["ok"]
    finally:
        group.close()
    if window:
        out["device_window"] = window
        out["ok"] = out["ok"] and not window["violations"]
    out["n_modes"] = len(out["modes"])
    return out


# ------------------------------------------------------------ memory
def memory_pass(modes=None, fast: bool = False, device="cuda") -> dict:
    """Measure one step of each mode on the card and reconcile it with the
    owner's analytic footprint (``obs/memory.py::measure_device_step`` +
    ``reconcile``, the ``memory-model`` rule); returns the report's
    ``memory`` block.  The card only: the CPU has no allocator to read,
    and a pass that measured nothing must not pass."""
    import torch

    from ..obs.memory import MEM_MODEL_TOL, measure_device_step, reconcile

    if torch.device(device).type != "cuda":
        raise RuntimeError(
            "the memory pass measures the card's allocator "
            "(obs/memory.py::measure_device_step); it has nothing to "
            "measure on the CPU — run it on the card (drop --device cpu)")
    if modes is None:
        modes = fast_modes() if fast else supported_modes()
    out: dict = {"modes": {}, "ok": True, "tol": MEM_MODEL_TOL}
    group = RankGroupHolder(device)
    try:
        for mode in modes:
            with aggregator_env(mode):
                owner, ctx = build_owner(mode, device, group)
                ctx["step"]()
                tr = owner.inner if hasattr(owner, "inner") else owner
                updated = (tr._updated_tensors()
                           if hasattr(tr, "_updated_tensors") else ())
                if hasattr(tr, "opt"):
                    tr.opt.zero_grad(set_to_none=True)
                measured = measure_device_step(ctx["step"], owner.device,
                                               tr._mem_base, updated)
                rec = reconcile(tr.memory, measured)
                entry = {"ok": rec["ok"],
                         "violations": [{"rule": "memory-model",
                                         "detail": v}
                                        for v in rec["violations"]],
                         "model_bytes": tr.memory.total_bytes,
                         "measured": measured,
                         "ratio": rec["block"]["total"]["ratio"]}
                _close_owner(owner, mode)
            out["modes"][mode.mode_id] = entry
            out["ok"] = out["ok"] and entry["ok"]
    finally:
        group.close()
    out["n_modes"] = len(out["modes"])
    return out
