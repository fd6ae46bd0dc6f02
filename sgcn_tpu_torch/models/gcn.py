"""Partitioned GCN: per-layer stack over the tile-SpMM aggregator, and its
losses.

Port of ``sgcn_tpu/models/gcn.py``: its tile-kernel branches
(``gcn_forward_local``, over the dense a2a exchange or the ragged ring,
and on an asymmetric Â the ``pspmm_overlap`` branch, a2a only, stacked
or one process per part), of
``gcn_forward_local_stale`` (the pipelined trainer's forward, with its
replica × stale branch, both transports) and of
``gcn_forward_local_replica`` (hot-halo replicas, both transports, and
the partial refresh on the a2a), and under ``SGCN_PALLAS_SPMM=0`` its
ELL branches (``pspmm_ell_sym``, ``pspmm_ragged_sym``, ``pspmm_overlap``:
``ops/pspmm.py``, stacked or one process per part), run over all ``k``
parts stacked on a leading axis: per layer, halo
exchange → tile SpMM → dense projection → activation, with the
reference's project-first layer order.  Weights keep
the reference's layout, ``(fin, fout)`` with ``h @ w``, so
``params_from_jax`` carries the JAX package's weights across unchanged.

The masked losses and metrics take stacked ``(k, b, ·)`` tensors; each of
the reference's ``lax.psum`` over chips is a sum over the ``k`` axis of
the per-part sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.pspmm import (ell_aggregate, exchange_recv, narrow_dtype,
                         ring_concat, settle)
from ..ops.row_shuffle import row_pack
from ..ops.tile_spmm import (pspmm_tiles_gen, pspmm_tiles_gen_ranks,
                              pspmm_tiles_ragged, pspmm_tiles_ranks,
                              pspmm_tiles_replica,
                              pspmm_tiles_stale, pspmm_tiles_stale_ragged,
                              pspmm_tiles_sym)
from .activations import get_activation

# Minimum input width (f32 elements) for the project-before-aggregate
# layer order.  Structural default MEASURED ON THE TPU (v5e) and kept so
# this port's layer order, and hence its numbers, match the reference's;
# it is to be re-measured on the H100 (ROADMAP).
PROJECT_FIRST_MIN_FIN = 256


def exchange_widths(fin: int, widths) -> list[int]:
    """Per-layer exchanged/aggregated row width under the project-first
    rule of ``gcn_forward_local``."""
    out, f = [], fin
    for w in widths:
        out.append(w if (w < f and f >= PROJECT_FIRST_MIN_FIN) else f)
        f = w
    return out


def init_gcn_params(generator: torch.Generator, dims, device="cpu"):
    """Glorot-uniform weight list, one ``(fin, fout)`` float32 matrix per
    layer, drawn from ``generator`` (the port's own init — a
    ``torch.Generator`` gives other numbers than ``jax.random``, so parity
    tests carry the reference's weights over with ``params_from_jax``)."""
    out = []
    for fin, fout in dims:
        lim = math.sqrt(6.0 / (fin + fout))
        w = torch.empty((fin, fout), dtype=torch.float32)
        w.uniform_(-lim, lim, generator=generator)
        out.append(w.to(device))
    return out


def params_from_jax(params, device="cpu"):
    """The JAX package's GCN params (a list of ``(fin, fout)`` arrays,
    passed as numpy) → float32 tensors on ``device``, same layout."""
    return [torch.tensor(np.asarray(w, np.float32), device=device)
            for w in params]


def weight_tensors(params, device="cpu"):
    """Weights given as numpy arrays (e.g. the JAX package's) or tensors
    → float32 copies on ``device``."""
    return [w.detach().to(device, torch.float32, copy=True)
            if isinstance(w, torch.Tensor)
            else torch.tensor(np.asarray(w, np.float32), device=device)
            for w in params]


def gcn_forward_local(
    params,
    h,                              # (k, B, f_in) stacked local rows
    pa,                             # plan tensors (TILE_PLAN_FIELDS, or
                                    # TILE_PLAN_FIELDS_RAGGED)
    activation: str = "relu",
    final_activation: str = "none",
    pallas_tb: int = 256,           # static tile height
    pallas_lclasses: tuple = (),    # static local tile classes
    pallas_hclasses: tuple = (),    # static halo tile classes
    comm_schedule: str = "a2a",     # static: 'a2a' (dense exchange) or
                                    # 'ragged' (the ring)
    rr_sizes: tuple | None = None,  # static plan.rr_sizes (ragged)
    halo_dtype: str | None = None,  # wire-only exchange dtype ('bfloat16')
    compute_dtype: str | None = None,  # the forward's dtype ('bfloat16'):
                                    # the weights and h are cast to it
    symmetric: bool = True,         # static: False for an asymmetric Â
                                    # (TILE_PLAN_FIELDS_GEN)
    pallas_tlclasses: tuple = (),   # static transposed classes (asymmetric)
    pallas_thclasses: tuple = (),
    pallas_t1classes: tuple = (),
    remat: bool = False,            # recompute each layer in the backward
    mesh=None,                      # a RankGroup: one process per part
    aggregator: str = "tile",       # static: 'tile' or 'ell'
                                    # (SGCN_PALLAS_SPMM=0)
    ell_layout: str | None = None,  # static ELL chain layout ('a2a',
                                    # 'ragged', 'directed')
    ell_buckets: tuple | None = None,  # static plan.ell_buckets
    ell_levels: dict | None = None,  # static chain level sizes
):
    """Stacked forward: L × (tile pspmm ⊗ dense matmul → activation) →
    ``(k, B, nout)``.  A wide input narrowed by the layer is projected
    first (``(Â·H)·W = Â·(H·W)``), so the exchange and the SpMM touch the
    narrower rows — the reference's rule and threshold.  Under
    ``comm_schedule='ragged'`` each aggregation rides the ring
    (``pspmm_tiles_ragged``), bit-identical to the a2a flavor.

    ``halo_dtype`` narrows every exchange's wire (both aggregations and,
    in training, their backward).  ``compute_dtype='bfloat16'`` runs the
    layers in bf16, as the reference's trainer does under mixed precision
    (``sgcn_tpu/train/fullbatch.py::_forward``): weights and ``h`` cast to
    bf16 here (autograd carries float32 gradients back to float32 master
    weights), bf16 tables into the kernel, each aggregation rounded once
    to bf16, bf16 matmuls; the result stays bf16 (the caller upcasts).

    ``remat=True`` (with autograd recording) runs each layer inside a
    non-reentrant ``torch.utils.checkpoint``: the forward keeps only the
    layer inputs, and the backward re-runs one layer at a time (its
    exchange and fused launch included) before differentiating it, so at
    most one layer's intermediates are live.  Same bits as without.

    ``mesh`` (a ``parallel/mesh.py::RankGroup``): one process per part,
    ``h`` the rank's ``(1, B, f)`` rows and ``pa`` its slice's tensors;
    each aggregation is ``pspmm_tiles_ranks`` on either transport (its
    exchange overlapped with the local pass; under ``compute_dtype`` K1's
    bf16 family entry in two launches, then one float32 add and one
    rounding to bf16: the fused bf16 entry's arithmetic), the same bits
    as the stacked forward's row for that part; on an asymmetric plan
    (a2a) ``pspmm_tiles_gen_ranks``, whose backward sends the halo rows'
    partials back to their owners with the reverse ``all_to_all_single``.
    Under ``remat`` the checkpoint re-runs each layer's collectives in the
    backward, in the same order on every rank.

    ``aggregator='ell'`` (``SGCN_PALLAS_SPMM=0``; ``ops/pspmm.py::
    choose_ell_dispatch`` gives the ``ell_*`` statics) aggregates with the
    reference's ELL ops instead of the tile kernel: ``PspmmEllSym`` on the
    a2a, ``PspmmRaggedSym`` on the ring, ``PspmmOverlap`` on an
    asymmetric plan (``ops/pspmm.py::ell_aggregate``); one pack per
    exchange, the sums in torch ops.  On a rank group (``mesh``) the
    same ops over the rank's slice's chains, each exchange the rank's
    collective overlapped with the local pass."""
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)
    dt = narrow_dtype(compute_dtype, "compute_dtype")
    if dt is not None:
        params = [w.to(dt) for w in params]
        h = h.to(dt)

    if not symmetric and comm_schedule != "a2a":
        raise ValueError(
            "comm_schedule='ragged' uses the symmetric custom backward "
            "(the gradient rides the same ring); asymmetric plans run "
            "the a2a schedule")
    tclasses = (pallas_tlclasses, pallas_thclasses, pallas_t1classes)
    if aggregator == "ell":
        static = {"ell_layout": ell_layout, "ell_buckets": ell_buckets,
                  "ell_levels": ell_levels, "rr_sizes": rr_sizes}

        def agg(x):
            return ell_aggregate(x, pa, static, halo_dtype, mesh)
    elif aggregator != "tile":
        raise ValueError(f"unknown aggregator {aggregator!r} (know 'tile', "
                         "'ell')")
    elif mesh is not None and not symmetric:
        def agg(x):
            return pspmm_tiles_gen_ranks(x, pa, pallas_tb, pallas_lclasses,
                                         pallas_hclasses, tclasses, mesh,
                                         halo_dtype)
    elif mesh is not None:
        if comm_schedule == "ragged" and rr_sizes is None:
            raise ValueError("the ragged GCN forward needs the plan's "
                             "static rr_sizes (CommPlan.ensure_ragged)")

        def agg(x):
            return pspmm_tiles_ranks(
                x, pa, pallas_tb, pallas_lclasses, pallas_hclasses, mesh,
                rr_sizes if comm_schedule == "ragged" else None, halo_dtype)
    elif not symmetric:
        def agg(x):
            return pspmm_tiles_gen(x, pa, pallas_tb, pallas_lclasses,
                                   pallas_hclasses, tclasses, halo_dtype)
    elif comm_schedule == "ragged":
        if rr_sizes is None:
            raise ValueError("the ragged GCN forward needs the plan's "
                             "static rr_sizes (CommPlan.ensure_ragged)")

        def agg(x):
            return pspmm_tiles_ragged(
                x, pa["ring_src"],
                pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
                pa["ptile_hrsrc"], pa["ptile_hld"], pa["ptile_hw"],
                pallas_tb, pallas_lclasses, pallas_hclasses, rr_sizes,
                halo_dtype)
    elif comm_schedule == "a2a":
        def agg(x):
            return pspmm_tiles_sym(
                x, pa["recv_src"],
                pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
                pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"],
                pallas_tb, pallas_lclasses, pallas_hclasses, halo_dtype)
    else:
        raise ValueError(f"unknown comm_schedule {comm_schedule!r} (the "
                         "trainer resolves 'auto' before the forward)")

    def layer(h, w, last):
        if w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN:
            z = agg(h @ w)
        else:
            z = agg(h) @ w
        return fact(z) if last else act(z)

    remat = remat and torch.is_grad_enabled()
    for i, w in enumerate(params):
        h = (checkpoint(layer, h, w, i == nl - 1, use_reentrant=False)
             if remat else layer(h, w, i == nl - 1))
    return h


def gcn_forward_local_stale(
    params,
    h,                              # (k, B, f_in) stacked local rows
    pa,                             # plan tensors (TILE_PLAN_FIELDS, or
                                    # TILE_PLAN_FIELDS_RAGGED)
    halos,                          # per-layer feature carries (step t−1)
    ghalos,                         # per-layer gradient carries (step t−1)
    gholder,                        # list the backward writes the next
                                    # gradient carries into
    activation: str = "relu",
    final_activation: str = "none",
    pallas_tb: int = 256,
    pallas_lclasses: tuple = (),
    pallas_hclasses: tuple = (),
    comm_schedule: str = "a2a",
    rr_sizes: tuple | None = None,
    delta: bool = False,            # the halo-delta cache on the wire
    wire_dtype: str | None = None,  # the feature wire's dtype
    gwire_dtype: str | None = None,  # the gradient wire's dtype
    fresh: bool = False,            # a sync step (exact math)
    gauges: bool = False,           # also return the per-layer qerr
    replica: bool = False,          # replicas composed in: stale steps
                                    # ship the kept rows alone
    mesh=None,                      # a RankGroup: one process per part
    bases=None,                     # a rank's per-layer delta baselines
    nrep_rr_sizes: tuple | None = None,  # static plan.nrep_rr_sizes (a
                                    # rank's shrunken ring)
):
    """Stacked forward under the pipelined stale-halo exchange (port of
    ``gcn_forward_local_stale``, its replica × stale branch included).

    The layer math and project-first order of ``gcn_forward_local``
    (``exchange_widths`` encodes the same rule, so the carries' widths
    stay in step with it), with every aggregation a stale op
    (``pspmm_tiles_stale``, or ``pspmm_tiles_stale_ragged`` under
    ``comm_schedule='ragged'``): layer ℓ reads ``halos[ℓ]`` and issues
    step t's exchange into the next carry.  The carries are in the
    receive layout of the transport (``ops/pspmm.py::stale_exchange``).
    Returns ``(out, new_halos)``; the backward writes each layer's next
    gradient carry into ``gholder[ℓ]``.  Symmetric Â and float32 only
    (the trainer gates them).

    ``gauges=True`` also returns, per layer, ``Σ (full − carry_next)²``
    over the send buffer — this step's halo-delta rounding residual (zero
    without ``delta`` and on sync steps): ``(out, new_halos, qerrs)``.
    Its extra pack of the full rows runs only then.

    ``replica=True`` (``replica_budget`` with ``halo_staleness=1``): a
    stale step ships only the kept rows (the plan's ``keep_*`` lists, in
    ``pa``) into the carry, whose replica slots keep their last-sync rows
    (``pspmm_replica_stale[_ragged]``); a sync step is the stale mode's.
    No ``delta`` with it (the trainer gates the composition).

    ``mesh`` (a ``parallel/mesh.py::RankGroup``): one process per part,
    ``h`` the rank's ``(1, B, f)`` rows and ``pa`` its slice's tensors
    (with ``replica``, ``REPLICA_RANK_FIELDS[_RAGGED]``).  Each layer's
    exchange is issued and left in flight: the carries come back as
    ``ops/pspmm.py::InFlight`` objects that the next read waits on
    (``ops/tile_spmm.py::_rank_stale_step``).  Under ``delta`` the
    senders' baselines are ``bases``, one ``(1, J, f)`` float32 tensor a
    layer, replaced in place, and the qerr gauge reads the rank's own
    send pack against them: the same slots as the stacked receive
    layout's, summed on the rank."""
    if replica and delta:
        raise ValueError(
            "replica × stale × delta is deferred: the delta baseline and "
            "the replica carry would disagree on what a stale step ships "
            "(docs/replication.md)")
    if comm_schedule not in ("a2a", "ragged"):
        raise ValueError(f"unknown comm_schedule {comm_schedule!r} "
                         "(the trainer resolves 'auto' before the forward)")
    if comm_schedule == "ragged" and rr_sizes is None:
        raise ValueError("the stale ragged forward needs the plan's static "
                         "rr_sizes (CommPlan.ensure_ragged)")
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)
    new_halos, qerrs = [], []
    ragged = comm_schedule == "ragged"
    for i, w in enumerate(params):
        project_first = (w.shape[1] < h.shape[-1]
                         and h.shape[-1] >= PROJECT_FIRST_MIN_FIN)
        x = (h @ w) if project_first else h
        mode = dict(delta=delta, wire_dtype=wire_dtype,
                    gwire_dtype=gwire_dtype, fresh=fresh, gholder=gholder,
                    layer=i)
        if mesh is not None:
            mode.update(mesh=mesh, bases=bases)
        if replica and mesh is not None:
            mode["keep"] = rank_keep(pa, comm_schedule, nrep_rr_sizes)
        elif replica:
            pre = "keep_ring" if comm_schedule == "ragged" else "keep_recv"
            mode["keep"] = (pa[f"{pre}_src"], pa[f"{pre}_dst"])
        if comm_schedule == "ragged":
            z, hn = pspmm_tiles_stale_ragged(
                x, halos[i], ghalos[i], pa["ring_src"],
                pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
                pa["ptile_hrsrc"], pa["ptile_hld"], pa["ptile_hw"],
                pallas_tb, pallas_lclasses, pallas_hclasses, rr_sizes,
                **mode)
        else:
            z, hn = pspmm_tiles_stale(
                x, halos[i], ghalos[i], pa["recv_src"],
                pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
                pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"],
                pallas_tb, pallas_lclasses, pallas_hclasses, **mode)
        if gauges:
            # a sync step re-bases with the full row: its residual is 0
            if delta and not fresh and mesh is not None:
                # the rank's own send pack against its baselines: the
                # values its receivers now hold
                full = row_pack(x.detach().contiguous(),
                                pa["ring_src" if ragged else "recv_src"])
                qerrs.append(torch.sum(torch.square(full - bases[i]),
                                       dtype=torch.float64))
            elif delta and not fresh:
                full = (ring_concat(x.detach(), pa["ring_src"], rr_sizes)
                        if comm_schedule == "ragged"
                        else exchange_recv(x.detach(), pa["recv_src"]))
                qerrs.append(torch.sum(torch.square(full - hn),
                                       dtype=torch.float64))
            else:
                qerrs.append(x.new_zeros(()))
        if not project_first:
            z = z @ w
        new_halos.append(hn)
        h = fact(z) if i == nl - 1 else act(z)
    if gauges:
        return h, new_halos, qerrs
    return h, new_halos


def gcn_forward_local_replica(
    params,
    h,                              # (k, B, f_in) stacked local rows
    pa,                             # plan tensors (the transport's tile
                                    # fields + REPLICA_TILE_FIELDS[_RAGGED],
                                    # + REPLICA_PARTIAL_TILE_FIELDS)
    carries,                        # per-layer feature carries
    gcarries,                       # per-layer gradient carries
    gholder,                        # list the backward writes the next
                                    # gradient carries into
    activation: str = "relu",
    final_activation: str = "none",
    pallas_tb: int = 256,
    pallas_lclasses: tuple = (),
    pallas_hclasses: tuple = (),
    comm_schedule: str = "a2a",
    rr_sizes: tuple | None = None,
    halo_dtype: str | None = None,  # the wire's dtype, both directions
    fresh: bool = False,            # a refresh (sync) step: exact math
    rep_base=None,                  # per-layer (k, RS, f) baselines
                                    # (refresh_band only)
    partial_step: bool = False,     # this step is the partial refresh
    band: float = 0.0,              # the relative drift band
    mesh=None,                      # a RankGroup: one process per part
    nrep_rr_sizes: tuple | None = None,  # static plan.nrep_rr_sizes (a
                                    # rank's shrunken ring)
):
    """Stacked forward under hot-halo replicas (port of
    ``gcn_forward_local_replica``): the layer math and project-first
    order of ``gcn_forward_local`` with every aggregation a replica op
    (``pspmm_tiles_replica``).  The carries are the transport's receive
    layout; a sync step (``fresh``) runs the exact exchange into new ones
    (the stale op's sync step, ``pspmm_tiles_stale[_ragged]`` with
    ``fresh``; float32 under ``rep_base``), a replica step packs only the
    kept rows into them in place, so
    the replica slots hold the last sync's rows; ``partial_step`` (a2a,
    with ``rep_base``) also ships the rows whose drift passes ``band``
    (``ops/pspmm.py::partial_refresh``).  Returns ``(out, new_carries,
    new_bases, nships)`` — ``new_bases`` under ``rep_base`` (a sync step
    re-anchors them at the wire-rounded rows the consumers received),
    ``nships`` the per-layer refreshed copies of a partial step (else
    ``None``); the backward writes each layer's next gradient carry into
    ``gholder[ℓ]``.  Symmetric Â and float32 only (the trainer gates
    them).

    ``mesh``: one process per part (``pa`` the rank's slice tensors with
    ``REPLICA_RANK_FIELDS[_RAGGED]`` and ``REPLICA_PARTIAL_RANK_FIELDS``):
    a replica step issues the shrunken exchange, runs the local family,
    waits, packs the received rows into the carry and runs the halo
    family over it (``ops/tile_spmm.py::_rank_replica_step``); a sync
    step is the rank's stale op with ``fresh``; ``nships`` are the
    rank's own counts."""
    if comm_schedule not in ("a2a", "ragged"):
        raise ValueError(f"unknown comm_schedule {comm_schedule!r} "
                         "(the trainer resolves 'auto' before the forward)")
    if comm_schedule == "ragged" and rr_sizes is None:
        raise ValueError("the ragged replica forward needs the plan's "
                         "static rr_sizes (CommPlan.ensure_ragged)")
    if partial_step and (rep_base is None or comm_schedule != "a2a"):
        raise ValueError(
            "the partial refresh step needs the threaded baselines "
            "(track_base=True) and rides the dense a2a transport only "
            "(docs/replication.md)")
    ragged = comm_schedule == "ragged"
    pre = "keep_ring" if ragged else "keep_recv"
    if mesh is not None:
        keep = rank_keep(pa, comm_schedule, nrep_rr_sizes)
    else:
        keep = (pa[f"{pre}_src"], pa[f"{pre}_dst"])
    if ragged:
        src, hsrc, ring = pa["ring_src"], pa["ptile_hrsrc"], (rr_sizes,)
    else:
        src, hsrc, ring = pa["recv_src"], pa["ptile_hwsrc"], ()
    sync_op = pspmm_tiles_stale_ragged if ragged else pspmm_tiles_stale
    tiles = (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"], hsrc,
             pa["ptile_hld"], pa["ptile_hw"], pallas_tb, pallas_lclasses,
             pallas_hclasses)
    ranked = {} if mesh is None else {"mesh": mesh}
    side = None
    if rep_base is not None:
        side = {name: pa[name] for name in (
            ("rep_rows_flat", "rep_row_valid", "ronly_base_pos",
             "ronly_send_counts", "rep_recv_src") if mesh is not None
            else ("rep_rows_flat", "rep_row_valid", "rep_base_flat",
                  "rep_src_flat"))}
        side["rep_dst"] = pa["rep_recv_dst"]
    kind = "partial" if partial_step else "replica"
    wdt = narrow_dtype(halo_dtype)
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)
    new_carries, new_bases, nships = [], [], []
    for i, w in enumerate(params):
        project_first = (w.shape[1] < h.shape[-1]
                         and h.shape[-1] >= PROJECT_FIRST_MIN_FIN)
        x = (h @ w) if project_first else h
        if fresh:
            z, cn = sync_op(x, carries[i], gcarries[i], src, *tiles, *ring,
                            wire_dtype=halo_dtype, gwire_dtype=halo_dtype,
                            fresh=True, gholder=gholder, layer=i, **ranked)
            # the partial refresh's replicas are float32
            cn, bn, ns = cn.to(settle(carries[i]).dtype), None, None
        else:
            z, cn, bn, ns = pspmm_tiles_replica(
                x, carries[i], gcarries[i], keep, tiles, kind,
                halo_dtype=halo_dtype, gholder=gholder, layer=i,
                base=None if rep_base is None else rep_base[i], side=side,
                band=band, **ranked)
        if rep_base is not None and fresh:
            # a full refresh re-anchors the senders' baselines at what the
            # consumers received: the wire-rounded rows (no gradient)
            with torch.no_grad():
                k, rs = pa["rep_rows_flat"].shape
                bn = x.detach().reshape(-1, x.shape[-1]).index_select(
                    0, pa["rep_rows_flat"].reshape(-1).long()).reshape(
                        k, rs, -1)
                if wdt is not None:
                    bn = bn.to(wdt).to(x.dtype)
                bn = bn * pa["rep_row_valid"][..., None].to(x.dtype)
        if not project_first:
            z = z @ w
        new_carries.append(cn)
        new_bases.append(bn)
        nships.append(ns)
        h = fact(z) if i == nl - 1 else act(z)
    return h, new_carries, new_bases, nships


def rank_keep(pa, comm_schedule: str, nrep_rr_sizes=None) -> tuple:
    """A rank's shrunken exchange from its slice tensors: ``(send, nsrc,
    dst, rr_sizes)`` — the shrunken send list it packs (``nrep_send_idx``
    flat, or ``nrep_rsend_idx`` on the ring with its static round sizes)
    and where each received row goes in the carried layout."""
    if comm_schedule == "ragged":
        if nrep_rr_sizes is None:
            raise ValueError("a rank's ragged replica exchange needs the "
                             "plan's static nrep_rr_sizes")
        return (pa["nrep_rsend_idx"], pa["keep_nring_src"],
                pa["keep_ring_dst"], tuple(nrep_rr_sizes))
    return (pa["nrep_send_idx"].reshape(1, -1), pa["keep_nrecv_src"],
            pa["keep_recv_dst"], None)


class GCN(nn.Module):
    """The GCN as a module: the weights (numpy arrays or tensors, copied)
    as trainable parameters, the plan's static tile structure as
    attributes, ``forward(h, pa)`` over stacked parts.  Callers that only
    infer run it under ``torch.inference_mode()`` (the serve engine
    does)."""

    def __init__(self, params, activation: str = "relu",
                 final_activation: str = "none", fwd_static=None):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(w) for w in weight_tensors(params))
        self.activation = activation
        self.final_activation = final_activation
        self.fwd_static = dict(fwd_static or {})
        self.remat = False            # checkpoint each layer (the trainer's)

    def layer_params(self) -> list:
        """Per layer the ``(fin, fout)`` weight (the live parameters)."""
        return list(self.weights)

    def forward(self, h, pa):
        return gcn_forward_local(
            list(self.weights), h, pa, activation=self.activation,
            final_activation=self.final_activation, remat=self.remat,
            **self.fwd_static)


def _picked(logp, labels):
    """``logp[..., labels]`` per row: ``(k, b, c)``, ``(k, b)`` → ``(k, b)``."""
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def _count(valid, group):
    """Valid rows over the parts: summed over the stacked axis, and over
    the ranks of ``group`` (a ``RankGroup``) when given."""
    count = valid.sum(dim=-1).sum()
    return count if group is None else group.all_reduce_sum(count)


def masked_softmax_xent_local(logits, labels, valid, group=None):
    """Global mean softmax cross-entropy over valid (non-padding) rows:
    per-part sums, then the sum over parts (the reference's ``psum``);
    a batch with no valid row divides by 1, not 0.  ``group`` (one
    process per part): the count is all-reduced, so each rank returns its
    share of the one global mean (its total over the global count), whose
    sum over the ranks is the loss and whose gradient is the rank's."""
    picked = _picked(torch.log_softmax(logits, dim=-1), labels)
    total = (-(picked * valid).sum(dim=-1)).sum()
    return total / torch.clamp(_count(valid, group), min=1.0)


def masked_sigmoid_bce_local(logits, labels, valid, group=None):
    """Global mean elementwise sigmoid + BCE against one-hot targets (the
    MPI trainer's loss flavor), in the stable softplus form; ``group`` as
    in ``masked_softmax_xent_local``."""
    y = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    bce = (torch.clamp(logits, min=0) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    total = (bce * valid[..., None]).sum(dim=(-2, -1)).sum()
    return total / torch.clamp(_count(valid, group), min=1.0)


def masked_err_local(logits, labels, valid):
    """The MPI stack's printed ``err``: Σ −y·log σ(z) over valid rows,
    summed (not averaged) over parts."""
    picked = _picked(F.logsigmoid(logits), labels)
    return (-(picked * valid).sum(dim=-1)).sum()


def masked_accuracy_local(logits, labels, valid, group=None):
    """Global accuracy over valid rows (hits and count all-reduced over
    ``group``'s ranks when given)."""
    hits = ((logits.argmax(dim=-1) == labels.long()) * valid).sum()
    if group is not None:
        hits = group.all_reduce_sum(hits)
    return hits / torch.clamp(_count(valid, group), min=1.0)
