"""One part's share of a k-way plan on one device (port of
``sgcn_tpu/parallel/proxy.py``).

Every per-part array of a ``CommPlan`` is padded to one shape across
parts, so part ``c``'s program — the send pack, the fused launch over its
tiles, the dense products, the loss, the backward, Adam — has the same
shapes, launches and work on every part; only index contents differ.
``shard_proxy_plan`` cuts that program out: a ``k = 1`` plan holding part
``c``'s slice, which the stacked trainer and serve engine run unchanged.
``send_idx`` stays ``(1, k, S)``, so the pack writes the full ``(k·S)``
receive window in one launch.  The exchange is a loopback: receive slot
``q·S + t`` holds the part's own row ``send_idx[c, q, t]`` (the
reference's "halo contents are the chip's own sent rows"), which changes
no shape, launch or FLOP, only the values.

The slice is cut by the plan's explicit field classification
(``parallel/plan.py``): ``PER_CHIP_ARRAY_FIELDS`` are sliced to
``[c:c+1]``, ``_GLOBAL_ARRAY_FIELDS`` pass through, and the port-only
flat indices over the stacked layout (``REBASED_ARRAY_FIELDS``) are
re-based by the rules in ``REBASE``.  A replica step's loopback is that
of the SHRUNKEN exchange (``nrep_*``), and the partial refresh's that of
its side channel: the values a one-rank group's collectives and the
reference proxy's size-1 collective deliver.  Any other dataclass array that
looks stacked per part raises.  A lazy layout (the ring, the GAT tiles,
the transposed layouts, the replicas) is sliced only if it was built on
the full plan first; a slice that lacks one raises when the trainer asks
for it.

The same slice is what one rank of the rank runtime holds
(``parallel/mesh.py``, ``train/fullbatch.py``): its send pack is the
loopback's pack, and a collective replaces the loopback.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .plan import (_GLOBAL_ARRAY_FIELDS, PER_CHIP_ARRAY_FIELDS,
                   REBASED_ARRAY_FIELDS, CommPlan)


def _loopback(plan, c):
    return np.ascontiguousarray(plan.send_idx[c].reshape(-1), np.int32)


def _ring_stride(plan):
    return max(1, int(sum(plan.rr_sizes)))


def _part_entries(plan, c, dst, stride):
    """Mask and re-based destinations of the entries of a flat list whose
    destination ``q·stride + j`` lies in part ``c``."""
    dst = np.asarray(dst, np.int64)
    mask = dst // stride == c
    return mask, (dst[mask] - c * stride).astype(np.int32)


def _rep_mask(plan, c):
    return np.asarray(plan.rep_table_pos, np.int64) // plan.rp == c


def _nrep_stride(plan, ring):
    """Rows of one part's shrunken receive layout: ``k·S'`` (a2a) or the
    shrunken ring concat's ``max(1, ΣS'_d)``."""
    return plan.nrep_ring_dst.shape[1] if ring else plan.k * plan.nrep_s


def _keep(ring):
    """The rules of the kept slots' lists.  A replica step's exchange is
    the SHRUNKEN one, so its loopback delivers, at each kept slot, the
    part's own row of its shrunken send list at the slot's place in the
    shrunken receive layout (what the reference proxy's size-1
    collective and a one-rank group deliver)."""
    def dst_rule(plan, c, v):
        stride = _ring_stride(plan) if ring else plan.k * plan.s
        return _part_entries(plan, c, v, stride)[1]

    def nsrc_rule(plan, c, v):
        return _part_entries(plan, c, v, _nrep_stride(plan, ring))[1]

    def src_rule(plan, c, v):
        sends = (plan.nrep_rsend_idx[c] if ring
                 else plan.nrep_send_idx[c].reshape(-1))
        pos = nsrc_rule(plan, c, plan.keep_nring_src if ring
                        else plan.keep_nrecv_src)
        return np.ascontiguousarray(sends[pos], np.int32)
    return src_rule, dst_rule, nsrc_rule


def _rep_dst(ring):
    def rule(plan, c, v):
        stride = _ring_stride(plan) if ring else plan.k * plan.s
        return _part_entries(plan, c, v, stride)[1]
    return rule


def _rep_base_flat(plan, c, v):
    """The partial refresh's loopback: replica slot ``i`` reads the side
    channel's slot ``rep_recv_src[c, i]``, which holds the part's own
    baseline row ``ronly_base_pos[c]`` names there.  A pad slot (past the
    part's own count to the slot's peer) carries 0, the reference's
    ``slot_valid``: it names row ``rep_row_counts[c]``, past the part's
    own rows, whose increment is 0 (``rep_row_valid``; ``_spare_row``
    adds that row where the part fills all ``rs``)."""
    n = int(plan.rep_counts[c])
    src = np.asarray(plan.rep_recv_src[c, :n], np.int64)
    peer, pos = src // plan.ronly_s, src % plan.ronly_s
    real = pos < np.asarray(plan.ronly_send_counts)[c, peer]
    return np.where(real, plan.ronly_base_pos[c].reshape(-1)[src],
                    plan.rep_row_counts[c]).astype(np.int32)


def _rep_src_flat(plan, c, v):
    """... and the gradient side channel's: that baseline row's own
    row (0 past the part's own rows)."""
    rows = np.append(plan.rep_rows[c] * (plan.rep_row_valid[c] > 0), 0)
    return np.ascontiguousarray(rows[_rep_base_flat(plan, c, v)], np.int32)


def _spare_row(plan, c, repl) -> dict:
    """A part that owns ``rs`` replicated rows and whose loopback reads a
    pad of the side channel (``_rep_base_flat``) gains one baseline row
    past its own, never valid: a zero column in its port-only
    ``rep_row_valid`` and ``rep_rows_flat`` (``CommPlan.rep_base_rows``;
    the reference-equal ``rs`` and ``rep_rows`` stay)."""
    flat = repl.get("rep_base_flat")
    if flat is None or not np.any(flat == plan.rs):
        return {}
    return {name: np.pad(repl[name], ((0, 0), (0, 1)))
            for name in ("rep_row_valid", "rep_rows_flat")}


def _rep_table_pos(plan, c, v):
    return (np.asarray(v, np.int64)[_rep_mask(plan, c)]
            - c * plan.rp).astype(np.int32)


def _rev(plan, c, v):
    return np.arange(plan.k * plan.s, dtype=np.int32)[None]


_keep_recv = _keep(ring=False)
_keep_ring = _keep(ring=True)

# ``REBASED_ARRAY_FIELDS``' rules (``parallel/plan.py`` states each in a
# line): each maps (full plan, part c, the field's full value) to the
# slice's value
REBASE = {
    "recv_src": lambda plan, c, v: _loopback(plan, c)[None],
    "halo_src_flat": lambda plan, c, v: np.ascontiguousarray(
        plan.halo_src[c: c + 1], np.int32),
    "ring_src": lambda plan, c, v: np.ascontiguousarray(
        plan.rsend_idx[c: c + 1], np.int32),
    "rev_src": _rev,
    "rev_csrc": _rev,
    "keep_recv_src": _keep_recv[0],
    "keep_recv_dst": _keep_recv[1],
    "keep_ring_src": _keep_ring[0],
    "keep_ring_dst": _keep_ring[1],
    "rep_recv_dst": _rep_dst(ring=False),
    "rep_ring_dst": _rep_dst(ring=True),
    "rep_src_flat": _rep_src_flat,
    "rep_base_flat": _rep_base_flat,
    "rep_table_pos": _rep_table_pos,
    "rep_rows_flat": lambda plan, c, v: np.ascontiguousarray(
        plan.rep_rows[c: c + 1] * (plan.rep_row_valid[c: c + 1] > 0),
        np.int32),
    "keep_nrecv_src": _keep_recv[2],
    "keep_nring_src": _keep_ring[2],
}


def shard_proxy_plan(plan: CommPlan, chip: int = 0) -> CommPlan:
    """A ``k = 1`` view of ``plan`` carrying only part ``chip``'s arrays.

    First builds, on the full plan, the layout the port's exact GCN path
    reads (``ensure_exchange``, ``ensure_pallas_tiles``: the counterparts
    of the reference's eager exchange fields).  Then every field of
    ``PER_CHIP_ARRAY_FIELDS`` that is built is checked to carry the
    leading ``k`` axis and sliced to ``[chip:chip+1]``, every built field
    of ``REBASED_ARRAY_FIELDS`` is re-based by its rule (``REBASE``), and
    the global arrays and scalars pass through; ``chip_ids = [chip]``.
    An unclassified dataclass array with a leading ``k`` axis raises.
    Each ELL chain layout built on the full plan is laid out again for
    the slice (``CommPlan.ensure_ell_chains``): part ``chip``'s chains,
    re-based to the slice's own buffers."""
    if plan.chip_ids is not None:
        raise ValueError("the plan is already a one-part slice")
    if not 0 <= chip < plan.k:
        raise ValueError(f"chip {chip} out of range for k={plan.k}")
    plan.ensure_exchange()
    plan.ensure_pallas_tiles()
    classified = (set(PER_CHIP_ARRAY_FIELDS) | set(_GLOBAL_ARRAY_FIELDS)
                  | set(REBASED_ARRAY_FIELDS))
    # the slice lays out its own ELL chains (below), over its own buffers
    repl: dict = {"k": 1, "chip_ids": np.array([chip]), "ell_chains": None}
    for fld in dataclasses.fields(plan):
        v = getattr(plan, fld.name)
        if fld.name in classified or not isinstance(v, np.ndarray):
            continue
        if v.ndim >= 1 and v.shape[0] == plan.k:
            raise ValueError(
                f"CommPlan.{fld.name} looks per-part-stacked (leading axis "
                f"{plan.k}) but is not classified in PER_CHIP_ARRAY_FIELDS, "
                "_GLOBAL_ARRAY_FIELDS or REBASED_ARRAY_FIELDS — add it to "
                "one before slicing")
    for name in PER_CHIP_ARRAY_FIELDS:
        v = getattr(plan, name, None)
        if v is None:             # a lazy layout not built, or not ported
            continue
        if not (isinstance(v, np.ndarray) and v.ndim >= 1
                and v.shape[0] == plan.k):
            raise ValueError(
                f"CommPlan.{name} is classified per-part-stacked but has "
                f"shape {getattr(v, 'shape', None)} (k={plan.k}) — "
                "PER_CHIP_ARRAY_FIELDS is out of sync with the dataclass")
        repl[name] = v[chip: chip + 1]
    for name, rule in REBASE.items():
        v = getattr(plan, name)
        if v is not None:
            repl[name] = rule(plan, chip, v)
    repl.update(_spare_row(plan, chip, repl))
    sl = dataclasses.replace(plan, **repl)
    for layout in plan.ell_chains or ():
        sl.ensure_ell_chains(layout)
    return sl


def shard_proxy_data(plan: CommPlan, chip: int, features: np.ndarray,
                     labels: np.ndarray, device="cpu"):
    """Part ``chip``'s ``TrainData`` block under the FULL k-way plan: its
    own rows only (``plan.scatter_rows(..., chips=[chip])``), every real
    row in the train and eval split, on ``device``."""
    import torch

    from ..train.fullbatch import TrainData

    n = plan.n
    h0 = plan.scatter_rows(np.asarray(features, np.float32), chips=[chip])
    lab = plan.scatter_rows(np.asarray(labels).reshape(n, 1)
                            .astype(np.int64), chips=[chip])[..., 0]
    rv = plan.row_valid[chip: chip + 1]
    return TrainData(*(torch.as_tensor(np.ascontiguousarray(x)).to(device)
                       for x in (h0, lab, rv, rv)))
