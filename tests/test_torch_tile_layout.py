"""The tile layout the CUDA tile SpMM kernel rests on, checked on the CPU.

The kernel (``sgcn_tpu_torch/csrc/tile_spmm.cu``) finds destination row
r's slots as ``[lower_bound(r), lower_bound(r+1))`` of its tile's local
destinations ``tld``, so every tile the plan builds must keep ``tld``
non-decreasing along its slots, with the pads (weight 0, ``tld = tb-1``)
last.  Here: every tile family the plan builds — local, halo, the
ring-re-based halo, combined and the combined ring — on cora2708 8-hp and
the 48-vertex ER graph, under both row orders; the one-launch entry's
class table (``pack_class_table``) against the flat layout; and the
plan's layout check (``check_tile_layout``) raising on a bad layout.
The kernel's own trap on a decreasing ``tld`` is never fired by a test.
"""

import os

import numpy as np
import pytest
import torch

from conftest import er_graph
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.ops.tile_spmm import (MAX_CLASSES, build_dst_tile_classes,
                                          check_tile_layout,
                                          pack_class_table,
                                          spmm_tiles_classes,
                                          tile_classes_from_buckets,
                                          vector_width)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# family -> (src, ld, w, classes) fields of the plan; the ring families
# read their a2a family's ld and w
FAMILIES = {
    "local": ("ptile_lsrc", "ptile_lld", "ptile_lw", "pallas_lclasses"),
    "halo": ("ptile_hsrc", "ptile_hld", "ptile_hw", "pallas_hclasses"),
    "ring": ("ptile_hrsrc", "ptile_hld", "ptile_hw", "pallas_hclasses"),
    "combined": ("ptile_csrc", "ptile_cld", "ptile_cw", "pallas_cclasses"),
    "combined_ring": ("ptile_crsrc", "ptile_cld", "ptile_cw",
                      "pallas_cclasses"),
}

_PLANS = {}


def _plan(graph, row_order):
    """The graph's plan with every tile family built (cached): cora2708
    8-hp at tb = 64, the ER graph 4-rp at tb = 8 — several tiles and
    classes per family."""
    key = (graph, row_order)
    if key not in _PLANS:
        if graph == "cora2708-8hp":
            a = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))[0]
            pv, k, tb = read_partvec(os.path.join(FIX, "cora2708.8.hp")), 8, 64
        else:
            a, k, tb = er_graph(), 4, 8
            pv = balanced_random_partition(48, k, seed=0)
        plan = build_comm_plan(normalize_adjacency(a), pv, k,
                               row_order=row_order)
        plan.ensure_pallas_tiles(tb).ensure_pallas_cell_tiles(tb)
        plan.ensure_ragged().ensure_pallas_ragged_tiles()
        plan.ensure_pallas_cell_ragged_tiles()
        _PLANS[key] = (plan, tb)
    return _PLANS[key]


def _real_edges(plan, family):
    """Per part, the family's real (nonzero-weight) edge count."""
    if family == "local":
        return np.asarray(plan.lnnz)
    if family in ("halo", "ring"):
        return np.asarray(plan.hnnz)
    return np.asarray(plan.nnz)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("row_order", ["degree", "id"])
@pytest.mark.parametrize("graph", ["cora2708-8hp", "er48-4rp"])
def test_every_tile_keeps_destination_order_pads_last(graph, row_order,
                                                      family):
    """Inside every tile of every family: ``tld`` in [0, tb) and never
    decreasing, the pads (weight 0, ``tld = tb-1``) one run at the end,
    every real edge present once, and the sources inside the table the
    family's pass reads."""
    plan, tb = _plan(graph, row_order)
    src_f, ld_f, w_f, cls_f = FAMILIES[family]
    src, ld, w = (np.asarray(getattr(plan, f)) for f in (src_f, ld_f, w_f))
    classes = getattr(plan, cls_f)
    assert len(classes) >= 1 and src.shape == ld.shape == w.shape
    check_tile_layout(ld, classes, tb)                # the plan's own check
    first, offs, emax = pack_class_table(classes, ld.shape[1])
    for (t, e), off in zip(classes, offs):
        blk = [x[:, off: off + t * e].reshape(plan.k, t, e)
               for x in (src, ld, w)]
        s, d, wt = blk
        assert d.min() >= 0 and d.max() < tb
        assert (np.diff(d, axis=-1) >= 0).all()
        pad = (wt == 0) & (d == tb - 1)
        # once a slot is a pad, every later slot of its tile is one too
        assert (np.maximum.accumulate(pad, axis=-1) == pad).all()
    assert ((w != 0).sum(axis=1) == _real_edges(plan, family)).all()
    rows = {"local": plan.b, "halo": plan.r,
            "ring": sum(plan.rr_sizes),
            "combined": plan.b + plan.r,
            "combined_ring": plan.b + sum(plan.rr_sizes)}[family]
    assert src.min() >= 0 and src.max() < max(rows, 1)


def test_class_table_agrees_with_flat_layout():
    """``pack_class_table`` on a real plan's classes: class c's first tile
    is the tiles before it, its first slot the slots before it, its emax
    its own; the slices it names are exactly the per-part tiles
    ``build_dst_tile_classes`` builds, padded to the class emax."""
    plan, tb = _plan("cora2708-8hp", "degree")
    classes = plan.pallas_lclasses
    first, offs, emax = pack_class_table(classes, plan.ptile_lld.shape[1])
    assert first.dtype == np.int32 and offs.dtype == np.int64
    assert emax.dtype == np.int32 and len(first) == len(classes) + 1
    assert list(first) == [0] + list(np.cumsum([t for t, _ in classes]))
    assert list(offs) == [0] + list(np.cumsum(
        [t * e for t, e in classes]))[:-1]
    assert list(emax) == [e for _, e in classes]
    assert offs[-1] + classes[-1][0] * emax[-1] == plan.ptile_lld.shape[1]
    ct = tile_classes_from_buckets(plan.ell_buckets, plan.b, tb)
    for p in range(plan.k):
        per = build_dst_tile_classes(plan.ledge_dst[p], plan.ledge_src[p],
                                     plan.ledge_w[p], plan.b, tb, ct)
        for c, (t, e) in enumerate(classes):
            sl = slice(int(offs[c]), int(offs[c]) + t * e)
            want_ld = np.full((t, e), tb - 1, np.int32)
            want_ld[:, : per[c][1].shape[1]] = per[c][1]
            np.testing.assert_array_equal(
                plan.ptile_lld[p, sl].reshape(t, e), want_ld)


def test_class_table_refuses_what_one_launch_cannot_take():
    """More classes than the kernel's cap, an empty class, or classes that
    do not cover the flat arrays exactly raise — in ``pack_class_table``
    and in ``spmm_tiles_classes`` on any device."""
    ok = tuple((1, 8) for _ in range(MAX_CLASSES))
    assert pack_class_table(ok)[0][-1] == MAX_CLASSES
    with pytest.raises(ValueError, match="1 to 32"):
        pack_class_table(ok + ((1, 8),))
    with pytest.raises(ValueError, match="1 to 32"):
        pack_class_table(())
    with pytest.raises(ValueError, match="at least one tile"):
        pack_class_table(((2, 8), (0, 8)))
    with pytest.raises(ValueError, match="at least one tile"):
        pack_class_table(((2, 0),))
    with pytest.raises(ValueError, match="cover 24 slots"):
        pack_class_table(((2, 8), (1, 8)), slots=32)
    flat = [torch.zeros(2, 32, dtype=torch.int32),
            torch.full((2, 32), 7, dtype=torch.int32), torch.zeros(2, 32)]
    table = torch.zeros(2, 5, 3)
    assert spmm_tiles_classes(*flat, table, ((4, 8),), 8).shape == (2, 32, 3)
    with pytest.raises(ValueError, match="cover 24 slots"):
        spmm_tiles_classes(*flat, table, ((2, 8), (1, 8)), 8)


def test_layout_check_raises_on_a_decreasing_tile():
    """``check_tile_layout`` raises on a tile whose destinations decrease
    or leave [0, tb) — and so does the plan, where it builds a family from
    an edge list that is not dst-sorted."""
    plan, tb = _plan("er48-4rp", "degree")
    ld = plan.ptile_hld.copy()
    classes = plan.pallas_hclasses
    check_tile_layout(ld, classes, tb)
    t, e = classes[0]
    real = np.nonzero(plan.ptile_hw[1, : t * e] != 0)[0]
    i, j = real[0], real[-1]
    assert ld[1, i] < ld[1, j]
    bad = ld.copy()
    bad[1, [i, j]] = bad[1, [j, i]]
    with pytest.raises(ValueError, match="decreases"):
        check_tile_layout(bad, classes, tb)
    bad = ld.copy()
    bad[0, 0] = tb
    with pytest.raises(ValueError, match="outside"):
        check_tile_layout(bad, classes, tb)
    with pytest.raises(ValueError, match="decreases"):
        check_tile_layout(np.array([[3, 1, 7, 7]]), ((1, 4),), 8)
    # the plan's own build: a family from an edge list whose dst order
    # breaks inside one tile (two edges of tile 0, rows swapped)
    dst, src, w = (x.copy() for x in (plan.ledge_dst, plan.ledge_src,
                                       plan.ledge_w))
    i, j = 0, int(np.nonzero(dst[0] // tb == 0)[0][-1])
    assert dst[0, i] < dst[0, j]
    for x in (dst, src, w):
        x[0, [i, j]] = x[0, [j, i]]
    ct = tile_classes_from_buckets(plan.ell_buckets, plan.b, tb)
    with pytest.raises(ValueError, match="decreases"):
        plan._pallas_family(dst, src, w, tb, ct)


@pytest.mark.parametrize("f,ptr,stride,want", [
    (128, 0x1000, 128 * 500, 4), (40, 0x1010, 40 * 7, 4),
    (129, 0x1000, 129 * 500, 1), (128, 0x1004, 128 * 500, 1),
    (128, 0x1000, 128 * 500 + 2, 1), (16, 0x1000, 16 * 500, 1),
    (1, 0x1000, 500, 1)])
def test_vector_width_needs_whole_aligned_rows(f, ptr, stride, want):
    """16-byte loads only for rows that are whole 16-byte units (f % 4 == 0,
    an aligned base and part stride) and wide enough to fill 8 lanes."""
    assert vector_width(f, ptr, stride) == want


@pytest.mark.parametrize("f,ptr,stride,want", [
    (128, 0x1008, 128 * 500, 4), (40, 0x1000, 40 * 7, 4),
    (128, 0x1004, 128 * 500, 1), (128, 0x1002, 128 * 500, 1),
    (129, 0x1000, 129 * 500, 1), (128, 0x1000, 128 * 500 + 2, 1)])
def test_vector_width_on_bf16_rows(f, ptr, stride, want):
    """On a bf16 table (2-byte values) a lane's 4-column load is 8 bytes:
    it needs an 8-byte aligned base, f % 4 == 0 and a part stride of whole
    4-column vectors; a 2- or 4-byte aligned base takes one value per
    lane."""
    assert vector_width(f, ptr, stride, itemsize=2) == want
