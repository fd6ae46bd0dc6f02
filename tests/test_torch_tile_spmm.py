"""The port's tile SpMM (K1, ``sgcn_tpu_torch/ops/tile_spmm.py``) against
the reference TPU kernel ``sgcn_tpu/ops/pallas_spmm.py::spmm_pallas``.

On the CPU the port's wrapper runs its plain PyTorch version; the
reference runs its Pallas kernel body in interpret mode (``interpret=True``)
or its exact jnp emulation (``emulate=True``).  Tolerance
``rtol=1e-6, atol=1e-7``: both add each row's terms in stored edge order,
but XLA:CPU may fuse a multiply-add where the port rounds the product and
the sum separately, so the last bit may differ.

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_cuda.py``, which imports no JAX so it runs there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import er_graph
from sgcn_tpu.ops.pallas_spmm import build_dst_tile_classes as ref_build
from sgcn_tpu.ops.pallas_spmm import spmm_pallas, spmm_pallas_classes
from sgcn_tpu.ops.pallas_spmm import tile_classes_from_buckets as ref_classes
from sgcn_tpu_torch.ops.tile_spmm import (build_dst_tile_classes,
                                          choose_tile_dispatch, spmm_tiles,
                                          spmm_tiles_classes,
                                          spmm_tiles_plain,
                                          tile_classes_from_buckets)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition
from sgcn_tpu_torch.prep import normalize_adjacency

RTOL, ATOL = 1e-6, 1e-7


def random_tiles(t, emax, tb, n, seed, fill=0.6):
    """Random dst tiles with the plan's conventions: each tile holds a
    random number of real edges (dst-sorted, so some rows stay empty) and
    pads of weight 0 at local dst tb-1; one tile is all pads."""
    rng = np.random.default_rng(seed)
    tsrc = np.zeros((t, emax), np.int32)
    tld = np.full((t, emax), tb - 1, np.int32)
    tw = np.zeros((t, emax), np.float32)
    for i in range(1, t):                      # tile 0: pads only
        c = int(rng.integers(1, int(emax * fill) + 1))
        tsrc[i, :c] = rng.integers(0, n, c)
        tld[i, :c] = np.sort(rng.integers(0, tb // 2, c))
        tw[i, :c] = rng.standard_normal(c)
    return tsrc, tld, tw


def _compare(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"{what}: max |port - reference| = {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f", [7, 16, 128])
def test_plain_matches_pallas_interpret(f):
    """Pads, an all-pad tile and empty rows, against the kernel body run
    off-TPU."""
    t, emax, tb, n = 4, 24, 16, 40
    tsrc, tld, tw = random_tiles(t, emax, tb, n, seed=f)
    table = np.random.default_rng(100 + f).standard_normal(
        (n, f)).astype(np.float32)
    want = spmm_pallas(jnp.asarray(tsrc), jnp.asarray(tld), jnp.asarray(tw),
                       jnp.asarray(table), tb=tb, interpret=True)
    got = spmm_tiles(torch.from_numpy(tsrc), torch.from_numpy(tld),
                     torch.from_numpy(tw), torch.from_numpy(table), tb)
    assert got.shape == (t * tb, f) and got.dtype == torch.float32
    _compare(got, want, f"spmm_tiles f={f}")
    # empty rows are exact zeros: the all-pad tile and rows no edge hits
    assert not got[:tb].any()
    assert not got[tb + tb // 2: 2 * tb - 1].any()


def test_plain_stacked_parts_match_per_part():
    """The stacked (k, T, Emax) form equals k single-part calls."""
    k, t, emax, tb, n, f = 3, 5, 16, 8, 30, 12
    parts = [random_tiles(t, emax, tb, n, seed=s) for s in range(k)]
    table = np.random.default_rng(7).standard_normal((k, n, f)).astype(
        np.float32)
    stacked = spmm_tiles(*(torch.from_numpy(np.stack([p[i] for p in parts]))
                           for i in range(3)), torch.from_numpy(table), tb)
    for p in range(k):
        one = spmm_tiles(*(torch.from_numpy(a) for a in parts[p]),
                         torch.from_numpy(table[p]), tb)
        assert torch.equal(stacked[p], one)


@pytest.fixture(scope="module")
def er_plan():
    a = normalize_adjacency(er_graph())
    pv = balanced_random_partition(48, 4, seed=0)
    return build_comm_plan(a, pv, 4).ensure_pallas_tiles(8)


@pytest.mark.parametrize("family", ["local", "halo"])
def test_classes_match_reference_emulation(er_plan, family):
    """Several degree classes over a real plan's flat tile arrays."""
    plan = er_plan
    decision = {}
    static = choose_tile_dispatch(plan, tb=8, decision=decision)
    if family == "local":
        arrays = (plan.ptile_lsrc, plan.ptile_lld, plan.ptile_lw)
        classes, rows = static["pallas_lclasses"], plan.b
    else:
        arrays = (plan.ptile_hsrc, plan.ptile_hld, plan.ptile_hw)
        classes, rows = static["pallas_hclasses"], plan.r
    assert len(classes) > 1
    assert all(kern == "tile_spmm" for _, _, kern in classes)
    assert decision["tile_dispatch"]["rule"] == \
        "every class runs the tile kernel"
    f = 16
    table = np.random.default_rng(5).standard_normal(
        (plan.k, rows, f)).astype(np.float32)
    got = spmm_tiles_classes(*(torch.from_numpy(a) for a in arrays),
                             torch.from_numpy(table), classes, 8)
    ref_cls = tuple((t, e, "vmem") for t, e, _ in classes)
    for p in range(plan.k):
        want = spmm_pallas_classes(*(jnp.asarray(a[p]) for a in arrays),
                                   jnp.asarray(table[p]), ref_cls, 8,
                                   emulate=True)
        _compare(got[p], want, f"{family} classes part {p}")


@pytest.mark.parametrize("buckets,rows,tb", [
    (((64, 4),), 64, 16), (((16, 28), (48, 2)), 64, 16), (None, 100, 16),
    (((10, 9), (54, 2)), 64, 16), (((3, 40), (20, 9), (300, 2)), 323, 32)])
def test_tile_classes_from_buckets_equal(buckets, rows, tb):
    assert tile_classes_from_buckets(buckets, rows, tb) == \
        ref_classes(buckets, rows, tb)


def test_build_dst_tile_classes_equal(er_plan):
    plan = er_plan
    for p in range(plan.k):
        for dst, src, w in ((plan.ledge_dst[p], plan.ledge_src[p],
                             plan.ledge_w[p]),
                            (plan.hedge_dst[p], plan.hedge_src[p],
                             plan.hedge_w[p])):
            for tb in (8, 16):
                ct = tile_classes_from_buckets(plan.ell_buckets, plan.b, tb)
                got = build_dst_tile_classes(dst, src, w, plan.b, tb, ct)
                want = ref_build(dst, src, w, plan.b, tb, ct)
                assert len(got) == len(want)
                for gc, wc in zip(got, want):
                    for a, b in zip(gc, wc):
                        assert a.dtype == b.dtype
                        np.testing.assert_array_equal(a, b)


def test_wrapper_refuses_what_it_does_not_take():
    tsrc, tld, tw = (torch.from_numpy(a) for a in random_tiles(2, 8, 8, 10, 0))
    before = spmm_tiles.launches
    spmm_tiles(tsrc, tld, tw, torch.zeros(10, 4), 8)
    assert spmm_tiles.launches == before      # the plain path is no launch
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tiles(tsrc, tld, tw, torch.zeros(10, 4, dtype=torch.float16), 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_tiles(tsrc.to("meta"), tld.to("meta"), tw.to("meta"),
                   torch.zeros(10, 4, device="meta"), 8)
    with pytest.raises(IndexError, match="out of range"):
        spmm_tiles_plain(tsrc, tld, tw, torch.zeros(3, 4), 8)


def test_build_lands_in_build_dir():
    from sgcn_tpu_torch.ops import _build

    path = _build.library_path("tile_spmm")
    assert path.parent.name == "sgcn_tpu_torch"
    assert path.parent.parent.name == "build"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(path).startswith(repo)
