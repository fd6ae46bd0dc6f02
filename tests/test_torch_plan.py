"""The port's host layer against the reference: I/O, normalization, part
vectors and the communication plan (``sgcn_tpu_torch`` vs ``sgcn_tpu``).

Integer plan arrays, float plan arrays and every static tuple must be
EQUAL, array for array — both packages run the same numpy construction,
so there is no tolerance here.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import er_graph
from sgcn_tpu.io.datasets import er_graph as ref_er_graph
from sgcn_tpu.io.datasets import load_npz_dataset as ref_load_npz
from sgcn_tpu.io.mtx import read_mtx as ref_read_mtx
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.partition import balanced_random_partition as ref_brp
from sgcn_tpu.partition.emit import read_partvec as ref_read_partvec
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu_torch.io.datasets import er_graph as port_er_graph
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.io.mtx import read_mtx
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import (balanced_random_partition,
                                      read_partvec, read_partvec_pickle)
from sgcn_tpu_torch.prep import normalize_adjacency

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# every CommPlan field the serving path reads
ARRAY_FIELDS = (
    "owner", "local_idx", "part_sizes", "send_idx", "send_counts",
    "halo_src", "halo_counts", "edge_dst", "edge_src", "edge_w", "nnz",
    "row_valid", "ledge_dst", "ledge_src", "ledge_w", "hedge_dst",
    "hedge_src", "hedge_w", "lnnz", "hnnz", "ell_idx", "ell_w",
    "ltail_dst", "ltail_src", "ltail_w", "ltail_nnz",
    "ptile_lsrc", "ptile_lld", "ptile_lw", "ptile_hsrc", "ptile_hld",
    "ptile_hw")
SCALAR_FIELDS = ("n", "k", "b", "s", "r", "e", "el", "eh", "ell_k", "tl",
                 "symmetric", "row_order", "pallas_tb")
STATIC_TUPLES = ("ell_buckets", "pallas_lclasses", "pallas_hclasses")


def _csr_equal(x, y):
    x, y = sp.csr_matrix(x), sp.csr_matrix(y)
    assert x.shape == y.shape
    np.testing.assert_array_equal(x.indptr, y.indptr)
    np.testing.assert_array_equal(x.indices, y.indices)
    np.testing.assert_array_equal(x.data, y.data)
    assert x.data.dtype == y.data.dtype


def _cora():
    a, _, _ = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    return a, read_partvec(os.path.join(FIX, "cora2708.8.hp")), 8


def _er():
    return er_graph(), balanced_random_partition(48, 4, seed=0), 4


@pytest.fixture(scope="module", params=["cora2708-8hp", "er48-4rp"])
def plans(request):
    a, pv, k = _cora() if request.param.startswith("cora") else _er()
    port = build_comm_plan(normalize_adjacency(a), pv, k)
    ref = ref_build_comm_plan(ref_normalize(a), pv, k)
    return port.ensure_pallas_tiles(256), ref.ensure_pallas_tiles(256)


def test_plan_array_fields_equal(plans):
    port, ref = plans
    for f in ARRAY_FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_plan_scalars_and_static_tuples_equal(plans):
    port, ref = plans
    for f in SCALAR_FIELDS + STATIC_TUPLES:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.symmetric


def test_plan_methods_equal(plans):
    port, ref = plans
    x = np.random.default_rng(0).standard_normal((port.n, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(port.scatter_rows(x), ref.scatter_rows(x))
    np.testing.assert_array_equal(
        port.scatter_rows(x)[port.owner, port.local_idx], x)
    np.testing.assert_array_equal(port.global_row_ids(),
                                  ref.global_row_ids())
    assert port.wire_rows_per_exchange("a2a") == \
        ref.wire_rows_per_exchange("a2a")
    np.testing.assert_array_equal(port.predicted_send_volume,
                                  ref.predicted_send_volume)
    assert port.wire_rows_per_exchange("ragged") == \
        ref.wire_rows_per_exchange("ragged")
    with pytest.raises(ValueError, match="unknown comm schedule"):
        port.wire_rows_per_exchange("ring")


@pytest.mark.parametrize("tb", [8, 64])
def test_plan_tiles_other_heights_equal(tb):
    """The tile layout at other tile heights (more classes, more pads)."""
    a, pv, k = _er()
    port = build_comm_plan(normalize_adjacency(a), pv, k).ensure_pallas_tiles(tb)
    ref = ref_build_comm_plan(ref_normalize(a), pv, k).ensure_pallas_tiles(tb)
    assert port.pallas_lclasses == ref.pallas_lclasses
    assert port.pallas_hclasses == ref.pallas_hclasses
    for f in ("ptile_lsrc", "ptile_lld", "ptile_lw", "ptile_hsrc",
              "ptile_hld", "ptile_hw"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))


def test_plan_id_row_order_equal():
    a, pv, k = _er()
    port = build_comm_plan(normalize_adjacency(a), pv, k, row_order="id")
    ref = ref_build_comm_plan(ref_normalize(a), pv, k, row_order="id")
    assert port.ell_buckets == ref.ell_buckets
    for f in ("local_idx", "ell_idx", "ell_w", "ltail_dst", "ltail_src"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("graph", ["cora2708", "er48"])
def test_normalize_adjacency_equal(graph):
    a = _cora()[0] if graph == "cora2708" else er_graph()
    _csr_equal(normalize_adjacency(a), ref_normalize(a))


def test_io_readers_equal(tmp_path):
    _csr_equal(read_mtx(os.path.join(FIX, "cora2708.A.mtx")),
               ref_read_mtx(os.path.join(FIX, "cora2708.A.mtx")))
    a, x, y = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    ra, rx, ry = ref_load_npz(os.path.join(FIX, "cora2708.npz"))
    _csr_equal(a, ra)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    _csr_equal(port_er_graph(500, avg_deg=6, seed=3),
               ref_er_graph(500, avg_deg=6, seed=3))


def test_partvec_readers_and_random_partition_equal(tmp_path):
    path = os.path.join(FIX, "cora2708.8.hp")
    np.testing.assert_array_equal(read_partvec(path), ref_read_partvec(path))
    pv = read_partvec(path)
    pk = tmp_path / "pv.pkl"
    with open(pk, "wb") as fh:
        pickle.dump([int(p) for p in pv], fh)
    np.testing.assert_array_equal(read_partvec_pickle(str(pk)), pv)
    for n, k, seed in ((48, 4, 0), (2708, 8, 3), (101, 7, 11)):
        np.testing.assert_array_equal(balanced_random_partition(n, k, seed),
                                      ref_brp(n, k, seed))
