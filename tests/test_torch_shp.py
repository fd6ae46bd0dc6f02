"""The port's stochastic hypergraph partitioner against the reference's
(``sgcn_tpu_torch.shp`` vs ``sgcn_tpu.shp``).

Both run the same numpy draws in the same order and partition with the
same native partitioner (compiled from ``native/sgcnpart.cpp`` by each
package's binding), so every submatrix, part vector, km1 and simulated
volume must be EQUAL, and the CLI's files byte-equal.  The CLIs run
in-process through ``main()``.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import er_graph
from sgcn_tpu.shp import communication_volume as ref_volume
from sgcn_tpu.shp import generate_stochastic_hypergraph as ref_generate
from sgcn_tpu.shp import run_shp as ref_run_shp
from sgcn_tpu.shp import sample_sparse_submatrix as ref_sample
from sgcn_tpu.shp import simulate as ref_simulate
from sgcn_tpu.shp.__main__ import main as ref_shp_main
from sgcn_tpu_torch.io.mtx import read_mtx, write_mtx
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import (balanced_random_partition,
                                      read_partvec_pickle)
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.shp import (communication_volume,
                                generate_stochastic_hypergraph, run_shp,
                                sample_sparse_submatrix, simulate)
from sgcn_tpu_torch.shp.__main__ import main as shp_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CORA_A = os.path.join(FIX, "cora2708.A.mtx")


@pytest.fixture(scope="module")
def graphs():
    return {"cora2708": normalize_adjacency(read_mtx(CORA_A)),
            "er48": normalize_adjacency(er_graph())}


def _csr_equal(x, y):
    x, y = sp.csr_matrix(x), sp.csr_matrix(y)
    assert x.shape == y.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("graph,bs,seed", [("er48", 20, 0),
                                           ("cora2708", 256, 3),
                                           ("er48", 100, 1)])
def test_sample_sparse_submatrix_equals_reference(graphs, graph, bs, seed):
    a = graphs[graph]
    got = sample_sparse_submatrix(a, bs, np.random.default_rng(seed))
    want = ref_sample(a, bs, np.random.default_rng(seed))
    _csr_equal(got, want)
    # the global row space stays, every kept column is non-empty, and
    # every nonzero lies in a batch of at most bs vertices
    assert got.shape[0] == a.shape[0]
    assert (np.diff(sp.csc_matrix(got).indptr) > 0).all()
    assert len(np.unique(sp.coo_matrix(got).row)) <= bs


def test_stochastic_hypergraph_equals_reference(graphs):
    a = graphs["cora2708"]
    got = generate_stochastic_hypergraph(a, 5, 128,
                                         np.random.default_rng(1))
    want = ref_generate(a, 5, 128, np.random.default_rng(1))
    assert isinstance(got, sp.csc_matrix)
    _csr_equal(got, want)
    assert got.shape[0] == a.shape[0]


def test_communication_volume_matches_definition_and_reference(graphs):
    # column 0 touches parts {0, 1} -> 1; column 1 touches {0} -> 0
    s = sp.coo_matrix((np.ones(3), (np.array([0, 1, 2]),
                                    np.array([0, 0, 1]))), shape=(4, 2))
    assert communication_volume(s, np.array([0, 1, 0, 1])) == 1
    s2 = sp.coo_matrix((np.ones(3), (np.array([0, 1, 2]), np.zeros(3, int))),
                       shape=(3, 1))
    assert communication_volume(s2, np.array([0, 1, 2])) == 2
    assert communication_volume(sp.coo_matrix((3, 3)), np.zeros(3, int)) == 0
    a = graphs["cora2708"]
    for k in (2, 8):
        pv = balanced_random_partition(a.shape[0], k, seed=k)
        assert communication_volume(a, pv) == ref_volume(a, pv)


def test_communication_volume_consistent_with_plan(graphs):
    """The full graph's λ−1 equals the plan's predicted send volume."""
    a = graphs["er48"]
    pv = balanced_random_partition(a.shape[0], 4, seed=2)
    plan = build_comm_plan(a, pv, 4)
    assert communication_volume(a, pv) == int(
        plan.predicted_send_volume.sum())


def test_simulate_equals_reference(graphs):
    a = graphs["cora2708"]
    pvs = {"rp": balanced_random_partition(a.shape[0], 4, seed=1),
           "rp2": balanced_random_partition(a.shape[0], 4, seed=2)}
    got = simulate(a, pvs, 6, 200, np.random.default_rng(5))
    want = ref_simulate(a, pvs, 6, 200, np.random.default_rng(5))
    assert got == want and got["rp"] > 0


@pytest.mark.parametrize("graph,k,m,bs,iters,seed", [
    ("er48", 3, 4, 16, 6, 1), ("cora2708", 8, 10, 256, 20, 1),
    ("cora2708", 4, 6, 512, 8, 7)])
def test_run_shp_equals_reference(graphs, graph, k, m, bs, iters, seed):
    a = graphs[graph]
    got = run_shp(a, k, nsampled_batches=m, batch_size=bs, sim_iters=iters,
                  seed=seed)
    want = ref_run_shp(a, k, nsampled_batches=m, batch_size=bs,
                       sim_iters=iters, seed=seed)
    assert set(got) == set(want)
    for key in ("partvec_hp", "partvec_stchp"):
        pv = got[key]
        assert pv.dtype == np.int64 and pv.shape == (a.shape[0],)
        assert pv.min() >= 0 and pv.max() < k
        np.testing.assert_array_equal(pv, want[key])
    for key in ("km1_hp", "km1_stchp", "sim_comm_volume_hp",
                "sim_comm_volume_stchp"):
        assert got[key] == want[key], key
    assert got["sim_comm_volume_hp"] >= 0


def test_shp_cli_writes_the_reference_files(tmp_path, monkeypatch, capsys):
    """``python -m sgcn_tpu_torch.shp`` against ``python -m sgcn_tpu.shp``
    on the same input and flags: both part-vector pickles byte-equal, the
    printed lines equal (paths aside), the vectors the trainers read."""
    path = str(tmp_path / "cora.A.mtx")
    write_mtx(path, normalize_adjacency(read_mtx(CORA_A)))
    flags = ["-p", path, "-k", "4", "-b", "128", "-m", "5", "-s", "6",
             "-e", "0.05", "--seed", "3"]
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    shp_main(flags + ["-o", port_dir])
    got = capsys.readouterr().out.replace(port_dir, "OUT")
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu.shp"] + flags
                        + ["-o", ref_dir])
    ref_shp_main()
    want = capsys.readouterr().out.replace(ref_dir, "OUT")
    assert got == want
    assert got.startswith("hp: OUT/partvec.hp.4  km1=")
    for name in ("hp", "stchp"):
        f = f"partvec.{name}.4"
        with open(os.path.join(port_dir, f), "rb") as x, \
                open(os.path.join(ref_dir, f), "rb") as y:
            assert x.read() == y.read(), f
        pv = read_partvec_pickle(os.path.join(port_dir, f))
        assert pv.shape == (2708,) and pv.max() < 4


def test_shp_cli_requires_its_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        shp_main(["-k", "4"])
    assert exc.value.code == 2
    assert "--path" in capsys.readouterr().err
