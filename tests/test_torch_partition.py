"""The port's partitioners and partition files against the reference's
(``sgcn_tpu_torch.partition`` vs ``sgcn_tpu.partition``).

Both bindings compile the same ``native/sgcnpart.cpp`` with the same
flags (the port into ``build/sgcn_tpu_torch/``, the reference through
``make -C native``), so part vectors and metrics must be EQUAL, and every
file byte-equal; there is no tolerance except in the pipeline test at the
end, which states its own.  The CLIs run in-process through ``main()``
with ``sys.argv`` set.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import scipy.sparse as sp

from conftest import er_graph
from sgcn_tpu import partition as ref
from sgcn_tpu.io.config import ModelConfig as RefModelConfig
from sgcn_tpu.io.mtx import read_dense_features as ref_read_features
from sgcn_tpu.io.mtx import read_mtx as ref_read_mtx
from sgcn_tpu.io.mtx import read_onehot_labels as ref_read_labels
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.partition.__main__ import main as ref_partition_main
from sgcn_tpu.prep.__main__ import main as ref_prep_main
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils import checkpoint as ref_ckpt
from sgcn_tpu_torch import partition as port
from sgcn_tpu_torch.io.config import ModelConfig
from sgcn_tpu_torch.io.datasets import planted_partition
from sgcn_tpu_torch.io.mtx import read_mtx, write_mtx
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import native
from sgcn_tpu_torch.partition.__main__ import main as partition_main
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.prep.__main__ import main as prep_main
from sgcn_tpu_torch.train.__main__ import main as train_main

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
CORA_A = str(FIX / "cora2708.A.mtx")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def graphs():
    """Â of cora2708, of the conftest ER graph and of a planted-partition
    graph (the partitioners' inputs as the trainers see them)."""
    return {"cora2708": normalize_adjacency(read_mtx(CORA_A)),
            "er48": normalize_adjacency(er_graph()),
            "planted": normalize_adjacency(
                planted_partition(n=600, nclasses=6, p_in=0.05, p_out=0.004,
                                  seed=3)[0])}


def _edge_cut(a, pv):
    """Edges of the symmetrized pattern (no diagonal) between parts."""
    coo = sp.triu(((a + a.T) != 0).astype(np.int8), k=1).tocoo()
    return int((pv[coo.row] != pv[coo.col]).sum())


def _km1(a, pv):
    """Σ over columns (nets) of (#parts among the column's rows − 1)."""
    a = sp.csc_matrix(a)
    lam = [len(np.unique(pv[a.indices[a.indptr[j]:a.indptr[j + 1]]]))
           for j in range(a.shape[1])]
    return int(sum(max(x - 1, 0) for x in lam))


def _check_vector(pv, n, k):
    assert pv.dtype == np.int64 and pv.shape == (n,)
    assert pv.min() >= 0 and pv.max() < k
    assert len(np.unique(pv)) == k


# ------------------------------------------------------------- partitioners
@pytest.mark.parametrize("graph", ["cora2708", "er48", "planted"])
@pytest.mark.parametrize("k", [2, 8])
def test_partition_graph_equals_reference(graphs, graph, k):
    a = graphs[graph]
    pv, cut = port.partition_graph(a, k, seed=1)
    rpv, rcut = ref.partition_graph(a, k, seed=1)
    assert np.array_equal(pv, rpv) and cut == rcut
    _check_vector(pv, a.shape[0], k)
    assert cut == _edge_cut(a, pv)


@pytest.mark.parametrize("graph", ["cora2708", "er48", "planted"])
@pytest.mark.parametrize("k", [2, 8])
def test_partition_hypergraph_colnet_equals_reference(graphs, graph, k):
    a = graphs[graph]
    pv, km1 = port.partition_hypergraph_colnet(a, k, imbalance=0.05, seed=2)
    rpv, rkm1 = ref.partition_hypergraph_colnet(a, k, imbalance=0.05, seed=2)
    assert np.array_equal(pv, rpv) and km1 == rkm1
    _check_vector(pv, a.shape[0], k)
    assert km1 == _km1(a, pv)


@pytest.mark.parametrize("graph", ["cora2708", "er48", "planted"])
def test_recursive_bisection_equals_reference(graphs, graph, monkeypatch):
    """``SGCN_HP_RB=1`` (read by the library at call time) at k = 8."""
    monkeypatch.setenv("SGCN_HP_RB", "1")
    a = graphs[graph]
    pv, km1 = port.partition_hypergraph_colnet(a, 8)
    rpv, rkm1 = ref.partition_hypergraph_colnet(a, 8)
    assert np.array_equal(pv, rpv) and km1 == rkm1 == _km1(a, pv)


@pytest.mark.parametrize("graph", ["cora2708", "er48", "planted"])
@pytest.mark.parametrize("budget", [0, 16])
def test_cache_aware_partition_and_objective_equal_reference(graphs, graph,
                                                             budget):
    """The co-optimized partition, both objectives, and the numpy
    ``cache_aware_km1`` of it (port == reference == the native value)."""
    a = graphs[graph]
    pv, km1, cache = port.partition_hypergraph_colnet_cache(a, 8, budget)
    rpv, rkm1, rcache = ref.partition_hypergraph_colnet_cache(a, 8, budget)
    assert np.array_equal(pv, rpv) and (km1, cache) == (rkm1, rcache)
    assert km1 == _km1(a, pv)
    assert port.cache_aware_km1(a, pv, budget) == \
        ref.native.cache_aware_km1(a, pv, budget) == cache
    blind, _ = port.partition_hypergraph_colnet(a, 8)
    assert port.cache_aware_km1(a, blind, budget) == \
        ref.native.cache_aware_km1(a, blind, budget)


def test_partitions_are_deterministic_and_beat_random(graphs):
    """The same input twice gives the same vector; on the planted graph gp
    and hp ship fewer rows than balanced random parts."""
    a = graphs["planted"]
    hp, _ = port.partition_hypergraph_colnet(a, 8)
    gp, _ = port.partition_graph(a, 8)
    assert np.array_equal(hp, port.partition_hypergraph_colnet(a, 8)[0])
    assert np.array_equal(gp, port.partition_graph(a, 8)[0])
    rp = port.balanced_random_partition(a.shape[0], 8, 1)
    sent = {name: int(build_comm_plan(a, pv, 8).predicted_send_volume.sum())
            for name, pv in (("hp", hp), ("gp", gp), ("rp", rp))}
    assert sent["hp"] < sent["rp"] and sent["gp"] < sent["rp"], sent


@pytest.mark.parametrize("seed", [0, 4])
def test_random_partitions_equal_reference(seed):
    assert np.array_equal(port.random_partition(1000, 7, seed),
                          ref.random_partition(1000, 7, seed))
    assert np.array_equal(port.balanced_random_partition(1000, 7, seed),
                          ref.balanced_random_partition(1000, 7, seed))


# --------------------------------------------------------------- the build
def test_library_builds_into_the_port_build_directory(graphs):
    """Built from ``native/sgcnpart.cpp`` with the Makefile's flags into
    ``build/sgcn_tpu_torch/`` under a name hashed from source, compiler and
    flags; nothing of the port's build lands in ``native/``."""
    port.partition_graph(graphs["er48"], 2)
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "sgcn_tpu_torch"
    assert path.name.startswith("libsgcnpart-")
    assert native.SOURCE == REPO / "native" / "sgcnpart.cpp"
    assert native.CXX_FLAGS == ("-O3", "-std=c++17", "-Wall", "-Wextra",
                                "-fPIC", "-shared")
    assert not list((REPO / "native").glob("libsgcnpart-*"))


def test_build_writes_by_atomic_rename(tmp_path, monkeypatch):
    """A new source text gets its own library name; the build leaves the
    library and no temporary file, and a second call reuses it."""
    src = tmp_path / "sgcnpart.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// another text\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    path = native.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [path.name]
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("compiler", ["missing", "fails"])
def test_failed_build_raises_with_no_fallback(graphs, tmp_path, monkeypatch,
                                              compiler):
    """A compiler that is not there, or one that exits non-zero, makes
    every partitioner raise with the compiler's story: no random or other
    partition comes back."""
    if compiler == "missing":
        cxx = str(tmp_path / "no-such-g++")
    else:
        cxx = tmp_path / "bad-g++"
        cxx.write_text("#!/bin/sh\necho 'bad-g++: internal error' >&2\n"
                       "exit 3\n")
        cxx.chmod(0o755)
        cxx = str(cxx)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    a = graphs["er48"]
    calls = [lambda: port.partition_graph(a, 2),
             lambda: port.partition_hypergraph_colnet(a, 2),
             lambda: port.partition_hypergraph_colnet_cache(a, 2, 4)]
    for call in calls:
        with pytest.raises(RuntimeError,
                           match="native partitioner build failed") as err:
            call()
        if compiler == "fails":
            assert "exit 3" in str(err.value) and "internal error" in \
                str(err.value)
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").iterdir())


# ----------------------------------------------------------------- files
def test_part_vector_writers_are_byte_equal(tmp_path):
    pv = port.balanced_random_partition(500, 8, 3)
    port.write_partvec(str(tmp_path / "port.hp"), pv)
    ref.write_partvec(str(tmp_path / "ref.hp"), pv)
    port.write_partvec_pickle(str(tmp_path / "port.pkl"), pv)
    ref.write_partvec_pickle(str(tmp_path / "ref.pkl"), pv)
    assert _bytes(tmp_path / "port.hp") == _bytes(tmp_path / "ref.hp")
    assert _bytes(tmp_path / "port.pkl") == _bytes(tmp_path / "ref.pkl")
    assert np.array_equal(port.read_partvec(str(tmp_path / "ref.hp")), pv)
    assert np.array_equal(port.read_partvec_pickle(str(tmp_path / "ref.pkl")),
                          pv)


RANK_FILES = ("A", "H", "Y", "conn", "buff")


@pytest.mark.parametrize("graph,k", [("cora2708", 4), ("er48", 3),
                                     ("planted", 8)])
def test_rank_files_are_byte_equal_and_read_back(graphs, tmp_path, graph, k):
    """``A.r/H.r/Y.r/conn.r/buff.r/config`` byte-equal to the reference's;
    ``read_conn``/``read_buff`` give back the plan they were written from
    (an id-ordered plan: send lists as global ids, receive counts)."""
    a = graphs[graph]
    n = a.shape[0]
    pv, _ = port.partition_hypergraph_colnet(a, k)
    y = sp.csr_matrix((np.ones(n, np.float32),
                       (np.arange(n), np.arange(n) % 3)), shape=(n, 3))
    cfg = ModelConfig(nlayers=2, nvtx=n, widths=[16, 3])
    port.write_rank_files(str(tmp_path / "port"), a, y, pv, k, cfg)
    ref.write_rank_files(str(tmp_path / "ref"), a, y, pv, k,
                         RefModelConfig(2, n, [16, 3]))
    names = ["config"] + [f"{f}.{r}" for f in RANK_FILES for r in range(k)]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for name in names:
        assert _bytes(tmp_path / "port" / name) == \
            _bytes(tmp_path / "ref" / name), name
    plan = build_comm_plan(a, pv, k, row_order="id")
    owned = [np.where(pv == r)[0] for r in range(k)]
    for r in range(k):
        conn = port.read_conn(str(tmp_path / "port" / f"conn.{r}"))
        buff = port.read_buff(str(tmp_path / "port" / f"buff.{r}"))
        want_conn = {q: owned[r][plan.send_idx[r, q, :plan.send_counts[r, q]]]
                     for q in range(k) if q != r and plan.send_counts[r, q]}
        assert conn.keys() == want_conn.keys()
        for q in conn:
            assert np.array_equal(conn[q], want_conn[q])
            assert (pv[conn[q]] == r).all()
        assert buff == {q: int(plan.send_counts[q, r]) for q in range(k)
                        if q != r and plan.send_counts[q, r]}
        ref_conn = ref.read_conn(str(tmp_path / "ref" / f"conn.{r}"))
        assert {q: v.tolist() for q, v in ref_conn.items()} == \
            {q: v.tolist() for q, v in conn.items()}
        assert ref.read_buff(str(tmp_path / "ref" / f"buff.{r}")) == buff


def _run_cli(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out


def _strip_times(text, root):
    return [line.split("  time_s=")[0].replace(str(root), "ROOT")
            for line in text.splitlines()]


def test_partition_cli_writes_the_reference_files(tmp_path, monkeypatch,
                                                  capsys):
    """``python -m sgcn_tpu_torch.partition -k 4,8 -m hp,gp,rp
    --rank-files …`` against ``python -m sgcn_tpu.partition`` on the same
    normalized cora2708 and seed: every ``.<k>.<mode>`` file and every
    rank file byte-equal, the same printed lines but for ``time_s``."""
    lines = {}
    for name, main in (("port", partition_main), ("ref", ref_partition_main)):
        root = tmp_path / name
        root.mkdir()
        write_mtx(str(root / "cora.A.mtx"), normalize_adjacency(
            read_mtx(CORA_A)))
        out = _run_cli(main, [
            "partition", "-a", str(root / "cora.A.mtx"), "-k", "4,8",
            "-m", "hp,gp,rp", "-s", "5", "-e", "0.05", "--rank-files",
            str(root / "ranks"), "-y", str(FIX / "cora2708.Y.mtx"), "-l", "3",
            "--hidden", "32"], monkeypatch, capsys)
        lines[name] = _strip_times(out, root)
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 7
    assert lines["port"][0].startswith("hp: ROOT/cora.A.mtx.4.hp  km1=")
    assert lines["port"][-1] == "rank files → ROOT/ranks"
    names = [f"cora.A.mtx.{k}.{m}" for k in (4, 8) for m in ("hp", "gp", "rp")]
    names += [f"ranks/{f}.{r}" for f in RANK_FILES for r in range(4)]
    names += ["ranks/config"]
    for name in names:
        assert _bytes(tmp_path / "port" / name) == \
            _bytes(tmp_path / "ref" / name), name
    assert _bytes(tmp_path / "port" / "ranks" / "config") == b"3 2708 32 32 7\n"


def test_partition_cli_refuses_bad_inputs(tmp_path, monkeypatch, capsys):
    write_mtx(str(tmp_path / "g.mtx"), er_graph())
    for argv, msg in ((["-k", "4,x"], "bad -k value '4,x'"),
                      (["-k", "4", "-m", "xp"], "unknown mode xp")):
        monkeypatch.setattr(sys, "argv", ["partition", "-a",
                                          str(tmp_path / "g.mtx"), *argv])
        with pytest.raises(SystemExit, match=msg):
            partition_main()


# ------------------------------------------------------------ the pipeline
def test_pipeline_prep_partition_train_matches_reference_trainer(
        tmp_path, monkeypatch, capsys):
    """prep → partition hp → train CLI (``--device cpu``, 2 epochs) on the
    port's own files.  The reference trainer, on its own reads of the same
    files and the train CLI's initial weights (written by the CLI's
    ``--save-checkpoint`` at step 0 and loaded by the reference's
    ``load_checkpoint``), gives the same two losses within rtol 1e-5
    (``tests/test_torch_train.py``'s float32 tolerance).  The reference
    steps on k × the loss gradient on this tree's JAX (ROADMAP C3), so it
    gets ``optax.scale(1/k)`` before Adam, as the other parity tests do."""
    k = 8
    _run_cli(prep_main, ["prep", "-a", CORA_A, "-o", str(tmp_path), "-n",
                         "cora", "-l", "2", "-f", "16", "-c", "7"],
             monkeypatch, capsys)
    a_path = str(tmp_path / "cora.A.mtx")
    out = _run_cli(partition_main, ["partition", "-a", a_path, "-k", str(k),
                                    "-m", "hp"], monkeypatch, capsys)
    assert out.startswith(f"hp: {a_path}.{k}.hp  km1=")
    files = ["-a", a_path, "-p", f"{a_path}.{k}.hp", "-s", str(k),
             "--features-mtx", str(tmp_path / "cora.H.mtx"), "--labels-mtx",
             str(tmp_path / "cora.Y.mtx"), "-l", "2", "--hidden", "16",
             "--device", "cpu"]
    init = str(tmp_path / "init.npz")
    train_main(files + ["--epochs", "0", "--warmup", "0",
                        "--save-checkpoint", init])
    capsys.readouterr()
    train_main(files + ["--epochs", "2", "--warmup", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    losses = [float(x.split()[-1]) for x in lines if x.startswith("epoch ")]
    report = json.loads(lines[-1])
    assert len(losses) == 2 and report["epochs"] == 2

    a = ref_read_mtx(a_path)
    pv = ref.read_partvec(f"{a_path}.{k}.hp")
    feats = ref_read_features(str(tmp_path / "cora.H.mtx"))
    labels = ref_read_labels(str(tmp_path / "cora.Y.mtx"))
    assert feats.shape == (2708, 1) and labels.max() == 6
    rplan = ref_build_comm_plan(a, pv, k)
    with monkeypatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        rtr = RefTrainer(rplan, fin=1, widths=[16, 7], lr=0.01,
                         optimizer=optax.chain(optax.scale(1.0 / k),
                                               optax.adam(0.01)))
        assert ref_ckpt.load_checkpoint(rtr, init) == 0
        rdata = ref_make_train_data(rplan, feats, labels)
        ref_losses = [float(rtr.step(rdata)) for _ in range(2)]
    print(f"pipeline losses: port {losses}, reference {ref_losses}")
    # the CLI prints six decimals; compare at that resolution too
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=5e-7)
