"""The port's offline front end against the reference's: the ``config``
sidecar, the MatrixMarket writer, preprocessing and its CLI, and the
dataset generators (``sgcn_tpu_torch`` vs ``sgcn_tpu``).

Both packages run the same numpy/scipy code on the same inputs, so files
are compared BYTE for byte and arrays EXACTLY: there is no tolerance in
this module.  The CLIs run in-process through ``main()`` with
``sys.argv`` set.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import er_graph
from sgcn_tpu.io import datasets as ref_ds
from sgcn_tpu.io.config import ModelConfig as RefModelConfig
from sgcn_tpu.io.config import read_config as ref_read_config
from sgcn_tpu.io.config import write_config as ref_write_config
from sgcn_tpu.io.mtx import read_mtx as ref_read_mtx
from sgcn_tpu.io.mtx import write_mtx as ref_write_mtx
from sgcn_tpu.prep import normalize as ref_norm
from sgcn_tpu.prep.__main__ import main as ref_prep_main
from sgcn_tpu_torch.io import datasets as ds
from sgcn_tpu_torch.io.config import ModelConfig, read_config, write_config
from sgcn_tpu_torch.io.mtx import read_mtx, write_mtx
from sgcn_tpu_torch.prep import normalize as norm
from sgcn_tpu_torch.prep.__main__ import main as prep_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CORA_A = os.path.join(FIX, "cora2708.A.mtx")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_files(dir_a, dir_b, names):
    for name in names:
        got, want = _bytes(os.path.join(dir_a, name)), \
            _bytes(os.path.join(dir_b, name))
        assert got == want, f"{name} differs from the reference's"


def _same_csr(got, want):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field


def _graphs():
    return {"cora2708": read_mtx(CORA_A), "er48": er_graph(),
            "karate": ds.karate()[0]}


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("nlayers,nvtx,widths", [
    (2, 2708, [16, 7]), (3, 169343, [128, 128, 40]), (1, 34, [2])])
def test_write_config_is_byte_equal_and_reads_back(tmp_path, nlayers, nvtx,
                                                   widths):
    """The legacy ``nlayers nvtx f1 … nout`` line, byte for byte; both
    readers parse it to the same fields and layer dims."""
    write_config(tmp_path / "port", ModelConfig(nlayers, nvtx, widths))
    ref_write_config(tmp_path / "ref", RefModelConfig(nlayers, nvtx, widths))
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")
    assert _bytes(tmp_path / "port") == (
        " ".join(map(str, [nlayers, nvtx, *widths])) + "\n").encode()
    cfg, ref = read_config(tmp_path / "ref"), ref_read_config(tmp_path / "port")
    assert (cfg.nlayers, cfg.nvtx, cfg.widths, cfg.nout) == \
        (ref.nlayers, ref.nvtx, ref.widths, ref.nout)
    assert cfg.layer_dims(1433) == ref.layer_dims(1433)


# -------------------------------------------------------------------- mtx
@pytest.mark.parametrize("what", ["ahat", "features", "labels", "comment"])
def test_write_mtx_is_byte_equal(tmp_path, what):
    """``scipy.io.mmwrite`` of the COO form at precision 8, comment line
    included; the port's reader reads the file back exactly."""
    a = read_mtx(CORA_A)
    m, comment = {
        "ahat": (norm.normalize_adjacency(a), ""),
        "features": (norm.synthetic_features(2708, 3), ""),
        "labels": (norm.synthetic_labels(2708, 7, seed=5), ""),
        "comment": (er_graph(), "written by a test"),
    }[what]
    write_mtx(str(tmp_path / "port.mtx"), m, comment=comment)
    ref_write_mtx(str(tmp_path / "ref.mtx"), m, comment=comment)
    assert _bytes(tmp_path / "port.mtx") == _bytes(tmp_path / "ref.mtx")
    back = read_mtx(str(tmp_path / "port.mtx"))
    _same_csr(back, ref_read_mtx(str(tmp_path / "ref.mtx")))
    # precision 8 round-trips float32 values within one rounding of 8
    # significant digits
    np.testing.assert_allclose(back.toarray(), sp.csr_matrix(m).toarray(),
                               rtol=1e-7)


# ------------------------------------------------------------- preprocess
def test_synthetic_features_and_labels_equal_reference():
    _same_csr(norm.synthetic_features(50, 4), ref_norm.synthetic_features(50, 4))
    for seed in (0, 3):
        _same_csr(norm.synthetic_labels(500, 7, seed),
                  ref_norm.synthetic_labels(500, 7, seed))


@pytest.mark.parametrize("graph", ["cora2708", "er48", "karate"])
def test_preprocess_writes_the_reference_files(tmp_path, graph):
    """``<name>.{A,H,Y}.mtx`` + ``config`` byte-equal to the reference's,
    and the same returned config."""
    a = _graphs()[graph]
    kw = dict(nlayers=3, hidden=8, nclasses=4, seed=2)
    cfg = norm.preprocess(a, str(tmp_path / "port"), graph, **kw)
    ref = ref_norm.preprocess(a, str(tmp_path / "ref"), graph, **kw)
    assert (cfg.nlayers, cfg.nvtx, cfg.widths) == \
        (ref.nlayers, ref.nvtx, ref.widths) == (3, a.shape[0], [8, 8, 4])
    _same_files(tmp_path / "port", tmp_path / "ref",
                [f"{graph}.{m}.mtx" for m in "AHY"] + ["config"])


def test_prep_cli_writes_the_reference_files_and_line(tmp_path, monkeypatch,
                                                      capsys):
    """``python -m sgcn_tpu_torch.prep`` and ``python -m sgcn_tpu.prep``
    with the same flags: the same files and the same printed line."""
    lines = {}
    for name, main in (("port", prep_main), ("ref", ref_prep_main)):
        out = str(tmp_path / name)
        monkeypatch.setattr(sys, "argv", [
            "prep", "-a", CORA_A, "-o", out, "-n", "cora", "-l", "2",
            "-f", "16", "-c", "7", "-s", "3"])
        main()
        lines[name] = capsys.readouterr().out.replace(out, "OUT")
    assert lines["port"] == lines["ref"] == (
        "wrote cora.A/H/Y.mtx + config (n=2708, widths=[16, 7]) to OUT\n")
    _same_files(tmp_path / "port", tmp_path / "ref",
                ["cora.A.mtx", "cora.H.mtx", "cora.Y.mtx", "config"])


# ------------------------------------------------------------- generators
GENERATORS = {
    "karate": lambda m: m.karate(),
    "planted_partition": lambda m: m.planted_partition(n=200, nclasses=4,
                                                       seed=7),
    "planted_partition_defaults": lambda m: m.planted_partition(),
    "dcsbm_graph": lambda m: m.dcsbm_graph(3000, seed=1),
    "dcsbm_graph_small_comm": lambda m: m.dcsbm_graph(
        500, ncomm=4, avg_deg=6, p_in=0.7, alpha=2.0, seed=4),
    "ba_graph": lambda m: m.ba_graph(2000, m=5, seed=2),
    "cora_like": lambda m: m.cora_like(seed=3),
    "er_graph": lambda m: m.er_graph(1000, avg_deg=10, seed=5),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_are_array_equal(name):
    """Same seed, same arrays: every sparse output's CSR triplet and every
    dense output exactly."""
    got, want = GENERATORS[name](ds), GENERATORS[name](ref_ds)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if sp.issparse(w):
            _same_csr(g, w)
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)
    a = got[0]
    assert (a != a.T).nnz == 0 and a.diagonal().sum() == 0   # symmetric, no loops


def test_ba_graph_refuses_n_not_above_m():
    with pytest.raises(ValueError, match="need n > m"):
        ds.ba_graph(5, m=5)


@pytest.mark.parametrize("dense", [False, True])
def test_save_npz_dataset_round_trips_like_the_reference(tmp_path, dense):
    """The snapshot layout: the same arrays under the same keys as the
    reference writes (the zip container's timestamps may differ), read
    back by both loaders to the same (adjacency, features, labels)."""
    a, feats, labels = ds.cora_like(n=300, seed=1)
    feats = feats.toarray() if dense else feats
    ds.save_npz_dataset(str(tmp_path / "port.npz"), a, feats, labels)
    ref_ds.save_npz_dataset(str(tmp_path / "ref.npz"), a, feats, labels)
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "ref.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype and np.array_equal(p[key], r[key])
    got = ds.load_npz_dataset(str(tmp_path / "port.npz"))
    want = ref_ds.load_npz_dataset(str(tmp_path / "ref.npz"))
    _same_csr(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


@pytest.mark.parametrize("parts", ["A", "AH", "AHY"])
def test_save_fixture_writes_the_reference_files(tmp_path, parts):
    a, feats, labels = ds.planted_partition(n=120, seed=2)
    kw = {"features": feats if "H" in parts else None,
          "labels": labels if "Y" in parts else None}
    got = ds.save_fixture(str(tmp_path / "port"), a, **kw)
    want = ref_ds.save_fixture(str(tmp_path / "ref"), a, **kw)
    assert sorted(got) == sorted(want) == sorted(parts)
    for key in parts:
        assert _bytes(got[key]) == _bytes(want[key])
