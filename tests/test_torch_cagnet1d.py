"""The port's CAGNET-style broadcast baseline against the reference's
(``sgcn_tpu_torch/baselines/cagnet1d.py`` vs
``sgcn_tpu/baselines/cagnet1d.py``), on cora2708 at GCN 1433 → 16 → 7
with sigmoid on every layer.

The reference's ``lax.all_gather`` + ``take`` + ``segment_sum`` and the
port's row pack + tile SpMM (its plain version here) sum each row's
edges in the same dst-sorted order, so the rows agree within float32
rounding of the dense products.  On gloo ranks (one process per part,
``tests/torch_rank_child.py``) the all-gather replaces the pack, and the
rows must equal the stacked form bit for bit.
"""

import dataclasses
import os
import pickle
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp

from sgcn_tpu.baselines.cagnet1d import BroadcastGCN1D as RefBroadcast
from sgcn_tpu.baselines.cagnet1d import \
    broadcast_edge_lists as ref_edge_lists
from sgcn_tpu.parallel import plan as ref_plan_mod
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu_torch.baselines.cagnet1d import (BroadcastGCN1D,
                                               broadcast_edge_lists)
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.ops import tile_spmm
from sgcn_tpu_torch.parallel.plan import relabel_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency

import torch_rank_child as child

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
WIDTHS = [16, 7]


@pytest.fixture(scope="module")
def cora():
    a, feats, _labels = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    ref = RefBroadcast(ref_normalize(a), pv, 8, fin=feats.shape[1],
                       widths=WIDTHS, seed=3)
    return {"a": a, "ahat": normalize_adjacency(a), "feats": feats,
            "pv": pv, "ref": ref,
            "params": [np.asarray(w) for w in ref.params]}


def _dense64(ahat, feats, params):
    h = feats.astype(np.float64)
    a64 = sp.csr_matrix(ahat, dtype=np.float64)
    for w in params:
        h = 1.0 / (1.0 + np.exp(-(a64 @ h) @ w.astype(np.float64)))
    return h


def test_relabel_plan_and_edge_lists_equal_the_references(cora):
    """The relabel-only plan and the broadcast edge lists, array for
    array."""
    port = relabel_plan(cora["ahat"], cora["pv"], 8)
    ref = ref_plan_mod.relabel_plan(ref_normalize(cora["a"]), cora["pv"], 8)
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name, None)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        elif want is not None:
            assert got == want, f.name
    for got, want in zip(broadcast_edge_lists(cora["ahat"], port),
                         ref_edge_lists(ref_normalize(cora["a"]), ref)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_rows_match_the_reference_and_float64(cora):
    """The port's rows within rtol 1e-5 / atol 1e-6 of the reference's
    on the same weights (observed ≤ 1.2e-7), and of the float64 dense
    forward."""
    bc = BroadcastGCN1D(cora["ahat"], cora["pv"], 8, fin=1433,
                        widths=WIDTHS, params=cora["params"], device="cpu")
    got = bc.forward(cora["feats"])
    want = cora["ref"].forward(cora["feats"])
    print(f"max |port - reference| {np.abs(got - want).max():.3g}")
    assert got.shape == want.shape == (2708, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, _dense64(cora["ahat"], cora["feats"], cora["params"]),
        rtol=1e-5, atol=1e-6)


def test_fused_equals_unfused_bit_for_bit(cora):
    kw = dict(fin=1433, widths=WIDTHS, params=cora["params"], device="cpu")
    a = BroadcastGCN1D(cora["ahat"], cora["pv"], 8, **kw)
    b = BroadcastGCN1D(cora["ahat"], cora["pv"], 8, fused=True, **kw)
    assert np.array_equal(a.forward(cora["feats"]), b.forward(cora["feats"]))


def test_phase_report_counts_and_volume(cora, monkeypatch):
    """Two epochs of two layers: 4 ``data_comm`` and 4 ``local_spmm``
    phases, one family pass each (the local SpMM), and the broadcast's
    wire volume ``(k−1)·n`` rows an exchange; ``fused`` reports one
    ``total`` phase an epoch."""
    calls = []
    family = tile_spmm.spmm_tiles_classes

    def counting(*a, **kw):
        calls.append(a[3].shape)
        return family(*a, **kw)

    import sgcn_tpu_torch.baselines.cagnet1d as cagnet
    monkeypatch.setattr(cagnet, "spmm_tiles_classes", counting)
    bc = BroadcastGCN1D(cora["ahat"], cora["pv"], 8, fin=1433,
                        widths=WIDTHS, params=cora["params"], device="cpu")
    report, out = bc.run_epochs(cora["feats"], epochs=2)
    assert out.shape == (2708, 7) and report["epochs"] == 2
    ph = report["phases"]
    assert ph["data_comm"]["count"] == ph["local_spmm"]["count"] == 4
    assert report["send_volume_per_exchange"] == 7 * 2708
    b = bc.plan.b
    assert calls == [(8, 8 * b, 1433), (8, 8 * b, 16)] * 2
    rf, _ = BroadcastGCN1D(cora["ahat"], cora["pv"], 8, fin=1433,
                           widths=WIDTHS, params=cora["params"],
                           device="cpu", fused=True).run_epochs(
                               cora["feats"], epochs=2)
    assert set(rf["phases"]) == {"total"} and \
        rf["phases"]["total"]["count"] == 2
    with pytest.raises(ValueError, match="epochs"):
        bc.run_epochs(cora["feats"], epochs=0)


def test_four_gloo_ranks_equal_the_stacked_form(cora):
    """On 4 gloo ranks (cora 4-hp), each rank's rows — the all-gather in
    the pack's place — equal the stacked form's bit for bit, fused and
    phase-split, and each rank reports the stacked wire volume."""
    _a, feats, _l, pv, _plan = child.cora_plan("cora2708.4.hp")
    stacked = BroadcastGCN1D(cora["ahat"], pv, 4, fin=1433, widths=WIDTHS,
                             params=cora["params"], device="cpu")
    want = stacked.forward(feats)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump({"widths": WIDTHS, "params": cora["params"]}, fh)
        res = child.spawn_ranks(child.broadcast_main, 4, out)
    for r in range(4):
        for fused in (False, True):
            assert np.array_equal(res[r][fused]["out"], want), (r, fused)
            assert res[r][fused]["report"]["send_volume_per_exchange"] == \
                3 * 2708
        assert res[r][False]["report"]["phases"]["data_comm"]["count"] == 4
