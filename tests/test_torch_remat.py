"""``FullBatchTrainer(remat=True)`` of the port: each layer runs inside a
non-reentrant ``torch.utils.checkpoint`` (where the reference wraps its
whole forward in ``jax.checkpoint``), so autograd keeps the layer inputs
only and the backward runs each layer's packs and fused / K5 launches
again, custom Functions included.

* remat == the plain step bit for bit (losses, every parameter after 3
  steps) on cora2708 8-hp for GCN and GAT, a2a and the ring, under
  ``compute_dtype='bfloat16'`` and ``halo_dtype='bfloat16'``, and on a
  directed cora (the transposed backward);
* remat against the reference's ``remat=True`` trainer (its kernel path
  forced with ``SGCN_PALLAS_SPMM=1``, ``optax.scale(1/8)`` before Adam for
  ROADMAP C3, as ``tests/test_torch_train.py`` does): losses within the
  trainer tolerance, rtol 1e-5;
* the stale and replica modes refuse remat with the reference's
  messages, verbatim.
"""

import os

import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
STEPS = 3
LR = 0.01


def _directed(a):
    """cora2708 with each undirected edge kept in one direction, which one
    by a coin from ``default_rng(0)`` (``tests/test_torch_asym.py``)."""
    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    rows = np.where(flip, up.col, up.row)
    cols = np.where(flip, up.row, up.col)
    return sp.csr_matrix((np.ones(up.nnz, np.float32), (rows, cols)),
                         shape=a.shape)


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": plan,
            "directed": build_comm_plan(normalize_adjacency(_directed(a)),
                                        pv, 8),
            "data": make_train_data(plan, feats, labels)}


def _run(plan, data, fin, remat, **kw):
    tr = FullBatchTrainer(plan, fin=fin, widths=WIDTHS, seed=3, lr=LR,
                          remat=remat, device="cpu", **kw)
    losses = [tr.step(data) for _ in range(STEPS)]
    return losses, [p.detach().clone() for p in tr.model.parameters()]


CASES = {
    "gcn-a2a": dict(),
    "gcn-ragged": dict(comm_schedule="ragged"),
    "gat-a2a": dict(model="gat", activation="none"),
    "gat-ragged": dict(model="gat", activation="none",
                       comm_schedule="ragged"),
    "gcn-compute-bf16": dict(compute_dtype="bfloat16"),
    "gat-compute-bf16": dict(model="gat", activation="none",
                             compute_dtype="bfloat16"),
    "gcn-halo-bf16": dict(halo_dtype="bfloat16"),
    "gcn-bce": dict(loss="bce"),
    "gcn-directed": dict(directed=True),
    "gat-directed": dict(model="gat", activation="none", directed=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_equals_plain_bitwise(cora, case):
    """Three steps with ``remat=True`` == three plain steps from the same
    seed, bit for bit: every loss and every parameter (GAT's ``a1``, whose
    gradient is exactly 0, included)."""
    kw = dict(CASES[case])
    plan = cora["directed"] if kw.pop("directed", False) else cora["plan"]
    data = (cora["data"] if plan is cora["plan"] else
            make_train_data(plan, cora["feats"], cora["labels"]))
    fin = cora["feats"].shape[1]
    plain = _run(plan, data, fin, False, **kw)
    remat = _run(plan, data, fin, True, **kw)
    assert plain[0] == remat[0], (plain[0], remat[0])
    assert np.isfinite(plain[0]).all() and plain[0][-1] < plain[0][0]
    for x, y in zip(plain[1], remat[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_remat_tracks_reference_remat(cora, model):
    """The port's remat trainer against the reference's ``remat=True``
    trainer from the same initial weights: 3 losses within rtol 1e-5 (the
    trainer tolerance of ``tests/test_torch_train.py``), and the port's
    remat losses == its plain ones bit for bit."""
    feats, labels = cora["feats"], cora["labels"]
    fin = feats.shape[1]
    ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), cora["pv"], 8)
    act = {} if model == "gcn" else {"activation": "none"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        ref = RefTrainer(ref_plan, fin=fin, widths=WIDTHS, seed=3,
                         model=model, remat=True, **act,
                         optimizer=optax.chain(optax.scale(1.0 / 8),
                                               optax.adam(LR)))
        p0 = [{k: np.asarray(v) for k, v in p.items()}
              if isinstance(p, dict) else np.asarray(p) for p in ref.params]
        rdata = ref_make_train_data(ref_plan, feats, labels)
        ref_losses = [ref.step(rdata) for _ in range(STEPS)]
    params = (port_gcn.params_from_jax(p0) if model == "gcn"
              else port_gat.params_from_jax(p0))
    tr = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS, lr=LR,
                          model=model, remat=True, params=params,
                          device="cpu", **act)
    losses = [tr.step(cora["data"]) for _ in range(STEPS)]
    print(f"{model} remat losses {losses} vs reference {ref_losses}")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    plain = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS, lr=LR,
                             model=model, params=params, device="cpu", **act)
    assert [plain.step(cora["data"]) for _ in range(STEPS)] == losses


@pytest.mark.parametrize("kw", [
    dict(halo_staleness=1), dict(replica_budget=8),
    dict(replica_budget=8, halo_staleness=1)],
    ids=["stale", "replica", "replica-stale"])
def test_carried_modes_refuse_remat_with_reference_messages(cora, kw):
    """remat with a carried mode raises the reference's ``ValueError``,
    message for message (the carries are f32 state threaded through the
    step)."""
    fin = cora["feats"].shape[1]
    ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), cora["pv"], 8)
    with pytest.raises(ValueError) as want:
        RefTrainer(ref_plan, fin=fin, widths=WIDTHS, remat=True, **kw)
    with pytest.raises(ValueError) as got:
        FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS, remat=True,
                         device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "non-remat" in str(got.value)
