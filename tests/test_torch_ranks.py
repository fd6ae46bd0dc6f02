"""The rank runtime (one process per part, ROADMAP A2b) against the
stacked layout and the reference's trainer, on cora2708 under its 8-part
hp partition with 8 gloo ranks.

One module-scoped spawn (``tests/torch_rank_child.py::ranks_main``, one
``file://`` rendezvous in a temporary directory) runs every rank check
and returns the results through files.  Per rank: one GCN aggregation's
forward and VJP on the same ``h`` and ``g`` the stacked op reads, on the
a2a and the ring, float32 and the bf16 wire — the rank path runs the
fused entry's arithmetic in two launches, so it must equal the stacked
op bit for bit — with the order of its launches and waits; three
training steps per transport from one set of initial weights; the
refusals.  The loss's count and the weight gradients are all-reduced in
another order than the stacked sums, so the steps are held within the
float32 contract.
"""

import dataclasses
import os
import pickle
import tempfile

import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.ops.tile_spmm import pspmm_tiles_ragged, pspmm_tiles_sym
from sgcn_tpu_torch.parallel import RankGroup, shard_proxy_plan
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  make_train_data_multihost)

import torch_rank_child as child

KEYS = ["a2a-float32", "a2a-bfloat16", "ragged-float32", "ragged-bfloat16"]
K = 8


@pytest.fixture(scope="module")
def cora():
    """The plan, data and the reference's initial weights (seed 3)."""
    ahat, feats, labels, pv, plan = child.cora_plan("cora2708.8.hp")
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    ref0 = RefTrainer(ref_plan, fin=child.FIN, widths=child.WIDTHS, seed=3)
    return {"ahat": ahat, "feats": feats, "labels": labels, "pv": pv,
            "plan": plan, "ref_plan": ref_plan,
            "p0": [np.asarray(w) for w in ref0.params]}


@pytest.fixture(scope="module")
def ranks(cora):
    """Every rank's results (``ranks_main``), from one spawn of 8."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(cora["p0"], fh)
        return child.spawn_ranks(child.ranks_main, K, out)


@pytest.fixture(scope="module")
def stacked(cora):
    """The stacked op on the same inputs, and the stacked trainer."""
    plan = cora["plan"]
    h_all, g_all = child.op_inputs(plan)
    pa = {f: torch.as_tensor(getattr(plan, f)) for f in (
        "recv_src", "ring_src", "ptile_lsrc", "ptile_lld", "ptile_lw",
        "ptile_hwsrc", "ptile_hrsrc", "ptile_hld", "ptile_hw")}
    out = {"fwd": {}, "vjp": {}, "losses": {}, "params": {}}
    for key in KEYS:
        sched, wire = key.split("-")
        wire = None if wire == "float32" else wire
        h = torch.tensor(h_all, requires_grad=True)
        if sched == "a2a":
            y = pspmm_tiles_sym(h, pa["recv_src"], pa["ptile_lsrc"],
                                pa["ptile_lld"], pa["ptile_lw"],
                                pa["ptile_hwsrc"], pa["ptile_hld"],
                                pa["ptile_hw"], plan.pallas_tb,
                                plan.pallas_lclasses, plan.pallas_hclasses,
                                wire)
        else:
            y = pspmm_tiles_ragged(h, pa["ring_src"], pa["ptile_lsrc"],
                                   pa["ptile_lld"], pa["ptile_lw"],
                                   pa["ptile_hrsrc"], pa["ptile_hld"],
                                   pa["ptile_hw"], plan.pallas_tb,
                                   plan.pallas_lclasses,
                                   plan.pallas_hclasses, plan.rr_sizes, wire)
        y.backward(torch.as_tensor(g_all))
        out["fwd"][key], out["vjp"][key] = y.detach().numpy(), h.grad.numpy()
    data = make_train_data(plan, cora["feats"], cora["labels"])
    for sched in ("a2a", "ragged"):
        tr = FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                              lr=child.LR, params=cora["p0"],
                              comm_schedule=sched, device="cpu")
        out["losses"][sched] = [tr.step(data) for _ in range(child.STEPS)]
        out["params"][sched] = [w.detach().numpy() for w in tr.params]
        if sched == "a2a":
            out["eval"], out["pred"] = tr.evaluate(data), tr.predict(data)
    return out


@pytest.mark.parametrize("key", KEYS)
def test_one_layer_forward_and_vjp_equal_stacked(ranks, stacked, key):
    """Each rank's aggregation and its VJP equal the stacked op's row for
    its part bit for bit, on both transports and both wires."""
    for r in range(K):
        np.testing.assert_array_equal(ranks[r]["fwd"][key][0],
                                      stacked["fwd"][key][r])
        np.testing.assert_array_equal(ranks[r]["vjp"][key][0],
                                      stacked["vjp"][key][r])


@pytest.mark.parametrize("key", KEYS)
def test_local_launch_is_issued_before_the_wait(ranks, key):
    """The overlap: the exchange is issued, the local family launch runs,
    then the rank waits, then the halo family launch runs."""
    for r in range(K):
        assert ranks[r]["order"][key] == ["issue", "family", "wait",
                                          "family"]


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
def test_three_steps_track_the_stacked_trainer(ranks, stacked, sched):
    """Losses within rtol 1e-6 of the stacked trainer's (observed ≤ 1.3e-7:
    the loss sums over the ranks in another order), the weights within
    1e-5 for 99 % of the entries and 5e-3 for all (observed ≤ 2.5e-7),
    and every rank holds the same losses and weights bit for bit."""
    for r in range(K):
        assert ranks[r]["losses"][sched] == ranks[0]["losses"][sched]
        for a, b in zip(ranks[r]["params"][sched],
                        ranks[0]["params"][sched]):
            assert np.array_equal(a, b)
    print(f"{sched}: ranks {ranks[0]['losses'][sched]} stacked "
          f"{stacked['losses'][sched]}")
    np.testing.assert_allclose(ranks[0]["losses"][sched],
                               stacked["losses"][sched], rtol=1e-6)
    for got, want in zip(ranks[0]["params"][sched],
                         stacked["params"][sched]):
        gap = np.abs(got - want)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


def test_three_steps_track_the_reference_trainer(cora, ranks):
    """The a2a steps against the reference's 8-part trainer from the same
    weights, its k-fold gradient (ROADMAP C3) measured on its first step
    and divided out of its optimizer: losses within rtol 1e-5."""
    ref_plan = cora["ref_plan"]
    rdata = ref_make_train_data(ref_plan, cora["feats"], cora["labels"])
    probe = RefTrainer(ref_plan, fin=child.FIN, widths=child.WIDTHS, seed=3,
                       optimizer=optax.sgd(1.0))
    probe.step(rdata)
    # one SGD step of rate 1 moves the weights by the reference's step
    # gradient; the port's stacked trainer gives the loss gradient
    tr = FullBatchTrainer(cora["plan"], fin=child.FIN, widths=child.WIDTHS,
                          params=cora["p0"], device="cpu")
    tr._one_step(make_train_data(cora["plan"], cora["feats"],
                                 cora["labels"]))
    factor = float(np.linalg.norm(cora["p0"][1] - np.asarray(
        probe.params[1])) / np.linalg.norm(
            tr.params[1].grad.detach().numpy()))
    assert round(factor) in (1, K), factor
    ref = RefTrainer(ref_plan, fin=child.FIN, widths=child.WIDTHS, seed=3,
                     optimizer=optax.chain(
                         optax.scale(1.0 / round(factor)),
                         optax.adam(child.LR)))
    want = [ref.step(rdata) for _ in range(child.STEPS)]
    print(f"ranks {ranks[0]['losses']['a2a']} reference {want}")
    np.testing.assert_allclose(ranks[0]["losses"]["a2a"], want, rtol=1e-5)


def test_evaluate_predict_and_report(cora, ranks, stacked):
    """After the a2a steps: evaluation (loss and accuracy all-reduced)
    within rtol 1e-6 of the stacked trainer's, the all-gathered logits
    within 1e-5, and each rank's comm report its own part's rows."""
    for r in range(K):
        loss, acc = ranks[r]["eval"]
        assert loss == pytest.approx(stacked["eval"][0], rel=1e-6)
        assert acc == pytest.approx(stacked["eval"][1], abs=1e-7)
        np.testing.assert_allclose(ranks[r]["pred"], stacked["pred"],
                                   rtol=1e-5, atol=1e-5)
        rep = ranks[r]["report"]
        sent = int(cora["plan"].predicted_send_volume[r])
        assert rep["total_send_volume"] == sent * (
            2 * len(child.WIDTHS) * child.STEPS + 2 * len(child.WIDTHS))
        assert rep["total_recv_volume"] == rep["total_send_volume"]


def test_non_gcn_modes_raise(ranks):
    """On a rank group GAT and compute_dtype build (A2c's first half),
    and so do the stale halo and replicas (its second half) and an
    asymmetric plan (its last part): none raises."""
    assert ranks[0]["errors"] == {}
    assert ranks[0]["built"] == ["gat", "compute_dtype", "stale", "replica",
                                 "asymmetric"]


def test_group_size_and_slice_guards(cora):
    """A rank group must hold one rank per part of a full plan, or one
    rank for a slice; a directed plan builds, and with replicas raises
    the reference's gate (no collective is needed to reach the
    guards)."""
    plan = cora["plan"]
    with pytest.raises(ValueError, match="one rank per part, 8 ranks"):
        FullBatchTrainer(plan, fin=8, widths=[4], device="cpu",
                         mesh=RankGroup(0, 4, "cpu"))
    sl = shard_proxy_plan(plan, 2)
    with pytest.raises(ValueError, match="one rank per part, 1 ranks"):
        FullBatchTrainer(sl, fin=8, widths=[4], device="cpu",
                         mesh=RankGroup(0, 8, "cpu"))
    asym = dataclasses.replace(plan, symmetric=False)
    with pytest.raises(ValueError, match="replica_budget uses the "
                       "symmetric-Â custom backward"):
        FullBatchTrainer(asym, fin=8, widths=[4], device="cpu",
                         mesh=RankGroup(0, 8, "cpu"), replica_budget=50)
    tr = FullBatchTrainer(asym, fin=8, widths=[4], device="cpu",
                          mesh=RankGroup(0, 8, "cpu"))
    assert tr.plan.chip_ids is not None and not tr.plan.symmetric


def test_multihost_data_is_the_ranks_own_rows(cora):
    """``make_train_data_multihost``: rank r's blocks are the stacked
    data's row r (features, labels, masks), read from its own rows."""
    plan = cora["plan"]
    mask = (np.arange(plan.n) % 3 == 0).astype(np.float32)
    full = make_train_data(plan, cora["feats"], cora["labels"],
                           train_mask=mask)
    for r in (0, 6):
        mine = make_train_data_multihost(plan, RankGroup(r, K, "cpu"),
                                         cora["feats"], cora["labels"],
                                         train_mask=mask)
        for name in ("h0", "labels", "train_valid", "eval_valid"):
            assert torch.equal(getattr(mine, name),
                               getattr(full, name)[r: r + 1]), name
    with pytest.raises(ValueError, match="full k-way plan"):
        make_train_data_multihost(shard_proxy_plan(plan, 1),
                                  RankGroup(0, 1, "cpu"),
                                  cora["feats"], cora["labels"])
