"""The rank runtime's GAT, bf16 and remat (ROADMAP A2c's first half)
against the stacked layout and the reference's trainer, on cora2708 under
its 8-part hp partition with 8 gloo ranks.

One module-scoped spawn (``tests/torch_rank_child.py::gat_ranks_main``,
one ``file://`` rendezvous in a temporary directory) runs every rank
check.  Per rank: one GAT layer's forward and VJP in ``h`` in each table
form the layer ships — fused, split, packed bf16 and fused on bf16
tables — on the a2a and the ring, and one GCN aggregation on bf16 rows
(``compute_dtype``: K1's bf16 family entry in two launches) on both
transports; each must equal the stacked op's row for its part bit for
bit (the same tables on the same wire, the stabilizer the all-reduced
max).  Then three training steps of GAT a2a and ring, GAT under
``compute_dtype`` and under ``remat``, and GCN under ``compute_dtype``,
from the reference's initial weights, against the stacked trainer (the
loss's count and the weight gradients are all-reduced in another order)
and against the reference's trainer.  GCN under ``compute_dtype`` is held
to a stacked emulation of the rank path's rounding points
(``_partwise_bf16``: each part's weight gradient rounded to bf16 on its
own, the parts summed in float32) as tightly as the float32 cases are
held to the stacked trainer.
"""

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
from sgcn_tpu_torch.parallel import RankGroup
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)

import torch_rank_child as child

K = 8
GAT_OP_KEYS = [f"{form}-{sched}" for sched in child.SCHEDS
               for form in child.GAT_OP_CASES]
BF16_CASES = ("gat-bf16", "gcn-bf16")


def _partwise_bf16(tr):
    """Point the stacked GCN trainer ``tr`` (``compute_dtype``, a2a) at a
    forward that casts each weight to bf16 once per part: part p's rows
    multiply their own copy, so part p's weight gradient is its own bf16
    matmul output, widened and summed over the parts in float32 by
    autograd.  Those are the rank path's rounding points (a rank's bf16
    partial, widened, then all-reduced; the reference's chips round
    theirs before the psum the same way); the stacked forward's one cast
    rounds the sum over every part's rows once instead.  Everything else
    is ``models/gcn.py::gcn_forward_local``'s stacked a2a forward."""
    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.models.gcn import get_activation
    from sgcn_tpu_torch.ops.tile_spmm import pspmm_tiles_sym

    m, st = tr.model, tr.model.fwd_static
    act, fact = (get_activation(m.activation),
                 get_activation(m.final_activation))

    def agg(x, pa):
        return pspmm_tiles_sym(
            x, pa["recv_src"], pa["ptile_lsrc"], pa["ptile_lld"],
            pa["ptile_lw"], pa["ptile_hwsrc"], pa["ptile_hld"],
            pa["ptile_hw"], st["pallas_tb"], st["pallas_lclasses"],
            st["pallas_hclasses"])

    def forward(h, pa):
        h = h.to(torch.bfloat16)
        nl = len(m.weights)
        for i, w in enumerate(m.weights):
            copies = [w.to(torch.bfloat16) for _ in range(h.shape[0])]

            def mm(x):
                return torch.stack([x[p] @ c for p, c in enumerate(copies)])
            if w.shape[1] < h.shape[-1] and \
                    h.shape[-1] >= PROJECT_FIRST_MIN_FIN:
                z = agg(mm(h), pa)
            else:
                z = mm(agg(h, pa))
            h = fact(z) if i == nl - 1 else act(z)
        return h

    m.forward = forward
    return tr


def _np(params):
    return [{k: np.asarray(v) for k, v in p.items()} if isinstance(p, dict)
            else np.asarray(p) for p in params]


@pytest.fixture(scope="module")
def cora():
    """The plan, data and the reference's initial weights (seed 3) of
    both models."""
    ahat, feats, labels, pv, plan = child.cora_plan("cora2708.8.hp")
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    kw = dict(fin=child.FIN, widths=child.WIDTHS, seed=3)
    p0 = {"gcn": _np(RefTrainer(ref_plan, **kw).params),
          "gat": _np(RefTrainer(ref_plan, **kw, model="gat",
                                activation="none").params)}
    return {"feats": feats, "labels": labels, "plan": plan,
            "ref_plan": ref_plan, "p0": p0}


@pytest.fixture(scope="module")
def ranks(cora):
    """Every rank's results (``gat_ranks_main``), from one spawn of 8."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(cora["p0"], fh)
        return child.spawn_ranks(child.gat_ranks_main, K, out)


@pytest.fixture(scope="module")
def stacked(cora):
    """The stacked ops on the same inputs, the stacked trainer's three
    steps per case, and GCN ``compute_dtype``'s three steps with the rank
    path's rounding points (``partwise``)."""
    plan = cora["plan"]
    out = {"gat_op": {}, "gcn_op": {}, "losses": {}, "params": {}}
    for sched in child.SCHEDS:
        setup = resolve_forward_setup(plan, model="gat", comm_schedule=sched)
        for form, (fout, cd) in child.GAT_OP_CASES.items():
            h, g, params = child.gat_op_inputs(plan, fout)
            out["gat_op"][f"{form}-{sched}"] = child.gat_layer_run(
                plan, setup, h, g, params, cd)
        h_all, g_all = child.op_inputs(plan)
        out["gcn_op"][sched] = child.gcn_bf16_op(plan, sched, h_all, g_all)
    data = make_train_data(plan, cora["feats"], cora["labels"])
    for case in list(child.STEP_CASES) + ["partwise"]:
        kw = child.step_kwargs("gcn-bf16" if case == "partwise" else case,
                               cora["p0"])
        tr = FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                              lr=child.LR, device="cpu", **kw)
        if case == "partwise":
            _partwise_bf16(tr)
        out["losses"][case] = [tr.step(data) for _ in range(child.STEPS)]
        out["params"][case] = [w.detach().numpy()
                               for w in tr.model.parameters()]
    return out


@pytest.fixture(scope="module")
def reference(cora):
    """The reference's trainer per case, three steps from the same
    weights, its k-fold step gradient (ROADMAP C3) measured per model on
    its first step and divided out of its optimizer."""
    ref_plan = cora["ref_plan"]
    rdata = ref_make_train_data(ref_plan, cora["feats"], cora["labels"])
    data = make_train_data(cora["plan"], cora["feats"], cora["labels"])
    factors, losses = {}, {}
    for model in ("gcn", "gat"):
        kw = dict(fin=child.FIN, widths=child.WIDTHS, seed=3, model=model,
                  activation="none" if model == "gat" else "relu")
        probe = RefTrainer(ref_plan, **kw, optimizer=optax.sgd(1.0))
        probe.step(rdata)
        # one SGD step of rate 1 moves the weights by the reference's
        # step gradient; the port's stacked trainer gives the loss's
        tr = FullBatchTrainer(cora["plan"], fin=child.FIN,
                              widths=child.WIDTHS, device="cpu", model=model,
                              activation=kw["activation"],
                              params=cora["p0"][model])
        tr._one_step(data)
        w0 = (cora["p0"][model][0]["w"] if model == "gat"
              else cora["p0"][model][0])
        w1 = (probe.params[0]["w"] if model == "gat" else probe.params[0])
        g = tr.model.layer_params()[0]
        g = (g["w"] if model == "gat" else g).grad.detach().numpy()
        factors[model] = float(np.linalg.norm(w0 - np.asarray(w1))
                               / np.linalg.norm(g))
    for case, kw in child.STEP_CASES.items():
        model = kw.get("model", "gcn")
        rkw = dict(fin=child.FIN, widths=child.WIDTHS, seed=3, model=model,
                   activation="none" if model == "gat" else "relu",
                   comm_schedule=kw.get("comm_schedule", "a2a"),
                   compute_dtype=kw.get("compute_dtype"),
                   remat=kw.get("remat", False))
        ref = RefTrainer(ref_plan, **rkw, optimizer=optax.chain(
            optax.scale(1.0 / round(factors[model])),
            optax.adam(child.LR)))
        losses[case] = [ref.step(rdata) for _ in range(child.STEPS)]
    return {"factors": factors, "losses": losses}


@pytest.mark.parametrize("key", GAT_OP_KEYS)
def test_gat_layer_forward_and_vjp_equal_stacked(ranks, stacked, key):
    """Each rank's GAT layer and its VJP in ``h`` equal the stacked
    layer's rows for its part bit for bit, in every table form and on
    both transports."""
    want_f, want_g = stacked["gat_op"][key]
    for r in range(K):
        got_f, got_g = ranks[r]["gat_op"][key]
        np.testing.assert_array_equal(got_f[0], want_f[r])
        np.testing.assert_array_equal(got_g[0], want_g[r])


@pytest.mark.parametrize("sched", child.SCHEDS)
def test_gcn_bf16_aggregation_equals_stacked(ranks, stacked, sched):
    """One GCN aggregation on bf16 rows and its VJP on each rank equal
    the stacked op's (the fused bf16 entry's arithmetic) bit for bit."""
    want_f, want_g = stacked["gcn_op"][sched]
    for r in range(K):
        got_f, got_g = ranks[r]["gcn_op"][sched]
        np.testing.assert_array_equal(got_f[0], want_f[r])
        np.testing.assert_array_equal(got_g[0], want_g[r])


@pytest.mark.parametrize("case", list(child.STEP_CASES))
def test_every_rank_holds_the_same_bits(ranks, case):
    """After three steps every rank holds rank 0's losses and weights
    bit for bit (the all-reduces give every rank the same sums)."""
    for r in range(1, K):
        assert ranks[r]["losses"][case] == ranks[0]["losses"][case]
        for a, b in zip(ranks[r]["params"][case], ranks[0]["params"][case]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", [c for c in child.STEP_CASES
                                  if c not in BF16_CASES])
def test_three_steps_track_the_stacked_trainer(ranks, stacked, case):
    """GAT a2a, ring and remat: losses within rtol 1e-6 of the stacked
    trainer's (observed ≤ 7.2e-8), the weights within 1e-5 for 99 % of
    the entries and 5e-3 for all (observed ≤ 7.9e-8): the weight
    gradients are each rank's float32 partial (``GatLayerSym``'s
    backward), all-reduced in another order than the stacked sum."""
    print(f"{case}: ranks {ranks[0]['losses'][case]} stacked "
          f"{stacked['losses'][case]}")
    np.testing.assert_allclose(ranks[0]["losses"][case],
                               stacked["losses"][case], rtol=1e-6)
    for got, want in zip(ranks[0]["params"][case], stacked["params"][case]):
        gap = np.abs(got - want)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


@pytest.mark.parametrize("case", BF16_CASES)
def test_three_bf16_steps_track_the_stacked_trainer(ranks, stacked, case):
    """Under ``compute_dtype``, within the float32 cases' bounds (losses
    rtol 1e-6, weights within 1e-5 for 99 % of the entries and 5e-3 for
    all).  GAT's weight gradients are float32 partials (``GatLayerSym``'s
    backward): held to the stacked trainer (observed: losses 8.4e-8,
    weights ≤ 9.6e-6).  GCN's are bf16 matmul outputs, so a rank rounds
    its partial to bf16 before the all-reduce where the stacked step
    rounds the one sum: held to the stacked trainer with the rank path's
    rounding points (``_partwise_bf16``; observed: losses 6.6e-8, weights
    equal), and shown to differ from the plain stacked trainer (observed
    there: losses 1.26e-5, weights ≤ 0.0192)."""
    got = ranks[0]["losses"][case]
    want_case = "partwise" if case == "gcn-bf16" else case
    want = stacked["losses"][want_case]
    gaps = [np.abs(a - b).max() for a, b in zip(
        ranks[0]["params"][case], stacked["params"][want_case])]
    print(f"{case}: ranks {got} stacked ({want_case}) {want}; max relative "
          f"loss gap {np.max(np.abs(np.asarray(got) / want - 1)):.3g}, max "
          f"weight gap {max(gaps):.3g}; plain stacked "
          f"{stacked['losses'][case]}")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(ranks[0]["params"][case], stacked["params"][want_case]):
        gap = np.abs(a - b)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3
    if case == "gcn-bf16":
        # the rounding point matters: the emulation is not the plain step
        assert want != stacked["losses"][case]
        assert got != stacked["losses"][case]


def test_reference_step_gradient_scale_is_measured(reference):
    """The reference's step-gradient factor (ROADMAP C3), per model: 1 or
    k = 8, measured, not assumed."""
    for model, factor in reference["factors"].items():
        print(f"{model}: factor {factor!r}")
        assert round(factor) in (1, K)
        assert factor == pytest.approx(round(factor), rel=1e-3)


@pytest.mark.parametrize("case", list(child.STEP_CASES))
def test_three_steps_track_the_reference_trainer(ranks, stacked, reference,
                                                 case):
    """Rank 0's losses against the reference's trainer from the same
    weights with ``optax.scale(1/factor)``: float32 cases within rtol
    1e-5.  The bf16 cases within rtol 3e-5 (observed: GAT 1.15e-5, GCN
    1.89e-5; the reference's bf16 GAT runs its ELL slot pass and its bf16
    matmuls round apart from the port's, so the port's stacked bf16
    trainers sit 1.15e-5 and 3.1e-5 from it too) and no farther from the
    reference than the stacked trainer is, to rtol 1e-6."""
    got, want = ranks[0]["losses"][case], reference["losses"][case]
    rel = np.max(np.abs(np.asarray(got) / np.asarray(want) - 1))
    rel_stacked = np.max(np.abs(np.asarray(stacked["losses"][case])
                                / np.asarray(want) - 1))
    print(f"{case}: ranks {got} reference {want} (max relative gap "
          f"{rel:.3g}; the stacked trainer's {rel_stacked:.3g})")
    np.testing.assert_allclose(got, want,
                               rtol=3e-5 if case in BF16_CASES else 1e-5)
    assert rel <= rel_stacked + 1e-6


def test_rank_levers_raise_only_for_a2c_modes(cora):
    """On a rank group GAT, compute_dtype and remat build, and so do the
    stale halo and replicas and, since A2c's last part, GAT on an
    asymmetric plan; the carried modes on an asymmetric plan raise the
    reference's own gates, as on one process (no collective is needed to
    reach the guards)."""
    import dataclasses

    plan = cora["plan"]
    mesh = RankGroup(0, K, "cpu")
    for kw in ({"model": "gat", "activation": "none"},
               {"compute_dtype": "bfloat16"}, {"remat": True},
               {"model": "gat", "compute_dtype": "bfloat16", "remat": True},
               {"halo_staleness": 1}, {"replica_budget": 50}):
        tr = FullBatchTrainer(plan, fin=8, widths=[4], device="cpu",
                              mesh=mesh, **kw)
        assert tr.plan.chip_ids is not None
        assert tr.model.fwd_static["mesh"] is mesh
    asym = dataclasses.replace(plan, symmetric=False)
    for kw, gate in (({"halo_staleness": 1}, "halo_staleness=1"),
                     ({"replica_budget": 50}, "replica_budget")):
        with pytest.raises(ValueError, match=f"^{gate} uses the "
                           "symmetric-Â custom backward"):
            FullBatchTrainer(asym, fin=8, widths=[4], device="cpu",
                             mesh=mesh, **kw)
    tr = FullBatchTrainer(asym, fin=8, widths=[4], device="cpu", mesh=mesh,
                          model="gat", activation="none")
    assert not tr.plan.symmetric and tr.model.fwd_static["mesh"] is mesh


def test_all_reduce_max_on_one_rank(tmp_path):
    """``RankGroup.all_reduce_max`` on a one-rank gloo group is the
    tensor itself, detached; the group closes."""
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        x = torch.tensor(3.5, requires_grad=True)
        y = mesh.all_reduce_max(x)
        assert float(y) == 3.5 and not y.requires_grad
    finally:
        mesh.close()
