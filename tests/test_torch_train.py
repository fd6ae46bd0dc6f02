"""The port's exact full-batch trainer against the reference's.

Same inputs (cora2708 under its 8-part hp partition, the same initial
weights carried by ``params_from_jax``) go through the reference — its
kernel path forced with ``SGCN_PALLAS_SPMM=1``, so ``spmm_pallas`` runs
its exact jnp emulation on the 8 virtual CPU devices of
``tests/conftest.py`` — and through the port on the CPU, where the tile
kernel is its plain version.  Tolerances are stated per test.

The reference's trainer, on the JAX of this tree, steps Adam on k times
the loss gradient: its explicit ``lax.psum`` of per-chip weight
gradients adds to the psum that ``jax.shard_map`` already forms for the
gradient of a replicated input (ROADMAP C3).  Adam's update is
invariant to that scale except where ``|g|`` is near ``eps``, so the
tests measure the factor, take the reference's gradient as JAX computes
it for the loss (``jax.grad`` of the whole mapped loss) and hand the
reference trainer ``optax.scale(1/factor)`` before ``optax.adam`` — a
power of two, so the division is exact — making both trainers step on
the loss gradient.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from sgcn_tpu.baselines.oracle import DenseOracle as RefOracle
from sgcn_tpu.io.datasets import planetoid_split as ref_planetoid_split
from sgcn_tpu.models import gcn as ref_gcn
from sgcn_tpu.ops.pallas_spmm import PALLAS_PLAN_FIELDS, pspmm_pallas_sym
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.accuracy import \
    train_test_split_masks as ref_split_masks
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils.stats import CommStats as RefCommStats
from sgcn_tpu_torch.baselines import DenseOracle
from sgcn_tpu_torch.io.datasets import load_npz_dataset, planetoid_split
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.models.gcn import exchange_widths
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS, PspmmTilesSym,
                                          _pspmm_tiles_once, pspmm_tiles_sym)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.train import LOSSES, FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.accuracy import (run_accuracy_parity,
                                           train_test_split_masks)
from sgcn_tpu_torch.utils.stats import CommStats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
HP4 = os.path.join(FIX, "cora2708.4.hp")
WIDTHS = [16, 7]
STEPS = 5
LR = 0.01


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8),
            "mesh": make_mesh_1d(8)}


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def _unblock(tree):
    return jax.tree.map(lambda x: x[0], tree)


@pytest.fixture(scope="module", params=["xent", "bce"])
def parity(request, cora):
    """Both trainers, 5 steps each from the reference's initial weights,
    on cora2708 8-hp, GCN 1433 → 16 → 7."""
    loss = request.param
    feats, labels = cora["feats"], cora["labels"]
    fin = feats.shape[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        ref0 = RefTrainer(cora["ref_plan"], fin=fin, widths=WIDTHS, seed=3,
                          loss=loss)
        assert ref0.plan_fields == PALLAS_PLAN_FIELDS   # kernel path taken
        p0 = [np.asarray(w) for w in ref0.params]
        rdata = ref_make_train_data(cora["ref_plan"], feats, labels)
        rd = shard_stacked(ref0.mesh, vars(rdata))
        args = (ref0.pa, rd["h0"], rd["labels"], rd["train_valid"])
        specs = (P(), P("v"), P("v"), P("v"), P("v"))

        def chip_loss(params, pa, h0, lab, valid):
            pa, h0, lab, valid = _unblock((pa, h0, lab, valid))
            return ref0._loss_fn(ref0._forward(params, pa, h0), lab, valid)

        # the loss gradient: jax.grad of the whole mapped (replicated) loss
        loss_map = jax.shard_map(chip_loss, mesh=ref0.mesh, in_specs=specs,
                                 out_specs=P())
        ref_loss0, ref_grads = jax.jit(jax.value_and_grad(
            lambda ps: loss_map(ps, *args)))(ref0.params)

        # the trainer's own convention: per-chip grad, then lax.psum
        def chip_grads(params, pa, h0, lab, valid):
            g = jax.grad(chip_loss)(params, pa, h0, lab, valid)
            return jax.tree.map(lambda x: lax.psum(x, "v"), g)

        step_grads = _smap(ref0.mesh, chip_grads, specs, P())(
            ref0.params, *args)
        factor = float(np.linalg.norm(np.asarray(step_grads[0]))
                       / np.linalg.norm(np.asarray(ref_grads[0])))
        ref = RefTrainer(cora["ref_plan"], fin=fin, widths=WIDTHS, seed=3,
                         loss=loss, optimizer=optax.chain(
                             optax.scale(1.0 / round(factor)),
                             optax.adam(LR)))
        ref_losses = [ref.step(rdata) for _ in range(STEPS)]
        ref_eval = ref.evaluate(rdata)
        ref_pred = ref.predict(rdata)

    tr = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS, loss=loss,
                          lr=LR, params=port_gcn.params_from_jax(p0),
                          device="cpu")
    data = make_train_data(cora["plan"], feats, labels)
    grads = []
    tr.opt.register_step_pre_hook(
        lambda opt, a, kw: grads.append([w.grad.clone() for w in tr.params]))
    losses = [tr.step(data) for _ in range(STEPS)]
    evaluated, pred = tr.evaluate(data), tr.predict(data)
    return {
        "loss": loss, "factor": factor,
        "ref_loss0": float(ref_loss0),
        "ref_grads": [np.asarray(g) for g in ref_grads],
        "ref_losses": np.asarray(ref_losses),
        "ref_params": [np.asarray(w) for w in ref.params],
        "ref_report": ref.stats.report(), "ref_err": float(ref.last_err),
        "ref_eval": ref_eval, "ref_pred": ref_pred,
        "grads": [g.numpy() for g in grads[0]],
        "losses": np.asarray(losses),
        "params": [w.detach().numpy() for w in tr.params],
        "report": tr.stats.report(), "err": float(tr.last_err),
        "eval": evaluated, "pred": pred,
    }


# ----------------------------------------------------- trainer vs reference
def test_reference_step_gradient_scale_is_measured(parity):
    """The factor the module docstring describes is 1 (a JAX that does not
    psum the gradient of a replicated input) or k = 8 (this tree's JAX);
    anything else would mean the two gradients are not the same
    function."""
    assert round(parity["factor"]) in (1, 8)
    assert parity["factor"] == pytest.approx(round(parity["factor"]),
                                             rel=1e-5)


def test_first_step_gradients_match_reference(parity):
    """Step-1 weight gradients: rtol 1e-4 / atol 1e-8 per entry (the
    largest entries are ~5e-3; observed max abs gap 4e-9) and relative
    Frobenius error ≤ 1e-6 (observed ~1e-7): the port sums the k·b rows
    of each ``h @ w`` in one GEMM, the reference per chip then across
    chips."""
    assert parity["losses"][0] == pytest.approx(parity["ref_loss0"],
                                                rel=1e-6)
    for got, want in zip(parity["grads"], parity["ref_grads"]):
        print(f"{parity['loss']} dW {want.shape}: max |port - reference| "
              f"{np.abs(got - want).max():.3g}, relative Frobenius "
              f"{np.linalg.norm(got - want) / np.linalg.norm(want):.3g}")
        assert got.shape == want.shape and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)


def test_losses_track_reference(parity):
    """Five losses within rtol 1e-5 (observed ≤ 3.3e-6); under bce the
    summed ``err`` too."""
    rel = np.abs(parity["losses"] / parity["ref_losses"] - 1)
    print(f"{parity['loss']} losses: max relative gap {rel.max():.3g}")
    np.testing.assert_allclose(parity["losses"], parity["ref_losses"],
                               rtol=1e-5)
    assert parity["losses"][-1] < parity["losses"][0]
    if parity["loss"] == "bce":
        assert parity["err"] == pytest.approx(parity["ref_err"], rel=1e-5)


def test_final_weights_track_reference(parity):
    """After five Adam steps: 99 % of the entries within 1e-5, every entry
    within 5e-3 (half of one step at lr 0.01).  Adam divides by
    sqrt(v), so an entry whose gradient is near zero moves by a
    step-sized amount on a rounding difference of its gradient (observed
    max gap 4.4e-4, on 0.2 % of layer 0's entries, under xent)."""
    for got, want in zip(parity["params"], parity["ref_params"]):
        gap = np.abs(got - want)
        print(f"{parity['loss']} W {want.shape}: {np.mean(gap <= 1e-5):.4f} "
              f"within 1e-5, max gap {gap.max():.3g}")
        assert np.mean(gap <= 1e-5) >= 0.99, gap.max()
        assert gap.max() <= 0.5 * LR


def test_comm_stats_equal_reference(parity):
    """Every key the port's report has equals the reference's: both book
    2 · nlayers exchanges per step and nlayers per forward."""
    rep, ref = parity["report"], parity["ref_report"]
    assert set(rep) <= set(ref)
    assert {k: rep[k] for k in rep} == {k: ref[k] for k in rep}
    assert rep["exchanges"] == STEPS * 2 * 2 + 2 * 2   # + eval + predict


def test_evaluate_and_predict_track_reference(parity):
    """Eval loss rtol 1e-5, accuracy equal; logits 99 % within rtol 1e-4 /
    atol 1e-4, all within atol 2e-3 (observed 3.1e-4 under xent: the
    Adam gaps of the near-zero-gradient weights above)."""
    (loss, acc), (rloss, racc) = parity["eval"], parity["ref_eval"]
    assert loss == pytest.approx(rloss, rel=1e-5) and acc == racc
    assert parity["pred"].shape == parity["ref_pred"].shape == (2708, 7)
    gap = np.abs(parity["pred"] - parity["ref_pred"])
    print(f"{parity['loss']} logits: max gap {gap.max():.3g}")
    assert np.mean(gap <= 1e-4 + 1e-4 * np.abs(parity["ref_pred"])) >= 0.99
    assert gap.max() <= 2e-3


# ------------------------------------------------------ the kernel's VJP
def test_one_layer_vjp_matches_pallas_sym(cora):
    """``PspmmTilesSym`` backward vs ``jax.vjp`` of ``pspmm_pallas_sym``
    (emulated kernel) on the same (h, g): rtol 1e-6 / atol 1e-7, the
    bound of the forward (ROADMAP C2).  The port's backward is its own
    forward applied to g, bit for bit."""
    plan = cora["plan"]
    plan.ensure_pallas_tiles(256)
    lcls = tuple((t, e, "vmem") for t, e in plan.pallas_lclasses)
    hcls = tuple((t, e, "vmem") for t, e in plan.pallas_hclasses)
    rng = np.random.default_rng(5)
    h, g = (rng.standard_normal((plan.k, plan.b, 16)).astype(np.float32)
            for _ in range(2))
    pa = [getattr(plan, f) for f in PALLAS_PLAN_FIELDS]

    def per_chip(h, g, *pa):
        _, vjp = jax.vjp(lambda x: pspmm_pallas_sym(
            x, *(p[0] for p in pa), 256, lcls, hcls, True, "v"), h[0])
        return vjp(g[0])[0][None]

    want = np.asarray(_smap(cora["mesh"], per_chip, (P("v"),) * 10,
                            P("v"))(h, g, *pa))
    plan.ensure_exchange()
    pa_t = [torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
            for f in TILE_PLAN_FIELDS]
    ht = torch.from_numpy(h).requires_grad_()
    out = pspmm_tiles_sym(ht, *pa_t, 256, lcls, hcls)
    out.backward(torch.from_numpy(g))
    got = ht.grad.numpy()
    print(f"one-layer VJP: max |port - reference| = "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(ht.grad, _pspmm_tiles_once(
        torch.from_numpy(g), *pa_t, 256, lcls, hcls))


def test_backward_runs_only_where_the_input_needs_a_gradient(
        cora, monkeypatch):
    """Autograd, like JAX, calls the aggregation backward only for an
    input that needs a gradient: cora's project-first layer 0 (1433 →
    16, aggregates ``h0 @ w0``) and layer 1 run it; an aggregate-first
    layer 0 (``agg(h0) @ w0``) does not."""
    calls = []
    orig = PspmmTilesSym.backward

    def counting(ctx, g):
        calls.append(tuple(g.shape))
        return orig(ctx, g)

    monkeypatch.setattr(PspmmTilesSym, "backward", staticmethod(counting))
    plan, feats, labels = cora["plan"], cora["feats"], cora["labels"]
    data = make_train_data(plan, feats, labels)
    FullBatchTrainer(plan, fin=feats.shape[1], widths=WIDTHS,
                     device="cpu").step(data)
    assert calls == [(8, plan.b, 16), (8, plan.b, 16)]
    calls.clear()
    narrow = make_train_data(plan, feats[:, :32], labels)
    FullBatchTrainer(plan, fin=32, widths=WIDTHS, device="cpu").step(narrow)
    assert exchange_widths(32, WIDTHS) == [32, 16]
    assert calls == [(8, plan.b, 16)]


# ------------------------------------------------------------- pieces
def _stacked_loss_inputs(seed=0, k=8, b=37, c=7):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((k, b, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, (k, b)).astype(np.int32)
    valid = (rng.random((k, b)) < 0.7).astype(np.float32)
    return logits, labels, valid


@pytest.mark.parametrize("name", ["masked_softmax_xent_local",
                                  "masked_sigmoid_bce_local",
                                  "masked_err_local",
                                  "masked_accuracy_local"])
def test_losses_match_reference(cora, name):
    """Stacked (k, b, c) losses vs the reference's per-chip losses with
    their psum, rtol 1e-6; the all-padding batch divides by 1, not 0."""
    logits, labels, valid = _stacked_loss_inputs()
    fn = getattr(ref_gcn, name)
    want = _smap(cora["mesh"], lambda *a: fn(*_unblock(a)),
                 (P("v"),) * 3, P())(logits, labels, valid)
    got = getattr(port_gcn, name)(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(valid))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    zero = getattr(port_gcn, name)(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   torch.zeros_like(torch.from_numpy(valid)))
    assert float(zero) == 0.0


def test_loss_registry_matches_reference():
    from sgcn_tpu.train.fullbatch import LOSSES as REF_LOSSES

    assert {k: v.__name__ for k, v in LOSSES.items()} == {
        k: v.__name__ for k, v in REF_LOSSES.items()}


def test_adam_matches_optax():
    """One step of ``torch.optim.Adam`` (optax's defaults) from zero
    weights, so the weights ARE the update: within 4 ulp of an exact
    float64 Adam, and within rtol 2e-5 of ``optax.adam``.  optax rounds
    its bias corrections 1 − βᵗ in float32 (0.999 is no float32 number),
    which moves its update by up to ~6.4e-6 relative: an exact Adam with
    that rounding mirrored is within 4 ulp of optax.  Gradients span
    1e-10 … 1, so the eps-dominated regime is covered.  Two more steps
    from there agree within atol 1e-6."""
    rng = np.random.default_rng(0)
    gs = [(rng.standard_normal((64, 16))
           * 10.0 ** rng.integers(-10, 1, (64, 16))).astype(np.float32)
          for _ in range(3)]
    jw = jnp.zeros((64, 16), jnp.float32)
    opt = optax.adam(LR)
    state = opt.init(jw)
    tw = torch.nn.Parameter(torch.zeros(64, 16))
    topt = torch.optim.Adam([tw], lr=LR, betas=(0.9, 0.999), eps=1e-8)

    def ulps(x, exact):
        return float((np.abs(x - exact) / np.spacing(np.abs(x))).max())

    for i, g in enumerate(gs):
        upd, state = opt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        tw.grad = torch.from_numpy(g)
        topt.step()
        got, want = tw.detach().numpy(), np.asarray(jw)
        if i == 0:
            g64 = g.astype(np.float64)
            exact = -LR * g64 / (np.abs(g64) + 1e-8)
            # optax's bias corrections, rounded in float32
            bc1, bc2 = (float(1 - np.float32(b)) for b in (0.9, 0.999))
            mirrored = (-LR * (0.1 * g64 / bc1)
                        / (np.sqrt(0.001 * g64 ** 2 / bc2) + 1e-8))
            print(f"Adam step 1: torch {ulps(got, exact):.3g} ulp from exact, "
                  f"optax {ulps(want, exact):.3g} ulp from exact and "
                  f"{ulps(want, mirrored):.3g} from exact with float32 "
                  f"bias correction; max |torch/optax - 1| "
                  f"{np.abs(got / want - 1).max():.3g}")
            assert ulps(got, exact) <= 4
            assert ulps(want, mirrored) <= 4
            np.testing.assert_allclose(got, want, rtol=2e-5)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)


def test_dense_oracle_matches_reference(ahat):
    """The port's oracle vs the reference's from the same weights on the
    48-vertex ER graph: three losses rtol 1e-5, predictions rtol 1e-4 /
    atol 1e-5."""
    rng = np.random.default_rng(4)
    n = ahat.shape[0]
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    ref = RefOracle(ahat, 6, [8, 3], seed=2)
    p0 = [np.asarray(w) for w in ref.params]
    port = DenseOracle(ahat, 6, [8, 3], params=p0, device="cpu")
    want = [ref.step(feats, labels, mask) for _ in range(3)]
    got = [port.step(feats, labels, mask) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(port.predict(feats), ref.predict(feats),
                               rtol=1e-4, atol=1e-5)
    # its own init is the trainer's: the port's generator, same seed
    again = DenseOracle(ahat, 6, [8, 3], seed=2, device="cpu")
    init = port_gcn.init_gcn_params(torch.Generator().manual_seed(2),
                                    [(6, 8), (8, 3)])
    for w, w0 in zip(again.params, init):
        assert torch.equal(w.detach(), w0)


def test_accuracy_parity_cora_4hp():
    """The port's accuracy experiment on cora2708 4-hp (planetoid split):
    the partitioned trainer within 0.03 of the oracle and the oracle
    above 0.75 — the reference test's band.  20 epochs: the fewest that
    reach the band with margin on the CPU (15 give oracle 0.754, 20 give
    0.791 and an equal full-batch accuracy)."""
    a, feats, labels = load_npz_dataset(NPZ)
    train, test = planetoid_split(labels, per_class=20, seed=0)
    rep = run_accuracy_parity(normalize_adjacency(a), feats, labels,
                              read_partvec(HP4), 4, WIDTHS, train, test,
                              epochs=20, device="cpu")
    print(rep)
    assert rep["oracle_test_acc"] > 0.75
    assert abs(rep["oracle_test_acc"] - rep["fullbatch_test_acc"]) < 0.03
    with pytest.raises(NotImplementedError, match="A8"):
        run_accuracy_parity(a, feats, labels, read_partvec(HP4), 4, WIDTHS,
                            train, test, batch_size=256, device="cpu")


def test_splits_equal_reference():
    labels = load_npz_dataset(NPZ)[2]
    for got, want in zip(planetoid_split(labels, 20, seed=3),
                         ref_planetoid_split(labels, 20, seed=3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(train_test_split_masks(500, 0.6, seed=1),
                         ref_split_masks(500, 0.6, seed=1)):
        np.testing.assert_array_equal(got, want)


def test_plan_stats_and_gather_equal_reference(cora):
    plan, ref = cora["plan"], cora["ref_plan"]
    np.testing.assert_array_equal(plan.predicted_message_count,
                                  ref.predicted_message_count)
    x = np.random.default_rng(1).standard_normal((plan.n, 3))
    blocks = plan.scatter_rows(x)
    np.testing.assert_array_equal(plan.gather_rows(blocks), x)
    np.testing.assert_array_equal(plan.gather_rows(blocks),
                                  ref.gather_rows(blocks))
    widths = exchange_widths(1433, WIDTHS)
    st = CommStats.from_plan(plan, lane_widths=widths)
    rst = RefCommStats.from_plan(ref, lane_widths=widths)
    for s in (st, rst):
        s.count_step(nlayers=2)
        s.count_forward(nlayers=2)
    rep, rrep = st.report(), rst.report()
    assert {k: rep[k] for k in rep} == {k: rrep[k] for k in rep}


# ------------------------------------------------------------------ CLI
def test_cli_trains_in_process(capsys):
    train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "-l", "2", "--hidden", "16", "--epochs", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-1])
    assert out[0].startswith("epoch 0: loss")
    assert rep["device"] == "cpu" and rep["model"] == "gcn"
    assert rep["loss"] == "xent" and rep["activation"] == "relu"
    assert rep["epochs"] == 2 and rep["epoch_s"] > 0
    assert rep["exchanges"] == 3 * 2 * 2          # warmup + 2 steps
    assert rep["comm_schedule"] == "a2a" and "loss_history" not in rep
    assert {"warmup", "train_step"} <= set(rep["phases"])


def test_cli_bce_reports_err_and_synthetic_inputs(capsys):
    train_main(["-a", os.path.join(FIX, "cora2708.A.mtx"), "--normalize",
                "-p", HP8, "-s", "8", "-l", "2", "-f", "4", "--epochs", "1",
                "--loss", "bce", "--lr", "0.001", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["loss"] == "bce" and np.isfinite(rep["err"])


def test_cli_accuracy_experiment_in_process(capsys):
    train_main(["--npz", NPZ, "--normalize", "-p", HP4, "-s", "4",
                "-l", "2", "--hidden", "16", "--experiment", "accuracy",
                "--epochs", "2", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["experiment"] == "accuracy" and rep["device"] == "cpu"
    assert 0.0 <= rep["oracle_test_acc"] <= 1.0
    assert 0.0 <= rep["fullbatch_test_acc"] <= 1.0
    with pytest.raises(SystemExit, match="xent"):
        train_main(["--npz", NPZ, "-p", HP4, "-s", "4", "--loss", "bce",
                    "--experiment", "accuracy", "--device", "cpu"])


CHECKPOINT_FLAGS = ("--resume", "--save-checkpoint", "--checkpoint-dir",
                    "--checkpoint-every", "--keep-checkpoints")


@pytest.mark.parametrize("flag", [
    "-b", "--backend", "-n", "--batch-size",
    "--halo-staleness", "--halo-delta", "--sync-every",
    "--replica-budget", "--refresh-band", "--resume",
    "--save-checkpoint", "--checkpoint-dir", "--checkpoint-every",
    "--keep-checkpoints", "--profile", "--metrics-out", "--memory-budget"])
def test_cli_leaves_unported_flags_undefined(flag, capsys):
    """Flags of features not ported are undefined (argparse exit 2).  The
    checkpoint flags are ported (``tests/test_torch_checkpoint.py``): they
    parse, and the run stops at the input guard instead."""
    with pytest.raises(SystemExit) as exc:
        train_main(["-p", HP8, "-s", "8", "--device", "cpu", flag, "1"])
    if flag in CHECKPOINT_FLAGS:
        assert exc.value.code != 2
        assert "unrecognized arguments" not in capsys.readouterr().err
        return
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_without_cpu_the_entry_points_raise_when_no_gpu(cora):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseOracle(cora["a"], 1433, WIDTHS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8"])


@pytest.mark.parametrize("lever,value,item", [
    ("remat", True, "A3"), ("halo_staleness", 1, "A7"),
    ("halo_delta", True, "A7"), ("sync_every", 2, "A7"),
    ("replica_budget", 4, "A7"), ("refresh_band", 0.1, "A7"),
    ("memory_budget", 1 << 30, "A10")])
def test_unported_levers_raise(cora, lever, value, item):
    with pytest.raises(NotImplementedError, match=f"not ported.*{item}"):
        FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS,
                         device="cpu", **{lever: value})


@pytest.mark.parametrize("lever", ["compute_dtype", "halo_dtype"])
def test_precision_levers_train_and_book_a_bf16_wire(cora, lever):
    """The two precision levers are ported: the trainer takes each, trains
    on the CPU (one step, finite loss, float32 master weights) and books
    the GCN wire at 2 bytes a lane, half the float32 run's bytes; an
    unknown narrow dtype raises."""
    data = make_train_data(cora["plan"], cora["feats"], cora["labels"])
    runs = {}
    for value in ("bfloat16", None):
        tr = FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS, seed=1,
                              device="cpu", **{lever: value})
        runs[value] = (tr.step(data), tr.stats.report())
        assert all(w.dtype == torch.float32 for w in tr.params)
    assert np.isfinite(runs["bfloat16"][0])
    assert runs["bfloat16"][0] != runs[None][0]
    assert runs["bfloat16"][1]["halo_bytes_wire_per_step"] * 2 == \
        runs[None][1]["halo_bytes_wire_per_step"]
    with pytest.raises(ValueError, match="bfloat16"):
        FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS,
                         device="cpu", **{lever: "float16"})


@pytest.mark.parametrize("flag", ["--dtype", "--halo-dtype"])
def test_cli_precision_flags_take_bfloat16_only(flag, capsys):
    """``--dtype`` and ``--halo-dtype`` are defined and take ``bfloat16``
    alone, as the reference's."""
    with pytest.raises(SystemExit) as exc:
        train_main(["-p", HP8, "-s", "8", "--device", "cpu", flag, "1"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


# -------------------------------------------------------- serving intact
def test_serving_stays_gradient_free_with_the_function_in_place(cora):
    """The serve engine runs the same forward under inference mode: its
    logits carry no autograd graph, no backward ever runs, and they equal
    the op without the Function (``_pspmm_tiles_once`` per layer)."""
    feats = cora["feats"]
    eng = ServeEngine(cora["plan"], fin=feats.shape[1], widths=WIDTHS,
                      seed=1, max_batch=8, device="cpu")
    eng.set_features(feats)
    assert all(w.requires_grad for w in eng.model.weights)
    before = PspmmTilesSym.backward_launches
    out = eng.forward()
    assert not out.requires_grad
    st = eng.setup.fwd_static

    def agg(x):
        return _pspmm_tiles_once(
            x, *(eng.pa[f] for f in TILE_PLAN_FIELDS), st["pallas_tb"],
            st["pallas_lclasses"], st["pallas_hclasses"])

    w0, w1 = eng.model.weights
    with torch.no_grad():
        h = agg(torch.relu(agg(eng._h0 @ w0))) @ w1     # 1433 projects first
    assert torch.equal(out, h)
    q = np.array([0, 5, 2707])
    plan = cora["plan"]
    np.testing.assert_array_equal(
        eng.query(q), h[plan.owner[q], plan.local_idx[q]].numpy())
    assert PspmmTilesSym.backward_launches == before
