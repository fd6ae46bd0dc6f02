"""The port's mini-batch trainer against the reference's
(``sgcn_tpu_torch.train.minibatch`` vs ``sgcn_tpu.train.minibatch``).

cora2708 under its 8-part hp partition, batches of 512, three of them
(``nbatches=3``), GCN and GAT 1433 → 16 → 7.  The batch samples, every
padded batch plan's arrays, the shared ELL buckets, the forced combined
layout and the forced ring sizes must be EQUAL to the reference's (the
same numpy construction).  Losses are compared with the tolerance each
test states: the reference's mini-batch trainer runs its slot-pass
aggregators (``allow_pallas=False``), the port its tile kernel (on the
CPU its plain version), so the sums run in other orders.  The reference
steps Adam on k × the loss gradient on this tree's JAX (ROADMAP C3), so
it gets ``optax.scale(1/k)`` before Adam, as the other parity tests do.
The CLIs run in-process through ``main()``.
"""

import json
import os
import sys

import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel.plan import pad_comm_plan as ref_pad_comm_plan
from sgcn_tpu.parallel.plan import shared_ell_buckets as ref_shared_buckets
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.__main__ import main as ref_train_main
from sgcn_tpu.train.accuracy import run_accuracy_parity as ref_accuracy
from sgcn_tpu.train.minibatch import MiniBatchTrainer as RefMiniBatch
from sgcn_tpu.train.minibatch import sample_adjacency as ref_sample_adjacency
from sgcn_tpu.train.minibatch import sample_batches as ref_sample_batches
from sgcn_tpu.utils import checkpoint as ref_ckpt
from sgcn_tpu.utils.stats import CommStats as RefCommStats
from sgcn_tpu_torch.io.datasets import load_npz_dataset, planetoid_split
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.parallel.plan import pad_comm_plan, shared_ell_buckets
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.accuracy import run_accuracy_parity
from sgcn_tpu_torch.train.minibatch import (MiniBatchTrainer,
                                            sample_adjacency, sample_batches)
from sgcn_tpu_torch.utils import checkpoint as port_ckpt
from sgcn_tpu_torch.utils.stats import CommStats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
K = 8
WIDTHS = [16, 7]
BATCH, NBATCHES = 512, 3
LR = 0.01

# the plan arrays the reference's padded batch plans carry
ARRAY_FIELDS = (
    "owner", "local_idx", "part_sizes", "send_idx", "send_counts",
    "halo_src", "halo_counts", "edge_dst", "edge_src", "edge_w", "nnz",
    "row_valid", "ledge_dst", "ledge_src", "ledge_w", "hedge_dst",
    "hedge_src", "hedge_w", "lnnz", "hnnz", "ell_idx", "ell_w",
    "ltail_dst", "ltail_src", "ltail_w", "ltail_nnz")
SCALAR_FIELDS = ("n", "k", "b", "s", "r", "e", "el", "eh", "ell_k", "tl",
                 "symmetric", "row_order", "ell_buckets")
CELL_FIELDS = ("cell_idx", "cell_w", "ctail_dst", "ctail_src", "ctail_w",
               "ctail_nnz")
RING_FIELDS = ("rsend_idx", "rhalo_dst")
TILE_FIELDS = ("ptile_lsrc", "ptile_lld", "ptile_lw", "ptile_hsrc",
               "ptile_hld", "ptile_hw")
CELL_TILE_FIELDS = ("ptile_csrc", "ptile_cld", "ptile_cw")


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    return {"ahat": normalize_adjacency(a), "ref_ahat": ref_normalize(a),
            "feats": feats, "labels": labels, "pv": read_partvec(HP8)}


def _activation(model):
    return "relu" if model == "gcn" else "none"


def _ref_trainer(cora, model, sched, **kw):
    return RefMiniBatch(
        cora["ref_ahat"], cora["pv"], K, fin=cora["feats"].shape[1],
        widths=WIDTHS, batch_size=BATCH, nbatches=NBATCHES, model=model,
        activation=_activation(model), comm_schedule=sched,
        optimizer=optax.chain(optax.scale(1.0 / K), optax.adam(LR)), **kw)


def _port_params(model, ref_params):
    if model == "gcn":
        return port_gcn.params_from_jax([np.asarray(w) for w in ref_params])
    return port_gat.params_from_jax(
        [{key: np.asarray(v) for key, v in p.items()} for p in ref_params])


def _port_trainer(cora, model, sched, params=None, **kw):
    return MiniBatchTrainer(
        cora["ahat"], cora["pv"], K, fin=cora["feats"].shape[1],
        widths=WIDTHS, batch_size=BATCH, nbatches=NBATCHES, model=model,
        activation=_activation(model), comm_schedule=sched, lr=LR,
        params=params, device="cpu", **kw)


@pytest.fixture(scope="module", params=["gcn-a2a", "gcn-ragged", "gat-a2a"])
def pair(request, cora):
    """The reference's and the port's trainers on the same batches and
    initial weights, two epochs of stepwise training each."""
    model, sched = request.param.split("-")
    ref = _ref_trainer(cora, model, sched)
    tr = _port_trainer(cora, model, sched,
                       params=_port_params(model, ref.inner.params))
    rb = ref.make_batches(cora["feats"], cora["labels"])
    pb = tr.make_batches(cora["feats"], cora["labels"])
    ref_losses = [ref.step(b) for _ in range(2) for b in rb]
    losses = [tr.step(b) for _ in range(2) for b in pb]
    return {"model": model, "sched": sched, "ref": ref, "port": tr,
            "ref_batches": rb, "batches": pb, "ref_losses": ref_losses,
            "losses": losses}


# ------------------------------------------------------------ sampling
@pytest.mark.parametrize("n,bs,nb,seed", [(2708, 512, None, 0),
                                          (100, 32, None, 3),
                                          (50, 80, 4, 1)])
def test_sample_batches_equal_reference(n, bs, nb, seed):
    got = sample_batches(n, bs, nb, seed=seed)
    want = ref_sample_batches(n, bs, nb, seed=seed)
    assert len(got) == len(want) == (nb or 3 * (n // bs + 1))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_sample_adjacency_equal_reference(cora):
    for bv in sample_batches(2708, 512, 3, seed=0):
        x = sample_adjacency(cora["ahat"], bv)
        y = ref_sample_adjacency(cora["ref_ahat"], bv)
        assert x.shape == y.shape == (512, 512)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


# --------------------------------------------------------------- plans
def _assert_plans_equal(port, ref, fields=ARRAY_FIELDS,
                        scalars=SCALAR_FIELDS):
    for f in fields:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in scalars:
        assert getattr(port, f) == getattr(ref, f), f


def test_batch_plans_equal_reference(pair):
    """Every padded batch plan (and, for GAT, its forced combined layout;
    on the ring, its forced round sizes and ring arrays) equals the
    reference's; so do the tile layouts both build on them."""
    ref, tr = pair["ref"], pair["port"]
    assert len(tr.plans) == len(ref.plans) == NBATCHES
    envs = {tuple(getattr(p, f) for f in ("b", "s", "r", "e", "el", "eh",
                                           "tl", "ell_buckets"))
            for p in tr.plans}
    assert len(envs) == 1                        # one shared envelope
    for p, q in zip(tr.plans, ref.plans):
        _assert_plans_equal(p, q)
        if pair["model"] == "gat":
            _assert_plans_equal(p, q, CELL_FIELDS, ("ctl", "cell_buckets"))
            q.ensure_pallas_cell_tiles(256)
            _assert_plans_equal(p, q, CELL_TILE_FIELDS, ("pallas_cclasses",))
        else:
            q.ensure_pallas_tiles(256)
            _assert_plans_equal(p, q, TILE_FIELDS,
                                ("pallas_lclasses", "pallas_hclasses"))
        if pair["sched"] == "ragged":
            _assert_plans_equal(p, q, RING_FIELDS, ("rr_sizes",))
    if pair["sched"] == "ragged":
        assert len({p.rr_sizes for p in tr.plans}) == 1
        assert tr.plans[0].rr_sizes == tuple(np.max(
            [p.ragged_round_sizes() for p in tr.plans], axis=0))


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("row_order", ["degree", "id"])
def test_shared_ell_buckets_equal_reference(cora, combined, row_order):
    batches = sample_batches(2708, BATCH, NBATCHES, seed=0)
    port = [build_comm_plan(sample_adjacency(cora["ahat"], bv),
                            cora["pv"][bv], K, pad_rows_to=8,
                            row_order=row_order) for bv in batches]
    ref = [ref_build_comm_plan(ref_sample_adjacency(cora["ref_ahat"], bv),
                               cora["pv"][bv], K, pad_rows_to=8,
                               row_order=row_order) for bv in batches]
    b = max(p.b for p in port)
    got = shared_ell_buckets(port, b, combined=combined)
    assert got == ref_shared_buckets(ref, b, combined=combined)
    assert sum(nb for nb, _ in got) == b


def test_forced_cell_and_ring_equal_reference(cora):
    """``ensure_cell(buckets=, ctl=)`` and ``ensure_ragged(rr_sizes=)``
    above the natural envelope, on one plan, equal the reference's; a
    forced envelope below the natural one raises in both."""
    port = build_comm_plan(cora["ahat"], cora["pv"], K)
    ref = ref_build_comm_plan(cora["ref_ahat"], cora["pv"], K)
    nat = port.ensure_cell().cell_buckets
    assert nat == ref.ensure_cell().cell_buckets
    forced = ((nat[0][0], nat[0][1] + 3),) + nat[1:]
    ctl = port.ctl + 9
    port.ensure_cell(buckets=forced, ctl=ctl)
    ref.ensure_cell(buckets=forced, ctl=ctl)
    _assert_plans_equal(port, ref, CELL_FIELDS, ("ctl", "cell_buckets"))
    sizes = tuple(x + 2 for x in port.ragged_round_sizes())
    port.ensure_ragged()
    port.ensure_pallas_tiles(256).ensure_pallas_ragged_tiles()
    hr_nat = port.ptile_hrsrc
    port.ensure_ragged(rr_sizes=sizes, rr_edge_sizes=None)
    ref.ensure_ragged(rr_sizes=sizes)
    _assert_plans_equal(port, ref, RING_FIELDS, ("rr_sizes",))
    assert port.ptile_hrsrc is None              # re-based on the new ring
    port.ensure_pallas_ragged_tiles()
    assert port.ptile_hrsrc.shape == hr_nat.shape
    assert port.ring_src.shape == (K, sum(sizes))
    with pytest.raises(ValueError, match="smaller than natural"):
        port.ensure_ragged(rr_sizes=tuple(x - 3 for x in sizes))
    with pytest.raises(ValueError, match="tail envelope smaller"):
        port.ensure_cell(buckets=((port.b, 1),), ctl=1)


def test_pad_comm_plan_equals_reference_and_refuses_shrink(cora):
    port = build_comm_plan(cora["ahat"], cora["pv"], K)
    ref = ref_build_comm_plan(cora["ref_ahat"], cora["pv"], K)
    env = (port.b + 5, port.s + 3, port.r + 7, port.e + 11)
    p2 = pad_comm_plan(port, *env, el=port.el + 2, eh=port.eh + 4,
                       tl=port.tl + 1)
    r2 = ref_pad_comm_plan(ref, *env, el=ref.el + 2, eh=ref.eh + 4,
                           tl=ref.tl + 1)
    _assert_plans_equal(p2, r2)
    assert pad_comm_plan(port, port.b, port.s, port.r, port.e) is port
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_comm_plan(port, port.b - 1, port.s, port.r, port.e)


def test_pad_comm_plan_preserves_forward(cora):
    """The reference's ``test_pad_comm_plan_preserves_forward`` on the
    port: the padded plan's predictions equal the plan's within rtol 1e-5
    / atol 1e-6 (the padded tiles hold the same edges in the same order,
    the pads weigh 0)."""
    n = 48
    from conftest import er_graph
    ahat = normalize_adjacency(er_graph())
    rng = np.random.default_rng(3)
    pv = balanced_random_partition(n, 4, seed=1)
    plan = build_comm_plan(ahat, pv, 4)
    padded = pad_comm_plan(plan, plan.b + 5, plan.s + 3, plan.r + 7,
                           plan.e + 11)
    feats = rng.standard_normal((n, 9)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    for sched in ("a2a", "ragged"):
        a = FullBatchTrainer(plan, fin=9, widths=[6, 3], seed=2,
                             comm_schedule=sched, device="cpu")
        b = FullBatchTrainer(padded, fin=9, widths=[6, 3], seed=2,
                             comm_schedule=sched, device="cpu")
        pa = a.predict(make_train_data(plan, feats, labels))
        pb = b.predict(make_train_data(padded, feats, labels))
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ training
def test_minibatch_losses_match_reference(pair):
    """Per-step losses over two epochs of three batches: GCN within rtol
    1e-5 / atol 1e-6, GAT within rtol 5e-5 / atol 1e-6 (observed ≤ 1.1e-5:
    the attention softmax carries the aggregators' other summation order
    through six Adam steps); ragged and a2a alike."""
    rtol = 1e-5 if pair["model"] == "gcn" else 5e-5
    print(f"{pair['model']} {pair['sched']} losses: port {pair['losses']}, "
          f"reference {pair['ref_losses']}")
    np.testing.assert_allclose(pair["losses"], pair["ref_losses"],
                               rtol=rtol, atol=1e-6)
    assert np.isfinite(pair["losses"]).all()


def test_evaluate_fullgraph_matches_reference(pair, cora):
    """``evaluate_fullgraph`` after the same training: the loss within
    rtol 1e-5 (GCN) / 5e-5 (GAT), the accuracy within one vertex."""
    got = pair["port"].evaluate_fullgraph(cora["feats"], cora["labels"])
    want = pair["ref"].evaluate_fullgraph(cora["feats"], cora["labels"])
    rtol = 1e-5 if pair["model"] == "gcn" else 5e-5
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    assert abs(got[1] - want[1]) <= 1.0 / 2708 + 1e-7


def test_merged_report_equals_reference(pair):
    """``CommStats.merged_report`` over the batch counters: every integer
    equal to the reference's, and the padding efficiency too."""
    got = CommStats.merged_report([b.stats for b in pair["batches"]])
    want = RefCommStats.merged_report([b.stats
                                       for b in pair["ref_batches"]])
    for key, val in want.items():
        if isinstance(val, (int, np.integer)) and key in got:
            assert got[key] == val, key
    assert got["exchanges"] == NBATCHES * 2 * 2 * len(WIDTHS)
    assert got["comm_schedule"] == pair["sched"]
    np.testing.assert_allclose(got["padding_efficiency"],
                               want["padding_efficiency"], rtol=1e-12)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_ragged_equals_a2a_bit_for_bit(cora, model):
    runs = {}
    for sched in ("a2a", "ragged"):
        tr = _port_trainer(cora, model, sched, seed=4)
        rep = tr.fit(cora["feats"], cora["labels"], epochs=2, warmup=1,
                     verbose=False)
        runs[sched] = (rep, [p.detach().clone()
                             for p in tr.inner.model.parameters()])
    (ra, wa), (rr, wr) = runs["a2a"], runs["ragged"]
    assert ra["loss_history"] == rr["loss_history"]
    assert all(torch.equal(x, y) for x, y in zip(wa, wr))
    assert rr["comm_schedule"] == "ragged"
    assert rr["total_send_volume"] == ra["total_send_volume"]
    assert rr["wire_rows_total"] < ra["wire_rows_total"]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_run_epochs_fused_equals_stepwise(cora, model):
    """The epoch sweep (no readback between steps) follows the stepwise
    trajectory bit for bit: batch losses, epoch means, weights, Adam
    state; its counters book every plan's exchanges."""
    seq = _port_trainer(cora, model, "a2a", seed=3)
    fused = _port_trainer(cora, model, "a2a", seed=3)
    batches = seq.make_batches(cora["feats"], cora["labels"])
    steps = [[seq.step(b) for b in batches] for _ in range(2)]
    got = fused.run_epochs_fused(cora["feats"], cora["labels"], epochs=2)
    assert fused.fused_batch_losses.tolist() == steps
    assert got.tolist() == [sum(r) / len(r) for r in steps]
    for a, b in zip(seq.inner.model.parameters(),
                    fused.inner.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(seq.inner.opt.state.values(),
                    fused.inner.opt.state.values()):
        assert all(torch.equal(a[key], b[key]) for key in a)
    rep = fused.fused_stats_report()
    want = sum(int(p.predicted_send_volume.sum())
               for p in fused.plans) * 2 * 2 * len(WIDTHS)
    assert rep["total_send_volume"] == want
    # sync=False: the device losses, and the sweep continues the run
    more = fused.run_epochs_fused(cora["feats"], cora["labels"], epochs=1,
                                  sync=False)
    assert tuple(more.shape) == (1, NBATCHES)


def test_minibatch_empty_train_batches_no_nan():
    """A batch with no train vertex gives a finite loss and keeps the
    weights finite (the reference's test, on the port)."""
    from conftest import er_graph
    ahat = normalize_adjacency(er_graph())
    n = ahat.shape[0]
    rng = np.random.default_rng(9)
    pv = balanced_random_partition(n, 4, seed=4)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    train_mask = np.zeros(n, dtype=np.float32)
    train_mask[rng.choice(n, 4, replace=False)] = 1.0
    tr = MiniBatchTrainer(ahat, pv, 4, fin=6, widths=[4, 3], batch_size=12,
                          nbatches=6, seed=2, device="cpu")
    report = tr.fit(feats, labels, train_mask, epochs=3, verbose=False)
    assert np.isfinite(report["loss_history"]).all()
    assert all(torch.isfinite(p).all() for p in tr.inner.model.parameters())
    # batches of 3 vertices over 4 parts: every batch misses a part,
    # which keeps its rank and its (empty) block
    tr = MiniBatchTrainer(ahat, pv, 4, fin=6, widths=[4, 3], batch_size=3,
                          nbatches=4, seed=2, device="cpu")
    assert all((p.part_sizes == 0).any() for p in tr.plans)
    report = tr.fit(feats, labels, train_mask, epochs=2, verbose=False)
    assert np.isfinite(report["loss_history"]).all()


def test_minibatch_bf16_matches_reference(cora):
    """``compute_dtype='bfloat16'`` GCN: ring == a2a bit for bit in the
    port, and the losses within the reference's bf16 band (rtol 0.05 /
    atol 0.02) of the reference's bf16 mini-batch run."""
    ref = _ref_trainer(cora, "gcn", "a2a", compute_dtype="bfloat16")
    params = _port_params("gcn", ref.inner.params)
    want = ref.fit(cora["feats"], cora["labels"], epochs=2, warmup=0,
                   verbose=False)["loss_history"]
    got = {}
    for sched in ("a2a", "ragged"):
        tr = _port_trainer(cora, "gcn", sched, params=params,
                           compute_dtype="bfloat16")
        got[sched] = tr.fit(cora["feats"], cora["labels"], epochs=2,
                            warmup=0, verbose=False)["loss_history"]
    assert got["a2a"] == got["ragged"]
    np.testing.assert_allclose(got["a2a"], want, rtol=0.05, atol=0.02)


def test_replica_budget_refused_with_the_reference_message(cora):
    with pytest.raises(ValueError) as want:
        _ref_trainer(cora, "gcn", "a2a", replica_budget=4)
    with pytest.raises(ValueError) as got:
        _port_trainer(cora, "gcn", "a2a", replica_budget=4)
    assert str(got.value) == str(want.value)


def test_checkpoint_records_no_plan_digest(cora, tmp_path):
    """The inner trainer saves no plan digest (the ``checkpoint_plan``
    sentinel), and the reference's mini-batch trainer restores the file."""
    tr = _port_trainer(cora, "gcn", "a2a")
    tr.fit(cora["feats"], cora["labels"], epochs=1, warmup=0, verbose=False)
    path = port_ckpt.save_checkpoint(tr.inner, str(tmp_path / "mb.npz"),
                                     step=1)
    assert port_ckpt.read_checkpoint_meta(path)["plan_digest"] is None
    full = FullBatchTrainer(build_comm_plan(cora["ahat"], cora["pv"], K),
                            fin=cora["feats"].shape[1], widths=WIDTHS,
                            device="cpu")
    assert "__plan_digest__" in np.load(port_ckpt.save_checkpoint(
        full, str(tmp_path / "fb.npz")))
    ref = _ref_trainer(cora, "gcn", "a2a")
    assert ref_ckpt.load_checkpoint(ref.inner, path) == 1
    for w, x in zip(ref.inner.params, tr.inner.params):
        np.testing.assert_array_equal(np.asarray(w), x.detach().numpy())


# ----------------------------------------------------------------- CLIs
def _ref_exit(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu.train"] + argv)
    with pytest.raises(SystemExit) as exc:
        ref_train_main()
    return exc.value.code


@pytest.mark.parametrize("extra", [
    ["--halo-dtype", "bfloat16"],
    ["--halo-staleness", "1"],
    ["--replica-budget", "4"],
    ["--checkpoint-dir", "ck", "--resume", "ck.npz"]])
def test_cli_minibatch_guards_exit_as_reference(extra, monkeypatch):
    """``-n BATCH`` with a full-batch lever (or an explicit resume into a
    durable directory) exits before any data load with the reference
    CLI's message."""
    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-n", "512"]
    want = _ref_exit(base + extra, monkeypatch)
    with pytest.raises(SystemExit) as exc:
        train_main(base + extra + ["--device", "cpu"])
    assert isinstance(want, str) and exc.value.code == want


def _cli_losses(out):
    lines = out.strip().splitlines()
    return ([float(x.split()[-1]) for x in lines if x.startswith("epoch ")],
            json.loads(lines[-1]))


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
def test_cli_minibatch_trains_checkpoints_and_resumes(sched, tmp_path,
                                                      capsys, cora):
    """``python -m sgcn_tpu_torch.train -n 512`` on cora: the losses of the
    in-process trainer; under ``--checkpoint-dir`` a run of 2 epochs
    (checkpoints at epochs 1 and 2) and a ``--resume auto`` to 3 epochs
    train the third epoch as the uninterrupted 3-epoch run does."""
    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
            "--hidden", "16", "-n", "512", "--comm-schedule", sched,
            "--device", "cpu", "--warmup", "1"]
    train_main(base + ["--epochs", "3"])
    full, rep = _cli_losses(capsys.readouterr().out)
    assert rep["nbatches"] == 3 * (2708 // 512 + 1) == 18
    assert rep["comm_schedule"] == sched
    tr = MiniBatchTrainer(cora["ahat"], cora["pv"], K,
                          fin=cora["feats"].shape[1], widths=WIDTHS,
                          batch_size=512, comm_schedule=sched, device="cpu")
    want = tr.fit(cora["feats"], cora["labels"], epochs=3, warmup=1,
                  verbose=False)["loss_history"]
    np.testing.assert_allclose(full, want, rtol=0, atol=5e-7)  # 6 decimals
    ck = str(tmp_path / "ck")
    dur = base + ["--checkpoint-dir", ck, "--checkpoint-every", "1"]
    train_main(dur + ["--epochs", "2"])
    first, _ = _cli_losses(capsys.readouterr().out)
    assert os.path.exists(os.path.join(ck, "ckpt_00000002.npz"))
    train_main(dur + ["--epochs", "3", "--resume", "auto"])
    rest, rep = _cli_losses(capsys.readouterr().out)
    assert rep["resumed"]["step"] == 2 and rep["start_epoch"] == 2
    assert first + rest == full


def test_accuracy_parity_minibatch_near_reference(cora):
    """``run_accuracy_parity(batch_size=1024)`` on cora 8-hp, 20 epochs:
    the port's ``minibatch_test_acc`` within 0.05 of the reference's
    (observed 0.824 against 0.859).  The runs are not one trajectory: the
    port draws its initial weights from a ``torch.Generator``, the
    reference from JAX's PRNG, and the reference's Adam steps on 8 × the
    gradient (C3)."""
    labels = cora["labels"]
    train_mask, test_mask = planetoid_split(labels, per_class=20, seed=0)
    kw = dict(epochs=20, batch_size=1024, lr=LR, seed=0)
    got = run_accuracy_parity(cora["ahat"], cora["feats"], labels,
                              cora["pv"], K, WIDTHS, train_mask, test_mask,
                              device="cpu", **kw)
    want = ref_accuracy(cora["ref_ahat"], cora["feats"], labels, cora["pv"],
                        K, WIDTHS, train_mask, test_mask, **kw)
    print(f"accuracy: port {got}, reference {want}")
    assert abs(got["minibatch_test_acc"] - want["minibatch_test_acc"]) < 0.05
