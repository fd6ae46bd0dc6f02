"""The port's hot-halo replicas (``replica_budget``) against the
reference's: the plan's replica layout, the destination-indexed pack's
plain version, the replica trainer on both transports, its gates, CLI and
checkpoints.

Inputs: cora2708 under its 8-part hp partition, GCN 1433 → 16 → 7 (ReLU),
on the CPU.  The reference's replica mode runs its ELL aggregator on the
8 virtual CPU devices of ``tests/conftest.py``; the port's runs the
destination-indexed pack and the fused tile launch, whose plain versions
carry it here.  So the two agree within a stated float32 tolerance, and
the port's own bit-identities (``sync_every=1`` == exact, replica ring ==
replica a2a) rest on its kernels' serial chains.  The reference steps on
k × the loss gradient (ROADMAP C3): it gets ``optax.chain(optax.scale(1/k),
optax.adam(lr))``, as in ``tests/test_torch_stale.py``.

Carries are compared in the reference's layout: the port's receive
layouts gathered at their replica slots to ``(k, RP, f)`` tables
(``FullBatchTrainer._replica_leaves``).
"""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel.plan import \
    choose_replica_budget as ref_choose_replica_budget
from sgcn_tpu.parallel.plan import \
    resolve_comm_schedule as ref_resolve_comm_schedule
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils import checkpoint as ref_ckpt
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models.gcn import params_from_jax
from sgcn_tpu_torch.ops.row_shuffle import (row_pack_into,
                                            row_pack_into_plain)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.parallel import plan as plan_mod
from sgcn_tpu_torch.parallel.plan import (choose_replica_budget,
                                          resolve_comm_schedule)
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
FIN = 1433
WIDTHS = [16, 7]
LR = 0.01
STEPS = 6
K = 8
BUDGET = 24
CLI = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
       "--hidden", "16", "--device", "cpu"]
# the float32 tolerance of the port's parity tests
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    plan = build_comm_plan(normalize_adjacency(a), pv, K)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": plan, "ref_plan": ref_plan,
            "data": make_train_data(plan, feats, labels),
            "ref_data": ref_make_train_data(ref_plan, feats, labels)}


def _ref(cora, **kw):
    opt = optax.chain(optax.scale(1.0 / K), optax.adam(LR))
    kw.setdefault("seed", 3)
    return RefTrainer(cora["ref_plan"], fin=FIN, widths=WIDTHS, lr=LR,
                      optimizer=opt, **kw)


def _port(cora, params, **kw):
    return FullBatchTrainer(cora["plan"], fin=FIN, widths=WIDTHS, lr=LR,
                            params=params_from_jax(params), device="cpu",
                            **kw)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def init(cora):
    return _np(_ref(cora).params)


def _trained(cora, params, steps=STEPS, **kw):
    tr = _port(cora, params, **kw)
    return tr, [tr.step(cora["data"]) for _ in range(steps)]


# ------------------------------------------------------------------ plan
REPLICA_ARRAYS = (
    "nrep_s", "nrep_send_idx", "nrep_send_counts", "nrep_halo_src",
    "rep_slots", "rep_counts", "rp", "rep_rows", "rep_row_counts", "rs",
    "ronly_s", "ronly_send_idx", "ronly_send_counts", "ronly_base_pos",
    "rep_recv_src", "nrep_rr_sizes", "nrep_rsend_idx", "nrep_rhalo_dst",
    "rep_ring_pos", "nrep_ring_dst", "replica_rows", "replica_send_saving",
    "replica_budget")


@pytest.mark.parametrize("budget", [0, 5, BUDGET, 200, 10 ** 7])
def test_plan_replica_arrays_equal_the_references(cora, budget):
    """Every array of ``ensure_replicas`` equals the reference's, a2a
    alone and with the ring built first, at budgets up to the clamp
    (everything replicated); the shrunken wire figures, the carry shapes,
    the side channel's wire rows and the shrunken send volume too."""
    a, _, _ = load_npz_dataset(NPZ)
    plan = build_comm_plan(normalize_adjacency(a), cora["pv"], K)
    ref = ref_build_comm_plan(ref_normalize(a), cora["pv"], K)
    for ring in (False, True):
        if ring:
            plan.ensure_ragged()
            ref.ensure_ragged()
        plan.ensure_replicas(budget)
        ref.ensure_replicas(budget)
        for name in REPLICA_ARRAYS:
            got, want = getattr(plan, name), getattr(ref, name)
            assert (got is None) == (want is None), name
            if want is not None:
                assert np.array_equal(np.asarray(got), np.asarray(want)), \
                    (ring, name)
        for sched in ("a2a", "ragged"):
            if sched == "ragged" and not ring:
                continue
            assert plan.wire_rows_per_exchange(sched, replica=True) == \
                ref.wire_rows_per_exchange(sched, replica=True)
    assert plan.replica_carry_shapes(FIN, WIDTHS, partial=True) == \
        ref.replica_carry_shapes(FIN, WIDTHS, partial=True)
    assert plan.partial_refresh_wire_rows == ref.partial_refresh_wire_rows
    assert np.array_equal(plan.replica_send_volume, ref.replica_send_volume)
    lam, cons = plan.replica_scores()
    ref_lam, ref_cons = ref.replica_scores()
    assert np.array_equal(lam, ref_lam) and np.array_equal(cons, ref_cons)
    if budget == 10 ** 7:
        assert plan.replica_rows < budget
        assert int(plan.nrep_send_counts.sum()) == 0
        assert len(plan.keep_recv_src) == len(plan.keep_ring_src) == 0


def test_replica_tuples_equal_the_references():
    """The reference's contract tuples of the replica modes, kept under
    its names."""
    from sgcn_tpu.parallel import plan as ref_plan_mod
    for name in ("REPLICA_PLAN_FIELDS", "REPLICA_PLAN_FIELDS_RAGGED",
                 "REPLICA_STALE_PLAN_FIELDS",
                 "REPLICA_STALE_PLAN_FIELDS_RAGGED",
                 "REPLICA_PARTIAL_PLAN_FIELDS"):
        assert getattr(plan_mod, name) == getattr(ref_plan_mod, name), name


@pytest.mark.parametrize("staleness", [0, 1])
@pytest.mark.parametrize("schedule", ["auto", "a2a"])
def test_budget_knee_and_schedule_decision_equal_the_references(
        cora, schedule, staleness):
    """``choose_replica_budget`` (the λ·degree knee) and its log, and the
    replica-aware ``resolve_comm_schedule`` decision log, equal the
    reference's key for key."""
    log, ref_log = {}, {}
    b = choose_replica_budget(cora["plan"], decision=log)
    assert b == ref_choose_replica_budget(cora["ref_plan"], decision=ref_log)
    assert log == ref_log
    assert 0 < b <= log["boundary_rows"] and 0 < log["score_covered"] <= 1
    log, ref_log = {}, {}
    got = resolve_comm_schedule(schedule, [cora["plan"]], "gcn",
                                decision=log, halo_staleness=staleness,
                                replica_budget=b)
    want = ref_resolve_comm_schedule(schedule, [cora["ref_plan"]], "gcn",
                                     halo_staleness=staleness,
                                     replica_budget=b, decision=ref_log)
    assert got == want and log == ref_log
    if schedule == "auto":
        assert log["wire_rows_a2a_replica"] <= log["wire_rows_a2a"]
        assert log["true_rows_replica"] < log["true_rows"]


def test_port_only_lists_match_their_definitions(cora):
    """The kept receive slots, dense: every real a2a receive slot ``(q,
    p, t)`` whose row ``send_idx[p, q, t]`` is not replicated at ``p``,
    with source ``p·B + send_idx[p, q, t]`` and destination ``q·k·S +
    p·S + t``; on the ring the same slots at their ring positions (the
    ring concat's ``ring_src`` names the same source); the replica slots:
    destination ``q·k·S + halo_src[q, rep_slots[q, i]]`` (ring: ``q·ΣS_d
    + rep_ring_pos``), source the owner's row, baseline row ``o·RS +``
    its position in ``rep_rows[o]``, table row ``q·RP + i``; kept and
    replica slots are disjoint and together every real receive slot."""
    plan = cora["plan"]
    plan.ensure_ragged()
    plan.ensure_exchange()
    plan.ensure_replicas(BUDGET)
    k, b, s = plan.k, plan.b, plan.s
    rep = {(p, int(r)) for p in range(k)
           for r in plan.rep_rows[p, : plan.rep_row_counts[p]]}
    keep, reps = {}, {}
    for q in range(k):
        for p in range(k):
            for t in range(int(plan.send_counts[p, q])):
                row = int(plan.send_idx[p, q, t])
                dst = q * k * s + p * s + t
                (reps if (p, row) in rep else keep)[dst] = p * b + row
    assert dict(zip(plan.keep_recv_dst.tolist(),
                    plan.keep_recv_src.tolist())) == keep
    assert len(plan.keep_recv_dst) == len(keep)
    assert dict(zip(plan.rep_recv_dst.tolist(),
                    plan.rep_src_flat.tolist())) == reps
    assert len(keep) + len(reps) == int(plan.send_counts.sum())
    assert np.array_equal(plan.recv_src.reshape(-1)[plan.keep_recv_dst],
                          plan.keep_recv_src)
    st = sum(plan.rr_sizes)
    assert np.array_equal(plan.ring_src.reshape(-1)[plan.keep_ring_dst],
                          plan.keep_ring_src)
    assert sorted(plan.keep_ring_src.tolist()) == \
        sorted(plan.keep_recv_src.tolist())
    i = 0
    for q in range(k):
        for j in range(int(plan.rep_counts[q])):
            rank = int(plan.rep_slots[q, j])
            assert plan.rep_recv_dst[i] == q * k * s + plan.halo_src[q, rank]
            assert plan.rep_ring_dst[i] == q * st + plan.rep_ring_pos[q, j]
            assert plan.rep_table_pos[i] == q * plan.rp + j
            o, row = divmod(int(plan.rep_src_flat[i]), b)
            pos = int(np.searchsorted(
                plan.rep_rows[o, : plan.rep_row_counts[o]], row))
            assert plan.rep_rows[o, pos] == row
            assert plan.rep_base_flat[i] == o * plan.rs + pos
            i += 1
    assert i == len(plan.rep_recv_dst) == plan.replica_send_saving
    valid = plan.rep_row_valid > 0
    assert np.array_equal(valid.sum(axis=1), plan.rep_row_counts)
    assert np.array_equal(plan.rep_rows_flat[valid],
                          (plan.rep_rows + np.arange(k)[:, None] * b)[valid])


# --------------------------------------------------------- the new pack
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_row_pack_into_plain_equals_index_copy(dtypes):
    """The destination-indexed pack on CPU tensors (its plain version):
    ``out.flat[dst] = src.flat[flat]`` in ``out``'s dtype, the other rows
    untouched — against ``index_copy_`` of the gathered rows on a copy;
    an empty list moves nothing; int64 indices and a width mismatch
    raise."""
    rng = np.random.default_rng(0)
    src = torch.tensor(rng.standard_normal((3, 11, 5)),
                       dtype=getattr(torch, dtypes[0]))
    out0 = torch.tensor(rng.standard_normal((3, 9, 5)),
                        dtype=getattr(torch, dtypes[1]))
    flat = torch.tensor(rng.integers(0, 33, 12), dtype=torch.int32)
    dst = torch.tensor(rng.permutation(27)[:12], dtype=torch.int32)
    out = out0.clone()
    assert row_pack_into(out, src, flat, dst) is out
    want = out0.clone().view(-1, 5)
    want.index_copy_(0, dst.long(),
                     src.reshape(-1, 5)[flat.long()].to(out0.dtype))
    assert torch.equal(out.view(-1, 5), want)
    untouched = np.setdiff1d(np.arange(27), dst.numpy())
    assert torch.equal(out.view(-1, 5)[untouched],
                       out0.view(-1, 5)[untouched])
    assert torch.equal(row_pack_into_plain(out0.clone(), src, flat, dst), out)
    empty = torch.zeros(0, dtype=torch.int32)
    same = out0.clone()
    assert torch.equal(row_pack_into(same, src, empty, empty), out0)
    with pytest.raises(TypeError, match="int32"):
        row_pack_into(out0.clone(), src, flat.long(), dst)
    with pytest.raises(ValueError, match="widths"):
        row_pack_into(out0[..., :4].contiguous(), src, flat, dst)
    assert row_pack_into.launches == 0                # CPU: no launches


# ------------------------------------------------------ the port's own
@pytest.mark.parametrize("case", ["a2a", "ragged", "a2a-halo_dtype"])
def test_sync_every_1_equals_exact_bit_for_bit(cora, init, case):
    """``sync_every=1``: every step refreshes with the exact exchange, so
    losses and weights equal the exact trainer's bit for bit, on both
    transports and under ``halo_dtype``; every exchange is booked full."""
    kw = {"comm_schedule": case.split("-")[0]}
    if case.endswith("halo_dtype"):
        kw["halo_dtype"] = "bfloat16"
    exact, want = _trained(cora, init, **kw)
    rep, got = _trained(cora, init, replica_budget=BUDGET, sync_every=1,
                        **kw)
    assert got == want
    for a, b in zip(rep.params, exact.params):
        assert torch.equal(a, b)
    r = rep.stats.report()
    assert r["replica_exchanges"] == 0
    assert r["exchanges"] == exact.stats.report()["exchanges"]


@pytest.mark.parametrize("sync_every", [0, 2, 3])
def test_replica_ring_equals_replica_a2a_bit_for_bit(cora, init, sync_every):
    """The ring's carry holds the a2a carry's rows at their ring
    positions and the fused launch walks the same slot order: 7 steps
    give equal losses, weights and replica rows on both transports."""
    runs = {s: _trained(cora, init, steps=7, replica_budget=BUDGET,
                        sync_every=sync_every, comm_schedule=s)
            for s in ("a2a", "ragged")}
    (a2a, la), (ring, lr) = runs["a2a"], runs["ragged"]
    assert la == lr
    for a, b in zip(a2a.params, ring.params):
        assert torch.equal(a, b)
    for x, y in zip(a2a._replica_leaves(), ring._replica_leaves()):
        assert np.array_equal(x, y)


def test_budget_at_the_clamp_packs_nothing_and_trains(cora, init):
    """A budget above the boundary row count replicates every boundary
    row: a replica step's pack has no rows (its kept lists are empty) and
    the halo tiles read the last refresh's rows; the run stays finite and
    books 0 true rows on its replica steps."""
    tr, losses = _trained(cora, init, steps=4, replica_budget=10 ** 7,
                          sync_every=2)
    assert tr.plan.replica_rows < 10 ** 7
    assert tr.pa["keep_recv_src"].numel() == 0
    assert np.all(np.isfinite(losses))
    rep = tr.stats.report()
    assert rep["true_rows_per_exchange_replica"] == 0
    assert rep["replica_exchanges"] == 2 * len(WIDTHS) * 2


# --------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def parity_runs(cora):
    """Per case: the reference's and the port's 6-step replica runs from
    the reference's initial weights."""
    cache = {}

    def get(case):
        if case not in cache:
            kw = dict(CASES[case])
            ref = _ref(cora, **kw)
            port = _port(cora, _np(ref.params), **kw)
            ref_losses = [ref.step(cora["ref_data"]) for _ in range(STEPS)]
            losses = [port.step(cora["data"]) for _ in range(STEPS)]
            cache[case] = {"ref": ref, "port": port, "ref_losses": ref_losses,
                           "losses": losses}
        return cache[case]
    return get


CASES = {
    "a2a-sync3": dict(replica_budget=BUDGET, sync_every=3),
    "ragged-sync0": dict(replica_budget=BUDGET, sync_every=0,
                         comm_schedule="ragged"),
    "a2a-halo_dtype-sync2": dict(replica_budget=BUDGET, sync_every=2,
                                 halo_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replica_trainer_matches_the_reference(parity_runs, case):
    """Six steps: losses within rtol 1e-5 / atol 1e-6 of the reference's
    replica trainer (observed ≤ 6e-6), weights too (observed ≤ 8e-7
    absolute); the carries in its layout and order (greps, reps: ``(k,
    RP, f)`` tables) with its shapes, each within 1e-5 of its largest
    value (observed ≤ 6e-6).  Under ``halo_dtype`` the two packages'
    float32 rows differ by ulps, and a row within an ulp of a bf16
    rounding tie rounds to neighbouring bf16 values on the wire: there
    the weights are held within atol 2e-5 (observed 6.6e-6) and the
    carries within one bf16 ulp (2^-7 relative) of their largest value
    (observed ≤ 4.1e-3)."""
    run = parity_runs(case)
    port, ref = run["port"], run["ref"]
    bf16 = "halo_dtype" in case
    np.testing.assert_allclose(run["losses"], run["ref_losses"], **F32)
    wtol = dict(rtol=1e-5, atol=2e-5) if bf16 else F32
    for got, want in zip(port.params, _np(ref.params)):
        np.testing.assert_allclose(got.detach().numpy(), want, **wtol)
    state, got = port.resume_state()
    ref_state, want = ref.resume_state()
    assert port.carry_leaf_shapes() == [w.shape for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        print(f"{case} carry leaf {i} {w.shape}: {err:.3g} of its largest")
        assert err <= (2.0 ** -7 if bf16 else 1e-5), i
    for key in ("rep_step_idx", "last_refresh_idx", "carry", "n_carry",
                "sync_every", "step_count"):
        assert state[key] == ref_state[key], key


@pytest.mark.parametrize("case", list(CASES))
def test_comm_stats_equal_the_references(parity_runs, case):
    """``CommStats.state()`` and every key of ``report()`` equal the
    reference's after the same six steps (replica steps at the shrunken
    figures, refreshes at the full ones)."""
    run = parity_runs(case)
    port, ref = run["port"], run["ref"]
    assert port.stats.state() == ref.stats.state()
    assert port.stats.report() == ref.stats.report()
    assert port.stats.state()["replica_exchanges"] > 0


# ------------------------------------------------------------------ gates
def _directed(cora):
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    return a.tocsr()


GATES = {
    "gat": dict(replica_budget=8, model="gat", activation="none"),
    "gat-auto": dict(replica_budget="auto", model="gat", activation="none"),
    "negative": dict(replica_budget=-1),
    "delta": dict(halo_staleness=1, halo_delta=True, replica_budget=8),
    "asymmetric": dict(replica_budget=8),
    "compute-dtype": dict(replica_budget=8, compute_dtype="bfloat16"),
    "remat": dict(replica_budget=8, remat=True),
    "band-without-budget": dict(refresh_band=0.1),
    "band-negative": dict(replica_budget=8, sync_every=2, refresh_band=-0.5),
    "band-with-staleness": dict(halo_staleness=1, replica_budget=8,
                                sync_every=2, refresh_band=0.1),
    "band-on-the-ring": dict(comm_schedule="ragged", replica_budget=8,
                             sync_every=2, refresh_band=0.1),
    "sync-every-alone": dict(sync_every=2),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_gates_raise_the_references_messages(cora, gate):
    """Every combination the reference refuses raises its ``ValueError``
    with its message."""
    kw = GATES[gate]
    plan, ref_plan = cora["plan"], cora["ref_plan"]
    if gate == "asymmetric":
        a = _directed(cora)
        plan = build_comm_plan(a, cora["pv"], K)
        ref_plan = ref_build_comm_plan(a, cora["pv"], K)
        assert not plan.symmetric
    with pytest.raises(ValueError) as ref_err:
        RefTrainer(ref_plan, fin=FIN, widths=WIDTHS, **kw)
    with pytest.raises(ValueError) as port_err:
        FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, device="cpu", **kw)
    assert str(port_err.value) == str(ref_err.value)


# -------------------------------------------------------------------- CLI
def test_train_cli_replica_budget_auto(cora, capsys, monkeypatch):
    """``main()`` with ``sys.argv``: ``--replica-budget auto --sync-every
    3 --comm-schedule auto`` resolves B at the knee (the reference's
    pick), scores the transports on the shrunken wire and reports the
    replica block and the comm report's replica keys."""
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu_torch.train"] + CLI + [
        "--replica-budget", "auto", "--sync-every", "3", "--comm-schedule",
        "auto", "--epochs", "3"])
    train_main()
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    b = ref_choose_replica_budget(cora["ref_plan"])
    assert rep["replica_budget"] == b
    assert rep["replica_auto"]["chosen"] == b
    assert rep["comm_schedule"] == "ragged"
    assert rep["sync_every"] == rep["controller"]["sync_every"]
    # steps 1, 2 (and 4 unless the controller retuned) are replica steps
    assert rep["replica_exchanges"] >= 2 * 2 * 2
    assert rep["wire_rows_per_exchange_replica"] < \
        rep["wire_rows_per_exchange"]


@pytest.mark.parametrize("argv", [
    ["--replica-budget", "8", "--model", "gat"],
    ["--replica-budget", "8", "--dtype", "bfloat16"],
    ["--replica-budget", "8", "--experiment", "accuracy"],
    ["--replica-budget", "8", "--halo-staleness", "1", "--halo-delta"],
    ["--refresh-band", "0.1"],
    ["--replica-budget", "8", "--refresh-band", "0.1", "--halo-staleness",
     "1"],
    ["--replica-budget", "8", "--refresh-band", "0.1", "--comm-schedule",
     "ragged"]])
def test_train_cli_replica_guards_say_what_the_references_do(argv,
                                                             monkeypatch):
    """The CLI's replica guards exit with the reference CLI's words,
    before any input is read."""
    from sgcn_tpu.train.__main__ import main as ref_main
    argv = ["-p", HP8, "-s", "8"] + argv
    with pytest.raises(SystemExit) as ref_exit:
        monkeypatch.setattr(sys, "argv", ["sgcn_tpu.train"] + argv)
        ref_main()
    with pytest.raises(SystemExit) as port_exit:
        train_main(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value)
    assert "--replica-budget" in str(port_exit.value) or \
        "--refresh-band" in str(port_exit.value)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_port_save_then_resume_equals_uninterrupted(cora, init, tmp_path,
                                                    schedule):
    """``sync_every`` 3: a run saved after step 2 and resumed in a fresh
    trainer (step 2 a replica step on the restored replicas, step 3 a
    refresh) trains steps 3–6 with losses, weights, replica rows and comm
    gauges ``==`` the uninterrupted run's, bit for bit."""
    kw = dict(replica_budget=BUDGET, sync_every=3, comm_schedule=schedule)
    full, want = _trained(cora, init, **kw)
    part, _ = _trained(cora, init, steps=2, **kw)
    path = save_checkpoint(part, str(tmp_path / "r2"), step=2)
    res = _port(cora, _np(_ref(cora, seed=9).params), **kw)
    assert load_checkpoint(res, path) == 2
    assert res.last_restore_partial is False
    assert (res._rep_step_idx, res._last_refresh_idx) == (2, 0)
    got = [res.step(cora["data"]) for _ in range(STEPS - 2)]
    assert got == want[2:]
    for a, b in zip(res.params, full.params):
        assert torch.equal(a, b)
    for x, y in zip(res._replica_leaves(), full._replica_leaves()):
        assert np.array_equal(x, y)
    assert res.stats.state() == full.stats.state()


FILE_CASES = {
    "replica": dict(replica_budget=BUDGET, sync_every=3),
    "composed": dict(replica_budget=BUDGET, sync_every=3, halo_staleness=1),
    "partial": dict(replica_budget=BUDGET, sync_every=2, refresh_band=0.5),
}


@pytest.mark.parametrize("case", list(FILE_CASES))
def test_reference_replica_file_resumes_in_the_port(cora, tmp_path, case):
    """The reference (C3 chain) trains 2 steps of a replica run, a
    composed run (its stale ``halo_carry`` holds the replicas) and a
    partial-refresh run (with its baselines) and saves; the port restores
    the full state (carries, counters) and trains 4 more within rtol 1e-5
    / atol 1e-6 of the reference's own continuation (a replica or stale
    step on the restored carries first)."""
    kw = FILE_CASES[case]
    ref = _ref(cora, **kw)
    for _ in range(2):
        ref.step(cora["ref_data"])
    path = ref_ckpt.save_checkpoint(ref, str(tmp_path / "ref"), step=2)
    want = [ref.step(cora["ref_data"]) for _ in range(4)]
    port = _port(cora, _np(_ref(cora, seed=9).params), **kw)
    assert load_checkpoint(port, path) == 2
    assert port.last_restore_partial is False
    assert (port._stale_step_idx if case == "composed"
            else port._rep_step_idx) == 2
    got = [port.step(cora["data"]) for _ in range(4)]
    np.testing.assert_allclose(got, want, **F32)
    assert port.stats.state() == ref.stats.state()


@pytest.mark.parametrize("case", ["replica", "partial"])
def test_port_replica_file_resumes_in_the_reference(cora, init, tmp_path,
                                                    case):
    """A port file of a replica run and of a partial-refresh run (saved
    after step 2) loads in the reference with full state: its replica
    tables (and baselines) are the file's bit for bit, and its next 4
    steps stay within rtol 1e-5 / atol 1e-6 of the port's own
    continuation."""
    kw = FILE_CASES[case]
    port, _ = _trained(cora, init, steps=2, **kw)
    path = save_checkpoint(port, str(tmp_path / "port"), step=2)
    carry = port.resume_state()[1]
    want = [port.step(cora["data"]) for _ in range(4)]
    ref = _ref(cora, seed=9, **kw)
    assert ref_ckpt.load_checkpoint(ref, path) == 2
    assert ref.last_restore_partial is False
    assert ref._rep_step_idx == 2
    for a, b in zip(_np(ref.replica_carry), carry):
        assert np.array_equal(a, b)
    got = [ref.step(cora["ref_data"]) for _ in range(4)]
    np.testing.assert_allclose(got, want, **F32)


def test_replica_file_into_an_exact_trainer_loads_params_only(cora, init,
                                                              tmp_path):
    """A carry-mode mismatch (a replica file into an exact trainer):
    the reference's loud warning, params-only."""
    rep, _ = _trained(cora, init, steps=1, replica_budget=BUDGET)
    path = save_checkpoint(rep, str(tmp_path / "rep"), step=1)
    exact = _port(cora, init)
    with pytest.warns(RuntimeWarning, match="'replica_carry' state but this "
                      "trainer runs exact mode — full state IGNORED"):
        assert load_checkpoint(exact, path) == 1
    # nothing beyond the params was imported; an exact trainer holds no
    # state a params-only restore could lose
    assert exact._step_count == 0 and exact.stats.state()["exchanges"] == 0
    assert exact.last_restore_partial is False


def test_directed_graph_gate_uses_a_real_directed_plan():
    """The asymmetric gate case above runs on a plan whose Â is not
    symmetric (one edge dropped one way)."""
    a = sp.random(40, 40, density=0.1, random_state=0, format="csr")
    plan = build_comm_plan(a, np.arange(40) % 4, 4)
    assert not plan.symmetric
    with pytest.raises(ValueError, match="symmetric"):
        FullBatchTrainer(plan, fin=3, widths=[2], device="cpu",
                         replica_budget=4)
