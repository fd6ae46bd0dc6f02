"""The port's pipelined stale-halo trainer against the reference's.

Inputs: cora2708 under its 8-part hp partition, GCN 1433 → 16 → 7 (ReLU),
on the CPU.  The reference's stale mode runs its ELL aggregator on the 8
virtual CPU devices of ``tests/conftest.py`` (it never selects its Pallas
kernel); the port's runs the pack and the fused tile launch, whose plain
versions carry it here.  So the two agree within a stated float32
tolerance, and the port's own bit-identities (``sync_every=1`` == exact,
stale ragged == stale a2a) rest on its kernels' serial chains.

On this tree's JAX the reference trainer steps on k × the loss gradient
(ROADMAP C3).  ``test_reference_step_gradient_scale_is_measured`` measures
the factor in the stale mode, on sync and stale steps, and the parity
tests hand the reference ``optax.chain(optax.scale(1/k), optax.adam(lr))``.

Carries are compared in the reference's layout: the port's receive
buffers gathered to ``(R, f)`` halo tables and its baselines transposed
back to the senders' ``(k, S, f)`` (``FullBatchTrainer._carry_leaves``).
Under ``halo_delta`` each stale step rounds ``full − base`` to bf16; where
that difference sits within float32 noise of a bf16 rounding boundary the
two packages round it to neighbouring bf16 values, so a delta carry
element may differ by one bf16 step of its increment (the next increment
carries the difference back: the losses stay within the float32
tolerance).  The delta tests bound those elements, count and size.
"""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.obs import RunRecorder, load_run
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel.plan import \
    resolve_comm_schedule as ref_resolve_comm_schedule
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.controller import CommController as RefController
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils import checkpoint as ref_ckpt
from sgcn_tpu.utils.stats import CommStats as RefCommStats
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models.gcn import exchange_widths, params_from_jax
from sgcn_tpu_torch.ops import pspmm
from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesStale,
                                          pspmm_tiles_ragged,
                                          pspmm_tiles_stale,
                                          pspmm_tiles_stale_ragged,
                                          pspmm_tiles_sym, spmm_tiles_fused)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.parallel.plan import resolve_comm_schedule
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.controller import (DEFAULT_LOWER, DEFAULT_UPPER,
                                             CommController)
from sgcn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sgcn_tpu_torch.utils.stats import CommStats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
FIN = 1433
WIDTHS = [16, 7]
LR = 0.01
STEPS = 6
K = 8
CLI = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
       "--hidden", "16", "--device", "cpu"]
# the float32 tolerance of the port's parity tests
F32 = dict(rtol=1e-5, atol=1e-6)
# one bf16 step of an increment of magnitude |x|: 2^-8 relative
BF16_STEP = 2.0 ** -8


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


def _ref(cora, scale=K, **kw):
    opt = optax.chain(optax.scale(1.0 / scale), optax.adam(LR))
    kw.setdefault("seed", 3)
    return RefTrainer(cora["ref_plan"], fin=FIN, widths=WIDTHS, lr=LR,
                      optimizer=opt, halo_staleness=1, **kw)


def _port(cora, params, **kw):
    return FullBatchTrainer(cora["plan"], fin=FIN, widths=WIDTHS, lr=LR,
                            params=params_from_jax(params), device="cpu",
                            **kw)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _weights(tr):
    return [w.detach().numpy().copy() for w in tr.params]


# ------------------------------------------------------- C3 in stale mode
def test_reference_step_gradient_scale_is_measured(cora):
    """C3's factor holds in the stale mode: the reference's optimizer sees
    k × the loss gradient on the sync step and on stale steps.  The
    reference steps with ``optax.scale(1)`` (its update IS its gradient);
    before each step the port takes the reference's weights and forms its
    own loss gradient on the same carries.  Ratio of the per-layer norms:
    8 within 1e-3 (observed within 2e-6)."""
    ref = RefTrainer(cora["ref_plan"], fin=FIN, widths=WIDTHS, seed=3,
                     halo_staleness=1, halo_delta=True, sync_every=0,
                     optimizer=optax.scale(1.0))
    port = _port(cora, _np(ref.params), halo_staleness=1, halo_delta=True)
    ratios = []
    for _ in range(3):
        before = _np(ref.params)
        with torch.no_grad():
            for w, x in zip(port.params, before):
                w.copy_(torch.tensor(x))
        ref.step(cora["ref_data"])
        port.step(cora["data"])
        ratios.append([
            float(np.linalg.norm(np.asarray(a) - b)
                  / np.linalg.norm(w.grad.numpy()))
            for a, b, w in zip(ref.params, before, port.params)])
    print(f"reference update / port gradient, per step and layer: {ratios}")
    np.testing.assert_allclose(ratios, K, rtol=1e-3)


# ------------------------------------------- parity with the reference
@pytest.fixture(scope="module")
def parity_runs(cora):
    """Per (schedule, delta, sync_every): the reference's and the port's
    6-step runs from the reference's initial weights — losses, weights
    and carry leaves.  Built once per case."""
    cache = {}

    def get(schedule, delta, sync_every):
        key = (schedule, delta, sync_every)
        if key not in cache:
            kw = dict(halo_delta=delta, sync_every=sync_every,
                      comm_schedule=schedule)
            ref = _ref(cora, **kw)
            port = _port(cora, _np(ref.params), halo_staleness=1, **kw)
            ref_losses = [ref.step(cora["ref_data"]) for _ in range(STEPS)]
            losses = [port.step(cora["data"]) for _ in range(STEPS)]
            cache[key] = {
                "ref_losses": ref_losses, "losses": losses,
                "ref_w": _np(ref.params), "w": _weights(port),
                "ref_carry": _np(ref.halo_carry),
                "carry": port.resume_state()[1], "port": port, "ref": ref}
        return cache[key]
    return get


CASES = [(s, d, n) for s in ("a2a", "ragged") for d in (False, True)
         for n in (0, 3)]


def _ids(case):
    s, d, n = case
    return f"{s}-{'delta' if d else 'plain'}-sync{n}"


def _normwise(got, want):
    """max |got − want| over the largest |want| of the array."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stale_trainer_matches_the_reference(parity_runs, case):
    """Six steps, both transports, delta off and on, ``sync_every`` 0 and
    3: losses and weights within rtol 1e-5 / atol 1e-6 (observed ≤ 4.6e-6
    and ≤ 1.2e-6 absolute).  The carries in the reference's layout and
    order (``jax.tree`` order of {halos, ghalos, bases}) with the
    reference's shapes; each array within 1e-5 of its largest value
    (the projection's rounding scale: a carry row is a 1433-term dot
    product; observed ≤ 7.1e-6) — except under delta, where a bf16
    rounding split (module docstring) moves a feature-carry element by
    one bf16 step of its increment (observed on ≤ 1.5 % of the elements,
    ≤ 6.5e-4 of the largest value; bound: ≤ 5 %, ≤ 2^-8) and the gradient
    carries, computed on those halos, within 1e-3 of their largest value
    (observed ≤ 1.1e-4)."""
    run = parity_runs(*case)
    gap = np.max(np.abs(np.subtract(run["losses"], run["ref_losses"])))
    wgap = max(float(np.max(np.abs(a - b)))
               for a, b in zip(run["w"], run["ref_w"]))
    print(f"{_ids(case)}: max loss gap {gap:.3g}, max weight gap {wgap:.3g}")
    np.testing.assert_allclose(run["losses"], run["ref_losses"], **F32)
    for got, want in zip(run["w"], run["ref_w"]):
        np.testing.assert_allclose(got, want, **F32)
    assert [c.shape for c in run["carry"]] == \
        [c.shape for c in run["ref_carry"]]
    assert run["port"].carry_leaf_shapes() == \
        [c.shape for c in run["ref_carry"]]
    n = len(WIDTHS)
    for i, (got, want) in enumerate(zip(run["carry"], run["ref_carry"])):
        err = _normwise(got, want)
        print(f"  carry leaf {i} {want.shape}: {err:.3g} of its largest")
        if not case[1]:
            assert err <= 1e-5, i
        elif n <= i < 2 * n:                       # gradient carries
            assert err <= 1e-3, i
        else:                                      # bases, halos
            scale = np.abs(want).max()
            split = np.abs(got - want) > 1e-5 * scale
            assert split.mean() <= 0.05 and err <= BF16_STEP, i


# ------------------------------------------------ the port's own identities
def _trained(cora, params, steps=STEPS, **kw):
    tr = _port(cora, params, **kw)
    losses = [tr.step(cora["data"]) for _ in range(steps)]
    return tr, losses


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
@pytest.mark.parametrize("lever", ["plain", "delta", "halo_dtype"])
def test_sync_every_1_equals_exact_bit_for_bit(cora, schedule, lever):
    """``sync_every=1``: every step is a sync step, whose exchanges are the
    exact path's (a delta sync ships the full float32 row), so losses and
    weights equal the exact trainer's bit for bit, both transports; under
    ``halo_dtype`` without delta too (the stale wire keeps it)."""
    init = _np(_ref(cora).params)
    kw = {"comm_schedule": schedule}
    if lever == "halo_dtype":
        kw["halo_dtype"] = "bfloat16"
    exact, want = _trained(cora, init, **kw)
    stale, got = _trained(cora, init, halo_staleness=1, sync_every=1,
                          halo_delta=lever == "delta", **kw)
    assert got == want
    for a, b in zip(stale.params, exact.params):
        assert torch.equal(a, b)
    rep = stale.stats.report()
    assert rep["hidden_exchanges"] == 0
    assert rep["exchanges"] == exact.stats.report()["exchanges"]


@pytest.mark.parametrize("sync_every", [0, 4])
@pytest.mark.parametrize("delta", [False, True])
def test_stale_ragged_equals_stale_a2a_bit_for_bit(cora, delta, sync_every):
    """The ring's carries hold the a2a carries' rows and the fused launch
    walks the same slot order: 1 + 8 steps give equal losses, weights and
    carries (in the reference's layout) on both transports."""
    init = _np(_ref(cora).params)
    runs = {s: _trained(cora, init, steps=9, halo_staleness=1,
                        halo_delta=delta, sync_every=sync_every,
                        comm_schedule=s) for s in ("a2a", "ragged")}
    (a2a, la), (ring, lr) = runs["a2a"], runs["ragged"]
    assert la == lr
    for a, b in zip(a2a.params, ring.params):
        assert torch.equal(a, b)
    # both transports' carries (feature and gradient; under delta the
    # carry is also the baseline), read back as the named halo rows
    for x, y in zip(a2a.halo_carry["halos"] + a2a.halo_carry["ghalos"],
                    ring.halo_carry["halos"] + ring.halo_carry["ghalos"]):
        assert torch.equal(_named_rows_a2a(a2a, x), _named_rows_ring(ring,
                                                                      y))


def _named_rows_a2a(tr, carry):
    """The named halo rows of an a2a carry, by (part, halo rank)."""
    rows = pspmm.recv_halo_rows(carry, tr._halo_src_flat)
    counts = tr.plan.halo_counts
    return torch.cat([rows[q, :counts[q]] for q in range(tr.plan.k)])


def _named_rows_ring(tr, carry):
    """The same rows out of a ring carry: slot ``j`` of part ``q`` holds
    halo rank ``rhalo_dst[q, j]`` (``r`` on a padding slot)."""
    plan = tr.plan
    out = []
    for q in range(plan.k):
        dst = np.asarray(plan.rhalo_dst[q])
        live = np.flatnonzero(dst < plan.r)
        order = live[np.argsort(dst[live], kind="stable")]
        assert np.array_equal(dst[order], np.arange(plan.halo_counts[q]))
        out.append(carry[q, torch.as_tensor(order)].float())
    return torch.cat(out)


# ------------------------------------------------------ plan and schedule
@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
@pytest.mark.parametrize("delta", [False, True])
def test_stale_carry_shapes_equal_the_references(cora, schedule, delta):
    plan, ref_plan = cora["plan"], cora["ref_plan"]
    if schedule == "ragged":
        plan.ensure_ragged()
        ref_plan.ensure_ragged()
    got = plan.stale_carry_shapes(FIN, WIDTHS, delta=delta,
                                  comm_schedule=schedule)
    want = ref_plan.stale_carry_shapes(FIN, WIDTHS, delta=delta,
                                       comm_schedule=schedule)
    assert got == want


@pytest.mark.parametrize("schedule", ["a2a", "ragged", "auto", None])
def test_schedule_decision_under_staleness_equals_the_references(
        cora, schedule, monkeypatch):
    """``halo_staleness=1`` switches ``auto`` to the hidden exchange's
    wire-row rule: on cora 8-hp the ring ships 4128 wire rows against the
    a2a's 6976, so ``auto`` resolves to ragged by that rule; every key of
    the reference's decision log is equal."""
    monkeypatch.setenv("SGCN_COMM_SCHEDULE", "auto")
    log, ref_log = {}, {}
    got = resolve_comm_schedule(schedule, [cora["plan"]], "gcn",
                                decision=log, halo_staleness=1)
    want = ref_resolve_comm_schedule(schedule, [cora["ref_plan"]], "gcn",
                                     halo_staleness=1, decision=ref_log)
    assert got == want
    assert log == ref_log
    if schedule in ("auto", None):
        assert got == "ragged" and log["rule"].startswith("hidden-exchange")
        assert (log["wire_rows_ragged"], log["wire_rows_a2a"]) == \
            (4128, 6976)


# ------------------------------------------------------------ controller
def test_controller_equals_the_references():
    """Decisions, log and ``state``/``load_state`` against the reference's
    on injected gauge sequences that cross the band both ways and hit
    both clamps; the constructor's refusals too."""
    assert (DEFAULT_UPPER, DEFAULT_LOWER) == (0.5, 0.02)
    rng = np.random.default_rng(0)
    seqs = [[0.6, 0.7, 0.9, 0.9, 0.9, 0.01, 0.3, 0.001],
            list(rng.choice([0.001, 0.1, 0.8], 40)),
            [0.0] * 12]
    for start in (1, 3, 200):
        for seq in seqs:
            a, b = CommController(start), RefController(start)
            for i, x in enumerate(seq):
                assert a.observe(3 * i, float(x)) == \
                    b.observe(3 * i, float(x))
            assert a.log() == b.log() and a.state() == b.state()
            c, d = CommController(7), RefController(7)
            c.load_state(a.state())
            d.load_state(b.state())
            assert c.log() == d.log()
    for bad in (dict(sync_every=0), dict(sync_every=2, lower=0.6)):
        with pytest.raises(ValueError) as e1:
            CommController(**bad)
        with pytest.raises(ValueError) as e2:
            RefController(**bad)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_drift_gauges_equal_the_references(cora, tmp_path, schedule):
    """The drift gauges of every step, delta on, ``sync_every`` 3 (the
    reference's through its run recorder, which gauges every step; the
    port's with ``drift_gauges``): ``halo_drift_rms``, ``halo_drift_rel``
    within rtol 1e-3 (the sums run in other orders); ``halo_quant_err_rms``
    within rtol 1e-2 (observed ≤ 1.3e-3): it sums the rounding residual
    itself, which each bf16 rounding split of the module docstring moves by
    one bf16 step.  The rms sums over the reference's
    ``(R, f)`` rows, padding rows included."""
    ref = _ref(cora, halo_delta=True, sync_every=3, comm_schedule=schedule)
    port = _port(cora, _np(ref.params), halo_staleness=1, halo_delta=True,
                 sync_every=3, comm_schedule=schedule)
    port.drift_gauges = True
    rec = RunRecorder(str(tmp_path), config={"model": "gcn"})
    ref.attach_recorder(rec)
    got = []
    for _ in range(5):
        ref.step(cora["ref_data"])
        port.step(cora["data"])
        g = port.last_gauges
        d, r, q = (np.sqrt(g[x]) for x in ("drift_sq", "ref_sq", "qerr_sq"))
        got.append((d, d / r, q))
    rec.close()
    for (d, rel, q), ev in zip(got, load_run(str(tmp_path)).steps()):
        want = ev["drift"]
        np.testing.assert_allclose(d, want["halo_drift_rms"], rtol=1e-3)
        np.testing.assert_allclose(rel, want["halo_drift_rel"], rtol=1e-3)
        np.testing.assert_allclose(q, want["halo_quant_err_rms"], rtol=1e-2,
                                   atol=1e-6)
    # step 3 is a sync step: a full re-base, no rounding residual
    assert np.all(got[3][2] == 0) and np.all(got[1][2] > 0)


def test_controller_retunes_on_the_cli_and_in_the_trainer(cora, capsys):
    """``--comm-schedule auto --halo-staleness 1 --sync-every 2`` resolves
    by the hidden-exchange rule (ragged) and the controller observes each
    non-initializing sync step: the trainer's decisions equal a reference
    controller fed the port's own measured drift.  The CLI prints the
    stale block and the controller's log."""
    init = _np(_ref(cora).params)
    tr = _port(cora, init, halo_staleness=1, halo_delta=True, sync_every=2,
               comm_schedule="auto")
    assert tr.comm_schedule == "ragged"
    ref_ctl = RefController(2)
    for _ in range(8):
        idx = tr._stale_step_idx
        sync = tr._stale_sync_due()
        tr.step(cora["data"])
        if sync and idx:
            g = tr.last_gauges
            rel = float(np.max(np.sqrt(g["drift_sq"]) / np.sqrt(g["ref_sq"])))
            ref_ctl.observe(idx, rel)
    assert tr.comm_decision["controller"] == ref_ctl.log()
    assert tr.sync_every == ref_ctl.sync_every
    train_main(CLI + ["--comm-schedule", "auto", "--halo-staleness", "1",
                      "--sync-every", "2", "--epochs", "4"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["comm_schedule"] == "ragged"
    assert rep["halo_staleness"] == 1 and rep["halo_delta"] is False
    assert rep["controller"]["kind"] == "drift-banded sync_every retune"
    assert rep["controller"]["initial_sync_every"] == 2
    assert rep["sync_every"] == rep["controller"]["sync_every"]
    assert rep["hidden_exchanges"] + rep["exposed_exchanges"] == \
        rep["exchanges"] == 5 * 2 * 2


# ----------------------------------------------------------------- gates
def _directed(cora):
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    return a.tocsr()


GATES = {
    "staleness-2": dict(halo_staleness=2),
    "delta-without-staleness": dict(halo_delta=True),
    "sync-every-negative": dict(sync_every=-1),
    "sync-every-without-staleness": dict(sync_every=2),
    "gat": dict(halo_staleness=1, model="gat", activation="none"),
    "asymmetric": dict(halo_staleness=1),
    "compute-dtype": dict(halo_staleness=1, compute_dtype="bfloat16"),
    "remat": dict(halo_staleness=1, remat=True),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_gates_raise_the_references_messages(cora, gate):
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


@pytest.mark.parametrize("argv", [
    ["--halo-staleness", "1", "--model", "gat"],
    ["--halo-staleness", "1", "--dtype", "bfloat16"],
    ["--halo-staleness", "1", "--experiment", "accuracy"],
    ["--halo-delta"],
    ["--sync-every", "3"]])
def test_train_cli_stale_guards_say_what_the_references_do(argv,
                                                           monkeypatch):
    from sgcn_tpu.train.__main__ import main as ref_main

    monkeypatch.setattr(sys, "argv", ["sgcn_tpu.train", "-p", HP8, "-s",
                                      "8", *argv])
    with pytest.raises(SystemExit) as ref_err:
        ref_main()
    with pytest.raises(SystemExit) as port_err:
        train_main(["-p", HP8, "-s", "8", "--device", "cpu", *argv])
    assert isinstance(port_err.value.code, str)
    assert port_err.value.code == ref_err.value.code


# ------------------------------------------------------------- the wire
@pytest.mark.parametrize("halo_dtype", [None, "bfloat16"])
def test_per_step_wire_itemsize_split(cora, capsys, halo_dtype):
    """Under ``--halo-delta`` a stale step's feature wire is bf16 and a
    sync (re-base) step's is float32, whatever ``--halo-dtype`` says (it
    sets the gradient wire alone): the CLI's cumulative byte gauges after
    1 + 2 steps at ``--sync-every 2`` (sync, stale, sync) equal the
    reference's ``CommStats`` booking the same steps, and the per-step
    keys describe the stale step."""
    argv = CLI + ["--halo-staleness", "1", "--halo-delta", "--sync-every",
                  "2", "--epochs", "2", "--comm-schedule", "ragged"]
    if halo_dtype:
        argv += ["--halo-dtype", halo_dtype]
    train_main(argv)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    plan = cora["ref_plan"]
    plan.ensure_ragged()
    bwd = 2 if halo_dtype else 4
    lanes = tuple(exchange_widths(FIN, WIDTHS))          # (16, 16)
    ref = RefCommStats.from_plan(plan, schedule="ragged",
                                 lane_widths=lanes, wire_itemsize=2,
                                 wire_itemsize_bwd=bwd)
    for sync in (True, False, True):
        ref.count_step(nlayers=2, hidden=not sync,
                       wire_itemsize=4 if sync else None)
    want = ref.report()
    for key in ("halo_bytes_true_total", "halo_bytes_wire_total",
                "halo_bytes_true_per_step", "halo_bytes_wire_per_step",
                "hidden_exchanges", "exposed_exchanges",
                "hidden_send_volume", "exposed_send_volume",
                "hidden_wire_rows_total", "exposed_wire_rows_total",
                "wire_rows_total", "exchanges"):
        assert rep[key] == want[key], key
    rows = int(cora["plan"].predicted_send_volume.sum())
    assert rep["halo_bytes_true_per_step"] == rows * 32 * (2 + bwd)
    port = CommStats.from_plan(cora["plan"], schedule="ragged",
                               lane_widths=lanes, wire_itemsize=2,
                               wire_itemsize_bwd=bwd)
    ref = RefCommStats.from_plan(plan, schedule="ragged", lane_widths=lanes,
                                 wire_itemsize=2, wire_itemsize_bwd=bwd)
    for st in (port, ref):
        st.count_step(nlayers=2, hidden=True)
        st.count_step(nlayers=2, wire_itemsize=4)
    assert port.state() == ref.state()
    assert port.report() == {key: v for key, v in ref.report().items()
                             if key in port.report()}


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_port_save_then_resume_equals_uninterrupted(cora, tmp_path,
                                                    schedule):
    """Delta on, ``sync_every`` 3: a run saved after step 2 (its next step
    stale) and resumed in a fresh trainer trains steps 3–6 with losses,
    weights, Adam state, carries and comm gauges ``==`` the uninterrupted
    run's, bit for bit."""
    init = _np(_ref(cora).params)
    kw = dict(halo_staleness=1, halo_delta=True, sync_every=3,
              comm_schedule=schedule)
    full, want = _trained(cora, init, **kw)
    part, _ = _trained(cora, init, steps=2, **kw)
    path = save_checkpoint(part, str(tmp_path / "s2"), step=2)
    res = _port(cora, _np(_ref(cora, seed=9).params), **kw)
    assert load_checkpoint(res, path) == 2
    assert res.last_restore_partial is False
    assert (res._stale_step_idx, res._last_sync_idx) == (2, 0)
    got = [res.step(cora["data"]) for _ in range(STEPS - 2)]
    assert got == want[2:]
    for a, b in zip(res.params, full.params):
        assert torch.equal(a, b)
    for x, y in zip(res.halo_carry["halos"] + res.halo_carry["ghalos"],
                    full.halo_carry["halos"] + full.halo_carry["ghalos"]):
        assert torch.equal(x, y)
    for p in res.params:
        for key in ("exp_avg", "exp_avg_sq"):
            q = full.params[[id(w) for w in res.params].index(id(p))]
            assert torch.equal(res.opt.state[p][key], full.opt.state[q][key])
    assert res.stats.state() == full.stats.state()


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_reference_stale_file_resumes_in_the_port(cora, tmp_path, schedule):
    """The reference (C3 chain; delta, ``sync_every`` 3) trains 2 steps
    and saves; the port restores the full state (carries, counters) and
    trains 4 more: its losses within rtol 1e-5 / atol 1e-6 of the
    reference's own continuation, which runs stale steps on the restored
    carries and baselines before its step-3 sync."""
    ref = _ref(cora, halo_delta=True, sync_every=3, comm_schedule=schedule)
    for _ in range(2):
        ref.step(cora["ref_data"])
    path = ref_ckpt.save_checkpoint(ref, str(tmp_path / "ref"), step=2)
    want = [ref.step(cora["ref_data"]) for _ in range(4)]
    port = _port(cora, _np(_ref(cora, seed=9).params), halo_staleness=1,
                 halo_delta=True, sync_every=3, comm_schedule=schedule)
    assert load_checkpoint(port, path) == 2
    assert port.last_restore_partial is False
    assert port._stale_step_idx == 2
    got = [port.step(cora["data"]) for _ in range(4)]
    gap = np.max(np.abs(np.subtract(got, want)))
    print(f"{schedule}: max loss gap {gap:.3g}")
    np.testing.assert_allclose(got, want, **F32)
    assert port.stats.report()["exchanges"] == \
        ref.stats.report()["exchanges"]


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_port_stale_file_resumes_in_the_reference(cora, tmp_path, schedule):
    """A port file of a stale run (delta, ``sync_every`` 3, saved after
    step 2) loads in the reference with full state: its carry leaves are
    the file's bit for bit, and its next 4 steps (stale steps on the
    restored carries first) stay within rtol 1e-5 / atol 1e-6 of the
    port's own continuation."""
    init = _np(_ref(cora).params)
    kw = dict(halo_delta=True, sync_every=3, comm_schedule=schedule)
    port, _ = _trained(cora, init, steps=2, halo_staleness=1, **kw)
    path = save_checkpoint(port, str(tmp_path / "port"), step=2)
    carry = port.resume_state()[1]
    want = [port.step(cora["data"]) for _ in range(4)]
    ref = _ref(cora, seed=9, **kw)
    assert ref_ckpt.load_checkpoint(ref, path) == 2
    assert ref.last_restore_partial is False
    assert ref._stale_step_idx == 2
    for a, b in zip(_np(ref.halo_carry), carry):
        assert np.array_equal(a, b)
    got = [ref.step(cora["ref_data"]) for _ in range(4)]
    np.testing.assert_allclose(got, want, **F32)


def test_carry_mode_mismatch_loads_params_only_with_a_warning(cora,
                                                              tmp_path):
    """An exact file into a stale trainer: the reference's PARTIAL STATE
    warning, params-only, ``last_restore_partial`` set."""
    init = _np(_ref(cora).params)
    exact, _ = _trained(cora, init, steps=1)
    path = save_checkpoint(exact, str(tmp_path / "exact"), step=1)
    stale = _port(cora, init, halo_staleness=1)
    with pytest.warns(RuntimeWarning, match="PARTIAL STATE"):
        assert load_checkpoint(stale, path) == 1
    assert stale.last_restore_partial is True
    assert stale._stale_step_idx == 0 and stale._step_count == 0


# ----------------------------------------------------- the op on its own
@pytest.mark.parametrize("delta", [False, True])
def test_stale_op_fresh_equals_the_exact_op_and_stale_reads_the_carry(
        cora, delta):
    """One aggregation: a fresh step is ``pspmm_tiles_sym`` (and the ring
    flavor ``pspmm_tiles_ragged``) bit for bit, forward and backward, and
    its carry is the exchange; a stale step sums the GIVEN carry (the
    fused launch on the previous receive buffer) while the next carry is
    this step's exchange (or, under delta, the carry plus the rounded
    increment), and its backward writes the gradient exchange into the
    holder and sums the given gradient carry."""
    plan = cora["plan"]
    tr = _port(cora, _np(_ref(cora).params), comm_schedule="a2a")
    ring = _port(cora, _np(_ref(cora).params), comm_schedule="ragged")
    pa, st = tr.pa, tr.setup.fwd_static
    pr, sr = ring.pa, ring.setup.fwd_static
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((K, plan.b, 16)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((K, plan.b, 16)), dtype=torch.float32)
    lt = (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"])
    ht = (pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"])
    cls = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    exact = pspmm_tiles_sym(x, pa["recv_src"], *lt, *ht, *cls)
    (gx_exact,) = torch.autograd.grad(exact, x, g)
    z = torch.zeros((K, K * plan.s, 16))
    holder = [None]
    out, nxt = pspmm_tiles_stale(x, z, z, pa["recv_src"], *lt, *ht, *cls,
                                 delta=delta, fresh=True, gholder=holder)
    (gx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(out, exact) and torch.equal(gx, gx_exact)
    recv = pspmm.exchange_recv(x.detach(), pa["recv_src"])
    assert torch.equal(nxt, recv)
    assert torch.equal(holder[0], pspmm.exchange_recv(g, pa["recv_src"]))
    # the ring flavor, fresh: the exact ring op, bit for bit
    rt = (pr["ptile_hrsrc"], pr["ptile_hld"], pr["ptile_hw"])
    zr = torch.zeros((K, sum(sr["rr_sizes"]), 16))
    out_r, _ = pspmm_tiles_stale_ragged(
        x, zr, zr, pr["ring_src"], *lt, *rt, *cls, sr["rr_sizes"],
        delta=delta, fresh=True, gholder=[None])
    assert torch.equal(out_r, pspmm_tiles_ragged(
        x, pr["ring_src"], *lt, *rt, *cls, sr["rr_sizes"]))
    assert torch.equal(out_r, exact)
    # a stale step on a carry of other rows: the sum reads the carry
    carry = torch.tensor(rng.standard_normal(recv.shape), dtype=torch.float32)
    gcarry = torch.tensor(rng.standard_normal(recv.shape),
                          dtype=torch.float32)
    holder = [None]
    out, nxt = pspmm_tiles_stale(x, carry, gcarry, pa["recv_src"], *lt, *ht,
                                 *cls, delta=delta, gholder=holder)
    (gx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(out, spmm_tiles_fused(lt, x.detach(), ht, carry,
                                             st["pallas_lclasses"],
                                             st["pallas_hclasses"],
                                             st["pallas_tb"]))
    assert torch.equal(gx, spmm_tiles_fused(lt, g, ht, gcarry,
                                            st["pallas_lclasses"],
                                            st["pallas_hclasses"],
                                            st["pallas_tb"]))
    want = (carry + (recv - carry).to(torch.bfloat16).float() if delta
            else recv)
    assert torch.equal(nxt, want)
    assert torch.equal(holder[0], pspmm.exchange_recv(g, pa["recv_src"]))
    assert PspmmTilesStale.backward_launches == 0   # CPU: no launches


def test_carry_layout_conversions_invert_each_other(cora):
    """The reference-layout edges: a2a baselines transpose and back, the
    ring's roll per round and back, halo rows gather and scatter on the
    named slots (0 in the others)."""
    plan = cora["plan"]
    plan.ensure_ragged()
    rng = np.random.default_rng(1)
    recv = torch.tensor(rng.standard_normal((K, K * plan.s, 3)),
                        dtype=torch.float32)
    base = pspmm.recv_to_send_bases(recv, plan.s)
    assert base.shape == (K, K, plan.s, 3)
    assert torch.equal(base[2, 5, 7], recv[5, 2 * plan.s + 7])
    assert torch.equal(pspmm.recv_from_send_bases(base, torch.float32), recv)
    ring = torch.tensor(rng.standard_normal((K, sum(plan.rr_sizes), 3)),
                        dtype=torch.float32)
    rb = pspmm.ring_to_send_bases(ring, plan.rr_sizes)
    off = plan.rr_sizes[0] + plan.rr_sizes[1]          # round d = 3
    assert torch.equal(rb[1, off], ring[4, off])
    assert torch.equal(pspmm.ring_to_send_bases(rb, plan.rr_sizes,
                                                inverse=True), ring)
    hsf = torch.as_tensor(plan.halo_src_flat.astype(np.int64))
    rows = pspmm.recv_halo_rows(recv, hsf)
    back = pspmm.recv_from_halo_rows(rows, hsf, recv.shape, torch.float32)
    assert torch.equal(pspmm.recv_halo_rows(back, hsf), rows)
    named = np.zeros(K * K * plan.s, bool)
    named[plan.halo_src_flat.ravel()] = True
    assert torch.all(back.reshape(-1, 3)[torch.as_tensor(~named)] == 0)
