"""The port's replica × stale composition and the drift-banded partial
refresh (``--refresh-band``) against the reference's.

Inputs: cora2708 under its 8-part hp partition, GCN 1433 → 16 → 7 (ReLU),
on the CPU, as in ``tests/test_torch_replica.py`` (the reference on its
ELL aggregator over 8 virtual CPU devices, the port on the plain versions
of its pack and fused launch; the reference's optimizer scaled by 1/k for
ROADMAP C3).

The composed mode (``replica_budget`` with ``halo_staleness=1``) carries
the stale mode's receive layouts; a stale step's fused launch reads the
previous carry and the kept rows are then packed into it, so the replica
slots keep their last-sync rows.  Its carries are compared on the named
halo rows: the reference's ``(R, f)`` table pads (ranks past a part's
halo count) read the shrunken exchange's slot 0 on a stale step, the
port's the last sync's.

The partial refresh decides per owned row on ``‖x − base‖² > band² ·
‖base‖²``; the two packages sum those squares in other orders, so a row
within an ulp of the boundary could fall either way.  The shipped counts
are therefore compared exactly only at the band's extremes (0, where
every drifted row ships, and 1e12, where none does) and at band 1.5 on
this input, where no row's ratio sits within 1e-4 of the band (the test
checks that margin).
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.controller import CommController as RefController
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models.gcn import params_from_jax
from sgcn_tpu_torch.ops import pspmm
from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesReplica,
                                          pspmm_tiles_replica,
                                          pspmm_tiles_stale, pspmm_tiles_sym,
                                          spmm_tiles_fused)
from sgcn_tpu_torch.parallel import build_comm_plan
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
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    plan = build_comm_plan(normalize_adjacency(a), pv, K)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    return {"plan": plan, "ref_plan": ref_plan,
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


COMPOSED = dict(replica_budget=BUDGET, halo_staleness=1)


# -------------------------------------------------- the composed mode
@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_composed_sync_every_1_equals_exact_bit_for_bit(cora, init,
                                                        schedule):
    """``sync_every=1``: every composed step is the stale mode's sync
    step, the exact exchange consumed fresh — losses and weights equal
    the exact trainer's bit for bit, both transports."""
    exact, want = _trained(cora, init, comm_schedule=schedule)
    comp, got = _trained(cora, init, sync_every=1, comm_schedule=schedule,
                         **COMPOSED)
    assert got == want
    for a, b in zip(comp.params, exact.params):
        assert torch.equal(a, b)
    rep = comp.stats.report()
    assert rep["hidden_exchanges"] == rep["replica_exchanges"] == 0


@pytest.mark.parametrize("sync_every", [0, 3])
def test_composed_ring_equals_composed_a2a_bit_for_bit(cora, init,
                                                       sync_every):
    """The composed ring carry holds the a2a carry's rows at their ring
    positions: 7 steps give equal losses and weights."""
    (a2a, la), (ring, lr) = (
        _trained(cora, init, steps=7, sync_every=sync_every,
                 comm_schedule=s, **COMPOSED) for s in ("a2a", "ragged"))
    assert la == lr
    for a, b in zip(a2a.params, ring.params):
        assert torch.equal(a, b)


def _named(tr, leaf, layer_rows):
    """A reference-layout a2a halo table's named rows (ranks below each
    part's halo count); the ring's envelope as it is."""
    if tr.comm_schedule == "ragged":
        return leaf
    m = np.arange(leaf.shape[1])[None, :] < layer_rows[:, None]
    return leaf[m]


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_composed_trainer_matches_the_reference(cora, schedule):
    """Six composed steps (``sync_every`` 2): losses and weights within
    rtol 1e-5 / atol 1e-6 of the reference's composed trainer; the stale
    carries (its ``halo_carry`` subsumes the replicas in both packages),
    on the named halo rows, each within 1e-5 of its largest value
    (observed ≤ 7e-6); ``CommStats`` state and report equal — the stale
    steps booked hidden and replica (``hidden_replica_exchanges``)."""
    kw = dict(sync_every=2, comm_schedule=schedule, **COMPOSED)
    ref = _ref(cora, **kw)
    port = _port(cora, _np(ref.params), **kw)
    want = [ref.step(cora["ref_data"]) for _ in range(STEPS)]
    got = [port.step(cora["data"]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, **F32)
    for a, b in zip(port.params, _np(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b, **F32)
    state, leaves = port.resume_state()
    ref_state, ref_leaves = ref.resume_state()
    assert state["carry"] == ref_state["carry"] == "halo_carry"
    assert [x.shape for x in leaves] == [x.shape for x in ref_leaves]
    counts = cora["plan"].halo_counts
    for i, (x, y) in enumerate(zip(leaves[2:], ref_leaves[2:])):
        x, y = _named(port, x, counts), _named(port, y, counts)
        err = float(np.abs(x - y).max()) / float(np.abs(y).max())
        print(f"{schedule} carry leaf {i + 2}: {err:.3g} of its largest")
        assert err <= 1e-5
    assert port.stats.state() == ref.stats.state()
    assert port.stats.report() == ref.stats.report()
    assert port.stats.state()["hidden_replica_exchanges"] == 2 * 2 * 3


def test_composed_step_reads_the_carry_then_packs_the_kept_rows(cora, init):
    """One composed stale aggregation: the sum reads the GIVEN carry (the
    fused launch on the previous layout), then the kept rows of ``x``
    are written into that same carry — the replica slots and the pads
    keep their values; the backward sums the given gradient carry, then
    packs the kept rows of ``g`` into it and hands it to the holder.  A
    sync step is the exact op bit for bit."""
    tr = _port(cora, init, **COMPOSED)
    pa, st = tr.pa, tr.setup.fwd_static
    plan = cora["plan"]
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((K, plan.b, 16)),
                     dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.standard_normal((K, plan.b, 16)),
                     dtype=torch.float32)
    lt = (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"])
    ht = (pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"])
    cls = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    keep = (pa["keep_recv_src"], pa["keep_recv_dst"])
    shape = (K, K * plan.s, 16)
    carry0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    gcarry0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    carry, gcarry = carry0.clone(), gcarry0.clone()
    holder = [None]
    out, nxt = pspmm_tiles_stale(x, carry, gcarry, pa["recv_src"], *lt, *ht,
                                 *cls, gholder=holder, keep=keep)
    (gx,) = torch.autograd.grad(out, x, g)
    assert nxt is carry
    assert torch.equal(out, spmm_tiles_fused(lt, x.detach(), ht, carry0,
                                             *cls[1:], cls[0]))
    assert torch.equal(gx, spmm_tiles_fused(lt, g, ht, gcarry0, *cls[1:],
                                            cls[0]))
    recv = pspmm.exchange_recv(x.detach(), pa["recv_src"]).reshape(-1, 16)
    kept = plan.keep_recv_dst.astype(np.int64)
    other = np.setdiff1d(np.arange(recv.shape[0]), kept)
    assert torch.equal(nxt.reshape(-1, 16)[kept], recv[kept])
    assert torch.equal(nxt.reshape(-1, 16)[other],
                       carry0.reshape(-1, 16)[other])
    grecv = pspmm.exchange_recv(g, pa["recv_src"]).reshape(-1, 16)
    assert holder[0] is gcarry
    assert torch.equal(gcarry.reshape(-1, 16)[kept], grecv[kept])
    assert torch.equal(gcarry.reshape(-1, 16)[other],
                       gcarry0.reshape(-1, 16)[other])
    out_s, _ = pspmm_tiles_stale(x, carry0, gcarry0, pa["recv_src"], *lt,
                                 *ht, *cls, fresh=True, gholder=[None],
                                 keep=keep)
    assert torch.equal(out_s, pspmm_tiles_sym(x, pa["recv_src"], *lt, *ht,
                                              *cls))
    assert PspmmTilesReplica.backward_launches == 0   # CPU: no launches


# -------------------------------------------------- the partial refresh
@pytest.fixture(scope="module")
def partial_runs(cora):
    cache = {}

    def get(case):
        if case not in cache:
            kw = dict(PARTIAL[case])
            ref = _ref(cora, **kw)
            port = _port(cora, _np(ref.params), **kw)
            want = [ref.step(cora["ref_data"]) for _ in range(STEPS)]
            got = [port.step(cora["data"]) for _ in range(STEPS)]
            cache[case] = (ref, port, want, got)
        return cache[case]
    return get


PARTIAL = {
    "band1.5": dict(replica_budget=BUDGET, sync_every=2, refresh_band=1.5),
    "band0": dict(replica_budget=BUDGET, sync_every=2, refresh_band=0.0),
    "band1e12": dict(replica_budget=BUDGET, sync_every=2,
                     refresh_band=1e12),
    "band0-halo_dtype": dict(replica_budget=BUDGET, sync_every=2,
                             refresh_band=0.0, halo_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(PARTIAL))
def test_partial_refresh_trainer_matches_the_reference(partial_runs, case):
    """Six steps (step 0 full, steps 2 and 4 partial): losses within rtol
    1e-5 / atol 1e-6 of the reference's; weights too (under
    ``halo_dtype``, whose wire rounding splits of the ulp-different rows
    move a weight by up to 6.6e-6: within atol 2e-5); the carries in its
    layout (greps, rep_base, reps) within 1e-5 of their largest value
    (``halo_dtype``: one bf16 ulp, 2^-7); ``CommStats`` state and report
    equal — the side channel booked at the rows really shipped, which are
    the reference's count exactly."""
    ref, port, want, got = partial_runs(case)
    bf16 = "halo_dtype" in case
    np.testing.assert_allclose(got, want, **F32)
    wtol = dict(rtol=1e-5, atol=2e-5) if bf16 else F32
    for a, b in zip(port.params, _np(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b, **wtol)
    state, leaves = port.resume_state()
    _, ref_leaves = ref.resume_state()
    assert [x.shape for x in leaves] == [x.shape for x in ref_leaves]
    assert port.carry_leaf_shapes() == [x.shape for x in ref_leaves]
    for i, (x, y) in enumerate(zip(leaves, ref_leaves)):
        err = float(np.abs(x - y).max()) / max(float(np.abs(y).max()), 1e-30)
        print(f"{case} carry leaf {i} {y.shape}: {err:.3g} of its largest")
        assert err <= (2.0 ** -7 if bf16 else 1e-5), i
    assert port.stats.state() == ref.stats.state()
    assert port.stats.report() == ref.stats.report()
    assert port.stats.state()["partial_refresh_steps"] == 2


def test_partial_refresh_band_extremes(partial_runs, cora):
    """Band 0 ships every drifted replica copy — both refreshes every one
    of the ``replica_send_saving`` copies per layer, forward and
    backward; a band of 1e12 ships none, and the replica rows keep their
    step-0 values."""
    saving = cora["plan"].replica_send_saving
    _, port, _, _ = partial_runs("band0")
    assert port.stats.report()["partial_refresh_rows_total"] == \
        2 * 2 * len(WIDTHS) * saving
    _, port, _, _ = partial_runs("band1e12")
    assert port.stats.report()["partial_refresh_rows_total"] == 0
    tr, _ = _trained(cora, _np(_ref(cora).params), steps=1,
                     **PARTIAL["band1e12"])
    reps0 = [tr._rep_rows(x) for x in tr.replica_carry["halos"]]
    for _ in range(4):
        tr.step(cora["data"])
        assert tr.last_refresh_rows in (None, [0, 0])
    for a, x in zip(reps0, tr.replica_carry["halos"]):
        assert torch.equal(a, tr._rep_rows(x))


def test_partial_refresh_band_margin_and_counts(cora, init):
    """At band 1.5 on this input every owned replicated row's layer-0
    drift ratio ``‖x − base‖ / ‖base‖`` sits more than 1e-4 from the band
    at both partial steps (observed ≥ 4.5e-3: the two packages'
    summation orders cannot flip a row; layer 1's counts are held equal
    to the reference's by the parity test), and the port ships strictly
    fewer rows than a full refresh and more than none."""
    tr = _port(cora, init, **PARTIAL["band1.5"])
    margins = []
    for step in range(STEPS):
        if step in (2, 4):
            x = tr.model.weights
            h0 = cora["data"].h0
            xw = (h0 @ x[0]).detach()              # layer 0 is project-first
            plan = tr.plan
            rows = torch.as_tensor(plan.rep_rows_flat.astype(np.int64))
            xr = xw.reshape(-1, xw.shape[-1])[rows.reshape(-1)].reshape(
                rows.shape + (xw.shape[-1],))
            base = tr.replica_carry["rep_base"][0]
            valid = torch.as_tensor(plan.rep_row_valid) > 0
            ratio = (torch.linalg.norm(xr - base, dim=-1)
                     / torch.linalg.norm(base, dim=-1))[valid]
            margins.append(float((ratio - 1.5).abs().min()))
        tr.step(cora["data"])
    print(f"band 1.5: smallest |ratio − band| at the partial steps, layer "
          f"0: {margins}")
    assert min(margins) > 1e-4
    rows = tr.stats.report()["partial_refresh_rows_total"]
    assert 0 < rows < 2 * 2 * len(WIDTHS) * tr.plan.replica_send_saving


def test_partial_refresh_bf16_lockstep(cora, init):
    """Under ``halo_dtype='bfloat16'`` every consumer's replica row equals
    its owner's baseline row bit for bit after any sequence of partial
    refreshes (the reference's ``test_partial_refresh_bf16_lockstep``):
    both start from the wire-rounded rows of step 0 and add the same
    rounded increments, in float32."""
    tr, _ = _trained(cora, init, steps=5, **PARTIAL["band0-halo_dtype"])
    plan = tr.plan
    assert tr.replica_carry["halos"][0].dtype == torch.float32
    pos = plan.rep_base_flat.astype(np.int64)
    for layer in range(len(WIDTHS)):
        carry = tr.replica_carry["halos"][layer]
        f = carry.shape[-1]
        reps = carry.reshape(-1, f)[torch.as_tensor(
            plan.rep_recv_dst.astype(np.int64))]
        bases = tr.replica_carry["rep_base"][layer].reshape(-1, f)[
            torch.as_tensor(pos)]
        assert torch.equal(reps, bases)


def test_partial_refresh_op_side_channels(cora, init):
    """One partial aggregation on its own: the forward's replica slots
    become ``rep + round(Δ·mask)`` and the baselines ``base + the same``,
    the kept slots this step's rows; the backward's replica slots take
    the owner's fresh gradient row where the forward refreshed and keep
    theirs elsewhere; ``nship`` counts the refreshed copies."""
    tr = _port(cora, init, **PARTIAL["band1.5"])
    pa, st = tr.pa, tr.setup.fwd_static
    plan = cora["plan"]
    rng = np.random.default_rng(1)
    f = 16
    x = torch.tensor(rng.standard_normal((K, plan.b, f)),
                     dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.standard_normal((K, plan.b, f)),
                     dtype=torch.float32)
    shape = (K, K * plan.s, f)
    carry0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    gcarry0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    # baselines: the owners' rows, half of them far off (they refresh)
    rows = plan.rep_rows_flat.astype(np.int64)
    xr = x.detach().reshape(-1, f)[torch.as_tensor(rows.reshape(-1))]
    base = xr.reshape(K, plan.rs, f).clone()
    base[:, ::2] *= 3.0
    side = {n: pa[n] for n in ("rep_rows_flat", "rep_row_valid",
                               "rep_base_flat", "rep_src_flat")}
    side["rep_dst"] = pa["rep_recv_dst"]
    tiles = (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
             pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"],
             st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    carry, gcarry, holder = carry0.clone(), gcarry0.clone(), [None]
    out, nxt, bnext, nship = pspmm_tiles_replica(
        x, carry, gcarry, (pa["keep_recv_src"], pa["keep_recv_dst"]),
        tiles, "partial",
        gholder=holder, base=base, side=side, band=0.1)
    (gx,) = torch.autograd.grad(out, x, g)
    valid = torch.as_tensor(plan.rep_row_valid) > 0
    mask = (torch.arange(plan.rs)[None, :] % 2 == 0) & valid
    assert int(nship) == int(mask.reshape(-1)[torch.as_tensor(
        plan.rep_base_flat.astype(np.int64))].sum()) > 0
    qinc = (xr.reshape(K, plan.rs, f) - base) * mask[..., None]
    assert torch.equal(bnext, base + qinc)
    dst = torch.as_tensor(plan.rep_recv_dst.astype(np.int64))
    bpos = torch.as_tensor(plan.rep_base_flat.astype(np.int64))
    assert torch.equal(nxt.reshape(-1, f)[dst],
                       carry0.reshape(-1, f)[dst]
                       + qinc.reshape(-1, f)[bpos])
    kept = torch.as_tensor(plan.keep_recv_dst.astype(np.int64))
    recv = pspmm.exchange_recv(x.detach(), pa["recv_src"]).reshape(-1, f)
    assert torch.equal(nxt.reshape(-1, f)[kept], recv[kept])
    assert torch.equal(out, spmm_tiles_fused(tiles[:3], x.detach(),
                                             tiles[3:6], nxt, tiles[7],
                                             tiles[8], tiles[6]))
    act = mask.reshape(-1)[bpos]
    src = torch.as_tensor(plan.rep_src_flat.astype(np.int64))
    grep = holder[0].reshape(-1, f)[dst]
    assert torch.equal(grep[act], g.reshape(-1, f)[src][act])
    assert torch.equal(grep[~act], gcarry0.reshape(-1, f)[dst][~act])
    assert torch.equal(gx, spmm_tiles_fused(tiles[:3], g, tiles[3:6],
                                            holder[0], tiles[7], tiles[8],
                                            tiles[6]))


# ---------------------------------------------- gauges and the controller
@pytest.mark.parametrize("case", ["replica", "partial"])
def test_replica_drift_gauges_equal_the_references(cora, tmp_path, case):
    """The replica drift gauges of every step (the reference's through
    its run recorder): ``replica_drift_rms`` and ``replica_drift_rel``
    within rtol 1e-3 (the sums run in other orders), zero on replica
    steps and (the initializing refresh) step 0."""
    from sgcn_tpu.obs import RunRecorder, load_run
    kw = dict(replica_budget=BUDGET, sync_every=2)
    if case == "partial":
        kw["refresh_band"] = 0.1
    ref = _ref(cora, **kw)
    port = _port(cora, _np(ref.params), **kw)
    port.drift_gauges = True
    rec = RunRecorder(str(tmp_path), config={"model": "gcn"})
    ref.attach_recorder(rec)
    got = []
    for _ in range(5):
        ref.step(cora["ref_data"])
        port.step(cora["data"])
        g = port.last_gauges
        d, r = np.sqrt(g["drift_sq"]), np.sqrt(g["ref_sq"])
        got.append((d, d / r))
    rec.close()
    got[0] = (np.zeros_like(got[0][0]), np.zeros_like(got[0][1]))
    for i, ((d, rel), ev) in enumerate(zip(got, load_run(
            str(tmp_path)).steps())):
        want = ev["replica"]
        np.testing.assert_allclose(d, want["replica_drift_rms"], rtol=1e-3,
                                   atol=1e-12)
        if i:
            np.testing.assert_allclose(rel, want["replica_drift_rel"],
                                       rtol=1e-3, atol=1e-12)
        if i % 2:
            assert np.all(d == 0)
    assert np.all(got[2][0] > 0)


def test_controller_retunes_the_replica_mode_and_the_cli(cora, init, capsys):
    """``comm_schedule='auto'`` with ``sync_every`` 2: the controller
    observes each non-initializing refresh of the replica mode; its
    decisions equal a reference controller fed the port's measured drift.
    The CLI with ``--replica-budget 24 --halo-staleness 1`` prints the
    composed run's blocks."""
    tr = _port(cora, init, replica_budget=BUDGET, sync_every=2,
               comm_schedule="auto")
    ref_ctl = RefController(2)
    for _ in range(8):
        idx, sync = tr._rep_step_idx, tr._replica_sync_due()
        tr.step(cora["data"])
        if sync and idx:
            g = tr.last_gauges
            ref_ctl.observe(idx, float(np.max(np.sqrt(g["drift_sq"])
                                              / np.sqrt(g["ref_sq"]))))
    assert tr.comm_decision["controller"] == ref_ctl.log()
    assert tr.sync_every == ref_ctl.sync_every
    train_main(CLI + ["--replica-budget", str(BUDGET), "--halo-staleness",
                      "1", "--sync-every", "2", "--epochs", "3"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["replica_budget"] == BUDGET and rep["halo_staleness"] == 1
    # steps 1 and 3 stale (hidden, replica-booked), 0 and 2 syncs
    assert rep["hidden_replica_exchanges"] == rep["hidden_exchanges"] == 8


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("case", ["composed-ragged", "partial"])
def test_port_save_then_resume_equals_uninterrupted(cora, init, tmp_path,
                                                    case):
    """A composed ring run and a partial-refresh run, ``sync_every`` 3,
    saved after step 2 and resumed in a fresh trainer: steps 3–6 give
    losses, weights and comm gauges ``==`` the uninterrupted run's."""
    kw = (dict(sync_every=3, comm_schedule="ragged", **COMPOSED)
          if case.startswith("composed") else
          dict(replica_budget=BUDGET, sync_every=3, refresh_band=0.1))
    full, want = _trained(cora, init, **kw)
    part, _ = _trained(cora, init, steps=2, **kw)
    path = save_checkpoint(part, str(tmp_path / "c2"), step=2)
    res = _port(cora, init, **kw)
    assert load_checkpoint(res, path) == 2
    assert res.last_restore_partial is False
    got = [res.step(cora["data"]) for _ in range(STEPS - 2)]
    assert got == want[2:]
    for a, b in zip(res.params, full.params):
        assert torch.equal(a, b)
    assert res.stats.state() == full.stats.state()
    for x, y in zip(res.resume_state()[1], full.resume_state()[1]):
        assert x.shape == y.shape
