"""The carried modes on the rank runtime (ROADMAP A2c's second half): the
stale halo with its exchange in flight across the step, the halo-delta
cache, the sync controller, hot-halo replicas and the partial refresh,
one process per part, against the stacked layout and the reference's
trainers, on cora2708 under its 8-part hp partition with 8 gloo ranks.

One module-scoped spawn (``tests/torch_rank_child.py::
carried_ranks_main``) runs every rank check, then the train CLI's jobs
under ``torchrun``'s variables.  Per rank: one carried GCN layer, a sync
step then a carried one from zero carries, in each ``OP_CASES`` mode —
its rows, its VJP and the next feature and gradient carries (and the
senders' delta baselines, the partial refresh's baselines) must equal the
stacked layer's row for the rank's part bit for bit: the same exchange
into the same receive layout, the same launch.  Then five training steps
of GCN 1433 → 16 → 7 with ``sync_every=2`` per case against the stacked
trainer (the loss's count and the weight gradients are all-reduced in
another order: the float32 bounds of ``tests/test_torch_ranks_gat.py``)
and the reference's stale and replica trainers (C3's ``optax.scale(1/k)``),
``sync_every=1`` against the exact rank trainer and the ring against the
a2a bit for bit, the controller's log, the drift gauges and the partial
refresh's counts, the in-flight exchanges, the refusals, and the CLI.
"""

import contextlib
import io
import json
import os
import pickle
import tempfile

import numpy as np
import optax
import pytest

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs.recorder import load_run
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.fullbatch import CARRY_CHECKPOINT_DEFERRAL

import torch_rank_child as child

K = 8
RUN_CASES = list(child.CARRIED_CASES) + list(child.EXACT_CASES)
# the reference's trainer per case, with C3's optimizer scale
REF_CASES = ("stale-a2a", "stale-delta", "replica-a2a", "replica-stale",
             "partial")
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "SLURM_NPROCS", "SLURM_PROCID",
               "SLURM_LOCALID", "SLURM_JOBID", "SLURM_NTASKS_PER_NODE",
               "SLURM_NNODES", "SGCN_COORDINATOR")
BASE = ["--npz", child.NPZ, "--normalize", "-p",
        os.path.join(child.FIX, "cora2708.8.hp"), "-s", "8", "-l", "2",
        "--hidden", "16", "--epochs", "5", "--warmup", "0", "--device",
        "cpu"]
CLI_RUNS = {"stale": ["--halo-staleness", "1", "--halo-delta",
                      "--sync-every", "2"],
            "replica": ["--replica-budget", "auto", "--sync-every", "2"],
            "controller": ["--halo-staleness", "1", "--sync-every", "2",
                           "--comm-schedule", "auto"]}
# the same runs under --metrics-out: rank 0 records, and every rank
# computes the gauges that its step events read (a collective)
CLI_METRICS = {"stale-metrics": "stale", "replica-metrics": "replica"}
CLI_EXITS = {"stale-ckpt": ["--halo-staleness", "1", "--save-checkpoint",
                            os.path.join(os.sep, "nonexistent", "s.npz")],
             "replica-ckpt": ["--replica-budget", "50", "--checkpoint-dir",
                              os.path.join(os.sep, "nonexistent", "ck")]}


def _np(params):
    return [np.asarray(w) for w in params]


def _controller_parts(log):
    """A controller log without each retune's measured drift, and those
    drifts: the ranks sum the gauges in another order."""
    if log is None:
        return None, []
    rest = [{k: v for k, v in r.items() if k != "drift_rel_max"}
            for r in log["retunes"]]
    return ({**log, "retunes": rest},
            [r["drift_rel_max"] for r in log["retunes"]])


def _step_blocks(run_dir):
    """The drift or replica block of each step event of a run
    directory."""
    return [e.get("drift") or e.get("replica")
            for e in load_run(run_dir).steps()]


def _epoch_losses(stdout):
    """The per-step losses ``fit`` prints (``epoch i: loss x``)."""
    return [float(x.split()[-1]) for x in stdout.splitlines()
            if x.startswith("epoch ")]


@pytest.fixture(scope="module")
def cora():
    """The plan, data and the reference's initial weights (seed 3)."""
    _ahat, feats, labels, pv, plan = child.cora_plan("cora2708.8.hp")
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    p0 = _np(RefTrainer(ref_plan, fin=child.FIN, widths=child.WIDTHS,
                        seed=3).params)
    return {"feats": feats, "labels": labels, "plan": plan,
            "ref_plan": ref_plan, "p0": p0}


@pytest.fixture(scope="module")
def ranks(cora):
    """Every rank's results (``carried_ranks_main``), from one spawn of
    8: the carried checks, then the CLI jobs; under rank 0's
    ``"metrics"`` the step blocks of each ``CLI_METRICS`` job's run
    directory (rank 0 records)."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(cora["p0"], fh)
        jobs = {name: BASE + extra
                for name, extra in {**CLI_RUNS, **CLI_EXITS}.items()}
        jobs.update({name: BASE + CLI_RUNS[run] + [
            "--metrics-out", os.path.join(out, name)]
            for name, run in CLI_METRICS.items()})
        with open(os.path.join(out, "jobs.pkl"), "wb") as fh:
            pickle.dump(jobs, fh)
        res = child.spawn_ranks(child.carried_ranks_main, K, out)
        res[0]["metrics"] = {name: _step_blocks(os.path.join(out, name))
                             for name in CLI_METRICS}
        return res


@pytest.fixture(scope="module")
def stacked(cora):
    """The stacked layers on the same inputs and the stacked trainer's
    runs of every case, from the same weights."""
    plan = cora["plan"]
    hs, gs, w = child.carried_op_inputs(plan)
    out = {"op": {}, "runs": {}}
    for case in child.OP_CASES:
        tr = FullBatchTrainer(plan, fin=child.LAYER_F,
                              widths=[child.LAYER_F], params=[w],
                              device="cpu", **child.carried_kwargs(case))
        out["op"][case] = child.carried_layer_steps(tr, hs, gs)
    data = make_train_data(plan, cora["feats"], cora["labels"])
    for case in RUN_CASES:
        tr = FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                              lr=child.LR, params=cora["p0"], device="cpu",
                              **child.carried_kwargs(case))
        out["runs"][case] = child.carried_run(tr, data)
    return out


@pytest.fixture(scope="module")
def reference(cora):
    """The reference's trainer per ``REF_CASES`` case, five steps from
    the same weights, its optimizer scaled by 1/k (ROADMAP C3, measured
    in the stale and replica modes by ``tests/test_torch_stale.py`` and
    ``tests/test_torch_replica_stale.py``)."""
    rdata = ref_make_train_data(cora["ref_plan"], cora["feats"],
                                cora["labels"])
    out = {}
    for case in REF_CASES:
        kw = child.carried_kwargs(case)
        ref = RefTrainer(cora["ref_plan"], fin=child.FIN,
                         widths=child.WIDTHS, seed=3, optimizer=optax.chain(
                             optax.scale(1.0 / K), optax.adam(child.LR)),
                         **kw)
        out[case] = [ref.step(rdata) for _ in range(child.CARRIED_STEPS)]
    return out


@pytest.fixture(scope="module")
def one_process_cli():
    """The one-process CLI's report of each ``CLI_RUNS`` job, and under
    ``"metrics"`` the step blocks of each ``CLI_METRICS`` job's run
    directory."""
    env = {v: os.environ.pop(v) for v in LAUNCH_VARS if v in os.environ}
    out = {"metrics": {}}
    try:
        for name, extra in CLI_RUNS.items():
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                train_main(BASE + extra)
            out[name] = text.getvalue()
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
            for name, run in CLI_METRICS.items():
                with contextlib.redirect_stdout(io.StringIO()):
                    train_main(BASE + CLI_RUNS[run] + [
                        "--metrics-out", os.path.join(d, name)])
                out["metrics"][name] = _step_blocks(os.path.join(d, name))
    finally:
        os.environ.update(env)
    return out


# ------------------------------------------------------------ one layer
@pytest.mark.parametrize("case", child.OP_CASES)
def test_one_layer_equals_stacked(ranks, stacked, case):
    """A sync step, then a carried one (a stale step, a replica step, a
    composed step, a partial refresh): each rank's rows, VJP in ``h``,
    next feature and gradient carries, delta baselines and refresh
    baselines equal the stacked layer's row for its part bit for bit (a
    rank's refresh baselines may hold one more row, never valid, which
    stays 0: ``parallel/proxy.py::_spare_row``)."""
    for step in range(2):
        want = stacked["op"][case][step]
        for r in range(K):
            got = ranks[r]["op"][case][step]
            assert sorted(got) == sorted(want)
            for key, value in got.items():
                if key in ("nship", "qerr"):
                    continue
                rows = want[key][r].shape[0]
                np.testing.assert_array_equal(value[0][:rows], want[key][r],
                                              err_msg=f"{key} rank {r}")
                assert value[0].shape[1:] == want[key][r].shape[1:]
                assert value[0].shape[0] <= rows + (key == "rep_base")
                assert not value[0][rows:].any()


@pytest.mark.parametrize("case", ["stale-delta", "stale-delta-ring"])
def test_layer_quantization_gauge_sums_to_the_stacked_one(ranks, stacked,
                                                          case):
    """The halo-delta cache's residual gauge on the carried step: each
    rank sums its own send pack against its baselines; the sum over the
    ranks is the stacked gauge over the receive layout within rtol 1e-6
    (the same squares, summed in float64 in another order); 0 on the
    sync step."""
    for step in range(2):
        want = stacked["op"][case][step]["qerr"]
        got = [ranks[r]["op"][case][step]["qerr"] for r in range(K)]
        assert (want > 0) == (step == 1)
        np.testing.assert_allclose(sum(got), want, rtol=1e-6)


def test_partial_layer_nship_sums_to_the_stacked_count(ranks, stacked):
    """The partial refresh's forward side channel: each rank counts the
    slots it shipped a row in; their sum over the ranks is the stacked
    layer's count of refreshed replica copies."""
    want = stacked["op"]["partial"][1]["nship"]
    got = [ranks[r]["op"]["partial"][1]["nship"] for r in range(K)]
    print(f"per rank {got}, sum {sum(got)}, stacked {want}")
    assert want > 0 and sum(got) == want


# ------------------------------------------------------------- training
@pytest.mark.parametrize("case", RUN_CASES)
def test_every_rank_holds_the_same_bits(ranks, case):
    """After five steps every rank holds rank 0's losses, weights, sync
    interval and refresh counts bit for bit."""
    want = ranks[0]["runs"][case]
    for r in range(1, K):
        got = ranks[r]["runs"][case]
        assert got["losses"] == want["losses"]
        assert got["rows"] == want["rows"]
        assert got["sync_every"] == want["sync_every"]
        for a, b in zip(got["params"], want["params"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", RUN_CASES)
def test_five_steps_track_the_stacked_trainer(ranks, stacked, case):
    """Losses within rtol 1e-6 of the stacked trainer's, the weights
    within 1e-5 for 99 % of the entries and 5e-3 for all (the float32
    bounds of ``tests/test_torch_ranks_gat.py``)."""
    got, want = ranks[0]["runs"][case], stacked["runs"][case]
    gaps = [float(np.abs(a - b).max())
            for a, b in zip(got["params"], want["params"])]
    print(f"{case}: ranks {got['losses']} stacked {want['losses']}; max "
          f"weight gap {max(gaps):.3g}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for a, b in zip(got["params"], want["params"]):
        gap = np.abs(a - b)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


@pytest.mark.parametrize("case", REF_CASES)
def test_five_steps_track_the_reference_trainer(ranks, reference, case):
    """Rank 0's losses within rtol 1e-5 of the reference's stale and
    replica trainers from the same weights."""
    got, want = ranks[0]["runs"][case]["losses"], reference[case]
    print(f"{case}: ranks {got} reference {want}")
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("case", ["stale-se1", "replica-se1"])
def test_sync_every_1_equals_exact_bit_for_bit(ranks, case):
    """A sync every step is the exact rank trainer, losses and weights
    bit for bit (one fused launch where the exact path makes two family
    launches of the same arithmetic)."""
    got, want = ranks[0]["runs"][case], ranks[0]["runs"]["exact"]
    assert got["losses"] == want["losses"]
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ring,a2a", [("stale-ring", "stale-a2a"),
                                      ("stale-delta-ring", "stale-delta"),
                                      ("replica-ring", "replica-a2a")])
def test_ring_equals_a2a_bit_for_bit(ranks, ring, a2a):
    """On ranks the ring's carries hold the a2a's rows and the launches
    walk the same slot order: the same losses and weights bit for
    bit."""
    got, want = ranks[0]["runs"][ring], ranks[0]["runs"][a2a]
    assert got["losses"] == want["losses"]
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b)


def test_controller_log_equals_the_stacked_trainers(ranks, stacked):
    """The controller decides on the all-reduced gauges and rank 0's
    ``sync_every`` is broadcast: its log and the interval in force equal
    the stacked trainer's, each retune's measured drift within rtol 1e-6
    (the gauges' sums run over the ranks in another order)."""
    got, want = ranks[0]["runs"]["controller"], stacked["runs"]["controller"]
    print(f"controller: {got['controller']}")
    (g_log, g_drift), (w_log, w_drift) = _controller_parts(
        got["controller"]), _controller_parts(want["controller"])
    assert g_log == w_log and g_log["retunes"]
    np.testing.assert_allclose(g_drift, w_drift, rtol=1e-6)
    assert got["sync_every"] == want["sync_every"]


@pytest.mark.parametrize("case", ["stale-a2a", "stale-delta", "replica-a2a",
                                  "replica-stale", "partial"])
def test_drift_gauges_track_the_stacked_ones(ranks, stacked, case):
    """Each step's drift gauges, summed per rank and all-reduced, within
    rtol 1e-6 of the stacked trainer's.  Under delta the quantization
    residual is held to rtol 1e-4 here (observed 4.3e-6): it sums the
    bf16 rounding residual of rows computed from weights that differ
    from the stacked run's by the all-reduce order (≈ 1e-7), and a
    rounding split moves it; on equal inputs it is held to rtol 1e-6
    (``test_layer_quantization_gauge_sums_to_the_stacked_one``)."""
    got, want = ranks[0]["runs"][case], stacked["runs"][case]
    for g, w in zip(got["gauges"], want["gauges"]):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(
                g[key], w[key], rtol=1e-4 if key == "qerr_sq" else 1e-6,
                err_msg=key)


def test_partial_refresh_counts_equal_the_stacked_ones(ranks, stacked):
    """Each partial refresh step's refreshed copies per layer, every
    rank's count all-reduced, equal the stacked count."""
    got, want = ranks[0]["runs"]["partial"], stacked["runs"]["partial"]
    print(f"partial refresh rows per step {got['rows']}")
    assert got["rows"] == want["rows"]
    assert any(rows for rows in got["rows"])


@pytest.mark.parametrize("case", ["stale-a2a", "stale-delta", "replica-ring",
                                  "replica-stale", "partial"])
def test_job_report_equals_the_stacked_report(ranks, stacked, case):
    """The comm report of the whole job (the full plan's figures, the
    byte and partial-refresh totals summed over the ranks) equals the
    stacked trainer's."""
    got, want = ranks[0]["runs"][case], stacked["runs"][case]
    assert got["report"] == want["report"]


def test_stale_exchange_waits_only_at_the_next_read(ranks):
    """A stale step's exchanges, forward and backward, are still pending
    when the step returns (step 2 of a ``sync_every=2`` run), and are
    waited on by the next step's read of the carry (step 3); a sync step
    (1, 3) leaves none pending."""
    for r in range(K):
        flight = ranks[r]["flight"]
        assert [all(f["pending"]) for f in flight] == [False, True, False]
        assert not any(flight[0]["pending"]) and \
            not any(flight[2]["pending"])
        assert flight[2]["before"] and all(flight[2]["before"])


def test_carried_checkpoints_defer_and_directed_plans_raise(ranks):
    """On 8 ranks a stale or replica trainer's ``resume_state`` raises
    the reference's deferral (the carry is sharded over the ranks); the
    stale mode on an asymmetric plan raises the reference's own gate, as
    on one process (directed plans run on ranks in exact mode)."""
    for r in range(K):
        errs = ranks[r]["errors"]
        assert errs["stale-ckpt"] == CARRY_CHECKPOINT_DEFERRAL
        assert errs["replica-ckpt"] == CARRY_CHECKPOINT_DEFERRAL
        assert errs["asymmetric"].startswith(
            "halo_staleness=1 uses the symmetric-Â custom backward")


def test_recorder_on_ranks_needs_the_gauges_on_every_rank(ranks):
    """A carried trainer on 8 ranks refuses a recorder until
    ``drift_gauges`` is set: its step events read the gauges, which every
    rank all-reduces, and a recorder lives on one rank."""
    for r in range(K):
        assert "drift_gauges=True on every rank" in \
            ranks[r]["errors"]["recorder"]


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("job", sorted(CLI_RUNS))
def test_cli_on_ranks_tracks_the_one_process_cli(ranks, one_process_cli,
                                                 job):
    """``main`` on 8 ranks under ``torchrun``'s variables: rank 0 prints
    per-step losses (six decimals) within rtol 1e-6 of the one-process
    CLI's and a report with the same comm figures, stale and replica
    blocks and controller log (its measured drifts within rtol 1e-6);
    the other ranks print nothing."""
    text = ranks[0]["cli"][job]["stdout"]
    assert ranks[0]["cli"][job]["exit"] is None
    rep = json.loads(text.strip().splitlines()[-1])
    want_text = one_process_cli[job]
    want = json.loads(want_text.strip().splitlines()[-1])
    for r in range(1, K):
        assert ranks[r]["cli"][job] == {"stdout": "", "exit": None}
    got_l, want_l = _epoch_losses(text), _epoch_losses(want_text)
    print(f"{job}: ranks {got_l} one process {want_l}")
    assert len(got_l) == 5
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    for key in ("total_send_volume", "max_send_volume", "total_recv_volume",
                "exchanges", "hidden_exchanges", "wire_rows_total",
                "comm_schedule", "halo_bytes_wire_total", "sync_every",
                "halo_staleness", "halo_delta", "replica_budget",
                "replica_exchanges", "replica_auto"):
        assert rep.get(key) == want.get(key), key
    (g_log, g_drift), (w_log, w_drift) = _controller_parts(
        rep.get("controller")), _controller_parts(want.get("controller"))
    assert g_log == w_log
    np.testing.assert_allclose(g_drift, w_drift, rtol=1e-6)


@pytest.mark.parametrize("job", sorted(CLI_EXITS))
def test_cli_carried_checkpoint_on_ranks_exits(ranks, job):
    """``--save-checkpoint`` or ``--checkpoint-dir`` in a carried mode on
    8 ranks exits before any step with the reference's deferral, on
    every rank, printing nothing."""
    for r in range(K):
        got = ranks[r]["cli"][job]
        assert got == {"stdout": "", "exit": CARRY_CHECKPOINT_DEFERRAL}


@pytest.mark.parametrize("job", sorted(CLI_METRICS))
def test_cli_metrics_on_ranks_record_the_one_process_gauges(
        ranks, one_process_cli, job):
    """``--metrics-out`` in a carried mode on 8 ranks: the run ends on
    every rank (rank 0 alone records, and every rank computes the gauges
    its step events read), rank 0 prints the run's losses without
    ``--metrics-out`` bit for bit, and each step event's drift or replica
    block equals the one-process run's: the ages, sync steps and counts
    exactly, the gauges within rtol 1e-6 (the ranks sum them in another
    order), the quantization residual within rtol 1e-4 (as in
    ``test_drift_gauges_track_the_stacked_ones``)."""
    run = CLI_METRICS[job]
    for r in range(K):
        assert ranks[r]["cli"][job]["exit"] is None
    for r in range(1, K):
        assert ranks[r]["cli"][job]["stdout"] == ""
    assert (_epoch_losses(ranks[0]["cli"][job]["stdout"])
            == _epoch_losses(ranks[0]["cli"][run]["stdout"]))
    got, want = ranks[0]["metrics"][job], one_process_cli["metrics"][job]
    print(f"{job}: ranks {got[-1]} one process {want[-1]}")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if isinstance(value, list) and value and isinstance(
                    value[0], float):
                np.testing.assert_allclose(
                    g[key], value, err_msg=key,
                    rtol=1e-4 if key == "halo_quant_err_rms" else 1e-6)
            else:
                assert g[key] == value, key
