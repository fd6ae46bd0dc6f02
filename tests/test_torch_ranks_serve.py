"""Serving on the rank runtime (ROADMAP A2c's serving half): 8 gloo ranks
on cora2708 under its 8-part hp partition, GCN and GAT 1433 → 16 → 7.

One module-scoped spawn (``tests/torch_rank_child.py::serve_ranks_main``)
runs ``ServeEngine(mesh=...)``: per ``SERVE_CASES`` case (GCN a2a, ring and
the bf16 wire, GAT a2a and ring, GCN and GAT sub-graph mode) rank 0 serves
three batches and reads the gauges while the other ranks follow; then a
hot swap through a watched directory (a checkpoint, a corrupt newer one, a
wrong-plan one) and one by ``swap_weights``; then the serve CLI's
``main()`` under torchrun's variables.  Meanwhile the parent builds the
stacked port engine's rows, the reference engine's (``sgcn_tpu.serve`` on
the conftest's 8 CPU devices, the same weights) and the one-process
CLI's reports.

Against the stacked port engine the rows are equal bit for bit: ROADMAP
C6's contract would cover a projection at another row count (a rank
projects its ``B`` rows where the stacked engine projects ``k·B``), and
on this CPU every row came out the same.  Against the reference engine
the rows hold C6's contract, float32 rtol 1e-5 / atol 1e-6 and bf16 wire
rtol 1e-3 / atol 1e-4 (measured: 3.7e-8 GCN, 3.0e-8 on the bf16 wire,
6.0e-8 GAT); a ring case is held to the reference's a2a engine, which
its own tests hold equal to its ring bit for bit.
"""

import contextlib
import io
import json
import os
import pickle
import tempfile

import jax
import numpy as np
import pytest

from sgcn_tpu.models.gat import init_gat_params as ref_init_gat
from sgcn_tpu.models.gcn import init_gcn_params as ref_init_gcn
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.serve import ServeEngine as RefEngine
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs import load_run
from sgcn_tpu_torch.ops.pspmm import ELL_MODE_DEFERRAL
from sgcn_tpu_torch.parallel import (RankGroup, build_comm_plan,
                                     init_rank_group, shard_proxy_plan)
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.resilience.faults import corrupt_file
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import FullBatchTrainer
from sgcn_tpu_torch.utils.checkpoint import save_checkpoint

import torch_rank_child as child

K = 8
CASES = list(child.SERVE_CASES)
HP8 = os.path.join(child.FIX, "cora2708.8.hp")
HP4 = os.path.join(child.FIX, "cora2708.4.hp")
# ROADMAP C6's contract, by wire
CONTRACT = {None: dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=1e-3, atol=1e-4)}
BASE = ["--npz", child.NPZ, "--normalize", "-p", HP8, "-s", "8",
        "--random-init", "--device", "cpu", "--hidden", "16", "--queries",
        "48", "--max-batch", "16", "--seed", "3"]
# the CLI jobs on 8 ranks ("watch" and "metrics" name their directories
# at the call); "world" is a world of 8 for k = 4
JOBS = {"full": ["--watch-checkpoint-dir"],
        "gat-sub": ["--model", "gat", "--serve-mode", "subgraph",
                    "--concurrent"],
        "qps": ["--comm-schedule", "ragged", "--halo-dtype", "bfloat16",
                "--qps", "400", "--concurrent", "--shed-factor", "4",
                "--memory-budget", "1G", "--metrics-out"],
        "world": ["-s", "4"]}
# the report's keys a host clock decides, and the rank's own memory block
TIMED = {"value", "window_s", "achieved_qps", "latency_p50_ms",
         "latency_p95_ms", "latency_p99_ms", "memory"}
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def _ref_params(model, seed):
    dims = list(zip([child.FIN] + child.WIDTHS[:-1], child.WIDTHS))
    init = ref_init_gat if model == "gat" else ref_init_gcn
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), dims))


def _stage(plan, stage, watch_cli):
    """The checkpoints the hot swaps read: GCN steps 1 (seed 7) and 2
    (seed 8, then corrupted) and a step 3 of the 4-part plan, and a GAT
    file (seed 9); ``watch_cli`` holds step 1 of the CLI's own plan (its
    ``k`` a Python int: ``plan_digest`` reads the repr of ``k``, and
    ``cora_plan``'s is a numpy integer, ROADMAP C11)."""
    a, _f, _l = load_npz_dataset(child.NPZ)
    ahat = normalize_adjacency(a)
    plan4 = build_comm_plan(ahat, read_partvec(HP4), 4)
    plan_cli = build_comm_plan(ahat, read_partvec(HP8), K)
    kw = dict(fin=child.FIN, widths=child.WIDTHS, device="cpu")
    for step, p, seed in ((1, plan, 7), (2, plan, 8), (3, plan4, 1)):
        path = os.path.join(stage, f"ckpt_{step:08d}.npz")
        save_checkpoint(FullBatchTrainer(p, seed=seed, **kw), path, step)
    save_checkpoint(FullBatchTrainer(plan_cli, seed=7, **kw),
                    os.path.join(watch_cli, "ckpt_00000001.npz"), 1)
    corrupt_file(os.path.join(stage, "ckpt_00000002.npz"))
    save_checkpoint(FullBatchTrainer(plan, seed=9, model="gat",
                                     activation="none", **kw),
                    os.path.join(stage, "gat.npz"))


def _one_process(argv):
    """The serve CLI in this process (no launcher variable): its report."""
    saved = {v: os.environ.pop(v) for v in LAUNCH_VARS if v in os.environ}
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main(list(argv))
    finally:
        os.environ.update(saved)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def runs():
    """Every rank's results (one spawn of 8), and meanwhile the stacked
    port engine's rows, the reference engine's and the one-process CLI's
    reports."""
    _ahat, feats, _labels, pv, plan = child.cora_plan("cora2708.8.hp")
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    p0 = {"gcn": _ref_params("gcn", 1), "gat": _ref_params("gat", 2)}
    qs = child.serve_queries(plan)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        dirs = {d: os.path.join(out, d) for d in
                ("stage", "watch", "watch-cli", "m-ranks", "m-one")}
        for d in dirs.values():
            os.makedirs(d)
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(p0, fh)
        jobs = {"full": BASE + JOBS["full"] + [dirs["watch-cli"]],
                "gat-sub": BASE + JOBS["gat-sub"],
                "qps": BASE + JOBS["qps"] + [dirs["m-ranks"]],
                "world": BASE + JOBS["world"]}
        with open(os.path.join(out, "jobs.pkl"), "wb") as fh:
            pickle.dump(jobs, fh)
        join = child.start_ranks(child.serve_ranks_main, K, out)
        try:
            # rank 0 waits for the files before its swap cases
            _stage(plan, dirs["stage"], dirs["watch-cli"])
            open(os.path.join(dirs["stage"], "ready"), "w").close()
            stacked, ref = {}, {}
            for case in child.ELL_SERVE_CASES:
                with child.ell_switch():
                    eng = child.serve_engine(plan, feats, case, p0)
                assert eng.setup.aggregator == "ell"
                stacked["ell-" + case] = {"rows": [eng.query(q) for q in qs]}
            for case in CASES:
                eng = child.serve_engine(plan, feats, case, p0)
                stacked[case] = {"rows": [eng.query(q) for q in qs],
                                 "gauges": eng.gauges()}
                kw = child.SERVE_CASES[case]
                model = kw.get("model", "gcn")
                if kw.get("comm_schedule") == "ragged":
                    ref[case] = ref[f"{model}-a2a"]
                    continue
                r = RefEngine(ref_plan, fin=child.FIN, widths=child.WIDTHS,
                              model=model, params=p0[model], max_batch=32,
                              buckets=(32,), precompile=False,
                              halo_dtype=kw.get("halo_dtype"),
                              mode=kw.get("mode", "full"))
                r.set_features(feats)
                ref[case] = r.query(qs[-1])         # one compile a case
            swaps = {name: child.serve_engine(
                plan, feats, case, p0, params=None,
                checkpoint=os.path.join(dirs["stage"], f)).query(qs[-1])
                for name, case, f in (("watch", "gcn-a2a",
                                       "ckpt_00000001.npz"),
                                      ("swap", "gat-sub", "gat.npz"))}
            one = {job: _one_process(jobs[job]) for job in ("full",
                                                            "gat-sub")}
            one["qps"] = _one_process(BASE + JOBS["qps"] + [dirs["m-one"]])
        finally:
            ranks = join()
        run = load_run(dirs["m-ranks"])
    return {"ranks": ranks, "stacked": stacked, "ref": ref, "swaps": swaps,
            "one": one, "run": run, "qs": qs}


@pytest.mark.parametrize("case", CASES)
def test_rank_rows_equal_the_stacked_engine(runs, case):
    """Rank 0's rows of every batch equal the stacked port engine's bit
    for bit (each query's row from its owner's rank, a gather); every
    follower served the three batches."""
    got = runs["ranks"][0][case]["rows"]
    for a, b in zip(got, runs["stacked"][case]["rows"]):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), case
    for r in range(1, K):
        assert runs["ranks"][r][case] == {"served": 3, "rev": 0}


@pytest.mark.parametrize("case", CASES)
def test_rank_rows_track_the_reference_engine(runs, case):
    """The widest batch (a vertex of every part) within ROADMAP C6's
    contract of the reference engine's rows (``sgcn_tpu.serve.ServeEngine``
    on 8 CPU devices; a ring case against its a2a engine)."""
    got, want = runs["ranks"][0][case]["rows"][-1], runs["ref"][case]
    np.testing.assert_allclose(
        got, want, **CONTRACT[child.SERVE_CASES[case].get("halo_dtype")])
    print(f"{case}: max |ranks - reference| "
          f"{float(np.abs(got - want).max()):.3g}")


@pytest.mark.parametrize("case", CASES)
def test_rank_gauges_are_the_stacked_engines(runs, case):
    """Rank 0 reports the full plan's gauges, the stacked engine's
    numbers (sub-graph totals summed over the ranks), its memory block
    the rank's: ``layout: ranks``, a slice's features and tiles."""
    got = runs["ranks"][0][case]["gauges"]
    want = runs["stacked"][case]["gauges"]
    skip = {"memory"} | ({"buckets"} if "sub" in case else set())
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["memory"]["layout"] == "ranks"
    assert "layout" not in want["memory"]
    assert got["memory"]["model_bytes"] < want["memory"]["model_bytes"]
    assert got["memory"]["params_bytes"] == want["memory"]["params_bytes"]


def test_watched_directory_swaps_on_every_rank(runs):
    """Through a watched directory: the batch before any file serves the
    initial weights; the step-1 file lands and the next batch serves its
    weights (== a stacked engine built from it) on every rank
    (``weights_rev`` 1); a corrupt step 2 is skipped alike (one warning,
    on rank 0, the same rows); a wrong-plan step 3 raises the digest
    mismatch on every rank and no rank hangs."""
    lead = runs["ranks"][0]["watch"]
    rows = lead["rows"]
    assert np.array_equal(rows[0], runs["stacked"]["gcn-a2a"]["rows"][-1])
    assert np.array_equal(rows[1], runs["swaps"]["watch"])
    assert np.array_equal(rows[2], rows[1])
    assert lead["revs"] == [0, 1, 1]
    assert lead["warned"] == [False, False, True]
    for r in range(K):
        got = runs["ranks"][r]["watch"]
        assert "plan digest mismatch" in got["err"], (r, got)
        assert got["rev"] == 1


def test_swap_weights_on_ranks_refreshes_gat_stabilizers(runs):
    """``swap_weights`` on rank 0 (a header with no queries): every rank
    loads the GAT file and refreshes its stabilizers, the next sub-graph
    batch equals a stacked sub-graph engine built from the file."""
    lead = runs["ranks"][0]["swap"]
    assert np.array_equal(lead["rows"][0],
                          runs["stacked"]["gat-sub"]["rows"][-1])
    assert np.array_equal(lead["rows"][1], runs["swaps"]["swap"])
    assert lead["rev"] == 1
    for r in range(1, K):
        assert runs["ranks"][r]["swap"] == {"served": 2, "rev": 1}


@pytest.mark.parametrize("job", ["full", "gat-sub", "qps"])
def test_serve_cli_on_ranks_reports_as_one_process(runs, job):
    """``main`` on 8 ranks under torchrun's variables: rank 0 prints one
    JSON line, the others nothing, every rank exits cleanly; the report
    equals the one-process CLI's, timings and the rank's memory block
    aside (sub-graph mode: and rank 0's compact shapes).  The watched
    directory's file swapped in on the ranks as on one process; the
    open-loop run (``--qps``, ``--concurrent``, shedding, the bf16 wire on
    the ring, a budget) differs only where its arrival clock decides the
    batches."""
    lines = runs["ranks"][0]["cli"][job]["stdout"].strip().splitlines()
    assert runs["ranks"][0]["cli"][job]["exit"] is None
    assert len(lines) == 1
    for r in range(1, K):
        assert runs["ranks"][r]["cli"][job] == {"stdout": "", "exit": None}
    got, want = json.loads(lines[0]), runs["one"][job]
    skip = TIMED | ({"buckets"} if job == "gat-sub" else set())
    if job == "qps":
        skip |= {"queries", "batches", "mean_batch", "deadline_flushes",
                 "full_flushes", "shed", "forwards"}
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["memory"]["layout"] == "ranks"
    if job == "full":
        assert got["weights_rev"] == 1
    if job == "gat-sub":
        assert got["concurrent"] and got["serve_mode"] == "subgraph"


def test_serve_cli_on_ranks_writes_heartbeats_and_rank0_telemetry(runs):
    """Every rank's rendezvous and serve phases are in
    ``heartbeat.jsonl``; the run directory's manifest and its one serve
    event are rank 0's."""
    run = runs["run"]
    by_pid = {}
    for h in run.heartbeats:
        by_pid.setdefault(h["pid"], []).append(h["event"])
    assert len(by_pid) == K
    for events in by_pid.values():
        assert events == ["rendezvous:start", "rendezvous:done",
                          "serve:start", "serve:done"]
    assert len(run.serves()) == 1
    backend = run.manifest["backend"]
    assert backend["process_count"] == K and backend["layout"] == "ranks"


def test_serve_cli_on_ranks_refuses_another_world(runs):
    """A world of 8 for ``-s 4`` exits on every rank with the numbers,
    printing nothing."""
    for r in range(K):
        got = runs["ranks"][r]["cli"]["world"]
        assert got["stdout"] == ""
        assert "a world of 8 processes for k=4" in got["exit"], (r, got)


@pytest.mark.parametrize("case", child.ELL_SERVE_CASES)
def test_ell_full_mode_on_ranks_equals_the_stacked_engine(runs, case):
    """Under ``SGCN_PALLAS_SPMM=0`` full-mode ``ServeEngine(mesh=...)``
    serves on the ELL aggregator over each rank's slice's chains (ROADMAP
    A2d): rank 0's rows of every batch equal the stacked ELL engine's bit
    for bit, GCN on both transports and GAT; every follower served the
    three batches."""
    got = runs["ranks"][0]["ell-" + case]
    assert got["aggregator"] == "ell"
    for a, b in zip(got["rows"], runs["stacked"]["ell-" + case]["rows"]):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), case
    for r in range(1, K):
        assert runs["ranks"][r]["ell-" + case] == {"served": 3, "rev": 0}


def test_ell_on_ranks_raises_the_deferral(monkeypatch):
    """``SGCN_PALLAS_SPMM=0`` with a rank group still raises the
    deferral of the modes that stay on the tiles: sub-graph mode, GCN
    and GAT, before anything ships (full mode serves on ELL:
    ``test_ell_full_mode_on_ranks_equals_the_stacked_engine``)."""
    _ahat, _feats, _labels, _pv, plan = child.cora_plan("cora2708.8.hp")
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    for model in ("gcn", "gat"):
        with pytest.raises(ValueError) as err:
            ServeEngine(plan, fin=child.FIN, widths=child.WIDTHS,
                        model=model, mode="subgraph",
                        mesh=RankGroup(0, K, "cpu"))
        assert str(err.value) == ELL_MODE_DEFERRAL.format(
            mode="sub-graph server")


def test_one_rank_proxy_serves_its_part_only(tmp_path):
    """A one-rank gloo group on part 3's slice serves that part's rows
    equal to the stacked engine on the same slice, bit for bit; a batch
    naming another part's vertex raises on both before anything ships;
    sub-graph mode refuses a slice."""
    _ahat, feats, _labels, _pv, plan = child.cora_plan("cora2708.8.hp")
    sl = shard_proxy_plan(plan, 3)
    p0 = {"gcn": _ref_params("gcn", 1)}
    mine = np.flatnonzero(np.asarray(plan.owner) == 3)[:20]
    other = np.flatnonzero(np.asarray(plan.owner) == 5)[:1]
    stacked = child.serve_engine(sl, feats, "gcn-a2a", p0)
    want = stacked.query(mine)
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        eng = child.serve_engine(sl, feats, "gcn-a2a", p0, mesh)
        try:
            got = eng.query(mine)
            with pytest.raises(ValueError, match=r"part\(s\) \[3\]"):
                eng.query(np.concatenate([mine[:2], other]))
            assert np.array_equal(eng.query(mine[:4]), want[:4])
        finally:
            eng.close()
    finally:
        mesh.close()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match=r"part\(s\) \[3\]"):
        stacked.query(other)
    with pytest.raises(ValueError, match="one-part slice"):
        child.serve_engine(sl, feats, "gcn-sub", p0)
