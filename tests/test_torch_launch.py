"""The launch layer (``sgcn_tpu_torch/parallel/launch.py``) and the
heartbeat writer (``obs/recorder.py::heartbeat``) against the reference's
(``sgcn_tpu/parallel/launch.py``, ``sgcn_tpu/obs/recorder.py``), and the
train CLI launched on 8 gloo ranks.

The counterparts of ``tests/test_launch.py``'s five tests: the
single-process no-op, the rank group a world of k gives, the SLURM
arithmetic (the same environment gives the reference's ``(coordinator,
n, id)``), SLURM absent, and one retry with backoff (the same heartbeats
and messages).  Then the heartbeat lines, ``classify_stall`` on a stalled
rendezvous's trail, and ``python -m sgcn_tpu_torch.train``'s ``main`` on
8 spawned ranks under ``torchrun``'s environment (one module-scoped
spawn, ``tests/torch_rank_child.py::cli_rank_main``, each job on a free
port rank 0 picks just before it): rank 0's report against the
one-process CLI's, the other ranks silent, the heartbeats of every rank,
and the guards.
"""

import contextlib
import dataclasses
import datetime
import io
import json
import os
import pickle
import tempfile

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from sgcn_tpu.obs import load_run as ref_load_run
from sgcn_tpu.obs import recorder as ref_recorder
from sgcn_tpu.parallel import launch as ref_launch
from sgcn_tpu.resilience.faults import classify_stall as ref_classify_stall
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs import append_env_event, heartbeat, load_run
from sgcn_tpu_torch.parallel import RankGroup, build_comm_plan, launch
from sgcn_tpu_torch.resilience.faults import classify_stall
from sgcn_tpu_torch.train import FullBatchTrainer
from sgcn_tpu_torch.train.fullbatch import CARRY_CHECKPOINT_DEFERRAL
from sgcn_tpu_torch.train.__main__ import build_parser, load_inputs
from sgcn_tpu_torch.train.__main__ import main as train_main

import torch_rank_child as child

K = 8
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "SLURM_NPROCS", "SLURM_PROCID",
               "SLURM_LOCALID", "SLURM_JOBID", "SLURM_NTASKS_PER_NODE",
               "SLURM_NNODES", "SGCN_COORDINATOR")


@pytest.fixture
def clean_env(monkeypatch):
    """No launcher variable and no ``$SGCN_METRICS_OUT``."""
    for var in LAUNCH_VARS + ("SGCN_METRICS_OUT",):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ------------------------------------------------- tests/test_launch.py's
def test_init_distributed_single_process(clean_env):
    """One process: a no-op that still returns a valid context, with the
    reference's process fields; no group, no rendezvous."""
    ctx = launch.init_distributed(device="cpu")
    ref = ref_launch.init_distributed()
    assert (ctx.num_processes, ctx.process_id, ctx.is_coordinator) == \
        (ref.num_processes, ref.process_id, ref.is_coordinator) == \
        (1, 0, True)
    assert ctx.global_devices == ctx.local_devices == 1
    assert ctx.group is None and ctx.coordinator is None
    ctx.close()                       # nothing to destroy


def test_global_mesh_is_the_rank_group(clean_env):
    """``global_mesh_1d(k)``: ``None`` for one process (the stacked
    layout, any k), the group for a world of k, a ``ValueError`` naming
    the numbers for any other world; more NCCL ranks on a node than it
    has cards raise in ``init_distributed``, before the rendezvous."""
    one = launch.init_distributed(device="cpu")
    assert launch.global_mesh_1d(8, one) is None
    assert launch.global_mesh_1d() is None     # the process's last context
    group = RankGroup(3, 8, "cpu")
    ctx = dataclasses.replace(one, process_id=3, num_processes=8,
                              global_devices=8, group=group)
    assert launch.global_mesh_1d(8, ctx) is group
    assert launch.global_mesh_1d(None, ctx) is group
    with pytest.raises(ValueError, match="a world of 8 processes for k=4"):
        launch.global_mesh_1d(4, ctx)
    clean_env.setattr(launch.torch.cuda, "device_count", lambda: 1)
    two = dataclasses.replace(ctx, device=torch.device("cuda:1"),
                              local_rank=1, local_world=2)
    with pytest.raises(RuntimeError, match="one card hosts one NCCL rank"):
        launch.check_rank_layout(two)

    def no_rendezvous(*_a, **_k):
        raise AssertionError("the layout is checked before the rendezvous")
    clean_env.setattr(launch, "_initialize_with_retry", no_rendezvous)
    with pytest.raises(RuntimeError, match="one card hosts one NCCL rank"):
        launch.init_distributed("127.0.0.1:1", 8, 1, local_rank=1)


def test_slurm_rendezvous_arithmetic(clean_env):
    """The same SLURM environment gives the reference's (coordinator, n,
    id): port = 10000 + the last 4 digits of the job id (digits only)."""
    clean_env.setenv("SLURM_NPROCS", "6")
    clean_env.setenv("SLURM_PROCID", "2")
    clean_env.setenv("SLURM_JOBID", "987654321")
    clean_env.setenv("MASTER_ADDR", "node0")
    assert launch.slurm_rendezvous_env() == \
        ref_launch.slurm_rendezvous_env() == ("node0:14321", 6, 2)
    clean_env.setenv("SLURM_JOBID", "1234_5")          # an array job
    clean_env.setenv("SGCN_COORDINATOR", "head")
    assert launch.slurm_rendezvous_env() == \
        ref_launch.slurm_rendezvous_env() == ("head:12345", 6, 2)
    clean_env.setenv("MASTER_PORT", "29400")
    assert launch.slurm_rendezvous_env() == \
        ref_launch.slurm_rendezvous_env() == ("head:29400", 6, 2)


def test_slurm_rendezvous_absent(clean_env):
    assert launch.slurm_rendezvous_env() is None
    assert ref_launch.slurm_rendezvous_env() is None
    clean_env.setenv("SLURM_NPROCS", "2")
    clean_env.setenv("SLURM_PROCID", "0")       # no coordinator named
    assert launch.slurm_rendezvous_env() is None
    assert ref_launch.slurm_rendezvous_env() is None


def _retry_runs(mod, monkeypatch, fail, entry):
    """``mod._initialize_with_retry`` under ``fail`` (a list of exceptions
    to raise, then success), its sleeps and teardowns recorded: returns
    the heartbeat events, the calls, the naps, the teardowns and the
    error (or ``None``)."""
    beats, calls, naps, downs = [], [], [], []
    monkeypatch.setattr(mod.time, "sleep", lambda s: naps.append(s))
    fails = list(fail)

    def init(**kw):
        calls.append(kw)
        if fails:
            raise fails.pop(0)
        return "group"

    monkeypatch.setattr(*entry(init, downs))
    err = None
    try:
        out = mod._initialize_with_retry(
            lambda e, **f: beats.append((e, f.get("phase"))),
            "2 processes @ node0:1234", **(
                {"coordinator_address": "node0:1234", "num_processes": 2,
                 "process_id": 0} if mod is ref_launch else
                {"coordinator": "node0:1234", "init_method":
                 "tcp://node0:1234", "world_size": 2, "rank": 0,
                 "device": "cpu"}))
        assert out in (None, "group")
    except RuntimeError as e:
        err = str(e)
    return [b[0] for b in beats], calls, naps, downs, err


def test_rendezvous_retries_once_with_backoff(clean_env):
    """A timed-out attempt gets ONE retry after the backoff, with the
    reference's heartbeats; the half-made group is destroyed between the
    attempts; a second failure raises the reference's message, and a
    failure that is not a timeout is not blamed on a stalled peer.  The
    attempt's timeout reaches the rendezvous."""
    clean_env.setenv("SGCN_RENDEZVOUS_BACKOFF", "0")
    clean_env.setenv("SGCN_RENDEZVOUS_TIMEOUT", "7")

    def port_entry(init, downs):
        clean_env.setattr(launch.dist, "is_initialized", lambda: True)
        clean_env.setattr(launch.dist, "destroy_process_group",
                          lambda: downs.append(1))
        return launch, "init_rank_group", init

    def ref_entry(init, downs):
        clean_env.setattr(ref_launch.jax.distributed, "shutdown",
                          lambda: downs.append(1))
        return ref_launch.jax.distributed, "initialize", init

    stalled = RuntimeError("Barrier timed out: peer 3 never arrived")
    cases = {"flaky": [stalled], "dead": [stalled, stalled],
             "misconfig": [RuntimeError("address already in use")] * 2}
    for name, fails in cases.items():
        got = _retry_runs(launch, clean_env, fails, port_entry)
        want = _retry_runs(ref_launch, clean_env, fails, ref_entry)
        events, calls, naps, downs, err = got
        assert events == want[0], name
        assert (len(calls), len(naps), len(downs)) == \
            (len(want[1]), len(want[2]), len(want[3])), name
        assert err == want[4], name
        assert calls[0]["timeout"] == datetime.timedelta(seconds=7)
    assert events[-1] == "rendezvous:failed"
    assert "NOT a timeout" in err and "stalled" not in err
    got = _retry_runs(launch, clean_env, cases["flaky"], port_entry)
    assert got[0] == ["rendezvous:start", "rendezvous:stalled",
                      "rendezvous:start", "rendezvous:done"]
    dead = _retry_runs(launch, clean_env, cases["dead"], port_entry)[4]
    assert "stalled" in dead and "node0:1234" in dead


def test_launcher_environments_resolve(clean_env):
    """torchrun's variables, then SLURM's, then the explicit arguments
    reach the rendezvous: ``env://`` (world, rank, local rank) under
    torchrun, ``tcp://<coordinator>`` under SLURM and explicitly; the
    device is ``cuda:<local rank>`` unless the CPU is asked for."""
    seen = []
    clean_env.setattr(launch, "_initialize_with_retry",
                      lambda hb, detail, coord, **kw: seen.append(
                          (coord, kw)) or RankGroup(kw["rank"],
                                                    kw["world_size"],
                                                    kw["device"]))
    for var, val in (("RANK", "3"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1"),
                     ("LOCAL_WORLD_SIZE", "4"), ("MASTER_ADDR", "node0"),
                     ("MASTER_PORT", "29500")):
        clean_env.setenv(var, val)
    ctx = launch.init_distributed(device="cpu")
    assert seen[-1] == ("node0:29500", dict(init_method="env://",
                                            world_size=8, rank=3,
                                            device=torch.device("cpu")))
    assert (ctx.process_id, ctx.num_processes, ctx.local_rank,
            ctx.local_world, ctx.coordinator) == (3, 8, 1, 4, "node0:29500")
    assert launch.global_mesh_1d(8) is ctx.group
    # one process under torchrun: the no-op
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("RANK", "0")
    n = len(seen)
    assert launch.init_distributed(device="cpu").group is None
    assert len(seen) == n
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_PORT"):
        clean_env.delenv(var)
    for var, val in (("SLURM_NPROCS", "4"), ("SLURM_PROCID", "2"),
                     ("SLURM_LOCALID", "0"), ("SLURM_JOBID", "77"),
                     ("SLURM_NTASKS_PER_NODE", "2(x2)")):
        clean_env.setenv(var, val)
    ctx = launch.init_distributed(device="cpu")
    assert seen[-1][0] == "node0:10077"
    assert seen[-1][1]["init_method"] == "tcp://node0:10077"
    assert (ctx.process_id, ctx.num_processes, ctx.local_world) == (2, 4, 2)
    ctx = launch.init_distributed("head:1", 2, 1, device="cpu")
    assert seen[-1] == ("head:1", dict(init_method="tcp://head:1",
                                       world_size=2, rank=1,
                                       device=torch.device("cpu")))
    with pytest.raises(ValueError, match="coordinator"):
        launch.init_distributed(None, 2, 1, device="cpu")


# ----------------------------------------------------------- heartbeats
def test_heartbeat_lines_equal_the_reference(clean_env, tmp_path):
    """``heartbeat`` is a no-op without ``$SGCN_METRICS_OUT``; with it,
    one line per call with the reference's keys, valid under both
    packages' loaders; best effort on a bad event or an unwritable
    directory."""
    heartbeat("rendezvous:start")             # nothing to write to
    assert not list(tmp_path.iterdir())
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d, fn in ((port_dir, heartbeat), (ref_dir, ref_recorder.heartbeat)):
        clean_env.setenv("SGCN_METRICS_OUT", str(d))
        fn("rendezvous:start", phase="init_distributed", detail="attempt 1")
        fn("train:done", phase="train")
    got = [json.loads(x) for x in
           (port_dir / "heartbeat.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in
            (ref_dir / "heartbeat.jsonl").read_text().splitlines()]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert {k: a[k] for k in a if k != "ts"} == \
            {k: b[k] for k in b if k != "ts"}
    for loader in (load_run, ref_load_run):
        assert [h["event"] for h in loader(str(port_dir)).heartbeats] == \
            ["rendezvous:start", "train:done"]
    # best effort: an invalid event and an unwritable directory pass
    append_env_event("heartbeat.jsonl", {"kind": "heartbeat"})
    blocker = tmp_path / "file"
    blocker.write_text("")
    clean_env.setenv("SGCN_METRICS_OUT", str(blocker / "sub"))
    heartbeat("rendezvous:start")
    assert len((port_dir / "heartbeat.jsonl").read_text().splitlines()) == 2


def test_classify_stall_reads_a_stalled_rendezvous(clean_env, tmp_path):
    """A rendezvous whose peer never comes (both attempts time out)
    leaves start / stalled / start / failed in the run directory;
    ``classify_stall`` — the port's and the reference's — reads that
    trail: slow just after its last heartbeat, stalled past the
    threshold, stalled with no trail at all."""
    clean_env.setenv("SGCN_METRICS_OUT", str(tmp_path))
    clean_env.setenv("SGCN_RENDEZVOUS_BACKOFF", "0")
    clean_env.setattr(launch.time, "sleep", lambda s: None)

    def never(**kw):
        raise RuntimeError("Socket Timeout: peer never arrived")

    clean_env.setattr(launch, "init_rank_group", never)
    with pytest.raises(RuntimeError, match="stalled"):
        launch._initialize_with_retry(heartbeat, "2 processes @ node0:1",
                                      "node0:1", init_method="tcp://node0:1",
                                      world_size=2, rank=1, device="cpu")
    trail = load_run(str(tmp_path)).heartbeats
    assert [h["event"] for h in trail] == [
        "rendezvous:start", "rendezvous:stalled", "rendezvous:start",
        "rendezvous:failed"]
    last = trail[-1]["ts"]
    for fn in (classify_stall, ref_classify_stall):
        assert fn(str(tmp_path), now=last + 1.0)[0] == "slow"
        verdict, age = fn(str(tmp_path), now=last + 120.0)
        assert verdict == "stalled" and age == pytest.approx(120.0)
        assert fn(str(tmp_path / "none"))[0] == "stalled"
        assert fn(str(tmp_path), now=last + 1.0,
                  exclude_pid=os.getpid()) == ("stalled", None)


# ------------------------------------------------ the CLI on 8 gloo ranks
BASE = ["--npz", child.NPZ, "--normalize", "-p",
        os.path.join(child.FIX, "cora2708.8.hp"), "-s", "8", "-l", "2",
        "--hidden", "16", "--epochs", "3", "--warmup", "0", "--device",
        "cpu"]
# the carried modes run on ranks; their checkpoints exit with the
# reference's deferral (the carry is sharded over the ranks); the
# mini-batch, accuracy and directed jobs exited until A2c's last part and
# now run
GUARDS = {"batch": ["-n", "512"],
          "stale": ["--halo-staleness", "1", "--save-checkpoint",
                    os.path.join(os.sep, "nonexistent", "stale.npz")],
          "replica": ["--replica-budget", "50", "--checkpoint-dir",
                      os.path.join(os.sep, "nonexistent", "replica")],
          "accuracy": ["--experiment", "accuracy"]}


def _directed_mtx(path):
    """Cora's adjacency with one direction of 20 edges dropped."""
    a, _f, _l = load_npz_dataset(child.NPZ)
    a = sp.triu(a, 1).tocoo()
    keep = np.ones(a.nnz, bool)
    keep[:20] = False
    lower = sp.coo_matrix((a.data[keep], (a.col[keep], a.row[keep])),
                          shape=a.shape)
    scipy.io.mmwrite(path, (a + lower).tocsr())


@pytest.fixture(scope="module")
def cli_runs():
    """Every rank's output of each CLI job on 8 ranks, and the
    one-process CLI's on the training jobs."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        d = {name: os.path.join(out, name) for name in (
            "gat_metrics", "gat_ck", "gcn_ck", "gat_ck1", "gcn_ck1")}
        _directed_mtx(os.path.join(out, "directed.mtx"))
        train = {
            "gat": BASE + ["--model", "gat", "--metrics-out",
                           d["gat_metrics"], "--checkpoint-dir",
                           d["gat_ck"]],
            "gcn": BASE + ["--comm-schedule", "ragged", "--checkpoint-dir",
                           d["gcn_ck"], "--checkpoint-every", "3",
                           "--save-checkpoint",
                           os.path.join(out, "gcn.npz")]}
        argvs = dict(train)
        argvs.update({name: BASE + extra for name, extra in GUARDS.items()})
        argvs["world"] = [x if x != "8" else "4" for x in BASE]
        argvs["directed"] = ["-a", os.path.join(out, "directed.mtx")] + \
            BASE[2:]
        with open(os.path.join(out, "jobs.pkl"), "wb") as fh:
            pickle.dump(argvs, fh)
        ranks = child.spawn_ranks(child.cli_rank_main, K, out)
        gat_dir = load_run(d["gat_metrics"])
        ref_dir = ref_load_run(d["gat_metrics"])
        files = sorted(os.listdir(d["gcn_ck"]))
        saved = os.path.join(out, "gcn.npz")
        exists = os.path.exists(saved)
        one = {}
        env = {v: os.environ.pop(v) for v in LAUNCH_VARS if v in os.environ}
        try:
            for name, argv in train.items():
                argv = [d[f"{name}_ck1"] if x == d[f"{name}_ck"] else x
                        for x in argv if x not in ("--metrics-out",
                                                   d["gat_metrics"])]
                argv = [os.path.join(out, "gcn1.npz") if x == saved else x
                        for x in argv]
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    train_main(argv)
                one[name] = json.loads(text.getvalue().strip()
                                       .splitlines()[-1])
        finally:
            os.environ.update(env)
        ck = None
        if exists:
            # the rank-0 file names the full plan, as the one-process
            # CLI's file does, and loads into its trainer
            from sgcn_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                         read_checkpoint_meta)
            one_file = os.path.join(out, "gcn1.npz")
            a, feats, labels, pv, k, f, widths = load_inputs(
                build_parser().parse_args(train["gcn"]))
            tr = FullBatchTrainer(build_comm_plan(a, pv, k), fin=f,
                                  widths=widths, device="cpu",
                                  comm_schedule="ragged")
            ck = {"step": load_checkpoint(tr, saved),
                  "digests": [read_checkpoint_meta(x)["plan_digest"]
                              for x in (saved, one_file)],
                  "params": [w.detach().numpy() for w in tr.params]}
            load_checkpoint(tr, one_file)
            ck["one_params"] = [w.detach().numpy() for w in tr.params]
        return {"ranks": ranks, "one": one, "run": gat_dir,
                "ref_run": ref_dir, "ck_files": files, "saved": exists,
                "ck": ck}


@pytest.mark.parametrize("job", ["gat", "gcn"])
def test_cli_on_ranks_tracks_the_one_process_cli(cli_runs, job):
    """``main`` on 8 ranks: rank 0 prints its per-step lines and one
    report whose losses are within rtol 1e-6 of the one-process CLI's
    (the stacked layout) and whose comm figures are the whole run's,
    equal to the one-process report's; the other ranks print nothing."""
    ranks = cli_runs["ranks"]
    lines = ranks[0][job]["stdout"].strip().splitlines()
    assert ranks[0][job]["exit"] is None
    assert [x.split(":")[0] for x in lines[:-1]] == \
        ["step 1", "step 2", "step 3"]
    rep, want = json.loads(lines[-1]), cli_runs["one"][job]
    for r in range(1, K):
        assert ranks[r][job] == {"stdout": "", "exit": None}
    print(f"{job}: ranks {rep['losses']} one process {want['losses']}")
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=1e-6)
    for key in ("total_send_volume", "max_send_volume", "total_recv_volume",
                "max_recv_msgs", "exchanges", "wire_rows_total",
                "comm_schedule", "halo_bytes_wire_total", "model", "steps"):
        assert rep[key] == want[key], key


def test_cli_on_ranks_writes_heartbeats_and_rank0_telemetry(cli_runs):
    """Every rank's rendezvous and train phases are in
    ``heartbeat.jsonl`` (valid under both packages' loaders); the run
    directory's manifest is rank 0's, the rank layout recorded; rank 0
    alone saved checkpoints, its file names the one-process CLI's plan
    and loads into its trainer, with the weights of the one-process run
    (within the float32 bounds of ``tests/test_torch_ranks.py``)."""
    beats = cli_runs["run"].heartbeats
    assert len(cli_runs["ref_run"].heartbeats) == len(beats) == 4 * K
    by_pid = {}
    for h in beats:
        by_pid.setdefault(h["pid"], []).append(h["event"])
    assert len(by_pid) == K
    for events in by_pid.values():
        assert events == ["rendezvous:start", "rendezvous:done",
                          "train:start", "train:done"]
    backend = cli_runs["run"].manifest["backend"]
    assert backend["process_count"] == K and backend["layout"] == "ranks"
    assert len(cli_runs["run"].steps()) == 3
    assert cli_runs["ck_files"] and cli_runs["saved"]
    ck = cli_runs["ck"]
    assert ck["step"] == 3 and ck["digests"][0] == ck["digests"][1]
    for got, want in zip(ck["params"], ck["one_params"]):
        gap = np.abs(got - want)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


@pytest.mark.parametrize("job", sorted(GUARDS) + ["world", "directed"])
def test_cli_on_ranks_guards_exit(cli_runs, job):
    """A world size that is neither 1 nor k exits with the numbers; a
    stale or replica run that would checkpoint exits with the reference's
    deferral; nothing is printed.  The mini-batch, accuracy and directed
    runs, which exited naming ROADMAP A2c before its last part, run: rank
    0 prints one report (``tests/test_torch_ranks_minibatch.py`` and
    ``tests/test_torch_ranks_directed.py`` hold their numbers), the
    other ranks nothing."""
    if job in ("batch", "accuracy", "directed"):
        got = cli_runs["ranks"][0][job]
        assert got["exit"] is None, got
        report = json.loads(got["stdout"].strip().splitlines()[-1])
        assert report["device"] == "cpu"
        for r in range(1, K):
            assert cli_runs["ranks"][r][job] == {"stdout": "", "exit": None}
        return
    for r in range(K):
        got = cli_runs["ranks"][r][job]
        assert got["stdout"] == "" and got["exit"], (r, got)
        if job == "world":
            assert "a world of 8 processes for k=4" in got["exit"]
        else:
            assert got["exit"] == CARRY_CHECKPOINT_DEFERRAL, got["exit"]
