"""The port's run telemetry (``sgcn_tpu_torch/obs``) against the
reference's (``sgcn_tpu/obs``).

* The port's schema is the reference's copy: both packages' validators
  accept and refuse the same records, with the same messages, on every
  event kind and on the malformed cases of ``tests/test_obs.py`` and
  more.
* Run directories the port writes — exact, stale, replica, GAT,
  mini-batch, durable checkpoints with a resume, serving full and
  sub-graph — load through the reference's ``sgcn_tpu.obs.load_run`` and
  render through ``scripts/obs_report.py``'s ``main()`` with exit 0.
* The step events track the reference trainer's under its recorder on
  cora2708 8-hp (the reference on its kernel path, ``optax.scale(1/8)``
  before Adam for ROADMAP C3, as the other parity tests do): losses
  within the trainer tolerance (rtol 1e-5), the ``comm`` blocks equal on
  the port's keys, stale mode's drift block on the same keys.
"""

import copy
import importlib.util
import json
import os
import sys

import numpy as np
import optax
import pytest

from sgcn_tpu.obs import RunRecorder as RefRecorder
from sgcn_tpu.obs import load_run as ref_load_run
from sgcn_tpu.obs import schema as ref_schema
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.obs import RunRecorder, load_run
from sgcn_tpu_torch.obs import schema as port_schema
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
LR = 0.01
V = port_schema.SCHEMA_VERSION

COMM = {"exchanges": 4, "exposed_exchanges": 2, "hidden_exchanges": 2,
        "exposed_send_volume": 10, "hidden_send_volume": 10,
        "total_send_volume": 20}
STEP = {"v": V, "ts": 1.0, "kind": "step", "step": 3, "loss": 0.5,
        "wall_s": 0.01, "comm": COMM}
DRIFT = {"staleness_age": 1, "sync_step": False, "halo_drift_rms": [0.1],
         "halo_drift_rel": [0.01], "halo_quant_err_rms": [0.0]}
REPLICA = {"refresh_age": 2, "sync_step": False, "replica_rows": 5,
           "replica_drift_rms": [0.0], "replica_drift_rel": [0.0]}
SERVE = {"v": V, "ts": 1.0, "kind": "serve", "queries": 10,
         "achieved_qps": 5.0, "latency_p50_ms": 1.0, "latency_p95_ms": 2.0,
         "latency_p99_ms": 3.0}
MEM_EV = {"v": V, "ts": 1.0, "kind": "memory", "program": "train_step",
          "model_bytes": 100, "measured_peak_bytes": 50, "ratio": 0.5}
MEM_BLOCK = {"families": {"params": {"model_bytes": 10, "measured_bytes": 10,
                                     "ratio": 1.0}},
             "total": {"model_bytes": 10, "measured_bytes": None,
                       "ratio": None},
             "arguments": {"model_bytes": 10}, "donated": {"model_bytes": 0}}
MANIFEST = {"v": V, "ts": 1.0, "run_kind": "train", "config": {}}

EVENTS = {
    # valid records, one per kind and the optional blocks
    "step": STEP,
    "step-drift": dict(STEP, drift=DRIFT),
    "step-drift-round-age": dict(STEP, drift=dict(DRIFT,
                                                  round_age=[0, None, 1])),
    "step-replica": dict(STEP, replica=REPLICA),
    "step-replica-partial": dict(STEP, replica=dict(
        REPLICA, refresh_kind="partial", refresh_rows=[3],
        refresh_wire_rows=8)),
    "eval": {"v": V, "ts": 1.0, "kind": "eval", "step": 1, "loss": 1.0,
             "acc": 0.5},
    "heartbeat": {"v": V, "ts": 1.0, "kind": "heartbeat", "event": "x"},
    "summary": {"v": V, "ts": 1.0, "kind": "summary", "report": {}},
    "span": {"v": V, "ts": 1.0, "kind": "span", "name": "step",
             "dur_s": 0.1, "depth": 0, "parent": None},
    "serve": dict(SERVE, shed=2, shed_factor=2.0, serve_mode="subgraph"),
    "checkpoint": {"v": V, "ts": 1.0, "kind": "checkpoint", "step": 4,
                   "path": "/x/c.npz", "bytes": 12, "wall_s": 0.1},
    "resume": {"v": V, "ts": 1.0, "kind": "resume", "step": 2,
               "path": "/x/c.npz", "fallback": True, "skipped": ["/x/d"]},
    "swap": {"v": V, "ts": 1.0, "kind": "swap", "path": "/x/c.npz",
             "weights_rev": 1, "checkpoint_step": 3, "wall_s": 0.1},
    "memory": MEM_EV,
    "v1-step": dict(STEP, v=1),
    # malformed: tests/test_obs.py's cases and more
    "unknown-kind": {"v": V, "ts": 1.0, "kind": "nope"},
    "bad-version": dict(STEP, v=999),
    "missing-required": {"v": V, "ts": 1.0, "kind": "step", "step": 1},
    "nan-wall": dict(STEP, wall_s=float("nan")),
    "bool-loss": dict(STEP, loss=True),
    "no-ts": {k: v for k, v in STEP.items() if k != "ts"},
    "comm-split": dict(STEP, comm=dict(COMM, hidden_exchanges=3)),
    "comm-partial": dict(STEP, comm={"exchanges": 1}),
    "v3-checkpoint": {"v": 3, "ts": 1.0, "kind": "checkpoint", "step": 4,
                      "path": "/x"},
    "v1-span": {"v": 1, "ts": 1.0, "kind": "span", "name": "x",
                "dur_s": 0.1},
    "v5-memory": dict(MEM_EV, v=5),
    "checkpoint-missing-path": {"v": V, "ts": 1.0, "kind": "checkpoint",
                                "step": 4},
    "checkpoint-negative-bytes": {"v": V, "ts": 1.0, "kind": "checkpoint",
                                  "step": 4, "path": "/x", "bytes": -1},
    "resume-negative-step": {"v": V, "ts": 1.0, "kind": "resume",
                             "step": -1, "path": "/x"},
    "serve-negative-shed": dict(SERVE, shed=-1),
    "serve-quantiles": dict(SERVE, latency_p95_ms=4.0),
    "serve-mode": dict(SERVE, mode="burst"),
    "serve-serve-mode": dict(SERVE, serve_mode="half"),
    "span-negative": {"v": V, "ts": 1.0, "kind": "span", "name": "x",
                      "dur_s": -0.1},
    "swap-negative-rev": {"v": V, "ts": 1.0, "kind": "swap", "path": "/x",
                          "weights_rev": -1},
    "memory-ratio": dict(MEM_EV, ratio=0.7),
    "memory-workload": dict(MEM_EV, workload="bench"),
    "memory-negative": dict(MEM_EV, temp_bytes=-1),
    "drift-missing": dict(STEP, drift={"staleness_age": 1}),
    "drift-round-age": dict(STEP, drift=dict(DRIFT, round_age=[-1])),
    "replica-missing": dict(STEP, replica={"refresh_age": 1}),
    "replica-list": dict(STEP, replica=dict(REPLICA,
                                            replica_drift_rms=0.1)),
    "replica-kind": dict(STEP, replica=dict(REPLICA, refresh_kind="x")),
    "replica-partial-rows": dict(STEP, replica=dict(
        REPLICA, refresh_kind="partial")),
    "roofline-partial": dict(STEP, roofline={"comm_schedule": "a2a"}),
    "mvm-no-anchor": dict(STEP, measured_vs_model={"components": {}}),
    "not-a-dict": ["step"],
}

MANIFESTS = {
    "minimal": MANIFEST,
    "memory": dict(MANIFEST, memory=MEM_BLOCK),
    "profile": dict(MANIFEST, profile={"dir": "/p", "trace_files": [
        {"path": "/p/a.pt.trace.json.gz", "bytes": 3}]}),
    "backend": dict(MANIFEST, backend={"platform": "gpu", "kind": "H100",
                                       "count": 1, "parts": 8}),
    "bad-version": dict(MANIFEST, v=0),
    "missing-config": {k: v for k, v in MANIFEST.items() if k != "config"},
    "memory-no-families": dict(MANIFEST, memory={"total": {}}),
    "memory-no-aggregate": dict(MANIFEST, memory={
        k: v for k, v in MEM_BLOCK.items() if k != "donated"}),
    "memory-ratio": dict(MANIFEST, memory=dict(MEM_BLOCK, families={
        "params": {"model_bytes": 10, "measured_bytes": 5, "ratio": 1.0}})),
    "profile-no-dir": dict(MANIFEST, profile={"trace_files": []}),
    "profile-bad-files": dict(MANIFEST, profile={"dir": "/p",
                                                 "trace_files": ["/p/a"]}),
}


def _verdict(fn, rec):
    try:
        fn(copy.deepcopy(rec))
    except ValueError as e:
        return "refused", str(e)
    return "accepted", None


@pytest.mark.parametrize("case", list(EVENTS))
def test_event_validators_agree_with_reference(case):
    """The same verdict and the same message from both packages."""
    rec = EVENTS[case]
    got = _verdict(port_schema.validate_event, rec)
    want = _verdict(ref_schema.validate_event, rec)
    assert got == want
    valid = not any(case.startswith(p) for p in (
        "unknown", "bad", "missing", "nan", "bool", "no-", "comm-", "v3-",
        "v1-span", "v5-", "checkpoint-", "resume-", "serve-", "span-",
        "swap-", "memory-", "drift-", "replica-", "roofline-", "mvm-",
        "not-"))
    assert (got[0] == "accepted") == valid, got


@pytest.mark.parametrize("case", list(MANIFESTS))
def test_manifest_validators_agree_with_reference(case):
    rec = MANIFESTS[case]
    got = _verdict(port_schema.validate_manifest, rec)
    assert got == _verdict(ref_schema.validate_manifest, rec)
    assert (got[0] == "accepted") == (case in ("minimal", "memory",
                                               "profile", "backend"))


def test_schema_tables_equal_reference():
    for name in ("SCHEMA_VERSION", "SUPPORTED_VERSIONS", "EVENT_KINDS",
                 "_KINDS_BY_VERSION", "_REQUIRED", "_OPTIONAL",
                 "COMM_SPLIT_KEYS", "DRIFT_KEYS", "REPLICA_KEYS",
                 "ROOFLINE_WIRE_KEYS", "_MANIFEST_REQUIRED",
                 "_MANIFEST_OPTIONAL", "MANIFEST_NAME", "EVENTS_NAME",
                 "HEARTBEAT_NAME"):
        assert getattr(port_schema, name) == getattr(ref_schema, name), name


# ----------------------------------------------------------- run directories
def _obs_report(rundir, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["obs_report.py", rundir])
    capsys.readouterr()
    code = mod.main()
    return code, capsys.readouterr().out


CORA_CLI = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "--device",
            "cpu"]
TRAIN_RUNS = {
    "exact": ["--epochs", "2"],
    "stale": ["--epochs", "2", "--halo-staleness", "1", "--halo-delta",
              "--sync-every", "2"],
    "stale-ragged": ["--epochs", "2", "--halo-staleness", "1",
                     "--comm-schedule", "ragged"],
    "replica": ["--epochs", "2", "--replica-budget", "64", "--sync-every",
                "2", "--refresh-band", "0.05"],
    "gat": ["--epochs", "2", "--model", "gat"],
    "minibatch": ["--epochs", "1", "-n", "1024"],
    "accuracy": ["--epochs", "3", "--experiment", "accuracy"],
}


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_train_run_dirs_load_in_reference_and_render(run, tmp_path,
                                                     monkeypatch, capsys):
    """A port train run directory (``--metrics-out``) loads through the
    reference's ``load_run`` (every record re-validated), carries the
    mode's blocks, and ``scripts/obs_report.py`` renders it with exit 0."""
    d = str(tmp_path / run)
    train_main(CORA_CLI + ["-l", "2", "--hidden", "16", "--warmup", "1",
                           "--metrics-out", d] + TRAIN_RUNS[run])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log, mine = ref_load_run(d), load_run(d)
    assert log.manifest == mine.manifest and log.events == mine.events
    assert log.manifest["backend"]["platform"] == "cpu"
    steps = log.steps()
    if run == "accuracy":
        assert steps == [] and log.summaries()[0]["report"]["experiment"] \
            == "accuracy"
    else:
        nsteps = 1 + (2 if run != "minibatch" else 3 * (2708 // 1024 + 1))
        assert len(steps) == nsteps
        assert all(np.isfinite(s["loss"]) for s in steps)
        assert len(log.summaries()) == 1
        assert "memory" in log.manifest
    if run.startswith("stale"):
        assert all("drift" in s for s in steps)
        assert steps[0]["drift"]["sync_step"] is True
    if run == "stale-ragged":
        assert "round_age" in steps[-1]["drift"]
    if run == "replica":
        kinds = [s["replica"].get("refresh_kind") for s in steps]
        assert kinds == ["full", None, "partial"]
    if run in ("exact", "gat", "stale", "replica"):
        assert all(s["grad_norm"] > 0 for s in steps)
        assert log.manifest["plan"]["k"] == 8
        assert any(e["kind"] == "memory" for e in log.events)
        assert steps[-1]["comm"]["exchanges"] == rep["exchanges"]
    code, out = _obs_report(d, monkeypatch, capsys)
    assert code == 0 and "schema=v6" in out


def test_checkpoint_and_resume_events(tmp_path, monkeypatch, capsys):
    """``--checkpoint-dir`` under ``--metrics-out``: one checkpoint event
    per committed save (the file on disk), and a ``--resume auto`` run's
    resume event; both directories load through the reference."""
    ck, d1, d2 = (str(tmp_path / x) for x in ("ck", "r1", "r2"))
    base = CORA_CLI + ["-l", "2", "--hidden", "16", "--warmup", "0",
                       "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    train_main(base + ["--epochs", "2", "--metrics-out", d1])
    log = ref_load_run(d1)
    cks = log.checkpoints()
    assert [c["step"] for c in cks] == [2]
    assert os.path.getsize(cks[0]["path"]) == cks[0]["bytes"]
    assert len(log.summaries()) == 1
    train_main(base + ["--epochs", "4", "--resume", "auto",
                       "--metrics-out", d2])
    log2 = ref_load_run(d2)
    assert [(r["step"], r["fallback"]) for r in log2.resumes()] == \
        [(2, False)]
    assert [c["step"] for c in log2.checkpoints()] == [4]
    assert len(log2.steps()) == 2
    code, out = _obs_report(d2, monkeypatch, capsys)
    assert code == 0 and "resume @ step 2" in out


@pytest.mark.parametrize("mode", ["full", "subgraph"])
def test_serve_run_dirs_load_in_reference_and_render(mode, tmp_path,
                                                     monkeypatch, capsys):
    d = str(tmp_path / mode)
    serve_main(CORA_CLI + ["--random-init", "-l", "2", "--hidden", "16",
                           "--queries", "24", "--max-batch", "8",
                           "--serve-mode", mode, "--shed-factor", "4",
                           "--metrics-out", d])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = ref_load_run(d)
    sv = log.serves()
    assert len(sv) == 1 and sv[0]["queries"] == rep["queries"] == 24
    assert sv[0]["serve_mode"] == mode and sv[0]["shed_factor"] == 4
    assert log.manifest["run_kind"] == "serve"
    assert log.manifest["memory"]["workload"] == (
        "serve_subgraph" if mode == "subgraph" else "serve")
    assert any(e["kind"] == "memory" for e in log.events)
    assert any(e["kind"] == "span" and e["name"] == "serve:route"
               for e in log.events)
    assert log.summaries()[0]["report"]["memory"] == rep["memory"]
    code, out = _obs_report(d, monkeypatch, capsys)
    assert code == 0 and "serve windows: 1" in out


def test_swap_event_on_hot_swap(tmp_path):
    """A hot swap under a recorder appends a swap event naming the file,
    the new ``weights_rev`` and the checkpoint's step."""
    from sgcn_tpu_torch.serve import ServeEngine
    from sgcn_tpu_torch.utils.checkpoint import save_checkpoint

    a, feats, labels = load_npz_dataset(NPZ)
    plan = build_comm_plan(normalize_adjacency(a), read_partvec(HP8), 8)
    tr = FullBatchTrainer(plan, fin=feats.shape[1], widths=WIDTHS,
                          device="cpu")
    path = str(tmp_path / "w.npz")
    save_checkpoint(tr, path, step=7)
    eng = ServeEngine(plan, fin=feats.shape[1], widths=WIDTHS, device="cpu")
    d = str(tmp_path / "swap")
    with RunRecorder(d, config={}, run_kind="serve", argv=[]) as rec:
        eng.attach_recorder(rec)
        eng.swap_weights(path)
    sw = [e for e in ref_load_run(d).events if e["kind"] == "swap"]
    assert [(e["path"], e["weights_rev"], e["checkpoint_step"])
            for e in sw] == [(path, 1, 7)]


# ------------------------------------------------- against the reference's
@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8)}


@pytest.mark.parametrize("mode", ["exact", "stale"])
def test_step_events_track_reference_recorder(cora, mode, tmp_path):
    """Both trainers under their own recorder, 3 steps from the same
    weights: the step events' losses within rtol 1e-5, the ``comm``
    blocks equal on the port's keys, the grad norms within rtol 1e-4 (the
    reference's after C3's scale), in the stale mode the drift blocks'
    schedule fields equal and their gauges within rtol 1e-3 / atol
    1e-7."""
    feats, labels = cora["feats"], cora["labels"]
    fin = feats.shape[1]
    kw = ({} if mode == "exact" else dict(halo_staleness=1, sync_every=2))
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        ref = RefTrainer(cora["ref_plan"], fin=fin, widths=WIDTHS, seed=3,
                         optimizer=optax.chain(optax.scale(1.0 / 8),
                                               optax.adam(LR)), **kw)
        p0 = [np.asarray(w) for w in ref.params]
        with RefRecorder(rd, config={}, argv=[]) as rec:
            ref.attach_recorder(rec)
            rdata = ref_make_train_data(cora["ref_plan"], feats, labels)
            for _ in range(3):
                ref.step(rdata)
    tr = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS, lr=LR,
                          params=port_gcn.params_from_jax(p0), device="cpu",
                          **kw)
    with RunRecorder(pd, config={}, argv=[]) as rec:
        tr.attach_recorder(rec)
        data = make_train_data(cora["plan"], feats, labels)
        for _ in range(3):
            tr.step(data)
    want, got = ref_load_run(rd).steps(), ref_load_run(pd).steps()
    assert [e["step"] for e in got] == [e["step"] for e in want] == [1, 2, 3]
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want], rtol=1e-5)
    for g, w in zip(got, want):
        assert {k: g["comm"][k] for k in g["comm"]} == \
            {k: w["comm"][k] for k in g["comm"]}
        # the reference's norm is of k x the loss gradient (C3)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"] / 8, rel=1e-4)
        if mode == "stale":
            for key in ("staleness_age", "sync_step"):
                assert g["drift"][key] == w["drift"][key]
            for key in ("halo_drift_rms", "halo_drift_rel"):
                np.testing.assert_allclose(g["drift"][key],
                                           w["drift"][key], rtol=1e-3,
                                           atol=1e-7)
