"""The port's serving slice against the reference ``sgcn_tpu.serve``.

  * **the slice as a whole** — the port's ``ServeEngine(device="cpu")``
    and the reference engine (mode full, same weights, the kernel path
    forced with ``SGCN_PALLAS_SPMM=1``) serve the same query ids on
    cora2708 8-part, including batches that pad to a larger bucket; logits
    agree within ``rtol=1e-4, atol=1e-5`` (XLA:CPU and torch sum the dense
    projection in different orders and may contract multiply-adds
    differently);
  * router, batcher and loadgen behave like the reference on the cases
    ``tests/test_serve.py`` pins (both packages driven side by side);
  * the CLI runs in-process on the CPU and prints a parseable report;
  * without a GPU, an entry point that did not ask for the CPU raises.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sgcn_tpu.ops.pallas_spmm import PALLAS_PLAN_FIELDS
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.serve import MicroBatcher as RefBatcher
from sgcn_tpu.serve import ServeEngine as RefEngine
from sgcn_tpu.serve import VertexRouter as RefRouter
from sgcn_tpu.serve import default_buckets as ref_default_buckets
from sgcn_tpu.serve import run_loadgen as ref_run_loadgen
from sgcn_tpu.serve import synthetic_query_ids as ref_query_ids
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import (MicroBatcher, ServeEngine, VertexRouter,
                                  default_buckets, run_loadgen,
                                  synthetic_query_ids)
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.utils.backend import resolve_device

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "pv": pv, "feats": feats, "labels": labels,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8)}


# ------------------------------------------------------------ whole slice
def test_serve_engine_matches_reference_engine(cora, monkeypatch):
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "1")
    feats = cora["feats"]
    widths = [16, 7]
    dims = list(zip([feats.shape[1]] + widths[:-1], widths))
    from sgcn_tpu.models.gcn import init_gcn_params as ref_init
    params = [np.asarray(w) for w in ref_init(jax.random.PRNGKey(1), dims)]

    ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), cora["pv"], 8)
    ref = RefEngine(ref_plan, fin=feats.shape[1], widths=widths,
                    params=params, max_batch=32, buckets=(8, 32))
    assert ref.setup.plan_fields == PALLAS_PLAN_FIELDS   # kernel path taken
    ref.set_features(feats)

    eng = ServeEngine(cora["plan"], fin=feats.shape[1], widths=widths,
                      params=params, max_batch=32, buckets=(8, 32),
                      device="cpu")
    eng.set_features(feats)
    assert eng.setup.fwd_static["pallas_lclasses"] == tuple(
        (t, e, "tile_spmm") for t, e, _ in ref.setup.fwd_static[
            "pallas_lclasses"])
    qids = synthetic_query_ids(cora["plan"].n, 57, seed=4)
    # 5 pads to bucket 8, 20 pads to 32, 32 fills 32
    for sl in (slice(0, 5), slice(5, 37), slice(37, 57)):
        got = eng.query(qids[sl])
        want = ref.query(qids[sl])
        assert got.shape == want.shape == (sl.stop - sl.start, 7)
        assert got.dtype == np.float32
        print(f"batch {sl}: max |port - reference| = "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert eng.forward_count == 3 and eng.compile_count == 0
    g = eng.gauges()
    rg = ref.gauges()
    for key in ("wire_rows_per_exchange", "true_rows_per_exchange",
                "wire_rows_per_batch", "full_rows_per_forward"):
        assert g[key] == rg[key], key


# ---------------------------------------------------------------- router
def test_router_matches_reference(cora):
    plan = cora["plan"]
    router, ref = VertexRouter(plan), RefRouter(plan)
    q = np.arange(plan.n)
    for a, b in zip(router.lookup(q), ref.lookup(q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(router.lookup(q)[0], plan.owner)
    groups, rgroups = router.route(q[::7]), ref.route(q[::7])
    assert groups.keys() == rgroups.keys()
    for chip in groups:
        np.testing.assert_array_equal(groups[chip], rgroups[chip])
        assert (plan.owner[groups[chip]] == chip).all()
    with pytest.raises(ValueError, match="out of range"):
        router.lookup([plan.n])


# --------------------------------------------------------------- batcher
@pytest.mark.parametrize("mb", [1, 12, 16, 33])
def test_bucket_ladder_matches_reference(mb):
    assert default_buckets(mb) == ref_default_buckets(mb)


def _drive_batcher(cls):
    """The deadline/full-flush sequence of tests/test_serve.py."""
    now = [0.0]
    b = cls(max_batch=3, latency_budget_ms=100.0, buckets=(1, 3),
            clock=lambda: now[0])
    trace = [b.submit(1), b.poll()]
    now[0] = 0.05
    trace += [b.poll(), b.submit(2)]
    now[0] = 0.1
    trace.append([p.qid for p in b.poll()])
    trace += [b.submit(3), b.submit(4), [p.qid for p in b.submit(5)]]
    trace += [b.deadline_flushes, b.full_flushes, len(b), b.flush(),
              b.bucket_for(2)]
    return trace


def test_batcher_flushes_match_reference():
    got = _drive_batcher(MicroBatcher)
    assert got == _drive_batcher(RefBatcher)
    assert got[4] == [1, 2] and got[7] == [3, 4, 5]
    with pytest.raises(ValueError, match="below max_batch"):
        MicroBatcher(max_batch=8, buckets=(1, 4))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        MicroBatcher(max_batch=4, buckets=(4,)).bucket_for(5)


# --------------------------------------------------------------- loadgen
class _FakeEngine:
    """Executing a batch takes a fixed simulated time on the clock."""

    def __init__(self, batcher, clock_box, service_s):
        self.batcher = batcher
        self._clock = clock_box
        self._service = service_s

    def query(self, qids):
        self._clock[0] += self._service
        return np.zeros((len(qids), 2), np.float32)


def _loadgen(run, batcher_cls, n, qps, max_batch, budget_ms, service_s,
             shed_factor=None):
    now = [0.0]

    def clock():
        return now[0]

    def sleep(dt):
        now[0] += dt

    b = batcher_cls(max_batch=max_batch, latency_budget_ms=budget_ms,
                    buckets=(max_batch,), clock=clock,
                    shed_factor=shed_factor)
    res = run(_FakeEngine(b, now, service_s), np.arange(n),
              offered_qps=qps, clock=clock, sleep=sleep)
    return (res.latencies_ms, res.batch_sizes, res.window_s, res.shed,
            b.full_flushes, b.deadline_flushes, res.summary())


@pytest.mark.parametrize("case", [
    # open loop, max-batch flushes (latency from the scheduled arrival)
    dict(n=8, qps=100.0, max_batch=4, budget_ms=1000.0, service_s=0.01),
    # open-loop trickle drained by the deadline
    dict(n=3, qps=1000.0, max_batch=8, budget_ms=50.0, service_s=0.001),
    # closed-loop tail drains immediately
    dict(n=3, qps=None, max_batch=8, budget_ms=50.0, service_s=0.001),
    # overload with deadline shedding
    dict(n=6, qps=1000.0, max_batch=2, budget_ms=10.0, service_s=0.1,
         shed_factor=2.0),
], ids=["open", "deadline", "closed-tail", "shed"])
def test_loadgen_matches_reference(case):
    got = _loadgen(run_loadgen, MicroBatcher, **case)
    want = _loadgen(ref_run_loadgen, RefBatcher, **case)
    assert got == want
    if case["qps"] == 100.0:
        assert got[0][0] == pytest.approx(40.0)
        assert got[0][3] == pytest.approx(10.0)


def test_synthetic_query_ids_match_reference():
    np.testing.assert_array_equal(synthetic_query_ids(100, 500, seed=1),
                                  ref_query_ids(100, 500, seed=1))
    np.testing.assert_array_equal(
        synthetic_query_ids(100, 500, seed=1, skew=1.2),
        ref_query_ids(100, 500, seed=1, skew=1.2))


# ------------------------------------------------------------------- CLI
def test_cli_runs_in_process(capsys):
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "-l", "2", "--hidden", "16",
                "--queries", "24", "--max-batch", "8", "--buckets", "4,8",
                "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["metric"] == "serve_qps" and rep["measured"] is True
    assert rep["queries"] == 24 and rep["value"] > 0
    assert rep["latency_p50_ms"] <= rep["latency_p99_ms"]
    assert rep["widths"] == [16, 7] and rep["device"] == "cpu"
    assert rep["compiles"] == 0 and rep["comm_schedule"] == "a2a"


def test_cli_leaves_unported_flags_undefined(capsys):
    """Every flag of the reference's serve CLI is ported: ``--metrics-out``
    parses and the run stops at the input check, ``--memory-budget``
    refuses a value that is no size with the reference's message
    (argparse exit 2, not an unknown flag); ``--checkpoint`` is exclusive
    with ``--random-init``.  (``--serve-mode``, ``--concurrent`` and
    ``--shed-factor``: ``tests/test_torch_subgraph.py``; the telemetry
    flags' runs: ``tests/test_torch_obs.py``,
    ``tests/test_torch_memory.py``.)"""
    with pytest.raises(SystemExit) as exc:
        serve_main(["-p", HP8, "-s", "8", "--random-init", "--metrics-out",
                    "x", "--device", "cpu"])
    assert exc.value.code != 2 and "--npz" in str(exc.value.code)
    assert "unrecognized arguments" not in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        serve_main(["-p", HP8, "-s", "8", "--random-init", "--memory-budget",
                    "x"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" not in err
    assert "is not BYTES or a K/M/G/T-suffixed size" in err
    with pytest.raises(SystemExit, match="exclusive"):
        serve_main(["-p", HP8, "-s", "8", "--random-init",
                    "--checkpoint", "x"])


# ---------------------------------------------------------------- device
def test_entry_points_without_cpu_raise_when_no_gpu(cora):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cora["plan"], fin=cora["feats"].shape[1], widths=[16, 7])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                    "--random-init"])


def test_unported_features_raise(cora):
    kw = dict(fin=cora["feats"].shape[1], widths=[16, 7], device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(cora["plan"], model="gin", **kw)
    # an asymmetric Â serves on the a2a exchange (the reference's
    # pspmm_overlap forward): rows within rtol 1e-4 / atol 1e-5 of a
    # float64 dense forward relu(Â·X·W0)·W1
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    asym = build_comm_plan(normalize_adjacency(a.tocsr()), cora["pv"], 8)
    assert not asym.symmetric
    eng = ServeEngine(asym, seed=3, **kw)
    eng.set_features(cora["feats"])
    q = np.arange(0, asym.n, 97)
    ahat = normalize_adjacency(a.tocsr()).astype(np.float64)
    w0, w1 = (w.detach().double().numpy() for w in eng.model.weights)
    want = ahat @ np.maximum(ahat @ (cora["feats"] @ w0), 0) @ w1
    np.testing.assert_allclose(eng.query(q), want[q], rtol=1e-4, atol=1e-5)
    assert eng.gauges()["comm_schedule"] == "a2a"
