"""The port's measured-time layer (``sgcn_tpu_torch/obs/tracing.py``).

* ``classify_op`` and ``kernel_label`` on the names the card's kernels
  carry in a ``torch.profiler`` trace (the tile kernels → ``spmm``, the
  row pack → ``exchange``, cuBLAS / CUTLASS → ``dense``, NCCL →
  ``exchange`` / ``collective_wait``, the rest ``other``) and on the CPU's
  ``aten::`` ops;
* ``summarize_trace`` on a synthetic device trace (per-class seconds,
  measured overlap, exposed comm, the straggler gauge) and on a real CPU
  ``torch.profiler`` trace of a port step, where the plain versions run
  inside regions named after their kernels;
* the train CLI's ``--profile --device cpu`` via ``main()``: the trace
  lands where ``find_trace_files`` finds it, the manifest records it and
  the reference's ``trace_path_for_run`` resolves it;
* ``SpanTimer`` nesting and events.
"""

import gzip
import json
import os

import pytest
from torch.profiler import ProfilerActivity, profile

from sgcn_tpu.obs.tracing import trace_path_for_run as ref_trace_path
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs import (KERNEL_TABLE, TRACE_CLASSES, RunRecorder,
                                SpanTimer, classify_op, find_trace_files,
                                kernel_label, load_run, summarize_trace)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")

# kernel names as a CUDA trace of the port carries them
NAMES = [
    ("void tile_spmm_fused_kernel<float, float, 4>(Family, Family, float*)",
     "spmm", "K3/K4 fused"),
    ("void tile_spmm_kernel<float, signed char, 4>(int const*, int const*)",
     "spmm", "K1/K5"),
    ("void row_pack_kernel<PackF32, 4>(float const*, int const*, float*)",
     "exchange", "pack"),
    ("void row_shuffle_f32_kernel<4>(float const*, int const*, float*)",
     "exchange", "pack"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "dense",
     "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>",
     "dense", "matmul"),
    ("void gemmSN_NN_kernel<float, 256, 4, 2, 8>", "dense", "matmul"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)",
     "exchange", "nccl"),
    ("c10d::wait", "collective_wait", "nccl wait"),
    ("void at::native::index_elementwise_kernel<128, 4>", "other",
     "gathers"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>",
     "other", "copies (transpose, casts)"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>",
     "other", "elementwise"),
    ("void at::native::roll_cuda_kernel<float>", "other", "roll"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy", "other",
     "cat"),
    ("aten::addmm", "dense", "matmul"),
    ("aten::mm", "dense", "matmul"),
    ("aten::index_select", "other", "gathers"),
    ("aten::relu", "other", None),
    ("Memcpy HtoD (Pageable -> Device)", "other", None),
]


@pytest.mark.parametrize("name,cls,label", NAMES,
                         ids=[n[:28] for n, _, _ in NAMES])
def test_classify_op_on_the_cards_kernel_names(name, cls, label):
    assert classify_op(name) == cls
    assert kernel_label(name) == label
    assert cls in TRACE_CLASSES


def test_scaffolding_is_not_op_time_and_table_is_ordered():
    """Profiler scaffolding classifies as ``None``; the fused kernel's name
    never falls to the family entry's label; every table row names a
    known class."""
    for name in ("ProfilerStep#3", "[memory]", ""):
        assert classify_op(name) is None
    assert kernel_label("tile_spmm_fused_kernel") == "K3/K4 fused"
    assert {cls for _, cls, _ in KERNEL_TABLE} <= set(TRACE_CLASSES)
    labels = [lab for lab, _, _ in KERNEL_TABLE]
    assert len(labels) == len(set(labels))


def _trace(tmp_path, events, name="dev.pt.trace.json.gz"):
    path = str(tmp_path / name)
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return path


def _k(name, ts, dur, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": 7}


def test_summarize_device_trace_overlap_and_skew(tmp_path):
    """Device tracks only (the host's ops are dropped when kernels exist):
    per-class seconds, per-label seconds, the comm union, the exposed
    share (the pack half under a concurrent fused launch), the
    straggler of two devices."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "GPU 1"}},
        _k("tile_spmm_fused_kernel<float>", 0, 100),
        _k("row_pack_kernel<x>", 50, 100),          # 50 µs under the fused
        _k("sm90_xmma_gemm", 200, 40),
        _k("vectorized_elementwise_kernel", 300, 10),
        _k("tile_spmm_kernel<int8>", 0, 30, pid=1),
        _k("aten::addmm", 0, 5000, pid=99, cat="cpu_op"),   # host: dropped
    ]
    ts = summarize_trace(_trace(tmp_path, ev))
    assert ts.on_device and ts.n_events == 5
    assert ts.classes["spmm"] == pytest.approx(130e-6)
    assert ts.classes["exchange"] == pytest.approx(100e-6)
    assert ts.classes["dense"] == pytest.approx(40e-6)
    assert ts.classes["other"] == pytest.approx(10e-6)
    assert ts.labels["K3/K4 fused"] == pytest.approx(100e-6)
    assert ts.comm_s == pytest.approx(100e-6)
    assert ts.exposed_comm_s == pytest.approx(50e-6)
    assert ts.measured_overlap_frac == pytest.approx(0.5)
    assert ts.skew["straggler"] == "GPU 0"
    per = ts.per_step(2)
    assert per["spmm_s"] == pytest.approx(65e-6)


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    plan = build_comm_plan(normalize_adjacency(a), read_partvec(HP8), 8)
    return {"plan": plan, "feats": feats,
            "data": make_train_data(plan, feats, labels)}


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_summarize_cpu_trace_of_a_port_step(cora, tmp_path, model):
    """A CPU ``torch.profiler`` trace of a port step: no device track,
    so host ops are read by self time per thread; the plain versions run
    inside regions named after their kernels, so the tile work is
    ``spmm`` and the pack ``exchange``, the products ``dense``; the
    classes' sum stays within the profiled wall time."""
    act = {} if model == "gcn" else {"activation": "none"}
    tr = FullBatchTrainer(cora["plan"], fin=cora["feats"].shape[1],
                          widths=[16, 7], model=model, device="cpu", **act)
    tr.step(cora["data"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(cora["data"])
    path = str(tmp_path / "cpu.pt.trace.json")
    prof.export_chrome_trace(path)
    assert find_trace_files(str(tmp_path))[0]["path"] == path
    ts = summarize_trace(path)
    assert not ts.on_device
    assert ts.classes["spmm"] > 0 and ts.classes["exchange"] > 0
    assert ts.classes["dense"] > 0
    label = "K3/K4 fused" if model == "gcn" else "K1/K5"
    assert ts.labels[label] > 0 and ts.labels["pack"] > 0
    busy = sum(d["busy_s"] for d in ts.devices.values())
    assert sum(ts.classes.values()) <= busy * (1 + 1e-6)


def test_train_cli_profile_and_metrics_out(tmp_path, capsys):
    """``--profile P --metrics-out D --device cpu``: one gzipped chrome
    trace under P, recorded in D's manifest with its size; the
    reference's ``trace_path_for_run`` resolves it from the manifest; the
    port's
    ``summarize_trace`` splits it into spmm / exchange / dense; the
    step events carry the losses the report ends with."""
    prof, run = str(tmp_path / "prof"), str(tmp_path / "run")
    train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
                "--hidden", "16", "--epochs", "1", "--warmup", "1",
                "--device", "cpu", "--profile", prof, "--metrics-out", run])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    files = find_trace_files(prof)
    assert len(files) == 1 and files[0]["path"].endswith(".pt.trace.json.gz")
    log = load_run(run)
    assert log.manifest["profile"]["trace_files"] == files
    assert ref_trace_path(log.manifest, run) == files[0]["path"]
    ts = summarize_trace(files[0]["path"])
    assert ts.classes["spmm"] > 0 and ts.classes["exchange"] > 0
    steps = log.steps()
    assert len(steps) == 2 and rep["epochs"] == 1
    assert [s["step"] for s in steps] == [1, 2]


def test_span_timer_nesting_and_events(tmp_path):
    """Spans nest (parent, depth), feed the phase timer's self times and,
    under a recorder, become span events."""
    d = str(tmp_path / "spans")
    with RunRecorder(d, config={}, argv=[]) as rec:
        spans = SpanTimer(recorder=rec)
        with spans.span("outer", step=1) as outer:
            with spans.span("inner", phase="fit") as inner:
                pass
    assert inner.parent == "outer" and inner.depth == 1
    assert outer.parent is None and outer.dur_s >= inner.dur_s
    rep = spans.timer.report()
    assert rep["outer"]["inclusive_s"] >= rep["inner"]["inclusive_s"]
    ev = load_run(d).events
    assert [(e["name"], e["depth"]) for e in ev] == [("inner", 1),
                                                      ("outer", 0)]
    assert ev[0]["parent"] == "outer" and ev[1]["step"] == 1
