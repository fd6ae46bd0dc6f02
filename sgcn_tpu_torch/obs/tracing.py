"""Measured-time layer of the port (port of ``sgcn_tpu/obs/tracing.py``):
nested spans, and the ``torch.profiler`` trace parser.

**Spans** (``SpanTimer``): named, optionally nested wall-clock spans
over a ``utils.timers.PhaseTimer``.
Every span is a phase of the timer (its self-time breakdown); with a
``RunRecorder`` attached, every span exit also appends one schema-v2
``span`` event.  The trainers and the serve engine thread their step,
eval and ``serve:*`` stages through one ``SpanTimer`` each.

**Trace parser** (``find_trace_files`` / ``summarize_trace``): reads the
chrome trace ``torch.profiler`` exports (the train CLI's ``--profile
DIR`` writes ``DIR/<host>_<pid>.pt.trace.json.gz``) and classifies its
ops into the attribution vocabulary through ``KERNEL_TABLE``, the ONE
table of the port's kernel names: the tile kernels (``spmm``), the row
pack (``exchange``), cuBLAS / CUTLASS products (``dense``), NCCL
(``exchange``, its waits ``collective_wait``), the rest ``other``.  A
trace with device events (``cat`` ``kernel`` / ``gpu_memcpy`` /
``gpu_memset``) is read on the device tracks only.  A CPU trace has none:
its host ops are read by self time per thread, and an op inside a region
the port's wrappers annotate with a kernel's name (the plain version on
the CPU runs under ``record_function(<kernel name>)``) takes that
region's class, so ``aten::`` ops map to the same classes as the card's
kernels.  Measured overlap and exposed comm are computed per device
track as in the reference.

The reference's ``measured_vs_model`` join against ``attribution
.step_cost`` is not carried: the port books no roofline for its tile
kernels (ROADMAP A10's remainder).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from dataclasses import dataclass, field

from ..utils.timers import PhaseTimer

# ---------------------------------------------------------------- span API


@dataclass
class Span:
    """Handle yielded by ``SpanTimer.span`` — filled at exit."""

    name: str
    parent: str | None = None
    depth: int = 0
    dur_s: float = 0.0


class SpanTimer:
    """Nested measured spans over a shared ``PhaseTimer``.

    ``timer`` keeps the phase breakdown (self time per name); when a
    ``RunRecorder`` is attached, every span exit appends one validated
    ``span`` event.  Without a recorder the only cost is the timer's two
    ``perf_counter`` reads."""

    def __init__(self, timer: PhaseTimer | None = None, recorder=None):
        self.timer = timer if timer is not None else PhaseTimer()
        self.recorder = recorder
        self._stack: list[str] = []

    @contextlib.contextmanager
    def span(self, name: str, sync=None, step: int | None = None,
             phase: str | None = None):
        """Time a named span (nesting under any open span).  ``sync`` is the
        ``PhaseTimer.phase`` sync callable (``torch.cuda.synchronize`` on
        the card), run after the body inside the window.  Yields a
        ``Span`` whose ``dur_s`` is valid after exit."""
        sp = Span(name=name,
                  parent=self._stack[-1] if self._stack else None,
                  depth=len(self._stack))
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with self.timer.phase(name, sync=sync):
                yield sp
        finally:
            sp.dur_s = time.perf_counter() - t0
            self._stack.pop()
            if self.recorder is not None:
                kw = {}
                if step is not None:
                    kw["step"] = int(step)
                if phase is not None:
                    kw["phase"] = str(phase)
                self.recorder.record_span(
                    name=sp.name, dur_s=sp.dur_s, parent=sp.parent,
                    depth=sp.depth, **kw)


# ------------------------------------------------------------ trace parser

TRACE_CLASSES = ("spmm", "dense", "exchange", "collective_wait", "other")

# The port's kernel-name table, in order (first match wins, by substring):
# a label (``chip_smoke.py``'s device split prints these), the attribution
# class, and the name keys.  Device kernels by their CUDA names; on a CPU
# trace the plain versions run inside ``record_function`` regions named
# after the kernel, and the dense products are ``aten::`` matmuls.
KERNEL_TABLE: tuple = (
    ("K3/K4 fused", "spmm", ("tile_spmm_fused_kernel",)),
    ("K1/K5", "spmm", ("tile_spmm_kernel",)),
    ("pack", "exchange", ("row_pack_kernel", "row_shuffle")),
    ("nccl wait", "collective_wait", ("ncclwait", "nccl:wait",
                                      "c10d::wait")),
    # the rank runtime's collectives: NCCL's device kernels
    # (ncclDevKernel_*), its profiler ranges (nccl:all_to_all) and c10d's
    # host ops
    ("nccl", "exchange", ("nccl", "c10d::")),
    ("matmul", "dense", ("gemm", "Kernel2", "cutlass", "sm90_xmma",
                         "cublas", "aten::mm", "aten::addmm", "aten::bmm",
                         "aten::matmul", "aten::linear")),
    ("gathers", "other", ("index", "gather", "scatter")),
    ("roll", "other", ("roll_cuda",)),
    ("cat", "other", ("CatArray",)),
    ("copies (transpose, casts)", "other", ("copy",)),
    ("elementwise", "other", ("elementwise_kernel",)),
)

# trace events that are profiler or runtime scaffolding, not op time
_TRACE_SKIP = re.compile(r"^ProfilerStep#|^\[memory\]|^PyTorch Profiler",
                         re.I)

# chrome-trace categories of events that ran ON the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_label(name: str) -> str | None:
    """The ``KERNEL_TABLE`` label of a trace-event name, ``None`` when no
    entry matches."""
    for label, _cls, keys in KERNEL_TABLE:
        if any(k in name for k in keys):
            return label
    return None


def classify_op(name: str) -> str | None:
    """Map one trace-event name into the attribution vocabulary
    (``TRACE_CLASSES``); ``None`` for profiler scaffolding."""
    if not name or _TRACE_SKIP.search(name):
        return None
    for _label, cls, keys in KERNEL_TABLE:
        if any(k in name for k in keys):
            return cls
    return "other"


def find_trace_files(profile_dir: str) -> list[dict]:
    """The chrome traces under a ``--profile`` directory (``*.trace.json.gz``
    and ``*.pt.trace.json``), newest first, as ``[{path, bytes}]`` — the
    shape the manifest ``profile`` block records."""
    hits = set()
    for pat in ("*.trace.json.gz", "*.pt.trace.json"):
        hits.update(glob.glob(os.path.join(profile_dir, "**", pat),
                              recursive=True))
    hits = sorted(hits, key=lambda p: os.path.getmtime(p), reverse=True)
    return [{"path": os.path.abspath(p), "bytes": os.path.getsize(p)}
            for p in hits]


def _interval_union(iv: list) -> list:
    """Merge [start, end) intervals into a disjoint sorted union."""
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_len(a: list, b: list) -> float:
    """Total intersection length of two DISJOINT SORTED interval unions."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class TraceSummary:
    """Measured per-device attribution of one profiler trace."""

    path: str
    n_events: int
    devices: dict = field(default_factory=dict)   # name -> per-class seconds
    classes: dict = field(default_factory=dict)   # per-class totals (s)
    labels: dict = field(default_factory=dict)    # KERNEL_TABLE label -> s
    comm_s: float = 0.0            # per-track union of exchange + wait ops
    exposed_comm_s: float = 0.0    # comm not covered by concurrent compute
    measured_overlap_frac: float | None = None    # 1 − exposed/comm
    skew: dict | None = None       # straggler gauge (multi-device only)
    on_device: bool = False        # device tracks read (else host ops)

    def per_step(self, nsteps: int) -> dict:
        """The trace totals averaged over ``nsteps`` optimizer steps (every
        step the trace covers; work in the profiled region that is not a
        step, an eval say, still lands in the numerator)."""
        n = max(int(nsteps), 1)
        out = {f"{c}_s": self.classes.get(c, 0.0) / n
               for c in TRACE_CLASSES}
        out["comm_s"] = self.comm_s / n
        out["exposed_comm_s"] = self.exposed_comm_s / n
        return out


def _self_times(evs: list) -> list:
    """``[ts, end, self seconds, class, label]`` of the host events of one
    thread: each event's duration less its children's, and the class and
    label of the outermost enclosing region that names a port kernel
    (class ``spmm`` or ``exchange``), else its own."""
    out: list = []
    stack: list[int] = []          # out indices of the enclosing events
    for ts, end, cls, label in sorted(evs, key=lambda e: (e[0], -e[1])):
        while stack and out[stack[-1]][1] <= ts:
            stack.pop()
        region = next((out[i] for i in stack
                       if out[i][3] in ("spmm", "exchange")), None)
        if region is not None:
            cls, label = region[3], region[4]
        if stack:
            out[stack[-1]][2] -= end - ts
        out.append([ts, end, end - ts, cls, label])
        stack.append(len(out) - 1)
    for ev in out:
        ev[2] = max(ev[2], 0.0)
    return out


def summarize_trace(path: str) -> TraceSummary:
    """Parse one ``torch.profiler`` chrome trace (``.json`` or ``.json.gz``)
    into per-class seconds, per-label seconds, measured overlap /
    exposed comm and the straggler gauge (module docstring)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        doc = json.load(fh)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and classify_op(e.get("name", ""))]
    proc_names: dict = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e.get("pid")] = e.get("args", {}).get(
                "name", str(e.get("pid")))
    dev_events = [e for e in events if e.get("cat") in _DEVICE_CATS]
    on_device = bool(dev_events)
    tracks: dict = {}              # pid -> [(ts, end, self s, cls, label)]
    if on_device:
        for e in dev_events:
            ts = float(e.get("ts", 0.0)) * 1e-6       # trace units: µs
            dur = float(e.get("dur", 0.0)) * 1e-6
            name = e.get("name", "")
            tracks.setdefault(e.get("pid"), []).append(
                (ts, ts + dur, dur, classify_op(name),
                 kernel_label(name) or "other"))
    else:
        threads: dict = {}
        for e in events:
            ts = float(e.get("ts", 0.0)) * 1e-6
            dur = float(e.get("dur", 0.0)) * 1e-6
            name = e.get("name", "")
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + dur, classify_op(name),
                 kernel_label(name) or "other"))
        for (pid, _tid), evs in threads.items():
            tracks.setdefault(pid, []).extend(
                tuple(x) for x in _self_times(evs))

    classes = {c: 0.0 for c in TRACE_CLASSES}
    labels: dict = {}
    devices: dict = {}
    busies: dict = {}
    comm_s = exposed_s = 0.0
    n_events = 0
    for pid, evs in tracks.items():
        per = {c: 0.0 for c in TRACE_CLASSES}
        comm, compute = [], []
        for ts, end, sec, cls, label in evs:
            per[cls] += sec
            labels[label] = labels.get(label, 0.0) + sec
            (comm if cls in ("exchange", "collective_wait")
             else compute).append((ts, end))
        n_events += len(evs)
        for c in TRACE_CLASSES:
            classes[c] += per[c]
        comm_u = _interval_union(comm)
        comp_u = _interval_union(compute)
        cm = sum(e - s for s, e in comm_u)
        comm_s += cm
        exposed_s += max(0.0, cm - _overlap_len(comm_u, comp_u))
        name = proc_names.get(pid, str(pid))
        if name in devices:
            name = f"{name} [pid {pid}]"
        busy = sum(e - s for s, e in _interval_union(comm + compute))
        devices[name] = dict(per, busy_s=busy)
        busies[name] = busy
    skew = None
    if len(busies) > 1:
        mean = sum(busies.values()) / len(busies)
        straggler = max(busies, key=busies.get)
        skew = {"busy_max_over_mean": (busies[straggler] / mean
                                       if mean > 0 else 1.0),
                "straggler": straggler}
    return TraceSummary(
        path=path, n_events=n_events, devices=devices, classes=classes,
        labels=labels, comm_s=comm_s, exposed_comm_s=exposed_s,
        measured_overlap_frac=(1.0 - exposed_s / comm_s) if comm_s > 0
        else None, skew=skew, on_device=on_device)


@contextlib.contextmanager
def profile_to(profile_dir: str | None, device):
    """``--profile DIR``: run the body under ``torch.profiler`` (CPU
    activity, and CUDA on the card) and write its chrome trace to
    ``DIR/<host>_<pid>.pt.trace.json.gz``, where ``find_trace_files``
    finds it.  ``None`` profiles nothing."""
    if profile_dir is None:
        yield None
        return
    import shutil
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(profile_dir, f"{socket.gethostname()}_"
                        f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
