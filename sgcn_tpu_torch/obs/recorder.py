"""RunRecorder — the run manifest + append-only JSONL event stream (port of
``sgcn_tpu/obs/recorder.py``).

One ``RunRecorder`` per run directory (``--metrics-out DIR``):

  * ``manifest.json``   — what ran: config, argv, git rev, backend, plan
    digest, partitioner, transport decision, memory block, profile.
    Rewritten atomically (``resilience/atomic.py``) as late facts arrive,
    so a killed run still leaves a parseable manifest.
  * ``events.jsonl``    — one line per event (``step``/``eval``/``span``/
    ``serve``/``checkpoint``/``resume``/``swap``/``memory``/``summary``),
    appended and flushed per event.
  * ``heartbeat.jsonl`` — liveness pings of other layers and processes
    (``heartbeat()`` below, through ``$SGCN_METRICS_OUT``): the launch
    rendezvous (``parallel/launch.py``) and the train CLI's phases, from
    every rank, so an operator tells "slow" (heartbeats advancing) from
    "stalled" (the last one stale, ``resilience/faults.py::
    classify_stall``) without a debugger.

Every record is validated against ``schema`` (the reference's copy) before
it is written, and ``load_run`` re-validates on read, so a directory the
port writes loads through ``sgcn_tpu.obs.load_run`` as well.
``plan_digest`` must equal the reference's digest of the same plan, byte
for byte: a checkpoint records it as provenance, and a file written by
either package is verified against the other's plan.

``set_backend`` records the torch device in place of the reference's jax
mesh: ``platform`` (``gpu`` or ``cpu``), ``device_count`` and
``process_count`` (1 when the port stacks all ``k`` parts on one device;
the world size on a rank group, one device per rank) under the
reference's keys, and beside them the device ``kind``
(``torch.cuda.get_device_name``), the ``count`` of devices the machine
shows and the ``parts`` stacked on the one the run uses.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

from . import schema


def _git_rev() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):   # best-effort metadata
        return None


def plan_digest(plan) -> str:
    """Stable 16-hex digest of a CommPlan's comm structure — enough to tell
    "same partition/layout" apart across runs without storing the arrays."""
    h = hashlib.sha256()
    h.update(repr((plan.n, plan.k, plan.b, plan.s, plan.r, plan.e,
                   bool(plan.symmetric), tuple(plan.ell_buckets))).encode())
    for arr in (plan.send_counts, plan.halo_counts, plan.nnz,
                plan.part_sizes):
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def plan_manifest_block(plan) -> dict:
    """The plan's sizes, per-exchange volumes and digest as one dict (the
    reference's manifest ``plan`` block)."""
    return {
        "n": int(plan.n), "k": int(plan.k), "b": int(plan.b),
        "s": int(plan.s), "r": int(plan.r), "e": int(plan.e),
        "symmetric": bool(plan.symmetric),
        "send_rows_per_exchange": int(plan.predicted_send_volume.sum()),
        "messages_per_exchange": int(plan.predicted_message_count.sum()),
        "digest": plan_digest(plan),
    }


class RunRecorder:
    """Owns one run directory; see module docstring."""

    def __init__(self, outdir: str, config: dict | None = None,
                 run_kind: str = "train", argv: list | None = None):
        from ..resilience.atomic import sweep_temp_litter

        self.dir = outdir
        os.makedirs(outdir, exist_ok=True)
        # manifest temp files of killed runs (a recorder is the directory's
        # only writer, so anything matching is from a dead process)
        sweep_temp_litter(outdir, schema.MANIFEST_NAME)
        self.manifest: dict = {
            "v": schema.SCHEMA_VERSION,
            "ts": time.time(),
            "run_kind": run_kind,
            "config": _jsonable(config or {}),
            "argv": list(sys.argv if argv is None else argv),
            "git_rev": _git_rev(),
        }
        self._events = open(os.path.join(outdir, schema.EVENTS_NAME), "a")
        self._write_manifest()

    # ------------------------------------------------------------- manifest
    def _write_manifest(self) -> None:
        from ..resilience.atomic import atomic_write_json

        schema.validate_manifest(self.manifest)
        atomic_write_json(os.path.join(self.dir, schema.MANIFEST_NAME),
                          self.manifest, indent=1)

    def set_plan(self, plan, partitioner: dict | None = None) -> None:
        """Record the comm plan's identity (and the partitioner provenance
        of its part vector)."""
        self.manifest["plan"] = plan_manifest_block(plan)
        if partitioner is not None:
            self.manifest["partitioner"] = _jsonable(partitioner)
        self._write_manifest()

    def set_partitioner(self, partitioner: dict) -> None:
        """Record partitioner provenance alone (the mini-batch trainer has
        one plan per batch, so there is no single plan block)."""
        self.manifest["partitioner"] = _jsonable(partitioner)
        self._write_manifest()

    def set_comm_schedule(self, decision: dict) -> None:
        """Record the transport-selection decision log
        (``parallel/plan.py::resolve_comm_schedule``)."""
        self.manifest["comm_schedule"] = _jsonable(decision)
        self._write_manifest()

    def set_profile(self, profile_dir: str) -> None:
        """Record where the ``torch.profiler`` trace of this run landed:
        the directory plus every trace file under it with its size
        (``tracing.find_trace_files``)."""
        from .tracing import find_trace_files

        self.manifest["profile"] = {
            "dir": os.path.abspath(profile_dir),
            "trace_files": find_trace_files(profile_dir),
        }
        self._write_manifest()

    def set_memory(self, block: dict) -> None:
        """Record the device memory block (``MemoryModel.block()``):
        per-family ``{model_bytes, measured_bytes, ratio}`` plus the
        total / arguments / donated joins.  Rewritten as measured joins
        arrive."""
        self.manifest["memory"] = _jsonable(block)
        self._write_manifest()

    def set_backend(self, device=None, parts: int | None = None,
                    processes: int = 1) -> None:
        """Record the torch device the run uses (``None``: the current
        CUDA device if there is one, else the CPU) and, given ``parts``,
        the ``k`` parts stacked on it; ``processes`` > 1: one process per
        part (a rank group), each on its own device."""
        import torch

        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        gpu = dev.type == "cuda"
        backend = {
            "platform": "gpu" if gpu else "cpu",
            "device_count": int(processes),
            "process_count": int(processes),
            "kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
        }
        # the devices the machine shows (the contract line's ``count``)
        backend["count"] = torch.cuda.device_count() if gpu else 1
        if parts is not None:
            backend["parts"] = int(parts)
            # all k parts on one device, or one rank per part
            backend["layout"] = "stacked" if processes == 1 else "ranks"
        self.manifest["backend"] = backend
        self._write_manifest()

    # --------------------------------------------------------------- events
    def _emit(self, ev: dict) -> None:
        ev.setdefault("v", schema.SCHEMA_VERSION)
        ev.setdefault("ts", time.time())
        ev = _jsonable(ev)
        schema.validate_event(ev)
        self._events.write(json.dumps(ev) + "\n")
        self._events.flush()

    def record_step(self, step: int, loss: float, wall_s: float,
                    err: float | None = None, grad_norm: float | None = None,
                    comm: dict | None = None, phases: dict | None = None,
                    roofline: dict | None = None, drift: dict | None = None,
                    **extra) -> None:
        ev = {"kind": "step", "step": int(step), "loss": float(loss),
              "wall_s": float(wall_s)}
        if err is not None:
            ev["err"] = float(err)
        if grad_norm is not None:
            ev["grad_norm"] = float(grad_norm)
        for k, val in (("comm", comm), ("phases", phases),
                       ("roofline", roofline), ("drift", drift)):
            if val is not None:
                ev[k] = val
        ev.update({k: v for k, v in extra.items() if v is not None})
        self._emit(ev)

    def record_eval(self, step: int, loss: float, acc: float | None = None,
                    wall_s: float | None = None) -> None:
        ev = {"kind": "eval", "step": int(step), "loss": float(loss)}
        if acc is not None:
            ev["acc"] = float(acc)
        if wall_s is not None:
            ev["wall_s"] = float(wall_s)
        self._emit(ev)

    def record_span(self, name: str, dur_s: float, parent: str | None = None,
                    depth: int = 0, **fields) -> None:
        """One measured wall-clock span (``obs.tracing.SpanTimer``)."""
        ev = {"kind": "span", "name": str(name), "dur_s": float(dur_s),
              "depth": int(depth)}
        if parent is not None:
            ev["parent"] = str(parent)
        ev.update(fields)
        self._emit(ev)

    def record_serve(self, queries: int, achieved_qps: float,
                     latency_p50_ms: float, latency_p95_ms: float,
                     latency_p99_ms: float, **fields) -> None:
        """One serving latency/throughput window: measured per-query
        latency quantiles and achieved QPS, with the batching counters and
        the analytic gauges riding along."""
        ev = {"kind": "serve", "queries": int(queries),
              "achieved_qps": float(achieved_qps),
              "latency_p50_ms": float(latency_p50_ms),
              "latency_p95_ms": float(latency_p95_ms),
              "latency_p99_ms": float(latency_p99_ms)}
        ev.update({k: v for k, v in fields.items() if v is not None})
        self._emit(ev)

    def record_checkpoint(self, step: int, path: str,
                          wall_s: float | None = None,
                          bytes: int | None = None) -> None:
        """One COMMITTED durable checkpoint, emitted after the atomic
        rename (``resilience.runner.save_and_record``)."""
        ev = {"kind": "checkpoint", "step": int(step), "path": str(path)}
        for k, val in (("wall_s", wall_s), ("bytes", bytes)):
            if val is not None:
                ev[k] = val
        self._emit(ev)

    def record_resume(self, step: int, path: str, fallback: bool = False,
                      partial_state: bool = False,
                      skipped: list | None = None) -> None:
        """One restore (the train CLI's ``--resume``): ``fallback`` marks a
        corrupt-newest → previous-intact fallback, ``partial_state`` a
        params-only restore."""
        ev = {"kind": "resume", "step": int(step), "path": str(path),
              "fallback": bool(fallback), "partial_state": bool(partial_state)}
        if skipped:
            ev["skipped"] = [str(s) for s in skipped]
        self._emit(ev)

    def record_swap(self, path: str, weights_rev: int,
                    checkpoint_step: int | None = None,
                    wall_s: float | None = None) -> None:
        """One weight hot-swap (``ServeEngine.swap_weights``), emitted after
        provenance verification and the in-place copy."""
        ev = {"kind": "swap", "path": str(path),
              "weights_rev": int(weights_rev)}
        for k, val in (("checkpoint_step", checkpoint_step),
                       ("wall_s", wall_s)):
            if val is not None:
                ev[k] = val
        self._emit(ev)

    def record_memory(self, program: str, model, measured: dict | None = None,
                      budget_bytes: int | None = None) -> None:
        """One program's analytic-vs-measured device memory join:
        ``model`` is a ``MemoryModel``, ``measured`` a dict of the
        reference's measured keys (``MemoryModel``'s docstring says how
        the port measures them), ``None`` when nothing was measured."""
        ev = {"kind": "memory", "program": str(program),
              "model_bytes": int(model.total_bytes),
              "workload": model.workload,
              "families": {name: int(b)
                           for name, b in model.families.items()}}
        if measured is not None:
            ev.update({("measured_peak_bytes" if k == "peak_bytes" else k):
                       int(v) for k, v in measured.items()})
            if model.total_bytes > 0:
                ev["ratio"] = measured["peak_bytes"] / model.total_bytes
        if budget_bytes is not None:
            ev["budget_bytes"] = int(budget_bytes)
        self._emit(ev)

    def record_heartbeat(self, event: str, **fields) -> None:
        self._emit({"kind": "heartbeat", "event": str(event),
                    "pid": os.getpid(), **fields})

    def record_summary(self, report: dict) -> None:
        """End-of-run report (the trainer's ``fit()`` dict, a CLI's JSON)."""
        self._emit({"kind": "summary", "report": _jsonable(report)})

    def close(self) -> None:
        self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------- out-of-recorder emission
def append_env_event(filename: str, ev: dict) -> None:
    """Validate and append one event to ``$SGCN_METRICS_OUT/<filename>``,
    the one emission path outside a recorder.  A no-op unless the variable
    names a directory; best effort: an ``OSError`` (a full disk) or a
    ``ValueError`` (an invalid event) does not kill the run it observes."""
    outdir = os.environ.get("SGCN_METRICS_OUT")
    if not outdir:
        return
    try:
        schema.validate_event(ev)
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, filename), "a") as fh:
            fh.write(json.dumps(_jsonable(ev)) + "\n")
    except (OSError, ValueError):
        pass


def heartbeat(event: str, **fields) -> None:
    """Append a liveness ping to ``$SGCN_METRICS_OUT/heartbeat.jsonl``
    (``pid`` and ``ts`` added; ``phase``/``detail`` optional).  A no-op
    without the variable, so callers ping at phase boundaries
    unconditionally and pay nothing when telemetry is off."""
    if not os.environ.get("SGCN_METRICS_OUT"):
        return
    append_env_event(schema.HEARTBEAT_NAME, {
        "v": schema.SCHEMA_VERSION, "ts": time.time(), "kind": "heartbeat",
        "event": str(event), "pid": os.getpid(), **fields})


# -------------------------------------------------------------------- loader
@dataclass
class RunLog:
    path: str
    manifest: dict
    events: list          # validated events.jsonl records, in write order
    heartbeats: list      # validated heartbeat.jsonl records (may be empty)

    def steps(self) -> list:
        return [e for e in self.events if e["kind"] == "step"]

    def evals(self) -> list:
        return [e for e in self.events if e["kind"] == "eval"]

    def summaries(self) -> list:
        return [e for e in self.events if e["kind"] == "summary"]

    def serves(self) -> list:
        return [e for e in self.events if e["kind"] == "serve"]

    def checkpoints(self) -> list:
        return [e for e in self.events if e["kind"] == "checkpoint"]

    def resumes(self) -> list:
        return [e for e in self.events if e["kind"] == "resume"]


def load_run(path: str) -> RunLog:
    """Load + validate one run directory; raises on a schema violation.  A
    directory holding only ``heartbeat.jsonl`` or ``events.jsonl`` (no
    recorder, only env-gated emission) is valid, with ``manifest`` ``{}``."""
    mpath = os.path.join(path, schema.MANIFEST_NAME)
    if os.path.exists(mpath):
        with open(mpath) as fh:
            manifest = json.load(fh)
        schema.validate_manifest(manifest)
    elif any(os.path.exists(os.path.join(path, n))
             for n in (schema.HEARTBEAT_NAME, schema.EVENTS_NAME)):
        manifest = {}
    else:
        raise FileNotFoundError(
            f"{path}: no {schema.MANIFEST_NAME}, {schema.HEARTBEAT_NAME} "
            f"or {schema.EVENTS_NAME} — not a run directory")

    def read_jsonl(name):
        p = os.path.join(path, name)
        if not os.path.exists(p):
            return []
        out = []
        with open(p) as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{p}:{i + 1}: not valid JSON ({e})") from e
                schema.validate_event(ev)
                out.append(ev)
        return out

    return RunLog(path=path, manifest=manifest,
                  events=read_jsonl(schema.EVENTS_NAME),
                  heartbeats=read_jsonl(schema.HEARTBEAT_NAME))


def _jsonable(x):
    """Coerce numpy scalars/arrays, tensors and other non-JSON leaves to
    JSON types."""
    import numpy as np

    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    # tensors and anything else scalar-like: try float, else repr
    try:
        return float(x)
    except (TypeError, ValueError, RuntimeError):
        return repr(x)
