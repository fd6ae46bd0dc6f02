"""Run telemetry of the port (port of ``sgcn_tpu/obs``).

  * ``recorder``    — ``RunRecorder`` (manifest, append-only event
    stream), the ``load_run`` loader and the plan digest checkpoints
    record;
  * ``schema``      — the reference's versioned event vocabulary, copied;
  * ``tracing``     — nested spans and the ``torch.profiler`` trace parser
    over the port's one table of kernel names;
  * ``memory``      — the analytic device footprint, the ``--memory-budget``
    gate and the card's measured join;
  * ``attribution`` — the analytic FLOP counts of serving.

Wired through ``FullBatchTrainer.attach_recorder`` /
``MiniBatchTrainer.attach_recorder`` / ``ServeEngine.attach_recorder``,
``resilience.run_resumable`` and both CLIs (``--metrics-out``,
``--profile``, ``--memory-budget``).  A run directory renders with
``scripts/obs_report.py``.  Outside a recorder, ``heartbeat`` (through
``recorder.append_env_event``) appends liveness pings to
``$SGCN_METRICS_OUT/heartbeat.jsonl``: the launch rendezvous
(``parallel/launch.py``) and the train CLI's phases write them.  The
reference's step cost model, roofline fields and ``measured_vs_model``
block, and its span emitters (``emit_span``, ``scoped_span``), are
ROADMAP A10's remainder.
"""

from .memory import (MEM_MODEL_TOL, MemoryBudgetError, MemoryModel,
                     check_memory_budget, measure_device_step, memory_model,
                     minibatch_memory_model, parse_bytes, reconcile)
from .recorder import (RunLog, RunRecorder, append_env_event, heartbeat,
                       load_run, plan_digest, plan_manifest_block)
from .schema import SCHEMA_VERSION, validate_event, validate_manifest
from .tracing import (KERNEL_TABLE, TRACE_CLASSES, SpanTimer, TraceSummary,
                      classify_op, find_trace_files, kernel_label,
                      summarize_trace)

__all__ = [
    "KERNEL_TABLE", "MEM_MODEL_TOL", "SCHEMA_VERSION", "TRACE_CLASSES",
    "MemoryBudgetError", "MemoryModel", "RunLog", "RunRecorder",
    "SpanTimer", "TraceSummary", "append_env_event",
    "check_memory_budget", "classify_op", "find_trace_files",
    "heartbeat", "kernel_label", "load_run", "measure_device_step",
    "memory_model", "minibatch_memory_model", "parse_bytes", "plan_digest",
    "plan_manifest_block", "reconcile", "summarize_trace",
    "validate_event", "validate_manifest",
]
