"""Run-telemetry schema — the versioned vocabulary of the JSONL event stream
(a copy of ``sgcn_tpu/obs/schema.py``: the same version, event kinds,
required and optional fields and validators, so a run directory the port
writes loads through either package's ``load_run`` and renders with
``scripts/obs_report.py``).

Everything the port's recorder writes (``manifest.json``,
``events.jsonl``, ``heartbeat.jsonl``) is validated against THIS module
before it hits disk (``recorder.RunRecorder``) and again on load
(``recorder.load_run``).  Figures the port has and the reference does not
ride in the free-form ``config``/``backend`` dicts, never as new event
fields: the validators stay the reference's.

Design rules:

  * every record carries ``v`` (schema version) and ``ts`` (unix seconds);
    events additionally carry ``kind``;
  * required fields are typed; optional fields are typed WHEN present —
    unknown extra fields are allowed (forward compatibility), unknown
    ``kind`` values are not;
  * numeric health: wall-clock and step-index fields must be finite — a
    NaN wall time is always a recorder bug, while ``loss`` may be non-finite
    (a diverged run is exactly what telemetry must be able to show).

Bump ``SCHEMA_VERSION`` on any breaking field change and teach
``load_run``/``scripts/obs_report.py`` both versions for one release.

Version history:

  * **v1** — manifest + ``step``/``eval``/``heartbeat``/``summary`` events.
  * **v2** — the measured-time profiling layer (``obs/tracing.py``): adds
    the ``span`` event kind (named, optionally nested measured wall-clock
    spans), the optional ``measured_vs_model`` block on step events
    (measured-vs-analytic roofline reconciliation), and the optional
    ``profile`` manifest block (where the jax.profiler trace landed).
    Purely additive — every valid v1 record is a valid record here, and
    ``validate_event`` accepts both versions (``SUPPORTED_VERSIONS``); a
    v1 stream must never carry the v2-only ``span`` kind.
  * **v3** — the serving subsystem (``sgcn_tpu/serve/``): adds the
    ``serve`` event kind — one latency/throughput window of the inference
    engine (query count, achieved QPS, p50/p95/p99 latency, batching and
    compile counters, per-query wire-row gauge).  Purely additive again:
    v1/v2 streams load unchanged and must not carry the v3-only kind.
  * **v4** — the resilience layer (``sgcn_tpu/resilience/``,
    ``docs/resilience.md``): adds the ``checkpoint`` event kind (one
    committed durable checkpoint: step, path, bytes, save wall time) and
    the ``resume`` event kind (one restore: step, path, whether the
    newest checkpoint was corrupt and fell back, whether the restore was
    partial-state), plus the optional ``shed``/``shed_factor`` keys on
    ``serve`` events (deadline-shed query count of the window — the
    graceful-degradation counter of the micro-batcher).  Purely additive:
    v1–v3 streams load unchanged and must not carry the v4-only kinds.
  * **v5** — sub-graph serving + weight hot-swap (``docs/serving.md``
    phase 2): adds the ``swap`` event kind (one zero-recompile weight
    hot-swap: checkpoint path, the engine's post-swap ``weights_rev``) and
    the optional ``serve_mode``/``weights_rev``/``touched_rows_per_query``
    /``subgraph_flops_per_query`` keys on ``serve`` events — a window
    spanning a swap is attributable to its weight revisions, and the
    sub-graph engine's per-query analytic gauges ride the same stream.
    Purely additive: v1–v4 streams load unchanged and must not carry the
    v5-only kind.
  * **v6** — memory observability (``obs/memory.py``): adds the ``memory``
    event kind (one compiled program's analytic-vs-measured per-chip HBM
    join: the plan-derived model total against XLA's
    ``memory_analysis()`` argument/output/temp/alias/peak bytes) and the
    optional ``memory`` manifest block (the per-family ``{model_bytes,
    measured_bytes, ratio}`` breakdown — ``MemoryModel.block()``).  The
    join fields follow the ``measured_vs_model`` discipline: when both
    endpoints are present the ``ratio`` must be derivable from them.
    Purely additive: v1–v5 streams load unchanged and must not carry the
    v6-only kind.
"""

from __future__ import annotations

import math
import numbers

SCHEMA_VERSION = 6
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5, 6)

# event stream file names inside a run directory
MANIFEST_NAME = "manifest.json"
EVENTS_NAME = "events.jsonl"
HEARTBEAT_NAME = "heartbeat.jsonl"

EVENT_KINDS = ("step", "eval", "heartbeat", "summary", "span", "serve",
               "checkpoint", "resume", "swap", "memory")
# the span kind is a v2 addition, the serve kind v3, checkpoint/resume v4,
# swap v5, memory v6; a stream claiming an older version must not carry a
# newer kind
_KINDS_BY_VERSION = {1: ("step", "eval", "heartbeat", "summary"),
                     2: ("step", "eval", "heartbeat", "summary", "span"),
                     3: ("step", "eval", "heartbeat", "summary", "span",
                         "serve"),
                     4: ("step", "eval", "heartbeat", "summary", "span",
                         "serve", "checkpoint", "resume"),
                     5: ("step", "eval", "heartbeat", "summary", "span",
                         "serve", "checkpoint", "resume", "swap"),
                     6: EVENT_KINDS}

_NUM = numbers.Real
_STR = str

# kind -> {field: type} (required)
_REQUIRED = {
    "step": {"step": _NUM, "loss": _NUM, "wall_s": _NUM},
    "eval": {"step": _NUM, "loss": _NUM},
    "heartbeat": {"event": _STR},
    "summary": {"report": dict},
    # v2: one measured wall-clock span (obs/tracing.py::SpanTimer) — the
    # trainers' step/eval phases and bench.py's A/B phases all emit these,
    # so measured phase times live in the SAME stream as the analytic gauges
    "span": {"name": _STR, "dur_s": _NUM},
    # v3: one serving latency/throughput window (sgcn_tpu/serve/engine.py):
    # measured per-query latency quantiles + achieved QPS over `queries`
    # completed queries.  The quantiles are MEASURED figures (host clock
    # around submit→result), so the validator holds them to the same
    # health rules as wall_s — finite, non-negative, and ordered.
    "serve": {"queries": _NUM, "achieved_qps": _NUM,
              "latency_p50_ms": _NUM, "latency_p95_ms": _NUM,
              "latency_p99_ms": _NUM},
    # v4: one committed durable checkpoint (resilience.runner) — emitted
    # AFTER the atomic rename, so an event in the stream means the file
    # named was fully on disk at that moment
    "checkpoint": {"step": _NUM, "path": _STR},
    # v4: one restore (trainer CLI --resume): ``fallback`` true when the
    # newest checkpoint was corrupt and an older intact one was used;
    # ``partial_state`` true when a pre-full-state file loaded params-only
    "resume": {"step": _NUM, "path": _STR},
    # v5: one zero-recompile weight hot-swap (ServeEngine.swap_weights):
    # emitted AFTER provenance verification and the in-place leaf swap, so
    # every serve event after it describes the new ``weights_rev``
    "swap": {"path": _STR, "weights_rev": _NUM},
    # v6: one compiled program's analytic-vs-measured per-chip HBM join
    # (obs/memory.py): ``model_bytes`` is the plan-derived analytic total —
    # always computable, like measured_vs_model's model_s; the measured
    # side (XLA memory_analysis) rides as optional fields
    "memory": {"program": _STR, "model_bytes": _NUM},
}

# kind -> {field: type} (optional, typed when present)
_OPTIONAL = {
    "step": {
        "err": _NUM,          # the MPI stack's `err` metric (loss='bce')
        "grad_norm": _NUM,    # global L2 norm of the psum'd weight grads
        "comm": dict,         # cumulative CommStats.report() snapshot
        "phases": dict,       # PhaseTimer.report() snapshot
        "roofline": dict,     # attribution.roofline_fields output
        "drift": dict,        # stale-halo drift gauges (see below)
        "replica": dict,      # hot-halo replication gauges (see below)
        "epoch": _NUM,
        "batch": _NUM,        # mini-batch trainer: batch index within epoch
        # v2: measured-vs-analytic reconciliation block (obs/tracing.py):
        # the span-measured phase-time total of this step joined against
        # attribution.step_cost per component (ratio + absolute error) —
        # a mispredicting cost model becomes a visible gauge
        "measured_vs_model": dict,
    },
    "eval": {"acc": _NUM, "wall_s": _NUM},
    "heartbeat": {"pid": _NUM, "phase": _STR, "detail": _STR},
    "summary": {},
    "span": {
        "parent": (str, type(None)),  # enclosing span's name (None = root)
        "depth": _NUM,        # nesting depth at entry (0 = root)
        "step": _NUM,         # optimizer step the span belongs to, if any
        "pid": _NUM,          # emitting process (bench A/B children differ)
        "phase": _STR,        # coarse phase label (bench arms, trainer fit)
        "detail": _STR,
    },
    "serve": {
        "window_s": _NUM,       # wall-clock span of this window
        "offered_qps": _NUM,    # open-loop target rate (absent closed-loop)
        "mode": _STR,           # 'open' or 'closed' loop generator
        "batches": _NUM,        # micro-batches executed
        "mean_batch": _NUM,     # mean queries per micro-batch
        "deadline_flushes": _NUM,   # flushed by the latency budget
        "full_flushes": _NUM,       # flushed by max-batch
        "latency_budget_ms": _NUM,
        "compiles": _NUM,       # AOT bucket compiles (0 in steady state —
        #                         the no-recompile contract's gauge)
        "buckets": list,        # padded batch-size buckets pre-compiled
        "comm_schedule": _STR,  # resolved transport of the forward
        "wire_rows_per_query": _NUM,   # analytic: L·wire_rows/exchange ÷
        #                                max_batch (plan-derived, zero-band)
        # v4 additive: deadline shedding (docs/resilience.md): queries
        # whose age already exceeded budget × shed_factor before dispatch
        # were returned as shed markers instead of silently blowing p99
        "shed": _NUM,
        "shed_factor": _NUM,
        # v5 additive: sub-graph serving + hot-swap attribution
        # (docs/serving.md phase 2): which engine mode served the window,
        # under which weight revision, and — sub-graph mode only — the
        # accumulated per-query receptive-set gauges (analytic, zero-band)
        "serve_mode": _STR,
        "weights_rev": _NUM,
        "touched_rows_per_query": _NUM,
        "subgraph_flops_per_query": _NUM,
    },
    "checkpoint": {
        "bytes": _NUM,        # committed file size
        "wall_s": _NUM,       # save duration (host clock around the write)
    },
    "resume": {
        "fallback": bool,     # newest checkpoint corrupt, older one used
        "partial_state": bool,  # pre-full-state file: params-only restore
        "skipped": list,      # corrupt checkpoint paths passed over
    },
    "swap": {
        "checkpoint_step": _NUM,  # the swapped checkpoint's training step
        "wall_s": _NUM,           # load+verify+swap duration (host clock)
    },
    "memory": {
        "workload": _STR,             # 'train' | 'serve' | 'serve_subgraph'
        "measured_peak_bytes": _NUM,  # arg + out + temp − alias (per device)
        "argument_bytes": _NUM,       # XLA memory_analysis components
        "output_bytes": _NUM,
        "temp_bytes": _NUM,
        "alias_bytes": _NUM,          # donated set (0 for serve programs)
        "generated_code_bytes": _NUM,
        "ratio": _NUM,                # measured_peak / model — must be
        #                               derivable from its own record
        "families": dict,             # per-family model_bytes detail
        "budget_bytes": _NUM,         # the --memory-budget in force, if any
    },
}

# comm snapshot: the CommStats.report() keys every step event must reconcile
# (hidden + exposed == total — asserted by tests/test_metrics_cli.py)
COMM_SPLIT_KEYS = ("exchanges", "exposed_exchanges", "hidden_exchanges",
                   "exposed_send_volume", "hidden_send_volume",
                   "total_send_volume")

# roofline wire-byte fields (PR-4, backward-compatible v1 addition): when a
# step event's roofline block carries ANY of these, it must carry them all —
# the padded-vs-true split is meaningless in halves.  Old run directories
# (rooflines without the split) still validate: absence is legal, an
# incomplete split is not.  ``halo_bytes_true_per_step`` is the Σ(λ−1)
# volume the partitioner optimizes; ``halo_bytes_wire_per_step`` what the
# selected schedule ships (k²·S·f dense a2a, Σ_d k·S_d·f ragged);
# ``padding_efficiency`` their row-level ratio in [0, 1].
ROOFLINE_WIRE_KEYS = ("comm_schedule", "halo_bytes_true_per_step",
                      "halo_bytes_wire_per_step",
                      "halo_wire_rows_per_exchange", "padding_efficiency")
COMM_SCHEDULES = ("a2a", "ragged", "mixed")

# drift-gauge fields (stale mode only): the AUTHORITATIVE field list —
# ``validate_event`` requires every one of these in a step event's ``drift``
# block, so this tuple, the trainer's ``_drift_fields`` and the
# docs/observability.md glossary cannot drift apart
DRIFT_KEYS = ("staleness_age", "sync_step", "halo_drift_rms",
              "halo_drift_rel", "halo_quant_err_rms")

# One OPTIONAL drift field, validated when present (see validate_event):
# ``round_age`` is the composed (stale × ragged) mode's per-round
# staleness-age vector — one entry per ring round, the age of the buffer
# this step CONSUMED (0 = received this step, N = carried N steps,
# null = empty round, ships nothing).

# replica-gauge fields (--replica-budget mode only): the AUTHORITATIVE
# field list — ``validate_event`` requires every one of these in a step
# event's ``replica`` block (``FullBatchTrainer._replica_fields``):
# ``refresh_age`` = steps since the replica tables were last refreshed,
# ``replica_drift_rms``/``_rel`` = per-layer ‖replica − fresh‖ measured AT
# each refresh (the drift the refresh erased; identically zero between
# refreshes, where no fresh value exists to compare against),
# ``replica_rows`` = the plan's replicated row count.
REPLICA_KEYS = ("refresh_age", "sync_step", "replica_rows",
                "replica_drift_rms", "replica_drift_rel")

# OPTIONAL replica fields, validated when present: drift-banded PARTIAL
# refresh (--refresh-band, docs/replication.md) stamps refresh steps with
# ``refresh_kind`` ('full' | 'partial') and, on partial steps, the ACTUAL
# per-layer side-channel rows shipped (``refresh_rows`` — the per-step
# face of CommStats' partial_refresh_* cumulative booking) plus the
# static padded side-channel wire rows (``refresh_wire_rows``).
REPLICA_REFRESH_KINDS = ("full", "partial")

_MANIFEST_REQUIRED = {"v": _NUM, "ts": _NUM, "run_kind": _STR, "config": dict}
_MANIFEST_OPTIONAL = {
    "argv": list, "git_rev": (str, type(None)), "backend": dict,
    "mesh": dict, "plan": dict, "partitioner": (dict, type(None)),
    # resolve_comm_schedule's decision log (asked/resolved/rule + the
    # wire-row inputs) — how an 'auto' transport pick is reconstructible
    # from the run directory alone
    "comm_schedule": dict,
    # v2: where the jax.profiler trace of this run landed (--profile +
    # --metrics-out composed): directory, trace-event JSON path(s) and
    # their gzip'd sizes — obs_report.py parses the trace from the run
    # directory alone (obs/tracing.py::find_trace_files)
    "profile": dict,
    # v6: the per-chip HBM footprint block (obs/memory.py::MemoryModel
    # .block()): per-family {model_bytes, measured_bytes, ratio} plus the
    # total/arguments/donated aggregate joins — validated below so a
    # manifest's memory claims are self-consistent
    "memory": dict,
}

# memory-join entries ({model_bytes, measured_bytes, ratio} — the manifest
# memory block's per-family rows and the aggregate rows): model_bytes is
# required and non-negative; measured_bytes may be None (no compiled
# program measured yet); when both endpoints are present and model > 0 the
# ratio must be derivable from them (same rule as measured_vs_model).
_MEMORY_AGGREGATES = ("total", "arguments", "donated")

# measured_vs_model component entries: required/optional numeric fields.
# ``model_s`` is the analytic prediction, ``measured_s`` the span- or
# trace-derived figure (None = the measured side has no probe for this
# component in this run); when both are present the writer must also ship
# the join — ``ratio`` (measured/model) and ``abs_err_s`` (measured−model)
# — and they must be CONSISTENT with the endpoints (an inconsistent join
# is a writer bug, not a run fact).
_MVM_REL_TOL = 1e-6


def _check_fields(rec: dict, required: dict, optional: dict, what: str) -> None:
    for f, t in required.items():
        if f not in rec:
            raise ValueError(f"{what}: missing required field {f!r}: {rec}")
        if not isinstance(rec[f], t) or isinstance(rec[f], bool) and t is _NUM:
            raise ValueError(
                f"{what}: field {f!r} has type {type(rec[f]).__name__}, "
                f"expected {t}")
    for f, t in optional.items():
        if f in rec and rec[f] is not None and not isinstance(rec[f], t):
            raise ValueError(
                f"{what}: optional field {f!r} has type "
                f"{type(rec[f]).__name__}, expected {t}")


def _validate_measured_vs_model(mvm: dict) -> None:
    if not isinstance(mvm.get("phase_total_s"), _NUM) \
            or isinstance(mvm.get("phase_total_s"), bool) \
            or not math.isfinite(mvm["phase_total_s"]) \
            or mvm["phase_total_s"] < 0:
        raise ValueError(
            "measured_vs_model: missing/non-finite phase_total_s "
            f"(got {mvm.get('phase_total_s')!r}) — the span-measured "
            "phase-time total is the block's anchor")
    comps = mvm.get("components")
    if not isinstance(comps, dict) or not comps:
        raise ValueError(
            "measured_vs_model: missing/empty components dict")
    for name, c in comps.items():
        if not isinstance(c, dict):
            raise ValueError(
                f"measured_vs_model component {name!r} is not a dict")
        ms = c.get("model_s")
        if not (isinstance(ms, _NUM) and not isinstance(ms, bool)
                and math.isfinite(ms) and ms >= 0):
            raise ValueError(
                f"measured_vs_model component {name!r}: model_s={ms!r} "
                "(the analytic side must always be computable)")
        meas = c.get("measured_s")
        if meas is None:
            continue
        if not (isinstance(meas, _NUM) and not isinstance(meas, bool)
                and math.isfinite(meas) and meas >= 0):
            raise ValueError(
                f"measured_vs_model component {name!r}: "
                f"measured_s={meas!r}")
        if ms > 0:
            for f, want in (("ratio", meas / ms), ("abs_err_s", meas - ms)):
                got = c.get(f)
                if not (isinstance(got, _NUM) and not isinstance(got, bool)
                        and math.isfinite(got)
                        and abs(got - want)
                        <= _MVM_REL_TOL * max(abs(want), 1.0)):
                    raise ValueError(
                        f"measured_vs_model component {name!r}: {f}={got!r} "
                        f"inconsistent with measured/model endpoints "
                        f"(expected {want!r}) — the join must be derivable "
                        "from its own record")


def _validate_memory_join(entry, what: str) -> None:
    if not isinstance(entry, dict):
        raise ValueError(f"{what}: memory join entry must be a dict, got "
                         f"{type(entry).__name__}")
    mb = entry.get("model_bytes")
    if not (isinstance(mb, _NUM) and not isinstance(mb, bool)
            and math.isfinite(mb) and mb >= 0):
        raise ValueError(
            f"{what}: model_bytes={mb!r} (the analytic side must always "
            "be a non-negative byte count)")
    meas = entry.get("measured_bytes")
    if meas is None:
        return
    if not (isinstance(meas, _NUM) and not isinstance(meas, bool)
            and math.isfinite(meas) and meas >= 0):
        raise ValueError(f"{what}: measured_bytes={meas!r}")
    if mb > 0:
        want = meas / mb
        got = entry.get("ratio")
        if not (isinstance(got, _NUM) and not isinstance(got, bool)
                and math.isfinite(got)
                and abs(got - want) <= _MVM_REL_TOL * max(abs(want), 1.0)):
            raise ValueError(
                f"{what}: ratio={got!r} inconsistent with measured/model "
                f"endpoints (expected {want!r}) — the join must be "
                "derivable from its own record")


def _validate_memory_block(mem: dict) -> None:
    fams = mem.get("families")
    if not isinstance(fams, dict) or not fams:
        raise ValueError(
            "manifest memory block: missing/empty families dict — the "
            "itemized per-family breakdown IS the block")
    for name, entry in fams.items():
        _validate_memory_join(entry, f"memory family {name!r}")
    for agg in _MEMORY_AGGREGATES:
        if agg not in mem:
            raise ValueError(
                f"manifest memory block missing the {agg!r} aggregate "
                f"join (must carry all of {_MEMORY_AGGREGATES})")
        _validate_memory_join(mem[agg], f"memory aggregate {agg!r}")


def validate_event(ev: dict) -> None:
    """Raise ``ValueError`` unless ``ev`` is a valid event under its own
    declared schema version (``SUPPORTED_VERSIONS`` — v1 streams written
    before the measured-time layer still load)."""
    if not isinstance(ev, dict):
        raise ValueError(f"event must be a dict, got {type(ev).__name__}")
    v = ev.get("v")
    if v not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"event schema version {v!r} not in {SUPPORTED_VERSIONS}")
    kind = ev.get("kind")
    kinds = _KINDS_BY_VERSION[v]
    if kind not in kinds:
        raise ValueError(
            f"unknown event kind {kind!r} for schema v{v} (know {kinds})")
    if not isinstance(ev.get("ts"), _NUM):
        raise ValueError(f"event missing numeric ts: {ev}")
    _check_fields(ev, _REQUIRED[kind], _OPTIONAL[kind], f"{kind} event")
    # wall-clock / index health: a NaN here is a recorder bug, not a run fact
    for f in ("step", "wall_s", "epoch", "batch", "dur_s", "depth"):
        if f in ev and isinstance(ev[f], _NUM) and not math.isfinite(ev[f]):
            raise ValueError(f"{kind} event: non-finite {f}={ev[f]}")
    if kind == "span":
        if ev["dur_s"] < 0:
            raise ValueError(f"span event: negative dur_s={ev['dur_s']}")
        if "depth" in ev and ev["depth"] < 0:
            raise ValueError(f"span event: negative depth={ev['depth']}")
    if kind == "checkpoint":
        for f in ("step", "bytes", "wall_s"):
            if f in ev and isinstance(ev[f], _NUM) and ev[f] < 0:
                raise ValueError(
                    f"checkpoint event: negative {f}={ev[f]}")
    if kind == "resume":
        if "step" in ev and isinstance(ev["step"], _NUM) and ev["step"] < 0:
            raise ValueError(f"resume event: negative step={ev['step']}")
    if kind == "swap":
        for f in ("weights_rev", "checkpoint_step", "wall_s"):
            if f in ev and isinstance(ev[f], _NUM) and (
                    not math.isfinite(ev[f]) or ev[f] < 0):
                raise ValueError(
                    f"swap event: non-finite/negative {f}={ev[f]}")
    if kind == "serve":
        for f in ("queries", "achieved_qps", "latency_p50_ms",
                  "latency_p95_ms", "latency_p99_ms", "window_s",
                  "offered_qps", "batches", "mean_batch",
                  "deadline_flushes", "full_flushes", "latency_budget_ms",
                  "compiles", "wire_rows_per_query", "shed", "shed_factor",
                  "weights_rev", "touched_rows_per_query",
                  "subgraph_flops_per_query"):
            if f in ev and isinstance(ev[f], _NUM) and (
                    not math.isfinite(ev[f]) or ev[f] < 0):
                raise ValueError(
                    f"serve event: non-finite/negative {f}={ev[f]}")
        p50, p95, p99 = (ev["latency_p50_ms"], ev["latency_p95_ms"],
                         ev["latency_p99_ms"])
        if not p50 <= p95 <= p99:
            raise ValueError(
                f"serve event: latency quantiles out of order "
                f"(p50={p50}, p95={p95}, p99={p99}) — a quantile "
                "inversion is a writer bug, not a run fact")
        if "mode" in ev and ev["mode"] not in ("open", "closed"):
            raise ValueError(
                f"serve event: mode={ev['mode']!r} not 'open'/'closed'")
        if "serve_mode" in ev and ev["serve_mode"] not in ("full",
                                                          "subgraph"):
            raise ValueError(
                f"serve event: serve_mode={ev['serve_mode']!r} not "
                "'full'/'subgraph'")
    if kind == "memory":
        for f in ("model_bytes", "measured_peak_bytes", "argument_bytes",
                  "output_bytes", "temp_bytes", "alias_bytes",
                  "generated_code_bytes", "ratio", "budget_bytes"):
            if f in ev and isinstance(ev[f], _NUM) and (
                    not math.isfinite(ev[f]) or ev[f] < 0):
                raise ValueError(
                    f"memory event: non-finite/negative {f}={ev[f]}")
        if "workload" in ev and ev["workload"] not in (
                "train", "serve", "serve_subgraph"):
            raise ValueError(
                f"memory event: workload={ev['workload']!r} not "
                "'train'/'serve'/'serve_subgraph'")
        if "ratio" in ev and isinstance(ev.get("measured_peak_bytes"), _NUM) \
                and ev["model_bytes"] > 0:
            want = ev["measured_peak_bytes"] / ev["model_bytes"]
            if abs(ev["ratio"] - want) > _MVM_REL_TOL * max(abs(want), 1.0):
                raise ValueError(
                    f"memory event: ratio={ev['ratio']!r} inconsistent "
                    f"with measured/model endpoints (expected {want!r})")
    if kind == "step" and isinstance(ev.get("measured_vs_model"), dict):
        _validate_measured_vs_model(ev["measured_vs_model"])
    if kind == "step" and "comm" in ev and ev["comm"] is not None:
        comm = ev["comm"]
        missing = [k for k in COMM_SPLIT_KEYS if k not in comm]
        if missing:
            raise ValueError(
                f"step event comm snapshot missing {missing} "
                "(must be a full CommStats.report())")
        if (comm["exposed_exchanges"] + comm["hidden_exchanges"]
                != comm["exchanges"]):
            raise ValueError(
                "step event comm snapshot violates the hidden/exposed "
                f"split: {comm['exposed_exchanges']} + "
                f"{comm['hidden_exchanges']} != {comm['exchanges']}")
    if kind == "step" and isinstance(ev.get("roofline"), dict):
        roof = ev["roofline"]
        present = [k for k in ROOFLINE_WIRE_KEYS if k in roof]
        if present and len(present) != len(ROOFLINE_WIRE_KEYS):
            missing = [k for k in ROOFLINE_WIRE_KEYS if k not in roof]
            raise ValueError(
                f"step event roofline carries a partial wire split "
                f"(has {present}, missing {missing}) — ship all of "
                "ROOFLINE_WIRE_KEYS or none")
        if present:
            if roof["comm_schedule"] not in COMM_SCHEDULES:
                raise ValueError(
                    f"roofline comm_schedule {roof['comm_schedule']!r} not "
                    f"one of {COMM_SCHEDULES}")
            pe = roof["padding_efficiency"]
            if not (isinstance(pe, _NUM) and 0 <= pe <= 1):
                raise ValueError(
                    f"roofline padding_efficiency {pe!r} outside [0, 1]")
            if roof["halo_bytes_wire_per_step"] \
                    < roof["halo_bytes_true_per_step"]:
                raise ValueError(
                    "roofline wire bytes below true bytes — a schedule "
                    "cannot ship less than the unpadded volume "
                    f"({roof['halo_bytes_wire_per_step']} < "
                    f"{roof['halo_bytes_true_per_step']})")
    if kind == "step" and ev.get("drift") is not None:
        missing = [k for k in DRIFT_KEYS if k not in ev["drift"]]
        if missing:
            raise ValueError(
                f"step event drift block missing {missing} "
                f"(must carry every DRIFT_KEYS field)")
        ra = ev["drift"].get("round_age")
        if ra is not None:
            if not isinstance(ra, list) or any(
                    not (x is None or (isinstance(x, _NUM)
                                       and not isinstance(x, bool)
                                       and x >= 0)) for x in ra):
                raise ValueError(
                    f"drift round_age must be a list of null / non-negative "
                    f"ages (one per ring round), got {ra!r}")
    if kind == "step" and ev.get("replica") is not None:
        rb = ev["replica"]
        missing = [k for k in REPLICA_KEYS if k not in rb]
        if missing:
            raise ValueError(
                f"step event replica block missing {missing} "
                f"(must carry every REPLICA_KEYS field)")
        for f in ("refresh_age", "replica_rows"):
            if not (isinstance(rb[f], _NUM) and not isinstance(rb[f], bool)
                    and math.isfinite(rb[f]) and rb[f] >= 0):
                raise ValueError(
                    f"replica block: non-finite/negative {f}={rb[f]!r}")
        for f in ("replica_drift_rms", "replica_drift_rel"):
            v = rb[f]
            if not isinstance(v, list) or any(
                    not (isinstance(x, _NUM) and not isinstance(x, bool)
                         and math.isfinite(x) and x >= 0) for x in v):
                raise ValueError(
                    f"replica block: {f} must be a list of finite "
                    f"non-negative per-layer norms, got {v!r}")
        if "refresh_kind" in rb and \
                rb["refresh_kind"] not in REPLICA_REFRESH_KINDS:
            raise ValueError(
                f"replica block: refresh_kind={rb['refresh_kind']!r} not "
                f"one of {REPLICA_REFRESH_KINDS}")
        if rb.get("refresh_kind") == "partial":
            rr = rb.get("refresh_rows")
            if not isinstance(rr, list) or any(
                    not (isinstance(x, _NUM) and not isinstance(x, bool)
                         and math.isfinite(x) and x >= 0) for x in rr):
                raise ValueError(
                    "replica block: a partial refresh must carry "
                    f"refresh_rows as per-layer non-negative counts, got "
                    f"{rr!r}")
            w = rb.get("refresh_wire_rows")
            if not (isinstance(w, _NUM) and not isinstance(w, bool)
                    and math.isfinite(w) and w >= 0):
                raise ValueError(
                    "replica block: a partial refresh must carry "
                    f"refresh_wire_rows >= 0, got {w!r}")


def validate_manifest(m: dict) -> None:
    """Raise ``ValueError`` unless ``m`` is a valid manifest under its own
    declared schema version (v1 manifests still load)."""
    if not isinstance(m, dict):
        raise ValueError(f"manifest must be a dict, got {type(m).__name__}")
    if m.get("v") not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"manifest schema version {m.get('v')!r} not in "
            f"{SUPPORTED_VERSIONS}")
    _check_fields(m, _MANIFEST_REQUIRED, _MANIFEST_OPTIONAL, "manifest")
    if isinstance(m.get("memory"), dict):
        _validate_memory_block(m["memory"])
    prof = m.get("profile")
    if isinstance(prof, dict):
        if not isinstance(prof.get("dir"), str):
            raise ValueError(
                f"manifest profile block missing string 'dir': {prof}")
        tf = prof.get("trace_files")
        if tf is not None and not (
                isinstance(tf, list)
                and all(isinstance(e, dict) and isinstance(e.get("path"), str)
                        and isinstance(e.get("bytes"), _NUM)
                        for e in tf)):
            raise ValueError(
                "manifest profile.trace_files must be a list of "
                f"{{path, bytes}} dicts, got {tf!r}")
