"""Serving CLI of the port — sustained synthetic query traffic over a
partitioned GCN or GAT (``--model gat``), with a trained checkpoint's
weights (``--checkpoint CKPT``) or random ones (``--random-init``).

::

    python -m sgcn_tpu_torch.serve --npz tests/fixtures/cora2708.npz \\
        --normalize -p tests/fixtures/cora2708.8.hp -s 8 --checkpoint CKPT

Same flag names as ``python -m sgcn_tpu.serve`` for the subset ported
here, plus ``--device {cuda,cpu}`` (default cuda; without a GPU the run
fails unless ``--device cpu`` is given).  ``--comm-schedule
{a2a,ragged,auto}`` picks the halo transport (default
``$SGCN_COMM_SCHEDULE``, else a2a); ``--halo-dtype bfloat16`` narrows the
GCN exchange's wire.  ``--checkpoint`` (either package's ``.npz``) has its
plan digest and model config verified, and its config supplies the model,
widths and activations (the flags fill the gaps);
``--watch-checkpoint-dir DIR`` hot-swaps the newest intact checkpoint of
a trainer's ``--checkpoint-dir`` in before each micro-batch.
``--serve-mode subgraph`` computes only each batch's L-hop receptive rows
(``serve/subgraph.py``; a GCN plan must be symmetric), ``--concurrent``
submits batch t+1 before batch t's result is read, ``--shed-factor F``
returns queries older than ``F`` × the latency budget at dispatch as shed.
``--metrics-out DIR`` writes the run's telemetry (manifest, the window's
``serve`` event, span, swap and memory events; render with
``scripts/obs_report.py DIR``); ``--memory-budget BYTES`` fails a mode
whose analytic device footprint exceeds the budget before any tensor
ships.  Launched by ``torchrun`` or under SLURM (``launch/gpu.slurm -m
serve``), the CLI opens a rank group first
(``parallel/launch.py::init_distributed``; one process is the stacked
layout): a world of ``-s K`` processes serves one part per rank
(``ServeEngine(mesh=...)``; both modes, both transports, every flag
above), every rank loads the inputs and builds the plan, rank 0 alone
runs the traffic, prints and records ``--metrics-out``, the others
follow its batches, and every rank appends its rendezvous and
``serve:start|done`` heartbeats to ``--metrics-out``'s
``heartbeat.jsonl``; another world size exits with the reason on every
rank.  Prints ONE JSON line: achieved QPS, p50/p95/p99 latency, the
shed count, the batching/wire gauges (sub-graph mode: touched rows,
recipe edges and FLOPs per query) and the ``memory`` block, under the
reference's keys, with ``"weights": "checkpoint"`` or
``"random-init"``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _mem_budget(text: str) -> int:
    """``--memory-budget`` values: bytes with optional binary suffix
    (``512M``, ``2G``; ``obs/memory.py::parse_bytes``)."""
    from ..obs.memory import parse_bytes

    try:
        return parse_bytes(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="sgcn_tpu_torch partitioned inference")
    p.add_argument("-a", "--adjacency", default=None,
                   help=".mtx adjacency (or use --npz)")
    p.add_argument("--npz", default=None,
                   help="planetoid/ogbn-style .npz snapshot")
    p.add_argument("--features-mtx", default=None)
    p.add_argument("--normalize", action="store_true",
                   help="apply Â normalization to the input adjacency")
    p.add_argument("-p", "--partvec", required=True,
                   help="part vector: text (.gp/.hp/.rp) or pickle")
    p.add_argument("-s", "--nparts", type=int, required=True)
    p.add_argument("--checkpoint", default=None,
                   help="trainer checkpoint .npz; its provenance block "
                        "(plan digest + model config) is verified and "
                        "supplies model/widths when present")
    p.add_argument("--random-init", action="store_true",
                   help="serve fresh Glorot-init weights instead of a "
                        "checkpoint (latency benching only — the JSON "
                        "records it)")
    p.add_argument("--model", default=None, choices=["gcn", "gat"],
                   help="gcn, or gat (PGAT: no inter-layer activation); "
                        "fallback when the checkpoint carries no config "
                        "(default gcn)")
    p.add_argument("-l", "--nlayers", type=int, default=2)
    p.add_argument("-f", "--nfeatures", type=int, default=16)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--classes", type=int, default=None,
                   help="output width (default: labels' class count when "
                        "the snapshot carries labels, else nfeatures)")
    p.add_argument("--qps", type=float, default=0.0,
                   help="offered query rate (open loop); 0 = closed loop")
    p.add_argument("--queries", type=int, default=200,
                   help="total synthetic queries in the window")
    p.add_argument("--latency-budget-ms", type=float, default=50.0,
                   help="micro-batcher deadline: flush once the oldest "
                        "pending query has waited this long")
    p.add_argument("--shed-factor", type=float, default=None, metavar="F",
                   help="deadline shedding (docs/resilience.md): a query "
                        "whose age already exceeds latency-budget-ms × F "
                        "at dispatch is returned as an explicit shed "
                        "marker instead of silently blowing the p99; "
                        "the shed count lands in the serve event (F >= 1; "
                        "default: never shed)")
    p.add_argument("--serve-mode", default="full",
                   choices=["full", "subgraph"],
                   help="'full' recomputes the whole partitioned forward "
                        "per micro-batch; 'subgraph' computes only the "
                        "routed queries' L-hop receptive sets — "
                        "query-proportional FLOPs (docs/serving.md phase "
                        "2); a GCN plan must be symmetric")
    p.add_argument("--concurrent", action="store_true",
                   help="double-buffered dispatch: submit batch t+1 while "
                        "batch t's device program runs (the serve:overlap "
                        "span measures the host/device overlap)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--buckets", default=None,
                   help="comma-separated padded batch-size buckets "
                        "(default: doubling ladder up to max-batch)")
    p.add_argument("--query-skew", type=float, default=0.0,
                   help="Zipf exponent of the synthetic query distribution "
                        "(0 = uniform)")
    p.add_argument("--comm-schedule", default=None,
                   choices=["a2a", "ragged", "auto"],
                   help="halo transport: a2a = dense padded exchange "
                        "(default), ragged = per-round-sized ring (same "
                        "bits, fewer wire rows on skewed partitions), auto "
                        "= ragged when the a2a's padding efficiency is "
                        "below 0.5; unset reads $SGCN_COMM_SCHEDULE")
    p.add_argument("--halo-dtype", default=None, choices=["bfloat16"],
                   help="wire-only exchange dtype (GCN)")
    p.add_argument("--watch-checkpoint-dir", default=None, metavar="DIR",
                   help="poll a --checkpoint-dir rotation directory once "
                        "per micro-batch and hot-swap the newest INTACT "
                        "checkpoint into the running server")
    p.add_argument("--metrics-out", default=None, metavar="DIR",
                   help="run-telemetry directory (sgcn_tpu_torch.obs): "
                        "manifest + serve/span events; render with "
                        "scripts/obs_report.py")
    p.add_argument("--memory-budget", type=_mem_budget, default=None,
                   metavar="BYTES",
                   help="device memory budget (suffixes K/M/G/T, e.g. "
                        "2G): the analytic footprint model "
                        "(sgcn_tpu_torch.obs.memory) is checked before "
                        "any tensor ships; over budget fails with the "
                        "itemized per-family breakdown")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the forward runs (default cuda; no CPU "
                        "fallback)")
    args = p.parse_args(argv)

    if not args.checkpoint and not args.random_init:
        raise SystemExit("need --checkpoint CKPT or --random-init")
    if args.checkpoint and args.random_init:
        raise SystemExit("--checkpoint and --random-init are exclusive")

    # the heartbeats (obs/recorder.py::heartbeat) read this variable: set
    # before the rendezvous so its pings land in the run directory, and
    # put back after the run for an in-process caller
    import os

    before = os.environ.get("SGCN_METRICS_OUT")
    if args.metrics_out:
        os.environ["SGCN_METRICS_OUT"] = args.metrics_out
    try:
        report, lead = _launched_run(args)
    finally:
        if args.metrics_out and before is None:
            os.environ.pop("SGCN_METRICS_OUT", None)
        elif args.metrics_out:
            os.environ["SGCN_METRICS_OUT"] = before
    if lead:
        print(json.dumps(report), flush=True)


def _launched_run(args):
    """The run inside the launcher's rendezvous (a no-op for one
    process; ``torchrun``'s or SLURM's otherwise), bracketed by heartbeats
    on every rank.  Returns ``(report, whether this process prints it)``:
    rank 0 alone."""
    from ..obs.recorder import heartbeat
    from ..parallel.launch import init_distributed
    from ..utils.backend import resolve_device

    ctx = init_distributed(device=args.device)
    try:
        mesh = _rank_group(args, ctx)
        device = resolve_device(mesh.device if mesh is not None
                                else args.device)
        inputs = _load_inputs(args)
        where = f"rank {ctx.process_id}/{ctx.num_processes}"
        heartbeat("serve:start", phase="serve", detail=where)
        report = _serve(args, device, inputs, mesh)
        heartbeat("serve:done", phase="serve", detail=where)
    finally:
        ctx.close()
    return report, ctx.is_coordinator


def _rank_group(args, ctx):
    """The run's ``RankGroup`` (one process per part) or ``None`` (one
    process: the stacked layout); another world size exits on every rank
    after a barrier (the slowest finishes its rendezvous first)."""
    import torch.distributed as dist

    from ..parallel.launch import global_mesh_1d

    if ctx.num_processes == 1:
        return None
    try:
        return global_mesh_1d(args.nparts, ctx)
    except ValueError as e:
        dist.barrier()
        raise SystemExit(str(e)) from e


def _load_inputs(args):
    """The graph, features, labels and part vector the flags name, checked
    against each other: ``(a, feats, labels, pv)``."""
    import numpy as np

    from ..io.mtx import read_dense_features, read_mtx
    from ..partition.emit import read_partvec, read_partvec_pickle
    from ..prep.normalize import normalize_adjacency

    feats = labels = None
    if args.npz:
        from ..io.datasets import load_npz_dataset
        a, feats, labels = load_npz_dataset(args.npz)
    elif args.adjacency:
        a = read_mtx(args.adjacency)
    else:
        raise SystemExit("need -a/--adjacency or --npz")
    if args.normalize:
        a = normalize_adjacency(a)
    n = a.shape[0]
    try:
        pv = read_partvec(args.partvec)
    except (UnicodeDecodeError, ValueError):
        pv = read_partvec_pickle(args.partvec)
    if len(pv) != n:
        raise SystemExit(f"partvec length {len(pv)} != n {n}")
    k = args.nparts
    if pv.max() >= k:
        raise SystemExit(f"partvec references part {pv.max()} >= k {k}")

    if args.features_mtx:
        feats = read_dense_features(args.features_mtx)
    f = feats.shape[1] if feats is not None else args.nfeatures
    if feats is None:
        # the trainer CLI's synthetic harness inputs
        feats = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, f))
    return a, feats, labels, pv


def _serve(args, device, inputs, mesh=None):
    """Build the plan and the engine from the loaded ``inputs``, and on
    rank 0 run the traffic window; returns the report (``None`` on the
    other ranks, which follow rank 0's batches until it closes the
    engine)."""
    from ..parallel.plan import build_comm_plan

    a, feats, labels, pv = inputs
    n, f, k = a.shape[0], feats.shape[1], args.nparts
    # model config: checkpoint provenance wins; CLI flags fill the gaps.
    # activation comes ONLY from provenance — it is part of the served
    # function, and the engine re-verifies it against the checkpoint
    model, widths = args.model, None
    activation = final_activation = None
    if args.checkpoint:
        from ..utils.checkpoint import read_checkpoint_meta
        meta = read_checkpoint_meta(args.checkpoint)
        cfg = meta.get("model_config") or {}
        model = model or cfg.get("model")
        activation = cfg.get("activation")
        final_activation = cfg.get("final_activation")
        if cfg.get("widths"):
            widths = list(cfg["widths"])
        if cfg.get("fin") is not None and cfg["fin"] != f:
            raise SystemExit(
                f"checkpoint was trained on fin={cfg['fin']} features, "
                f"this dataset has {f}")
    model = model or "gcn"
    if widths is None:
        nclasses = args.classes or (
            int(labels.max()) + 1 if labels is not None else f)
        hidden = args.hidden or f
        widths = [hidden] * (args.nlayers - 1) + [nclasses]

    plan = build_comm_plan(a, pv, k)
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)

    from ..obs.memory import MemoryBudgetError
    from .engine import ServeEngine

    try:
        engine = ServeEngine(
            plan, fin=f, widths=widths, model=model, activation=activation,
            final_activation=final_activation or "none",
            comm_schedule=args.comm_schedule, halo_dtype=args.halo_dtype,
            checkpoint=args.checkpoint, max_batch=args.max_batch,
            buckets=buckets, latency_budget_ms=args.latency_budget_ms,
            shed_factor=args.shed_factor, seed=args.seed, device=device,
            mode=args.serve_mode, memory_budget=args.memory_budget,
            mesh=mesh)
    except MemoryBudgetError as e:
        raise SystemExit(str(e)) from e
    engine.set_features(feats)
    if mesh is not None and mesh.rank != 0:
        engine.follow()
        return None
    try:
        return _window(args, engine, plan, device, n, k, model, widths)
    finally:
        engine.close()       # the followers' stop header, on every path


def _window(args, engine, plan, device, n, k, model, widths) -> dict:
    """Rank 0's (or the one process's) traffic window and its report."""
    from .loadgen import run_loadgen, synthetic_query_ids

    if args.watch_checkpoint_dir:
        engine.attach_checkpoint_watch(args.watch_checkpoint_dir)
    recorder = None
    if args.metrics_out:
        from ..obs import RunRecorder
        recorder = RunRecorder(args.metrics_out, config=vars(args),
                               run_kind="serve")
        recorder.set_plan(plan, partitioner={"partvec": args.partvec,
                                             "k": k})
        recorder.set_backend(device, parts=k, processes=(
            1 if engine.mesh is None else engine.mesh.size))
        engine.attach_recorder(recorder)

    qids = synthetic_query_ids(n, args.queries, seed=args.seed,
                               skew=args.query_skew)
    mode = "open" if args.qps > 0 else "closed"
    engine.warmup(qids)      # every bucket, outside the measured window
    result = run_loadgen(engine, qids,
                         offered_qps=args.qps if args.qps > 0 else None,
                         concurrent=args.concurrent)
    engine.record_window(result, offered_qps=args.qps or None, mode=mode)

    report = {
        "metric": "serve_qps",
        "value": result.summary()["achieved_qps"],
        "unit": "qps",
        "mode": mode,
        "offered_qps": args.qps or None,
        # live host-clock measurement from THIS process, on `device`
        "measured": True,
        **result.summary(),
        "deadline_flushes": engine.batcher.deadline_flushes,
        "full_flushes": engine.batcher.full_flushes,
        "latency_budget_ms": args.latency_budget_ms,
        "shed": result.shed,
        "shed_factor": args.shed_factor,
        "concurrent": args.concurrent,
        "model": model,
        "activation": engine.activation,
        "widths": widths,
        "weights": ("checkpoint" if args.checkpoint else "random-init"),
        **engine.gauges(),
    }
    if recorder is not None:
        recorder.record_summary(report)
        recorder.close()
    return report


if __name__ == "__main__":
    sys.exit(main())
