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
a trainer's ``--checkpoint-dir`` in before each micro-batch.  Flags whose
feature is not ported are not defined (sub-graph mode, concurrent
dispatch, metrics, memory budget, shedding).  Prints ONE JSON line:
achieved QPS, p50/p95/p99 latency and the batching/wire gauges, under the
reference's keys, with ``"weights": "checkpoint"`` or ``"random-init"``.
"""

from __future__ import annotations

import argparse
import json
import sys


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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the forward runs (default cuda; no CPU "
                        "fallback)")
    args = p.parse_args(argv)

    if not args.checkpoint and not args.random_init:
        raise SystemExit("need --checkpoint CKPT or --random-init")
    if args.checkpoint and args.random_init:
        raise SystemExit("--checkpoint and --random-init are exclusive")

    import numpy as np

    from ..io.mtx import read_dense_features, read_mtx
    from ..parallel.plan import build_comm_plan
    from ..partition.emit import read_partvec, read_partvec_pickle
    from ..prep.normalize import normalize_adjacency
    from ..utils.backend import resolve_device

    device = resolve_device(args.device)
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

    from .engine import ServeEngine
    from .loadgen import run_loadgen, synthetic_query_ids

    engine = ServeEngine(
        plan, fin=f, widths=widths, model=model, activation=activation,
        final_activation=final_activation or "none",
        comm_schedule=args.comm_schedule, halo_dtype=args.halo_dtype,
        checkpoint=args.checkpoint, max_batch=args.max_batch,
        buckets=buckets, latency_budget_ms=args.latency_budget_ms,
        seed=args.seed, device=device)
    engine.set_features(feats)
    if args.watch_checkpoint_dir:
        engine.attach_checkpoint_watch(args.watch_checkpoint_dir)

    qids = synthetic_query_ids(n, args.queries, seed=args.seed,
                               skew=args.query_skew)
    mode = "open" if args.qps > 0 else "closed"
    engine.warmup(qids)      # every bucket, outside the measured window
    result = run_loadgen(engine, qids,
                         offered_qps=args.qps if args.qps > 0 else None)

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
        "model": model,
        "activation": engine.activation,
        "widths": widths,
        "weights": ("checkpoint" if args.checkpoint else "random-init"),
        **engine.gauges(),
    }
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    sys.exit(main())
