"""Training CLI of the port — the exact full-batch GCN/GAT trainer
(``--model gat``), the mini-batch trainer (``-n BATCH``) and the
accuracy-parity experiment.

::

    python -m sgcn_tpu_torch.train --npz tests/fixtures/cora2708.npz \\
        --normalize -p tests/fixtures/cora2708.8.hp -s 8 -l 2 --hidden 16

Same flag names as ``python -m sgcn_tpu.train`` for the subset ported
here, with ``--device {cuda,cpu}`` (default cuda; without a GPU the run
fails unless ``--device cpu`` is given) in place of ``-b/--backend``.
``--comm-schedule {a2a,ragged,auto}`` picks the halo transport (default
``$SGCN_COMM_SCHEDULE``, else a2a); ``ragged`` does not compose with
``--experiment accuracy``, as in the reference.  ``--dtype bfloat16`` is
the mixed-precision step (float32 master weights, bf16 forward and
backward) and ``--halo-dtype bfloat16`` the GCN wire-only lever, with the
reference's flag guards.  Checkpoints: ``--save-checkpoint CKPT`` writes
the full trainer state after training, ``--resume CKPT`` restores one
first (either package's ``.npz``), and ``--checkpoint-dir DIR`` runs the
resumable loop (``resilience.run_resumable``) with a durable checkpoint
every ``--checkpoint-every N`` steps, the newest ``--keep-checkpoints K``
kept; ``--resume auto`` restores the newest intact one there and trains
the rest of the ``--warmup + --epochs`` schedule, bit-identical to the
uninterrupted run.  ``$SGCN_FAULT`` (``resilience/faults.py``) kills or
corrupts a run after a named save.  ``--halo-staleness 1`` trains the
pipelined stale-halo GCN (``--halo-delta`` adds the bf16 halo-delta
cache, ``--sync-every N`` a sync step every N steps, and with
``--comm-schedule auto`` the controller retunes N), with the reference's
guards.  ``--replica-budget B|auto`` trains with hot-halo replicas
(``--sync-every N`` refreshes them every N steps, ``--refresh-band RHO``
makes the refreshes after step 0 partial; with ``--halo-staleness 1``
the replicas compose with the stale carry), with the reference's guards.
``-n BATCH`` trains the mini-batch trainer (``train/minibatch.py``:
``3·(n//BATCH + 1)`` sampled batches, one padded plan each, an epoch a
pass over all of them; GCN or GAT, ``--dtype`` and ``--comm-schedule``
apply, the full-batch levers exit with the reference's messages); with
``--checkpoint-dir`` it saves every ``--checkpoint-every`` EPOCHS and
``--resume auto`` trains the remaining epochs, ``--warmup`` only on a
fresh start.  ``--metrics-out DIR`` writes the run's telemetry
(``obs/recorder.py``: manifest, step / span / eval / checkpoint / resume
/ memory / summary events; render with ``scripts/obs_report.py DIR``),
``--profile DIR`` a ``torch.profiler`` chrome trace of the run (the
manifest records it under ``--metrics-out``), and ``--memory-budget
BYTES`` fails a mode whose analytic device footprint exceeds the budget
before any tensor ships.  Launched by ``torchrun`` or under SLURM
(``launch/gpu.slurm``), the CLI opens a rank group first
(``parallel/launch.py::init_distributed``; one process is the stacked
layout): a world of ``-s K`` processes trains one part per rank (GCN and
GAT, ``--dtype``, ``--halo-dtype``, both transports, the GCN's carried
modes: ``--halo-staleness 1``, ``--halo-delta``, ``--sync-every``,
``--replica-budget B|auto``, ``--refresh-band`` and ``--comm-schedule
auto``'s controller, a directed graph on the a2a, the mini-batch trainer
``-n BATCH`` with its durable path, and ``--experiment accuracy``), rank
0 alone prints, records ``--metrics-out`` and saves, every rank
restores, and every rank appends its rendezvous and ``train:start|done``
heartbeats to ``--metrics-out``'s ``heartbeat.jsonl``; another world
size exits with the reason, and so do ``--checkpoint-dir``,
``--save-checkpoint`` and ``--resume`` in a carried mode (the
reference's deferral: the carry is sharded over the ranks).  Prints ONE
JSON line: the
comm report and epoch timing under the reference's keys (in the stale
mode with its hidden/exposed split, the stale flags and the controller's
log; in the replica mode its replica figures and flags) (with
``--checkpoint-dir``: ``steps``, ``step_s_wall``
and the per-step ``losses``), or with ``--experiment accuracy`` the
oracle's and the partitioned trainer's test accuracy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _budget(text: str):
    """``--replica-budget`` values: a non-negative int or ``auto`` (the
    λ·degree-knee rule, ``parallel/plan.py::choose_replica_budget``)."""
    if text == "auto":
        return "auto"
    return int(text)


def _mem_budget(text: str) -> int:
    """``--memory-budget`` values: bytes with optional binary suffix
    (``512M``, ``2G``; ``obs/memory.py::parse_bytes``)."""
    from ..obs.memory import parse_bytes

    try:
        return parse_bytes(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e


def _resume_auto(mgr, target, recorder):
    """The one ``--resume auto`` sequence of both trainers: restore the
    newest intact checkpoint into ``target`` and emit the resume event.
    Returns ``(start_step, resumed_block)``."""
    start_step, rpath, skipped = mgr.load_latest(target)
    resumed = {"step": start_step, "path": rpath, "fallback": bool(skipped)}
    if recorder is not None:
        recorder.record_resume(
            step=start_step, path=rpath, fallback=bool(skipped),
            partial_state=getattr(target, "last_restore_partial", False),
            skipped=skipped or None)
    return start_step, resumed


def _fit_minibatch_durable(tr, feats, labels, args, mgr, recorder,
                           start_ep: int = 0, verbose: bool = True) -> dict:
    """The mini-batch trainer's durable path: ``fit`` in chunks of
    ``--checkpoint-every`` EPOCHS (its checkpoint grain: the batch plans
    have no stable step identity), saving the inner trainer's state after
    each chunk.  ``--warmup`` runs only on a fresh start (warm-up steps
    are real optimizer steps a resumed run must not repeat).  ``mgr=None``:
    a rank other than 0 runs the same chunks and saves nothing."""
    from ..resilience.runner import save_and_record

    every = args.checkpoint_every
    total = args.epochs
    history: list = []
    warm = args.warmup if start_ep == 0 else 0
    done, report = start_ep, None
    while done < total:
        run = total - done
        if every:
            run = min(run, every - done % every)
        report = tr.fit(feats, labels, epochs=run, warmup=warm,
                        verbose=verbose)
        warm = 0
        history += report.get("loss_history", [])
        done += run
        if every and done % every == 0 and mgr is not None:
            save_and_record(mgr, tr.inner, done, recorder=recorder)
    if report is None:
        # resumed at (or past) the full schedule: nothing left to train
        report = {"note": "resume found the epoch schedule complete"}
    report.update(epochs=done, loss_history=history, start_epoch=start_ep)
    return report


def _run_minibatch(args, a, feats, labels, pv, k, f, widths, activation,
                   device, recorder, mesh=None) -> dict:
    """``-n BATCH``: the mini-batch trainer, with the durable path under
    ``--checkpoint-dir`` (checkpoints count EPOCHS), ``--resume`` and
    ``--save-checkpoint`` as the reference CLI runs them.  ``mesh``: one
    part per rank; every rank restores, rank 0 alone prints its epoch
    lines and saves (the weights and Adam state are the same on every
    rank).  Returns the report."""
    from ..obs.memory import MemoryBudgetError
    from .minibatch import MiniBatchTrainer

    try:
        tr = MiniBatchTrainer(a, pv, k, fin=f, widths=widths,
                              batch_size=args.batch_size, lr=args.lr,
                              model=args.model, loss=args.loss,
                              activation=activation, seed=args.seed,
                              compute_dtype=args.dtype,
                              comm_schedule=args.comm_schedule,
                              memory_budget=args.memory_budget,
                              device=device, mesh=mesh)
    except MemoryBudgetError as e:
        raise SystemExit(str(e)) from e
    lead = mesh is None or mesh.rank == 0
    if recorder is not None:
        recorder.set_partitioner({"partvec": args.partvec, "k": k})
        recorder.set_backend(device, parts=k,
                             processes=1 if mesh is None else mesh.size)
        tr.attach_recorder(recorder)
    mgr = None
    if args.checkpoint_dir:
        from ..resilience.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir,
                                keep_last=args.keep_checkpoints)
    state = tr.inner                 # the checkpointable weights and Adam
    start, resumed = 0, None
    if args.resume == "auto":
        # mini-batch checkpoints count the EPOCHS completed
        start, resumed = _resume_auto(mgr, state, recorder)
    elif args.resume:
        from ..utils.checkpoint import load_checkpoint
        start = load_checkpoint(state, args.resume)
    if mgr is not None:
        report = _fit_minibatch_durable(
            tr, feats, labels, args, mgr if lead else None, recorder,
            start_ep=start if args.resume == "auto" else 0, verbose=lead)
    else:
        report = tr.fit(feats, labels, epochs=args.epochs,
                        warmup=args.warmup, verbose=lead)
    if resumed is not None:
        report["resumed"] = resumed
    if args.save_checkpoint and lead:
        # the durable path stamps at EPOCH grain everywhere, so the final
        # stamp agrees with its files whether or not this run resumed;
        # otherwise warm-up steps count, chained resumes add up
        from ..utils.checkpoint import save_checkpoint
        final = (args.epochs if mgr is not None
                 else start + args.epochs + args.warmup)
        report["checkpoint"] = save_checkpoint(state, args.save_checkpoint,
                                               step=final)
    return report


def build_parser(description: str = "sgcn_tpu_torch partitioned full-batch "
                 "trainer") -> argparse.ArgumentParser:
    """The trainer's flags (``tools/repeat_run.py`` adds its own)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-a", "--adjacency", default=None,
                   help=".mtx adjacency (or use --npz)")
    p.add_argument("-p", "--partvec", required=True,
                   help="part vector: text (.gp/.hp/.rp) or pickle")
    p.add_argument("-s", "--nparts", type=int, required=True)
    p.add_argument("-l", "--nlayers", type=int, default=2)
    p.add_argument("-f", "--nfeatures", type=int, default=16)
    p.add_argument("-n", "--batch-size", type=int, default=None,
                   help="enable the mini-batch trainer")
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("--activation", default=None,
                   choices=["relu", "sigmoid", "elu", "none"],
                   help="inter-layer activation; defaults to relu for gcn "
                        "and none for gat (PGAT stacks bare layers)")
    p.add_argument("--loss", default="xent", choices=["xent", "bce"],
                   help="xent = log-softmax + NLL; bce = sigmoid + BCE "
                        "with the reported `err` metric")
    p.add_argument("--dtype", default=None, choices=["bfloat16"],
                   help="mixed-precision compute (f32 master params)")
    p.add_argument("--halo-dtype", default=None, choices=["bfloat16"],
                   help="wire-only exchange dtype: halves the exchange's "
                        "bytes, all compute stays f32 (full-batch GCN "
                        "only)")
    p.add_argument("--halo-staleness", type=int, default=0, choices=[0, 1],
                   help="0 (default) = exact per-layer halo exchange; 1 = "
                        "pipelined one-step-stale exchange: layer L of step "
                        "t aggregates with the halo exchanged during step "
                        "t-1, so the exchange leaves the critical path "
                        "(full-batch GCN, symmetric adjacency only)")
    p.add_argument("--halo-delta", action="store_true",
                   help="halo-delta cache on top of --halo-staleness 1: "
                        "boundary rows ship as bf16 deltas accumulated "
                        "into the carried remote halo (half the wire bytes)")
    p.add_argument("--sync-every", type=int, default=0,
                   help="stale mode: run a full-sync (exact-math) step "
                        "every N steps to bound staleness/quantization "
                        "drift; replica mode: refresh the replica tables "
                        "every N steps; 0 = only the initializing first "
                        "step")
    p.add_argument("--replica-budget", type=_budget, default=0,
                   metavar="B|auto",
                   help="hot-halo replication: the top-B boundary rows (by "
                        "λ·degree from the comm plan) become persistent "
                        "replicas on their consumer parts and leave the "
                        "per-layer wire, refreshed only on --sync-every "
                        "steps (at --sync-every 1 the run is the exact "
                        "one bit for bit); full-batch GCN, symmetric "
                        "adjacency, f32; composes with --comm-schedule, "
                        "--halo-dtype and --halo-staleness 1; 'auto' picks "
                        "B at the knee of the λ·degree curve; 0 = off")
    p.add_argument("--refresh-band", type=float, default=None, metavar="RHO",
                   help="partial replica refresh: refresh steps after step "
                        "0 ship only the replica rows whose relative drift "
                        "‖x−base‖/‖base‖ exceeds RHO, as increments on the "
                        "refresh baseline; requires --replica-budget > 0, "
                        "--comm-schedule a2a, no staleness")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--hidden", type=int, default=None,
                   help="hidden width (default: nfeatures)")
    p.add_argument("--normalize", action="store_true",
                   help="apply Â normalization to the input adjacency")
    p.add_argument("--features-mtx", default=None)
    p.add_argument("--labels-mtx", default=None)
    p.add_argument("--npz", default=None,
                   help="planetoid/ogbn-style .npz snapshot (adj_* CSR + "
                        "attr_* + labels); replaces -a, and supplies "
                        "features/labels unless --features-mtx/--labels-mtx "
                        "override them")
    p.add_argument("--experiment", default=None, choices=["accuracy"],
                   help="accuracy = train the dense oracle and the "
                        "partitioned trainer on a planetoid split and "
                        "report the test accuracy of each")
    p.add_argument("--train-per-class", type=int, default=20,
                   help="planetoid split: train nodes per class")
    p.add_argument("--comm-schedule", default=None,
                   choices=["a2a", "ragged", "auto"],
                   help="halo transport: a2a = dense padded exchange "
                        "(default), ragged = per-round-sized ring (same "
                        "bits, fewer wire rows on skewed partitions), auto "
                        "= ragged when the a2a's padding efficiency is "
                        "below 0.5; unset reads $SGCN_COMM_SCHEDULE")
    p.add_argument("--resume", default=None, metavar="CKPT|auto",
                   help="restore the full trainer state (params, Adam "
                        "state, step counter and cumulative comm gauges) "
                        "from a checkpoint .npz before training; 'auto' "
                        "picks the newest INTACT checkpoint in "
                        "--checkpoint-dir, falling back past corrupt files "
                        "with a logged warning, and trains only the "
                        "REMAINING steps of the --warmup + --epochs "
                        "schedule — bit-identical to the uninterrupted run")
    p.add_argument("--save-checkpoint", default=None, metavar="CKPT",
                   help="save the full trainer state after training")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="durable checkpoint directory: step-stamped atomic "
                        "checkpoints with keep-last-K rotation — the "
                        "directory --resume auto restores from")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write a durable full-state checkpoint into "
                        "--checkpoint-dir every N optimizer steps (for the "
                        "mini-batch trainer N counts EPOCHS).  0 = off")
    p.add_argument("--keep-checkpoints", type=int, default=3, metavar="K",
                   help="rotation depth of --checkpoint-dir (keep the "
                        "newest K checkpoints; default 3)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the training "
                        "run into DIR (a chrome trace, "
                        "DIR/<host>_<pid>.pt.trace.json.gz; the "
                        "reference's analogue is its manual phase timers, "
                        "Cagnet/main.c:35-38 — see utils/timers.py for "
                        "those)")
    p.add_argument("--metrics-out", default=None, metavar="DIR",
                   help="run-telemetry directory (sgcn_tpu_torch.obs): "
                        "writes a run manifest (config, git rev, plan "
                        "digest) plus a per-step JSONL event stream — "
                        "loss, grad-norm, wall time, the hidden/exposed "
                        "comm split and (stale mode) drift gauges; render "
                        "with scripts/obs_report.py, schema in "
                        "docs/observability.md")
    p.add_argument("--memory-budget", type=_mem_budget, default=None,
                   metavar="BYTES",
                   help="device memory budget (suffixes K/M/G/T, e.g. "
                        "2G): the analytic footprint model "
                        "(sgcn_tpu_torch.obs.memory) is checked at PLAN "
                        "time — before any tensor ships — and an "
                        "over-budget (plan, mode) fails with the itemized "
                        "per-family breakdown")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (default cuda; no CPU "
                        "fallback)")
    return p


def load_inputs(args):
    """The run's inputs from the parsed flags: ``(a, features, labels,
    part vector, k, fin, widths)`` — the adjacency normalized under
    ``--normalize``, synthetic features and labels where the input has
    none."""
    import numpy as np

    from ..io.mtx import read_dense_features, read_mtx, read_onehot_labels
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

    f = args.nfeatures
    if args.features_mtx:
        feats = read_dense_features(args.features_mtx)
    if feats is not None:
        f = feats.shape[1]
    else:
        # synthetic benchmark harness inputs
        feats = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, f))
    if args.labels_mtx:
        labels = read_onehot_labels(args.labels_mtx)
    if labels is not None:
        nclasses = int(labels.max()) + 1
    else:
        labels = np.arange(n) % f
        nclasses = f
    labels = labels.astype(np.int32)

    hidden = args.hidden or f
    widths = [hidden] * (args.nlayers - 1) + [nclasses]
    return a, feats, labels, pv, k, f, widths


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    # pure flag conflicts fail before any dataset load (the reference's
    # guards, with its words)
    if args.halo_dtype and (args.batch_size is not None
                            or args.model != "gcn"
                            or args.experiment == "accuracy"
                            or args.dtype):
        raise SystemExit(
            "--halo-dtype narrows the full-batch GCN exchange only (the "
            "mini-batch trainer and GAT narrow via --dtype bfloat16; the "
            "accuracy-parity harness is defined for the f32-wire config; "
            "under --dtype bfloat16 the wire is already bf16, so the flag "
            "would be a silent no-op)")
    if args.halo_staleness and (args.batch_size is not None
                                or args.model != "gcn"
                                or args.experiment == "accuracy"
                                or args.dtype):
        raise SystemExit(
            "--halo-staleness 1 pipelines the full-batch GCN trainer only "
            "(the mini-batch sweep re-plans per batch, GAT ships per-layer "
            "attention tables, the accuracy-parity harness is defined for "
            "the exact exchange, and the carries are f32 state — drop the "
            "conflicting flag)")
    if args.halo_delta and not args.halo_staleness:
        raise SystemExit(
            "--halo-delta configures the stale pipelined exchange; add "
            "--halo-staleness 1")
    if args.sync_every and not (args.halo_staleness or args.replica_budget):
        raise SystemExit(
            "--sync-every schedules the stale mode's full-sync steps or "
            "the replica mode's refresh steps; add --halo-staleness 1 or "
            "--replica-budget B")
    if args.replica_budget and (args.batch_size is not None
                                or args.model != "gcn"
                                or args.experiment == "accuracy"
                                or args.dtype
                                or args.halo_delta):
        raise SystemExit(
            "--replica-budget replicates rows of the full-batch GCN "
            "exchange only (the mini-batch trainer re-plans per batch, so "
            "replica carries have no stable identity across batch plans; "
            "GAT ships per-layer attention tables; the accuracy-parity "
            "harness is defined for the exact exchange; the carries are "
            "f32 state; composition with --halo-delta is deferred — the "
            "delta baseline and the replica carry would disagree on what "
            "a stale step ships — drop the conflicting flag)")
    if args.refresh_band is not None and (not args.replica_budget
                                          or args.halo_staleness
                                          or args.comm_schedule == "ragged"):
        raise SystemExit(
            "--refresh-band schedules the drift-driven PARTIAL replica "
            "refresh: it requires --replica-budget > 0, rides the dense "
            "a2a transport, and does not compose with --halo-staleness 1 "
            "(the composed mode's replica state lives inside the stale "
            "carry) — drop the conflicting flag")
    if args.comm_schedule == "ragged" and args.experiment == "accuracy":
        raise SystemExit(
            "--comm-schedule ragged: the accuracy-parity harness is "
            "defined for the default transport — drop the conflicting "
            "flag or use --comm-schedule auto")
    if args.checkpoint_every < 0:
        raise SystemExit(
            f"--checkpoint-every must be >= 0, got {args.checkpoint_every}")
    if (args.checkpoint_every or args.resume == "auto") \
            and not args.checkpoint_dir:
        raise SystemExit(
            "--checkpoint-every / --resume auto operate on the durable "
            "checkpoint directory; add --checkpoint-dir DIR "
            "(docs/resilience.md)")
    if args.checkpoint_dir and args.experiment == "accuracy":
        raise SystemExit(
            "--experiment accuracy trains fresh oracle+partitioned pairs; "
            "durable checkpointing (--checkpoint-dir) is not supported "
            "there")
    if (args.checkpoint_dir and args.batch_size is not None
            and args.resume and args.resume != "auto"):
        raise SystemExit(
            "mini-batch: explicit --resume CKPT does not compose with "
            "--checkpoint-dir (the durable stamps count EPOCHS of THIS "
            "schedule and would collide with the chained run's) — resume "
            "the durable directory with --resume auto, or drop "
            "--checkpoint-dir for a chained run")

    if args.experiment == "accuracy" and (
            args.model != "gcn" or args.loss != "xent" or args.dtype
            or (args.activation or "relu") != "relu"):
        raise SystemExit(
            "--experiment accuracy compares against the dense GCN oracle "
            "and supports only --model gcn --loss xent --activation relu "
            "(f32); drop the conflicting flags")
    if args.experiment == "accuracy" and (args.resume
                                          or args.save_checkpoint):
        raise SystemExit(
            "--experiment accuracy trains fresh oracle+partitioned pairs "
            "for the parity comparison; --resume/--save-checkpoint are "
            "not supported there")
    from ..utils.backend import resolve_device
    from .fullbatch import MODELS

    # the model's own inter-layer activation unless one is asked for
    activation = args.activation or MODELS[args.model].activation

    device = resolve_device(args.device)
    # the heartbeats (obs/recorder.py::heartbeat) read this variable: set
    # before the rendezvous so its pings land in the run directory, and
    # put back after the run for an in-process caller
    before = os.environ.get("SGCN_METRICS_OUT")
    if args.metrics_out:
        os.environ["SGCN_METRICS_OUT"] = args.metrics_out
    try:
        report, lead = _launched_run(args, device, activation)
    finally:
        if args.metrics_out and before is None:
            os.environ.pop("SGCN_METRICS_OUT", None)
        elif args.metrics_out:
            os.environ["SGCN_METRICS_OUT"] = before
    if lead:
        print(json.dumps(report), flush=True)


def _launched_run(args, device, activation):
    """The run inside the launcher's rendezvous (a no-op for one
    process; ``torchrun``'s or SLURM's otherwise, ``parallel/launch.py``),
    its phases bracketed by heartbeats on every rank.  Returns ``(report,
    whether this process prints it)``: rank 0 alone prints, and owns the
    run directory's recorder (the reference's ``GPU/PGCN.py:226-238``)."""
    from ..obs.recorder import heartbeat
    from ..parallel.launch import init_distributed
    from ..utils.backend import resolve_device

    ctx = init_distributed(device=args.device)
    try:
        mesh = _rank_group(args, ctx)
        if mesh is not None:
            device = resolve_device(mesh.device)
        inputs = load_inputs(args)
        where = f"rank {ctx.process_id}/{ctx.num_processes}"
        heartbeat("train:start", phase="train", detail=where)
        recorder = None
        if args.metrics_out and ctx.is_coordinator:
            from ..obs import RunRecorder
            recorder = RunRecorder(args.metrics_out, config=vars(args))
            recorder.set_backend(device)
        try:
            report = _train(args, device, activation, recorder, inputs,
                            mesh)
        finally:
            if recorder is not None:
                recorder.close()
        heartbeat("train:done", phase="train", detail=where)
    finally:
        ctx.close()
    return report, ctx.is_coordinator


def _rank_group(args, ctx):
    """The run's ``RankGroup`` (one process per part) or ``None`` (one
    process: the stacked layout); exits for another world size and for a
    carried mode's checkpoint (the reference's deferral), before any
    step.  The trainers' own gates (turned into exits by ``_train``)
    cover the rest, as on one process."""
    import torch.distributed as dist

    from ..parallel.launch import global_mesh_1d
    from .fullbatch import CARRY_CHECKPOINT_DEFERRAL

    if ctx.num_processes == 1:
        return None

    def leave(reason):
        # every rank refuses alike; the barrier lets the slowest finish
        # the rendezvous before a faster one tears the group down
        dist.barrier()
        raise SystemExit(reason)
    try:
        mesh = global_mesh_1d(args.nparts, ctx)
    except ValueError as e:
        leave(str(e))
    carried = args.halo_staleness or args.replica_budget
    if carried and (args.checkpoint_dir or args.save_checkpoint
                    or args.resume):
        leave(CARRY_CHECKPOINT_DEFERRAL)
    return mesh


def _train(args, device, activation, recorder, inputs, mesh=None) -> dict:
    """Run the asked experiment on the loaded ``inputs`` under
    ``--profile``; returns the end-of-run report (the trainers write their
    events to ``recorder``).  ``mesh``: one process per part — this
    rank's part of the full-batch trainer; only rank 0 saves."""
    from ..obs.memory import MemoryBudgetError
    from ..obs.tracing import profile_to
    from ..parallel.plan import build_comm_plan
    from .fullbatch import (FullBatchTrainer, make_train_data,
                            make_train_data_multihost)

    a, feats, labels, pv, k, f, widths = inputs
    lead = mesh is None or mesh.rank == 0

    if args.experiment == "accuracy":
        from ..io.datasets import planetoid_split
        from .accuracy import run_accuracy_parity
        train_mask, test_mask = planetoid_split(
            labels, per_class=args.train_per_class, seed=args.seed)
        with profile_to(args.profile, device):
            report = run_accuracy_parity(
                a, feats, labels, pv, k, widths, train_mask, test_mask,
                epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                seed=args.seed, device=device, mesh=mesh)
        report["experiment"] = "accuracy"
        report["device"] = args.device
        if recorder is not None:
            # the parity harness drives its own trainers: the run's
            # identity and outcome, no per-step stream
            if args.profile:
                recorder.set_profile(args.profile)
            recorder.record_summary(report)
        return report

    if args.batch_size is not None:
        with profile_to(args.profile, device):
            report = _run_minibatch(args, a, feats, labels, pv, k, f,
                                    widths, activation, device, recorder,
                                    mesh)
        if recorder is not None and args.profile:
            recorder.set_profile(args.profile)
        report.update(device=args.device, model=args.model,
                      activation=activation, loss=args.loss,
                      dtype=args.dtype, halo_dtype=args.halo_dtype)
        report.pop("loss_history", None)
        return report

    # on ranks every process builds the full plan and the trainer keeps
    # its part's slice (train/fullbatch.py)
    plan = build_comm_plan(a, pv, k)
    try:
        tr = FullBatchTrainer(plan, fin=f, widths=widths, lr=args.lr,
                              model=args.model, loss=args.loss,
                              activation=activation, seed=args.seed,
                              compute_dtype=args.dtype,
                              halo_dtype=args.halo_dtype,
                              halo_staleness=args.halo_staleness,
                              halo_delta=args.halo_delta,
                              sync_every=args.sync_every,
                              comm_schedule=args.comm_schedule,
                              replica_budget=args.replica_budget,
                              refresh_band=args.refresh_band,
                              memory_budget=args.memory_budget,
                              device=device, mesh=mesh)
    except MemoryBudgetError as e:
        raise SystemExit(str(e)) from e
    except ValueError as e:
        if mesh is None:
            raise
        # a gate of the reference's (a carried mode on a directed plan,
        # the ring on one): every rank exits alike
        raise SystemExit(str(e)) from e
    if mesh is not None and args.metrics_out:
        # rank 0's step events read the gauges, a collective of every rank
        tr.drift_gauges = True
    if recorder is not None:
        recorder.set_plan(plan, partitioner={"partvec": args.partvec,
                                             "k": k})
        recorder.set_backend(device, parts=k,
                             processes=1 if mesh is None else mesh.size)
        tr.attach_recorder(recorder)
    # durable checkpointing: one manager per checkpoint directory
    mgr = None
    if args.checkpoint_dir:
        from ..resilience.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir,
                                keep_last=args.keep_checkpoints)
    resumed = None
    start_step = 0
    if args.resume == "auto":
        start_step, resumed = _resume_auto(mgr, tr, recorder)
    elif args.resume:
        from ..utils.checkpoint import load_checkpoint
        start_step = load_checkpoint(tr, args.resume)
    data = (make_train_data(plan, feats, labels, device=device)
            if mesh is None else
            make_train_data_multihost(plan, mesh, feats, labels))
    with profile_to(args.profile, device):
        report = _fit(args, tr, data, mgr if lead else None, start_step,
                      verbose=lead)
    if recorder is not None and args.profile:
        # the trace is written when the profiled block exits: now the
        # manifest can record its path and size
        recorder.set_profile(args.profile)
    if resumed is not None:
        report["resumed"] = resumed
    if args.save_checkpoint and lead:
        # rank 0 alone writes (the ranks hold the same weights and Adam
        # state); warm-up steps are real optimizer steps, so they count
        # toward the saved step; --resume auto completes a FIXED total
        # schedule, so its final step is absolute, not additive
        from ..utils.checkpoint import save_checkpoint
        if args.resume == "auto":
            final_step = args.epochs + args.warmup
        else:
            final_step = start_step + args.epochs + args.warmup
        report["checkpoint"] = save_checkpoint(
            tr, args.save_checkpoint, step=final_step)

    # end-of-run line under the reference's keys
    report["device"] = args.device
    report["model"] = args.model
    report["activation"] = activation
    report["loss"] = args.loss
    report["dtype"] = args.dtype
    report["halo_dtype"] = args.halo_dtype
    if args.halo_staleness:
        # the stale block: the mode's flags, the sync interval in force
        # at the end (the controller may have retuned it) and its log
        report.update(halo_staleness=args.halo_staleness,
                      halo_delta=args.halo_delta, sync_every=tr.sync_every)
    if tr.replica_budget:
        # the replica block: the budget in force ('auto' resolved) and
        # its flags
        report.update(replica_budget=tr.replica_budget,
                      refresh_band=tr.refresh_band, sync_every=tr.sync_every)
        if "replica_auto" in tr.comm_decision:
            report["replica_auto"] = tr.comm_decision["replica_auto"]
    if tr.controller is not None:
        report["controller"] = tr.comm_decision["controller"]
    report.pop("loss_history", None)
    return report


def _fit(args, tr, data, mgr, start_step: int, verbose: bool = True) -> dict:
    """Train the full-batch schedule: ``fit`` (warm-up + timed epochs), or
    under ``--checkpoint-dir`` the resumable per-step loop with a durable
    checkpoint every N steps and the fault-injection kill point.
    ``--resume auto``: ``--warmup``/``--epochs`` name the run's TOTAL step
    schedule and the resumed process completes the remainder (the
    bit-identity contract).  Explicit ``--resume CKPT`` keeps its chained
    meaning (warmup + epochs MORE steps) but threads the loaded step
    through, so the durable stamps continue the real step count.
    ``mgr=None`` under ``--checkpoint-dir``: a rank other than 0 runs the
    same loop and saves nothing; ``verbose`` prints the per-step lines
    (rank 0 only)."""
    if not args.checkpoint_dir:
        return tr.fit(data, epochs=args.epochs, warmup=args.warmup,
                      verbose=verbose)
    from ..resilience.runner import run_resumable
    total = args.warmup + args.epochs
    if args.resume and args.resume != "auto":
        total += start_step
    return run_resumable(
        tr, data, total, manager=mgr,
        checkpoint_every=args.checkpoint_every if mgr is not None else 0,
        start_step=start_step if args.resume else 0, verbose=verbose)


if __name__ == "__main__":
    sys.exit(main())
