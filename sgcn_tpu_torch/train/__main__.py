"""Training CLI of the port — the exact full-batch GCN/GAT trainer
(``--model gat``) and the accuracy-parity experiment.

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
corrupts a run after a named save.  Flags whose feature is not ported are
not defined (mini-batch, stale halos, replicas, profiling, metrics, memory
budget).  Prints ONE JSON line: the comm report and epoch timing under the
reference's keys (with ``--checkpoint-dir``: ``steps``, ``step_s_wall``
and the per-step ``losses``), or with ``--experiment accuracy`` the
oracle's and the partitioned trainer's test accuracy.
"""

from __future__ import annotations

import argparse
import json
import sys


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
                        "--checkpoint-dir every N optimizer steps.  0 = off")
    p.add_argument("--keep-checkpoints", type=int, default=3, metavar="K",
                   help="rotation depth of --checkpoint-dir (keep the "
                        "newest K checkpoints; default 3)")
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
    if args.halo_dtype and (args.model != "gcn"
                            or args.experiment == "accuracy"
                            or args.dtype):
        raise SystemExit(
            "--halo-dtype narrows the full-batch GCN exchange only (the "
            "mini-batch trainer and GAT narrow via --dtype bfloat16; the "
            "accuracy-parity harness is defined for the f32-wire config; "
            "under --dtype bfloat16 the wire is already bf16, so the flag "
            "would be a silent no-op)")
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
    from ..parallel.plan import build_comm_plan
    from ..utils.backend import resolve_device
    from .fullbatch import MODELS, FullBatchTrainer, make_train_data

    # the model's own inter-layer activation unless one is asked for
    activation = args.activation or MODELS[args.model].activation

    device = resolve_device(args.device)
    a, feats, labels, pv, k, f, widths = load_inputs(args)

    if args.experiment == "accuracy":
        from ..io.datasets import planetoid_split
        from .accuracy import run_accuracy_parity
        train_mask, test_mask = planetoid_split(
            labels, per_class=args.train_per_class, seed=args.seed)
        report = run_accuracy_parity(
            a, feats, labels, pv, k, widths, train_mask, test_mask,
            epochs=args.epochs, lr=args.lr, seed=args.seed, device=device)
        report["experiment"] = "accuracy"
        report["device"] = args.device
        print(json.dumps(report), flush=True)
        return

    plan = build_comm_plan(a, pv, k)
    tr = FullBatchTrainer(plan, fin=f, widths=widths, lr=args.lr,
                          model=args.model, loss=args.loss,
                          activation=activation, seed=args.seed,
                          compute_dtype=args.dtype,
                          halo_dtype=args.halo_dtype,
                          comm_schedule=args.comm_schedule, device=device)
    # durable checkpointing: one manager per checkpoint directory
    mgr = None
    if args.checkpoint_dir:
        from ..resilience.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir,
                                keep_last=args.keep_checkpoints)
    resumed = None
    start_step = 0
    if args.resume == "auto":
        start_step, rpath, skipped = mgr.load_latest(tr)
        resumed = {"step": start_step, "path": rpath,
                   "fallback": bool(skipped)}
    elif args.resume:
        from ..utils.checkpoint import load_checkpoint
        start_step = load_checkpoint(tr, args.resume)
    data = make_train_data(plan, feats, labels, device=device)
    if mgr is not None:
        # the resumable per-step loop: durable checkpoints every N steps +
        # the fault-injection kill point.  --resume auto: --warmup/--epochs
        # name the run's TOTAL step schedule and the resumed process
        # completes the remainder (the bit-identity contract).  Explicit
        # --resume CKPT keeps its chained meaning (train warmup+epochs MORE
        # steps) but threads the loaded step through, so the durable stamps
        # continue the trainer's real step count instead of restarting at 1
        from ..resilience.runner import run_resumable
        total = args.warmup + args.epochs
        if args.resume and args.resume != "auto":
            total += start_step
        report = run_resumable(
            tr, data, total, manager=mgr,
            checkpoint_every=args.checkpoint_every,
            start_step=start_step if args.resume else 0)
    else:
        report = tr.fit(data, epochs=args.epochs, warmup=args.warmup)
    if resumed is not None:
        report["resumed"] = resumed
    if args.save_checkpoint:
        # warm-up steps are real optimizer steps, so they count toward the
        # saved step; --resume auto completes a FIXED total schedule, so
        # its final step is absolute, not additive
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
    report.pop("loss_history", None)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    sys.exit(main())
