"""Training CLI of the port — the exact full-batch GCN trainer and the
accuracy-parity experiment.

::

    python -m sgcn_tpu_torch.train --npz tests/fixtures/cora2708.npz \\
        --normalize -p tests/fixtures/cora2708.8.hp -s 8 -l 2 --hidden 16

Same flag names as ``python -m sgcn_tpu.train`` for the subset ported
here, with ``--device {cuda,cpu}`` (default cuda; without a GPU the run
fails unless ``--device cpu`` is given) in place of ``-b/--backend``.
Flags whose feature is not ported are not defined (mini-batch, GAT,
precision and wire levers, stale halos, replicas, the ragged ring,
checkpoints, profiling, metrics, memory budget).  Prints ONE JSON line:
the comm report and epoch timing under the reference's keys, or with
``--experiment accuracy`` the oracle's and the partitioned trainer's
test accuracy.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="sgcn_tpu_torch partitioned full-batch trainer")
    p.add_argument("-a", "--adjacency", default=None,
                   help=".mtx adjacency (or use --npz)")
    p.add_argument("-p", "--partvec", required=True,
                   help="part vector: text (.gp/.hp/.rp) or pickle")
    p.add_argument("-s", "--nparts", type=int, required=True)
    p.add_argument("-l", "--nlayers", type=int, default=2)
    p.add_argument("-f", "--nfeatures", type=int, default=16)
    p.add_argument("--activation", default="relu",
                   choices=["relu", "sigmoid", "elu", "none"],
                   help="inter-layer activation (default relu)")
    p.add_argument("--loss", default="xent", choices=["xent", "bce"],
                   help="xent = log-softmax + NLL; bce = sigmoid + BCE "
                        "with the reported `err` metric")
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (default cuda; no CPU "
                        "fallback)")
    args = p.parse_args(argv)

    if args.experiment == "accuracy" and (args.loss != "xent"
                                          or args.activation != "relu"):
        raise SystemExit(
            "--experiment accuracy compares against the dense GCN oracle "
            "and supports only --loss xent --activation relu; drop the "
            "conflicting flags")

    import numpy as np

    from ..io.mtx import read_dense_features, read_mtx, read_onehot_labels
    from ..parallel.plan import build_comm_plan
    from ..partition.emit import read_partvec, read_partvec_pickle
    from ..prep.normalize import normalize_adjacency
    from ..utils.backend import resolve_device
    from .fullbatch import FullBatchTrainer, make_train_data

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
                          loss=args.loss, activation=args.activation,
                          seed=args.seed, device=device)
    data = make_train_data(plan, feats, labels, device=device)
    report = tr.fit(data, epochs=args.epochs, warmup=args.warmup)

    # end-of-run line under the reference's keys
    report["device"] = args.device
    report["model"] = "gcn"
    report["activation"] = args.activation
    report["loss"] = args.loss
    report.pop("loss_history", None)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    sys.exit(main())
