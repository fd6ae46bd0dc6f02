"""Baseline CLIs — the reference's two comparison executables (port of
``python -m sgcn_tpu.baselines``, the same flags and printed JSON keys):

  * ``python -m sgcn_tpu_torch.baselines oracle -a A.mtx -f H.mtx -y Y.mtx
    -c config`` — the DGL single-process GCN role (``DGL/gcn.py``): dense
    training on one device on the preprocessor's outputs, sigmoid between
    layers, SGD with momentum 0.9, per-epoch loss (stderr) and the
    process time;
  * ``python -m sgcn_tpu_torch.baselines cagnet -a A.mtx -c config -s k``
    — the CAGNET 1-D broadcast inference role (``Cagnet/main.c``):
    contiguous equal row blocks (no partitioner), every block to every
    part each layer, inference only, the ``data_comm`` / ``local_spmm``
    phase breakdown (``baselines/cagnet1d.py``).

Both run on the card unless ``--device cpu`` (the reference's ``-b
{jax,cpu}``) asks for the CPU; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p):
    p.add_argument("-a", "--adjacency", required=True,
                   help="path to <name>.A.mtx (normalized adjacency)")
    p.add_argument("-c", "--config", default=None,
                   help="config sidecar 'nlayers nvtx f1 ... nout'; widths "
                        "default to it when present")
    p.add_argument("-f", "--features-mtx", default=None,
                   help="path to <name>.H.mtx (the reference DGL CLI's -h). "
                        "Without it, all-ones features at a GUESSED input "
                        "width: the config does not record fin, so -c alone "
                        "takes f1 (the first HIDDEN width)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default): the card; cpu: the plain versions")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="sgcn_tpu_torch comparison "
                                            "baselines")
    sub = p.add_subparsers(dest="cmd", required=True)
    po = sub.add_parser("oracle", help="DGL/gcn.py role: dense single-device "
                                       "GCN on preprocessor outputs")
    _add_common(po)
    po.add_argument("-y", "--labels-mtx", default=None,
                    help="path to <name>.Y.mtx (one-hot labels)")
    po.add_argument("--lr", type=float, default=0.01)
    pc = sub.add_parser("cagnet", help="Cagnet/main.c role: 1-D broadcast "
                                       "inference with phase breakdown "
                                       "(inference only: no lr)")
    _add_common(pc)
    pc.add_argument("-s", "--nparts", type=int, required=True)
    args = p.parse_args(argv)
    if args.epochs < 1:
        raise SystemExit("--epochs must be >= 1")

    import numpy as np
    import torch

    from ..io.config import read_config
    from ..io.mtx import read_dense_features, read_mtx, read_onehot_labels

    a = read_mtx(args.adjacency)
    n = a.shape[0]
    cfg = read_config(args.config) if args.config else None
    if args.features_mtx:
        feats = read_dense_features(args.features_mtx)
    else:
        feats = np.ones((n, cfg.widths[0] if cfg else 16), np.float32)
    fin = feats.shape[1]
    widths = list(cfg.widths) if cfg else [fin, 2]

    if args.cmd == "oracle":
        from .oracle import DenseOracle
        if args.labels_mtx:
            labels = read_onehot_labels(args.labels_mtx)
        else:
            labels = (np.arange(n) % widths[-1]).astype(np.int64)
        # DGL/gcn.py: sigmoid between layers, cross-entropy, SGD momentum,
        # epochs timed with time.process_time (DGL/gcn.py:74-97)
        oracle = DenseOracle(
            a, fin=fin, widths=widths, activation="sigmoid",
            optimizer=lambda ps: torch.optim.SGD(ps, lr=args.lr,
                                                 momentum=0.9),
            seed=args.seed, device=args.device)
        t0 = time.process_time()
        losses = oracle.fit(feats, labels, epochs=args.epochs)
        for e, loss in enumerate(losses):
            print(f"epoch {e}: loss {loss:.6f}", file=sys.stderr, flush=True)
        print(json.dumps({
            "baseline": "oracle",
            "epochs": args.epochs,
            "process_time_s": time.process_time() - t0,
            "final_loss": losses[-1],
        }), flush=True)
        return

    from .cagnet1d import BroadcastGCN1D
    k = args.nparts
    # CAGNET's uniform block row distribution (Cagnet/main.c: contiguous
    # equal blocks; no partitioner)
    partvec = np.repeat(np.arange(k), -(-n // k))[:n]
    bc = BroadcastGCN1D(a, partvec, k, fin=fin, widths=widths,
                        seed=args.seed, device=args.device)
    report, _ = bc.run_epochs(feats, epochs=args.epochs)
    report["baseline"] = "cagnet1d"
    report["backend"] = args.device
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
