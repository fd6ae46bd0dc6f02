"""Partitioner CLI (port of ``python -m sgcn_tpu.partition``: the same
flags, files and printed lines).

``python -m sgcn_tpu_torch.partition -a A.mtx -k 8 -m hp``     → ``A.mtx.8.hp``
``python -m sgcn_tpu_torch.partition -a A.mtx -k 8 -m hp,gp,rp`` → all three
``python -m sgcn_tpu_torch.partition -a A.mtx -k 2,3,9 -m hp,rp`` → a k-sweep
``python -m sgcn_tpu_torch.partition -a A.mtx -k 4 -m hp --rank-files out/
-y Y.mtx -l 2 --hidden 16``                → A.r/H.r/Y.r/conn.r/buff.r/config

``gp`` is the native graph partition (edge cut), ``hp`` the column-net
hypergraph partition (km1), ``rp`` a balanced random partition.  Each
part vector goes to ``<prefix>.<k>.<mode>`` (``-o``, default the
adjacency's path) with one line ``<mode>: <file>  <metric>=…  max_part=…
time_s=…``.  Host only; it needs no card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..io.config import ModelConfig
from ..io.mtx import read_mtx
from .emit import write_partvec, write_rank_files
from .random_part import balanced_random_partition


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="sgcn_tpu_torch partitioner")
    p.add_argument("-a", "--adjacency", required=True)
    p.add_argument("-k", "--nparts", required=True,
                   help="part count, or a comma list (a k-sweep, e.g. "
                        "2,3,9,15,21,27)")
    p.add_argument("-m", "--modes", default="hp",
                   help="comma list of gp|hp|rp (graph/hypergraph/random)")
    p.add_argument("-e", "--imbalance", type=float, default=0.03)
    p.add_argument("-s", "--seed", type=int, default=1)
    p.add_argument("-o", "--out-prefix", default=None,
                   help="default: <adjacency path>")
    p.add_argument("--rank-files", default=None,
                   help="also emit per-rank A.r/H.r/Y.r/conn.r/buff.r/config "
                        "to this dir (first mode)")
    p.add_argument("-y", "--labels", default=None,
                   help=".mtx labels for rank files")
    p.add_argument("-l", "--nlayers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=16)
    args = p.parse_args(argv)

    a = read_mtx(args.adjacency)
    n = a.shape[0]
    prefix = args.out_prefix or args.adjacency
    try:
        ks = [int(x) for x in str(args.nparts).split(",")]
    except ValueError:
        raise SystemExit(f"bad -k value {args.nparts!r}") from None
    first_pv = first_k = None
    for k in ks:
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            if mode == "gp":
                from .native import partition_graph
                pv, metric = partition_graph(a, k, args.imbalance, args.seed)
                mname = "edgecut"
            elif mode == "hp":
                from .native import partition_hypergraph_colnet
                pv, metric = partition_hypergraph_colnet(a, k, args.imbalance,
                                                         args.seed)
                mname = "km1"
            elif mode == "rp":
                pv = balanced_random_partition(n, k, args.seed)
                metric, mname = -1, "none"
            else:
                raise SystemExit(f"unknown mode {mode}")
            dt = time.perf_counter() - t0
            out = f"{prefix}.{k}.{mode}"
            write_partvec(out, pv)
            sizes = np.bincount(pv, minlength=k)
            print(f"{mode}: {out}  {mname}={metric}  max_part={sizes.max()}  "
                  f"time_s={dt:.3f}", flush=True)
            if first_pv is None:
                first_pv, first_k = pv, k

    if args.rank_files:
        import scipy.sparse as sp
        y = read_mtx(args.labels) if args.labels else sp.eye(n, 2, format="csr")
        nclasses = y.shape[1]
        cfg = ModelConfig(nlayers=args.nlayers, nvtx=n,
                          widths=[args.hidden] * (args.nlayers - 1) + [nclasses])
        write_rank_files(args.rank_files, a, y, first_pv, first_k, cfg)
        print(f"rank files → {args.rank_files}", flush=True)


if __name__ == "__main__":
    main()
