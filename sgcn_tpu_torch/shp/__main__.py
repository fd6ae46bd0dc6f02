"""SHP CLI of the port — the reference's ``python -m sgcn_tpu.shp``::

    python -m sgcn_tpu_torch.shp -p A.mtx -k 8 -b 256 -m 10 -s 20 -o out

Same flags (``-p -k -s -b -m -o -e --seed``), the same files
(``partvec.hp.<k>`` and ``partvec.stchp.<k>``, pickled part vectors, the
format the mini-batch trainer's ``-p`` reads) and the same printed lines.
Host only: no card is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io.mtx import read_mtx
from ..partition.emit import write_partvec_pickle
from .model import run_shp


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="stochastic hypergraph partitioner")
    p.add_argument("-p", "--path", required=True, help="adjacency .mtx")
    p.add_argument("-k", "--nparts", type=int, required=True)
    p.add_argument("-s", "--sim-iters", type=int, default=20)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("-m", "--sampled-batches", type=int, default=10,
                   help="batches hstacked into the stochastic hypergraph")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("-e", "--imbalance", type=float, default=0.03)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    a = read_mtx(args.path)
    res = run_shp(a, args.nparts, args.sampled_batches, args.batch_size,
                  args.sim_iters, args.imbalance, args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    for name in ("hp", "stchp"):
        out = os.path.join(args.outdir, f"partvec.{name}.{args.nparts}")
        write_partvec_pickle(out, res[f"partvec_{name}"])
        print(f"{name}: {out}  km1={res[f'km1_{name}']}  "
              f"sim_comm_volume={res[f'sim_comm_volume_{name}']}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
