"""CLI: ``python -m sgcn_tpu_torch.prep -a graph.mtx -o outdir -n name
-l 2 -f 16 -c 2`` (port of ``python -m sgcn_tpu.prep``: the same flags,
files and printed line).

Writes ``<name>.{A,H,Y}.mtx`` + ``config`` into ``outdir``: Â normalized,
all-ones features of width 1, one-hot labels over ``-c`` classes drawn
from ``-s``.  Host only; it needs no card.
"""

import argparse

from ..io.mtx import read_mtx
from .normalize import preprocess


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="sgcn_tpu_torch input-data "
                                            "generator")
    p.add_argument("-a", "--adjacency", required=True, help="input .mtx graph")
    p.add_argument("-o", "--out", required=True, help="output directory")
    p.add_argument("-n", "--name", required=True, help="dataset name prefix")
    p.add_argument("-l", "--nlayers", type=int, default=2)
    p.add_argument("-f", "--hidden", type=int, default=16)
    p.add_argument("-c", "--nclasses", type=int, default=2)
    p.add_argument("-s", "--seed", type=int, default=0)
    args = p.parse_args(argv)
    a = read_mtx(args.adjacency)
    cfg = preprocess(a, args.out, args.name, args.nlayers, args.hidden,
                     args.nclasses, args.seed)
    print(f"wrote {args.name}.A/H/Y.mtx + config (n={cfg.nvtx}, "
          f"widths={cfg.widths}) to {args.out}")


if __name__ == "__main__":
    main()
