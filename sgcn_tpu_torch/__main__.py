"""``python -m sgcn_tpu_torch`` — the port's tool map (port of
``python -m sgcn_tpu``).

Each role is a module CLI under one package; this dispatcher only prints
the map, and each tool owns its flags (``--help`` on any of them).
"""

from __future__ import annotations

import sys

_TOOLS = (
    ("sgcn_tpu_torch.prep", "normalize Â, emit A/H/Y.mtx + config "
                            "(preprocess/GrB-GNN-IDG.py role)"),
    ("sgcn_tpu_torch.partition", "graph/hypergraph/random partitioner, part "
                                 "vectors + per-rank files (GCN-GP/GCN-HP/"
                                 "GPU partvec roles)"),
    ("sgcn_tpu_torch.train", "partitioned full-batch / mini-batch / GAT / "
                             "accuracy trainers on the card (grbgcn + "
                             "GPU/*.py roles)"),
    ("sgcn_tpu_torch.shp", "stochastic hypergraph model (GPU/SHP role)"),
    ("sgcn_tpu_torch.baselines", "oracle (DGL role) and cagnet (CAGNET "
                                 "role) comparison baselines"),
    ("sgcn_tpu_torch.serve", "partitioned inference under synthetic query "
                             "traffic on the card"),
    ("sgcn_tpu_torch.analysis", "static analysis: the launch and "
                                "collective census of every mode + AST "
                                "hygiene"),
)


def main(argv=None) -> int:
    # arguments mean a mistyped tool invocation (`python -m sgcn_tpu_torch
    # train` instead of `python -m sgcn_tpu_torch.train`): fail loudly
    args = sys.argv[1:] if argv is None else list(argv)
    out = sys.stderr if args else sys.stdout
    if args:
        print(f"unknown arguments {args} — the tools are separate modules:",
              file=out)
    else:
        print("sgcn_tpu_torch — the PyTorch + CUDA port of sgcn_tpu "
              "(partitioned GCN/GAT training on NVIDIA Hopper)\n", file=out)
    print("tools (run any with --help):", file=out)
    for mod, desc in _TOOLS:
        print(f"  python -m {mod:28s} {desc}", file=out)
    return 2 if args else 0


if __name__ == "__main__":
    sys.exit(main())
