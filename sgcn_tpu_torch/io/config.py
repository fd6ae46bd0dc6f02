"""The ``config`` sidecar file: ``"nlayers nvtx f1 ... f_{L-1} nout"``
(port of ``sgcn_tpu/io/config.py``).

The legacy line of the reference pipeline's preprocessor and partitioner,
which its trainers read: the layer count, the vertex count, then the
output width of every layer.  ``write_config`` writes it byte for byte as
the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    nlayers: int          # number of GCN layers
    nvtx: int             # number of vertices (global)
    widths: list[int] = field(default_factory=list)  # f1 ... f_{L-1}, nout

    @property
    def nout(self) -> int:
        return self.widths[-1]

    def layer_dims(self, fin: int) -> list[tuple[int, int]]:
        """(in, out) dims per layer given the input feature width."""
        dims = [fin] + list(self.widths)
        return list(zip(dims[:-1], dims[1:]))


def read_config(path: str) -> ModelConfig:
    with open(path) as f:
        toks = f.read().split()
    nlayers, nvtx = int(toks[0]), int(toks[1])
    widths = [int(t) for t in toks[2:]]
    return ModelConfig(nlayers=nlayers, nvtx=nvtx, widths=widths)


def write_config(path: str, cfg: ModelConfig) -> None:
    toks = [str(cfg.nlayers), str(cfg.nvtx)] + [str(w) for w in cfg.widths]
    with open(path, "w") as f:
        f.write(" ".join(toks) + "\n")
