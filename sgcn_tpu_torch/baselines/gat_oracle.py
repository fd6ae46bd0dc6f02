"""Single-device dense GAT oracle — ground truth for the partitioned GAT
(port of ``sgcn_tpu/baselines/gat_oracle.py``).

The same math as the partitioned GAT — the masked neighbour softmax of
``s_ij = z1_i + z2_j`` over Â's nonzero pattern (``A > 0``, as the
reference), ``H' = α·Z`` — on one device with a dense mask, its own
weights and its own Adam.  It is an oracle, not a path of the system:
nothing on the main path calls it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..models.activations import get_activation
from ..models.gat import gat_param_tensors, init_gat_params
from ..utils.backend import resolve_device

_NEG = -1e30


class DenseGATOracle:
    """Single-device full-batch GAT with a dense edge mask."""

    def __init__(self, a: sp.spmatrix, fin: int, widths: list[int],
                 lr: float = 0.01, activation: str = "none",
                 final_activation: str = "none", optimizer=None,
                 seed: int = 0, params=None, device=None):
        """``optimizer``/``params``/``device`` as in ``FullBatchTrainer``:
        ``params`` is a list of ``{w, a1, a2}`` dicts; ``None`` draws them
        from a ``torch.Generator`` seeded with ``seed`` — the trainer's
        init for the same seed."""
        self.device = resolve_device(device)
        self.mask = torch.as_tensor(
            np.asarray(sp.coo_matrix(a).todense() > 0)).to(self.device)
        dims = list(zip([fin] + widths[:-1], widths))
        if params is None:
            params = init_gat_params(torch.Generator().manual_seed(seed),
                                     dims)
        self.params = [{name: nn.Parameter(x) for name, x in p.items()}
                       for p in gat_param_tensors(params, self.device)]
        flat = [x for p in self.params for x in p.values()]
        self.opt = (optimizer(flat) if optimizer is not None else
                    torch.optim.Adam(flat, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8))
        self.activation = activation
        self.final_activation = final_activation

    def forward(self, h):
        act = get_activation(self.activation)
        fact = get_activation(self.final_activation)
        nl = len(self.params)
        for i, p in enumerate(self.params):
            z = h @ p["w"]
            scores = (z @ p["a1"])[:, None] + (z @ p["a2"])[None, :]
            scores = torch.where(self.mask, scores, _NEG)
            alpha = torch.softmax(scores, dim=-1)
            alpha = torch.where(self.mask, alpha, 0.0)
            h = alpha @ z
            h = fact(h) if i == nl - 1 else act(h)
        return h

    def loss(self, h, labels, mask):
        logp = torch.log_softmax(self.forward(h), dim=-1)
        picked = logp.gather(-1, labels[:, None])[:, 0]
        return -(picked * mask).sum() / mask.sum()

    def _inputs(self, h, labels, mask):
        h = torch.as_tensor(h, dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(labels, dtype=torch.int64,
                                 device=self.device)
        mask = (torch.ones(h.shape[0], device=self.device) if mask is None
                else torch.as_tensor(mask, dtype=torch.float32,
                                     device=self.device))
        return h, labels, mask

    def step(self, h, labels, mask=None) -> float:
        h, labels, mask = self._inputs(h, labels, mask)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(h, labels, mask)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def predict(self, h) -> np.ndarray:
        h = torch.as_tensor(h, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.forward(h).cpu().numpy()

    def fit(self, h, labels, mask=None, epochs: int = 5) -> list[float]:
        return [self.step(h, labels, mask) for _ in range(epochs)]
