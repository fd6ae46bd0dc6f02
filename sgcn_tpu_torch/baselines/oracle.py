"""Single-device dense oracle — ground truth for the partitioned trainer
(port of ``sgcn_tpu/baselines/oracle.py``).

The same math as ``FullBatchTrainer`` (same init, same optimizer, same
loss) on one device with a dense Â and ``torch.matmul``.  It is an
oracle, not a path of the system: nothing on the main path calls it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..models.activations import get_activation
from ..models.gcn import init_gcn_params, weight_tensors
from ..utils.backend import resolve_device


class DenseOracle:
    """Single-device full-batch GCN with a dense adjacency."""

    def __init__(self, a: sp.spmatrix, fin: int, widths: list[int],
                 lr: float = 0.01, activation: str = "relu",
                 final_activation: str = "none", optimizer=None,
                 seed: int = 0, params=None, device=None):
        """``optimizer``/``params``/``device`` as in ``FullBatchTrainer``:
        ``params=None`` draws the weights from a ``torch.Generator``
        seeded with ``seed`` — the trainer's init for the same seed."""
        self.device = resolve_device(device)
        self.a = torch.as_tensor(np.asarray(sp.coo_matrix(a).todense(),
                                            np.float32)).to(self.device)
        dims = list(zip([fin] + widths[:-1], widths))
        if params is None:
            params = init_gcn_params(torch.Generator().manual_seed(seed), dims)
        self.params = [nn.Parameter(w)
                       for w in weight_tensors(params, self.device)]
        self.opt = (optimizer(self.params) if optimizer is not None else
                    torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8))
        self.activation = activation
        self.final_activation = final_activation

    def forward(self, h):
        act = get_activation(self.activation)
        fact = get_activation(self.final_activation)
        nl = len(self.params)
        for i, w in enumerate(self.params):
            z = (self.a @ h) @ w
            h = fact(z) if i == nl - 1 else act(z)
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
