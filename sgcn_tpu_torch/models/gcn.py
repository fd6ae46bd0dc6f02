"""Partitioned GCN: per-layer stack over the tile-SpMM aggregator, and its
losses.

Port of the a2a tile-kernel branch of ``sgcn_tpu/models/gcn.py``
(``gcn_forward_local``), run over all ``k`` parts stacked on a leading
axis: per layer, halo exchange → tile SpMM → dense projection →
activation, with the reference's project-first layer order.  Weights keep
the reference's layout, ``(fin, fout)`` with ``h @ w``, so
``params_from_jax`` carries the JAX package's weights across unchanged.

The masked losses and metrics take stacked ``(k, b, ·)`` tensors; each of
the reference's ``lax.psum`` over chips is a sum over the ``k`` axis of
the per-part sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.tile_spmm import pspmm_tiles_sym
from .activations import get_activation

# Minimum input width (f32 elements) for the project-before-aggregate
# layer order.  Structural default MEASURED ON THE TPU (v5e) and kept so
# this port's layer order, and hence its numbers, match the reference's;
# it is to be re-measured on the H100 (ROADMAP).
PROJECT_FIRST_MIN_FIN = 256


def exchange_widths(fin: int, widths) -> list[int]:
    """Per-layer exchanged/aggregated row width under the project-first
    rule of ``gcn_forward_local``."""
    out, f = [], fin
    for w in widths:
        out.append(w if (w < f and f >= PROJECT_FIRST_MIN_FIN) else f)
        f = w
    return out


def init_gcn_params(generator: torch.Generator, dims, device="cpu"):
    """Glorot-uniform weight list, one ``(fin, fout)`` float32 matrix per
    layer, drawn from ``generator`` (the port's own init — a
    ``torch.Generator`` gives other numbers than ``jax.random``, so parity
    tests carry the reference's weights over with ``params_from_jax``)."""
    out = []
    for fin, fout in dims:
        lim = math.sqrt(6.0 / (fin + fout))
        w = torch.empty((fin, fout), dtype=torch.float32)
        w.uniform_(-lim, lim, generator=generator)
        out.append(w.to(device))
    return out


def params_from_jax(params, device="cpu"):
    """The JAX package's GCN params (a list of ``(fin, fout)`` arrays,
    passed as numpy) → float32 tensors on ``device``, same layout."""
    return [torch.tensor(np.asarray(w, np.float32), device=device)
            for w in params]


def weight_tensors(params, device="cpu"):
    """Weights given as numpy arrays (e.g. the JAX package's) or tensors
    → float32 copies on ``device``."""
    return [w.detach().to(device, torch.float32, copy=True)
            if isinstance(w, torch.Tensor)
            else torch.tensor(np.asarray(w, np.float32), device=device)
            for w in params]


def gcn_forward_local(
    params,
    h,                              # (k, B, f_in) stacked local rows
    pa,                             # plan tensors (TILE_PLAN_FIELDS)
    activation: str = "relu",
    final_activation: str = "none",
    pallas_tb: int = 256,           # static tile height
    pallas_lclasses: tuple = (),    # static local tile classes
    pallas_hclasses: tuple = (),    # static halo tile classes
):
    """Stacked forward: L × (tile pspmm ⊗ dense matmul → activation) →
    ``(k, B, nout)``.  A wide input narrowed by the layer is projected
    first (``(Â·H)·W = Â·(H·W)``), so the exchange and the SpMM touch the
    narrower rows — the reference's rule and threshold."""
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)

    def agg(x):
        return pspmm_tiles_sym(
            x, pa["send_idx"], pa["halo_src"],
            pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
            pa["ptile_hsrc"], pa["ptile_hld"], pa["ptile_hw"],
            pallas_tb, pallas_lclasses, pallas_hclasses)

    for i, w in enumerate(params):
        if w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN:
            z = agg(h @ w)
        else:
            z = agg(h) @ w
        h = fact(z) if i == nl - 1 else act(z)
    return h


class GCN(nn.Module):
    """The GCN as a module: the weights (numpy arrays or tensors, copied)
    as trainable parameters, the plan's static tile structure as
    attributes, ``forward(h, pa)`` over stacked parts.  Callers that only
    infer run it under ``torch.inference_mode()`` (the serve engine
    does)."""

    def __init__(self, params, activation: str = "relu",
                 final_activation: str = "none", fwd_static=None):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(w) for w in weight_tensors(params))
        self.activation = activation
        self.final_activation = final_activation
        self.fwd_static = dict(fwd_static or {})

    def forward(self, h, pa):
        return gcn_forward_local(
            list(self.weights), h, pa, activation=self.activation,
            final_activation=self.final_activation, **self.fwd_static)


def _picked(logp, labels):
    """``logp[..., labels]`` per row: ``(k, b, c)``, ``(k, b)`` → ``(k, b)``."""
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def masked_softmax_xent_local(logits, labels, valid):
    """Global mean softmax cross-entropy over valid (non-padding) rows:
    per-part sums, then the sum over parts (the reference's ``psum``);
    a batch with no valid row divides by 1, not 0."""
    picked = _picked(torch.log_softmax(logits, dim=-1), labels)
    total = (-(picked * valid).sum(dim=-1)).sum()
    count = valid.sum(dim=-1).sum()
    return total / torch.clamp(count, min=1.0)


def masked_sigmoid_bce_local(logits, labels, valid):
    """Global mean elementwise sigmoid + BCE against one-hot targets (the
    MPI trainer's loss flavor), in the stable softplus form."""
    y = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    bce = (torch.clamp(logits, min=0) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    total = (bce * valid[..., None]).sum(dim=(-2, -1)).sum()
    count = valid.sum(dim=-1).sum()
    return total / torch.clamp(count, min=1.0)


def masked_err_local(logits, labels, valid):
    """The MPI stack's printed ``err``: Σ −y·log σ(z) over valid rows,
    summed (not averaged) over parts."""
    picked = _picked(F.logsigmoid(logits), labels)
    return (-(picked * valid).sum(dim=-1)).sum()


def masked_accuracy_local(logits, labels, valid):
    """Global accuracy over valid rows."""
    hits = ((logits.argmax(dim=-1) == labels.long()) * valid).sum(dim=-1)
    count = valid.sum(dim=-1).sum()
    return hits.sum() / torch.clamp(count, min=1.0)
