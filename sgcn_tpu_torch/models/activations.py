"""Shared activation registry (port of ``sgcn_tpu/models/activations.py``):
``relu``, ``sigmoid``, ``elu`` and ``none``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "none": lambda x: x,
}


def get_activation(name: str):
    try:
        return ACTS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; one of {sorted(ACTS)}")
