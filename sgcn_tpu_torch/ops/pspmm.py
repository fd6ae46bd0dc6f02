"""Halo exchange over stacked parts (port of
``sgcn_tpu/ops/pspmm.py::halo_exchange``).

Rank layout of this port: all ``k`` parts run stacked along a leading axis
in one process on one device (NCCL refuses two ranks on one GPU).  The
reference's per-chip ``lax.all_to_all(split_axis=0, concat_axis=0)`` of the
``(k, S, f)`` send buffer is, over the stacked ``(k, k, S, f)`` buffer,
exactly ``recv[q, p] = send[p, q]`` — a transpose of the first two axes
(the identity for ``k = 1``).  This function is the one place that knows
the layout: a multi-GPU slice swaps the transpose for
``torch.distributed.all_to_all_single`` and nothing else changes.
"""

from __future__ import annotations

import torch


def halo_exchange(h, send_idx, halo_src):
    """Exchange boundary rows; return every part's halo row block.

    Args:
      h: ``(k, B, f)`` local feature rows of all parts.
      send_idx: ``(k, k, S)`` int — ``send_idx[p, q]`` the local rows part
        ``p`` ships to part ``q`` (padded with 0; receivers never gather
        padded slots).
      halo_src: ``(k, R)`` int — flat indices into each part's received
        ``(k*S, f)`` buffer, in the plan's (owner, vertex-id) halo order.

    Returns ``(k, R, f)`` halo rows (padding rows hold garbage; only
    weight-0 edges reference them).
    """
    k, _, f = h.shape
    parts = torch.arange(k, device=h.device)
    send = h[parts[:, None, None], send_idx.long()]        # (k, k, S, f)
    recv = send.transpose(0, 1).reshape(k, -1, f)          # recv[q, p·S + t]
    return recv[parts[:, None], halo_src.long()]           # (k, R, f)
