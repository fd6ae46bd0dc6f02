"""Halo exchange and the ragged ring over stacked parts (port of
``sgcn_tpu/ops/pspmm.py::halo_exchange``, ``ragged_live_rounds`` and
``sgcn_tpu/ops/pallas_spmm.py::pallas_ring_concat``).

Rank layout of this port: all ``k`` parts run stacked along a leading axis
in one process on one device (NCCL refuses two ranks on one GPU).  The
reference's per-chip ``lax.all_to_all(split_axis=0, concat_axis=0)`` of the
``(k, S, f)`` send buffer is, over the stacked ``(k, k, S, f)`` buffer,
exactly ``recv[q, p] = send[p, q]`` — a transpose of the first two axes
(the identity for ``k = 1``).  Its ``lax.ppermute`` of ring round ``d``
(part ``p`` sends to ``(p+d) mod k``) is a roll of the stacked round
buffer by ``d`` parts.  ``halo_exchange`` and ``ring_concat`` are the one
place that knows the layout: a multi-GPU slice swaps the transpose for
``torch.distributed.all_to_all_single`` and the roll for
``batch_isend_irecv``, and nothing else changes.

Both take the reference's ``halo_dtype``, a narrower dtype for the WIRE
only: the send buffer is cast after the send gather and the received rows
are upcast back to ``h``'s dtype after the receive side's gather, so the
transpose (or the roll) moves half the bytes under ``'bfloat16'`` while
every table and sum stays in ``h``'s dtype.
"""

from __future__ import annotations

import torch

# the dtypes a halo_dtype or compute_dtype may name, by the reference's
# names: float32 (no narrowing, None) or bfloat16
_NARROW = {None: None, "float32": None, torch.float32: None,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def narrow_dtype(dtype, what: str = "halo_dtype"):
    """The torch dtype a ``halo_dtype`` or ``compute_dtype`` narrows to:
    ``torch.bfloat16`` for ``'bfloat16'`` (or the torch dtype), ``None``
    for ``None`` and float32.  Raises for any other."""
    if dtype not in _NARROW:
        raise ValueError(f"{what} {dtype!r}: the port narrows to 'bfloat16' "
                         "only")
    return _NARROW[dtype]


def halo_exchange(h, send_idx, halo_src, halo_dtype=None):
    """Exchange boundary rows; return every part's halo row block.

    Args:
      h: ``(k, B, f)`` local feature rows of all parts, or ``(k, B)`` one
        scalar per row (the split GAT form ships its ``u`` in its own
        ``(k, S)`` buffer, the reference's ``_exchange_rows_scalar``).
      send_idx: ``(k, k, S)`` int — ``send_idx[p, q]`` the local rows part
        ``p`` ships to part ``q`` (padded with 0; receivers never gather
        padded slots).
      halo_src: ``(k, R)`` int — flat indices into each part's received
        ``(k*S, ...)`` buffer, in the plan's (owner, vertex-id) halo order.
      halo_dtype: the wire's dtype (``'bfloat16'``), or ``None`` for
        ``h``'s own (``sgcn_tpu/ops/pspmm.py::halo_exchange``).

    Returns ``(k, R, f)`` (or ``(k, R)``) halo rows in ``h``'s dtype
    (padding rows hold garbage; only weight-0 edges reference them).
    """
    k = h.shape[0]
    wire = narrow_dtype(halo_dtype)
    parts = torch.arange(k, device=h.device)
    send = h[parts[:, None, None], send_idx.long()]        # (k, k, S, ...)
    if wire is not None:
        send = send.to(wire)
    recv = send.transpose(0, 1).reshape(k, -1, *h.shape[2:])  # recv[q, p·S+t]
    return recv[parts[:, None], halo_src.long()].to(h.dtype)  # (k, R, ...)


def ragged_live_rounds(rr_sizes) -> tuple:
    """Ring distances ``d`` (1-based) of the rounds with ``S_d > 0``: the
    rounds that run.  A round of size 0 ships nothing and has no slot in
    the receive concat."""
    return tuple(d for d, sd in enumerate(rr_sizes, start=1) if sd > 0)


def ring_concat(h, rsend_idx, rr_sizes, halo_dtype=None):
    """The ragged ring's receive buffers, concatenated in round order —
    the remote pass's table.

    Per live round ``d`` (``ragged_live_rounds``) every part ``p`` gathers
    its round slots ``h[p, rsend_idx[p, off:off+S_d]]`` and ships them to
    ``(p+d) mod k``, so part ``q`` receives from ``(q−d) mod k``: over the
    stacked parts that is ``torch.roll(·, shifts=d, dims=0)``.  Nothing is
    scattered into an ``(R, f)`` halo table: the plan re-bases the halo
    tile sources to positions in this concat (``ptile_hrsrc``,
    ``ptile_crsrc``).

    Args:
      h: ``(k, B, f)`` local rows of all parts (any trailing shape).
      rsend_idx: ``(k, ΣS_d)`` int — each part's send rows, round-major.
      rr_sizes: the static round sizes ``(S_1, …, S_{k−1})``.
      halo_dtype: each round's wire dtype (``'bfloat16'``), or ``None``
        for ``h``'s own: the round buffer is cast before the roll and
        upcast after it (``pallas_spmm.py:404-406``).

    Returns ``(k, Σ_live S_d, f)`` in ``h``'s dtype; an all-empty ring
    (k = 1, or no halo) gives a ``(k, 1, f)`` zero table.
    """
    k = h.shape[0]
    wire = narrow_dtype(halo_dtype)
    parts = torch.arange(k, device=h.device)[:, None]
    segs = []
    live = ragged_live_rounds(rr_sizes)
    off = 0
    for d, sd in enumerate(rr_sizes, start=1):
        if d in live:
            buf = h[parts, rsend_idx[:, off: off + sd].long()]  # (k, S_d, ...)
            if wire is not None:
                buf = buf.to(wire)
            segs.append(torch.roll(buf, shifts=d, dims=0)       # q ← q−d
                        .to(h.dtype))
        off += sd
    if not segs:
        return h.new_zeros((k, 1) + tuple(h.shape[2:]))
    return segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
