"""Halo exchange and the ragged ring over stacked parts (port of
``sgcn_tpu/ops/pspmm.py::halo_exchange``, ``ragged_live_rounds`` and
``sgcn_tpu/ops/pallas_spmm.py::pallas_ring_concat``).

Rank layout of this port: all ``k`` parts run stacked along a leading axis
in one process on one device (NCCL refuses two ranks on one GPU).  The
reference's per-chip ``jnp.take`` of the send rows, its
``lax.all_to_all(split_axis=0, concat_axis=0)`` of the ``(k, S, f)`` send
buffer and its ``jnp.take`` of the halo rows are, over the stacked parts,
gathers of rows by a flat index ``part·rows + row`` that the plan computes
in numpy (``CommPlan.ensure_exchange``/``ensure_ragged``): part ``q``'s
receive buffer ``recv[q, p·S + t] = h[p, send_idx[p, q, t]]``
(``recv_src``), its halo rows ``recv[q, halo_src[q, r]]``
(``halo_src_flat``), and the ring's round-major concat
(``ring_src``: round ``d``'s rows arrive from part ``(q−d) mod k``, the
reference's ``lax.ppermute``).  Each is one launch of the row pack
(``ops/row_shuffle.py::row_pack``) that writes the receive layout
directly: no send buffer, transpose, roll or concatenation.  The functions
here are the one place that knows the layout: under one process per GPU
(ROADMAP A2b) each rank's gather by ``recv_src`` becomes its send pack
(``send_idx[p]`` in peer order), ``torch.distributed.all_to_all_single``
takes the place of the stacked layout's transpose, and the ring's rounds
become ``batch_isend_irecv``; nothing else changes.

An asymmetric Â (a directed graph) sends each aggregation's backward the
other way: every part's halo rows' partial gradients, laid out in its
forward receive layout, go back to their owners — ``reverse_exchange``,
one row pack by the plan's ``rev_src`` (the transpose of ``recv_src``);
under NCCL ranks it is the reverse ``all_to_all_single`` of the forward's.

The functions take the reference's ``halo_dtype``, a narrower dtype for
the WIRE only: the pack rounds each row to it as it stores it, so the receive
buffer and the ring concat hold half the bytes under ``'bfloat16'``; the
tile kernel reads them in place and widens each value exactly, which is
the reference's upcast of the received rows.
"""

from __future__ import annotations

import torch

from .row_shuffle import row_pack

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


def _wire(h, halo_dtype):
    return narrow_dtype(halo_dtype) or h.dtype


def exchange_recv(h, recv_src, halo_dtype=None):
    """Every part's receive buffer of the dense a2a exchange, in the wire's
    dtype: ``recv[q, p·S + t] = h[p, send_idx[p, q, t]]`` — one row pack.

    Args:
      h: ``(k, B, f)`` local rows of all parts (``(k, B)``: one scalar per
        row).
      recv_src: ``(k, k·S)`` int32, the plan's ``recv_src``: the flat
        stacked row ``p·B + send_idx[p, q, t]`` of each receive slot.
      halo_dtype: the wire's dtype (``'bfloat16'``), or ``None`` for
        ``h``'s own.

    Returns ``(k, k·S, f)`` (or ``(k, k·S)``) in the wire's dtype.  The
    halo tiles of the GCN aggregation read it in place (``ptile_hwsrc``);
    slots past a send list's length hold row 0 of the sender."""
    return row_pack(h.contiguous(), recv_src, _wire(h, halo_dtype))


def reverse_exchange(send_rev, rev_src, halo_dtype=None, dtype=None):
    """The backward's exchange of an asymmetric Â: every part's reverse
    send buffer — its halo rows' partials in its forward receive layout —
    goes back to the owners, ``rwire[p, q·S + t] = send_rev[q, p·S + t]``:
    one row pack.

    Args:
      send_rev: ``(k, rows, f)`` float32, the halo-ᵀ launch's output
        (slot ``q·S + t`` of part ``p`` holds the partial for row
        ``send_idx[q, p, t]`` of part ``q``; ``rows`` ≥ ``k·S``).
      rev_src: ``(k, k·S)`` int32, the plan's ``rev_src``
        (``CommPlan.ensure_transpose_tiles``).
      halo_dtype: the wire's dtype (``'bfloat16'``): the pack narrows the
        partials in its store — the rounding point of the reference's
        transpose of the halo rows' upcast (``sgcn_tpu/ops/pspmm.py:135-
        139``); the owner's sum over them stays float32.
      dtype: the wire's dtype without ``halo_dtype`` (the backward table's,
        bf16 under ``compute_dtype``); default ``send_rev``'s.

    Returns ``(k, k·S, f)`` in the wire's dtype."""
    return row_pack(send_rev.contiguous(), rev_src,
                    narrow_dtype(halo_dtype) or dtype or send_rev.dtype)


def halo_exchange(h, recv_src, halo_src_flat, halo_dtype=None):
    """Exchange boundary rows; return every part's halo row block: the
    receive buffer (``exchange_recv``), then its halo rows in the plan's
    (owner, vertex-id) order, upcast to ``h``'s dtype — two row packs.

    Args:
      h: ``(k, B, f)`` local feature rows of all parts, or ``(k, B)`` one
        scalar per row (the split GAT form ships its ``u`` in its own
        buffer, the reference's ``_exchange_rows_scalar``).
      recv_src: ``(k, k·S)`` int32, the plan's ``recv_src``.
      halo_src_flat: ``(k, R)`` int32, the plan's ``halo_src_flat``:
        ``q·k·S + halo_src[q, r]``, the halo rows' flat positions in the
        stacked receive buffers.
      halo_dtype: the wire's dtype (``'bfloat16'``), or ``None`` for
        ``h``'s own (``sgcn_tpu/ops/pspmm.py::halo_exchange``).

    Returns ``(k, R, f)`` (or ``(k, R)``) halo rows in ``h``'s dtype
    (padding rows hold garbage; only weight-0 edges reference them).
    """
    return row_pack(exchange_recv(h, recv_src, halo_dtype), halo_src_flat,
                    h.dtype)


def ragged_live_rounds(rr_sizes) -> tuple:
    """Ring distances ``d`` (1-based) of the rounds with ``S_d > 0``: the
    rounds that run.  A round of size 0 ships nothing and has no slot in
    the receive concat."""
    return tuple(d for d, sd in enumerate(rr_sizes, start=1) if sd > 0)


def ring_concat(h, ring_src, rr_sizes, halo_dtype=None):
    """The ragged ring's receive buffers, concatenated in round order —
    the remote pass's table — in one row pack.

    Per live round ``d`` (``ragged_live_rounds``) every part ``p`` ships
    its round slots ``h[p, rsend_idx[p, off:off+S_d]]`` to
    ``(p+d) mod k``, so part ``q`` receives from ``(q−d) mod k``; the
    plan's ``ring_src`` holds each concat slot's flat stacked row.
    Nothing is scattered into an ``(R, f)`` halo table: the plan re-bases
    the halo tile sources to positions in this concat (``ptile_hrsrc``,
    ``ptile_crsrc``).

    Args:
      h: ``(k, B, f)`` local rows of all parts (any trailing shape).
      ring_src: ``(k, ΣS_d)`` int32, the plan's ``ring_src``:
        ``((q−d) mod k)·B + rsend_idx[(q−d) mod k, off_d + t]``.
      rr_sizes: the static round sizes ``(S_1, …, S_{k−1})``.
      halo_dtype: each round's wire dtype (``'bfloat16'``), or ``None``
        for ``h``'s own.

    Returns ``(k, Σ_live S_d, f)`` in the wire's dtype (the tile kernel
    widens a bf16 wire exactly as it reads it: the reference's upcast,
    ``pallas_spmm.py:404-406``); an all-empty ring (k = 1, or no halo)
    gives a ``(k, 1, f)`` zero table.
    """
    if not ragged_live_rounds(rr_sizes):
        return h.new_zeros((h.shape[0], 1) + tuple(h.shape[2:]),
                           dtype=_wire(h, halo_dtype))
    return row_pack(h.contiguous(), ring_src, _wire(h, halo_dtype))
