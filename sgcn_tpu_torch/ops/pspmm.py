"""Halo exchange and the ragged ring over stacked parts, and the ELL
aggregators (port of ``sgcn_tpu/ops/pspmm.py::halo_exchange``,
``ragged_live_rounds`` and
``sgcn_tpu/ops/pallas_spmm.py::pallas_ring_concat``, and the stale
mode's ``_stale_exchange`` / ``_stale_ragged_exchange``).

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
here are the one place that knows the layout.  With one process per part
(``rank_exchange``, ROADMAP A2b) each rank holds its slice of the plan
(``parallel/proxy.py``), whose ``recv_src`` is its send pack's index
(``send_idx[c]`` in peer order), ``torch.distributed.all_to_all_single``
takes the place of the stacked layout's transpose, and the ring's rounds
become ``batch_isend_irecv``; the receive layouts are the same.  A GAT table's
exchange on a rank is ``rank_halo_exchange``: the same collective, then
the a2a's second pack by the slice's ``halo_src_flat``.

An asymmetric Â (a directed graph) sends each aggregation's backward the
other way: every part's halo rows' partial gradients, laid out in its
forward receive layout, go back to their owners — ``reverse_exchange``,
one row pack by the plan's ``rev_src`` (the transpose of ``recv_src``);
with one process per part it is the reverse ``all_to_all_single`` of the
forward's (``rank_reverse_exchange``: the halo-ᵀ output's first ``k·S``
rows are already the send buffer in peer order, so no pack runs).

``stale_exchange`` and ``stale_ring_exchange`` issue the stale mode's
exchange into a carry that stays in the receive layout (the halo-delta
cache's arithmetic included); the reference's ``(R, f)`` halo tables and
``(k, S, f)`` baselines exist in the port only at the checkpoint's edge
(``train/fullbatch.py``).

The hot-halo replicas live in the same receive layouts: a replica slot
is a receive slot that stops being overwritten between syncs.  A sync
step is the exact exchange; a replica step is ``replica_pack``, the
destination-indexed pack of the kept slots alone
(``row_shuffle.py::row_pack_into``); ``partial_refresh`` and
``partial_refresh_grad`` are the drift-banded refresh's side channels
(the reference's ``_partial_mask`` and masked increments), and
``carry_replica_rows``/``carry_set_replica_rows`` convert to and from the
reference's ``(k, RP, f)`` replica tables.

The carried modes on a rank (ROADMAP A2c) leave their exchanges in
flight: ``rank_stale_exchange`` issues step t's collective into a new
receive buffer and returns it as an ``InFlight`` carry, waited on only
when the carry is next read (``settle``).  Under the halo-delta cache a
rank keeps its senders' baselines itself, in its send-pack order.  A
replica step's exchange is the shrunken one (``rank_replica_exchange``:
its kept rows packed into the carry once they arrive), and the partial
refresh adds two side channels (``rank_partial_refresh`` and
``rank_partial_refresh_grad``).

The functions take the reference's ``halo_dtype``, a narrower dtype for
the WIRE only: the pack rounds each row to it as it stores it, so the receive
buffer and the ring concat hold half the bytes under ``'bfloat16'``; the
tile kernel reads them in place and widens each value exactly, which is
the reference's upcast of the received rows.

The reference's default aggregator, which ``SGCN_PALLAS_SPMM=0`` selects
(``ell_selected``, ``choose_ell_dispatch``), is ported at the end of this
module in torch ops (ROADMAP A2): ``bucketed_slot_reduce``, ``spmm_ell``,
``spmm_local``, ``pspmm`` / ``pspmm_exchange``,
``halo_exchange_ragged(_multi)``, ``_ragged_remote`` and the
``autograd.Function``s ``PspmmEllSym`` (a2a), ``PspmmRaggedSym`` (the
ring) and ``PspmmOverlap`` (any Â, the reference's ``pspmm_overlap``).
They read the chain layout the plan builds (``parallel/plan.py::
ell_chain_layout``): every scatter-add runs level by level
(``chain_add``), so each row's sum is the reference's serial chain in
stored order, run to run and ring against a2a bit for bit.  Their
exchange is this module's pack, one per exchange.  The GAT's slot passes
(``models/gat.py::GatLayerEll``) exchange through
``gat_exchange_table`` / ``gat_exchange_rows_scalar`` (the reference's
``_exchange_table`` / ``_exchange_rows_scalar``) and reduce with
``bucketed_slot_reduce``; an asymmetric plan's transposes, GCN's and
GAT's, share ``ell_transpose``.  Every ELL op takes ``mesh`` (ROADMAP
A2d): with one process per part each exchange is the rank's
(``rank_exchange`` issued before the local pass and waited on after it,
``rank_halo_exchange`` for a GAT table, ``rank_reverse_exchange`` for a
transpose's reverse exchange) over the chains of the rank's slice, which
are the stacked chains of its part, so a rank's rows are the stacked
op's row for its part bit for bit.
"""

from __future__ import annotations

import os

import torch

from ..utils import census
from .row_shuffle import row_pack, row_pack_into

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


# ------------------------------------------------ one process per part
def rank_exchange(h, send_flat, mesh, halo_dtype=None, rr_sizes=None):
    """Issue one rank's exchange without waiting on it (ROADMAP A2b): the
    send pack, then the collective, asynchronously.  Returns ``(recv,
    wait)``; ``recv`` holds the rank's receive layout once ``wait()`` has
    returned.

    The pack is one ``row_pack`` of the rank's own rows by ``send_flat``
    (its slice's ``recv_src`` — ``send_idx[c]`` in peer order — or
    ``ring_src`` — ``rsend_idx[c]`` in round order) into one buffer in the
    wire's dtype.  The a2a: one ``all_to_all_single`` of the ``(k·S, f)``
    buffer, so slot ``p·S + t`` receives ``h_p[send_idx[p, c, t]]``: the
    stacked receive layout's row ``c``.  The ring (``rr_sizes`` given):
    per live round ``d`` (``ragged_live_rounds``) one
    ``batch_isend_irecv`` that sends the round's
    slots to the rank ``d`` steps on and receives the same slots from the
    rank ``d`` steps back, the rounds concatenated in round order: the
    ring concat.  On a one-rank group both are the loopback of
    ``parallel/proxy.py``: the a2a's collective delivers the buffer to
    itself, and a round whose peer is the rank itself is a device copy
    (gloo refuses a send to self).

    Args:
      h: ``(1, B, f)`` the rank's local rows.
      send_flat: ``(1, J)`` int32 on ``h``'s device.
      mesh: the ``RankGroup``.
      halo_dtype: the wire's dtype (``'bfloat16'``) or ``None``.
      rr_sizes: the plan's static round sizes (the ring), or ``None``
        (the a2a)."""
    if rr_sizes is not None and not ragged_live_rounds(rr_sizes):
        # an empty ring ships nothing: ring_concat's zero table
        return ring_concat(h, send_flat, rr_sizes, halo_dtype), lambda: None
    pack = row_pack(h.contiguous(), send_flat, _wire(h, halo_dtype))
    recv, works = _rank_issue(pack, mesh, rr_sizes)

    def wait():
        census.collective("wait")
        for w in works:
            w.wait()
    return recv, wait


def rank_reverse_exchange(send_rev, slots: int, mesh, halo_dtype=None,
                          dtype=None):
    """Issue one rank's reverse exchange of an asymmetric Â's backward
    without waiting on it (the rank form of ``reverse_exchange``; ROADMAP
    A2c): the first ``slots = k·S`` rows of ``send_rev`` — the halo-ᵀ
    launch's ``(1, rows, f)`` float32 output, slot ``q·S + t`` the
    partial for row ``send_idx[q, c, t]`` of part ``q`` — narrowed to the
    wire's dtype (the stacked pack's rounding point: one rounding of each
    float32 partial), then one asynchronous ``all_to_all_single`` with
    equal splits of ``S``, so slot ``q·S + t`` of the received buffer
    holds part ``q``'s partial for this rank's row ``send_idx[c, q, t]``:
    the stacked ``rwire``'s row ``c``.  The stacked ``rev_src`` gather is
    the collective itself, so no row pack runs.  On a one-rank group the
    collective delivers the buffer to itself, the loopback of the
    slice's ``rev_src`` (``parallel/proxy.py``).  Returns ``(rwire,
    wait)`` as ``rank_exchange`` does; ``halo_dtype`` and ``dtype`` as in
    ``reverse_exchange``."""
    wire = narrow_dtype(halo_dtype) or dtype or send_rev.dtype
    send = send_rev[:, :slots]
    if send.dtype != wire or not send.is_contiguous():
        send = send.to(wire, memory_format=torch.contiguous_format)
    rwire, works = _rank_issue(send, mesh)

    def wait():
        census.collective("wait")
        for w in works:
            w.wait()
    return rwire, wait


def _rank_issue(pack, mesh, rr_sizes=None):
    """Issue the collective of one rank's packed send buffer ``pack``
    ``(1, J, ...)``: the a2a's ``all_to_all_single`` (equal splits of
    ``J``), or per live ring round one ``batch_isend_irecv`` (a round to
    the rank itself, on a one-rank group, a device copy).  Returns
    ``(recv, works)``: the receive buffer and the pending works.  The
    collectives keep their tensors alive until they complete."""
    import torch.distributed as dist

    recv = torch.empty_like(pack)
    if rr_sizes is None:
        census.collective("all_to_all", pack[0])
        return recv, [dist.all_to_all_single(recv[0], pack[0],
                                             async_op=True)]
    works, off = [], 0
    for d in ragged_live_rounds(rr_sizes):
        sl = slice(off, off + rr_sizes[d - 1])
        if mesh.peer(d) == mesh.rank:          # a one-rank group: loopback
            census.collective("loopback", pack[0, sl])
            recv[0, sl].copy_(pack[0, sl])
        else:
            census.collective("isend_irecv", pack[0, sl])
            works += dist.batch_isend_irecv([
                dist.P2POp(dist.isend, pack[0, sl], mesh.peer(d)),
                dist.P2POp(dist.irecv, recv[0, sl], mesh.peer(-d))])
        off += rr_sizes[d - 1]
    return recv, works


# ------------------------------------- the carried modes on one process a part
class InFlight:
    """A rank's carry whose exchange may still be in flight (ROADMAP
    A2c): the buffer the collective writes, its pending works, and what
    the receiver makes of the buffer once they complete (``finish``: the
    halo-delta cache's add, or a replica step's pack into the carried
    layout).  Nothing waits until the carry is read: ``wait()`` (or
    ``settle``) waits on the works once, applies ``finish`` once and
    returns the carry; ``waited`` says whether that has happened."""

    __slots__ = ("_value", "_works", "_finish", "waited")

    def __init__(self, value, works=(), finish=None):
        self._value, self._works, self._finish = value, list(works), finish
        self.waited = not self._works and finish is None

    @property
    def buffer(self):
        """The carry's tensor as it stands, without waiting (its storage:
        what the census's in-place rule compares)."""
        return self._value

    def wait(self):
        if not self.waited:
            if self._works:
                census.collective("wait")
            for w in self._works:
                w.wait()
            if self._finish is not None:
                self._value = self._finish(self._value)
            self._works, self._finish, self.waited = [], None, True
        return self._value


def settle(carry):
    """A carry as a tensor: an ``InFlight`` waited on, a tensor as is."""
    return carry.wait() if isinstance(carry, InFlight) else carry


def rank_stale_exchange(x, carry_in, base_in, send_flat, mesh,
                        rr_sizes=None, delta=False, wire_dtype=None,
                        fresh=False):
    """Issue step t's stale exchange on one rank and return ``(carry_next,
    base_next)`` without waiting: ``carry_next`` is an ``InFlight`` over a
    new receive buffer (the rank form of ``stale_exchange`` /
    ``stale_ring_exchange``; ``send_flat`` the slice's ``recv_src`` or
    ``ring_src``, ``rr_sizes`` the ring's).  Its consumer is the next
    read of the carry, not this step.

    Under ``delta`` the halo-delta cache's two ends are on two
    processes: the sender keeps ``base`` — ``(1, J, f)`` float32 in its
    send-pack order, the value every receiver holds for each slot — ships
    ``wire = (pack(x) − base)`` rounded to ``wire_dtype`` (``None``:
    bf16) and adds it, ``base_next = base + wire``; the receiver adds the
    wire to ``carry_in`` once it arrives.  A ``fresh`` step ships the
    float32 row and both ends take it.  The same values as the stacked
    tensor, slot for slot, so the same bits.  Without ``delta``
    ``base_next`` is ``None``."""
    if not delta:
        pack = row_pack(x.contiguous(), send_flat, _wire(x, wire_dtype))
        recv, works = _rank_issue(pack, mesh, rr_sizes)
        return InFlight(recv, works), None
    full = row_pack(x.contiguous(), send_flat, x.dtype)
    if fresh:
        recv, works = _rank_issue(full, mesh, rr_sizes)
        return InFlight(recv, works), full
    wdt = (torch.bfloat16 if wire_dtype is None
           else narrow_dtype(wire_dtype) or torch.float32)
    wire = torch.empty(full.shape, dtype=wdt, device=full.device)
    torch.sub(full, base_in, out=wire)
    recv, works = _rank_issue(wire, mesh, rr_sizes)
    return (InFlight(recv, works, lambda w: settle(carry_in) + w),
            base_in + wire)


def rank_replica_exchange(x, send_flat, nsrc, dst, mesh, rr_sizes=None,
                          wire_dtype=None):
    """Issue a replica step's SHRUNKEN exchange on one rank: its kept rows
    (``send_flat``: the slice's ``nrep_send_idx`` flat, or
    ``nrep_rsend_idx`` with the shrunken ring's ``rr_sizes``) packed in
    the wire's dtype and the collective issued.  Returns ``(works,
    finish)``: once the works are done, ``finish(carry)`` packs the
    received rows into ``carry`` in place (``row_pack_into`` by the
    slice's ``keep_nrecv_src`` / ``keep_nring_src`` → ``keep_recv_dst`` /
    ``keep_ring_dst``; the replica slots keep the last sync's rows) —
    ``InFlight(carry, works, finish)``."""
    if rr_sizes is not None and not ragged_live_rounds(rr_sizes):
        return [], None
    pack = row_pack(x.contiguous(), send_flat, _wire(x, wire_dtype))
    recv, works = _rank_issue(pack, mesh, rr_sizes)
    return works, lambda carry: row_pack_into(carry, recv, nsrc, dst)


def _real_slots(side):
    """A rank's ``(k·RS')`` side-channel slots that hold a row (the
    reference's ``slot_valid``: below its count to each peer)."""
    pos, counts = side["ronly_base_pos"], side["ronly_send_counts"]
    return (torch.arange(pos.shape[-1], device=pos.device)[None, None]
            < counts[..., None]).reshape(-1)


def rank_partial_refresh(x, base, side, band: float, mesh, wire_dtype=None):
    """The partial refresh's forward side channel on one rank (the rank
    form of ``partial_refresh``): the sender's mask and wire-rounded
    increments over its owned replicated rows, the baselines advanced,
    and one ``all_to_all_single`` of the ``(k·RS', f)`` increments packed
    by ``ronly_base_pos`` (the reference's ``_pspmm_replica_partial_once``;
    a pad slot ships 0, its ``slot_valid``: no receiver of a full group
    reads one, a one-rank group's loopback may).  ``side``: the slice
    tensors ``rep_rows_flat``,
    ``rep_row_valid``, ``ronly_base_pos``, ``ronly_send_counts``,
    ``rep_recv_src``, ``rep_dst``.

    Returns ``(works, finish, base_next, nship, mask)``: once the works
    are done, ``finish(carry)`` adds each replica slot's increment into
    the float32 ``carry`` in place; ``nship`` this rank's side-channel
    slots that carried a row (the stats sum it over the ranks); ``mask``
    the ``(1, RS)`` rows refreshed, which the gradient's side channel
    ships again."""
    f = x.shape[-1]
    wdt = narrow_dtype(wire_dtype) or x.dtype
    mask, qinc = _drift_increments(x, base, side, band, wire_dtype)
    pos, real = side["ronly_base_pos"].reshape(1, -1), _real_slots(side)
    nship = (mask.reshape(-1)[pos[0].long()] & real).sum()
    wire = row_pack(qinc, pos, wdt)
    wire.mul_(real[None, :, None].to(wdt))
    recv, works = _rank_issue(wire, mesh)

    def finish(carry):
        src, dst = side["rep_recv_src"], side["rep_dst"].long()
        inc = recv.reshape(-1, f).index_select(
            0, src[0, : dst.numel()].long()).to(carry.dtype)
        cf = carry.view(-1, f)
        cf.index_copy_(0, dst, cf.index_select(0, dst) + inc)
        return carry
    return works, finish, base + qinc, nship, mask


def rank_partial_refresh_grad(g, side, mask, mesh, wire_dtype=None):
    """The partial refresh's gradient side channel on one rank (the rank
    form of ``partial_refresh_grad``): the rows ``mask`` marks ship their
    gradient and a 0/1 indicator lane, ``(k·RS', f + 1)`` in the wire's
    dtype by ``ronly_base_pos``, one ``all_to_all_single``.  Returns
    ``(works, finish)``: once the works are done, ``finish(gcarry)``
    writes the slots whose indicator is 1 with the owner's row (set
    semantics, the reference's ``grep·(1 − r) + vals·r``), in place."""
    _one, rs = side["rep_rows_flat"].shape
    f = g.shape[-1]
    wdt = narrow_dtype(wire_dtype) or g.dtype
    gr = g.reshape(-1, f).index_select(
        0, side["rep_rows_flat"].reshape(-1).long()).reshape(1, rs, f)
    m = mask.to(g.dtype)[..., None]
    gtab = torch.cat([gr * m, m], dim=-1)
    gwire = row_pack(gtab, side["ronly_base_pos"].reshape(1, -1), wdt)
    gwire.mul_(_real_slots(side)[None, :, None].to(wdt))  # pads: no lane
    recv, works = _rank_issue(gwire, mesh)

    def finish(gcarry):
        src, dst = side["rep_recv_src"], side["rep_dst"].long()
        vals = recv.reshape(-1, f + 1).index_select(
            0, src[0, : dst.numel()].long()).to(g.dtype)
        act = vals[:, f:]
        cf = gcarry.view(-1, f)
        old = cf.index_select(0, dst).to(g.dtype)
        cf.index_copy_(0, dst, (old * (1.0 - act) + vals[:, :f] * act)
                       .to(cf.dtype))
        return gcarry
    return works, finish


def chain(*finishes):
    """One ``finish`` that applies each given one (``None`` skipped) in
    turn: a replica step's pack into the carry, then its side channel."""
    steps = [f for f in finishes if f is not None]

    def finish(carry):
        for step in steps:
            carry = step(carry)
        return carry
    return finish if steps else None


def rank_halo_exchange(h, send_flat, halo_src_flat, mesh, rr_sizes=None):
    """One rank's halo rows of a GAT table (the rank form of
    ``halo_exchange`` and, with ``rr_sizes``, of ``ring_concat``): the
    exchange (``rank_exchange``), waited on at once, then on the a2a the
    second row pack of the receive layout by the rank's re-based
    ``halo_src_flat`` (``halo_src[c]``: positions in its own ``(k·S)``
    window), upcast to ``h``'s dtype.  Returns ``(1, R, f)`` (or ``(1,
    R)``) halo rows, or on the ring the ``(1, ΣS_d, f)`` concat: the
    stacked functions' row for this rank, bit for bit.

    The GAT pass reads a row's local and halo in-edges in one chain, so
    nothing overlaps this exchange: the caller's K5 launch waits for it."""
    recv, wait = rank_exchange(h, send_flat, mesh, None, rr_sizes)
    wait()
    if rr_sizes is not None:
        return recv
    return row_pack(recv, halo_src_flat, h.dtype)


def _stale_step(exchange, x, carry_in, delta, wire_dtype, fresh):
    """One stale-mode exchange into the carry's layout (the lockstep
    contract of ``_stale_exchange``).  Without ``delta`` the carry is
    the exchange itself at ``wire_dtype``.  With it the carry is float32:
    a ``fresh`` step re-bases with the full row; a stale step ships
    ``(full − carry)`` rounded to ``wire_dtype`` (bf16 by default) and
    adds that increment to the carry."""
    if not delta:
        return exchange(x, wire_dtype)
    full = exchange(x, None)
    return full if fresh else delta_step(full, carry_in, wire_dtype)


def delta_step(full, carry_in, wire_dtype=None):
    """The halo-delta cache's arithmetic on a float32 carry: ``carry +
    wire`` with ``wire = (full − carry)`` rounded to ``wire_dtype``
    (``None``: bf16) — what both ends of the wire add.  Two passes: the
    difference is rounded as it is stored, and the add widens the
    increment exactly; the same bits as ``(full − carry).to(dtype)`` and
    ``carry + wire.float()``, with no float32 temporaries."""
    wdt = (torch.bfloat16 if wire_dtype is None
           else narrow_dtype(wire_dtype) or torch.float32)
    wire = torch.empty(full.shape, dtype=wdt, device=full.device)
    torch.sub(full, carry_in, out=wire)
    return carry_in + wire


def stale_exchange(x, carry_in, recv_src, delta=False, wire_dtype=None,
                   fresh=False):
    """Issue step t's a2a exchange of the stale mode and return the next
    carry (port of ``sgcn_tpu/ops/pspmm.py::_stale_exchange``).

    The carry is every part's receive buffer ``(k, k·S, f)``
    (``exchange_recv``'s layout, which the halo tiles read in place), not
    the reference's ``(R, f)`` halo table; the reference's ``(R, f)``
    rows are its gather by ``halo_src_flat``.  Under ``delta`` the
    halo-delta cache's two ends — the receiver's cached halo and the
    sender's baseline ``base[p, q, t]`` — hold the same value in every
    receive slot ``recv[q, p·S + t]``: both start from the fresh row of a
    sync step and add the same quantized increment.  So one float32
    tensor is both, and the baseline is its transpose: ``base[p, q, t] =
    carry[q, p·S + t]``.

    Args:
      x: ``(k, B, f)`` float32 local rows of all parts.
      carry_in: the carry from step t−1 (ignored unless ``delta`` and not
        ``fresh``).
      recv_src: the plan's ``recv_src``.
      delta: the halo-delta cache (float32 carry, bf16 increments).
      wire_dtype: the wire's dtype: the increments' under ``delta``
        (``None`` = bf16), else the full rows' (``None`` = ``x``'s).
      fresh: a sync step: the full row, exactly the exact exchange.

    Returns the next carry ``(k, k·S, f)``: ``x``'s dtype under ``delta``,
    else the wire's."""
    return _stale_step(lambda h, dt: exchange_recv(h, recv_src, dt), x,
                       carry_in, delta, wire_dtype, fresh)


def stale_ring_exchange(x, carry_in, ring_src, rr_sizes, delta=False,
                        wire_dtype=None, fresh=False):
    """``stale_exchange`` on the ragged ring (port of
    ``sgcn_tpu/ops/pspmm.py::_stale_ragged_exchange``): the carry is the
    ring's round-major receive concat ``(k, ΣS_d, f)`` (``ring_concat``),
    which is the reference's own carry layout, one row pack per step.
    Under ``delta`` each round's increment is rounded and added per slot,
    so the round structure needs no code of its own; the reference's
    sender-side baseline of round ``d`` is the carry rolled back by ``d``
    parts (``base[p, off_d + t] = carry[(p + d) mod k, off_d + t]``)."""
    return _stale_step(lambda h, dt: ring_concat(h, ring_src, rr_sizes, dt),
                       x, carry_in, delta, wire_dtype, fresh)


# ------------------------------------------- the reference's carry layout
# The stale trainer's carries stay in the receive layouts above; these
# convert them to the reference's layout (its checkpoint's, and the rows
# its drift gauges sum over) and back.
def recv_halo_rows(recv, halo_src_flat):
    """The reference's ``(R, f)`` halo table of every part from a2a
    receive buffers: ``(k, k·S, f)`` → ``(k, R, f)`` float32, padding
    rows included (each reads the slot its ``halo_src`` names)."""
    k, _, f = recv.shape
    idx = halo_src_flat.reshape(-1).long()
    return recv.reshape(-1, f).index_select(0, idx).reshape(k, -1, f).float()


def recv_from_halo_rows(rows, halo_src_flat, shape, dtype):
    """Receive buffers holding the ``(k, R, f)`` halo rows at the slots
    their ``halo_src`` names and 0 elsewhere: the slots no halo row names
    (send-list padding) carry weight 0 in every halo tile, so their values
    change no sum.  Inverse of ``recv_halo_rows`` on the named slots."""
    out = rows.new_zeros(shape, dtype=dtype)
    idx = halo_src_flat.reshape(-1).long()
    out.reshape(-1, shape[-1]).index_copy_(
        0, idx, rows.reshape(-1, shape[-1]).to(dtype))
    return out


def recv_to_send_bases(recv, s: int):
    """The senders' ``(k, S, f)`` delta baselines from the a2a carry:
    ``base[p, q, t] = recv[q, p·S + t]`` → ``(k, k, S, f)`` float32."""
    k, _, f = recv.shape
    return recv.reshape(k, k, s, f).transpose(0, 1).float().contiguous()


def recv_from_send_bases(base, dtype):
    """Inverse of ``recv_to_send_bases``: ``(k, k, S, f)`` → ``(k, k·S,
    f)``."""
    k, _, s, f = base.shape
    return base.transpose(0, 1).reshape(k, k * s, f).to(dtype).contiguous()


def ring_to_send_bases(ring, rr_sizes, inverse: bool = False):
    """The senders' round-major delta baselines from the ring carry: the
    slots of round ``d`` arrived from part ``(q − d) mod k``, so
    ``base[p, off_d + t] = ring[(p + d) mod k, off_d + t]``;
    ``inverse=True`` maps baselines back to the carry."""
    out = ring.float().clone()
    off = 0
    for d, sd in enumerate(rr_sizes, start=1):
        if sd:
            out[:, off: off + sd] = torch.roll(ring[:, off: off + sd],
                                               d if inverse else -d, dims=0)
        off += sd
    return out


# ---------------------------------------------------------- hot-halo replicas
def replica_pack(carry, x, keep_src, keep_dst, wire_dtype=None):
    """A replica step's exchange (port of the shrunken exchange of
    ``_replica_halo``/``_replica_ring_halo``/``_replica_stale_exchange``):
    the kept (non-replicated) rows of ``x`` go into their slots of the
    carried receive layout ``carry``, in place, rounded to the wire's
    dtype; the replica slots, and the pads, keep what the last sync wrote.
    One launch of ``row_pack_into`` (none when every boundary row is
    replicated).

    Args:
      carry: ``(k, J, f)`` the receive layout (a2a buffer or ring
        concat), float32 or the wire's dtype.
      x: ``(k, B, f)`` float32 local rows.
      keep_src/keep_dst: the plan's ``keep_recv_*`` or ``keep_ring_*``.
      wire_dtype: the wire's dtype (``'bfloat16'``) or ``None``.

    Returns ``carry``.  A bf16 wire into a float32 carry (the partial
    refresh keeps its replica values float32) rounds ``x`` first."""
    wire = narrow_dtype(wire_dtype) or x.dtype
    src = x if carry.dtype == wire else x.to(wire)
    return row_pack_into(carry, src.contiguous(), keep_src, keep_dst)


def carry_replica_rows(carry, rep_dst, rep_table_pos, rp: int):
    """The reference's ``(k, RP, f)`` replica tables from a receive-layout
    carry, float32: each replica slot's row at its (part, rank), 0 on the
    pads (``rep_*_dst`` and ``rep_table_pos`` of the plan)."""
    k, _, f = carry.shape
    out = carry.new_zeros((k * rp, f), dtype=torch.float32)
    out.index_copy_(0, rep_table_pos.long(),
                    carry.reshape(-1, f).index_select(0, rep_dst.long())
                    .float())
    return out.reshape(k, rp, f)


def carry_set_replica_rows(carry, table, rep_dst, rep_table_pos):
    """Inverse of ``carry_replica_rows`` on the replica slots: write the
    ``(k, RP, f)`` table's real rows into ``carry`` in place."""
    f = carry.shape[-1]
    rows = table.reshape(-1, f).index_select(0, rep_table_pos.long())
    carry.view(-1, f).index_copy_(0, rep_dst.long(), rows.to(carry.dtype))
    return carry


def _drift_increments(x, base, side, band: float, wire_dtype=None):
    """The senders' side of the partial refresh (the reference's
    ``_partial_mask`` and masked increment): over each part's owned
    replicated rows (``side``'s ``rep_rows_flat`` / ``rep_row_valid``),
    row ``i`` refreshes iff ``‖x_i − base_i‖² > band²·‖base_i‖²``.
    Returns ``(mask, qinc)``: the ``(k, RS)`` rows refreshed and their
    increments rounded to the wire's dtype (0 elsewhere), float32."""
    k, rs = side["rep_rows_flat"].shape
    f = x.shape[-1]
    xr = x.reshape(-1, f).index_select(
        0, side["rep_rows_flat"].reshape(-1).long()).reshape(k, rs, f)
    valid = side["rep_row_valid"]
    diff = (xr - base) * valid[..., None].to(x.dtype)
    drift2 = torch.sum(torch.square(diff), dim=-1)
    ref2 = torch.sum(torch.square(base), dim=-1)
    mask = (drift2 > (band * band) * ref2) & (valid > 0)
    wdt = narrow_dtype(wire_dtype) or x.dtype
    return mask, (diff * mask[..., None].to(x.dtype)).to(wdt).to(x.dtype)


def partial_refresh(x, carry, base, side, band: float, wire_dtype=None):
    """The drift-banded partial refresh's forward side channel (port of
    ``_partial_mask`` and the masked increment of
    ``_pspmm_replica_partial_once``), in place on the replica slots of a
    float32 ``carry``.

    Row ``i`` of a sender's owned replicated rows refreshes iff
    ``‖x_i − base_i‖² > band²·‖base_i‖²``; its increment, rounded to the
    wire's dtype, is added to the sender's baseline and to every consumer
    copy (the lockstep of the two ends).

    Args:
      x: ``(k, B, f)`` float32 local rows.
      carry: ``(k, J, f)`` float32 receive layout; its replica slots hold
        the replicas.
      base: ``(k, RS, f)`` float32 sender baselines.
      side: the plan tensors ``rep_rows_flat``, ``rep_row_valid``,
        ``rep_base_flat``, ``rep_dst`` (the transport's replica slots).
      band: the relative drift band ``RHO``.

    Returns ``(base_next, nship, active)``: the new baselines, the number
    of replica copies refreshed (the side channel's true rows) and the
    per-replica-slot 0/1 refresh mask the gradient's side channel uses."""
    f = x.shape[-1]
    mask, qinc = _drift_increments(x, base, side, band, wire_dtype)
    base_next = base + qinc
    pos = side["rep_base_flat"].long()
    active = mask.reshape(-1).index_select(0, pos)
    dst = side["rep_dst"].long()
    cf = carry.view(-1, f)
    cf.index_copy_(0, dst, cf.index_select(0, dst)
                   + qinc.reshape(-1, f).index_select(0, pos))
    return base_next, active.sum(), active


def partial_refresh_grad(gcarry, g, side, active, wire_dtype=None):
    """The partial refresh's gradient side channel (port of the backward
    of ``pspmm_replica_partial``), in place on ``gcarry``'s replica slots:
    the slots ``active`` marks take the owner's fresh gradient row rounded
    to the wire's dtype, the others keep theirs (set semantics: the
    reference's ``grep·(1 − r) + vals·r``).  ``side``: ``rep_src_flat``
    and ``rep_dst``."""
    f = g.shape[-1]
    wdt = narrow_dtype(wire_dtype) or g.dtype
    act = active.to(g.dtype)[:, None]
    vals = (g.reshape(-1, f).index_select(0, side["rep_src_flat"].long())
            * act).to(wdt).to(g.dtype)
    dst = side["rep_dst"].long()
    cf = gcarry.view(-1, f)
    old = cf.index_select(0, dst).to(g.dtype)
    cf.index_copy_(0, dst, (old * (1.0 - act) + vals * act).to(cf.dtype))
    return gcarry


# ------------------------------------------------------ the ELL aggregators
# The reference's default aggregator (``sgcn_tpu/ops/pspmm.py:48-107,
# 169-556``): XLA gathers and segment sums outside any ``pallas_call``,
# here torch ops over the stacked parts (ROADMAP A2).  The exchange is the
# port's own row pack, one per exchange as on the tile path; the sums
# launch no kernel of this package.
#
# The order of the sums.  XLA:CPU's sorted ``segment_sum`` and
# ``.at[].add`` apply their updates one after another in stored order, so
# each output row is one serial chain from +0.  ``torch.index_add_`` on a
# CUDA tensor with a row named twice adds in an order that changes from
# run to run, so every scatter here runs level by level
# (``parallel/plan.py::chain_levels``): level j holds each row's j-th
# update, no row twice, and the levels in order form the reference's
# chains.  The ring folds its rounds' levels after one another, the same
# chain per row as the a2a fold over ``hedge_*`` (sorted by (dst, round,
# receive position)): ELL ring == ELL a2a bit for bit.  The slot passes
# start from the first slot's product and add the rest in slot order, the
# reference's unrolled branch; its scan branch (above 1.5 GiB of slot
# temps, ``_CONCURRENT_TEMP_LIMIT`` & co.) is an XLA scheduling budget
# and not carried: this loop holds one slot's gather at a time.

def _rows(x):
    """``(k, rows, f)`` → the ``(k·rows, f)`` view the flat indices name."""
    return x.reshape(-1, x.shape[-1])


def chain_add(out, table, src, dst, w, levels):
    """``out[dst_e] += table[src_e] · w_e`` over the updates in
    ``chain_levels`` order, one level at a time (in place; returns
    ``out``).  ``table`` rows are cast to ``out``'s dtype before the
    product (a bf16 wire's upcast), ``w`` (``None``: weight 1) to it
    too; each level is one gather, one product and one ``index_add_``
    whose rows are distinct, so each row's sum is its serial chain."""
    if w is not None and w.dtype != out.dtype:
        w = w.to(out.dtype)
    off = 0
    for n in levels:
        seg = slice(off, off + n)
        vals = table.index_select(0, src[seg])
        if vals.dtype != out.dtype:
            vals = vals.to(out.dtype)
        if w is not None:
            vals.mul_(w[seg, None])
        out.index_add_(0, dst[seg], vals)
        off += n
    return out


def bucketed_slot_reduce(flat_src, flat_w, buckets, contrib, k: int = 1):
    """Σ over width slots of ``contrib(src_t, w_t)`` per bucket (port of
    the reference's unrolled branch): ``buckets = ((nb, wb), ...)``, the
    flat arrays hold, bucket after bucket and slot after slot, one
    ``(k·nb)`` run per slot (``ell_chain_layout``'s ``ell_src`` /
    ``ell_w``, or ``cell_src`` / ``cell_m``).  ``contrib`` returns a
    tensor or a tuple of tensors (the GAT's feature and scalar sums).
    Each bucket's sum starts from its first slot's contribution and adds
    the others in slot order.  Returns the per-bucket sums in bucket
    order."""
    outs, off = [], 0
    for nb, wb in buckets:
        run, acc = k * nb, None
        for t in range(wb):
            seg = slice(off + t * run, off + (t + 1) * run)
            c = contrib(flat_src[seg], flat_w[seg])
            if acc is None:
                acc = c
            elif isinstance(c, tuple):
                acc = tuple(a.add_(x) for a, x in zip(acc, c))
            else:
                acc = acc.add_(c)
        outs.append(acc)
        off += run * wb
    return outs


def spmm_local(edge_dst, edge_src, edge_w, table, num_rows: int, levels):
    """Masked segment-sum SpMM (port of ``spmm_local``): ``out[i] = Σ_e
    w_e · table[src_e]`` for ``dst_e = i``, each row one serial chain in
    stored order.  ``table`` ``(rows, f)`` flat over the stacked parts;
    the edges are a ``chain_levels`` family with flat indices.  Returns
    ``(num_rows, f)`` in ``table``'s dtype."""
    out = table.new_zeros((num_rows, table.shape[-1]))
    return chain_add(out, table, edge_src, edge_dst, edge_w, levels)


def spmm_ell(ell_src, ell_w, tail_dst, tail_src, tail_w, h, buckets,
             tail_levels):
    """Local SpMM in bucketed-ELL layout plus the COO hub tail (port of
    ``spmm_ell``) over stacked ``h`` ``(k, B, f)``: per width slot one
    gather·weight and one add into the bucket's rows, then the tail's
    chains (from +0) added.  ``ell_w`` and ``tail_w`` are cast to ``h``'s
    dtype (the reference's plan arrays under ``compute_dtype``).
    Returns ``(k, B, f)``."""
    if sum(nb * wb for nb, wb in buckets) * h.shape[0] != ell_src.shape[0]:
        raise ValueError(
            f"bucket structure {buckets} does not cover the flat ELL arrays "
            f"({ell_src.shape[0]} slots over {h.shape[0]} parts) — pass the "
            "owning plan's ell_buckets")
    k, _, f = h.shape
    table = _rows(h)
    w = ell_w.to(h.dtype)

    def contrib(src, wt):
        return table.index_select(0, src).mul_(wt[:, None])
    outs = [o.view(k, -1, f) for o in bucketed_slot_reduce(
        ell_src, w, buckets, contrib, k)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if tail_levels:
        tsum = spmm_local(tail_dst, tail_src, tail_w, table, table.shape[0],
                          tail_levels)
        out = out + tsum.view(k, -1, f)
    return out


def pspmm(h, halo, edge_dst, edge_src, edge_w, levels):
    """Aggregate with an already-exchanged halo: ``Â_local · [h; halo]``
    (port of ``pspmm``) over the stacked ``(k, B + R, f)`` table;
    ``ell_chain_layout(plan, 'edge')``'s ``edge_*``."""
    k, b, f = h.shape
    table = _rows(torch.cat([h, halo.to(h.dtype)], dim=1))
    return spmm_local(edge_dst, edge_src, edge_w, table, k * b,
                      levels).view(k, b, f)


def pspmm_exchange(h, recv_src, halo_src_flat, edge_dst, edge_src, edge_w,
                   levels):
    """``PSpMM`` over the combined ``[h; halo]`` edge list (port of
    ``pspmm_exchange``): the halo rows (``halo_exchange``, two packs),
    then ``pspmm``."""
    halo = halo_exchange(h, recv_src, halo_src_flat)
    return pspmm(h, halo, edge_dst, edge_src, edge_w, levels)


def _exchange(h, send_flat, mesh=None, halo_dtype=None, rr_sizes=None):
    """Issue one ELL aggregation's exchange: over the stacked parts the
    row pack of the receive layout (``exchange_recv``, or ``ring_concat``
    with ``rr_sizes``), complete at once; on a rank (``mesh``)
    ``rank_exchange``, in flight until ``wait()``.  Returns ``(recv,
    wait)``."""
    if mesh is not None:
        return rank_exchange(h, send_flat, mesh, halo_dtype, rr_sizes)
    if rr_sizes is None:
        return exchange_recv(h, send_flat, halo_dtype), _done
    return ring_concat(h, send_flat, rr_sizes, halo_dtype), _done


def _done():
    return None


def halo_exchange_ragged_multi(parts, ring_src, rhalo_dst, rr_sizes, r: int,
                               halo_dtype=None, mesh=None):
    """The ring exchange of several row tables at once (port of
    ``halo_exchange_ragged_multi``): the tables ride one ring concat
    side by side (one pack, the ``(ΣS_d, Σ d_i)``-lane buffer of every
    round, ``halo_dtype`` narrowing it), then each part's rows scatter into
    its ``(k, r, ...)`` halo table at ``rhalo_dst`` (each slot written
    once; pads name row ``r`` and are dropped, pad rows hold 0).  On a
    rank (``mesh``; ``ring_src`` / ``rhalo_dst`` its slice's) the concat
    is the rank's ring (``rank_exchange``), waited on at once.  Returns
    a tuple of halo tables in the parts' dtypes."""
    k = parts[0].shape[0]
    lanes = [p.shape[2] if p.dim() == 3 else 1 for p in parts]
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    wide = torch.cat([p.reshape(k, p.shape[1], ln).to(dt)
                      for p, ln in zip(parts, lanes)], dim=-1)
    recv, wait = _exchange(wide, ring_src, mesh, halo_dtype, rr_sizes)
    wait()
    live = bool(ragged_live_rounds(rr_sizes))
    dst = (rhalo_dst.long() + (torch.arange(k, device=recv.device)
                               * (r + 1))[:, None]).reshape(-1)
    halos, col = [], 0
    for p, ln in zip(parts, lanes):
        tab = p.new_zeros((k * (r + 1), ln))
        if live:
            tab.index_copy_(0, dst, recv[..., col: col + ln]
                            .reshape(-1, ln).to(p.dtype))
        halos.append(tab.view(k, r + 1, ln)[:, :r].reshape(
            (k, r) + tuple(p.shape[2:])))
        col += ln
    return tuple(halos)


def halo_exchange_ragged(h, ring_src, rhalo_dst, rr_sizes, r: int,
                         halo_dtype=None, mesh=None):
    """The ring's ``(k, r, f)`` halo table (port of
    ``halo_exchange_ragged``): the one-table form of
    ``halo_exchange_ragged_multi``."""
    (halo,) = halo_exchange_ragged_multi((h,), ring_src, rhalo_dst, rr_sizes,
                                         r, halo_dtype, mesh)
    return halo


def _halo_rows(table, pa, mesh=None):
    """The a2a's halo rows of one table: ``halo_exchange`` (two packs),
    or on a rank ``rank_halo_exchange`` (its send pack, the collective,
    the halo pack)."""
    if mesh is not None:
        return rank_halo_exchange(table, pa["recv_src"], pa["halo_src_flat"],
                                  mesh)
    return halo_exchange(table, pa["recv_src"], pa["halo_src_flat"])


def gat_exchange_table(table, pa, rr_sizes=None, r=None, mesh=None):
    """The halo block of one GAT table (port of the reference's
    ``_exchange_table``): on the a2a ``halo_exchange`` by the plan's
    ``recv_src`` / ``halo_src_flat`` (two packs), on the ring (``rr_sizes``
    given) ``halo_exchange_ragged`` by ``ring_src`` / ``rhalo_dst`` into
    ``(k, r, d)`` (one pack).  Every real halo row is the same copy of
    its owner's row on both transports, so the slot passes that read it
    do not depend on the transport (pad rows differ: no true edge reads
    one).  No arithmetic: the packed form's bit-paired words pass as
    they are, on a rank's wire too (``mesh``: ``rank_halo_exchange`` on
    the a2a, the rank's ring on the ring, by its slice's arrays)."""
    if rr_sizes is not None:
        return halo_exchange_ragged(table, pa["ring_src"], pa["rhalo_dst"],
                                    rr_sizes, r, mesh=mesh)
    return _halo_rows(table, pa, mesh)


def gat_exchange_rows_scalar(p, u, pa, rr_sizes=None, r=None, mesh=None):
    """Feature rows ``p`` ``(k, B, f)`` and a scalar a row ``u`` ``(k,
    B)`` exchanged without a ``(k, B, f + 1)`` table (port of the
    reference's ``_exchange_rows_scalar``): on the a2a the scalar rides
    its own pack (``halo_exchange`` twice, four packs; on a rank two
    ``rank_halo_exchange``), on the ring both ride one ring side by side
    (``halo_exchange_ragged_multi``, one pack).  Returns the ``[local;
    halo]`` pair ``((k, B + R, f), (k, B + R))``."""
    if rr_sizes is not None:
        halo_p, halo_u = halo_exchange_ragged_multi(
            (p, u), pa["ring_src"], pa["rhalo_dst"], rr_sizes, r, mesh=mesh)
    else:
        halo_p = _halo_rows(p, pa, mesh)
        halo_u = _halo_rows(u, pa, mesh)
    return torch.cat([p, halo_p], dim=1), torch.cat([u, halo_u], dim=1)


def _ragged_remote(x, recv, redge_dst, redge_src, redge_w, levels):
    """Σ_d of round d's halo edges over its received rows (port of
    ``_ragged_remote``): over the ring concat ``recv`` of ``x``'s rows,
    each round's ``redge_*`` levels folded into ``remote`` (``x``'s shape
    and dtype) after the rounds before."""
    k, b, f = x.shape
    remote = x.new_zeros((k * b, f))
    chain_add(remote, _rows(recv), redge_src, redge_dst, redge_w, levels)
    return remote.view(k, b, f)


def _ell_local(h, pa, buckets, levels):
    return spmm_ell(pa["ell_src"], pa["ell_w"], pa["ltail_dst"],
                    pa["ltail_src"], pa["ltail_w"], h, buckets,
                    levels["ltail"])


def _pspmm_ell_once(h, pa, buckets, levels, halo_dtype, mesh=None):
    """One symmetric a2a aggregation: the exchange issued, the ELL local
    pass (while a rank's collective is in flight: the reference's
    overlap, ``sgcn_tpu/ops/pspmm.py:365-374``), the wait, the halo
    edges' chains over the receive buffer, ``local + remote``."""
    k, b, f = h.shape
    recv, wait = _exchange(h, pa["recv_src"], mesh, halo_dtype)
    local = _ell_local(h, pa, buckets, levels)
    wait()
    remote = h.new_zeros((k * b, f))
    chain_add(remote, _rows(recv), pa["hedge_src"], pa["hedge_dst"],
              pa["hedge_w"], levels["hedge"])
    return local + remote.view(k, b, f)


def _pspmm_ragged_once(h, pa, buckets, levels, rr_sizes, halo_dtype,
                       mesh=None):
    """One symmetric ring aggregation: the ring issued, the ELL local
    pass, the wait, the rounds' fold (``_ragged_remote``), ``local +
    remote``."""
    recv, wait = _exchange(h, pa["ring_src"], mesh, halo_dtype, rr_sizes)
    local = _ell_local(h, pa, buckets, levels)
    wait()
    return local + _ragged_remote(h, recv, pa["redge_dst"], pa["redge_src"],
                                  pa["redge_w"], levels["redge"])


class PspmmEllSym(torch.autograd.Function):
    """``PSpMM`` for a SYMMETRIC Â on the a2a exchange (port of
    ``pspmm_ell_sym``): the exchange (``exchange_recv``, one pack), the
    ELL local pass, the halo edges' chains over the receive buffer, and
    ``local + remote``; the backward is the same form on ``g``
    (Âᵀg = Âg), its exchange on the same wire.  ``pa``: the
    ``ell_chain_layout(plan, 'a2a')`` tensors; ``levels`` their level
    sizes by family name.  ``mesh`` (a ``RankGroup``): one rank's part,
    ``pa`` its slice's tensors, the exchange ``rank_exchange`` overlapped
    with the local pass in both directions."""

    @staticmethod
    def forward(ctx, h, pa, buckets, levels, halo_dtype=None, mesh=None):
        ctx.args = (pa, buckets, levels, halo_dtype, mesh)
        return _pspmm_ell_once(h, pa, buckets, levels, halo_dtype, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_pspmm_ell_once(g.contiguous(), *ctx.args),
                None, None, None, None, None)


class PspmmRaggedSym(torch.autograd.Function):
    """``PSpMM`` over the ragged ring for a SYMMETRIC Â (port of
    ``pspmm_ragged_sym``): the ELL local pass and the round-by-round fold
    of the ring (``_ragged_remote``); the backward is the same form on
    ``g``.  ``pa``: ``ell_chain_layout(plan, 'ragged')``'s tensors;
    ``mesh``: one rank's part, its ring the rank's rounds at the plan's
    static ``rr_sizes``, overlapped with the local pass."""

    @staticmethod
    def forward(ctx, h, pa, buckets, levels, rr_sizes, halo_dtype=None,
                mesh=None):
        ctx.args = (pa, buckets, levels, rr_sizes, halo_dtype, mesh)
        return _pspmm_ragged_once(h, pa, buckets, levels, rr_sizes,
                                  halo_dtype, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_pspmm_ragged_once(g.contiguous(), *ctx.args),
                None, None, None, None, None, None)


class PspmmOverlap(torch.autograd.Function):
    """``PSpMM`` of any Â over the split edge lists (port of
    ``pspmm_overlap``): the exchange (one pack), the local-src chains
    over ``h`` and the halo-src chains over the receive buffer, ``local +
    remote``.  The backward is the transpose the reference takes from
    ``jax.vjp``, every scatter in the stored edge order: the local edges'
    transposed chains into ``dh``, the halo edges' into each part's
    reverse send buffer (its receive layout), the reverse exchange (one
    pack by ``rev_src``, narrowed to ``halo_dtype``), the owners' weight-1
    chains over what came back, and the two sums added.  ``pa``:
    ``ell_chain_layout(plan, 'directed')``'s tensors.  ``mesh``: one
    rank's part, the forward's exchange overlapped with the local chains,
    the backward's reverse exchange the reverse ``all_to_all_single``
    (``ell_transpose``)."""

    @staticmethod
    def forward(ctx, h, pa, levels, halo_dtype=None, mesh=None):
        ctx.args = (pa, levels, halo_dtype, mesh)
        k, b, f = h.shape
        recv, wait = _exchange(h, pa["recv_src"], mesh, halo_dtype)
        local = spmm_local(pa["ledge_dst"], pa["ledge_src"], pa["ledge_w"],
                           _rows(h), k * b, levels["ledge"])
        wait()
        remote = h.new_zeros((k * b, f))
        chain_add(remote, _rows(recv), pa["hedge_src"], pa["hedge_dst"],
                  pa["hedge_w"], levels["hedge"])
        return (local + remote).view(k, b, f)

    @staticmethod
    def backward(ctx, g):
        pa, levels, halo_dtype, mesh = ctx.args
        return (ell_transpose(g, pa, levels, "ledge_t", "hedge_t",
                              halo_dtype, mesh), None, None, None, None)


def ell_transpose(g, pa, levels, local: str, halo: str, halo_dtype=None,
                  mesh=None):
    """The transpose of an aggregation over split edge lists, every
    scatter in stored edge order (``PspmmOverlap``'s backward, and the
    GAT's ``'cell_t'`` one): the halo edges' transposed chains
    (``{halo}_*``) into each part's reverse send buffer (its receive
    layout), the reverse exchange (one pack by ``rev_src``, narrowed to
    ``halo_dtype``), the local edges' (``{local}_*``) into the owned
    rows, the owners' weight-1 chains over what came back, and the two
    sums added.  On a rank (``mesh``) the reverse exchange is
    ``rank_reverse_exchange`` (no pack: the collective is the
    transpose), in flight while the local chains run.  ``g`` ``(k, B,
    f)``; returns ``(k, B, f)`` in its dtype."""
    g = g.contiguous()
    k, b, f = g.shape
    gf = _rows(g)
    slots = pa["rev_src"].shape[1]
    send_rev = g.new_zeros((k, slots, f))
    chain_add(_rows(send_rev), gf, pa[f"{halo}_src"], pa[f"{halo}_dst"],
              pa[f"{halo}_w"], levels[halo])
    if mesh is None:
        rwire, wait = reverse_exchange(send_rev, pa["rev_src"], halo_dtype,
                                       g.dtype), _done
    else:
        rwire, wait = rank_reverse_exchange(send_rev, slots, mesh,
                                            halo_dtype, g.dtype)
    dh = spmm_local(pa[f"{local}_dst"], pa[f"{local}_src"],
                    pa[f"{local}_w"], gf, k * b, levels[local])
    wait()
    back = g.new_zeros((k * b, f))
    chain_add(back, _rows(rwire), pa["owner_src"], pa["owner_dst"],
              None, levels["owner"])
    return (dh + back).view(k, b, f)


def pspmm_ell_sym(h, pa, buckets, levels, halo_dtype=None, mesh=None):
    return PspmmEllSym.apply(h, pa, buckets, levels, halo_dtype, mesh)


def pspmm_ragged_sym(h, pa, buckets, levels, rr_sizes, halo_dtype=None,
                     mesh=None):
    return PspmmRaggedSym.apply(h, pa, buckets, levels, rr_sizes, halo_dtype,
                                mesh)


def pspmm_overlap(h, pa, levels, halo_dtype=None, mesh=None):
    return PspmmOverlap.apply(h, pa, levels, halo_dtype, mesh)


# ------------------------------------------------------ the selection
# plan arrays the ELL GCN forward ships (``ell_chain_layout``'s names): the
# symmetric a2a aggregation, the ring's and an asymmetric plan's
ELL_PLAN_FIELDS = ("recv_src", "ell_src", "ell_w", "ltail_dst", "ltail_src",
                   "ltail_w", "hedge_dst", "hedge_src", "hedge_w")
ELL_PLAN_FIELDS_RAGGED = ("ring_src", "ell_src", "ell_w", "ltail_dst",
                          "ltail_src", "ltail_w", "redge_dst", "redge_src",
                          "redge_w")
ELL_PLAN_FIELDS_GEN = ("recv_src", "ledge_dst", "ledge_src", "ledge_w",
                       "hedge_dst", "hedge_src", "hedge_w",
                       "ledge_t_dst", "ledge_t_src", "ledge_t_w",
                       "hedge_t_dst", "hedge_t_src", "hedge_t_w",
                       "owner_dst", "owner_src", "rev_src")
# ... and the GAT's slot passes (``ell_chain_layout(plan, 'cell')``): the
# a2a's, the ring's (``rhalo_dst`` scatters the ring into the halo table)
# and an asymmetric plan's (``'cell_t'``: the transposed chains, the
# reverse exchange)
ELL_GAT_PLAN_FIELDS = ("recv_src", "halo_src_flat", "cell_src", "cell_m",
                       "chub_dst", "chub_src", "chub_w", "row_valid")
ELL_GAT_PLAN_FIELDS_RAGGED = ("ring_src", "rhalo_dst", "cell_src", "cell_m",
                              "chub_dst", "chub_src", "chub_w", "row_valid")
ELL_GAT_PLAN_FIELDS_GEN = ELL_GAT_PLAN_FIELDS + (
    "cl_t_dst", "cl_t_src", "cl_t_w", "ch_t_dst", "ch_t_src", "ch_t_w",
    "owner_dst", "owner_src", "rev_src")

# what SGCN_PALLAS_SPMM=0 refuses, naming the ROADMAP entry it waits on
ELL_MODE_DEFERRAL = (
    "SGCN_PALLAS_SPMM=0 selects the ELL aggregator, which runs the exact "
    "full-batch step and the full-mode server only: the {mode} runs on "
    "the tile kernel (ROADMAP, 'Not carried': the ELL flavours of the "
    "stale, replica, mini-batch and sub-graph modes) — unset "
    "SGCN_PALLAS_SPMM (or set 'auto')")

# why the reference's ``auto`` is not carried: it means "the Pallas
# kernel only on a TPU" (``sgcn_tpu/ops/pallas_spmm.py:304-325``)
ELL_SELECTION_RULE = (
    "SGCN_PALLAS_SPMM unset, 'auto' or '1': every class runs the tile "
    "kernel (the reference's 'auto' picks Pallas only on a TPU whose "
    "per-chip tables fit 4 MiB of VMEM, a rule with no meaning on the "
    "card); '0': the ELL aggregator")


def ell_selected() -> bool:
    """The reference's switch: ``SGCN_PALLAS_SPMM=0`` selects the ELL
    aggregator, anything else (unset, ``auto``, ``1``) the tile kernel."""
    return os.environ.get("SGCN_PALLAS_SPMM", "auto") == "0"


def choose_ell_dispatch(plan, schedule: str = "a2a",
                        decision: dict | None = None,
                        model: str = "gcn") -> dict:
    """Build the plan's ELL chain layout for ``schedule`` and ``model``
    and return the forward's static kwargs: ``aggregator='ell'``, the
    buckets, every chain family's level sizes (``ell_levels``) and, on
    the ring, its round sizes.  The GCN's layout is the schedule's
    (``'a2a'``, ``'ragged'``; an asymmetric plan ``'directed'``); the
    GAT's is ``'cell'`` on either transport (``'cell_t'`` on an
    asymmetric plan), its buckets ``cell_buckets``, plus the halo table's
    height ``halo_r``.  Logs the choice in ``decision['aggregator']``."""
    if schedule not in ("a2a", "ragged"):
        raise ValueError(f"unknown comm schedule {schedule!r} (resolve "
                         "'auto' first: parallel/plan.py::"
                         "resolve_comm_schedule)")
    if model == "gat":
        layout = "cell" if plan.symmetric else "cell_t"
        if schedule == "ragged":
            plan.ensure_ragged()
    else:
        layout = schedule if plan.symmetric else "directed"
    plan.ensure_ell_chains(layout)
    chains = plan.ell_chains[layout]
    out = {"aggregator": "ell", "ell_layout": layout,
           "ell_buckets": (plan.cell_buckets if model == "gat"
                           else plan.ell_buckets),
           "ell_levels": {name[: -len("_levels")]: sizes
                          for name, sizes in chains.items()
                          if name.endswith("_levels")}}
    if model == "gat":
        out["halo_r"] = int(plan.r)
    if not plan.symmetric:
        out["symmetric"] = False
    if schedule == "ragged":
        out.update(comm_schedule="ragged", rr_sizes=plan.rr_sizes)
    if decision is not None:
        decision["aggregator"] = {
            "chosen": "ell", "layout": layout,
            "env": os.environ.get("SGCN_PALLAS_SPMM"),
            "rule": ELL_SELECTION_RULE,
            "levels": {k: len(v) for k, v in out["ell_levels"].items()}}
    return out


def ell_plan_fields(layout: str, schedule: str = "a2a") -> tuple:
    """The shipped arrays of an ELL layout (``choose_ell_dispatch``'s
    ``ell_layout``) on ``schedule``'s transport."""
    if layout == "cell":
        return (ELL_GAT_PLAN_FIELDS_RAGGED if schedule == "ragged"
                else ELL_GAT_PLAN_FIELDS)
    return {"a2a": ELL_PLAN_FIELDS, "ragged": ELL_PLAN_FIELDS_RAGGED,
            "directed": ELL_PLAN_FIELDS_GEN,
            "cell_t": ELL_GAT_PLAN_FIELDS_GEN}[layout]


def ell_aggregate(x, pa, static, halo_dtype=None, mesh=None):
    """One ELL aggregation of the forward's static kwargs ``static``
    (``choose_ell_dispatch``): ``PspmmEllSym`` on the a2a, ``PspmmRaggedSym``
    on the ring, ``PspmmOverlap`` on an asymmetric plan; ``mesh``: one
    rank's part (``pa`` its slice's tensors)."""
    levels = static["ell_levels"]
    if static["ell_layout"] == "directed":
        return pspmm_overlap(x, pa, levels, halo_dtype, mesh)
    if static["ell_layout"] == "ragged":
        return pspmm_ragged_sym(x, pa, static["ell_buckets"], levels,
                                static["rr_sizes"], halo_dtype, mesh)
    return pspmm_ell_sym(x, pa, static["ell_buckets"], levels, halo_dtype,
                         mesh)
