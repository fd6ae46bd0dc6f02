"""Destination-tiled SpMM — the port of ``sgcn_tpu/ops/pallas_spmm.py``.

The reference's one TPU kernel, ``spmm_pallas``, becomes a CUDA kernel for
Hopper (``csrc/tile_spmm.cu``, built by ``ops/_build.py``).  This module
holds, in the reference's order:

  * the numpy tile builders ``tile_classes_from_buckets`` and
    ``build_dst_tile_classes`` (copied; the plan's tile layout rests on
    them);
  * ``spmm_tiles_classes`` — the degree-binned SpMM over a tile family's
    flat class arrays (counterpart of ``spmm_pallas_classes``): on CUDA
    tensors ONE kernel launch for all the family's classes, on CPU
    tensors ``spmm_tiles_classes_plain``, its plain PyTorch version
    (``spmm_tiles_plain`` per class).  A CUDA tensor launches the kernel
    or raises.  ``spmm_tiles`` (the
    counterpart of ``spmm_pallas``) is its one-class case, and
    ``spmm_tiles.launches`` counts kernel launches, one per family pass;
    ``pack_class_table`` packs the launch's class structure and
    ``check_tile_layout`` checks the kernel's premise on a layout (each
    tile's local destinations do not decrease along its slots);
  * ``choose_tile_dispatch`` — the per-class table, logged the way
    ``choose_pallas_dispatch`` logs it;
  * ``spmm_tiles_fused`` — one GCN aggregation's tile work in one launch
    of the kernel's fused entry point: the local family over ``h``, the
    halo family over the exchange's receive buffer (or the ring concat)
    read in place, ``local + remote`` rounded once to ``h``'s dtype for
    the owned rows; ``spmm_tiles_fused_plain`` is its plain version (the
    two plain family passes, the slices, the add and the cast);
  * ``pspmm_tiles_sym`` — ``pspmm_pallas_sym`` (K3) with its custom VJP as
    the ``torch.autograd.Function`` ``PspmmTilesSym``: the exchange's
    receive buffer (one row pack, ``ops/pspmm.py::exchange_recv``), then
    the fused launch; the backward is the same op on the gradient (Â is
    symmetric);
  * ``pspmm_tiles_gen`` — the same forward on an asymmetric Â (the
    reference's ``pspmm_overlap``, whose backward is XLA's transpose) as
    ``PspmmTilesGen``: its backward runs Âᵀ as tile SpMMs over the plan's
    transposed layouts — one family launch of the halo rows' Âᵀ into each
    part's reverse send buffer, the reverse exchange (one row pack), then
    one fused launch of the local rows' Âᵀ over the gradient and the
    weight-1 owner sum over what came back: no scatter-add, no float
    atomics;
  * ``pspmm_tiles_ragged`` — ``pspmm_pallas_ragged`` (K4) with its custom
    VJP as ``PspmmTilesRagged``: the same op on the ragged ring, the
    fused launch over the local table and the ring's receive concat
    (``ops/pspmm.py::ring_concat``, one row pack) through the
    ring-re-based halo tiles; bit-identical to ``pspmm_tiles_sym`` (same
    tiles, same edge order);
  * ``pspmm_tiles_stale`` / ``pspmm_tiles_stale_ragged`` — the
    reference's ``pspmm_stale`` / ``pspmm_stale_ragged`` (the pipelined
    trainer's one-step-stale aggregation, whose reference runs no Pallas
    kernel) as ``PspmmTilesStale``, on the same pack and fused launch: the
    exchange goes into a carry in the receive layout, the fused launch
    reads the previous step's carry;
  * ``pspmm_tiles_replica`` — the reference's ``pspmm_replica``,
    ``pspmm_replica_ragged`` and ``pspmm_replica_partial`` (hot-halo
    replicas, whose reference runs no Pallas kernel) as
    ``PspmmTilesReplica``: the carry is the receive layout, a replica
    step packs only the kept slots into it (``ops/pspmm.py::
    replica_pack``), then the fused launch reads it; the backward mirrors
    it on the gradient carry.  A sync step refills the carry with the
    exact exchange: ``pspmm_tiles_stale`` with ``fresh``.  The
    composed replica × stale steps (``pspmm_replica_stale[_ragged]``) are
    ``pspmm_tiles_stale`` with the kept lists: the fused launch reads the
    previous carry, then the kept pack turns it into the next;
  * ``pspmm_tiles_ranks`` — the same GCN aggregation with one process per
    part (``PspmmTilesRanks``, ROADMAP A2b): the send pack and the
    asynchronous collective (``ops/pspmm.py::rank_exchange``), the local
    family launch while the exchange is in flight, then the halo family
    over the received buffer and one float32 add: the fused entry's
    arithmetic in two launches.  The carried modes take a ``mesh`` too
    (ROADMAP A2c): a stale step issues its exchange and leaves it in
    flight (``ops/pspmm.py::InFlight``) while ONE fused launch reads the
    previous step's carry (``PspmmTilesStaleRanks``); a replica step
    issues the shrunken exchange, runs the local family, waits, packs the
    received rows into the carry (``row_pack_into``) and runs the halo
    family over it (``PspmmTilesReplicaRanks``).  An asymmetric Â on a
    rank is ``pspmm_tiles_gen_ranks`` (``PspmmTilesGenRanks``): the same
    forward, and a backward of three K1 family launches — the halo-ᵀ
    family into the reverse send buffer, the reverse ``all_to_all_single``
    issued, the local-ᵀ family while it is in flight, then the weight-1
    owner sum over what came back (``transposed_ranks``);
  * ``gat_tiles_pass`` — ``gat_pallas_pass`` (K5): the GAT attention pass,
    the kernel over the combined-edge tiles with int8 0/1 mask weights.
    An int8 ``tw`` launches the kernel's int8 entry point, counted in
    ``spmm_tiles.mask_launches``.

Tables are float32 or bfloat16, as ``spmm_pallas`` keeps its table in its
own dtype and upcasts each row as it reads it; the output is float32
either way.  A bf16 table launches the kernel's bf16 entry points, counted
apart in ``spmm_tiles.bf16_launches`` and ``spmm_tiles.bf16_mask_launches``
(``k5_launches`` sums the mask launches over both tables).
``_pspmm_tiles_once`` and its ragged flavor take the reference's
``halo_dtype`` (the wire only: the fused launch reads the bf16 receive
buffer through a bf16 remote table) and return ``(local + remote)``
rounded once to the table's dtype, as ``_pspmm_pallas_once`` does.

Every function takes the ``k`` parts stacked on a leading axis
(``(k, ...)`` tile arrays and tables); the single-part 2-D forms are
accepted by ``spmm_tiles``/``spmm_tiles_classes`` too.

Two selection rules of the reference are TPU numbers and are NOT carried:
the VMEM-fit rule (``pallas_spmm_fits``/``use_pallas_spmm``, 4 MiB) — the
CUDA kernel reads its table from HBM through L2 and has no residency
limit — and the hub cap ``pallas_emax_cap`` (8192).  On CUDA every class
runs the kernel; an H100 class rule is a ROADMAP item.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import census
from ..utils.backend import plain_region
from .pspmm import (InFlight, chain, exchange_recv, partial_refresh,
                    partial_refresh_grad, rank_exchange,
                    rank_partial_refresh, rank_partial_refresh_grad,
                    rank_replica_exchange, rank_reverse_exchange,
                    rank_stale_exchange, replica_pack,
                    reverse_exchange, ring_concat, settle, stale_exchange,
                    stale_ring_exchange)


# ----------------------------------------------------------- tile builders
def tile_classes_from_buckets(buckets, num_rows: int, tb: int) -> tuple:
    """Per-class TILE counts, classes aligned to the degree-bucket
    histogram's row boundaries (rounded up to tile multiples).  Always
    covers all ``ceil(num_rows/tb)`` tiles."""
    t = max(1, -(-num_rows // tb))
    cuts = {t}
    cum = 0
    for nb, _wb in (buckets or ()):
        cum += int(nb)
        cuts.add(min(t, -(-cum // tb)))
    bounds = sorted(c for c in cuts if 0 < c <= t)
    out, prev = [], 0
    for c in bounds:
        if c > prev:
            out.append(c - prev)
            prev = c
    if prev < t:
        out.append(t - prev)
    return tuple(out)


def build_dst_tile_classes(edge_dst, edge_src, edge_w, num_rows: int,
                           tb: int, class_tiles) -> list:
    """Group dst-sorted edges into tiles of ``tb`` rows, binned into the
    given tile classes; per class, tiles pad to that class's own edge max
    (at least 8, a multiple of 8).

    Returns a list over classes of ``(tsrc, tld, tw)`` — each
    ``(T_c, Emax_c)``, pad edges carrying weight 0 and local dst tb−1.
    """
    edge_dst = np.asarray(edge_dst)
    edge_src = np.asarray(edge_src)
    edge_w = np.asarray(edge_w)
    t = int(sum(class_tiles))
    tile_of = edge_dst // tb
    counts = np.bincount(tile_of, minlength=t)
    starts = np.zeros(t + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # position of each edge within its tile (edges are dst-sorted, so each
    # tile's run is contiguous)
    pos = np.arange(edge_dst.shape[0], dtype=np.int64) - starts[tile_of]
    out = []
    t0 = 0
    for tc in class_tiles:
        emax = max(8, int(counts[t0: t0 + tc].max()) if tc else 8)
        emax = -(-emax // 8) * 8
        tsrc = np.zeros((tc, emax), np.int32)
        tw = np.zeros((tc, emax), np.float32)
        tld = np.full((tc, emax), tb - 1, np.int32)
        sel = slice(int(starts[t0]), int(starts[t0 + tc]))
        ti = tile_of[sel] - t0
        pj = pos[sel]
        tsrc[ti, pj] = edge_src[sel]
        tw[ti, pj] = edge_w[sel]
        tld[ti, pj] = edge_dst[sel] - (ti + t0) * tb
        out.append((tsrc, tld, tw))
        t0 += tc
    return out


def stack_tile_family(dsts, srcs, ws, num_rows: int, tb: int, class_tiles,
                      src_fill: int = 0):
    """One edge family's tiles over stacked parts: per part
    ``build_dst_tile_classes`` on its dst-sorted ``(dst, src, w)`` list,
    then per class every part's tiles padded to that class's largest
    ``Emax`` (pads: local dst ``tb-1``, weight 0) and laid out flat, class
    after class.  ``src_fill`` given, every weight-0 slot reads that row
    (sub-graph serving points them at its all-zero dump row).  Returns
    ``(src, ld, w, classes)``: ``(k, ΣT_c·Emax_c)`` int32 / int32 /
    float32 and ``((T_c, Emax_c), ...)``.  Raises if a tile's local
    destinations decrease along its slots (``check_tile_layout``)."""
    per = [build_dst_tile_classes(d, s, w, num_rows, tb, class_tiles)
           for d, s, w in zip(dsts, srcs, ws)]
    fills = (0, tb - 1, 0.0)
    dtypes = (np.int32, np.int32, np.float32)
    flats: list[list] = [[], [], []]
    classes = []
    for c, tc in enumerate(class_tiles):
        emax = max(x[c][0].shape[1] for x in per)
        classes.append((int(tc), int(emax)))
        for i in range(3):
            flats[i].append(np.stack([
                np.pad(x[c][i], ((0, 0), (0, emax - x[c][i].shape[1])),
                       constant_values=fills[i]).astype(dtypes[i])
                .reshape(-1) for x in per]))
    src, ld, w = (np.concatenate(f, axis=1) for f in flats)
    if src_fill:
        src[w == 0] = src_fill
    check_tile_layout(ld, classes, tb)
    return src, ld, w, tuple(classes)


# ------------------------------------------------------------- the kernel
def spmm_tiles_plain(tsrc, tld, tw, table, tb: int = 256):
    """Plain PyTorch version of the tile SpMM: a literal loop over the
    ``Emax`` edge slots, vectorized across tiles and parts.  At slot ``e``
    every tile adds ``tw[e] * table[tsrc[e]]`` into its row ``tld[e]``;
    one row per tile per step, so no two updates collide and each row's
    additions happen in stored edge order, multiply and add rounded
    separately — the kernel's arithmetic, on any device.

    ``tsrc``/``tld``: int32 ``(k, T, Emax)`` (or ``(T, Emax)``); ``tw``
    float32, or int8 0/1 masks (upcast here), same shape; ``table``:
    ``(k, N, f)`` (or ``(N, f)``), float32 or bfloat16 — a bf16 table is
    upcast to float32 here, exactly, before any product, as the kernel
    widens each value it loads.  Returns ``(k, T·tb, f)`` (or
    ``(T·tb, f)``) float32 — float64 for a float64 table, which autograd
    can differentiate (the float64 gradient checks of the GAT layer).
    """
    single = tsrc.dim() == 2
    if single:
        tsrc, tld, tw, table = (x.unsqueeze(0) for x in (tsrc, tld, tw, table))
    k, t, emax = tsrc.shape
    n, f = table.shape[1], table.shape[2]
    src = tsrc.to(torch.int64)
    ld = tld.to(torch.int64)
    if src.numel() and (int(src.min()) < 0 or int(src.max()) >= n
                        or int(ld.min()) < 0 or int(ld.max()) >= tb):
        raise IndexError(f"tile indices out of range (table rows {n}, "
                         f"tile height {tb})")
    dev = table.device
    dt = torch.float64 if table.dtype == torch.float64 else torch.float32
    flat_table = table.reshape(k * n, f).to(dt)
    src = (src + (torch.arange(k, device=dev) * n).view(k, 1, 1)) \
        .reshape(k * t, emax)
    ld = (ld + (torch.arange(k * t, device=dev) * tb).view(k, t, 1)) \
        .reshape(k * t, emax)
    w = tw.to(dt).reshape(k * t, emax)
    acc = torch.zeros(k * t * tb, f, dtype=dt, device=dev)
    for e in range(emax):
        rows = ld[:, e]
        acc[rows] = acc[rows] + w[:, e, None] * flat_table[src[:, e]]
    out = acc.view(k, t * tb, f)
    return out[0] if single else out


# classes one family launch takes (``kMaxClasses`` of csrc/tile_spmm.cu)
MAX_CLASSES = 32


def pack_class_table(classes, slots: int | None = None):
    """The static class structure of one family launch: for class c of
    ``classes`` (``((t_c, emax_c[, kernel]), ...)``) its first tile, its
    first slot within a part, and its ``emax``.  Returns
    ``(first_tile, slot_off, emax)``: int32 ``(n+1,)``, int64 ``(n,)``,
    int32 ``(n,)``.  Raises for more than ``MAX_CLASSES`` classes, an
    empty class, or (given ``slots``, the flat arrays' per-part length)
    classes that do not cover the flat layout exactly."""
    n = len(classes)
    if not 1 <= n <= MAX_CLASSES:
        raise ValueError(f"{n} tile classes; one launch takes 1 to "
                         f"{MAX_CLASSES}")
    first = np.zeros(n + 1, np.int32)
    off = np.zeros(n, np.int64)
    emax = np.zeros(n, np.int32)
    total = 0
    for c, (t, e, *_) in enumerate(classes):
        if int(t) < 1 or int(e) < 1:
            raise ValueError(f"tile class {c} is ({t}, {e}): every class "
                             "needs at least one tile of at least one slot")
        first[c + 1] = first[c] + int(t)
        off[c] = total
        emax[c] = int(e)
        total += int(t) * int(e)
    if slots is not None and total != slots:
        raise ValueError(f"the tile classes cover {total} slots per part, "
                         f"the flat arrays hold {slots}")
    return first, off, emax


def check_tile_layout(flat_ld, classes, tb: int) -> None:
    """Raise unless every tile of the flat ``(k, ΣT_c·Emax_c)`` local
    destinations (or one part's 1-D form) lies in ``[0, tb)`` and does not
    decrease along its slots — the CUDA kernel's premise: it finds row
    r's slots as ``[lower_bound(r), lower_bound(r+1))`` of its tile.
    Tiles cut from dst-sorted edge lists meet it (pads, at ``tb-1``,
    last); the plan checks every layout it builds."""
    ld = np.asarray(flat_ld)
    ld = ld.reshape(-1, ld.shape[-1])
    _first, offs, _emax = pack_class_table(classes, ld.shape[1])
    for c, ((t, e, *_), off) in enumerate(zip(classes, offs)):
        blk = ld[:, off: off + t * e].reshape(ld.shape[0], t, e)
        if blk.min() < 0 or blk.max() >= tb:
            raise ValueError(f"tile class {c}: local destinations outside "
                             f"[0, {tb})")
        down = np.argwhere(np.diff(blk, axis=-1) < 0)
        if len(down):
            p, i, j = down[0]
            raise ValueError(
                f"tile class {c}, part {p}, tile {i}: local destination "
                f"decreases at slot {j + 1} ({blk[p, i, j]} -> "
                f"{blk[p, i, j + 1]}); the kernel needs each tile's slots "
                "in destination order")


def vector_width(f: int, ptr: int, part_stride: int, itemsize: int = 4) -> int:
    """Columns per lane load the kernel uses on a table of ``itemsize``-byte
    values: 4 (one load of ``4 * itemsize`` bytes: a float4, or 4 × bf16)
    when rows are whole 4-column vectors — ``f % 4 == 0``, a base aligned
    to ``4 * itemsize`` bytes and a part stride of whole vectors — and wide
    enough (``f >= 32``) to fill a group of 8 lanes; else 1."""
    return 4 if (f % 4 == 0 and f >= 32 and ptr % (4 * itemsize) == 0
                 and part_stride % 4 == 0) else 1


# the kernel's entry points by (weights are masks, table dtype), and the
# spmm_tiles counter each one's launches go to
_ENTRIES = {
    (False, torch.float32): ("sgcn_tile_spmm_family_f32", "launches"),
    (True, torch.float32): ("sgcn_tile_spmm_family_mask_f32",
                            "mask_launches"),
    (False, torch.bfloat16): ("sgcn_tile_spmm_family_bf16", "bf16_launches"),
    (True, torch.bfloat16): ("sgcn_tile_spmm_family_mask_bf16",
                             "bf16_mask_launches"),
}


# the fused entry points by (h's dtype, the remote table's dtype), and the
# spmm_tiles_fused counter each one's launches go to
_FUSED_ENTRIES = {
    (torch.float32, torch.float32): ("sgcn_tile_spmm_fused_f32",
                                     "launches"),
    (torch.float32, torch.bfloat16): ("sgcn_tile_spmm_fused_f32_bf16wire",
                                      "wire_bf16_launches"),
    (torch.bfloat16, torch.bfloat16): ("sgcn_tile_spmm_fused_bf16",
                                       "bf16_launches"),
}


def _lib():
    from . import _build

    lib = _build.load("tile_spmm")
    if not getattr(lib, "_sgcn_typed", False):
        for name, _counter in _ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for name, _counter in _FUSED_ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.sgcn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgcn_cuda_error_string.restype = ctypes.c_char_p
        lib._sgcn_typed = True
    return lib


def _launch_family(flat_src, flat_ld, flat_w, table, classes, tb: int):
    """One kernel launch over a whole tile family on CUDA tensors:
    ``flat_*`` ``(k, ΣT_c·Emax_c)`` (each part's slots contiguous, one
    common part stride), ``table`` ``(k, N, f)`` float32 or bfloat16,
    row-major per part.  Returns ``(k, ΣT_c·tb, f)`` float32."""
    if not all(x.device == table.device for x in (flat_src, flat_ld, flat_w)):
        raise ValueError("tile arrays and table must be on the same device")
    if flat_src.dtype != torch.int32 or flat_ld.dtype != torch.int32:
        raise TypeError("tsrc/tld must be int32 (the plan's stored form)")
    if flat_w.dtype not in (torch.float32, torch.int8):
        raise TypeError("tw must be float32 (Â's values) or int8 (0/1 "
                        "edge masks)")
    if flat_src.dim() != 2 or flat_src.shape != flat_ld.shape \
            or flat_src.shape != flat_w.shape:
        raise ValueError(f"tile arrays must share one (k, slots) shape, got "
                         f"{tuple(flat_src.shape)}, {tuple(flat_ld.shape)}, "
                         f"{tuple(flat_w.shape)}")
    k, slots = flat_src.shape
    for x in (flat_src, flat_ld, flat_w):
        if (slots > 1 and x.stride(1) != 1) or (
                k > 1 and x.stride(0) != flat_src.stride(0)):
            raise ValueError("tile arrays must be row-major (T, Emax) per "
                             "part with one common part stride")
    if table.dim() != 3 or table.shape[0] != k:
        raise ValueError(f"table must be (k={k}, N, f), got "
                         f"{tuple(table.shape)}")
    if not 1 <= tb <= 256:
        raise ValueError(f"tile height tb={tb} outside the kernel's [1, 256]")
    n, f = table.shape[1], table.shape[2]
    if table.stride(2) != 1 or table.stride(1) != f:
        raise ValueError("table must be row-major (N, f) per part")
    if n == 0 or f == 0:
        raise ValueError(f"empty tile SpMM table {tuple(table.shape)}")
    first, offs, emax = pack_class_table(classes, slots)
    out = torch.empty((k, int(first[-1]) * tb, f), dtype=torch.float32,
                      device=table.device)
    lib = _lib()
    name, counter = _ENTRIES[(flat_w.dtype == torch.int8, table.dtype)]
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    rc = getattr(lib, name)(
        flat_src.data_ptr(), flat_ld.data_ptr(), flat_w.data_ptr(),
        table.data_ptr(), out.data_ptr(), k, len(classes),
        first.ctypes.data, emax.ctypes.data, offs.ctypes.data, tb, n, f,
        vector_width(f, table.data_ptr(), table.stride(0),
                     table.element_size()),
        flat_src.stride(0), table.stride(0), out.stride(0), dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"tile_spmm launch failed: "
            f"{lib.sgcn_cuda_error_string(rc).decode()} (cudaError {rc})")
    setattr(spmm_tiles, counter, getattr(spmm_tiles, counter) + 1)
    return out


# the census label of each family entry point (``utils/census.py``)
_FAMILY_LABELS = {(False, torch.float32): "K1", (True, torch.float32): "K5",
                  (False, torch.bfloat16): "K1-bf16",
                  (True, torch.bfloat16): "K5-bf16"}
_FUSED_LABELS = {(torch.float32, torch.float32): "fused",
                 (torch.float32, torch.bfloat16): "fused-wire-bf16",
                 (torch.bfloat16, torch.bfloat16): "fused-bf16"}


def _census_family(w, table, rows: int, single: bool) -> None:
    """The census hook of one family launch (K1/K5 by ``w``'s dtype, the
    bf16 flavour on a bf16 table): its ``(k, rows, f)`` float32 output
    (``(rows, f)`` for one part).  A table dtype no entry point takes
    (the CPU's float64) is an unknown launch to the census."""
    key = (w.dtype == torch.int8, table.dtype)
    lead = () if single else (table.shape[0],)
    census.launch(_FAMILY_LABELS.get(key, f"family{key}"),
                  (*lead, rows, table.shape[-1]), table.dtype, table.device)


def _on_cpu(table, *arrays):
    """True for CPU tensors (the plain version); raises for a table dtype
    or device the port does not take."""
    cpu = table.device.type == "cpu" and all(
        x.device.type == "cpu" for x in arrays)
    if table.dtype not in (torch.float32, torch.bfloat16) and not (
            cpu and table.dtype == torch.float64):
        raise TypeError(f"tile SpMM tables are float32 or bfloat16 (got "
                        f"{table.dtype})")
    if not cpu and table.device.type != "cuda":
        raise ValueError(f"tile SpMM runs on cpu or cuda tensors, got "
                         f"{table.device}")
    return cpu


def spmm_tiles(tsrc, tld, tw, table, tb: int = 256):
    """Â·table over dst tiles — the counterpart of ``spmm_pallas``: the
    one-class case of ``spmm_tiles_classes``.

    Args:
      tsrc/tld/tw: ``(k, T, Emax)`` tile arrays (``(T, Emax)`` for one
        part): int32 source row, int32 local destination row in
        ``[0, tb)``, not decreasing along a tile's slots, and the weight:
        float32 (Â's values) or int8 (the GAT passes' 0/1 edge masks);
        pads carry weight 0 and dst ``tb-1``.
      table: ``(k, N, f)`` float32 or bfloat16 feature rows (``(N, f)``
        for one part); the plain version also takes float64, on the CPU
        only.

    Returns ``(k, T·tb, f)`` float32 (``(T·tb, f)`` for one part); slice to
    the true row count.  On CPU tensors this is ``spmm_tiles_plain``; on
    CUDA tensors it launches the CUDA kernel on the current stream (no
    synchronize) — the float32-weight entry point, counted in
    ``spmm_tiles.launches``, or for an int8 ``tw`` the mask entry point,
    counted in ``spmm_tiles.mask_launches``; on a bfloat16 table their
    bf16 flavors, counted in ``spmm_tiles.bf16_launches`` and
    ``spmm_tiles.bf16_mask_launches``.  Any other device, dtype or layout
    raises (a float16 table among them).
    """
    cpu = _on_cpu(table, tsrc, tld, tw)
    if census.active():
        _census_family(tw, table, tsrc.shape[-2] * tb, tsrc.dim() == 2)
    if cpu:
        with plain_region("tile_spmm_kernel"):
            return spmm_tiles_plain(tsrc, tld, tw, table, tb)
    single = tsrc.dim() == 2
    if single:
        tsrc, tld, tw, table = (x.unsqueeze(0) for x in (tsrc, tld, tw, table))
    if tsrc.dim() != 3 or tsrc.shape != tld.shape or tsrc.shape != tw.shape:
        raise ValueError(f"tile arrays must share one (k, T, Emax) shape, "
                         f"got {tuple(tsrc.shape)}, {tuple(tld.shape)}, "
                         f"{tuple(tw.shape)}")
    k, t, emax = tsrc.shape
    if t == 0:
        raise ValueError("empty tile SpMM: 0 tiles")
    flat = []
    for x in (tsrc, tld, tw):
        if x.stride(2) != 1 or x.stride(1) != emax:
            raise ValueError("tile arrays must be row-major (T, Emax) per "
                             "part with one common part stride")
        flat.append(x.as_strided((k, t * emax), (x.stride(0), 1)))
    out = _launch_family(*flat, table, ((t, emax),), tb)
    return out[0] if single else out


spmm_tiles.launches = 0              # float32-weight entry (K1)
spmm_tiles.mask_launches = 0         # int8 0/1-mask entry (K5)
spmm_tiles.bf16_launches = 0         # ... each on a bfloat16 table
spmm_tiles.bf16_mask_launches = 0


def k5_launches() -> int:
    """Int8-mask launches (K5) on either table dtype."""
    return spmm_tiles.mask_launches + spmm_tiles.bf16_mask_launches


def spmm_tiles_classes(flat_src, flat_ld, flat_w, table, classes, tb: int):
    """Degree-binned SpMM over the flat tile-class arrays — the
    counterpart of ``spmm_pallas_classes``.  ``classes`` is
    ``((t_c, emax_c[, kernel]), ...)``: class c owns the next
    ``t_c·emax_c`` flat slots of every part.  On CUDA tensors the whole
    family is ONE kernel launch writing the ``(k, Σ t_c·tb, f)`` output
    directly; on CPU tensors ``spmm_tiles_classes_plain``.  Returns
    ``(k, Σ t_c·tb, f)`` float32 (no leading k for 1-D inputs)."""
    cpu = _on_cpu(table, flat_src, flat_ld, flat_w)
    if census.active():
        _census_family(flat_w, table, sum(c[0] for c in classes) * tb,
                       flat_src.dim() == 1)
    if not cpu:
        if flat_src.dim() == 1:
            return _launch_family(
                *(x.unsqueeze(0) for x in (flat_src, flat_ld, flat_w)),
                table.unsqueeze(0), classes, tb)[0]
        return _launch_family(flat_src, flat_ld, flat_w, table, classes, tb)
    with plain_region("tile_spmm_kernel"):
        return spmm_tiles_classes_plain(flat_src, flat_ld, flat_w, table,
                                        classes, tb)


def spmm_tiles_classes_plain(flat_src, flat_ld, flat_w, table, classes,
                             tb: int):
    """Plain PyTorch version of ``spmm_tiles_classes`` on any device: each
    class, viewed as its own ``(k, t_c, emax_c)`` pad, through
    ``spmm_tiles_plain``, the outputs concatenated along the rows."""
    _first, offs, _emax = pack_class_table(classes, flat_src.shape[-1])
    outs = []
    for (tc, ec, *_), off in zip(classes, offs):
        sl = slice(int(off), int(off) + tc * ec)
        shape = flat_src.shape[:-1] + (tc, ec)
        outs.append(spmm_tiles_plain(flat_src[..., sl].reshape(shape),
                                     flat_ld[..., sl].reshape(shape),
                                     flat_w[..., sl].reshape(shape), table,
                                     tb))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


def spmm_tiles_fused_plain(ltiles, h, htiles, remote, lclasses, hclasses,
                           tb: int):
    """Plain PyTorch version of the fused aggregation, torch arithmetic on
    any device (it launches no kernel): the plain tile SpMM over each
    family, sliced to the ``b`` owned rows, summed in float32 and rounded
    once to ``h``'s dtype (``pallas_spmm.py:428``)."""
    b = h.shape[1]
    local = spmm_tiles_classes_plain(*ltiles, h, lclasses, tb)[:, :b]
    rem = spmm_tiles_classes_plain(*htiles, remote, hclasses, tb)[:, :b]
    return (local + rem).to(h.dtype)


def spmm_tiles_fused(ltiles, h, htiles, remote, lclasses, hclasses,
                     tb: int):
    """``local + remote`` of one GCN aggregation in one kernel launch: the
    local family ``ltiles = (src, ld, w)`` (flat ``(k, Σ T_c·Emax_c)``)
    over ``h`` and the halo family ``htiles`` over ``remote`` (the a2a
    receive buffer or the ring concat, read in place), each row's two
    chains exactly as ``spmm_tiles_classes`` runs them, summed in float32
    and stored once in ``h``'s dtype — the tile work of
    ``_pspmm_pallas_once``.

    Args:
      ltiles/htiles: the two families' flat int32/int32/float32 arrays;
        their classes (``lclasses``/``hclasses``) must have the same tile
        counts (the plan builds both on one ``class_tiles``).
      h: ``(k, b, f)`` float32 or bfloat16, the local table; its ``b``
        rows are the owned rows of the output.
      remote: ``(k, N, f)`` in ``h``'s dtype, or bfloat16 under a float32
        ``h`` (the ``halo_dtype`` wire).

    Returns ``(k, b, f)`` in ``h``'s dtype.  On CPU tensors this is
    ``spmm_tiles_fused_plain``; on CUDA tensors it launches the kernel's
    fused entry point on the current stream (no synchronize), counted in
    ``spmm_tiles_fused.launches`` (float32 ``h`` and ``remote``),
    ``.wire_bf16_launches`` (float32 ``h``, bf16 ``remote``) or
    ``.bf16_launches`` (both bf16).  Any other device, dtype pair or
    layout raises."""
    arrays = (*ltiles, *htiles)
    cpu = _on_cpu(h, *arrays) and _on_cpu(remote, *arrays)
    if census.active():
        key = (h.dtype, remote.dtype)
        census.launch(_FUSED_LABELS.get(key, f"fused{key}"), h.shape,
                      remote.dtype, h.device)
    if cpu:
        with plain_region("tile_spmm_fused_kernel"):
            return spmm_tiles_fused_plain(ltiles, h, htiles, remote,
                                          lclasses, hclasses, tb)
    if not all(x.device == h.device for x in (*arrays, remote)):
        raise ValueError("tile arrays and tables must be on the same device")
    key = (h.dtype, remote.dtype)
    if key not in _FUSED_ENTRIES:
        raise TypeError(f"the fused aggregation takes h and its remote "
                        f"table as float32/float32, float32/bfloat16 or "
                        f"bfloat16/bfloat16, got {h.dtype}/{remote.dtype}")
    for x in ltiles + htiles:
        if x.dim() != 2 or x.stride(1) != 1:
            raise ValueError("tile arrays must be flat (k, slots), row-major")
    if any(x.dtype != torch.int32 for x in ltiles[:2] + htiles[:2]) or \
            ltiles[2].dtype != torch.float32 or \
            htiles[2].dtype != torch.float32:
        raise TypeError("tile arrays must be int32 src/ld and float32 w")
    for fam in (ltiles, htiles):
        if any(x.shape != fam[0].shape or x.stride(0) != fam[0].stride(0)
               for x in fam):
            raise ValueError("a family's tile arrays must share one "
                             "(k, slots) shape and part stride")
    k, b, f = h.shape
    for name, t in (("h", h), ("remote", remote)):
        if t.dim() != 3 or t.shape[0] != k or t.shape[2] != f \
                or t.stride(2) != 1 or t.stride(1) != f or t.shape[1] == 0:
            raise ValueError(f"{name} must be (k={k}, N, f={f}) row-major, "
                             f"got {tuple(t.shape)}")
    if ltiles[0].shape[0] != k or htiles[0].shape[0] != k:
        raise ValueError("tile arrays and tables must have the same k")
    if not 1 <= tb <= 256:
        raise ValueError(f"tile height tb={tb} outside the kernel's [1, 256]")
    first, loffs, lemax = pack_class_table(lclasses, ltiles[0].shape[1])
    hfirst, hoffs, hemax = pack_class_table(hclasses, htiles[0].shape[1])
    if not np.array_equal(first, hfirst):
        raise ValueError("the local and halo families must share their tile "
                         f"classes' tile counts: {lclasses} vs {hclasses}")
    if not 0 < b <= int(first[-1]) * tb:
        raise ValueError(f"{b} owned rows outside the {int(first[-1])} tiles "
                         f"of {tb}")
    out = torch.empty((k, b, f), dtype=h.dtype, device=h.device)
    vec = min(vector_width(f, t.data_ptr(), t.stride(0), t.element_size())
              for t in (h, remote, out))
    lib = _lib()
    name, counter = _FUSED_ENTRIES[key]
    dev = h.device.index if h.device.index is not None \
        else torch.cuda.current_device()
    rc = getattr(lib, name)(
        *(x.data_ptr() for x in ltiles), h.data_ptr(),
        *(x.data_ptr() for x in htiles), remote.data_ptr(), out.data_ptr(),
        k, len(lclasses), first.ctypes.data, lemax.ctypes.data,
        loffs.ctypes.data, hemax.ctypes.data, hoffs.ctypes.data, tb, b,
        h.shape[1], remote.shape[1], f, vec, ltiles[0].stride(0),
        htiles[0].stride(0), h.stride(0), remote.stride(0), out.stride(0),
        dev, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"tile_spmm fused launch failed: "
            f"{lib.sgcn_cuda_error_string(rc).decode()} (cudaError {rc})")
    setattr(spmm_tiles_fused, counter, getattr(spmm_tiles_fused, counter) + 1)
    return out


spmm_tiles_fused.launches = 0            # float32 h and remote table
spmm_tiles_fused.wire_bf16_launches = 0  # float32 h, bf16 wire
spmm_tiles_fused.bf16_launches = 0       # bf16 h and remote table


def k1_launches() -> int:
    """Float32-weight family launches (K1) on either table dtype."""
    return spmm_tiles.launches + spmm_tiles.bf16_launches


def fused_launches() -> int:
    """Fused-entry launches on any dtype pair: one per GCN aggregation."""
    return (spmm_tiles_fused.launches + spmm_tiles_fused.wire_bf16_launches
            + spmm_tiles_fused.bf16_launches)


# ----------------------------------------------------- plan-driven dispatch
TILE_KERNEL = "tile_spmm"

# plan arrays the tile-kernel GCN forward ships: the reference's
# PALLAS_PLAN_FIELDS with its exchange arrays replaced by the port's
# receive layout — ``recv_src`` for send_idx and halo_src, and the halo
# tiles re-based into the receive buffer (``ptile_hwsrc`` for ptile_hsrc)
TILE_PLAN_FIELDS = ("recv_src", "ptile_lsrc", "ptile_lld", "ptile_lw",
                    "ptile_hwsrc", "ptile_hld", "ptile_hw")
# ... and on an asymmetric plan the a2a flavor's plus the backward's
# transposed layouts (port only; ``CommPlan.ensure_transpose_tiles``)
TILE_PLAN_FIELDS_GEN = TILE_PLAN_FIELDS + (
    "ptile_tlsrc", "ptile_tlld", "ptile_tlw", "ptile_thsrc", "ptile_thld",
    "ptile_thw", "ptile_t1src", "ptile_t1ld", "ptile_t1w", "rev_src")
# ... and the ragged flavor's (PALLAS_PLAN_FIELDS_RAGGED, with the ring
# concat's flat sources ``ring_src`` for rsend_idx): the halo tiles read
# ring positions
TILE_PLAN_FIELDS_RAGGED = ("ring_src", "ptile_lsrc", "ptile_lld",
                           "ptile_lw", "ptile_hrsrc", "ptile_hld",
                           "ptile_hw")


def _classes_log(classes) -> list:
    return [{"tiles": t, "emax": e, "kernel": kern}
            for t, e, kern in classes]


def choose_tile_dispatch(plan, tb: int = 256, decision: dict | None = None,
                         model: str = "gcn", schedule: str = "a2a") -> dict:
    """Build the plan's tile-class layouts and assign the kernel per class
    — the counterpart of ``choose_pallas_dispatch``.  GCN gets the local
    and halo families (``pallas_lclasses``/``pallas_hclasses``), GAT the
    combined-edge family (``pallas_cclasses``); ``schedule='ragged'``
    also builds the ring layout and the ring-re-based halo sources
    (``ptile_hrsrc``/``ptile_crsrc``) and adds the ring's static
    ``comm_schedule``/``rr_sizes`` to the returned forward kwargs.  An
    asymmetric plan also builds the backward's transposed layouts and
    adds ``symmetric=False`` and their classes (``pallas_t{l,h,1}classes``
    for GCN, ``pallas_tc{l,h,1}classes`` for GAT).  Fills
    ``decision['tile_dispatch']`` with the per-class table.  Every class
    runs the CUDA kernel (on CPU tensors its plain version): the
    reference's TPU-measured class rules are recorded as not carried."""
    not_carried = {
        "vmem_budget": "pallas_spmm_fits 4 MiB is a TPU VMEM residency "
                       "rule; the CUDA kernel reads its table from HBM "
                       "through L2",
        "emax_cap": "pallas_emax_cap 8192 is a TPU serial-chain rule; no "
                    "H100 class rule is measured yet",
    }
    if schedule not in ("a2a", "ragged"):
        raise ValueError(f"unknown comm schedule {schedule!r} (resolve "
                         "'auto' first: parallel/plan.py::"
                         "resolve_comm_schedule)")
    log = {"model": model, "schedule": schedule, "tb": tb,
           "rule": "every class runs the tile kernel",
           "not_carried": not_carried}
    out = {"pallas_tb": tb}
    if schedule == "ragged":
        plan.ensure_ragged()
    else:
        plan.ensure_exchange()
    if not plan.symmetric:
        # an asymmetric Â: the backward runs on the transposed layouts
        out["symmetric"] = False
        if model == "gat":
            plan.ensure_cell_transpose_tiles(tb)
        else:
            plan.ensure_transpose_tiles(tb)
        pre = "pallas_tc" if model == "gat" else "pallas_t"
        for fam in ("l", "h", "1"):
            out[f"{pre}{fam}classes"] = tuple(
                (t, e, TILE_KERNEL)
                for t, e in getattr(plan, f"{pre}{fam}classes"))
            log[f"transpose_{fam}"] = _classes_log(out[f"{pre}{fam}classes"])
    if model == "gat":
        plan.ensure_pallas_cell_tiles(tb)
        if schedule == "ragged":
            plan.ensure_pallas_cell_ragged_tiles()
        out["pallas_cclasses"] = tuple(
            (t, e, TILE_KERNEL) for t, e in plan.pallas_cclasses)
        not_carried["gat_memory"] = (
            "check_gat_memory's coefficients were fitted to TPU v5e "
            "compile OOMs")
        log["combined"] = _classes_log(out["pallas_cclasses"])
    else:
        plan.ensure_pallas_tiles(tb)
        if schedule == "ragged":
            plan.ensure_pallas_ragged_tiles()
        out["pallas_lclasses"] = tuple(
            (t, e, TILE_KERNEL) for t, e in plan.pallas_lclasses)
        out["pallas_hclasses"] = tuple(
            (t, e, TILE_KERNEL) for t, e in plan.pallas_hclasses)
        log["local"] = _classes_log(out["pallas_lclasses"])
        log["halo"] = _classes_log(out["pallas_hclasses"])
    if schedule == "ragged":
        # both models thread the same static ring spec
        out.update(comm_schedule="ragged", rr_sizes=plan.rr_sizes)
        log["rr_sizes"] = list(plan.rr_sizes)
    if decision is not None:
        decision["tile_dispatch"] = log
    return out


def _pspmm_tiles_once(h, recv_src, lsrc, lld, lw, hwsrc, hld, hw, tb,
                      lclasses, hclasses, halo_dtype=None):
    """``_pspmm_pallas_once`` over stacked parts: the exchange's receive
    buffer (one row pack, on a ``halo_dtype`` wire if given), then the
    fused tile launch — the local family over ``h``, the halo family over
    the receive buffer in place (``hwsrc``: the plan's ``ptile_hwsrc``),
    summed in float32 and rounded once to ``h``'s dtype
    (``pallas_spmm.py:428``) for the ``b`` owned rows."""
    recv = exchange_recv(h, recv_src, halo_dtype)
    return _fused_on(h, recv, lsrc, lld, lw, hwsrc, hld, hw, tb, lclasses,
                     hclasses)


def _fused_on(h, table, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
              hclasses):
    """The fused tile launch of one GCN aggregation on a given remote
    table — the exchange's receive buffer or ring concat of this step, or
    a stale carry in the same layout (``hsrc``: ``ptile_hwsrc`` or
    ``ptile_hrsrc``)."""
    return spmm_tiles_fused((lsrc, lld, lw), h, (hsrc, hld, hw), table,
                            lclasses, hclasses, tb)


class PspmmTilesSym(torch.autograd.Function):
    """``pspmm_pallas_sym`` with its custom VJP: Â·h over stacked parts,
    and — Â being symmetric — the backward is the same op on the
    gradient: exchange of the gradient's boundary rows and the fused tile
    launch over the local table ``g`` and its receive buffer.  Plan
    tensors get no gradient.

    ``PspmmTilesSym.backward_launches`` counts the fused tile launches
    the backward made (CUDA tensors only; the plain version on the CPU
    launches nothing).  ``halo_dtype`` narrows the wire of both
    directions; the gradient ``g`` arrives in ``h``'s dtype."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, h, recv_src, lsrc, lld, lw, hwsrc, hld, hw, tb,
                lclasses, hclasses, halo_dtype=None):
        ctx.save_for_backward(recv_src, lsrc, lld, lw, hwsrc, hld, hw)
        ctx.static = (tb, lclasses, hclasses, halo_dtype)
        return _pspmm_tiles_once(h, recv_src, lsrc, lld, lw, hwsrc, hld, hw,
                                 tb, lclasses, hclasses, halo_dtype)

    @staticmethod
    def backward(ctx, g):
        before = fused_launches()
        # the incoming gradient may be a strided view (a matmul's
        # backward); the kernels read row-major tables
        gh = _pspmm_tiles_once(g.contiguous(), *ctx.saved_tensors,
                               *ctx.static)
        PspmmTilesSym.backward_launches += fused_launches() - before
        return (gh,) + (None,) * 11


def pspmm_tiles_sym(h, recv_src, lsrc, lld, lw, hwsrc, hld, hw, tb: int,
                    lclasses, hclasses, halo_dtype=None):
    """``pspmm_pallas_sym`` over stacked parts (``PspmmTilesSym``).
    ``h``: ``(k, b, f)`` float32 or bfloat16; ``recv_src`` and ``hwsrc``
    the plan's ``recv_src`` and ``ptile_hwsrc``; returns ``(k, b, f)`` in
    ``h``'s dtype.  ``halo_dtype`` (``'bfloat16'``) narrows the
    exchange's wire only.  Differentiable in ``h``: the backward re-runs
    the op on the gradient."""
    return PspmmTilesSym.apply(h, recv_src, lsrc, lld, lw, hwsrc, hld, hw,
                               tb, lclasses, hclasses, halo_dtype)


def pspmm_tiles_transposed(g, tl, th, t1, rev_src, tb, tlclasses,
                            thclasses, t1classes, halo_dtype=None):
    """Âᵀ·g of an asymmetric Â over stacked parts, from the plan's
    transposed layouts (``CommPlan.ensure_transpose_tiles``; GAT's
    ``ensure_cell_transpose_tiles``, whose ``th`` weights are int8 masks:
    its family launch is then K5): one family launch of the halo rows'
    Âᵀ (``th``) over ``g`` writes every part's reverse send buffer (its
    halo rows' partials at their forward wire slots, float32), one row
    pack ships them back (``ops/pspmm.py::reverse_exchange``, narrowed to
    ``halo_dtype`` — or to ``g``'s bf16 — in its store), then one fused
    launch runs, per owned row, the local rows' Âᵀ chain over ``g``
    (``tl``) and the weight-1 chain over the partials that came back
    (``t1``, in q order), adds them in float32 and stores once in ``g``'s
    dtype.  Every element is one serial chain in stored slot order."""
    send_rev = spmm_tiles_classes(*th, g, thclasses, tb)
    rwire = reverse_exchange(send_rev, rev_src, halo_dtype, g.dtype)
    return spmm_tiles_fused(tl, g, t1, rwire, tlclasses, t1classes, tb)


class PspmmTilesGen(torch.autograd.Function):
    """``PspmmTilesSym`` for an asymmetric Â (a directed graph; the
    reference's ``pspmm_overlap``, whose backward is XLA's transpose):
    the same forward (``_pspmm_tiles_once``), and a backward that runs
    Âᵀ on the plan's transposed layouts (``pspmm_tiles_transposed``): one
    family launch (halo-ᵀ), one row pack (the reverse exchange) and one
    fused launch (local-ᵀ + the owner sum) per aggregation.  Plan tensors
    get no gradient.

    ``PspmmTilesGen.backward_launches`` counts the fused launches the
    backward made (CUDA tensors only); its family launches count in
    ``spmm_tiles.launches`` (``.bf16_launches`` on a bf16 gradient).
    ``halo_dtype`` narrows both directions' wire."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, h, recv_src, lsrc, lld, lw, hwsrc, hld, hw, tb,
                lclasses, hclasses, transposed, halo_dtype=None):
        ctx.transposed = transposed
        ctx.static = (tb, halo_dtype)
        return _pspmm_tiles_once(h, recv_src, lsrc, lld, lw, hwsrc, hld, hw,
                                 tb, lclasses, hclasses, halo_dtype)

    @staticmethod
    def backward(ctx, g):
        tb, halo_dtype = ctx.static
        before = fused_launches()
        gh = pspmm_tiles_transposed(g.contiguous(), *ctx.transposed[:4],
                                     tb, *ctx.transposed[4:], halo_dtype)
        PspmmTilesGen.backward_launches += fused_launches() - before
        return (gh,) + (None,) * 12


def pspmm_tiles_gen(h, pa, tb: int, lclasses, hclasses, tclasses,
                    halo_dtype=None):
    """Â·h over stacked parts for an asymmetric Â (``PspmmTilesGen``).
    ``pa``: the plan tensors of ``TILE_PLAN_FIELDS_GEN``; ``tclasses``:
    the transposed families' classes ``(tl, th, t1)``.  Returns ``(k, b,
    f)`` in ``h``'s dtype; differentiable in ``h`` (Âᵀ on the gradient)."""
    transposed = (
        tuple(pa[f"ptile_tl{x}"] for x in ("src", "ld", "w")),
        tuple(pa[f"ptile_th{x}"] for x in ("src", "ld", "w")),
        tuple(pa[f"ptile_t1{x}"] for x in ("src", "ld", "w")),
        pa["rev_src"], *tclasses)
    return PspmmTilesGen.apply(
        h, pa["recv_src"], pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
        pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"], tb, lclasses,
        hclasses, transposed, halo_dtype)


def _pspmm_ranks_once(h, send_flat, lsrc, lld, lw, hsrc, hld, hw, tb,
                      lclasses, hclasses, mesh, rr_sizes=None,
                      halo_dtype=None):
    """One GCN aggregation on one rank, its exchange overlapped with the
    local pass (ROADMAP A2b): issue the exchange (``ops/pspmm.py::
    rank_exchange``: the send pack and the asynchronous collective), run
    the local family over ``h`` into a float32 partial (one K1 family
    launch), wait, run the halo family over the receive layout in place
    (a second launch; the bf16 family entry on a ``halo_dtype`` wire),
    add in float32 and round once to ``h``'s dtype for the ``b`` owned
    rows (``pallas_spmm.py:428``).  The fused entry's arithmetic, split
    in two launches, so it equals the stacked path bit for bit."""
    recv, wait = rank_exchange(h, send_flat, mesh, halo_dtype, rr_sizes)

    def arrived():
        wait()
        return recv
    return _split_on(h, arrived, (lsrc, lld, lw, hsrc, hld, hw, tb,
                                  lclasses, hclasses))


class PspmmTilesRanks(torch.autograd.Function):
    """``PspmmTilesSym`` (a2a) and ``PspmmTilesRagged`` (the ring) with one
    process per part (``_pspmm_ranks_once``): each rank holds its slice's
    tiles and its own ``(1, B, f)`` rows.  The backward is the same op on
    the gradient (Â symmetric).  Plan tensors get no gradient."""

    @staticmethod
    def forward(ctx, h, send_flat, lsrc, lld, lw, hsrc, hld, hw, tb,
                lclasses, hclasses, mesh, rr_sizes, halo_dtype=None):
        ctx.save_for_backward(send_flat, lsrc, lld, lw, hsrc, hld, hw)
        ctx.static = (tb, lclasses, hclasses, mesh, rr_sizes, halo_dtype)
        return _pspmm_ranks_once(h, send_flat, lsrc, lld, lw, hsrc, hld, hw,
                                 tb, lclasses, hclasses, mesh, rr_sizes,
                                 halo_dtype)

    @staticmethod
    def backward(ctx, g):
        gh = _pspmm_ranks_once(g.contiguous(), *ctx.saved_tensors,
                               *ctx.static)
        return (gh,) + (None,) * 13


def pspmm_tiles_ranks(h, pa, tb: int, lclasses, hclasses, mesh,
                      rr_sizes=None, halo_dtype=None):
    """Â·h on one rank of a rank group (``PspmmTilesRanks``): ``pa`` the
    rank's slice tensors (``TILE_PLAN_FIELDS``, or
    ``TILE_PLAN_FIELDS_RAGGED`` with ``rr_sizes``), ``h`` ``(1, B, f)``
    float32 or bfloat16 (``compute_dtype``: the bf16 wire, K1's bf16
    family entry in both launches).  Returns ``(1, B, f)`` in ``h``'s
    dtype; differentiable in ``h``."""
    if rr_sizes is None:
        send, hsrc = pa["recv_src"], pa["ptile_hwsrc"]
    else:
        send, hsrc = pa["ring_src"], pa["ptile_hrsrc"]
    return PspmmTilesRanks.apply(
        h, send, pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"], hsrc,
        pa["ptile_hld"], pa["ptile_hw"], tb, lclasses, hclasses, mesh,
        rr_sizes, halo_dtype)


def transposed_ranks(g, tl, th, t1, slots, tb, tlclasses, thclasses,
                     t1classes, mesh, halo_dtype=None):
    """``pspmm_tiles_transposed`` on one rank of a rank group (ROADMAP
    A2c): Âᵀ·g of the rank's part, its reverse exchange overlapped with
    the local-ᵀ pass.  One K1 family launch of the halo rows' Âᵀ over
    ``g`` (``th``; K5 on GAT's int8 masks) writes the reverse send
    buffer; the reverse ``all_to_all_single`` of its first ``slots =
    k·S`` rows is issued (``ops/pspmm.py::rank_reverse_exchange``,
    narrowed to ``halo_dtype`` — or to ``g``'s bf16 — at the stacked
    pack's rounding point); while it is in flight the local-ᵀ family over
    ``g`` (``tl``) runs into a float32 partial; then the wait, the
    weight-1 family over what came back (``t1``, in q order) and one
    float32 add rounded to ``g``'s dtype: the stacked fused launch's
    arithmetic split in two launches (``_split_on``), so the same bits
    as ``pspmm_tiles_transposed``'s row for this part."""
    send_rev = spmm_tiles_classes(*th, g, thclasses, tb)
    rwire, wait = rank_reverse_exchange(send_rev, slots, mesh, halo_dtype,
                                        g.dtype)

    def arrived():
        wait()
        return rwire
    return _split_on(g, arrived, (*tl, *t1, tb, tlclasses, t1classes))


class PspmmTilesGenRanks(torch.autograd.Function):
    """``PspmmTilesGen`` on one rank of a rank group (ROADMAP A2c): the
    forward is ``_pspmm_ranks_once`` (the send pack and the collective,
    the local family in flight, the wait, the halo family, one add — the
    forward of an asymmetric Â is the symmetric one's), the backward
    ``transposed_ranks`` on the slice's transposed layouts: three K1
    family launches and one reverse ``all_to_all_single`` an
    aggregation, no pack and no fused launch.
    ``PspmmTilesGenRanks.backward_launches`` counts the family launches
    the backward made (CUDA tensors only; the plain versions on the CPU
    launch nothing).  ``halo_dtype`` narrows both directions' wire.  Plan
    tensors get no gradient."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, h, send_flat, lsrc, lld, lw, hsrc, hld, hw, tb,
                lclasses, hclasses, transposed, mesh, halo_dtype=None):
        ctx.transposed = transposed
        ctx.static = (tb, mesh, halo_dtype)
        return _pspmm_ranks_once(h, send_flat, lsrc, lld, lw, hsrc, hld, hw,
                                 tb, lclasses, hclasses, mesh, None,
                                 halo_dtype)

    @staticmethod
    def backward(ctx, g):
        tb, mesh, halo_dtype = ctx.static
        tl, th, t1, slots, *classes = ctx.transposed
        before = k1_launches()
        gh = transposed_ranks(g.contiguous(), tl, th, t1, slots, tb,
                              *classes, mesh, halo_dtype)
        PspmmTilesGenRanks.backward_launches += k1_launches() - before
        return (gh,) + (None,) * 13


def pspmm_tiles_gen_ranks(h, pa, tb: int, lclasses, hclasses, tclasses,
                          mesh, halo_dtype=None):
    """Â·h on one rank of a rank group for an asymmetric Â
    (``PspmmTilesGenRanks``): ``pa`` the rank's slice tensors
    (``TILE_PLAN_FIELDS_GEN``; the slice's ``rev_src`` is read for its
    length ``k·S`` only), ``tclasses`` the transposed families' classes
    ``(tl, th, t1)``, ``h`` ``(1, B, f)`` float32 or bfloat16.  Returns
    ``(1, B, f)`` in ``h``'s dtype; differentiable in ``h`` (Âᵀ on the
    gradient, its reverse exchange a collective)."""
    transposed = (
        tuple(pa[f"ptile_tl{x}"] for x in ("src", "ld", "w")),
        tuple(pa[f"ptile_th{x}"] for x in ("src", "ld", "w")),
        tuple(pa[f"ptile_t1{x}"] for x in ("src", "ld", "w")),
        int(pa["rev_src"].shape[-1]), *tclasses)
    return PspmmTilesGenRanks.apply(
        h, pa["recv_src"], pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"],
        pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"], tb, lclasses,
        hclasses, transposed, mesh, halo_dtype)


def _pspmm_tiles_ragged_once(h, ring_src, lsrc, lld, lw, rsrc, rld, rw,
                             tb, lclasses, hclasses, rr_sizes,
                             halo_dtype=None):
    """``_pspmm_pallas_ragged_once`` over stacked parts: the ring's
    receive concat (one row pack, each round on a ``halo_dtype`` wire if
    given), then the fused tile launch over the local table ``h`` and the
    concat in place (the halo tiles' sources re-based to ring positions),
    summed in float32 and rounded once to ``h``'s dtype for the ``b``
    owned rows."""
    ring = ring_concat(h, ring_src, rr_sizes, halo_dtype)
    # the a2a flavor's halo tiles in the a2a flavor's edge order, reading
    # the same rows at their ring positions: the same bits
    return _fused_on(h, ring, lsrc, lld, lw, rsrc, rld, rw, tb, lclasses,
                     hclasses)


class PspmmTilesRagged(torch.autograd.Function):
    """``pspmm_pallas_ragged`` with its custom VJP: ``PspmmTilesSym`` on
    the ragged ring.  The backward is the same op on the gradient — the
    gradient rides the same ring at the same round sizes (Â symmetric).
    Bit-identical to ``PspmmTilesSym`` forward and backward.

    ``PspmmTilesRagged.launches`` and ``.backward_launches`` count the
    fused tile launches of the forward and the backward (CUDA tensors
    only; the plain version on the CPU launches nothing)."""

    launches = 0
    backward_launches = 0

    @staticmethod
    def forward(ctx, h, ring_src, lsrc, lld, lw, rsrc, rld, rw, tb,
                lclasses, hclasses, rr_sizes, halo_dtype=None):
        ctx.save_for_backward(ring_src, lsrc, lld, lw, rsrc, rld, rw)
        ctx.static = (tb, lclasses, hclasses, rr_sizes, halo_dtype)
        before = fused_launches()
        out = _pspmm_tiles_ragged_once(h, ring_src, lsrc, lld, lw, rsrc,
                                       rld, rw, tb, lclasses, hclasses,
                                       rr_sizes, halo_dtype)
        PspmmTilesRagged.launches += fused_launches() - before
        return out

    @staticmethod
    def backward(ctx, g):
        before = fused_launches()
        gh = _pspmm_tiles_ragged_once(g.contiguous(), *ctx.saved_tensors,
                                      *ctx.static)
        PspmmTilesRagged.backward_launches += fused_launches() - before
        return (gh,) + (None,) * 12


def pspmm_tiles_ragged(h, ring_src, lsrc, lld, lw, rsrc, rld, rw,
                       tb: int, lclasses, hclasses, rr_sizes,
                       halo_dtype=None):
    """``pspmm_pallas_ragged`` over stacked parts (``PspmmTilesRagged``).
    ``h``: ``(k, b, f)`` float32 or bfloat16; ``ring_src`` the plan's
    ``ring_src``, ``rsrc`` the ring-re-based halo tile sources
    (``ptile_hrsrc``); ``halo_dtype`` narrows each round's wire; returns
    ``(k, b, f)`` in ``h``'s dtype.  Differentiable in ``h``: the
    backward re-runs the op on the gradient."""
    return PspmmTilesRagged.apply(h, ring_src, lsrc, lld, lw, rsrc, rld, rw,
                                  tb, lclasses, hclasses, rr_sizes,
                                  halo_dtype)


class PspmmTilesStale(torch.autograd.Function):
    """``pspmm_stale`` (a2a) and ``pspmm_stale_ragged`` (the ring) with
    their custom VJPs: the one-step-stale aggregation of the pipelined
    trainer, on the same two halves as ``PspmmTilesSym``/
    ``PspmmTilesRagged`` — one row pack, one fused launch.

    Forward: step t's exchange goes into the next carry
    (``ops/pspmm.py::stale_exchange`` / ``stale_ring_exchange``, the
    halo-delta cache's arithmetic included), and one fused launch sums
    ``Â_local·x + Â_halo·used`` with ``used`` the carry from step t−1 —
    or, on a ``fresh`` (sync) step, the exchange just made, which is the
    exact op bit for bit.  Backward (Â symmetric): one pack of the
    gradient ``g`` at ``gwire_dtype`` (never delta) makes the next
    gradient carry, and one fused launch sums ``Â_local·g +
    Â_halo·ghalo_in`` (the fresh carry on a sync step).

    The reference hands the fresh gradient carry out as the cotangent of
    its ``ghalo_in`` argument.  Here the backward stores it in
    ``gholder[layer]``, a list the caller owns, and returns no gradient
    for any carry.  A layer whose input needs no gradient (an
    aggregate-first first layer) runs no backward, so its slot keeps
    what the caller put there.

    The carries stay in the layout the fused launch reads in place: the
    a2a receive buffer ``(k, k·S, f)`` (``hsrc`` = ``ptile_hwsrc``) or the
    ring concat ``(k, ΣS_d, f)`` (``ptile_hrsrc``, ``rr_sizes`` given).
    ``PspmmTilesStale.backward_launches`` counts the backward's fused
    launches (CUDA tensors only)."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, x, halo_in, ghalo_in, src, lsrc, lld, lw, hsrc, hld, hw,
                spec, mode, gholder, layer):
        tb, lclasses, hclasses, rr_sizes = spec
        delta, wire_dtype, gwire_dtype, fresh = mode
        halo_next = _stale_exchange_of(rr_sizes)(
            x, halo_in, src, delta, wire_dtype, fresh)
        used = halo_next if fresh else halo_in
        out = _fused_on(x, used, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
                        hclasses)
        ctx.save_for_backward(ghalo_in, src, lsrc, lld, lw, hsrc, hld, hw)
        ctx.static = (spec, gwire_dtype, fresh, gholder, layer)
        ctx.mark_non_differentiable(halo_next)
        # the carry gets no gradient: do not let autograd fill a zero
        # receive-layout tensor for it on every backward
        ctx.set_materialize_grads(False)
        return out, halo_next

    @staticmethod
    def backward(ctx, g, _g_carry):
        ghalo_in, src, lsrc, lld, lw, hsrc, hld, hw = ctx.saved_tensors
        (tb, lclasses, hclasses, rr_sizes), gwire_dtype, fresh, gholder, \
            layer = ctx.static
        g = g.contiguous()
        gh_next = _stale_exchange_of(rr_sizes)(g, None, src, False,
                                               gwire_dtype, False)
        before = fused_launches()
        gx = _fused_on(g, gh_next if fresh else ghalo_in, lsrc, lld, lw,
                       hsrc, hld, hw, tb, lclasses, hclasses)
        PspmmTilesStale.backward_launches += fused_launches() - before
        if gholder is not None:
            gholder[layer] = gh_next
        return (gx,) + (None,) * 13


def _stale_exchange_of(rr_sizes):
    """The stale exchange of a transport: a2a without ``rr_sizes``."""
    if rr_sizes is None:
        return stale_exchange
    return lambda x, carry, src, *a: stale_ring_exchange(x, carry, src,
                                                         rr_sizes, *a)


def pspmm_tiles_stale(x, halo_in, ghalo_in, recv_src, lsrc, lld, lw, hwsrc,
                      hld, hw, tb: int, lclasses, hclasses, delta=False,
                      wire_dtype=None, gwire_dtype=None, fresh=False,
                      gholder=None, layer: int = 0, keep=None, mesh=None,
                      bases=None):
    """``pspmm_stale`` over stacked parts (``PspmmTilesStale``, a2a).
    ``x``: ``(k, b, f)`` float32; ``halo_in``/``ghalo_in``: the feature
    and gradient carries, ``(k, k·S, f)`` receive buffers (float32 under
    ``delta``, else the wire's dtype).  Returns ``(out, halo_next)``;
    differentiable in ``x``, the next gradient carry goes to
    ``gholder[layer]``.  ``keep``: the plan's ``(keep_recv_src,
    keep_recv_dst)`` — the composed replica × stale mode
    (``pspmm_replica_stale``), whose stale steps ship the kept rows alone
    (``_replica_stale_step``).  ``mesh``: one rank of a rank group
    (``_rank_stale_step``; ``keep`` then the rank's ``(send, nsrc, dst,
    rr_sizes)`` of its shrunken exchange, ``bases`` the per-layer delta
    baselines it replaces)."""
    if mesh is not None:
        return _rank_stale_step(
            x, halo_in, ghalo_in, recv_src, (lsrc, lld, lw, hwsrc, hld, hw),
            (tb, lclasses, hclasses, None, mesh), delta, wire_dtype,
            gwire_dtype, fresh, gholder, layer, keep, bases)
    if keep is not None and not fresh:
        return _replica_stale_step(
            x, halo_in, ghalo_in, keep, (lsrc, lld, lw, hwsrc, hld, hw, tb,
                                         lclasses, hclasses),
            wire_dtype, gwire_dtype, gholder, layer)
    return PspmmTilesStale.apply(
        x, halo_in, ghalo_in, recv_src, lsrc, lld, lw, hwsrc, hld, hw,
        (tb, lclasses, hclasses, None),
        (delta, wire_dtype, gwire_dtype, fresh), gholder, layer)


def pspmm_tiles_stale_ragged(x, halo_in, ghalo_in, ring_src, lsrc, lld, lw,
                             rsrc, rld, rw, tb: int, lclasses, hclasses,
                             rr_sizes, delta=False, wire_dtype=None,
                             gwire_dtype=None, fresh=False, gholder=None,
                             layer: int = 0, keep=None, mesh=None,
                             bases=None):
    """``pspmm_stale_ragged`` over stacked parts (``PspmmTilesStale`` on
    the ring): as ``pspmm_tiles_stale`` with ``(k, ΣS_d, f)`` ring-concat
    carries and the ring-re-based halo tiles (``ptile_hrsrc``).  The
    carries hold the same rows as the a2a flavor's and the fused launch
    walks the same slot order, so it equals ``pspmm_tiles_stale`` bit for
    bit.  ``keep``: ``(keep_ring_src, keep_ring_dst)``, the composed
    mode's ring flavor (``pspmm_replica_stale_ragged``).  ``mesh`` and
    ``bases``: as ``pspmm_tiles_stale``'s, on the ring."""
    if mesh is not None:
        return _rank_stale_step(
            x, halo_in, ghalo_in, ring_src, (lsrc, lld, lw, rsrc, rld, rw),
            (tb, lclasses, hclasses, tuple(rr_sizes), mesh), delta,
            wire_dtype, gwire_dtype, fresh, gholder, layer, keep, bases)
    if keep is not None and not fresh:
        return _replica_stale_step(
            x, halo_in, ghalo_in, keep, (lsrc, lld, lw, rsrc, rld, rw, tb,
                                         lclasses, hclasses),
            wire_dtype, gwire_dtype, gholder, layer)
    return PspmmTilesStale.apply(
        x, halo_in, ghalo_in, ring_src, lsrc, lld, lw, rsrc, rld, rw,
        (tb, lclasses, hclasses, tuple(rr_sizes)),
        (delta, wire_dtype, gwire_dtype, fresh), gholder, layer)


# ----------------------------------------------------------------- replicas
class PspmmTilesReplica(torch.autograd.Function):
    """The aggregation of the replica modes over a carried receive layout
    (``ops/pspmm.py``'s replica section): the forward is one fused launch
    over ``x`` and ``table``, the layout the caller's exchange just
    filled; the backward makes the gradient's exchange by ``kind`` and
    one fused launch over it, and stores the gradient carry it leaves in
    ``gholder[layer]`` (a list the caller owns, as ``PspmmTilesStale``
    does; a layer whose input needs no gradient runs no backward and its
    slot keeps what the caller put there).  A sync step is not a kind of
    its own: it is ``PspmmTilesStale`` with ``fresh``, which makes the
    exact exchange in both directions and keeps the gradient carry.

      * ``'replica'`` — a replica step: the kept rows of ``g`` packed into
        the gradient carry in place (its replica slots keep the last
        sync's rows), then the launch over it;
      * ``'partial'`` — a partial-refresh step: as ``'replica'``, and the
        replica slots ``active`` marks take the owner's fresh gradient
        row (``partial_refresh_grad``);
      * ``'stale'`` — a composed replica × stale step: the launch over the
        gradient carry of step t−1, then the kept pack of ``g`` turns it
        into the next (``pspmm_replica_stale``: the fused launch is
        enqueued first, so one buffer serves as both).

    ``spec``: ``(keep_src, keep_dst, lsrc, lld, lw, hsrc, hld, hw, tb,
    lclasses, hclasses, gwire_dtype, side, active)``.
    Carries are held as attributes, never saved tensors: the in-place
    packs change them.  ``PspmmTilesReplica.backward_launches`` counts
    the backward's fused launches (CUDA tensors only)."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, x, table, gcarry, spec, kind, gholder, layer):
        (_ks, _kd, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
         hclasses, *_rest) = spec
        ctx.state = (gcarry, spec, kind, gholder, layer)
        ctx.set_materialize_grads(False)
        return _fused_on(x, table, lsrc, lld, lw, hsrc, hld, hw, tb,
                         lclasses, hclasses)

    @staticmethod
    def backward(ctx, g):
        gcarry, spec, kind, gholder, layer = ctx.state
        ctx.state = None
        if g is None:
            return (None,) * 7
        (keep_src, keep_dst, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
         hclasses, gwire_dtype, side, active) = spec
        g = g.contiguous()
        if kind == "stale":
            table = gcarry
        else:
            table = replica_pack(gcarry, g, keep_src, keep_dst, gwire_dtype)
            if kind == "partial":
                partial_refresh_grad(table, g, side, active, gwire_dtype)
        before = fused_launches()
        gx = _fused_on(g, table, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
                       hclasses)
        PspmmTilesReplica.backward_launches += fused_launches() - before
        if kind == "stale":
            table = replica_pack(gcarry, g, keep_src, keep_dst, gwire_dtype)
        if gholder is not None:
            gholder[layer] = table
        return (gx,) + (None,) * 6


def _replica_stale_step(x, halo_in, ghalo_in, keep, tiles, wire_dtype,
                        gwire_dtype, gholder, layer):
    """A composed replica × stale step (``pspmm_replica_stale``'s
    ``fresh=False``): the fused launch over the carry of step t−1, then
    the kept rows of ``x`` packed into that carry in place — the replica
    slots keep their last-sync rows — which is the next carry.  Returns
    ``(out, halo_next)``; the backward mirrors it on ``ghalo_in``."""
    spec = (*keep, *tiles, gwire_dtype, None, None)
    out = PspmmTilesReplica.apply(x, halo_in, ghalo_in, spec, "stale",
                                  gholder, layer)
    with torch.no_grad():
        replica_pack(halo_in, x.detach(), *keep, wire_dtype)
    return out, halo_in


def pspmm_tiles_replica(x, carry, gcarry, keep, tiles, kind: str,
                        halo_dtype=None, gholder=None, layer: int = 0,
                        base=None, side=None, band: float = 0.0,
                        mesh=None):
    """One replica-step aggregation of the pure replica mode over stacked
    parts (port of ``pspmm_replica`` and ``pspmm_replica_ragged`` without
    ``fresh``, and of ``pspmm_replica_partial``); their sync step is
    ``pspmm_tiles_stale[_ragged]`` with ``fresh``.

    Args:
      x: ``(k, b, f)`` float32 local rows.
      carry/gcarry: the feature and gradient carries, receive layouts
        ``(k, k·S, f)`` (a2a) or ``(k, ΣS_d, f)`` (ring): the wire's
        dtype, the feature carry float32 under the partial refresh.
      keep: ``(keep_src, keep_dst)`` of the transport; ``tiles``: ``(lsrc, lld, lw, hsrc, hld, hw, tb,
        lclasses, hclasses)`` with the halo tiles of the transport.
      kind: ``'replica'`` or ``'partial'`` (a2a only: ``base`` the
        ``(k, RS, f)`` baselines, ``side`` the plan's partial-refresh
        tensors, ``band``).
      halo_dtype: the wire's dtype, both directions.

    Returns ``(out, carry_next, base_next, nship)``: the aggregation
    (differentiable in ``x``; the backward leaves the next gradient carry
    in ``gholder[layer]``), the next feature carry (``carry`` written in
    place), and on a partial step
    the new baselines and the number of replica copies refreshed (else
    ``base`` and ``None``).

    ``mesh``: one rank of a rank group (``_rank_replica_step``), ``keep``
    its ``(send, nsrc, dst, rr_sizes)``, ``side`` its slice's partial
    refresh tensors; the count is then this rank's."""
    if mesh is not None:
        return _rank_replica_step(x, carry, gcarry, keep, tiles, kind,
                                  halo_dtype, gholder, layer, base, side,
                                  band, mesh)
    active, nship, base_next = None, None, base
    with torch.no_grad():
        xd = x.detach()
        table = replica_pack(carry, xd, *keep, halo_dtype)
        if kind == "partial":
            base_next, nship, active = partial_refresh(
                xd, table, base, side, band, halo_dtype)
    spec = (*keep, *tiles, halo_dtype, side, active)
    out = PspmmTilesReplica.apply(x, table, gcarry, spec, kind, gholder,
                                  layer)
    return out, table, base_next, nship


# ------------------------------------- the carried modes on one rank each
class PspmmTilesStaleRanks(torch.autograd.Function):
    """``PspmmTilesStale`` on one rank of a rank group (ROADMAP A2c): the
    forward is ONE fused launch over ``x`` and ``table`` — the carry of
    step t−1, or on a sync step the exchange just waited on — while step
    t's exchange is in flight (``_rank_stale_step`` issued it).  The
    backward issues the gradient's exchange (never delta) and leaves it
    in flight in ``gholder[layer]`` (an ``InFlight``), waits on the
    gradient carry of step t−1 and makes one fused launch over it; a sync
    step waits on its own exchange first and launches over that.  Its
    fused launches count in ``PspmmTilesStale.backward_launches``.  The
    carries are attributes, never saved tensors."""

    @staticmethod
    def forward(ctx, x, table, ghalo_in, src, lsrc, lld, lw, hsrc, hld, hw,
                spec, gwire_dtype, fresh, gholder, layer):
        tb, lclasses, hclasses, _rr, _mesh = spec
        ctx.save_for_backward(src, lsrc, lld, lw, hsrc, hld, hw)
        ctx.state = (ghalo_in, spec, gwire_dtype, fresh, gholder, layer)
        ctx.set_materialize_grads(False)
        return _fused_on(x, table, lsrc, lld, lw, hsrc, hld, hw, tb,
                         lclasses, hclasses)

    @staticmethod
    def backward(ctx, g):
        ghalo_in, spec, gwire_dtype, fresh, gholder, layer = ctx.state
        ctx.state = None
        if g is None:
            return (None,) * 15
        src, lsrc, lld, lw, hsrc, hld, hw = ctx.saved_tensors
        tb, lclasses, hclasses, rr_sizes, mesh = spec
        g = g.contiguous()
        gh_next, _ = rank_stale_exchange(g, None, None, src, mesh, rr_sizes,
                                         False, gwire_dtype)
        # a sync step's launch reads its own exchange; step t−1's is
        # waited on all the same (its consumer is gone), so no work dangles
        old = settle(ghalo_in)
        table = gh_next.wait() if fresh else old
        before = fused_launches()
        gx = _fused_on(g, table, lsrc, lld, lw, hsrc, hld, hw, tb, lclasses,
                       hclasses)
        PspmmTilesStale.backward_launches += fused_launches() - before
        if gholder is not None:
            gholder[layer] = table if fresh else gh_next
        return (gx,) + (None,) * 14


def _rank_stale_step(x, halo_in, ghalo_in, src, tiles, spec, delta,
                     wire_dtype, gwire_dtype, fresh, gholder, layer, keep,
                     bases):
    """One stale-mode aggregation on a rank: issue step t's exchange
    (``ops/pspmm.py::rank_stale_exchange``; the halo-delta cache's sender
    baseline is ``bases[layer]``, replaced by the next), then ONE fused
    launch over the carry of step t−1, waited on only now — or, on a
    sync step, over the exchange just issued, waited on at once.
    Returns ``(out, halo_next)``: ``halo_next`` an ``InFlight`` that the
    next read waits on (the tensor itself on a sync step).  ``keep``
    (the composed replica × stale mode): a stale step ships the kept rows
    alone (``_rank_replica_stale_step``)."""
    if keep is not None and not fresh:
        return _rank_replica_stale_step(x, halo_in, ghalo_in, keep, tiles,
                                        spec, wire_dtype, gwire_dtype,
                                        gholder, layer)
    rr_sizes, mesh = spec[3], spec[4]
    with torch.no_grad():
        base_in = bases[layer] if delta else None
        halo_next, base_next = rank_stale_exchange(
            x.detach(), halo_in, base_in, src, mesh, rr_sizes, delta,
            wire_dtype, fresh)
    if delta:
        bases[layer] = base_next
    # a sync step's launch reads its own exchange; step t−1's is waited on
    # all the same (its consumer is gone), so no work dangles
    old = settle(halo_in)
    table = halo_next.wait() if fresh else old
    out = PspmmTilesStaleRanks.apply(x, table, ghalo_in, src, *tiles, spec,
                                     gwire_dtype, fresh, gholder, layer)
    return out, (table if fresh else halo_next)


class PspmmTilesReplicaRanks(torch.autograd.Function):
    """``PspmmTilesReplica`` on one rank of a rank group (ROADMAP A2c).

      * ``'replica'`` / ``'partial'`` (the pure replica mode): the
        forward is handed the step's shrunken exchange in flight
        (``pending``, an ``InFlight`` over the carry); it runs the local
        family over ``x`` (one K1 launch), waits, packs the received rows
        into the carry (and on a partial step adds the side channel's
        increments), runs the halo family over the carry (a second K1
        launch; K1-bf16 on a ``halo_dtype`` carry) and adds once in
        float32 — the fused entry's arithmetic in two launches.  The
        backward mirrors it on the gradient carry: the shrunken exchange
        of ``g`` (and the gradient side channel) issued, the local
        launch, the wait and the packs, the halo launch;
      * ``'stale'`` (a composed replica × stale step): the forward is one
        fused launch over the carry of step t−1 (``pending``, waited on
        before); the backward issues ``g``'s shrunken exchange, makes one
        fused launch over the gradient carry of step t−1 and leaves the
        exchange in flight in ``gholder[layer]``, to be packed into that
        carry at the next read.

    ``spec``: ``(keep, tiles, mesh, gwire_dtype, side, mask)`` — ``keep``
    the rank's ``(send, nsrc, dst, rr_sizes)``, ``tiles`` as
    ``pspmm_tiles_replica``'s, ``mask`` the partial step's refreshed
    rows.  The fused launches of the backward count in
    ``PspmmTilesReplica.backward_launches``."""

    @staticmethod
    def forward(ctx, x, pending, gcarry, spec, kind, gholder, layer):
        (_keep, tiles, *_rest) = spec
        lsrc, lld, lw, hsrc, hld, hw, tb, lclasses, hclasses = tiles
        ctx.state = (gcarry, spec, kind, gholder, layer)
        ctx.set_materialize_grads(False)
        if kind == "stale":
            return _fused_on(x, settle(pending), lsrc, lld, lw, hsrc, hld,
                             hw, tb, lclasses, hclasses)
        return _split_on(x, pending.wait, tiles)

    @staticmethod
    def backward(ctx, g):
        gcarry, spec, kind, gholder, layer = ctx.state
        ctx.state = None
        if g is None:
            return (None,) * 7
        (send, nsrc, dst, rr_sizes), tiles, mesh, gwire, side, mask = spec
        lsrc, lld, lw, hsrc, hld, hw, tb, lclasses, hclasses = tiles
        g = g.contiguous()
        works, finish = rank_replica_exchange(g, send, nsrc, dst, mesh,
                                              rr_sizes, gwire)
        if kind == "stale":
            table = settle(gcarry)
            before = fused_launches()
            gx = _fused_on(g, table, lsrc, lld, lw, hsrc, hld, hw, tb,
                           lclasses, hclasses)
            PspmmTilesReplica.backward_launches += fused_launches() - before
            nxt = InFlight(table, works, finish)
        else:
            if kind == "partial":
                w2, fin2 = rank_partial_refresh_grad(g, side, mask, mesh,
                                                     gwire)
                works, finish = works + w2, chain(finish, fin2)
            pending = InFlight(settle(gcarry), works, finish)
            gx = _split_on(g, pending.wait, tiles)
            nxt = pending.wait()
        if gholder is not None:
            gholder[layer] = nxt
        return (gx,) + (None,) * 6


def _split_on(h, arrived, tiles):
    """The rank path's two-launch aggregation over a remote table whose
    exchange is in flight: the local family over ``h`` (one K1 launch),
    then ``arrived()`` — the wait (and a replica step's packs into its
    carry), which returns the table — the halo family over it, one
    float32 add rounded to ``h``'s dtype for the ``b`` owned rows: the
    fused entry's arithmetic in two launches."""
    lsrc, lld, lw, hsrc, hld, hw, tb, lclasses, hclasses = tiles
    b = h.shape[1]
    local = spmm_tiles_classes(lsrc, lld, lw, h, lclasses, tb)[:, :b]
    table = arrived()
    remote = spmm_tiles_classes(hsrc, hld, hw, table, hclasses, tb)[:, :b]
    return (local + remote).to(h.dtype)


def _rank_replica_stale_step(x, halo_in, ghalo_in, keep, tiles, spec,
                             wire_dtype, gwire_dtype, gholder, layer):
    """A composed replica × stale step on a rank: issue the shrunken
    exchange of ``x``, wait on the carry of step t−1, ONE fused launch
    over it, and return the carry with the exchange in flight: the next
    read waits and packs the kept rows into it (its replica slots keep
    their last-sync rows).  Returns ``(out, halo_next)``."""
    send, nsrc, dst, rr_sizes = keep
    tb, lclasses, hclasses, _rr, mesh = spec
    with torch.no_grad():
        works, finish = rank_replica_exchange(x.detach(), send, nsrc, dst,
                                              mesh, rr_sizes, wire_dtype)
    table = settle(halo_in)
    rspec = (keep, (*tiles, tb, lclasses, hclasses), mesh, gwire_dtype,
             None, None)
    out = PspmmTilesReplicaRanks.apply(x, table, ghalo_in, rspec, "stale",
                                       gholder, layer)
    return out, InFlight(table, works, finish)


def _rank_replica_step(x, carry, gcarry, keep, tiles, kind, halo_dtype,
                       gholder, layer, base, side, band, mesh):
    """A replica (or partial refresh) step on a rank: issue the shrunken
    exchange (and the partial refresh's forward side channel), then the
    two-launch aggregation that waits between its launches
    (``PspmmTilesReplicaRanks``).  The exchange is synchronous: the carry
    is this step's, as in the reference.  Returns ``(out, carry_next,
    base_next, nship)`` as ``pspmm_tiles_replica`` does."""
    send, nsrc, dst, rr_sizes = keep
    mask, nship, base_next = None, None, base
    with torch.no_grad():
        xd = x.detach()
        works, finish = rank_replica_exchange(xd, send, nsrc, dst, mesh,
                                              rr_sizes, halo_dtype)
        if kind == "partial":
            w2, fin2, base_next, nship, mask = rank_partial_refresh(
                xd, base, side, band, mesh, halo_dtype)
            works, finish = works + w2, chain(finish, fin2)
    pending = InFlight(settle(carry), works, finish)
    spec = (keep, tiles, mesh, halo_dtype, side, mask)
    out = PspmmTilesReplicaRanks.apply(x, pending, gcarry, spec, kind,
                                       gholder, layer)
    return out, pending.wait(), base_next, nship


def gat_tiles_pass(csrc, cld, cw, table, cclasses, tb: int, num_rows: int):
    """One GAT attention pass — the counterpart of ``gat_pallas_pass``: the
    class-dispatched kernel over the combined-edge tiles with 0/1 mask
    weights ``cw`` (int8 as the trainer ships them: on CUDA the kernel's
    mask entry point converts each in the kernel, on the CPU the plain
    version upcasts).  ``table``: the ``(k, B+R, lanes)`` ``[local; halo]``
    rows of whichever form the layer ships — the fused ``[p ‖ u]`` table,
    one of the split pair, or one lane group of the packed bf16 form —
    float32 or bfloat16.  Returns ``(k, num_rows, lanes)`` float32."""
    return spmm_tiles_classes(csrc, cld, cw, table, cclasses,
                              tb)[:, :num_rows]
