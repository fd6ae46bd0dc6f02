"""Destination-tiled SpMM — the port of ``sgcn_tpu/ops/pallas_spmm.py``.

The reference's one TPU kernel, ``spmm_pallas``, becomes a CUDA kernel for
Hopper (``csrc/tile_spmm.cu``, built by ``ops/_build.py``).  This module
holds, in the reference's order:

  * the numpy tile builders ``tile_classes_from_buckets`` and
    ``build_dst_tile_classes`` (copied; the plan's tile layout rests on
    them);
  * ``spmm_tiles`` — the kernel wrapper (counterpart of ``spmm_pallas``)
    and ``spmm_tiles_plain``, its plain PyTorch version.  The wrapper runs
    the plain version only for tensors on the CPU; a CUDA tensor launches
    the kernel or raises.  ``spmm_tiles.launches`` counts kernel launches;
  * ``spmm_tiles_classes`` — the per-degree-class dispatch (counterpart of
    ``spmm_pallas_classes``);
  * ``choose_tile_dispatch`` — the per-class table, logged the way
    ``choose_pallas_dispatch`` logs it;
  * ``pspmm_tiles_sym`` — ``pspmm_pallas_sym`` with its custom VJP as the
    ``torch.autograd.Function`` ``PspmmTilesSym``: halo exchange, the
    kernel over the local table, the kernel over the halo table,
    ``local + remote``; the backward is the same op on the gradient
    (Â is symmetric).

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

from .pspmm import halo_exchange


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


# ------------------------------------------------------------- the kernel
def spmm_tiles_plain(tsrc, tld, tw, table, tb: int = 256):
    """Plain PyTorch version of the tile SpMM: a literal loop over the
    ``Emax`` edge slots, vectorized across tiles and parts.  At slot ``e``
    every tile adds ``tw[e] * table[tsrc[e]]`` into its row ``tld[e]``;
    one row per tile per step, so no two updates collide and each row's
    additions happen in stored edge order, multiply and add rounded
    separately — the kernel's arithmetic, on any device.

    ``tsrc``/``tld``: int32 ``(k, T, Emax)`` (or ``(T, Emax)``); ``tw``
    float32, same shape; ``table``: ``(k, N, f)`` (or ``(N, f)``).
    Returns ``(k, T·tb, f)`` (or ``(T·tb, f)``) float32.
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
    flat_table = table.reshape(k * n, f).to(torch.float32)
    src = (src + (torch.arange(k, device=dev) * n).view(k, 1, 1)) \
        .reshape(k * t, emax)
    ld = (ld + (torch.arange(k * t, device=dev) * tb).view(k, t, 1)) \
        .reshape(k * t, emax)
    w = tw.to(torch.float32).reshape(k * t, emax)
    acc = torch.zeros(k * t * tb, f, dtype=torch.float32, device=dev)
    for e in range(emax):
        rows = ld[:, e]
        acc[rows] = acc[rows] + w[:, e, None] * flat_table[src[:, e]]
    out = acc.view(k, t * tb, f)
    return out[0] if single else out


def _lib():
    from . import _build

    lib = _build.load("tile_spmm")
    if not getattr(lib, "_sgcn_typed", False):
        lib.sgcn_tile_spmm_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.sgcn_tile_spmm_f32.restype = ctypes.c_int
        lib.sgcn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgcn_cuda_error_string.restype = ctypes.c_char_p
        lib._sgcn_typed = True
    return lib


def _check_cuda_args(tsrc, tld, tw, table, tb: int):
    if not all(x.device == table.device for x in (tsrc, tld, tw)):
        raise ValueError("tile arrays and table must be on the same device")
    if tsrc.dtype != torch.int32 or tld.dtype != torch.int32:
        raise TypeError("tsrc/tld must be int32 (the plan's stored form)")
    if tw.dtype != torch.float32:
        raise TypeError("tw must be float32")
    if tsrc.shape != tld.shape or tsrc.shape != tw.shape or tsrc.dim() != 3:
        raise ValueError(f"tile arrays must share one (k, T, Emax) shape, "
                         f"got {tuple(tsrc.shape)}, {tuple(tld.shape)}, "
                         f"{tuple(tw.shape)}")
    k, t, emax = tsrc.shape
    if table.dim() != 3 or table.shape[0] != k:
        raise ValueError(f"table must be (k={k}, N, f), got "
                         f"{tuple(table.shape)}")
    if not 1 <= tb <= 256:
        raise ValueError(f"tile height tb={tb} outside the kernel's [1, 256]")
    # each part's (T, Emax) block must be row-major; parts may sit at any
    # stride (a class slice of the flat (k, ΣT_c·Emax_c) plan arrays)
    for x in (tsrc, tld, tw):
        if x.stride(2) != 1 or x.stride(1) != emax or x.stride(0) != tsrc.stride(0):
            raise ValueError("tile arrays must be row-major (T, Emax) per "
                             "part with one common part stride")
    if table.stride(2) != 1 or table.stride(1) != table.shape[2]:
        raise ValueError("table must be row-major (N, f) per part")


def spmm_tiles(tsrc, tld, tw, table, tb: int = 256):
    """Â·table over dst tiles — the counterpart of ``spmm_pallas``.

    Args:
      tsrc/tld/tw: ``(k, T, Emax)`` tile arrays (``(T, Emax)`` for one
        part): int32 source row, int32 local destination row in
        ``[0, tb)``, float32 weight; pads carry weight 0 and dst ``tb-1``.
      table: ``(k, N, f)`` float32 feature rows (``(N, f)`` for one part).
        f32 only in this slice: bf16 tables are ROADMAP item A6.

    Returns ``(k, T·tb, f)`` float32 (``(T·tb, f)`` for one part); slice to
    the true row count.  On CPU tensors this is ``spmm_tiles_plain``; on
    CUDA tensors it launches the CUDA kernel on the current stream (no
    synchronize) and counts the launch in ``spmm_tiles.launches``.  Any
    other device, dtype or layout raises.
    """
    if table.dtype != torch.float32:
        raise TypeError(f"tile SpMM tables are float32 in this port "
                        f"(got {table.dtype}; bf16 is ROADMAP item A6)")
    if table.device.type == "cpu" and all(
            x.device.type == "cpu" for x in (tsrc, tld, tw)):
        return spmm_tiles_plain(tsrc, tld, tw, table, tb)
    if table.device.type != "cuda":
        raise ValueError(f"tile SpMM runs on cpu or cuda tensors, got "
                         f"{table.device}")
    single = tsrc.dim() == 2
    if single:
        tsrc, tld, tw, table = (x.unsqueeze(0) for x in (tsrc, tld, tw, table))
    _check_cuda_args(tsrc, tld, tw, table, tb)
    k, t, emax = tsrc.shape
    n, f = table.shape[1], table.shape[2]
    if n == 0 or f == 0 or t == 0:
        raise ValueError(f"empty tile SpMM: table {tuple(table.shape)}, "
                         f"{t} tiles")
    out = torch.empty((k, t * tb, f), dtype=torch.float32,
                      device=table.device)
    lib = _lib()
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.sgcn_tile_spmm_f32(
        tsrc.data_ptr(), tld.data_ptr(), tw.data_ptr(),
        table.data_ptr(), out.data_ptr(), k, t, emax, tb, n, f,
        tsrc.stride(0), table.stride(0), out.stride(0), dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"tile_spmm launch failed: "
            f"{lib.sgcn_cuda_error_string(rc).decode()} (cudaError {rc})")
    spmm_tiles.launches += 1
    return out[0] if single else out


spmm_tiles.launches = 0


def spmm_tiles_classes(flat_src, flat_ld, flat_w, table, classes, tb: int):
    """Degree-binned dispatch over the flat tile-class arrays — the
    counterpart of ``spmm_pallas_classes``.  ``classes`` is
    ``((t_c, emax_c[, kernel]), ...)``: class c owns the next
    ``t_c·emax_c`` flat slots of every part, viewed (not copied) as its
    own ``(k, t_c, emax_c)`` pad.  Every class runs ``spmm_tiles``.
    Returns ``(k, Σ t_c·tb, f)`` float32 (no leading k for 1-D inputs)."""
    outs, off = [], 0
    for tc, ec, *_ in classes:
        sl = slice(off, off + tc * ec)
        shape = flat_src.shape[:-1] + (tc, ec)
        outs.append(spmm_tiles(flat_src[..., sl].reshape(shape),
                               flat_ld[..., sl].reshape(shape),
                               flat_w[..., sl].reshape(shape), table, tb))
        off += tc * ec
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


# ----------------------------------------------------- plan-driven dispatch
TILE_KERNEL = "tile_spmm"

# plan arrays the tile-kernel GCN forward ships (the reference's
# PALLAS_PLAN_FIELDS, same names)
TILE_PLAN_FIELDS = ("send_idx", "halo_src", "ptile_lsrc", "ptile_lld",
                    "ptile_lw", "ptile_hsrc", "ptile_hld", "ptile_hw")


def _classes_log(classes) -> list:
    return [{"tiles": t, "emax": e, "kernel": kern}
            for t, e, kern in classes]


def choose_tile_dispatch(plan, tb: int = 256,
                         decision: dict | None = None) -> dict:
    """Build the plan's tile-class layouts and assign the kernel per class
    — the counterpart of ``choose_pallas_dispatch``.  Returns the static
    forward kwargs and fills ``decision['tile_dispatch']`` with the
    per-class table.  Every class runs the CUDA kernel (on CPU tensors
    its plain version): the reference's TPU-measured class rules are
    recorded as not carried."""
    plan.ensure_pallas_tiles(tb)
    lclasses = tuple((t, e, TILE_KERNEL) for t, e in plan.pallas_lclasses)
    hclasses = tuple((t, e, TILE_KERNEL) for t, e in plan.pallas_hclasses)
    if decision is not None:
        decision["tile_dispatch"] = {
            "model": "gcn", "schedule": "a2a", "tb": tb,
            "rule": "every class runs the tile kernel",
            "not_carried": {
                "vmem_budget": "pallas_spmm_fits 4 MiB is a TPU VMEM "
                               "residency rule; the CUDA kernel reads its "
                               "table from HBM through L2",
                "emax_cap": "pallas_emax_cap 8192 is a TPU serial-chain "
                            "rule; no H100 class rule is measured yet",
            },
            "local": _classes_log(lclasses),
            "halo": _classes_log(hclasses)}
    return {"pallas_tb": tb, "pallas_lclasses": lclasses,
            "pallas_hclasses": hclasses}


def _pspmm_tiles_once(h, send_idx, halo_src, lsrc, lld, lw, hsrc, hld, hw,
                      tb, lclasses, hclasses):
    """``_pspmm_pallas_once`` over stacked parts: exchange the boundary
    rows, run the tile kernel over the local table ``h`` and over the halo
    table, and return ``local + remote`` sliced to the ``b`` owned rows."""
    halo = halo_exchange(h, send_idx, halo_src)
    b = h.shape[1]
    local = spmm_tiles_classes(lsrc, lld, lw, h, lclasses, tb)[:, :b]
    remote = spmm_tiles_classes(hsrc, hld, hw, halo, hclasses, tb)[:, :b]
    return local + remote


class PspmmTilesSym(torch.autograd.Function):
    """``pspmm_pallas_sym`` with its custom VJP: Â·h over stacked parts,
    and — Â being symmetric — the backward is the same op on the
    gradient: exchange of the gradient's boundary rows, the tile kernel
    over the local table ``g``, the tile kernel over the halo table of
    ``g``, ``local + remote``.  Plan tensors get no gradient.

    ``PspmmTilesSym.backward_launches`` counts the tile-kernel launches
    the backward made (CUDA tensors only; the plain version on the CPU
    launches nothing)."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, h, send_idx, halo_src, lsrc, lld, lw, hsrc, hld, hw,
                tb, lclasses, hclasses):
        ctx.save_for_backward(send_idx, halo_src, lsrc, lld, lw, hsrc, hld,
                              hw)
        ctx.static = (tb, lclasses, hclasses)
        return _pspmm_tiles_once(h, send_idx, halo_src, lsrc, lld, lw, hsrc,
                                 hld, hw, tb, lclasses, hclasses)

    @staticmethod
    def backward(ctx, g):
        before = spmm_tiles.launches
        # the incoming gradient may be a strided view (the [:, :b] slice,
        # a matmul's backward); the kernel reads row-major tables
        gh = _pspmm_tiles_once(g.contiguous(), *ctx.saved_tensors,
                               *ctx.static)
        PspmmTilesSym.backward_launches += spmm_tiles.launches - before
        return (gh,) + (None,) * 11


def pspmm_tiles_sym(h, send_idx, halo_src, lsrc, lld, lw, hsrc, hld, hw,
                    tb: int, lclasses, hclasses):
    """``pspmm_pallas_sym`` over stacked parts (``PspmmTilesSym``).
    ``h``: ``(k, b, f)`` float32; returns ``(k, b, f)``.  Differentiable
    in ``h``: the backward re-runs the op on the gradient."""
    return PspmmTilesSym.apply(h, send_idx, halo_src, lsrc, lld, lw, hsrc,
                               hld, hw, tb, lclasses, hclasses)
