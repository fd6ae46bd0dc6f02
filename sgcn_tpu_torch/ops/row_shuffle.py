"""Row gathers on the card (``csrc/row_shuffle.cu``, built by
``ops/_build.py``):

  * ``row_shuffle`` — the port of the micro-benchmark probe K6
    (``scripts/spmm_micro.py::tga_kernel``, a Pallas ``take_along_axis``
    over an ``(S, f)`` f32 chunk driven by an ``(S, 1)`` int32 index):
    ``out[i, :] = x[idx[i], :]``.  On CPU tensors it is
    ``row_shuffle_plain``, an advanced index; a CUDA tensor launches the
    kernel on the current stream or raises.  ``row_shuffle.launches``
    counts kernel launches;
  * ``row_pack`` — the stacked row pack that carries the halo exchange and
    the ragged ring (K3, K4; ``ops/pspmm.py``): ``out[q, j] =
    src[flat[q, j] // rows, flat[q, j] % rows]`` over a ``(k, rows, ...)``
    stack, cast to the output dtype as it is stored.  On CPU tensors it is
    ``row_pack_plain``; a CUDA tensor launches the kernel or raises.
    ``row_pack.launches`` counts kernel launches;
  * ``row_pack_into`` — the same pack into rows of a buffer the caller
    owns, ``out.flat[dst[i]] = cast(src.flat[flat[i]])``: a replica
    step's kept rows written into the carried receive layout
    (``ops/pspmm.py::replica_pack``).  On CPU tensors it is
    ``row_pack_into_plain``; a CUDA tensor launches the kernel or
    raises.  ``row_pack_into.launches`` counts kernel launches; an empty
    list launches nothing.

A copy rounds nothing, and the pack's float32 → bf16 store rounds as
torch's cast on the same device does, so each kernel agrees with its plain
version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import census
from ..utils.backend import plain_region


def row_shuffle_plain(x, idx):
    """``x[idx]`` row by row: ``x`` ``(N, f)``, ``idx`` ``(S,)`` or
    ``(S, 1)`` int → ``(S, f)``."""
    return x[idx.reshape(-1).long()]


def _lib():
    from . import _build

    lib = _build.load("row_shuffle")
    if not getattr(lib, "_sgcn_typed", False):
        lib.sgcn_row_shuffle_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.sgcn_row_shuffle_f32.restype = ctypes.c_int
        lib.sgcn_row_pack.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.sgcn_row_pack.restype = ctypes.c_int
        lib.sgcn_row_pack_into.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.sgcn_row_pack_into.restype = ctypes.c_int
        lib.sgcn_row_shuffle_error_string.argtypes = [ctypes.c_int]
        lib.sgcn_row_shuffle_error_string.restype = ctypes.c_char_p
        lib._sgcn_typed = True
    return lib


def row_shuffle(x, idx):
    """``out[i, :] = x[idx[i], :]`` — the counterpart of ``tga_kernel``.

    Args:
      x: ``(N, f)`` float32, row-major.
      idx: ``(S,)`` or ``(S, 1)`` int32 rows of ``x`` (the probe's
        ``(S, 1)`` index), on ``x``'s device.

    Returns ``(S, f)`` float32.  On CPU tensors this is
    ``row_shuffle_plain``; on CUDA tensors it launches the kernel on the
    current stream (no synchronize) and counts it in
    ``row_shuffle.launches``.  Any other dtype, shape, layout or device
    raises; an index outside ``[0, N)`` fails the launch."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"row_shuffle takes a 2-D float32 table, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if idx.dtype != torch.int32 or not (
            idx.dim() == 1 or (idx.dim() == 2 and idx.shape[1] == 1)):
        raise TypeError(f"row_shuffle takes an (S,) or (S, 1) int32 index, "
                        f"got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError("table and index must be on the same device")
    census.launch("K6", (idx.shape[0], x.shape[1]), x.dtype, x.device)
    if x.device.type == "cpu":
        with plain_region("row_shuffle_f32_kernel"):
            return row_shuffle_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_shuffle runs on cpu or cuda tensors, got "
                         f"{x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_shuffle takes a row-major table and a "
                         "contiguous index")
    n, f = x.shape
    s = idx.shape[0]
    if n == 0 or f == 0 or s == 0:
        raise ValueError(f"empty row shuffle: table {tuple(x.shape)}, "
                         f"{s} rows")
    out = torch.empty((s, f), dtype=torch.float32, device=x.device)
    lib = _lib()
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.sgcn_row_shuffle_f32(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), s, n, f, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"row_shuffle launch failed: "
            f"{lib.sgcn_row_shuffle_error_string(rc).decode()} "
            f"(cudaError {rc})")
    row_shuffle.launches += 1
    return out


row_shuffle.launches = 0


# the pack's dtypes and their codes in csrc/row_shuffle.cu
_PACK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_pack_plain(src, flat, dtype=None):
    """``src.reshape(k·rows, ...)[flat]`` in ``dtype`` (default
    ``src.dtype``): ``src`` ``(k, rows, ...)``, ``flat`` ``(k, J)`` int →
    ``(k, J, ...)``."""
    k, rows = src.shape[:2]
    out = src.reshape(k * rows, *src.shape[2:])[flat.reshape(-1).long()]
    return out.reshape(*flat.shape, *src.shape[2:]).to(dtype or src.dtype)


def row_pack(src, flat, dtype=None):
    """Gather rows of the ``k`` stacked parts by one flat index and cast.

    Args:
      src: ``(k, rows, ...)`` float32 or bfloat16, the parts stacked (a
        row is everything past the first two axes, ``w`` values).
      flat: ``(k, J)`` int32 — output row ``(q, j)`` is stacked row
        ``flat[q, j] = part·rows + row`` of ``src`` (any part).
      dtype: the output dtype, float32 or bfloat16 (default ``src``'s):
        float32 → bf16 rounds to nearest even, bf16 → float32 widens
        exactly.

    Returns ``(k, J, ...)`` in ``dtype``.  On CPU tensors this is
    ``row_pack_plain``; on CUDA tensors it launches the kernel on the
    current stream (no synchronize) and counts it in
    ``row_pack.launches``.  A non-contiguous source, another dtype or
    device raises; an index outside ``[0, k·rows)`` fails the launch."""
    dtype = dtype or src.dtype
    if src.dim() < 2 or flat.dim() != 2:
        raise ValueError(f"row_pack takes a (k, rows, ...) source and a "
                         f"(k, J) index, got {tuple(src.shape)} and "
                         f"{tuple(flat.shape)}")
    if flat.dtype != torch.int32:
        raise TypeError(f"row_pack takes an int32 index, got {flat.dtype}")
    if flat.device != src.device:
        raise ValueError("source and index must be on the same device")
    census.launch("pack", (*flat.shape, *src.shape[2:]), dtype, src.device)
    if src.device.type == "cpu":
        with plain_region("row_pack_kernel"):
            return row_pack_plain(src, flat, dtype)
    if src.device.type != "cuda":
        raise ValueError(f"row_pack runs on cpu or cuda tensors, got "
                         f"{src.device}")
    if src.dtype not in _PACK_DTYPES or dtype not in _PACK_DTYPES:
        raise TypeError(f"row_pack moves float32 and bfloat16 rows, got "
                        f"{src.dtype} -> {dtype}")
    if not (src.is_contiguous() and flat.is_contiguous()):
        raise ValueError("row_pack takes a row-major source and a "
                         "contiguous index")
    n_src, n_out = src.shape[0] * src.shape[1], flat.numel()
    w = src[0, 0].numel() if n_src else 0
    if n_src == 0 or n_out == 0 or w == 0:
        raise ValueError(f"empty row pack: source {tuple(src.shape)}, "
                         f"index {tuple(flat.shape)}")
    out = torch.empty((*flat.shape, *src.shape[2:]), dtype=dtype,
                      device=src.device)
    lib = _lib()
    dev = src.device.index if src.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.sgcn_row_pack(
        src.data_ptr(), flat.data_ptr(), out.data_ptr(), n_out, n_src, w,
        _PACK_DTYPES[src.dtype], _PACK_DTYPES[dtype], dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"row_pack launch failed: "
            f"{lib.sgcn_row_shuffle_error_string(rc).decode()} "
            f"(cudaError {rc})")
    row_pack.launches += 1
    return out


row_pack.launches = 0


def row_pack_into_plain(out, src, flat, dst):
    """``out.flat[dst] = src.flat[flat]`` in ``out``'s dtype, in place:
    the rows gathered by ``index_select`` and stored by ``index_copy_``.
    ``out`` ``(k, J, ...)``, ``src`` ``(k, rows, ...)``, ``flat``/``dst``
    ``(n,)`` int.  Returns ``out``."""
    w = out[0, 0].numel()
    rows = src.reshape(-1, w).index_select(0, flat.long()).to(out.dtype)
    out.view(-1, w).index_copy_(0, dst.long(), rows)
    return out


def row_pack_into(out, src, flat, dst):
    """Gather rows of the ``k`` stacked parts into given rows of ``out``,
    casting as they are stored; every other row of ``out`` keeps its
    value.

    Args:
      out: ``(k, J, ...)`` float32 or bfloat16, row-major, written in
        place (row ``(q, j)`` is flat row ``q·J + j``).
      src: ``(k, rows, ...)`` float32 or bfloat16 with ``out``'s row
        width (a row is everything past the first two axes).
      flat: ``(n,)`` int32 — the flat source row ``part·rows + row`` of
        each moved row.
      dst: ``(n,)`` int32 — its flat row of ``out``; no two alike.

    Returns ``out``.  ``n = 0`` moves and launches nothing.  On CPU
    tensors this is ``row_pack_into_plain``; on CUDA tensors it launches
    the kernel on the current stream (no synchronize) and counts it in
    ``row_pack_into.launches``.  A non-contiguous tensor, another dtype or
    device raises; an index outside ``[0, k·rows)`` or a destination
    outside ``[0, k·J)`` fails the launch."""
    if src.dim() < 2 or out.dim() < 2 or flat.dim() != 1 \
            or dst.shape != flat.shape:
        raise ValueError(f"row_pack_into takes (k, ·, ...) tensors and two "
                         f"(n,) indices, got {tuple(out.shape)}, "
                         f"{tuple(src.shape)}, {tuple(flat.shape)}, "
                         f"{tuple(dst.shape)}")
    if flat.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"row_pack_into takes int32 indices, got "
                        f"{flat.dtype} and {dst.dtype}")
    w = out[0, 0].numel() if out.numel() else 0
    if src.shape[0] * src.shape[1] and src[0, 0].numel() != w:
        raise ValueError(f"row widths differ: out {tuple(out.shape)}, src "
                         f"{tuple(src.shape)}")
    if not all(x.device == out.device for x in (src, flat, dst)):
        raise ValueError("tensors and indices must be on the same device")
    if flat.numel() == 0:
        return out
    census.launch("pack-into", (flat.numel(), w), out.dtype, out.device)
    if out.device.type == "cpu":
        with plain_region("row_pack_kernel"):
            return row_pack_into_plain(out, src, flat, dst)
    if out.device.type != "cuda":
        raise ValueError(f"row_pack_into runs on cpu or cuda tensors, got "
                         f"{out.device}")
    if src.dtype not in _PACK_DTYPES or out.dtype not in _PACK_DTYPES:
        raise TypeError(f"row_pack_into moves float32 and bfloat16 rows, "
                        f"got {src.dtype} -> {out.dtype}")
    if not all(x.is_contiguous() for x in (out, src, flat, dst)):
        raise ValueError("row_pack_into takes row-major tensors and "
                         "contiguous indices")
    n_src = src.shape[0] * src.shape[1]
    n_out = out.shape[0] * out.shape[1]
    if n_src == 0 or w == 0:
        raise ValueError(f"empty row pack: source {tuple(src.shape)}, "
                         f"output {tuple(out.shape)}")
    lib = _lib()
    dev = out.device.index if out.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.sgcn_row_pack_into(
        src.data_ptr(), flat.data_ptr(), dst.data_ptr(), out.data_ptr(),
        flat.numel(), n_src, n_out, w, _PACK_DTYPES[src.dtype],
        _PACK_DTYPES[out.dtype], dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"row_pack_into launch failed: "
            f"{lib.sgcn_row_shuffle_error_string(rc).decode()} "
            f"(cudaError {rc})")
    row_pack_into.launches += 1
    return out


row_pack_into.launches = 0
