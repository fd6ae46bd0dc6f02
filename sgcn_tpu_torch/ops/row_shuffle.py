"""Row shuffle — the port of the micro-benchmark probe K6
(``scripts/spmm_micro.py::tga_kernel``, a Pallas ``take_along_axis`` over
an ``(S, f)`` f32 chunk driven by an ``(S, 1)`` int32 index).

  * ``row_shuffle`` — the kernel wrapper: ``out[i, :] = x[idx[i], :]``.
    On CPU tensors it is ``row_shuffle_plain``; a CUDA tensor launches the
    CUDA kernel (``csrc/row_shuffle.cu``, built by ``ops/_build.py``) on
    the current stream or raises.  ``row_shuffle.launches`` counts kernel
    launches;
  * ``row_shuffle_plain`` — its plain PyTorch version, an advanced index.

A copy rounds nothing, so the kernel and the plain version agree bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch


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
    if x.device.type == "cpu":
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
