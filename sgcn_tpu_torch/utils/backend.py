"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Without a GPU, a call that did not
ask for the CPU raises: it never falls back silently.
"""

from __future__ import annotations

import contextlib

import torch

from . import census


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises if CUDA is wanted and absent.

    On CUDA the dense ``h @ w`` products must be true float32 to compare
    with the reference, so this turns TF32 off explicitly for matmuls and
    for cuDNN (PyTorch's cuDNN default is TF32 on).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: this entry point runs on the GPU "
                "unless device='cpu' (--device cpu) is asked for")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def device_name(device) -> str:
    """Human name of the device results were produced on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def plain_region(kernel: str):
    """While ``torch.profiler`` records, a region named after the CUDA
    kernel a plain version stands for (a CPU trace then classifies the
    plain version's ops as that kernel's, ``obs/tracing.py``); while a
    census records (``utils/census.py``), the mark that a plain version
    runs; otherwise nothing."""
    region = (torch.profiler.record_function(kernel)
              if torch.autograd._profiler_enabled() else None)
    if census.active():
        return census.plain(region)
    return region if region is not None else contextlib.nullcontext()
