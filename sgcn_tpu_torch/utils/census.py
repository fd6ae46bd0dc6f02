"""Census hooks: what a step launches and which collectives it issues.

Every kernel wrapper (``ops/row_shuffle.py``, ``ops/tile_spmm.py``) calls
``launch`` once where it launches its kernel on the card or runs its plain
version on the CPU, and every collective site (``ops/pspmm.py``,
``parallel/mesh.py``, the trainer's gradient all-reduce) calls
``collective`` once where it issues one.  While a ``recording()`` block is
open each call appends one ``Record`` — its label, shape, dtype and device
— to the block's list, in issue order; outside one a hook does no work.
The CPU's plain versions and the card's kernels record at the same places,
so a step's census is the same list on either device.  The static-analysis
tool (``sgcn_tpu_torch.analysis.census``) holds it against the plan.

A ``tally()`` block counts every launch by label over a longer stretch
(the card's census holds it against a profiler window).  A label outside
``LAUNCH_LABELS`` / ``COLLECTIVE_LABELS`` raises: a hook never records a
launch the census does not know.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import NamedTuple

# kernel launch labels: the entry point a wrapper launched, its
# ``obs/tracing.py::KERNEL_TABLE`` label, and the wrapper counter that
# counts it on the card ``(function name, attribute)``
LAUNCH_LABELS = {
    "fused": ("K3/K4 fused", "spmm_tiles_fused", "launches"),
    "fused-wire-bf16": ("K3/K4 fused", "spmm_tiles_fused",
                        "wire_bf16_launches"),
    "fused-bf16": ("K3/K4 fused", "spmm_tiles_fused", "bf16_launches"),
    "K1": ("K1/K5", "spmm_tiles", "launches"),
    "K1-bf16": ("K1/K5", "spmm_tiles", "bf16_launches"),
    "K5": ("K1/K5", "spmm_tiles", "mask_launches"),
    "K5-bf16": ("K1/K5", "spmm_tiles", "bf16_mask_launches"),
    "pack": ("pack", "row_pack", "launches"),
    "pack-into": ("pack", "row_pack_into", "launches"),
    "K6": ("pack", "row_shuffle", "launches"),
}

# collective labels: ``all_to_all`` (one ``all_to_all_single``),
# ``isend_irecv`` (one ring round's ``batch_isend_irecv``), ``loopback``
# (a ring round to the rank itself: a device copy), ``wait`` (an
# exchange's works waited on), and the group's reductions, gathers and
# broadcasts (``grad_all_reduce``: the trainer's per-parameter sum)
COLLECTIVE_LABELS = ("all_to_all", "isend_irecv", "loopback", "wait",
                     "all_reduce_sum", "all_reduce_max", "grad_all_reduce",
                     "all_gather", "broadcast")

_DTYPES = {"torch.float32": "f32", "torch.bfloat16": "bf16",
           "torch.float64": "f64", "torch.float16": "f16",
           "torch.int8": "i8", "torch.int32": "i32", "torch.int64": "i64",
           "torch.uint8": "u8", "torch.bool": "bool"}


class Record(NamedTuple):
    """One launch or collective: ``kind`` (``'launch'`` or
    ``'collective'``), its label, the output (launch) or operand
    (collective) shape and dtype, and the device type."""

    kind: str
    label: str
    shape: tuple
    dtype: str
    device: str


def dtype_short(dtype) -> str:
    """``torch.float32`` → ``'f32'``, ``torch.bfloat16`` → ``'bf16'``…"""
    return _DTYPES.get(str(dtype), str(dtype))


_ACTIVE: list | None = None
_TALLY: Counter | None = None
_PLAIN = 0          # depth of plain versions running inside a recording


def active() -> bool:
    """Whether a ``recording()`` or a ``tally()`` block is open."""
    return _ACTIVE is not None or _TALLY is not None


def in_plain() -> bool:
    """Whether a kernel's plain version is running (``plain``): its own
    host arithmetic stands in for a launch and is not the step's."""
    return _PLAIN > 0


@contextlib.contextmanager
def plain(inner=None):
    """Mark a plain version's run (``utils/backend.py::plain_region``),
    entering ``inner`` (the profiler's region) if given."""
    global _PLAIN
    _PLAIN += 1
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _PLAIN -= 1


def _append(kind, label, shape, dtype, device) -> None:
    _ACTIVE.append(Record(kind, label, tuple(int(x) for x in shape),
                          dtype_short(dtype), str(device.type)))


def launch(label: str, shape, dtype, device) -> None:
    """One kernel launch (or its plain version): its output ``shape``, the
    ``dtype`` the census files it under and the ``device`` it runs on."""
    if _ACTIVE is None and _TALLY is None:
        return
    if label not in LAUNCH_LABELS:
        raise ValueError(f"census: unknown kernel launch {label!r} (known: "
                         f"{sorted(LAUNCH_LABELS)})")
    if _TALLY is not None:
        _TALLY[label] += 1
    if _ACTIVE is not None:
        _append("launch", label, shape, dtype, device)


def collective(label: str, t=None) -> None:
    """One collective issued on ``t`` (its send operand; ``None`` for a
    wait)."""
    if _ACTIVE is None:
        return
    if label not in COLLECTIVE_LABELS:
        raise ValueError(f"census: unknown collective {label!r} (known: "
                         f"{list(COLLECTIVE_LABELS)})")
    if t is None:
        _ACTIVE.append(Record("collective", label, (), "", ""))
    else:
        _append("collective", label, t.shape, t.dtype, t.device)


@contextlib.contextmanager
def tally():
    """Count every launch by label inside the block (recordings inside it
    record as usual); yields the ``Counter``.  The census holds it against
    a profiler window over the same block."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("census: a tally is already open")
    _TALLY = out = Counter()
    try:
        yield out
    finally:
        _TALLY = None


@contextlib.contextmanager
def recording():
    """Record every hook call inside the block; yields the list.  Blocks
    do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("census: a recording is already open")
    _ACTIVE = out = []
    try:
        yield out
    finally:
        _ACTIVE = None
