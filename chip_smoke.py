#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for ``sm_90a``), the
CUDA toolkit (``nvcc``) and the repository checkout around this file.  It
imports nothing of JAX or of the JAX package.  Phases, in order; any
failure raises and the script exits non-zero:

  0. print the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, and build every kernel from ``sgcn_tpu_torch/csrc``
     (one ``nvcc`` per source, started together), with its build time and
     the tile kernel's ``-Xptxas -v`` report (registers, shared memory,
     spills per instantiation);
  1. the tile SpMM kernel (K1) against its plain PyTorch version on the
     card, on random tiles from a numpy seed — one launch over a family
     of 4 classes with a hub row of 1100 slots, an all-pad tile, a
     pad-heavy class, pads and empty rows — at f ∈ {1, 7, 8, 16, 17, 40,
     41, 128, 129}, on a 16-byte aligned table and on a view whose base
     is 4-byte but not 16-byte aligned: bit-identical to the plain version
     and between two launches.  Times the kernel, the plain version and
     the ``torch.sparse.mm`` yardstick with CUDA events at f ∈ {16, 40,
     128}, and prints the kernel's bound for the same work; then (1b) the
     stacked row pack against its plain version at 1, 2, 7, 41, 65 and
     128 words a row, float32 → float32, float32 → bf16 (±inf, NaN and
     rounding ties, NaN bits included) and bf16 → bf16, on aligned and
     4-byte-only aligned bases, and the fused local + remote entry
     against its plain version on phase 1's tiles and a second random
     family, h and the remote table float32/float32, float32/bf16 and
     bf16/bf16, on unaligned tables and with inf/NaN in the pads' row;
  2. the serving main path on real data: cora2708 (k = 8 hp parts), GCN
     1433 → 16 → 7 with ReLU, Glorot weights from a numpy seed carried by
     ``params_from_jax``, 128 synthetic queries through ``ServeEngine`` and
     ``run_loadgen`` on the card.  Every served row is checked against a
     float64 scipy forward ``act(Â·X·W…)`` (rtol 1e-4, atol 1e-5), and the
     launch counts must be exactly forwards × layers: one row pack (the
     exchange) and one fused tile launch (local pass, halo pass and their
     sum) per aggregation; then device time vs wall over 5 batches under
     ``torch.profiler`` (the device's idle share);
  3. the same at the flagship width: Erdős–Rényi n = 169343, average
     degree 14, features N(0, 1), k = 8 balanced random parts, GCN 128 →
     128 → 128 → 40; 512 closed-loop queries, 256 served rows checked
     against the float64 forward; p50/p99 latency, QPS, the per-layer
     kernel time, a per-stage breakdown of one forward, the idle share,
     K1 held against its plain version on this layer's real tiles, the
     pack and the fused entry on this layer's real exchange, and the
     whole K3 op (pack + fused launch) timed against its bound, its plain
     version and ``torch.index_select`` + ``torch.sparse.mm``;
  4. training on real data: ``python -m sgcn_tpu_torch.train``'s ``main``
     in-process on the card, cora2708 (k = 8 hp), GCN 1433 → 16 → 7,
     ``--experiment accuracy --epochs 60``: the dense oracle above 0.75
     test accuracy and the partitioned trainer within 0.03 of it (the JAX
     package's own bands), and the kernel's launch count exact;
  5. training at the flagship width: phase 3's graph, features and plan,
     labels uniform in [0, 40), every row in the train mask; 1 warm-up
     and 5 timed steps of ``FullBatchTrainer.fit``.  The step-1 weight
     gradients are held against a float64 scipy backprop of the same
     loss with the run's ReLU masks (relative Frobenius error ≤ 1e-5 per
     layer; see ``GRAD_RTOL``), the initial loss against its float64
     value (rtol 1e-5), and the largest halo class alone is timed (the
     unit the per-class dispatch launched) beside the halo family's one
     launch; every loss must be finite, the kernel's launches must equal
     steps × (forward passes + the backward passes autograd really runs)
     (one pack and one fused launch each), and the kernels on this run's
     real gradient tables must equal their plain versions bit for bit.
     Prints ``epoch_s``, a per-step breakdown (forward, backward,
     optimizer) from CUDA events, the idle share over 3 steps under
     ``torch.profiler``, and the backward layer's whole-op time, bound
     and library time on the same gradient;
  6. K5, the kernel's int8-mask entry point (the GAT attention pass), on
     phase 1's tiles as 0/1 masks at phase 1's widths and tables:
     bit-identical to its plain version, to K1 on the upcast mask and
     between two launches; timed as phase 1 at f ∈ {1, 41, 128};
  7. serving GAT (no activation between layers): cora2708 8-hp 1433 → 16
     → 7 and phase 3's graph, features and plan at 128 → 128 → 128 → 40
     (split, split, fused table forms).  Served rows against a float64
     host GAT (``gat64``: ``torch.sparse.softmax`` of z1_i + z2_j over
     Â's pattern) within rtol 1e-4 / atol 1e-5, exact mask-kernel
     launches, p50/p99, QPS, a per-stage breakdown of one flagship forward
     and the idle share;
  8. training GAT at the flagship width, 1 warm-up + 5 timed steps: step-1
     gradients of ``w`` and ``a2`` within 1e-5 (relative Frobenius, per
     layer) of ``gat64``'s float64 autograd, ``a1``'s exactly 0, finite
     losses, exact launches (every layer runs its backward passes), the
     kernel on this run's real forward and backward tables == plain, and
     its times at the flagship layer; ``epoch_s``, the step breakdown and
     the idle share;
  9. training cora2708 GAT through the CLI's ``main`` in-process
     (``--model gat``, 5 steps): the losses track the dense GAT oracle
     from the same seed on the card within 1e-4 relative, exact launches;
  10. K4 serving: ragged ``ServeEngine``s (``comm_schedule='ragged'``)
     for GCN and GAT on phase 3's plan, features and weights — every
     served row and the whole forward ``torch.equal`` to the a2a engines'
     of phases 3 and 7, exact launches, p50/p99, QPS, the per-stage
     breakdown with the ring's exchange beside the a2a's, the idle share;
     K1 on the real ring table and K5 on every real ring table of a
     served GAT forward == plain, and the whole K4 op (ring pack + fused
     launch) timed as phase 3 times K3;
  11. K4 training: GCN and GAT on the ring from phases 5 and 8's initial
     weights, 1 warm-up + 5 timed steps: losses and weights after ``fit``
     ``torch.equal`` to the a2a runs', exact launches (forward and
     backward through ``PspmmTilesRagged``), ``epoch_s``, the step
     breakdown, the idle share, K1 on the real ring gradient table and K5
     on every ring table of a training step == plain;
  12. cora2708 8-hp through the train CLI with ``--comm-schedule auto``:
     it resolves to the ring (padding efficiency 0.311 < 0.5) and its
     losses equal the ``--comm-schedule a2a`` run's, GCN and GAT, exact
     launches; then each transport's ``epoch_s`` over 3 CLI runs of 3
     warm-up + 20 timed steps, interleaved;
  13. K6, the row-shuffle kernel, vs its plain version at S = 2048 and
     f ∈ {1, 41, 128} (bit-identical, two launches equal), then
     ``python -m sgcn_tpu_torch.tools.spmm_micro``'s ``main`` at its
     defaults (this card's stream, gather and matmul ceilings), and K6's
     device time per call against its bound and
     ``torch.take_along_dim``;
  14. K1 and K5 on bf16 tables (the kernel's bf16 entry points) vs their
     plain version on phase 1's tiles at f ∈ {1, 7, 8, 16, 17, 40, 41,
     128, 129}: on an 8-byte aligned table, on a view whose base is
     2-byte but not 8-byte aligned, and with inf and NaN in the row the
     pads read — bit-identical (NaN where the plain version has NaN) and
     between two launches; K1-bf16 timed at f ∈ {16, 128} against its
     bound (2 bytes a table value) and ``torch.sparse.mm`` on a bf16 CSR
     where this torch has one;
  15. the flagship GCN of phase 5 under ``halo_dtype='bfloat16'`` and
     ``compute_dtype='bfloat16'``, each on both transports from phase 5's
     initial weights: ragged == a2a bit for bit (losses and weights after
     ``fit``), the 5 losses within the reference's bf16 band (rtol 0.05 /
     atol 0.02) of phase 5's float32 losses and not equal to them, exact
     launches per entry point (the fused entry's bf16-wire flavor under
     ``halo_dtype``, its bf16 one under ``compute_dtype``); ``epoch_s``,
     the step breakdown and the profiler's split (fused, K1/K5, pack,
     gathers, copies, roll, cat, matmul, idle); K1 and the fused entry on
     the compute run's real bf16 forward and gradient tables == plain,
     their times and the whole op's at the flagship layer, and the pack
     and fused entry on the bf16 wire;
  16. flagship GCN serving with ``halo_dtype='bfloat16'`` on both
     transports: served rows within rtol 5e-3 / atol 5e-3 of the float64
     forward, ring == a2a bit for bit, exact launches, p50/p99 and QPS
     beside the float32 engines';
  17. the flagship GAT of phase 8 under ``compute_dtype='bfloat16'`` (every
     layer packed) on both transports: ragged == a2a bit for bit, losses
     within the reference's GAT bf16 band (rtol 0.05 / atol 0.03) of phase
     8's and not equal, exact launches per entry point, the step
     breakdown and split, K5 on every real table of a step == plain; then
     cora2708 GAT ``--dtype bfloat16`` through the train CLI (the odd
     width 7 takes the fused bf16 table) against phase 9's losses;
  18. the row pack and the fused entry against their plain versions on
     every exchange and aggregation one flagship training pass (forward
     and backward) makes, GCN and GAT, both transports;
  19. serving on the directed flagship graph (an asymmetric Â): 14·n
     ordered pairs from ``default_rng(0)``, self pairs dropped,
     ``normalize_adjacency``, phase 3's features and parts, GCN and GAT
     128 → 128 → 128 → 40; 512 closed-loop queries at batch 64, 256
     served rows against the float64 forward with Â (phase 3's and 7's
     gates), exact launches, p50/p99/QPS, the idle share;
  20. training there, GCN and GAT, 1 warm-up + 5 timed steps: step-1
     gradients within 1e-5 (relative Frobenius, per layer) of a float64
     backprop with Âᵀ (GCN, with the run's ReLU masks) or of float64
     autograd (GAT ``w``/``a2``; ``a1``'s exactly 0), exact launches (a
     forward aggregation: one pack, one fused launch; a backward one:
     one K1 family launch of the halo rows' transpose, one reverse pack,
     one fused launch; GAT the K5 passes of each form, then per exchanged
     table one K5 pass, one pack, one fused launch), every family launch,
     pack and fused launch of one training pass == plain bit for bit on
     its real inputs, ``epoch_s``, the step breakdown and the profiler's
     split; one backward aggregation at the layer-0 table (f = 128) timed
     whole and by step against its byte bound, its plain version and
     ``torch.sparse.mm`` + ``torch.index_select`` + ``torch.sparse.mm``;
  21. the directed GCN of phase 20 under ``halo_dtype`` and
     ``compute_dtype``: losses in the reference's bf16 band of the
     float32 run and not equal to it, exact launches per entry, every
     launch of one pass == plain;
  22. the same training repeated in one process
     (``tools/repeat_run.py::repeat_training``, fresh trainers from one
     start): cora2708 GAT a2a (phase 9's run) 20 times, the directed
     flagship GCN and GAT 3 times each — exactly one loss history and one
     weight digest each;
  23. checkpoints at the flagship width (phase 3's graph, features and
     parts, phase 5's labels; GCN a2a and ring, GAT a2a, 128 → 128 → 128
     → 40, float32, 6 steps from the train CLI's seed 0): per run a child
     process (``torch.multiprocessing``, ``spawn``; four at once) runs the
     train CLI with ``--checkpoint-every 3`` under
     ``SGCN_FAULT=kill-after-save:3`` and must exit 43, and one more GCN
     a2a child runs ``--checkpoint-every 2`` under
     ``corrupt-after-save:4:bitflip``; then a new child per run resumes
     with ``--resume auto`` to 6 steps (the corrupt one must fall back to
     step 2 with a warning).  Their losses and the digest of their final
     weights and Adam state must equal the same runs trained here
     uninterrupted, bit for bit.  ``ServeEngine(checkpoint=…)`` on the
     step-6 files (GCN and GAT) serves the trainer's ``predict`` rows bit
     for bit and within rtol 1e-4 / atol 1e-5 of the float64 forward; a
     file under another part vector or other widths is refused with the
     reference's message; one ``poll`` of a watched directory hot-swaps
     the newest file into a random-weight engine (rows move to the
     trainer's, ``weights_rev`` + 1, every parameter keeps its storage)
     and skips a corrupt newest file.  Prints the checkpoint's bytes and
     its save and load ms, each child's start-up against its training
     seconds, and the poll + swap ms, beside the card's name and power
     limit.  The children's inputs come from an ``.npz`` written under
     ``build/chip_smoke_ckpt/``, and every child is stopped when the
     phase ends;
  24. one JSON line ``{"kernels": [...]}`` — per ported kernel (the tile
     SpMM, the GCN aggregation's backward, the GAT attention pass and its
     use in the GAT layer's backward, the ragged ring aggregation and its
     backward, the row shuffle, the tile SpMM's and the GAT pass's bf16
     flavors, the row pack and the fused local + remote entry) its
     launches on the main path (phases 2–5, 7–13, 15–17, 19–21 and 23,
     the resumed children's included), max
     |kernel − plain|, kernel / plain / bound / library times at the
     flagship layer.  The tile SpMM's own float-weight family entries
     (both tables) launch on the main path only in the asymmetric
     backward (phases 20–21): the symmetric phases must show 0 of them —
     the fused entry runs their chains and counts those launches — and any
     kernel with no launch on the main path fails the run;
  25. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, the script
prints no result and exits with code 2 or 3.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 outside the tensor cores — the K1 bound's two rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the flagship graph's vertex count (bench.py's ER shape, ogbn-arxiv's n)
FLAGSHIP_N = 169343

RTOL, ATOL = 1e-4, 1e-5          # served logits vs the float64 forward
# step-1 weight gradients vs a float64 backprop that uses the float32
# run's ReLU masks: relative Frobenius error per layer.  Float32 rounding
# gives ~2.6e-7 here; with float64's own masks, one pre-activation within
# rounding of 0 at the flagship flips sign and moves the earlier layers'
# gradients by up to ~1e-4 relative — a different function, not an error
GRAD_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- K1 helpers
def random_class_tiles(rng, k, classes, tb, n):
    """Flat (k, Σ t_c·e_c) tile arrays over the given (t_c, e_c) classes:
    per tile a random count of dst-sorted real edges over the first 3/4
    of the rows (the last quarter and some whole tiles stay empty), pads
    of weight 0 at dst tb-1.  The kernel's edge cases: the first tile of
    the first class is full (the hub tile), and in part 0 1100 of its
    slots are one row's (a hub row); the first tile of the second class
    is all pads; the last class is pad-heavy (at most 8 real slots per
    tile, the rest pads on row tb-1, reading row 0 in even parts and mixed
    rows in odd parts)."""
    import numpy as np

    flats = [[], [], []]
    for ci, (t, e) in enumerate(classes):
        src = np.zeros((k, t, e), np.int32)
        ld = np.full((k, t, e), tb - 1, np.int32)
        w = np.zeros((k, t, e), np.float32)
        for p in range(k):
            for i in range(t):
                c = (0 if (ci, i) == (1, 0) else
                     int(rng.integers(0, 9)) if ci == len(classes) - 1 else
                     e if (ci, i) == (0, 0) else int(rng.integers(0, e + 1)))
                rows = rng.integers(0, 3 * tb // 4, c)
                if (ci, i, p) == (0, 0, 0):
                    rows[:1100] = 5
                src[p, i, :c] = rng.integers(0, n, c)
                ld[p, i, :c] = np.sort(rows)
                w[p, i, :c] = rng.standard_normal(c)
                if ci == len(classes) - 1 and p % 2:
                    src[p, i, c:] = rng.integers(0, n, e - c)
        for j, a in enumerate((src, ld, w)):
            flats[j].append(a.reshape(k, -1))
    return tuple(np.concatenate(f, axis=1) for f in flats)


def unaligned_copy(table):
    """The same rows in a view whose base is aligned to one value (4 bytes
    for float32, 2 for bf16) but not to a 4-value vector (16 or 8 bytes):
    the kernel's one-value-per-lane path."""
    import torch

    odd = torch.empty(table.numel() + 1, dtype=table.dtype,
                      device=table.device)[1:].view(table.shape)
    odd.copy_(table)
    if odd.data_ptr() % (4 * table.element_size()) == 0:
        raise AssertionError("the unaligned view is vector-aligned")
    return odd


def ptxas_report(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its template
    arguments where it has them, registers, shared memory and spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            # the mangled name spells each identifier as <length><name>
            for c in re.finditer(r"(\d+)([A-Za-z_])", name):
                base = name[c.start(2): c.start(2) + int(c.group(1))]
                if base.endswith("_kernel"):
                    t = re.match(r"I(f|a|13__nv_bfloat16)(f|13__nv_bfloat16"
                                 r"|S\d*_)Li(\d+)ELi(\d+)ELi(\d+)E",
                                 name[c.start(2) + len(base):])
                    kinds = {"f": "float", "a": "int8",
                             "13__nv_bfloat16": "bf16"}
                    if t:
                        a, b = kinds[t.group(1)], kinds.get(t.group(2), "")
                        name = base + (
                            f"<{a}, {b or a}, VEC={t.group(3)}, "
                            f"G={t.group(4)}, NV={t.group(5)}>")
                    else:
                        m2 = re.match(r"I(\w+?)EEv",
                                      name[c.start(2) + len(base):])
                        name = base + (f"<{m2.group(1)}>" if m2 else "")
                    break
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {m.group(2)} B "
                         f"smem, {spill}")
            name = None
    return lines


def k1_work(flat_src, flat_w, k, n, f, out_rows, itemsize=4):
    """Bytes and flops the K1 call needs on these inputs: every stored
    slot's (src, ld, w) read once — 12 bytes, 9 with int8 mask weights
    (K5) — each DISTINCT referenced table row read once (``itemsize``
    bytes a value: 4 for float32, 2 for bf16), the float32 output written
    once; 2 flops (multiply, add) per real edge and column."""
    import numpy as np

    src = np.asarray(flat_src, np.int64)
    w = np.asarray(flat_w)
    real = w != 0
    parts = np.broadcast_to(np.arange(k)[:, None], src.shape)
    rows = np.unique(parts[real] * n + src[real]).size
    nbytes = (src.size * (8 + w.itemsize) + rows * f * itemsize
              + out_rows * f * 4)
    flops = 2 * int(real.sum()) * f
    return nbytes, flops


def k1_bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_spmm(flat_src, flat_ld, flat_w, classes, k, n, tb, device,
                 dtype=None):
    """``torch.sparse.mm`` of a CSR holding the same real edges as the
    tile arrays, shaped so ``csr @ table.reshape(k*n, f)`` is the K1
    output — the library yardstick, timed here and used nowhere in the
    port.  ``dtype``: the CSR's values (the table's dtype; float32 by
    default)."""
    import numpy as np
    import torch

    rows, cols, vals = [], [], []
    off = row0 = 0
    t_all = sum(t for t, _e, *_ in classes)
    for t, e, *_ in classes:
        s = flat_src[:, off: off + t * e].reshape(k, t, e).astype(np.int64)
        d = flat_ld[:, off: off + t * e].reshape(k, t, e).astype(np.int64)
        w = flat_w[:, off: off + t * e].reshape(k, t, e)
        real = w != 0
        pk, ti, _ = np.nonzero(real)
        rows.append(pk * t_all * tb + (row0 + ti) * tb + d[real])
        cols.append(pk * n + s[real])
        vals.append(w[real].astype(np.float32))
        off += t * e
        row0 += t
    idx = torch.as_tensor(np.stack([np.concatenate(rows),
                                    np.concatenate(cols)]))
    coo = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)).to(dtype or torch.float32),
        (k * t_all * tb, k * n), device=device)
    return coo.coalesce().to_sparse_csr()


def same_bits(a, b, nan_ok=False):
    """``torch.equal``; with ``nan_ok``, NaN in the same places and equal
    bits everywhere else."""
    import torch

    if not nan_ok:
        return torch.equal(a, b)
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def check_k1(tiles, table, classes, tb, what, nan_ok=False):
    """Kernel vs plain on the card: bit identity and two-launch
    determinism (``nan_ok``: NaN where the plain version has NaN, the
    same bits elsewhere).  Returns the max |kernel − plain| over the
    entries where the plain version is finite (0.0 when identical)."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_classes_plain)

    one = spmm_tiles_classes(*tiles, table, classes, tb)
    two = spmm_tiles_classes(*tiles, table, classes, tb)
    plain = spmm_tiles_classes_plain(*tiles, table, classes, tb)
    torch.cuda.synchronize()
    fin = torch.isfinite(plain)
    diff = float((one[fin] - plain[fin]).abs().max())
    relaunch = same_bits(one, two, nan_ok)
    log(f"  {what}: max |kernel - plain| = {diff!r}  "
        f"(relaunch identical: {relaunch}"
        + (f"; NaN entries {int(torch.isnan(plain).sum())}, in the same "
           f"places: {torch.equal(torch.isnan(one), torch.isnan(plain))}"
           if nan_ok else "") + ")")
    if not relaunch:
        raise AssertionError(f"{what}: two launches differ")
    if not same_bits(one, plain, nan_ok):
        raise AssertionError(f"{what}: kernel != plain version "
                             f"(max diff {diff})")
    return diff


def time_k1(tiles_np, tiles, table, classes, tb, n, what, plain_reps=3):
    """Kernel, plain and library times (CUDA events) and the bound."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_classes_plain)

    k, f = table.shape[0], table.shape[2]
    t_all = sum(t for t, _e, *_ in classes)
    ms = cuda_ms(lambda: spmm_tiles_classes(*tiles, table, classes, tb))
    plain_ms = cuda_ms(lambda: spmm_tiles_classes_plain(
        *tiles, table, classes, tb), reps=plain_reps, warmup=1)
    dense = table.reshape(k * n, f)
    try:
        # on a bf16 table, a bf16 CSR: where this torch has no CUDA kernel
        # for it, there is no library call to time
        csr = library_spmm(*tiles_np, classes, k, n, tb, table.device,
                           dtype=table.dtype)
        lib_out = torch.sparse.mm(csr, dense)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, dense))
    except (RuntimeError, NotImplementedError) as e:
        if table.dtype == torch.float32:
            raise
        log(f"  {what}: torch.sparse.mm on a {table.dtype} CSR is not "
            f"available here ({str(e).splitlines()[0][:120]}): no library "
            "call")
        lib_out, library_ms = None, None
    kern_out = spmm_tiles_classes(*tiles, table, classes, tb).reshape(-1, f)
    lib_diff = (float((lib_out.float() - kern_out).abs().max())
                if lib_out is not None else float("nan"))
    nbytes, flops = k1_work(tiles_np[0], tiles_np[2], k, n, f, k * t_all * tb,
                            itemsize=table.element_size())
    bound_ms, bound_by = k1_bound_ms(nbytes, flops)
    log(f"  {what}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.sparse.mm {library_ms!r} ms (|lib - kernel| {lib_diff:.3g}), "
        f"bound {bound_ms!r} ms by {bound_by} ({nbytes} B, {flops} flop), "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


# ------------------------------------------- the pack and the fused entry
def check_pack(src, flat, dtype, what):
    """The row pack vs its plain version on the card, on the same inputs:
    bit for bit (NaN where the plain version has NaN), and two launches
    the same.  Returns 0.0 (a copy or one rounding: no error to report
    when they agree)."""
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_plain

    one, two = row_pack(src, flat, dtype), row_pack(src, flat, dtype)
    plain = row_pack_plain(src, flat, dtype)
    torch.cuda.synchronize()
    ok = same_bits(one, plain, nan_ok=True) and same_bits(one, two, True)
    # NaN's own bits: the card's cast and the kernel's store agree on them
    nan = torch.isnan(plain)
    if ok and nan.any() and plain.dtype == torch.bfloat16:
        ok = torch.equal(one[nan].view(torch.int16),
                         plain[nan].view(torch.int16))
    if not ok:
        raise AssertionError(f"{what}: row pack != plain version")
    return 0.0


def check_fused(ltiles, h, htiles, remote, lcls, hcls, tb, what):
    """The fused entry vs its plain version (two plain family passes,
    slices, add, cast: torch arithmetic, no kernel) on the card: bit for
    bit (NaN in the same places,
    with the same bits), and two launches the same.  Returns the max
    |kernel − plain| over the finite entries."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_fused,
                                              spmm_tiles_fused_plain)

    one = spmm_tiles_fused(ltiles, h, htiles, remote, lcls, hcls, tb)
    two = spmm_tiles_fused(ltiles, h, htiles, remote, lcls, hcls, tb)
    plain = spmm_tiles_fused_plain(ltiles, h, htiles, remote, lcls, hcls,
                                   tb)
    torch.cuda.synchronize()
    fin = torch.isfinite(plain)
    diff = float((one[fin].float() - plain[fin].float()).abs().max()) \
        if fin.any() else 0.0
    nan = torch.isnan(plain)
    bits = torch.int16 if plain.dtype == torch.bfloat16 else torch.int32
    ok = (same_bits(one, plain, nan_ok=True) and same_bits(one, two, True)
          and torch.equal(one[nan].view(bits), plain[nan].view(bits)))
    log(f"  {what}: max |fused - plain| = {diff!r} (relaunch identical, "
        f"NaN {int(nan.sum())} with the same bits: {ok})")
    if not ok:
        raise AssertionError(f"{what}: fused entry != plain version")
    return diff


def pack_work(src, flat, dtype):
    """Bytes the pack needs on these inputs: each distinct referenced
    source row read once, the index read once, the output written once
    (it does no arithmetic)."""
    import numpy as np
    import torch

    w = src[0, 0].numel()
    rows = np.unique(flat.cpu().numpy()).size
    return (rows * w * src.element_size() + flat.numel() * 4
            + flat.numel() * w * torch.empty((), dtype=dtype).element_size())


def time_pack(src, flat, dtype, what):
    """The pack's time (CUDA events), its plain version's, the library
    yardstick's (``torch.index_select`` of the same rows: one PyTorch
    call; None when the pack also casts) and the bound."""
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_plain

    ms = cuda_ms(lambda: row_pack(src, flat, dtype))
    plain_ms = cuda_ms(lambda: row_pack_plain(src, flat, dtype), reps=5)
    library_ms = None
    if dtype == src.dtype:
        flat2d = src.reshape(src.shape[0] * src.shape[1], -1)
        idx = flat.reshape(-1).long()
        library_ms = cuda_ms(lambda: torch.index_select(flat2d, 0, idx))
    nbytes = pack_work(src, flat, dtype)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {what}: pack {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.index_select {library_ms!r} ms, bound {bound_ms!r} ms by "
        f"bytes ({nbytes} B), {100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}


def fused_work(ltiles, h, htiles, remote):
    """Bytes and flops of the fused launch on these inputs: both
    families' K1 work (``k1_work``, no float32 output) and the (k, b, f)
    output written once in h's dtype."""
    k, b, f = h.shape
    lb, lf = k1_work(ltiles[0].cpu().numpy(), ltiles[2].cpu().numpy(), k,
                     h.shape[1], f, 0, itemsize=h.element_size())
    hb, hf = k1_work(htiles[0].cpu().numpy(), htiles[2].cpu().numpy(), k,
                     remote.shape[1], f, 0, itemsize=remote.element_size())
    return lb + hb + k * b * f * h.element_size(), lf + hf + k * b * f


def library_fused(ltiles, h, htiles, remote, lcls, hcls, tb):
    """The fused launch's library yardstick: ``torch.sparse.mm`` of one
    CSR holding both families' real edges over the stacked ``[h; remote]``
    rows (the concatenation is set-up, outside the timed call), sliced
    to the owned rows by the CSR's own row count.  Returns (csr, dense)
    or None where the tables' dtypes differ."""
    import numpy as np
    import torch

    if h.dtype != remote.dtype:
        return None
    k, b, f = h.shape
    nl, nh = h.shape[1], remote.shape[1]
    rows, cols, vals = [], [], []
    for tiles, cls, base, n in ((ltiles, lcls, 0, nl),
                                (htiles, hcls, k * nl, nh)):
        src, ld, w = (t.cpu().numpy() for t in tiles)
        off = row0 = 0
        for t, e, *_ in cls:
            sl = slice(off, off + t * e)
            s_ = src[:, sl].reshape(k, t, e).astype(np.int64)
            d_ = ld[:, sl].reshape(k, t, e).astype(np.int64)
            w_ = w[:, sl].reshape(k, t, e)
            real = w_ != 0
            pk, ti, _ = np.nonzero(real)
            r = (row0 + ti) * tb + d_[real]
            keep = r < b
            rows.append((pk * b + r)[keep])
            cols.append((base + pk * n + s_[real])[keep])
            vals.append(w_[real][keep].astype(np.float32))
            off += t * e
            row0 += t
    idx = torch.as_tensor(np.stack([np.concatenate(rows),
                                    np.concatenate(cols)]))
    csr = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)).to(h.dtype),
        (k * b, k * (nl + nh)), device=h.device).coalesce().to_sparse_csr()
    dense = torch.cat([h.reshape(k * nl, f), remote.reshape(k * nh, f)])
    return csr, dense


def time_fused(ltiles, h, htiles, remote, lcls, hcls, tb, what):
    """The fused launch's time, its plain version's (one call: it takes
    seconds at the flagship), the library yardstick's (``library_fused``)
    and the bound."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_fused,
                                              spmm_tiles_fused_plain)

    args = (ltiles, h, htiles, remote, lcls, hcls, tb)
    ms = cuda_ms(lambda: spmm_tiles_fused(*args))
    plain_ms = cuda_ms(lambda: spmm_tiles_fused_plain(*args), reps=1,
                       warmup=0)
    lib = library_fused(*args)
    try:
        library_ms = (cuda_ms(lambda: torch.sparse.mm(*lib))
                      if lib is not None else None)
    except (RuntimeError, NotImplementedError) as e:
        # a bf16 CSR where this torch has no kernel for it: no library call
        if h.dtype == torch.float32:
            raise
        log(f"  {what}: torch.sparse.mm on a {h.dtype} CSR is not "
            f"available here ({str(e).splitlines()[0][:120]})")
        library_ms = None
    nbytes, flops = fused_work(ltiles, h, htiles, remote)
    bound_ms, bound_by = k1_bound_ms(nbytes, flops)
    log(f"  {what}: fused {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.sparse.mm {library_ms!r} ms, bound {bound_ms!r} ms by "
        f"{bound_by} ({nbytes} B, {flops} flop), {100 * bound_ms / ms:.1f}% "
        "of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def time_whole_op(h, pa, st, tb, ragged, what):
    """One GCN aggregation (K3, or K4 on the ring) at this table: the
    whole op (exchange pack + fused launch), each part alone, the plain
    version (torch indexing + the plain family passes, add and cast), the
    library yardsticks summed, and the whole op's bound (the pack's bytes
    plus the fused launch's)."""
    import torch

    from sgcn_tpu_torch.ops.pspmm import exchange_recv, ring_concat
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_plain
    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_ragged,
                                              pspmm_tiles_sym,
                                              spmm_tiles_fused_plain)

    lt = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    if ragged:
        flat = pa["ring_src"]
        remote = ring_concat(h, flat, st["rr_sizes"])
        ht = [pa["ptile_hrsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    else:
        flat = pa["recv_src"]
        remote = exchange_recv(h, flat)
        ht = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    static = (tb, st["pallas_lclasses"], st["pallas_hclasses"])
    pack = time_pack(h, flat, h.dtype, f"{what} exchange")
    fused = time_fused(lt, h, ht, remote, st["pallas_lclasses"],
                       st["pallas_hclasses"], tb, f"{what} fused launch")
    with torch.inference_mode():
        if ragged:
            op = cuda_ms(lambda: pspmm_tiles_ragged(
                h, flat, *lt, *ht, *static, st["rr_sizes"]))
        else:
            op = cuda_ms(lambda: pspmm_tiles_sym(h, flat, *lt, *ht, *static))
    plain = cuda_ms(lambda: spmm_tiles_fused_plain(
        lt, h, ht, row_pack_plain(h, flat), *static[1:], tb), reps=1,
        warmup=0)
    bound = (pack["bytes"] + fused["bytes"]) / HBM_BYTES_PER_S * 1e3
    lib = (None if pack["library_ms"] is None or fused["library_ms"] is None
           else pack["library_ms"] + fused["library_ms"])
    log(f"  {what}: whole op {op!r} ms (exchange {pack['ms']!r} + fused "
        f"{fused['ms']!r}); bound {bound!r} ms by bytes, "
        f"{100 * bound / op:.1f}% of bound; plain {plain!r} ms; library "
        f"(index_select + sparse.mm) {lib!r} ms")
    return {"ms": op, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": "bytes", "pack": pack,
            "fused": fused}


PACK_WIDTHS = (1, 2, 7, 41, 65, 128)
FUSED_DTYPES = (("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "bfloat16"))


def special_rows(x):
    """Writes ±inf, NaN and float32 values at bf16 rounding ties (1 +
    2⁻⁸ rounds down to 1, 1 + 3·2⁻⁸ up to 1 + 2⁻⁶: nearest even) into
    the first rows of ``x`` (k, rows, ...) float32."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    vals = (float("inf"), -float("inf"), float("nan"), 1.0 + 2 ** -8,
            1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8))
    for i, v in enumerate(vals):
        flat[:, i % x.shape[1], i % flat.shape[2]] = v
    return x


def phase_pack_fused_random(rng, dev, tiles, classes, tb, n):
    """Phase 1's second half: the row pack at ``PACK_WIDTHS`` words on
    float32 → float32, float32 → bf16 (±inf, NaN, rounding ties) and bf16
    → bf16, on 16-byte aligned and 4-byte-only aligned (bf16: 2-byte)
    bases; then the fused entry on phase 1's tiles as the local family and
    a second random draw (its own Emax, the same tile counts) as the halo
    family, on each of ``FUSED_DTYPES`` at ``BF16_WIDTHS``, on unaligned
    tables, and with inf/NaN in the row the pads read.  Every launch ==
    plain bit for bit.  Returns the max |fused − plain|."""
    import numpy as np
    import torch

    k = tiles[0].shape[0]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    n_pack = 0
    for w in PACK_WIDTHS:
        base = torch.as_tensor(rng.standard_normal((k, 700, w)).astype(
            np.float32)).to(dev)
        special_rows(base)
        flat = torch.as_tensor(rng.integers(0, k * 700, (k, 900)).astype(
            np.int32)).to(dev)
        for sdt, odt in (("float32", "float32"), ("float32", "bfloat16"),
                         ("bfloat16", "bfloat16")):
            src = base.to(dt[sdt])
            for t_, how in ((src, ""), (unaligned_copy(src), " unaligned")):
                t_ = t_ if w > 1 else t_[..., 0]       # a (k, rows) table
                check_pack(t_, flat, dt[odt], f"pack w={w} {sdt}->{odt}{how}")
                n_pack += 1
    log(f"  row pack: {n_pack} cases == plain bit for bit (NaN bits "
        "included), relaunch identical")
    classes2 = tuple((t, max(8, e // 2)) for t, e, *_ in classes)
    htiles_np = random_class_tiles(rng, k, classes2, tb, n)
    htiles = [torch.as_tensor(a).to(dev) for a in htiles_np]
    err = 0.0
    for f in BF16_WIDTHS:
        h32 = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        r32 = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        for hd, rd in FUSED_DTYPES:
            h, r = h32.to(dt[hd]), r32.to(dt[rd])
            cases = [(h, r, "")]
            if f in (7, 40, 129):
                cases.append((unaligned_copy(h), unaligned_copy(r),
                              " unaligned"))
            if f in (1, 40, 129):
                hb, rb = h.clone(), r.clone()
                hb[:, 0, 0], rb[:, 0, -1] = float("inf"), float("nan")
                cases.append((hb, rb, " inf/NaN in the pads' row"))
            for h_, r_, how in cases:
                err = max(err, check_fused(
                    tiles, h_, htiles, r_, classes, classes2, tb,
                    f"fused f={f} h {hd} remote {rd}{how}"))
    return err


# ----------------------------------------------------------- serving path
def glorot_numpy(seed, dims):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.uniform(-np.sqrt(6.0 / (a + b)), np.sqrt(6.0 / (a + b)),
                        (a, b)).astype(np.float32) for a, b in dims]


def oracle_forward(ahat, feats, params):
    """Global float64 forward on the host: ReLU(Â·H·W) per layer, no
    activation after the last."""
    import numpy as np

    a = ahat.astype(np.float64)
    h = np.asarray(feats, np.float64)
    for i, w in enumerate(params):
        h = a @ (h @ np.asarray(w, np.float64))
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


class RecordingEngine:
    """Hands ``run_loadgen`` the engine's batcher and query path, keeping
    every served (qids, logits) pair for the oracle check."""

    def __init__(self, engine):
        self.engine = engine
        self.batcher = engine.batcher
        self.served = []

    def query(self, qids):
        out = self.engine.query(qids)
        self.served.append((list(qids), out))
        return out


def gat_params_numpy(seed, dims):
    """GAT params from a numpy seed: per layer ``w`` N(0, 2/(fin+fout)),
    ``a1``/``a2`` N(0, 1)/√fout (the reference's scales)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)))
             .astype(np.float32),
             "a1": (rng.standard_normal(b) / np.sqrt(b)).astype(np.float32),
             "a2": (rng.standard_normal(b) / np.sqrt(b)).astype(np.float32)}
            for a, b in dims]


def gat64(ahat, feats, params, labels=None):
    """Global float64 GAT on the host, written here apart from the port's
    code: per layer ``z = h·w``, the scores ``s_ij = z1_i + z2_j`` on Â's
    nonzero pattern, ``torch.sparse.softmax`` over each row, ``h = α·z``;
    no activation (PGAT).  Returns the (n, nout) logits, or with
    ``labels`` the mean softmax cross-entropy over every row and its
    gradients by torch autograd on the CPU (per layer ``{w, a1, a2}``).
    A check only: nothing else uses it."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    a = sp.csr_matrix(ahat, dtype=np.float64)
    a.eliminate_zeros()
    a.sort_indices()
    coo = a.tocoo()
    idx = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
    n = a.shape[0]
    grad = labels is not None
    ps = [{k: torch.tensor(np.asarray(v, np.float64), requires_grad=grad)
           for k, v in p.items()} for p in params]
    h = torch.as_tensor(np.asarray(feats, np.float64))
    with torch.set_grad_enabled(grad):
        for p in ps:
            z = h @ p["w"]
            s = (z @ p["a1"])[idx[0]] + (z @ p["a2"])[idx[1]]
            scores = torch.sparse_coo_tensor(idx, s, (n, n), is_coalesced=True,
                                             check_invariants=False)
            alpha = torch.sparse.softmax(scores, dim=1).to_sparse_csr()
            h = torch.sparse.mm(alpha, z)
        if not grad:
            return h.numpy()
        loss = torch.nn.functional.cross_entropy(
            h, torch.as_tensor(np.asarray(labels, np.int64)))
        leaves = [p[k] for p in ps for k in ("w", "a1", "a2")]
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [
        {k: grads[3 * i + j].numpy() for j, k in enumerate(("w", "a1", "a2"))}
        for i in range(len(ps))]


def gat_passes(widths):
    """Kernel passes per class of one GAT forward (or backward): 1 for a
    fused layer, 2 for a split one."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    return sum(1 if gat_table_form(w) == "fused" else 2 for w in widths)


# row-pack launches counted on the main path's runs (drive_serving and the
# training phases add theirs)
MAIN_PATH_PACKS = [0]

# launches of K1's own family entries (float32 weights, on float32 and bf16
# tables) made inside the symmetric main path's runs: the fused entry runs
# K1's two family chains since the K3/K4 redesign, GAT runs the mask
# entries, so these stay 0 (asserted); only the asymmetric backward
# launches them (phases 20-21, counted there)
MAIN_PATH_K1 = {"launches": 0, "bf16_launches": 0}
_K1_AT_OPEN = {}


def k1_open():
    """Marks the start of a main-path run for ``MAIN_PATH_K1``."""
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    _K1_AT_OPEN.update({c: getattr(spmm_tiles, c) for c in MAIN_PATH_K1})


def k1_close():
    """Adds the K1 family-entry launches since ``k1_open``."""
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    for c in MAIN_PATH_K1:
        MAIN_PATH_K1[c] += getattr(spmm_tiles, c) - _K1_AT_OPEN.pop(c)


def pack_launches(model, schedule, widths, compute_dtype=None):
    """Row-pack launches of one forward (or one backward) over these
    layer widths: GCN one per aggregation; GAT per layer on the ring one
    (one ``[p ‖ u]`` concat), on the a2a exchange two per exchanged table
    (the receive layout, then the halo rows): one table for the fused and
    packed forms, two for the split form."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    if model == "gcn" or schedule == "ragged":
        return len(widths)
    return sum(4 if gat_table_form(w, compute_dtype) == "split" else 2
               for w in widths)


def drive_serving(name, eng, queries, seed):
    """Drive the serving main path through ``eng``: warm every bucket, then
    ``queries`` synthetic closed-loop queries through ``run_loadgen``.  The
    launches — GCN: the fused tile entry (one per aggregation, on the
    float32 or the bf16-wire flavor); GAT: the int8-mask entry (one per
    pass) — and the row pack's are counted from 0 and must be exactly
    forwards × passes; the pack's are added to ``MAIN_PATH_PACKS``.
    Returns (recording engine, loadgen result, tile launches)."""
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles, spmm_tiles_fused
    from sgcn_tpu_torch.serve import run_loadgen, synthetic_query_ids

    st, widths = eng.setup.fwd_static, eng.widths
    if eng.setup.model == "gat":
        classes, owner, counter = (st["pallas_cclasses"], spmm_tiles,
                                   "mask_launches")
        passes = gat_passes(widths)
    else:
        classes, owner = st["pallas_lclasses"], spmm_tiles_fused
        counter = "wire_bf16_launches" if eng.halo_dtype else "launches"
        passes = len(widths)                    # one fused launch a layer
    packs = pack_launches(eng.setup.model, eng.comm_schedule, widths)
    qids = synthetic_query_ids(eng.plan.n, queries, seed=seed)
    rec = RecordingEngine(eng)

    setattr(owner, counter, 0)                  # the main path starts here
    k1_open()
    row_pack.launches = 0
    fwd0 = eng.forward_count
    eng.warmup(qids)
    result = run_loadgen(rec, qids)
    k1_close()
    launches = getattr(owner, counter)          # ... and ends here
    n_pack = row_pack.launches
    forwards = eng.forward_count - fwd0
    expected = forwards * passes
    if launches != expected or launches == 0 or n_pack != forwards * packs:
        raise AssertionError(
            f"{name}: tile kernel launched {launches} times, expected "
            f"{forwards} forwards x {passes} passes = {expected}; row pack "
            f"{n_pack}, expected {forwards} x {packs}")
    s = result.summary()
    log(f"  {name}: {s['queries']} queries in {s['batches']} batches, "
        f"{s['achieved_qps']} QPS, p50 {s['latency_p50_ms']} ms, "
        f"p99 {s['latency_p99_ms']} ms; launches: tile kernel "
        f"({counter}) {launches} = {forwards} forwards x {passes} passes "
        f"(each over {len(classes)} classes), row pack {n_pack} = "
        f"{forwards} x {packs}")
    MAIN_PATH_PACKS[0] += n_pack
    return rec, result, launches


def serve_and_check(name, ahat, feats, pv, k, widths, queries, max_batch,
                    seed, check_rows=None, device="cuda", model="gcn",
                    plan=None):
    """Drive the serving main path on the card and hold it to the float64
    forward (GCN: ``oracle_forward``; GAT: ``gat64``).  Returns (engine,
    result, launches): the tile kernel's fused entry's launches for GCN,
    its int8-mask entry point's for GAT."""
    import numpy as np

    from sgcn_tpu_torch.models import gat as gat_model
    from sgcn_tpu_torch.models.gcn import params_from_jax
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.serve import ServeEngine

    n, fin = feats.shape
    t0 = time.perf_counter()
    plan = build_comm_plan(ahat, pv, k) if plan is None else plan
    dims = list(zip([fin] + widths[:-1], widths))
    if model == "gat":
        params = gat_params_numpy(seed, dims)
        torch_params = gat_model.params_from_jax(params)
    else:
        params = glorot_numpy(seed, dims)
        torch_params = params_from_jax(params)
    eng = ServeEngine(plan, fin=fin, widths=widths, model=model,
                      comm_schedule="a2a", params=torch_params,
                      max_batch=max_batch, device=device)
    eng.set_features(feats)
    st = eng.setup.fwd_static
    if model == "gat":
        what = f"combined {[(t, e) for t, e, _ in st['pallas_cclasses']]}"
    else:
        what = (f"local {[(t, e) for t, e, _ in st['pallas_lclasses']]} "
                f"halo {[(t, e) for t, e, _ in st['pallas_hclasses']]}")
    log(f"  {name}: plan + engine {time.perf_counter() - t0:.2f} s; "
        f"b={plan.b} S={plan.s} R={plan.r} classes {what}")
    rec, result, launches = drive_serving(name, eng, queries, seed)

    q = np.concatenate([np.asarray(a, np.int64) for a, _ in rec.served])
    got = np.concatenate([o for _, o in rec.served])
    if len(q) != queries or got.shape != (queries, widths[-1]) \
            or not np.isfinite(got).all():
        raise AssertionError(f"{name}: served {got.shape} rows, finite "
                             f"{np.isfinite(got).all()}")
    if check_rows is not None:
        pick = np.random.default_rng(seed).permutation(len(q))[:check_rows]
        q, got = q[pick], got[pick]
    t0 = time.perf_counter()
    want = (gat64(ahat, feats, params) if model == "gat"
            else oracle_forward(ahat, feats, params))[q]
    err = np.abs(got - want)
    log(f"  {name}: {len(q)} served rows vs float64 forward "
        f"({time.perf_counter() - t0:.2f} s): max abs err {err.max():.3g}, "
        f"max rel err {(err / np.maximum(np.abs(want), 1e-30)).max():.3g}, "
        f"max |float64 row| {np.abs(want).max():.3g}")
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: served logits differ from the "
                             f"float64 forward beyond rtol {RTOL}, atol {ATOL}")
    return eng, result, launches


def forward_breakdown(eng):
    """Device time of each stage of one GCN forward (CUDA events around
    each stage, run back to back): projection, exchange (the a2a receive
    buffer or the ring's concat: one row pack), the fused tile launch
    (local pass, halo pass and their sum), activation — per layer."""
    import torch

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.ops.pspmm import exchange_recv, ring_concat
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_fused

    pa, st = eng.pa, eng.setup.fwd_static
    tb, lcls, hcls = st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"]
    ragged = eng.comm_schedule == "ragged"
    hsrc = pa["ptile_hrsrc"] if ragged else pa["ptile_hwsrc"]
    weights = list(eng.model.weights)
    h = eng._h0
    rows = []
    torch.cuda.synchronize()
    with torch.inference_mode():
        for i, w in enumerate(weights):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
            ev[0].record()
            x = h @ w if pf else h
            ev[1].record()
            remote = (ring_concat(x, pa["ring_src"], st["rr_sizes"])
                      if ragged else exchange_recv(x, pa["recv_src"]))
            ev[2].record()
            z = spmm_tiles_fused(
                (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]), x,
                (hsrc, pa["ptile_hld"], pa["ptile_hw"]), remote, lcls, hcls,
                tb)
            ev[3].record()
            z = z if pf else z @ w
            ev[4].record()
            h = torch.relu(z) if i < len(weights) - 1 else z
            ev[5].record()
            torch.cuda.synchronize()
            el = [ev[j].elapsed_time(ev[j + 1]) for j in range(5)]
            rows.append({"layer": i, "width": int(x.shape[-1]),
                         "project_ms": el[0] + el[3], "exchange_ms": el[1],
                         "fused_kernel_ms": el[2], "act_ms": el[4]})
        if not torch.equal(h, eng.forward()):
            raise AssertionError("breakdown != the engine's forward")
    return rows


def device_busy(run, reps: int = 5):
    """Device time vs wall over ``reps`` calls of ``run`` under
    ``torch.profiler``: returns (wall ms, device ms, top kernels).  The
    device time sums the events the profiler recorded ON the device
    (kernels, copies — one stream, so they do not overlap; the host-side
    aten ops that launched them are not counted again); the profiler's
    own overhead lengthens the wall, so 1 − device/wall is an upper bound
    of the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return wall_ms, sum(ms for _, ms in rows), rows[:5]


# device-time classes of a flagship step, by kernel name (torch.profiler);
# the first class whose key the name holds ("roll_cuda", not "roll": the
# casts and copies run in unrolled_elementwise_kernel)
DEVICE_CLASSES = (("K3/K4 fused", ("tile_spmm_fused_kernel",)),
                  ("K1/K5", ("tile_spmm_kernel",)),
                  ("pack", ("row_pack_kernel",)),
                  ("gathers", ("index", "gather")),
                  ("roll", ("roll_cuda",)),
                  ("cat", ("CatArray",)),
                  ("copies (transpose, casts)", ("copy",)),
                  ("matmul", ("gemm", "Kernel2", "cutlass", "sm90_xmma",
                              "cublas")))


def device_split(name, run, reps: int = 3, what: str = "steps"):
    """Device time of ``reps`` calls of ``run`` under ``torch.profiler``,
    split into ``DEVICE_CLASSES`` by kernel name (the rest as "other"),
    and the idle share's upper bound; logged and returned as a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {label: 0.0 for label, _ in DEVICE_CLASSES}
    split["other"] = 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type != DeviceType.CUDA or ms <= 0:
            continue
        label = next((lab for lab, keys in DEVICE_CLASSES
                      if any(k in e.key for k in keys)), "other")
        split[label] += ms
    dev_ms = sum(split.values())
    out = {"wall_ms": wall, "device_ms": dev_ms,
           "idle_le": (1 - dev_ms / wall) if dev_ms else None, **split}
    log(f"  {name}: {reps} {what} under torch.profiler: wall {wall:.3f} ms, "
        f"device {dev_ms:.3f} ms, idle share <= "
        f"{out['idle_le'] if dev_ms else 'not measured'}; device ms by "
        "class: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return out


def log_device_busy(name, run, reps: int = 5, what: str = "batches"):
    wall, dev_ms, top = device_busy(run, reps)
    if dev_ms == 0:
        log(f"  {name}: profiler saw no device time — idle share not "
            "measured")
        return
    log(f"  {name}: {reps} {what} under torch.profiler: wall {wall:.3f} ms, "
        f"device {dev_ms:.3f} ms, idle share <= {1 - dev_ms / wall:.3f}; "
        "top: " + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top))


# ---------------------------------------------------------- training path
def backward_passes(fin, widths):
    """Aggregation backward passes one step really runs: autograd calls a
    layer's backward only where its aggregated input needs a gradient —
    every layer past the first, and the first only when it projects
    before aggregating (``agg(h0 @ w0)``)."""
    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN

    first = widths[0] < fin and fin >= PROJECT_FIRST_MIN_FIN
    return len(widths) - 1 + int(first)


def backprop64(ahat, feats, labels, params, masks=None):
    """Float64 host loss and weight gradients of the GCN with ReLU between
    layers, no activation after the last, and the mean softmax
    cross-entropy over every row, in the trainer's layer order (a wide
    input narrowed by the layer projects first).  The backward of each
    aggregation multiplies by Âᵀ (Â itself on a symmetric graph).

    ``masks``: per hidden layer, the ReLU derivative (``z > 0``) to use in
    place of float64's own — the float32 run's, so that an entry whose
    pre-activation lies within rounding of 0 (where the two runs may
    disagree on the sign) does not count as an error of the gradient.
    Returns (loss, grads, per-layer count of entries whose mask differs
    from float64's)."""
    import numpy as np

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN

    a = ahat.astype(np.float64).tocsr()
    at = a.T.tocsr()
    h = np.asarray(feats, np.float64)
    ws = [np.asarray(w, np.float64) for w in params]
    ins, relu, pfs = [], [], []
    for i, w in enumerate(ws):
        pf = w.shape[1] < h.shape[1] and h.shape[1] >= PROJECT_FIRST_MIN_FIN
        ins.append(h if pf else a @ h)        # what the layer's W multiplies
        z = a @ (h @ w) if pf else ins[-1] @ w
        pfs.append(pf)
        if i < len(ws) - 1:
            relu.append(z > 0)
            h = np.maximum(z, 0.0)
        else:
            h = z
    flips = [0] * len(relu)
    if masks is not None:
        flips = [int((m != r).sum()) for m, r in zip(masks, relu)]
        relu = masks
    n = h.shape[0]
    z = h - h.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    loss = -logp[np.arange(n), labels].mean()
    dz = np.exp(logp)
    dz[np.arange(n), labels] -= 1.0
    dz /= n
    grads = [None] * len(ws)
    for i in reversed(range(len(ws))):
        if pfs[i]:                           # z = Â (h W)
            adz = at @ dz
            grads[i] = ins[i].T @ adz
            dh = adz @ ws[i].T
        else:                                # z = (Â h) W
            grads[i] = ins[i].T @ dz
            dh = at @ (dz @ ws[i].T)
        if i:
            dz = dh * relu[i - 1]
    return float(loss), grads, flips


def forward_backward_trace(tr, data):
    """One forward and backward of the trainer's loss at its current
    weights, written out with the public op, without an optimizer step:
    returns the pre-activations of every layer and, by layer, the
    gradient table that reaches each aggregation's backward."""
    import torch

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                              TILE_PLAN_FIELDS_RAGGED,
                                              pspmm_tiles_gen,
                                              pspmm_tiles_ragged,
                                              pspmm_tiles_sym)
    from sgcn_tpu_torch.train import LOSSES

    st = tr.model.fwd_static
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    if not st.get("symmetric", True):
        def agg(x):
            return pspmm_tiles_gen(
                x, tr.pa, *static, (st["pallas_tlclasses"],
                                    st["pallas_thclasses"],
                                    st["pallas_t1classes"]))
    elif tr.comm_schedule == "ragged":
        def agg(x):
            return pspmm_tiles_ragged(
                x, *(tr.pa[f] for f in TILE_PLAN_FIELDS_RAGGED), *static,
                st["rr_sizes"])
    else:
        def agg(x):
            return pspmm_tiles_sym(
                x, *(tr.pa[f] for f in TILE_PLAN_FIELDS), *static)
    zs, caught = [], {}
    weights = list(tr.model.weights)
    h = data.h0
    for i, w in enumerate(weights):
        pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
        z = agg(h @ w if pf else h)
        if z.requires_grad:
            z.register_hook(lambda g, i=i: caught.__setitem__(
                i, g.detach().contiguous()))
        z = z if pf else z @ w
        zs.append(z.detach())
        h = torch.relu(z) if i < len(weights) - 1 else z
    loss = LOSSES[tr.loss_name](h, data.labels, data.train_valid)
    torch.autograd.grad(loss, weights)
    torch.cuda.synchronize()
    return zs, caught


def step_breakdown(tr, data, steps: int = 3):
    """Device time of the three parts of a training step — forward with
    the loss, backward, optimizer — from CUDA events around each, over
    ``steps`` steps (the trainer's ``_one_step`` written out)."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    rows = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        tr.opt.zero_grad(set_to_none=True)
        loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                    data.train_valid)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    return {key: sum(r[j] for r in rows) / steps
            for j, key in enumerate(("forward_ms", "backward_ms",
                                     "optimizer_ms"))}


def gat_forward_breakdown(eng):
    """Device time of each stage of one GAT forward, per layer, from CUDA
    events recorded at the boundaries of the model's own functions while
    ``eng.forward()`` runs (``_gat_factored_fwd_core``,
    ``_gat_tiles_aggregate``, ``gat_tiles_pass``): projection (``z =
    h·w``, scores, ``u``, ``p = u·z``: the layer's start to its
    aggregation), exchange (the table or the split pair to the halo or
    the ring, and the ``[local; halo]`` concatenation: to the first
    pass), numerator pass (the one pass of a fused layer), denominator
    pass (a split layer's second pass; a fused one's lane slice: from the
    first pass's end to the aggregation's), division (to the layer's
    end)."""
    import torch

    from sgcn_tpu_torch.models import gat as gat_model

    layers = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        layers[-1].append((label, ev))

    def around(fn, before, after, new_layer=False):
        def wrapped(*args, **kw):
            if new_layer:
                layers.append([])
            mark(before)
            out = fn(*args, **kw)
            mark(after)
            return out
        return wrapped

    names = ("_gat_factored_fwd_core", "_gat_tiles_aggregate",
             "gat_tiles_pass")
    orig = {name: getattr(gat_model, name) for name in names}
    gat_model._gat_factored_fwd_core = around(
        orig["_gat_factored_fwd_core"], "start", "end", new_layer=True)
    gat_model._gat_tiles_aggregate = around(
        orig["_gat_tiles_aggregate"], "agg", "agg_end")
    gat_model.gat_tiles_pass = around(orig["gat_tiles_pass"], "pass",
                                      "pass_end")
    torch.cuda.synchronize()
    try:
        out = eng.forward()
    finally:
        for name, fn in orig.items():
            setattr(gat_model, name, fn)
    torch.cuda.synchronize()
    rows = []
    for i, (marks, p) in enumerate(zip(layers, eng.model.layer_params())):
        at = {}
        for label, ev in marks:                  # first mark of each label
            at.setdefault(label, ev)
        passes = sum(label == "pass" for label, _ in marks)
        fout = p["w"].shape[1]

        def ms(a, b):
            return at[a].elapsed_time(at[b])

        rows.append({"layer": i, "form": "fused" if passes == 1 else "split",
                     "width": fout, "project_ms": ms("start", "agg"),
                     "exchange_ms": ms("agg", "pass"),
                     "numerator_pass_ms": ms("pass", "pass_end"),
                     "denominator_pass_ms": ms("pass_end", "agg_end"),
                     "divide_ms": ms("agg_end", "end")})
    if len(rows) != len(eng.widths) or not torch.equal(out, eng.forward()):
        raise AssertionError("GAT breakdown: the recorded forward != the "
                             "engine's forward")
    return rows


def gat_train_pass(tr, data):
    """One forward and backward of the GAT trainer's loss at its current
    weights, without an optimizer step."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                data.train_valid)
    torch.autograd.grad(loss, list(tr.model.parameters()))


def record_gat_passes(run):
    """Run ``run()`` recording every K5 pass the GAT model makes: the
    arguments of each ``gat_tiles_pass`` call of ``models/gat.py``, the
    tables exactly as the model built them (a2a or ring), grouped by
    aggregation (``_gat_tiles_aggregate``): for a training pass the
    forward's layers in order, then the backward's in reverse.  Each
    group holds one pass for a fused layer, two (numerator, denominator)
    for a split one; each pass is (tiles, table, classes, tb)."""
    import torch

    from sgcn_tpu_torch.models import gat as gat_model

    groups = []
    orig_agg, orig_pass = gat_model._gat_tiles_aggregate, \
        gat_model.gat_tiles_pass

    def aggregate(*args):
        groups.append([])
        return orig_agg(*args)

    def recording(csrc, cld, cw, table, cclasses, tb, num_rows):
        groups[-1].append(([csrc, cld, cw], table.detach(), cclasses, tb))
        return orig_pass(csrc, cld, cw, table, cclasses, tb, num_rows)

    gat_model._gat_tiles_aggregate = aggregate
    gat_model.gat_tiles_pass = recording
    try:
        run()
    finally:
        gat_model._gat_tiles_aggregate = orig_agg
        gat_model.gat_tiles_pass = orig_pass
    torch.cuda.synchronize()
    return groups


def check_time_gat_call(passes, what):
    """K5 on one recorded aggregation's real tables: the mask kernel ==
    its plain version (and two launches) bit for bit per pass, then its
    time, plain time, bound and library time summed over the passes.
    Returns (max |kernel - plain|, timing dict)."""
    err, tot, bound_by = 0.0, {}, None
    for tiles, table, cls, tb in passes:
        f = table.shape[-1]
        err = max(err, check_k1(tiles, table, cls, tb, f"{what} f={f}"))
        t = time_k1([x.cpu().numpy() for x in tiles], tiles, table, cls, tb,
                    table.shape[1], f"{what} f={f}", plain_reps=2)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] = tot.get(key, 0.0) + t[key]
        bound_by = bound_by or t["bound_by"]
    tot["bound_by"] = bound_by
    log(f"  {what}: K5 over its {len(passes)} table(s): {tot['ms']!r} ms; "
        f"bound {tot['bound_ms']!r} ms; plain {tot['plain_ms']!r} ms; "
        f"torch.sparse.mm {tot['library_ms']!r} ms")
    return err, tot


def check_gat_passes(groups, what):
    """K5 == plain bit for bit on every recorded pass; returns the max
    |kernel - plain|."""
    err = 0.0
    for j, passes in enumerate(groups):
        for tiles, table, cls, tb in passes:
            err = max(err, check_k1(tiles, table, cls, tb, f"{what} "
                                    f"aggregation {j} f={table.shape[-1]}"))
    return err


# -------------------------------------------------------- the ragged ring
def serve_ragged(name, eng_a, feats, queries, max_batch, seed):
    """Drive the serving main path on the ragged ring: an engine on
    ``eng_a``'s plan, weights and features with ``comm_schedule='ragged'``.
    Its launches must be exact (for GCN, every one through
    ``PspmmTilesRagged``) and every served row must equal the a2a
    engine's row for the same query, bit for bit.  Returns (engine,
    result, launches)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import PspmmTilesRagged
    from sgcn_tpu_torch.serve import ServeEngine

    eng = ServeEngine(eng_a.plan, fin=eng_a.fin, widths=eng_a.widths,
                      model=eng_a.setup.model, comm_schedule="ragged",
                      params=eng_a.model.layer_params(),
                      max_batch=max_batch, device=eng_a.device)
    if eng.comm_schedule != "ragged":
        raise AssertionError(f"{name}: resolved {eng.comm_schedule}")
    eng.set_features(feats)
    PspmmTilesRagged.launches = 0
    rec, result, launches = drive_serving(name, eng, queries, seed)
    if PspmmTilesRagged.launches != (
            0 if eng.setup.model == "gat" else launches):
        raise AssertionError(f"{name}: {PspmmTilesRagged.launches} "
                             "launches through the ring op")
    for q, out in rec.served:
        if not np.array_equal(out, eng_a.query(q)):
            raise AssertionError(f"{name}: served rows != the a2a "
                                 "engine's rows")
    if not torch.equal(eng.forward(), eng_a.forward()):
        raise AssertionError(f"{name}: ragged forward != a2a forward")
    log(f"  {name}: {len(rec.served)} served batches and the whole "
        f"forward == the a2a engine's, bit for bit; wire rows per "
        f"exchange {eng.gauges()['wire_rows_per_exchange']} (a2a "
        f"{eng_a.gauges()['wire_rows_per_exchange']})")
    return eng, result, launches


def log_side_by_side(name, a2a_rows, ring_rows, keys):
    for a, r in zip(a2a_rows, ring_rows):
        log(f"  {name} layer {a['layer']}: " + ", ".join(
            f"{k} a2a {a[k]:.4f} / ring {r[k]:.4f} ms" for k in keys))


def run_train_cli(argv):
    """``python -m sgcn_tpu_torch.train``'s ``main`` in-process: its
    per-epoch losses and its JSON report."""
    from sgcn_tpu_torch.train.__main__ import main as train_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(argv)
    lines = out.getvalue().strip().splitlines()
    return ([float(x.split()[-1]) for x in lines if x.startswith("epoch ")],
            json.loads(lines[-1]))


def k6_bound_ms(idx, f):
    """Bytes the row shuffle needs on these inputs — each distinct
    referenced row read once, the index read once, the output written
    once — over the HBM rate; it does no arithmetic."""
    import numpy as np

    rows = np.unique(idx.cpu().numpy()).size
    s = idx.shape[0]
    return (rows * f * 4 + s * 4 + s * f * 4) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------- the bf16 levers
BF16_WIDTHS = (1, 7, 8, 16, 17, 40, 41, 128, 129)
BAND_GCN = dict(rtol=0.05, atol=0.02)    # tests/test_train_parity.py:122
BAND_GAT = dict(rtol=0.05, atol=0.03)    # tests/test_gat.py:171
SERVE_BF16_TOL = dict(rtol=5e-3, atol=5e-3)   # tests/test_halo_dtype.py:43


def phase_bf16_kernels(rng, dev, tiles_np, tiles, classes, tb, n):
    """Phase 14: K1 and K5 on bf16 tables (the kernel's bf16 entry
    points) vs their plain version, bit for bit and between two launches,
    on phase 1's tiles (hub row, all-pad tile, pad-heavy class) at every
    width of ``BF16_WIDTHS``: on an 8-byte aligned table, on a view whose
    base is 2-byte but not 8-byte aligned, and with inf and NaN in the row
    the pads read.  Times K1-bf16 at f ∈ {16, 128}.  Returns the max
    |kernel − plain| of each and the times."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    k = tiles[0].shape[0]
    mtiles = tiles[:2] + [(tiles[2] != 0).to(torch.int8)]
    err = {"k1": 0.0, "k5": 0.0}
    times = {}
    before = (spmm_tiles.launches, spmm_tiles.mask_launches,
              spmm_tiles.bf16_launches, spmm_tiles.bf16_mask_launches)
    for f in BF16_WIDTHS:
        table = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev).bfloat16()
        bad = table.clone()
        bad[:, 0, 0], bad[:, 0, -1] = float("inf"), float("nan")
        for t_, how, nan_ok in ((table, "", False),
                                (unaligned_copy(table), " 2-byte aligned",
                                 False),
                                (bad, " inf/NaN in the pads' row", True)):
            err["k1"] = max(err["k1"], check_k1(
                tiles, t_, classes, tb, f"K1 bf16 f={f}{how}", nan_ok))
            err["k5"] = max(err["k5"], check_k1(
                mtiles, t_, classes, tb, f"K5 bf16 f={f}{how}", nan_ok))
        if f in (16, 128):
            times[f] = time_k1(tiles_np, tiles, table, classes, tb, n,
                               f"K1 bf16 random tiles f={f}")
    after = (spmm_tiles.launches, spmm_tiles.mask_launches,
             spmm_tiles.bf16_launches, spmm_tiles.bf16_mask_launches)
    if after[:2] != before[:2] or after[2] == before[2] \
            or after[3] == before[3]:
        raise AssertionError(f"bf16 tables launched {after} from {before}: "
                             "not (only) the bf16 entries")
    return err, times


def record_aggregations(run):
    """Run ``run()`` recording the table of every GCN aggregation
    (``_pspmm_tiles_once`` of ``ops/tile_spmm.py``, which the forward and
    the backward of ``PspmmTilesSym`` call): the forward's layers in
    order, then the backward's gradient tables."""
    import torch

    from sgcn_tpu_torch.ops import tile_spmm

    calls, orig = [], tile_spmm._pspmm_tiles_once

    def recording(h, *args):
        calls.append(h.detach())
        return orig(h, *args)

    tile_spmm._pspmm_tiles_once = recording
    try:
        run()
    finally:
        tile_spmm._pspmm_tiles_once = orig
    torch.cuda.synchronize()
    return calls


def gcn_train_pass(tr, data):
    """One forward and backward of the GCN trainer's loss at its current
    weights, without an optimizer step."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                data.train_valid)
    torch.autograd.grad(loss, list(tr.params))


def time_layer(pa, st, table, tb, what):
    """K1 over one aggregation's two families on ``table`` (its halo
    family over the a2a receive buffer, on the table's own dtype): bit for
    bit against the plain version, the fused entry on the same inputs
    likewise, then the two K1 passes' times summed and the whole op's
    (``time_whole_op``).  Returns (max |kernel − plain|, K1 timing dict,
    whole-op timing dict)."""
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    recv = exchange_recv(table, pa["recv_src"])
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    htiles = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    err = max(check_k1(ltiles, table, st["pallas_lclasses"], tb,
                       f"{what} local pass"),
              check_k1(htiles, recv, st["pallas_hclasses"], tb,
                       f"{what} halo pass"),
              check_fused(ltiles, table, htiles, recv, st["pallas_lclasses"],
                          st["pallas_hclasses"], tb, f"{what} fused"))
    t_l = time_k1([t.cpu().numpy() for t in ltiles], ltiles, table,
                  st["pallas_lclasses"], tb, table.shape[1],
                  f"{what} local pass")
    t_h = time_k1([t.cpu().numpy() for t in htiles], htiles, recv,
                  st["pallas_hclasses"], tb, recv.shape[1],
                  f"{what} halo pass")
    out = {key: (None if t_l[key] is None or t_h[key] is None
                 else t_l[key] + t_h[key])
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = t_h["bound_by"]
    log(f"  {what}: K1 over both families {out['ms']!r} ms; bound "
        f"{out['bound_ms']!r} ms; plain {out['plain_ms']!r} ms; "
        f"torch.sparse.mm {out['library_ms']!r} ms")
    return err, out, time_whole_op(table, pa, st, tb, False,
                                   f"{what} whole K3 op")


def split_f32(model, trainers, data):
    """The float32 trainers' step breakdown and profiler split, beside
    which the bf16 runs of phases 15 and 17 are read."""
    for sched, tr in trainers.items():
        log(f"  {model} float32 {sched}: step breakdown (CUDA events, mean "
            f"of 3): {json.dumps(step_breakdown(tr, data))}")
        device_split(f"{model} float32 {sched} training",
                     lambda tr=tr: tr.step(data))


def phase_bf16_gcn_training(plan, data, p_init, widths, rep32, dev, tb,
                            steps, bwd):
    """Phase 15: the flagship GCN trained under each bf16 lever on both
    transports from phase 5's initial weights, 1 warm-up + 5 timed steps:
    ragged == a2a bit for bit (losses and weights after ``fit``), the
    losses inside the reference's bf16 band of phase 5's float32 run and
    not equal to them, exact launches per entry (``halo_dtype`` keeps
    float32 tables: the float32 entry; ``compute_dtype``: the bf16 entry
    only); ``epoch_s``, the step breakdown and the profiler's split; K1
    on the compute run's real bf16 forward and gradient tables == plain,
    and K1-bf16's time at the flagship layer.  Returns (launches per
    entry, max |kernel − plain|, the forward layer's timing)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesRagged,
                                              PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer

    fam = 1
    want = steps * (len(widths) + bwd) * fam
    runs, launches = {}, {"wire": 0, "bf16": 0}
    for lever in ("halo_dtype", "compute_dtype"):
        for sched in ("a2a", "ragged"):
            tr = FullBatchTrainer(plan, fin=128, widths=widths,
                                  params=p_init, comm_schedule=sched,
                                  device=dev, **{lever: "bfloat16"})
            # the main path starts here
            for c in ("launches", "wire_bf16_launches", "bf16_launches"):
                setattr(spmm_tiles_fused, c, 0)
            spmm_tiles.launches = spmm_tiles.bf16_launches = 0
            row_pack.launches = 0
            PspmmTilesSym.backward_launches = 0
            PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
            k1_open()
            rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
            k1_close()
            n = (spmm_tiles_fused.launches,           # ... and ends here
                 spmm_tiles_fused.wire_bf16_launches,
                 spmm_tiles_fused.bf16_launches,
                 spmm_tiles.launches + spmm_tiles.bf16_launches)
            n_pack = row_pack.launches
            nbwd = (PspmmTilesRagged.backward_launches if sched == "ragged"
                    else PspmmTilesSym.backward_launches)
            exp = ((0, want, 0, 0) if lever == "halo_dtype"
                   else (0, 0, want, 0))
            log(f"  GCN {lever}=bfloat16 {sched}: fused launches float32 "
                f"{n[0]}, bf16 wire {n[1]}, bf16 {n[2]}; K1 {n[3]}; "
                f"backward {nbwd}; row pack {n_pack}; expected {exp} and "
                f"{want} packs = {steps} steps x ({len(widths)} forward + "
                f"{bwd} backward aggregations); losses "
                f"{rep['loss_history']}; epoch_s {rep['epoch_s']!r}; "
                f"wire bytes per step {rep['halo_bytes_wire_per_step']}")
            if n != exp or nbwd != steps * bwd * fam or n_pack != want:
                raise AssertionError(f"GCN {lever} {sched}: launch counts "
                                     "differ from the passes run")
            launches["wire"] += n[1]
            launches["bf16"] += n[2]
            MAIN_PATH_PACKS[0] += n_pack
            runs[(lever, sched)] = {
                "rep": rep, "tr": tr,
                "w": [w.detach().clone() for w in tr.params]}
        a2a, ring = runs[(lever, "a2a")], runs[(lever, "ragged")]
        same = (a2a["rep"]["loss_history"] == ring["rep"]["loss_history"]
                and all(torch.equal(x, y) for x, y in zip(a2a["w"],
                                                          ring["w"])))
        l16 = np.asarray(a2a["rep"]["loss_history"])
        l32 = np.asarray(rep32["loss_history"])
        band = np.allclose(l16, l32, **BAND_GCN)
        log(f"  GCN {lever}: ragged == a2a (losses, weights): {same}; "
            f"losses vs float32 {l32.tolist()}: max |gap| "
            f"{np.abs(l16 - l32).max():.3g}, inside the band {BAND_GCN}: "
            f"{band}, bit-equal: {np.array_equal(l16, l32)}")
        if not same or not band or np.array_equal(l16, l32) \
                or not np.isfinite(l16).all():
            raise AssertionError(f"GCN {lever}: ragged != a2a, or losses "
                                 "outside the band, or equal to float32")
    for (lever, sched), run in runs.items():
        tr = run["tr"]
        log(f"  GCN {lever} {sched}: epoch_s {run['rep']['epoch_s']!r}; "
            f"step breakdown (CUDA events, mean of 3): "
            f"{json.dumps(step_breakdown(tr, data))}")
        run["split"] = device_split(f"GCN {lever} {sched} training",
                                    lambda tr=tr: tr.step(data))
    tr = runs[("compute_dtype", "a2a")]["tr"]
    calls = record_aggregations(lambda: gcn_train_pass(tr, data))
    if [c.dtype for c in calls] != [torch.bfloat16] * (len(widths) + bwd):
        raise AssertionError(f"compute run's aggregation tables "
                             f"{[c.dtype for c in calls]}")
    st, pa = tr.model.fwd_static, tr.pa
    err_g, _, _ = time_layer(pa, st, calls[len(widths)], tb,
                             "flagship bf16 gradient (layer 2 backward)")
    err_f, t_fwd, op_fwd = time_layer(pa, st, calls[0], tb,
                                      "flagship bf16 layer-0 forward table")
    # the bf16 wire under halo_dtype: the pack narrows, the fused launch
    # reads the bf16 receive buffer beside the float32 h
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    trw = runs[("halo_dtype", "a2a")]["tr"]
    h32 = record_aggregations(lambda: gcn_train_pass(trw, data))[0]
    pw = trw.pa
    check_pack(h32, pw["recv_src"], torch.bfloat16,
               "flagship layer-0 exchange on the bf16 wire")
    wire = exchange_recv(h32, pw["recv_src"], "bfloat16")
    err_w = check_fused(
        [pw["ptile_lsrc"], pw["ptile_lld"], pw["ptile_lw"]], h32,
        [pw["ptile_hwsrc"], pw["ptile_hld"], pw["ptile_hw"]], wire,
        st["pallas_lclasses"], st["pallas_hclasses"], tb,
        "flagship layer-0 fused on the bf16 wire")
    t_wire = time_pack(h32, pw["recv_src"], torch.bfloat16,
                       "flagship layer-0 exchange, bf16 wire")
    return launches, max(err_g, err_f, err_w), t_fwd, op_fwd, t_wire


def phase_bf16_serving(eng_f, eng_fr, res_f, res_fr, ahat, feats, dev):
    """Phase 16: flagship GCN serving with ``halo_dtype='bfloat16'`` on
    both transports, phase 3's plan, weights and features: 512 queries,
    256 served rows within rtol 5e-3 / atol 5e-3 of the float64 forward,
    the ring's rows and whole forward == the a2a engine's bit for bit,
    exact launches (float32 tables: the float32 entry); p50/p99 and QPS
    beside the float32 engines'.  Returns the launches."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.serve import ServeEngine

    params = [w.detach().cpu().numpy() for w in eng_f.model.weights]
    want_all = oracle_forward(ahat, feats, params)
    engines, total = {}, 0
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(eng_f.plan, fin=eng_f.fin, widths=eng_f.widths,
                          comm_schedule=sched, halo_dtype="bfloat16",
                          params=eng_f.model.layer_params(), max_batch=64,
                          device=dev)
        eng.set_features(feats)
        rec, result, launches = drive_serving(
            f"flagship GCN halo_dtype=bfloat16 {sched}", eng, 512, 3)
        total += launches
        q = np.concatenate([np.asarray(a, np.int64) for a, _ in rec.served])
        got = np.concatenate([o for _, o in rec.served])
        pick = np.random.default_rng(3).permutation(len(q))[:256]
        err = np.abs(got[pick] - want_all[q[pick]])
        ok = np.allclose(got[pick], want_all[q[pick]], **SERVE_BF16_TOL)
        log(f"  {sched}: 256 served rows vs float64 forward: max abs err "
            f"{err.max():.3g} (inside {SERVE_BF16_TOL}: {ok})")
        if not ok or not np.isfinite(got).all():
            raise AssertionError(f"halo_dtype serving {sched}: rows off the "
                                 "float64 forward")
        engines[sched] = (eng, rec, result)
    (ea, _ra, res_a), (er, rr, res_r) = engines["a2a"], engines["ragged"]
    for q, out in rr.served:
        if not np.array_equal(out, ea.query(q)):
            raise AssertionError("halo_dtype serving: ring rows != a2a rows")
    if not torch.equal(er.forward(), ea.forward()):
        raise AssertionError("halo_dtype serving: ring forward != a2a")
    for name, r16, r32 in (("a2a", res_a, res_f), ("ring", res_r, res_fr)):
        a, b = r16.summary(), r32.summary()
        log(f"  flagship GCN serving {name}: bf16 wire p50 "
            f"{a['latency_p50_ms']} ms, p99 {a['latency_p99_ms']} ms, "
            f"{a['achieved_qps']} QPS; float32 p50 {b['latency_p50_ms']} "
            f"ms, p99 {b['latency_p99_ms']} ms, {b['achieved_qps']} QPS")
    log("  ring rows and whole forward == a2a, bit for bit; breakdown "
        "a2a: " + json.dumps(forward_breakdown_halo(ea)))
    log_device_busy("flagship GCN halo_dtype a2a",
                    lambda: ea.query(np.arange(64)))
    log_device_busy("flagship GCN halo_dtype ring",
                    lambda: er.query(np.arange(64)))
    return total


def forward_breakdown_halo(eng):
    """One bf16-wire exchange of layer 0 against the float32 one on the
    same table (CUDA events, mean of 10): the wire's effect alone."""
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    pa, h = eng.pa, eng._h0
    return {"exchange_f32_ms": cuda_ms(lambda: exchange_recv(
                h, pa["recv_src"]), reps=10),
            "exchange_bf16_wire_ms": cuda_ms(lambda: exchange_recv(
                h, pa["recv_src"], "bfloat16"), reps=10)}


def phase_bf16_gat(plan, data, params_g, widths, rep32, dev, steps,
                   cli, cli_losses):
    """Phase 17: the flagship GAT trained under ``compute_dtype=
    'bfloat16'`` on both transports (every layer packed: 128, 128 and 40
    are even), 1 warm-up + 5 timed steps: ragged == a2a bit for bit, the
    losses inside the reference's GAT bf16 band of phase 8's float32 run
    and not equal to them, exact launches per entry (a packed pass runs
    the bf16 entry on the feature lanes and the float32 one on ``u``);
    ``epoch_s``, the step breakdown, the profiler's split; K5 on every
    real table of a training step == plain and K5-bf16's time at the
    flagship layer.  Then cora2708 GAT 1433 → 16 → 7 ``--dtype bfloat16``
    through the train CLI (16 packed, 7 odd: the fused bf16 table),
    against phase 9's float32 CLI run.  Returns (launches per entry, max
    |kernel − plain|, the flagship feature pass's timing)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import GatLayerSym
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles
    from sgcn_tpu_torch.train import FullBatchTrainer

    per_dir = len(widths)                 # one bf16 + one f32 pass a layer
    runs, launches = {}, {"f32": 0, "bf16": 0}
    for sched in ("a2a", "ragged"):
        tr = FullBatchTrainer(plan, fin=128, widths=widths, model="gat",
                              activation="none",
                              params=gat_from_numpy(params_g),
                              comm_schedule=sched, compute_dtype="bfloat16",
                              device=dev)
        spmm_tiles.mask_launches = spmm_tiles.bf16_mask_launches = 0
        row_pack.launches = 0
        GatLayerSym.backward_launches = 0       # the main path starts here
        k1_open()
        rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
        n32, n16 = spmm_tiles.mask_launches, spmm_tiles.bf16_mask_launches
        k1_close()
        nbwd = GatLayerSym.backward_launches    # ... and ends here
        n_pack = row_pack.launches
        MAIN_PATH_PACKS[0] += n_pack
        want = steps * 2 * per_dir
        want_pack = steps * 2 * pack_launches("gat", sched, widths,
                                              "bfloat16")
        log(f"  GAT bf16 {sched}: K5 launches float32 entry {n32}, bf16 "
            f"entry {n16} (backward {nbwd}); expected {want} each = {steps} "
            f"steps x 2 directions x {per_dir} packed layers; row pack "
            f"{n_pack} (expected {want_pack}); losses "
            f"{rep['loss_history']}; epoch_s {rep['epoch_s']!r}; wire bytes "
            f"per step {rep['halo_bytes_wire_per_step']}")
        if (n32, n16, nbwd, n_pack) != (want, want, want, want_pack):
            raise AssertionError(f"GAT bf16 {sched}: K5 launch counts differ "
                                 "from the passes run")
        launches["f32"] += n32
        launches["bf16"] += n16
        runs[sched] = {"rep": rep, "tr": tr, "w": [
            p.detach().clone() for p in tr.model.parameters()]}
    a2a, ring = runs["a2a"], runs["ragged"]
    same = (a2a["rep"]["loss_history"] == ring["rep"]["loss_history"]
            and all(torch.equal(x, y) for x, y in zip(a2a["w"], ring["w"])))
    l16 = np.asarray(a2a["rep"]["loss_history"])
    l32 = np.asarray(rep32["loss_history"])
    band = np.allclose(l16, l32, **BAND_GAT)
    log(f"  GAT bf16: ragged == a2a (losses, weights): {same}; losses vs "
        f"float32 {l32.tolist()}: max |gap| {np.abs(l16 - l32).max():.3g}, "
        f"inside the band {BAND_GAT}: {band}, bit-equal: "
        f"{np.array_equal(l16, l32)}")
    if not same or not band or np.array_equal(l16, l32) \
            or not np.isfinite(l16).all():
        raise AssertionError("GAT bf16: ragged != a2a, or losses outside "
                             "the band, or equal to float32")
    for sched, run in runs.items():
        tr = run["tr"]
        log(f"  GAT bf16 {sched}: epoch_s {run['rep']['epoch_s']!r}; step "
            f"breakdown (CUDA events, mean of 3): "
            f"{json.dumps(step_breakdown(tr, data))}")
        run["split"] = device_split(f"GAT bf16 {sched} training",
                                    lambda tr=tr: tr.step(data))
    calls = record_gat_passes(lambda: gat_train_pass(a2a["tr"], data))
    dtypes = [[str(t.dtype)[6:] for _, t, _, _ in c] for c in calls]
    log(f"  one training pass's K5 tables by aggregation: {dtypes}")
    if dtypes != [["bfloat16", "float32"]] * (2 * per_dir):
        raise AssertionError("GAT bf16: packed passes' tables are not "
                             "bf16 features + float32 u")
    err = check_gat_passes(calls, "flagship GAT bf16")
    tiles, table, cls, tb = calls[0][0]
    t5 = time_k1([x.cpu().numpy() for x in tiles], tiles, table, cls, tb,
                 table.shape[1], "flagship GAT bf16 layer-0 forward "
                 "feature pass f=128")

    spmm_tiles.mask_launches = spmm_tiles.bf16_mask_launches = 0
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0           # the main path starts here
    k1_open()
    losses, rep_c = run_train_cli(cli + ["--model", "gat", "--dtype",
                                         "bfloat16", "--comm-schedule",
                                         "a2a"])
    n32, n16 = spmm_tiles.mask_launches, spmm_tiles.bf16_mask_launches
    k1_close()
    n_pack = row_pack.launches                  # ... and ends here
    MAIN_PATH_PACKS[0] += n_pack
    want_pack = 5 * 2 * pack_launches("gat", "a2a", [16, 7], "bfloat16")
    # per step: forward packed 16 (bf16 + f32) and fused bf16 7 (bf16);
    # backward packed (bf16 + f32) and fused float32 (f32)
    want_c = (5 * 3, 5 * 3)
    band_c = np.allclose(losses, cli_losses, **BAND_GAT)
    log(f"  cora GAT --dtype bfloat16 CLI: losses {losses} (float32 "
        f"{cli_losses}, inside {BAND_GAT}: {band_c}); K5 launches float32 "
        f"{n32}, bf16 {n16} (expected {want_c}), row pack {n_pack} "
        f"(expected {want_pack}); wire bytes per step "
        f"{rep_c['halo_bytes_wire_per_step']}; epoch_s "
        f"{rep_c['epoch_s']!r}")
    if (n32, n16) != want_c or not band_c or rep_c["dtype"] != "bfloat16" \
            or losses == cli_losses or n_pack != want_pack:
        raise AssertionError("cora GAT bf16 CLI: launches, band or dtype")
    launches["f32"] += n32
    launches["bf16"] += n16
    return launches, err, t5


# ------------------------------------------------- asymmetric Â (directed)
def directed_er_graph(n, seed=0):
    """The directed flagship graph: 14·n ordered pairs (i, j) from
    ``default_rng(seed)``, self pairs dropped, every edge of weight 1
    (a pair drawn twice is one edge); the caller normalizes it."""
    import numpy as np
    import scipy.sparse as sp

    r, c = np.random.default_rng(seed).integers(0, n, (2, 14 * n))
    keep = r != c
    a = sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                       (r[keep], c[keep])), shape=(n, n))
    a.data[:] = 1.0
    return a


def record_launches(run):
    """Run ``run()`` recording the inputs of every tile family launch
    (``spmm_tiles_classes``: K1 on float32 weights, K5 on int8 masks),
    every row pack and every fused launch it makes, through the module
    attributes the ops call them by.  Returns (families, packs, fused):
    lists of argument tuples."""
    import torch

    from sgcn_tpu_torch.ops import pspmm, tile_spmm

    fams, packs, fused = [], [], []
    orig = (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
            tile_spmm.spmm_tiles_fused)

    def family(src, ld, w, table, classes, tb):
        fams.append(([src, ld, w], table.detach(), classes, tb))
        return orig[0](src, ld, w, table, classes, tb)

    def pack(src, flat, dtype=None):
        packs.append((src.detach(), flat, dtype or src.dtype))
        return orig[1](src, flat, dtype)

    def fuse(ltiles, h, htiles, remote, lcls, hcls, tb):
        fused.append((ltiles, h.detach(), htiles, remote, lcls, hcls, tb))
        return orig[2](ltiles, h, htiles, remote, lcls, hcls, tb)

    # the wrappers share the wrapped functions' launch counters
    for wrapper, wrapped in zip((family, pack, fuse), orig):
        wrapper.__dict__ = wrapped.__dict__
    (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
     tile_spmm.spmm_tiles_fused) = family, pack, fuse
    try:
        run()
    finally:
        (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
         tile_spmm.spmm_tiles_fused) = orig
    torch.cuda.synchronize()
    return fams, packs, fused


def check_launches(name, recorded):
    """Every recorded family launch, pack and fused launch == its plain
    version on the same (real) inputs, bit for bit.  Returns the max
    |kernel − plain| (0.0 when identical)."""
    fams, packs, fused = recorded
    err = 0.0
    for j, (tiles, table, cls, tb) in enumerate(fams):
        err = max(err, check_k1(tiles, table, cls, tb, f"{name} family "
                                f"launch {j} f={table.shape[-1]}"))
    for j, (src, flat, dtype) in enumerate(packs):
        check_pack(src, flat, dtype, f"{name} pack {j}")
    for j, args in enumerate(fused):
        err = max(err, check_fused(*args, f"{name} fused launch {j}"))
    log(f"  {name}: {len(fams)} family launches, {len(packs)} packs, "
        f"{len(fused)} fused launches == plain, bit for bit")
    return err


def time_transposed_op(g, pa, st, tb, what):
    """One backward aggregation of an asymmetric Â on the table ``g``
    (``pspmm_tiles_transposed``): the whole op (halo-ᵀ family launch,
    reverse pack, fused local-ᵀ + owner sum) by CUDA events, each step
    alone, the plain version once (torch arithmetic), the library
    yardsticks summed (``torch.sparse.mm`` of the halo rows' Âᵀ, the
    ``torch.index_select`` of the reverse wire, ``torch.sparse.mm`` of the
    local rows' Âᵀ beside the owner sum) and the bound: the three steps'
    bytes at the card's memory rate."""
    import torch

    from sgcn_tpu_torch.ops.pspmm import reverse_exchange
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_plain
    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_transposed,
                                              spmm_tiles_classes,
                                              spmm_tiles_classes_plain,
                                              spmm_tiles_fused_plain)

    tl, th, t1 = ([pa[f"ptile_t{x}{y}"] for y in ("src", "ld", "w")]
                  for x in ("l", "h", "1"))
    cls = (st["pallas_tlclasses"], st["pallas_thclasses"],
           st["pallas_t1classes"])
    send = spmm_tiles_classes(*th, g, cls[1], tb)
    rwire = reverse_exchange(send, pa["rev_src"], dtype=g.dtype)
    fam = time_k1([t.cpu().numpy() for t in th], th, g, cls[1], tb,
                  g.shape[1], f"{what} halo-T family launch")
    pack = time_pack(send, pa["rev_src"], g.dtype, f"{what} reverse pack")
    fused = time_fused(tl, g, t1, rwire, cls[0], cls[2], tb,
                       f"{what} fused local-T + owner sum")
    args = (g, tl, th, t1, pa["rev_src"], tb, *cls)
    with torch.inference_mode():
        op = cuda_ms(lambda: pspmm_tiles_transposed(*args))
    plain = cuda_ms(lambda: spmm_tiles_fused_plain(
        tl, g, t1, row_pack_plain(spmm_tiles_classes_plain(
            *th, g, cls[1], tb), pa["rev_src"], g.dtype), cls[0], cls[2],
        tb), reps=1, warmup=0)
    nbytes = fam["bytes"] + pack["bytes"] + fused["bytes"]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    parts = (fam["library_ms"], pack["library_ms"], fused["library_ms"])
    lib = None if None in parts else sum(parts)
    log(f"  {what}: whole op {op!r} ms (halo-T {fam['ms']!r} + pack "
        f"{pack['ms']!r} + fused {fused['ms']!r}); bound {bound!r} ms by "
        f"bytes ({nbytes} B), {100 * bound / op:.1f}% of bound; plain "
        f"{plain!r} ms; library (sparse.mm + index_select + sparse.mm) "
        f"{lib!r} ms")
    return {"ms": op, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": "bytes", "family": fam,
            "pack": pack, "fused": fused}


def phase_asymmetric(ahat_d, feats, labels, pv, widths, dev, tb, steps,
                     k3b):
    """Phases 19–21: the directed flagship graph (serving, training, the
    backward op's time, the bf16 levers).  Returns the launches per
    kernel entry on these main-path runs, the max |kernel − plain|, the
    trainers' initial weights and plan for the repeat phase."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import GatLayerGen
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesGen, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    n = ahat_d.shape[0]
    out = {"k1": 0, "k1_bf16": 0, "k5": 0, "fused": 0, "err": 0.0}

    def reset():
        for c in ("launches", "mask_launches", "bf16_launches",
                  "bf16_mask_launches"):
            setattr(spmm_tiles, c, 0)
        for c in ("launches", "wire_bf16_launches", "bf16_launches"):
            setattr(spmm_tiles_fused, c, 0)
        row_pack.launches = 0
        PspmmTilesGen.backward_launches = GatLayerGen.backward_launches = 0

    def counts():
        return {"k1": spmm_tiles.launches, "k1_bf16": spmm_tiles.bf16_launches,
                "k5": spmm_tiles.mask_launches
                + spmm_tiles.bf16_mask_launches,
                "fused": spmm_tiles_fused.launches,
                "fused_wire": spmm_tiles_fused.wire_bf16_launches,
                "fused_bf16": spmm_tiles_fused.bf16_launches,
                "pack": row_pack.launches,
                "gen_bwd": PspmmTilesGen.backward_launches,
                "gat_gen_bwd": GatLayerGen.backward_launches}

    def book(c):
        out["k1"] += c["k1"]
        out["k1_bf16"] += c["k1_bf16"]
        out["k5"] += c["k5"]
        out["fused"] += c["fused"] + c["fused_wire"] + c["fused_bf16"]
        MAIN_PATH_PACKS[0] += c["pack"]

    # ---------------------------------------------------------- phase 19
    log("phase 19: serve the directed flagship graph (asymmetric Â), GCN "
        f"and GAT 128 -> {' -> '.join(map(str, widths))}, a2a")
    reset()
    eng, _res, _l = serve_and_check(
        "directed flagship GCN", ahat_d, feats, pv, 8, widths, queries=512,
        max_batch=64, seed=3, check_rows=256)
    book(counts())
    plan = eng.plan
    log(f"  directed flagship plan: nnz {ahat_d.nnz}, B {plan.b}, S "
        f"{plan.s}, R {plan.r}, true halo rows {int(plan.halo_counts.sum())}"
        f", EL/EH per part {plan.el}/{plan.eh}, symmetric {plan.symmetric}; "
        f"transposed classes: local "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_tlclasses']]}, halo "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_thclasses']]}, "
        f"owner sum "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_t1classes']]}")
    if plan.symmetric or eng.setup.fwd_static.get("symmetric", True):
        raise AssertionError("the directed flagship plan came out symmetric")
    log_device_busy("directed flagship GCN", lambda: eng.query(np.arange(64)))
    reset()
    eng_g, _res_g, _l = serve_and_check(
        "directed flagship GAT", ahat_d, feats, pv, 8, widths, queries=512,
        max_batch=64, seed=3, check_rows=256, model="gat", plan=plan)
    book(counts())
    log_device_busy("directed flagship GAT",
                    lambda: eng_g.query(np.arange(64)))

    # ---------------------------------------------------------- phase 20
    log("phase 20: train the directed flagship graph, GCN and GAT, 1 "
        "warm-up + 5 timed steps; step-1 gradients vs a float64 backprop "
        "with Â^T, exact launches, every launch of one step == plain")
    data = make_train_data(plan, feats, labels, device=dev)
    tr = FullBatchTrainer(plan, fin=128, widths=widths, seed=5,
                          comm_schedule="a2a", device=dev)
    p_init = [w.detach().cpu().numpy().copy() for w in tr.params]
    zs, caught = forward_backward_trace(tr, data)
    masks = [plan.gather_rows((z > 0).cpu().numpy()) for z in zs[:-1]]
    t0 = time.perf_counter()
    loss64, _g64, _ = backprop64(ahat_d, feats, labels, p_init)
    _, grads64m, flips = backprop64(ahat_d, feats, labels, p_init,
                                    masks=masks)
    log(f"  float64 host backprop with A^T {time.perf_counter() - t0:.2f} s"
        f", loss {loss64!r}; ReLU sign flips by hidden layer: {flips}")
    loss0, _ = tr.evaluate(data)
    if abs(loss0 - loss64) > 1e-5 * abs(loss64):
        raise AssertionError(f"directed GCN initial loss {loss0} vs "
                             f"float64 {loss64}")
    step_grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: None if step_grads else
                                  step_grads.append([w.grad.cpu().numpy()
                                                     for w in tr.params]))
    reset()
    rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
    c = counts()
    book(c)
    nf, nb = len(widths), backward_passes(128, widths)
    want = {"fused": steps * (nf + nb), "pack": steps * (nf + nb),
            "k1": steps * nb, "gen_bwd": steps * nb}
    log(f"  GCN launches {json.dumps(c)}; expected {json.dumps(want)} "
        f"({steps} steps x ({nf} forward + {nb} backward aggregations); a "
        "backward: one K1 family, one pack, one fused)")
    if any(c[key] != v for key, v in want.items()) or c["k5"] \
            or c["fused_wire"] or c["fused_bf16"] or c["k1_bf16"]:
        raise AssertionError("directed GCN training: launch counts differ "
                             "from the passes the program runs")
    losses = [loss0] + rep["loss_history"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"directed GCN: non-finite loss {losses}")
    for i, (got, want_g) in enumerate(zip(step_grads[0], grads64m)):
        rel = float(np.linalg.norm(got - want_g) / np.linalg.norm(want_g))
        log(f"  GCN step-1 dW{i} {got.shape}: relative Frobenius error vs "
            f"float64 (A^T backward, the run's ReLU masks) {rel:.3g}")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"directed GCN layer {i} gradient off "
                                 f"float64 by {rel}")
    comm = {key: rep[key] for key in (
        "exchanges", "total_send_volume", "max_send_volume",
        "max_recv_volume", "wire_rows_per_exchange")}
    log(f"  GCN losses {losses}; epoch_s {rep['epoch_s']!r} (5 timed steps, "
        f"host clock); comm {json.dumps(comm)}")
    log(f"  GCN step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(tr, data))}")
    device_split("directed GCN training", lambda: tr.step(data))
    out["err"] = max(out["err"], check_launches(
        "directed GCN training pass",
        record_launches(lambda: gcn_train_pass(tr, data))))
    st, pa = tr.model.fwd_static, tr.pa
    out["op"] = time_transposed_op(data.h0, pa, st, tb, "directed flagship "
                                   "backward aggregation, layer-0 table "
                                   "f=128")
    log(f"  backward aggregation f=128: asymmetric {out['op']['ms']!r} ms "
        f"(bound {out['op']['bound_ms']!r}) vs the symmetric one (phase 5) "
        f"{k3b['ms']!r} ms (bound {k3b['bound_ms']!r})")
    fwd = time_whole_op(data.h0, pa, st, tb, False, "directed flagship "
                        "forward aggregation layer 0 f=128")
    out["fwd_op"] = fwd

    params_g = gat_params_numpy(7, list(zip([128] + widths[:-1], widths)))
    trg = FullBatchTrainer(plan, fin=128, widths=widths, model="gat",
                           activation="none", params=gat_from_numpy(params_g),
                           comm_schedule="a2a", device=dev)
    t0 = time.perf_counter()
    loss64_g, grads64_g = gat64(ahat_d, feats, params_g, labels=labels)
    log(f"  float64 host GAT autograd on the directed pattern "
        f"{time.perf_counter() - t0:.2f} s, loss {loss64_g!r}")
    loss0_g, _ = trg.evaluate(data)
    if abs(loss0_g - loss64_g) > 1e-5 * abs(loss64_g):
        raise AssertionError(f"directed GAT initial loss {loss0_g} vs "
                             f"float64 {loss64_g}")
    gsteps = []
    trg.opt.register_step_pre_hook(lambda opt, a, kw: None if gsteps else
                                   gsteps.append([
                                       {k: v.grad.cpu().numpy()
                                        for k, v in p.items()}
                                       for p in trg.params]))
    reset()
    rep_g = trg.fit(data, epochs=5, warmup=1, verbose=False)
    c = counts()
    book(c)
    fwd_p, tables = gat_passes(widths), gat_passes(widths)
    want = {"k5": steps * (fwd_p + tables),
            "pack": steps * (pack_launches("gat", "a2a", widths) + tables),
            "fused": steps * tables, "gat_gen_bwd": steps * tables}
    log(f"  GAT launches {json.dumps(c)}; expected {json.dumps(want)} "
        f"({steps} steps x forward {fwd_p} K5 passes and "
        f"{pack_launches('gat', 'a2a', widths)} packs, backward per "
        f"exchanged table ({tables}) one K5 pass, one pack, one fused)")
    if any(c[key] != v for key, v in want.items()) or c["k1"] \
            or c["k1_bf16"] or c["fused_wire"] or c["fused_bf16"]:
        raise AssertionError("directed GAT training: launch counts differ "
                             "from the passes the program runs")
    losses_g = [loss0_g] + rep_g["loss_history"]
    if not np.isfinite(losses_g).all():
        raise AssertionError(f"directed GAT: non-finite loss {losses_g}")
    for i, (got, want_g) in enumerate(zip(gsteps[0], grads64_g)):
        if got["a1"].any():
            raise AssertionError(f"directed GAT layer {i}: a1 gradient is "
                                 "not exactly 0")
        for key in ("w", "a2"):
            rel = float(np.linalg.norm(got[key] - want_g[key])
                        / np.linalg.norm(want_g[key]))
            log(f"  GAT step-1 d{key}{i} {got[key].shape}: relative "
                f"Frobenius error vs float64 autograd {rel:.3g}")
            if not rel <= GRAD_RTOL:
                raise AssertionError(f"directed GAT layer {i} d{key} off "
                                     f"float64 by {rel}")
    log(f"  GAT losses {losses_g}; epoch_s {rep_g['epoch_s']!r}")
    log(f"  GAT step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trg, data))}")
    device_split("directed GAT training", lambda: trg.step(data))
    out["err"] = max(out["err"], check_launches(
        "directed GAT training pass",
        record_launches(lambda: gat_train_pass(trg, data))))

    # ---------------------------------------------------------- phase 21
    log("phase 21: the directed flagship GCN under halo_dtype='bfloat16' "
        "and compute_dtype='bfloat16' from phase 20's initial weights: "
        "losses in the reference's bf16 band of the float32 run, exact "
        "launches, every launch of one step == plain")
    l32 = np.asarray(rep["loss_history"])
    for lever in ("halo_dtype", "compute_dtype"):
        trb = FullBatchTrainer(plan, fin=128, widths=widths, params=p_init,
                               comm_schedule="a2a", device=dev,
                               **{lever: "bfloat16"})
        reset()
        rep_b = trb.fit(data, epochs=5, warmup=1, verbose=False)
        c = counts()
        book(c)
        agg = steps * (nf + nb)
        want = ({"fused_wire": agg, "k1": steps * nb} if lever == "halo_dtype"
                else {"fused_bf16": agg, "k1_bf16": steps * nb})
        want.update(pack=agg, gen_bwd=steps * nb)
        l16 = np.asarray(rep_b["loss_history"])
        band = np.allclose(l16, l32, **BAND_GCN)
        log(f"  GCN {lever}: launches {json.dumps(c)}, expected "
            f"{json.dumps(want)}; losses {l16.tolist()} vs float32 "
            f"{l32.tolist()}: max |gap| {np.abs(l16 - l32).max():.3g}, in "
            f"the band {BAND_GCN}: {band}; epoch_s {rep_b['epoch_s']!r}")
        others = {"fused", "fused_wire", "fused_bf16", "k1", "k1_bf16",
                  "k5"} - set(want)
        if any(c[key] != v for key, v in want.items()) \
                or any(c[key] for key in others):
            raise AssertionError(f"directed GCN {lever}: launch counts "
                                 "differ from the passes the program runs")
        if not band or np.array_equal(l16, l32) \
                or not np.isfinite(l16).all():
            raise AssertionError(f"directed GCN {lever}: losses outside the "
                                 "band or equal to float32")
        out["err"] = max(out["err"], check_launches(
            f"directed GCN {lever} training pass",
            record_launches(lambda trb=trb: gcn_train_pass(trb, data))))
    out.update(plan=plan, data=data, p_init=p_init, params_g=params_g)
    return out


def phase_repeat(fix, dev, asym, widths):
    """Phase 22: the same training run repeated in one process
    (``tools/repeat_run.py``'s ``repeat_training``, fresh trainers from
    the same start): cora2708 GAT a2a (phase 9's configuration, 5 steps)
    20 times, the directed flagship GCN and GAT (phase 20's, 1 + 5 steps)
    3 times each.  Each must give exactly one loss history and one weight
    digest."""
    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.tools.repeat_run import repeat_training
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    plan_c = build_comm_plan(normalize_adjacency(a), read_partvec(
        os.path.join(fix, "cora2708.8.hp")), 8)
    data_c = make_train_data(plan_c, feats, labels, device=dev)
    plan, data = asym["plan"], asym["data"]
    cases = (
        ("cora2708 GAT a2a (phase 9)", 20, 5, data_c, lambda: FullBatchTrainer(
            plan_c, fin=1433, widths=[16, 7], model="gat",
            activation="none", seed=11, comm_schedule="a2a", device=dev)),
        ("directed flagship GCN", 3, 6, data, lambda: FullBatchTrainer(
            plan, fin=128, widths=widths, params=asym["p_init"],
            comm_schedule="a2a", device=dev)),
        ("directed flagship GAT", 3, 6, data, lambda: FullBatchTrainer(
            plan, fin=128, widths=widths, model="gat", activation="none",
            params=gat_from_numpy(asym["params_g"]), comm_schedule="a2a",
            device=dev)))
    for name, runs, steps, d, make in cases:
        t0 = time.perf_counter()
        rep = repeat_training(make, d, steps, runs)
        log(f"  {name}: {runs} runs of {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s: "
            f"{rep['distinct_loss_histories']} loss history(ies) "
            f"{[x['count'] for x in rep['loss_histories']]}, "
            f"{rep['distinct_weight_digests']} weight digest(s) "
            f"{[x['count'] for x in rep['weight_digests']]}; losses "
            f"{[float.fromhex(x) for x in rep['loss_histories'][0]['value']]}")
        if rep["distinct_loss_histories"] != 1 \
                or rep["distinct_weight_digests"] != 1:
            raise AssertionError(f"{name}: repeated runs differ: "
                                 f"{json.dumps(rep)}")


# ------------------------------- checkpoints, crash-safe resume, hot swap
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_ckpt")

# phase 23's training runs: (model, transport) by name; every one trains
# 6 steps in all from the CLI's default seed
CKPT_CASES = {"gcn-a2a": ("gcn", "a2a"), "gcn-ragged": ("gcn", "ragged"),
              "gat-a2a": ("gat", "a2a")}


def launch_counts(zero: bool = False) -> dict:
    """The launch counts of every kernel entry phase 23's paths run (and
    K1's float-weight family entries, which must stay 0 there); with
    ``zero``, each is set to 0 first — the start of a path."""
    from sgcn_tpu_torch.models.gat import GatLayerSym
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesRagged,
                                              PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)

    owners = {"fused": (spmm_tiles_fused, "launches"),
              "pack": (row_pack, "launches"),
              "k5": (spmm_tiles, "mask_launches"),
              "k1": (spmm_tiles, "launches"),
              "k1_bf16": (spmm_tiles, "bf16_launches"),
              "sym_bwd": (PspmmTilesSym, "backward_launches"),
              "gat_bwd": (GatLayerSym, "backward_launches"),
              "ring": (PspmmTilesRagged, "launches"),
              "ring_bwd": (PspmmTilesRagged, "backward_launches")}
    if zero:
        for obj, attr in owners.values():
            setattr(obj, attr, 0)
    return {key: getattr(obj, attr) for key, (obj, attr) in owners.items()}


def ckpt_child(argv, fault, out_path):
    """One process of phase 23, started with the ``spawn`` context:
    ``python -m sgcn_tpu_torch.train argv`` in-process on the card under
    ``$SGCN_FAULT=fault`` (``None``: no fault), set here before the CLI
    builds anything.  When the CLI returns, writes its JSON report, the
    warnings it raised, its launch counts and its clock marks to
    ``out_path``; a run the fault kills writes nothing."""
    t_enter = time.time()
    if fault:
        os.environ["SGCN_FAULT"] = fault
    else:
        os.environ.pop("SGCN_FAULT", None)
    sys.path.insert(0, REPO)
    import warnings

    import torch

    from sgcn_tpu_torch.train.__main__ import main as train_main

    launch_counts(zero=True)                 # this child's path starts here
    t_imported = time.time()
    out = io.StringIO()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(out):
        warnings.simplefilter("always")
        train_main(list(argv))
    torch.cuda.synchronize()
    launches = launch_counts()                # ... and ends here
    with open(out_path, "w") as fh:
        json.dump({"report": json.loads(out.getvalue().strip()
                                        .splitlines()[-1]),
                   "warnings": [str(w.message) for w in caught],
                   "launches": launches, "t_enter": t_enter,
                   "t_imported": t_imported, "t_end": time.time()}, fh)


class Children:
    """Phase 23's child processes: ``start`` spawns one per job, all at
    once; ``join`` waits for them (a child alive past the deadline is
    terminated and fails the run); ``stop`` terminates whatever still
    runs, so no child outlives the script."""

    def __init__(self):
        import torch.multiprocessing as mp

        self.ctx = mp.get_context("spawn")
        self.running = []

    def start(self, jobs):
        procs = []
        for job in jobs:
            p = self.ctx.Process(target=ckpt_child, args=job)
            t = time.time()
            p.start()
            procs.append((p, t))
        self.running += [p for p, _ in procs]
        return procs

    def join(self, procs, timeout=600.0):
        deadline = time.monotonic() + timeout
        codes = []
        for p, _ in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                self.stop()
                raise AssertionError(f"phase 23: child {p.pid} still runs "
                                     f"after {timeout:.0f} s")
            codes.append(p.exitcode)
        return codes

    def stop(self):
        for p in self.running:
            if p.is_alive():
                p.terminate()
                p.join()


def leaves_digest(leaves) -> str:
    """sha256 over a checkpoint leaf list's dtypes, shapes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for x in leaves:
        x = np.ascontiguousarray(x)
        h.update(repr((x.dtype.str, x.shape)).encode())
        h.update(x.tobytes())
    return h.hexdigest()[:16]


def phase_checkpoints(plan, ahat, feats, labels, pv, widths, data, dev, smi):
    """Phase 23: checkpoints, crash-safe resume and serving from a
    checkpoint at the flagship width (module docstring).  Returns the
    launch counts of its paths (this process's and the resumed
    children's) by kernel entry."""
    children = Children()
    try:
        return _phase_checkpoints(children, plan, ahat, feats, labels, pv,
                                  widths, data, dev, smi)
    finally:
        children.stop()


def _phase_checkpoints(children, plan, ahat, feats, labels, pv, widths,
                       data, dev, smi):
    import shutil
    import warnings

    import numpy as np
    import scipy.sparse as sp
    import torch

    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import balanced_random_partition
    from sgcn_tpu_torch.resilience import faults
    from sgcn_tpu_torch.resilience.checkpoint import CheckpointManager
    from sgcn_tpu_torch.serve import ServeEngine, synthetic_query_ids
    from sgcn_tpu_torch.serve.engine import CheckpointWatcher
    from sgcn_tpu_torch.train import FullBatchTrainer
    from sgcn_tpu_torch.train.fullbatch import MODELS
    from sgcn_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint, to_leaves)

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    n, fin = feats.shape
    t0 = time.perf_counter()
    npz = os.path.join(CKPT_DIR, "flagship.npz")
    a = sp.csr_matrix(ahat)
    np.savez(npz, adj_data=a.data, adj_indices=a.indices,
             adj_indptr=a.indptr, adj_shape=np.asarray(a.shape),
             attr_matrix=feats, labels=np.asarray(labels))
    parts = os.path.join(CKPT_DIR, "flagship.8.rp")
    np.savetxt(parts, pv, fmt="%d")
    log(f"  inputs for the children (Â as normalized, features, labels, "
        f"parts) written in {time.perf_counter() - t0:.2f} s")
    base = ["--npz", npz, "-p", parts, "-s", "8", "-l", str(len(widths)),
            "--hidden", str(widths[0]), "--warmup", "0", "--epochs", "6",
            "--device", "cuda"]
    argv, jobs, resumes = {}, [], []
    for case, (model, sched) in CKPT_CASES.items():
        argv[case] = base + ["--model", model, "--comm-schedule", sched,
                             "--checkpoint-dir", os.path.join(CKPT_DIR, case),
                             "--checkpoint-every", "3"]
        jobs.append((argv[case], "kill-after-save:3",
                     os.path.join(CKPT_DIR, f"{case}.kill.json")))
    argv["bitflip"] = base + ["--comm-schedule", "a2a", "--checkpoint-dir",
                              os.path.join(CKPT_DIR, "bitflip"),
                              "--checkpoint-every", "2"]
    jobs.append((argv["bitflip"], "corrupt-after-save:4:bitflip",
                 os.path.join(CKPT_DIR, "bitflip.kill.json")))
    names = list(CKPT_CASES) + ["bitflip"]

    # ---- (a) 4 children killed after a save, while this process trains
    # the same runs uninterrupted (6 steps from the CLI's seed 0); the
    # a2a GCN also writes the hot-swap directory at steps 4 and 6
    launch_counts(zero=True)                  # the phase's path starts here
    wave = children.start(jobs)
    hot = os.path.join(CKPT_DIR, "hot")
    q = synthetic_query_ids(n, 256, seed=7)
    full, hot_rows = {}, {}
    for case, (model, sched) in CKPT_CASES.items():
        tr = FullBatchTrainer(plan, fin=fin, widths=widths, model=model,
                              activation=MODELS[model].activation, seed=0,
                              comm_schedule=sched, device=dev)
        losses = []
        for step in range(1, 7):
            losses.append(tr.step(data))
            if case == "gcn-a2a" and step in (4, 6):
                CheckpointManager(hot).save(tr, step)
                hot_rows[step] = tr.predict(data)[q]
        full[case] = (tr, losses)
        log(f"  {case}: uninterrupted losses {losses}")
    codes = children.join(wave)
    listing = {c: sorted(os.listdir(os.path.join(CKPT_DIR, c)))
               for c in names}
    log(f"  killed children: exit codes {dict(zip(names, codes))}, "
        f"directories {listing}")
    if codes != [faults.FAULT_EXIT_CODE] * len(jobs):
        raise AssertionError(f"phase 23: killed children exited {codes}, "
                             f"expected {faults.FAULT_EXIT_CODE} each")
    want_ls = {c: ["ckpt_00000003.npz"] for c in CKPT_CASES}
    want_ls["bitflip"] = ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    if listing != want_ls:
        raise AssertionError(f"phase 23: checkpoint directories {listing}")

    # ---- a new process per killed run: --resume auto to 6 steps
    for case in names:
        resumes.append((argv[case] + [
            "--resume", "auto", "--save-checkpoint",
            os.path.join(CKPT_DIR, f"{case}.final.npz")], None,
            os.path.join(CKPT_DIR, f"{case}.resume.json")))
    wave = children.start(resumes)
    codes = children.join(wave)
    if codes != [0] * len(resumes):
        raise AssertionError(f"phase 23: resumed children exited {codes}")
    child_launches = {}
    for (p, t_spawn), case in zip(wave, names):
        with open(os.path.join(CKPT_DIR, f"{case}.resume.json")) as fh:
            res = json.load(fh)
        rep = res["report"]
        model, _ = CKPT_CASES.get(case, ("gcn", "a2a"))
        tr, losses = full[case if case in CKPT_CASES else "gcn-a2a"]
        start = 2 if case == "bitflip" else 3
        setup_s = res["t_end"] - res["t_imported"] - rep["elapsed_s"]
        log(f"  {case}: resumed at step {rep['resumed']['step']} "
            f"(fallback {rep['resumed']['fallback']}), losses "
            f"{rep['losses']}; child start-up {res['t_enter'] - t_spawn:.2f}"
            f" s interpreter + {res['t_imported'] - res['t_enter']:.2f} s "
            f"imports + {setup_s:.2f} s inputs, plan, trainer, resume load "
            f"and final save; training {rep['elapsed_s']:.3f} s "
            f"({rep['steps_run']} steps, step_s_wall "
            f"{rep['step_s_wall']:.4f} s); 4 children at once; card: {smi}")
        if rep["resumed"]["step"] != start or rep["losses"] != losses[start:]:
            raise AssertionError(f"phase 23 {case}: resumed losses "
                                 f"{rep['losses']} != uninterrupted "
                                 f"{losses[start:]}")
        if case == "bitflip" and not (rep["resumed"]["fallback"] and any(
                "ckpt_00000004.npz" in w and "falling back" in w
                for w in res["warnings"])):
            raise AssertionError(f"phase 23: no fallback warning past the "
                                 f"corrupt step-4 file: {res['warnings']}")
        with np.load(os.path.join(CKPT_DIR, f"{case}.final.npz")) as z:
            got = [z[f"leaf_{i}"] for i in range(
                sum(f.startswith("leaf_") for f in z.files))]
            state = json.loads(str(z["__train_state__"]))
        want = to_leaves(tr.params, tr.opt)
        d_got, d_want = leaves_digest(got), leaves_digest(want)
        log(f"  {case}: weights + Adam state digest resumed {d_got}, "
            f"uninterrupted {d_want}; step_count {state['step_count']}")
        if d_got != d_want or state["step_count"] != 6 or \
                state["comm_stats"]["exchanges"] != 6 * 2 * len(widths):
            raise AssertionError(f"phase 23 {case}: the resumed state "
                                 "differs from the uninterrupted run's")
        ln = res["launches"]
        # GAT: K5 passes and packs; GCN: packs and fused launches,
        # through the ring's Function or the a2a one
        need = (["pack", "k5", "gat_bwd"] if model == "gat" else
                ["pack", "fused"] + (["ring", "ring_bwd"] if "ragged" in case
                                     else ["sym_bwd"]))
        if any(not ln[key] for key in need) or ln["k1"] or ln["k1_bf16"]:
            raise AssertionError(f"phase 23 {case}: child launches {ln}")
        child_launches[case] = ln

    # ---- (b) serve from the step-6 files the resumed children wrote
    for case in ("gcn-a2a", "gat-a2a"):
        model = CKPT_CASES[case][0]
        path = os.path.join(CKPT_DIR, case, "ckpt_00000006.npz")
        tr = full[case][0]
        eng = ServeEngine(plan, fin=fin, widths=widths, model=model,
                          comm_schedule="a2a", checkpoint=path,
                          max_batch=64, device=dev)
        eng.set_features(feats)
        rows = np.concatenate([eng.query(q[i:i + 64])
                               for i in range(0, len(q), 64)])
        pred = tr.predict(data)[q]
        params = [{k: v.detach().cpu().numpy() for k, v in p.items()}
                  if isinstance(p, dict) else p.detach().cpu().numpy()
                  for p in tr.params]
        want = (gat64(ahat, feats, params) if model == "gat"
                else oracle_forward(ahat, feats, params))[q]
        err = np.abs(rows - want)
        log(f"  {case}: engine from the step-6 file, {len(q)} rows: == "
            f"the trainer's predict rows {np.array_equal(rows, pred)}; vs "
            f"float64 max abs err {err.max():.3g}, max rel err "
            f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3g}")
        if not np.array_equal(rows, pred):
            raise AssertionError(f"phase 23 {case}: served rows differ from "
                                 "the trainer's predict rows")
        if not np.allclose(rows, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"phase 23 {case}: served rows differ from "
                                 f"float64 beyond rtol {RTOL}, atol {ATOL}")
        del eng
    path = os.path.join(CKPT_DIR, "gcn-a2a", "ckpt_00000006.npz")
    t0 = time.perf_counter()
    plan2 = build_comm_plan(ahat, balanced_random_partition(n, 8, seed=1), 8)
    log(f"  another part vector's plan built in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    for what, p_, w_, msg in (
            ("part vector", plan2, widths,
             "plan digest mismatch — checkpoint was saved under plan"),
            ("widths", plan, [widths[0], 64, widths[-1]],
             "model config mismatch on 'widths'")):
        try:
            ServeEngine(p_, fin=fin, widths=w_, checkpoint=path, device=dev)
        except ValueError as e:
            if msg not in str(e):
                raise
            log(f"  refused under another {what}: {str(e)[:90]}...")
        else:
            raise AssertionError(f"phase 23: a checkpoint under another "
                                 f"{what} was not refused")

    # ---- (c) hot swap on a random-weight engine
    eng = ServeEngine(plan, fin=fin, widths=widths, comm_schedule="a2a",
                      seed=11, max_batch=64, device=dev)
    eng.set_features(feats)
    rows_r = eng.query(q[:64])
    init = [p.detach().cpu().numpy() for p in eng.model.layer_params()]
    if not np.allclose(rows_r, oracle_forward(ahat, feats, init)[q[:64]],
                       rtol=RTOL, atol=ATOL):
        raise AssertionError("phase 23: random-weight rows differ from "
                             "float64")
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    watch = eng.attach_checkpoint_watch(hot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swapped = watch.poll(eng)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    rows = eng.query(q[:64])
    ok = (swapped and eng.weights_rev == 1 and np.array_equal(
        rows, hot_rows[6][:64])
        and [p.data_ptr() for p in eng.model.parameters()] == ptrs)
    log(f"  hot swap: one poll + swap of the step-6 file "
        f"{swap_ms:.2f} ms wall; weights_rev {eng.weights_rev}, rows == "
        f"the trainer's {np.array_equal(rows, hot_rows[6][:64])}, storage "
        f"kept {[p.data_ptr() for p in eng.model.parameters()] == ptrs}; "
        f"card: {smi}")
    if not ok:
        raise AssertionError("phase 23: hot swap failed")
    bad = os.path.join(CKPT_DIR, "hot_corrupt")
    shutil.copytree(hot, bad)
    faults.corrupt_file(os.path.join(bad, "ckpt_00000006.npz"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        swapped = CheckpointWatcher(bad).poll(eng)
    rows = eng.query(q[:64])
    warned = any("corrupt" in str(w.message) for w in caught)
    log(f"  corrupt newest file: swapped {swapped}, warned {warned}, now "
        f"step {eng.checkpoint_meta['step']}, weights_rev "
        f"{eng.weights_rev}, rows == the trainer's step-4 rows "
        f"{np.array_equal(rows, hot_rows[4][:64])}")
    if not (swapped and warned and eng.checkpoint_meta["step"] == 4
            and eng.weights_rev == 2
            and np.array_equal(rows, hot_rows[4][:64])
            and [p.data_ptr() for p in eng.model.parameters()] == ptrs):
        raise AssertionError("phase 23: the poll did not skip the corrupt "
                             "newest file")
    del eng

    # ---- (d) the flagship checkpoint's save and load on the card
    for case in ("gcn-a2a", "gat-a2a"):
        tr = full[case][0]
        path = os.path.join(CKPT_DIR, f"timing_{case}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(tr, path, step=6)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        load_checkpoint(tr, path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        log(f"  {case} flagship checkpoint: {os.path.getsize(path)} bytes, "
            f"save {save_ms:.2f} ms, load {load_ms:.2f} ms wall; card: {smi}")
    parent = launch_counts()                  # ... and ends here
    if parent["k1"] or parent["k1_bf16"]:
        raise AssertionError(f"phase 23: K1 family launches {parent}")
    total = {key: parent[key] + sum(ln[key] for ln in child_launches.values())
             for key in parent}
    log(f"  phase 23 launches (this process {parent}, resumed children "
        f"{child_launches}); phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "sgcn_tpu_torch")):
        print("chip_smoke: sgcn_tpu_torch/ is not beside this script — run "
              "it from a checkout of the repository", file=sys.stderr)
        return 3
    import numpy as np

    from sgcn_tpu_torch.io.datasets import er_graph, load_npz_dataset
    from sgcn_tpu_torch.ops import _build
    from sgcn_tpu_torch.ops.tile_spmm import choose_tile_dispatch
    from sgcn_tpu_torch.partition import (balanced_random_partition,
                                          read_partvec)
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.utils.backend import resolve_device

    t_start = time.perf_counter()
    # every phase names its transport; the accuracy harness (phase 4) has
    # no knob and takes the default, so the variable must not choose it
    os.environ.pop("SGCN_COMM_SCHEDULE", None)
    # ---------------------------------------------------------- phase 0
    smi = nvidia_smi_line()
    dev = resolve_device("cuda")             # TF32 off for the dense matmuls
    log(f"phase 0: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  kernel build {time.perf_counter() - t0:.2f} s wall: "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for k, v in built.items():
        for line in ptxas_report(v["log"]):
            log(f"    {k}: {line}")

    # ---------------------------------------------------------- phase 1
    log("phase 1: tile SpMM kernel vs plain version on random tiles")
    rng = np.random.default_rng(0)
    k, tb, n = 8, 256, 6000
    classes = ((2, 2048, "tile_spmm"), (6, 512, "tile_spmm"),
               (12, 64, "tile_spmm"), (4, 1024, "tile_spmm"))
    tiles_np = random_class_tiles(rng, k, [c[:2] for c in classes], tb, n)
    tiles = [torch.as_tensor(a).to(dev) for a in tiles_np]
    max_err = 0.0
    tables = {}                                  # f -> (aligned, unaligned)
    for f in (1, 7, 8, 16, 17, 40, 41, 128, 129):
        table = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        tables[f] = (table, unaligned_copy(table))
        for t_, how in zip(tables[f], ("", " unaligned")):
            max_err = max(max_err, check_k1(tiles, t_, classes, tb,
                                            f"random tiles f={f}{how}"))
        if f in (16, 40, 128):
            time_k1(tiles_np, tiles, table, classes, tb, n,
                    f"random tiles f={f}")
    log("phase 1b: the row pack and the fused local + remote entry vs "
        "their plain versions on random inputs")
    fused_err = phase_pack_fused_random(rng, dev, tiles, classes, tb, n)

    # ---------------------------------------------------------- phase 2
    log("phase 2: serve cora2708, k=8 hp, GCN 1433 -> 16 -> 7 (ReLU)")
    fix = os.path.join(REPO, "tests", "fixtures")
    a, feats, _ = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    ahat = normalize_adjacency(a)
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    eng_c, _res_c, launches_c = serve_and_check(
        "cora2708", ahat, feats, pv, 8, [16, 7], queries=128, max_batch=32,
        seed=1)
    log_device_busy("cora2708", lambda: eng_c.query(np.arange(32)))
    pa = eng_c.pa
    st = eng_c.setup.fwd_static
    x16 = torch.as_tensor(rng.standard_normal(
        (8, eng_c.plan.b, 16)).astype(np.float32)).to(dev)
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    ltiles_np = [t.cpu().numpy() for t in ltiles]
    max_err = max(max_err, check_k1(ltiles, x16, st["pallas_lclasses"], tb,
                                    "cora local pass f=16"))
    time_k1(ltiles_np, ltiles, x16, st["pallas_lclasses"], tb,
            eng_c.plan.b, "cora local pass f=16")

    # ---------------------------------------------------------- phase 3
    n_f = FLAGSHIP_N
    log(f"phase 3: serve ER n={n_f} deg 14, k=8 rp, GCN 128 -> 128 -> "
        "128 -> 40 (ReLU)")
    t0 = time.perf_counter()
    ahat_f = normalize_adjacency(er_graph(n_f, avg_deg=14, seed=0))
    feats_f = np.random.default_rng(2).standard_normal(
        (n_f, 128)).astype(np.float32)
    pv_f = balanced_random_partition(n_f, 8, seed=0)
    log(f"  graph + features {time.perf_counter() - t0:.2f} s, "
        f"nnz {ahat_f.nnz}")
    eng_f, res_f, launches_f = serve_and_check(
        "flagship", ahat_f, feats_f, pv_f, 8, [128, 128, 40], queries=512,
        max_batch=64, seed=3, check_rows=256)
    pa, st, plan = eng_f.pa, eng_f.setup.fwd_static, eng_f.plan
    decision = {}
    choose_tile_dispatch(plan, tb=tb, decision=decision)
    log(f"  dispatch: {json.dumps(decision['tile_dispatch'])}")
    bd_f = forward_breakdown(eng_f)
    for row in bd_f:
        log(f"  forward breakdown: {json.dumps(row)}")
    log_device_busy("flagship", lambda: eng_f.query(np.arange(64)))

    from sgcn_tpu_torch.ops.pspmm import exchange_recv
    h0 = eng_f._h0
    recv = exchange_recv(h0, pa["recv_src"])
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    htiles = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    check_pack(h0, pa["recv_src"], h0.dtype, "flagship layer-0 exchange")
    fused_err = max(fused_err, check_fused(
        ltiles, h0, htiles, recv, st["pallas_lclasses"],
        st["pallas_hclasses"], tb, "flagship layer-0 fused f=128"))
    max_err = max(max_err, check_k1(ltiles, h0, st["pallas_lclasses"], tb,
                                    "flagship local pass f=128"))
    max_err = max(max_err, check_k1(htiles, recv, st["pallas_hclasses"], tb,
                                    "flagship halo pass f=128 (on the "
                                    "receive buffer)"))
    t_loc = time_k1([t.cpu().numpy() for t in ltiles], ltiles, h0,
                    st["pallas_lclasses"], tb, plan.b,
                    "flagship local pass f=128")
    t_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, recv,
                     st["pallas_hclasses"], tb, recv.shape[1],
                     "flagship halo pass f=128")
    layer = {key: t_loc[key] + t_halo[key]
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"  flagship per-layer K1 time (local + halo family launches, "
        f"f=128): {layer['ms']!r} ms; bound {layer['bound_ms']!r} ms")
    k3 = time_whole_op(h0, pa, st, tb, False,
                       "flagship K3 layer 0 forward f=128")

    # ---------------------------------------------------------- phase 4
    log("phase 4: train cora2708 on the card, k=8 hp, GCN 1433 -> 16 -> 7 "
        "(python -m sgcn_tpu_torch.train --experiment accuracy --epochs 60)")
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
    from sgcn_tpu_torch.train.__main__ import main as train_main

    epochs_c = 60
    fam = 1               # an aggregation: one fused tile launch, one pack
    out = io.StringIO()
    t0 = time.perf_counter()
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesSym.backward_launches = 0
    with contextlib.redirect_stdout(out):
        train_main(["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                    "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8",
                    "-l", "2", "--hidden", "16", "--experiment", "accuracy",
                    "--epochs", str(epochs_c)])
    k1_close()
    launches_tc = spmm_tiles_fused.launches     # ... and ends here
    packs_tc = row_pack.launches
    bwd_tc = PspmmTilesSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_tc
    acc = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  report ({time.perf_counter() - t0:.2f} s): {json.dumps(acc)}")
    # per epoch 2 forward + 2 backward passes (layer 0 projects first),
    # then one evaluation forward; every pass launches once: one fused
    # tile launch and one pack
    want_c = (epochs_c * (2 + backward_passes(1433, [16, 7])) + 2) * fam
    want_bwd_c = epochs_c * backward_passes(1433, [16, 7]) * fam
    log(f"  fused launches {launches_tc} (backward {bwd_tc}), row pack "
        f"{packs_tc}; expected {want_c} ({want_bwd_c}), {want_c}")
    if launches_tc != want_c or bwd_tc != want_bwd_c or packs_tc != want_c:
        raise AssertionError("cora training: kernel launch count differs "
                             "from the passes the program runs")
    gap = abs(acc["oracle_test_acc"] - acc["fullbatch_test_acc"])
    if not (acc["oracle_test_acc"] > 0.75 and gap < 0.03):
        raise AssertionError(f"cora accuracy outside the bands (oracle > "
                             f"0.75, |oracle - fullbatch| < 0.03): {acc}")

    # ---------------------------------------------------------- phase 5
    log(f"phase 5: train ER n={n_f} deg 14, k=8 rp, GCN 128 -> 128 -> 128 "
        "-> 40 (ReLU, xent), 1 warm-up + 5 timed steps")
    widths_f = [128, 128, 40]
    labels_f = np.random.default_rng(4).integers(0, 40, n_f)
    tr = FullBatchTrainer(plan, fin=128, widths=widths_f, seed=5,
                          comm_schedule="a2a", device=dev)
    data = make_train_data(plan, feats_f, labels_f, device=dev)
    p_init = [w.detach().cpu().numpy().copy() for w in tr.params]
    zs, caught = forward_backward_trace(tr, data)      # at the step-1 weights
    masks = [plan.gather_rows((z > 0).cpu().numpy()) for z in zs[:-1]]
    t0 = time.perf_counter()
    loss64, grads64, _ = backprop64(ahat_f, feats_f, labels_f, p_init)
    _, grads64m, flips = backprop64(ahat_f, feats_f, labels_f, p_init,
                                    masks=masks)
    log(f"  float64 host backprop {time.perf_counter() - t0:.2f} s (twice), "
        f"loss {loss64!r}; ReLU entries whose sign float32 and float64 "
        f"disagree on, by hidden layer: {flips}")
    loss0, _ = tr.evaluate(data)
    if abs(loss0 - loss64) > 1e-5 * abs(loss64):
        raise AssertionError(f"initial loss {loss0} vs float64 {loss64}")
    step_grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: None if step_grads else
                                  step_grads.append([w.grad.cpu().numpy()
                                                     for w in tr.params]))
    steps_f = 1 + 5
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesSym.backward_launches = 0
    rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_tf = spmm_tiles_fused.launches     # ... and ends here
    packs_tf = row_pack.launches
    bwd_tf = PspmmTilesSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_tf
    # the weights right after fit, before the breakdown steps move them
    # (phase 11 trains the ring from the same start and must end here)
    fit_f = [w.detach().clone() for w in tr.params]
    bwd_f = backward_passes(128, widths_f)
    want_f = steps_f * (len(widths_f) + bwd_f) * fam
    log(f"  fused launches {launches_tf} (backward {bwd_tf}), row pack "
        f"{packs_tf}; each = {steps_f} steps x ({len(widths_f)} forward + "
        f"{bwd_f} backward aggregations) = {want_f}")
    if launches_tf != want_f or bwd_tf != steps_f * bwd_f * fam \
            or packs_tf != want_f:
        raise AssertionError("flagship training: kernel launch count "
                             "differs from the passes the program runs")
    losses = [loss0] + rep["loss_history"]
    log(f"  losses (initial eval, timed steps): {losses}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    for i, (got, want, own) in enumerate(zip(step_grads[0], grads64m,
                                              grads64)):
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        rel_own = float(np.linalg.norm(got - own) / np.linalg.norm(own))
        log(f"  step-1 dW{i} {got.shape}: relative Frobenius error vs "
            f"float64 {rel:.3g} with the run's ReLU masks, {rel_own:.3g} "
            f"with float64's own")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"layer {i} gradient off float64 by {rel}")
    log(f"  epoch_s {rep['epoch_s']!r} (5 timed steps, host clock); "
        f"phases {json.dumps(rep['phases'])}")
    log(f"  step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(tr, data))}")
    log_device_busy("flagship training", lambda: tr.step(data), reps=3,
                    what="steps")

    layer_b = max(caught)                       # the deepest backward pass
    g = caught[layer_b]
    ghalo = exchange_recv(g, pa["recv_src"])
    grad_err = max(
        check_k1(ltiles, g, st["pallas_lclasses"], tb,
                 f"flagship layer-{layer_b} gradient local pass f=128"),
        check_k1(htiles, ghalo, st["pallas_hclasses"], tb,
                 f"flagship layer-{layer_b} gradient halo pass f=128"))
    fused_err = max(fused_err, check_fused(
        ltiles, g, htiles, ghalo, st["pallas_lclasses"],
        st["pallas_hclasses"], tb, f"flagship layer-{layer_b} gradient "
        "fused f=128"))
    k3b = time_whole_op(g, pa, st, tb, False, f"flagship K3 layer-{layer_b}"
                        " backward (on the gradient) f=128")
    b_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, ghalo,
                     st["pallas_hclasses"], tb, ghalo.shape[1],
                     f"flagship layer-{layer_b} gradient halo pass f=128")
    # K2: the halo family is one launch (timed above); one degree class
    # alone, the largest halo class by stored slots, is the unit the
    # per-class dispatch launched before
    hcls = st["pallas_hclasses"]
    c = max(range(len(hcls)), key=lambda j: hcls[j][0] * hcls[j][1])
    off = sum(t * e for t, e, *_ in hcls[:c])
    size = hcls[c][0] * hcls[c][1]
    ctiles = [x[:, off: off + size] for x in htiles]
    time_k1([x.cpu().numpy() for x in ctiles], ctiles, ghalo, (hcls[c],), tb,
            ghalo.shape[1], f"flagship largest halo class {hcls[c][:2]} on the "
            f"layer-{layer_b} gradient, f=128")
    log(f"  K2: the halo family's {len(hcls)} classes in one launch "
        f"{b_halo['ms']!r} ms (bound {b_halo['bound_ms']!r} ms)")

    # ---------------------------------------------------------- phase 6
    log("phase 6: K5 — the int8-mask entry point vs its plain version and "
        "K1 on the upcast mask, on phase 1's tiles as 0/1 masks")
    from sgcn_tpu_torch.models.gat import GatLayerSym
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_classes

    mask_np = (tiles_np[0], tiles_np[1], (tiles_np[2] != 0).astype(np.int8))
    mtiles = [torch.as_tensor(x).to(dev) for x in mask_np]
    k5_err = 0.0
    for f, (table, odd) in tables.items():
        for t_, how in ((table, ""), (odd, " unaligned")):
            k5_err = max(k5_err, check_k1(mtiles, t_, classes, tb,
                                          f"K5 random tiles f={f}{how}"))
        k1_up = spmm_tiles_classes(*mtiles[:2], mtiles[2].float(), table,
                                   classes, tb)
        if not torch.equal(k1_up, spmm_tiles_classes(*mtiles, table,
                                                     classes, tb)):
            raise AssertionError(f"K5 f={f}: mask kernel != K1 on the "
                                 "upcast mask")
        log(f"  K5 random tiles f={f}: == K1 on the upcast mask")
        if f in (1, 41, 128):
            time_k1(mask_np, mtiles, table, classes, tb, n,
                    f"K5 random tiles f={f}")

    # ---------------------------------------------------------- phase 7
    log("phase 7: serve GAT (no activation): cora2708 k=8 hp 1433 -> 16 -> "
        "7, and phase 3's graph, features and plan at 128 -> 128 -> 128 -> "
        "40")
    eng_gc, _res_gc, launches_gc = serve_and_check(
        "cora2708 GAT", ahat, feats, pv, 8, [16, 7], queries=128,
        max_batch=32, seed=1, model="gat")
    log_device_busy("cora2708 GAT", lambda: eng_gc.query(np.arange(32)))
    widths_f = [128, 128, 40]
    eng_gf, _res_gf, launches_gf = serve_and_check(
        "flagship GAT", ahat_f, feats_f, pv_f, 8, widths_f, queries=512,
        max_batch=64, seed=3, check_rows=256, model="gat", plan=plan)
    cls_g = eng_gf.setup.fwd_static["pallas_cclasses"]
    bd_gf = gat_forward_breakdown(eng_gf)
    for row in bd_gf:
        log(f"  GAT forward breakdown: {json.dumps(row)}")
    log_device_busy("flagship GAT", lambda: eng_gf.query(np.arange(64)))

    # ---------------------------------------------------------- phase 8
    log("phase 8: train GAT on phase 5's graph, features, labels and plan, "
        "128 -> 128 -> 128 -> 40 (no activation, xent), 1 warm-up + 5 timed "
        "steps")
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy

    params_g = gat_params_numpy(7, list(zip([128] + widths_f[:-1],
                                            widths_f)))
    trg = FullBatchTrainer(plan, fin=128, widths=widths_f, model="gat",
                           activation="none", params=gat_from_numpy(params_g),
                           comm_schedule="a2a", device=dev)
    t0 = time.perf_counter()
    loss64_g, grads64_g = gat64(ahat_f, feats_f, params_g, labels=labels_f)
    log(f"  float64 host GAT backprop (torch autograd, CPU) "
        f"{time.perf_counter() - t0:.2f} s, loss {loss64_g!r}")
    loss0_g, _ = trg.evaluate(data)
    if abs(loss0_g - loss64_g) > 1e-5 * abs(loss64_g):
        raise AssertionError(f"GAT initial loss {loss0_g} vs float64 "
                             f"{loss64_g}")
    gsteps = []
    trg.opt.register_step_pre_hook(lambda opt, a, kw: None if gsteps else
                                   gsteps.append([
                                       {k: v.grad.cpu().numpy()
                                        for k, v in p.items()}
                                       for p in trg.params]))
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    rep_g = trg.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_gt = spmm_tiles.mask_launches      # ... and ends here
    packs_gt = row_pack.launches
    bwd_gt = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gt
    fit_g = [p.detach().clone() for p in trg.model.parameters()]
    want_gt = steps_f * 2 * gat_passes(widths_f)
    want_pg = steps_f * 2 * pack_launches("gat", "a2a", widths_f)
    log(f"  K5 launches {launches_gt} (backward {bwd_gt}) = {steps_f} steps "
        f"x 2 directions x {gat_passes(widths_f)} passes (each over "
        f"{len(cls_g)} classes) = {want_gt}; row pack {packs_gt} (expected "
        f"{want_pg})")
    if launches_gt != want_gt or bwd_gt != want_gt // 2 \
            or packs_gt != want_pg:
        raise AssertionError("flagship GAT training: K5 launch count "
                             "differs from the passes the program runs")
    losses_g = [loss0_g] + rep_g["loss_history"]
    log(f"  losses (initial eval, timed steps): {losses_g}")
    if not np.isfinite(losses_g).all():
        raise AssertionError(f"non-finite GAT loss: {losses_g}")
    for i, (got, want) in enumerate(zip(gsteps[0], grads64_g)):
        if got["a1"].any():
            raise AssertionError(f"layer {i}: a1 gradient is not exactly 0")
        for key in ("w", "a2"):
            rel = float(np.linalg.norm(got[key] - want[key])
                        / np.linalg.norm(want[key]))
            log(f"  step-1 d{key}{i} {got[key].shape}: relative Frobenius "
                f"error vs float64 {rel:.3g}")
            if not rel <= GRAD_RTOL:
                raise AssertionError(f"GAT layer {i} d{key} off float64 by "
                                     f"{rel}")
        log(f"  step-1 da1{i}: exactly 0 (float64 autograd's "
            f"|da1| {np.linalg.norm(want['a1']):.3g}, zero up to rounding)")
    log(f"  epoch_s {rep_g['epoch_s']!r} (5 timed steps, host clock); "
        f"phases {json.dumps(rep_g['phases'])}")
    log(f"  step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trg, data))}")
    log_device_busy("flagship GAT training", lambda: trg.step(data), reps=3,
                    what="steps")
    calls = record_gat_passes(lambda: gat_train_pass(trg, data))
    nl = len(widths_f)
    want_passes = [gat_passes([w]) for w in widths_f]
    if [len(c) for c in calls] != want_passes + want_passes[::-1]:
        raise AssertionError(f"recorded K5 passes per aggregation "
                             f"{[len(c) for c in calls]}, expected the "
                             f"forward's {want_passes} and the backward's "
                             "in reverse")
    # the flagship layer: layer 0's forward and layer 1's backward, both
    # split (f = 128 numerator + f = 1 denominator)
    err_f, gat_fwd = check_time_gat_call(calls[0], "flagship GAT layer-0 "
                                         "forward")
    err_b, gat_bwd = check_time_gat_call(calls[nl + 1], "flagship GAT "
                                         "layer-1 backward")
    err_b = max(err_b, check_gat_passes(           # the other backward passes
        [calls[nl], calls[2 * nl - 1]], "flagship GAT backward"))

    # ---------------------------------------------------------- phase 9
    log("phase 9: train cora2708 GAT on the card through the CLI (--model "
        "gat --epochs 5 --warmup 0), against the dense GAT oracle from the "
        "same seed")
    from sgcn_tpu_torch.baselines import DenseGATOracle

    out = io.StringIO()
    t0 = time.perf_counter()
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    with contextlib.redirect_stdout(out):
        train_main(["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                    "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8",
                    "-l", "2", "--hidden", "16", "--model", "gat",
                    "--epochs", "5", "--warmup", "0", "--seed", "11",
                    "--comm-schedule", "a2a"])
    k1_close()
    launches_gtc = spmm_tiles.mask_launches     # ... and ends here
    packs_gtc = row_pack.launches
    bwd_gtc = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gtc
    lines = out.getvalue().strip().splitlines()
    rep_gc = json.loads(lines[-1])
    cli_losses = [float(x.split()[-1]) for x in lines
                  if x.startswith("epoch ")]
    labels_c = load_npz_dataset(os.path.join(fix, "cora2708.npz"))[2]
    oracle = DenseGATOracle(ahat, 1433, [16, 7], seed=11, device=dev)
    want_losses = oracle.fit(feats, labels_c, epochs=5)
    rel = np.abs(np.asarray(cli_losses) / np.asarray(want_losses) - 1)
    log(f"  CLI report ({time.perf_counter() - t0:.2f} s with the oracle): "
        f"{json.dumps(rep_gc)}")
    log(f"  CLI losses {cli_losses}; dense GAT oracle {want_losses}; max "
        f"relative gap {rel.max():.3g}")
    want_gtc = 5 * 2 * gat_passes([16, 7])
    want_pgc = 5 * 2 * pack_launches("gat", "a2a", [16, 7])
    log(f"  K5 launches {launches_gtc} (backward {bwd_gtc}), row pack "
        f"{packs_gtc}; expected {want_gtc} ({want_gtc // 2}), {want_pgc}")
    if launches_gtc != want_gtc or bwd_gtc != want_gtc // 2 \
            or packs_gtc != want_pgc:
        raise AssertionError("cora GAT training: K5 launch count differs "
                             "from the passes the program runs")
    if rep_gc["model"] != "gat" or len(cli_losses) != 5 \
            or not rel.max() <= 1e-4:
        raise AssertionError("cora GAT: the CLI's losses do not track the "
                             "dense GAT oracle within 1e-4 relative")

    # ---------------------------------------------------------- phase 10
    log("phase 10: K4 serving — the ragged ring for GCN and GAT on phase "
        "3's plan, features and weights; served rows == the a2a engines' "
        "(phases 3 and 7), bit for bit")
    from sgcn_tpu_torch.ops.pspmm import ring_concat
    from sgcn_tpu_torch.ops.tile_spmm import PspmmTilesRagged
    from sgcn_tpu_torch.parallel import resolve_comm_schedule

    d_f = {}
    resolve_comm_schedule("auto", [plan], "gcn", decision=d_f)
    log(f"  flagship ring: rr_sizes {plan.ensure_ragged().rr_sizes}, S "
        f"{plan.s}, R {plan.r}; wire rows per exchange a2a "
        f"{d_f['wire_rows_a2a']}, ragged {d_f['wire_rows_ragged']}, true "
        f"{d_f['true_rows']} (padding efficiency "
        f"{d_f['padding_efficiency']:.3f}); auto resolves "
        f"{d_f['resolved']} ({d_f['rule']})")
    eng_fr, _res_fr, launches_fr = serve_ragged(
        "flagship GCN ragged", eng_f, feats_f, 512, 64, 3)
    log_side_by_side("GCN forward breakdown", bd_f, forward_breakdown(eng_fr),
                     ("exchange_ms", "fused_kernel_ms"))
    log_device_busy("flagship GCN ragged", lambda: eng_fr.query(np.arange(64)))
    pa_r, st_r = eng_fr.pa, eng_fr.setup.fwd_static
    ring0 = ring_concat(h0, pa_r["ring_src"], st_r["rr_sizes"])
    rtiles = [pa_r["ptile_hrsrc"], pa_r["ptile_hld"], pa_r["ptile_hw"]]
    rtiles_np = [t.cpu().numpy() for t in rtiles]
    check_pack(h0, pa_r["ring_src"], h0.dtype, "flagship layer-0 ring")
    fused_err = max(fused_err, check_fused(
        ltiles, h0, rtiles, ring0, st_r["pallas_lclasses"],
        st_r["pallas_hclasses"], tb, "flagship layer-0 ring fused f=128"))
    k4_err = check_k1(rtiles, ring0, st_r["pallas_hclasses"], tb,
                      "flagship ring pass f=128")
    t_ring = time_k1(rtiles_np, rtiles, ring0, st_r["pallas_hclasses"], tb,
                     ring0.shape[1], "flagship ring pass f=128")
    k4 = time_whole_op(h0, pa_r, st_r, tb, True,
                       "flagship K4 layer 0 forward f=128")
    log(f"  one whole aggregation at f=128 (exchange + fused launch): "
        f"ring {k4['ms']!r} ms, a2a {k3['ms']!r} ms; K1 alone on the ring "
        f"pass {t_ring['ms']!r} ms")

    eng_gfr, _res_gfr, launches_gfr = serve_ragged(
        "flagship GAT ragged", eng_gf, feats_f, 512, 64, 3)
    log_side_by_side("GAT forward breakdown", bd_gf,
                     gat_forward_breakdown(eng_gfr),
                     ("exchange_ms", "numerator_pass_ms",
                      "denominator_pass_ms"))
    log_device_busy("flagship GAT ragged",
                    lambda: eng_gfr.query(np.arange(64)))
    k5r_err = check_gat_passes(record_gat_passes(eng_gfr.forward),
                               "flagship GAT ring forward")

    # ---------------------------------------------------------- phase 11
    log("phase 11: K4 training — GCN and GAT on the ring on phases 5 and "
        "8's plan and data from the same initial weights, 1 warm-up + 5 "
        "timed steps; losses and weights == the a2a runs'")
    trr = FullBatchTrainer(plan, fin=128, widths=widths_f, seed=5,
                           comm_schedule="ragged", device=dev)
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
    rep_r = trr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_rt = spmm_tiles_fused.launches     # ... and ends here
    packs_rt = row_pack.launches
    ring_rt = PspmmTilesRagged.launches
    ring_bwd_rt = PspmmTilesRagged.backward_launches
    MAIN_PATH_PACKS[0] += packs_rt
    log(f"  GCN fused launches {launches_rt} (ring forward {ring_rt}, "
        f"ring backward {ring_bwd_rt}), row pack {packs_rt}; expected "
        f"{want_f} each")
    if (launches_rt != want_f or ring_bwd_rt != steps_f * bwd_f * fam
            or ring_rt + ring_bwd_rt != launches_rt or packs_rt != want_f):
        raise AssertionError("ragged GCN training: launch count differs "
                             "from the passes the program runs")
    same_w = all(torch.equal(a, b) for a, b in zip(trr.params, fit_f))
    log(f"  GCN losses {rep_r['loss_history']}; == a2a: "
        f"{rep_r['loss_history'] == rep['loss_history']}; weights == a2a: "
        f"{same_w}")
    if rep_r["loss_history"] != rep["loss_history"] or not same_w:
        raise AssertionError("ragged GCN training differs from a2a")
    log(f"  GCN epoch_s ring {rep_r['epoch_s']!r} (a2a {rep['epoch_s']!r}); "
        f"comm {json.dumps({k: rep_r[k] for k in ('comm_schedule', 'wire_rows_per_exchange', 'true_rows_per_exchange', 'padding_efficiency')})}")
    log(f"  GCN step breakdown on the ring (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trr, data))}")
    log_device_busy("flagship GCN ragged training", lambda: trr.step(data),
                    reps=3, what="steps")
    _zs, caught_r = forward_backward_trace(trr, data)
    g_r = caught_r[layer_b]
    gring = ring_concat(g_r, pa_r["ring_src"], st_r["rr_sizes"])
    k4b_err = max(
        check_k1(ltiles, g_r, st_r["pallas_lclasses"], tb,
                 f"flagship layer-{layer_b} gradient local pass (ring run)"),
        check_k1(rtiles, gring, st_r["pallas_hclasses"], tb,
                 f"flagship layer-{layer_b} gradient ring pass f=128"))
    fused_err = max(fused_err, check_fused(
        ltiles, g_r, rtiles, gring, st_r["pallas_lclasses"],
        st_r["pallas_hclasses"], tb, f"flagship layer-{layer_b} gradient "
        "ring fused f=128"))
    k4b = time_whole_op(g_r, pa_r, st_r, tb, True, f"flagship K4 "
                        f"layer-{layer_b} backward (on the gradient) f=128")

    trgr = FullBatchTrainer(plan, fin=128, widths=widths_f, model="gat",
                            activation="none",
                            params=gat_from_numpy(params_g),
                            comm_schedule="ragged", device=dev)
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    rep_gr = trgr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_grt = spmm_tiles.mask_launches     # ... and ends here
    packs_grt = row_pack.launches
    bwd_grt = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_grt
    want_pgr = steps_f * 2 * pack_launches("gat", "ragged", widths_f)
    log(f"  GAT K5 launches {launches_grt} (backward {bwd_grt}), row pack "
        f"{packs_grt}; expected {want_gt} ({want_gt // 2}), {want_pgr}")
    if launches_grt != want_gt or bwd_grt != want_gt // 2 \
            or packs_grt != want_pgr:
        raise AssertionError("ragged GAT training: K5 launch count "
                             "differs from the passes the program runs")
    same_g = all(torch.equal(a, b)
                 for a, b in zip(trgr.model.parameters(), fit_g))
    log(f"  GAT losses {rep_gr['loss_history']}; == a2a: "
        f"{rep_gr['loss_history'] == rep_g['loss_history']}; weights == "
        f"a2a: {same_g}")
    if rep_gr["loss_history"] != rep_g["loss_history"] or not same_g:
        raise AssertionError("ragged GAT training differs from a2a")
    log(f"  GAT epoch_s ring {rep_gr['epoch_s']!r} (a2a "
        f"{rep_g['epoch_s']!r})")
    log(f"  GAT step breakdown on the ring (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trgr, data))}")
    log_device_busy("flagship GAT ragged training", lambda: trgr.step(data),
                    reps=3, what="steps")
    k5r_err = max(k5r_err, check_gat_passes(
        record_gat_passes(lambda: gat_train_pass(trgr, data)),
        "flagship GAT ring training"))

    # ---------------------------------------------------------- phase 12
    log("phase 12: cora2708 8-hp through the train CLI with --comm-schedule "
        "auto (resolves to the ring) against --comm-schedule a2a, GCN and "
        "GAT, 5 steps; then each transport's epoch_s with warm-up")
    cli_base = ["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8", "-l",
                "2", "--hidden", "16", "--seed", "11"]
    cli = cli_base + ["--epochs", "5", "--warmup", "0"]
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    losses_ca, rep_ca = run_train_cli(cli + ["--comm-schedule", "a2a"])
    k1_close()
    launches_ca = spmm_tiles_fused.launches     # ... and ends here
    packs_ca = row_pack.launches
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
    losses_cr, rep_cr = run_train_cli(cli + ["--comm-schedule", "auto"])
    k1_close()
    launches_cr = spmm_tiles_fused.launches     # ... and ends here
    packs_cr = row_pack.launches
    ring_cr = PspmmTilesRagged.launches
    ring_bwd_cr = PspmmTilesRagged.backward_launches
    MAIN_PATH_PACKS[0] += packs_ca + packs_cr
    want_cc = 5 * (2 + backward_passes(1433, [16, 7])) * fam
    log(f"  GCN: a2a losses {losses_ca}; auto -> {rep_cr['comm_schedule']} "
        f"(wire rows {rep_cr['wire_rows_per_exchange']} vs "
        f"{rep_ca['wire_rows_per_exchange']}) losses {losses_cr}; fused "
        f"launches {launches_ca} / {launches_cr} (ring {ring_cr} + "
        f"{ring_bwd_cr}), row pack {packs_ca} / {packs_cr}, expected "
        f"{want_cc} each; epoch_s a2a {rep_ca['epoch_s']!r}, ring "
        f"{rep_cr['epoch_s']!r} (host-bound)")
    if (rep_cr["comm_schedule"] != "ragged" or rep_ca["comm_schedule"]
            != "a2a" or losses_cr != losses_ca or len(losses_cr) != 5
            or launches_ca != want_cc or launches_cr != want_cc
            or ring_cr + ring_bwd_cr != want_cc
            or packs_ca != want_cc or packs_cr != want_cc):
        raise AssertionError("cora GCN CLI: auto did not train the ring "
                             "with the a2a losses and exact launches")
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    losses_gcr, rep_gcr = run_train_cli(
        cli + ["--model", "gat", "--comm-schedule", "auto"])
    k1_close()
    launches_gcr = spmm_tiles.mask_launches     # ... and ends here
    packs_gcr = row_pack.launches
    bwd_gcr = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gcr
    log(f"  GAT: auto -> {rep_gcr['comm_schedule']} losses {losses_gcr}; "
        f"phase 9's a2a {cli_losses}; K5 launches {launches_gcr} (backward "
        f"{bwd_gcr}), expected {want_gtc}; epoch_s a2a "
        f"{rep_gc['epoch_s']!r}, ring {rep_gcr['epoch_s']!r}")
    if (rep_gcr["comm_schedule"] != "ragged" or losses_gcr != cli_losses
            or launches_gcr != want_gtc or bwd_gcr != want_gtc // 2
            or packs_gcr != 5 * 2 * pack_launches("gat", "ragged", [16, 7])):
        raise AssertionError("cora GAT CLI: auto did not train the ring "
                             "with the a2a losses and exact launches")
    # epoch_s of each transport, 3 runs each of 3 warm-up + 20 timed
    # steps, in the order a2a, ring, ring, a2a, a2a, ring so that a drift
    # of the shared host weighs on both alike
    for model in ("gcn", "gat"):
        runs = {"a2a": [], "ragged": []}
        for sched in ("a2a", "ragged", "ragged", "a2a", "a2a", "ragged"):
            runs[sched].append(run_train_cli(
                cli_base + ["--epochs", "20", "--warmup", "3", "--model",
                            model, "--comm-schedule", sched])[1]["epoch_s"])
        med = {key: statistics.median(v) for key, v in runs.items()}
        log(f"  cora {model.upper()} epoch_s, 3 + 20 steps per run: a2a "
            f"{runs['a2a']!r}, ring {runs['ragged']!r}; medians a2a "
            f"{med['a2a']!r}, ring {med['ragged']!r}, ring / a2a "
            f"{med['ragged'] / med['a2a']:.3f}")

    # ---------------------------------------------------------- phase 13
    log("phase 13: K6 — the row shuffle kernel vs its plain version at "
        "S = 2048, then the micro-benchmark (python -m "
        "sgcn_tpu_torch.tools.spmm_micro) at its defaults")
    from sgcn_tpu_torch.ops.row_shuffle import row_shuffle, row_shuffle_plain
    from sgcn_tpu_torch.tools.spmm_micro import main as micro_main

    s_k6 = 2048
    k6_err = 0.0
    for f in (1, 41, 128):
        chunk = torch.as_tensor(rng.standard_normal((s_k6, f)).astype(
            np.float32)).to(dev)
        gidx = torch.as_tensor(rng.integers(0, s_k6, (s_k6, 1)).astype(
            np.int32)).to(dev)
        one, two = row_shuffle(chunk, gidx), row_shuffle(chunk, gidx)
        plain = row_shuffle_plain(chunk, gidx)
        torch.cuda.synchronize()
        diff = float((one - plain).abs().max())
        log(f"  row_shuffle f={f}: max |kernel - plain| = {diff!r} "
            f"(relaunch identical: {torch.equal(one, two)})")
        if not (torch.equal(one, two) and torch.equal(one, plain)):
            raise AssertionError(f"row_shuffle f={f}: kernel != plain")
        k6_err = max(k6_err, diff)
    row_shuffle.launches = 0                    # the main path starts here
    k1_open()
    micro = micro_main([])
    k1_close()
    launches_k6 = row_shuffle.launches          # ... and ends here
    if launches_k6 == 0:
        raise AssertionError("spmm_micro launched no row_shuffle kernel")
    log("  this card's ceilings (spmm_micro): " + "; ".join(
        f"{p_['name']} {p_.get('gbps', p_.get('tflops'))!r} "
        f"{'GB/s' if 'gbps' in p_ else 'TFLOP/s'}"
        for p_ in micro["spmm_micro"]))
    # at this size a call is shorter than the host's launch of it, so
    # CUDA events around back-to-back calls time the host; the device's
    # own time per call comes from the profiler (kernels and copies only)
    idx_l = gidx.long().expand(s_k6, 128)
    calls = {"ms": lambda: row_shuffle(chunk, gidx),
             "plain_ms": lambda: row_shuffle_plain(chunk, gidx),
             "library_ms": lambda: torch.take_along_dim(chunk, idx_l, dim=0)}
    k6 = {key: device_busy(fn, reps=100)[1] / 100
          for key, fn in calls.items()}
    if not all(v > 0 for v in k6.values()):
        raise AssertionError(f"the profiler saw no device time: {k6}")
    k6["bound_ms"] = k6_bound_ms(gidx, 128)
    events = {key: cuda_ms(fn) for key, fn in calls.items()}
    log(f"  row_shuffle S={s_k6} f=128, device time per call "
        f"(torch.profiler, 100 calls): kernel {k6['ms']!r} ms, plain "
        f"{k6['plain_ms']!r} ms, torch.take_along_dim "
        f"{k6['library_ms']!r} ms; bound {k6['bound_ms']!r} ms by bytes; "
        f"CUDA events per back-to-back call (host-bound): "
        f"{json.dumps(events)}")

    # ---------------------------------------------------------- phase 14
    log("phase 14: K1 and K5 on bf16 tables (the bf16 entry points) vs "
        "their plain version on phase 1's tiles")
    err16, times16 = phase_bf16_kernels(rng, dev, tiles_np, tiles, classes,
                                        tb, n)

    # ---------------------------------------------------------- phase 15
    log("phase 15: the flagship GCN (phase 5) under halo_dtype='bfloat16' "
        "and compute_dtype='bfloat16', both transports, from phase 5's "
        "initial weights")
    split_f32("GCN", {"a2a": tr, "ragged": trr}, data)
    l15, err15, k1_16, op_16, wire_16 = phase_bf16_gcn_training(
        plan, data, p_init, widths_f, rep, dev, tb, steps_f, bwd_f)

    # ---------------------------------------------------------- phase 16
    log("phase 16: flagship GCN serving with halo_dtype='bfloat16', both "
        "transports (phase 3's plan, weights and features)")
    launches_16 = phase_bf16_serving(eng_f, eng_fr, res_f, _res_fr, ahat_f,
                                     feats_f, dev)

    # ---------------------------------------------------------- phase 17
    log("phase 17: the flagship GAT (phase 8) under compute_dtype="
        "'bfloat16', both transports; then cora2708 GAT --dtype bfloat16 "
        "through the CLI")
    split_f32("GAT", {"a2a": trg, "ragged": trgr}, data)
    l17, err17, k5_16 = phase_bf16_gat(
        plan, data, params_g, widths_f, rep_g, dev, steps_f, cli,
        cli_losses)

    # ---------------------------------------------------------- phase 18
    log("phase 18: the row pack and the fused entry on every real exchange "
        "and aggregation of one flagship training pass (forward and "
        "backward), GCN and GAT, both transports: kernel == plain")
    for name, trainer, run in (
            ("GCN a2a", tr, gcn_train_pass), ("GCN ring", trr, gcn_train_pass),
            ("GAT a2a", trg, gat_train_pass),
            ("GAT ring", trgr, gat_train_pass)):
        _fams, packs, fused = record_launches(lambda: run(trainer, data))
        for j, (src, flat, dtype) in enumerate(packs):
            check_pack(src, flat, dtype, f"{name} exchange {j}")
        for j, args in enumerate(fused):
            fused_err = max(fused_err, check_fused(
                *args, f"{name} aggregation {j} fused"))
        log(f"  {name}: {len(packs)} exchanges (tables "
            f"{sorted({tuple(p[0].shape[2:]) for p in packs})}) == plain "
            f"bit for bit; {len(fused)} fused launches == plain")
        if not packs or (name.startswith("GCN") and not fused):
            raise AssertionError(f"{name}: recorded no exchange")

    # ------------------------------------------------------ phases 19-21
    # K1's float-weight family entries make no launch on the symmetric
    # paths above (the fused entry runs their chains); the asymmetric
    # backward launches them (the halo rows' transpose)
    if any(MAIN_PATH_K1.values()):
        raise AssertionError(f"K1 family-entry launches on the symmetric "
                             f"main path: {MAIN_PATH_K1}, expected 0")
    t0 = time.perf_counter()
    ahat_d = normalize_adjacency(directed_er_graph(n_f, seed=0))
    log(f"  directed flagship graph {time.perf_counter() - t0:.2f} s, nnz "
        f"{ahat_d.nnz}")
    asym = phase_asymmetric(ahat_d, feats_f, labels_f, pv_f, widths_f, dev,
                            tb, steps_f, k3b)

    # ---------------------------------------------------------- phase 22
    log("phase 22: repeated runs in one process (tools/repeat_run.py): "
        "cora2708 GAT a2a x 20, the directed flagship GCN and GAT x 3; "
        "exactly one loss history and one weight digest each")
    phase_repeat(fix, dev, asym, widths_f)

    # ---------------------------------------------------------- phase 23
    log("phase 23: checkpoints at the flagship width (GCN a2a and ring, "
        "GAT a2a, float32): kill after a save and resume in a new process, "
        "a corrupt newest file, serving from a checkpoint, hot swap")
    p23 = phase_checkpoints(plan, ahat_f, feats_f, labels_f, pv_f, widths_f,
                            data, dev, smi)
    MAIN_PATH_PACKS[0] += p23["pack"]

    # ---------------------------------------------------------- phase 24
    fused_main = (launches_c + launches_f + launches_tc + launches_tf
                  + launches_fr + launches_rt + launches_ca + launches_cr
                  + l15["wire"] + l15["bf16"] + launches_16 + asym["fused"]
                  + p23["fused"])
    kernels = [{
        # K1's own float32-weight family entry: its launches on the main
        # path are the asymmetric backward's halo-ᵀ launches (the
        # symmetric paths run its chains inside the fused entry, which
        # counts those launches under tile_spmm_fused); the times are its
        # own family launches at the flagship layer
        "name": "tile_spmm",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": asym["k1"],
        "max_abs_err": max(max_err, grad_err, k4_err, k4b_err, asym["err"]),
        "ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": t_halo["bound_by"],
        "library_ms": layer["library_ms"],
    }, {
        # K3's backward: the whole op (exchange + fused launch) on the
        # gradient
        "name": "pspmm_tiles_sym_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:457-464",
        "launches": bwd_tc + bwd_tf + p23["sym_bwd"],
        "max_abs_err": max(grad_err, fused_err),
        "ms": k3b["ms"],
        "plain_ms": k3b["plain_ms"],
        "bound_ms": k3b["bound_ms"],
        "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"],
    }, {
        "name": "gat_tiles_pass",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:530-545",
        "launches": (launches_gc + launches_gf + launches_gt + launches_gtc
                     + launches_gfr + launches_grt + launches_gcr
                     + l17["f32"] + asym["k5"] + p23["k5"]),
        "max_abs_err": max(k5_err, err_f, err_b, k5r_err),
        "ms": gat_fwd["ms"],
        "plain_ms": gat_fwd["plain_ms"],
        "bound_ms": gat_fwd["bound_ms"],
        "bound_by": gat_fwd["bound_by"],
        "library_ms": gat_fwd["library_ms"],
    }, {
        "name": "gat_layer_sym_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/models/gat.py:637-687",
        "launches": bwd_gt + bwd_gtc + bwd_grt + bwd_gcr + p23["gat_bwd"],
        "max_abs_err": max(err_b, k5r_err),
        "ms": gat_bwd["ms"],
        "plain_ms": gat_bwd["plain_ms"],
        "bound_ms": gat_bwd["bound_ms"],
        "bound_by": gat_bwd["bound_by"],
        "library_ms": gat_bwd["library_ms"],
    }, {
        # K4: the whole op (ring pack + fused launch) per flagship layer
        "name": "pspmm_tiles_ragged",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:469-527",
        "launches": launches_fr + ring_rt + ring_cr + p23["ring"],
        "max_abs_err": max(k4_err, fused_err),
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }, {
        "name": "pspmm_tiles_ragged_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:517-523",
        "launches": ring_bwd_rt + ring_bwd_cr + p23["ring_bwd"],
        "max_abs_err": max(k4b_err, fused_err),
        "ms": k4b["ms"],
        "plain_ms": k4b["plain_ms"],
        "bound_ms": k4b["bound_ms"],
        "bound_by": k4b["bound_by"],
        "library_ms": k4b["library_ms"],
    }, {
        "name": "row_shuffle",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/row_shuffle.cu",
        "replaces": "scripts/spmm_micro.py:163",
        "launches": launches_k6,
        "max_abs_err": k6_err,
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k6["library_ms"],
    }, {
        # K1's own family entry on bf16 tables: its main-path launches
        # are the asymmetric compute_dtype backward's (the symmetric
        # compute_dtype path runs it inside the fused bf16 entry); the
        # times are its own family launches at the flagship layer
        "name": "tile_spmm_bf16",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": asym["k1_bf16"],
        "max_abs_err": max(err16["k1"], err15),
        "ms": k1_16["ms"],
        "plain_ms": k1_16["plain_ms"],
        "bound_ms": k1_16["bound_ms"],
        "bound_by": k1_16["bound_by"],
        "library_ms": k1_16["library_ms"],
    }, {
        "name": "gat_tiles_pass_bf16",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:530-545",
        "launches": l17["bf16"],
        "max_abs_err": max(err16["k5"], err17),
        "ms": k5_16["ms"],
        "plain_ms": k5_16["plain_ms"],
        "bound_ms": k5_16["bound_ms"],
        "bound_by": k5_16["bound_by"],
        "library_ms": k5_16["library_ms"],
    }, {
        # the stacked row pack: every exchange of K3 (a2a) and K4 (ring),
        # GCN and GAT; timed on the flagship layer-0 a2a exchange
        "name": "row_pack",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/row_shuffle.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:418",
        "launches": MAIN_PATH_PACKS[0],
        "max_abs_err": 0.0,
        "ms": k3["pack"]["ms"],
        "plain_ms": k3["pack"]["plain_ms"],
        "bound_ms": k3["pack"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3["pack"]["library_ms"],
    }, {
        # the fused local + remote entry: K3/K4's tile work and sum in one
        # launch, every dtype flavor; timed at the flagship layer 0 (a2a)
        "name": "tile_spmm_fused",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:413-428",
        "launches": fused_main,
        "max_abs_err": fused_err,
        "ms": k3["fused"]["ms"],
        "plain_ms": k3["fused"]["plain_ms"],
        "bound_ms": k3["fused"]["bound_ms"],
        "bound_by": k3["fused"]["bound_by"],
        "library_ms": k3["fused"]["library_ms"],
    }]
    # every kernel must be on the main path (K1's family entries through
    # the asymmetric backward only: asserted 0 on the symmetric paths)
    for kern in kernels:
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']}: no launch on the main "
                                 "path")
    op = asym["op"]
    log("  asymmetric backward aggregation (flagship, f=128; halo-T K1 + "
        "reverse pack + fused): " + json.dumps(
            {key: op[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}))
    log("  launches on the main path per entry: " + json.dumps(
        {kern["name"]: kern["launches"] for kern in kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
