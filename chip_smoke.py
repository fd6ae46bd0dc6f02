#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for ``sm_90a``), the
CUDA toolkit (``nvcc``) and the repository checkout around this file.  It
imports nothing of JAX or of the JAX package.  Phases, in order; any
failure raises and the script exits non-zero:

  0. print the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, and build every kernel from ``sgcn_tpu_torch/csrc``
     (one ``nvcc`` per source, started together), with its build time;
  1. the tile SpMM kernel (K1) against its plain PyTorch version on the
     card, on random tiles from a numpy seed (several classes, a hub
     tile, pads, empty rows, f ∈ {16, 40, 128}): bit-identical to the
     plain version and between two launches.  Times the kernel, the plain
     version and the ``torch.sparse.mm`` yardstick with CUDA events, and
     prints the kernel's bound for the same work;
  2. the serving main path on real data: cora2708 (k = 8 hp parts), GCN
     1433 → 16 → 7 with ReLU, Glorot weights from a numpy seed carried by
     ``params_from_jax``, 128 synthetic queries through ``ServeEngine`` and
     ``run_loadgen`` on the card.  Every served row is checked against a
     float64 scipy forward ``act(Â·X·W…)`` (rtol 1e-4, atol 1e-5), and the
     kernel's launch count must be exactly forwards × layers × 2 passes ×
     classes; then device time vs wall over 5 batches under
     ``torch.profiler`` (the device's idle share);
  3. the same at the flagship width: Erdős–Rényi n = 169343, average
     degree 14, features N(0, 1), k = 8 balanced random parts, GCN 128 →
     128 → 128 → 40; 512 closed-loop queries, 256 served rows checked
     against the float64 forward; p50/p99 latency, QPS, the per-layer
     kernel time, a per-stage breakdown of one forward, the idle share,
     and K1 held against its plain version on this layer's real tiles;
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
     per-class dispatch's unit); every loss must be
     finite, the kernel's launches must equal steps × (forward passes +
     the backward passes autograd really runs) × classes, and the kernel
     on this run's real gradient tables must equal its plain version bit
     for bit.  Prints ``epoch_s``, a per-step breakdown (forward,
     backward, optimizer) from CUDA events, the idle share over 3 steps
     under ``torch.profiler``, and the backward layer's kernel time, bound
     and ``torch.sparse.mm`` time on the same gradient;
  6. one JSON line ``{"kernels": [...]}`` — per ported kernel (the tile
     SpMM, and its use as the aggregation's backward) its launches on the
     main path (phases 2–5), max |kernel − plain|, kernel / plain / bound
     / library times at the flagship layer;
  7. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, the script
prints no result and exits with code 2 or 3.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 outside the tensor cores — the K1 bound's two rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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
    of weight 0 at dst tb-1; the first tile of the first class is full
    (the hub)."""
    import numpy as np

    flats = [[], [], []]
    for ci, (t, e) in enumerate(classes):
        src = np.zeros((k, t, e), np.int32)
        ld = np.full((k, t, e), tb - 1, np.int32)
        w = np.zeros((k, t, e), np.float32)
        for p in range(k):
            for i in range(t):
                c = e if (ci == 0 and i == 0) else int(rng.integers(0, e + 1))
                src[p, i, :c] = rng.integers(0, n, c)
                ld[p, i, :c] = np.sort(rng.integers(0, 3 * tb // 4, c))
                w[p, i, :c] = rng.standard_normal(c)
        for j, a in enumerate((src, ld, w)):
            flats[j].append(a.reshape(k, -1))
    return tuple(np.concatenate(f, axis=1) for f in flats)


def k1_work(flat_src, flat_w, k, n, f, out_rows):
    """Bytes and flops the K1 call needs on these inputs: every stored
    slot's (src, ld, w) read once, each DISTINCT referenced table row read
    once, the output written once; 2 flops (multiply, add) per real edge
    and column."""
    import numpy as np

    src = np.asarray(flat_src, np.int64)
    real = np.asarray(flat_w) != 0
    parts = np.broadcast_to(np.arange(k)[:, None], src.shape)
    rows = np.unique(parts[real] * n + src[real]).size
    nbytes = src.size * 12 + rows * f * 4 + out_rows * f * 4
    flops = 2 * int(real.sum()) * f
    return nbytes, flops


def k1_bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_spmm(flat_src, flat_ld, flat_w, classes, k, n, tb, device):
    """``torch.sparse.mm`` of a CSR holding the same real edges as the
    tile arrays, shaped so ``csr @ table.reshape(k*n, f)`` is the K1
    output — the library yardstick, timed here and used nowhere in the
    port."""
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
        vals.append(w[real])
        off += t * e
        row0 += t
    idx = torch.as_tensor(np.stack([np.concatenate(rows),
                                    np.concatenate(cols)]))
    coo = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)),
        (k * t_all * tb, k * n), device=device)
    return coo.coalesce().to_sparse_csr()


def check_k1(tiles, table, classes, tb, what):
    """Kernel vs plain on the card: bit identity and two-launch
    determinism.  Returns the max |kernel − plain| (0.0 when identical)."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_plain)

    one = spmm_tiles_classes(*tiles, table, classes, tb)
    two = spmm_tiles_classes(*tiles, table, classes, tb)
    plain, off = [], 0
    for t, e, *_ in classes:
        sl = slice(off, off + t * e)
        plain.append(spmm_tiles_plain(
            *(x[:, sl].reshape(x.shape[0], t, e) for x in tiles), table, tb))
        off += t * e
    plain = torch.cat(plain, dim=1)
    torch.cuda.synchronize()
    diff = float((one - plain).abs().max())
    log(f"  {what}: max |kernel - plain| = {diff!r}  "
        f"(relaunch identical: {torch.equal(one, two)})")
    if not torch.equal(one, two):
        raise AssertionError(f"{what}: two launches differ")
    if not torch.equal(one, plain):
        raise AssertionError(f"{what}: kernel != plain version "
                             f"(max diff {diff})")
    return diff


def time_k1(tiles_np, tiles, table, classes, tb, n, what, plain_reps=3):
    """Kernel, plain and library times (CUDA events) and the bound."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_plain)

    k, f = table.shape[0], table.shape[2]
    t_all = sum(t for t, _e, *_ in classes)

    def plain():
        off = 0
        for t, e, *_ in classes:
            sl = slice(off, off + t * e)
            spmm_tiles_plain(*(x[:, sl].reshape(k, t, e) for x in tiles),
                             table, tb)
            off += t * e

    ms = cuda_ms(lambda: spmm_tiles_classes(*tiles, table, classes, tb))
    plain_ms = cuda_ms(plain, reps=plain_reps, warmup=1)
    csr = library_spmm(*tiles_np, classes, k, n, tb, table.device)
    dense = table.reshape(k * n, f)
    lib_out = torch.sparse.mm(csr, dense)
    kern_out = spmm_tiles_classes(*tiles, table, classes, tb).reshape(-1, f)
    lib_diff = float((lib_out - kern_out).abs().max())
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, dense))
    nbytes, flops = k1_work(tiles_np[0], tiles_np[2], k, n, f, k * t_all * tb)
    bound_ms, bound_by = k1_bound_ms(nbytes, flops)
    log(f"  {what}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.sparse.mm {library_ms!r} ms (|lib - kernel| {lib_diff:.3g}), "
        f"bound {bound_ms!r} ms by {bound_by} ({nbytes} B, {flops} flop), "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def serve_and_check(name, ahat, feats, pv, k, widths, queries, max_batch,
                    seed, check_rows=None, device="cuda"):
    """Drive the serving main path on the card and hold it to the float64
    forward.  Returns (engine, result, launches, expected launches)."""
    import numpy as np

    from sgcn_tpu_torch.models.gcn import params_from_jax
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.serve import (ServeEngine, run_loadgen,
                                      synthetic_query_ids)

    n, fin = feats.shape
    t0 = time.perf_counter()
    plan = build_comm_plan(ahat, pv, k)
    dims = list(zip([fin] + widths[:-1], widths))
    params = glorot_numpy(seed, dims)
    eng = ServeEngine(plan, fin=fin, widths=widths,
                      params=params_from_jax(params), max_batch=max_batch,
                      device=device)
    eng.set_features(feats)
    lcls = eng.setup.fwd_static["pallas_lclasses"]
    hcls = eng.setup.fwd_static["pallas_hclasses"]
    log(f"  {name}: plan + engine {time.perf_counter() - t0:.2f} s; "
        f"b={plan.b} S={plan.s} R={plan.r} classes local "
        f"{[(t, e) for t, e, _ in lcls]} halo {[(t, e) for t, e, _ in hcls]}")
    qids = synthetic_query_ids(n, queries, seed=seed)
    rec = RecordingEngine(eng)

    spmm_tiles.launches = 0                     # the main path starts here
    fwd0 = eng.forward_count
    eng.warmup(qids)
    result = run_loadgen(rec, qids)
    launches = spmm_tiles.launches              # ... and ends here
    forwards = eng.forward_count - fwd0
    expected = forwards * len(widths) * 2 * len(lcls)
    if len(lcls) != len(hcls) or launches != expected:
        raise AssertionError(
            f"{name}: tile kernel launched {launches} times, expected "
            f"{forwards} forwards x {len(widths)} layers x 2 passes x "
            f"{len(lcls)} classes = {expected}")
    if launches == 0:
        raise AssertionError(f"{name}: the main path launched no kernel")
    s = result.summary()
    log(f"  {name}: {s['queries']} queries in {s['batches']} batches, "
        f"{s['achieved_qps']} QPS, p50 {s['latency_p50_ms']} ms, "
        f"p99 {s['latency_p99_ms']} ms; kernel launches {launches} "
        f"= {forwards} forwards x {len(widths)} x 2 x {len(lcls)}")

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
    want = oracle_forward(ahat, feats, params)[q]
    err = np.abs(got - want)
    log(f"  {name}: {len(q)} served rows vs float64 forward "
        f"({time.perf_counter() - t0:.2f} s): max abs err {err.max():.3g}, "
        f"max rel err {(err / np.maximum(np.abs(want), 1e-30)).max():.3g}")
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: served logits differ from the "
                             f"float64 forward beyond rtol {RTOL}, atol {ATOL}")
    return eng, result, launches


def forward_breakdown(eng):
    """Device time of each stage of one forward (CUDA events around each
    stage, run back to back): exchange, local pass, halo pass, sum,
    projection, activation — per layer."""
    import torch

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.ops.pspmm import halo_exchange
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_classes

    pa, st = eng.pa, eng.setup.fwd_static
    tb, lcls, hcls = st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"]
    weights = list(eng.model.weights)
    h = eng._h0
    rows = []
    torch.cuda.synchronize()
    with torch.inference_mode():
        for i, w in enumerate(weights):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
            pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
            ev[0].record()
            x = h @ w if pf else h
            ev[1].record()
            halo = halo_exchange(x, pa["send_idx"], pa["halo_src"])
            ev[2].record()
            b = x.shape[1]
            loc = spmm_tiles_classes(pa["ptile_lsrc"], pa["ptile_lld"],
                                     pa["ptile_lw"], x, lcls, tb)[:, :b]
            ev[3].record()
            rem = spmm_tiles_classes(pa["ptile_hsrc"], pa["ptile_hld"],
                                     pa["ptile_hw"], halo, hcls, tb)[:, :b]
            ev[4].record()
            z = loc + rem
            ev[5].record()
            z = z if pf else z @ w
            ev[6].record()
            h = torch.relu(z) if i < len(weights) - 1 else z
            ev[7].record()
            torch.cuda.synchronize()
            el = [ev[j].elapsed_time(ev[j + 1]) for j in range(7)]
            rows.append({"layer": i, "width": int(x.shape[-1]),
                         "project_ms": el[0] + el[5], "exchange_ms": el[1],
                         "local_kernel_ms": el[2], "halo_kernel_ms": el[3],
                         "sum_ms": el[4], "act_ms": el[6]})
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
    input narrowed by the layer projects first).  Â is symmetric, so
    the transpose of each aggregation is Â itself.

    ``masks``: per hidden layer, the ReLU derivative (``z > 0``) to use in
    place of float64's own — the float32 run's, so that an entry whose
    pre-activation lies within rounding of 0 (where the two runs may
    disagree on the sign) does not count as an error of the gradient.
    Returns (loss, grads, per-layer count of entries whose mask differs
    from float64's)."""
    import numpy as np

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN

    a = ahat.astype(np.float64).tocsr()
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
            adz = a @ dz
            grads[i] = ins[i].T @ adz
            dh = adz @ ws[i].T
        else:                                # z = (Â h) W
            grads[i] = ins[i].T @ dz
            dh = a @ (dz @ ws[i].T)
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
    from sgcn_tpu_torch.ops.tile_spmm import TILE_PLAN_FIELDS, pspmm_tiles_sym
    from sgcn_tpu_torch.train import LOSSES

    st = tr.model.fwd_static
    zs, caught = [], {}
    weights = list(tr.model.weights)
    h = data.h0
    for i, w in enumerate(weights):
        pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
        z = pspmm_tiles_sym(h @ w if pf else h,
                            *(tr.pa[f] for f in TILE_PLAN_FIELDS),
                            st["pallas_tb"], st["pallas_lclasses"],
                            st["pallas_hclasses"])
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
        loss = LOSSES[tr.loss_name](tr.model(data.h0, tr.pa), data.labels,
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
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {k}: {line.strip()}")

    # ---------------------------------------------------------- phase 1
    log("phase 1: tile SpMM kernel vs plain version on random tiles")
    rng = np.random.default_rng(0)
    k, tb, n = 8, 256, 6000
    classes = ((2, 2048, "tile_spmm"), (6, 512, "tile_spmm"),
               (12, 64, "tile_spmm"))
    tiles_np = random_class_tiles(rng, k, [c[:2] for c in classes], tb, n)
    tiles = [torch.as_tensor(a).to(dev) for a in tiles_np]
    max_err = 0.0
    for f in (16, 40, 128):
        table = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        max_err = max(max_err, check_k1(tiles, table, classes, tb,
                                        f"random tiles f={f}"))
        time_k1(tiles_np, tiles, table, classes, tb, n, f"random tiles f={f}")

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
    log("phase 3: serve ER n=169343 deg 14, k=8 rp, GCN 128 -> 128 -> "
        "128 -> 40 (ReLU)")
    t0 = time.perf_counter()
    n_f = 169343
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
    for row in forward_breakdown(eng_f):
        log(f"  forward breakdown: {json.dumps(row)}")
    log_device_busy("flagship", lambda: eng_f.query(np.arange(64)))

    from sgcn_tpu_torch.ops.pspmm import halo_exchange
    h0 = eng_f._h0
    halo = halo_exchange(h0, pa["send_idx"], pa["halo_src"])
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    htiles = [pa["ptile_hsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    max_err = max(max_err, check_k1(ltiles, h0, st["pallas_lclasses"], tb,
                                    "flagship local pass f=128"))
    max_err = max(max_err, check_k1(htiles, halo, st["pallas_hclasses"], tb,
                                    "flagship halo pass f=128"))
    t_loc = time_k1([t.cpu().numpy() for t in ltiles], ltiles, h0,
                    st["pallas_lclasses"], tb, plan.b,
                    "flagship local pass f=128")
    t_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, halo,
                     st["pallas_hclasses"], tb, plan.r,
                     "flagship halo pass f=128")
    layer = {key: t_loc[key] + t_halo[key]
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"  flagship per-layer kernel time (local + halo passes, f=128): "
        f"{layer['ms']!r} ms; bound {layer['bound_ms']!r} ms")

    # ---------------------------------------------------------- phase 4
    log("phase 4: train cora2708 on the card, k=8 hp, GCN 1433 -> 16 -> 7 "
        "(python -m sgcn_tpu_torch.train --experiment accuracy --epochs 60)")
    from sgcn_tpu_torch.ops.tile_spmm import PspmmTilesSym, spmm_tiles
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
    from sgcn_tpu_torch.train.__main__ import main as train_main

    epochs_c = 60
    cls_c = (len(eng_c.setup.fwd_static["pallas_lclasses"])
             + len(eng_c.setup.fwd_static["pallas_hclasses"]))
    out = io.StringIO()
    t0 = time.perf_counter()
    spmm_tiles.launches = 0                     # the main path starts here
    PspmmTilesSym.backward_launches = 0
    with contextlib.redirect_stdout(out):
        train_main(["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                    "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8",
                    "-l", "2", "--hidden", "16", "--experiment", "accuracy",
                    "--epochs", str(epochs_c)])
    launches_tc = spmm_tiles.launches           # ... and ends here
    bwd_tc = PspmmTilesSym.backward_launches
    acc = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  report ({time.perf_counter() - t0:.2f} s): {json.dumps(acc)}")
    # per epoch 2 forward + 2 backward passes (layer 0 projects first),
    # then one evaluation forward; every pass runs every local + halo class
    want_c = (epochs_c * (2 + backward_passes(1433, [16, 7])) + 2) * cls_c
    want_bwd_c = epochs_c * backward_passes(1433, [16, 7]) * cls_c
    log(f"  kernel launches {launches_tc} (backward {bwd_tc}); expected "
        f"{want_c} ({want_bwd_c})")
    if launches_tc != want_c or bwd_tc != want_bwd_c:
        raise AssertionError("cora training: kernel launch count differs "
                             "from the passes the program runs")
    gap = abs(acc["oracle_test_acc"] - acc["fullbatch_test_acc"])
    if not (acc["oracle_test_acc"] > 0.75 and gap < 0.03):
        raise AssertionError(f"cora accuracy outside the bands (oracle > "
                             f"0.75, |oracle - fullbatch| < 0.03): {acc}")

    # ---------------------------------------------------------- phase 5
    log("phase 5: train ER n=169343 deg 14, k=8 rp, GCN 128 -> 128 -> 128 "
        "-> 40 (ReLU, xent), 1 warm-up + 5 timed steps")
    widths_f = [128, 128, 40]
    labels_f = np.random.default_rng(4).integers(0, 40, n_f)
    tr = FullBatchTrainer(plan, fin=128, widths=widths_f, seed=5, device=dev)
    data = make_train_data(plan, feats_f, labels_f, device=dev)
    p_init = [w.detach().cpu().numpy() for w in tr.params]
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
    spmm_tiles.launches = 0                     # the main path starts here
    PspmmTilesSym.backward_launches = 0
    rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
    launches_tf = spmm_tiles.launches           # ... and ends here
    bwd_tf = PspmmTilesSym.backward_launches
    cls_f = len(st["pallas_lclasses"]) + len(st["pallas_hclasses"])
    bwd_f = backward_passes(128, widths_f)
    want_f = steps_f * (len(widths_f) + bwd_f) * cls_f
    log(f"  kernel launches {launches_tf} (backward {bwd_tf}) = {steps_f} "
        f"steps x ({len(widths_f)} forward + {bwd_f} backward passes) x "
        f"{cls_f} classes = {want_f}")
    if launches_tf != want_f or bwd_tf != steps_f * bwd_f * cls_f:
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
    ghalo = halo_exchange(g, pa["send_idx"], pa["halo_src"])
    grad_err = max(
        check_k1(ltiles, g, st["pallas_lclasses"], tb,
                 f"flagship layer-{layer_b} gradient local pass f=128"),
        check_k1(htiles, ghalo, st["pallas_hclasses"], tb,
                 f"flagship layer-{layer_b} gradient halo pass f=128"))
    b_loc = time_k1([t.cpu().numpy() for t in ltiles], ltiles, g,
                    st["pallas_lclasses"], tb, plan.b,
                    f"flagship layer-{layer_b} gradient local pass f=128")
    b_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, ghalo,
                     st["pallas_hclasses"], tb, plan.r,
                     f"flagship layer-{layer_b} gradient halo pass f=128")
    bwd = {key: b_loc[key] + b_halo[key]
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"  flagship backward kernel time (layer {layer_b}, local + halo "
        f"passes on the gradient, f=128): {bwd['ms']!r} ms; bound "
        f"{bwd['bound_ms']!r} ms; torch.sparse.mm {bwd['library_ms']!r} ms")
    # one degree class alone (the per-class dispatch's unit): the largest
    # halo class by stored slots
    hcls = st["pallas_hclasses"]
    c = max(range(len(hcls)), key=lambda j: hcls[j][0] * hcls[j][1])
    off = sum(t * e for t, e, *_ in hcls[:c])
    size = hcls[c][0] * hcls[c][1]
    ctiles = [x[:, off: off + size] for x in htiles]
    time_k1([x.cpu().numpy() for x in ctiles], ctiles, ghalo, (hcls[c],), tb,
            plan.r, f"flagship largest halo class {hcls[c][:2]} on the "
            f"layer-{layer_b} gradient, f=128")

    # ---------------------------------------------------------- phase 6
    kernels = [{
        "name": "tile_spmm",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": launches_c + launches_f + launches_tc + launches_tf,
        "max_abs_err": max(max_err, grad_err),
        "ms": layer["ms"],
        "kernel_ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": t_halo["bound_by"],
        "library_ms": layer["library_ms"],
    }, {
        "name": "pspmm_tiles_sym_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:457-464",
        "launches": bwd_tc + bwd_tf,
        "max_abs_err": grad_err,
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": b_halo["bound_by"],
        "library_ms": bwd["library_ms"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
