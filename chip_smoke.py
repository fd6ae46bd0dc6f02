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
  4. one JSON line ``{"kernels": [...]}`` — per ported kernel its launches
     on the main path (phases 2 + 3), max |kernel − plain|, kernel /
     plain / bound / library times at the flagship layer;
  5. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, the script
prints no result and exits with code 2 or 3.
"""

from __future__ import annotations

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


def device_busy(eng, qids, batches: int = 5):
    """Device time vs wall over ``batches`` served batches under
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
        for _ in range(batches):
            eng.query(qids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return wall_ms, sum(ms for _, ms in rows), rows[:5]


def log_device_busy(name, eng, qids):
    wall, dev_ms, top = device_busy(eng, qids)
    if dev_ms == 0:
        log(f"  {name}: profiler saw no device time — idle share not "
            "measured")
        return
    log(f"  {name}: 5 batches under torch.profiler: wall {wall:.3f} ms, "
        f"device {dev_ms:.3f} ms, idle share <= {1 - dev_ms / wall:.3f}; "
        "top: " + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top))


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
    log_device_busy("cora2708", eng_c, np.arange(32))
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
    log_device_busy("flagship", eng_f, np.arange(64))

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
    kernels = [{
        "name": "tile_spmm",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": launches_c + launches_f,
        "max_abs_err": max_err,
        "ms": layer["ms"],
        "kernel_ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": t_halo["bound_by"],
        "library_ms": layer["library_ms"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
