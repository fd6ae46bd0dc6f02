"""Tests of the port that need the card: the CUDA tile SpMM kernel against
its plain PyTorch version, its backward (``PspmmTilesSym``), the serve
engine and a training step on ``cuda``; the kernel's int8-mask entry
point (the GAT attention pass, K5) and the GAT layer (``GatLayerSym``),
engine and trainer on ``cuda``; the ragged ring (K4,
``PspmmTilesRagged`` and the ragged GAT layer) against the a2a flavor on
the card; the row-shuffle kernel (K6) against its plain version; the
kernel's bf16 entry points (K1 and K5 on bf16 tables) against their plain
version, and the bf16 levers (``compute_dtype``, ``halo_dtype``) on the
card against the CPU and ragged against a2a; the stacked row pack that
carries every exchange and the fused local + remote entry of the GCN
aggregation (K3, K4) against their plain versions; the backward of an
asymmetric Â (a directed graph) on its transposed layouts — the halo
rows' Âᵀ family launch, the reverse pack and the fused local-ᵀ + owner
sum — against their plain versions, and two asymmetric trainings on the
card bit-identical.

This module imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

On a machine without CUDA every test skips (the kernel has no CPU mode);
whether there is a card is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from sgcn_tpu_torch.io.datasets import er_graph
from sgcn_tpu_torch.models import gat as gat_mod
from sgcn_tpu_torch.models.gat import GatLayerSym
from sgcn_tpu_torch.ops.row_shuffle import (row_pack, row_pack_plain,
                                            row_shuffle, row_shuffle_plain)
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                          TILE_PLAN_FIELDS_RAGGED,
                                          PspmmTilesGen, PspmmTilesRagged,
                                          PspmmTilesSym,
                                          choose_tile_dispatch,
                                          pspmm_tiles_gen,
                                          pspmm_tiles_ragged,
                                          pspmm_tiles_sym, spmm_tiles,
                                          spmm_tiles_classes,
                                          spmm_tiles_classes_plain,
                                          spmm_tiles_fused,
                                          spmm_tiles_fused_plain,
                                          spmm_tiles_plain)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tiles(k, t, emax, tb, n, seed):
    """Random tiles: dst-sorted real edges over half the rows (the rest
    stay empty), pads of weight 0 at dst tb-1; tile 0 of part 0 is all
    pads and tile 1 of part 0 is full."""
    rng = np.random.default_rng(seed)
    tsrc = np.zeros((k, t, emax), np.int32)
    tld = np.full((k, t, emax), tb - 1, np.int32)
    tw = np.zeros((k, t, emax), np.float32)
    for p in range(k):
        for i in range(t):
            c = 0 if (p, i) == (0, 0) else (
                emax if (p, i) == (0, 1) else int(rng.integers(0, emax + 1)))
            tsrc[p, i, :c] = rng.integers(0, n, c)
            tld[p, i, :c] = np.sort(rng.integers(0, tb // 2, c))
            tw[p, i, :c] = rng.standard_normal(c)
    return tsrc, tld, tw


@pytest.mark.parametrize("f", [7, 16, 40, 128])
def test_kernel_bitwise_equals_plain(cuda_device, f):
    k, t, emax, tb, n = 2, 6, 1040, 256, 500   # > one staged edge chunk
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in _tiles(k, t, emax, tb, n, seed=f)]
    table = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (k, n, f)).astype(np.float32)).to(cuda_device)
    before = spmm_tiles.launches
    one = spmm_tiles(*arrays, table, tb)
    two = spmm_tiles(*arrays, table, tb)
    torch.cuda.synchronize()
    assert spmm_tiles.launches == before + 2
    plain = spmm_tiles_plain(*arrays, table, tb)
    assert torch.equal(one, two), "two launches differ"
    assert torch.equal(one, plain), (
        f"kernel != plain, max diff {(one - plain).abs().max().item()}")
    assert not one[0, :tb].any()                  # the all-pad tile
    assert not one[:, tb // 2: tb - 1].any()      # rows no edge hits


def test_kernel_on_class_slices_of_flat_arrays(cuda_device):
    """The plan's flat (k, Σ t_c·e_c) layout: each class is a strided view
    (part stride Σ t_c·e_c), launched without a copy."""
    k, tb, n, f = 3, 16, 60, 33
    classes = ((2, 48, "tile_spmm"), (3, 16, "tile_spmm"), (1, 8, "tile_spmm"))
    parts = [_tiles(k, t, e, tb, n, seed=i)
             for i, (t, e, _) in enumerate(classes)]
    flat = [torch.from_numpy(np.concatenate(
        [p[j].reshape(k, -1) for p in parts], axis=1)) for j in range(3)]
    table = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (k, n, f)).astype(np.float32))
    want = spmm_tiles_classes(*flat, table, classes, tb)          # plain
    got = spmm_tiles_classes(*(x.to(cuda_device) for x in flat),
                             table.to(cuda_device), classes, tb)
    assert torch.equal(got.cpu(), want)


def test_kernel_refuses_bf16_and_bad_layouts(cuda_device):
    """A bf16 table launches the bf16 entry point (== the plain version,
    counted in ``spmm_tiles.bf16_launches``); a float16 table, a strided
    table and a tile taller than 256 rows raise."""
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in _tiles(1, 2, 8, 8, 10, seed=0)]
    table = torch.zeros(1, 10, 4, device=cuda_device)
    t16 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 10, 4)).astype(np.float32)).to(cuda_device).bfloat16()
    before = spmm_tiles.bf16_launches
    got = spmm_tiles(*arrays, t16, 8)
    torch.cuda.synchronize()
    assert spmm_tiles.bf16_launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, spmm_tiles_plain(*arrays, t16, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tiles(*arrays, table.half(), 8)
    with pytest.raises(ValueError, match="row-major"):
        spmm_tiles(*arrays, table.transpose(1, 2).contiguous()
                   .transpose(1, 2), 8)
    with pytest.raises(ValueError, match="tile height"):
        spmm_tiles(*arrays, table, 512)


def _edge_tiles(k, classes, tb, n, seed):
    """Flat (k, Σ t_c·e_c) tiles over ``classes`` with the kernel's edge
    cases: a hub row of 1100 slots (class 0, tile 0, part 0), empty rows
    (the last quarter of every tile), an all-pad tile (class 1, tile 0)
    and a pad-heavy last class (at most 8 real slots per tile) whose pads
    read row 0 in even parts and mixed rows in odd parts."""
    rng = np.random.default_rng(seed)
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
    return [np.concatenate(x, axis=1) for x in flats]


@pytest.mark.parametrize("weights", ["f32", "mask"])
@pytest.mark.parametrize("f", [1, 7, 8, 16, 17, 40, 41, 128, 129])
def test_family_launch_equals_plain(cuda_device, f, weights):
    """One launch over a whole family of 4 classes == the plain version
    class by class, bit for bit, for both weight types, on a 16-byte
    aligned table and on a view whose base is 4-byte but not 16-byte
    aligned; two launches agree; one launch per call."""
    k, tb, n = 2, 256, 300
    classes = ((1, 1536, "tile_spmm"), (2, 64, "tile_spmm"),
               (1, 256, "tile_spmm"), (2, 600, "tile_spmm"))
    src, ld, w = _edge_tiles(k, [c[:2] for c in classes], tb, n, seed=f)
    if weights == "mask":
        w = (w != 0).astype(np.int8)
    arrays = [torch.from_numpy(a) for a in (src, ld, w)]
    base = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (k, n, f)).astype(np.float32))
    want = spmm_tiles_classes(*arrays, base, classes, tb)        # plain
    dev = [a.to(cuda_device) for a in arrays]
    odd = torch.empty(k * n * f + 1, device=cuda_device)[1:].view(k, n, f)
    odd.copy_(base)
    assert odd.data_ptr() % 16 == 4
    counter = "mask_launches" if weights == "mask" else "launches"
    before = getattr(spmm_tiles, counter)
    one = spmm_tiles_classes(*dev, base.to(cuda_device), classes, tb)
    two = spmm_tiles_classes(*dev, base.to(cuda_device), classes, tb)
    three = spmm_tiles_classes(*dev, odd, classes, tb)
    torch.cuda.synchronize()
    assert getattr(spmm_tiles, counter) == before + 3
    assert torch.equal(one, two), "two launches differ"
    assert torch.equal(one.cpu(), want), (
        f"kernel != plain, max diff {(one.cpu() - want).abs().max()}")
    assert torch.equal(three.cpu(), want), "unaligned table != plain"
    assert not one[:, tb: 2 * tb].any()          # the all-pad tile


@pytest.mark.parametrize("f", [1, 40, 129])
def test_family_launch_keeps_nan_of_pads(cuda_device, f):
    """A pad adds 0·x: where the row the pads read holds inf or NaN, the
    tile's last row turns NaN, as in the plain version — the kernel adds a
    one-source run of pads once and keeps that, and every other value's
    bits; pads of mixed sources are walked one by one."""
    k, tb, n = 2, 256, 300
    classes = ((1, 1536), (2, 64), (1, 256), (2, 600))
    src, ld, w = _edge_tiles(k, classes, tb, n, seed=100 + f)
    table = np.random.default_rng(f).standard_normal(
        (k, n, f)).astype(np.float32)
    table[:, 0, 0] = np.inf                        # pads read row 0
    table[:, 0, -1] = np.nan
    arrays = [torch.from_numpy(a) for a in (src, ld, w)]
    want = spmm_tiles_classes(*arrays, torch.from_numpy(table), classes, tb)
    got = spmm_tiles_classes(*(a.to(cuda_device) for a in arrays),
                             torch.from_numpy(table).to(cuda_device),
                             classes, tb).cpu()
    nan = torch.isnan(want)
    assert nan[:, tb - 1:: tb].any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


def _nan_same(got, want):
    """Equal bits wherever ``want`` is not NaN, NaN where it is."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


@pytest.mark.parametrize("weights", ["f32", "mask"])
@pytest.mark.parametrize("f", [1, 7, 8, 16, 17, 40, 41, 128, 129])
def test_family_launch_on_bf16_table_equals_plain(cuda_device, f, weights):
    """K1 and K5 on a bf16 table: one launch over the 4-class family ==
    the plain version (which upcasts the table) bit for bit, on an 8-byte
    aligned table and on a view whose base is 2-byte but not 8-byte
    aligned; two launches agree; with inf and NaN in the row the pads
    read, the NaNs land where the plain version's do.  Counted in the
    bf16 counters only."""
    k, tb, n = 2, 256, 300
    classes = ((1, 1536, "tile_spmm"), (2, 64, "tile_spmm"),
               (1, 256, "tile_spmm"), (2, 600, "tile_spmm"))
    src, ld, w = _edge_tiles(k, [c[:2] for c in classes], tb, n, seed=f)
    if weights == "mask":
        w = (w != 0).astype(np.int8)
    arrays = [torch.from_numpy(a) for a in (src, ld, w)]
    dev = [a.to(cuda_device) for a in arrays]
    base = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (k, n, f)).astype(np.float32)).bfloat16()
    odd = torch.empty(k * n * f + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(k, n, f)
    odd.copy_(base)
    assert odd.data_ptr() % 8 != 0
    counter = "bf16_mask_launches" if weights == "mask" else "bf16_launches"
    before = (getattr(spmm_tiles, counter), spmm_tiles.launches,
              spmm_tiles.mask_launches)
    want = spmm_tiles_classes(*arrays, base, classes, tb)        # plain
    one = spmm_tiles_classes(*dev, base.to(cuda_device), classes, tb)
    two = spmm_tiles_classes(*dev, base.to(cuda_device), classes, tb)
    three = spmm_tiles_classes(*dev, odd, classes, tb)
    nanb = base.clone()
    nanb[:, 0, 0], nanb[:, 0, -1] = float("inf"), float("nan")
    four = spmm_tiles_classes(*dev, nanb.to(cuda_device), classes, tb)
    torch.cuda.synchronize()
    assert (getattr(spmm_tiles, counter), spmm_tiles.launches,
            spmm_tiles.mask_launches) == (before[0] + 4,) + before[1:]
    assert one.dtype == torch.float32
    assert torch.equal(one, two), "two launches differ"
    assert torch.equal(one.cpu(), want), (
        f"kernel != plain, max diff {(one.cpu() - want).abs().max()}")
    assert torch.equal(three.cpu(), want), "unaligned bf16 table != plain"
    want_nan = spmm_tiles_classes(*arrays, nanb, classes, tb)
    assert torch.isnan(want_nan[:, tb - 1:: tb]).any()
    assert _nan_same(four.cpu(), want_nan)


@pytest.mark.parametrize("lever", ["halo_dtype", "compute_dtype"])
@pytest.mark.parametrize("sched", ["a2a", "ragged"])
def test_gcn_bf16_levers_on_cuda_match_cpu(cuda_device, lever, sched):
    """Two GCN training steps under each bf16 lever on each transport, on
    the card and on the CPU from the same weights: losses rtol 2e-2 (bf16
    matmuls round differently on the two devices); on the card the
    launches go to the fused entry of the tables' dtypes — float32 h and
    a bf16 wire under ``halo_dtype``, bf16 both under ``compute_dtype`` —
    one per aggregation, 2 forward + 1 backward per step, and no K1
    family launch."""
    plan = _er_plan()
    rng = np.random.default_rng(21)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    got = {}
    for dev in ("cpu", cuda_device):
        tr = FullBatchTrainer(plan, fin=24, widths=[32, 5], seed=2,
                              device=dev, comm_schedule=sched,
                              **{lever: "bfloat16"})
        data = make_train_data(plan, feats, labels, device=dev)
        for c in ("launches", "wire_bf16_launches", "bf16_launches"):
            setattr(spmm_tiles_fused, c, 0)
        spmm_tiles.launches = spmm_tiles.bf16_launches = 0
        losses = [tr.step(data) for _ in range(2)]
        got[str(dev)] = (losses, spmm_tiles_fused.launches,
                         spmm_tiles_fused.wire_bf16_launches,
                         spmm_tiles_fused.bf16_launches,
                         spmm_tiles.launches + spmm_tiles.bf16_launches)
    (l_c, *_), (l_g, *n) = got["cpu"], got["cuda"]
    want = 2 * (2 + 1)
    assert tuple(n) == ((0, want, 0, 0) if lever == "halo_dtype"
                        else (0, 0, want, 0))
    np.testing.assert_allclose(l_g, l_c, rtol=2e-2)


@pytest.mark.parametrize("widths", [[6, 4], [6, 3], [130, 5]])
def test_gat_bf16_on_cuda_ragged_equals_a2a_and_tracks_cpu(cuda_device,
                                                          widths):
    """GAT under ``compute_dtype='bfloat16'`` on the card: packed (even),
    fused bf16 (odd) and split bf16 (odd, 130 → split) layers; two steps
    on the ring == on a2a bit for bit, the bf16 mask entry launched, and
    the losses within rtol 2e-2 of the CPU's."""
    plan = _er_plan()
    rng = np.random.default_rng(22)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, widths[-1], plan.n)
    runs = {}
    for dev, sched in (("cpu", "a2a"), (cuda_device, "a2a"),
                       (cuda_device, "ragged")):
        tr = FullBatchTrainer(plan, fin=24, widths=widths, model="gat",
                              activation="none", seed=4, device=dev,
                              comm_schedule=sched, compute_dtype="bfloat16")
        data = make_train_data(plan, feats, labels, device=dev)
        spmm_tiles.bf16_mask_launches = 0
        losses = [tr.step(data) for _ in range(2)]
        runs[(str(dev), sched)] = (losses, [p.detach().cpu() for p in
                                            tr.model.parameters()],
                                   spmm_tiles.bf16_mask_launches)
    cpu, a2a, ring = (runs[("cpu", "a2a")], runs[("cuda", "a2a")],
                      runs[("cuda", "ragged")])
    assert a2a[2] > 0 and ring[2] == a2a[2] and cpu[2] == 0
    assert ring[0] == a2a[0]
    assert all(torch.equal(a, b) for a, b in zip(ring[1], a2a[1]))
    np.testing.assert_allclose(a2a[0], cpu[0], rtol=2e-2)


def test_engine_on_cuda_launches_kernel_and_matches_cpu(cuda_device):
    a = normalize_adjacency(er_graph(3000, avg_deg=10, seed=1))
    plan = build_comm_plan(a, balanced_random_partition(3000, 4, seed=1), 4)
    feats = np.random.default_rng(0).standard_normal(
        (3000, 24)).astype(np.float32)
    kw = dict(fin=24, widths=[32, 5], max_batch=8, seed=2)
    cpu = ServeEngine(plan, device="cpu", **kw)
    gpu = ServeEngine(plan, device=cuda_device, **kw)
    for e in (cpu, gpu):
        e.set_features(feats)
    spmm_tiles_fused.launches = row_pack.launches = 0
    q = np.arange(0, 3000, 397)
    got = gpu.query(q)
    # one forward x 2 layers: one exchange pack and one fused launch each
    assert spmm_tiles_fused.launches == row_pack.launches == 1 * 2
    np.testing.assert_allclose(got, cpu.query(q), rtol=1e-5, atol=1e-6)


def _er_plan(n=3000, k=4, seed=1):
    a = normalize_adjacency(er_graph(n, avg_deg=10, seed=seed))
    return build_comm_plan(a, balanced_random_partition(n, k, seed=seed), k)


def test_backward_on_cuda_bitwise_equals_cpu(cuda_device):
    """The aggregation's backward launches the fused entry on the gradient
    (one launch: the local and halo families and their sum) and equals
    the same Function on CPU tensors bit for bit — also for a strided
    gradient, which the backward makes row-major before the launch."""
    plan = _er_plan()
    st = choose_tile_dispatch(plan)
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    pa = [torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in TILE_PLAN_FIELDS]
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 24)).astype(np.float32))
    wide = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 48)).astype(np.float32))
    for g in (wide[..., :24].contiguous(), wide[..., ::2]):
        out = {}
        for dev in ("cpu", cuda_device):
            x = h.to(dev, copy=True).requires_grad_()
            y = pspmm_tiles_sym(x, *(t.to(dev) for t in pa), *static)
            before = PspmmTilesSym.backward_launches
            y.backward(g.to(dev))
            torch.cuda.synchronize()
            out[str(dev)] = (x.grad.cpu(),
                             PspmmTilesSym.backward_launches - before)
        (cpu, n_cpu), (gpu, n_gpu) = out["cpu"], out["cuda"]
        assert len(static[1]) > 1 and len(static[2]) > 1
        assert n_cpu == 0 and n_gpu == 1
        assert torch.equal(cpu, gpu), (
            f"backward cuda != cpu, max diff {(cpu - gpu).abs().max()}")


def test_trainer_step_on_cuda_matches_cpu(cuda_device):
    """One ``FullBatchTrainer.step`` on the card vs on the CPU from the
    same weights: loss rtol 1e-5, weight gradients rtol 1e-4 / atol 1e-7
    (the dense products sum in other orders on the card).  The card step
    launches the fused entry for 2 forward and 1 backward aggregations
    (layer 0 aggregates first: its input needs no gradient), once
    each."""
    plan = _er_plan()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    got = {}
    for dev in ("cpu", cuda_device):
        tr = FullBatchTrainer(plan, fin=24, widths=[32, 5], seed=2,
                              device=dev)
        data = make_train_data(plan, feats, labels, device=dev)
        grads = []
        tr.opt.register_step_pre_hook(lambda opt, a, kw, tr=tr: grads.append(
            [w.grad.cpu().clone() for w in tr.params]))
        spmm_tiles_fused.launches = 0
        loss = tr.step(data)
        got[str(dev)] = (loss, grads[0], spmm_tiles_fused.launches)
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = got["cpu"], got["cuda"]
    assert n_c == 0 and n_g == 2 + 1
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_g, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)


# ------------------------------------------------------------ GAT (K5)
@pytest.mark.parametrize("f", [1, 41, 128])
def test_mask_kernel_equals_plain_and_k1_on_upcast_mask(cuda_device, f):
    """The int8-mask entry point: == its plain version, == K1 on the
    upcast f32 mask, and two launches agree, bit for bit; counted in
    ``spmm_tiles.mask_launches``, not in ``spmm_tiles.launches``."""
    k, t, emax, tb, n = 2, 6, 1040, 256, 500
    src, ld, w = _tiles(k, t, emax, tb, n, seed=f)
    mask = (w != 0).astype(np.int8)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in (src, ld, mask)]
    table = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (k, n, f)).astype(np.float32)).to(cuda_device)
    before, before_k1 = spmm_tiles.mask_launches, spmm_tiles.launches
    one = spmm_tiles(*arrays, table, tb)
    two = spmm_tiles(*arrays, table, tb)
    torch.cuda.synchronize()
    assert spmm_tiles.mask_launches == before + 2
    assert spmm_tiles.launches == before_k1
    k1 = spmm_tiles(*arrays[:2], arrays[2].float(), table, tb)
    plain = spmm_tiles_plain(*arrays, table, tb)
    assert torch.equal(one, two), "two launches differ"
    assert torch.equal(one, plain), (
        f"mask kernel != plain, max diff {(one - plain).abs().max().item()}")
    assert torch.equal(one, k1), "mask kernel != K1 on the upcast mask"
    assert not one[0, :tb].any()


def _gat_layer_inputs(plan, fin, fout, seed):
    rng = np.random.default_rng(seed)
    valid = plan.row_valid[..., None]
    h = rng.standard_normal((plan.k, plan.b, fin)) * valid
    w = rng.standard_normal((fin, fout)) / np.sqrt(fin)
    a1, a2 = (rng.standard_normal(fout) / np.sqrt(fout) for _ in range(2))
    g = rng.standard_normal((plan.k, plan.b, fout)) * valid
    return [torch.tensor(x, dtype=torch.float32) for x in (w, a1, a2, h, g)]


@pytest.mark.parametrize("fout", [40, 128])
def test_gat_layer_on_cuda_matches_cpu(cuda_device, fout, monkeypatch):
    """``GatLayerSym`` forward and backward on the card vs the same
    Function on CPU tensors.  Every aggregation the card ran (forward and
    backward) equals the plain version on the same tables bit for bit;
    the layer's output and the gradients of ``w``, ``a2`` and ``h`` agree
    within a relative Frobenius error of 1e-5 each — the dense products
    (cuBLAS vs the CPU's BLAS) and ``exp`` round their last bits
    differently (up to ~5e-7 absolute on outputs of order 1), so
    whole-layer bits may differ.  ``a1``'s
    gradient is exactly 0; the card launches the mask kernel once (fused,
    fout = 40) or twice (split, fout = 128) per direction, each launch
    covering all the combined family's classes."""
    plan = _er_plan()
    setup = resolve_forward_setup(plan, model="gat")
    cls = setup.fwd_static["pallas_cclasses"]
    w, a1, a2, h, g = _gat_layer_inputs(plan, 24, fout, seed=fout)
    seen = []
    orig = gat_mod._gat_tiles_aggregate

    def recording(p, s, form, *rest):
        out = orig(p, s, form, *rest)
        seen.append(((p.detach(), s.detach(), form) + rest,
                     [x.detach() for x in out]))
        return out

    monkeypatch.setattr(gat_mod, "_gat_tiles_aggregate", recording)
    got = {}
    for dev in ("cpu", cuda_device):
        pa = setup.ship_arrays(plan, dev)
        leaves = [x.to(dev, copy=True).requires_grad_()
                  for x in (w, a1, a2, h)]
        seen.clear()
        before = spmm_tiles.mask_launches
        bwd_before = GatLayerSym.backward_launches
        out = GatLayerSym.apply(
            *leaves, *(pa[f] for f in ("recv_src", "halo_src_flat",
                                        "ptile_csrc", "ptile_cld",
                                        "ptile_cw", "row_valid")), 256, cls)
        out.backward(g.to(dev))
        torch.cuda.synchronize()
        got[str(dev)] = ([out.detach().cpu()]
                         + [x.grad.cpu() for x in leaves],
                         spmm_tiles.mask_launches - before,
                         GatLayerSym.backward_launches - bwd_before,
                         list(seen))
    (cpu, n_cpu, _, _), (gpu, n_gpu, n_bwd, calls) = got["cpu"], got["cuda"]
    passes = 1 if fout + 1 <= 128 else 2
    assert n_cpu == 0
    assert len(cls) > 1
    assert n_gpu == 2 * passes and n_bwd == passes
    assert len(calls) == 2                       # forward, backward
    for (p, s, form, *rest), outs in calls:
        plain = orig(p.cpu(), s.cpu(), form,
                     *(x.cpu() if torch.is_tensor(x) else x for x in rest))
        for x, y in zip(outs, plain):
            assert torch.equal(x.cpu(), y), "K5 on the card != plain"
    assert not gpu[2].any() and not cpu[2].any()   # d a1
    for name, x, y in zip(("out", "w", "a2", "h"), gpu[:2] + gpu[3:],
                          cpu[:2] + cpu[3:]):
        rel = float((x - y).norm() / y.norm())
        print(f"fout {fout} {name}: relative Frobenius gap {rel:.3g}, max "
              f"|card - cpu| {float((x - y).abs().max()):.3g}")
        assert rel <= 1e-5, name


def test_gat_engine_and_trainer_on_cuda_match_cpu(cuda_device):
    """The GAT serve engine and one trainer step on the card vs the CPU
    from the same weights: served rows rtol 1e-5 / atol 1e-6, loss
    rtol 1e-5, gradients rtol 1e-4 / atol 1e-7.  Launches of the mask
    kernel, one per pass over the whole combined family: forward passes
    (split 2, fused 1 per layer) to serve; forward + backward passes
    (every layer's backward runs) to train."""
    plan = _er_plan()
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    kw = dict(fin=24, widths=[130, 5], seed=3)
    passes = 2 + 1
    engines = [ServeEngine(plan, model="gat", max_batch=8, device=d, **kw)
               for d in ("cpu", cuda_device)]
    q = np.arange(0, plan.n, 397)
    rows = []
    for e in engines:
        e.set_features(feats)
        before = spmm_tiles.mask_launches
        rows.append(e.query(q))
        assert spmm_tiles.mask_launches - before == (
            0 if e.device.type == "cpu" else passes)
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-5, atol=1e-6)
    got = {}
    for dev in ("cpu", cuda_device):
        tr = FullBatchTrainer(plan, model="gat", activation="none",
                              device=dev, **kw)
        data = make_train_data(plan, feats, labels, device=dev)
        grads = []
        tr.opt.register_step_pre_hook(lambda opt, a, k, tr=tr: grads.append(
            [p.grad.cpu().clone() for p in tr.model.parameters()]))
        before = spmm_tiles.mask_launches
        loss = tr.step(data)
        got[str(dev)] = (loss, grads[0], spmm_tiles.mask_launches - before)
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = got["cpu"], got["cuda"]
    assert n_c == 0 and n_g == 2 * passes
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_g, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)


# ------------------------------------------------------- the ring (K4)
def test_ragged_on_cuda_equals_a2a_bitwise(cuda_device):
    """``pspmm_tiles_ragged`` on the card: forward and backward equal
    ``pspmm_tiles_sym`` on the card and the ragged op on the CPU, bit for
    bit; one fused launch in each direction, counted in
    ``PspmmTilesRagged.launches``/``.backward_launches``."""
    plan = _er_plan()
    st = choose_tile_dispatch(plan, schedule="ragged")
    plan.ensure_exchange()
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    fields = TILE_PLAN_FIELDS + ("ring_src", "ptile_hrsrc")
    pa = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in fields}
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 40)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 80)).astype(np.float32))[..., ::2]
    out = {}
    for dev, sched in (("cpu", "ragged"), (cuda_device, "ragged"),
                       (cuda_device, "a2a")):
        x = h.to(dev, copy=True).requires_grad_()
        t = {f: v.to(dev) for f, v in pa.items()}
        before = (PspmmTilesRagged.launches,
                  PspmmTilesRagged.backward_launches)
        if sched == "ragged":
            y = pspmm_tiles_ragged(x, *(t[f] for f in
                                        TILE_PLAN_FIELDS_RAGGED),
                                   *static, st["rr_sizes"])
        else:
            y = pspmm_tiles_sym(x, *(t[f] for f in TILE_PLAN_FIELDS),
                                *static)
        y.backward(g.to(dev))
        torch.cuda.synchronize()
        out[(str(dev), sched)] = (
            y.detach().cpu(), x.grad.cpu(),
            PspmmTilesRagged.launches - before[0],
            PspmmTilesRagged.backward_launches - before[1])
    cpu, gpu, a2a = (out[("cpu", "ragged")], out[("cuda", "ragged")],
                     out[("cuda", "a2a")])
    assert cpu[2:] == (0, 0) and gpu[2:] == (1, 1) and a2a[2:] == (0, 0)
    for i in (0, 1):
        assert torch.equal(gpu[i], a2a[i]), "ragged != a2a on the card"
        assert torch.equal(gpu[i], cpu[i]), "ragged card != CPU"


@pytest.mark.parametrize("model,widths", [("gcn", [32, 5]),
                                          ("gat", [130, 5])])
def test_ragged_trainer_and_engine_on_cuda_equal_a2a(cuda_device, model,
                                                     widths):
    """Serving and two training steps on the ring, on the card: rows,
    losses and weights equal the a2a runs' bit for bit.  The GAT case is
    split at width 130, whose ring slices ``ring[..., :fout]`` and
    ``ring[..., fout]`` are strided views: the layer ``cat``s them into
    row-major tables before the kernel, which refuses strided tables."""
    plan = _er_plan()
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    kw = dict(fin=24, widths=widths, model=model, seed=4)
    act = {"activation": "none"} if model == "gat" else {}
    rows, runs = {}, {}
    q = np.arange(0, plan.n, 397)
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(plan, comm_schedule=sched, max_batch=8,
                          device=cuda_device, **kw)
        eng.set_features(feats)
        rows[sched] = eng.query(q)
        tr = FullBatchTrainer(plan, comm_schedule=sched, device=cuda_device,
                              **kw, **act)
        data = make_train_data(plan, feats, labels, device=cuda_device)
        losses = [tr.step(data) for _ in range(2)]
        runs[sched] = (losses, [p.detach().cpu()
                                for p in tr.model.parameters()])
    np.testing.assert_array_equal(rows["a2a"], rows["ragged"])
    assert runs["a2a"][0] == runs["ragged"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["a2a"][1],
                                                 runs["ragged"][1]))


# ----------------------------------------------------- the row shuffle (K6)
@pytest.mark.parametrize("f", [1, 41, 128])
def test_row_shuffle_kernel_equals_plain(cuda_device, f):
    """The row-shuffle kernel at the probe's S = 2048: == its plain
    version and two launches agree, bit for bit; counted in
    ``row_shuffle.launches``.  A table whose base is not 16-byte aligned
    takes the one-float-per-lane path and gives the same bits."""
    s = 2048
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.standard_normal((s, f)).astype(
        np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, s, (s, 1)).astype(
        np.int32)).to(cuda_device)
    before = row_shuffle.launches
    one, two = row_shuffle(x, idx), row_shuffle(x, idx)
    odd = torch.empty(s * f + 1, device=cuda_device)[1:].view(s, f)
    odd.copy_(x)
    three = row_shuffle(odd, idx)
    torch.cuda.synchronize()
    assert row_shuffle.launches == before + 3
    plain = row_shuffle_plain(x, idx)
    assert torch.equal(one, two) and torch.equal(one, plain)
    assert torch.equal(three, plain)


# ------------------------------------- the row pack and the fused entry
def _special(x):
    """±inf, NaN and float32 values at bf16 rounding ties in the first
    rows (1 + 2⁻⁸ rounds down, 1 + 3·2⁻⁸ up: nearest even)."""
    vals = (float("inf"), -float("inf"), float("nan"), 1.0 + 2 ** -8,
            1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8))
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    for i, v in enumerate(vals):
        flat[:, i % x.shape[1], i % flat.shape[2]] = v
    return x


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind", ["f32", "f32->bf16", "bf16", "bf16->f32"])
@pytest.mark.parametrize("w", [1, 2, 7, 41, 65, 128])
def test_row_pack_equals_plain_bitwise(cuda_device, w, kind, aligned):
    """The row pack at ``w`` words a row (a ``(k, rows)`` table at w = 1),
    on each dtype pair, from a 16-byte aligned source or one whose base is
    4-byte (bf16: 2-byte) but not 16-byte aligned: == its plain version
    on the card bit for bit — ±inf, NaN and rounding ties included, the
    NaN bits torch's cast writes — and two launches agree; counted in
    ``row_pack.launches``."""
    src_dt, out_dt = {"f32": (torch.float32, torch.float32),
                      "f32->bf16": (torch.float32, torch.bfloat16),
                      "bf16": (torch.bfloat16, torch.bfloat16),
                      "bf16->f32": (torch.bfloat16, torch.float32)}[kind]
    rng = np.random.default_rng(w)
    k, rows = 3, 300
    x = _special(torch.from_numpy(rng.standard_normal(
        (k, rows, w)).astype(np.float32))).to(src_dt).to(cuda_device)
    if not aligned:
        odd = torch.empty(x.numel() + 1, dtype=src_dt,
                          device=cuda_device)[1:].view(x.shape)
        odd.copy_(x)
        x = odd
        assert x.data_ptr() % 16
    if w == 1:
        x = x[..., 0]
    flat = torch.from_numpy(rng.integers(0, k * rows, (k, 500)).astype(
        np.int32)).to(cuda_device)
    before = row_pack.launches
    one, two = row_pack(x, flat, out_dt), row_pack(x, flat, out_dt)
    torch.cuda.synchronize()
    assert row_pack.launches == before + 2
    plain = row_pack_plain(x, flat, out_dt)
    assert one.dtype == out_dt and one.shape == plain.shape
    assert torch.equal(_bits(one), _bits(two))
    assert torch.equal(_bits(one), _bits(plain))


def test_row_pack_refuses_bad_inputs(cuda_device):
    """A strided source, an int64 index or a float16 table raise; an
    index out of range fails the launch (the kernel traps)."""
    x = torch.zeros(2, 10, 8, device=cuda_device)
    flat = torch.zeros(2, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="row-major"):
        row_pack(x[:, :, ::2], flat)
    with pytest.raises(TypeError, match="int32"):
        row_pack(x, flat.long())
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        row_pack(x.half(), flat)


def _fused_case(dev, f, hd, rd, seed, nan=False):
    k, tb, n = 2, 256, 700
    lclasses = ((2, 1040), (3, 24))
    hclasses = ((2, 520), (3, 16))
    lt = [torch.from_numpy(a).to(dev) for a in _edge_tiles(
        k, lclasses, tb, n, seed)]
    ht = [torch.from_numpy(a).to(dev) for a in _edge_tiles(
        k, hclasses, tb, n, seed + 1)]
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((k, n, f)).astype(
        np.float32)).to(hd).to(dev)
    r = torch.from_numpy(rng.standard_normal((k, n, f)).astype(
        np.float32)).to(rd).to(dev)
    if nan:
        h[:, 0, 0], r[:, 0, -1] = float("inf"), float("nan")
    return lt, h, ht, r, lclasses, hclasses, tb


@pytest.mark.parametrize("dtypes", ["f32/f32", "f32/bf16", "bf16/bf16"])
@pytest.mark.parametrize("f", [1, 7, 16, 40, 41, 128, 129])
def test_fused_entry_equals_plain_bitwise(cuda_device, f, dtypes):
    """The fused local + remote entry on random tiles with a hub row and
    pad-heavy tiles (``_edge_tiles``), h and the remote table in each of
    the port's dtype pairs: == its plain version (the two plain family
    passes, the slices, the float32 add and the cast; no kernel) bit for
    bit, with inf and
    NaN in the row the pads read too; two launches agree; one launch,
    counted in the pair's counter."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    hd, rd = (dt[x] for x in dtypes.split("/"))
    counter = {"f32/f32": "launches", "f32/bf16": "wire_bf16_launches",
               "bf16/bf16": "bf16_launches"}[dtypes]
    for nan in (False, True):
        args = _fused_case(cuda_device, f, hd, rd, seed=f, nan=nan)
        before = getattr(spmm_tiles_fused, counter)
        one = spmm_tiles_fused(*args)
        two = spmm_tiles_fused(*args)
        torch.cuda.synchronize()
        assert getattr(spmm_tiles_fused, counter) == before + 2
        k1_before = (spmm_tiles.launches, spmm_tiles.bf16_launches)
        plain = spmm_tiles_fused_plain(*args)
        # the plain version is torch arithmetic: no family launch
        assert (spmm_tiles.launches, spmm_tiles.bf16_launches) == k1_before
        assert one.dtype == hd and one.shape == (2, 700, f)
        assert torch.equal(_bits(one), _bits(two))
        assert torch.equal(_bits(one), _bits(plain)), (
            f"fused != plain, max diff "
            f"{(one.float() - plain.float()).abs().nan_to_num().max()}")


# --------------------------------------------- asymmetric Â (directed)
def _directed_plan(n=3000, deg=8, k=4, seed=1):
    """A directed Erdős–Rényi graph (n·deg ordered pairs, self pairs
    dropped), normalized, in k balanced random parts."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, (2, n * deg))
    keep = r != c
    a = sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                       (r[keep], c[keep])), shape=(n, n))
    a.data[:] = 1.0
    plan = build_comm_plan(normalize_adjacency(a),
                           balanced_random_partition(n, k, seed=seed), k)
    assert not plan.symmetric
    return plan


@pytest.mark.parametrize("lever", [None, "halo_dtype", "compute_dtype"])
def test_transposed_launches_equal_plain_bitwise(cuda_device, lever):
    """The backward of an asymmetric Â's aggregation on the card: its
    halo-ᵀ family launch, its reverse pack and its fused launch each ==
    their plain versions on the same inputs, bit for bit, and the whole
    backward (``PspmmTilesGen``) == the same Function on CPU tensors,
    with one launch of each per aggregation.  ``halo_dtype`` narrows the
    reverse wire, ``compute_dtype`` runs bf16 tables."""
    from sgcn_tpu_torch.ops.pspmm import reverse_exchange

    plan = _directed_plan()
    setup = resolve_forward_setup(plan)
    st = setup.fwd_static
    cpu_pa = setup.ship_arrays(plan, "cpu")
    pa = {f: t.to(cuda_device) for f, t in cpu_pa.items()}
    dt = torch.bfloat16 if lever == "compute_dtype" else torch.float32
    halo = "bfloat16" if lever == "halo_dtype" else None
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 40)).astype(np.float32)).to(cuda_device, dt)
    fam = [tuple(pa[f"ptile_t{x}{y}"] for y in ("src", "ld", "w"))
           for x in ("l", "h", "1")]
    counter = "bf16_launches" if dt == torch.bfloat16 else "launches"
    before = getattr(spmm_tiles, counter)
    send = spmm_tiles_classes(*fam[1], g, st["pallas_thclasses"], 256)
    assert getattr(spmm_tiles, counter) == before + 1
    assert torch.equal(send, spmm_tiles_classes_plain(
        *fam[1], g, st["pallas_thclasses"], 256))
    before = row_pack.launches
    rwire = reverse_exchange(send, pa["rev_src"], halo, dt)
    assert row_pack.launches == before + 1
    assert torch.equal(_bits(rwire), _bits(row_pack_plain(
        send, pa["rev_src"], rwire.dtype)))
    args = (fam[0], g, fam[2], rwire, st["pallas_tlclasses"],
            st["pallas_t1classes"], 256)
    assert torch.equal(_bits(spmm_tiles_fused(*args)),
                       _bits(spmm_tiles_fused_plain(*args)))
    tcls = (st["pallas_tlclasses"], st["pallas_thclasses"],
            st["pallas_t1classes"])
    out = {}
    for dev, arrays in (("cpu", cpu_pa), ("cuda", pa)):
        x = g.detach().to(dev, copy=True).requires_grad_()
        y = pspmm_tiles_gen(x, arrays, 256, st["pallas_lclasses"],
                            st["pallas_hclasses"], tcls, halo)
        before = (spmm_tiles.launches + spmm_tiles.bf16_launches,
                  row_pack.launches, PspmmTilesGen.backward_launches)
        y.backward(g.to(dev))
        torch.cuda.synchronize()
        after = (spmm_tiles.launches + spmm_tiles.bf16_launches,
                 row_pack.launches, PspmmTilesGen.backward_launches)
        out[dev] = (x.grad.cpu(), tuple(b - a for a, b in zip(before, after)))
    assert out["cpu"][1] == (0, 0, 0) and out["cuda"][1] == (1, 1, 1)
    assert torch.equal(_bits(out["cpu"][0]), _bits(out["cuda"][0]))


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_asymmetric_training_on_cuda_is_bit_identical(cuda_device, model):
    """Two trainers from the same seed on a directed graph on the card:
    the same 3 losses and weights, bit for bit (no float atomics on the
    path), and both track the CPU's losses within rtol 1e-5.  GAT at an
    odd and a 130-wide layer runs the fused and split transposed
    passes."""
    plan = _directed_plan()
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    widths = [130, 5] if model == "gat" else [32, 5]
    runs = []
    for dev in (cuda_device, cuda_device, "cpu"):
        tr = FullBatchTrainer(plan, fin=24, widths=widths, model=model,
                              seed=2, device=dev)
        data = make_train_data(plan, feats, labels, device=dev)
        runs.append(([tr.step(data) for _ in range(3)],
                     [p.detach().cpu() for p in tr.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    np.testing.assert_allclose(runs[0][0], runs[2][0], rtol=1e-5)


# ------------------------------------------------ checkpoints on the card
def _er_files(tmp_path, n=300):
    """A symmetric ER graph as a ``.mtx`` and a 4-part random part vector
    as a text file, for the train CLI."""
    import scipy.io

    mtx, parts = str(tmp_path / "g.mtx"), str(tmp_path / "g.4.rp")
    scipy.io.mmwrite(mtx, er_graph(n, avg_deg=8, seed=3))
    np.savetxt(parts, balanced_random_partition(n, 4, seed=1), fmt="%d")
    return ["-a", mtx, "--normalize", "-p", parts, "-s", "4", "-f", "24",
            "-l", "2", "--hidden", "32", "--warmup", "0", "--epochs", "6",
            "--device", "cuda"]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_kill_and_resume_on_cuda_is_bit_identical(cuda_device, model,
                                                  tmp_path):
    """On the card: a child killed after its step-3 save (exit 43), a new
    process resuming it to 6 steps, and an uninterrupted child end with
    the same losses and the same final state file, bit for bit."""
    import json

    import torch_resume_child as child

    argv = _er_files(tmp_path) + ["--model", model, "--checkpoint-every",
                                  "3"]
    full, kill = str(tmp_path / "full"), str(tmp_path / "kill")
    codes = child.spawn_all([
        (argv + ["--checkpoint-dir", full + ".d", "--save-checkpoint",
                 full + ".npz"], None, full),
        (argv + ["--checkpoint-dir", kill + ".d"], "kill-after-save:3",
         kill)])
    assert codes == [0, 43]
    resume = str(tmp_path / "resume")
    assert child.spawn_all([(argv + [
        "--checkpoint-dir", kill + ".d", "--resume", "auto",
        "--save-checkpoint", resume + ".npz"], None, resume)]) == [0]
    want = child.read_result(full)["report"]
    got = child.read_result(resume)["report"]
    assert got["resumed"]["step"] == 3
    assert got["losses"] == want["losses"][3:]
    with np.load(full + ".npz") as a, np.load(resume + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    assert json.loads(str(np.load(full + ".npz")["__train_state__"]))[
        "step_count"] == 6


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_engine_from_checkpoint_on_cuda_serves_predict_rows(cuda_device,
                                                            model, tmp_path):
    """``ServeEngine(checkpoint=…)`` on the card serves the trainer's
    ``predict`` rows bit for bit; a hot swap keeps every parameter's
    storage and moves the rows to the new file's."""
    from sgcn_tpu_torch.resilience.checkpoint import CheckpointManager
    from sgcn_tpu_torch.utils.checkpoint import save_checkpoint

    n = 300
    plan = build_comm_plan(normalize_adjacency(er_graph(n, avg_deg=8,
                                                        seed=3)),
                           balanced_random_partition(n, 4, seed=1), 4)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    tr = FullBatchTrainer(plan, fin=24, widths=[32, 5], model=model,
                          activation="none" if model == "gat" else "relu",
                          seed=2, device=cuda_device)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    tr.step(data)
    first = save_checkpoint(tr, str(tmp_path / "one"), step=1)
    rows1 = tr.predict(data)
    tr.step(data)
    CheckpointManager(str(tmp_path / "d")).save(tr, 2)
    rows2 = tr.predict(data)
    q = np.arange(0, n, 7)
    eng = ServeEngine(plan, fin=24, widths=[32, 5], model=model,
                      checkpoint=first, max_batch=64, device=cuda_device)
    eng.set_features(feats)
    assert np.array_equal(eng.query(q), rows1[q])
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    eng.attach_checkpoint_watch(str(tmp_path / "d"))
    assert np.array_equal(eng.query(q), rows2[q])
    assert eng.weights_rev == 1
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
