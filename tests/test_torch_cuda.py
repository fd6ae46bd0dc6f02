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
card bit-identical; the pack, the fused entry and the ring on a plan from
the port's native hypergraph partitioner (a DCSBM graph at n = 20 000);
the stale-halo ops (``PspmmTilesStale``, both transports) against their
CPU versions, and the stale trainer's ``sync_every=1`` == exact and ring
== a2a on the card; the destination-indexed pack (``row_pack_into``)
against its plain version, one replica and one composed replica × stale
step against their CPU versions, and the replica trainer's launches on
the card; sub-graph serving's compact fused and K5 launches against their
plain versions on a batch holding a hub row, and the sub-graph engine's
launches and rows on the card; one NCCL rank training a proxy slice
through the rank path against the stacked proxy, bit for bit (GCN on
float32, the bf16 wire, ``compute_dtype`` and ``remat``; GAT with every
K5 launch against its plain version; the carried modes — the stale
halo, the halo-delta cache, replicas, replica × stale and the partial
refresh — with the rank's fused launch on its carry and its pack-into
from a shrunken receive against their plain versions), the broadcast
baseline's K1 launch against its plain version, and the launch layer's
one-process no-op; a directed plan on one NCCL rank against the stacked
proxy (GCN on float32, the bf16 wire and ``compute_dtype``; GAT) with
every family launch of a step — the backward's halo-ᵀ, local-ᵀ and
weight-1 families over the reverse ``all_to_all_single``'s buffer among
them — against its plain version, and the mini-batch trainer on one
NCCL rank against the shard proxy of the same part's batch slices; the
ELL aggregator (``SGCN_PALLAS_SPMM=0``): ring == a2a and the card == the
CPU bit for bit, trainers deterministic, with no K1 or fused launch and
one pack an exchange.

This module imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

On a machine without CUDA every test skips (the kernel has no CPU mode);
whether there is a card is decided inside the fixture, never at import.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from sgcn_tpu_torch.io.datasets import er_graph
from sgcn_tpu_torch.models import gat as gat_mod
from sgcn_tpu_torch.models.gat import GatLayerSym
from sgcn_tpu_torch.ops.row_shuffle import (row_pack, row_pack_into,
                                            row_pack_into_plain,
                                            row_pack_plain, row_shuffle,
                                            row_shuffle_plain)
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                          TILE_PLAN_FIELDS_RAGGED,
                                          PspmmTilesGen, PspmmTilesRagged,
                                          PspmmTilesReplica,
                                          PspmmTilesStale, PspmmTilesSym,
                                          choose_tile_dispatch,
                                          pspmm_tiles_gen,
                                          pspmm_tiles_ragged,
                                          pspmm_tiles_replica,
                                          pspmm_tiles_stale,
                                          pspmm_tiles_stale_ragged,
                                          pspmm_tiles_sym, spmm_tiles,
                                          spmm_tiles_classes,
                                          spmm_tiles_classes_plain,
                                          spmm_tiles_fused,
                                          spmm_tiles_fused_plain,
                                          spmm_tiles_plain)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import (ServeEngine, SubgraphIndex, VertexRouter,
                                  build_batch)
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


# ------------------------------------ hypergraph-partitioned plans (hp)
@functools.lru_cache(maxsize=1)
def _hp_dcsbm_plan(n=20000, k=8):
    """The DCSBM graph (power-law degrees, 64 planted communities) at n,
    Â normalized, in k parts from the port's native hypergraph
    partitioner (seed 1): uneven parts, a hub row, an uneven ring.
    Built once, on the first test that gets past the card check."""
    from sgcn_tpu_torch.io.datasets import dcsbm_graph
    from sgcn_tpu_torch.partition import partition_hypergraph_colnet

    a = normalize_adjacency(dcsbm_graph(n))
    pv, _ = partition_hypergraph_colnet(a, k, seed=1)
    return a, build_comm_plan(a, pv, k)


@pytest.mark.parametrize("f", [1, 41, 128])
def test_fused_entry_equals_plain_on_hp_dcsbm_plan(cuda_device, f):
    """The exchange pack and the fused local + remote entry on an
    hp-partitioned DCSBM plan at n = 20 000 == their plain versions bit
    for bit; the plan's tiles hold every edge, the longest row's
    included."""
    a, plan = _hp_dcsbm_plan()
    st = choose_tile_dispatch(plan)
    plan.ensure_exchange()
    tb, lcls, hcls = (st["pallas_tb"], st["pallas_lclasses"],
                      st["pallas_hclasses"])
    dev = cuda_device
    lt = [torch.from_numpy(getattr(plan, x)).to(dev)
          for x in ("ptile_lsrc", "ptile_lld", "ptile_lw")]
    ht = [torch.from_numpy(getattr(plan, x)).to(dev)
          for x in ("ptile_hwsrc", "ptile_hld", "ptile_hw")]
    flat = torch.from_numpy(plan.recv_src).to(dev)
    h = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (plan.k, plan.b, f)).astype(np.float32)).to(dev)
    recv = row_pack(h, flat)
    assert torch.equal(recv, row_pack_plain(h, flat))
    one = spmm_tiles_fused(lt, h, ht, recv, lcls, hcls, tb)
    two = spmm_tiles_fused(lt, h, ht, recv, lcls, hcls, tb)
    plain = spmm_tiles_fused_plain(lt, h, ht, row_pack_plain(h, flat),
                                   lcls, hcls, tb)
    torch.cuda.synchronize()
    assert torch.equal(_bits(one), _bits(two))
    assert torch.equal(_bits(one), _bits(plain)), (
        f"fused != plain, max diff {(one - plain).abs().max()}")
    row_nnz = np.diff(a.indptr)
    hub = int(np.argmax(row_nnz))
    p, r = int(plan.owner[hub]), int(plan.local_idx[hub])
    slots = (int((plan.ledge_dst[p, :plan.lnnz[p]] == r).sum())
             + int((plan.hedge_dst[p, :plan.hnnz[p]] == r).sum()))
    assert row_nnz[hub] > 100 and slots == row_nnz[hub]
    for q in range(plan.k):
        assert (plan.ptile_lw[q] != 0).sum() == plan.lnnz[q]
        assert (plan.ptile_hw[q] != 0).sum() == plan.hnnz[q]


def test_hp_dcsbm_training_on_cuda_ragged_equals_a2a(cuda_device):
    """Two GCN steps on the hp DCSBM plan on the card: the ring's losses
    and weights == a2a's bit for bit, and within rtol 1e-5 of the CPU's
    (the trainers' CPU/card tolerance)."""
    _, plan = _hp_dcsbm_plan()
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    runs = {}
    for dev, sched in ((cuda_device, "a2a"), (cuda_device, "ragged"),
                       ("cpu", "a2a")):
        tr = FullBatchTrainer(plan, fin=24, widths=[32, 5], seed=4,
                              comm_schedule=sched, device=dev)
        data = make_train_data(plan, feats, labels, device=dev)
        runs[(str(dev), sched)] = (
            [tr.step(data) for _ in range(2)],
            [p.detach().cpu() for p in tr.model.parameters()])
    a2a, ring, cpu = (runs[("cuda", "a2a")], runs[("cuda", "ragged")],
                      runs[("cpu", "a2a")])
    assert a2a[0] == ring[0]
    assert all(torch.equal(x, y) for x, y in zip(a2a[1], ring[1]))
    np.testing.assert_allclose(a2a[0], cpu[0], rtol=1e-5)


# --------------------------------------------- the stale-halo trainer
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("sched", ["a2a", "ragged"])
def test_stale_op_on_cuda_equals_cpu_bitwise(cuda_device, sched, delta):
    """``pspmm_tiles_stale`` (a2a) and ``pspmm_tiles_stale_ragged`` on the
    card — the pack and the fused launch on a given carry — equal the same
    ops on the CPU (their plain versions) bit for bit: forward, next
    carry, input gradient and next gradient carry, on a stale step (random
    carries) and a sync step; one fused launch in the backward, counted
    in ``PspmmTilesStale.backward_launches``."""
    plan = _er_plan()
    st = choose_tile_dispatch(plan, schedule=sched)
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    fields = (TILE_PLAN_FIELDS_RAGGED if sched == "ragged"
              else TILE_PLAN_FIELDS)
    pa = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in fields}
    rows = (sum(plan.rr_sizes) if sched == "ragged"
            else plan.k * plan.s)
    rng = np.random.default_rng(13)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    h, g = draw(plan.k, plan.b, 40), draw(plan.k, plan.b, 40)
    carry, gcarry = draw(plan.k, rows, 40), draw(plan.k, rows, 40)
    out = {}
    for fresh in (False, True):
        for dev in ("cpu", cuda_device):
            x = h.to(dev, copy=True).requires_grad_()
            t = {f: v.to(dev) for f, v in pa.items()}
            holder = [None]
            kw = dict(delta=delta, fresh=fresh, gholder=holder)
            before = PspmmTilesStale.backward_launches
            if sched == "ragged":
                y, nxt = pspmm_tiles_stale_ragged(
                    x, carry.to(dev), gcarry.to(dev),
                    *(t[f] for f in TILE_PLAN_FIELDS_RAGGED), *static,
                    st["rr_sizes"], **kw)
            else:
                y, nxt = pspmm_tiles_stale(
                    x, carry.to(dev), gcarry.to(dev),
                    *(t[f] for f in TILE_PLAN_FIELDS), *static, **kw)
            y.backward(g.to(dev))
            torch.cuda.synchronize()
            out[(str(dev), fresh)] = (
                y.detach().cpu(), nxt.cpu(), x.grad.cpu(), holder[0].cpu(),
                PspmmTilesStale.backward_launches - before)
        cpu, gpu = out[("cpu", fresh)], out[("cuda", fresh)]
        assert cpu[4] == 0 and gpu[4] == 1
        for i in range(4):
            assert torch.equal(gpu[i], cpu[i]), (i, fresh)


def test_stale_trainer_on_cuda_sync_every_1_is_exact_and_ring_is_a2a(
        cuda_device):
    """On the card: ``sync_every=1`` (delta on) trains bit for bit as the
    exact trainer on both transports, and the stale ragged trainer equals
    the stale a2a one (delta on, ``sync_every`` 3) over 1 + 5 steps; a
    stale step makes one pack and one fused launch per aggregation and
    direction, and no launch of K1's family entries."""
    plan = _er_plan()
    rng = np.random.default_rng(14)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    kw = dict(fin=24, widths=[32, 5], seed=6, device=cuda_device)
    runs = {}
    for name, extra in (
            ("exact a2a", {"comm_schedule": "a2a"}),
            ("exact ragged", {"comm_schedule": "ragged"}),
            ("sync1 a2a", {"comm_schedule": "a2a", "halo_staleness": 1,
                           "halo_delta": True, "sync_every": 1}),
            ("sync1 ragged", {"comm_schedule": "ragged", "halo_staleness": 1,
                              "halo_delta": True, "sync_every": 1}),
            ("stale a2a", {"comm_schedule": "a2a", "halo_staleness": 1,
                           "halo_delta": True, "sync_every": 3}),
            ("stale ragged", {"comm_schedule": "ragged",
                              "halo_staleness": 1, "halo_delta": True,
                              "sync_every": 3})):
        tr = FullBatchTrainer(plan, **kw, **extra)
        counts = (row_pack.launches, spmm_tiles_fused.launches,
                  spmm_tiles.launches)
        losses = [tr.step(data) for _ in range(6)]
        torch.cuda.synchronize()
        runs[name] = (losses, [p.detach().cpu() for p in tr.params],
                      (row_pack.launches - counts[0],
                       spmm_tiles_fused.launches - counts[1],
                       spmm_tiles.launches - counts[2]))
    for a, b in (("exact a2a", "sync1 a2a"), ("exact ragged", "sync1 ragged"),
                 ("stale a2a", "stale ragged")):
        assert runs[a][0] == runs[b][0], (a, b)
        assert all(torch.equal(x, y) for x, y in zip(runs[a][1],
                                                     runs[b][1])), (a, b)
    # 6 steps x (2 forward + 1 backward aggregations: layer 0 aggregates
    # first at fin 24, so its input needs no gradient)
    assert runs["stale a2a"][2] == (18, 18, 0)
    assert runs["stale a2a"][0] != runs["exact a2a"][0]


# --------------------------------------------------- hot-halo replicas
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind", ["f32", "f32->bf16", "bf16", "bf16->f32"])
@pytest.mark.parametrize("w", [1, 7, 41, 128])
def test_row_pack_into_equals_plain_bitwise(cuda_device, w, kind, aligned):
    """The destination-indexed pack on the card == its plain version
    (``index_copy_`` of the gathered rows, torch on the card) bit for
    bit — the rows it does not name untouched, ±inf, NaN (the bits
    torch's cast writes) and float32 → bf16 ties included — from a
    16-byte aligned source or one whose base is 4-byte (bf16: 2-byte) but
    not 16-byte aligned; one launch each, counted in
    ``row_pack_into.launches``; an empty list launches nothing."""
    src_dt, out_dt = {"f32": (torch.float32, torch.float32),
                      "f32->bf16": (torch.float32, torch.bfloat16),
                      "bf16": (torch.bfloat16, torch.bfloat16),
                      "bf16->f32": (torch.bfloat16, torch.float32)}[kind]
    dev = cuda_device
    rng = np.random.default_rng(w)
    src = _special(torch.from_numpy(rng.standard_normal(
        (4, 300, w)).astype(np.float32))).to(src_dt).to(dev)
    if not aligned:
        odd = torch.empty(src.numel() + 1, dtype=src_dt,
                          device=dev)[1:].view(src.shape)
        odd.copy_(src)
        src = odd
        assert src.data_ptr() % 16
    out0 = torch.from_numpy(rng.standard_normal((4, 250, w)).astype(
        np.float32)).to(out_dt).to(dev)
    n = 600
    flat = torch.from_numpy(rng.integers(0, 1200, n).astype(
        np.int32)).to(dev)
    dst = torch.from_numpy(rng.permutation(1000)[:n].astype(
        np.int32)).to(dev)
    want = row_pack_into_plain(out0.clone(), src, flat, dst)
    got = out0.clone()
    before = row_pack_into.launches
    row_pack_into(got, src, flat, dst)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    row_pack_into(got, src, empty, empty)
    torch.cuda.synchronize()
    assert row_pack_into.launches - before == 1
    assert torch.equal(_bits(got), _bits(want))
    untouched = torch.ones(1000, dtype=torch.bool, device=dev)
    untouched[dst.long()] = False
    assert torch.equal(_bits(got.view(-1, w)[untouched]),
                       _bits(out0.view(-1, w)[untouched]))


def test_row_pack_into_refuses_bad_inputs(cuda_device):
    """No CPU fallback on the card: a float64 source, int64 indices, a
    non-contiguous output or a width mismatch raise."""
    dev = cuda_device
    out = torch.zeros((2, 5, 4), device=dev)
    src = torch.zeros((2, 6, 4), device=dev)
    idx = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        row_pack_into(out, src.double(), idx, idx)
    with pytest.raises(TypeError):
        row_pack_into(out, src, idx.long(), idx)
    with pytest.raises(ValueError):
        row_pack_into(out.transpose(0, 1), src, idx, idx)
    with pytest.raises(ValueError):
        row_pack_into(out, src[..., :3].contiguous(), idx, idx)


def _replica_plan():
    plan = _er_plan()
    plan.ensure_ragged()
    plan.ensure_replicas(200)
    return plan


@pytest.mark.parametrize("sched,kind", [
    ("a2a", "replica"), ("a2a", "partial"), ("a2a", "stale"),
    ("ragged", "replica"), ("ragged", "stale")])
def test_replica_ops_on_cuda_equal_cpu_bitwise(cuda_device, sched, kind):
    """One replica step (``pspmm_tiles_replica``: the kept pack into the
    carry, the fused launch; its backward the same on the gradient
    carry), one partial refresh step (a2a) and one composed replica ×
    stale step (``pspmm_tiles_stale`` with the kept lists) on the card
    equal the same ops on the CPU bit for bit: output, next carries,
    input gradient, baselines; one pack and one fused launch per
    direction.  The partial refresh rides the a2a only, as in the
    reference."""
    plan = _replica_plan()
    st = choose_tile_dispatch(plan, schedule=sched)
    ragged = sched == "ragged"
    pre = "ring" if ragged else "recv"
    names = ["ptile_lsrc", "ptile_lld", "ptile_lw",
             "ptile_hrsrc" if ragged else "ptile_hwsrc", "ptile_hld",
             "ptile_hw", f"keep_{pre}_src", f"keep_{pre}_dst",
             "ring_src" if ragged else "recv_src", "rep_rows_flat",
             "rep_row_valid", "rep_base_flat", "rep_src_flat",
             "rep_recv_dst"]
    pa = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in names}
    rows = sum(plan.rr_sizes) if ragged else plan.k * plan.s
    rng = np.random.default_rng(21)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    h, g = draw(plan.k, plan.b, 40), draw(plan.k, plan.b, 40)
    carry, gcarry = draw(plan.k, rows, 40), draw(plan.k, rows, 40)
    base = draw(plan.k, plan.rs, 40)
    out = {}
    for dev in ("cpu", cuda_device):
        t = {f: v.to(dev) for f, v in pa.items()}
        x = h.to(dev, copy=True).requires_grad_()
        c, gc, holder = carry.to(dev, copy=True), gcarry.to(dev, copy=True), \
            [None]
        tiles = (*(t[f] for f in names[:6]), st["pallas_tb"],
                 st["pallas_lclasses"], st["pallas_hclasses"])
        keep = (t[names[6]], t[names[7]])
        before = (row_pack_into.launches, spmm_tiles_fused.launches)
        bnext = None
        if kind == "stale":
            y, nxt = (pspmm_tiles_stale_ragged if ragged
                      else pspmm_tiles_stale)(
                x, c, gc, t[names[8]], *tiles[:6], *tiles[6:],
                *((st["rr_sizes"],) if ragged else ()), gholder=holder,
                keep=keep)
        else:
            side = None
            if kind == "partial":
                side = {f: t[f] for f in names[9:13]}
                side["rep_dst"] = t["rep_recv_dst"]
            y, nxt, bnext, _ = pspmm_tiles_replica(
                x, c, gc, keep, tiles, kind, gholder=holder,
                base=base.to(dev) if side else None, side=side, band=1.0)
        y.backward(g.to(dev))
        torch.cuda.synchronize()
        out[str(dev)] = ([y.detach().cpu(), nxt.cpu(), x.grad.cpu(),
                          holder[0].cpu()]
                         + ([bnext.cpu()] if bnext is not None else []),
                         (row_pack_into.launches - before[0],
                          spmm_tiles_fused.launches - before[1]))
    (cpu, cpu_n), (gpu, gpu_n) = out["cpu"], out["cuda"]
    assert cpu_n == (0, 0) and gpu_n == (2, 2)
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        assert torch.equal(a, b), i


def test_replica_trainer_on_cuda_sync_1_is_exact_and_counts_launches(
        cuda_device):
    """On the card: a replica run at ``sync_every=1`` trains bit for bit
    as the exact trainer, the replica ring equals the replica a2a
    (``sync_every`` 3) and the composed ring the composed a2a; a replica
    step makes one destination-indexed pack and one fused launch per
    aggregation and direction, a refresh the exact exchange's pack."""
    plan = _er_plan()
    rng = np.random.default_rng(15)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    kw = dict(fin=24, widths=[32, 5], seed=6, device=cuda_device)
    runs = {}
    for name, extra in (
            ("exact a2a", {"comm_schedule": "a2a"}),
            ("sync1 a2a", {"comm_schedule": "a2a", "replica_budget": 200,
                           "sync_every": 1}),
            ("sync1 ragged", {"comm_schedule": "ragged",
                              "replica_budget": 200, "sync_every": 1}),
            ("rep a2a", {"comm_schedule": "a2a", "replica_budget": 200,
                         "sync_every": 3}),
            ("rep ragged", {"comm_schedule": "ragged", "replica_budget": 200,
                            "sync_every": 3}),
            ("comp a2a", {"comm_schedule": "a2a", "replica_budget": 200,
                          "sync_every": 3, "halo_staleness": 1}),
            ("comp ragged", {"comm_schedule": "ragged",
                             "replica_budget": 200, "sync_every": 3,
                             "halo_staleness": 1})):
        tr = FullBatchTrainer(plan, **kw, **extra)
        counts = (row_pack.launches, row_pack_into.launches,
                  spmm_tiles_fused.launches)
        losses = [tr.step(data) for _ in range(6)]
        torch.cuda.synchronize()
        runs[name] = (losses, [p.detach().cpu() for p in tr.params],
                      (row_pack.launches - counts[0],
                       row_pack_into.launches - counts[1],
                       spmm_tiles_fused.launches - counts[2]))
    for a, b in (("exact a2a", "sync1 a2a"), ("exact a2a", "sync1 ragged"),
                 ("rep a2a", "rep ragged"), ("comp a2a", "comp ragged")):
        assert runs[a][0] == runs[b][0], (a, b)
        assert all(torch.equal(x, y) for x, y in zip(runs[a][1],
                                                     runs[b][1])), (a, b)
    # 6 steps x 3 aggregations (2 forward, 1 backward: layer 0 aggregates
    # first at fin 24); steps 0 and 3 refresh, the other 4 are replica
    # steps
    assert runs["rep a2a"][2] == (2 * 3, 4 * 3, 6 * 3)
    assert runs["comp a2a"][2] == (2 * 3, 4 * 3, 6 * 3)
    assert runs["rep a2a"][0] != runs["exact a2a"][0]


# ------------------------------------------------ the mini-batch trainer
@functools.lru_cache(maxsize=None)
def _cora_minibatch_inputs():
    """cora2708 (Â normalized), its features and labels, the 8-part hp
    vector — the mini-batch tests' inputs (the fixture files)."""
    import os

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.partition import read_partvec

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    return (normalize_adjacency(a), feats, labels,
            read_partvec(os.path.join(fix, "cora2708.8.hp")))


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
@pytest.mark.parametrize("f", [16, 128])
def test_fused_entry_equals_plain_on_padded_batch_plan(cuda_device, sched, f):
    """On the padded batch plan with the longest pad chain (the shared
    envelope's weight-0 edges in each part's last tile): the exchange's
    pack and the fused local + remote entry == their plain versions bit
    for bit, on both transports (the ring at the shared round sizes)."""
    from sgcn_tpu_torch.ops.pspmm import ring_concat
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    ahat, feats, labels, pv = _cora_minibatch_inputs()
    tr = MiniBatchTrainer(ahat, pv, 8, fin=feats.shape[1], widths=[16, 7],
                          batch_size=512, comm_schedule=sched,
                          device=cuda_device)
    batches = tr.make_batches(feats, labels)
    pads = [int((p.el - p.lnnz).max()) for p in tr.plans]
    b = batches[int(np.argmax(pads))]
    st, pa = b.fwd_static, b.pa
    tb, lcls, hcls = st["pallas_tb"], st["pallas_lclasses"], \
        st["pallas_hclasses"]
    h = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (8, b.plan.b, f)).astype(np.float32)).to(cuda_device)
    lt = [pa[x] for x in ("ptile_lsrc", "ptile_lld", "ptile_lw")]
    if sched == "ragged":
        ht = [pa[x] for x in ("ptile_hrsrc", "ptile_hld", "ptile_hw")]
        remote = ring_concat(h, pa["ring_src"], st["rr_sizes"])
        assert st["rr_sizes"] == tr.plans[0].rr_sizes
        flat = pa["ring_src"]
    else:
        ht = [pa[x] for x in ("ptile_hwsrc", "ptile_hld", "ptile_hw")]
        flat = pa["recv_src"]
        remote = row_pack(h, flat)
    assert torch.equal(row_pack(h, flat), row_pack_plain(h, flat))
    one = spmm_tiles_fused(lt, h, ht, remote, lcls, hcls, tb)
    plain = spmm_tiles_fused_plain(lt, h, ht, remote, lcls, hcls, tb)
    torch.cuda.synchronize()
    assert max(pads) > 0
    assert torch.equal(_bits(one), _bits(plain)), (
        f"fused != plain, max diff {(one - plain).abs().max()}")


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_minibatch_epoch_on_cuda_ragged_equals_a2a(cuda_device, model):
    """One mini-batch epoch on cora 8-hp (18 batches of 512) on the card:
    the ring's losses and weights == a2a's bit for bit, within rtol 1e-5
    (GCN) / 5e-5 (GAT) of the CPU's; every batch step makes the launches
    of a full-batch step (GCN: one pack and one fused launch per
    aggregation, no K1 family launch; GAT: its K5 passes)."""
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    ahat, feats, labels, pv = _cora_minibatch_inputs()
    act = "relu" if model == "gcn" else "none"
    runs = {}
    for dev, sched in ((cuda_device, "a2a"), (cuda_device, "ragged"),
                       ("cpu", "a2a")):
        tr = MiniBatchTrainer(ahat, pv, 8, fin=feats.shape[1],
                              widths=[16, 7], batch_size=512, model=model,
                              activation=act, comm_schedule=sched, seed=2,
                              device=dev)
        counts = (row_pack.launches, spmm_tiles_fused.launches,
                  spmm_tiles.launches, spmm_tiles.mask_launches)
        rep = tr.fit(feats, labels, epochs=1, warmup=0, verbose=False)
        if str(dev) == "cuda":
            torch.cuda.synchronize()
        runs[(str(dev), sched)] = (
            rep["loss_history"], [p.detach().cpu()
                                  for p in tr.inner.model.parameters()],
            tuple(x - c for x, c in zip(
                (row_pack.launches, spmm_tiles_fused.launches,
                 spmm_tiles.launches, spmm_tiles.mask_launches), counts)),
            rep["nbatches"])
    a2a, ring, cpu = (runs[("cuda", "a2a")], runs[("cuda", "ragged")],
                      runs[("cpu", "a2a")])
    assert a2a[0] == ring[0]
    assert all(torch.equal(x, y) for x, y in zip(a2a[1], ring[1]))
    np.testing.assert_allclose(a2a[0], cpu[0],
                               rtol=1e-5 if model == "gcn" else 5e-5)
    nb = a2a[3]
    assert nb == 18
    # one full-batch step on the full plan, for its launches
    plan = build_comm_plan(ahat, pv, 8)
    full = FullBatchTrainer(plan, fin=feats.shape[1], widths=[16, 7],
                            model=model, activation=act, comm_schedule="a2a",
                            device=cuda_device)
    counts = (row_pack.launches, spmm_tiles_fused.launches,
              spmm_tiles.launches, spmm_tiles.mask_launches)
    full.step(make_train_data(plan, feats, labels, device=cuda_device))
    torch.cuda.synchronize()
    per_step = tuple(x - c for x, c in zip(
        (row_pack.launches, spmm_tiles_fused.launches, spmm_tiles.launches,
         spmm_tiles.mask_launches), counts))
    assert a2a[2] == tuple(nb * x for x in per_step)
    assert a2a[2][2] == 0                        # no K1 family launch
    assert (a2a[2][1] > 0) if model == "gcn" else (a2a[2][3] > 0)


@functools.lru_cache(maxsize=1)
def _hub_plan():
    """An ER graph (n = 3000, degree 8) with one hub row of 1200 extra
    neighbors, normalized, on 4 balanced random parts."""
    a = er_graph(3000, avg_deg=8, seed=5).tolil()
    nb = np.random.default_rng(5).choice(3000, 1200, replace=False)
    nb = nb[nb != 17]
    a[17, nb] = 1.0
    a[nb, 17] = 1.0
    return build_comm_plan(normalize_adjacency(a.tocsr()),
                           balanced_random_partition(3000, 4, seed=1), 4)


@pytest.mark.parametrize("f", [1, 16, 41, 128])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_subgraph_compact_launches_equal_plain(cuda_device, model, f):
    """A sub-graph batch holding the hub row and its 1200 slots: the
    compact fused entry (GCN, float32 and on the bf16 wire) and K5 (GAT)
    == their plain versions bit for bit, and two launches agree."""
    plan = _hub_plan()
    index = SubgraphIndex(plan, model)
    q = np.array([17, 5, 900, 2999])
    batch = build_batch(index, VertexRouter(plan), q, 2)
    assert batch.touched_rows > 1200
    fams = batch.to_device(cuda_device)["families"]
    rows = batch.gids.shape[1]
    x = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (plan.k, rows, f)).astype(np.float32)).to(cuda_device)
    if model == "gcn":
        for remote in (x, x.to(torch.bfloat16)):
            one = spmm_tiles_fused(fams[0], x, fams[1], remote,
                                   *batch.classes, batch.tb)
            two = spmm_tiles_fused(fams[0], x, fams[1], remote,
                                   *batch.classes, batch.tb)
            plain = spmm_tiles_fused_plain(fams[0], x, fams[1], remote,
                                           *batch.classes, batch.tb)
            torch.cuda.synchronize()
            assert torch.equal(_bits(one), _bits(two))
            assert torch.equal(_bits(one), _bits(plain)), (
                f"fused != plain, max diff {(one - plain).abs().max()}")
    else:
        before = spmm_tiles.mask_launches
        one = gat_mod.gat_tiles_pass(*fams[0], x, batch.classes[0],
                                     batch.tb, rows)
        two = gat_mod.gat_tiles_pass(*fams[0], x, batch.classes[0],
                                     batch.tb, rows)
        plain = spmm_tiles_classes_plain(*fams[0], x, batch.classes[0],
                                         batch.tb)[:, :rows]
        torch.cuda.synchronize()
        assert spmm_tiles.mask_launches == before + 2
        assert torch.equal(_bits(one), _bits(two))
        assert torch.equal(_bits(one), _bits(plain)), (
            f"K5 != plain, max diff {(one - plain).abs().max()}")


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_subgraph_engine_on_cuda_launches_and_rows(cuda_device, model):
    """The sub-graph engine on the card: per GCN batch one fused launch a
    layer and no pack, per GAT batch the K5 passes of its layers; rows
    within rtol 1e-5 / atol 1e-6 of the card's full engine (the
    projections run at another row count)."""
    plan = _hub_plan()
    feats = np.random.default_rng(2).standard_normal((3000, 24)).astype(
        np.float32)
    kw = dict(fin=24, widths=[32, 32, 5], model=model, max_batch=16,
              device="cuda", seed=3)
    full = ServeEngine(plan, **kw)
    full.set_features(feats)
    sub = ServeEngine(plan, mode="subgraph", params=[
        {n_: t.detach().cpu() for n_, t in p.items()} if isinstance(p, dict)
        else p.detach().cpu() for p in full.model.layer_params()], **kw)
    sub.set_features(feats)
    q = np.array([17, 3, 400, 1234, 2999])
    want = full.query(q)
    packs, fused, k5 = (row_pack.launches, spmm_tiles_fused.launches,
                        spmm_tiles.mask_launches)
    got = sub.query(q)
    torch.cuda.synchronize()
    assert row_pack.launches == packs
    if model == "gcn":
        assert spmm_tiles_fused.launches - fused == 3
    else:
        assert spmm_tiles.mask_launches - k5 == 3     # 3 fused-form layers
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------ remat and the memory join
@pytest.mark.parametrize("sched", ["a2a", "ragged"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_remat_on_cuda_equals_plain_bitwise(cuda_device, model, sched):
    """On the card: 3 steps with ``remat=True`` == 3 plain steps, losses
    and every parameter bit for bit; remat re-runs one forward's launches
    a step in the backward (GCN: a fused launch and a pack per layer; GAT:
    its K5 passes), the backward's own launches unchanged."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    plan = _er_plan()
    rng = np.random.default_rng(21)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    widths = [32, 32, 5]
    act = {} if model == "gcn" else {"activation": "none"}
    runs = {}
    for remat in (False, True):
        tr = FullBatchTrainer(plan, fin=24, widths=widths, seed=6,
                              model=model, comm_schedule=sched, remat=remat,
                              device=cuda_device, **act)
        before = (spmm_tiles_fused.launches, row_pack.launches,
                  spmm_tiles.mask_launches, GatLayerSym.backward_launches,
                  PspmmTilesSym.backward_launches
                  + PspmmTilesRagged.backward_launches)
        losses = [tr.step(data) for _ in range(3)]
        torch.cuda.synchronize()
        after = (spmm_tiles_fused.launches, row_pack.launches,
                 spmm_tiles.mask_launches, GatLayerSym.backward_launches,
                 PspmmTilesSym.backward_launches
                 + PspmmTilesRagged.backward_launches)
        runs[remat] = (losses, [p.detach().cpu() for p in
                                tr.model.parameters()],
                       [b - a for a, b in zip(before, after)])
    assert runs[False][0] == runs[True][0]
    assert all(torch.equal(x, y) for x, y in zip(runs[False][1],
                                                 runs[True][1]))
    plain, remat = runs[False][2], runs[True][2]
    if model == "gcn":
        extra = [3 * len(widths), 3 * len(widths), 0, 0, 0]
    else:
        passes = sum(1 if gat_table_form(w) == "fused" else 2
                     for w in widths)
        packs = (len(widths) if sched == "ragged" else
                 sum(4 if gat_table_form(w) == "split" else 2
                     for w in widths))
        extra = [0, 3 * packs, 3 * passes, 0, 0]
    assert [r - p for r, p in zip(remat, plain)] == extra


@pytest.mark.parametrize("remat", [False, True])
def test_memory_join_on_cuda(cuda_device, remat):
    """On the card: one measured step (``measure_step``) joined against the
    model (``publish_memory``): the reference's contract holds — peak ≤
    total × ``MEM_MODEL_TOL``, arguments ≤ modeled + 256 B, alias ≥
    params + Adam's moments — and the argument families equal the live
    tensors."""
    from sgcn_tpu_torch.obs.memory import ARGUMENT_FAMILIES

    plan = _er_plan()
    rng = np.random.default_rng(22)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, plan.n)
    torch.cuda.synchronize()
    tr = FullBatchTrainer(plan, fin=24, widths=[32, 5], seed=6,
                          remat=remat, device=cuda_device)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    tr.step(data)
    _loss, measured = tr.measure_step(data)
    join = tr.publish_memory(measured, data)
    assert join["ok"], join["violations"]
    assert measured["peak_bytes"] > measured["argument_bytes"] > 0
    assert measured["alias_bytes"] >= tr.memory.donated_floor_bytes
    live = tr.resident_bytes(data)
    for fam in ARGUMENT_FAMILIES:
        assert tr.memory.families.get(fam, 0) == live.get(fam, 0), fam


@pytest.mark.parametrize("mode", ["full", "subgraph"])
def test_serve_memory_join_on_cuda(cuda_device, mode):
    """On the card: the widest bucket's batch measured in ``warmup``
    joins the engine's model with no violation: it aliases 0 (a forward
    updates no weight in place) and its peak is under total × tol."""
    plan = _er_plan()
    feats = np.random.default_rng(23).standard_normal(
        (plan.n, 24)).astype(np.float32)
    torch.cuda.synchronize()
    eng = ServeEngine(plan, fin=24, widths=[32, 5], device=cuda_device,
                      max_batch=16, mode=mode)
    eng.set_features(feats)
    eng.warmup(np.arange(16))
    join = eng.memory_join
    assert join["ok"], join["violations"]
    assert join["block"]["donated"]["measured_bytes"] == 0
    assert join["block"]["total"]["measured_bytes"] > 0
    assert eng.gauges()["memory"]["measured"]


def test_minibatch_memory_join_on_cuda(cuda_device, tmp_path):
    """On the card: the mini-batch trainer's measured step (the first
    recorded step after Adam's state exists) joins the model of the whole
    batch set with no violation: the arguments (every batch plan's arrays
    and tiles, every batch's data, the weights and Adam's moments) within
    256 B of the model either way, the peak under 1.05 × its total (the
    band ``chip_smoke.py`` holds the card to)."""
    from sgcn_tpu_torch.obs import RunRecorder
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    n = 3000
    ahat = normalize_adjacency(er_graph(n, avg_deg=8, seed=1))
    pv = balanced_random_partition(n, 4, seed=1)
    rng = np.random.default_rng(24)
    feats = rng.standard_normal((n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    torch.cuda.synchronize()
    mb = MiniBatchTrainer(ahat, pv, 4, fin=24, widths=[32, 5],
                          batch_size=1024, device=cuda_device)
    with RunRecorder(str(tmp_path / "mb")) as rec:
        mb.attach_recorder(rec)
        mb.fit(feats, labels, epochs=1, warmup=1, verbose=False)
    join = mb.memory_join
    assert join["ok"], join["violations"]
    blk = join["block"]
    assert abs(blk["arguments"]["measured_bytes"]
               - blk["arguments"]["model_bytes"]) <= 256
    assert blk["total"]["measured_bytes"] <= \
        1.05 * blk["total"]["model_bytes"]
    assert blk["donated"]["measured_bytes"] >= mb.memory.donated_floor_bytes


# ------------------------------------------ the rank runtime and baseline
def _proxy_inputs(sched):
    """Part 2's slice of a 4-way ER plan (the ring built when asked) and
    its data."""
    from sgcn_tpu_torch.parallel import shard_proxy_data, shard_proxy_plan

    n = 3000
    ahat = normalize_adjacency(er_graph(n, avg_deg=8, seed=5))
    plan = build_comm_plan(ahat, balanced_random_partition(n, 4, seed=5), 4)
    if sched == "ragged":
        plan.ensure_pallas_tiles()
        plan.ensure_ragged()
        plan.ensure_pallas_ragged_tiles()
    rng = np.random.default_rng(26)
    feats = rng.standard_normal((n, 24)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    return (shard_proxy_plan(plan, 2),
            shard_proxy_data(plan, 2, feats, labels, device="cuda"))


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
@pytest.mark.parametrize("halo_dtype", [None, "bfloat16"])
def test_one_nccl_rank_equals_the_stacked_proxy(cuda_device, tmp_path,
                                                sched, halo_dtype):
    """On the card: one NCCL rank (a ``file://`` rendezvous, world size
    1) trains part 2's slice through the rank path — the send pack, the
    collective's loopback (on the ring, sends to self), the local and
    halo K1 family launches, the float32 add — and its 3 losses and final
    weights equal the stacked proxy's (the fused entry) bit for bit; two
    family launches and one pack per aggregation."""
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _proxy_inputs(sched)
    kw = dict(fin=24, widths=[32, 5], seed=3, comm_schedule=sched,
              halo_dtype=halo_dtype)
    stacked = FullBatchTrainer(sl, device=cuda_device, **kw)
    want = [stacked.step(data) for _ in range(3)]
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        before = (spmm_tiles.launches, spmm_tiles.bf16_launches,
                  row_pack.launches)
        tr = FullBatchTrainer(sl, mesh=mesh, **kw)
        got = [tr.step(data) for _ in range(3)]
        torch.cuda.synchronize()
        fam = (spmm_tiles.launches - before[0]
               + spmm_tiles.bf16_launches - before[1])
        packs = row_pack.launches - before[2]
    finally:
        mesh.close()
    assert got == want
    for a, b in zip(tr.params, stacked.params):
        assert torch.equal(a, b)
    # 2 forward + 1 backward aggregations a step (layer 0 aggregates its
    # input first, which needs no gradient)
    assert packs == 3 * 3 and fam == 2 * packs


def test_broadcast_kernel_equals_plain_on_cuda(cuda_device):
    """On the card: the broadcast baseline's local SpMM (one K1 family
    launch over the gathered table) equals its plain version bit for
    bit; fused == phase-split rows; the rows within rtol 1e-4 / atol
    1e-5 of the CPU run's."""
    from sgcn_tpu_torch.baselines.cagnet1d import BroadcastGCN1D

    n = 3000
    ahat = normalize_adjacency(er_graph(n, avg_deg=8, seed=6))
    pv = balanced_random_partition(n, 4, seed=6)
    feats = np.random.default_rng(27).standard_normal(
        (n, 24)).astype(np.float32)
    kw = dict(fin=24, widths=[32, 5], seed=2)
    bc = BroadcastGCN1D(ahat, pv, 4, device=cuda_device, **kw)
    h = torch.as_tensor(bc.plan.scatter_rows(feats)).to(cuda_device)
    table = bc.gather(h)
    assert table.shape == (4, 4 * bc.plan.b, 24)
    before = spmm_tiles.launches
    got = spmm_tiles_classes(bc.pa["tsrc"], bc.pa["tld"], bc.pa["tw"],
                             table, bc.classes, 256)
    want = spmm_tiles_classes_plain(bc.pa["tsrc"], bc.pa["tld"],
                                    bc.pa["tw"], table, bc.classes, 256)
    torch.cuda.synchronize()
    assert spmm_tiles.launches == before + 1
    assert torch.equal(got, want)
    rows = bc.forward(feats)
    fused = BroadcastGCN1D(ahat, pv, 4, device=cuda_device, fused=True,
                           **kw).forward(feats)
    assert np.array_equal(rows, fused)
    cpu = BroadcastGCN1D(ahat, pv, 4, device="cpu", **kw).forward(feats)
    np.testing.assert_allclose(rows, cpu, rtol=1e-4, atol=1e-5)


# ------------------------------- GAT, bf16 and remat on one NCCL rank
def _cora_slice(chip=2):
    """Cora2708's 8-hp plan, every layout the rank path reads built on
    the full plan, part ``chip``'s slice and its data on the card."""
    import os

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import shard_proxy_data, shard_proxy_plan
    from sgcn_tpu_torch.partition import read_partvec

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    plan.ensure_pallas_tiles()
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    plan.ensure_pallas_cell_tiles()
    plan.ensure_pallas_cell_ragged_tiles()
    return (shard_proxy_plan(plan, chip),
            shard_proxy_data(plan, chip, feats, labels, device="cuda"))


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_one_nccl_rank_gat_k5_equals_plain(cuda_device, tmp_path, sched,
                                           compute_dtype, monkeypatch):
    """On the card: GAT (1433 → 16 → 7, no activation) on one NCCL rank
    training cora's part-2 slice: every K5 launch of a step (forward and
    backward, every table form: fused, packed, fused bf16) equals its
    plain version on the same inputs bit for bit, and 3 losses and the
    final weights equal the stacked proxy's, with as many K5 launches."""
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _cora_slice()
    kw = dict(fin=1433, widths=[16, 7], seed=3, model="gat",
              activation="none", comm_schedule=sched,
              compute_dtype=compute_dtype)
    stacked = FullBatchTrainer(sl, device=cuda_device, **kw)
    k5 = ts.k5_launches()
    want = [stacked.step(data) for _ in range(3)]
    torch.cuda.synchronize()
    want_k5 = ts.k5_launches() - k5
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    calls = []
    family = ts.spmm_tiles_classes

    def recorded(*args):
        out = family(*args)
        if args[2].dtype == torch.int8:
            calls.append((args, out))
        return out

    try:
        tr = FullBatchTrainer(sl, mesh=mesh, **kw)
        got = [tr.step(data)]
        monkeypatch.setattr(ts, "spmm_tiles_classes", recorded)
        got.append(tr.step(data))
        monkeypatch.setattr(ts, "spmm_tiles_classes", family)
        k5 = ts.k5_launches()
        got.append(tr.step(data))
        torch.cuda.synchronize()
        got_k5 = ts.k5_launches() - k5
    finally:
        mesh.close()
    assert calls and got_k5 == len(calls) == want_k5 // 3
    for args, out in calls:
        assert torch.equal(out, spmm_tiles_classes_plain(*args))
    assert got == want
    for a, b in zip(tr.model.parameters(), stacked.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sched", ["a2a", "ragged"])
@pytest.mark.parametrize("lever", ["compute_dtype", "remat"])
def test_one_nccl_rank_bf16_and_remat_equal_the_stacked_proxy(
        cuda_device, tmp_path, sched, lever):
    """On the card: GCN under ``compute_dtype`` (K1's bf16 family entry,
    two launches an aggregation) and under ``remat`` (the checkpoint
    re-runs each layer's collective in the backward) on one NCCL rank:
    3 losses and the final weights equal the stacked proxy's bit for bit;
    two family launches per pack."""
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _proxy_inputs(sched)
    kw = dict(fin=24, widths=[32, 5], seed=3, comm_schedule=sched,
              **({"compute_dtype": "bfloat16"} if lever == "compute_dtype"
                 else {"remat": True}))
    stacked = FullBatchTrainer(sl, device=cuda_device, **kw)
    want = [stacked.step(data) for _ in range(3)]
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        before = (spmm_tiles.launches, spmm_tiles.bf16_launches,
                  row_pack.launches)
        tr = FullBatchTrainer(sl, mesh=mesh, **kw)
        got = [tr.step(data) for _ in range(3)]
        torch.cuda.synchronize()
        f32 = spmm_tiles.launches - before[0]
        bf16 = spmm_tiles.bf16_launches - before[1]
        packs = row_pack.launches - before[2]
    finally:
        mesh.close()
    assert got == want
    for a, b in zip(tr.params, stacked.params):
        assert torch.equal(a, b)
    fam = bf16 if lever == "compute_dtype" else f32
    assert (f32 if lever == "compute_dtype" else bf16) == 0
    assert packs > 0 and fam == 2 * packs


# ----------------------- the carried modes on one NCCL rank (A2c)
CARRIED_NCCL_CASES = {
    "stale-a2a": dict(halo_staleness=1),
    "stale-ring": dict(halo_staleness=1, comm_schedule="ragged"),
    "stale-delta": dict(halo_staleness=1, halo_delta=True),
    "stale-bf16": dict(halo_staleness=1, halo_dtype="bfloat16"),
    "replica-a2a": dict(replica_budget=64),
    "replica-bf16": dict(replica_budget=64, halo_dtype="bfloat16"),
    "replica-ring": dict(replica_budget=64, comm_schedule="ragged"),
    "replica-stale": dict(replica_budget=64, halo_staleness=1),
    "partial": dict(replica_budget=64, refresh_band=0.05),
}


def _carried_slice(chip=2):
    """Cora's 8-hp plan with the ring and 64 replicas built on the full
    plan, part ``chip``'s slice and its data on the card."""
    import os

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import shard_proxy_data, shard_proxy_plan
    from sgcn_tpu_torch.partition import read_partvec

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    plan.ensure_pallas_tiles()
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    plan.ensure_replicas(64)
    return (shard_proxy_plan(plan, chip),
            shard_proxy_data(plan, chip, feats, labels, device="cuda"))


@pytest.mark.parametrize("case", list(CARRIED_NCCL_CASES))
def test_one_nccl_rank_carried_mode_equals_the_stacked_proxy(
        cuda_device, tmp_path, case):
    """On the card: each carried mode on one NCCL rank (GCN 1433 → 16 →
    7, ``sync_every=2``) training cora's part-2 slice — its stale
    exchanges in flight until the next read, its shrunken exchange packed
    into the carry — gives the stacked proxy's 4 losses and final
    weights bit for bit."""
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _carried_slice()
    kw = dict(fin=1433, widths=[16, 7], seed=3, sync_every=2,
              **CARRIED_NCCL_CASES[case])
    kw.setdefault("comm_schedule", "a2a")
    stacked = FullBatchTrainer(sl, device=cuda_device, **kw)
    want = [stacked.step(data) for _ in range(4)]
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        tr = FullBatchTrainer(sl, mesh=mesh, **kw)
        got = [tr.step(data) for _ in range(4)]
        tr._settle_carries()
        torch.cuda.synchronize()
    finally:
        mesh.close()
    assert got == want
    for a, b in zip(tr.params, stacked.params):
        assert torch.equal(a, b)


def test_one_nccl_rank_fused_carry_and_pack_into_equal_plain(
        cuda_device, tmp_path, monkeypatch):
    """On the card, one NCCL rank: every fused launch of a stale step
    (forward over the carry of the step before, backward over the
    gradient carry) and every pack-into of a replica step (the shrunken
    receive into the carried layout, forward and backward) equals its
    plain version on the same inputs bit for bit, on a float32 and on a
    bf16 ``halo_dtype`` carry (the fused entry's ``_f32_bf16wire``
    form)."""
    from sgcn_tpu_torch.ops import pspmm as ps
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_into_plain
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _carried_slice()
    fused_fn, into_fn = ts.spmm_tiles_fused, ps.row_pack_into
    calls = []

    def fused_rec(*args):
        out = fused_fn(*args)
        calls.append(("fused", [a.clone() if torch.is_tensor(a) else a
                                for a in args], out))
        return out

    def into_rec(out, src, flat, dst):
        before = out.clone()
        res = into_fn(out, src, flat, dst)
        calls.append(("into", (before, src.clone(), flat, dst),
                      res.clone()))
        return res
    fused_rec.__dict__ = fused_fn.__dict__
    into_rec.__dict__ = into_fn.__dict__
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        for (kw, fn, name), wire in itertools.product(
                ((dict(halo_staleness=1), fused_rec, "fused"),
                 (dict(replica_budget=64), into_rec, "into")),
                (None, "bfloat16")):
            tr = FullBatchTrainer(sl, fin=1433, widths=[16, 7], seed=3,
                                  sync_every=2, comm_schedule="a2a",
                                  halo_dtype=wire, mesh=mesh, **kw)
            tr.step(data)                     # the sync step
            target = ts if name == "fused" else ps
            attr = "spmm_tiles_fused" if name == "fused" else "row_pack_into"
            monkeypatch.setattr(target, attr, fn)
            tr.step(data)                     # the carried step
            monkeypatch.setattr(target, attr,
                                fused_fn if name == "fused" else into_fn)
            tr._settle_carries()
        torch.cuda.synchronize()
    finally:
        mesh.close()
    kinds = [c[0] for c in calls]
    # 2 forward + 2 backward aggregations a step (layer 0 projects first)
    assert kinds.count("fused") == 8 and kinds.count("into") == 8
    assert sum(c[1][3].dtype == torch.bfloat16
               for c in calls if c[0] == "fused") == 4
    for kind, args, out in calls:
        plain = (ts.spmm_tiles_fused_plain(*args) if kind == "fused"
                 else row_pack_into_plain(*args))
        assert torch.equal(out, plain), kind


# ------------- directed plans and the mini-batch trainer on one NCCL rank
DIRECTED_NCCL_CASES = {"gcn": {}, "gcn-halo-bf16": {"halo_dtype": "bfloat16"},
                       "gcn-bf16": {"compute_dtype": "bfloat16"},
                       "gat": {"model": "gat", "activation": "none"}}


def _directed_slice(chip=2):
    """The directed cora2708 (each undirected edge kept in one direction
    by a seeded coin) under its 8-hp partition, both models' layouts
    built on the full plan, part ``chip``'s slice and its data on the
    card."""
    import os

    import scipy.sparse as sp

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import shard_proxy_data, shard_proxy_plan
    from sgcn_tpu_torch.partition import read_partvec

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    ad = sp.csr_matrix((np.ones(up.nnz, np.float32),
                        (np.where(flip, up.col, up.row),
                         np.where(flip, up.row, up.col))), shape=a.shape)
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    plan = build_comm_plan(normalize_adjacency(ad), pv, 8)
    for model in ("gcn", "gat"):
        resolve_forward_setup(plan, model=model)
    return (shard_proxy_plan(plan, chip),
            shard_proxy_data(plan, chip, feats, labels, device="cuda"))


@pytest.mark.parametrize("case", list(DIRECTED_NCCL_CASES))
def test_one_nccl_rank_directed_equals_the_stacked_proxy(cuda_device,
                                                         tmp_path, case):
    """On the card: a directed plan on one NCCL rank (1433 → 16 → 7,
    cora's part-2 slice; the backward's reverse exchange an
    ``all_to_all_single`` to itself) gives the stacked proxy's 3 losses
    and final weights bit for bit, with three K1 family launches and no
    pack or fused launch an aggregation's backward."""
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesGenRanks,
                                              fused_launches, k1_launches)
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _directed_slice()
    kw = dict(fin=1433, widths=[16, 7], seed=3, **DIRECTED_NCCL_CASES[case])
    stacked = FullBatchTrainer(sl, device=cuda_device, **kw)
    want = [stacked.step(data) for _ in range(3)]
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        before = (PspmmTilesGenRanks.backward_launches, fused_launches())
        tr = FullBatchTrainer(sl, mesh=mesh, **kw)
        got = [tr.step(data) for _ in range(3)]
        torch.cuda.synchronize()
        bwd = PspmmTilesGenRanks.backward_launches - before[0]
        fused = fused_launches() - before[1]
    finally:
        mesh.close()
    assert got == want
    for a, b in zip(tr.model.parameters(), stacked.model.parameters()):
        assert torch.equal(a, b)
    assert fused == 0
    # GCN: layer 0 projects first, so both layers' aggregations have a
    # backward; GAT's transposed passes count as K5 + K1 launches
    assert bwd == (3 * 2 * 3 if kw.get("model") != "gat" else 0)
    assert k1_launches() > 0


@pytest.mark.parametrize("lever", [None, "halo_dtype", "compute_dtype"])
def test_one_nccl_rank_transposed_families_equal_plain(cuda_device,
                                                        tmp_path, lever,
                                                        monkeypatch):
    """On the card, one NCCL rank on a directed slice: every family
    launch of a GCN step — the forward's local and halo families and the
    backward's halo-ᵀ, local-ᵀ and weight-1 families, the last over the
    buffer the reverse ``all_to_all_single`` delivered (bf16 under either
    lever) — equals its plain version on the same inputs bit for bit."""
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.parallel import init_rank_group

    sl, data = _directed_slice()
    family = ts.spmm_tiles_classes
    calls = []

    def recorded(*args):
        out = family(*args)
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], out))
        return out
    recorded.__dict__ = family.__dict__
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        tr = FullBatchTrainer(sl, fin=1433, widths=[16, 7], seed=3,
                              mesh=mesh, **({lever: "bfloat16"} if lever
                                            else {}))
        tr.step(data)
        monkeypatch.setattr(ts, "spmm_tiles_classes", recorded)
        tr.step(data)
        monkeypatch.setattr(ts, "spmm_tiles_classes", family)
        torch.cuda.synchronize()
    finally:
        mesh.close()
    # 2 forward aggregations (2 launches each) + 2 backward (3 each)
    assert len(calls) == 10
    assert any(args[3].dtype == torch.bfloat16 for args, _ in calls) == \
        (lever is not None)
    for args, out in calls:
        assert torch.equal(out, spmm_tiles_classes_plain(*args))


MINIBATCH_NCCL_CASES = {"gcn-a2a": ("gcn", "a2a"),
                        "gcn-ring": ("gcn", "ragged"),
                        "gat-a2a": ("gat", "a2a")}


@pytest.mark.parametrize("case", list(MINIBATCH_NCCL_CASES))
def test_one_nccl_rank_minibatch_equals_the_stacked_proxy(cuda_device,
                                                          tmp_path, case):
    """On the card: the mini-batch trainer on one NCCL rank training part
    2 of cora's batches (512 a batch, 3 batches) gives the shard proxy's
    batch losses (the same part's slices trained stacked) and final
    weights bit for bit."""
    import os

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import init_rank_group
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    model, sched = MINIBATCH_NCCL_CASES[case]
    kw = dict(fin=1433, widths=[16, 7], batch_size=512, nbatches=3, seed=3,
              model=model, comm_schedule=sched, part=2,
              activation="relu" if model == "gcn" else "none")
    out = []
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0)
    try:
        for group in (None, mesh):
            tr = MiniBatchTrainer(normalize_adjacency(a), pv, 8, mesh=group,
                                  device=cuda_device, **kw)
            batches = tr.make_batches(feats, labels)
            out.append(([tr.step(b) for b in batches],
                        [w.detach().clone()
                         for w in tr.inner.model.parameters()]))
        torch.cuda.synchronize()
    finally:
        mesh.close()
    assert out[0][0] == out[1][0] and np.isfinite(out[0][0]).all()
    for a_, b_ in zip(out[0][1], out[1][1]):
        assert torch.equal(a_, b_)


def test_init_distributed_without_env_is_a_noop_on_card(cuda_device,
                                                        monkeypatch):
    """On the card, with no launcher in the environment:
    ``init_distributed()`` opens no group, names ``cuda:0`` and one
    process; ``global_mesh_1d(8)`` is the stacked layout (``None``)."""
    import torch.distributed as dist

    from sgcn_tpu_torch.parallel import launch

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NPROCS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    ctx = launch.init_distributed()
    assert (ctx.num_processes, ctx.process_id, ctx.group) == (1, 0, None)
    assert ctx.device == torch.device("cuda:0") and ctx.is_coordinator
    assert launch.global_mesh_1d(8, ctx) is None
    assert not dist.is_initialized()


# ------------------------------------------------ the ELL aggregator
def _ell_static(plan, layout):
    plan.ensure_ell_chains(layout)
    chains = plan.ell_chains[layout]
    static = {"ell_layout": layout, "ell_buckets": plan.ell_buckets,
              "rr_sizes": plan.rr_sizes,
              "ell_levels": {k[: -len("_levels")]: v
                             for k, v in chains.items()
                             if k.endswith("_levels")}}
    pa = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in chains.items() if isinstance(v, np.ndarray)}
    return pa, static


@pytest.mark.parametrize("halo_dtype", [None, "bfloat16"])
def test_ell_ring_equals_a2a_and_the_cpu_on_card(cuda_device, halo_dtype):
    """One ELL aggregation and its gradient on the card (``PspmmEllSym``,
    ``PspmmRaggedSym``; ``PspmmOverlap`` on a directed plan): the ring ==
    the a2a bit for bit, each == the same ops on CPU tensors bit for bit
    (every sum a serial chain of single float32 adds, no two updates of a
    level on one row), one pack an exchange and no tile launch."""
    from sgcn_tpu_torch.ops.pspmm import ell_aggregate

    for plan, layouts in ((_er_plan(), ("a2a", "ragged")),
                          (_directed_plan(), ("directed",))):
        rng = np.random.default_rng(5)
        h = rng.standard_normal((plan.k, plan.b, 24)).astype(np.float32)
        g = rng.standard_normal((plan.k, plan.b, 24)).astype(np.float32)
        res = []
        for layout in layouts:
            pa, static = _ell_static(plan, layout)
            for dev in (cuda_device, torch.device("cpu")):
                x = torch.tensor(h, device=dev, requires_grad=True)
                k1, fused, packs = (spmm_tiles.launches,
                                    spmm_tiles_fused.launches,
                                    row_pack.launches)
                out = ell_aggregate(x, {k: v.to(dev) for k, v in pa.items()},
                                    static, halo_dtype)
                out.backward(torch.tensor(g, device=dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    assert (spmm_tiles.launches, spmm_tiles_fused.launches,
                            row_pack.launches) == (k1, fused, packs + 2)
                res.append((out.detach().cpu(), x.grad.cpu()))
        for out, grad in res[1:]:
            assert torch.equal(out, res[0][0])
            assert torch.equal(grad, res[0][1])


@pytest.mark.parametrize("case", ["a2a", "ragged", "directed"])
def test_ell_trainer_on_card_is_deterministic(cuda_device, case,
                                              monkeypatch):
    """Three steps of the GCN trainer under ``SGCN_PALLAS_SPMM=0`` on the
    card, twice: losses and weights bit for bit, the ring's == the a2a's,
    no K1 or fused launch, and one pack an exchange (the forward's, and
    the backward's where the aggregation's input needs a gradient)."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    plan = _directed_plan() if case == "directed" else _er_plan()
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((plan.n, 24)).astype(np.float32)
    labels = rng.integers(0, 8, plan.n)
    data = make_train_data(plan, feats, labels, device=cuda_device)
    widths = [16, 8]
    runs = []
    scheds = {"a2a": ("a2a", "a2a"), "ragged": ("ragged", "ragged", "a2a"),
              "directed": ("a2a", "a2a")}[case]
    for sched in scheds:
        tr = FullBatchTrainer(plan, fin=24, widths=widths, seed=1,
                              comm_schedule=sched, device=cuda_device)
        assert tr.setup.aggregator == "ell"
        k1, fused, packs = (spmm_tiles.launches, spmm_tiles_fused.launches,
                            row_pack.launches)
        losses = [tr.step(data) for _ in range(3)]
        torch.cuda.synchronize()
        # fin < 256: layer 0 aggregates the data, whose gradient nobody
        # needs, so its backward sends nothing
        want = 3 * (len(widths) + len(widths) - 1)
        assert (spmm_tiles.launches - k1, spmm_tiles_fused.launches - fused,
                row_pack.launches - packs) == (0, 0, want)
        runs.append((losses, [w.detach().clone() for w in tr.params]))
    for losses, params in runs[1:]:
        assert losses == runs[0][0] and np.isfinite(losses).all()
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))
