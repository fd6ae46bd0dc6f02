"""Tests of the port that need the card: the CUDA tile SpMM kernel against
its plain PyTorch version, its backward (``PspmmTilesSym``), the serve
engine and a training step on ``cuda``.

This module imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

On a machine without CUDA every test skips (the kernel has no CPU mode);
whether there is a card is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from sgcn_tpu_torch.io.datasets import er_graph
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS, PspmmTilesSym,
                                          choose_tile_dispatch,
                                          pspmm_tiles_sym, spmm_tiles,
                                          spmm_tiles_classes,
                                          spmm_tiles_plain)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data


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
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in _tiles(1, 2, 8, 8, 10, seed=0)]
    table = torch.zeros(1, 10, 4, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        spmm_tiles(*arrays, table.bfloat16(), 8)
    with pytest.raises(ValueError, match="row-major"):
        spmm_tiles(*arrays, table.transpose(1, 2).contiguous()
                   .transpose(1, 2), 8)
    with pytest.raises(ValueError, match="tile height"):
        spmm_tiles(*arrays, table, 512)


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
    nclasses = len(gpu.setup.fwd_static["pallas_lclasses"])
    spmm_tiles.launches = 0
    q = np.arange(0, 3000, 397)
    got = gpu.query(q)
    assert spmm_tiles.launches == 1 * 2 * 2 * nclasses
    np.testing.assert_allclose(got, cpu.query(q), rtol=1e-5, atol=1e-6)


def _er_plan(n=3000, k=4, seed=1):
    a = normalize_adjacency(er_graph(n, avg_deg=10, seed=seed))
    return build_comm_plan(a, balanced_random_partition(n, k, seed=seed), k)


def test_backward_on_cuda_bitwise_equals_cpu(cuda_device):
    """The aggregation's backward launches the kernel on the gradient
    (one launch per local and per halo class) and equals the same
    Function on CPU tensors bit for bit — also for a strided gradient,
    which the backward makes row-major before the launch."""
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
        assert n_cpu == 0 and n_gpu == len(static[1]) + len(static[2])
        assert torch.equal(cpu, gpu), (
            f"backward cuda != cpu, max diff {(cpu - gpu).abs().max()}")


def test_trainer_step_on_cuda_matches_cpu(cuda_device):
    """One ``FullBatchTrainer.step`` on the card vs on the CPU from the
    same weights: loss rtol 1e-5, weight gradients rtol 1e-4 / atol 1e-7
    (the dense products sum in other orders on the card).  The card step
    launches the kernel for 2 forward passes and 1 backward pass (layer 0
    aggregates first: its input needs no gradient), per local and halo
    class."""
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
        spmm_tiles.launches = 0
        loss = tr.step(data)
        got[str(dev)] = (loss, grads[0], spmm_tiles.launches,
                         tr.model.fwd_static)
    (loss_c, g_c, n_c, _), (loss_g, g_g, n_g, st) = got["cpu"], got["cuda"]
    classes = len(st["pallas_lclasses"]) + len(st["pallas_hclasses"])
    assert n_c == 0 and n_g == (2 + 1) * classes
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_g, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)
