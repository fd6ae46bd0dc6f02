"""The port's exchange, aggregation and GCN forward against the reference
run per chip under ``shard_map`` on the 8 virtual CPU devices
(``tests/conftest.py``), on cora2708 under its 8-part hp partition.

The reference side runs its kernel path with the exact jnp emulation of
the tile kernel (``emulate=True``, what it runs off-TPU).  Tolerances:
the exchange is a pure copy (exact); one aggregation layer
``rtol=1e-5, atol=1e-6``; the 2-layer forward ``rtol=1e-4, atol=1e-5``
(the dense 1433-wide projection sums in another order in XLA and torch).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sgcn_tpu.models.gcn import exchange_widths as ref_exchange_widths
from sgcn_tpu.models.gcn import gcn_forward_local as ref_gcn_forward
from sgcn_tpu.models.gcn import init_gcn_params as ref_init
from sgcn_tpu.ops.pallas_spmm import PALLAS_PLAN_FIELDS, pspmm_pallas_sym
from sgcn_tpu.ops.pspmm import halo_exchange as ref_halo_exchange
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import (GCN, exchange_widths, gcn_forward_local,
                                   init_gcn_params, params_from_jax)
from sgcn_tpu_torch.models.activations import get_activation
from sgcn_tpu_torch.ops import halo_exchange, pspmm_tiles_sym
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def cora():
    a, feats, _ = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    plan.ensure_pallas_tiles(256)
    return {"plan": plan, "feats": feats, "mesh": make_mesh_1d(8)}


def _smap(mesh, fn, nargs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("v"),) * nargs,
                                 out_specs=P("v")))


def _pa_torch(plan):
    return {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
            for f in PALLAS_PLAN_FIELDS}


def _classes(plan):
    return (tuple((t, e, "vmem") for t, e in plan.pallas_lclasses),
            tuple((t, e, "vmem") for t, e in plan.pallas_hclasses))


def test_halo_exchange_matches_shard_map(cora):
    plan = cora["plan"]
    h = np.random.default_rng(0).standard_normal(
        (plan.k, plan.b, 5)).astype(np.float32)

    def per_chip(h, si, hs):
        return ref_halo_exchange(h[0], si[0], hs[0], "v")[None]

    want = np.asarray(_smap(cora["mesh"], per_chip, 3)(
        h, plan.send_idx, plan.halo_src))
    got = halo_exchange(torch.from_numpy(h), torch.from_numpy(plan.send_idx),
                        torch.from_numpy(plan.halo_src)).numpy()
    assert got.shape == (plan.k, plan.r, 5)
    for p in range(plan.k):
        hc = int(plan.halo_counts[p])
        assert hc > 0
        np.testing.assert_array_equal(got[p, :hc], want[p, :hc])


def test_one_layer_pspmm_tiles_matches_pallas_sym(cora):
    plan = cora["plan"]
    lcls, hcls = _classes(plan)
    h = np.random.default_rng(1).standard_normal(
        (plan.k, plan.b, 16)).astype(np.float32)
    args = [h] + [getattr(plan, f) for f in PALLAS_PLAN_FIELDS]

    def per_chip(*a):
        return pspmm_pallas_sym(*(x[0] for x in a), 256, lcls, hcls,
                                True, "v")[None]

    want = np.asarray(_smap(cora["mesh"], per_chip, len(args))(*args))
    pa = _pa_torch(plan)
    got = pspmm_tiles_sym(torch.from_numpy(h),
                          *(pa[f] for f in PALLAS_PLAN_FIELDS),
                          256, lcls, hcls).numpy()
    diff = float(np.abs(got - want).max())
    print(f"one layer: max |port - reference| = {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_layer_forward_matches_reference(cora):
    """Project-first layer (1433 → 16) then aggregate-first (16 → 7),
    weights from the reference's own init carried by ``params_from_jax``."""
    plan, feats = cora["plan"], cora["feats"]
    lcls, hcls = _classes(plan)
    dims = [(feats.shape[1], 16), (16, 7)]
    assert exchange_widths(feats.shape[1], [16, 7]) == [16, 16]
    params = [np.asarray(w) for w in ref_init(jax.random.PRNGKey(3), dims)]
    h0 = plan.scatter_rows(feats)
    pa = {f: getattr(plan, f) for f in PALLAS_PLAN_FIELDS}

    def per_chip(params, h0, pa):
        pa = jax.tree.map(lambda x: x[0], pa)
        return ref_gcn_forward(params, h0[0], pa, symmetric=True,
                               pallas_tb=256, pallas_emulate=True,
                               pallas_lclasses=lcls,
                               pallas_hclasses=hcls)[None]

    fn = jax.jit(jax.shard_map(per_chip, mesh=cora["mesh"],
                               in_specs=(P(), P("v"), P("v")),
                               out_specs=P("v")))
    want = np.asarray(fn([jnp.asarray(w) for w in params], h0, pa))
    static = {"pallas_tb": 256, "pallas_lclasses": lcls,
              "pallas_hclasses": hcls}
    got = gcn_forward_local(params_from_jax(params), torch.from_numpy(h0),
                            _pa_torch(plan), **static).numpy()
    diff = float(np.abs(got - want).max())
    print(f"2-layer forward: max |port - reference| = {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the module form is the same function
    mod = GCN(params_from_jax(params), fwd_static=static)
    with torch.inference_mode():
        assert torch.equal(mod(torch.from_numpy(h0), _pa_torch(plan)),
                           torch.from_numpy(got))


@pytest.mark.parametrize("fin,widths", [
    (1433, [16, 7]), (128, [128, 128, 40]), (300, [400, 8]), (8, [3])])
def test_exchange_widths_equal(fin, widths):
    assert exchange_widths(fin, widths) == ref_exchange_widths(fin, widths)


@pytest.mark.parametrize("name", ["relu", "sigmoid", "elu", "none"])
def test_activations_match_jax(name):
    from sgcn_tpu.models.activations import get_activation as ref_act

    x = np.random.default_rng(2).standard_normal(64).astype(np.float32) * 4
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_act(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown activation"):
        get_activation("gelu")


def test_port_init_is_glorot_and_seeded():
    dims = [(1433, 16), (16, 7)]
    a = init_gcn_params(torch.Generator().manual_seed(5), dims)
    b = init_gcn_params(torch.Generator().manual_seed(5), dims)
    for w, w2, (fin, fout) in zip(a, b, dims):
        assert w.shape == (fin, fout) and w.dtype == torch.float32
        assert torch.equal(w, w2)
        assert float(w.abs().max()) <= (6.0 / (fin + fout)) ** 0.5
