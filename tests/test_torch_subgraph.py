"""Sub-graph serving of the port (``sgcn_tpu_torch/serve/subgraph.py``, the
engine's ``mode='subgraph'`` and the serve CLI's ``--serve-mode``,
``--concurrent`` and ``--shed-factor``) against the reference
``sgcn_tpu.serve``, on cora2708 with its 8 hp parts.

  * the integers equal the reference's: ``halo_global_rows`` (cora and a
    planted-partition plan), the real-edge adjacency, receptive sets,
    ``edges_in`` and each batch's ``touched_rows`` / ``recipe_edges`` /
    ``per_chip_rows``;
  * the compact aggregation equals the full layer's rows bit for bit (the
    plain versions of the fused entry and K5): GCN on float32 and on the
    bf16 wire, GAT's fused and split table forms, both transports;
  * routed logits against the port's full engine within the contract the
    README states (``CONTRACT``: the dense projections run at another row
    count, and this CPU's GEMM gives some rows other last bits there), and
    within ``tests/test_torch_serve.py``'s cross-package tolerance of the
    reference's ``ServeEngine(mode='subgraph')``;
  * GAT's stabilizers against the reference's, refreshed by a weight swap;
    concurrent dispatch == sequential; ``shed_factor`` reaches the
    batcher; the CLI on the CPU and the reference's refusals.
"""

import json
import os

import jax
import numpy as np
import pytest
import scipy.io
import torch

from sgcn_tpu.models.gat import init_gat_params as ref_init_gat
from sgcn_tpu.models.gcn import init_gcn_params as ref_init_gcn
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.partition import balanced_random_partition
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.serve import MicroBatcher as RefBatcher
from sgcn_tpu.serve import ServeEngine as RefEngine
from sgcn_tpu.serve import VertexRouter as RefRouter
from sgcn_tpu.serve.subgraph import SubgraphIndex as RefIndex
from sgcn_tpu.serve.subgraph import build_batch as ref_build_batch
from sgcn_tpu_torch.io.datasets import load_npz_dataset, planted_partition
from sgcn_tpu_torch.models.gat import _gat_tiles_aggregate
from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_ragged,
                                          pspmm_tiles_sym, spmm_tiles_fused)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import (ServeEngine, SubgraphIndex, VertexRouter,
                                  build_batch, pad_pow2, run_loadgen)
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.serve.subgraph import compact_gat_aggregate
from sgcn_tpu_torch.train import FullBatchTrainer
from sgcn_tpu_torch.train.fullbatch import resolve_forward_setup
from sgcn_tpu_torch.utils.checkpoint import save_checkpoint

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
# the routed-logit contract against the port's full engine (README,
# PERF.md): the aggregation is ==, a dense projection at another row count
# may end in other last bits (measured here: 2.98e-8 GCN, 5.96e-8 GAT; on
# an H100 1.2e-7), and on the bf16 wire such a bit can move a row's bf16
# rounding by one bf16 step (1.0e-5 on an H100)
CONTRACT = {None: dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=1e-3, atol=1e-4)}
CROSS = dict(rtol=1e-4, atol=1e-5)       # tests/test_torch_serve.py


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "pv": pv, "feats": np.asarray(feats, np.float32),
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8)}


@pytest.fixture(scope="module")
def planted():
    a, _, _ = planted_partition(n=300, nclasses=6, p_in=0.08, p_out=0.01,
                                seed=3)
    pv = balanced_random_partition(300, 4, seed=2)
    return {"plan": build_comm_plan(normalize_adjacency(a), pv, 4),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 4)}


def _params(model, seed=1, fin=1433):
    dims = list(zip([fin] + WIDTHS[:-1], WIDTHS))
    init = ref_init_gat if model == "gat" else ref_init_gcn
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), dims))


def _engine(cora, model, mode, params, **kw):
    eng = ServeEngine(cora["plan"], fin=cora["feats"].shape[1],
                      widths=WIDTHS, model=model, params=params,
                      max_batch=32, device="cpu", mode=mode, **kw)
    eng.set_features(cora["feats"])
    return eng


# ------------------------------------------------------------- integers
@pytest.mark.parametrize("which", ["cora", "planted"])
def test_halo_global_rows_match_reference(request, which):
    d = request.getfixturevalue(which)
    got, want = d["plan"].halo_global_rows(), d["ref_plan"].halo_global_rows()
    np.testing.assert_array_equal(got, want)
    real = got >= 0
    assert real.sum() == d["plan"].halo_counts.sum()
    # a halo rank holds a row another part owns
    owner = d["plan"].owner[np.where(real, got, 0)]
    parts = np.arange(d["plan"].k)[:, None]
    assert (owner[real] != np.broadcast_to(parts, got.shape)[real]).all()


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_index_and_batches_match_reference(cora, model):
    plan, ref_plan = cora["plan"], cora["ref_plan"]
    index, ref = SubgraphIndex(plan, model), RefIndex(ref_plan, model)
    np.testing.assert_array_equal(index.adj[0], ref.adj[0])
    for g in (0, 5, 1000, 2707):           # each row's neighbors, as a set
        lo, hi = index.adj[0][g], index.adj[0][g + 1]
        np.testing.assert_array_equal(np.sort(index.adj[1][lo:hi]),
                                      np.sort(ref.adj[1][lo:hi]))
    rng = np.random.default_rng(0)
    router, ref_router = VertexRouter(plan), RefRouter(ref_plan)
    for nq, hops in ((1, 1), (7, 2), (32, 2), (100, 3)):
        q = rng.permutation(plan.n)[:nq]
        u = index.receptive(q, hops)
        np.testing.assert_array_equal(u, ref.receptive(q, hops))
        assert index.edges_in(u) == ref.edges_in(u)
        got = build_batch(index, router, q, hops)
        want = ref_build_batch(ref, ref_router, cora["feats"], q, hops)
        assert (got.touched_rows, got.recipe_edges, got.per_chip_rows,
                got.nq) == (want.touched_rows, want.recipe_edges,
                            want.per_chip_rows, want.nq)
        assert got.key[1] == pad_pow2(nq, 1) == want.key[1]
        # every query sits at its own compact row of its owner's part
        np.testing.assert_array_equal(
            got.gids[got.q_owner[:nq], got.q_pos[:nq]], q)
        assert (got.gids[:, -1] == -1).all()          # the dump row


def test_gcn_recipes_keep_the_plans_stored_order(cora):
    """A row's local recipe is its ``ledge_*`` real slots in stored order,
    sources through ``global_row_ids``."""
    plan = cora["plan"]
    index = SubgraphIndex(plan, "gcn")
    glob = plan.global_row_ids()
    for g in (3, 77, 2500):
        c, i = plan.owner[g], plan.local_idx[g]
        sel = (plan.ledge_dst[c] == i) & (plan.ledge_w[c] != 0)
        ptr, src, w = index.recipes[0]
        np.testing.assert_array_equal(src[ptr[g]:ptr[g + 1]],
                                      glob[c][plan.ledge_src[c][sel]])
        np.testing.assert_array_equal(w[ptr[g]:ptr[g + 1]],
                                      plan.ledge_w[c][sel])


# -------------------------------------------------- compact aggregation
def _compact_rows(plan, x, gids):
    """``x``'s ``(k, B, f)`` rows gathered to the compact ``(k, rows, f)``
    layout (zeros on pad rows and the dump row)."""
    flat = x.reshape(-1, x.shape[-1])
    idx = plan.owner[np.maximum(gids, 0)] * plan.b \
        + plan.local_idx[np.maximum(gids, 0)]
    out = flat[torch.as_tensor(idx)]
    return torch.where(torch.as_tensor(gids >= 0)[..., None], out, 0.0)


def _complete(index, batch):
    """Per compact row: is it real and are all its sources in its part's
    set (so its compact chain is the full one)?"""
    ptr, src = index.adj
    out = np.zeros(batch.gids.shape, bool)
    for c, row in enumerate(batch.gids):
        u = np.sort(row[row >= 0])
        for j, g in enumerate(row):
            if g >= 0:
                nb = src[ptr[g]:ptr[g + 1]]
                out[c, j] = np.isin(nb, u).all()
    return out


@pytest.mark.parametrize("case", [
    "gcn-a2a", "gcn-ragged", "gcn-bf16wire-a2a", "gcn-bf16wire-ragged",
    "gat-fused-a2a", "gat-fused-ragged", "gat-split-a2a", "gat-split-ragged"])
def test_compact_aggregation_bit_identical(cora, case):
    model, *flavor, sched = case.split("-")
    plan = cora["plan"]
    setup = resolve_forward_setup(plan, model=model, comm_schedule=sched)
    st, pa = setup.fwd_static, setup.ship_arrays(plan, "cpu")
    index = SubgraphIndex(plan, model)
    rng = np.random.default_rng(4)
    q = rng.permutation(plan.n)[:128]
    batch = build_batch(index, VertexRouter(plan), q, 2)
    dev = batch.to_device("cpu")
    done = _complete(index, batch)
    f = 9
    x = torch.as_tensor(rng.standard_normal((plan.k, plan.b, f)).astype(
        np.float32)) * torch.as_tensor(plan.row_valid)[..., None]
    xc = _compact_rows(plan, x, batch.gids)
    if model == "gcn":
        halo = "bfloat16" if flavor else None
        if sched == "ragged":
            full = pspmm_tiles_ragged(
                x, pa["ring_src"], pa["ptile_lsrc"], pa["ptile_lld"],
                pa["ptile_lw"], pa["ptile_hrsrc"], pa["ptile_hld"],
                pa["ptile_hw"], st["pallas_tb"], st["pallas_lclasses"],
                st["pallas_hclasses"], st["rr_sizes"], halo)
        else:
            full = pspmm_tiles_sym(
                x, pa["recv_src"], pa["ptile_lsrc"], pa["ptile_lld"],
                pa["ptile_lw"], pa["ptile_hwsrc"], pa["ptile_hld"],
                pa["ptile_hw"], st["pallas_tb"], st["pallas_lclasses"],
                st["pallas_hclasses"], halo)
        remote = xc.to(torch.bfloat16) if halo else xc
        got = spmm_tiles_fused(dev["families"][0], xc, dev["families"][1],
                               remote, *batch.classes, batch.tb)
    else:
        form = flavor[0]
        s = torch.rand((plan.k, plan.b), generator=torch.Generator()
                       .manual_seed(5)) * torch.as_tensor(plan.row_valid)
        ragged = sched == "ragged"
        ex = ((pa["ring_src"], None, pa["ptile_crsrc"]) if ragged
              else (pa["recv_src"], pa["halo_src_flat"], pa["ptile_csrc"]))
        num, den = _gat_tiles_aggregate(
            x, s, form, *ex, pa["ptile_cld"], pa["ptile_cw"],
            st["pallas_tb"], st["pallas_cclasses"],
            st["rr_sizes"] if ragged else None)
        full = torch.cat([num, den[..., None]], dim=-1)
        sc = _compact_rows(plan, s[..., None], batch.gids)[..., 0]
        cn, cd = compact_gat_aggregate(xc, sc, form, dev["families"][0],
                                       batch.classes[0], batch.tb)
        got = torch.cat([cn, cd[..., None]], dim=-1)
    want = _compact_rows(plan, full, batch.gids)
    mask = torch.as_tensor(done)
    assert mask.sum() > 300                       # rows under test
    assert torch.equal(got[mask], want[mask]), case
    # the queries' own rows and their neighbors' are complete at two hops
    assert done[batch.q_owner[:128], batch.q_pos[:128]].all()


# ------------------------------------------------------ routed logits
@pytest.mark.parametrize("model,sched,halo", [
    ("gcn", "a2a", None), ("gcn", "ragged", None), ("gcn", "a2a", "bfloat16"),
    ("gat", "a2a", None), ("gat", "ragged", None)])
def test_routed_logits_vs_full_engine(cora, model, sched, halo):
    params = _params(model)
    kw = dict(comm_schedule=sched, halo_dtype=halo)
    full = _engine(cora, model, "full", params, **kw)
    sub = _engine(cora, model, "subgraph", params, **kw)
    rng = np.random.default_rng(0)
    gap = 0.0
    for nq in (1, 5, 17, 32):
        q = rng.permutation(cora["plan"].n)[:nq]
        got, want = sub.query(q), full.query(q)
        assert got.shape == (nq, 7) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **CONTRACT[halo])
        gap = max(gap, float(np.abs(got - want).max()))
    print(f"{model}/{sched}/{halo}: max |subgraph - full| {gap:.3g}")
    g = sub.gauges()
    assert g["serve_mode"] == "subgraph" and g["compiles"] == 0
    assert g["subgraph_queries_total"] == 55
    # GAT's one full forward: the stabilizers at set_features
    assert g["subgraph_batches_total"] == 4
    assert g["forwards"] == (1 if model == "gat" else 0)
    assert 0 < g["touched_rows_per_query"] < g["full_rows_per_forward"]
    assert 0 < g["subgraph_flops_per_query"] < g["full_forward_flops"]
    assert g["full_forward_flops"] == full.gauges()["full_forward_flops"]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_matches_reference_subgraph_engine(cora, model):
    params = _params(model, seed=2)
    ref = RefEngine(cora["ref_plan"], fin=cora["feats"].shape[1],
                    widths=WIDTHS, model=model, params=params, max_batch=32,
                    mode="subgraph")
    ref.set_features(cora["feats"])
    sub = _engine(cora, model, "subgraph", params)
    rng = np.random.default_rng(3)
    for nq in (3, 32):
        q = rng.permutation(cora["plan"].n)[:nq]
        np.testing.assert_allclose(sub.query(q), ref.query(q), **CROSS)
    g, rg = sub.gauges(), ref.gauges()
    for key in ("subgraph_queries_total", "subgraph_batches_total",
                "touched_rows_total", "touched_rows_per_query",
                "recipe_edges_total", "subgraph_flops_per_query",
                "wire_rows_per_query", "full_rows_per_forward",
                "full_forward_flops", "serve_mode", "comm_schedule",
                "weights_rev"):
        assert g[key] == rg[key], key


def test_stabilizers_match_reference_and_refresh_on_swap(cora, tmp_path):
    params, other = _params("gat", seed=4), _params("gat", seed=5)
    ref = RefEngine(cora["ref_plan"], fin=cora["feats"].shape[1],
                    widths=WIDTHS, model="gat", params=params, max_batch=32,
                    mode="subgraph")
    ref.set_features(cora["feats"])
    sub = _engine(cora, "gat", "subgraph", params)
    np.testing.assert_allclose(sub._stabilizers.numpy(), ref._stabilizers,
                               rtol=1e-5, atol=1e-6)
    q = np.arange(0, cora["plan"].n, 101)
    before = sub.query(q)
    tr = FullBatchTrainer(cora["plan"], fin=cora["feats"].shape[1],
                          widths=WIDTHS, model="gat", activation="none",
                          params=other, device="cpu")
    sub.swap_weights(save_checkpoint(tr, str(tmp_path / "gat"), step=1))
    fresh = _engine(cora, "gat", "subgraph", other)
    assert sub.weights_rev == 1
    assert torch.equal(sub._stabilizers, fresh._stabilizers)
    assert not torch.equal(sub._stabilizers, _engine(
        cora, "gat", "subgraph", params)._stabilizers)
    after = sub.query(q)
    assert np.array_equal(after, fresh.query(q))
    assert not np.allclose(after, before)


# ----------------------------------------------- dispatch and shedding
def test_concurrent_equals_sequential(cora):
    eng = _engine(cora, "gcn", "subgraph", _params("gcn"))
    rng = np.random.default_rng(6)
    batches = [rng.permutation(cora["plan"].n)[:nq] for nq in (4, 9, 32)]
    seq = [eng.query(b) for b in batches]
    handles = [eng.submit(batches[0])]
    out = []
    for b in batches[1:]:
        handles.append(eng.submit(b))           # t+1 before t is read
        out.append(handles.pop(0).result())
    out.append(handles.pop(0).result())
    assert all(np.array_equal(a, b) for a, b in zip(out, seq))
    res = run_loadgen(eng, np.concatenate(batches), concurrent=True)
    assert res.queries == 45 and res.shed == 0


def test_shed_factor_reaches_the_batcher(cora):
    eng = _engine(cora, "gcn", "subgraph", _params("gcn"), shed_factor=2.0,
                  latency_budget_ms=5.0)
    assert eng.batcher.shed_factor == 2.0
    # a query older than 5 ms x 2 at dispatch is shed
    keep, shed = eng.batcher.split_shed(
        eng.batcher.submit(1, t_arrival=0.0) or eng.batcher.flush(),
        now=0.011)
    assert keep == [] and [p.qid for p in shed] == [1]
    assert eng.batcher.shed_count == 1
    with pytest.raises(ValueError) as got:
        _engine(cora, "gcn", "full", _params("gcn"), shed_factor=0.5)
    with pytest.raises(ValueError) as want:
        RefBatcher(max_batch=32, shed_factor=0.5)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- CLI
def _cli(capsys, *flags):
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "-l", "2", "--hidden", "16",
                "--queries", "24", "--max-batch", "8", "--buckets", "4,8",
                "--device", "cpu", *flags])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ("--serve-mode", "subgraph"),
    ("--serve-mode", "subgraph", "--concurrent"),
    ("--serve-mode", "subgraph", "--shed-factor", "2", "--model", "gat"),
    ("--concurrent", "--shed-factor", "2")],
    ids=["subgraph", "subgraph-concurrent", "subgraph-shed-gat",
         "full-concurrent-shed"])
def test_cli_modes(capsys, flags):
    rep = _cli(capsys, *flags)
    mode = "subgraph" if "subgraph" in flags else "full"
    assert rep["serve_mode"] == mode and rep["device"] == "cpu"
    assert rep["queries"] + rep["shed"] == 24
    assert rep["concurrent"] == ("--concurrent" in flags)
    assert rep["shed_factor"] == (2.0 if "--shed-factor" in flags else None)
    if mode == "subgraph":
        assert rep["subgraph_queries_total"] >= 24
        assert 0 < rep["touched_rows_per_query"] < rep["full_rows_per_forward"]
        assert 0 < rep["subgraph_flops_per_query"] < rep["full_forward_flops"]
        assert rep["forwards"] == (1 if "gat" in flags else 0)
    else:
        assert rep["forwards"] > 0


def test_cli_refusals_match_reference(cora, tmp_path, capsys):
    with pytest.raises(ValueError) as got:
        _cli(capsys, "--shed-factor", "0.5")
    with pytest.raises(ValueError) as want:
        RefBatcher(max_batch=8, buckets=(4, 8), shed_factor=0.5)
    assert str(got.value) == str(want.value)
    # a GCN asymmetric plan: the reference's refusal, from the CLI
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    mtx = str(tmp_path / "directed.mtx")
    scipy.io.mmwrite(mtx, a.tocsr())
    with pytest.raises(ValueError) as got:
        serve_main(["-a", mtx, "--normalize", "-p", HP8, "-s", "8",
                    "--random-init", "--device", "cpu", "--serve-mode",
                    "subgraph"])
    with pytest.raises(ValueError) as want:
        RefIndex(ref_build_comm_plan(ref_normalize(a.tocsr()), cora["pv"],
                                     8), "gcn")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown serve mode"):
        _engine(cora, "gcn", "compact", _params("gcn"))
