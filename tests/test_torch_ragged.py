"""The port's ragged ring (K4: ``ops/pspmm.py::ring_concat``,
``ops/tile_spmm.py::PspmmTilesRagged``, the ragged flavor of the GAT
attention pass) against the reference ``sgcn_tpu``'s, and against the
port's own a2a flavor.

Three kinds of checks:

  * the ring layout (``rr_sizes``, ``rsend_idx``, ``rhalo_dst``,
    ``ptile_hrsrc``, ``ptile_crsrc``) and the schedule choice
    (``resolve_comm_schedule``) EQUAL the reference's — both packages run
    the same numpy construction;
  * inside the port, ragged == a2a BIT FOR BIT (``torch.equal``): the
    forward of both models, both GAT table forms, 3 training steps
    (losses, gradients, weights).  On cora 8-hp the round sizes are
    skewed (109, 67, 88, 41, 70, 54, 87), so a ring rolled the wrong way
    reads other rows and fails;
  * the port's ragged path against the reference's ragged Pallas path
    (``SGCN_PALLAS_SPMM=1``, ``comm_schedule='ragged'``: the kernel's
    exact jnp emulation on the 8 virtual CPU devices of
    ``tests/conftest.py``), with the tolerances the a2a tests state, the
    reference trainer's gradient factor (ROADMAP C3) measured and divided
    out as ``tests/test_torch_train.py`` does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from conftest import er_graph
from sgcn_tpu.models import gat as ref_gat
from sgcn_tpu.models.gcn import gcn_forward_local as ref_gcn_forward
from sgcn_tpu.ops.pallas_spmm import (PALLAS_PLAN_FIELDS_RAGGED,
                                      choose_pallas_dispatch,
                                      pspmm_pallas_ragged)
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.parallel.plan import \
    resolve_comm_schedule as ref_resolve_comm_schedule
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils.stats import CommStats as RefCommStats
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.models.gat import GatLayerSym, _gat_tiles_aggregate
from sgcn_tpu_torch.ops.pspmm import (halo_exchange, ragged_live_rounds,
                                      ring_concat)
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                          TILE_PLAN_FIELDS_RAGGED,
                                          PspmmTilesRagged,
                                          choose_tile_dispatch,
                                          pspmm_tiles_ragged,
                                          pspmm_tiles_sym)
from sgcn_tpu_torch.parallel import build_comm_plan, resolve_comm_schedule
from sgcn_tpu_torch.parallel.plan import RAGGED_AUTO_EFFICIENCY
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.utils.stats import CommStats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
STEPS = 3
LR = 0.01

RING_ARRAYS = ("rsend_idx", "rhalo_dst", "ptile_hrsrc", "ptile_crsrc")


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8),
            "mesh": make_mesh_1d(8)}


def _graph(cora, name, row_order="degree"):
    """(port plan, reference plan) of cora2708 8-hp or the 48-vertex ER
    graph of ``tests/conftest.py`` under 4 balanced random parts."""
    if name == "cora":
        a, pv, k = cora["a"], cora["pv"], 8
    else:
        a, pv, k = er_graph(), balanced_random_partition(48, 4, seed=0), 4
    return (build_comm_plan(normalize_adjacency(a), pv, k,
                            row_order=row_order),
            ref_build_comm_plan(ref_normalize(a), pv, k,
                                row_order=row_order))


def _ring_layouts(plan, tb):
    plan.ensure_ragged()
    plan.ensure_pallas_tiles(tb).ensure_pallas_ragged_tiles()
    plan.ensure_pallas_cell_tiles(tb).ensure_pallas_cell_ragged_tiles()
    return plan


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def _unblock(tree):
    return jax.tree.map(lambda x: x[0], tree)


# --------------------------------------------------------------- the plan
@pytest.mark.parametrize("graph,tb", [("cora", 256), ("er", 8)])
@pytest.mark.parametrize("row_order", ["degree", "id"])
def test_ring_plan_arrays_equal_reference(cora, graph, tb, row_order):
    """``ensure_ragged`` + the two ring re-bases: ``rr_sizes`` and every
    ring array equal the reference's, exactly, under both row orders."""
    port, ref = (_ring_layouts(p, tb)
                 for p in _graph(cora, graph, row_order))
    assert port.rr_sizes == ref.rr_sizes
    assert port.ragged_round_sizes() == ref.ragged_round_sizes()
    for f in RING_ARRAYS:
        x, y = getattr(port, f), getattr(ref, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if graph == "cora" and row_order == "degree":
        assert port.rr_sizes == (109, 67, 88, 41, 70, 54, 87)
        assert (port.s, port.r) == (109, 316)


def test_ring_rebase_follows_the_tile_layout(cora):
    """A re-base built for one tile layout is reset when the layout is
    rebuilt, so it never reads stale positions: after a new tile height
    the re-based sources equal the reference's at that height."""
    port, ref = _graph(cora, "er")
    _ring_layouts(port, 256)
    port.ensure_pallas_tiles(8)
    port.ensure_pallas_cell_tiles(8)
    assert port.ptile_hrsrc is None and port.ptile_crsrc is None
    _ring_layouts(port, 8)
    _ring_layouts(ref, 8)
    for f in ("ptile_hrsrc", "ptile_crsrc"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    fresh = [build_comm_plan(normalize_adjacency(er_graph()),
                             balanced_random_partition(48, 4, seed=0), 4)
             for _ in range(2)]
    with pytest.raises(ValueError, match="ensure_pallas_tiles"):
        fresh[0].ensure_ragged().ensure_pallas_ragged_tiles()
    with pytest.raises(ValueError, match="ensure_ragged"):
        fresh[1].ensure_pallas_tiles(8).ensure_pallas_ragged_tiles()


@pytest.mark.parametrize("graph", ["cora", "er"])
def test_wire_rows_and_padding_efficiency_equal_reference(cora, graph):
    port, ref = _graph(cora, graph)
    for sched in ("a2a", "ragged"):
        assert port.wire_rows_per_exchange(sched) == \
            ref.wire_rows_per_exchange(sched)
    assert port.padding_efficiency() == ref.padding_efficiency()
    port.ensure_ragged()
    assert port.wire_rows_per_exchange("ragged") == \
        port.k * sum(port.rr_sizes)
    with pytest.raises(ValueError, match="unknown comm schedule"):
        port.wire_rows_per_exchange("ring")
    if graph == "cora":
        assert (port.wire_rows_per_exchange("a2a"),
                port.wire_rows_per_exchange("ragged")) == (6976, 4128)


@pytest.mark.parametrize("graph", ["cora", "er"])
@pytest.mark.parametrize("schedule", ["a2a", "ragged", "auto", None])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_schedule_choice_equals_reference(cora, graph, schedule, model,
                                          monkeypatch):
    """``resolve_comm_schedule`` resolves as the reference does, with the
    same decision log (rule, padding efficiency, wire rows); ``None``
    reads ``$SGCN_COMM_SCHEDULE``.  ``auto`` gives the ring on cora 8-hp
    (efficiency 0.311 < 0.5)."""
    monkeypatch.setenv("SGCN_COMM_SCHEDULE", "auto")
    port, ref = _graph(cora, graph)
    log, ref_log = {}, {}
    got = resolve_comm_schedule(schedule, [port], model, decision=log)
    want = ref_resolve_comm_schedule(schedule, [ref], model,
                                     decision=ref_log)
    assert got == want
    for key in ("asked", "model", "resolved", "rule", "true_rows",
                "padding_efficiency", "wire_rows_a2a", "wire_rows_ragged",
                "threshold"):
        assert log.get(key) == ref_log.get(key), key
    if graph == "cora" and schedule in ("auto", None):
        assert got == "ragged"
        assert log["padding_efficiency"] < RAGGED_AUTO_EFFICIENCY


def test_schedule_choice_rules(cora):
    """The rules that keep ``auto`` on a2a (asymmetric plan, k = 1), and
    the errors of a bad knob and of an explicit ring that cannot run."""
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    asym = build_comm_plan(a.tocsr(), cora["pv"], 8)
    one = build_comm_plan(normalize_adjacency(er_graph()),
                          np.zeros(48, np.int64), 1)
    for plan, model in ((asym, "gcn"), (one, "gat")):
        log = {}
        assert resolve_comm_schedule("auto", [plan], model, log) == "a2a"
        assert log["rule"] != "padding efficiency below threshold"
    with pytest.raises(ValueError, match="'a2a', 'ragged' or 'auto'"):
        resolve_comm_schedule("ring", [cora["plan"]], "gcn")
    with pytest.raises(ValueError, match="asymmetric"):
        resolve_forward_setup(asym, comm_schedule="ragged")
    with pytest.raises(ValueError, match="k > 1"):
        resolve_forward_setup(one, comm_schedule="ragged")
    # k = 1 on the a2a exchange still runs
    assert resolve_forward_setup(one).comm_schedule == "a2a"


def test_dispatch_and_setup_of_the_ring(cora):
    """``choose_tile_dispatch(schedule='ragged')`` keeps the a2a flavor's
    classes and adds the static ring spec; the forward setup ships the
    reference's ragged field tuples for both models."""
    plan = cora["plan"]
    log = {}
    a2a = choose_tile_dispatch(plan)
    ragged = choose_tile_dispatch(plan, decision=log, schedule="ragged")
    assert ragged == dict(a2a, comm_schedule="ragged",
                          rr_sizes=plan.rr_sizes)
    assert log["tile_dispatch"]["schedule"] == "ragged"
    ref_st = choose_pallas_dispatch(cora["ref_plan"].ensure_ragged(),
                                    schedule="ragged")
    assert ragged["pallas_hclasses"] == tuple(
        (t, e, "tile_spmm") for t, e, _ in ref_st["pallas_hclasses"])
    gcn = resolve_forward_setup(plan, comm_schedule="ragged")
    gat = resolve_forward_setup(plan, model="gat", comm_schedule="ragged")
    # the reference's tuples, with the ring's send rows replaced by the
    # flat sources of the port's ring pack
    def port(fields):
        return tuple({"rsend_idx": "ring_src"}.get(f, f) for f in fields)

    assert gcn.plan_fields == TILE_PLAN_FIELDS_RAGGED \
        == port(PALLAS_PLAN_FIELDS_RAGGED)
    assert gat.plan_fields == port_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED \
        == port(ref_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED)
    assert gat.ship_arrays(plan, "cpu")["ptile_cw"].dtype == torch.int8
    with pytest.raises(ValueError, match="unknown comm schedule"):
        choose_tile_dispatch(plan, schedule="auto")


# ------------------------------------------------------- ring == a2a, bits
def test_ring_concat_holds_the_halo_rows_at_ring_positions(cora):
    """Every real halo row of the a2a exchange sits in the ring concat at
    its ring position, exactly: part q receives round d from (q − d)
    mod k.  The concat has Σ_live S_d rows; an empty ring is one zero
    row."""
    plan = cora["plan"].ensure_ragged().ensure_exchange()
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (plan.k, plan.b, 5)).astype(np.float32))
    ring = ring_concat(h, torch.from_numpy(plan.ring_src), plan.rr_sizes)
    halo = halo_exchange(h, torch.from_numpy(plan.recv_src),
                         torch.from_numpy(plan.halo_src_flat))
    assert ring.shape == (plan.k, sum(plan.rr_sizes), 5)
    assert ragged_live_rounds(plan.rr_sizes) == tuple(range(1, plan.k))
    pos = plan._ring_pos_of_rank()
    for q in range(plan.k):
        hc = int(plan.halo_counts[q])
        assert torch.equal(ring[q, pos[q, :hc]], halo[q, :hc])
    # the wrong direction reads other rows
    wrong = torch.cat([torch.roll(h[torch.arange(plan.k)[:, None],
                                    torch.from_numpy(plan.rsend_idx[
                                        :, off: off + sd]).long()],
                                  shifts=-d, dims=0)
                       for d, sd, off in zip(
                           range(1, plan.k), plan.rr_sizes,
                           np.cumsum((0,) + plan.rr_sizes))], dim=1)
    assert not torch.equal(wrong, ring)
    assert ragged_live_rounds((3, 0, 2)) == (1, 3)
    empty = ring_concat(h, torch.zeros(plan.k, 1, dtype=torch.int32),
                        (0,) * (plan.k - 1))
    assert empty.shape == (plan.k, 1, 5) and not empty.any()


def test_pspmm_ragged_equals_a2a_bitwise(cora):
    """``pspmm_tiles_ragged`` vs ``pspmm_tiles_sym``, forward and backward
    (on a strided gradient too): torch.equal; no kernel launch on the
    CPU."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, schedule="ragged")
    plan.ensure_exchange()
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    pa = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in TILE_PLAN_FIELDS + ("ring_src", "ptile_hrsrc")}
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 32)).astype(np.float32))[..., ::2]
    before = (PspmmTilesRagged.launches, PspmmTilesRagged.backward_launches)
    out = {}
    for name in ("a2a", "ragged"):
        x = h.clone().requires_grad_()
        if name == "a2a":
            y = pspmm_tiles_sym(x, *(pa[f] for f in TILE_PLAN_FIELDS),
                                *static)
        else:
            y = pspmm_tiles_ragged(x, *(pa[f] for f in
                                        TILE_PLAN_FIELDS_RAGGED),
                                   *static, st["rr_sizes"])
        y.backward(g)
        out[name] = (y.detach(), x.grad)
    assert torch.equal(out["a2a"][0], out["ragged"][0])
    assert torch.equal(out["a2a"][1], out["ragged"][1])
    assert out["a2a"][0].abs().max() > 0
    assert (PspmmTilesRagged.launches,
            PspmmTilesRagged.backward_launches) == before


def _weights(seed, dims, model):
    rng = np.random.default_rng(seed)
    if model == "gat":
        return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a))
                 .astype(np.float32),
                 "a1": (rng.standard_normal(b) / np.sqrt(b)).astype(
                     np.float32),
                 "a2": (rng.standard_normal(b) / np.sqrt(b)).astype(
                     np.float32)} for a, b in dims]
    return [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
            for a, b in dims]


@pytest.mark.parametrize("model,widths", [
    ("gcn", [16, 7]), ("gat", [16, 7]), ("gat", [130, 7])],
    ids=["gcn", "gat-fused", "gat-split"])
def test_forward_ragged_equals_a2a_bitwise(cora, model, widths):
    """The whole forward of both models (GAT in the fused and the split
    table form) on the ring equals the a2a forward, bit for bit."""
    plan, feats = cora["plan"], cora["feats"]
    dims = list(zip([1433] + widths[:-1], widths))
    params = _weights(2, dims, model)
    h0 = torch.from_numpy(plan.scatter_rows(feats))
    fwd = (port_gat.gat_forward_local if model == "gat"
           else port_gcn.gcn_forward_local)
    conv = (port_gat.params_from_jax if model == "gat"
            else port_gcn.params_from_jax)
    outs = []
    for sched in ("a2a", "ragged"):
        setup = resolve_forward_setup(plan, model=model,
                                      comm_schedule=sched)
        with torch.no_grad():
            outs.append(fwd(conv(params), h0, setup.ship_arrays(plan, "cpu"),
                            **setup.fwd_static))
    assert outs[0].shape == (plan.k, plan.b, widths[-1])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("fout", [7, 130])
def test_gat_layer_forms_ragged_equal_a2a_bitwise(cora, fout):
    """``GatLayerSym`` with ``form=`` forced fused and split, on the ring
    and on the a2a exchange: the aggregate, the layer's output and every
    gradient are the same bits in all four runs."""
    plan = cora["plan"]
    setups = {s: resolve_forward_setup(plan, model="gat", comm_schedule=s)
              for s in ("a2a", "ragged")}
    cls = setups["a2a"].fwd_static["pallas_cclasses"]
    rng = np.random.default_rng(fout)
    valid = plan.row_valid[..., None]
    w, a1, a2, h, g = (torch.tensor(x, dtype=torch.float32) for x in (
        rng.standard_normal((24, fout)) / np.sqrt(24),
        rng.standard_normal(fout), rng.standard_normal(fout) / np.sqrt(fout),
        rng.standard_normal((plan.k, plan.b, 24)) * valid,
        rng.standard_normal((plan.k, plan.b, fout)) * valid))
    p, s = torch.rand(plan.k, plan.b, fout), torch.rand(plan.k, plan.b)
    res, aggs = {}, {}
    for sched, setup in setups.items():
        pa = setup.ship_arrays(plan, "cpu")
        if sched == "ragged":
            ex, rr = (pa["ring_src"], None, pa["ptile_crsrc"]), plan.rr_sizes
        else:
            ex = (pa["recv_src"], pa["halo_src_flat"], pa["ptile_csrc"])
            rr = None
        for form in ("fused", "split"):
            aggs[sched, form] = _gat_tiles_aggregate(
                p, s, form, *ex, pa["ptile_cld"], pa["ptile_cw"], 256, cls,
                rr)
            leaves = [x.clone().requires_grad_() for x in (w, a1, a2, h)]
            out = GatLayerSym.apply(*leaves, *ex, pa["ptile_cld"],
                                    pa["ptile_cw"], pa["row_valid"], 256,
                                    cls, form, rr)
            out.backward(g)
            res[sched, form] = [out.detach()] + [x.grad for x in leaves]
    first = res["a2a", "fused"]
    for key, got in res.items():
        assert all(torch.equal(x, y) for x, y in zip(got, first)), key
        assert all(torch.equal(x, y) for x, y in
                   zip(aggs[key], aggs["a2a", "fused"])), key
    assert not first[2].any()                    # d a1 exactly 0


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_three_steps_ragged_equal_a2a_bitwise(cora, model):
    """Three training steps on the ring and on the a2a exchange from the
    same weights: losses, every step's gradients and the weights after
    each step are the same bits; the comm report differs only in the
    wire accounting."""
    plan = cora["plan"]
    data = make_train_data(plan, cora["feats"], cora["labels"])
    kw = dict(fin=1433, widths=WIDTHS, model=model, seed=4, device="cpu",
              activation="relu" if model == "gcn" else "none")
    runs = {}
    for sched in ("a2a", "ragged"):
        tr = FullBatchTrainer(plan, comm_schedule=sched, **kw)
        assert tr.comm_schedule == sched
        grads = []
        tr.opt.register_step_pre_hook(lambda opt, a, k, tr=tr: grads.append(
            [p.grad.clone() for p in tr.model.parameters()]))
        losses = [tr.step(data) for _ in range(STEPS)]
        runs[sched] = (losses, grads,
                       [p.detach() for p in tr.model.parameters()],
                       tr.stats.report())
    (la, ga, wa, ra), (lr, gr, wr, rr) = runs["a2a"], runs["ragged"]
    assert la == lr and la[-1] < la[0]
    for x, y in zip(ga, gr):
        assert all(torch.equal(a, b) for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(wa, wr))
    assert ra["wire_rows_per_exchange"] == 6976
    assert rr["wire_rows_per_exchange"] == 4128
    assert rr["comm_schedule"] == "ragged"
    same = {k for k in ra if "wire" not in k and k not in (
        "comm_schedule", "padding_efficiency")}
    assert {k: ra[k] for k in same} == {k: rr[k] for k in same}


# ------------------------------------------------------- against the JAX
def test_gcn_ragged_forward_matches_reference(cora):
    """One ragged aggregation and the 2-layer ragged GCN forward vs the
    reference's ``pspmm_pallas_ragged`` / ragged ``gcn_forward_local``
    (kernel path, emulated) per chip, from the same weights: one layer
    rtol 1e-5 / atol 1e-6, the forward rtol 1e-4 / atol 1e-5 — the a2a
    tests' bounds (``tests/test_torch_gcn.py``)."""
    plan, feats = cora["plan"], cora["feats"]
    st = choose_tile_dispatch(plan, schedule="ragged")
    lcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_lclasses"])
    hcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_hclasses"])
    pa_np = {f: np.ascontiguousarray(getattr(plan, f))
             for f in TILE_PLAN_FIELDS_RAGGED}
    pa = {f: torch.from_numpy(x) for f, x in pa_np.items()}
    h = np.random.default_rng(1).standard_normal(
        (plan.k, plan.b, 16)).astype(np.float32)
    ref_np = {f: np.ascontiguousarray(getattr(plan, f))
              for f in PALLAS_PLAN_FIELDS_RAGGED}
    args = [h] + [ref_np[f] for f in PALLAS_PLAN_FIELDS_RAGGED]

    def per_chip(*a):
        return pspmm_pallas_ragged(*(x[0] for x in a), 256, lcls, hcls,
                                   plan.rr_sizes, True, "v")[None]

    want = np.asarray(_smap(cora["mesh"], per_chip, (P("v"),) * len(args),
                            P("v"))(*args))
    got = pspmm_tiles_ragged(torch.from_numpy(h),
                             *(pa[f] for f in TILE_PLAN_FIELDS_RAGGED),
                             256, st["pallas_lclasses"],
                             st["pallas_hclasses"], plan.rr_sizes).numpy()
    print(f"one ragged layer: max |port - reference| "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    params = _weights(3, [(1433, 16), (16, 7)], "gcn")
    h0 = plan.scatter_rows(feats)

    def fwd(params, h0, pa):
        return ref_gcn_forward(params, h0[0], _unblock(pa), symmetric=True,
                               pallas_tb=256, pallas_emulate=True,
                               pallas_lclasses=lcls, pallas_hclasses=hcls,
                               comm_schedule="ragged",
                               rr_sizes=plan.rr_sizes)[None]

    want = np.asarray(_smap(cora["mesh"], fwd, (P(), P("v"), P("v")),
                            P("v"))([jnp.asarray(w) for w in params], h0,
                                    ref_np))
    got = port_gcn.gcn_forward_local(port_gcn.params_from_jax(params),
                                     torch.from_numpy(h0), pa,
                                     **st).numpy()
    print(f"2-layer ragged forward: max |port - reference| "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("widths", [[16, 7], [128, 7]],
                         ids=["fused-fused", "split-fused"])
def test_gat_ragged_forward_matches_reference_predict(cora, widths,
                                                      monkeypatch):
    """The port's ragged GAT forward vs the reference trainer's ragged
    ``predict`` (kernel path, emulated) from the same params on cora 8-hp:
    rtol 1e-4 / atol 1e-5, the a2a test's bound."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "1")
    monkeypatch.delenv("SGCN_GAT_FUSED", raising=False)
    feats, labels = cora["feats"], cora["labels"]
    ref = RefTrainer(cora["ref_plan"], fin=1433, widths=widths, model="gat",
                     activation="none", seed=7, comm_schedule="ragged")
    assert ref.plan_fields == ref_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED
    want = ref.predict(ref_make_train_data(cora["ref_plan"], feats, labels))
    setup = resolve_forward_setup(cora["plan"], model="gat",
                                  comm_schedule="ragged")
    params = port_gat.params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref.params])
    with torch.no_grad():
        out = port_gat.gat_forward_local(
            params, torch.from_numpy(cora["plan"].scatter_rows(feats)),
            setup.ship_arrays(cora["plan"], "cpu"), **setup.fwd_static)
    got = cora["plan"].gather_rows(out.numpy())
    print(f"ragged GAT {widths}: max |port - reference| "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _np_tree(params):
    return [{k: np.asarray(v) for k, v in p.items()} if isinstance(p, dict)
            else np.asarray(p) for p in params]


@pytest.fixture(scope="module", params=["gcn", "gat"])
def parity(request, cora):
    """Both trainers on the ring, 3 steps each from the reference's
    initial weights, on cora2708 8-hp, 1433 → 16 → 7; the reference's
    step gradient factor measured and divided out of its optimizer."""
    model = request.param
    feats, labels = cora["feats"], cora["labels"]
    kw = dict(fin=1433, widths=WIDTHS, seed=3, model=model,
              activation="relu" if model == "gcn" else "none",
              comm_schedule="ragged")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        mp.delenv("SGCN_GAT_FUSED", raising=False)
        ref0 = RefTrainer(cora["ref_plan"], **kw)
        assert ref0.plan_fields == (
            PALLAS_PLAN_FIELDS_RAGGED if model == "gcn"
            else ref_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED)
        p0 = _np_tree(ref0.params)
        rdata = ref_make_train_data(cora["ref_plan"], feats, labels)
        rd = shard_stacked(ref0.mesh, vars(rdata))
        args = (ref0.pa, rd["h0"], rd["labels"], rd["train_valid"])
        specs = (P(), P("v"), P("v"), P("v"), P("v"))

        def chip_loss(params, pa, h0, lab, valid):
            pa, h0, lab, valid = _unblock((pa, h0, lab, valid))
            return ref0._loss_fn(ref0._forward(params, pa, h0), lab, valid)

        loss_map = jax.shard_map(chip_loss, mesh=ref0.mesh, in_specs=specs,
                                 out_specs=P())
        ref_loss0, ref_grads = jax.jit(jax.value_and_grad(
            lambda ps: loss_map(ps, *args)))(ref0.params)

        def chip_grads(params, pa, h0, lab, valid):
            g = jax.grad(chip_loss)(params, pa, h0, lab, valid)
            return jax.tree.map(lambda x: lax.psum(x, "v"), g)

        step_grads = _smap(ref0.mesh, chip_grads, specs, P())(
            ref0.params, *args)
        leaf = (lambda t: t[0]["w"]) if model == "gat" else (lambda t: t[0])
        factor = float(np.linalg.norm(np.asarray(leaf(step_grads)))
                       / np.linalg.norm(np.asarray(leaf(ref_grads))))
        ref = RefTrainer(cora["ref_plan"], **kw, optimizer=optax.chain(
            optax.scale(1.0 / round(factor)), optax.adam(LR)))
        ref_losses = [ref.step(rdata) for _ in range(STEPS)]
        ref_report = ref.stats.report()

    conv = (port_gat.params_from_jax if model == "gat"
            else port_gcn.params_from_jax)
    tr = FullBatchTrainer(cora["plan"], lr=LR, params=conv(p0),
                          device="cpu", **kw)
    assert tr.comm_schedule == "ragged"
    data = make_train_data(cora["plan"], feats, labels)
    grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, k: grads.append(
        _np_tree([{n: v.grad.clone() for n, v in p.items()}
                  if isinstance(p, dict) else p.grad.clone()
                  for p in tr.params])))
    losses = [tr.step(data) for _ in range(STEPS)]
    return {"model": model, "factor": factor,
            "ref_loss0": float(ref_loss0), "ref_grads": _np_tree(ref_grads),
            "ref_losses": np.asarray(ref_losses),
            "ref_params": _np_tree(ref.params), "ref_report": ref_report,
            "grads": grads[0], "losses": np.asarray(losses),
            "params": _np_tree([{n: v.detach() for n, v in p.items()}
                                if isinstance(p, dict) else p.detach()
                                for p in tr.params]),
            "report": tr.stats.report()}


def _leaves(tree):
    out = []
    for p in tree:
        out += ([p[k] for k in ("w", "a1", "a2")] if isinstance(p, dict)
                else [p])
    return out


def test_ragged_step_gradient_scale_is_measured(parity):
    """The reference's ragged trainer carries the same gradient factor as
    its a2a trainer (ROADMAP C3): 1 or k = 8."""
    print(f"{parity['model']} ragged reference step gradient / loss "
          f"gradient: {parity['factor']!r}")
    assert round(parity["factor"]) in (1, 8)
    assert parity["factor"] == pytest.approx(round(parity["factor"]),
                                             rel=1e-5)


def test_ragged_first_step_gradients_match_reference(parity):
    """Step-1 gradients on the ring: relative Frobenius error ≤ 1e-6
    (GCN) / 1e-5 (GAT) per leaf with a nonzero gradient, the a2a tests'
    bounds; GAT's ``a1`` gradient is exactly 0 in both packages."""
    bound = 1e-6 if parity["model"] == "gcn" else 1e-5
    assert parity["losses"][0] == pytest.approx(parity["ref_loss0"],
                                                rel=1e-6)
    for got, want in zip(_leaves(parity["grads"]),
                         _leaves(parity["ref_grads"])):
        if not np.asarray(want).any():
            assert not got.any()                  # GAT's a1
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        print(f"{parity['model']} d{want.shape}: relative Frobenius "
              f"{rel:.3g}")
        assert rel <= bound


def test_ragged_losses_and_weights_track_reference(parity):
    """Three losses within rtol 1e-5; after three Adam steps 99 % of the
    weights within 1e-5 and all within half a step (the a2a tests'
    bounds: Adam moves a weight with a near-zero gradient a step-sized
    amount on a rounding difference)."""
    np.testing.assert_allclose(parity["losses"], parity["ref_losses"],
                               rtol=1e-5)
    for got, want in zip(_leaves(parity["params"]),
                         _leaves(parity["ref_params"])):
        gap = np.abs(got - want)
        assert np.mean(gap <= 1e-5) >= 0.99, gap.max()
        assert gap.max() <= 0.5 * LR


def test_ragged_comm_stats_equal_reference(parity):
    """Every key of the port's ragged report equals the reference's: the
    ring's wire rows k·Σ S_d, its padding efficiency and byte gauges."""
    rep, ref = parity["report"], parity["ref_report"]
    assert rep["comm_schedule"] == ref["comm_schedule"] == "ragged"
    assert set(rep) <= set(ref)
    assert {k: rep[k] for k in rep} == {k: ref[k] for k in rep}
    assert rep["wire_rows_per_exchange"] == 4128


@pytest.mark.parametrize("graph", ["cora", "er"])
def test_comm_stats_ragged_report_equals_reference(cora, graph):
    port, ref = _graph(cora, graph)
    lanes = port_gcn.exchange_widths(8, [16, 7])
    st = CommStats.from_plan(port, schedule="ragged", lane_widths=lanes)
    rst = RefCommStats.from_plan(ref, schedule="ragged", lane_widths=lanes)
    for s in (st, rst):
        s.count_step(nlayers=2)
        s.count_forward(nlayers=2)
    rep, rrep = st.report(), rst.report()
    assert {k: rep[k] for k in rep} == {k: rrep[k] for k in rep}


# ------------------------------------------------------------------ CLIs
def test_train_cli_ragged_refuses_the_accuracy_experiment():
    with pytest.raises(SystemExit, match="accuracy-parity harness"):
        train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                    "--comm-schedule", "ragged", "--experiment", "accuracy",
                    "--device", "cpu"])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_train_cli_auto_resolves_to_the_ring_on_cora(model, capsys):
    """``--comm-schedule auto`` on cora 8-hp trains on the ring, with the
    losses of ``--comm-schedule a2a`` bit for bit."""
    reps = {}
    for sched in ("a2a", "auto"):
        train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                    "-l", "2", "--hidden", "16", "--epochs", "2",
                    "--warmup", "0", "--model", model,
                    "--comm-schedule", sched, "--device", "cpu"])
        out = capsys.readouterr().out.strip().splitlines()
        reps[sched] = ([float(x.split()[-1]) for x in out
                        if x.startswith("epoch ")], json.loads(out[-1]))
    assert reps["a2a"][1]["comm_schedule"] == "a2a"
    assert reps["auto"][1]["comm_schedule"] == "ragged"
    assert reps["auto"][1]["wire_rows_per_exchange"] == 4128
    assert len(reps["auto"][0]) == 2
    assert reps["auto"][0] == reps["a2a"][0]


def test_serve_ragged_engine_and_cli(cora, capsys):
    """The ragged engine serves the a2a engine's rows bit for bit and
    prices the ring's wire; the serve CLI takes ``--comm-schedule``."""
    kw = dict(fin=1433, widths=WIDTHS, seed=1, max_batch=8, device="cpu")
    engines = {s: ServeEngine(cora["plan"], comm_schedule=s, **kw)
               for s in ("a2a", "ragged")}
    q = np.array([0, 7, 100, 2707, 1500])
    rows = {}
    for s, e in engines.items():
        e.set_features(cora["feats"])
        rows[s] = e.query(q)
    np.testing.assert_array_equal(rows["a2a"], rows["ragged"])
    g = engines["ragged"].gauges()
    assert g["comm_schedule"] == "ragged"
    assert g["wire_rows_per_exchange"] == 4128
    assert engines["a2a"].gauges()["wire_rows_per_exchange"] == 6976
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "-l", "2", "--hidden", "16", "--model",
                "gat", "--queries", "16", "--max-batch", "8", "--buckets",
                "4,8", "--comm-schedule", "ragged", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["comm_schedule"] == "ragged" and rep["model"] == "gat"
    assert rep["wire_rows_per_exchange"] == 4128 and rep["queries"] == 16
