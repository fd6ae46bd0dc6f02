"""The port's GAT (``sgcn_tpu_torch/models/gat.py``, the attention pass K5
on the tile kernel) against the reference ``sgcn_tpu``'s.

Same inputs — cora2708 under its 8-part hp partition, or the 48-vertex ER
graph of ``tests/conftest.py``, params and features from numpy seeds or
carried from the reference with ``params_from_jax`` — go through the
reference (its kernel path forced with ``SGCN_PALLAS_SPMM=1``, so
``spmm_pallas`` runs its exact jnp emulation on the 8 virtual CPU devices,
or the kernel body in interpret mode) and through the port on the CPU,
where the tile kernel is its plain version.  Tolerances are stated per
test.  As in ``tests/test_torch_train.py``, the reference trainer's
gradient scale (ROADMAP C3) is measured and divided out of its optimizer.
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
from sgcn_tpu.baselines.gat_oracle import DenseGATOracle as RefGATOracle
from sgcn_tpu.models import gat as ref_gat
from sgcn_tpu.ops.pallas_spmm import (choose_pallas_dispatch, spmm_pallas,
                                      spmm_pallas_classes)
from sgcn_tpu.ops.pspmm import halo_exchange as ref_halo_exchange
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.baselines import DenseGATOracle
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models.gat import (GatLayerSym, _gat_factored_fwd_core,
                                       _gat_tiles_aggregate,
                                       gat_forward_local, params_from_jax)
from sgcn_tpu_torch.ops.pspmm import halo_exchange
from sgcn_tpu_torch.ops.tile_spmm import (choose_tile_dispatch,
                                          gat_tiles_pass, spmm_tiles,
                                          spmm_tiles_classes)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)
from sgcn_tpu_torch.train.__main__ import main as train_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
STEPS = 5
LR = 0.01

# the combined-edge layout the GAT forward reads, every field by name
CELL_ARRAYS = ("cell_idx", "cell_w", "ctail_dst", "ctail_src", "ctail_w",
               "ctail_nnz", "ptile_csrc", "ptile_cld", "ptile_cw")
CELL_STATICS = ("ctl", "cell_buckets", "pallas_ctb", "pallas_cclasses")


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "ahat": normalize_adjacency(a),
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8),
            "mesh": make_mesh_1d(8)}


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def _unblock(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


# --------------------------------------------------------------- the plan
@pytest.mark.parametrize("graph,tb,row_order", [
    ("cora2708-8hp", 256, "degree"), ("er48-4rp", 256, "degree"),
    ("er48-4rp", 8, "degree"), ("er48-4rp", 8, "id")])
def test_cell_plan_fields_equal_reference(cora, graph, tb, row_order):
    """``ensure_cell`` + ``ensure_pallas_cell_tiles``: every combined-edge
    array and static tuple equals the reference's, exactly, under both
    row orders (bucketed, and one bucket of the tail-bounded width)."""
    if graph.startswith("cora"):
        a, pv, k = cora["a"], cora["pv"], 8
    else:
        a, pv, k = er_graph(), balanced_random_partition(48, 4, seed=0), 4
    port = build_comm_plan(normalize_adjacency(a), pv, k,
                           row_order=row_order)
    ref = ref_build_comm_plan(ref_normalize(a), pv, k, row_order=row_order)
    port.ensure_pallas_cell_tiles(tb)
    ref.ensure_pallas_cell_tiles(tb)
    for f in CELL_STATICS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in CELL_ARRAYS:
        x, y = getattr(port, f), getattr(ref, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert set(np.unique(port.ptile_cw)) <= {0.0, 1.0}
    if row_order == "id":
        assert len(port.cell_buckets) == 1
    if graph.startswith("cora"):
        # the classes the reference's kernel path resolves on cora 8-hp
        assert port.pallas_cclasses == ((1, 832), (1, 288))


def test_dispatch_logs_combined_classes(cora):
    """``choose_tile_dispatch(model='gat')``: the reference's combined
    classes, every one on the tile kernel, and the decision log names the
    TPU rules it does not carry — ``check_gat_memory`` among them."""
    decision, ref_decision = {}, {}
    st = choose_tile_dispatch(cora["plan"], decision=decision, model="gat")
    ref_st = choose_pallas_dispatch(cora["ref_plan"], model="gat",
                                    decision=ref_decision)
    assert st["pallas_cclasses"] == tuple(
        (t, e, "tile_spmm") for t, e, _ in ref_st["pallas_cclasses"])
    log = decision["tile_dispatch"]
    assert log["model"] == "gat" and log["tb"] == 256
    assert log["combined"] == [
        {"tiles": t, "emax": e, "kernel": "tile_spmm"}
        for t, e, _ in ref_st["pallas_cclasses"]]
    assert [(c["tiles"], c["emax"]) for c in log["combined"]] == [
        (c["tiles"], c["emax"])
        for c in ref_decision["pallas_dispatch"]["combined"]]
    assert {"vmem_budget", "emax_cap", "gat_memory"} <= set(
        log["not_carried"])
    setup = resolve_forward_setup(cora["plan"], model="gat")
    # the reference's fields, with its exchange arrays replaced by the
    # flat sources of the port's row packs
    assert setup.plan_fields == tuple(
        {"send_idx": "recv_src", "halo_src": "halo_src_flat"}.get(f, f)
        for f in ref_gat.GAT_PLAN_FIELDS_PALLAS)
    pa = setup.ship_arrays(cora["plan"], "cpu")
    assert pa["ptile_cw"].dtype == torch.int8
    np.testing.assert_array_equal(pa["ptile_cw"].numpy(),
                                  cora["plan"].ptile_cw != 0)


# ------------------------------------------------------------ the K5 pass
def _mask_tiles(plan, f, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((plan.k, plan.b + plan.r, f)).astype(
        np.float32)
    cw = (plan.ptile_cw != 0).astype(np.int8)
    return plan.ptile_csrc, plan.ptile_cld, cw, table


@pytest.mark.parametrize("f", [1, 8, 17, 41])
def test_mask_pass_plain_equals_reference_emulation(cora, f):
    """K5's plain version on int8 masks over cora's combined classes vs
    ``spmm_pallas_classes(emulate=True)`` on the upcast masks, per part:
    exact (0/1 weights make every product exact, and both sum each row in
    stored order).  The plain version on the upcast f32 mask (K1's form)
    gives the same bits."""
    plan = cora["plan"].ensure_pallas_cell_tiles(256)
    csrc, cld, cw, table = _mask_tiles(plan, f, seed=f)
    cls = tuple((t, e, "tile_spmm") for t, e in plan.pallas_cclasses)
    got = gat_tiles_pass(*(torch.from_numpy(x) for x in (csrc, cld, cw)),
                         torch.from_numpy(table), cls, 256, plan.b)
    assert got.shape == (plan.k, plan.b, f) and got.dtype == torch.float32
    upcast = spmm_tiles_classes(
        *(torch.from_numpy(x) for x in (csrc, cld, cw.astype(np.float32))),
        torch.from_numpy(table), cls, 256)[:, :plan.b]
    assert torch.equal(got, upcast)
    ref_cls = tuple((t, e, "vmem") for t, e in plan.pallas_cclasses)
    for p in range(plan.k):
        want = spmm_pallas_classes(
            jnp.asarray(csrc[p]), jnp.asarray(cld[p]),
            jnp.asarray(cw[p]).astype(jnp.float32), jnp.asarray(table[p]),
            ref_cls, 256, emulate=True)[:plan.b]
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


@pytest.mark.parametrize("f", [1, 8, 17, 41])
def test_mask_pass_plain_matches_pallas_interpret(f):
    """Per combined class of the ER plan at tile height 8 (several
    classes, pads, empty rows), the plain version on int8 masks vs the
    kernel body in interpret mode: rtol 1e-6 / atol 1e-7 (ROADMAP C2 —
    XLA:CPU may contract the body's multiply-add into an FMA)."""
    a, pv = er_graph(), balanced_random_partition(48, 4, seed=0)
    plan = build_comm_plan(normalize_adjacency(a), pv, 4)
    plan.ensure_pallas_cell_tiles(8)
    assert len(plan.pallas_cclasses) > 1
    csrc, cld, cw, table = _mask_tiles(plan, f, seed=10 + f)
    off = 0
    for t, e in plan.pallas_cclasses:
        sl = slice(off, off + t * e)
        tiles = [x[:, sl].reshape(plan.k, t, e) for x in (csrc, cld, cw)]
        got = spmm_tiles(*(torch.from_numpy(np.ascontiguousarray(x))
                           for x in tiles), torch.from_numpy(table), 8)
        for p in range(plan.k):
            want = spmm_pallas(jnp.asarray(tiles[0][p]),
                               jnp.asarray(tiles[1][p]),
                               jnp.asarray(tiles[2][p], jnp.float32),
                               jnp.asarray(table[p]), tb=8, interpret=True)
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        off += t * e


def test_scalar_exchange_matches_reference(cora):
    """``halo_exchange`` of a ``(k, B)`` scalar table (the split form's
    ``u``) vs the reference's per-chip exchange: a pure copy, exact."""
    plan = cora["plan"]
    u = np.random.default_rng(3).random((plan.k, plan.b)).astype(np.float32)
    plan.ensure_exchange()
    got = halo_exchange(torch.from_numpy(u),
                        torch.from_numpy(plan.recv_src),
                        torch.from_numpy(plan.halo_src_flat))
    want = _smap(cora["mesh"], lambda u, s, h: ref_halo_exchange(
        u[0][:, None], s[0], h[0])[None, :, 0], (P("v"),) * 3, P("v"))(
        u, plan.send_idx, plan.halo_src)
    assert got.shape == (plan.k, plan.r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the model
def _ref_params(seed, dims):
    return _np_params(ref_gat.init_gat_params(jax.random.PRNGKey(seed), dims))


def test_table_forms_and_lane_widths_equal_reference(monkeypatch):
    monkeypatch.delenv("SGCN_GAT_FUSED", raising=False)
    for fout in (1, 7, 16, 40, 126, 127, 128, 129, 256):
        assert port_gat.gat_table_form(fout) == ref_gat.gat_table_form(fout)
    widths = [128, 127, 40, 7]
    assert port_gat.gat_exchange_lane_widths(widths) == \
        ref_gat.gat_exchange_lane_widths(widths)
    # the packed bf16 form and its lane widths (f32-lane equivalents)
    for fout in (1, 7, 16, 127, 128):
        assert port_gat.gat_table_form(fout, "bfloat16") == \
            ref_gat.gat_table_form(fout, "bfloat16")
    assert port_gat.gat_exchange_lane_widths(widths, "bfloat16") == \
        ref_gat.gat_exchange_lane_widths(widths, "bfloat16") == \
        [65, 64, 21, 4]


def test_init_params_and_params_from_jax():
    """The port's own init: the reference's shapes, ``w`` Glorot-normal
    truncated at 2σ (std within 5 % of √(2/(fin+fout)) over 64k draws),
    ``a1``/``a2`` N(0, 1)/√fout; the same seed gives the same params.
    ``params_from_jax`` carries the reference's dicts over exactly."""
    dims = [(256, 256), (256, 7)]
    p = port_gat.init_gat_params(torch.Generator().manual_seed(3), dims)
    again = port_gat.init_gat_params(torch.Generator().manual_seed(3), dims)
    for layer, (fin, fout) in zip(p, dims):
        assert layer["w"].shape == (fin, fout)
        assert layer["a1"].shape == layer["a2"].shape == (fout,)
    w = p[0]["w"]
    std = np.sqrt(2.0 / 512)
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
    assert abs(float(p[0]["a2"].std()) * np.sqrt(256) - 1) < 0.15
    for x, y in zip(p, again):
        assert all(torch.equal(x[k], y[k]) for k in x)
    ref = _ref_params(0, dims)
    for got, want in zip(params_from_jax(ref), ref):
        for k in ("w", "a1", "a2"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_edge_softmax_matches_reference():
    """``edge_softmax`` over a dst-sorted COO list with masked edges and an
    empty row, vs the reference's: rtol 1e-6 / atol 1e-7."""
    rng = np.random.default_rng(5)
    n, deg = 12, 4
    dst = np.repeat(np.arange(n - 1), deg).astype(np.int32)   # row 11 empty
    scores = (rng.standard_normal(dst.size) * 5).astype(np.float32)
    mask = rng.random(dst.size) < 0.8
    want = np.asarray(ref_gat.edge_softmax(
        jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(dst), n))
    got = port_gat.edge_softmax(torch.from_numpy(scores),
                                torch.from_numpy(mask),
                                torch.from_numpy(dst), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("widths", [[16, 7], [128, 7]],
                         ids=["fused-fused", "split-fused"])
def test_forward_matches_reference_predict(cora, widths, monkeypatch):
    """The port's ``gat_forward_local`` vs the reference trainer's
    ``predict`` (kernel path, emulated) from the same params on cora
    8-hp: rtol 1e-4 / atol 1e-5 (the dense projections and score
    reductions sum in other orders; observed ≤ 4.2e-7)."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "1")
    monkeypatch.delenv("SGCN_GAT_FUSED", raising=False)
    feats, labels = cora["feats"], cora["labels"]
    ref = RefTrainer(cora["ref_plan"], fin=1433, widths=widths, model="gat",
                     activation="none", seed=7)
    assert ref.plan_fields == ref_gat.GAT_PLAN_FIELDS_PALLAS
    want = ref.predict(ref_make_train_data(cora["ref_plan"], feats, labels))
    forms = [port_gat.gat_table_form(w) for w in widths]
    assert forms == [ref_gat.gat_table_form(w) for w in widths]
    setup = resolve_forward_setup(cora["plan"], model="gat")
    pa = setup.ship_arrays(cora["plan"], "cpu")
    h0 = torch.from_numpy(cora["plan"].scatter_rows(feats))
    params = params_from_jax(_np_params(ref.params))
    with torch.no_grad():
        out = gat_forward_local(params, h0, pa, **setup.fwd_static)
    got = cora["plan"].gather_rows(out.numpy())
    gap = np.abs(got - want)
    print(f"GAT {widths} ({forms}): max |port - reference| {gap.max():.3g}")
    assert got.shape == want.shape == (2708, 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _layer_inputs(plan, fin, fout, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((plan.k, plan.b, fin)) * plan.row_valid[..., None]
    w = rng.standard_normal((fin, fout)) / np.sqrt(fin)
    a1, a2 = (rng.standard_normal(fout) / np.sqrt(fout) for _ in range(2))
    g = rng.standard_normal((plan.k, plan.b, fout)) * plan.row_valid[..., None]
    return [torch.tensor(x, dtype=dtype) for x in (w, a1, a2, h, g)]


@pytest.mark.parametrize("fout", [7, 130])
def test_fused_equals_split_bitwise(cora, fout):
    """Both table forms, given as an argument: the aggregation and the
    whole layer (forward and every gradient) come out bit-identical —
    each kernel column is summed on its own in stored edge order."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, model="gat")
    pa = resolve_forward_setup(plan, model="gat").ship_arrays(plan, "cpu")
    w, a1, a2, h, g = _layer_inputs(plan, 24, fout, seed=fout)
    args = (pa["recv_src"], pa["halo_src_flat"], pa["ptile_csrc"],
            pa["ptile_cld"], pa["ptile_cw"])
    p, s = torch.rand(plan.k, plan.b, fout), torch.rand(plan.k, plan.b)
    fused = _gat_tiles_aggregate(p, s, "fused", *args, 256,
                                 st["pallas_cclasses"])
    split = _gat_tiles_aggregate(p, s, "split", *args, 256,
                                 st["pallas_cclasses"])
    assert all(torch.equal(x, y) for x, y in zip(fused, split))
    res = {}
    for form in ("fused", "split"):
        leaves = [x.clone().requires_grad_() for x in (w, a1, a2, h)]
        out = GatLayerSym.apply(*leaves, *args, pa["row_valid"], 256,
                                st["pallas_cclasses"], form)
        out.backward(g)
        res[form] = [out.detach()] + [x.grad for x in leaves]
    assert all(torch.equal(x, y) for x, y in zip(res["fused"], res["split"]))
    # 'packed' is the bf16 form now (tests/test_torch_bf16.py); any other
    # name is refused
    with pytest.raises(ValueError, match="fused, split and packed"):
        _gat_tiles_aggregate(p, s, "ell", *args, 256,
                             st["pallas_cclasses"])


@pytest.mark.parametrize("form", ["fused", "split"])
def test_layer_backward_matches_autograd_float64(cora, form):
    """``GatLayerSym``'s custom backward vs torch autograd through the
    same forward without the Function (``_gat_factored_fwd_core``, the
    plain kernel version differentiated), all in float64 on cora 8-hp:
    rtol 1e-9 / atol 1e-12 (the two sum in other orders; observed
    ≤ 2e-15 relative).  ``∂L/∂a1`` is exactly 0, and autograd's ``a1``
    takes no part in the forward at all."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, model="gat")
    pa = resolve_forward_setup(plan, model="gat").ship_arrays(plan, "cpu")
    w, a1, a2, h, g = _layer_inputs(plan, 20, 9, seed=1,
                                    dtype=torch.float64)
    args = (pa["recv_src"], pa["halo_src_flat"], pa["ptile_csrc"],
            pa["ptile_cld"], pa["ptile_cw"], pa["row_valid"], 256,
            st["pallas_cclasses"], form)
    ours = [x.clone().requires_grad_() for x in (w, a1, a2, h)]
    out = GatLayerSym.apply(*ours, *args)
    out.backward(g)
    auto = [x.clone().requires_grad_() for x in (w, a2, h)]
    out2 = _gat_factored_fwd_core(*auto, *args)[0]
    out2.backward(g)
    assert out.dtype == torch.float64
    assert torch.equal(out.detach(), out2.detach())
    assert torch.equal(ours[1].grad, torch.zeros_like(a1))
    for name, got, want in zip(("w", "a2", "h"), (ours[0], ours[2], ours[3]),
                               auto):
        rel = float((got.grad - want.grad).norm() / want.grad.norm())
        print(f"{form} d{name}: relative gap {rel:.3g}")
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_asymmetric_and_unported_forms_raise(cora):
    """An asymmetric plan trains GAT on the a2a exchange (``GatLayerGen``,
    the transposed layouts shipped); the ring on it still raises, as in the
    reference, and so do the levers GAT does not take."""
    plan = cora["plan"]
    setup = resolve_forward_setup(plan, model="gat")
    pa = setup.ship_arrays(plan, "cpu")
    params = port_gat.init_gat_params(torch.Generator().manual_seed(0),
                                      [(1433, 7)])
    st = dict(setup.fwd_static, comm_schedule="ragged")
    with pytest.raises(ValueError, match="asymmetric plans run the a2a"):
        gat_forward_local(params, torch.zeros(8, plan.b, 1433), pa,
                          symmetric=False, **st)
    a = cora["a"].tolil()
    a[0, 1], a[1, 0] = 1.0, 0.0
    asym = build_comm_plan(a.tocsr(), cora["pv"], 8)
    tr = FullBatchTrainer(asym, fin=1433, widths=WIDTHS, model="gat",
                          device="cpu")
    assert tr.model.fwd_static["symmetric"] is False
    assert tr.pa["ptile_tchw"].dtype == torch.int8 and "rev_csrc" in tr.pa
    data = make_train_data(asym, cora["feats"], cora["labels"])
    losses = [tr.step(data) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    # the wire-only lever is GCN's; GAT narrows through compute_dtype
    with pytest.raises(ValueError, match="GCN-trainer lever"):
        FullBatchTrainer(plan, fin=1433, widths=WIDTHS, model="gat",
                         device="cpu", halo_dtype="bfloat16")


# ------------------------------------------------- trainer vs reference
@pytest.fixture(scope="module")
def parity(cora):
    """Both trainers, 5 steps each from the reference's initial params, on
    cora2708 8-hp, GAT 1433 → 16 → 7 (fused, fused), no activation."""
    feats, labels = cora["feats"], cora["labels"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        mp.delenv("SGCN_GAT_FUSED", raising=False)
        kw = dict(fin=1433, widths=WIDTHS, seed=3, model="gat",
                  activation="none")
        ref0 = RefTrainer(cora["ref_plan"], **kw)
        assert ref0.plan_fields == ref_gat.GAT_PLAN_FIELDS_PALLAS
        p0 = _np_params(ref0.params)
        rdata = ref_make_train_data(cora["ref_plan"], feats, labels)
        rd = shard_stacked(ref0.mesh, vars(rdata))
        args = (ref0.pa, rd["h0"], rd["labels"], rd["train_valid"])
        specs = (P(), P("v"), P("v"), P("v"), P("v"))

        def chip_loss(params, pa, h0, lab, valid):
            pa, h0, lab, valid = _unblock((pa, h0, lab, valid))
            return ref0._loss_fn(ref0._forward(params, pa, h0), lab, valid)

        # the loss gradient: jax.grad of the whole mapped (replicated) loss
        loss_map = jax.shard_map(chip_loss, mesh=ref0.mesh, in_specs=specs,
                                 out_specs=P())
        ref_loss0, ref_grads = jax.jit(jax.value_and_grad(
            lambda ps: loss_map(ps, *args)))(ref0.params)

        # the trainer's own convention: per-chip grad, then lax.psum
        def chip_grads(params, pa, h0, lab, valid):
            g = jax.grad(chip_loss)(params, pa, h0, lab, valid)
            return jax.tree.map(lambda x: lax.psum(x, "v"), g)

        step_grads = _smap(ref0.mesh, chip_grads, specs, P())(
            ref0.params, *args)
        factor = float(np.linalg.norm(np.asarray(step_grads[0]["w"]))
                       / np.linalg.norm(np.asarray(ref_grads[0]["w"])))
        ref = RefTrainer(cora["ref_plan"], **kw, optimizer=optax.chain(
            optax.scale(1.0 / round(factor)), optax.adam(LR)))
        ref_losses = [ref.step(rdata) for _ in range(STEPS)]
        ref_report = ref.stats.report()
        ref_pred = ref.predict(rdata)

    tr = FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS, model="gat",
                          activation="none", lr=LR,
                          params=params_from_jax(p0), device="cpu")
    data = make_train_data(cora["plan"], feats, labels)
    grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: grads.append(
        [{k: v.grad.clone() for k, v in p.items()} for p in tr.params]))
    losses = [tr.step(data) for _ in range(STEPS)]
    return {
        "factor": factor, "ref_loss0": float(ref_loss0),
        "ref_grads": _np_params(ref_grads),
        "ref_losses": np.asarray(ref_losses),
        "ref_params": _np_params(ref.params),
        "ref_report": ref_report, "ref_pred": ref_pred,
        "grads": [{k: v.numpy() for k, v in p.items()} for p in grads[0]],
        "losses": np.asarray(losses),
        "params": [{k: v.detach().numpy() for k, v in p.items()}
                   for p in tr.params],
        "report": tr.stats.report(), "trainer": tr, "data": data,
    }


def test_reference_step_gradient_scale_is_measured(parity):
    """The reference GAT trainer's gradient scale (ROADMAP C3): its
    forward pcasts the params to varying before its explicit psum, so
    the factor is measured, not assumed — 1 or k = 8, a power of two."""
    print(f"reference GAT step gradient / loss gradient: "
          f"{parity['factor']!r}")
    assert round(parity["factor"]) in (1, 8)
    assert parity["factor"] == pytest.approx(round(parity["factor"]),
                                             rel=1e-5)


def test_first_step_gradients_match_reference(parity):
    """Step-1 gradients of ``w`` and ``a2``: relative Frobenius error
    ≤ 1e-5 per layer and rtol 1e-3 / atol 1e-7 per entry (observed
    ≤ 5.5e-7 relative); ``a1``'s is exactly 0 in both packages."""
    assert parity["losses"][0] == pytest.approx(parity["ref_loss0"],
                                                rel=1e-6)
    for i, (got, want) in enumerate(zip(parity["grads"],
                                        parity["ref_grads"])):
        assert not got["a1"].any() and not np.asarray(want["a1"]).any()
        for k in ("w", "a2"):
            rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            print(f"layer {i} d{k} {want[k].shape}: max |port - reference| "
                  f"{np.abs(got[k] - want[k]).max():.3g}, relative "
                  f"Frobenius {rel:.3g}")
            assert np.abs(want[k]).max() > 1e-4
            assert rel <= 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-7)


def test_losses_track_reference(parity):
    """Five losses within rtol 1e-5 (observed ≤ 5.1e-6), and falling."""
    rel = np.abs(parity["losses"] / parity["ref_losses"] - 1)
    print(f"GAT losses {parity['losses']}: max relative gap {rel.max():.3g}")
    np.testing.assert_allclose(parity["losses"], parity["ref_losses"],
                               rtol=1e-5)
    assert parity["losses"][-1] < parity["losses"][0]


def test_final_weights_track_reference(parity):
    """After five Adam steps: 99 % of the entries within 1e-5, every entry
    within 5e-3 (half of one step at lr 0.01; Adam divides by sqrt(v), so
    a near-zero gradient moves a weight a step-sized amount on a rounding
    difference).  ``a1`` never moves in either package."""
    for i, (got, want) in enumerate(zip(parity["params"],
                                        parity["ref_params"])):
        for k in ("w", "a1", "a2"):
            gap = np.abs(got[k] - want[k])
            print(f"layer {i} {k}: {np.mean(gap <= 1e-5):.4f} within 1e-5, "
                  f"max gap {gap.max():.3g}")
            assert np.mean(gap <= 1e-5) >= 0.99, gap.max()
            assert gap.max() <= 0.5 * LR
    tr = parity["trainer"]
    for p, p0 in zip(tr.params, params_from_jax(parity["ref_params"])):
        assert torch.equal(p["a1"].detach(), p0["a1"])


def test_comm_stats_equal_reference(parity):
    """Every key of the port's report equals the reference's, byte gauges
    included (``gat_exchange_lane_widths``: fout + 1 lanes per layer)."""
    rep, ref = parity["report"], parity["ref_report"]
    assert set(rep) <= set(ref)
    assert {k: rep[k] for k in rep} == {k: ref[k] for k in rep}
    assert rep["exchanges"] == STEPS * 2 * 2
    assert rep["halo_bytes_true_per_step"] == \
        rep["true_rows_per_exchange"] * (17 + 8) * 2 * 4


def test_served_rows_equal_predict_bitwise(parity, cora):
    """``ServeEngine(model='gat')`` with the trainer's weights serves the
    rows of the trainer's ``predict``, bit for bit (same forward), and
    those track the reference's ``predict`` (rtol 1e-4 / atol 1e-4: the
    Adam gaps of the test above)."""
    tr, data = parity["trainer"], parity["data"]
    pred = tr.predict(data)
    eng = ServeEngine(cora["plan"], fin=1433, widths=WIDTHS, model="gat",
                      params=tr.params, max_batch=16, device="cpu")
    assert eng.activation == "none"
    eng.set_features(cora["feats"])
    q = np.array([0, 7, 100, 2707, 1500])
    np.testing.assert_array_equal(eng.query(q), pred[q])
    np.testing.assert_allclose(pred, parity["ref_pred"], rtol=1e-4,
                               atol=1e-4)


def test_dense_gat_oracle_matches_reference(ahat):
    """The port's dense GAT oracle vs the reference's from the same params
    on the 48-vertex ER graph: three losses rtol 1e-5, predictions
    rtol 1e-4 / atol 1e-5; its own init is the trainer's for the same
    seed."""
    rng = np.random.default_rng(4)
    n = ahat.shape[0]
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    ref = RefGATOracle(ahat, 6, [8, 3], seed=2)
    port = DenseGATOracle(ahat, 6, [8, 3], params=_np_params(ref.params),
                          device="cpu")
    want = [ref.step(feats, labels, mask) for _ in range(3)]
    got = [port.step(feats, labels, mask) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(port.predict(feats), ref.predict(feats),
                               rtol=1e-4, atol=1e-5)
    again = DenseGATOracle(ahat, 6, [8, 3], seed=2, device="cpu")
    init = port_gat.init_gat_params(torch.Generator().manual_seed(2),
                                    [(6, 8), (8, 3)])
    for p, p0 in zip(again.params, init):
        assert all(torch.equal(p[k].detach(), p0[k]) for k in p0)


def test_oracle_tracks_partitioned_trainer(ahat):
    """The dense GAT oracle and the partitioned trainer from the same
    seed on the ER graph (4 random parts): five losses within rtol 1e-5."""
    n = ahat.shape[0]
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    plan = build_comm_plan(ahat, balanced_random_partition(n, 4, seed=3), 4)
    tr = FullBatchTrainer(plan, fin=12, widths=[8, 4], model="gat",
                          activation="none", seed=5, device="cpu")
    oracle = DenseGATOracle(ahat, 12, [8, 4], seed=5, device="cpu")
    data = make_train_data(plan, feats, labels)
    got = [tr.step(data) for _ in range(STEPS)]
    want = oracle.fit(feats, labels, epochs=STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------------ CLIs
def test_train_cli_runs_gat_in_process(capsys):
    train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "-l", "2", "--hidden", "16", "--epochs", "2",
                "--model", "gat", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-1])
    assert out[0].startswith("epoch 0: loss")
    assert rep["model"] == "gat" and rep["activation"] == "none"
    assert rep["device"] == "cpu" and rep["exchanges"] == 3 * 2 * 2
    assert rep["halo_bytes_true_per_step"] == \
        rep["true_rows_per_exchange"] * (17 + 8) * 2 * 4
    with pytest.raises(SystemExit, match="--model gcn"):
        train_main(["--npz", NPZ, "-p", HP8, "-s", "8", "--model", "gat",
                    "--experiment", "accuracy", "--device", "cpu"])


def test_serve_cli_runs_gat_in_process(capsys):
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "-l", "2", "--hidden", "16", "--model",
                "gat", "--queries", "24", "--max-batch", "8", "--buckets",
                "4,8", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["model"] == "gat" and rep["activation"] == "none"
    assert rep["queries"] == 24 and rep["widths"] == [16, 7]
    assert rep["device"] == "cpu" and rep["value"] > 0


def test_gat_entry_points_without_cpu_raise_when_no_gpu(cora):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS, model="gat")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cora["plan"], fin=1433, widths=WIDTHS, model="gat")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseGATOracle(cora["a"], 1433, WIDTHS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--npz", NPZ, "-p", HP8, "-s", "8", "--model", "gat"])
