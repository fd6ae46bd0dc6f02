"""The port's bf16 levers against the reference ``sgcn_tpu``'s.

``halo_dtype='bfloat16'`` narrows the exchange's wire only (GCN);
``compute_dtype='bfloat16'`` runs the forward and backward in bf16 with
float32 master weights (GCN, and GAT with its packed table form).  Same
inputs — cora2708 under its 8-part hp partition, tables and params from
numpy seeds or the reference's init — go through the reference (its kernel
path forced with ``SGCN_PALLAS_SPMM=1``, so ``spmm_pallas`` runs its exact
jnp emulation on the 8 virtual CPU devices of ``tests/conftest.py``; its
bf16 GAT runs on the ELL slot pass, which ``use_pallas_spmm`` keeps for
it) and through the port on the CPU, where the tile kernel is its plain
version.  Tolerances are stated per test.  As in
``tests/test_torch_train.py``, the reference trainer's gradient scale
(ROADMAP C3) is measured and divided out of its optimizer.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from sgcn_tpu.models import gat as ref_gat
from sgcn_tpu.ops.pallas_spmm import (PALLAS_PLAN_FIELDS,
                                      PALLAS_PLAN_FIELDS_RAGGED,
                                      _pspmm_pallas_once,
                                      _pspmm_pallas_ragged_once,
                                      pallas_ring_concat, spmm_pallas_classes)
from sgcn_tpu.ops.pspmm import halo_exchange as ref_halo_exchange
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.serve import ServeEngine as RefEngine
from sgcn_tpu.train.__main__ import main as ref_train_main
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.ops.pspmm import exchange_recv, halo_exchange, ring_concat
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                          TILE_PLAN_FIELDS_RAGGED,
                                          _pspmm_tiles_once,
                                          _pspmm_tiles_ragged_once,
                                          choose_tile_dispatch,
                                          spmm_tiles_classes)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]
STEPS = 5
LR = 0.01


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8),
            "mesh": make_mesh_1d(8)}


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def _unblock(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits): 2^(floor(log2|x|) − 7)."""
    _m, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def _tables(plan, f, seed):
    """A (k, b, f) table of bf16 values: as float32 numpy (exactly
    representable) and as a bf16 tensor."""
    t16 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (plan.k, plan.b, f)).astype(np.float32)).bfloat16()
    return t16.float().numpy(), t16


# ------------------------------------------------ (a) one aggregation, bf16
@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_aggregation_on_bf16_tables_matches_pallas_once(cora, schedule):
    """``_pspmm_tiles_once`` / ``_pspmm_tiles_ragged_once`` on a bf16 table
    vs ``_pspmm_pallas_once`` / ``_pspmm_pallas_ragged_once`` (emulated
    kernel) on the same values: the float32 ``local + remote`` within C2's
    rtol 1e-6 / atol 1e-7, and the bf16 result within one bf16 ulp (the
    two float32 sums round to bf16 apart only where they straddle a
    rounding boundary)."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, schedule=schedule)
    lcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_lclasses"])
    hcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_hclasses"])
    ragged = schedule == "ragged"
    pfields = TILE_PLAN_FIELDS_RAGGED if ragged else TILE_PLAN_FIELDS
    rfields = PALLAS_PLAN_FIELDS_RAGGED if ragged else PALLAS_PLAN_FIELDS
    # the port's fields are the reference's with the exchange arrays
    # replaced by the receive layout's flat sources
    assert pfields[1:] == tuple(
        {"ptile_hsrc": "ptile_hwsrc"}.get(f, f) for f in rfields[-6:])
    pa_np = [np.ascontiguousarray(getattr(plan, f)) for f in rfields]
    pa = [torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in pfields]
    h_np, h16 = _tables(plan, 16, seed=7)

    def per_chip(h, *a):
        h, a = h[0].astype(jnp.bfloat16), [x[0] for x in a]
        if ragged:
            ring = pallas_ring_concat(h, a[0], plan.rr_sizes, "v")
            tabs = ((a[1:4], h, lcls), (a[4:7], ring, hcls))
            once = _pspmm_pallas_ragged_once(h, *a, 256, lcls, hcls,
                                             plan.rr_sizes, True, "v")
        else:
            halo = ref_halo_exchange(h, a[0], a[1], "v")
            tabs = ((a[2:5], h, lcls), (a[5:8], halo, hcls))
            once = _pspmm_pallas_once(h, *a, 256, lcls, hcls, True, "v")
        local, remote = (spmm_pallas_classes(
            s, ld, w.astype(jnp.float32), t, cls, 256, emulate=True,
            vma=("v",))[:h.shape[0]] for (s, ld, w), t, cls in tabs)
        return (local + remote)[None], once.astype(jnp.float32)[None]

    want32, want16 = (np.asarray(x) for x in _smap(
        cora["mesh"], per_chip, (P("v"),) * (1 + len(pa_np)),
        (P("v"), P("v")))(h_np, *pa_np))
    if ragged:
        remote = ring_concat(h16, pa[0], plan.rr_sizes)
        got16 = _pspmm_tiles_ragged_once(h16, *pa, 256, st["pallas_lclasses"],
                                         st["pallas_hclasses"],
                                         plan.rr_sizes)
    else:
        remote = exchange_recv(h16, pa[0])
        got16 = _pspmm_tiles_once(h16, *pa, 256, st["pallas_lclasses"],
                                  st["pallas_hclasses"])
    tabs = ((pa[1:4], h16), (pa[4:7], remote))
    local, remote = (spmm_tiles_classes(*t, tab, cls, 256)[:, :plan.b]
                     for (t, tab), cls in zip(tabs, (st["pallas_lclasses"],
                                                     st["pallas_hclasses"])))
    got32 = (local + remote).numpy()
    assert got16.dtype == torch.bfloat16 and local.dtype == torch.float32
    print(f"{schedule}: f32 sum max |port - reference| "
          f"{np.abs(got32 - want32).max():.3g}")
    np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=1e-7)
    got16 = got16.float().numpy()
    gap = np.abs(got16 - want16)
    print(f"{schedule}: bf16 result differs in {np.mean(gap > 0):.2e} of "
          "entries")
    assert (gap <= _bf16_ulp(np.maximum(np.abs(got16), np.abs(want16)))
            ).all()


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_aggregation_on_bf16_wire_matches_pallas_once(cora, schedule):
    """``halo_dtype='bfloat16'`` on a float32 table: the port's one
    aggregation vs the reference's with the same ``halo_dtype``, within
    C2's rtol 1e-6 / atol 1e-7 (both round the wire to nearest-even, so
    the halo rows are equal and only the kernel's sums differ)."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, schedule=schedule)
    lcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_lclasses"])
    hcls = tuple((t, e, "vmem") for t, e, _ in st["pallas_hclasses"])
    ragged = schedule == "ragged"
    fields = TILE_PLAN_FIELDS_RAGGED if ragged else TILE_PLAN_FIELDS
    rfields = PALLAS_PLAN_FIELDS_RAGGED if ragged else PALLAS_PLAN_FIELDS
    pa_np = [np.ascontiguousarray(getattr(plan, f)) for f in rfields]
    h = np.random.default_rng(8).standard_normal(
        (plan.k, plan.b, 16)).astype(np.float32)

    def per_chip(h, *a):
        a = [x[0] for x in a]
        if ragged:
            return _pspmm_pallas_ragged_once(
                h[0], *a, 256, lcls, hcls, plan.rr_sizes, True, "v",
                jnp.bfloat16)[None]
        return _pspmm_pallas_once(h[0], *a, 256, lcls, hcls, True, "v",
                                  jnp.bfloat16)[None]

    want = np.asarray(_smap(cora["mesh"], per_chip,
                            (P("v"),) * (1 + len(pa_np)), P("v"))(h, *pa_np))
    args = (torch.from_numpy(h),
            *(torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
              for f in fields), 256,
            st["pallas_lclasses"], st["pallas_hclasses"])
    if ragged:
        got = _pspmm_tiles_ragged_once(*args, plan.rr_sizes, "bfloat16")
        f32 = _pspmm_tiles_ragged_once(*args, plan.rr_sizes)
    else:
        got = _pspmm_tiles_once(*args, "bfloat16")
        f32 = _pspmm_tiles_once(*args)
    assert got.dtype == torch.float32
    got = got.numpy()
    print(f"{schedule} bf16 wire: max |port - reference| "
          f"{np.abs(got - want).max():.3g}; wire vs f32 "
          f"{np.abs(got - f32.numpy()).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(got, f32.numpy())   # the wire did narrow


# ---------------------------------------------------- (b) the exchanges
@pytest.mark.parametrize("width", [16, 7])
def test_halo_exchange_and_ring_with_halo_dtype_equal_reference(cora, width):
    """``halo_exchange`` and ``ring_concat`` with ``halo_dtype='bfloat16'``
    vs the reference's ``halo_exchange`` and ``pallas_ring_concat`` with
    the same wire, per chip: equal, bit for bit.  The halo rows keep the
    input's float32 dtype; the ring concat stays on the bf16 wire (the
    tile kernel reads it in place), and its exact upcast is the
    reference's."""
    plan = cora["plan"]
    plan.ensure_ragged()
    plan.ensure_exchange()
    recv, hflat, ring = (torch.from_numpy(getattr(plan, f)) for f in
                         ("recv_src", "halo_src_flat", "ring_src"))
    h = np.random.default_rng(9).standard_normal(
        (plan.k, plan.b, width)).astype(np.float32)
    sidx, hsrc, rsend = (np.ascontiguousarray(getattr(plan, f))
                         for f in ("send_idx", "halo_src", "rsend_idx"))

    def per_chip(h, sidx, hsrc, rsend):
        h, sidx, hsrc, rsend = _unblock((h, sidx, hsrc, rsend))
        return (ref_halo_exchange(h, sidx, hsrc, "v", jnp.bfloat16)[None],
                pallas_ring_concat(h, rsend, plan.rr_sizes, "v",
                                   jnp.bfloat16)[None])

    want_h, want_r = (np.asarray(x) for x in _smap(
        cora["mesh"], per_chip, (P("v"),) * 4, (P("v"), P("v")))(
            h, sidx, hsrc, rsend))
    ht = torch.from_numpy(h)
    got_h = halo_exchange(ht, recv, hflat, "bfloat16")
    got_r = ring_concat(ht, ring, plan.rr_sizes, halo_dtype=torch.bfloat16)
    assert got_h.dtype == torch.float32 and got_r.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_r.float().numpy(), want_r)
    assert not np.array_equal(got_h.numpy(),
                              halo_exchange(ht, recv, hflat).numpy())
    with pytest.raises(ValueError, match="bfloat16"):
        halo_exchange(ht, recv, hflat, "float16")


# ------------------------------------------------ (c, e, f) the trainers
def _scaled_reference(ref_plan, kw, feats, labels, factor):
    """The reference trainer with ``optax.scale(1/factor)`` before Adam
    (ROADMAP C3): ``STEPS`` losses, its report and final params."""
    ref = RefTrainer(ref_plan, **kw, optimizer=optax.chain(
        optax.scale(1.0 / round(factor)), optax.adam(LR)))
    rdata = ref_make_train_data(ref_plan, feats, labels)
    losses = [ref.step(rdata) for _ in range(STEPS)]
    return ref, np.asarray(losses), ref.stats.report()


def _measure_factor(ref_plan, kw, feats, labels):
    """The reference trainer's step gradient over ``jax.grad`` of the
    whole mapped loss (first layer's weight, Frobenius ratio)."""
    ref0 = RefTrainer(ref_plan, **kw)
    rdata = ref_make_train_data(ref_plan, feats, labels)
    rd = shard_stacked(ref0.mesh, vars(rdata))
    args = (ref0.pa, rd["h0"], rd["labels"], rd["train_valid"])
    specs = (P(), P("v"), P("v"), P("v"), P("v"))

    def chip_loss(params, pa, h0, lab, valid):
        pa, h0, lab, valid = _unblock((pa, h0, lab, valid))
        return ref0._loss_fn(ref0._forward(params, pa, h0), lab, valid)

    loss_map = jax.shard_map(chip_loss, mesh=ref0.mesh, in_specs=specs,
                             out_specs=P())
    grads = jax.jit(jax.grad(lambda ps: loss_map(ps, *args)))(ref0.params)

    def chip_grads(params, pa, h0, lab, valid):
        g = jax.grad(chip_loss)(params, pa, h0, lab, valid)
        return jax.tree.map(lambda x: lax.psum(x, "v"), g)

    step = _smap(ref0.mesh, chip_grads, specs, P())(ref0.params, *args)
    leaf = (lambda g: g[0]["w"]) if kw.get("model") == "gat" else \
        (lambda g: g[0])
    return ref0, float(np.linalg.norm(np.asarray(leaf(step)))
                       / np.linalg.norm(np.asarray(leaf(grads))))


@pytest.fixture(scope="module")
def gcn_runs(cora):
    """Reference and port GCN trainers, 1433 → 16 → 7, 5 steps each from
    the reference's initial weights, under ``halo_dtype`` and under
    ``compute_dtype``."""
    feats, labels = cora["feats"], cora["labels"]
    kw = dict(fin=1433, widths=WIDTHS, seed=3)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        ref0, factor = _measure_factor(cora["ref_plan"], kw, feats, labels)
        assert ref0.plan_fields == PALLAS_PLAN_FIELDS   # kernel path taken
        p0 = [np.asarray(w) for w in ref0.params]
        for lever in ("halo_dtype", "compute_dtype"):
            ref, ref_losses, ref_report = _scaled_reference(
                cora["ref_plan"], {**kw, lever: "bfloat16"}, feats, labels,
                factor)
            out[lever] = {"ref_losses": ref_losses, "ref_report": ref_report,
                          "ref_params": [np.asarray(w) for w in ref.params]}
    data = make_train_data(cora["plan"], feats, labels)
    for lever in ("halo_dtype", "compute_dtype", None):
        tr = FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS, lr=LR,
                              params=port_gcn.params_from_jax(p0),
                              device="cpu",
                              **({lever: "bfloat16"} if lever else {}))
        losses = np.asarray([tr.step(data) for _ in range(STEPS)])
        out.setdefault(lever, {}).update(
            losses=losses, report=tr.stats.report(),
            params=[w.detach().numpy() for w in tr.params])
    out["factor"] = factor
    return out


def test_reference_factor_is_measured(gcn_runs):
    assert round(gcn_runs["factor"]) in (1, 8)


def test_gcn_halo_dtype_losses_track_reference(gcn_runs):
    """Five losses under ``halo_dtype`` within rtol 1e-5, the port's f32
    port-vs-reference bound (``tests/test_torch_train.py``): only the wire
    is bf16, rounded the same way on both sides.  They differ from the
    float32 run's, so the wire did narrow."""
    run = gcn_runs["halo_dtype"]
    rel = np.abs(run["losses"] / run["ref_losses"] - 1)
    print(f"halo_dtype losses: max relative gap {rel.max():.3g}")
    np.testing.assert_allclose(run["losses"], run["ref_losses"], rtol=1e-5)
    assert not np.array_equal(run["losses"], gcn_runs[None]["losses"])
    assert run["losses"][-1] < run["losses"][0]


def test_gcn_compute_dtype_losses_track_reference(gcn_runs):
    """Five losses under ``compute_dtype`` within rtol 2e-3 of the
    reference's (observed max relative gap 4.0e-5: torch and XLA round
    their bf16 matmuls apart, and a bf16 aggregation rounds a float32 sum
    whose order may differ in the last bit), and within the reference's
    own bf16 band (rtol 0.05 / atol 0.02) of the port's float32 run."""
    run = gcn_runs["compute_dtype"]
    rel = np.abs(run["losses"] / run["ref_losses"] - 1)
    print(f"compute_dtype losses: max relative gap {rel.max():.3g}; "
          f"{run['losses']} vs {run['ref_losses']}")
    np.testing.assert_allclose(run["losses"], run["ref_losses"], rtol=2e-3)
    np.testing.assert_allclose(run["losses"], gcn_runs[None]["losses"],
                               rtol=0.05, atol=0.02)
    assert not np.array_equal(run["losses"], gcn_runs[None]["losses"])
    for got, want in zip(run["params"], run["ref_params"]):
        assert got.dtype == np.float32          # float32 master weights
        assert np.abs(got - want).max() <= 0.5 * LR * STEPS


@pytest.mark.parametrize("lever", ["halo_dtype", "compute_dtype"])
def test_gcn_comm_stats_equal_reference(gcn_runs, lever):
    """Every key of the port's report equals the reference's under each
    lever: both book the GCN wire at 2 bytes a lane, both directions."""
    rep, ref = gcn_runs[lever]["report"], gcn_runs[lever]["ref_report"]
    assert {k: rep[k] for k in rep} == {k: ref[k] for k in rep}
    assert rep["halo_bytes_wire_per_step"] * 2 == \
        gcn_runs[None]["report"]["halo_bytes_wire_per_step"]


@pytest.fixture(scope="module")
def gat_run(cora):
    """Reference and port GAT trainers under ``compute_dtype='bfloat16'``,
    1433 → 16 → 7 (layer 0 packed, layer 1 the odd-width fused bf16
    table), 5 steps each from the reference's initial params."""
    feats, labels = cora["feats"], cora["labels"]
    kw = dict(fin=1433, widths=WIDTHS, seed=3, model="gat",
              activation="none")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        mp.delenv("SGCN_GAT_FUSED", raising=False)
        ref0, factor = _measure_factor(cora["ref_plan"], kw, feats, labels)
        p0 = [{k: np.asarray(v) for k, v in p.items()} for p in ref0.params]
        ref, ref_losses, ref_report = _scaled_reference(
            cora["ref_plan"], {**kw, "compute_dtype": "bfloat16"}, feats,
            labels, factor)
        assert ref.plan_fields == ref_gat.GAT_PLAN_FIELDS   # the slot pass
    data = make_train_data(cora["plan"], feats, labels)
    out = {"factor": factor, "ref_losses": ref_losses,
           "ref_report": ref_report}
    for dt in ("bfloat16", None):
        tr = FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS,
                              model="gat", activation="none", lr=LR,
                              params=port_gat.params_from_jax(p0),
                              device="cpu", compute_dtype=dt)
        out[dt] = {"losses": np.asarray([tr.step(data)
                                         for _ in range(STEPS)]),
                   "report": tr.stats.report()}
    return out


def test_gat_bf16_losses_track_reference(gat_run):
    """GAT under bf16 compute, packed (16) and odd fused (7) layers: five
    losses within rtol 2e-3 of the reference's (observed max relative gap
    1.1e-4: the reference sums its in-edges in its ELL bucket order, the
    port in its tiles' order, both in float32 of the same bf16 values,
    and the bf16 matmuls round apart), and within
    the reference's GAT bf16 band (rtol 0.05 / atol 0.03,
    ``tests/test_gat.py``) of the port's float32 run."""
    assert round(gat_run["factor"]) in (1, 8)
    got, want = gat_run["bfloat16"]["losses"], gat_run["ref_losses"]
    rel = np.abs(got / want - 1)
    print(f"GAT bf16 losses: max relative gap {rel.max():.3g}; {got} vs "
          f"{want}")
    np.testing.assert_allclose(got, want, rtol=2e-3)
    np.testing.assert_allclose(got, gat_run[None]["losses"], rtol=0.05,
                               atol=0.03)
    assert not np.array_equal(got, gat_run[None]["losses"])
    assert got[-1] < got[0]


def test_gat_bf16_comm_stats_equal_reference(gat_run):
    """The GAT report under bf16 compute equals the reference's: the
    lanes encode the dtype (packed 16/2 + 1, odd (7 + 1)/2) at 4 bytes."""
    rep, ref = gat_run["bfloat16"]["report"], gat_run["ref_report"]
    assert {k: rep[k] for k in rep} == {k: ref[k] for k in rep}
    assert port_gat.gat_exchange_lane_widths(WIDTHS, "bfloat16") == [9, 4]


# ------------------------------------------------------ (d) the packing
def test_pack_rows_words_equal_reference():
    """``_pack_rows`` gives the reference's float32 words bit for bit
    (compared as uint32), and ``_unpack_rows`` inverts it — also on a
    strided slice of a wider word table, as the exchange's halo rows
    arrive."""
    x16 = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (6, 16)).astype(np.float32)).bfloat16()
    want = np.asarray(ref_gat._pack_rows(
        jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16)))
    got = port_gat._pack_rows(x16)
    assert got.dtype == torch.float32 and got.shape == (6, 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(port_gat._unpack_rows(got), x16)
    wide = torch.cat([got, torch.ones(6, 1)], dim=-1)
    assert torch.equal(port_gat._unpack_rows(wide[:, :8]), x16)


def test_table_forms_and_lane_widths_under_bf16(monkeypatch):
    """``gat_table_form`` and ``gat_exchange_lane_widths`` under bf16
    compute equal the reference's (packed for even widths)."""
    monkeypatch.delenv("SGCN_GAT_FUSED", raising=False)
    for fout in (1, 7, 16, 40, 126, 127, 128, 129, 256):
        for dt in ("bfloat16", None):
            assert port_gat.gat_table_form(fout, dt) == \
                ref_gat.gat_table_form(fout, dt), (fout, dt)
    widths = [128, 127, 40, 7]
    assert port_gat.gat_exchange_lane_widths(widths, "bfloat16") == \
        ref_gat.gat_exchange_lane_widths(widths, "bfloat16")


# ------------------------------------------------- (g) ragged == a2a
@pytest.mark.parametrize("model,lever", [("gcn", "halo_dtype"),
                                         ("gcn", "compute_dtype"),
                                         ("gat", "compute_dtype")])
def test_ragged_equals_a2a_bitwise_under_each_lever(cora, model, lever):
    """Three training steps on the ring == on a2a, bit for bit (losses and
    every weight), for each model under each of its bf16 levers; GAT
    1433 → 16 → 7 covers the packed and the odd fused bf16 forms."""
    feats, labels = cora["feats"], cora["labels"]
    data = make_train_data(cora["plan"], feats, labels)
    runs = {}
    for sched in ("a2a", "ragged"):
        tr = FullBatchTrainer(cora["plan"], fin=1433, widths=WIDTHS, seed=6,
                              model=model, device="cpu", comm_schedule=sched,
                              activation="relu" if model == "gcn" else "none",
                              **{lever: "bfloat16"})
        losses = [tr.step(data) for _ in range(3)]
        runs[sched] = (losses, [p.detach().clone()
                                for p in tr.model.parameters()])
    assert runs["a2a"][0] == runs["ragged"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["a2a"][1],
                                                 runs["ragged"][1]))


def test_gat_layer_bf16_forms_take_bf16_tables(cora):
    """Under bf16 compute the GAT layer feeds the kernel what the
    reference's forms hold: the packed layer a bf16 feature table and a
    float32 ``u`` table; the odd fused layer one bf16 ``(fout+1)`` table
    (not silently promoted, as ``tests/test_gat.py`` asserts of the
    reference); the backward's packed tables bf16 and float32, its fused
    table float32."""
    plan = cora["plan"]
    setup_st = choose_tile_dispatch(plan, model="gat")
    seen = []
    orig = port_gat.gat_tiles_pass

    def recording(csrc, cld, cw, table, cclasses, tb, num_rows):
        seen.append((table.dtype, table.shape[-1]))
        return orig(csrc, cld, cw, table, cclasses, tb, num_rows)

    pa = {f: torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
          for f in port_gat.GAT_PLAN_FIELDS_PALLAS}
    pa["ptile_cw"] = (pa["ptile_cw"] != 0).to(torch.int8)
    params = port_gat.init_gat_params(torch.Generator().manual_seed(0),
                                      [(1433, 16), (16, 7)])
    for p in params:
        for v in p.values():
            v.requires_grad_()
    h0 = torch.from_numpy(plan.scatter_rows(cora["feats"]))
    port_gat.gat_tiles_pass = recording
    try:
        out = port_gat.gat_forward_local(params, h0, pa,
                                         compute_dtype="bfloat16",
                                         **setup_st)
        out.square().sum().backward()
    finally:
        port_gat.gat_tiles_pass = orig
    bf, f32 = torch.bfloat16, torch.float32
    assert out.dtype == f32
    assert seen == [(bf, 16), (f32, 1), (bf, 8),       # forward 0, 1
                    (f32, 8), (bf, 16), (f32, 1)]      # backward 1, 0
    assert all(v.grad.dtype == f32 for p in params for v in p.values())


# ------------------------------------------------------ serving, wire only
def test_serve_engine_halo_dtype_matches_reference_engine(cora, monkeypatch):
    """``ServeEngine(halo_dtype='bfloat16')`` vs the reference engine with
    the same lever and weights: rows within rtol 1e-4 / atol 1e-5 (the f32
    serving bound; only the wire is bf16), the ring's rows equal the a2a
    engine's bit for bit, and GAT refuses the lever as the reference's
    engine does."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "1")
    feats = cora["feats"]
    dims = [(1433, 16), (16, 7)]
    params = [np.asarray(w) for w in port_gcn.init_gcn_params(
        torch.Generator().manual_seed(1), dims)]
    ref = RefEngine(cora["ref_plan"], fin=1433, widths=WIDTHS, params=params,
                    max_batch=32, buckets=(32,), halo_dtype="bfloat16")
    ref.set_features(feats)
    q = np.arange(0, 2708, 97)
    want = ref.query(q)
    rows = {}
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(cora["plan"], fin=1433, widths=WIDTHS,
                          params=params, max_batch=32, buckets=(32,),
                          comm_schedule=sched, halo_dtype="bfloat16",
                          device="cpu")
        eng.set_features(feats)
        rows[sched] = eng.query(q)
        assert eng.gauges()["halo_dtype"] == "bfloat16"
    print(f"served rows: max |port - reference| "
          f"{np.abs(rows['a2a'] - want).max():.3g}")
    np.testing.assert_allclose(rows["a2a"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(rows["a2a"], rows["ragged"])
    with pytest.raises(ValueError, match="GCN wire lever"):
        ServeEngine(cora["plan"], fin=1433, widths=WIDTHS, model="gat",
                    halo_dtype="bfloat16", device="cpu")


# ----------------------------------------------------- (h) the CLI guards
def _ref_exit(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu.train"] + argv)
    with pytest.raises(SystemExit) as exc:
        ref_train_main()
    return exc.value.code


@pytest.mark.parametrize("extra", [
    ["--halo-dtype", "bfloat16", "--dtype", "bfloat16"],
    ["--halo-dtype", "bfloat16", "--model", "gat"],
    ["--halo-dtype", "bfloat16", "--experiment", "accuracy"],
    ["--dtype", "bfloat16", "--experiment", "accuracy"]])
def test_cli_flag_guards_exit_as_reference(extra, monkeypatch):
    """The train CLI's precision flag conflicts exit, before any data
    load, with the reference CLI's message."""
    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8"]
    want = _ref_exit(base + extra, monkeypatch)
    with pytest.raises(SystemExit) as exc:
        train_main(base + extra + ["--device", "cpu"])
    assert isinstance(want, str) and exc.value.code == want


@pytest.mark.parametrize("flags", [["--dtype", "bfloat16"],
                                   ["--halo-dtype", "bfloat16"],
                                   ["--dtype", "bfloat16", "--model", "gat"]])
def test_cli_trains_with_precision_flags(flags, capsys):
    """The train CLI in-process on the CPU with each precision flag: the
    report names the lever, and the GCN wire bytes halve under either."""
    import json

    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "--hidden",
            "16", "--epochs", "2", "--device", "cpu"]
    train_main(base + flags)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["dtype"] == (flags[1] if flags[0] == "--dtype" else None)
    assert rep["halo_dtype"] == (flags[1] if flags[0] == "--halo-dtype"
                                 else None)
    lanes = (port_gat.gat_exchange_lane_widths(WIDTHS, "bfloat16")
             if "gat" in flags else [16, 16])
    assert rep["halo_bytes_true_per_step"] == (
        rep["true_rows_per_exchange"] * sum(lanes) * 2
        * (4 if "gat" in flags else 2))


def test_serve_cli_takes_halo_dtype(capsys):
    """``python -m sgcn_tpu_torch.serve --halo-dtype bfloat16`` in-process
    on the CPU: the report names the wire dtype; any other value is an
    argparse error, as in the reference CLI."""
    import json

    # one layer, one bucket: two forwards of the plain tile loop, which
    # slows badly on a loaded CPU
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "-l", "1", "--queries", "8", "--max-batch",
                "8", "--buckets", "8", "--halo-dtype", "bfloat16",
                "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["halo_dtype"] == "bfloat16" and rep["queries"] == 8
    assert rep["forwards"] == 2
    with pytest.raises(SystemExit) as exc:
        serve_main(["-p", HP8, "-s", "8", "--random-init", "--halo-dtype",
                    "float16"])
    assert exc.value.code == 2
