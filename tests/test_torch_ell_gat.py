"""The GAT's ELL slot passes (``SGCN_PALLAS_SPMM=0``) against the reference.

The reference's default GAT aggregator (``sgcn_tpu/models/gat.py``:
``_mask_slot_pass``, ``_pair_slot_pass``, ``_packed_aggregate`` over the
combined-edge bucketed layout, ``gat_layer_sym`` / ``gat_layer_local``)
runs per chip on the 8 virtual CPU devices of ``tests/conftest.py``; the
port's (``sgcn_tpu_torch/models/gat.py::GatLayerEll``) over the stacked
parts on the CPU.  Same plan, inputs and cotangents, made from a seed
with numpy.  These tests hold:

  * the ``'cell'`` / ``'cell_t'`` chain layouts against ``cell_*`` /
    ``ctail_*`` / ``edge_*``, which stay the reference's;
  * each slot pass per table form (fused at fout 16 and 7, split at 16,
    packed bf16 at 16), on both transports and on a plan with a hub tail,
    against the reference's function: bit for bit where the ops are the
    same (fused, packed, split's numerator), the split denominator's gap
    measured (the reference gathers a 128-lane broadcast of ``u`` and
    sums it, the port gathers ``u``);
  * a layer's forward and gradients (symmetric at fout 16 and the split
    fout 128, both transports; the directed layer against
    ``gat_layer_local``) within rtol 1e-5 / atol 1e-6 of the reference,
    and against float64 autograd of the same forward to rtol 1e-9 /
    atol 1e-12;
  * 3 trainer steps against the reference's trainer (``optax.scale(1/8)``,
    ROADMAP C3), the packed bf16 directed gradient against float64
    (ROADMAP C5); ring == a2a, run == run and remat == plain bit for bit;
    ELL against the port's tile GAT; no K1, K5 or fused call, and the
    tile path's packs;
  * the full-mode server against the reference trainer's ``predict`` (the
    rows its ``evaluate()`` scores), the step events' wire bytes against
    ``CommStats``, and the memory model's GAT slot temps and budget gate.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.obs import RunRecorder, load_run
from sgcn_tpu_torch.obs.memory import MemoryBudgetError
from sgcn_tpu_torch.ops import pspmm as ops
from sgcn_tpu_torch.ops import tile_spmm
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)

ref_gat = importlib.import_module("sgcn_tpu.models.gat")
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
WIDTHS = [16, 7]
LR = 0.01
TOL = dict(rtol=1e-5, atol=1e-6)
TOL64 = dict(rtol=1e-9, atol=1e-12)


def _cora_directed(a):
    """cora2708 with each undirected edge kept in one direction, which one
    by a coin from ``default_rng(0)`` (``tests/test_torch_ell.py``)."""
    import scipy.sparse as sp

    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    rows = np.where(flip, up.col, up.row)
    cols = np.where(flip, up.row, up.col)
    return sp.csr_matrix((np.ones(up.nnz, np.float32), (rows, cols)),
                         shape=a.shape)


@pytest.fixture(scope="module")
def cora():
    """cora2708 8-hp, its ``row_order='id'`` plan (one combined bucket
    and a hub tail) and the directed cora, each as (port, reference)."""
    a, feats, labels = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    out = {"feats": feats, "labels": labels, "pv": pv, "a": a,
           "mesh": make_mesh_1d(8)}
    for name, g, kw in (("sym", a, {}), ("id", a, {"row_order": "id"}),
                        ("dir", _cora_directed(a), {})):
        out[name] = (build_comm_plan(normalize_adjacency(g), pv, 8, **kw),
                     ref_build_comm_plan(ref_normalize(g), pv, 8, **kw))
        for plan in out[name]:
            plan.ensure_cell()
            plan.ensure_ragged()
    assert out["sym"][0].ctail_nnz.sum() == 0          # no hub tail
    assert out["id"][0].ctail_nnz.sum() > 0            # a hub tail
    assert not out["dir"][0].symmetric
    return out


def _setup(plan, sched, monkeypatch):
    """The trainer's ELL setup of ``plan`` on ``sched``: the shipped
    tensors and the forward's static kwargs."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    setup = resolve_forward_setup(plan, model="gat", comm_schedule=sched)
    assert setup.aggregator == "ell"
    return setup.ship_arrays(plan, "cpu"), setup.fwd_static


def _static(fwd):
    return {"ell_layout": fwd["ell_layout"], "ell_buckets": fwd["ell_buckets"],
            "ell_levels": fwd["ell_levels"], "halo_r": fwd["halo_r"],
            "rr_sizes": fwd.get("rr_sizes")}


def _chip(mesh, fn, arrays, nout):
    """``fn(*chip_arrays) -> (out, ...)`` per chip under shard_map, every
    array stacked on a leading ``k`` axis; the outputs stacked back to
    ``(k, ...)`` numpy."""
    def chip(*xs):
        xs = jax.tree.map(lambda v: v[0], xs)
        return tuple(o[None] for o in fn(*xs))

    f = jax.jit(jax.shard_map(chip, mesh=mesh,
                              in_specs=(P("v"),) * len(arrays),
                              out_specs=(P("v"),) * nout))
    return [np.asarray(o, np.float32) for o in f(
        *[shard_stacked(mesh, x) for x in arrays])]


def _gap(name, got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want)
    print(f"{name}: max |port - reference| {gap.max():.3g}, "
          f"{np.mean(gap == 0):.4f} equal")
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)
    return float(gap.max())


# ------------------------------------------------------------- the layout
@pytest.mark.parametrize("graph", ["sym", "id", "dir"])
def test_cell_chains_match_their_definitions(cora, graph):
    """``'cell'``: every slot's source and mask are ``cell_idx`` /
    ``cell_w != 0`` at ``p·(B + R)`` (pad slots kept), the hub tail's
    chains hold every true tail edge; on the directed plan ``'cell_t'``'s
    transposed chains hold every combined edge once, local sources at
    their rows and halo sources at their receive slots.  The reference's
    ``cell_*`` arrays are not touched."""
    port, ref = cora[graph]
    layout = "cell" if port.symmetric else "cell_t"
    port.ensure_ell_chains(layout)
    ch = port.ell_chains[layout]
    k, b, rows = port.k, port.b, port.b + port.r
    np.testing.assert_array_equal(port.cell_idx, ref.cell_idx)
    off = 0
    for nb, wb in port.cell_buckets:
        blk = ch["cell_src"][off * k: (off + nb * wb) * k].reshape(wb, k, nb)
        msk = ch["cell_m"][off * k: (off + nb * wb) * k].reshape(wb, k, nb)
        for p in range(k):
            want = port.cell_idx[p, off: off + nb * wb].reshape(wb, nb)
            np.testing.assert_array_equal(blk[:, p] - p * rows, want)
            np.testing.assert_array_equal(
                msk[:, p], port.cell_w[p, off: off + nb * wb]
                .reshape(wb, nb) != 0)
        off += nb * wb
    assert sum(ch["chub_levels"]) == int(port.ctail_nnz.sum())
    assert set(np.unique(ch["chub_w"])) <= {1.0}
    if layout == "cell_t":
        nt = sum(ch["cl_t_levels"]) + sum(ch["ch_t_levels"])
        assert nt == int(port.nnz.sum())
        assert ch["cl_t_dst"].max() < k * b
        assert ch["ch_t_dst"].max() < k * k * port.s
        assert sum(ch["owner_levels"]) == int(port.send_counts.sum())


# ------------------------------------------------------- the slot passes
def _pass_inputs(plan, fout, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((plan.k, plan.b, fout)).astype(np.float32)
    s = rng.uniform(0.05, 1.0, (plan.k, plan.b)).astype(np.float32)
    return p, s


def _ref_pass(ref, form, fout, sched):
    """The reference's slot pass of ``form`` per chip, from the
    exchange on: ``fn(send, halo, cell arrays..., p, s) -> (N, D)``."""
    comm = (ref_gat.COMM_A2A if sched == "a2a"
            else ("ragged", tuple(ref.rr_sizes), int(ref.r)))
    buckets = ref.cell_buckets

    def fn(send, halo, ci, cw, td, ts, tw, p, s):
        b = p.shape[0]
        cells = (ci, cw, td, ts, tw)
        if form == "fused":
            table = jnp.concatenate([p, s[:, None]], axis=-1)
            full = jnp.concatenate([table, ref_gat._exchange_table(
                table, send, halo, "v", comm)])
            return ref_gat._mask_slot_pass(full, fout, *cells, buckets, b)
        if form == "split":
            fp, fu = ref_gat._exchange_rows_scalar(p, s, send, halo, "v",
                                                   comm)
            return ref_gat._pair_slot_pass(fp, fu, fout, *cells, buckets, b)
        return ref_gat._packed_aggregate(p.astype(jnp.bfloat16), s, fout,
                                         send, halo, *cells, buckets, b,
                                         "v", comm)
    ex = ("send_idx", "halo_src") if sched == "a2a" else ("rsend_idx",
                                                         "rhalo_dst")
    arrays = [getattr(ref, f) for f in ex + (
        "cell_idx", "cell_w", "ctail_dst", "ctail_src", "ctail_w")]
    return fn, arrays


# form, fout, transport, graph
PASSES = {
    "fused-16-a2a": ("fused", 16, "a2a", "sym"),
    "fused-7-ring": ("fused", 7, "ragged", "sym"),
    "fused-16-tail": ("fused", 16, "a2a", "id"),
    "split-16-a2a": ("split", 16, "a2a", "sym"),
    "split-16-tail-ring": ("split", 16, "ragged", "id"),
    "packed-16-a2a": ("packed", 16, "a2a", "sym"),
    "packed-16-tail-ring": ("packed", 16, "ragged", "id"),
}


@pytest.mark.parametrize("case", list(PASSES))
def test_slot_pass_matches_the_reference(cora, case, monkeypatch):
    """One slot pass per table form, transport and plan against the
    reference's function per chip: the numerator and the fused / packed
    denominator bit for bit (the same gathers, mask products and adds in
    the same order; masks are 0/1, so no contraction changes a bit); the
    split denominator within rtol 1e-6 / atol 0 (the reference sums a
    128-lane broadcast of ``u`` and scales by 1/128, exact when its lanes
    are added pairwise; the gap is printed); a hub-tail row's sums within
    rtol 1e-5 / atol 1e-6 (ROADMAP C12, observed ≤ 1.43e-6; bit for bit
    elsewhere); on each
    transport the halo table's real rows equal the other transport's."""
    form, fout, sched, graph = PASSES[case]
    port, ref = cora[graph]
    p, s = _pass_inputs(port, fout, 11)
    pa, fwd = _setup(port, sched, monkeypatch)
    fn, arrays = _ref_pass(ref, form, fout, sched)
    want_n, want_d = _chip(cora["mesh"], fn, arrays + [p, s], 2)
    tp = torch.from_numpy(p)
    if form == "packed":
        tp = tp.to(torch.bfloat16)
    got_n, got_d = port_gat._gat_ell_aggregate(
        tp, torch.from_numpy(s), form, pa, _static(fwd))
    # the rows with hub-tail edges: the reference's XLA:CPU program folds
    # the tail's scatter-add into the bucket sums (each such row's chain
    # continues from its bucket sum), where its source and the port add
    # the tail's own sum, from +0, after the buckets (ROADMAP C12)
    tail = np.zeros(port.k * port.b, bool)
    tail[pa["chub_dst"].numpy()] = True
    tail = tail.reshape(port.k, port.b)
    assert tail.any() == (graph == "id")
    for name, got, want, exact in (
            ("N", got_n.numpy(), want_n, True),
            ("D", got_d.numpy(), want_d, form != "split")):
        _gap(f"{case} {name}", got[~tail], want[~tail],
             None if exact else dict(rtol=1e-6, atol=0))
        if tail.any():
            _gap(f"{case} {name} hub-tail rows", got[tail], want[tail])
    # the halo tables: real rows equal on both transports
    other = "a2a" if sched == "ragged" else "ragged"
    pb, fb = _setup(port, other, monkeypatch)
    t = torch.from_numpy(np.concatenate([p, s[..., None]], -1))
    h1 = ops.gat_exchange_table(t, pa, fwd.get("rr_sizes"), port.r)
    h2 = ops.gat_exchange_table(t, pb, fb.get("rr_sizes"), port.r)
    real = torch.from_numpy(np.arange(port.r)[None, :]
                            < port.halo_counts[:, None])
    assert torch.equal(h1[real], h2[real])


# ---------------------------------------------------------------- a layer
def _layer_inputs(plan, fin, fout, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rv = plan.row_valid[..., None]
    h = (rng.standard_normal((plan.k, plan.b, fin)) * rv).astype(dtype)
    w = (rng.standard_normal((fin, fout)) / np.sqrt(fin)).astype(dtype)
    a1, a2 = ((rng.standard_normal(fout) / np.sqrt(fout)).astype(dtype)
              for _ in range(2))
    g = (rng.standard_normal((plan.k, plan.b, fout)) * rv).astype(dtype)
    return w, a1, a2, h, g


def _ref_layer(cora, graph, sched, w, a1, a2, h, g):
    """The reference's layer (``gat_layer_sym``, or on the directed plan
    ``gat_layer_local``) per chip and its VJP, every chip with its own
    copy of the params: ``(out, dh, dw, da2)``, ``dw`` / ``da2`` summed
    over the chips."""
    _port, ref = cora[graph]
    k = ref.k
    ex = ("send_idx", "halo_src") if sched == "a2a" else ("rsend_idx",
                                                         "rhalo_dst")
    fields = ex + ("cell_idx", "cell_w", "ctail_dst", "ctail_src",
                   "ctail_w", "row_valid")
    comm = (ref_gat.COMM_A2A if sched == "a2a"
            else ("ragged", tuple(ref.rr_sizes), int(ref.r)))
    layer = ref_gat.gat_layer_sym if ref.symmetric else \
        ref_gat.gat_layer_local

    def fn(*xs):
        plan_args = xs[: len(fields)]
        w_, a1_, a2_, h_, g_ = xs[len(fields):]

        def f(w_, a2_, h_):
            return layer(w_, a1_, a2_, h_, *plan_args, ref.cell_buckets,
                         "v", comm)
        out, vjp = jax.vjp(f, w_, a2_, h_)
        dw, da2, dh = vjp(g_)
        return out, dh, dw, da2

    rep = [np.broadcast_to(x, (k,) + x.shape) for x in (w, a1, a2)]
    arrays = [getattr(ref, f) for f in fields] + rep + [h, g]
    out, dh, dw, da2 = _chip(cora["mesh"], fn, arrays, 4)
    return out, dh, dw.sum(0), da2.sum(0)


def _port_layer(pa, fwd, w, a1, a2, h, g, autograd=False):
    """The port's layer (``GatLayerEll``) or, with ``autograd``, torch's
    autograd through the same forward: ``(out, dh, dw, da1, da2)``."""
    ts = [torch.tensor(x).requires_grad_() for x in (w, a1, a2, h)]
    static = _static(fwd)
    if autograd:
        form = port_gat.gat_table_form(w.shape[1], ts[0].dtype)
        out = port_gat._gat_factored_core(
            ts[0], ts[2], ts[3], pa["row_valid"], form,
            lambda p, s: port_gat._gat_ell_aggregate(p, s, form, pa,
                                                     static))[0]
    else:
        out = port_gat.GatLayerEll.apply(*ts, pa, static)
    out.backward(torch.tensor(g))
    return (out.detach().numpy(), ts[3].grad.numpy(), ts[0].grad.numpy(),
            None if ts[1].grad is None else ts[1].grad.numpy(),
            ts[2].grad.numpy())


LAYERS = {
    "fused-a2a": ("sym", "a2a", 16),
    "split-a2a": ("sym", "a2a", 128),
    "fused-tail": ("id", "a2a", 16),
    "directed-fused": ("dir", "a2a", 16),
    "directed-split": ("dir", "a2a", 128),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_matches_the_reference_and_float64(cora, case, monkeypatch):
    """One layer (fin 24) forward and VJP against the reference's
    ``gat_layer_sym`` / ``gat_layer_local`` per chip (on a symmetric
    plan the ring's layer equals the a2a's bit for bit): the output within
    rtol 1e-5 / atol 1e-6 (the projection ``h·w`` and the score
    reduction sum in other orders), the gradients within rtol 1e-5 and
    an atol of 1e-5 of their largest entry (the directed ones the
    reference takes from XLA's scatter-adds), ``∂a1`` exactly 0;
    in float64 the port's output equals torch autograd's through the
    same forward bit for bit and its gradients within rtol 1e-9 / atol
    1e-12."""
    graph, sched, fout = LAYERS[case]
    port, _ref = cora[graph]
    pa, fwd = _setup(port, sched, monkeypatch)
    w, a1, a2, h, g = _layer_inputs(port, 24, fout, 5)
    want = _ref_layer(cora, graph, sched, w, a1, a2, h, g)
    got = _port_layer(pa, fwd, w, a1, a2, h, g)
    for name, x, y in zip(("out", "dh", "dw", "da2"),
                          (got[0], got[1], got[2], got[4]), want):
        ok = np.isfinite(y)
        if not ok.all():
            # ROADMAP C12: the reference's directed split gradient
            print(f"{case} {name}: the reference has {np.sum(~ok)} NaN "
                  f"entries")
            assert case == "directed-split" and name != "out"
        assert np.isfinite(x).all()
        if ok.any():
            _gap(f"{case} {name}", x[ok], y[ok],
                 TOL if name == "out" else dict(
                     rtol=1e-5, atol=1e-5 * float(np.abs(y[ok]).max())))
    assert not got[3].any()
    if port.symmetric:
        # the ring: the same layer, forward and gradients, bit for bit
        ring = _port_layer(*_setup(port, "ragged", monkeypatch), w, a1, a2,
                           h, g)
        for x, y in zip(got, ring):
            assert (x is None and y is None) or np.array_equal(x, y)
    x64 = _layer_inputs(port, 24, fout, 6, np.float64)
    mine = _port_layer(pa, fwd, *x64)
    auto = _port_layer(pa, fwd, *x64, autograd=True)
    np.testing.assert_array_equal(mine[0], auto[0])
    for name, i in (("dh", 1), ("dw", 2), ("da2", 4)):
        _gap(f"{case} float64 {name}", mine[i], auto[i], TOL64)


# ------------------------------------------------------------- trainers
class _Calls:
    """Counts the port's calls of the tile entries and the row pack."""

    def __init__(self, monkeypatch):
        self.n = {"k1": 0, "k5": 0, "fused": 0, "pack": 0}

        def wrap(mod, name, key):
            orig = getattr(mod, name)

            def counted(*a, **kw):
                self.n[key] += 1
                return orig(*a, **kw)
            counted.__dict__ = orig.__dict__        # its launch counters
            monkeypatch.setattr(mod, name, counted)
        wrap(tile_spmm, "spmm_tiles_classes", "k1")
        wrap(port_gat, "gat_tiles_pass", "k5")
        wrap(tile_spmm, "spmm_tiles_fused", "fused")
        wrap(ops, "row_pack", "pack")

    def take(self):
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        return out


def _weights_track(name, got, want, lr=LR):
    """The trainer parity tests' rule: 99 % of the entries within 1e-5,
    every entry within half a step at ``lr``."""
    gap = np.abs(got - want)
    print(f"{name}: {np.mean(gap <= 1e-5):.4f} within 1e-5, max gap "
          f"{gap.max():.3g}")
    assert np.mean(gap <= 1e-5) >= 0.99, gap.max()
    assert gap.max() <= 0.5 * lr


def _params(tr):
    return [{k: v.detach().clone() for k, v in p.items()} for p in tr.params]


def _same(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.fixture(scope="module")
def references(cora):
    """The reference trainer's 3 steps under ``SGCN_PALLAS_SPMM=0`` (its
    slot passes on the CPU) from its own initial params, its optimizer
    scaled by 1/8 (ROADMAP C3), on cora a2a (the hub-tail plan's and the
    directed cora's slot passes and layers meet the reference above); with its predictions after the steps on cora."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "0")
        mp.delenv("SGCN_GAT_FUSED", raising=False)
        for graph in ("sym",):
            ref = cora[graph][1]
            tr = RefTrainer(ref, fin=1433, widths=WIDTHS, seed=3,
                            model="gat", activation="none",
                            comm_schedule="a2a", optimizer=optax.chain(
                                optax.scale(1.0 / 8), optax.adam(LR)))
            assert "pallas_tb" not in tr._fwd_static
            p0 = [{k: np.asarray(v) for k, v in p.items()}
                  for p in tr.params]
            rdata = ref_make_train_data(ref, cora["feats"], cora["labels"])
            losses = [tr.step(rdata) for _ in range(3)]
            out[graph] = {"p0": p0, "losses": losses,
                          "params": [{k: np.asarray(v) for k, v in p.items()}
                                     for p in tr.params]}
            out[graph]["pred"] = tr.predict(rdata)
    return out


def _port_run(plan, data, p0, calls, steps=3, **kw):
    tr = FullBatchTrainer(plan, fin=1433, widths=WIDTHS, lr=LR, model="gat",
                          activation="none",
                          params=port_gat.params_from_jax(p0), device="cpu",
                          **kw)
    calls.take()
    losses = [tr.step(data) for _ in range(steps)]
    return losses, _params(tr), calls.take(), tr


@pytest.mark.parametrize("graph", ["sym", "id", "dir"])
def test_trainer_matches_reference_and_tiles(cora, references, graph,
                                             monkeypatch):
    """3 GAT steps under ``SGCN_PALLAS_SPMM=0`` (cora 8-hp, the hub-tail
    plan, the directed cora; a2a), cora's and the hub-tail plan's against
    the reference's trainer on cora 8-hp (the same graph and parts; the
    hub-tail plan sums in another bucket layout): losses within rtol 1e-5
    / atol 1e-6, weights by the parity tests' rule (the directed cora's
    layer meets ``gat_layer_local`` above, its gradient float64 below); a
    second run, the ring (symmetric) and ``remat=True`` bit for bit; no
    K1, K5 or fused call and as many packs as the tile step; against the
    port's tile GAT the losses bit for bit, and the weights too except on
    the hub-tail plan (there by the parity tests' rule)."""
    port = cora[graph][0]
    ref = references["sym"]
    data = make_train_data(port, cora["feats"], cora["labels"])
    calls = _Calls(monkeypatch)
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    losses, params, n, tr = _port_run(port, data, ref["p0"], calls)
    assert tr.setup.aggregator == "ell"
    assert tr.comm_decision["aggregator"]["chosen"] == "ell"
    assert tr.comm_decision["aggregator"]["layout"] == (
        "cell" if port.symmetric else "cell_t")
    if graph != "dir":
        _gap(f"{graph} losses", losses, ref["losses"])
        for p, rp in zip(params, ref["params"]):
            for key in ("w", "a2"):
                _weights_track(f"{graph} {key}", p[key].numpy(), rp[key])
    again = [_port_run(port, data, ref["p0"], calls, remat=True)]
    if port.symmetric:
        again.append(_port_run(port, data, ref["p0"], calls,
                               comm_schedule="ragged"))
    again.append(_port_run(port, data, ref["p0"], calls))
    for run in again:
        assert run[0] == losses and _same(run[1], params)
    assert n["k1"] == n["k5"] == n["fused"] == 0, n
    monkeypatch.delenv("SGCN_PALLAS_SPMM")
    tl, tp, tn, tt = _port_run(port, data, ref["p0"], calls)
    assert tt.setup.aggregator == "tile"
    assert n["pack"] == tn["pack"] > 0, (n, tn)
    if port.symmetric:
        assert again[-2][2]["pack"] == 3 * 2 * len(WIDTHS)   # the ring's
    # ELL against the tiles: the same losses bit for bit on all three
    # plans; the same weights bit for bit except on the hub-tail plan,
    # whose hub rows the tiles sum in another order
    _gap(f"{graph} losses ELL vs tile", losses, tl, None)
    if graph == "id":
        for p, q in zip(params, tp):
            for key in ("w", "a2"):
                _weights_track(f"{graph} {key} ELL vs tile", p[key].numpy(),
                               q[key].numpy())
    else:
        assert _same(params, tp)


def _dense_gat64_grads(ahat, feats, labels, params):
    """Float64 torch autograd of the GAT loss (no activation, xent over
    every row) with a dense mask of Â's pattern: ``{w, a2}`` per layer
    (``tests/test_torch_asym.py``'s)."""
    mask = torch.as_tensor(np.asarray(ahat.todense()) != 0)
    leaves = [{k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
               for k, v in p.items()} for p in params]
    h = torch.tensor(feats, dtype=torch.float64)
    for p in leaves:
        z = h @ p["w"]
        s = (z @ p["a1"])[:, None] + (z @ p["a2"])[None, :]
        alpha = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        h = torch.where(mask, alpha, 0.0) @ z
    logp = torch.log_softmax(h, dim=-1)
    loss = -logp.gather(-1, torch.as_tensor(labels, dtype=torch.int64)[:, None]
                        ).mean()
    loss.backward()
    return [{k: p[k].grad.numpy() for k in ("w", "a2")} for p in leaves]


# packed bf16 vs float64: relative Frobenius bound on each layer's step-1
# gradient (``tests/test_torch_asym.py``'s BF16_GRAD_RTOL)
BF16_GRAD_RTOL = 5e-2


@pytest.mark.parametrize("graph", ["sym", "dir"])
def test_packed_bf16_trainer_gradient_tracks_float64(cora, references, graph,
                                                     monkeypatch):
    """``compute_dtype='bfloat16'`` (layer 0 the packed form, layer 1 the
    fused bf16 table): step-1 gradients of ``w`` and ``a2`` within
    ``BF16_GRAD_RTOL`` (relative Frobenius) of float64 autograd of the
    loss over the mean of every row — on the directed cora too, where the
    reference's packed gradient misses the feature lanes (ROADMAP C5) and
    the port's transposed chains carry it — ``a1``'s exactly 0; the ring
    equals the a2a bit for bit."""
    port = cora[graph][0]
    p0 = references["sym"]["p0"]
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    data = make_train_data(port, cora["feats"], cora["labels"])
    runs = []
    for sched in ("a2a", "ragged") if port.symmetric else ("a2a",):
        tr = FullBatchTrainer(port, fin=1433, widths=WIDTHS, lr=LR,
                              model="gat", activation="none",
                              compute_dtype="bfloat16",
                              comm_schedule=sched, device="cpu",
                              params=port_gat.params_from_jax(p0))
        grads = []
        tr.opt.register_step_pre_hook(lambda opt, a, kw, g=grads: g.append(
            [{k: v.grad.clone() for k, v in p.items()} for p in tr.params]))
        runs.append(([tr.step(data) for _ in range(2)], grads[0]))
    want = _dense_gat64_grads(normalize_adjacency(
        cora["a"] if graph == "sym" else _cora_directed(cora["a"])),
        cora["feats"], cora["labels"], p0)
    for i, (mine, w64) in enumerate(zip(runs[0][1], want)):
        assert not mine["a1"].any()
        for key in ("w", "a2"):
            got = mine[key].numpy()
            rel = float(np.linalg.norm(got - w64[key])
                        / np.linalg.norm(w64[key]))
            print(f"{graph} layer {i} d{key}: relative gap to float64 "
                  f"{rel:.3g}")
            assert rel <= BF16_GRAD_RTOL
    for losses, grads in runs[1:]:
        assert losses == runs[0][0] and _same(grads, runs[0][1])


# --------------------------------------------------- server, events, memory
def test_full_mode_server_matches_reference_predict(cora, references,
                                                    monkeypatch):
    """The full-mode engine under ``SGCN_PALLAS_SPMM=0`` with the
    reference trainer's weights after its 3 steps serves that trainer's
    ``predict`` rows (the rows its ``evaluate()`` scores) within rtol 1e-5
    / atol 1e-6 — the fused form at 16 and 7 and, on a 128-wide layer,
    the split form — the ring's rows equal the a2a's bit for bit, one
    forward's packs a query batch and no K1, K5 or fused call."""
    port = cora["sym"][0]
    ref = references["sym"]
    calls = _Calls(monkeypatch)
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    qids = np.arange(0, 2708, 43)
    rows = {}
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(port, 1433, WIDTHS, model="gat",
                          params=port_gat.params_from_jax(ref["params"]),
                          comm_schedule=sched, device="cpu")
        assert eng.setup.aggregator == "ell"
        eng.set_features(cora["feats"])
        calls.take()
        rows[sched] = eng.query(qids)
        n = calls.take()
        assert n == {"k1": 0, "k5": 0, "fused": 0,
                     "pack": 2 * 2 if sched == "a2a" else 2}, n
    np.testing.assert_array_equal(rows["a2a"], rows["ragged"])
    _gap("served rows vs the reference's predict", rows["a2a"],
         ref["pred"][qids])
    wide = ServeEngine(port, 1433, [128, 7], model="gat", device="cpu")
    assert [port_gat.gat_table_form(w) for w in (128, 7)] == ["split",
                                                             "fused"]
    wide.set_features(cora["feats"])
    assert np.isfinite(wide.query(qids)).all()


def test_step_events_book_the_gat_cost_and_reconcile(cora, tmp_path,
                                                     monkeypatch):
    """A GAT ELL step event carries ``roofline`` and ``measured_vs_model``
    from ``step_cost(model='gat')``, its wire bytes equal to
    ``CommStats``' lane-weighted gauges, on both transports and under
    ``compute_dtype`` (the packed lanes)."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    port = cora["sym"][0]
    data = make_train_data(port, cora["feats"], cora["labels"])
    for i, kw in enumerate(({}, {"comm_schedule": "ragged"},
                            {"compute_dtype": "bfloat16"})):
        tr = FullBatchTrainer(port, fin=1433, widths=WIDTHS, model="gat",
                              device="cpu", **kw)
        d = str(tmp_path / f"run{i}")
        rec = RunRecorder(d, config={})
        tr.attach_recorder(rec)
        for _ in range(2):
            tr.step(data)
        rec.close()
        steps = load_run(d).steps()
        assert len(steps) == 2
        for s in steps:
            roof = s["roofline"]
            assert roof["halo_bytes_wire_per_step"] == \
                s["comm"]["halo_bytes_wire_per_step"] > 0
            assert s["measured_vs_model"]["components"]


def test_memory_model_prices_gat_slot_temps_and_gates(cora, monkeypatch):
    """A GAT ELL setup's model: its shipped chain arrays, no tile arrays,
    and ``slot_temps`` per table form (the split form's two passes and
    one slot's gather, the packed form's ``fout/2 + 1``-word gather);
    ``memory_budget`` refuses an ``=0`` GAT trainer before anything
    ships."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    port = cora["sym"][0]
    temps = {}
    for widths, dt in (([16, 7], None), ([128, 7], None), ([16, 7],
                                                           "bfloat16")):
        tr = FullBatchTrainer(port, fin=1433, widths=widths, model="gat",
                              compute_dtype=dt, device="cpu")
        fam = tr.memory.families
        res = tr.resident_bytes()
        assert fam["plan_arrays"] == res["plan_arrays"] > 0
        assert fam["pallas_tiles"] == res["pallas_tiles"] == 0
        temps[str(widths), dt] = fam["slot_temps"]
    kb = port.k * port.b
    assert temps["[16, 7]", None] >= 4 * kb * 17 * 4
    assert temps["[128, 7]", None] > temps["[16, 7]", None]
    assert temps["[16, 7]", "bfloat16"] < temps["[16, 7]", None]
    with pytest.raises(MemoryBudgetError):
        FullBatchTrainer(port, fin=1433, widths=WIDTHS, model="gat",
                         device="cpu",
                         memory_budget=temps["[16, 7]", None])


@pytest.mark.parametrize("argv", [
    ["-m", "train", "--comm-schedule", "a2a"],
    ["-m", "train", "--comm-schedule", "ragged"],
    ["-m", "train", "--dtype", "bfloat16"],
    ["-m", "serve"]], ids=["train-a2a", "train-ring", "train-bf16", "serve"])
def test_clis_run_gat_on_ell(argv, tmp_path, monkeypatch, capsys):
    """``python -m sgcn_tpu_torch.train --model gat`` (a2a, the ring,
    ``--dtype bfloat16``) and ``python -m sgcn_tpu_torch.serve --model
    gat`` (full mode) under ``SGCN_PALLAS_SPMM=0`` on cora 8-hp: one
    JSON report with finite numbers, and the run directory's decision
    log names the ELL aggregator and its ``'cell'`` layout."""
    from sgcn_tpu_torch.serve.__main__ import main as serve_main
    from sgcn_tpu_torch.train.__main__ import main as train_main

    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    d = str(tmp_path / "run")
    base = ["--npz", os.path.join(FIX, "cora2708.npz"), "--normalize", "-p",
            os.path.join(FIX, "cora2708.8.hp"), "-s", "8", "--model", "gat",
            "--device", "cpu", "--metrics-out", d]
    if argv[1] == "train":
        train_main(base + ["-l", "2", "--hidden", "16", "--epochs", "2",
                           "--warmup", "0"] + argv[2:])
    else:
        serve_main(base + ["--random-init", "--classes", "7",
                           "--queries", "64"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report.get("model", "gat") == "gat"
    log = load_run(d)
    decision = log.manifest["comm_schedule"]["aggregator"]
    assert decision["chosen"] == "ell" and decision["layout"] == "cell"
