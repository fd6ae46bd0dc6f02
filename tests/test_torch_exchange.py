"""The exchange as the port lays it out over the stacked parts (K3, K4):
one row pack writes the a2a receive layout (and, for GAT, the halo rows
of it), or the ragged ring's round-major concat; the GCN aggregation's
halo tiles read the receive buffer in place (``ptile_hwsrc``) and its
local pass, halo pass and sum run as one fused launch
(``ops/tile_spmm.py::spmm_tiles_fused``).

On the CPU every kernel is its plain version, so these tests hold:

  * the port-only plan arrays (``recv_src``, ``halo_src_flat``,
    ``ring_src``, ``ptile_hwsrc``) to their definitions from the plan's
    ``send_idx``/``rsend_idx``/``halo_src``/``ptile_hsrc``, and every
    array those are built from to the reference's;
  * the pack's plain version to the exchange as torch indexing writes it
    from the reference's arrays (a two-index gather, the stacked
    transpose, the ``halo_src`` gather; the ring's per-round gather, roll
    and cat), bit for bit, with and without the bf16 wire and on bf16
    tables;
  * the fused plain version to the two family passes, the ``[:, :b]``
    slices, the float32 add and the cast, bit for bit, on both
    transports, forward and backward;
  * one GCN and one GAT training step and serving forward against the
    reference (its kernel path, emulated, per chip under ``shard_map`` on
    the 8 virtual CPU devices of ``tests/conftest.py``), both transports,
    at the tolerances of ``tests/test_torch_train.py`` and
    ``tests/test_torch_gat.py``.

Sizes: cora2708 under its 8-part hp partition and the 48-vertex ER graph
of ``tests/conftest.py`` under 4 balanced random parts.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import er_graph
from sgcn_tpu.models import gat as ref_gat
from sgcn_tpu.ops.pallas_spmm import (PALLAS_PLAN_FIELDS,
                                      PALLAS_PLAN_FIELDS_RAGGED)
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import make_mesh_1d
from sgcn_tpu.parallel.mesh import shard_stacked
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models import gat as port_gat
from sgcn_tpu_torch.models import gcn as port_gcn
from sgcn_tpu_torch.ops.pspmm import (exchange_recv, halo_exchange,
                                      ring_concat)
from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_plain
from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                          TILE_PLAN_FIELDS_RAGGED,
                                          choose_tile_dispatch,
                                          pspmm_tiles_ragged,
                                          pspmm_tiles_sym,
                                          spmm_tiles_classes,
                                          spmm_tiles_fused,
                                          spmm_tiles_fused_plain)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
WIDTHS = [16, 7]

# the reference arrays the port-only ones are built from
SOURCE_ARRAYS = ("send_idx", "send_counts", "halo_src", "halo_counts",
                 "rsend_idx", "rhalo_dst", "ptile_hsrc", "ptile_hld",
                 "ptile_hw", "ptile_hrsrc", "ptile_lsrc", "ptile_lld",
                 "ptile_lw")


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": build_comm_plan(normalize_adjacency(a), pv, 8),
            "ref_plan": ref_build_comm_plan(ref_normalize(a), pv, 8),
            "mesh": make_mesh_1d(8)}


def _graph(cora, name):
    """(port plan, reference plan) with every layout built, tile height
    256 on cora, 8 on the ER graph."""
    if name == "cora":
        a, pv, k, tb = cora["a"], cora["pv"], 8, 256
    else:
        a, pv, k, tb = er_graph(), balanced_random_partition(48, 4, seed=0), \
            4, 8
    port = build_comm_plan(normalize_adjacency(a), pv, k)
    ref = ref_build_comm_plan(ref_normalize(a), pv, k)
    for p in (port, ref):
        p.ensure_ragged()
        p.ensure_pallas_tiles(tb).ensure_pallas_ragged_tiles()
    port.ensure_exchange()
    return port, ref


def _t(plan, *fields):
    return [torch.from_numpy(np.ascontiguousarray(getattr(plan, f)))
            for f in fields]


# ------------------------------------------------- torch indexing, literal
def _indexed_exchange(h, send_idx, halo_src, wire=None):
    """The a2a exchange as torch indexing writes it from the reference's
    arrays: the two-index send gather, the cast to the wire, the stacked
    transpose (recv[q, p] = send[p, q]), the ``halo_src`` gather, the
    upcast."""
    k = h.shape[0]
    parts = torch.arange(k)
    send = h[parts[:, None, None], send_idx.long()]
    if wire is not None:
        send = send.to(wire)
    recv = send.transpose(0, 1).reshape(k, -1, *h.shape[2:])
    return recv, recv[parts[:, None], halo_src.long()].to(h.dtype)


def _indexed_ring(h, rsend_idx, rr_sizes, wire=None):
    """The ring as torch indexing writes it: per live round a gather, the
    cast, a roll by d parts (q receives from q − d), then a cat."""
    k = h.shape[0]
    parts = torch.arange(k)[:, None]
    segs, off = [], 0
    for d, sd in enumerate(rr_sizes, start=1):
        if sd:
            buf = h[parts, rsend_idx[:, off: off + sd].long()]
            if wire is not None:
                buf = buf.to(wire)
            segs.append(torch.roll(buf, shifts=d, dims=0))
        off += sd
    return torch.cat(segs, dim=1)


# ---------------------------------------------------------- the plan
@pytest.mark.parametrize("graph", ["cora", "er"])
def test_flat_sources_follow_their_definitions(cora, graph):
    """``recv_src[q, p·S + t] = p·B + send_idx[p, q, t]``,
    ``halo_src_flat[q, r] = q·k·S + halo_src[q, r]``, and the ring concat
    slot of round d on part q holds what ``(q − d) mod k`` sends:
    ``ring_src[q, off_d + t] = o·B + rsend_idx[o, off_d + t]``; all int32,
    computed here slot by slot."""
    plan, _ = _graph(cora, graph)
    k, b, s = plan.k, plan.b, plan.s
    for x in (plan.recv_src, plan.halo_src_flat, plan.ring_src):
        assert x.dtype == np.int32 and x.flags.c_contiguous
    assert plan.recv_src.shape == (k, k * s)
    for q in range(k):
        for p in range(k):
            np.testing.assert_array_equal(
                plan.recv_src[q, p * s: (p + 1) * s],
                p * b + plan.send_idx[p, q])
        np.testing.assert_array_equal(plan.halo_src_flat[q],
                                      q * k * s + plan.halo_src[q])
    assert plan.ring_src.shape == plan.rsend_idx.shape
    off = 0
    for d, sd in enumerate(plan.rr_sizes, start=1):
        for q in range(k):
            o = (q - d) % k
            np.testing.assert_array_equal(
                plan.ring_src[q, off: off + sd],
                o * b + plan.rsend_idx[o, off: off + sd])
        off += sd


@pytest.mark.parametrize("graph", ["cora", "er"])
def test_hwsrc_rebases_the_halo_tiles_into_the_receive_buffer(cora, graph):
    """``ptile_hwsrc[q] == halo_src[q][ptile_hsrc[q]]``: each halo tile
    slot reads its halo rank's row at that rank's position in the
    ``(k·S)`` receive buffer — the row the halo table held there."""
    plan, _ = _graph(cora, graph)
    assert plan.ptile_hwsrc.shape == plan.ptile_hsrc.shape
    assert plan.ptile_hwsrc.dtype == np.int32
    for q in range(plan.k):
        np.testing.assert_array_equal(plan.ptile_hwsrc[q],
                                      plan.halo_src[q][plan.ptile_hsrc[q]])
    assert plan.ptile_hwsrc.max() < plan.k * plan.s


@pytest.mark.parametrize("graph", ["cora", "er"])
def test_source_arrays_still_equal_reference(cora, graph):
    """Every array the port-only ones are built from (and the tiles the
    fused launch reads) equals the reference's, dtype and shape too."""
    port, ref = _graph(cora, graph)
    for f in SOURCE_ARRAYS:
        x, y = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert port.rr_sizes == ref.rr_sizes
    assert port.pallas_hclasses == ref.pallas_hclasses


def test_plan_fields_replace_only_the_exchange_arrays():
    """The port's field tuples are the reference's with the exchange's
    arrays replaced by the flat sources of its row packs (and the halo
    tiles by their receive-buffer re-base), nothing else."""
    gcn = {"send_idx": "recv_src", "halo_src": None,
           "ptile_hsrc": "ptile_hwsrc", "rsend_idx": "ring_src"}
    gat = {"send_idx": "recv_src", "halo_src": "halo_src_flat",
           "rsend_idx": "ring_src"}
    for port, ref, sub in (
            (TILE_PLAN_FIELDS, PALLAS_PLAN_FIELDS, gcn),
            (TILE_PLAN_FIELDS_RAGGED, PALLAS_PLAN_FIELDS_RAGGED, gcn),
            (port_gat.GAT_PLAN_FIELDS_PALLAS, ref_gat.GAT_PLAN_FIELDS_PALLAS,
             gat),
            (port_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED,
             ref_gat.GAT_PLAN_FIELDS_PALLAS_RAGGED, gat)):
        want = tuple(sub.get(f, f) for f in ref if sub.get(f, f))
        assert port == want


# ----------------------------------------------------- the pack, plain
@pytest.mark.parametrize("graph", ["cora", "er"])
@pytest.mark.parametrize("case", ["f32", "f32 bf16 wire", "bf16 table",
                                  "scalar"])
def test_pack_plain_equals_torch_indexing(cora, graph, case):
    """The receive buffer, the halo rows and the ring concat as the row
    pack's plain version writes them equal the torch-indexing exchange
    from the reference's arrays, bit for bit: a float32 table, a float32
    table on the bf16 wire, a bf16 table, and a ``(k, B)`` scalar table
    (the split GAT form's ``u``)."""
    plan, _ = _graph(cora, graph)
    rng = np.random.default_rng(0)
    shape = (plan.k, plan.b) if case == "scalar" else (plan.k, plan.b, 5)
    h = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    wire = torch.bfloat16 if case == "f32 bf16 wire" else None
    if case == "bf16 table":
        h = h.bfloat16()
    recv_src, hflat, ring_src, sidx, hsrc, rsend = _t(
        plan, "recv_src", "halo_src_flat", "ring_src", "send_idx",
        "halo_src", "rsend_idx")
    want_recv, want_halo = _indexed_exchange(h, sidx, hsrc, wire)
    recv = exchange_recv(h, recv_src, wire)
    halo = halo_exchange(h, recv_src, hflat, wire)
    ring = ring_concat(h, ring_src, plan.rr_sizes, wire)
    want_ring = _indexed_ring(h, rsend, plan.rr_sizes, wire)
    assert recv.dtype == want_recv.dtype == (wire or h.dtype)
    assert halo.dtype == h.dtype and ring.dtype == (wire or h.dtype)
    for got, want in ((recv, want_recv), (halo, want_halo),
                      (ring, want_ring)):
        assert got.shape == want.shape
        assert torch.equal(got, want)
    # the pack itself, on the CPU: its plain version
    assert torch.equal(row_pack(h, recv_src, wire),
                       row_pack_plain(h, recv_src, wire))


def test_pack_plain_casts_as_torch_and_rejects_bad_index():
    """The plain pack rounds a float32 row to bf16 as ``Tensor.to`` does
    (nearest even, ties and inf included) and widens bf16 exactly; an
    index must be int32 and (k, J)."""
    x = torch.tensor([[[1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, float("inf"),
                        -2.5]]])
    flat = torch.zeros((1, 3), dtype=torch.int32)
    got = row_pack(x, flat, torch.bfloat16)
    assert torch.equal(got, x.to(torch.bfloat16).expand(1, 3, 4))
    assert torch.equal(row_pack(got, flat, torch.float32),
                       got.float())
    with pytest.raises(TypeError, match="int32"):
        row_pack(x, flat.long())
    with pytest.raises(ValueError, match=r"\(k, J\)"):
        row_pack(x, flat[0])


def test_empty_ring_is_one_zero_row_on_the_wire():
    """k = 1 (or no halo): the ring concat is a ``(k, 1, f)`` zero table
    in the wire's dtype; the pack is not called."""
    h = torch.ones(3, 4, 2)
    for wire, dt in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        z = ring_concat(h, torch.zeros(3, 1, dtype=torch.int32), (0, 0),
                        wire)
        assert z.shape == (3, 1, 2) and z.dtype == dt and not z.any()


# --------------------------------------------------- the fused launch
def _two_pass(h, remote, lt, ht, st):
    """Local + remote as two family passes: each sliced to the b owned
    rows, summed in float32, cast once to h's dtype."""
    b = h.shape[1]
    local = spmm_tiles_classes(*lt, h, st["pallas_lclasses"], 256)[:, :b]
    rem = spmm_tiles_classes(*ht, remote, st["pallas_hclasses"], 256)[:, :b]
    return (local + rem).to(h.dtype)


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
@pytest.mark.parametrize("lever", [None, "halo_dtype", "compute_dtype"])
def test_fused_plain_equals_two_passes_forward_and_backward(cora, schedule,
                                                            lever):
    """``pspmm_tiles_sym``/``pspmm_tiles_ragged`` (pack + fused plain
    version) forward, and its backward on a strided gradient, equal the
    two-pass form over the torch-indexing exchange's tables (the halo
    table with ``ptile_hsrc``, or the ring concat upcast), bit for bit —
    float32, on the bf16 wire, and on bf16 tables."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan, schedule=schedule)
    plan.ensure_exchange()
    ragged = schedule == "ragged"
    rng = np.random.default_rng(3)
    dt = torch.bfloat16 if lever == "compute_dtype" else torch.float32
    wire = "bfloat16" if lever == "halo_dtype" else None
    h = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 16)).astype(np.float32)).to(dt)
    g = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 32)).astype(np.float32)).to(dt)[..., ::2]
    lt = _t(plan, "ptile_lsrc", "ptile_lld", "ptile_lw")
    static = (256, st["pallas_lclasses"], st["pallas_hclasses"])

    def old(x):
        w = torch.bfloat16 if wire else None
        if ragged:
            remote = _indexed_ring(x, *_t(plan, "rsend_idx"), plan.rr_sizes,
                                   w).to(x.dtype)
            ht = _t(plan, "ptile_hrsrc", "ptile_hld", "ptile_hw")
        else:
            remote = _indexed_exchange(x, *_t(plan, "send_idx", "halo_src"),
                                       w)[1]
            ht = _t(plan, "ptile_hsrc", "ptile_hld", "ptile_hw")
        return _two_pass(x, remote, lt, ht, st)

    x = h.clone().requires_grad_()
    if ragged:
        y = pspmm_tiles_ragged(x, *_t(plan, *TILE_PLAN_FIELDS_RAGGED),
                               *static, plan.rr_sizes, wire)
    else:
        y = pspmm_tiles_sym(x, *_t(plan, *TILE_PLAN_FIELDS), *static, wire)
    y.backward(g)
    assert y.dtype == dt and x.grad.dtype == dt
    assert torch.equal(y.detach(), old(h))
    assert torch.equal(x.grad, old(g.contiguous()))
    assert y.detach().float().abs().max() > 0


def test_fused_plain_launches_no_kernel(cora, monkeypatch):
    """``spmm_tiles_fused_plain`` is torch arithmetic wherever its tensors
    lie: with every tensor taken for a card tensor and every kernel entry
    made to raise, it still equals the two-pass plain form bit for bit —
    it is what the card's checks hold the fused entry against."""
    import sgcn_tpu_torch.ops.tile_spmm as ts

    plan = cora["plan"]
    st = choose_tile_dispatch(plan)
    plan.ensure_exchange()
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal(
        (plan.k, plan.b, 8)).astype(np.float32))
    lt = _t(plan, "ptile_lsrc", "ptile_lld", "ptile_lw")
    ht = _t(plan, "ptile_hwsrc", "ptile_hld", "ptile_hw")
    recv = exchange_recv(h, *_t(plan, "recv_src"))
    want = _two_pass(h, recv, lt, ht, st)

    def no_kernel(*_a, **_k):
        raise AssertionError("the plain version reached a kernel entry")

    monkeypatch.setattr(ts, "_on_cpu", lambda *_a: False)
    monkeypatch.setattr(ts, "_launch_family", no_kernel)
    monkeypatch.setattr(ts, "_lib", no_kernel)
    got = spmm_tiles_fused_plain(lt, h, ht, recv, st["pallas_lclasses"],
                                 st["pallas_hclasses"], 256)
    assert torch.equal(got, want) and got.abs().max() > 0


def test_fused_wrapper_checks_its_families(cora):
    """On the CPU ``spmm_tiles_fused`` is its plain version; a table on
    another device than the CPU or the card raises."""
    plan = cora["plan"]
    st = choose_tile_dispatch(plan)
    plan.ensure_exchange()
    h = torch.ones(plan.k, plan.b, 4)
    lt = _t(plan, "ptile_lsrc", "ptile_lld", "ptile_lw")
    ht = _t(plan, "ptile_hwsrc", "ptile_hld", "ptile_hw")
    recv = exchange_recv(h, *_t(plan, "recv_src"))
    args = (lt, h, ht, recv, st["pallas_lclasses"], st["pallas_hclasses"],
            256)
    assert torch.equal(spmm_tiles_fused(*args), spmm_tiles_fused_plain(*args))
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_tiles_fused(lt, h.to("meta"), ht, recv.to("meta"),
                         *args[4:])


# ------------------------------------- the slice against the reference
def _reference_step(cora, model, schedule):
    """The reference's loss, loss gradient (``jax.grad`` of the whole
    mapped loss) and served logits at its initial weights (seed 3), its
    kernel path emulated; and those weights as numpy."""
    feats, labels = cora["feats"], cora["labels"]
    kw = dict(fin=1433, widths=WIDTHS, seed=3, model=model,
              comm_schedule=schedule,
              activation="none" if model == "gat" else "relu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        mp.delenv("SGCN_GAT_FUSED", raising=False)
        ref = RefTrainer(cora["ref_plan"], **kw)
        rdata = ref_make_train_data(cora["ref_plan"], feats, labels)
        rd = shard_stacked(ref.mesh, vars(rdata))
        args = (ref.pa, rd["h0"], rd["labels"], rd["train_valid"])
        specs = (P(), P("v"), P("v"), P("v"), P("v"))

        def chip_loss(params, pa, h0, lab, valid):
            pa, h0, lab, valid = jax.tree.map(lambda x: x[0],
                                              (pa, h0, lab, valid))
            return ref._loss_fn(ref._forward(params, pa, h0), lab, valid)

        loss_map = jax.shard_map(chip_loss, mesh=ref.mesh, in_specs=specs,
                                 out_specs=P())
        loss, grads = jax.jit(jax.value_and_grad(
            lambda ps: loss_map(ps, *args)))(ref.params)
        pred = ref.predict(rdata)
    as_np = (lambda t: [{k: np.asarray(v) for k, v in p.items()} for p in t]
             if model == "gat" else [np.asarray(w) for w in t])
    return float(loss), as_np(grads), pred, as_np(ref.params)


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_step_and_serving_track_reference(cora, model, schedule):
    """One training step and one serving forward of the port, from the
    reference's initial weights, on either transport: the loss within
    rtol 1e-6; step-1 gradients within rtol 1e-4 / atol 1e-8 (GCN,
    ``tests/test_torch_train.py``) or rtol 1e-3 / atol 1e-7 (GAT ``w`` and
    ``a2``, ``tests/test_torch_gat.py``; ``a1``'s exactly 0); served rows
    within rtol 1e-4 / atol 1e-5 of the reference's ``predict``."""
    loss, grads, pred, p0 = _reference_step(cora, model, schedule)
    plan, feats = cora["plan"], cora["feats"]
    to_port = (port_gat.params_from_jax if model == "gat"
               else port_gcn.params_from_jax)
    act = {"activation": "none"} if model == "gat" else {}
    tr = FullBatchTrainer(plan, fin=1433, widths=WIDTHS, model=model,
                          comm_schedule=schedule, params=to_port(p0),
                          device="cpu", **act)
    data = make_train_data(plan, feats, cora["labels"])
    got = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: got.append(
        [{k: v.grad.clone().numpy() for k, v in p.items()}
         if model == "gat" else p.grad.clone().numpy() for p in tr.params]))
    assert tr.step(data) == pytest.approx(loss, rel=1e-6)
    for mine, want in zip(got[0], grads):
        if model == "gat":
            assert not mine["a1"].any()
            for k in ("w", "a2"):
                np.testing.assert_allclose(mine[k], want[k], rtol=1e-3,
                                           atol=1e-7)
        else:
            np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-8)
    eng = ServeEngine(plan, fin=1433, widths=WIDTHS, model=model,
                      comm_schedule=schedule, params=to_port(p0),
                      max_batch=64, device="cpu")
    eng.set_features(feats)
    q = np.arange(0, plan.n, 43)
    np.testing.assert_allclose(eng.query(q), pred[q], rtol=1e-4, atol=1e-5)
