"""Directed graphs on the rank runtime (ROADMAP A2c's last part): an
asymmetric Â on 8 gloo ranks against the stacked layout and the
reference's asymmetric trainer, on the directed cora2708 of
``tests/test_torch_asym.py`` (each undirected edge kept in one direction
by a seeded coin) under its 8-part hp partition.

One module-scoped spawn (``tests/torch_rank_child.py::
directed_ranks_main``) runs every rank check while the parent builds the
stacked and reference runs.  Per rank: one GCN aggregation's forward and
VJP (``pspmm_tiles_gen_ranks``: the forward's exchange, and a backward
whose halo rows' partials go back to their owners with the reverse
``all_to_all_single``) in float32, under ``halo_dtype`` and on bf16 rows
(``compute_dtype``), and one GAT layer (``GatLayerGen`` on the rank) per
table form; each must equal the stacked op's row for its part bit for
bit.  The float32 aggregation's launches and waits are logged: the
reverse exchange is waited on only after the local-ᵀ launch is issued.
Then five training steps per case against the stacked trainer (GCN
under ``compute_dtype`` against the stacked emulation of the rank path's
bf16 rounding points), the reference's asymmetric trainer (float32, C3's
factor divided out) and, for GAT under ``compute_dtype``, a float64
autograd of the same function (ROADMAP C5: the reference's packed
gradient drops the feature lanes' share).
"""

import os
import pickle
import tempfile

import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu_torch.parallel import shard_proxy_plan
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)
from sgcn_tpu_torch.utils.stats import CommStats

import torch_rank_child as child

K = 8
CASES = list(child.DIRECTED_CASES)
# the packed bf16 GAT's step-1 gradient against float64: the bound of
# tests/test_torch_asym.py (relative Frobenius per layer and leaf)
BF16_GRAD_RTOL = 5e-2


def _np(params):
    return [{k: np.asarray(v) for k, v in p.items()} if isinstance(p, dict)
            else np.asarray(p) for p in params]


def _partwise_gen_bf16(tr):
    """Point the stacked directed GCN trainer ``tr`` (``compute_dtype``)
    at a forward that casts each weight to bf16 once per part, so part
    p's weight gradient is its own bf16 matmul output, widened and summed
    over the parts in float32: the rank path's rounding points (a rank's
    bf16 partial, widened, then all-reduced).  Otherwise
    ``gcn_forward_local``'s stacked asymmetric forward
    (``pspmm_tiles_gen``)."""
    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.models.gcn import get_activation
    from sgcn_tpu_torch.ops.tile_spmm import pspmm_tiles_gen

    m, st = tr.model, tr.model.fwd_static
    act, fact = (get_activation(m.activation),
                 get_activation(m.final_activation))
    tcls = (st["pallas_tlclasses"], st["pallas_thclasses"],
            st["pallas_t1classes"])

    def forward(h, pa):
        h = h.to(torch.bfloat16)
        nl = len(m.weights)
        for i, w in enumerate(m.weights):
            copies = [w.to(torch.bfloat16) for _ in range(h.shape[0])]

            def mm(x):
                return torch.stack([x[p] @ c for p, c in enumerate(copies)])

            def agg(x):
                return pspmm_tiles_gen(x, pa, st["pallas_tb"],
                                       st["pallas_lclasses"],
                                       st["pallas_hclasses"], tcls)
            if w.shape[1] < h.shape[-1] and \
                    h.shape[-1] >= PROJECT_FIRST_MIN_FIN:
                z = agg(mm(h))
            else:
                z = mm(agg(h))
            h = fact(z) if i == nl - 1 else act(z)
        return h

    m.forward = forward
    return tr


def _dense_gat64_grads(ahat, feats, labels, params):
    """Float64 torch autograd of the GAT loss (no activation, xent over
    every row) with a dense mask of Â's pattern: ``{w, a2}`` per layer."""
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


@pytest.fixture(scope="module")
def cora():
    """The directed plan, data, the reference's plan and its initial
    weights (seed 3) of both models."""
    ad, ahat, feats, labels, pv, plan = child.cora_directed_plan()
    ref_plan = ref_build_comm_plan(ref_normalize(ad), pv, K)
    kw = dict(fin=child.FIN, widths=child.WIDTHS, seed=3)
    p0 = {"gcn": _np(RefTrainer(ref_plan, **kw).params),
          "gat": _np(RefTrainer(ref_plan, **kw, model="gat",
                                activation="none").params)}
    return {"ahat": ahat, "feats": feats, "labels": labels, "plan": plan,
            "ref_plan": ref_plan, "p0": p0}


@pytest.fixture(scope="module")
def runs(cora):
    """Every rank's results (one spawn of 8), and meanwhile the stacked
    ops and trainers and the reference's trainers on the same inputs."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(cora["p0"], fh)
        join = child.start_ranks(child.directed_ranks_main, K, out)
        try:
            stacked = _stacked(cora)
            reference = _reference(cora)
        finally:
            ranks = join()
    return {"ranks": ranks, "stacked": stacked, "reference": reference}


def _stacked(cora):
    plan, p0 = cora["plan"], cora["p0"]
    out = {"gcn_op": {}, "gat_op": {}, "losses": {}, "params": {}}
    setup = resolve_forward_setup(plan)
    h, g = child.op_inputs(plan)
    for lever in child.GCN_GEN_OPS:
        out["gcn_op"][lever] = child.gcn_gen_op(plan, setup, lever, h, g)
    gsetup = resolve_forward_setup(plan, model="gat")
    for form, (fout, cd) in child.GAT_OP_CASES.items():
        hh, gg, params = child.gat_op_inputs(plan, fout)
        out["gat_op"][form] = child.gat_layer_run(plan, gsetup, hh, gg,
                                                  params, cd)
    data = make_train_data(plan, cora["feats"], cora["labels"])
    for case in CASES + ["partwise"]:
        kw = child.directed_kwargs("gcn-bf16" if case == "partwise"
                                   else case, p0)
        tr = FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                              lr=child.LR, device="cpu", **kw)
        if case == "partwise":
            _partwise_gen_bf16(tr)
        out["losses"][case] = [tr.step(data)
                               for _ in range(child.DIRECTED_STEPS)]
        out["params"][case] = [w.detach().numpy()
                               for w in tr.model.parameters()]
        if case == "gcn":
            out["report"] = tr.stats.report()
    return out


def _reference(cora):
    """The reference's asymmetric trainer per model, float32, five steps
    from the same weights, its k-fold step gradient (ROADMAP C3) measured
    on its first step and divided out of its optimizer."""
    ref_plan = cora["ref_plan"]
    rdata = ref_make_train_data(ref_plan, cora["feats"], cora["labels"])
    data = make_train_data(cora["plan"], cora["feats"], cora["labels"])
    out = {"factors": {}, "losses": {}}
    for model in ("gcn", "gat"):
        kw = dict(fin=child.FIN, widths=child.WIDTHS, seed=3, model=model,
                  activation="none" if model == "gat" else "relu")
        probe = RefTrainer(ref_plan, **kw, optimizer=optax.sgd(1.0))
        probe.step(rdata)
        tr = FullBatchTrainer(cora["plan"], fin=child.FIN,
                              widths=child.WIDTHS, device="cpu", model=model,
                              activation=kw["activation"],
                              params=cora["p0"][model])
        tr._one_step(data)
        w0 = (cora["p0"][model][0]["w"] if model == "gat"
              else cora["p0"][model][0])
        w1 = probe.params[0]["w"] if model == "gat" else probe.params[0]
        g = tr.model.layer_params()[0]
        g = (g["w"] if model == "gat" else g).grad.detach().numpy()
        factor = float(np.linalg.norm(w0 - np.asarray(w1))
                       / np.linalg.norm(g))
        out["factors"][model] = factor
        ref = RefTrainer(ref_plan, **kw, optimizer=optax.chain(
            optax.scale(1.0 / round(factor)), optax.adam(child.LR)))
        out["losses"][model] = [ref.step(rdata)
                                for _ in range(child.DIRECTED_STEPS)]
    return out


@pytest.mark.parametrize("lever", list(child.GCN_GEN_OPS))
def test_gcn_aggregation_equals_stacked(runs, lever):
    """Each rank's directed GCN aggregation and its VJP equal the stacked
    ``PspmmTilesGen``'s rows for its part bit for bit: float32, a bf16
    wire both ways (``halo_dtype``) and bf16 rows (``compute_dtype``)."""
    want_f, want_g = runs["stacked"]["gcn_op"][lever]
    for r in range(K):
        got_f, got_g = runs["ranks"][r]["gcn_op"][lever]
        np.testing.assert_array_equal(got_f[0], want_f[r])
        np.testing.assert_array_equal(got_g[0], want_g[r])


@pytest.mark.parametrize("form", list(child.GAT_OP_CASES))
def test_gat_layer_equals_stacked(runs, form):
    """Each rank's directed GAT layer and its VJP in ``h`` equal the
    stacked ``GatLayerGen``'s rows for its part bit for bit, in every
    table form (fused, split, packed bf16, fused on bf16 tables)."""
    want_f, want_g = runs["stacked"]["gat_op"][form]
    for r in range(K):
        got_f, got_g = runs["ranks"][r]["gat_op"][form]
        np.testing.assert_array_equal(got_f[0], want_f[r])
        np.testing.assert_array_equal(got_g[0], want_g[r])


def test_reverse_exchange_waits_after_the_local_transpose(runs):
    """The rank's launch and wait order of one directed aggregation: the
    forward issues its exchange, runs the local family, waits, runs the
    halo family; the backward runs the halo-ᵀ family, issues the reverse
    exchange, runs the local-ᵀ family while it is in flight, then waits
    and runs the weight-1 family.  No pack runs for the reverse side."""
    want = ["issue", "family", "wait", "family",
            "family", "rev-issue", "family", "rev-wait", "family"]
    for r in range(K):
        assert runs["ranks"][r]["order"] == want


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_bits(runs, case):
    """After five steps every rank holds rank 0's losses and weights bit
    for bit (the all-reduces give every rank the same sums)."""
    ranks = runs["ranks"]
    for r in range(1, K):
        assert ranks[r]["losses"][case] == ranks[0]["losses"][case]
        for a, b in zip(ranks[r]["params"][case], ranks[0]["params"][case]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_five_steps_track_the_stacked_trainer(runs, case):
    """Losses within rtol 1e-6 of the stacked trainer's and the weights
    within 1e-5 for 99 % of the entries and 5e-3 for all (the bounds of
    ``tests/test_torch_ranks_gat.py``): the weight gradients are each
    rank's float32 partial, all-reduced in another order than the
    stacked sum.  GCN under ``compute_dtype`` rounds each rank's partial
    to bf16 before the all-reduce: it is held to the stacked trainer with
    those rounding points (``_partwise_gen_bf16``) and shown to differ
    from the plain stacked step."""
    ranks, stacked = runs["ranks"], runs["stacked"]
    want_case = "partwise" if case == "gcn-bf16" else case
    got, want = ranks[0]["losses"][case], stacked["losses"][want_case]
    print(f"{case}: ranks {got} stacked ({want_case}) {want}")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(ranks[0]["params"][case], stacked["params"][want_case]):
        gap = np.abs(a - b)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3
    if case == "gcn-bf16":
        assert got != stacked["losses"][case]


def test_reference_step_gradient_scale_is_measured(runs):
    """The reference's asymmetric step-gradient factor (ROADMAP C3), per
    model: 1 or k = 8, measured, not assumed."""
    for model, factor in runs["reference"]["factors"].items():
        print(f"{model}: factor {factor!r}")
        assert round(factor) in (1, K)
        assert factor == pytest.approx(round(factor), rel=1e-3)


@pytest.mark.parametrize("case,rtol", [("gcn", 1e-5), ("gat", 5e-5)])
def test_five_float32_steps_track_the_reference(runs, case, rtol):
    """Rank 0's float32 losses against the reference's asymmetric trainer
    (``pspmm_overlap``, ``gat_layer_local``) from the same weights with
    ``optax.scale(1/factor)``: GCN within rtol 1e-5, GAT within 5e-5, and
    falling."""
    got = runs["ranks"][0]["losses"][case]
    want = runs["reference"]["losses"][case]
    print(f"{case}: ranks {got} reference {want}")
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]


def test_bf16_gat_step_gradient_tracks_float64(runs, cora):
    """The packed bf16 GAT on 8 ranks: rank 0's step-1 weight gradients
    (all-reduced) of ``w`` and ``a2`` within ``BF16_GRAD_RTOL`` (relative
    Frobenius, per layer) of the float64 autograd of the same function,
    ``a1``'s exactly 0 — not the reference's, whose packed gradient drops
    the feature lanes' share (ROADMAP C5)."""
    grads = runs["ranks"][0]["grads"]["gat-bf16"]
    # the GAT module's parameters: w per layer, then a1, then a2
    nl = len(child.WIDTHS)
    want = _dense_gat64_grads(cora["ahat"], cora["feats"], cora["labels"],
                              cora["p0"]["gat"])
    for i in range(nl):
        assert not grads[nl + i].any()
        for key, got in (("w", grads[i]), ("a2", grads[2 * nl + i])):
            rel = float(np.linalg.norm(got - want[i][key])
                        / np.linalg.norm(want[i][key]))
            print(f"layer {i} d{key}: relative gap to float64 {rel:.3g}")
            assert rel <= BF16_GRAD_RTOL
    assert np.isfinite(runs["ranks"][0]["losses"]["gat-bf16"]).all()


def test_job_report_books_the_reverse_exchange(runs, cora):
    """On 8 ranks the job's comm report equals the stacked trainer's
    (every rank books the full plan's figures, the reverse backward's
    per-part maxima included), and a slice's own counters come from its
    halo layout (``CommStats.from_slice``): its receive volume and
    messages are the full plan's column for its part."""
    assert runs["ranks"][0]["report"] == runs["stacked"]["report"]
    plan = cora["plan"]
    full = CommStats.from_plan(plan)
    for r in (0, 5):
        part = CommStats.from_slice(shard_proxy_plan(plan, r))
        for name in ("send_volume_per_exchange", "send_msgs_per_exchange",
                     "recv_volume_per_exchange", "recv_msgs_per_exchange"):
            assert getattr(part, name)[0] == getattr(full, name)[r], name


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_directed_slice_trains_as_proxy_and_on_one_rank(cora, tmp_path,
                                                        model):
    """ROADMAP C8: the shard proxy of a directed plan — a slice trained
    stacked, without a group — built no trainer before (its comm
    counters raised, a slice receiving other rows than it sends); now it
    trains, its counters from the slice's halo layout, and a one-rank
    gloo group on the same slice (the reverse ``all_to_all_single`` to
    itself) gives its losses and weights bit for bit."""
    from sgcn_tpu_torch.parallel import init_rank_group, shard_proxy_data

    sl = shard_proxy_plan(cora["plan"], 3)
    data = shard_proxy_data(cora["plan"], 3, cora["feats"], cora["labels"])
    kw = child.directed_kwargs(model, cora["p0"])
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        out = []
        for group in (None, mesh):
            tr = FullBatchTrainer(sl, fin=child.FIN, widths=child.WIDTHS,
                                  lr=child.LR, device="cpu", mesh=group, **kw)
            out.append(([tr.step(data) for _ in range(2)],
                        [w.detach().clone() for w in tr.model.parameters()],
                        tr.stats.report()))
    finally:
        mesh.close()
    assert out[0][0] == out[1][0] and np.isfinite(out[0][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    # two steps of a forward and a backward exchange a layer; the reverse
    # backward receives what the forward sent
    full = CommStats.from_plan(cora["plan"])
    assert out[0][2]["total_recv_volume"] == 2 * len(child.WIDTHS) * int(
        full.recv_volume_per_exchange[3] + full.send_volume_per_exchange[3])


def test_reverse_send_buffer_is_the_all_to_all_layout(cora):
    """On each part's slice, the first ``k·S`` rows of the halo-ᵀ
    launch's output are, in order, what an ``all_to_all_single`` with
    equal splits of ``S`` must send: chunk ``q`` goes to part ``q``, and
    exchanging the chunks (part ``p``'s chunk ``q`` to part ``q``'s slot
    ``p``) gives the stacked reverse pack by ``rev_src`` row for row —
    slot ``q·S + t`` of part ``c`` holds the partial for row
    ``send_idx[q, c, t]`` of part ``q``.  The slice's ``rev_src`` is the
    identity over those rows (its one-rank loopback)."""
    from sgcn_tpu_torch.ops.pspmm import reverse_exchange
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_classes

    plan = cora["plan"]
    k, s = plan.k, plan.s
    st = resolve_forward_setup(plan).fwd_static
    g = torch.tensor(child.op_inputs(plan)[1])
    th = [torch.as_tensor(getattr(plan, f"ptile_th{x}"))
          for x in ("src", "ld", "w")]
    send_rev = spmm_tiles_classes(*th, g, st["pallas_thclasses"],
                                  st["pallas_tb"])
    want = reverse_exchange(send_rev, torch.as_tensor(plan.rev_src))
    chunks = send_rev[:, : k * s].reshape(k, k, s, -1)
    got = chunks.transpose(0, 1).reshape(k, k * s, -1)
    assert torch.equal(got, want)
    for c in (0, 5):
        sl = shard_proxy_plan(plan, c)
        assert np.array_equal(sl.rev_src, np.arange(k * s)[None])
        own = spmm_tiles_classes(
            *[torch.as_tensor(getattr(sl, f"ptile_th{x}"))
              for x in ("src", "ld", "w")], g[c: c + 1],
            st["pallas_thclasses"], st["pallas_tb"])
        assert torch.equal(own[0, : k * s], send_rev[c, : k * s])
