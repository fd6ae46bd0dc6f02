"""The ELL aggregators on the rank runtime (ROADMAP A2d):
``SGCN_PALLAS_SPMM=0`` with one gloo process per part, on cora2708 under
its 8-part hp partition and on the directed cora of
``tests/test_torch_asym.py``.

The chain layout of a one-part slice (``parallel/plan.py::
ell_chain_layout`` on ``shard_proxy_plan``'s slice) is part c's entries
of the stacked layout, re-based to the slice's own buffers, for every
layout.  One module-scoped spawn of 8 gloo ranks
(``tests/torch_rank_child.py::ell_ranks_main``) runs, per
``child.ELL_CASES`` case — GCN on the a2a, the ring, the bf16 wire, under
``compute_dtype`` and ``remat``, and directed; GAT in the fused form on
the a2a and the ring, the packed form, the split form (fin 24, fout 128)
and directed — the trainer's model forward and its VJP in the features,
then two training steps; then the train CLI's ``main()`` under
torchrun's variables.  Meanwhile the parent runs the stacked ELL trainer
on the same seeded inputs, the JAX reference's ELL trainer, a one-rank
gloo group on part slices against the stacked proxy, and the
one-process CLI.

What each comparison holds:

  * a rank's forward rows and its features' gradient equal the stacked
    model's rows for its part bit for bit (the slice's chains are the
    stacked chains of the part, in the same stored order; GAT's ``cg`` is
    the all-reduced max);
  * a one-rank group on a slice equals the stacked proxy of the slice bit
    for bit, losses and weights, in every case;
  * on 8 ranks every rank holds the same losses and weights, the ring and
    ``remat`` equal the a2a bit for bit, and the steps track the stacked
    trainer within the rank tests' float32 bounds (losses rtol 1e-6;
    weights within 1e-5 for 99 % of the entries, 5e-3 for all): the
    loss's count and each weight gradient are all-reduced over the ranks,
    which sums in another order than the stacked sum over the parts.  GCN
    under ``compute_dtype`` is held to a stacked emulation of the rank
    path's rounding points (each part's weight gradient a bf16 matmul
    output of its own, as ``tests/test_torch_ranks_gat.py`` does);
  * the stacked ELL trainer tracks the reference's ELL trainer within
    rtol 1e-5 / atol 1e-6 (losses) and the parity tests' weight rule,
    the reference's optimizer scaled by 1/8 (ROADMAP C3);
  * the CLI on 8 ranks reports as the one-process CLI does, and its step
    events carry the rank's roofline with the rank's wire bytes;
  * the modes that stay on the tiles still raise ``ELL_MODE_DEFERRAL`` on
    ranks, and the memory model and step cost price a rank's slice.
"""

import contextlib
import io
import json
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
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN, get_activation
from sgcn_tpu_torch.obs import load_run
from sgcn_tpu_torch.obs.attribution import step_cost
from sgcn_tpu_torch.obs.memory import MemoryBudgetError, memory_model
from sgcn_tpu_torch.ops.pspmm import ELL_MODE_DEFERRAL, ell_aggregate
from sgcn_tpu_torch.parallel import (RankGroup, init_rank_group,
                                     shard_proxy_plan)
from sgcn_tpu_torch.parallel.proxy import shard_proxy_data
from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                  resolve_forward_setup)
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer
from sgcn_tpu_torch.utils.stats import CommStats

import torch_rank_child as child

K = 8
CASES = list(child.ELL_CASES)
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")
CLI = ["--npz", child.NPZ, "--normalize", "-p",
       os.path.join(child.FIX, "cora2708.8.hp"), "-s", "8", "-l", "2",
       "--hidden", "16", "--epochs", "2", "--warmup", "0", "--device",
       "cpu"]
CLI_JOBS = {"gcn": ["--comm-schedule", "ragged"], "gat": ["--model", "gat"]}
# the parity tests' tolerances (tests/test_torch_ell.py)
TOL = dict(rtol=1e-5, atol=1e-6)
LAYOUTS = ("a2a", "ragged", "directed", "cell", "cell_t", "edge")


def _partwise_bf16(tr):
    """Point the stacked ELL GCN trainer ``tr`` (``compute_dtype``) at a
    forward that casts each weight to bf16 once per part, so part p's
    weight gradient is its own bf16 matmul output, widened and summed
    over the parts in float32: the rank path's rounding points.
    Otherwise ``models/gcn.py::gcn_forward_local``'s ELL forward."""
    m, st = tr.model, tr.model.fwd_static
    act, fact = (get_activation(m.activation),
                 get_activation(m.final_activation))

    def forward(h, pa):
        h = h.to(torch.bfloat16)
        nl = len(m.weights)
        for i, w in enumerate(m.weights):
            copies = [w.to(torch.bfloat16) for _ in range(h.shape[0])]

            def mm(x):
                return torch.stack([x[p] @ c for p, c in enumerate(copies)])

            def agg(x):
                return ell_aggregate(x, pa, st)
            if w.shape[1] < h.shape[-1] and \
                    h.shape[-1] >= PROJECT_FIRST_MIN_FIN:
                z = agg(mm(h))
            else:
                z = mm(agg(h))
            h = fact(z) if i == nl - 1 else act(z)
        return h

    m.forward = forward
    return tr


def _stacked(graphs):
    """Per case the stacked ELL trainer's model rows, its VJP digests per
    part and two steps, and GCN ``compute_dtype``'s two steps with the
    rank path's rounding points (``partwise``)."""
    out = {"rows": {}, "dh": {}, "losses": {}, "params": {}}
    for case in CASES + ["partwise"]:
        name = "gcn-bf16" if case == "partwise" else case
        plan = graphs[child.ELL_CASES[name][0]][0]
        tr = child.ell_trainer(plan, name)
        data = child.ell_data(graphs, name)
        assert tr.setup.aggregator == "ell"
        if case == "partwise":
            _partwise_bf16(tr)
        else:
            out["rows"][case], out["dh"][case] = child.ell_vjp(
                tr, data, child.ell_cotangent(plan, case))
        out["losses"][case] = [tr.step(data) for _ in range(child.ELL_STEPS)]
        out["params"][case] = [w.detach().numpy()
                               for w in tr.model.parameters()]
    return out


def _proxy_runs(graphs, parts=(0, 5)):
    """Per case and part: two steps of a one-rank gloo group on the
    part's slice and of the stacked trainer on the same slice."""
    out = {}
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        mesh = init_rank_group("file://" + os.path.join(d, "rdv"), 1, 0,
                               device="cpu")
        try:
            for case in CASES:
                graph = child.ELL_CASES[case][0]
                plan, feats, labels = graphs[graph]
                fin = child.ell_dims(case)[0]
                for c in parts:
                    sl = shard_proxy_plan(plan, c)
                    data = shard_proxy_data(plan, c, feats[:, :fin], labels)
                    runs = []
                    for m in (None, mesh):
                        tr = child.ell_trainer(sl, case, m)
                        runs.append(([tr.step(data)
                                      for _ in range(child.ELL_STEPS)],
                                     [w.detach().numpy()
                                      for w in tr.model.parameters()]))
                    out[case, c] = runs
        finally:
            mesh.close()
    return out


def _one_process(argv):
    """The train CLI in this process, no launcher variable: its standard
    output."""
    saved = {v: os.environ.pop(v) for v in LAUNCH_VARS if v in os.environ}
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_main(list(argv))
    finally:
        os.environ.update(saved)
    return buf.getvalue()


def _cli_output(stdout):
    """A train CLI's per-epoch losses (its ``epoch i: loss x`` lines) and
    its report (the last line)."""
    lines = stdout.strip().splitlines()
    return ([float(x.split()[-1]) for x in lines[:-1] if ": loss " in x],
            json.loads(lines[-1]))


def _reference_runs(graphs):
    """The reference's ELL trainer (``SGCN_PALLAS_SPMM=0``) per model, two
    steps on cora 8-hp from its seed-3 weights, its optimizer scaled by
    1/8 (ROADMAP C3): ``{model: (weights before, losses, weights
    after)}`` as numpy."""
    plan, feats, labels = graphs["sym"]
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), np.asarray(plan.owner),
                                   K)
    rdata = ref_make_train_data(ref_plan, feats, labels)
    out = {}
    for model in ("gcn", "gat"):
        ref = RefTrainer(ref_plan, fin=child.FIN, widths=child.WIDTHS,
                         model=model, seed=3, comm_schedule="a2a",
                         activation="none" if model == "gat" else "relu",
                         optimizer=optax.chain(optax.scale(1.0 / K),
                                               optax.adam(child.LR)))
        p0 = _ref_weights(ref.params)
        losses = [ref.step(rdata) for _ in range(child.ELL_STEPS)]
        out[model] = (p0, losses, _ref_weights(ref.params))
    return out


@pytest.fixture(scope="module")
def graphs():
    with child.ell_switch():
        return child.ell_graphs()


@pytest.fixture(scope="module")
def runs(graphs):
    """Every rank's results (one spawn of 8) and meanwhile the stacked
    runs, the one-rank proxies and the one-process CLI's reports."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        metrics = os.path.join(out, "metrics")
        jobs = {name: CLI + extra for name, extra in CLI_JOBS.items()}
        jobs["gcn"] = jobs["gcn"] + ["--metrics-out", metrics]
        with open(os.path.join(out, "jobs.pkl"), "wb") as fh:
            pickle.dump(jobs, fh)
        join = child.start_ranks(child.ell_ranks_main, K, out)
        try:
            with child.ell_switch():
                stacked = _stacked(graphs)
                proxy = _proxy_runs(graphs)
                one = {name: _one_process(CLI + extra)
                       for name, extra in CLI_JOBS.items()}
                ref = _reference_runs(graphs)
        finally:
            ranks = join()
        run = load_run(metrics)
    return {"ranks": ranks, "stacked": stacked, "proxy": proxy, "one": one,
            "run": run, "ref": ref}


# ----------------------------------------------------------- the slices
def _strides(plan):
    """Each chain family's (dst, src) part strides in the stacked layout:
    rows ``B``, the receive window ``k·S``, the ring concat, the
    ``[local; halo]`` table ``B + R``."""
    b, w, t = plan.b, plan.k * plan.s, plan.b + plan.r
    st = plan.ring_src.shape[1] if plan.ring_src is not None else 1
    return {"ltail": (b, b), "hedge": (b, w), "redge": (b, st),
            "ledge": (b, b), "ledge_t": (b, b), "hedge_t": (w, b),
            "owner": (b, w), "chub": (b, t), "cl_t": (b, b),
            "ch_t": (w, b), "edge": (b, t)}


def _part_chain(chains, name, c, dst_stride, src_stride):
    """Part ``c``'s entries of a stacked chain family, re-based, with
    their level sizes, the part's empty levels dropped (the ring's
    levels are its rounds' one after another: a round's tail of levels
    the part does not reach)."""
    dst = chains[f"{name}_dst"].astype(np.int64)
    mine = dst // dst_stride == c
    out = {f"{name}_dst": dst[mine] - c * dst_stride,
           f"{name}_src": (chains[f"{name}_src"].astype(np.int64)[mine]
                           - c * src_stride)}
    if f"{name}_w" in chains:
        out[f"{name}_w"] = chains[f"{name}_w"][mine]
    sizes, off = [], 0
    for n in chains[f"{name}_levels"]:
        sizes.append(int(mine[off: off + n].sum()))
        off += n
    out[f"{name}_levels"] = tuple(n for n in sizes if n)
    return out


def _part_slots(src, w, buckets, k, c, base):
    """Part ``c``'s runs of a stacked slot layout (each slot of a bucket
    one ``(k·nb)`` run), sources re-based by ``c·base``."""
    srcs, ws, off = [], [], 0
    for nb, wb in buckets:
        for _t in range(wb):
            run = slice(off + c * nb, off + (c + 1) * nb)
            srcs.append(src[run].astype(np.int64) - c * base)
            ws.append(w[run])
            off += k * nb
    return np.concatenate(srcs), np.concatenate(ws)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slice_chains_are_the_stacked_parts_entries(graphs, layout):
    """For every layout and every part c, the slice's chain arrays are
    exactly the stacked layout's entries of part c, re-based to the
    slice's own buffers, in the same order and levels; its exchange
    arrays are the slice's send pack and halo gather, and its reverse
    pack the loopback's."""
    plan = graphs["dir" if layout in ("directed", "cell_t") else "sym"][0]
    plan.ensure_ell_chains(layout)
    full = plan.ell_chains[layout]
    strides = _strides(plan)
    for c in range(plan.k):
        sl = shard_proxy_plan(plan, c)
        got = sl.ell_chains[layout]
        want = {}
        for name in {x.rsplit("_", 1)[0] for x in full
                     if x.endswith("_levels")}:
            want.update(_part_chain(full, name, c, *strides[name]))
        for src, w, buckets, base in (
                ("ell_src", "ell_w", plan.ell_buckets, plan.b),
                ("cell_src", "cell_m", plan.cell_buckets,
                 plan.b + plan.r)):
            if src in full:
                want[src], want[w] = _part_slots(full[src], full[w], buckets,
                                                 plan.k, c, base)
        for name in ("recv_src", "ring_src", "halo_src_flat"):
            if name in full:
                want[name] = getattr(sl, name)
        if "rev_src" in full:
            want["rev_src"] = np.arange(plan.k * plan.s)[None]
        assert sorted(got) == sorted(full) == sorted(want), layout
        for name, v in want.items():
            if name.endswith("_levels"):
                assert got[name] == v, (layout, c, name)
            else:
                assert np.array_equal(np.asarray(got[name]), v), \
                    (layout, c, name)


def test_slice_builds_no_layout_of_its_own(graphs):
    """A slice lays out its chains over the layouts built on the full
    plan; one the full plan lacks raises naming the order (build it
    before ``shard_proxy_plan``)."""
    _ahat, _f, _l, _pv, plan = child.cora_plan("cora2708.8.hp")
    sl = shard_proxy_plan(plan, 2)
    assert sl.ell_chains is None
    with pytest.raises(ValueError, match="BEFORE shard_proxy_plan"):
        sl.ensure_ell_chains("cell")
    sl.ensure_ell_chains("a2a")
    assert set(sl.ell_chains) == {"a2a"}


# -------------------------------------------------------------- 8 ranks
@pytest.mark.parametrize("case", CASES)
def test_rank_runs_its_slices_chains(runs, graphs, case):
    """Each rank's trainer selects the ELL aggregator and its levels are
    its own slice's chains'."""
    graph, model = child.ELL_CASES[case][:2]
    plan = graphs[graph][0]
    for r in range(K):
        agg, layout, levels = runs["ranks"][r]["setup"][case]
        sl = shard_proxy_plan(plan, r)
        want = {n[: -len("_levels")]: v
                for n, v in sl.ell_chains[layout].items()
                if n.endswith("_levels")}
        assert agg == "ell" and levels == want, (case, r)


@pytest.mark.parametrize("case", CASES)
def test_rank_rows_and_vjp_equal_stacked_bit_for_bit(runs, case):
    """Each rank's model forward rows and its features' gradient (the
    VJP of the rank's part of one cotangent) equal the stacked model's
    rows for its part bit for bit."""
    want_rows = runs["stacked"]["rows"][case]
    want_dh = runs["stacked"]["dh"][case]
    for r in range(K):
        got = runs["ranks"][r]["rows"][case]
        assert got.shape == want_rows[r: r + 1].shape
        assert np.array_equal(got.view(np.int32),
                              want_rows[r: r + 1].view(np.int32)), (case, r)
        assert runs["ranks"][r]["dh"][case] == [want_dh[r]], (case, r)


@pytest.mark.parametrize("case", CASES)
def test_one_rank_on_a_slice_equals_the_stacked_proxy(runs, case):
    """A one-rank gloo group on a part's slice trains that slice equal to
    the stacked trainer on it bit for bit, losses and weights (parts 0
    and 5)."""
    for c in (0, 5):
        (sl, sw), (rl, rw) = runs["proxy"][case, c]
        assert rl == sl, (case, c)
        assert all(np.array_equal(a, b) for a, b in zip(rw, sw)), (case, c)


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_bits(runs, case):
    for r in range(1, K):
        assert runs["ranks"][r]["losses"][case] == \
            runs["ranks"][0]["losses"][case]
        for a, b in zip(runs["ranks"][r]["params"][case],
                        runs["ranks"][0]["params"][case]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("pair", [("gcn-ring", "gcn-a2a"),
                                  ("gcn-remat", "gcn-a2a"),
                                  ("gat-ring", "gat-a2a")])
def test_ring_and_remat_equal_the_a2a_on_ranks(runs, pair):
    """On the ranks the ring's steps and ``remat``'s equal the a2a's
    plain steps bit for bit, losses and weights."""
    got, want = (runs["ranks"][0] for _ in range(2))
    assert got["losses"][pair[0]] == want["losses"][pair[1]]
    for a, b in zip(got["params"][pair[0]], want["params"][pair[1]]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_steps_track_the_stacked_ell_trainer(runs, case):
    """Two steps on 8 ranks against the stacked ELL trainer: losses
    within rtol 1e-6, weights within 1e-5 for 99 % of the entries and
    5e-3 for all (GCN under ``compute_dtype`` against the stacked
    emulation of its rounding points)."""
    want_case = "partwise" if case == "gcn-bf16" else case
    got = runs["ranks"][0]
    want = runs["stacked"]
    gaps = [float(np.abs(a - b).max()) for a, b in zip(
        got["params"][case], want["params"][want_case])]
    print(f"{case}: ranks {got['losses'][case]} stacked "
          f"{want['losses'][want_case]}; max weight gap {max(gaps):.3g}")
    np.testing.assert_allclose(got["losses"][case],
                               want["losses"][want_case], rtol=1e-6)
    for a, b in zip(got["params"][case], want["params"][want_case]):
        gap = np.abs(a - b)
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


def _ref_weights(params):
    return [{k: np.asarray(v) for k, v in p.items()} if isinstance(p, dict)
            else np.asarray(p) for p in params]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_stacked_ell_trainer_tracks_the_reference(runs, graphs, model,
                                                  monkeypatch):
    """The stacked ELL trainer (the ranks' yardstick) against the JAX
    reference's trainer under the same switch, two steps from the
    reference's weights on cora 8-hp: losses within rtol 1e-5 / atol
    1e-6, the weights by the parity tests' rule (99 % within 1e-5, all
    within half a step), the reference's optimizer scaled by 1/8
    (ROADMAP C3)."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    plan, feats, labels = graphs["sym"]
    p0, want, ref_after = runs["ref"][model]
    tr = FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                          model=model, lr=child.LR, params=p0, device="cpu",
                          activation="none" if model == "gat" else "relu")
    assert tr.setup.aggregator == "ell"
    data = make_train_data(plan, feats, labels)
    got = [tr.step(data) for _ in range(child.ELL_STEPS)]
    print(f"{model}: port {got} reference {want}")
    np.testing.assert_allclose(got, want, **TOL)
    for mine, theirs in zip(tr.params, ref_after):
        pairs = ([(mine[n], theirs[n]) for n in ("w", "a1", "a2")]
                 if model == "gat" else [(mine, theirs)])
        for w, rw in pairs:
            gap = np.abs(w.detach().numpy() - np.asarray(rw))
            assert np.mean(gap <= 1e-5) >= 0.99
            assert gap.max() <= 0.5 * child.LR


@pytest.mark.parametrize("job", sorted(CLI_JOBS))
def test_train_cli_on_ranks_under_ell(runs, job):
    """``main`` on 8 ranks under ``SGCN_PALLAS_SPMM=0``: rank 0 prints
    its step lines and one report whose losses are within rtol 1e-6 of
    the one-process CLI's and whose comm figures equal its; the other
    ranks print nothing."""
    ranks = runs["ranks"]
    assert ranks[0]["cli"][job]["exit"] is None
    losses, rep = _cli_output(ranks[0]["cli"][job]["stdout"])
    want_losses, want = _cli_output(runs["one"][job])
    for r in range(1, K):
        assert ranks[r]["cli"][job] == {"stdout": "", "exit": None}
    print(f"{job}: ranks {losses} one process {want_losses}")
    assert len(losses) == 2
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for key in ("total_send_volume", "max_send_volume", "total_recv_volume",
                "exchanges", "wire_rows_total", "comm_schedule",
                "halo_bytes_wire_total", "model"):
        assert rep[key] == want[key], key


def test_cli_step_events_book_the_ranks_roofline(runs, graphs):
    """The CLI's run directory on 8 ranks (rank 0's): the decision log
    names the ELL aggregator, and each step event carries ``roofline``
    and ``measured_vs_model``, its wire bytes the rank's ``CommStats``'
    and its FLOPs the reference's per-chip figure (the full plan's)."""
    run = runs["run"]
    assert run.manifest["comm_schedule"]["aggregator"]["chosen"] == "ell"
    steps = run.steps()
    assert len(steps) == 2
    plan = graphs["sym"][0]
    full = step_cost(plan, child.FIN, child.WIDTHS, comm_schedule="ragged")
    for s in steps:
        roof = s["roofline"]
        assert roof["halo_bytes_wire_per_step"] == \
            s["comm"]["halo_bytes_wire_per_step"] > 0
        assert roof["model_step_GFLOP"] == float(
            f"{full.step_flops / 1e9:.6g}")
        assert s["measured_vs_model"]["components"]


# ----------------------------------------------- pricing and refusals
def test_step_cost_of_a_rank_is_per_chip_with_its_own_wire(graphs):
    """``step_cost(full, halo_plan=slice)``: the full plan's per-chip
    FLOPs and gather bytes (the reference's figures for any chip), the
    slice's true and wire rows, what its ``CommStats`` books; a slice
    alone prices its gathers over every peer's bucket."""
    plan = graphs["sym"][0]
    full = step_cost(plan, child.FIN, child.WIDTHS)
    for c in (0, 3):
        sl = shard_proxy_plan(plan, c)
        cost = step_cost(plan, child.FIN, child.WIDTHS, halo_plan=sl)
        stats = CommStats.from_plan(sl, lane_widths=cost.widths)
        stats.count_step(nlayers=2)
        assert cost.step_flops == full.step_flops
        assert cost.gather_bytes == full.gather_bytes
        assert cost.halo_wire_rows == sl.wire_rows_per_exchange() == \
            plan.k * plan.s
        assert cost.halo_bytes_wire_per_step == stats.halo_bytes_wire_total
        assert cost.halo_bytes_true_per_step == stats.halo_bytes_true_total
        own = step_cost(sl, child.FIN, child.WIDTHS)
        assert own.gather_bytes == full.gather_bytes   # same tl, eh, buckets
        assert own.halo_send_rows == int(sl.predicted_send_volume.sum())


@pytest.mark.parametrize("graph,model", [("sym", "gcn"), ("dir", "gcn"),
                                         ("sym", "gat"), ("dir", "gat")])
def test_rank_memory_model_and_budget_gate_price_the_slice(graphs, graph,
                                                           model,
                                                           monkeypatch):
    """A rank's ELL memory model prices its slice: its own chain arrays
    and ``slot_temps`` over its ``(1, k·S)`` window; the budget gate
    refuses a rank's trainer before any collective runs."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    plan = graphs[graph][0]
    plan.ensure_cell()                  # the GAT's layout, before slicing
    sl = shard_proxy_plan(plan, 1)
    setup = resolve_forward_setup(sl, model=model)
    mm = memory_model(sl, child.FIN, child.WIDTHS, model=model,
                      setup=setup, ranks=True)
    fam = mm.families
    assert fam["slot_temps"] > 0 and fam["pallas_tiles"] == 0
    shipped = setup.ship_arrays(sl, "cpu")
    assert fam["plan_arrays"] == sum(t.numel() * t.element_size()
                                     for t in shipped.values())
    with pytest.raises(MemoryBudgetError):
        FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                         model=model, mesh=RankGroup(1, K, "cpu"),
                         memory_budget=fam["slot_temps"])


def test_tile_only_modes_still_raise_on_ranks(graphs, monkeypatch):
    """Under ``SGCN_PALLAS_SPMM=0`` on ranks the stale and replica
    trainers, the mini-batch trainer and the sub-graph server still
    raise ``ELL_MODE_DEFERRAL``, before anything ships."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    plan = graphs["sym"][0]
    mesh = RankGroup(0, K, "cpu")
    for kw, mode in (({"halo_staleness": 1}, "stale-halo trainer"),
                     ({"replica_budget": "auto"}, "replica trainer")):
        with pytest.raises(ValueError) as err:
            FullBatchTrainer(plan, fin=child.FIN, widths=child.WIDTHS,
                             mesh=mesh, **kw)
        assert str(err.value) == ELL_MODE_DEFERRAL.format(mode=mode)
    _ahat, _f, _l, pv, _p = child.cora_plan("cora2708.8.hp")
    with pytest.raises(ValueError) as err:
        MiniBatchTrainer(_ahat, pv, K, fin=child.FIN, widths=child.WIDTHS,
                         batch_size=512, mesh=mesh)
    assert str(err.value) == ELL_MODE_DEFERRAL.format(
        mode="mini-batch trainer")
