"""The port's memory model (``sgcn_tpu_torch/obs/memory.py``) and its
``--memory-budget`` gate, against the live tensors and the reference.

* The argument families (params, Adam's moments, features, the shipped
  plan arrays, the carries) equal the bytes of the tensors the trainer
  and the engine really hold, to the byte, across the modes (exact and
  ragged, GAT, the precision levers, stale, replica, partial refresh, the
  composed mode, the directed backward, serving full and sub-graph).
* Family by family against the reference's model of the same plan: the
  params are equal, the per-part families are ``k`` times the
  reference's per-chip figures (the port stacks the k parts on one
  device), Adam's moments are the reference's less optax's step count.
* One rank of a rank group in each carried mode (a one-rank gloo group
  on a part's slice): its argument families equal its live tensors,
  under delta with the senders' baselines beside the carries, and its
  scratch prices the shrunken receive and the side channels; on a
  directed plan its scratch prices the backward's reverse exchange, and
  the mini-batch trainer on a rank prices its part's batch slices.
* ``CommPlan.wire_buffer_shapes`` == the reference's on every plan
  (both transports, with and without replicas).
* ``parse_bytes`` == the reference's on valid and invalid sizes, and the
  budget message is the reference's.
* ``--memory-budget`` on both CLIs via ``main()``: over the model's total
  the run passes, under it the run exits with the message before any
  tensor ships.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgcn_tpu.obs import memory as ref_memory
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu_torch.io.datasets import er_graph, load_npz_dataset
from sgcn_tpu_torch.obs import memory as port_memory
from sgcn_tpu_torch.obs.memory import (ARGUMENT_FAMILIES, MemoryBudgetError,
                                       MemoryModel, check_memory_budget,
                                       parse_bytes, reconcile)
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import balanced_random_partition, read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.serve import ServeEngine
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer
from sgcn_tpu_torch.train.__main__ import main as train_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
HP4 = os.path.join(FIX, "cora2708.4.hp")
WIDTHS = [16, 7]


def _directed(a):
    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    rows = np.where(flip, up.col, up.row)
    cols = np.where(flip, up.row, up.col)
    return sp.csr_matrix((np.ones(up.nnz, np.float32), (rows, cols)),
                         shape=a.shape)


@pytest.fixture(scope="module")
def cora(tmp_path_factory):
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": plan,
            "directed": build_comm_plan(normalize_adjacency(_directed(a)),
                                        pv, 8),
            "data": make_train_data(plan, feats, labels),
            "tmp": tmp_path_factory.mktemp("memory")}


MODES = {
    "gcn-a2a": dict(),
    "gcn-ragged": dict(comm_schedule="ragged"),
    "gat-a2a": dict(model="gat", activation="none"),
    "gat-ragged": dict(model="gat", activation="none",
                       comm_schedule="ragged"),
    "gcn-compute-bf16": dict(compute_dtype="bfloat16"),
    "gcn-halo-bf16": dict(halo_dtype="bfloat16"),
    "gcn-remat": dict(remat=True),
    "stale-a2a": dict(halo_staleness=1, sync_every=2),
    "stale-delta-ragged": dict(halo_staleness=1, halo_delta=True,
                               comm_schedule="ragged"),
    "replica-a2a": dict(replica_budget=64, sync_every=2),
    "replica-ragged-halo-bf16": dict(replica_budget=64,
                                     comm_schedule="ragged",
                                     halo_dtype="bfloat16"),
    "replica-band": dict(replica_budget=64, sync_every=2,
                         refresh_band=0.1),
    "replica-stale": dict(replica_budget=64, halo_staleness=1),
    "gcn-directed": dict(directed=True),
    "gat-directed": dict(model="gat", activation="none", directed=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_argument_families_equal_live_tensor_bytes(cora, mode):
    """After two steps (Adam's state exists) every argument family of the
    trainer's model equals the bytes of the tensors it holds for it, to
    the byte; the memory block written at the second step carries the
    same figures as its per-family measured side."""
    kw = dict(MODES[mode])
    plan = cora["directed"] if kw.pop("directed", False) else cora["plan"]
    data = (cora["data"] if plan is cora["plan"] else
            make_train_data(plan, cora["feats"], cora["labels"]))
    tr = FullBatchTrainer(plan, fin=cora["feats"].shape[1], widths=WIDTHS,
                          device="cpu", **kw)
    for _ in range(2):
        tr.step(data)
    live = tr.resident_bytes(data)
    fams = tr.memory.families
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    gat = kw.get("model") == "gat"
    assert (fams["halo_tables"] > 0) == gat and fams["workspace"] > 0
    join = tr.publish_memory(None, data)
    assert join["ok"] and join["violations"] == []
    for fam in ARGUMENT_FAMILIES:
        if fam in join["block"]["families"]:
            e = join["block"]["families"][fam]
            assert e["measured_bytes"] == e["model_bytes"]
    assert join["block"]["total"]["measured_bytes"] is None   # CPU


RANK_MODES = ("stale-a2a", "stale-delta-ragged", "replica-a2a",
              "replica-ragged-halo-bf16", "replica-band", "replica-stale")


@pytest.mark.parametrize("mode", RANK_MODES)
def test_rank_carried_families_equal_live_tensor_bytes(cora, mode,
                                                       tmp_path):
    """One rank of a rank group (a one-rank gloo group on part 3's slice:
    the collectives a loopback) after two steps of a carried mode: every
    argument family equals the bytes the rank holds for it, to the byte —
    under ``halo_delta`` the senders' float32 baselines beside the
    carries, which the stacked layout's one tensor serves for both;
    the scratch adds the shrunken receive (replica modes) and the partial
    refresh's side channels to the stacked slice's, and the layout is
    recorded."""
    from sgcn_tpu_torch.parallel import (init_rank_group, shard_proxy_data,
                                         shard_proxy_plan)

    kw = dict(MODES[mode])
    plan = cora["plan"]
    plan.ensure_pallas_tiles()
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    if kw.get("replica_budget"):
        plan.ensure_replicas(kw["replica_budget"])
    sl = shard_proxy_plan(plan, 3)
    data = shard_proxy_data(plan, 3, cora["feats"], cora["labels"])
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        tr = FullBatchTrainer(sl, fin=cora["feats"].shape[1],
                              widths=WIDTHS, mesh=mesh, **kw)
        for _ in range(2):
            tr.step(data)
        tr._settle_carries()
        live = tr.resident_bytes(data)
    finally:
        mesh.close()
    fams = tr.memory.families
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    stacked = port_memory.memory_model(
        sl, cora["feats"].shape[1], WIDTHS, setup=tr.setup,
        halo_staleness=kw.get("halo_staleness", 0),
        halo_delta=kw.get("halo_delta", False),
        halo_dtype=kw.get("halo_dtype"),
        refresh_band=kw.get("refresh_band"))
    assert tr.memory.config["layout"] == "ranks"
    assert stacked.config["layout"] == "stacked"
    from sgcn_tpu_torch.models.gcn import exchange_widths
    fs = exchange_widths(cora["feats"].shape[1], WIDTHS)
    rows = int(np.prod(sl.recv_layout_shape(tr.comm_schedule)))
    base = (4 * rows * sum(fs)) if kw.get("halo_delta") else 0
    assert fams["halo_carries"] == stacked.families["halo_carries"] + base
    extra = fams["wire_buffers"] - stacked.families["wire_buffers"]
    assert (extra > 0) == bool(kw.get("replica_budget"))


DIRECTED_RANK_MODES = ("gcn-directed", "gat-directed",
                       "gcn-directed-compute-bf16")


@pytest.mark.parametrize("mode", DIRECTED_RANK_MODES)
def test_rank_directed_families_equal_live_tensor_bytes(cora, mode,
                                                        tmp_path):
    """One rank of a rank group on a directed plan (a one-rank gloo group
    on part 3's slice): after two steps every argument family equals the
    bytes the rank holds (its slice's transposed tiles among the shipped
    ones), and the scratch adds the backward's reverse exchange to the
    stacked slice's: the halo-ᵀ launch's float32 output, the receive
    buffer in the wire's dtype and, on a bf16 wire, the narrowed send
    copy."""
    from sgcn_tpu_torch.parallel import (init_rank_group, shard_proxy_data,
                                         shard_proxy_plan)
    from sgcn_tpu_torch.train import resolve_forward_setup

    kw = dict(MODES[mode.replace("-compute-bf16", "")])
    kw.pop("directed")
    if mode.endswith("compute-bf16"):
        kw["compute_dtype"] = "bfloat16"
    model = kw.get("model", "gcn")
    plan = cora["directed"]
    resolve_forward_setup(plan, model=model)
    sl = shard_proxy_plan(plan, 3)
    data = shard_proxy_data(plan, 3, cora["feats"], cora["labels"])
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        tr = FullBatchTrainer(sl, fin=cora["feats"].shape[1],
                              widths=WIDTHS, mesh=mesh, **kw)
        for _ in range(2):
            tr.step(data)
        live = tr.resident_bytes(data)
    finally:
        mesh.close()
    fams = tr.memory.families
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    assert any(f.startswith("ptile_t") for f in tr.pa)
    stacked = port_memory.memory_model(
        sl, cora["feats"].shape[1], WIDTHS, setup=tr.setup, model=model,
        compute_dtype=kw.get("compute_dtype"))
    st = tr.setup.fwd_static
    th = st["pallas_tchclasses" if model == "gat" else "pallas_thclasses"]
    out_rows = sum(t for t, *_ in th) * st["pallas_tb"]
    fmax = max(tr.setup.lane_widths_fn(cora["feats"].shape[1], WIDTHS,
                                       kw.get("compute_dtype")))
    wire = 2 if kw.get("compute_dtype") and model == "gcn" else 4
    slots = sl.k * sl.s
    want = (out_rows * 4 + (2 if wire == 2 else 1) * slots * wire) * fmax
    assert fams["wire_buffers"] - stacked.families["wire_buffers"] == want
    assert tr.memory.config["layout"] == "ranks"


def test_rank_minibatch_families_equal_live_tensor_bytes(cora, tmp_path):
    """The mini-batch trainer on one rank (``part=3`` on a one-rank gloo
    group): it prices its part's slice of every batch plan and its part's
    rows of every batch, to the byte against the live tensors after two
    steps; the plan families are the sum over the slices, the features
    the batch count times one slice's."""
    from sgcn_tpu_torch.obs.memory import memory_model, shipped_bytes
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        tr = _minibatch(cora, part=3, mesh=mesh)
        batches = tr.make_batches(cora["feats"], cora["labels"])
        for b in batches[:2]:
            tr.step(b)
        live = tr.resident_bytes()
    finally:
        mesh.close()
    fams, setup = tr.memory.families, tr.inner.setup
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    assert all(p.chip_ids is not None and p.k == 1 for p in tr.slices)
    assert fams["plan_arrays"] + fams["pallas_tiles"] == sum(
        sum(shipped_bytes(setup, p)) for p in tr.slices)
    one = memory_model(tr.slices[0], cora["feats"].shape[1], WIDTHS,
                       setup=setup, ranks=True).families
    assert fams["features"] == len(tr.slices) * one["features"]
    assert tr.memory.config["layout"] == "ranks"


@pytest.mark.parametrize("mode", ["full", "subgraph"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_serve_families_equal_live_tensor_bytes(cora, mode, model):
    """A serve engine's argument families (params, features — a sub-graph
    engine's ``(n + 1, fin)`` rows too — and the shipped plan arrays)
    equal its live tensors' bytes; it prices no optimizer state."""
    eng = ServeEngine(cora["plan"], fin=cora["feats"].shape[1],
                      widths=WIDTHS, model=model, device="cpu", mode=mode,
                      max_batch=8)
    eng.set_features(cora["feats"])
    eng.warmup(np.arange(8))
    live = eng.resident_bytes()
    fams = eng.memory.families
    assert eng.memory.workload == ("serve_subgraph" if mode == "subgraph"
                                   else "serve")
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    assert fams["opt_state"] == 0
    assert eng.memory_join["ok"]
    g = eng.gauges()["memory"]
    assert g["analytic"] and g["model_bytes"] == eng.memory.total_bytes
    assert "measured" not in g                  # nothing measured on CPU


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_families_against_reference_per_chip_model(cora, model):
    """Family by family against the reference's model of the same plan
    and mode (never the totals: the port prices one device holding all k
    parts): params equal; Adam's moments the reference's less optax's
    4-byte count; the feature rows k times the reference's (the port's
    labels are int64 and it keeps an eval mask beside the train mask);
    the halo tables 0 for GCN (the fused entry folds in place), for GAT's
    a2a exchange its ``(k, R)`` halo rows and the ``[p ‖ u]`` table over
    the local and halo rows at the widest lane width."""
    fin, k = cora["feats"].shape[1], 8
    ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), cora["pv"], k)
    act = {} if model == "gcn" else {"activation": "none"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGCN_PALLAS_SPMM", "1")
        ref = RefTrainer(ref_plan, fin=fin, widths=WIDTHS, model=model,
                         **act).memory.families
    port = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS,
                            model=model, device="cpu", **act)
    fams, b = port.memory.families, cora["plan"].b
    assert fams["params"] == ref["params"]
    assert fams["opt_state"] == ref["opt_state"] - 4
    assert fams["features"] - k * b * 16 == k * (ref["features"] - 2 * b * 4)
    plan = cora["plan"]
    assert fams["halo_tables"] == (
        0 if model == "gcn" else
        8 * (b + 2 * plan.r) * (WIDTHS[0] + 1) * 4)
    assert port.memory.config["layout"] == "stacked"
    assert port.memory.config["parts_per_device"] == k


MB_MODES = {
    "gcn-a2a": dict(),
    "gcn-ragged": dict(comm_schedule="ragged"),
    "gat-a2a": dict(model="gat", activation="none"),
    "gcn-compute-bf16": dict(compute_dtype="bfloat16"),
}


def _minibatch(cora, **kw):
    return MiniBatchTrainer(normalize_adjacency(cora["a"]), cora["pv"], 8,
                            fin=cora["feats"].shape[1], widths=WIDTHS,
                            batch_size=1024, device="cpu", **kw)


@pytest.mark.parametrize("mode", list(MB_MODES))
def test_minibatch_families_equal_live_tensor_bytes(cora, mode):
    """The mini-batch trainer prices what it keeps on the device: every
    batch plan's shipped arrays and tiles (plan 0's once, shared with the
    inner trainer) and every batch's data, to the byte against the live
    tensors after two recorded steps; the plan families are the sum over
    the batch plans, the features the batch count times one batch's, the
    scratch families the envelope plan's."""
    from sgcn_tpu_torch.obs import RunRecorder, load_run
    from sgcn_tpu_torch.obs.memory import memory_model, shipped_bytes

    tr = _minibatch(cora, **MB_MODES[mode])
    batches = tr.make_batches(cora["feats"], cora["labels"])
    with RunRecorder(str(cora["tmp"] / mode)) as rec:
        tr.attach_recorder(rec)
        for b in batches[:2]:
            tr.step(b)
    live, fams = tr.resident_bytes(), tr.memory.families
    for fam in ARGUMENT_FAMILIES:
        assert fams.get(fam, 0) == live.get(fam, 0), (fam, fams, live)
    setup = tr.inner.setup
    one = memory_model(tr.plans[0], cora["feats"].shape[1], WIDTHS,
                       model=setup.model, setup=setup,
                       compute_dtype=tr.inner.compute_dtype).families
    nb = len(tr.plans)
    assert nb == 9 and tr.memory.config["nbatches"] == nb
    assert fams["plan_arrays"] + fams["pallas_tiles"] == sum(
        sum(shipped_bytes(setup, p)) for p in tr.plans)
    assert fams["features"] == nb * one["features"]
    for fam in ("params", "opt_state", "wire_buffers", "halo_tables",
                "workspace"):
        assert fams[fam] == one[fam], fam
    assert tr.memory_join["ok"]
    manifest = load_run(str(cora["tmp"] / mode)).manifest
    assert manifest["memory"]["total"]["model_bytes"] == \
        tr.memory.total_bytes


def test_minibatch_budget_gate_before_anything_ships(cora):
    """A budget one byte under the mini-batch total raises the
    reference's message from ``__init__`` before any plan array ships or
    any parameter is drawn; a budget the envelope plan alone would meet
    (one plan's arrays, one batch's data) raises too; the total passes."""
    from sgcn_tpu_torch.train.fullbatch import ForwardSetup

    total = _minibatch(cora).memory.total_bytes
    one_plan = FullBatchTrainer(
        _minibatch(cora).plans[0], fin=cora["feats"].shape[1],
        widths=WIDTHS, device="cpu").memory.total_bytes
    assert one_plan < total
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        real = ForwardSetup.ship_arrays
        mp.setattr(ForwardSetup, "ship_arrays",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        for budget in (total - 1, one_plan):
            with pytest.raises(MemoryBudgetError) as ei:
                _minibatch(cora, memory_budget=budget)
            assert calls == []
            assert str(ei.value).startswith(
                f"gcn mini-batch trainer: analytic per-chip HBM footprint "
                f"{total:,} B exceeds --memory-budget {budget:,} B "
                "(workload=train)")
        _minibatch(cora, memory_budget=total)
        assert calls == [1]


def _plans():
    a, _, _ = load_npz_dataset(NPZ)
    er = er_graph(600, avg_deg=8, seed=1)
    pv_er = balanced_random_partition(600, 8, seed=2)
    return {
        "cora-8hp": (normalize_adjacency(a), read_partvec(HP8), 8),
        "cora-4hp": (normalize_adjacency(a), read_partvec(HP4), 4),
        "cora-directed": (normalize_adjacency(_directed(a)),
                          read_partvec(HP8), 8),
        "er-8rp": (normalize_adjacency(er), pv_er, 8),
    }


@pytest.mark.parametrize("name", ["cora-8hp", "cora-4hp", "cora-directed",
                                  "er-8rp"])
def test_wire_buffer_shapes_equal_reference(name):
    """``wire_buffer_shapes`` == the reference's on both transports, and
    on a symmetric plan with replicas (budget 32) too; the port's receive
    layout beside it holds every sender's padded bucket (a2a) or the
    ring's concat (ragged)."""
    ahat, pv, k = _plans()[name]
    port = build_comm_plan(ahat, pv, k)
    ref = ref_build_comm_plan(ahat, pv, k)
    for plan in (port, ref):
        plan.ensure_ragged()
    for sched in ("a2a", "ragged"):
        assert port.wire_buffer_shapes(sched) == ref.wire_buffer_shapes(sched)
    assert port.recv_layout_shape("a2a") == (k, k * port.s)
    assert port.recv_layout_shape("ragged") == (
        k, max(1, sum(port.rr_sizes)))
    if port.symmetric:
        for plan in (port, ref):
            plan.ensure_replicas(32)
        for sched in ("a2a", "ragged"):
            assert port.wire_buffer_shapes(sched, replica=True) == \
                ref.wire_buffer_shapes(sched, replica=True)
    with pytest.raises(ValueError, match="unknown comm schedule"):
        port.wire_buffer_shapes("ring")


@pytest.mark.parametrize("text", [
    "1024", "2K", "16G", "1.5M", "2KB", "3t", " 7 ", "", "abc", "-1", "0",
    "nan", "inf", "1e3", "2GB"])
def test_parse_bytes_equals_reference(text):
    try:
        want = ref_memory.parse_bytes(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_bytes(text)
        assert str(got.value) == str(e)
        return
    assert parse_bytes(text) == want


def test_budget_message_equals_reference():
    """The same families give the reference's message and table, byte for
    byte; under the total and with no budget the gate passes; a budget of
    0 is refused."""
    fams = {"params": 1000, "opt_state": 2004, "features": 40_000,
            "plan_arrays": 512, "pallas_tiles": 4096, "halo_tables": 0,
            "wire_buffers": 2048, "workspace": 70_000}
    port = MemoryModel(workload="train", families=dict(fams),
                       overlays={"pad_overhead_bytes": 12})
    ref = ref_memory.MemoryModel(workload="train", families=dict(fams),
                                 overlays={"pad_overhead_bytes": 12})
    with pytest.raises(ref_memory.MemoryBudgetError) as want:
        ref_memory.check_memory_budget(ref, 1024, what="gcn trainer")
    with pytest.raises(MemoryBudgetError) as got:
        check_memory_budget(port, 1024, what="gcn trainer")
    assert str(got.value) == str(want.value)
    assert port.table() == ref.table()
    assert port.block() == ref.block()
    check_memory_budget(port, port.total_bytes)
    check_memory_budget(port, None)
    with pytest.raises(ValueError, match="> 0"):
        check_memory_budget(port, 0)


def test_reconcile_contract():
    """``reconcile`` holds the reference's contract on a measured step:
    the peak under total × tol, the arguments under the model + 256 B,
    the alias at or over params + Adam to train and 0 to serve."""
    fams = {"params": 100, "opt_state": 200, "features": 1000,
            "workspace": 5000}
    train = MemoryModel(workload="train", families=fams)
    ok = {"argument_bytes": 1300, "temp_bytes": 2000, "alias_bytes": 300,
          "peak_bytes": 3300}
    assert reconcile(train, ok)["ok"]
    assert reconcile(train, None)["ok"]
    for bad, word in ((dict(ok, peak_bytes=20_000), "exceeds the analytic"),
                      (dict(ok, argument_bytes=1300 + 257), "argument"),
                      (dict(ok, alias_bytes=299), "alias")):
        res = reconcile(train, bad)
        assert not res["ok"] and word in res["violations"][0]
    serve = MemoryModel(workload="serve", families=fams)
    assert not reconcile(serve, ok)["ok"]
    assert reconcile(serve, dict(ok, alias_bytes=0))["ok"]
    blk = reconcile(train, ok, resident={"params": 100})["block"]
    assert blk["families"]["params"]["ratio"] == 1.0
    assert blk["total"]["measured_bytes"] == 3300


def test_trainer_budget_gate_before_anything_ships(cora):
    """A budget one byte under the model's total raises the reference's
    message from ``__init__`` before the model is built (no parameter
    drawn, no plan array shipped); the total itself passes."""
    fin = cora["feats"].shape[1]
    tr = FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS,
                          device="cpu")
    total = tr.memory.total_bytes
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        from sgcn_tpu_torch.train.fullbatch import ForwardSetup
        real = ForwardSetup.ship_arrays
        mp.setattr(ForwardSetup, "ship_arrays",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        with pytest.raises(MemoryBudgetError) as ei:
            FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS,
                             memory_budget=total - 1, device="cpu")
        assert calls == []
        FullBatchTrainer(cora["plan"], fin=fin, widths=WIDTHS,
                         memory_budget=total, device="cpu")
        assert calls == [1]
    msg = str(ei.value)
    assert msg.startswith(f"gcn trainer: analytic per-chip HBM footprint "
                          f"{total:,} B exceeds --memory-budget "
                          f"{total - 1:,} B (workload=train)")
    assert "TOTAL" in msg and "workspace" in msg


def test_train_cli_memory_budget(capsys, tmp_path):
    """``--memory-budget`` on the train CLI (full-batch and ``-n``): a
    budget under the total exits with the message, over it the run
    trains; a value that is no size is an argparse error with the
    reference's message."""
    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
            "--hidden", "16", "--epochs", "1", "--warmup", "0",
            "--device", "cpu"]
    for extra in ([], ["-n", "1024"]):
        with pytest.raises(SystemExit) as exc:
            train_main(base + extra + ["--memory-budget", "1M"])
        assert "exceeds --memory-budget 1,048,576 B" in str(exc.value.code)
        assert "per-family breakdown" in str(exc.value.code)
    train_main(base + ["--memory-budget", "1G"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["epochs"] == 1
    with pytest.raises(SystemExit) as exc:
        train_main(base + ["--memory-budget", "lots"])
    assert exc.value.code == 2
    assert "is not BYTES or a K/M/G/T-suffixed size" in \
        capsys.readouterr().err


def test_serve_cli_memory_budget(capsys):
    """``--memory-budget`` on the serve CLI: under the total exits with
    the engine's message, over it the report carries the memory block
    (the analytic total and its families)."""
    base = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
            "--random-init", "-l", "1", "--queries", "8", "--max-batch",
            "8", "--buckets", "8", "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        serve_main(base + ["--memory-budget", "1K"])
    assert str(exc.value.code).startswith(
        "gcn serve engine (full): analytic per-chip HBM footprint")
    serve_main(base + ["--memory-budget", "4G"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mem = rep["memory"]
    assert mem["analytic"] and mem["model_bytes"] > 0
    assert mem["features_bytes"] == 8 * 392 * 1433 * 4
    assert rep["forwards"] == 2


def test_device_bytes_none_off_the_card():
    """Off the card nothing is measured: ``device_bytes`` is ``None`` and
    ``measure_device_step`` runs the step and returns ``None``."""
    ran = []
    assert port_memory.device_bytes("cpu") is None
    assert port_memory.measure_device_step(lambda: ran.append(1), "cpu",
                                           None) is None
    assert ran == [1]
    assert torch.device("cpu").type == "cpu"
