"""The step cost model and its reconciliation against the reference's.

``sgcn_tpu_torch/obs/attribution.py`` and the reconciliation functions of
``sgcn_tpu_torch/obs/tracing.py`` are the reference's, with the card's two
ceilings (``STREAM_CEILING_GBS``, ``LINK_CEILING_GBS``) in place of the
TPU's.  These tests hold, on cora2708 8-hp (and its replica layout):

  * ``step_cost`` (GCN and GAT, a2a and ragged, ``compute_dtype``, the
    wire itemsize pairs, ``replica=True``), ``gather_bytes_per_epoch``,
    ``_exchange_gather_rows``, ``forward_flops`` and
    ``subgraph_batch_flops`` equal to the reference's, field for field;
  * ``roofline_fields``, ``add_partial_refresh``, ``exchange_join`` and
    ``measured_vs_model_block`` equal to the reference's with the ceilings
    set equal for the comparison;
  * an ELL trainer's step events (``SGCN_PALLAS_SPMM=0``) carry both
    blocks, the stacked parts' cost, their wire bytes equal to
    ``CommStats``' per-step bytes exactly; a tile step's carry neither;
  * an ELL ``--metrics-out`` run directory loads through the reference's
    ``sgcn_tpu.obs.load_run`` (every record re-validated against its
    schema).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from sgcn_tpu.obs import attribution as ref_attr
from sgcn_tpu.obs import load_run as ref_load_run
from sgcn_tpu.obs import tracing as ref_tracing
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs import RunRecorder, load_run
from sgcn_tpu_torch.obs import attribution as attr
from sgcn_tpu_torch.obs import tracing
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
FIN, WIDTHS = 1433, [16, 7]


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    port = build_comm_plan(normalize_adjacency(a), pv, 8)
    ref = ref_build_comm_plan(ref_normalize(a), pv, 8)
    for p in (port, ref):
        p.ensure_ragged()
        p.ensure_replicas(64)
    return {"port": port, "ref": ref, "feats": feats, "labels": labels}


# name: step_cost kwargs
COSTS = {
    "gcn-a2a": {},
    "gcn-ragged": {"comm_schedule": "ragged"},
    "gcn-compute-bf16": {"compute_dtype": "bfloat16"},
    "gcn-wire-2": {"wire_itemsize": 2},
    "gcn-wire-pair": {"wire_itemsize": (4, 2)},
    "gcn-wire-pair-none": {"wire_itemsize": (2, None)},
    "gcn-replica": {"replica": True},
    "gcn-replica-ragged": {"replica": True, "comm_schedule": "ragged"},
    "gat-a2a": {"model": "gat"},
    "gat-ragged": {"model": "gat", "comm_schedule": "ragged"},
    "gat-compute-bf16": {"model": "gat", "compute_dtype": "bfloat16"},
}


@pytest.mark.parametrize("case", list(COSTS))
def test_step_cost_equals_the_references(cora, case):
    """``step_cost`` field for field (per layer included), and
    ``stacked_cost`` scales the per-chip gathers and FLOPs by k only."""
    kw = COSTS[case]
    got = attr.step_cost(cora["port"], FIN, WIDTHS, **kw)
    want = ref_attr.step_cost(cora["ref"], FIN, WIDTHS, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    st = attr.stacked_cost(got, 8)
    assert (st.gather_bytes, st.step_flops, st.spmm_flops,
            st.dense_flops) == (8 * got.gather_bytes, 8 * got.step_flops,
                                8 * got.spmm_flops, 8 * got.dense_flops)
    assert st.halo_bytes_wire_per_step == got.halo_bytes_wire_per_step
    assert attr.stacked_cost(got, 1) is got


@pytest.mark.parametrize("schedule", ["a2a", "ragged"])
def test_gather_bytes_and_flop_counts_equal_the_references(cora, schedule):
    port, ref = cora["port"], cora["ref"]
    assert attr._exchange_gather_rows(port, schedule) == \
        ref_attr._exchange_gather_rows(ref, schedule)
    for isize in (2, 4):
        assert attr.gather_bytes_per_epoch(port, FIN, WIDTHS, isize,
                                           schedule) == \
            ref_attr.gather_bytes_per_epoch(ref, FIN, WIDTHS, isize, schedule)
    for model in ("gcn", "gat"):
        assert attr.forward_flops(port, FIN, WIDTHS, model) == \
            ref_attr.forward_flops(ref, FIN, WIDTHS, model)
        assert attr.subgraph_batch_flops(37, 412, FIN, WIDTHS, model) == \
            ref_attr.subgraph_batch_flops(37, 412, FIN, WIDTHS, model)


def test_roofline_and_reconciliation_equal_with_equal_ceilings(
        cora, monkeypatch):
    """With the reference's ceilings set on the port (655 GB/s, 50 GB/s),
    ``roofline_fields`` (exact, stale-like and no exchange counts),
    ``add_partial_refresh``, ``exchange_join`` and
    ``measured_vs_model_block`` (with and without a trace) are the
    reference's, key for key."""
    monkeypatch.setattr(attr, "STREAM_CEILING_GBS",
                        ref_attr.STREAM_CEILING_GBS)
    monkeypatch.setattr(attr, "LINK_CEILING_GBS", ref_attr.ICI_CEILING_GBS)
    got = attr.step_cost(cora["port"], FIN, WIDTHS, replica=True)
    want = ref_attr.step_cost(cora["ref"], FIN, WIDTHS, replica=True)
    for wall, ex, exposed in ((0.0123, 4, 4), (0.5, 4, 0), (1e-7, 0, 0)):
        assert attr.roofline_fields(got, wall, ex, exposed) == \
            ref_attr.roofline_fields(want, wall, ex, exposed)
    rows = [17, 3]
    pg = attr.add_partial_refresh(got, rows, 96, 4, 2)
    pw = ref_attr.add_partial_refresh(want, rows, 96, 4, 2)
    assert dataclasses.asdict(pg) == dataclasses.asdict(pw)
    with pytest.raises(ValueError, match="per-layer counts"):
        attr.add_partial_refresh(got, [1], 96, 4, 2)
    trace = {"exposed_comm_s": 3.5e-4, "comm_s": 5e-4}
    for per_step in (trace, {}):
        assert tracing.exchange_join(per_step, 123456.0) == \
            ref_tracing.exchange_join(per_step, 123456.0)
    for kw in ({}, {"phase_total_s": 0.02},
               {"trace_per_step": trace, "exposed_halo_bytes": 98765}):
        assert tracing.measured_vs_model_block(got, 0.0123, **kw) == \
            ref_tracing.measured_vs_model_block(want, 0.0123, **kw)


def test_the_ceilings_are_the_cards():
    """The port prices with the card's measured stream rate and the
    NVLink 4 datasheet rate per direction, never the TPU's figures."""
    assert attr.STREAM_CEILING_GBS == 2488.0
    assert attr.LINK_CEILING_GBS == 450.0
    assert attr.STREAM_CEILING_GBS != ref_attr.STREAM_CEILING_GBS
    assert attr.LINK_CEILING_GBS != ref_attr.ICI_CEILING_GBS


@pytest.mark.parametrize("lever", [None, "halo_dtype", "compute_dtype"])
def test_ell_step_events_book_the_cost_and_reconcile_with_comm_stats(
        cora, lever, tmp_path, monkeypatch):
    """Under ``SGCN_PALLAS_SPMM=0`` every step event carries ``roofline``
    and ``measured_vs_model``: the stacked parts' cost (8 × the per-chip
    gathers), every exchange exposed, the wire bytes per step equal to
    ``CommStats``' exactly, and the gather join's ratio the roofline's
    fraction inverted; the same trainer on the tile kernel books neither
    (float32)."""
    port = cora["port"]
    kw = {} if lever is None else {lever: "bfloat16"}
    data = make_train_data(port, cora["feats"], cora["labels"])
    for env in ("0", None) if lever is None else ("0",):
        if env is None:
            monkeypatch.delenv("SGCN_PALLAS_SPMM")
        else:
            monkeypatch.setenv("SGCN_PALLAS_SPMM", env)
        tr = FullBatchTrainer(port, FIN, WIDTHS, device="cpu", **kw)
        d = str(tmp_path / f"run{env}")
        rec = RunRecorder(d, config={})
        tr.attach_recorder(rec)
        for _ in range(2):
            tr.step(data)
        rec.close()
        steps = load_run(d).steps()
        if env is None:
            assert not any("roofline" in s or "measured_vs_model" in s
                           for s in steps)
            continue
        cost = attr.step_cost(
            port, FIN, WIDTHS, compute_dtype=kw.get("compute_dtype"),
            wire_itemsize=(2, 2) if lever == "halo_dtype" else None)
        for s in steps:
            roof, mvm = s["roofline"], s["measured_vs_model"]
            assert roof["halo_bytes_wire_per_step"] == \
                s["comm"]["halo_bytes_wire_per_step"]
            assert roof["halo_bytes_true_per_step"] == \
                s["comm"]["halo_bytes_true_per_step"]
            assert roof["gather_GB"] == float(
                f"{8 * cost.gather_bytes / 1e9:.6g}")
            assert roof["exposed_comm_frac"] == 1.0
            assert roof["exposed_halo_bytes"] == \
                roof["halo_bytes_wire_per_step"]
            gs = mvm["components"]["gather_stream"]
            assert gs["measured_s"] == pytest.approx(s["wall_s"], rel=1e-5)
            assert gs["ratio"] == pytest.approx(
                1 / roof["stream_ceiling_frac"], rel=1e-3)


def test_ell_run_dir_loads_in_the_reference(tmp_path, monkeypatch, capsys):
    """The train CLI under ``SGCN_PALLAS_SPMM=0`` with ``--metrics-out``:
    the run directory loads through the reference's ``load_run`` (every
    record re-validated against its schema), each step with its roofline
    and ``measured_vs_model`` blocks and the ELL choice in the manifest's
    decision log."""
    monkeypatch.setenv("SGCN_PALLAS_SPMM", "0")
    d = str(tmp_path / "ell")
    train_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l",
                "2", "--hidden", "16", "--epochs", "2", "--warmup", "1",
                "--device", "cpu", "--metrics-out", d])
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = ref_load_run(d)
    assert log.events == load_run(d).events
    steps = log.steps()
    assert len(steps) == 3
    assert all("roofline" in s and "measured_vs_model" in s for s in steps)
    assert log.manifest["comm_schedule"]["aggregator"]["chosen"] == "ell"
