"""The port's static-analysis tool on the CPU (``sgcn_tpu_torch/analysis``):
the launch and collective census of every supported mode, the AST
hygiene pass, the mode matrix against the reference's, and the expected
exchanges against the reference's own expectations.

One module-scoped census of the full matrix (the CPU's plain versions
record at the same hooks as the card's kernels) is shared by the cases;
each seeded mutation re-censuses one mode and must fail with its rule's
name.  Rank modes run here as one gloo rank on part 0's slice; a group
of k ranks is ``tests/test_torch_ranks_analysis.py``.
"""

import itertools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sgcn_tpu_torch.analysis import ast_rules, build_report, census, expect
from sgcn_tpu_torch.analysis import modes as pm
from sgcn_tpu_torch.analysis.__main__ import main as analysis_main
from sgcn_tpu_torch.ops import pspmm as ps
from sgcn_tpu_torch.ops import tile_spmm as ts
from sgcn_tpu_torch.ops.row_shuffle import row_pack
from sgcn_tpu_torch.train import FullBatchTrainer
from sgcn_tpu_torch.utils import census as hooks

AST_RULES = {r.name for r in ast_rules.RULES}
SRC_PKG = os.path.dirname(os.path.dirname(os.path.abspath(census.__file__)))


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def report(one_thread):
    """The full census of the port's matrix and the banded ring modes, on
    the CPU, with the AST pass."""
    return build_report(device="cpu")


def _rules(entry) -> set:
    rules = {v["rule"] for prog in entry["programs"].values()
             for v in prog["violations"]}
    assert rules <= set(census.CENSUS_RULES), rules
    return rules


def _census(mode, kind="er"):
    return census.census_mode(mode, "cpu", kind=kind)


# ------------------------------------------------------------ clean at HEAD
def test_report_clean_and_complete(report):
    assert report["schema"] == "sgcn_analysis_report" and report["v"] == 1
    assert report["ok"], json.dumps(
        {k: v for k, v in report["census"]["modes"].items() if not v["ok"]},
        indent=1)[:4000]
    want = {m.mode_id for m in pm.supported_modes()} | {
        m.mode_id + "@banded" for m in pm.banded_modes()}
    assert set(report["census"]["modes"]) == want
    assert report["census"]["n_modes"] == len(want) == 104
    assert set(report["ast"]["rules"]) == AST_RULES
    # the census names its rules, and every violation a seeded mutation
    # below raises is one of them
    assert report["census"]["rules"] == list(census.CENSUS_RULES)
    assert report["ast"]["files"] > 60
    assert report["torch"] == torch.__version__


@pytest.mark.parametrize("mode_id", sorted(
    [m.mode_id for m in pm.supported_modes()]
    + [m.mode_id + "@banded" for m in pm.banded_modes()]))
def test_mode_census_clean(report, mode_id):
    """Every mode's census is clean and not vacuous: its steps launched,
    and a rank mode issued collectives."""
    entry = report["census"]["modes"][mode_id]
    assert entry["ok"], entry
    for label, prog in entry["programs"].items():
        c = prog["census"]
        assert c["launches"], (mode_id, label)
        assert bool(c["collectives"]) == mode_id.endswith("/ranks"), c
        if "/ell" in mode_id:
            assert set(c["launches"]) <= {"pack", "pack-into"}, c


def test_banded_ring_keeps_two_rounds(report):
    """The banded fixture's ring packs only its 2 live rounds of k−1."""
    plan = census.audit_plan("banded")
    live = ps.ragged_live_rounds(plan.ragged_round_sizes())
    assert len(live) == 2 < census.AUDIT_K - 1
    sizes = plan.ragged_round_sizes()
    rows = sum(sizes[d - 1] for d in live)
    c = report["census"]["modes"]["train/gcn/ragged/s0/f32@banded"]
    shapes = c["programs"]["step"]["census"]["shapes"]["pack"]
    assert shapes == [f"8x{rows}x8:f32"] * 3


# ---------------------------------------------------------------- mutations
_BF16 = pm.Mode("train", "gcn", "a2a", halo_dtype="bfloat16")


def test_f32_pack_under_bf16_fails_wire_dtype(monkeypatch, one_thread):
    monkeypatch.setattr(ps, "_wire", lambda h, halo_dtype: h.dtype)
    assert "wire-dtype" in _rules(_census(_BF16))


def test_extra_pack_fails_exchange_census(monkeypatch, one_thread):
    orig = ts.exchange_recv

    def twice(h, recv_src, halo_dtype=None):
        orig(h, recv_src, halo_dtype)
        return orig(h, recv_src, halo_dtype)
    monkeypatch.setattr(ts, "exchange_recv", twice)
    rules = _rules(_census(pm.Mode("train", "gcn", "a2a")))
    assert {"exchange-census", "launch-census"} <= rules


def test_missing_live_round_fails_exchange_census(monkeypatch, one_thread):
    orig = ps._rank_issue

    def drop_last(pack, mesh, rr_sizes=None):
        if rr_sizes is not None:
            rr_sizes = tuple(rr_sizes[:-1]) + (0,)
        return orig(pack, mesh, rr_sizes)
    monkeypatch.setattr(ps, "_rank_issue", drop_last)
    mode = pm.Mode("train", "gcn", "ragged", ranks=True)
    assert "exchange-census" in _rules(_census(mode))


def test_replica_step_shipping_full_rows_fails(monkeypatch, one_thread):
    plan = census.audit_plan()
    plan.ensure_exchange()
    recv_src = torch.as_tensor(plan.recv_src)

    def full_rows(carry, x, keep_src, keep_dst, wire_dtype=None):
        wire = ps.narrow_dtype(wire_dtype) or x.dtype
        carry.copy_(row_pack(x.contiguous(), recv_src, wire))
        return carry
    monkeypatch.setattr(ts, "replica_pack", full_rows)
    rules = _rules(_census(pm.Mode("train", "gcn", "a2a", replica=True)))
    assert {"exchange-census", "wire-shape"} <= rules


def test_host_read_in_the_step_fails_host_sync(monkeypatch, one_thread):
    monkeypatch.setattr(FullBatchTrainer, "_note_grad_norm", lambda self: float(
        next(self.model.parameters()).grad.sum()))
    assert _rules(_census(pm.Mode("train", "gcn", "a2a"))) == {"host-sync"}


def test_reallocated_parameter_fails_in_place(monkeypatch, one_thread):
    def realloc(self):
        p = next(self.model.parameters())
        p.data = p.data.clone()
    monkeypatch.setattr(FullBatchTrainer, "_note_grad_norm", realloc)
    assert _rules(_census(pm.Mode("train", "gcn", "a2a"))) == {"in-place"}


def test_halo_table_fails_halo_materialization(monkeypatch, one_thread):
    r = census.audit_plan().r
    orig = ts.ring_concat

    def with_table(h, ring_src, rr_sizes, halo_dtype=None):
        row_pack(h.contiguous(), torch.zeros((h.shape[0], r), dtype=torch.int32),
                 h.dtype)
        return orig(h, ring_src, rr_sizes, halo_dtype)
    monkeypatch.setattr(ts, "ring_concat", with_table)
    rules = _rules(_census(pm.Mode("train", "gcn", "ragged")))
    assert "halo-materialization" in rules


def test_wait_before_local_pass_fails_overlap_order(monkeypatch, one_thread):
    orig = ts._split_on

    def waited_first(h, arrived, tiles):
        table = arrived()
        return orig(h, lambda: table, tiles)
    monkeypatch.setattr(ts, "_split_on", waited_first)
    rules = _rules(_census(pm.Mode("train", "gcn", "a2a", ranks=True)))
    assert rules == {"overlap-order"}


def test_unknown_launch_raises_and_idle_hooks_record_nothing():
    hooks.launch("K9", (1,), torch.float32, torch.device("cpu"))  # idle
    assert not hooks.active()
    with hooks.recording() as recs:
        with pytest.raises(ValueError, match="unknown kernel launch"):
            hooks.launch("K9", (1,), torch.float32, torch.device("cpu"))
        with pytest.raises(ValueError, match="unknown collective"):
            hooks.collective("all_to_all_v")
        hooks.collective("wait")
    assert [r.label for r in recs] == ["wait"]
    with pytest.raises(RuntimeError, match="already open"):
        with hooks.recording(), hooks.recording():
            pass


# ---------------------------------------------------------------- AST rules
_SEEDED = {
    "traced-host-free": ("sgcn_tpu_torch/ops/pspmm.py",
                         "\ndef _noise(x):\n    return x + torch.randn(3)\n"),
    "sanctioned-sync-only": ("sgcn_tpu_torch/train/fullbatch.py",
                             "\ndef _wait():\n    torch.cuda.synchronize()\n"),
    "consumer-registered": ("sgcn_tpu_torch/models/gcn.py",
                            '\nNEW_PLAN_FIELDS = ("recv_src", "owner")\n'),
    "mode-flag-enumerated": ("sgcn_tpu_torch/serve/__main__.py",
                             '\ndef _extra(p):\n    p.add_argument('
                             '"--halo-shrink", type=int)\n'),
}


@pytest.mark.parametrize("rule", sorted(_SEEDED))
def test_seeded_ast_violation_fails_its_rule(rule, tmp_path):
    """A copy of the package with one seeded violation fails exactly that
    rule."""
    shutil.copytree(SRC_PKG, tmp_path / "sgcn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, src = _SEEDED[rule]
    with open(tmp_path / rel, "a") as fh:
        fh.write(src)
    out = ast_rules.run_ast_pass(str(tmp_path))
    failed = {name for name, e in out["rules"].items() if not e["ok"]}
    assert failed == {rule}, out
    assert any(rel in v for v in out["rules"][rule]["violations"])


def test_rules_read_torch_spellings():
    """The torch forms of each rule: a draw with its own generator and a
    sync through the backend pass; aliases and Event/Stream waits do
    not."""
    ok = ("import torch\ng = torch.Generator()\n"
          "x = torch.rand(3, generator=g)\n")
    assert not ast_rules.rule_traced_host_free("sgcn_tpu_torch/ops/a.py", ok)
    bad = ("from torch import randperm\nimport time as t\n"
           "def f():\n    t.perf_counter()\n    torch.manual_seed(0)\n"
           "    return randperm(4)\n")
    assert len(ast_rules.rule_traced_host_free("sgcn_tpu_torch/ops/a.py",
                                               bad)) == 3
    waits = "def f(ev, s):\n    ev.synchronize()\n    s.synchronize()\n"
    assert len(ast_rules.rule_sanctioned_sync_only("sgcn_tpu_torch/obs/a.py",
                                                   waits)) == 2
    fine = ("from ..utils.backend import synchronize\n"
            "def f(d):\n    synchronize(d)\n")
    assert not ast_rules.rule_sanctioned_sync_only("sgcn_tpu_torch/obs/a.py",
                                                   fine)
    # the kernels' nvcc build is outside the scope, with its reason
    assert "sgcn_tpu_torch/ops/_build.py" in ast_rules.TRACED_EXEMPT
    rule = {r.name: r for r in ast_rules.RULES}["traced-host-free"]
    assert not rule.applies("sgcn_tpu_torch/ops/_build.py")


# ----------------------------------------------------------------- the CLI
def _cli(monkeypatch, capsys, *args):
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu_torch.analysis", *args])
    threads = torch.get_num_threads()
    try:
        rc = analysis_main()
    finally:
        torch.set_num_threads(threads)
    return rc, capsys.readouterr().out


def test_cli_fast_json_clean(monkeypatch, capsys, tmp_path):
    out_file = tmp_path / "report.json"
    rc, out = _cli(monkeypatch, capsys, "--fast", "--json", "--device",
                   "cpu", "--out", str(out_file))
    rep = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rep["ok"] and rep["fast"]
    assert set(rep["census"]["modes"]) == {m.mode_id
                                           for m in pm.fast_modes()}
    assert json.loads(out_file.read_text()) == rep


def test_cli_seeded_census_mutation_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(ps, "_wire", lambda h, halo_dtype: h.dtype)
    rc, out = _cli(monkeypatch, capsys, "--fast", "--device", "cpu",
                   "--no-ast")
    assert rc == 1
    assert "wire-dtype" in out and "analysis: VIOLATIONS" in out


def test_cli_seeded_ast_mutation_exits_1(monkeypatch, capsys, tmp_path):
    shutil.copytree(SRC_PKG, tmp_path / "sgcn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, src = _SEEDED["sanctioned-sync-only"]
    with open(tmp_path / rel, "a") as fh:
        fh.write(src)
    orig = ast_rules.run_ast_pass
    monkeypatch.setattr(ast_rules, "run_ast_pass",
                        lambda root=None: orig(str(tmp_path)))
    rc, out = _cli(monkeypatch, capsys, "--no-census")
    assert rc == 1 and "sanctioned-sync-only" in out and "FAIL" in out


def test_memory_pass_refuses_the_cpu(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        _cli(monkeypatch, capsys, "--memory", "--device", "cpu")
    assert e.value.code == 2
    assert "nothing to measure on the CPU" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="nothing to measure on the CPU"):
        build_report(ast_pass=False, census=False, memory=True,
                     device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_report(ast_pass=False, fast=True)


# ------------------------------------------------------------- the matrix
def test_unsupported_modes_raise_their_reasons(one_thread):
    """Every combination outside the matrix is either a recorded coverage
    choice or refused by its constructor with the stated reason."""
    group = census.RankGroupHolder("cpu")
    checked = set()
    try:
        for combo in itertools.product(
                ("train", "serve", "serve_subgraph", "minibatch"),
                ("gcn", "gat"), ("a2a", "ragged"), (0, 1),
                (None, "bfloat16"), (False, True), (False, True),
                pm.AGGREGATORS, (False, True)):
            wl, model, sched, st, hd, delta, rep, agg, ranks = combo
            for form in ((None,) if model == "gcn" else pm.GAT_FORMS):
                m = pm.Mode(wl, model, sched, st, hd, delta, form, rep, agg,
                            ranks)
                ok, why = pm.is_supported(m)
                if ok or why in pm.COVERAGE_REASONS or why in checked:
                    continue
                with census.aggregator_env(m), pytest.raises(
                        (ValueError, NotImplementedError)) as e:
                    census.build_owner(m, "cpu", group)
                assert why[:60] in str(e.value), (m.mode_id, why, e.value)
                checked.add(why)
    finally:
        group.close()
    assert len(checked) >= 8


def test_matrix_equals_the_reference_up_to_recorded_differences():
    from sgcn_tpu.analysis.modes import supported_modes as ref_modes
    from sgcn_tpu.analysis.modes import \
        train_matrix_verdicts as ref_verdicts

    ref = {(m.workload, m.model, m.schedule, m.staleness, m.halo_dtype,
            m.delta, m.gat_form, m.replica, m.pallas) for m in ref_modes()}
    port = pm.supported_modes()
    diff_used = set()
    mirrored = set()
    for m in port:
        d = pm.reference_difference(m)
        if d is None:
            mirrored.add(pm.reference_key(m))
        else:
            diff_used.add(d["reason"])
    assert mirrored == ref
    assert diff_used == {d["reason"] for d in pm.REFERENCE_DIFFERENCES}
    ours = {key: ok for key, (ok, _why) in pm.train_matrix_verdicts().items()}
    theirs = {key: ok for key, (ok, _why) in ref_verdicts().items()}
    assert ours == theirs


def test_mode_flags_match_the_reference_and_the_clis():
    from sgcn_tpu.analysis.modes import MODE_FLAGS, NON_AXIS_FLAGS

    assert pm.MODE_FLAGS == MODE_FLAGS
    assert set(pm.NON_AXIS_FLAGS) == set(NON_AXIS_FLAGS)


# --------------------------------------- parity with the reference's expect
_PARITY = pm.fast_modes() + [pm.Mode("train", "gat", "a2a", gat_form="fused"),
                             pm.Mode("train", "gat", "a2a",
                                     gat_form="split")]


@pytest.mark.parametrize("mode", _PARITY, ids=lambda m: m.mode_id)
def test_expected_exchanges_equal_the_reference(mode, one_thread):
    """The port's expected exchanges — count per direction, lanes, dtype,
    and the wire shape mapped from the reference's per-chip ``(peers, S,
    f)`` buckets (or its live ring rounds) to the stacked ``(k, k·S, f)``
    receive layout — equal the reference's
    ``expect.train_expectation(...).exchanges`` on the same graph, parts
    and widths.  The one recorded difference (``expect.py``'s module
    docstring): the reference's stale program also emits layer 0's
    backward exchange as the next step's carry; the port never runs it."""
    from sgcn_tpu.analysis.expect import train_expectation
    from sgcn_tpu.analysis.hlo_audit import audit_plan as ref_audit_plan
    from sgcn_tpu.analysis.modes import Mode as RefMode
    from sgcn_tpu.train import FullBatchTrainer as RefTrainer

    widths = list(census.mode_widths(mode))
    rplan = ref_audit_plan()
    kw = dict(comm_schedule=mode.schedule)
    if mode.model == "gcn":
        kw.update(halo_dtype=mode.halo_dtype, halo_staleness=mode.staleness,
                  sync_every=2 if mode.staleness else 0)
    rtr = RefTrainer(rplan, fin=census.AUDIT_FIN, widths=widths,
                     model=mode.model, **kw)
    rmode = RefMode(mode.workload, mode.model, mode.schedule,
                    mode.staleness, mode.halo_dtype, gat_form=mode.gat_form)
    rex = train_expectation(rtr, rmode).exchanges
    # the reference's collectives grouped into exchanges: one a2a bucket,
    # or one collective_permute per live ring round
    per = (1 if mode.schedule == "a2a"
           else len(rplan.wire_buffer_shapes("ragged")))
    groups = [rex[i:i + per] for i in range(0, len(rex), per)]

    def mapped(group):
        (_kind, shape, dt) = group[0]
        lanes = shape[-1] if len(shape) == (3 if mode.schedule == "a2a"
                                            else 2) else None
        if mode.schedule == "a2a":
            rows = shape[0] * shape[1]
        else:
            rows = sum(s[0] for _k, s, _d in group)
        return lanes, dt, (rplan.k, rows) + (() if lanes is None
                                              else (lanes,))

    ref = [mapped(g) for g in groups]
    nl = len(widths)
    if mode.model == "gcn" and mode.staleness:
        fs, pf = expect.gcn_layer_plan(census.AUDIT_FIN, widths)
        assert len(ref) == 2 * nl and not pf[0]
        del ref[nl]                      # layer 0's backward exchange
    owner, ctx = census.build_owner(mode, "cpu")
    label = census.program_labels(mode)[0]
    exp = expect.expectation(owner, ctx, mode, label)
    packs = exp.packs[::2] if mode.model == "gat" else exp.packs
    port = [(ex.lanes, ex.wire_dtype, shape)
            for ex, (_l, shape, _d) in zip(exp.exchanges, packs)]
    assert len(packs) == len(exp.exchanges)
    assert port == ref
    fwd = sum(ex.direction == "fwd" for ex in exp.exchanges)
    assert fwd == (nl if mode.model == "gcn" else len(ref) // 2)
    # the two plans are the same fixture
    plan = ctx["plan"]
    assert (plan.s, plan.r, tuple(plan.ragged_round_sizes())) == (
        rplan.s, rplan.r, tuple(rplan.ragged_round_sizes()))
    np.testing.assert_array_equal(plan.owner, rplan.owner)
