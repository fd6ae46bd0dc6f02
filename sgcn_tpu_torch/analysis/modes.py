"""The port's mode matrix — one source of truth for "which configurations
does the port support" (port of ``sgcn_tpu/analysis/modes.py``), shared
by the census, the tests and ``docs/torch_static_analysis.md``.

A :class:`Mode` names one point of the matrix:

    {train, serve, serve_subgraph, minibatch} × {gcn, gat}
    × {a2a, ragged} × staleness {0, 1} × halo-dtype {f32, bf16}
    × delta × replica × GAT table form × aggregator {tiles, ell}
    × ranks {stacked, one process per part}

``is_supported`` restates the PORT's construction gates
(``train/fullbatch.py::check_carry_levers`` and ``resolve_forward_setup``,
``serve/engine.py::ServeEngine.__init__``) with their messages, and the
census's coverage choices with their reasons; ``supported_modes()``
filters the full cross product through it, so a combination missing from
its output is a bug in ``is_supported``, not in a hand-kept list.

Two axes differ from the reference's:

  * ``aggregator`` takes the place of the reference's ``pallas`` axis.
    The port's default is the tile kernel (``'tiles'``);
    ``SGCN_PALLAS_SPMM=0`` selects the ELL aggregator (``'ell'``,
    ``ops/pspmm.py::ell_selected``).  The matrix is the reference's
    mirrored: the reference runs its stale, replica, mini-batch and
    sub-graph modes on the ELL path and its kernel on the exact step
    only; the port runs them on the tiles and raises
    ``ops/pspmm.py::ELL_MODE_DEFERRAL`` under ``'ell'``;
  * ``ranks`` (one process per part: ``FullBatchTrainer(mesh=)``,
    ``ServeEngine(mesh=)``) takes the place of the reference's virtual
    8-device mesh.  The census runs it as one rank on part 0's slice.

``REFERENCE_DIFFERENCES`` keeps every entry where this matrix and the
reference's differ, with its reason.  ``MODE_FLAGS`` maps every
mode-selecting CLI flag to its axis; the AST pass (``ast_rules``) holds
the CLIs to it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

# mode-selecting CLI flags → matrix axis; the AST pass also holds every
# key to exist on the trainer CLI (no dead axes)
MODE_FLAGS = {
    "--model": "model",
    "--comm-schedule": "schedule",
    "--halo-staleness": "staleness",
    "--halo-dtype": "halo_dtype",
    "--halo-delta": "delta",
    "--replica-budget": "replica",
}

# knobs that look mode-like but are deliberately NOT axes
NON_AXIS_FLAGS = {
    "--sync-every": "continuous schedule knob — censused through the "
                    "carried/sync step PAIR every stale and replica mode "
                    "runs, not as an axis",
    "--refresh-band": "continuous refresh-policy knob of the replica mode "
                      "(drift-banded partial refresh) — its step is "
                      "exercised by tests/test_torch_replica_stale.py; "
                      "deferred as a census axis",
}

GAT_FORMS = ("fused", "split", "packed")
AGGREGATORS = ("tiles", "ell")

# the message the ELL aggregator raises for a mode it does not run
# (ops/pspmm.py::ELL_MODE_DEFERRAL, kept here as text: this module imports
# nothing of the package)
_ELL_DEFERRAL = (
    "SGCN_PALLAS_SPMM=0 selects the ELL aggregator, which runs the exact "
    "full-batch step and the full-mode server only: the {mode} runs on "
    "the tile kernel (ROADMAP, 'Not carried': the ELL flavours of the "
    "stale, replica, mini-batch and sub-graph modes) — unset "
    "SGCN_PALLAS_SPMM (or set 'auto')")


# the reasons a combination is left out of the census although no
# constructor refuses it (coverage, as the reference's matrix records it);
# every other reason below echoes a constructor's error
_NOT_TRAINING = (
    "staleness/delta/replication are full-batch TRAINING levers; serving "
    "always runs the exact forward and the mini-batch trainer re-plans per "
    "batch (replica carries have no stable identity across batch plans), "
    "so the census has no such entry")
_SUBGRAPH_ONCE = (
    "the sub-graph server ships NO per-layer exchange — its compact "
    "forward does not depend on the transport, so the census runs it "
    "once, under the a2a-constructed engine")
_SUBGRAPH_GAT = (
    "the sub-graph engine is float32 (no compute_dtype lever) and runs the "
    "compact tables at the plan's natural width — one GAT census entry")
_MINIBATCH_GCN = (
    "the mini-batch census entry covers the GCN envelope; the GAT batch "
    "step is the full-batch step on a batch plan, censused full-batch")
_MINIBATCH_RING = (
    "the mini-batch census entry covers the forced-ring envelope once (the "
    "reference's one entry)")
_SERVE_PACKED = (
    "the serve engine has no compute_dtype lever — the packed form is a "
    "training-side wire shape, so the census has no serve entry for it")
_SERVE_SPLIT = (
    "the serve census covers the GAT table forms through the trainer; the "
    "engine's forward is the trainer's forward (one fused entry, as the "
    "reference's)")
_MINIBATCH_RANKS = (
    "the mini-batch census entry covers the shared envelope once, "
    "stacked; a rank runs the same batch step on its part of each batch "
    "plan (tests/test_torch_ranks_minibatch.py)")
COVERAGE_REASONS = (_NOT_TRAINING, _SUBGRAPH_ONCE, _SUBGRAPH_GAT,
                    _MINIBATCH_GCN, _MINIBATCH_RING, _SERVE_PACKED,
                    _SERVE_SPLIT, _MINIBATCH_RANKS)


@dataclass(frozen=True)
class Mode:
    """One point of the port's configuration matrix."""

    workload: str                  # 'train' | 'serve' | 'serve_subgraph'
    #                                | 'minibatch'
    model: str                     # 'gcn' | 'gat'
    schedule: str                  # 'a2a' | 'ragged'
    staleness: int = 0             # 0 exact | 1 pipelined
    halo_dtype: str | None = None  # None (f32 wire) | 'bfloat16'
    delta: bool = False            # halo-delta cache (stale GCN only)
    gat_form: str | None = None    # 'fused' | 'split' | 'packed' (GAT)
    replica: bool = False          # hot-halo replicas, B > 0 (GCN; the
    #                                census runs census.AUDIT_REPLICA_B)
    aggregator: str = "tiles"      # 'tiles' | 'ell' (SGCN_PALLAS_SPMM=0)
    ranks: bool = False            # one process per part (mesh=)

    @property
    def mode_id(self) -> str:
        parts = [self.workload, self.model, self.schedule]
        if self.model == "gat":
            parts.append(self.gat_form or "fused")
        else:
            parts.append(f"s{self.staleness}")
            parts.append("bf16" if self.halo_dtype == "bfloat16" else "f32")
            if self.delta:
                parts.append("delta")
            if self.replica:
                parts.append("rep")
        if self.aggregator == "ell":
            parts.append("ell")
        if self.ranks:
            parts.append("ranks")
        return "/".join(parts)

    @property
    def compute_dtype(self) -> str | None:
        """The trainer lever that selects the GAT packed form
        (``models/gat.py::gat_table_form``); GCN modes never set it."""
        return "bfloat16" if self.gat_form == "packed" else None


def is_supported(mode: Mode) -> tuple[bool, str]:
    """``(supported?, reason)``: the census's coverage choices first
    (``COVERAGE_REASONS``: combinations no constructor refuses, left out
    as the reference's matrix leaves them out), then the port's
    construction gates in the order the constructors apply them, each
    reason the constructor's own message."""
    m = mode
    if m.workload not in ("train", "serve", "serve_subgraph", "minibatch"):
        return False, f"unknown workload {m.workload!r}"
    if m.model not in ("gcn", "gat"):
        return False, f"unknown model {m.model!r}"
    if m.schedule not in ("a2a", "ragged"):
        return False, f"unknown schedule {m.schedule!r}"
    if m.aggregator not in AGGREGATORS:
        return False, f"unknown aggregator {m.aggregator!r}"
    if m.model == "gat" and m.gat_form not in GAT_FORMS:
        return False, f"unknown GAT table form {m.gat_form!r}"
    if m.model == "gcn" and m.gat_form is not None:
        return False, "gat_form is a GAT axis"
    # ---- coverage
    if m.workload != "train" and (m.staleness or m.delta or m.replica):
        return False, _NOT_TRAINING
    if m.workload == "serve_subgraph" and m.schedule != "a2a":
        return False, _SUBGRAPH_ONCE
    if m.workload == "serve_subgraph" and m.gat_form not in (None, "fused"):
        return False, _SUBGRAPH_GAT
    if m.workload == "minibatch" and m.model == "gat":
        return False, _MINIBATCH_GCN
    if m.workload == "minibatch" and m.schedule != "ragged":
        return False, _MINIBATCH_RING
    if m.workload == "serve" and m.gat_form == "packed":
        return False, _SERVE_PACKED
    if m.workload == "serve" and m.gat_form == "split":
        return False, _SERVE_SPLIT
    if m.ranks and m.workload == "minibatch":
        return False, _MINIBATCH_RANKS
    # ---- the constructors' gates
    if m.model == "gat" and m.halo_dtype is not None:
        if m.workload == "train":
            return False, ("halo_dtype is a GCN-trainer lever; for GAT use "
                           "compute_dtype='bfloat16' (the packed exchange "
                           "already ships half-width rows)")
        return False, ("halo_dtype is a GCN wire lever; the GAT exchange "
                       "ships attention tables (same rule as the trainer)")
    if m.delta and not m.staleness:
        return False, ("halo_delta accumulates into the stale halo carry; "
                       "it requires halo_staleness=1")
    if m.replica:
        if m.model == "gat":
            return False, ("replica_budget replicates rows of the GCN "
                           "feature exchange; the GAT exchange ships "
                           "per-layer attention tables whose replication "
                           "is not supported")
        if m.delta:
            return False, ("replica_budget composed with halo_delta is "
                           "deferred: the delta baseline and the replica "
                           "carry would disagree on what a stale step "
                           "ships")
    if m.staleness and m.model == "gat":
        return False, ("halo_staleness=1 pipelines the GCN hot path; the "
                       "GAT exchange ships per-layer attention tables "
                       "whose staleness is not supported (models/gat.py)")
    if m.aggregator == "ell":
        for on, what in ((m.staleness, "stale-halo trainer"),
                         (m.replica, "replica trainer"),
                         (m.workload == "serve_subgraph",
                          "sub-graph server"),
                         (m.workload == "minibatch", "mini-batch trainer")):
            if on:
                return False, _ELL_DEFERRAL.format(mode=what)
    if m.ranks and m.workload == "serve_subgraph":
        return False, ("sub-graph serving indexes the receptive sets of the "
                       "full k-way plan; a one-part slice has none of its "
                       "own (the census runs one rank on part 0's slice; k "
                       "ranks: tests/test_torch_ranks_serve.py)")
    return True, "supported"


def supported_modes() -> list[Mode]:
    """Every supported configuration, each censused by
    ``census.run_census``: the full cross product per workload filtered
    through ``is_supported``."""
    modes: list[Mode] = []
    for ranks, agg in itertools.product((False, True), AGGREGATORS):
        for sched, stale, hd, delta, rep in itertools.product(
                ("a2a", "ragged"), (0, 1), (None, "bfloat16"),
                (False, True), (False, True)):
            modes.append(Mode("train", "gcn", sched, stale, hd, delta,
                              replica=rep, aggregator=agg, ranks=ranks))
        for sched, form in itertools.product(("a2a", "ragged"), GAT_FORMS):
            modes.append(Mode("train", "gat", sched, gat_form=form,
                              aggregator=agg, ranks=ranks))
        for sched, hd in itertools.product(("a2a", "ragged"),
                                           (None, "bfloat16")):
            modes.append(Mode("serve", "gcn", sched, halo_dtype=hd,
                              aggregator=agg, ranks=ranks))
        for sched, form in itertools.product(("a2a", "ragged"), GAT_FORMS):
            modes.append(Mode("serve", "gat", sched, gat_form=form,
                              aggregator=agg, ranks=ranks))
        for sched, hd in itertools.product(("a2a", "ragged"),
                                           (None, "bfloat16")):
            modes.append(Mode("serve_subgraph", "gcn", sched, halo_dtype=hd,
                              aggregator=agg, ranks=ranks))
        modes.append(Mode("serve_subgraph", "gat", "a2a", gat_form="fused",
                          aggregator=agg, ranks=ranks))
        for sched, model in itertools.product(("a2a", "ragged"),
                                              ("gcn", "gat")):
            modes.append(Mode("minibatch", model, sched,
                              gat_form="fused" if model == "gat" else None,
                              aggregator=agg, ranks=ranks))
    return [m for m in modes if is_supported(m)[0]]


def fast_modes() -> list[Mode]:
    """The ``--fast`` subset: one exact mode, one composed mode."""
    return [
        Mode("train", "gcn", "a2a"),
        Mode("train", "gcn", "ragged", staleness=1, halo_dtype="bfloat16"),
    ]


def banded_modes() -> list[Mode]:
    """The ring modes also censused on the banded fixture, whose ring
    keeps 2 of k−1 rounds: the live-round census of the exact, stale,
    composed replica × stale and ELL rings."""
    return [
        Mode("train", "gcn", "ragged"),
        Mode("train", "gcn", "ragged", staleness=1),
        Mode("train", "gcn", "ragged", staleness=1, replica=True),
        Mode("train", "gcn", "ragged", aggregator="ell"),
    ]


def train_matrix_verdicts() -> dict:
    """The composition-matrix rows (schedule × staleness × delta ×
    replicas × model) as verdicts, the reference's
    ``train_matrix_verdicts`` on the tile aggregator."""
    out = {}
    for sched, stale, delta, rep, model in itertools.product(
            ("a2a", "ragged"), (0, 1), (False, True), (False, True),
            ("gcn", "gat")):
        mode = Mode("train", model, sched, stale, None, delta,
                    gat_form="fused" if model == "gat" else None,
                    replica=rep)
        out[(sched, stale, delta, rep, model)] = is_supported(mode)
    return out


def reference_key(mode: Mode) -> tuple:
    """The reference matrix's point this mode mirrors, as the tuple
    ``(workload, model, schedule, staleness, halo_dtype, delta, gat_form,
    replica, pallas)``: the port's ``'ell'`` is the reference's
    ``pallas=True`` and its ``'tiles'`` the reference's default (the
    mirror in the module docstring).  ``ranks`` has no counterpart."""
    return (mode.workload, mode.model, mode.schedule, mode.staleness,
            mode.halo_dtype, mode.delta, mode.gat_form, mode.replica,
            mode.aggregator == "ell")


# every point where the port's matrix and the reference's differ:
# ``side`` says which matrix has it, ``match`` the axis values that pick
# it out (through ``reference_key``'s mirror), ``reason`` why
REFERENCE_DIFFERENCES = (
    {"side": "port", "match": {"ranks": True},
     "reason": "one process per part has no counterpart in the "
               "reference's matrix, which lowers every mode on one "
               "virtual 8-device mesh; the port runs each supported "
               "train and full-mode serve mode on a rank group "
               "(ROADMAP A2b–A2d)"},
    {"side": "port", "match": {"workload": "serve", "aggregator": "ell"},
     "reason": "the reference audits its kernel family on the train "
               "programs only; the port's ELL aggregator is a separate "
               "path with its own exchanges, so its full-mode server is "
               "censused too"},
    {"side": "port", "match": {"gat_form": "packed", "aggregator": "ell"},
     "reason": "the reference's kernel cannot read the packed form's "
               "bit-paired words; the port's ELL slot passes unpack them "
               "(models/gat.py::GatLayerEll), so packed GAT runs there"},
)


def _matches(mode: Mode, match: dict) -> bool:
    return all(getattr(mode, k) == v for k, v in match.items())


def reference_difference(mode: Mode) -> dict | None:
    """The ``REFERENCE_DIFFERENCES`` entry covering a port-only mode,
    else ``None``."""
    for entry in REFERENCE_DIFFERENCES:
        if entry["side"] == "port" and _matches(mode, entry["match"]):
            return entry
    return None
