"""Full-batch partitioned GCN/GAT trainer and the forward setup it shares
with the serve engine (port of ``sgcn_tpu/train/fullbatch.py``: the exact
path and the pipelined stale-halo mode).

``resolve_forward_setup`` ports the tile-kernel selection for both
models on both transports: GCN over the local and halo tile families, GAT
over the combined-edge family with its int8 0/1 mask tiles, over the
dense a2a exchange or the ragged ring (``comm_schedule``: ``a2a``,
``ragged``, ``auto`` or ``None`` for ``$SGCN_COMM_SCHEDULE``, resolved by
``parallel/plan.py::resolve_comm_schedule``).  An asymmetric plan (a
directed graph: the reference's ``pspmm_overlap`` and
``gat_layer_local``) runs the a2a exchange with the backward on the
plan's transposed layouts; the ring raises on it, as in the reference.

``FullBatchTrainer`` is the reference's exact trainer over the ``k``
parts stacked on one device: per step the L-layer forward (exchange →
tile SpMM → projection → activation for GCN; the factored attention layer
for GAT), the masked loss, autograd's backward (each aggregation's
backward re-runs the kernel on the gradient: ``ops/tile_spmm.py::
PspmmTilesSym``/``PspmmTilesRagged``, ``models/gat.py::GatLayerSym``;
on an asymmetric plan ``PspmmTilesGen``/``GatLayerGen`` run Âᵀ on the
transposed layouts)
and Adam.  Its two precision levers are the reference's:
``compute_dtype='bfloat16'`` (float32 master weights, the forward and
backward in bf16, the loss on float32 logits) and ``halo_dtype='bfloat16'``
(GCN only: the exchange's wire narrows, every table and sum stays
float32).

``halo_staleness=1`` is the reference's pipelined trainer (GCN, symmetric
Â, float32): layer ℓ of step t aggregates with the halo exchanged during
step t−1 (``models/gcn.py::gcn_forward_local_stale``,
``ops/tile_spmm.py::PspmmTilesStale``), features and gradients alike;
step 0 and every ``sync_every``-th step run the sync step (exact math);
``halo_delta`` ships bf16 increments into a float32 carry; under
``comm_schedule='auto'`` with ``sync_every`` a ``CommController``
retunes the interval from the drift measured at sync steps.  The carries
live in the receive layouts the fused launch reads
(``ops/pspmm.py::stale_exchange``) and take the reference's layout only
in checkpoints and drift gauges.

``replica_budget=B`` (or ``'auto'``, the λ·degree knee) is the
reference's hot-halo replicas (GCN, symmetric Â, float32, both
transports): the top-B boundary rows leave the per-layer wire, their
copies sit in the receive layout's replica slots, refreshed on step 0
and every ``sync_every``-th step (the exact exchange) and between them
kept as the last sync wrote them
(``models/gcn.py::gcn_forward_local_replica``); ``refresh_band`` makes
every refresh after step 0 a partial one (a2a) that ships only the rows
whose drift passes the band.  With ``halo_staleness=1`` the replicas
compose with the stale carry: a stale step ships the kept rows alone.

On a rank group (``mesh``) the carried modes run one process per part:
a stale step's exchanges stay in flight until the carry is next read, a
replica step ships the shrunken exchange, and the gauges, refresh counts
and the controller's decision are the group's (ROADMAP A2c).

``remat=True`` recomputes the forward inside the backward, one layer at
a time (a non-reentrant ``torch.utils.checkpoint`` per layer, where the
reference wraps the whole forward in ``jax.checkpoint``): the same bits
and launches as one checkpoint over the forward, but only one layer's
intermediates live at once.
``memory_budget`` holds the mode's analytic device footprint
(``obs/memory.py``) to a byte budget before any tensor ships.
``attach_recorder`` writes the run's telemetry (``obs/recorder.py``): one
``step`` event per step (loss, wall time, grad norm, the comm split, the
stale and replica gauges), span, eval and summary events, and the memory
block joined against the card's measured step.

``SGCN_PALLAS_SPMM=0`` (the reference's switch) runs the GCN's exact step
and the full-mode server on the reference's ELL aggregator instead of the
tile kernel (``ops/pspmm.py``: the symmetric a2a and ring aggregations,
an asymmetric plan's ``pspmm_overlap``); its step events also carry the
reference's ``roofline`` and ``measured_vs_model`` blocks, priced by
``obs/attribution.py::step_cost`` with the card's ceilings, as the
reference books them on its slot-pass steps only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..models.gat import (GAT, GAT_PLAN_FIELDS_PALLAS,
                          GAT_PLAN_FIELDS_PALLAS_GEN,
                          GAT_PLAN_FIELDS_PALLAS_RAGGED,
                          gat_exchange_lane_widths, init_gat_params)
from ..models.gcn import (GCN, exchange_widths, gcn_forward_local_replica,
                          gcn_forward_local_stale, init_gcn_params,
                          masked_accuracy_local,
                          masked_err_local, masked_sigmoid_bce_local,
                          masked_softmax_xent_local)
from ..obs.memory import (check_memory_budget, device_bytes,
                          measure_device_step, memory_model, reconcile)
from ..obs.attribution import roofline_fields, stacked_cost, step_cost
from ..obs.tracing import SpanTimer, measured_vs_model_block
from ..ops import pspmm as layout
from ..ops.pspmm import (ELL_GAT_DEFERRAL, ELL_MODE_DEFERRAL,
                         ELL_RANKS_DEFERRAL, ELL_SELECTION_RULE,
                         choose_ell_dispatch, ell_plan_fields, ell_selected,
                         narrow_dtype)
from ..ops.tile_spmm import (TILE_PLAN_FIELDS, TILE_PLAN_FIELDS_GEN,
                             TILE_PLAN_FIELDS_RAGGED, choose_tile_dispatch)
from ..parallel.plan import (REPLICA_PARTIAL_RANK_FIELDS,
                             REPLICA_PARTIAL_TILE_FIELDS, REPLICA_RANK_FIELDS,
                             REPLICA_RANK_FIELDS_RAGGED, REPLICA_TILE_FIELDS,
                             REPLICA_TILE_FIELDS_RAGGED,
                             choose_replica_budget, resolve_comm_schedule)
from ..parallel.proxy import shard_proxy_plan
from ..utils.backend import resolve_device, synchronize
from ..utils.stats import CommStats
from ..utils.timers import PhaseTimer

class ModelSpec(NamedTuple):
    """One model's facts, as the forward setup, trainer and engine read
    them."""

    init_fn: object               # param init on a torch.Generator
    module: type                  # nn.Module over the stacked forward
    plan_fields: tuple            # CommPlan array fields the a2a forward
    plan_fields_ragged: tuple     # ... and the ragged forward read
    plan_fields_gen: tuple        # ... and the a2a forward of an
                                  # asymmetric plan (with the backward's
                                  # transposed layouts)
    lane_widths_fn: object        # (fin, widths, compute_dtype) → per-layer
                                  # wire lanes
    activation: str               # inter-layer activation by default
    mask_fields: tuple = ()       # plan fields shipped as int8 0/1 masks


# model registry.  PGAT stacks bare layers (no activation between them),
# the GCN uses ReLU — the reference CLIs' and serve engine's rule.  GAT's
# tile weights narrow to int8 on ``!= 0`` (attention ignores Â's values),
# as the reference ships them; the kernel converts each mask to float as
# it stages it.
MODELS = {
    "gcn": ModelSpec(init_gcn_params, GCN, TILE_PLAN_FIELDS,
                     TILE_PLAN_FIELDS_RAGGED, TILE_PLAN_FIELDS_GEN,
                     lambda fin, widths, dt: exchange_widths(fin, widths),
                     "relu"),
    "gat": ModelSpec(init_gat_params, GAT, GAT_PLAN_FIELDS_PALLAS,
                     GAT_PLAN_FIELDS_PALLAS_RAGGED,
                     GAT_PLAN_FIELDS_PALLAS_GEN,
                     lambda fin, widths, dt: gat_exchange_lane_widths(
                         widths, dt),
                     "none", mask_fields=("ptile_cw", "ptile_tchw")),
}

# loss registry: 'xent' is the torch stack's log-softmax + NLL, 'bce' the
# MPI stack's sigmoid + BCE whose reported metric is `err`
LOSSES = {
    "xent": masked_softmax_xent_local,
    "bce": masked_sigmoid_bce_local,
}


@dataclass
class ForwardSetup:
    """Resolved forward configuration: the model's facts (``ModelSpec``),
    the forward's static kwargs, and the selection log."""

    model: str
    comm_schedule: str            # resolved: 'a2a' or 'ragged'
    fwd_static: dict              # static kwargs of the forward fn
    decision: dict                # selection log
    plan_fields: tuple            # the resolved schedule's plan fields
    init_fn: object               # ModelSpec's other fields from here on
    module: type
    lane_widths_fn: object
    activation: str
    mask_fields: tuple
    replica_budget: int = 0       # resolved: 'auto' → the λ·degree knee

    @property
    def aggregator(self) -> str:
        """``'ell'`` under ``SGCN_PALLAS_SPMM=0``, else ``'tile'``."""
        return self.fwd_static.get("aggregator", "tile")

    def host_arrays(self, plan) -> dict:
        """The plan arrays the forward consumes, as the host arrays
        ``ship_arrays`` copies (integer arrays stay int32, the kernel's
        stored form; the ``mask_fields`` narrow to int8 0/1) — what the
        memory model prices.  The ELL aggregator's come from the plan's
        chain layout (``CommPlan.ensure_ell_chains``)."""
        src = (plan.ell_chains[self.fwd_static["ell_layout"]]
               if self.aggregator == "ell" else {})
        arrays = {f: np.ascontiguousarray(src[f] if f in src
                                          else getattr(plan, f))
                  for f in self.plan_fields}
        for f in self.mask_fields:
            if f in arrays:
                arrays[f] = (arrays[f] != 0).astype(np.int8)
        return arrays

    def ship_arrays(self, plan, device, compute_dtype=None) -> dict:
        """``host_arrays`` as tensors on ``device``.  Under
        ``compute_dtype='bfloat16'`` every float32 array is rounded
        through bf16 and kept as float32, as the reference's trainer casts
        its float32 plan arrays to the compute dtype and its kernel
        wrappers upcast the tile weights again (``ptile_lw``/``ptile_hw``:
        one rounding of each weight)."""
        out = {f: torch.as_tensor(a).to(device)
               for f, a in self.host_arrays(plan).items()}
        dt = narrow_dtype(compute_dtype, "compute_dtype")
        if dt is not None:
            out = {f: t.to(dt).float() if t.dtype == torch.float32 else t
                   for f, t in out.items()}
        return out


def resolve_forward_setup(plan, model: str = "gcn",
                          comm_schedule: str | None = None,
                          halo_staleness: int = 0,
                          replica_budget: int | str = 0,
                          refresh_band: float | None = None,
                          ranks: bool = False,
                          serve_subgraph: bool = False) -> ForwardSetup:
    """Resolve the ported subset: GCN or GAT over the transport
    ``resolve_comm_schedule`` picks (``None`` reads
    ``$SGCN_COMM_SCHEDULE``, default a2a; ``auto`` takes the ring when the
    a2a's padding efficiency is below ``RAGGED_AUTO_EFFICIENCY``), every
    tile class on the tile kernel (``choose_tile_dispatch``, tile height
    256).  An explicit ``'ragged'`` raises on an asymmetric plan (the
    gradient rides the ring through the symmetric backward) and on k = 1
    (no ring); ``auto`` gives a2a on an asymmetric plan, whose backward
    runs on the plan's transposed layouts (``TILE_PLAN_FIELDS_GEN``,
    ``GAT_PLAN_FIELDS_PALLAS_GEN``).  ``halo_staleness=1`` switches
    ``auto`` to the hidden exchange's wire-row rule.  Builds the plan's
    tile and ring layouts as a side effect, as the reference does.  The
    reference's ``fin``/``widths`` fed its VMEM-fit rule, which is not
    carried.

    ``replica_budget`` (a training lever; GCN): ``'auto'`` resolves to
    the λ·degree knee first (``choose_replica_budget``, its log in
    ``decision['replica_auto']``), ``auto`` scores the transports on the
    shrunken exchange, the plan gets its replica layout
    (``ensure_replicas``) and the shipped fields gain the replica lists
    of the transport (and the partial refresh's under
    ``refresh_band``) — with ``ranks``, those one rank of a rank group
    reads (``REPLICA_RANK_FIELDS[_RAGGED]``,
    ``REPLICA_PARTIAL_RANK_FIELDS``).

    ``SGCN_PALLAS_SPMM=0`` (the reference's switch) selects the ELL
    aggregator instead (``ops/pspmm.py::choose_ell_dispatch``: the
    symmetric a2a and ring aggregations, or an asymmetric plan's
    ``pspmm_overlap``), for the GCN's exact step and full-mode serving;
    GAT, ``ranks``, the carried modes and the sub-graph server
    (``serve_subgraph``) raise under it (the mini-batch trainer raises
    before it builds its batch plans).  Unset, ``auto`` or ``1`` keep
    the tile kernel.  ``decision['aggregator']`` logs which and why."""
    if model not in MODELS:
        raise NotImplementedError(
            f"model {model!r} is not ported yet (ported: "
            f"{', '.join(MODELS)})")
    ell = ell_selected()
    if ell:
        if model != "gcn":
            raise ValueError(ELL_GAT_DEFERRAL)
        if ranks:
            raise ValueError(ELL_RANKS_DEFERRAL)
        for on, mode in ((halo_staleness, "stale-halo trainer"),
                         (replica_budget, "replica trainer"),
                         (serve_subgraph, "sub-graph server")):
            if on:
                raise ValueError(ELL_MODE_DEFERRAL.format(mode=mode))
    decision: dict = {}
    if replica_budget == "auto":
        if model != "gcn":
            raise ValueError("replica_budget='auto' is a GCN lever "
                             "(replication is GCN-only)")
        knee: dict = {}
        replica_budget = choose_replica_budget(plan, decision=knee)
        decision["replica_auto"] = knee
    replica_budget = int(replica_budget or 0)
    schedule = resolve_comm_schedule(
        comm_schedule, [plan], model, decision=decision,
        halo_staleness=halo_staleness,
        replica_budget=replica_budget if model == "gcn" else 0)
    if schedule == "ragged" and not plan.symmetric:
        raise ValueError(
            "comm_schedule='ragged' uses the symmetric custom backward (the "
            "gradient rides the same ring); this plan is asymmetric — run "
            "the a2a schedule")
    if schedule == "ragged" and plan.k == 1 and plan.chip_ids is None:
        raise ValueError("comm_schedule='ragged' needs k > 1 parts: with "
                         "one part there is no ring")
    spec = MODELS[model]._asdict()
    ragged_fields = spec.pop("plan_fields_ragged")
    gen_fields = spec.pop("plan_fields_gen")
    if ell:
        fwd_static = choose_ell_dispatch(plan, schedule, decision=decision)
        spec["plan_fields"] = ell_plan_fields(fwd_static["ell_layout"])
        return ForwardSetup(model=model, comm_schedule=schedule,
                            fwd_static=fwd_static, decision=decision,
                            replica_budget=0, **spec)
    fwd_static = choose_tile_dispatch(plan, decision=decision, model=model,
                                      schedule=schedule)
    decision["aggregator"] = {"chosen": "tile",
                              "env": os.environ.get("SGCN_PALLAS_SPMM"),
                              "rule": ELL_SELECTION_RULE}
    if schedule == "ragged":
        spec["plan_fields"] = ragged_fields
    elif not plan.symmetric:
        spec["plan_fields"] = gen_fields
    if model == "gcn" and replica_budget:
        plan.ensure_replicas(replica_budget)
        ragged = schedule == "ragged"
        if ranks:
            spec["plan_fields"] += (REPLICA_RANK_FIELDS_RAGGED if ragged
                                    else REPLICA_RANK_FIELDS)
        else:
            spec["plan_fields"] += (REPLICA_TILE_FIELDS_RAGGED if ragged
                                    else REPLICA_TILE_FIELDS)
        if refresh_band is not None:
            spec["plan_fields"] += (REPLICA_PARTIAL_RANK_FIELDS if ranks
                                    else REPLICA_PARTIAL_TILE_FIELDS)
    return ForwardSetup(model=model, comm_schedule=schedule,
                        fwd_static=fwd_static, decision=decision,
                        replica_budget=replica_budget, **spec)


def check_param_dims(params, dims) -> None:
    """Raise unless the per-layer weights (``(fin, fout)`` arrays, or
    ``{w, a1, a2}`` dicts for GAT) have the layer dims' shapes."""
    shapes = [tuple(np.shape(p["w"] if isinstance(p, dict) else p))
              for p in params]
    if shapes != dims:
        raise ValueError(f"param shapes {shapes} != layer dims {dims}")


@dataclass
class TrainData:
    """Stacked per-part training data (leading axis k)."""

    h0: torch.Tensor           # (k, B, f) float32 input features
    labels: torch.Tensor       # (k, B) int64
    train_valid: torch.Tensor  # (k, B) float32 — 1 on real rows in the train split
    eval_valid: torch.Tensor   # (k, B) float32 — 1 on real rows in the eval split

    def to(self, device) -> "TrainData":
        """The same data on ``device`` (no copy for tensors already there)."""
        return TrainData(**{k: v.to(device) for k, v in vars(self).items()})


def make_train_data(plan, features: np.ndarray, labels: np.ndarray,
                    train_mask: np.ndarray | None = None,
                    eval_mask: np.ndarray | None = None,
                    device="cpu") -> TrainData:
    """Scatter global (n, f) features and (n,) int labels into stacked
    per-part blocks on ``device``."""
    n = plan.n
    h0 = plan.scatter_rows(np.asarray(features, np.float32))
    lab = plan.scatter_rows(np.asarray(labels).reshape(n, 1)
                            .astype(np.int64))[..., 0]
    if train_mask is None:
        train_mask = np.ones(n, dtype=np.float32)
    if eval_mask is None:
        eval_mask = train_mask
    tv = plan.scatter_rows(np.asarray(train_mask, np.float32)
                           .reshape(n, 1))[..., 0] * plan.row_valid
    ev = plan.scatter_rows(np.asarray(eval_mask, np.float32)
                           .reshape(n, 1))[..., 0] * plan.row_valid
    return TrainData(*(torch.as_tensor(np.ascontiguousarray(x)).to(device)
                       for x in (h0, lab, tv, ev)))


def make_train_data_multihost(plan, mesh, features: np.ndarray,
                              labels: np.ndarray,
                              train_mask: np.ndarray | None = None,
                              eval_mask: np.ndarray | None = None
                              ) -> TrainData:
    """One rank's ``TrainData``: only its own part's rows of the global
    (n, f) features, labels and masks, as ``(1, B, ...)`` blocks on the
    group's device — each MPI rank reading its own
    ``H.r`` shard (``Parallel-GCN/main.c:456-504``).  ``plan`` is the full
    k-way plan; the rank's part is ``mesh.rank``."""
    return make_part_data(plan, mesh.rank, features, labels, train_mask,
                          eval_mask, device=mesh.device)


def make_part_data(plan, part: int, features: np.ndarray,
                   labels: np.ndarray, train_mask: np.ndarray | None = None,
                   eval_mask: np.ndarray | None = None,
                   device="cpu") -> TrainData:
    """Part ``part``'s ``TrainData`` under the FULL k-way ``plan``: its
    own rows of the global features, labels and masks as ``(1, B, ...)``
    blocks on ``device`` (``make_train_data``'s row ``part``)."""
    if plan.chip_ids is not None:
        raise ValueError("a part's data is cut from the full k-way plan "
                         "(make_train_data_multihost, make_part_data); a "
                         "slice's data is shard_proxy_data(full plan, "
                         "chip, ...)")
    chips = [part]
    n = plan.n
    if train_mask is None:
        train_mask = np.ones(n, dtype=np.float32)
    if eval_mask is None:
        eval_mask = train_mask

    def scatter(x, dt):
        return plan.scatter_rows(np.asarray(x, dt).reshape(n, -1),
                                 chips=chips)

    rv = plan.row_valid[part: part + 1]
    blocks = (scatter(features, np.float32),
              scatter(labels, np.int64)[..., 0],
              scatter(train_mask, np.float32)[..., 0] * rv,
              scatter(eval_mask, np.float32)[..., 0] * rv)
    return TrainData(*(torch.as_tensor(np.ascontiguousarray(x)).to(device)
                       for x in blocks))


def check_carry_levers(model: str, symmetric: bool, halo_staleness: int,
                       halo_delta: bool, sync_every: int, compute_dtype,
                       remat: bool, replica_budget=0,
                       refresh_band=None) -> None:
    """The reference trainer's gates on the stale-halo and replica
    levers, in its order, with its messages (``ValueError``)."""
    if halo_staleness not in (0, 1):
        raise ValueError(
            f"halo_staleness must be 0 (exact) or 1 (pipelined), got "
            f"{halo_staleness}")
    if halo_delta and not halo_staleness:
        raise ValueError(
            "halo_delta accumulates into the stale halo carry; it "
            "requires halo_staleness=1")
    if sync_every < 0:
        raise ValueError(f"sync_every must be >= 0, got {sync_every}")
    if sync_every and not (halo_staleness or replica_budget):
        raise ValueError(
            "sync_every schedules the stale mode's full-sync steps / "
            "the replica mode's refresh steps; it requires "
            "halo_staleness=1 or replica_budget>0 (exact mode is "
            "always in sync)")
    if replica_budget != "auto" and replica_budget < 0:
        raise ValueError(
            f"replica_budget must be >= 0 or 'auto', got "
            f"{replica_budget}")
    if replica_budget:
        if model != "gcn":
            raise ValueError(
                "replica_budget replicates rows of the GCN feature "
                "exchange; the GAT exchange ships per-layer attention "
                "tables whose replication is not supported")
        if halo_delta:
            raise ValueError(
                "replica_budget composed with halo_delta is deferred: "
                "the delta baseline and the replica carry would "
                "disagree on what a stale step ships — compose "
                "replication with plain --halo-staleness 1 instead "
                "(docs/replication.md)")
        if not symmetric:
            raise ValueError(
                "replica_budget uses the symmetric-Â custom backward "
                "(gradient replicas mirror the feature replicas); this "
                "plan is asymmetric — run without replication")
        if compute_dtype is not None or remat:
            raise ValueError(
                "replica_budget is defined for the f32 non-remat "
                "trainer (replica carries are f32 state threaded "
                "through the step); drop compute_dtype/remat or run "
                "without replication")
    if refresh_band is not None:
        if refresh_band < 0:
            raise ValueError(
                f"refresh_band must be >= 0, got {refresh_band}")
        if not replica_budget:
            raise ValueError(
                "refresh_band schedules the drift-driven PARTIAL "
                "replica refresh; it requires replica_budget > 0 "
                "(docs/replication.md)")
        if halo_staleness:
            raise ValueError(
                "refresh_band with halo_staleness=1 is deferred: the "
                "composed mode's replica state lives inside the stale "
                "halo carry, which partial refresh cannot address per "
                "row — run full refreshes there (docs/replication.md)")
    if halo_staleness:
        if model != "gcn":
            raise ValueError(
                "halo_staleness=1 pipelines the GCN hot path; the GAT "
                "exchange ships per-layer attention tables whose "
                "staleness is not supported (models/gat.py)")
        if not symmetric:
            raise ValueError(
                "halo_staleness=1 uses the symmetric-Â custom backward "
                "(stale gradient exchange == stale forward exchange "
                "pattern); this plan is asymmetric — run exact mode")
        if compute_dtype is not None or remat:
            raise ValueError(
                "halo_staleness=1 is defined for the f32 non-remat "
                "trainer (carries are f32 state threaded through the "
                "step); drop compute_dtype/remat or run exact mode")


# The reference's deferral of a carried mode's checkpoint on more than one
# process (``sgcn_tpu/train/fullbatch.py::resume_state``), word for word
CARRY_CHECKPOINT_DEFERRAL = (
    "full-state checkpointing of the stale/replica carry is "
    "single-process for now: the carry is sharded across hosts and the "
    "coordinator cannot fetch it — run exact mode for multi-host durable "
    "checkpoints, or checkpoint carried modes from a single-process run "
    "(docs/resilience.md)")


def check_rank_levers(plan, mesh) -> None:
    """The rank path's scope (ROADMAP A2b, A2c): a ``k``-rank group on
    the full k-way plan, or one rank on a slice; else a ``ValueError``.
    Every lever of the stacked trainer runs on it — GCN or GAT, float32
    or ``compute_dtype``, with or without ``remat`` (``halo_dtype`` for
    GCN), both transports on a symmetric plan and the a2a on an
    asymmetric one, and for GCN the carried modes — under the
    reference's own gates (``check_carry_levers``, the ring's refusal of
    an asymmetric plan), which the trainer applies as the stacked one
    does."""
    want = 1 if plan.chip_ids is not None else plan.k
    if mesh.size != want:
        raise ValueError(
            f"a rank group of {mesh.size} ranks for a plan of k={plan.k} "
            f"parts{' (a one-part slice)' if plan.chip_ids is not None else ''}"
            f": one rank per part, {want} ranks")


class FullBatchTrainer:
    """Full-batch partitioned GCN/GAT trainer over the a2a exchange or the
    ragged ring (the reference's ``FullBatchTrainer``): the exact path,
    and for GCN the pipelined stale-halo mode."""

    def __init__(
        self,
        plan,
        fin: int,
        widths: list[int],
        lr: float = 0.01,
        activation: str = "relu",
        final_activation: str = "none",
        optimizer=None,
        seed: int = 0,
        model: str = "gcn",
        loss: str = "xent",
        compute_dtype: str | None = None,
        remat: bool = False,
        halo_dtype: str | None = None,
        halo_staleness: int = 0,
        halo_delta: bool = False,
        sync_every: int = 0,
        comm_schedule: str | None = None,
        replica_budget: int | str = 0,
        refresh_band: float | None = None,
        memory_budget: int | None = None,
        params=None,
        device=None,
        mesh=None,
    ):
        """Arguments keep the reference's names.  ``optimizer``: a
        callable taking the parameter list and returning a
        ``torch.optim.Optimizer``; ``None`` is Adam with optax's defaults
        (``lr``, betas (0.9, 0.999), eps 1e-8), as the reference uses.
        ``params``: initial weights — ``(fin, fout)`` arrays for GCN,
        ``{w, a1, a2}`` dicts for GAT (numpy, e.g. the JAX package's, or
        tensors); ``None`` draws the model's init from a
        ``torch.Generator`` seeded with ``seed``.  ``device``:
        ``None`` means ``cuda`` and raises without a GPU; pass ``"cpu"``
        to train on the CPU.  ``compute_dtype='bfloat16'``: float32
        master weights and Adam, the forward and backward in bf16 (the
        float32 plan weights rounded through bf16 once, here), the loss
        on the logits upcast to float32.  ``halo_dtype='bfloat16'`` (GCN
        only): both directions' exchanges ship bf16, every table and sum
        stays float32.

        ``halo_staleness=1`` trains the pipelined stale-halo mode (GCN,
        symmetric plan, float32, both transports): each layer aggregates
        with the halo exchanged the step before, features forward and
        gradients backward; step 0 and, with ``sync_every=N``, every N-th
        step are sync steps (exact math, the carries refreshed).
        ``halo_delta`` ships each stale step's feature rows as bf16
        increments into a float32 carry (a sync step re-bases with the
        full float32 row); the gradient wire keeps ``halo_dtype``.  With
        ``comm_schedule='auto'`` and ``sync_every`` the drift-banded
        ``CommController`` retunes ``sync_every`` at each sync step
        (``comm_decision['controller']`` holds its log).  Evaluation runs
        the exact forward.

        ``replica_budget=B`` (B > 0, or ``'auto'``: the λ·degree knee)
        trains with hot-halo replicas (GCN, symmetric plan, float32, both
        transports, ``halo_dtype`` allowed): each step's exchanges ship
        only the rows not replicated, the replica slots of the carried
        receive layouts keep what the last refresh wrote; step 0 and
        every ``sync_every``-th step refresh with the exact exchange
        (``sync_every=1`` is the exact trainer bit for bit).
        ``refresh_band=RHO`` (a2a, no staleness) makes every refresh after
        step 0 partial: only the replica rows whose relative drift passes
        ``RHO`` ship, as increments on float32 replicas.  With
        ``halo_staleness=1`` (no ``halo_delta``) the two compose.  The
        reference's gates raise its ``ValueError``s.

        ``remat=True`` (exact path, either model, either transport, either
        precision) checkpoints each layer: the forward keeps the layer
        inputs alone, the backward re-runs each layer's forward (each
        pack and fused or K5 launch) before it differentiates it, the
        same bits as the plain step.  ``memory_budget`` (bytes):
        ``MemoryBudgetError`` here, before any tensor ships, when the
        mode's analytic device footprint (``self.memory``) exceeds it.

        ``mesh`` (a ``parallel/mesh.py::RankGroup``): one process per
        part (ROADMAP A2b).  Rank ``r`` of a ``k``-rank group trains part
        ``r`` of the full k-way ``plan`` (every rank builds the plan, the
        layouts are built on it and the rank keeps its slice,
        ``parallel/proxy.py``); a one-rank group trains a slice given as
        ``plan``.  Each aggregation's exchange is a collective overlapped
        with the local pass (``ops/tile_spmm.py::pspmm_tiles_ranks``; a
        GAT table's exchange, ``ops/pspmm.py::rank_halo_exchange``, is
        waited on before K5), GAT's stabilizer is all-reduced to its max,
        the loss's count and every weight gradient are all-reduced.  GCN
        and GAT on a symmetric plan, float32 or ``compute_dtype``, with
        or without ``remat`` (``halo_dtype`` for GCN), both transports,
        and the GCN's carried modes (ROADMAP A2c): a stale step leaves
        each exchange in flight until the carry is next read
        (``ops/pspmm.py::InFlight``; ``fit`` waits on every one before it
        returns), the halo-delta cache keeps each sender's baseline on
        its own rank, a replica step ships the shrunken exchange, the
        drift gauges and the partial refresh's counts are all-reduced,
        and the controller's ``sync_every`` is rank 0's, broadcast.  A
        carried mode's checkpoint on more than one rank raises the
        reference's deferral.  An asymmetric plan (a directed graph,
        a2a) runs each backward's reverse exchange as the reverse
        ``all_to_all_single`` of the forward's
        (``ops/tile_spmm.py::pspmm_tiles_gen_ranks``,
        ``models/gat.py::GatLayerGen``).  ``device`` defaults to the
        group's; data comes from ``make_train_data_multihost``."""
        if mesh is not None:
            check_rank_levers(plan, mesh)
        if halo_dtype is not None and model != "gcn":
            raise ValueError(
                "halo_dtype is a GCN-trainer lever; for GAT use "
                "compute_dtype='bfloat16' (the packed exchange already "
                "ships half-width rows)")
        check_carry_levers(model, plan.symmetric, halo_staleness,
                           halo_delta, sync_every, compute_dtype, remat,
                           replica_budget, refresh_band)
        narrowed = {name: "bfloat16" for name, dt in (
            ("compute_dtype", narrow_dtype(compute_dtype, "compute_dtype")),
            ("halo_dtype", narrow_dtype(halo_dtype))) if dt is not None}
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}; one of {sorted(LOSSES)}")
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        setup = resolve_forward_setup(plan, model=model,
                                      comm_schedule=comm_schedule,
                                      halo_staleness=halo_staleness,
                                      replica_budget=replica_budget,
                                      refresh_band=refresh_band,
                                      ranks=mesh is not None)
        # one process per part: the layouts are built on the full plan
        # (above), then the rank keeps its part's slice
        self.mesh = mesh
        self.full_plan = plan
        if mesh is not None and plan.chip_ids is None:
            # a checkpoint names the full plan, whichever rank writes or
            # reads it (utils/checkpoint.py)
            self.checkpoint_plan = plan
            plan = shard_proxy_plan(plan, mesh.rank)
        # the analytic footprint and the --memory-budget gate, before any
        # tensor ships (obs/memory.py); the allocator's state now is the
        # measured side's zero
        self.memory = memory_model(
            plan, fin, widths, workload="train", model=model,
            compute_dtype=narrowed.get("compute_dtype"),
            halo_dtype=narrowed.get("halo_dtype"),
            halo_staleness=halo_staleness, halo_delta=halo_delta,
            refresh_band=refresh_band, remat=remat, setup=setup,
            ranks=mesh is not None)
        check_memory_budget(self.memory, memory_budget,
                            what=f"{model} trainer")
        self.memory_budget = memory_budget
        self.memory_join = None        # reconcile() of the measured step
        self._mem_base = device_bytes(self.device)
        self.remat = bool(remat)
        self.recorder = None           # attach_recorder
        self._grad_norm = None         # device scalar, under a recorder
        self._last_info = {}           # the step's schedule facts
        self.setup = setup
        self.comm_decision = setup.decision
        self.comm_schedule = setup.comm_schedule
        self.replica_budget = setup.replica_budget   # 'auto' → the knee
        self.refresh_band = refresh_band
        if refresh_band is not None and self.comm_schedule != "a2a":
            raise ValueError(
                "refresh_band rides the dense-a2a replica path; the "
                "ragged partial-refresh side channel is deferred — run "
                "--comm-schedule a2a (docs/replication.md)")
        self.plan = plan
        self.fin = int(fin)
        self.widths = list(widths)
        self.activation = activation
        self.final_activation = final_activation
        self.loss_name = loss
        self._loss_fn = LOSSES[loss]
        self.compute_dtype = narrowed.get("compute_dtype")
        self.halo_dtype = narrowed.get("halo_dtype")
        dims = list(zip([self.fin] + self.widths[:-1], self.widths))
        if params is None:
            params = setup.init_fn(torch.Generator().manual_seed(seed), dims)
        check_param_dims(params, dims)
        self.model = setup.module(
            params, activation=activation, final_activation=final_activation,
            fwd_static={**setup.fwd_static, **narrowed,
                        **({"mesh": mesh} if mesh is not None else {})}
        ).to(self.device)
        self.model.remat = self.remat
        self.pa = setup.ship_arrays(plan, self.device, self.compute_dtype)
        self.opt = (optimizer(list(self.model.parameters()))
                    if optimizer is not None else
                    torch.optim.Adam(self.model.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8))
        # per-exchange wire lane widths: GCN ships feature rows at the
        # project-first widths, GAT its attention tables (whose lanes
        # encode the dtype, at 4 bytes each); a GCN wire narrows to 2
        # bytes under either bf16 lever, both directions, and the
        # halo-delta cache narrows the feature wire alone
        gcn = setup.model == "gcn"
        self._stats_args = dict(
            schedule=self.comm_schedule,
            lane_widths=setup.lane_widths_fn(self.fin, self.widths,
                                             self.compute_dtype),
            wire_itemsize=2 if gcn and (narrowed or halo_delta) else 4,
            wire_itemsize_bwd=2 if gcn and narrowed else 4)
        # a slice of an asymmetric plan receives other rows than it
        # sends: its receive counters come from its own halo layout
        self.stats = (CommStats.from_slice if plan.chip_ids is not None
                      and not plan.symmetric else CommStats.from_plan)(
                          plan, **self._stats_args)
        if self.replica_budget:
            self.stats.set_replica(plan)
        self._step_cost = None         # _step_cost_model
        self.timer = PhaseTimer()
        self.spans = SpanTimer(timer=self.timer)   # span events under a
        # recorder; without one a span is a phase of the timer
        self._step_count = 0
        self.last_err = None
        self.last_restore_partial = False  # set by load_checkpoint
        self.halo_staleness = int(halo_staleness)
        self.halo_delta = bool(halo_delta)
        self.sync_every = int(sync_every)
        # the drift-banded sync_every retune: when the schedule was asked
        # as 'auto' and there is a sync schedule to tune
        self.controller = None
        if (str(self.comm_decision.get("asked")) == "auto" and sync_every
                and (halo_staleness or self.replica_budget)):
            from .controller import CommController
            self.controller = CommController(sync_every=sync_every)
            self.comm_decision["controller"] = self.controller.log()
        # drift gauges on every step (else only on a controller's sync
        # steps); the newest land in last_gauges
        self.drift_gauges = False
        self.last_gauges = None
        self.last_refresh_rows = None   # a partial refresh's shipped rows
        self.halo_carry = None
        self.replica_carry = None
        if self.replica_budget:
            ragged = self.comm_schedule == "ragged"
            self._rep_dst = torch.as_tensor(
                plan.rep_ring_dst if ragged else plan.rep_recv_dst).to(
                    self.device)
            self._rep_pos = torch.as_tensor(plan.rep_table_pos).to(
                self.device)
        if halo_staleness:
            self._init_stale_carry()
        elif self.replica_budget:
            self._init_replica_carry()

    # ------------------------------------------------------------- state
    @property
    def params(self) -> list:
        """The weights per layer (live parameters): the ``(fin, fout)``
        matrix for GCN, the ``{w, a1, a2}`` dict for GAT."""
        return self.model.layer_params()

    @property
    def nlayers(self) -> int:
        return len(self.widths)

    def _sync(self) -> None:
        synchronize(self.device)

    # ------------------------------------------------------- stale halos
    def _zero_carries(self, float32_features: bool) -> dict:
        """Per layer a zero feature and gradient carry in the receive
        layout of the transport (never consumed: step 0 syncs): the
        wire's dtype, the feature carries float32 if asked."""
        k, rows = self.plan.recv_layout_shape(self.comm_schedule)
        wire = narrow_dtype(self.halo_dtype) or torch.float32
        hdt = torch.float32 if float32_features else wire
        fs = exchange_widths(self.fin, self.widths)
        return {"halos": [torch.zeros((k, rows, f), dtype=hdt,
                                      device=self.device) for f in fs],
                "ghalos": [torch.zeros((k, rows, f), dtype=wire,
                                       device=self.device) for f in fs]}

    def _init_stale_carry(self) -> None:
        """Zero carries (``_zero_carries``), float32 under
        ``halo_delta``; on a rank under ``halo_delta`` also the sender's
        float32 baselines, one per layer in its send-pack order (the
        stacked layout's one tensor is both ends; a rank holds the
        receiver's end in its carry and the sender's here)."""
        self.halo_carry = self._zero_carries(self.halo_delta)
        if self.halo_delta and self.mesh is not None:
            self.halo_carry["bases"] = [
                torch.zeros_like(x) for x in self.halo_carry["halos"]]
        self._halo_src_flat = (
            None if self.comm_schedule == "ragged" else torch.as_tensor(
                self.plan.halo_src_flat.astype(np.int64)).to(self.device))
        self._stale_step_idx = 0
        self._last_sync_idx = 0

    def _sync_due(self, step_idx: int) -> bool:
        """Carry init (step 0) + the periodic sync (refresh) schedule;
        with ``sync_every=0`` only step 0 syncs."""
        if step_idx == 0:
            return True
        return bool(self.sync_every) and step_idx % self.sync_every == 0

    def _stale_sync_due(self) -> bool:
        return self._sync_due(self._stale_step_idx)

    def _halo_rows(self, carry):
        """A carry's rows in the reference's layout, float32: the a2a
        receive buffer gathered to its ``(k, R, f)`` halo tables; the
        ring concat as it is."""
        if self._halo_src_flat is None:
            return carry.float()
        return layout.recv_halo_rows(carry, self._halo_src_flat)

    def _carried_step(self, data: TrainData, carry: dict, forward,
                      rows_of, gauges: bool):
        """One optimizer step of a carried mode (stale or replica):
        ``forward(gholder)`` runs the mode's forward over ``carry`` and
        returns its outputs, the logits first and the next feature
        carries second; the backward writes the next gradient carries
        into ``gholder``; then ``_loss_backward_update``, as in
        ``_one_step``.  ``gauges``: the drift gauges over ``rows_of``
        each carry (the reference's layout) —
        ``drift_sq[ℓ] = Σ (next − in)²`` and ``ref_sq[ℓ] = Σ next²`` into
        ``last_gauges`` (float64 numpy; on ranks the per-rank sums
        all-reduced).  A gauge reads the carries, so it waits on their
        exchanges.  Returns ``(loss, err, outputs, gholder)``."""
        self.opt.zero_grad(set_to_none=True)
        # both modes may rewrite a carry in place (a composed or a replica
        # step): read the rows it starts from first
        old = ([rows_of(layout.settle(x)) for x in carry["halos"]]
               if gauges else None)
        gholder = list(carry["ghalos"])
        out = forward(gholder)
        loss, err = self._loss_backward_update(out[0], data)
        if gauges:
            with torch.no_grad():
                new = [rows_of(layout.settle(x)) for x in out[1]]
                self.last_gauges = self._gauge_sums({
                    "drift_sq": [torch.sum(torch.square(n - o),
                                           dtype=torch.float64)
                                 for n, o in zip(new, old)],
                    "ref_sq": [torch.sum(torch.square(n),
                                         dtype=torch.float64)
                               for n in new]})
        return loss, err, out, gholder

    def _gauge_sums(self, sums: dict) -> dict:
        """Per-layer gauge sums (float64 device scalars: the same squares
        summed in any order give the same figure to float64 rounding) as
        float64 numpy arrays; on a rank group each rank's sums
        all-reduced in one collective."""
        if self.mesh is not None:
            flat = self.mesh.all_reduce_sum(torch.stack(
                [x.double() for v in sums.values() for x in v]))
            it = iter(flat.cpu().tolist())
            return {name: np.array([next(it) for _ in v], np.float64)
                    for name, v in sums.items()}
        return {name: np.array([float(x) for x in v], np.float64)
                for name, v in sums.items()}

    def _settle_carries(self) -> None:
        """Wait on every carry whose exchange is still in flight (a rank's
        stale or composed steps leave them so until the next read)."""
        for carry in (self.halo_carry, self.replica_carry):
            for key, xs in (carry or {}).items():
                carry[key] = [layout.settle(x) for x in xs]

    def _one_step_stale(self, data: TrainData, fresh: bool,
                        gauges: bool = False):
        """One step under the pipelined stale exchange: the stale forward
        reads the carries of step t−1 and makes step t's; the backward
        writes the next gradient carries into a holder.  ``gauges``: the
        drift gauges of the reference's ``_one_step_stale``, over its
        ``(R, f)`` rows (padding rows included) — ``drift_sq[ℓ] = Σ
        (halo_next − halo_in)²``, ``ref_sq[ℓ] = Σ halo_next²`` and the
        halo-delta residual ``qerr_sq[ℓ]`` (float64 numpy)."""
        carry = self.halo_carry
        # a rank's delta baselines: the forward replaces them per layer
        bases = list(carry["bases"]) if "bases" in carry else None

        def forward(gholder):
            return gcn_forward_local_stale(
                list(self.model.weights), data.h0, self.pa, carry["halos"],
                carry["ghalos"], gholder, activation=self.activation,
                final_activation=self.final_activation,
                delta=self.halo_delta,
                # the delta cache IS the bf16 wire; otherwise the stale
                # feature wire keeps the exact mode's halo_dtype
                wire_dtype="bfloat16" if self.halo_delta else self.halo_dtype,
                gwire_dtype=self.halo_dtype, fresh=fresh, gauges=gauges,
                replica=bool(self.replica_budget), **self._rank_static(),
                bases=bases, **self.setup.fwd_static)

        loss, err, out, gholder = self._carried_step(
            data, carry, forward, self._halo_rows, gauges)
        # carries are per-part state: never reduced, never differentiated
        self.halo_carry = {"halos": out[1], "ghalos": gholder}
        if bases is not None:
            self.halo_carry["bases"] = bases
        if gauges:
            self.last_gauges.update(self._gauge_sums({"qerr_sq": out[2]}))
        return loss, err

    def _rank_static(self) -> dict:
        """The carried forwards' rank arguments: the group and the
        shrunken ring's static round sizes (none without a group)."""
        if self.mesh is None:
            return {}
        return {"mesh": self.mesh, "nrep_rr_sizes": self.plan.nrep_rr_sizes}

    def _stale_run_one(self, data: TrainData):
        """One stale-mode optimizer step, sync or pipelined per schedule;
        books the step's exchanges as hidden unless it is a sync step (a
        delta sync step's feature wire at 4 bytes: the float32 re-base)."""
        sync_step = self._stale_sync_due()
        first = sync_step and self._stale_step_idx == 0
        self._last_info = {"age": self._stale_step_idx - self._last_sync_idx,
                           "sync_step": sync_step}
        loss, err = self._one_step_stale(data, sync_step,
                                         self._gauges_due(sync_step))
        if sync_step:
            self._controller_observe(first, self._stale_step_idx)
            self._last_sync_idx = self._stale_step_idx
        self._stale_step_idx += 1
        # a composed replica × stale step ships the shrunken wire, hidden
        self.stats.count_step(
            nlayers=self.nlayers, hidden=not sync_step,
            wire_itemsize=4 if (self.halo_delta and sync_step) else None,
            replica=bool(self.replica_budget) and not sync_step)
        return loss, err

    def _gauges_due(self, sync_step: bool) -> bool:
        """Whether this step computes the drift gauges: ``drift_gauges``,
        a controller's sync step, or a recorder.  On a rank group the
        gauges are a collective, so the choice reads only what every rank
        shares: a recorder lives on rank 0 alone, and counts through
        ``drift_gauges``, which ``attach_recorder`` requires there."""
        return (self.drift_gauges
                or (self.mesh is None and self.recorder is not None)
                or (self.controller is not None and sync_step))

    def _controller_observe(self, first: bool, step_idx: int) -> None:
        """Feed a sync (refresh) step's measured drift (the max over
        layers of the relative RMS) to the controller and apply its
        ``sync_every``.  The initializing sync is skipped: it compares
        against the zero carry, which measures initialization, not
        drift."""
        if self.controller is None or first:
            return
        g = self.last_gauges
        d = np.sqrt(np.maximum(g["drift_sq"], 0))
        r = np.sqrt(np.maximum(g["ref_sq"], 0))
        rel = float(np.max(d / np.maximum(r, 1e-30))) if d.size else 0.0
        self.sync_every = self.controller.observe(step_idx, rel)
        if self.mesh is not None and self.mesh.size > 1:
            # every rank decided on the same all-reduced gauges; rank 0's
            # decision is the group's all the same: two ranks that
            # disagree on the next sync step would deadlock the exchanges
            t = torch.tensor([self.sync_every], dtype=torch.int64,
                             device=self.mesh.device)
            torch.distributed.broadcast(t, src=0)
            self.sync_every = int(t.item())
        self.comm_decision["controller"] = self.controller.log()
        if self.recorder is not None:
            self.recorder.set_comm_schedule(self.comm_decision)

    # ------------------------------------------------- hot-halo replicas
    def _init_replica_carry(self) -> None:
        """Zero carries (``_zero_carries``), the feature carries float32
        under ``refresh_band`` (its replicas are float32 sums), and then
        also the ``(k, RS, f)`` float32 baselines."""
        band = self.refresh_band is not None
        self.replica_carry = self._zero_carries(band)
        if band:
            self.replica_carry["rep_base"] = [
                torch.zeros((self.plan.k, self.plan.rep_base_rows, f),
                            device=self.device)
                for f in exchange_widths(self.fin, self.widths)]
        self._rep_step_idx = 0
        self._last_refresh_idx = 0

    def _rep_rows(self, carry):
        """A carry's replica rows as the reference's ``(k, RP, f)``
        float32 table (0 on the pads)."""
        return layout.carry_replica_rows(carry, self._rep_dst,
                                         self._rep_pos, self.plan.rp)

    def _replica_sync_due(self) -> bool:
        return self._sync_due(self._rep_step_idx)

    def _one_step_replica(self, data: TrainData, fresh: bool,
                          partial: bool = False, gauges: bool = False):
        """One step of the replica mode: the replica forward over the
        carries (a refresh, a partial refresh or a replica step), the
        backward leaving the next gradient carries in a holder, Adam.
        ``gauges``: the reference's replica drift gauges over its
        ``(RP, f)`` tables — ``drift_sq[ℓ] = Σ (rep_next − rep_in)²``
        (zero on replica steps), ``ref_sq[ℓ] = Σ rep_next²`` (float64
        numpy, in ``last_gauges``).  Returns the loss, ``err`` and, on a
        partial step, the per-layer refreshed copies."""
        carry = self.replica_carry

        def forward(gholder):
            return gcn_forward_local_replica(
                list(self.model.weights), data.h0, self.pa, carry["halos"],
                carry["ghalos"], gholder, activation=self.activation,
                final_activation=self.final_activation,
                halo_dtype=self.halo_dtype, fresh=fresh,
                rep_base=carry.get("rep_base"), partial_step=partial,
                band=float(self.refresh_band or 0.0),
                **self._rank_static(), **self.setup.fwd_static)

        loss, err, (_, halos, bases, nships), gholder = self._carried_step(
            data, carry, forward, self._rep_rows, gauges)
        self.replica_carry = {"halos": halos, "ghalos": gholder}
        if "rep_base" in carry:
            self.replica_carry["rep_base"] = bases
        rows = [int(x) for x in nships] if partial else None
        return loss, err, rows

    def _replica_run_one(self, data: TrainData):
        """One replica-mode optimizer step, a refresh or a replica step
        per schedule; under ``refresh_band`` every refresh but step 0 is
        partial.  Books a replica step at the shrunken exchange, a full
        refresh at the full one and a partial refresh at the shrunken
        exchange plus the side-channel rows it shipped."""
        sync_step = self._replica_sync_due()
        first = sync_step and self._rep_step_idx == 0
        partial = (sync_step and not first
                   and self.refresh_band is not None)
        loss, err, own = self._one_step_replica(
            data, sync_step and not partial, partial,
            self._gauges_due(sync_step))
        # the job's refreshed copies: on a rank group every rank's own
        # count, summed (the stats book the rank's own, job_report sums)
        rows = own
        if own is not None and self.mesh is not None:
            rows = [int(x) for x in self.mesh.all_reduce_sum(
                torch.tensor(own, device=self.mesh.device)).cpu()]
        self.last_refresh_rows = rows
        self._last_info = {"age": self._rep_step_idx - self._last_refresh_idx,
                           "sync_step": sync_step, "first": first,
                           "rows": rows}
        if sync_step:
            self._controller_observe(first, self._rep_step_idx)
            self._last_refresh_idx = self._rep_step_idx
        self._rep_step_idx += 1
        if partial:
            self.stats.count_partial_refresh_step(
                nlayers=self.nlayers, refresh_rows=own,
                wire_rows=int(self.plan.partial_refresh_wire_rows))
        else:
            self.stats.count_step(nlayers=self.nlayers,
                                  replica=not sync_step)
        return loss, err

    # ------------------------------------------------- checkpoint/resume state
    def _carry_attr(self) -> str | None:
        """The carry attribute a full-state checkpoint persists:
        ``'halo_carry'`` in the stale mode (the composed replica × stale
        mode too: the stale carry holds its replicas, as in the
        reference), ``'replica_carry'`` in the replica mode, none on the
        exact path."""
        if self.halo_staleness:
            return "halo_carry"
        return "replica_carry" if self.replica_budget else None

    def carry_leaf_shapes(self) -> list:
        """The checkpoint's carry leaf shapes in the reference's
        ``jax.tree`` order, stacked ``(k,) + shape``: ``{halos, ghalos,
        bases}`` (sorted: bases, ghalos, halos; each a list by layer;
        ``CommPlan.stale_carry_shapes``) in the stale mode, ``{reps,
        greps, rep_base}`` (sorted: greps, rep_base, reps;
        ``CommPlan.replica_carry_shapes``) in the replica mode."""
        if self._carry_attr() == "replica_carry":
            shapes = self.plan.replica_carry_shapes(
                self.fin, self.widths, partial=self.refresh_band is not None)
            keys = ("greps", "rep_base", "reps")
        else:
            shapes = self.plan.stale_carry_shapes(
                self.fin, self.widths, delta=self.halo_delta,
                comm_schedule=self.comm_schedule)
            keys = ("bases", "ghalos", "halos")
        return [(self.plan.k,) + tuple(x) for key in keys
                for x in shapes.get(key, [])]

    def _replica_leaves(self) -> list:
        """The replica mode's carries in the reference's layout and order
        (greps, rep_base, reps), float32 numpy: each receive layout's
        replica slots gathered to ``(k, RP, f)`` tables."""
        self._settle_carries()
        c = self.replica_carry
        rows = ([self._rep_rows(x) for x in c["ghalos"]]
                + list(c.get("rep_base", []))
                + [self._rep_rows(x) for x in c["halos"]])
        return [x.detach().cpu().numpy().astype(np.float32) for x in rows]

    def _restore_replica_carry(self, leaves) -> None:
        """Inverse of ``_replica_leaves``: zero receive layouts with the
        replica tables' rows in their replica slots (every other slot is
        rewritten by the next step before it is read, or carries weight 0
        in every halo tile)."""
        n = self.nlayers
        t = [torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
             for x in leaves]
        band = self.refresh_band is not None
        greps, reps = t[:n], t[2 * n:] if band else t[n:]
        live = self.replica_carry

        def fill(tables, like):
            return [layout.carry_set_replica_rows(
                torch.zeros_like(c), x, self._rep_dst, self._rep_pos)
                for x, c in zip(tables, like)]
        self.replica_carry = {"halos": fill(reps, live["halos"]),
                              "ghalos": fill(greps, live["ghalos"])}
        if band:
            self.replica_carry["rep_base"] = t[n:2 * n]

    def _carry_leaves(self) -> list:
        """The carries in the reference's layout and order, float32
        numpy: the a2a receive buffers gathered to ``(R, f)`` tables and
        the delta baselines transposed back to the senders' ``(k, S, f)``;
        the ring concat as it is, its baselines rolled back per round.  A
        placeholder base without ``halo_delta``.  A rank (one rank on a
        slice: more raise in ``resume_state``) holds its senders'
        baselines itself, in its send-pack order: ``(1, k·S, f)`` is the
        reference's ``(1, k, S, f)``, the ring's round-major as is."""
        self._settle_carries()
        halos, ghalos = self.halo_carry["halos"], self.halo_carry["ghalos"]
        k = self.plan.k
        ragged = self.comm_schedule == "ragged"
        if not self.halo_delta:
            pad = (k, 1, 1) if ragged else (k, 1, 1, 1)
            bases = [torch.zeros(pad) for _ in halos]
        elif "bases" in self.halo_carry:
            bases = [x if ragged else x.reshape(k, -1, self.plan.s,
                                                x.shape[-1])
                     for x in self.halo_carry["bases"]]
        elif ragged:
            bases = [layout.ring_to_send_bases(x, self.plan.rr_sizes)
                     for x in halos]
        else:
            bases = [layout.recv_to_send_bases(x, self.plan.s)
                     for x in halos]
        rows = [self._halo_rows(x) for x in ghalos + halos]
        return [x.detach().cpu().numpy().astype(np.float32)
                for x in bases + rows]

    def _restore_carry(self, leaves) -> None:
        """Inverse of ``_carry_leaves``.  An a2a halo table fills the
        receive slots its rows name and leaves 0 in the others (they
        carry weight 0 in every halo tile); under ``halo_delta`` the
        baselines fill every slot (the carry and the baseline hold the
        same value in each, ``ops/pspmm.py::stale_exchange``)."""
        n = self.nlayers
        t = [torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
             for x in leaves]
        bases, ghalos, halos = t[:n], t[n:2 * n], t[2 * n:]
        live = self.halo_carry
        if "bases" in live:
            # one rank on a slice: its exchange is the loopback, so every
            # receive slot holds what the rank sent there — its baseline
            k, rows = self.plan.recv_layout_shape(self.comm_schedule)
            own = [b.reshape(k, rows, -1).contiguous() for b in bases]
            new_g = [layout.recv_from_halo_rows(
                g, self._halo_src_flat, c.shape, c.dtype)
                if self._halo_src_flat is not None else g.to(c.dtype)
                for g, c in zip(ghalos, live["ghalos"])]
            self.halo_carry = {"halos": [b.clone() for b in own],
                               "ghalos": new_g, "bases": own}
            return
        if self._halo_src_flat is None:
            new_h = [h.to(c.dtype) for h, c in zip(halos, live["halos"])]
            new_g = [g.to(c.dtype) for g, c in zip(ghalos, live["ghalos"])]
        else:
            def scatter(rows, like):
                return layout.recv_from_halo_rows(
                    rows, self._halo_src_flat, like.shape, like.dtype)
            new_h = ([layout.recv_from_send_bases(b, c.dtype)
                      for b, c in zip(bases, live["halos"])]
                     if self.halo_delta else
                     [scatter(h, c) for h, c in zip(halos, live["halos"])])
            new_g = [scatter(g, c) for g, c in zip(ghalos, live["ghalos"])]
        self.halo_carry = {"halos": new_h, "ghalos": new_g}

    def resume_state(self) -> tuple[dict, list]:
        """``(state, carry_leaves)`` — what a bit-identical resume needs
        beyond (params, Adam state), under the reference's keys: the step
        counter, the effective ``sync_every`` and the cumulative CommStats
        gauges; in the stale mode also the sync schedule's counters, the
        controller's state and the carries (``_carry_leaves``)."""
        state = {"step_count": int(self._step_count),
                 "sync_every": int(self.sync_every),
                 "comm_stats": self.stats.state()}
        if self.controller is not None:
            state["controller"] = self.controller.state()
        attr = self._carry_attr()
        if attr is None:
            return state, []
        self._check_carry_checkpoint()
        if attr == "halo_carry":
            state["stale_step_idx"] = int(self._stale_step_idx)
            state["last_sync_idx"] = int(self._last_sync_idx)
            carry = self._carry_leaves()
        else:
            state["rep_step_idx"] = int(self._rep_step_idx)
            state["last_refresh_idx"] = int(self._last_refresh_idx)
            carry = self._replica_leaves()
        state["carry"] = attr
        state["n_carry"] = len(carry)
        return state, carry

    def restore_resume_state(self, state: dict, carry_leaves=None) -> None:
        """Restore ``resume_state()`` output (the checkpoint loader has
        checked the mode and the carry shapes already).  The backward
        exchanges, which the reference's gauges do not record, are
        ``nlayers`` per step."""
        self._step_count = int(state.get("step_count", 0))
        if "sync_every" in state:
            self.sync_every = int(state["sync_every"])
        if self.halo_staleness:
            self._stale_step_idx = int(state.get("stale_step_idx", 0))
            self._last_sync_idx = int(state.get("last_sync_idx", 0))
        elif self.replica_budget:
            self._rep_step_idx = int(state.get("rep_step_idx", 0))
            self._last_refresh_idx = int(state.get("last_refresh_idx", 0))
        if self.controller is not None and state.get("controller"):
            self.controller.load_state(state["controller"])
            self.comm_decision["controller"] = self.controller.log()
        if state.get("comm_stats"):
            self.stats.load_state(state["comm_stats"])
        self.stats.backward_exchanges = self.nlayers * self._step_count
        if carry_leaves:
            self._check_carry_checkpoint()
        if carry_leaves and self.halo_staleness:
            self._restore_carry(carry_leaves)
        elif carry_leaves and self.replica_budget:
            self._restore_replica_carry(carry_leaves)

    def _check_carry_checkpoint(self) -> None:
        """A carried mode's state on more than one rank is sharded over
        the ranks' processes: the reference's deferral."""
        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError(CARRY_CHECKPOINT_DEFERRAL)

    # ----------------------------------------------------------------- step
    def _forward(self, h0):
        # float32 logits for the loss (a no-op on the float32 path)
        return self.model(h0, self.pa).float()

    def _one_step(self, data: TrainData):
        """Loss, backward and optimizer update of one step; returns the
        loss and ``err`` (the loss itself unless ``loss='bce'``) as
        device scalars.  Under ``remat`` the model checkpoints each layer
        (``models/gcn.py::gcn_forward_local``)."""
        self.opt.zero_grad(set_to_none=True)
        return self._loss_backward_update(self._forward(data.h0), data)

    def _loss_backward_update(self, logits, data: TrainData):
        """The loss of ``logits``, its backward and Adam's update; returns
        the loss and ``err`` (the loss itself unless ``loss='bce'``),
        reduced over the rank group, as device scalars."""
        logits = logits.float()
        loss = self._loss(logits, data.labels, data.train_valid)
        err = (self._reduced(masked_err_local(logits.detach(), data.labels,
                                              data.train_valid))
               if self.loss_name == "bce" else None)
        # the reference all-reduces per-chip weight gradients
        # (lax.psum); with all k parts stacked on one device that sum is
        # the one autograd (GCN) or GatLayerSym's backward (GAT) forms
        # over the k·b rows of each h @ w; with one process per part each
        # rank's .grad is all-reduced here
        loss.backward()
        if self.mesh is not None:
            for p in self.model.parameters():
                torch.distributed.all_reduce(p.grad)
        self._note_grad_norm()
        self.opt.step()
        loss = self._reduced(loss.detach())
        return loss, (loss if err is None else err)

    def _loss(self, logits, labels, valid):
        """The training objective; on a rank group the rank's share of the
        global mean (``models/gcn.py``: the count all-reduced)."""
        if self.mesh is None:
            return self._loss_fn(logits, labels, valid)
        return self._loss_fn(logits, labels, valid, group=self.mesh)

    def _reduced(self, x):
        """A per-part sum over the rank group (as is without one)."""
        return x if self.mesh is None else self.mesh.all_reduce_sum(x)

    def _note_grad_norm(self) -> None:
        """Under a recorder, keep the global L2 norm of the weight
        gradients (the reference's ``_global_grad_norm`` of its psum'd
        grads: with the k parts on one device autograd's grads are that
        sum) as a device scalar for the step event."""
        if self.recorder is None:
            return
        with torch.no_grad():
            self._grad_norm = torch.sqrt(sum(
                torch.sum(torch.square(p.grad.float()))
                for p in self.model.parameters() if p.grad is not None))

    def _step_body(self, data: TrainData):
        """One optimizer step of the trainer's mode and its counters;
        returns the loss as a device scalar."""
        if self.halo_staleness:
            loss, err = self._stale_run_one(data)
        elif self.replica_budget:
            loss, err = self._replica_run_one(data)
        else:
            loss, err = self._one_step(data)
            self.stats.count_step(nlayers=self.nlayers)
        self.last_err = err
        self._step_count += 1
        return loss

    def step(self, data: TrainData, sync: bool = True):
        """One training step (a stale-mode step under
        ``halo_staleness=1``, a replica-mode step under
        ``replica_budget``).  ``sync=True`` returns the loss as a float
        (a device readback); ``sync=False`` returns the device scalar.

        With a recorder attached every step reads the loss back inside
        its ``step`` span and appends one ``step`` event; the first step
        after Adam's state exists is measured (``measure_step``) and the
        memory block joined."""
        data = data.to(self.device)
        if self.recorder is None:
            loss = self._step_body(data)
            return float(loss) if sync else loss
        join = self.memory_join is None and self._step_count >= 1
        with self.spans.span("step", step=self._step_count + 1) as sp:
            if join:
                loss, measured = self.measure_step(data)
            else:
                loss = self._step_body(data)
            loss = float(loss)          # readback = the span's sync point
        self._record_step_event(loss, sp.dur_s)
        if join:
            self.publish_memory(measured, data)
        return loss

    # -------------------------------------------------------------- memory
    def _updated_tensors(self) -> list:
        """The tensors a step updates in place: the parameters and Adam's
        moment tensors (its ``step`` counters are host scalars)."""
        out = list(self.model.parameters())
        for st in self.opt.state.values():
            out += [t for key, t in st.items()
                    if torch.is_tensor(t) and key != "step"]
        return out

    def resident_bytes(self, data: TrainData | None = None) -> dict:
        """The live tensors' bytes per memory family (``obs/memory.py``):
        params, Adam's moments, ``data`` (if given), the shipped plan
        arrays and the carries.  The per-family measured side of the
        memory block."""
        def nb(ts):
            return int(sum(t.numel() * t.element_size() for t in ts))

        aux = [t for t in (getattr(self, "_halo_src_flat", None),
                           getattr(self, "_rep_dst", None),
                           getattr(self, "_rep_pos", None))
               if t is not None]
        params = list(self.model.parameters())
        self._settle_carries()
        carries = {"halo_carries": self.halo_carry,
                   "replica_carries": self.replica_carry}
        out = {
            "params": nb(params),
            "opt_state": nb(self._updated_tensors()[len(params):]),
            "plan_arrays": nb([t for f, t in self.pa.items()
                               if not f.startswith("ptile_")] + aux),
            "pallas_tiles": nb([t for f, t in self.pa.items()
                                if f.startswith("ptile_")]),
        }
        for fam, carry in carries.items():
            out[fam] = nb([x for v in (carry or {}).values() for x in v])
        if data is not None:
            out["features"] = nb(vars(data).values())
        return out

    def measure_step(self, data: TrainData):
        """One training step measured on the card
        (``obs.memory.measure_device_step``: argument bytes at its start,
        after the last step's gradients are released, its peak, and the
        params and Adam state it updated in place).  Returns ``(loss,
        measured)``; ``measured`` is ``None`` on the CPU."""
        data = data.to(self.device)
        self.opt.zero_grad(set_to_none=True)
        out = []
        measured = measure_device_step(
            lambda: out.append(self._step_body(data)), self.device,
            self._mem_base, self._updated_tensors())
        return out[0], measured

    def publish_memory(self, measured: dict | None,
                       data: TrainData | None = None) -> dict:
        """Join ``measured`` and the live tensors against the model
        (``obs.memory.reconcile``) into ``memory_join`` and, under a
        recorder, the manifest's memory block and one ``memory`` event."""
        self.memory_join = reconcile(self.memory, measured,
                                     resident=self.resident_bytes(data))
        if self.recorder is not None:
            self.recorder.set_memory(self.memory_join["block"])
            self.recorder.record_memory(
                "train_step", self.memory, measured,
                budget_bytes=self.memory_budget)
        return self.memory_join

    # ------------------------------------------------------ run telemetry
    def attach_recorder(self, recorder) -> None:
        """Attach a ``RunRecorder``: span exits become span events, every
        ``step`` appends one step event, ``evaluate`` an eval event and
        ``fit`` a summary; the transport decision and the memory model
        land in the manifest (the measured join follows at the first step
        after Adam's state exists).  ``None`` detaches.  On a rank group
        a carried mode's step events need the gauges on every rank: set
        ``drift_gauges`` on each first (``_gauges_due``)."""
        if (recorder is not None and self.mesh is not None
                and (self.halo_staleness or self.replica_budget)
                and not self.drift_gauges):
            raise ValueError(
                "a recorder on a rank group reads the drift gauges, which "
                "every rank all-reduces: set drift_gauges=True on every "
                "rank before attaching it on any")
        self.recorder = recorder
        self.spans.recorder = recorder
        if recorder is None:
            return
        if self.comm_decision:
            recorder.set_comm_schedule(self.comm_decision)
        recorder.set_memory(self.memory.block())

    def _step_cost_model(self):
        """The exact step's analytic cost (``obs/attribution.py::
        step_cost``, the only step the ELL aggregator runs), a
        ``halo_dtype`` wire at 2 bytes both ways; cached."""
        if self._step_cost is None:
            self._step_cost = step_cost(
                self.plan, self.fin, self.widths,
                compute_dtype=self.compute_dtype,
                wire_itemsize=2 if self.halo_dtype == "bfloat16" else None,
                comm_schedule=self.comm_schedule, model=self.setup.model)
        return self._step_cost

    def _record_step_event(self, loss: float, wall_s: float) -> None:
        """The step event: the reference's fields, with the stale mode's
        drift block and the replica mode's replica block.  An ELL step
        (``SGCN_PALLAS_SPMM=0``) also carries the ``roofline`` and
        ``measured_vs_model`` blocks, the step cost of all ``k`` stacked
        parts (``attribution.stacked_cost``) joined against the step's
        wall time, every exchange exposed; a tile step books neither, the
        reference's own gate (its gather model describes the slot-pass
        aggregators, not the kernel that ran)."""
        info, g = self._last_info, self.last_gauges
        drift = replica = roofline = mvm = None
        if self.setup.aggregator == "ell":
            cost = stacked_cost(self._step_cost_model(), self.plan.k)
            ex = 2 * self.nlayers
            roofline = roofline_fields(cost, wall_s, exchanges=ex,
                                       exposed_exchanges=ex)
            mvm = measured_vs_model_block(cost, wall_s)
        if self.halo_staleness:
            drift = self._drift_fields(
                g, info["age"], info["sync_step"],
                rr_sizes=(self.plan.rr_sizes
                          if self.comm_schedule == "ragged" else None))
        elif self.replica_budget:
            rows = info["rows"]
            replica = self._replica_fields(
                g, info["age"], info["sync_step"], self.plan.replica_rows,
                first_refresh=info["first"], refresh_rows=rows,
                refresh_wire_rows=(int(self.plan.partial_refresh_wire_rows)
                                   if rows is not None else None))
        self.recorder.record_step(
            step=self._step_count, loss=loss, wall_s=wall_s,
            err=float(self.last_err) if self.loss_name == "bce" else None,
            grad_norm=(float(self._grad_norm)
                       if self._grad_norm is not None else None),
            comm=self.stats.report(),
            phases=self.timer.report() or None,
            drift=drift, replica=replica, roofline=roofline,
            measured_vs_model=mvm)

    @staticmethod
    def _drift_fields(gauges: dict, age: int, sync_step: bool,
                      rr_sizes: tuple | None = None) -> dict:
        """The reference's drift block from the stale gauges
        (``schema.DRIFT_KEYS``; ``round_age`` per ring round on the
        ring)."""
        d = np.sqrt(np.maximum(np.asarray(gauges["drift_sq"], np.float64),
                               0))
        r = np.sqrt(np.maximum(np.asarray(gauges["ref_sq"], np.float64), 0))
        q = np.sqrt(np.maximum(np.asarray(gauges["qerr_sq"], np.float64),
                               0))
        out = {
            "staleness_age": int(age),
            "sync_step": bool(sync_step),
            "halo_drift_rms": [float(x) for x in d],
            "halo_drift_rel": [float(x / max(y, 1e-30))
                               for x, y in zip(d, r)],
            "halo_quant_err_rms": [float(x) for x in q],
        }
        if rr_sizes is not None:
            out["round_age"] = [None if sd == 0
                                else (0 if sync_step else int(age))
                                for sd in rr_sizes]
        return out

    @staticmethod
    def _replica_fields(gauges: dict, age: int, sync_step: bool,
                        replica_rows: int, first_refresh: bool = False,
                        refresh_rows=None,
                        refresh_wire_rows: int | None = None) -> dict:
        """The reference's replica block (``schema.REPLICA_KEYS``): the
        per-layer drift a refresh erased (zero at step 0, whose gauge
        measures the zero-initialized carry), the refresh age, and on a
        partial refresh the rows it shipped."""
        d = np.sqrt(np.maximum(np.asarray(gauges["drift_sq"], np.float64),
                               0))
        r = np.sqrt(np.maximum(np.asarray(gauges["ref_sq"], np.float64), 0))
        if first_refresh:
            d = np.zeros_like(d)
        out = {
            "refresh_age": int(age),
            "sync_step": bool(sync_step),
            "replica_rows": int(replica_rows),
            "replica_drift_rms": [float(x) for x in d],
            "replica_drift_rel": [float(x / max(y, 1e-30))
                                  for x, y in zip(d, r)],
        }
        if refresh_rows is not None:
            out["refresh_kind"] = "partial"
            out["refresh_rows"] = [int(x) for x in refresh_rows]
            out["refresh_wire_rows"] = int(refresh_wire_rows or 0)
        elif sync_step:
            out["refresh_kind"] = "full"
        return out

    def job_report(self) -> dict:
        """The comm report of the whole run: ``stats.report()``, and on
        a ``k``-rank group the full plan's figures under this rank's
        counters (every rank books the same exchanges), as the stacked
        trainer reports them, the byte totals summed over the ranks (one
        all-reduce: every rank calls this); ``stats`` itself keeps the
        rank's own part's rows."""
        if self.mesh is None or self.full_plan is self.plan:
            return self.stats.report()
        job = CommStats.from_plan(self.full_plan, **self._stats_args)
        if self.replica_budget:
            job.set_replica(self.full_plan)
        job.load_state(self.stats.state())
        job.backward_exchanges = self.stats.backward_exchanges
        # the byte totals and the partial refresh's rows: each rank booked
        # its own part's
        summed = ("halo_bytes_true_total", "halo_bytes_wire_total",
                  "partial_refresh_rows_total",
                  "partial_refresh_wire_rows_total")
        mine = torch.tensor([getattr(self.stats, a) for a in summed],
                            dtype=torch.int64, device=self.mesh.device)
        for a, x in zip(summed, self.mesh.all_reduce_sum(mine).cpu()):
            setattr(job, a, int(x))
        return job.report()

    def _eval_logits(self, data: TrainData):
        with torch.no_grad():
            return self._forward(data.h0)

    def evaluate(self, data: TrainData) -> tuple[float, float]:
        """(loss, accuracy) over the eval split, with the training
        objective."""
        data = data.to(self.device)
        with self.spans.span("eval") as sp:
            logits = self._eval_logits(data)
            loss = self._reduced(self._loss(logits, data.labels,
                                            data.eval_valid))
            acc = masked_accuracy_local(logits, data.labels, data.eval_valid,
                                        group=self.mesh)
            loss, acc = float(loss), float(acc)
        self.stats.count_forward(nlayers=self.nlayers)
        if self.recorder is not None:
            self.recorder.record_eval(step=self._step_count, loss=loss,
                                      acc=acc, wall_s=sp.dur_s)
        return loss, acc

    def predict(self, data: TrainData) -> np.ndarray:
        """Global (n, nout) logits in original vertex order (on a rank
        group every rank's rows, all-gathered; a one-part slice's
        ``gather_rows`` raises, as the reference's does)."""
        logits = self._eval_logits(data.to(self.device))
        self.stats.count_forward(nlayers=self.nlayers)
        if self.mesh is not None and self.mesh.size > 1:
            logits = self.mesh.all_gather(logits[0]).reshape(
                self.mesh.size, *logits.shape[1:])
            return self.full_plan.gather_rows(logits.cpu().numpy())
        return self.plan.gather_rows(logits.cpu().numpy())

    def fit(self, data: TrainData, epochs: int = 5, warmup: int = 1,
            verbose: bool = True) -> dict:
        """``warmup`` untimed steps, then wall-clock over ``epochs`` timed
        ones, each phase closed by a device synchronize.  Returns the
        comm report plus ``epochs``, ``elapsed_s``, ``epoch_s``,
        ``loss_history`` and ``phases`` (and ``err`` under
        ``loss='bce'``)."""
        data = data.to(self.device)
        history: list[float] = []
        t_prior = self.timer.inclusive_total("train_step")
        with self.spans.span("warmup", sync=self._sync):
            for _ in range(warmup):
                self.step(data)
        for ep in range(epochs):
            with self.spans.span("train_step", sync=self._sync):
                loss = self.step(data)
            history.append(loss)
            if verbose:
                print(f"epoch {ep}: loss {loss:.6f}", flush=True)
        # a rank's last stale exchanges are still in flight: their
        # consumer is the next step, which fit does not run
        self._settle_carries()
        elapsed = self.timer.inclusive_total("train_step") - t_prior
        report = self.job_report()
        report.update(
            epochs=epochs,
            elapsed_s=elapsed,
            epoch_s=elapsed / max(epochs, 1),
            loss_history=history,
            phases=self.timer.report(),
        )
        if self.loss_name == "bce":
            report["err"] = float(self.last_err)
        if self.recorder is not None:
            self.recorder.record_summary(
                {k: v for k, v in report.items() if k != "loss_history"})
        return report
