"""Full-batch partitioned GCN/GAT trainer and the forward setup it shares
with the serve engine (port of ``sgcn_tpu/train/fullbatch.py``, exact
path).

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
float32).  The levers of the reference that are not ported — remat,
stale halos, replicas, memory budgets — raise "not ported yet" with their
ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..models.gat import (GAT, GAT_PLAN_FIELDS_PALLAS,
                          GAT_PLAN_FIELDS_PALLAS_GEN,
                          GAT_PLAN_FIELDS_PALLAS_RAGGED,
                          gat_exchange_lane_widths, init_gat_params)
from ..models.gcn import (GCN, exchange_widths, init_gcn_params,
                          masked_accuracy_local,
                          masked_err_local, masked_sigmoid_bce_local,
                          masked_softmax_xent_local)
from ..ops.pspmm import narrow_dtype
from ..ops.tile_spmm import (TILE_PLAN_FIELDS, TILE_PLAN_FIELDS_GEN,
                             TILE_PLAN_FIELDS_RAGGED, choose_tile_dispatch)
from ..parallel.plan import resolve_comm_schedule
from ..utils.backend import resolve_device, synchronize
from ..utils.stats import CommStats
from ..utils.timers import PhaseTimer, SpanTimer

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

    def ship_arrays(self, plan, device, compute_dtype=None) -> dict:
        """The plan arrays the forward consumes, as tensors on ``device``
        (integer arrays stay int32, the kernel's stored form; the
        ``mask_fields`` narrow to int8 0/1).  Under
        ``compute_dtype='bfloat16'`` every float32 array is rounded
        through bf16 and kept as float32, as the reference's trainer casts
        its float32 plan arrays to the compute dtype and its kernel
        wrappers upcast the tile weights again (``ptile_lw``/``ptile_hw``:
        one rounding of each weight)."""
        arrays = {f: np.ascontiguousarray(getattr(plan, f))
                  for f in self.plan_fields}
        for f in self.mask_fields:
            if f in arrays:
                arrays[f] = (arrays[f] != 0).astype(np.int8)
        out = {f: torch.as_tensor(a).to(device) for f, a in arrays.items()}
        dt = narrow_dtype(compute_dtype, "compute_dtype")
        if dt is not None:
            out = {f: t.to(dt).float() if t.dtype == torch.float32 else t
                   for f, t in out.items()}
        return out


def resolve_forward_setup(plan, model: str = "gcn",
                          comm_schedule: str | None = None) -> ForwardSetup:
    """Resolve the ported subset: GCN or GAT over the transport
    ``resolve_comm_schedule`` picks (``None`` reads
    ``$SGCN_COMM_SCHEDULE``, default a2a; ``auto`` takes the ring when the
    a2a's padding efficiency is below ``RAGGED_AUTO_EFFICIENCY``), every
    tile class on the tile kernel (``choose_tile_dispatch``, tile height
    256).  An explicit ``'ragged'`` raises on an asymmetric plan (the
    gradient rides the ring through the symmetric backward) and on k = 1
    (no ring); ``auto`` gives a2a on an asymmetric plan, whose backward
    runs on the plan's transposed layouts (``TILE_PLAN_FIELDS_GEN``,
    ``GAT_PLAN_FIELDS_PALLAS_GEN``).  Builds the plan's tile and ring
    layouts as a side effect, as the reference does.  The reference's
    ``fin``/``widths`` fed its VMEM-fit rule, which is not carried."""
    if model not in MODELS:
        raise NotImplementedError(
            f"model {model!r} is not ported yet (ported: "
            f"{', '.join(MODELS)})")
    decision: dict = {}
    schedule = resolve_comm_schedule(comm_schedule, [plan], model,
                                     decision=decision)
    if schedule == "ragged" and not plan.symmetric:
        raise ValueError(
            "comm_schedule='ragged' uses the symmetric custom backward (the "
            "gradient rides the same ring); this plan is asymmetric — run "
            "the a2a schedule")
    if schedule == "ragged" and plan.k == 1:
        raise ValueError("comm_schedule='ragged' needs k > 1 parts: with "
                         "one part there is no ring")
    fwd_static = choose_tile_dispatch(plan, decision=decision, model=model,
                                      schedule=schedule)
    spec = MODELS[model]._asdict()
    ragged_fields = spec.pop("plan_fields_ragged")
    gen_fields = spec.pop("plan_fields_gen")
    if schedule == "ragged":
        spec["plan_fields"] = ragged_fields
    elif not plan.symmetric:
        spec["plan_fields"] = gen_fields
    return ForwardSetup(model=model, comm_schedule=schedule,
                        fwd_static=fwd_static, decision=decision, **spec)


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


# trainer levers of the reference that this port does not carry yet:
# name -> (default meaning "off", ROADMAP item)
_UNPORTED_LEVERS = {
    "remat": (False, "A3"),
    "halo_staleness": (0, "A7"),
    "halo_delta": (False, "A7"),
    "sync_every": (0, "A7"),
    "replica_budget": (0, "A7"),
    "refresh_band": (None, "A7"),
    "memory_budget": (None, "A10"),
}


class FullBatchTrainer:
    """Full-batch partitioned GCN/GAT trainer, exact path over the a2a
    exchange or the ragged ring (the reference's ``FullBatchTrainer``
    with its defaults)."""

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
        stays float32.  Levers not ported raise ``NotImplementedError``."""
        given = {"remat": remat, "halo_staleness": halo_staleness,
                 "halo_delta": halo_delta, "sync_every": sync_every,
                 "replica_budget": replica_budget,
                 "refresh_band": refresh_band,
                 "memory_budget": memory_budget}
        for name, (off, item) in _UNPORTED_LEVERS.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet (ROADMAP "
                    f"item {item}); this port trains the exact path")
        if halo_dtype is not None and model != "gcn":
            raise ValueError(
                "halo_dtype is a GCN-trainer lever; for GAT use "
                "compute_dtype='bfloat16' (the packed exchange already "
                "ships half-width rows)")
        narrowed = {name: "bfloat16" for name, dt in (
            ("compute_dtype", narrow_dtype(compute_dtype, "compute_dtype")),
            ("halo_dtype", narrow_dtype(halo_dtype))) if dt is not None}
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}; one of {sorted(LOSSES)}")
        self.device = resolve_device(device)
        setup = resolve_forward_setup(plan, model=model,
                                      comm_schedule=comm_schedule)
        self.setup = setup
        self.comm_decision = setup.decision
        self.comm_schedule = setup.comm_schedule
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
            fwd_static={**setup.fwd_static, **narrowed}).to(self.device)
        self.pa = setup.ship_arrays(plan, self.device, self.compute_dtype)
        self.opt = (optimizer(list(self.model.parameters()))
                    if optimizer is not None else
                    torch.optim.Adam(self.model.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8))
        # per-exchange wire lane widths: GCN ships feature rows at the
        # project-first widths, GAT its attention tables (whose lanes
        # encode the dtype, at 4 bytes each); a GCN wire narrows to 2
        # bytes under either bf16 lever, both directions
        self.stats = CommStats.from_plan(
            plan, schedule=self.comm_schedule,
            lane_widths=setup.lane_widths_fn(self.fin, self.widths,
                                             self.compute_dtype),
            wire_itemsize=2 if setup.model == "gcn" and narrowed else 4)
        self.timer = PhaseTimer()
        self.spans = SpanTimer(timer=self.timer)
        self._step_count = 0
        self.last_err = None
        self.last_restore_partial = False  # set by load_checkpoint

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

    # ------------------------------------------------- checkpoint/resume state
    def _carry_attr(self) -> str | None:
        """The carry attribute a full-state checkpoint persists: none on
        the exact path (the stale-halo and replica carries are ROADMAP
        A7)."""
        return None

    def resume_state(self) -> tuple[dict, list]:
        """``(state, carry_leaves)`` — what a bit-identical resume needs
        beyond (params, Adam state), under the reference's keys: the step
        counter, the effective ``sync_every`` (0: no sync schedule on the
        exact path) and the cumulative CommStats gauges; no carry leaves."""
        return {"step_count": int(self._step_count), "sync_every": 0,
                "comm_stats": self.stats.state()}, []

    def restore_resume_state(self, state: dict, carry_leaves=None) -> None:
        """Restore ``resume_state()`` output (the checkpoint loader has
        checked the mode already).  The backward exchanges, which the
        reference's gauges do not record, are ``nlayers`` per step."""
        self._step_count = int(state.get("step_count", 0))
        if state.get("comm_stats"):
            self.stats.load_state(state["comm_stats"])
        self.stats.backward_exchanges = self.nlayers * self._step_count

    # ----------------------------------------------------------------- step
    def _forward(self, h0):
        # float32 logits for the loss (a no-op on the float32 path)
        return self.model(h0, self.pa).float()

    def _one_step(self, data: TrainData):
        """Loss, backward and optimizer update of one step; returns the
        loss and ``err`` (the loss itself unless ``loss='bce'``) as
        device scalars."""
        self.opt.zero_grad(set_to_none=True)
        logits = self._forward(data.h0)
        loss = self._loss_fn(logits, data.labels, data.train_valid)
        err = (masked_err_local(logits.detach(), data.labels,
                                data.train_valid)
               if self.loss_name == "bce" else loss.detach())
        # the reference all-reduces per-chip weight gradients
        # (lax.psum); with all k parts stacked on one device that sum is
        # the one autograd (GCN) or GatLayerSym's backward (GAT) forms
        # over the k·b rows of each h @ w.  A multi-process runtime
        # (ROADMAP A2b) all-reduces .grad here.
        loss.backward()
        self.opt.step()
        return loss.detach(), err

    def step(self, data: TrainData, sync: bool = True):
        """One training step.  ``sync=True`` returns the loss as a float
        (a device readback); ``sync=False`` returns the device scalar."""
        loss, err = self._one_step(data.to(self.device))
        self.last_err = err
        self.stats.count_step(nlayers=self.nlayers)
        self._step_count += 1
        return float(loss) if sync else loss

    def _eval_logits(self, data: TrainData):
        with torch.no_grad():
            return self._forward(data.h0)

    def evaluate(self, data: TrainData) -> tuple[float, float]:
        """(loss, accuracy) over the eval split, with the training
        objective."""
        data = data.to(self.device)
        with self.spans.span("eval"):
            logits = self._eval_logits(data)
            loss = self._loss_fn(logits, data.labels, data.eval_valid)
            acc = masked_accuracy_local(logits, data.labels, data.eval_valid)
            loss, acc = float(loss), float(acc)
        self.stats.count_forward(nlayers=self.nlayers)
        return loss, acc

    def predict(self, data: TrainData) -> np.ndarray:
        """Global (n, nout) logits in original vertex order."""
        logits = self._eval_logits(data.to(self.device))
        self.stats.count_forward(nlayers=self.nlayers)
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
        elapsed = self.timer.inclusive_total("train_step") - t_prior
        report = self.stats.report()
        report.update(
            epochs=epochs,
            elapsed_s=elapsed,
            epoch_s=elapsed / max(epochs, 1),
            loss_history=history,
            phases=self.timer.report(),
        )
        if self.loss_name == "bce":
            report["err"] = float(self.last_err)
        return report
