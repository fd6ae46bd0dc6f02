"""Full-batch partitioned GCN trainer and the forward setup it shares with
the serve engine (port of ``sgcn_tpu/train/fullbatch.py``, exact path).

``resolve_forward_setup`` ports only the GCN / dense-a2a / tile-kernel
selection; what the reference resolves beyond it raises a clear "not
ported yet" error: GAT, the ragged ring and asymmetric plans
(``pspmm_overlap``); bf16 tables are refused by the kernel wrapper.

``FullBatchTrainer`` is the reference's exact trainer over the ``k``
parts stacked on one device: per step the L-layer forward (exchange →
tile SpMM → projection → activation), the masked loss, autograd's
backward (each aggregation's backward re-runs the tile SpMM on the
gradient, ``ops/tile_spmm.py::PspmmTilesSym``) and Adam.  The levers of
the reference that are not ported — precision, remat, stale halos,
replicas, the ragged ring, memory budgets — raise "not ported yet" with
their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gcn import (GCN, exchange_widths, gcn_forward_local,
                          init_gcn_params, masked_accuracy_local,
                          masked_err_local, masked_sigmoid_bce_local,
                          masked_softmax_xent_local)
from ..ops.tile_spmm import TILE_PLAN_FIELDS, choose_tile_dispatch
from ..utils.backend import resolve_device, synchronize
from ..utils.stats import CommStats
from ..utils.timers import PhaseTimer, SpanTimer

# loss registry: 'xent' is the torch stack's log-softmax + NLL, 'bce' the
# MPI stack's sigmoid + BCE whose reported metric is `err`
LOSSES = {
    "xent": masked_softmax_xent_local,
    "bce": masked_sigmoid_bce_local,
}


@dataclass
class ForwardSetup:
    """Resolved forward configuration: the plan fields the forward reads,
    its static kwargs, and the selection log."""

    model: str
    comm_schedule: str            # resolved: 'a2a'
    plan_fields: tuple            # CommPlan array fields the forward reads
    fwd_static: dict              # static kwargs of the forward fn
    forward_fn: object            # stacked forward
    init_fn: object               # param init
    decision: dict                # selection log

    def ship_arrays(self, plan, device) -> dict:
        """The plan arrays the forward consumes, as tensors on ``device``
        (integer arrays stay int32, the kernel's stored form)."""
        return {f: torch.as_tensor(np.ascontiguousarray(getattr(plan, f)))
                .to(device) for f in self.plan_fields}


def resolve_forward_setup(plan, model: str = "gcn",
                          comm_schedule: str | None = None) -> ForwardSetup:
    """Resolve the ported subset: GCN on a symmetric plan over the dense
    a2a exchange, every tile class on the tile kernel
    (``choose_tile_dispatch``, tile height 256).  Builds the plan's tile
    layout as a side effect, as the reference does.  The reference's
    ``fin``/``widths`` fed its VMEM-fit rule, which is not carried."""
    if model != "gcn":
        raise NotImplementedError(
            f"model {model!r} is not ported yet (GCN only; GAT is "
            "ROADMAP item A5)")
    if comm_schedule not in (None, "a2a"):
        raise NotImplementedError(
            f"comm_schedule {comm_schedule!r} is not ported yet (dense a2a "
            "only; the ragged ring is ROADMAP item A4)")
    if not plan.symmetric:
        raise NotImplementedError(
            "asymmetric plans need pspmm_overlap, which is not ported yet "
            "(ROADMAP item A2); this port serves symmetric Â")
    decision: dict = {"asked": comm_schedule, "resolved": "a2a",
                      "rule": "only transport ported"}
    fwd_static = choose_tile_dispatch(plan, decision=decision)
    return ForwardSetup(model=model, comm_schedule="a2a",
                        plan_fields=TILE_PLAN_FIELDS, fwd_static=fwd_static,
                        forward_fn=gcn_forward_local,
                        init_fn=init_gcn_params, decision=decision)


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
    "compute_dtype": (None, "A6"),
    "remat": (False, "A3"),
    "halo_dtype": (None, "A6"),
    "halo_staleness": (0, "A7"),
    "halo_delta": (False, "A7"),
    "sync_every": (0, "A7"),
    "replica_budget": (0, "A7"),
    "refresh_band": (None, "A7"),
    "memory_budget": (None, "A10"),
}


class FullBatchTrainer:
    """Full-batch partitioned GCN trainer, exact a2a path (the reference's
    ``FullBatchTrainer`` with its defaults)."""

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
        ``params``: initial ``(fin, fout)`` weights (numpy arrays — e.g.
        the JAX package's — or tensors); ``None`` draws Glorot weights
        from a ``torch.Generator`` seeded with ``seed``.  ``device``:
        ``None`` means ``cuda`` and raises without a GPU; pass ``"cpu"``
        to train on the CPU.  Levers not ported raise
        ``NotImplementedError``."""
        given = {"compute_dtype": compute_dtype, "remat": remat,
                 "halo_dtype": halo_dtype, "halo_staleness": halo_staleness,
                 "halo_delta": halo_delta, "sync_every": sync_every,
                 "replica_budget": replica_budget,
                 "refresh_band": refresh_band,
                 "memory_budget": memory_budget}
        for name, (off, item) in _UNPORTED_LEVERS.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet (ROADMAP "
                    f"item {item}); this port trains the exact f32 a2a "
                    "path")
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}; one of {sorted(LOSSES)}")
        self.device = resolve_device(device)
        setup = resolve_forward_setup(plan, model=model,
                                      comm_schedule=comm_schedule)
        self.comm_decision = setup.decision
        self.comm_schedule = setup.comm_schedule
        self.plan = plan
        self.fin = int(fin)
        self.widths = list(widths)
        self.activation = activation
        self.final_activation = final_activation
        self.loss_name = loss
        self._loss_fn = LOSSES[loss]
        dims = list(zip([self.fin] + self.widths[:-1], self.widths))
        if params is None:
            params = setup.init_fn(torch.Generator().manual_seed(seed), dims)
        if [tuple(w.shape) for w in params] != dims:
            raise ValueError(
                f"param shapes {[tuple(w.shape) for w in params]} != "
                f"layer dims {dims}")
        self.model = GCN(params, activation=activation,
                         final_activation=final_activation,
                         fwd_static=setup.fwd_static).to(self.device)
        self.pa = setup.ship_arrays(plan, self.device)
        self.opt = (optimizer(list(self.model.parameters()))
                    if optimizer is not None else
                    torch.optim.Adam(self.model.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8))
        self.stats = CommStats.from_plan(
            plan, schedule=self.comm_schedule,
            lane_widths=exchange_widths(self.fin, self.widths),
            wire_itemsize=4)
        self.timer = PhaseTimer()
        self.spans = SpanTimer(timer=self.timer)
        self._step_count = 0
        self.last_err = None

    # ------------------------------------------------------------- state
    @property
    def params(self) -> list:
        """The weights, ``(fin, fout)`` per layer (live parameters)."""
        return list(self.model.weights)

    @property
    def nlayers(self) -> int:
        return len(self.widths)

    def _sync(self) -> None:
        synchronize(self.device)

    # ----------------------------------------------------------------- step
    def _forward(self, h0):
        return self.model(h0, self.pa)

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
        # the one autograd forms over the k·b rows of each h @ w.  A
        # multi-process runtime (ROADMAP A2b) all-reduces .grad here.
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
