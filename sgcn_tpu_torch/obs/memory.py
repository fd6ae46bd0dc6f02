"""Analytic device-memory footprint and its measured join (port of
``sgcn_tpu/obs/memory.py``).

The reference prices one chip of a sharded mesh (its stacked arrays
divided by ``k``).  The port stacks all ``k`` parts on ONE device, so this
model prices that device: every stacked array in full, ``k`` times the
reference's per-chip figure for the per-part families (params are equal).
Per array FAMILY, in the reference's names, each priced at what the port
allocates:

  * **params** — the float32 weights, once;
  * **opt_state** — torch Adam's ``exp_avg`` and ``exp_avg_sq`` (one
    float32 copy of every parameter each); its ``step`` counters are
    host scalars (Adam's default, not capturable), priced at 0 here;
  * **features** — the stacked ``(k·b, fin)`` float32 features and, to
    train, the int64 labels and the float32 train and eval masks
    (``TrainData``); a sub-graph engine adds its ``(n + 1, fin)`` feature
    rows;
  * **plan_arrays / pallas_tiles** — exactly what
    ``ForwardSetup.ship_arrays`` puts on the device (the int8 GAT masks
    included), split on the ``ptile_`` prefix; the port-only layouts
    (``recv_src``, ``ring_src``, ``ptile_hwsrc``, the transposed tiles,
    the replica lists) with them, and the trainer's own index tensors of
    the carried modes;
  * **halo_tables** — 0 for GCN: the fused entry folds the receive
    layout in place, no ``(R, f)`` halo table is gathered.  GAT's pass
    reads one ``[p ‖ u]`` table of the local rows and the received ones
    (``models/gat.py::_gat_tiles_aggregate``: ``k·b`` rows plus the
    ring's concat, or on a2a the ``(k, R)`` halo rows its second pack
    gathers, which are priced as well), at the widest lane width;
  * **wire_buffers** — the pack's receive layout of one exchange
    (``CommPlan.recv_layout_shape``) at the widest lane width and the
    wire's itemsize;
  * **halo_carries / replica_carries** — the stale and replica carries
    in their receive layouts (and the partial refresh's float32
    baselines);
  * **workspace** — layer activations (and their backward mirrors to
    train) at the compute dtype; ``remat`` is priced as the plain step,
    an envelope of its layer-by-layer recompute;
  * **slot_temps** — under the ELL aggregator (``SGCN_PALLAS_SPMM=0``)
    its transient tables at the widest exchanged width
    (``ell_temp_bytes``): the family exists only then.

The measured side replaces XLA's ``compiled.memory_analysis()``
(``measure_device_step``): on the card, ``argument_bytes`` are the bytes
the caching allocator holds at the start of a step (its
``requested_bytes`` — the tensors' own sizes, before the allocator's
512-byte rounding), ``peak_bytes`` the ``max_memory_allocated`` over one
step after ``reset_peak_memory_stats``, ``temp_bytes`` their difference,
and ``alias_bytes`` the bytes of params and optimizer state the step
updated in place (their ``data_ptr`` unchanged — torch's counterpart of a
donated buffer; a serve forward updates nothing and aliases 0).  All
three count from the allocator's state when the trainer or engine began
(``device_bytes``), so tensors another caller holds are not its, nor
the process's cuBLAS workspaces (made before the first base).  On the
CPU nothing is measured (``None``, the join absent).  ``reconcile`` holds
the reference's contract: peak ≤ total × ``MEM_MODEL_TOL``, arguments ≤
modeled + 256 B, alias ≥ params + optimizer state to train and == 0 to
serve.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

# Reconciliation band of measured peak vs analytic total.  A STRUCTURAL
# DEFAULT calibrated on the reference's CPU fixture (its XLA programs sat
# in ~[0.25, 1.9]); the card's measured ratios are printed beside it
# (chip_smoke.py, PERF.md §5).
MEM_MODEL_TOL = 2.5

# Families resident for the life of the trainer or engine (their sum is
# what the measured argument bytes reconcile against).
ARGUMENT_FAMILIES = ("params", "opt_state", "features", "plan_arrays",
                     "pallas_tiles", "halo_carries", "replica_carries")
# Families a step materializes while it runs (``slot_temps``: the ELL
# aggregator's, under SGCN_PALLAS_SPMM=0).
SCRATCH_FAMILIES = ("halo_tables", "wire_buffers", "workspace",
                    "slot_temps")
# Families a training step updates in place (the reference's donated set).
DONATED_FAMILIES = ("params", "opt_state", "halo_carries",
                    "replica_carries")


class MemoryBudgetError(ValueError):
    """A (plan, mode) combination's analytic footprint exceeds the
    ``--memory-budget`` — raised in the trainer's or engine's
    ``__init__``, before any tensor ships, with the itemized table."""


@dataclass
class MemoryModel:
    """Analytic device footprint of ONE (plan, mode, model) on the port's
    one device (all ``k`` parts stacked)."""

    workload: str                 # 'train' | 'serve' | 'serve_subgraph'
    families: dict                # family name -> modeled bytes
    config: dict = field(default_factory=dict)   # scoping identity
    overlays: dict = field(default_factory=dict)  # informational, unsummed

    @property
    def total_bytes(self) -> int:
        return int(sum(self.families.values()))

    @property
    def argument_bytes(self) -> int:
        return int(sum(self.families.get(f, 0) for f in ARGUMENT_FAMILIES))

    @property
    def donated_bytes(self) -> int:
        return int(sum(self.families.get(f, 0) for f in DONATED_FAMILIES))

    @property
    def donated_floor_bytes(self) -> int:
        """Params + optimizer state: what every training step updates in
        place (the carries may be absent from a mode)."""
        return int(self.families.get("params", 0)
                   + self.families.get("opt_state", 0))

    def table(self) -> str:
        """Human-readable itemized breakdown — the loud half of the
        ``--memory-budget`` failure."""
        lines = [f"  {name:<16} {int(b):>14,} B"
                 for name, b in sorted(self.families.items(),
                                       key=lambda kv: -kv[1]) if b]
        lines.append(f"  {'TOTAL':<16} {self.total_bytes:>14,} B")
        for name, b in sorted(self.overlays.items()):
            lines.append(f"  ({name:<14} {int(b):>14,} B — informational, "
                         "not summed)")
        return "\n".join(lines)

    def block(self, measured: dict | None = None,
              resident: dict | None = None) -> dict:
        """The schema-v6 manifest ``memory`` block: per family
        ``{model_bytes, measured_bytes, ratio}`` — ``resident`` (family →
        the live tensors' bytes, ``resident_bytes`` of the trainer or
        engine) fills the per-family measured side — and the aggregate
        joins total↔peak, arguments↔argument bytes, donated↔alias bytes
        from ``measured`` (``measure_device_step``)."""
        def join(model_b, measured_b):
            e = {"model_bytes": int(model_b),
                 "measured_bytes": None if measured_b is None
                 else int(measured_b), "ratio": None}
            if measured_b is not None and model_b > 0:
                e["ratio"] = float(measured_b) / float(model_b)
            return e

        res = resident or {}
        m = measured or {}
        out = {
            "workload": self.workload,
            "config": dict(self.config),
            "families": {name: join(b, res.get(name))
                         for name, b in self.families.items()},
            "total": join(self.total_bytes, m.get("peak_bytes")),
            "arguments": join(self.argument_bytes, m.get("argument_bytes")),
            "donated": join(self.donated_bytes, m.get("alias_bytes")),
        }
        if self.overlays:
            out["overlays"] = {k: int(v) for k, v in self.overlays.items()}
        return out


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def shipped_bytes(setup, plan) -> tuple[int, int]:
    """``(plan_arrays, pallas_tiles)`` bytes of what
    ``setup.ship_arrays(plan)`` puts on the device, split on the
    ``ptile_`` prefix."""
    plan_b = pallas_b = 0
    for name, arr in setup.host_arrays(plan).items():
        if name.startswith("ptile_"):
            pallas_b += int(arr.nbytes)
        else:
            plan_b += int(arr.nbytes)
    return plan_b, pallas_b


def model_param_bytes(fin: int, widths, model: str = "gcn") -> int:
    """Float32 parameter bytes: GCN one ``(fin, fout)`` matrix per layer,
    GAT also its two ``(fout,)`` attention vectors."""
    dims = list(zip([int(fin)] + [int(w) for w in widths][:-1],
                    [int(w) for w in widths]))
    return 4 * sum(fi * fo + (2 * fo if model == "gat" else 0)
                   for fi, fo in dims)


def memory_model(plan, fin: int, widths, *, workload: str = "train",
                 model: str = "gcn", comm_schedule: str | None = None,
                 compute_dtype: str | None = None,
                 halo_dtype: str | None = None, halo_staleness: int = 0,
                 halo_delta: bool = False, replica_budget=0,
                 refresh_band: float | None = None, remat: bool = False,
                 setup=None, ranks: bool = False) -> MemoryModel:
    """The analytic footprint of one resolved mode on the port's device.

    ``setup`` is the caller's ``ForwardSetup`` (the trainer and the serve
    engine hold one), so the model prices exactly the arrays it ships;
    ``None`` resolves one with the given knobs (building the plan's tile
    layouts on the host, as the trainer does).  Nothing here allocates on
    a device.

    ``ranks``: ``plan`` is one rank's slice of a rank group
    (``parallel/proxy.py``), priced as that rank's device holds it; its
    carried modes add what the stacked layout does not hold: under
    ``halo_delta`` the senders' float32 baselines beside the receivers'
    carries (the stacked layout's one tensor is both), and to the scratch
    a replica step's shrunken receive buffer and the partial refresh's
    side-channel buffers (the forward's ``(k·RS', f)``, the gradient's
    ``(k·RS', f + 1)``, each sent and received), and on an asymmetric
    plan the backward's reverse exchange: the halo-ᵀ launch's float32
    output (the send buffer is its first ``k·S`` rows, narrowed to the
    wire's dtype in a copy of its own when the wire is narrower) and the
    ``(k·S, f)`` receive buffer in the wire's dtype."""
    widths = [int(w) for w in widths]
    fin = int(fin)
    if setup is None:
        from ..train.fullbatch import resolve_forward_setup
        setup = resolve_forward_setup(
            plan, model=model, comm_schedule=comm_schedule,
            halo_staleness=halo_staleness, replica_budget=replica_budget,
            refresh_band=refresh_band)
    schedule = setup.comm_schedule
    replica_budget = int(setup.replica_budget or 0)
    train = workload == "train"
    k, b = int(plan.k), int(plan.b)
    compute_isize = 2 if compute_dtype == "bfloat16" else 4

    families: dict[str, int] = {}
    families["params"] = model_param_bytes(fin, widths, model=model)
    families["opt_state"] = 2 * families["params"] if train else 0
    features = k * b * fin * 4
    if train:
        features += k * b * (8 + 4 + 4)     # labels, train and eval masks
    if workload == "serve_subgraph":
        features += (int(plan.n) + 1) * fin * 4
    families["features"] = features

    plan_b, pallas_b = shipped_bytes(setup, plan)
    if train and halo_staleness and schedule == "a2a":
        plan_b += int(plan.halo_src_flat.size) * 8     # int64 gather index
    if train and replica_budget:
        dst = plan.rep_ring_dst if schedule == "ragged" else plan.rep_recv_dst
        plan_b += int(dst.nbytes) + int(plan.rep_table_pos.nbytes)
    families["plan_arrays"] = plan_b
    families["pallas_tiles"] = pallas_b

    # per-layer exchanged widths (f32-lane equivalents) and the wire's
    # itemsize, as CommStats prices the wire
    lane_widths = list(setup.lane_widths_fn(fin, widths, compute_dtype))
    if model == "gat":
        wire_isize = 4                        # lanes encode the dtype
    else:
        wire_isize = 2 if (halo_dtype == "bfloat16" or halo_delta
                           or compute_dtype == "bfloat16") else 4
    rows = _prod(plan.recv_layout_shape(schedule))
    fmax = max(lane_widths) if lane_widths else 0
    families["wire_buffers"] = rows * fmax * wire_isize
    # the fused entry folds the receive layout in place; GAT's pass reads
    # [p ‖ u] over the local and the received rows: on the ring the
    # concat's rows, on a2a the (k, R) halo rows gathered out of the
    # receive layout (a table of their own)
    halo_rows = 0
    if model == "gat":
        halo_rows = k * b + (rows if schedule == "ragged"
                             else 2 * k * int(plan.r))
    families["halo_tables"] = halo_rows * fmax * wire_isize

    # the carries in their receive layouts (trainer's ``_zero_carries``):
    # per layer a feature and a gradient carry at the exchanged width
    families["halo_carries"] = 0
    families["replica_carries"] = 0
    if train and (halo_staleness or replica_budget) and model == "gcn":
        from ..models.gcn import exchange_widths
        fs = exchange_widths(fin, widths)
        wire = 2 if halo_dtype == "bfloat16" else 4
        f32_features = halo_delta if halo_staleness \
            else refresh_band is not None
        carry = sum(rows * f * ((4 if f32_features else wire) + wire)
                    for f in fs)
        if halo_staleness and halo_delta and ranks:
            carry += sum(rows * f * 4 for f in fs)      # senders' bases
        if halo_staleness:
            families["halo_carries"] = carry
        else:
            if refresh_band is not None:
                carry += sum(k * plan.rep_base_rows * f * 4 for f in fs)
            families["replica_carries"] = carry

    if train and ranks and not plan.symmetric:
        # the reverse exchange of the directed backward: the halo-ᵀ
        # output, the narrowed send copy (a narrower wire only) and the
        # receive buffer, at the widest lane width
        fwd = setup.fwd_static
        th = fwd["pallas_tchclasses" if model == "gat"
                 else "pallas_thclasses"]
        out_rows = int(sum(t for t, *_ in th)) * int(fwd["pallas_tb"])
        slots = k * int(plan.s)
        narrow = 1 if wire_isize < 4 else 0
        families["wire_buffers"] += (out_rows * 4 + (1 + narrow) * slots
                                     * wire_isize) * fmax

    if train and ranks and replica_budget and model == "gcn":
        # a replica step's shrunken receive buffer, and the partial
        # refresh's side channels (sent and received, both directions)
        nrows = int(plan.wire_rows_per_exchange(schedule, replica=True))
        families["wire_buffers"] += nrows * fmax * wire_isize
        if refresh_band is not None:
            side = int(plan.partial_refresh_wire_rows)
            families["wire_buffers"] += 2 * side * (2 * fmax + 1) * \
                wire_isize

    if setup.aggregator == "ell":
        families["slot_temps"] = ell_temp_bytes(
            plan, setup.fwd_static, fmax, compute_isize, wire_isize)

    # layer activations (+ backward mirrors to train), every layer width
    npass = 2 if train else 1
    families["workspace"] = npass * k * b * (fin + sum(widths)) \
        * compute_isize

    # pad overhead (informational: wire_buffers already holds the pads)
    true_rows = int(plan.send_counts.sum())
    padded_rows = int(plan.wire_rows_per_exchange(schedule))
    overlays = {"pad_overhead_bytes":
                max(0, padded_rows - true_rows) * fmax * wire_isize}

    config = {
        "workload": workload, "model": model, "n": int(plan.n),
        "nnz": int(plan.nnz.sum()), "k": k, "fin": fin,
        "widths": list(widths), "comm_schedule": schedule,
        "compute_dtype": compute_dtype or "float32",
        "halo_dtype": halo_dtype or "float32",
        "halo_staleness": int(halo_staleness), "halo_delta": bool(halo_delta),
        "replica_budget": replica_budget,
        "partial_refresh": refresh_band is not None, "remat": bool(remat),
        # the port's layout: all k parts on one device, priced in full,
        # or one rank's part of a rank group
        "layout": "ranks" if ranks else "stacked", "parts_per_device": k,
    }
    return MemoryModel(workload=workload, families=families, config=config,
                       overlays=overlays)


def ell_temp_bytes(plan, static: dict, f: int, isize: int,
                   wire_isize: int) -> int:
    """The ELL aggregator's transient tensors while one aggregation runs
    at width ``f`` (``ops/pspmm.py``; at most one runs at a time), an
    envelope: on the symmetric layouts the per-bucket sums and their
    concatenation, one slot's gather, the tail's and the remote pass's
    zero-started tables and their sum (five ``(k·B, f)`` tables in all),
    and the largest level's gather; on an asymmetric plan the backward's
    ``dh``, owners' sum and their sum (three ``(k·B, f)``), the reverse
    send buffer and the wire it is packed into (``(k, k·S, f)`` each) and
    the largest level's gather."""
    k, b = int(plan.k), int(plan.b)
    level = max((max(v, default=0) for v in static["ell_levels"].values()),
                default=0)
    if static["ell_layout"] == "directed":
        slots = k * k * int(plan.s)
        return f * (isize * (3 * k * b + slots + level)
                    + wire_isize * slots)
    nb = max(nb for nb, _ in static["ell_buckets"])
    return f * isize * (5 * k * b + k * nb + level)


def minibatch_memory_model(plans, fin: int, widths, *, setup,
                           model: str = "gcn",
                           compute_dtype: str | None = None,
                           remat: bool = False,
                           ranks: bool = False) -> MemoryModel:
    """The mini-batch trainer's footprint (``train/minibatch.py``): one
    step's families on the plan every batch plan is padded to
    (``plans[0]``: the same receive layout, halo and row counts), with
    what the trainer keeps on the device for the whole batch set in place
    of one plan's arrays and one ``TrainData``: every batch plan's arrays
    and tiles (shipped once) and every batch's features, labels and
    masks.  ``setup`` is resolved on ``plans[0]``, and every plan's tile
    layouts are built (``choose_tile_dispatch``) before this is called.
    One part's batch set (a rank of a rank group, ``ranks``, or the
    shard proxy): ``plans`` are that part's slices of the batch plans,
    each priced as the part's device holds it."""
    mm = memory_model(plans[0], fin, widths, workload="train", model=model,
                      compute_dtype=compute_dtype, remat=remat, setup=setup,
                      ranks=ranks)
    shipped = [shipped_bytes(setup, p) for p in plans]
    mm.families["plan_arrays"] = sum(pb for pb, _ in shipped)
    mm.families["pallas_tiles"] = sum(tb for _, tb in shipped)
    mm.families["features"] *= len(plans)
    mm.config["nbatches"] = len(plans)
    return mm


# ---------------------------------------------------------------- measured
_BLAS_READY: set = set()


def _make_blas_workspaces(dev) -> None:
    """A thread's first product on a stream allocates its cuBLAS handle's
    workspace through the caching allocator, and it stays for the life
    of the process, as the CUDA context does.
    The calling thread and autograd's backward thread hold a handle each:
    run one product and its backward here, once per device and stream, so
    that a base taken after it holds both workspaces and no trainer's or
    engine's join counts them as its own."""
    import torch

    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(dev).cuda_stream)
    if key in _BLAS_READY:
        return
    with torch.inference_mode(False), torch.enable_grad():
        x = torch.ones((8, 8), device=dev, requires_grad=True)
        (x @ x).sum().backward()
    del x
    torch.cuda.synchronize(dev)
    _BLAS_READY.add(key)


def device_bytes(device) -> tuple[int, int] | None:
    """``(requested, allocated)`` bytes the caching allocator holds on a
    CUDA ``device`` now — the tensors' own sizes and the allocator's
    512-byte-rounded blocks — or ``None`` off the card.  The process's
    cuBLAS workspaces are made first (``_make_blas_workspaces``): they are
    in every figure read here, in no difference of two."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    _make_blas_workspaces(dev)
    stats = torch.cuda.memory_stats(dev)
    alloc = int(torch.cuda.memory_allocated(dev))
    return int(stats.get("requested_bytes.all.current", alloc)), alloc


def measure_device_step(run, device, base: tuple[int, int] | None,
                        updated=()) -> dict | None:
    """Measure one ``run()`` (a training step or a forward) on the card:
    ``argument_bytes`` held before it, its ``peak_bytes``
    (``max_memory_allocated`` after ``reset_peak_memory_stats``), the
    ``temp_bytes`` between, and ``alias_bytes``: the bytes of the
    ``updated`` tensors (params, optimizer state) that ``run`` left at the
    same ``data_ptr``.  Each counts from ``base`` (``device_bytes`` when
    the trainer or engine began).  Off the card ``run`` runs unmeasured
    and the result is ``None``."""
    import torch

    if torch.device(device).type != "cuda":
        run()
        return None
    torch.cuda.synchronize(device)
    b_req, b_alloc = base if base is not None else (0, 0)
    before = [(t, t.data_ptr()) for t in updated]
    arg = device_bytes(device)[0] - b_req
    torch.cuda.reset_peak_memory_stats(device)
    run()
    torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device)) - b_alloc
    alias = sum(t.numel() * t.element_size() for t, ptr in before
                if t.data_ptr() == ptr)
    return {"argument_bytes": max(arg, 0), "temp_bytes": max(peak - arg, 0),
            "alias_bytes": int(alias), "peak_bytes": max(peak, 0)}


def reconcile(model: MemoryModel, measured: dict | None,
              tol: float = MEM_MODEL_TOL, resident: dict | None = None
              ) -> dict:
    """Join one measured step against the analytic model; returns ``{ok,
    violations, block}`` (``block`` the manifest-shaped join)."""
    violations: list[str] = []
    if measured is not None:
        peak, total = measured["peak_bytes"], model.total_bytes
        if total > 0 and peak > total * tol:
            violations.append(
                f"measured peak {peak:,} B exceeds the analytic total "
                f"{total:,} B x tol {tol} (ratio {peak / total:.2f}) — "
                "the model is the residency upper envelope; a step above "
                "it holds buffers the model does not know about")
        arg_model = model.argument_bytes
        if measured["argument_bytes"] > arg_model + 256:
            violations.append(
                f"measured argument bytes {measured['argument_bytes']:,} B "
                f"exceed the modeled resident arguments {arg_model:,} B — "
                "the device holds tensors the footprint model does not "
                "price")
        floor = model.donated_floor_bytes
        if model.workload == "train":
            if measured["alias_bytes"] < floor:
                violations.append(
                    f"measured alias {measured['alias_bytes']:,} B below "
                    f"the params+opt floor {floor:,} B — the step "
                    "reallocated weights or optimizer state instead of "
                    "updating them in place")
        elif measured["alias_bytes"] != 0:
            violations.append(
                f"serve forward aliases {measured['alias_bytes']:,} B — "
                "a forward updates no weights in place")
    return {"ok": not violations, "violations": violations,
            "block": model.block(measured, resident)}


# ------------------------------------------------------------------ budget
def check_memory_budget(model: MemoryModel, budget_bytes: int | None,
                        what: str = "this run") -> None:
    """Raise ``MemoryBudgetError`` when the analytic footprint exceeds the
    budget — called in the trainer's or engine's ``__init__`` before any
    tensor ships (the reference's message)."""
    if budget_bytes is None:
        return
    budget_bytes = int(budget_bytes)
    if budget_bytes <= 0:
        raise ValueError(f"--memory-budget must be > 0 bytes, got "
                         f"{budget_bytes}")
    total = model.total_bytes
    if total > budget_bytes:
        raise MemoryBudgetError(
            f"{what}: analytic per-chip HBM footprint {total:,} B exceeds "
            f"--memory-budget {budget_bytes:,} B "
            f"(workload={model.workload}) — per-family breakdown:\n"
            f"{model.table()}")


_SUFFIX = {"K": 1024, "M": 1024 ** 2, "G": 1024 ** 3, "T": 1024 ** 4}


def parse_bytes(text: str) -> int:
    """Parse a ``--memory-budget`` value: plain bytes or a K/M/G/T binary
    suffix (``16G`` = 16 GiB)."""
    s = str(text).strip().upper().removesuffix("B")
    mult = 1
    if s and s[-1] in _SUFFIX:
        mult, s = _SUFFIX[s[-1]], s[:-1]
    try:
        val = float(s)
    except ValueError:
        raise ValueError(
            f"--memory-budget {text!r} is not BYTES or a K/M/G/T-suffixed "
            "size") from None
    if not math.isfinite(val) or val <= 0:
        raise ValueError(f"--memory-budget {text!r} must be positive")
    return int(val * mult)
