"""Plan-derived expectations of the census (port of
``sgcn_tpu/analysis/expect.py``).

Everything the census holds a step to is computed here from the plan,
the mode and the port's own helpers — never from a recorded census:

  * the exchanges of one step: per layer the lane width
    (``models/gcn.py::exchange_widths``, ``models/gat.py::gat_table_form``)
    and the wire's dtype, forward always and backward on the layers whose
    input gradient autograd runs (the reference's rule,
    ``sgcn_tpu/analysis/expect.py:151-233``: layer 0's only under
    project-first; in the port that holds for the stale and refresh
    steps too: the reference's programs also emit layer 0's as the next
    step's carry, while the port's autograd never runs layer 0's input
    gradient when it aggregates first, so that carry is neither made nor
    read);
  * each exchange's packs and collectives from the receive layout
    (``CommPlan.recv_layout_shape``, ``wire_buffer_shapes``, the live
    rounds of ``ops/pspmm.py::ragged_live_rounds``), the shrunken layout on
    a replica step;
  * the launches per ``utils/census.py::LAUNCH_LABELS`` label: one fused
    launch per stacked GCN aggregation (its dtype pair names the entry),
    two K1 family launches per rank aggregation that overlaps its
    exchange, one K5 pass per GAT table (two for the split and packed
    forms), nothing on the ELL aggregator;
  * the rank group's other collectives: one gradient all-reduce per
    parameter, the loss's pinned scalar reduces (``XENT_RANK_REDUCES``),
    GAT's per-layer max, and per served batch the header and id
    broadcasts and one row all-gather.

Three constants are pinned by experiment, as the reference pins
``XENT_SCALAR_PSUMS``; the full census at HEAD validates them for every
mode, and a change that moves one fails it loudly:

  * ``XENT_RANK_REDUCES = 2`` — the scalar sums of one rank's train step:
    the masked loss's global row count (``models/gcn.py::
    masked_count``) and the step's loss returned to the caller
    (``train/fullbatch.py::_reduced``);
  * ``HOST_READS`` — the tensors a step reads into Python numbers
    (``aten::_local_scalar_dense``) outside the optimizer and the plain
    versions: none in a train step (``step(sync=False)``), one in a
    mini-batch step (the loss its ``step`` returns), none in a stacked
    served batch, and on a rank group's served batch the header's
    ``SERVE_HEADER_FIELDS`` fields;
  * ``DTOH_COPIES`` — device-to-host copies (the card only): a served
    batch's rows, and on a rank group also its header and ids.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

# the scalar sums of one rank's train step (module docstring)
XENT_RANK_REDUCES = 2
# the fields a rank reads from a served batch's header broadcast
# (serve/engine.py::_rank_round: action, bucket, nq, path bytes, measure)
SERVE_HEADER_FIELDS = 5
# host reads (_local_scalar_dense) a step may make, by (workload, ranks)
HOST_READS = {("train", False): 0, ("train", True): 0,
              ("minibatch", False): 1,
              ("serve", False): 0, ("serve", True): SERVE_HEADER_FIELDS,
              ("serve_subgraph", False): 0}
# device-to-host copies a step may make (the card only), same keys
DTOH_COPIES = {("train", False): 0, ("train", True): 0,
               ("minibatch", False): 1,
               ("serve", False): 1, ("serve", True): 3,
               ("serve_subgraph", False): 1}

@dataclass(frozen=True)
class Exchange:
    """One exchange of a step: direction, layer, lane width (``None``: one
    scalar a row), what it packs (the sender's table dtype the pack
    writes), what crosses the wire, what the aggregation reads, and
    whether it ships the shrunken replica layout."""

    direction: str
    layer: int
    lanes: int | None
    pack_dtype: str
    wire_dtype: str
    table_dtype: str
    shrunk: bool = False


@dataclass
class Expectation:
    """What one censused step must hold."""

    exchanges: list = field(default_factory=list)     # [Exchange]
    launches: Counter = field(default_factory=Counter)
    packs: list = field(default_factory=list)         # (label, shape, dt)
    collectives: list = field(default_factory=list)   # (label, shape, dt)
    host_reads: int = 0
    dtoh_copies: int = 0
    forbidden_packs: list = field(default_factory=list)
    overlapped: int = 0        # rank aggregations: issue, launch, wait
    ptr_keep: tuple = ()       # in-place names (``census`` snapshot keys)
    version_keep: tuple = ()


def gcn_layer_plan(fin: int, widths) -> tuple[list, list]:
    """(per-layer exchanged lane widths, per-layer project-first flags):
    ``models/gcn.py::exchange_widths`` and its condition."""
    from ..models.gcn import PROJECT_FIRST_MIN_FIN, exchange_widths

    fs = exchange_widths(fin, list(widths))
    pf, f = [], fin
    for w in widths:
        pf.append(bool(w < f and f >= PROJECT_FIRST_MIN_FIN))
        f = w
    return fs, pf


def _gcn_dtypes(mode, label: str) -> dict:
    """The dtypes of a GCN step's exchanges: ``pack`` (what the sender's
    pack writes), ``wire`` (what crosses a rank's collective) and
    ``table`` (what the aggregation reads), per direction."""
    wire = "bf16" if mode.halo_dtype == "bfloat16" else "f32"
    out = {"fwd": dict(pack=wire, wire=wire, table=wire),
           "bwd": dict(pack=wire, wire=wire, table=wire)}
    if mode.delta:
        # the halo-delta cache: the pack gathers the full float32 row, a
        # stale step ships its increment rounded to bf16 and a sync step
        # the float32 row (the re-base); the carry read is float32
        inc = "f32" if label == "sync" else "bf16"
        out["fwd"] = dict(pack="f32", wire=inc, table="f32")
    return out


def exchanges(owner, ctx, mode, label: str) -> list:
    """The step's exchanges in the reference's order (GCN: forward by
    layer, then backward; GAT: layer by layer, forward and backward),
    derived from the mode and the layer widths."""
    widths = ctx["widths"]
    fin = owner.fin if hasattr(owner, "fin") else owner.inner.fin
    train = mode.workload in ("train", "minibatch")
    out = []
    if mode.model == "gcn":
        fs, pf = gcn_layer_plan(fin, widths)
        dts = _gcn_dtypes(mode, label)
        shrunk = mode.replica and label in ("rep", "stale")
        for i, f in enumerate(fs):
            d = dts["fwd"]
            out.append(Exchange("fwd", i, f, d["pack"], d["wire"],
                                d["table"], shrunk))
        if train:
            d = dts["bwd"]
            for i, f in enumerate(fs):
                if i > 0 or pf[0]:
                    out.append(Exchange("bwd", i, f, d["pack"], d["wire"],
                                        d["table"], shrunk))
        return out
    from ..models.gat import gat_table_form

    # layer by layer, both directions (the reference's order): each
    # direction ships the same form
    for i, fout in enumerate(widths):
        for direction in (("fwd", "bwd") if train else ("fwd",)):
            form = gat_table_form(fout, mode.compute_dtype
                                  if mode.workload == "train" else None)
            if form == "packed":
                tables = [fout // 2 + 1]
            elif form == "fused" or mode.schedule == "ragged":
                # the ring ships the split pair as one two-part table
                tables = [fout + 1]
            else:
                tables = [fout, None]
            for lanes in tables:
                out.append(Exchange(direction, i, lanes, "f32", "f32",
                                    "f32"))
    return out


def _lane_shape(rows: tuple, lanes) -> tuple:
    return tuple(rows) + (() if lanes is None else (int(lanes),))


def _ring_sizes(plan, static, shrunk: bool) -> tuple:
    if shrunk:
        return tuple(plan.nrep_rr_sizes)
    sizes = static.get("rr_sizes") if static else None
    return tuple(sizes if sizes is not None else plan.rr_sizes
                 if plan.rr_sizes is not None
                 else plan.ragged_round_sizes())


def _wire_rows(plan, mode, static, shrunk: bool) -> int:
    """Rows of one exchange's receive layout (a rank's send buffer): the
    a2a's every peer's padded bucket, the ring's live rounds; the
    shrunken ``nrep`` layout on a replica step."""
    from ..ops.pspmm import ragged_live_rounds

    if mode.schedule == "ragged":
        sizes = _ring_sizes(plan, static, shrunk)
        return max(1, sum(sizes[d - 1] for d in ragged_live_rounds(sizes)))
    peers = int(plan.recv_layout_shape("a2a")[1]) // int(plan.s)
    return peers * int(plan.nrep_s if shrunk else plan.s)


def _keep_rows(plan, mode, ranks: bool) -> int:
    """Rows a replica step packs into the carried layout: the kept
    (non-replica) slots of the transport (a rank: its slice's)."""
    import numpy as np

    ring = mode.schedule == "ragged"
    name = (("keep_nring_src" if ring else "keep_nrecv_src") if ranks
            else ("keep_ring_src" if ring else "keep_recv_src"))
    return int(np.asarray(getattr(plan, name)).size)


def _rows(classes, tb) -> int:
    return int(sum(int(c[0]) for c in classes)) * int(tb)


def _fused_label(h: str, table: str) -> str:
    return {("f32", "f32"): "fused", ("f32", "bf16"): "fused-wire-bf16",
            ("bf16", "bf16"): "fused-bf16"}[(h, table)]


def expectation(owner, ctx, mode, label: str, kind: str = "er"
                ) -> Expectation:
    """The expectation of one censused step of ``mode`` (``label``: the
    program of ``census.program_labels``)."""
    plan, static = ctx["plan"], ctx.get("static") or {}
    ranks = bool(mode.ranks)
    k = int(plan.k)
    sub = mode.workload == "serve_subgraph"
    # the sub-graph server's compact forward ships no exchange
    exp = Expectation(exchanges=[] if sub else exchanges(owner, ctx, mode,
                                                         label))
    key = (mode.workload, ranks)
    exp.host_reads = HOST_READS[key]
    exp.dtoh_copies = DTOH_COPIES[key]
    tiles = mode.aggregator == "tiles"
    from ..ops.pspmm import ragged_live_rounds

    for ex in exp.exchanges:
        rows = _wire_rows(plan, mode, static, ex.shrunk)
        if mode.model == "gcn" and ex.shrunk and not ranks:
            # a stacked replica step packs the kept rows straight into
            # the carried receive layout
            exp.packs.append(("pack-into", _lane_shape(
                (_keep_rows(plan, mode, False),), ex.lanes), ex.pack_dtype))
        else:
            exp.packs.append(("pack", _lane_shape((k, rows), ex.lanes),
                              ex.pack_dtype))
        if ranks:
            if mode.schedule == "a2a":
                exp.collectives.append(("all_to_all", _lane_shape(
                    (rows,), ex.lanes), ex.wire_dtype))
            else:
                sizes = _ring_sizes(plan, static, ex.shrunk)
                lab = "loopback" if owner.mesh.size == 1 else "isend_irecv"
                for d in ragged_live_rounds(sizes):
                    exp.collectives.append((lab, _lane_shape(
                        (sizes[d - 1],), ex.lanes), ex.wire_dtype))
        if mode.model == "gat" and mode.schedule == "a2a":
            # the halo rows of the receive layout, the second pack
            r = int(plan.halo_src_flat.shape[-1])
            exp.packs.append(("pack", _lane_shape((k, r), ex.lanes),
                              ex.pack_dtype))
    # the replica step's pack into the carry on a rank runs when the
    # exchange has arrived: in the step on a replica step, at the next
    # read (the following step) in the composed stale mode
    if mode.model == "gcn" and ranks and mode.replica:
        intos = [ex for ex in exp.exchanges if ex.shrunk] \
            if label == "rep" else (
                [ex for ex in exchanges(owner, ctx, mode, "stale")]
                if mode.staleness and label == "sync" else [])
        for ex in intos:
            exp.packs.append(("pack-into", _lane_shape(
                (_keep_rows(plan, mode, True),), ex.lanes), ex.pack_dtype))
    for lab, _shape, _dt in exp.packs:
        exp.launches[lab] += 1
    # launches of the aggregations
    if tiles and mode.model == "gcn":
        # a rank's exact step, replica step and served batch overlap each
        # exchange with the local pass: two family launches; its stale and
        # sync steps read an arrived carry in one fused launch
        split = ranks and label in ("step", "rep", "batch")
        for ex in exp.exchanges:
            if split:
                exp.launches["K1"] += 1
                exp.launches["K1" if ex.table_dtype == "f32"
                             else "K1-bf16"] += 1
                exp.overlapped += label in ("step", "batch")
            else:
                exp.launches[_fused_label("f32", ex.table_dtype)] += 1
        if sub:
            fs, _ = gcn_layer_plan(owner.fin, ctx["widths"])
            wire = "bf16" if mode.halo_dtype == "bfloat16" else "f32"
            exp.launches[_fused_label("f32", wire)] += len(fs)
    elif tiles:
        from ..models.gat import gat_table_form

        train = mode.workload == "train"
        for direction in (("fwd", "bwd") if train else ("fwd",)):
            for fout in ctx["widths"]:
                form = gat_table_form(fout, mode.compute_dtype if train
                                      else None)
                if form == "fused":
                    exp.launches["K5"] += 1
                elif form == "packed":
                    exp.launches["K5-bf16"] += 1
                    exp.launches["K5"] += 1
                else:
                    exp.launches["K5"] += 2
    # the rank group's other collectives
    if ranks:
        model = owner.model
        if mode.workload == "train":
            for p in model.parameters():
                exp.collectives.append(("grad_all_reduce", tuple(p.shape),
                                        "f32"))
            exp.collectives += [("all_reduce_sum", (), "f32")] * \
                XENT_RANK_REDUCES
        else:
            from ..serve.engine import HEADER_LEN

            bucket = len(ctx["qids"])
            exp.collectives += [("broadcast", (HEADER_LEN,), "i64"),
                                ("broadcast", (bucket,), "i64"),
                                ("all_gather", (bucket, ctx["widths"][-1]),
                                 "f32")]
        if mode.model == "gat":
            exp.collectives += [("all_reduce_max", (), "f32")] * \
                len(ctx["widths"])
    # halo materialization: a GCN tile aggregation reads the receive
    # layout in place; a pack shaped like the (k, R, f) halo table means
    # the table was assembled first (dropped where it collides with a
    # legitimate pack shape)
    if tiles and mode.model == "gcn" and not sub:
        legit = {s for _l, s, _d in exp.packs}
        r = int(plan.r) if plan.chip_ids is None else int(
            plan.halo_src_flat.shape[-1])
        exp.forbidden_packs = sorted(
            {_lane_shape((k, r), ex.lanes) for ex in exp.exchanges}
            - legit)
    # in place: params and optimizer state always; a replica step's
    # carries; plan tensors and data never written; a served batch
    # writes no parameter
    exp.ptr_keep = ("param", "opt", "replica_carry", "halo_carry") \
        if mode.replica and label in ("rep", "stale") else ("param", "opt")
    exp.version_keep = ("pa.", "data.", "features") + (
        ("param",) if mode.workload.startswith("serve") else ())
    return exp


def inplace_carries(owner) -> dict:
    """The carries a step may update in place, by family, as lists of
    tensors (an in-flight rank carry by its buffer, unwaited)."""
    out = {}
    for fam in ("replica_carry", "halo_carry"):
        carry = getattr(owner, fam, None)
        if not carry:
            continue
        out[fam] = {key: [getattr(x, "buffer", x) for x in xs]
                    for key, xs in carry.items() if key in ("halos",
                                                            "ghalos")}
    return out


def check_selection(owner, mode) -> None:
    """The census must never check the wrong aggregator: a tile mode that
    fell back to ELL (or the reverse) would pass vacuously."""
    tr = owner.inner if hasattr(owner, "inner") else owner
    got = tr.setup.aggregator
    want = "ell" if mode.aggregator == "ell" else "tile"
    if got != want:
        raise RuntimeError(f"mode {mode.mode_id}: the {got} aggregator was "
                           f"selected, not the {want} one")


def _viol(rule: str, detail: str) -> dict:
    return {"rule": rule, "detail": detail}


def _diff(expected, observed):
    e, o = Counter(expected), Counter(observed)
    return sorted(map(str, (e - o).elements())), \
        sorted(map(str, (o - e).elements()))


def check(rec: dict, snap: dict, exp: Expectation, mode, device) -> list:
    """Hold one recorded step to its expectation; returns the violations,
    each naming its rule."""
    v: list = []
    records = rec["records"]
    launches = [r for r in records if r.kind == "launch"]
    colls = [r for r in records if r.kind == "collective"
             and r.label != "wait"]
    # ---- launch-census
    got = Counter(r.label for r in launches)
    if got != exp.launches:
        miss, extra = _diff(exp.launches.elements(), got.elements())
        v.append(_viol("launch-census",
                       f"launches {dict(sorted(got.items()))} != expected "
                       f"{dict(sorted(exp.launches.items()))}: missing "
                       f"{miss}, unexpected {extra}"))
    if mode.aggregator == "ell":
        spmm = [r.label for r in launches if r.label not in ("pack",
                                                             "pack-into")]
        if spmm:
            v.append(_viol("launch-census",
                           f"the ELL aggregator launched {spmm}"))
    # on the card each launch moves its wrapper's counter (the profiler's
    # device kernels are held to the hooks over the whole run:
    # census.device_window)
    if (rec["counters"] or str(device).startswith("cuda")) and \
            rec["counters"] != dict(got):
        v.append(_viol("launch-census",
                       f"the wrappers' counters moved by {rec['counters']}, "
                       f"the hooks recorded {dict(got)}"))
    # ---- packs: exchange count, shape, dtype
    packs = [(r.label, r.shape, r.dtype) for r in launches
             if r.label in ("pack", "pack-into")]
    e_n = Counter(lab for lab, _s, _d in exp.packs)
    o_n = Counter(lab for lab, _s, _d in packs)
    if e_n != o_n:
        v.append(_viol("exchange-census",
                       f"packs {dict(o_n)} != expected {dict(e_n)} (one per "
                       "dense or ring exchange; a rank's GAT a2a table "
                       "also packs its halo rows)"))
    e_s = Counter((lab, s) for lab, s, _d in exp.packs)
    o_s = Counter((lab, s) for lab, s, _d in packs)
    if e_s != o_s:
        miss, extra = _diff(e_s.elements(), o_s.elements())
        v.append(_viol("wire-shape",
                       f"pack shapes drifted from the plan's layout: "
                       f"missing {miss}, unexpected {extra}"))
    e_d = Counter((lab, d) for lab, _s, d in exp.packs)
    o_d = Counter((lab, d) for lab, _s, d in packs)
    if e_d != o_d:
        miss, extra = _diff(e_d.elements(), o_d.elements())
        v.append(_viol("wire-dtype",
                       f"pack dtypes != requested: missing {miss}, "
                       f"unexpected {extra}"))
    elif e_s == o_s and Counter(packs) != Counter(exp.packs):
        miss, extra = _diff(exp.packs, packs)
        v.append(_viol("wire-dtype",
                       f"pack (shape, dtype) pairing drifted: missing "
                       f"{miss}, unexpected {extra}"))
    # ---- collectives
    obs = [(r.label, r.shape, r.dtype) for r in colls]
    if Counter(obs) != Counter(exp.collectives):
        el = Counter(lab for lab, _s, _d in exp.collectives)
        ol = Counter(lab for lab, _s, _d in obs)
        if el != ol:
            v.append(_viol("exchange-census",
                           f"collectives {dict(sorted(ol.items()))} != "
                           f"expected {dict(sorted(el.items()))}"))
        es = Counter((lab, s) for lab, s, _d in exp.collectives)
        os_ = Counter((lab, s) for lab, s, _d in obs)
        if es != os_:
            miss, extra = _diff(es.elements(), os_.elements())
            v.append(_viol("wire-shape",
                           f"collective buffers drifted from "
                           f"wire_buffer_shapes: missing {miss}, "
                           f"unexpected {extra}"))
        ed = Counter((lab, d) for lab, _s, d in exp.collectives)
        od = Counter((lab, d) for lab, _s, d in obs)
        if ed != od or (el == ol and es == os_):
            miss, extra = _diff(exp.collectives, obs)
            v.append(_viol("wire-dtype",
                           f"collective dtypes != requested: missing "
                           f"{miss}, unexpected {extra}"))
    # ---- halo materialization
    hits = sorted({str(s) for lab, s, _d in packs
                   if s in exp.forbidden_packs})
    if hits:
        v.append(_viol("halo-materialization",
                       f"pack(s) shaped like the (k, R, f) halo table "
                       f"{hits}: the fused launch reads the receive layout "
                       "in place — no halo table is assembled"))
    # ---- host reads
    host = rec["host"]
    if host["host_reads"] > exp.host_reads:
        v.append(_viol("host-sync",
                       f"{host['host_reads']} host reads "
                       "(aten::_local_scalar_dense) in the step, at most "
                       f"{exp.host_reads} pinned (expect.HOST_READS)"))
    if host["dtoh_copies"] > exp.dtoh_copies:
        v.append(_viol("host-sync",
                       f"{host['dtoh_copies']} device-to-host copies in "
                       f"the step, at most {exp.dtoh_copies} pinned "
                       "(expect.DTOH_COPIES)"))
    # ---- in place
    after = rec["after"]
    if after is not None:
        moved = [n for n, p in snap["ptr"].items()
                 if n.startswith(exp.ptr_keep) and after["ptr"].get(n) != p]
        if moved:
            v.append(_viol("in-place",
                           f"reallocated by the step (data_ptr moved): "
                           f"{moved[:6]}{' …' if len(moved) > 6 else ''}"))
        written = [n for n, ver in snap["version"].items()
                   if n.startswith(exp.version_keep)
                   and after["version"].get(n) != ver]
        if written:
            v.append(_viol("in-place",
                           f"written by the step (_version moved): "
                           f"{written[:6]}"
                           f"{' …' if len(written) > 6 else ''}"))
    # ---- overlap order
    if exp.overlapped:
        n = _overlapped(records)
        if n != exp.overlapped:
            v.append(_viol("overlap-order",
                           f"{n} aggregation(s) issued the exchange, "
                           "launched the local pass and then waited; "
                           f"expected {exp.overlapped}"))
    return v


def _overlapped(records) -> int:
    """Waits preceded, since their exchange's issue, by a K1 launch (the
    local pass in flight)."""
    n, issued, launched = 0, False, False
    for r in records:
        if r.kind == "collective" and r.label in ("all_to_all",
                                                  "isend_irecv",
                                                  "loopback"):
            issued, launched = True, False
        elif r.kind == "launch" and r.label.startswith("K1") and issued:
            launched = True
        elif r.kind == "collective" and r.label == "wait":
            n += issued and launched
            issued = launched = False
    return n
