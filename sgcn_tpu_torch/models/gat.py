"""Partitioned GAT over the tile-SpMM attention pass (port of the a2a
tile-kernel branch of ``sgcn_tpu/models/gat.py``).

Per layer the reference computes ``Z = H·W`` and the scores
``s_ij = z1_i + z2_j`` (``z1 = Z·a1``, ``z2 = Z·a2``), softmaxes each row
over its in-edges and aggregates ``H' = α·Z``.  Two facts reshape the
layer (the reference's ``gat_layer_sym``):

  * the row softmax is shift-invariant, so ``z1``/``a1`` cancel
    (``∂L/∂a1 = 0`` exactly) and ``α_ij = u_j / Σ_{j'∈N(i)} u_j'`` with
    ``u_j = exp(z2_j − C)``: the layer is ``out_i = N_i / D_i`` with
    ``N = P·(u z)`` and ``D = P·u``, two mask-weighted aggregations over
    the combined ``[local; halo]`` edges.  ``C`` is the max of ``z2`` over
    every part's real rows (the reference's ``pmax``);
  * for a symmetric edge pattern the backward of ``N``/``D`` is the same
    pair of aggregations on ``[ḡ/D ‖ −(ḡ·out)/D]``: no scatter.

The aggregations run the tile kernel's int8-mask entry point
(``ops/tile_spmm.py::gat_tiles_pass``, K5) on the table form the reference
ships (``gat_table_form``): one fused ``(fout+1)``-lane pass, or split
feature and scalar passes.  All ``k`` parts are stacked on a leading axis;
each of the reference's per-chip weight-gradient psums is a sum over the
``k`` parts.  Params keep the reference's layout — per layer a dict
``{w (fin, fout), a1 (fout,), a2 (fout,)}`` — so ``params_from_jax``
carries the JAX package's params across unchanged.

Both transports: the dense a2a exchange and the ragged ring
(``comm_schedule='ragged'``: the tables ride ``ops/pspmm.py::
ring_concat`` and the pass reads ``[local ‖ ring concat]``), bit for bit
the same.

One process per part (``mesh``, a ``parallel/mesh.py::RankGroup``; ROADMAP
A2c): each rank holds its slice of the plan and its own ``(1, B, f)``
rows; every table the layer exchanges, forward and backward, rides
``ops/pspmm.py::rank_halo_exchange`` (the rank's pack and collective,
then on the a2a the second pack by the slice's ``halo_src_flat``) in the
same table form on the same wire, and the stabilizer ``C`` is the
all-reduced max (``RankGroup.all_reduce_max``, the reference's ``pmax``),
so a rank's rows equal the stacked layer's bit for bit.  K5 reads a row's
local and halo in-edges in one chain per element, so each pass waits for
its exchange: nothing overlaps the forward's exchange on this path.  On
an asymmetric pattern the backward's transposed passes split as the GCN
backward does on a rank (``GatLayerGen``): the reverse
``all_to_all_single`` is in flight while the local-ᵀ pass runs.

Mixed precision (``compute_dtype='bfloat16'``, the reference's
``--dtype bfloat16``): each layer casts ``w``, ``a2`` and ``h`` to bf16
inside ``GatLayerSym`` (``z = h·w`` in bf16; the scores' ``u`` and the
stabilizer in float32) and returns float32 rows and float32 gradients,
as the reference's custom VJP does.  An even ``fout`` ships the
reference's ``'packed'`` form: ``u·z`` in bf16, bit-paired into
``fout/2`` float32 words, beside ``u`` in float32 — one ``(fout/2 + 1)``
-word table on the wire; an odd ``fout`` keeps the fused or split form
with bf16 tables.  The reference runs its bf16 GAT on the ELL slot pass,
not on its kernel: ``use_pallas_spmm`` carves it out because the kernel
cannot read packed words.  The port unpacks the received words with a
``Tensor.view`` before its kernel — the feature lanes as a bf16 table, the
``u`` lane as a float32 one — so it computes the same function, every
in-edge summed in float32, on the combined-edge tiles it already builds,
through the kernel's bf16 entry point (the order of each row's sum is the
tiles', not the ELL buckets').

``SGCN_PALLAS_SPMM=0`` (``aggregator='ell'``) runs the reference's own
aggregator instead, its slot passes over the combined-edge ELL layout
(``_edge_pass``, ``_mask_slot_pass``, ``_pair_slot_pass``,
``_packed_aggregate``, ``sgcn_tpu/models/gat.py:255-483``) in torch ops:
``GatLayerEll``.  Per table one exchange (``ops/pspmm.py::
gat_exchange_table`` / ``gat_exchange_rows_scalar``, the a2a's two packs or
the ring's one, the halo table the same on both), then per width slot one
gather of the stacked ``[local; halo]`` table, one mask product and one
add, and the hub tail's level-by-level ``index_add_`` chains
(``parallel/plan.py::ell_chain_layout(plan, 'cell')``).  The packed form's
words are unpacked before the mask multiplies.  With one process per part
(``mesh``) the slot passes run over the rank's slice's chains, each table
through the rank's exchange (``rank_halo_exchange`` on the a2a, the
rank's ring scattered by its ``rhalo_dst``), ``cg`` all-reduced to its
max and a transpose's reverse exchange the reverse ``all_to_all_single``:
the stacked layer's row for the part, bit for bit.  The split form's
denominator gathers ``u`` itself, at every table size: the reference's
own branch at ``_ONED_U_ROWS`` = 10⁶ rows a chip and above; below it the
reference gathers a 128-lane broadcast of ``u``, sums the lanes and
scales by 1/128, which rounds in XLA:CPU's order of the 128 adds (a
device for the TPU's tile padding; ROADMAP C12).  On an asymmetric
plan the backward runs the transposed chains of ``'cell_t'`` and the
reverse exchange, as ``ops/pspmm.py::PspmmOverlap`` does for the GCN.

An asymmetric edge pattern (a directed graph; the reference's
``gat_layer_local``, the factored forward with autodiff as its backward)
runs ``GatLayerGen``: the same forward, and the symmetric layer's chain
rules with the aggregation replaced by its transpose
(``_gat_tiles_aggregate_T``: per exchanged table, K5 over the halo rows'
transposed masks into the reverse send buffer, the reverse exchange, and
one fused launch of the local rows' transposed masks plus the owner's sum
of what came back).  a2a only, as in the reference.  Under
``compute_dtype='bfloat16'`` this is the packed table's true gradient;
the reference differentiates through ``_pack_rows``'s bit cast, which
carries none (ROADMAP C5).

``gat_forward_local(collect_stabilizers=True)`` also returns each layer's
softmax stabilizer ``cg``, the one full-graph quantity sub-graph serving
(``serve/subgraph.py``) takes as an input.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.pspmm import (bucketed_slot_reduce, ell_transpose,
                         gat_exchange_rows_scalar, gat_exchange_table,
                         halo_exchange, narrow_dtype,
                         rank_halo_exchange, ring_concat)
from ..ops.tile_spmm import (gat_tiles_pass, k5_launches,
                             pspmm_tiles_transposed, transposed_ranks)
from .activations import get_activation

# plan arrays the tile-kernel GAT forward ships: the reference's
# GAT_PLAN_FIELDS_PALLAS with its exchange arrays replaced by the flat
# sources of the port's row packs (``recv_src`` for send_idx,
# ``halo_src_flat`` for halo_src); ptile_cw ships as int8
GAT_PLAN_FIELDS_PALLAS = ("recv_src", "halo_src_flat", "ptile_csrc",
                          "ptile_cld", "ptile_cw", "row_valid")
# ... and its ragged flavor's (``ring_src`` for rsend_idx): the combined
# tiles' sources re-based to [local ‖ ring concat] (no halo table, no
# rhalo_dst)
GAT_PLAN_FIELDS_PALLAS_RAGGED = ("ring_src", "ptile_crsrc", "ptile_cld",
                                 "ptile_cw", "row_valid")
# ... and on an asymmetric plan the a2a flavor's plus the backward's
# transposed layouts (port only; ``CommPlan.ensure_cell_transpose_tiles``);
# ptile_tchw ships as int8 (K5's masks), the fused entry's families as
# float32 0/1 weights
GAT_PLAN_FIELDS_PALLAS_GEN = GAT_PLAN_FIELDS_PALLAS + (
    "ptile_tclsrc", "ptile_tclld", "ptile_tclw", "ptile_tchsrc",
    "ptile_tchld", "ptile_tchw", "ptile_tc1src", "ptile_tc1ld",
    "ptile_tc1w", "rev_csrc")

# Widest row of the fused one-pass table form.  Structural default
# MEASURED ON THE TPU (v5e: one 128-lane tile; a 129-lane f32 array doubles
# under tile padding) and kept so this port's table forms, kernel launches
# and wire census match the reference's; to be re-measured on the H100
# (ROADMAP).
FUSED_MAX_LANES = 128

_NEG = -1e30


def score_project(z, a2):
    """Per-row attention score ``z2_i = z_i · a2`` as a row-local
    multiply-reduce (the reference's form; every consumer, forward and
    backward, goes through it)."""
    return (z * a2).sum(dim=-1)


def gat_exchange_lane_widths(widths, compute_dtype=None):
    """Per-layer wire width of the GAT attention-table exchange in
    f32-lane equivalents, the reference's lane model: ``fout + 1`` for the
    f32 fused table and the split pair alike; under bf16 compute
    ``fout/2 + 1`` for the packed table (even ``fout``) and
    ``(fout + 1)/2`` for the ``fout + 1`` bf16 lanes of an odd one."""
    bf16 = _is_bf16(compute_dtype)
    out = []
    for fout in widths:
        fout = int(fout)
        if bf16:
            out.append(fout // 2 + 1 if fout % 2 == 0 else (fout + 1) // 2)
        else:
            out.append(fout + 1)
    return out


def _fused_form(fout: int) -> bool:
    """One pass over the ``(fout+1)``-lane table only while it fits
    ``FUSED_MAX_LANES``."""
    return fout + 1 <= FUSED_MAX_LANES


def _is_bf16(dtype) -> bool:
    """Whether a compute dtype (the reference's name, a torch dtype or
    ``None``) is bf16."""
    return dtype in ("bfloat16", torch.bfloat16)


def _widened(x):
    """``x`` in float32 if it is bf16, else as it is (float32, or the
    float64 of the gradient checks): the reference's ``astype(float32)``
    of the layer's scores and backward operands."""
    return x.float() if x.dtype == torch.bfloat16 else x


def gat_table_form(fout: int, compute_dtype=None) -> str:
    """The table form one GAT exchange ships at width ``fout``:
    ``'fused'`` (one ``(·, fout+1)`` table, one kernel pass), ``'split'``
    (feature rows and the scalar ``u`` as two tables, two passes) or,
    under bf16 compute at an even ``fout``, ``'packed'`` (the bit-paired
    ``(·, fout/2 + 1)`` float32 table, two passes).  Both directions ship
    the same form.  ``compute_dtype``: ``None``, ``'bfloat16'`` or a
    torch dtype (the layer's own)."""
    if _is_bf16(compute_dtype) and fout % 2 == 0:
        return "packed"
    return "fused" if _fused_form(fout) else "split"


def _pack_rows(x16):
    """``(..., f)`` bf16 → ``(..., f/2)`` float32 words, bit-pairing
    adjacent lanes (a bit cast, no copy of a contiguous input): the
    reference's ``_pack_rows``."""
    return x16.contiguous().view(torch.float32)


def _unpack_rows(xp):
    """``(..., f/2)`` float32 words → ``(..., f)`` bf16, row-major (the
    inverse of ``_pack_rows``; a strided input is copied to contiguous
    rows first, as the kernel reads row-major tables)."""
    return xp.contiguous().view(torch.bfloat16)


def init_gat_params(generator: torch.Generator, dims, device="cpu"):
    """The reference's init on a ``torch.Generator``: per layer a
    Glorot-normal ``w`` (truncated at two standard deviations, as
    ``jax.nn.initializers.glorot_normal``) and ``a1``/``a2`` drawn
    N(0, 1)/√fout.  Other numbers than ``jax.random`` gives for the same
    seed: parity tests carry the reference's params over with
    ``params_from_jax``."""
    out = []
    for fin, fout in dims:
        # variance 2/(fin+fout) after truncation: the std of a standard
        # normal truncated to [-2, 2] is 0.87962566103423978
        std = math.sqrt(2.0 / (fin + fout)) / 0.87962566103423978
        w = torch.empty((fin, fout), dtype=torch.float32)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        a1 = torch.randn(fout, generator=generator) / math.sqrt(fout)
        a2 = torch.randn(fout, generator=generator) / math.sqrt(fout)
        out.append({"w": w.to(device), "a1": a1.to(device),
                    "a2": a2.to(device)})
    return out


def gat_param_tensors(params, device="cpu"):
    """Per-layer ``{w, a1, a2}`` dicts of numpy arrays (e.g. the JAX
    package's) or tensors → float32 copies on ``device``."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, torch.float32, copy=True)
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return [{name: one(p[name]) for name in ("w", "a1", "a2")}
            for p in params]


def params_from_jax(params, device="cpu"):
    """The JAX package's GAT params (a list of ``{w, a1, a2}`` dicts,
    passed as numpy) → float32 tensors on ``device``, same layout."""
    return gat_param_tensors(params, device)


def edge_softmax(scores, edge_mask, edge_dst, num_rows: int):
    """Numerically stable softmax over the incoming edges of each dst
    row, over a dst-sorted COO edge list (the reference's helper, for
    callers holding plain edge lists; masked edges get 0)."""
    scores = torch.where(edge_mask, scores, torch.full_like(scores, _NEG))
    dst = edge_dst.long()
    row_max = torch.full((num_rows,), -math.inf, dtype=scores.dtype,
                         device=scores.device)
    row_max = row_max.scatter_reduce(0, dst, scores, "amax",
                                     include_self=False)
    row_max = torch.clamp(row_max, min=_NEG)     # empty rows: -inf → _NEG
    ex = torch.where(edge_mask, torch.exp(scores - row_max[dst]),
                     torch.zeros_like(scores))
    denom = torch.zeros(num_rows, dtype=scores.dtype,
                        device=scores.device).index_add(0, dst, ex)
    return ex / (denom[dst] + 1e-9)


def _gat_tiles_aggregate(p, s, form, ex_src, halo_src_flat, csrc, cld, cw,
                         tb, cclasses, rr_sizes=None, mesh=None):
    """Masked Σ over every row's in-edges of ``[p ‖ s]`` — the reference's
    ``_gat_pallas_aggregate``.  ``p``: ``(k, b, fout)``, ``s``: ``(k, b)``.
    ``form='fused'`` exchanges one ``(k, b, fout+1)`` table and runs ONE
    kernel pass whose last lane is the scalar sum; ``'split'`` exchanges
    the feature rows and the scalar separately (the scalar in its own
    ``(k, S)`` buffer) and runs two passes, the second at width 1.  Every
    kernel column is summed on its own in stored edge order, so the two
    forms give the same bits.

    ``form='packed'`` (bf16 compute, even ``fout``): ``p`` is bf16 and
    ``s`` float32; the exchange ships one ``(k, b, fout/2 + 1)`` float32
    table, ``p`` bit-packed beside ``s`` (the reference's
    ``_packed_aggregate`` wire), and the received words unpack to a bf16
    feature table and a float32 scalar table, each ``[local; halo]``,
    for two passes (the bf16 one at width ``fout``, the float32 one at
    width 1).

    ``ex_src`` and ``halo_src_flat`` are the plan's ``recv_src`` and
    ``halo_src_flat`` (``ops/pspmm.py::halo_exchange``: two row packs).
    ``rr_sizes`` given selects the ragged ring: ``ex_src`` is then the
    plan's ``ring_src``, ``halo_src_flat`` is unused and ``csrc`` the
    ring-re-based ``ptile_crsrc``; the pass reads ``[local ‖ ring
    concat]`` (one row pack).  The split form ships ONE ring of ``[p ‖ s]`` (the
    reference's two-lane ring) and cuts it into the two tables with a
    ``cat``, which also makes the kernel's tables row-major.  Same bits as
    the a2a flavor.  ``mesh`` (a ``RankGroup``): one rank's part, every
    table through ``rank_halo_exchange`` (the slice's ``recv_src`` or
    ``ring_src``, its re-based ``halo_src_flat``).  Returns ``(N (k, b,
    fout), D (k, b))``."""
    b, fout = p.shape[1], p.shape[2]
    ragged = rr_sizes is not None
    if mesh is not None:
        def exchange(t):
            return rank_halo_exchange(t, ex_src, halo_src_flat, mesh,
                                      rr_sizes)
    elif ragged:
        def exchange(t):
            return ring_concat(t, ex_src, rr_sizes)
    else:
        def exchange(t):
            return halo_exchange(t, ex_src, halo_src_flat)
    if form == "packed":
        half = fout // 2
        table = torch.cat([_pack_rows(p), s[..., None]], dim=-1)
        halo = exchange(table)
        full_p = torch.cat([p, _unpack_rows(halo[..., :half])], dim=1)
        full_u = torch.cat([s, halo[..., half]], dim=1)
        num = gat_tiles_pass(csrc, cld, cw, full_p, cclasses, tb, b)
        den = gat_tiles_pass(csrc, cld, cw, full_u[..., None], cclasses, tb,
                             b)[..., 0]
        return num, den
    if form == "fused":
        table = torch.cat([p, s[..., None]], dim=-1)
        full = torch.cat([table, exchange(table)], dim=1)  # (k, B+R, fout+1)
        out = gat_tiles_pass(csrc, cld, cw, full, cclasses, tb, b)
        return out[..., :fout], out[..., fout]
    if form != "split":
        raise ValueError(f"the tile GAT pass takes the fused, split and "
                         f"packed table forms, not {form!r}")
    if ragged:
        ring = exchange(torch.cat([p, s[..., None]], dim=-1))
        full_p = torch.cat([p, ring[..., :fout]], dim=1)
        full_u = torch.cat([s, ring[..., fout]], dim=1)
    else:
        full_p = torch.cat([p, exchange(p)], dim=1)
        full_u = torch.cat([s, exchange(s)], dim=1)
    num = gat_tiles_pass(csrc, cld, cw, full_p, cclasses, tb, b)
    den = gat_tiles_pass(csrc, cld, cw, full_u[..., None], cclasses, tb,
                         b)[..., 0]
    return num, den


def _gat_tiles_aggregate_T(p, s, form, tl, th, t1, rev, tlclasses,
                           thclasses, t1classes, tb, mesh=None):
    """The transpose of ``_gat_tiles_aggregate`` for an asymmetric
    pattern: per owned row j, the masked Σ of ``[p ‖ s]`` over every row
    that reads j (``Mᵀ·[p ‖ s]``), from the plan's transposed combined
    layouts (``CommPlan.ensure_cell_transpose_tiles``).  Per exchanged
    table: K5 over the halo rows' transposed masks (``th``, int8) writes
    every part's reverse send buffer (float32 partials at the forward wire
    slots), the reverse exchange ships them back (one row pack), and one
    fused launch sums, per owned row, the local rows' transposed masks
    over the table (``tl``) and the weight-1 chain over what came back
    (``t1``).  ``form='fused'`` ships one ``(fout+1)``-lane table; the
    split and packed forms two, the features and the scalar (the packed
    form's bf16 ``p`` widened exactly to float32: the partials and their
    sums stay float32, as the reference's float32 scatter-adds).  ``mesh``
    (a ``RankGroup``): one rank's part, each table through
    ``ops/tile_spmm.py::transposed_ranks`` — the halo-ᵀ K5 pass, the
    reverse ``all_to_all_single`` of ``rev``'s ``k·S`` slots issued, the
    local-ᵀ pass while it is in flight, the weight-1 pass over what came
    back, one add: the fused launch's arithmetic in two launches.
    Returns ``(N (k, b, fout), D (k, b))`` float32."""
    fout = p.shape[2]
    if form == "fused":
        tables = [torch.cat([p, s[..., None]], dim=-1)]
    elif form in ("split", "packed"):
        tables = [_widened(p), _widened(s)[..., None]]
    else:
        raise ValueError(f"the tile GAT pass takes the fused, split and "
                         f"packed table forms, not {form!r}")
    if mesh is None:
        outs = [pspmm_tiles_transposed(table.contiguous(), tl, th, t1, rev,
                                       tb, tlclasses, thclasses, t1classes)
                for table in tables]
    else:
        outs = [transposed_ranks(table.contiguous(), tl, th, t1,
                                 int(rev.shape[-1]), tb, tlclasses,
                                 thclasses, t1classes, mesh)
                for table in tables]
    if form == "fused":
        return outs[0][..., :fout], outs[0][..., fout]
    return outs[0], outs[1][..., 0]


def _gat_factored_fwd_core(w, a2, h, ex_src, halo_src_flat, csrc, cld, cw,
                           row_valid, tb, cclasses, form=None,
                           rr_sizes=None, mesh=None):
    """The factored layer over stacked parts on the tile kernel
    (``_gat_tiles_aggregate``): returns ``(out, z, u, den, cg)``
    (``_gat_factored_core``).  ``rr_sizes`` selects the ragged ring;
    ``mesh`` one rank's part."""
    if form is None:
        form = gat_table_form(w.shape[-1], w.dtype)
    return _gat_factored_core(
        w, a2, h, row_valid, form,
        lambda p, s: _gat_tiles_aggregate(p, s, form, ex_src, halo_src_flat,
                                          csrc, cld, cw, tb, cclasses,
                                          rr_sizes, mesh), mesh)


def _gat_factored_core(w, a2, h, row_valid, form, aggregate, mesh=None):
    """The factored layer over stacked parts, its two aggregations
    given (``aggregate(p, s) → (N, D)``, ``p = u·z`` in ``z``'s dtype and
    ``s`` the ``u`` the form ships): returns ``(out, z, u, den, cg)``.
    ``cg`` is the max of ``z2`` over every part's real rows (the
    reference's ``pmax``, pad rows excluded), without gradient: ``out`` is
    exactly invariant to it; with ``mesh`` (one rank's part) the max over
    the ranks.  ``w``, ``a2`` and ``h`` in bf16 run the layer in bf16
    (``z`` bf16; ``u``, ``cg``, the sums and ``out`` float32, as in the
    reference)."""
    z = h @ w
    z2 = _widened(score_project(z, a2))
    z2m = torch.where(row_valid > 0, z2.detach(),
                      torch.full_like(z2, -math.inf))
    cg = z2m.max()
    if mesh is not None:
        cg = mesh.all_reduce_max(cg)
    u = torch.exp(z2 - cg)                           # (k, b) in (0, 1]
    # the packed form keeps u in float32 beside the bf16 u·z; the others
    # ship both in z's dtype
    s = u if form == "packed" else u.to(z.dtype)
    num, den = aggregate(u.to(z.dtype)[..., None] * z, s)
    # max(den, tiny): u > 0 on every real edge, so this stays exact until
    # genuine f32 underflow; the reference's guard, kept as it is
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out, z, u, den, cg


class GatLayerSym(torch.autograd.Function):
    """``gat_layer_sym`` with its custom VJP, over stacked parts, for a
    SYMMETRIC edge pattern.  The forward keeps ``(w, a1, a2, h, cg, den,
    out)`` and the plan tensors, not ``z`` or ``u``: the backward
    recomputes ``z = h·w`` and ``u`` from ``cg``, forms ``dn = ḡ/D`` and
    ``dd = −(ḡ·out)/D`` and sends them through the same exchange and the
    same kernel passes as the forward (the transpose of a symmetric
    pattern's aggregation is the aggregation).  ``∂L/∂a1`` is exactly 0;
    the weight gradients sum over the ``k`` parts (the reference's psum).

    ``ex_src`` and ``halo_src_flat`` are the plan's ``recv_src`` and
    ``halo_src_flat``; ``rr_sizes`` given selects the ragged ring in both
    directions (``ex_src`` is then ``ring_src``, ``halo_src_flat`` is
    ``None`` and ``csrc`` is ``ptile_crsrc``).

    ``compute_dtype='bfloat16'`` casts ``w``, ``a2`` and ``h`` to bf16
    inside the layer (the reference's mixed-precision layer): the forward
    runs in bf16 and returns float32 rows; the backward's tables are the
    forward's form (the packed one with the cotangent ``ḡ/D`` rounded to
    bf16 and ``dd`` in float32, ``sgcn_tpu/models/gat.py:659-662``; the
    fused and split ones in float32), its matmuls run in float32 on the
    bf16 values, and the gradients return unrounded in the inputs' own
    dtypes, as the reference's VJP hands float32 cotangents to its casts.

    ``GatLayerSym.backward_launches`` counts the kernel launches the
    backward made (CUDA tensors only).  ``stabilizers``, a list, receives
    the layer's ``cg`` (``gat_forward_local(collect_stabilizers=True)``).
    ``mesh`` (a ``RankGroup``): one rank's part; ``dn``/``dd`` ride the
    same rank exchange, and ``dw``/``da2`` are the rank's share (the
    trainer all-reduces them)."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, w, a1, a2, h, ex_src, halo_src_flat, csrc, cld, cw,
                row_valid, tb, cclasses, form=None, rr_sizes=None,
                compute_dtype=None, stabilizers=None, mesh=None):
        dt = narrow_dtype(compute_dtype, "compute_dtype")
        dtypes = (w.dtype, a2.dtype, h.dtype)
        if dt is not None:
            w, a2, h = w.to(dt), a2.to(dt), h.to(dt)
        if form is None:
            form = gat_table_form(w.shape[1], w.dtype)
        out, _z, _u, den, cg = _gat_factored_fwd_core(
            w, a2, h, ex_src, halo_src_flat, csrc, cld, cw, row_valid, tb,
            cclasses, form, rr_sizes, mesh)
        if stabilizers is not None:
            stabilizers.append(cg)
        ctx.save_for_backward(w, a1, a2, h, cg, den, out, ex_src,
                              halo_src_flat, csrc, cld, cw)
        ctx.static = (tb, cclasses, form, rr_sizes, dtypes, mesh)
        ctx.form, ctx.dtypes = form, dtypes
        return out

    @staticmethod
    def backward(ctx, gbar):
        # ctx.saved_tensors is read once: a non-reentrant checkpoint
        # (the trainer's remat) unpacks each saved tensor once only
        saved = ctx.saved_tensors
        ex_src, halo_src_flat, csrc, cld, cw = saved[7:]
        tb, cclasses, form, rr_sizes, _dtypes, mesh = ctx.static
        before = k5_launches()
        grads = _gat_layer_grads(
            ctx, saved, gbar, lambda dn, dd: _gat_tiles_aggregate(
                dn, dd, form, ex_src, halo_src_flat, csrc, cld, cw, tb,
                cclasses, rr_sizes, mesh))
        GatLayerSym.backward_launches += k5_launches() - before
        return grads + (None,) * 13


def _gat_layer_grads(ctx, saved, gbar, aggregate):
    """The GAT layer's chain rules (``GatLayerSym``'s backward) with the
    aggregation of ``[dn ‖ dd]`` given: ``aggregate(dn, dd)`` returns
    ``(dp, du)`` — the same passes as the forward for a symmetric
    pattern, their transpose otherwise.  ``saved``: the layer's
    ``ctx.saved_tensors``; ``ctx.form`` and ``ctx.dtypes`` the forward's
    table form and its inputs' dtypes.  Returns ``(dw, da1, da2, dh)``."""
    w, a1, a2, h, cg, den, out = saved[:7]
    form, dtypes = ctx.form, ctx.dtypes
    z = h @ w                                    # recomputed
    fin, fout = w.shape
    u = torch.exp(_widened(score_project(z, a2)) - cg)
    dng = torch.clamp(den, min=1e-30)            # the forward's guard
    dn = gbar / dng[..., None]                   # (k, b, fout)
    dd = -(gbar * out).sum(dim=-1) / dng         # (k, b)
    if form == "packed":
        dn = dn.to(torch.bfloat16)
    dp, du_agg = aggregate(dn, dd)
    # p = u·z, u = exp(z2 − C): chain rules (C is constant a.e.), in
    # float32 on bf16 operands under mixed precision
    w, a2, h, z = (_widened(x) for x in (w, a2, h, z))
    dz2 = u * ((dp * z).sum(dim=-1) + du_agg)
    dz_total = u[..., None] * dp + dz2[..., None] * a2
    dh = (dz_total @ w.T).to(dtypes[2]) if ctx.needs_input_grad[3] \
        else None
    dw = (h.reshape(-1, fin).T @ dz_total.reshape(-1, fout)) \
        .to(dtypes[0])
    da2 = (z.reshape(-1, fout).T @ dz2.reshape(-1)).to(dtypes[1])
    return dw, torch.zeros_like(a1), da2, dh


class GatLayerGen(torch.autograd.Function):
    """``gat_layer_local`` over stacked parts (or one rank's part:
    ``mesh``), for an ASYMMETRIC edge pattern: ``GatLayerSym``'s forward
    (the factored ``_gat_factored_fwd_core``, a2a) and its chain rules,
    with the
    aggregation of ``[ḡ/D ‖ −(ḡ·out)/D]`` replaced by its transpose
    (``_gat_tiles_aggregate_T`` on the plan's transposed combined
    layouts, ``transposed = (tl, th, t1, rev_csrc, tlclasses, thclasses,
    t1classes)``).  The reference lets autodiff transpose its forward
    (scatter-adds); this is the same gradient as a chain of gathers in
    stored order, with no float atomics.  Under ``compute_dtype=
    'bfloat16'`` the packed form's gradient is the true one (the
    reference's differentiates through a bit cast and drops the feature
    lanes' share: ROADMAP C5).

    ``GatLayerGen.backward_launches`` counts the K5 launches the backward
    made (CUDA tensors only); its fused launches count in
    ``spmm_tiles_fused.launches``."""

    backward_launches = 0

    @staticmethod
    def forward(ctx, w, a1, a2, h, ex_src, halo_src_flat, csrc, cld, cw,
                row_valid, tb, cclasses, transposed, form=None,
                compute_dtype=None, stabilizers=None, mesh=None):
        ctx.transposed = transposed
        return GatLayerSym.forward(ctx, w, a1, a2, h, ex_src, halo_src_flat,
                                   csrc, cld, cw, row_valid, tb, cclasses,
                                   form, None, compute_dtype, stabilizers,
                                   mesh)

    @staticmethod
    def backward(ctx, gbar):
        tb, form, mesh = ctx.static[0], ctx.static[2], ctx.static[5]
        before = k5_launches()
        grads = _gat_layer_grads(
            ctx, ctx.saved_tensors, gbar,
            lambda dn, dd: _gat_tiles_aggregate_T(dn, dd, form,
                                                  *ctx.transposed, tb, mesh))
        GatLayerGen.backward_launches += k5_launches() - before
        return grads + (None,) * 13


# ------------------------------------------------- the ELL slot passes
# The reference's default GAT aggregator (``SGCN_PALLAS_SPMM=0``): masked
# sums over the combined-edge bucketed layout, one gather of the stacked
# ``[local; halo]`` table per width slot.  ``pa``: the shipped
# ``ell_chain_layout(plan, 'cell')`` arrays (``cell_src``, ``cell_m``,
# ``chub_*``) and the exchange's; ``static``: ``choose_ell_dispatch``'s
# kwargs (``ell_buckets`` the plan's ``cell_buckets``, ``ell_levels``,
# ``halo_r``, ``rr_sizes`` on the ring, ``mesh`` on a rank).  Not
# carried: the reference's
# chunked tail scan (``SGCN_GAT_TAIL_CHUNK``, past 256 MiB of tail temps)
# and its slot scan under ``_GAT_SCAN_LIVE``: XLA memory budgets that
# only reorder the sums (ROADMAP C10).

def _edge_pass(pa, static, k, b, contrib):
    """Masked Σ over every row's combined in-edges (port of
    ``_edge_pass``): ``bucketed_slot_reduce`` over ``cell_src`` /
    ``cell_m`` (each bucket's sum from its first slot's product, the
    others added in slot order), then the hub tail's chains from +0
    (``chub_*``, level by level), added after the buckets.  ``contrib(src,
    m)`` returns a tuple of float ``(n, ...)`` products; returns the
    tuple of ``(k, b, ...)`` sums."""
    outs = bucketed_slot_reduce(pa["cell_src"], pa["cell_m"],
                                static["ell_buckets"], contrib, k)
    res = []
    for per_bucket in zip(*outs):
        views = [o.view(k, -1, *o.shape[1:]) for o in per_bucket]
        res.append(views[0] if len(views) == 1 else torch.cat(views, dim=1))
    levels = static["ell_levels"]["chub"]
    if not levels:
        return tuple(res)
    tails = [r.new_zeros((k * b, *r.shape[2:])) for r in res]
    off = 0
    for n in levels:
        seg = slice(off, off + n)
        dst = pa["chub_dst"][seg]
        for t, v in zip(tails, contrib(pa["chub_src"][seg],
                                       pa["chub_w"][seg])):
            t.index_add_(0, dst, v)
        off += n
    return tuple(r + t.view_as(r) for r, t in zip(res, tails))


def _full_rows(table, halo):
    """The stacked ``[local; halo]`` table as the ``(k·(B + R), d)`` rows
    ``cell_src`` names."""
    full = torch.cat([table, halo], dim=1)
    return full.reshape(-1, *full.shape[2:])


def _mask_slot_pass(p, s, pa, static):
    """The fused form (port of ``_mask_slot_pass``): one ``(fout + 1)``
    -lane ``[p ‖ s]`` table exchanged, one gather a slot, both parts of
    the gathered row widened to float32 and multiplied by the mask.
    Returns ``(N (k, b, fout), D (k, b))``."""
    k, b, fout = p.shape
    table = torch.cat([p, s[..., None]], dim=-1)
    full = _full_rows(table, gat_exchange_table(
        table, pa, static.get("rr_sizes"), static["halo_r"],
        static.get("mesh")))

    def contrib(src, m):
        g = _widened(full.index_select(0, src))
        return g[:, :fout] * m[:, None], g[:, fout] * m
    return _edge_pass(pa, static, k, b, contrib)


def _pair_slot_pass(p, s, pa, static):
    """The split form (port of ``_pair_slot_pass``): the feature rows and
    ``u`` exchanged apart (``gat_exchange_rows_scalar``), then two edge
    passes, the features' and ``u``'s.  The denominator gathers ``u``
    itself (the reference's branch at ``_ONED_U_ROWS`` rows and above),
    not a 128-lane broadcast of it: one semantics at every size.
    Returns ``(N (k, b, fout), D (k, b))``."""
    k, b, _fout = p.shape
    full_p, full_u = gat_exchange_rows_scalar(
        p, s, pa, static.get("rr_sizes"), static["halo_r"],
        static.get("mesh"))
    fp, fu = full_p.reshape(-1, full_p.shape[-1]), full_u.reshape(-1)
    (num,) = _edge_pass(pa, static, k, b, lambda src, m: (
        _widened(fp.index_select(0, src)) * m[:, None],))
    (den,) = _edge_pass(pa, static, k, b, lambda src, m: (
        _widened(fu.index_select(0, src)) * m,))
    return num, den


def _packed_aggregate(p16, s, pa, static):
    """The packed bf16 form (port of ``_packed_aggregate``): ``p16``
    bit-paired into ``fout/2`` float32 words beside the float32 ``s``,
    one ``(fout/2 + 1)``-word table exchanged and gathered once a slot;
    the words are copied, never computed on, until the gathered row is
    unpacked to bf16 and widened, and only then masked.  Returns ``(N
    (k, b, fout), D (k, b))`` float32."""
    k, b, fout = p16.shape
    half = fout // 2
    table = torch.cat([_pack_rows(p16), s[..., None]], dim=-1)
    full = _full_rows(table, gat_exchange_table(
        table, pa, static.get("rr_sizes"), static["halo_r"],
        static.get("mesh")))

    def contrib(src, m):
        g = full.index_select(0, src)
        return (_unpack_rows(g[:, :half]).float() * m[:, None],
                g[:, half] * m)
    return _edge_pass(pa, static, k, b, contrib)


_ELL_PASSES = {"fused": _mask_slot_pass, "split": _pair_slot_pass,
               "packed": _packed_aggregate}


def _gat_ell_aggregate(p, s, form, pa, static):
    """Masked Σ over every row's in-edges of ``[p ‖ s]`` on the slot
    passes of the table form ``form``."""
    return _ELL_PASSES[form](p, s, pa, static)


def _gat_ell_aggregate_T(p, s, form, pa, static):
    """The transpose of ``_gat_ell_aggregate`` for an asymmetric pattern:
    per table (one ``(fout + 1)``-lane table for the fused form, the
    features and the scalar for the split and packed ones, the packed
    form's bf16 ``p`` widened exactly to float32) the transposed chains
    of ``'cell_t'`` in stored edge order, the halo sources' sums home
    through the reverse exchange (``ops/pspmm.py::ell_transpose``; on a
    rank the reverse ``all_to_all_single``).  Returns ``(N (k, b, fout),
    D (k, b))``."""
    fout = p.shape[2]
    levels, mesh = static["ell_levels"], static.get("mesh")
    if form == "fused":
        out = ell_transpose(torch.cat([p, s[..., None]], dim=-1), pa,
                            levels, "cl_t", "ch_t", mesh=mesh)
        return out[..., :fout], out[..., fout]
    num = ell_transpose(_widened(p), pa, levels, "cl_t", "ch_t", mesh=mesh)
    den = ell_transpose(_widened(s)[..., None], pa, levels, "cl_t", "ch_t",
                        mesh=mesh)
    return num, den[..., 0]


class GatLayerEll(torch.autograd.Function):
    """The GAT layer on the reference's slot passes
    (``SGCN_PALLAS_SPMM=0``): ``GatLayerSym``'s factored forward and
    chain rules with the aggregation of ``_gat_ell_aggregate`` (either
    transport, ``static['rr_sizes']`` selecting the ring).  The backward
    of a symmetric pattern (``ell_layout='cell'``) is the same passes over
    ``[ḡ/D ‖ −(ḡ·out)/D]``, exchanged on the same wire; of an asymmetric
    one (``'cell_t'``, a2a) their transpose (``_gat_ell_aggregate_T``), a
    chain of gathers and level-by-level adds in stored edge order, never
    autograd's transpose of ``index_select`` (float atomics on the card).
    ``compute_dtype='bfloat16'`` as ``GatLayerSym``'s; the packed form's
    gradient is the true one on either pattern (ROADMAP C5).
    ``static['mesh']`` (a ``RankGroup``): one rank's part, ``cg`` the
    all-reduced max; under ``remat`` the backward's re-run of the forward
    all-reduces again, in the same order on every rank."""

    @staticmethod
    def forward(ctx, w, a1, a2, h, pa, static, compute_dtype=None,
                stabilizers=None):
        dt = narrow_dtype(compute_dtype, "compute_dtype")
        dtypes = (w.dtype, a2.dtype, h.dtype)
        if dt is not None:
            w, a2, h = w.to(dt), a2.to(dt), h.to(dt)
        form = gat_table_form(w.shape[1], w.dtype)
        out, _z, _u, den, cg = _gat_factored_core(
            w, a2, h, pa["row_valid"], form,
            lambda p, s: _gat_ell_aggregate(p, s, form, pa, static),
            static.get("mesh"))
        if stabilizers is not None:
            stabilizers.append(cg)
        ctx.save_for_backward(w, a1, a2, h, cg, den, out)
        ctx.pa, ctx.static, ctx.form, ctx.dtypes = pa, static, form, dtypes
        return out

    @staticmethod
    def backward(ctx, gbar):
        agg = (_gat_ell_aggregate_T if ctx.static["ell_layout"] == "cell_t"
               else _gat_ell_aggregate)
        grads = _gat_layer_grads(
            ctx, ctx.saved_tensors, gbar.contiguous(),
            lambda dn, dd: agg(dn, dd, ctx.form, ctx.pa, ctx.static))
        return grads + (None,) * 4


def gat_forward_local(
    params,
    h,                              # (k, B, f_in) stacked local rows
    pa,                             # plan tensors (GAT_PLAN_FIELDS_PALLAS,
                                    # or GAT_PLAN_FIELDS_PALLAS_RAGGED)
    activation: str = "none",
    final_activation: str = "none",
    symmetric: bool = True,         # the custom backward needs Â's pattern
                                    # symmetric
    pallas_tb: int = 256,           # static tile height
    pallas_cclasses: tuple = (),    # static combined tile classes
    comm_schedule: str = "a2a",     # static: 'a2a' or 'ragged' (the ring)
    rr_sizes: tuple | None = None,  # static plan.rr_sizes (ragged)
    compute_dtype: str | None = None,  # 'bfloat16': every layer in bf16
    pallas_tclclasses: tuple = (),  # static transposed combined classes
    pallas_tchclasses: tuple = (),  # (asymmetric)
    pallas_tc1classes: tuple = (),
    collect_stabilizers: bool = False,  # also return the per-layer cg
    remat: bool = False,            # recompute each layer in the backward
    mesh=None,                      # a RankGroup: one process per part
    aggregator: str = "tile",       # static: 'tile' or 'ell'
                                    # (SGCN_PALLAS_SPMM=0)
    ell_layout: str | None = None,  # static ELL chain layout ('cell',
                                    # 'cell_t')
    ell_buckets: tuple | None = None,  # static plan.cell_buckets
    ell_levels: dict | None = None,  # static chain level sizes
    halo_r: int | None = None,      # static plan.r (the halo table)
):
    """Stacked forward: L × (``GatLayerSym`` → activation) →
    ``(k, B, nout)`` float32.  The reference stacks bare PGAT layers (no
    inter-layer activation by default).  Under ``comm_schedule='ragged'``
    both directions of every layer ride the ring, bit-identical to the
    a2a flavor.  ``compute_dtype='bfloat16'`` runs every layer in bf16
    (``GatLayerSym``), each on its float32 input cast to bf16 — the
    reference's cast of ``h`` between layers.  ``symmetric=False`` (an
    asymmetric pattern, the reference's ``gat_layer_local``) runs every
    layer as ``GatLayerGen`` on ``GAT_PLAN_FIELDS_PALLAS_GEN``, a2a only.
    ``collect_stabilizers=True`` returns ``(out, cgs)``: ``cgs`` the
    ``(L,)`` float32 softmax stabilizers the layers used (each the max of
    ``z2`` over every part's real rows).  ``remat=True`` (with autograd
    recording) checkpoints each layer as ``gcn_forward_local`` does: the
    backward re-runs each layer's exchanges (on ranks, its collectives,
    in the same order on every rank).  ``mesh`` (a ``RankGroup``): one
    process per part, ``h`` the rank's ``(1, B, f)`` rows and ``pa`` its
    slice's tensors, on either pattern (an asymmetric one on the a2a,
    its backward's reverse exchange an ``all_to_all_single``); the same
    bits as the stacked forward's row for that part.

    ``aggregator='ell'`` (``SGCN_PALLAS_SPMM=0``; ``ops/pspmm.py::
    choose_ell_dispatch`` gives the ``ell_*`` statics and ``halo_r``) runs
    every layer as ``GatLayerEll``, the reference's slot passes, on
    ``ELL_GAT_PLAN_FIELDS`` (``_RAGGED`` on the ring, ``_GEN`` on an
    asymmetric plan), stacked or on a rank group (``mesh``: the rank's
    slice's chains)."""
    if not symmetric and comm_schedule != "a2a":
        raise ValueError(
            "comm_schedule='ragged' uses the symmetric custom backward (the "
            "gradient table rides the same ring); asymmetric plans run the "
            "a2a schedule")
    if aggregator == "ell":
        if comm_schedule == "ragged" and rr_sizes is None:
            raise ValueError("the ragged GAT forward needs the plan's "
                             "static rr_sizes (CommPlan.ensure_ragged)")
        static = {"ell_layout": ell_layout, "ell_buckets": ell_buckets,
                  "ell_levels": ell_levels, "halo_r": halo_r,
                  "rr_sizes": rr_sizes if comm_schedule == "ragged"
                  else None, "mesh": mesh}
        ex = None
    elif aggregator != "tile":
        raise ValueError(f"unknown aggregator {aggregator!r} (know 'tile', "
                         "'ell')")
    elif comm_schedule == "ragged":
        if rr_sizes is None:
            raise ValueError("the ragged GAT forward needs the plan's "
                             "static rr_sizes (CommPlan.ensure_ragged)")
        ex = (pa["ring_src"], None, pa["ptile_crsrc"])
    elif comm_schedule == "a2a":
        ex = (pa["recv_src"], pa["halo_src_flat"], pa["ptile_csrc"])
        rr_sizes = None
    else:
        raise ValueError(f"unknown comm_schedule {comm_schedule!r} (the "
                         "trainer resolves 'auto' before the forward)")
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)
    if not symmetric and ex is not None:
        transposed = (
            tuple(pa[f"ptile_tcl{x}"] for x in ("src", "ld", "w")),
            tuple(pa[f"ptile_tch{x}"] for x in ("src", "ld", "w")),
            tuple(pa[f"ptile_tc1{x}"] for x in ("src", "ld", "w")),
            pa["rev_csrc"], pallas_tclclasses, pallas_tchclasses,
            pallas_tc1classes)
    cgs = [] if collect_stabilizers else None

    def layer(h, w, a1, a2, last):
        if ex is None:
            h = GatLayerEll.apply(w, a1, a2, h, pa, static, compute_dtype,
                                  cgs)
            return fact(h) if last else act(h)
        plan_args = (w, a1, a2, h, *ex, pa["ptile_cld"], pa["ptile_cw"],
                     pa["row_valid"], pallas_tb, pallas_cclasses)
        if symmetric:
            h = GatLayerSym.apply(*plan_args, None, rr_sizes, compute_dtype,
                                  cgs, mesh)
        else:
            h = GatLayerGen.apply(*plan_args, transposed, None,
                                  compute_dtype, cgs, mesh)
        return fact(h) if last else act(h)

    # a recompute would append its stabilizer again: no remat with cgs
    remat = remat and torch.is_grad_enabled() and cgs is None
    for i, p in enumerate(params):
        args = (h, p["w"], p["a1"], p["a2"], i == nl - 1)
        h = (checkpoint(layer, *args, use_reentrant=False) if remat
             else layer(*args))
    if collect_stabilizers:
        return h, torch.stack(cgs).float()
    return h


class GAT(nn.Module):
    """The GAT as a module: per layer ``w``, ``a1`` and ``a2`` as
    trainable parameters (from numpy arrays or tensors, copied), the
    plan's static tile structure as attributes, ``forward(h, pa)`` over
    stacked parts."""

    def __init__(self, params, activation: str = "none",
                 final_activation: str = "none", fwd_static=None):
        super().__init__()
        tensors = gat_param_tensors(params)
        self.w, self.a1, self.a2 = (
            nn.ParameterList(nn.Parameter(p[name]) for p in tensors)
            for name in ("w", "a1", "a2"))
        self.activation = activation
        self.final_activation = final_activation
        self.fwd_static = dict(fwd_static or {})
        self.remat = False            # checkpoint each layer (the trainer's)

    def layer_params(self) -> list:
        """Per layer ``{w, a1, a2}`` (the live parameters)."""
        return [{"w": w, "a1": a1, "a2": a2}
                for w, a1, a2 in zip(self.w, self.a1, self.a2)]

    def forward(self, h, pa):
        return gat_forward_local(
            self.layer_params(), h, pa, activation=self.activation,
            final_activation=self.final_activation, remat=self.remat,
            **self.fwd_static)
