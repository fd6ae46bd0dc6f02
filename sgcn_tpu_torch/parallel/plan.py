"""Communication plan: partition vector → static all_to_all layout.

Port of the subset of ``sgcn_tpu/parallel/plan.py`` the GCN serving
forward and the exact full-batch trainer read.  Same construction, same
arrays, so every field and static tuple equals the reference's array for
array (``tests/test_torch_plan.py``):

  * vertices are relabeled so part ``p`` owns local slots ``0..B-1``
    (``B`` = max part size; rows within a part ranked descending by local
    in-degree, global id breaking ties, under ``row_order='degree'``);
  * ``send_idx[p, q, s]`` — the ``S`` local rows part ``p`` ships to part
    ``q`` (padded with 0; ``send_counts[p, q]`` masks the tail);
  * ``halo_src[p, r]`` gathers part ``p``'s ``R`` halo rows out of the
    received ``(k*S, f)`` buffer, in (owner, vertex-id) order;
  * the local adjacency block becomes padded dst-sorted edge lists
    ``(dst, src, w)`` with ``src`` indexing ``[local rows; halo rows]``,
    split by source locality into the local-src (``ledge_*``) and
    halo-src (``hedge_*``) families;
  * ``ensure_pallas_tiles`` regroups both families into ``tb``-row tiles
    binned into degree-aligned classes — the layout the tile SpMM kernel
    (``ops/tile_spmm.py``) consumes.  The field names keep the
    reference's ``ptile_*``/``pallas_*`` so the two plans compare by name;
  * ``ensure_cell`` lays the combined ``[local; halo]``-sourced edge list
    out as bucketed ELL plus a hub tail (``cell_*``/``ctail_*``), and
    ``ensure_pallas_cell_tiles`` regroups it into tiles with 0/1 mask
    weights (``ptile_c*``) — the GAT attention passes' layout;
  * ``ensure_ragged`` lays the exchange out as the ragged ring: round ``d``
    carries part ``p`` → ``(p+d) mod k`` in a buffer sized to that round's
    own largest send list (``rr_sizes``, ``rsend_idx``, ``rhalo_dst``), and
    ``ensure_pallas_ragged_tiles``/``ensure_pallas_cell_ragged_tiles``
    re-base the halo tile sources to positions in the ring's round-major
    receive concat (``ptile_hrsrc``/``ptile_crsrc``);
  * ``resolve_comm_schedule`` picks the transport (``a2a``, ``ragged`` or
    ``auto``) by the reference's rules, exact and stale;
  * port-only arrays, which the reference has no counterpart of, lay the
    exchange out for one row gather over the stacked parts
    (``ops/pspmm.py``): ``ensure_exchange`` builds the a2a receive
    layout's flat sources (``recv_src``, ``halo_src_flat``),
    ``ensure_ragged`` the ring concat's (``ring_src``), and
    ``ensure_pallas_tiles`` re-bases the halo tiles to positions in the
    a2a receive buffer (``ptile_hwsrc``), so they read it in place;
  * for an asymmetric Â (a directed graph), the transposed layouts the
    backward aggregation runs on (port only; the reference lets autodiff
    transpose its gathers into scatter-adds): ``ensure_transpose_tiles``
    builds, for GCN, the local rows' ``Â_localᵀ`` tiles (``ptile_tl*``),
    the halo rows' ``Â_haloᵀ`` tiles whose destinations are the forward's
    wire slots (``ptile_th*``: the launch writes each part's reverse send
    buffer), the reverse exchange's flat sources (``rev_src``) and the
    weight-1 tiles that sum, for each owned row, the partials the other
    parts sent back (``ptile_t1*``); ``ensure_cell_transpose_tiles`` the
    same over the combined-edge 0/1 masks for GAT (``ptile_tc*``,
    ``rev_csrc``).

``stale_carry_shapes`` gives the stale-halo mode's carries in the
reference's layout (the checkpoint's).  ``ensure_replicas`` builds the
hot-halo replica layout of the reference (``replica_scores``' λ·degree
selection, the shrunken ``nrep_*`` exchange of both transports, the
partial refresh's side channel), ``choose_replica_budget`` its ``auto``
budget and ``replica_carry_shapes`` its carries; ``ensure_replicas`` also
builds the port-only lists the trainer packs by: each kept receive
slot's source and destination (``keep_*``) and each replica slot's
position (``rep_*_dst``, ``rep_src_flat``, ``rep_base_flat``,
``rep_table_pos``).  The mini-batch trainer's shared envelope:
``pad_comm_plan`` re-pads a batch plan to it, ``shared_ell_buckets``
gives the buckets every batch plan shares, and ``ensure_cell`` /
``ensure_ragged`` take a forced combined layout and forced round sizes.
``ensure_ragged`` also splits the halo-src edges per arrival round
(``rr_edge_sizes``, ``redge_*``), which the ELL ring aggregator folds, and
``ensure_ell_chains`` lays the ELL aggregators' sums out as serial chains
over the stacked parts, or over one part's slice (port only:
``ell_chain_layout``).
Everything here is offline numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

# ``comm_schedule='auto'`` picks the ragged ring only when the dense a2a's
# padding efficiency (Σ send_counts / (k²·S)) falls below this.  A
# structural default MEASURED ON THE TPU, where it prices k−1 ppermutes
# against one all_to_all; kept so the port resolves ``auto`` as the
# reference does, and no H100 fact: on an H100 it picks the slower
# transport for the flagship GCN and for cora 8-hp (PERF.md; ROADMAP
# A16 replaces it).
RAGGED_AUTO_EFFICIENCY = 0.5

# The reference's contract tuples of the replica modes' shipped plan
# arrays (``sgcn_tpu/parallel/plan.py:101-150``), kept under its names:
# the pure replica step (a2a and ring), the composed replica × stale step
# and the partial refresh.  The port's trainer ships the tile layout and
# the port-only lists of ``REPLICA_TILE_FIELDS`` instead
# (``train/fullbatch.py``).
REPLICA_PLAN_FIELDS = (
    "send_idx", "halo_src",
    "nrep_send_idx", "nrep_halo_src", "rep_slots",
    "ell_idx", "ell_w", "ltail_dst", "ltail_src", "ltail_w",
    "hedge_dst", "hedge_src", "hedge_w",
)
REPLICA_PLAN_FIELDS_RAGGED = (
    "rsend_idx", "nrep_rsend_idx", "nrep_rhalo_dst", "rep_slots",
    "rep_ring_pos",
    "ell_idx", "ell_w", "ltail_dst", "ltail_src", "ltail_w",
    "hedge_dst", "hedge_src", "hedge_w",
    "redge_dst", "redge_src", "redge_w",
)
REPLICA_STALE_PLAN_FIELDS = REPLICA_PLAN_FIELDS
REPLICA_STALE_PLAN_FIELDS_RAGGED = (
    "rsend_idx", "nrep_rsend_idx", "nrep_ring_dst",
    "ell_idx", "ell_w", "ltail_dst", "ltail_src", "ltail_w",
    "redge_dst", "redge_src", "redge_w",
)
REPLICA_PARTIAL_PLAN_FIELDS = REPLICA_PLAN_FIELDS + (
    "rep_rows", "rep_row_counts",
    "ronly_send_idx", "ronly_send_counts", "ronly_base_pos",
    "rep_recv_src",
)
# the port-only lists a replica step packs by, per transport, and the
# partial refresh's (``CommPlan.ensure_replicas``)
REPLICA_TILE_FIELDS = ("keep_recv_src", "keep_recv_dst", "rep_recv_dst")
REPLICA_TILE_FIELDS_RAGGED = ("keep_ring_src", "keep_ring_dst",
                              "rep_ring_dst")
REPLICA_PARTIAL_TILE_FIELDS = ("rep_rows_flat", "rep_row_valid",
                               "rep_base_flat", "rep_src_flat")
# ... and what one rank of a rank group reads instead (its slice's): the
# shrunken send list it packs, where each row of its shrunken receive goes
# in the carried layout, and the partial refresh's side-channel lists
REPLICA_RANK_FIELDS = ("nrep_send_idx", "keep_nrecv_src", "keep_recv_dst",
                       "rep_recv_dst")
REPLICA_RANK_FIELDS_RAGGED = ("nrep_rsend_idx", "keep_nring_src",
                              "keep_ring_dst", "rep_ring_dst")
REPLICA_PARTIAL_RANK_FIELDS = ("rep_rows_flat", "rep_row_valid",
                               "ronly_base_pos", "ronly_send_counts",
                               "rep_recv_src")

# Every CommPlan array field stacked per part along a leading ``k`` axis:
# the explicit classification anything slicing a plan per part reads
# (``parallel/proxy.py::shard_proxy_plan``, the rank runtime), never a
# ``shape[0] == k`` coincidence.  The reference's members first, under its
# name; then the port-only per-part layouts (tile sources re-based into
# the part's own receive buffer, the transposed families, a mask, the
# ring's per-round edge counts).  Lazy layouts are listed too and skipped
# while ``None``.
PER_CHIP_ARRAY_FIELDS = (
    "part_sizes",
    "send_idx", "send_counts", "halo_src", "halo_counts",
    "edge_dst", "edge_src", "edge_w", "nnz", "row_valid",
    "ledge_dst", "ledge_src", "ledge_w",
    "hedge_dst", "hedge_src", "hedge_w", "lnnz", "hnnz",
    "ell_idx", "ell_w", "ltail_dst", "ltail_src", "ltail_w", "ltail_nnz",
    "cell_idx", "cell_w", "ctail_dst", "ctail_src", "ctail_w", "ctail_nnz",
    "ptile_lsrc", "ptile_lld", "ptile_lw",
    "ptile_hsrc", "ptile_hld", "ptile_hw", "ptile_hrsrc",
    "ptile_csrc", "ptile_cld", "ptile_cw", "ptile_crsrc",
    "rsend_idx", "rhalo_dst", "redge_dst", "redge_src", "redge_w",
    "nrep_send_idx", "nrep_send_counts", "nrep_halo_src",
    "rep_slots", "rep_counts", "nrep_rsend_idx", "nrep_rhalo_dst",
    "rep_ring_pos", "nrep_ring_dst",
    "rep_rows", "rep_row_counts", "ronly_send_idx", "ronly_send_counts",
    "ronly_base_pos", "rep_recv_src",
    # port only
    "ptile_hwsrc",
    "ptile_tlsrc", "ptile_tlld", "ptile_tlw",
    "ptile_thsrc", "ptile_thld", "ptile_thw",
    "ptile_t1src", "ptile_t1ld", "ptile_t1w",
    "ptile_tclsrc", "ptile_tclld", "ptile_tclw",
    "ptile_tchsrc", "ptile_tchld", "ptile_tchw",
    "ptile_tc1src", "ptile_tc1ld", "ptile_tc1w",
    "rep_row_valid", "redge_nnz",
)

# Global-vertex-indexed arrays (plus a slice's part-identity record): a
# per-part slice passes them through untouched.
_GLOBAL_ARRAY_FIELDS = ("owner", "local_idx", "chip_ids")

# Port-only flat indices over the STACKED layout (``part·rows + row``, or
# lists over every part's slots): a slice of part ``c`` re-bases each by
# its rule (``parallel/proxy.py::REBASE``).  The slice's exchange is a
# loopback, the reference proxy's "halo contents are the chip's own sent
# rows": receive slot ``q·S + t`` holds ``h_c[send_idx[c, q, t]]``.
REBASED_ARRAY_FIELDS = (
    "recv_src",        # q·S + t ↦ send_idx[c, q, t] (the loopback)
    "halo_src_flat",   # q·k·S + halo_src[q, r] ↦ halo_src[c, r]
    "ring_src",        # ((q−d) mod k)·B + rsend_idx[...] ↦ rsend_idx[c]
    "rev_src",         # q·rows + p·S + t ↦ q·S + t (the loopback's
    "rev_csrc",        #   transpose: the own partial goes back in place)
    "keep_recv_src",   # part c's kept a2a slots: the shrunken loopback
    #                    row there, nrep_send_idx[c] at keep_nrecv_src
    "keep_recv_dst",   # q·k·S + j with q = c ↦ j
    "keep_ring_src",   # part c's kept ring slots: nrep_rsend_idx[c] at
    #                    keep_nring_src (the shrunken ring's loopback)
    "keep_ring_dst",   # q·ΣS_d + j with q = c ↦ j
    "rep_recv_dst",    # part c's replica slots, as keep_recv_dst
    "rep_ring_dst",    # ... and as keep_ring_dst
    "rep_src_flat",    # the side channel's loopback: the own row of
    "rep_base_flat",   #   the baseline row ronly_base_pos[c] names at
    #                    rep_recv_src[c, i] (and that baseline row); a
    #                    pad slot there names a row past the part's own
    #                    count, whose increment is 0
    "rep_table_pos",   # q·RP + i with q = c ↦ i
    "rep_rows_flat",   # c·B + rep_rows[c] ↦ rep_rows[c] (0 on a pad)
    "keep_nrecv_src",  # q·k·S' + p·S' + t' with q = c ↦ p·S' + t'
    "keep_nring_src",  # q·ΣS'_d + j' with q = c ↦ j'
)


@dataclass
class CommPlan:
    """Static halo-exchange + local-SpMM plan for one (graph, partvec) pair.

    All per-part arrays are stacked along a leading ``k`` axis.
    """

    n: int                    # global vertex count
    k: int                    # number of parts
    b: int                    # padded local rows per part (max part size)
    s: int                    # padded send-bucket size per (src, dst) pair
    r: int                    # padded halo rows per part
    e: int                    # padded local nnz per part

    # vertex relabeling
    owner: np.ndarray         # (n,) part owning each global vertex
    local_idx: np.ndarray     # (n,) local slot of each vertex on its owner
    part_sizes: np.ndarray    # (k,) true part sizes (<= b)

    # halo exchange layout
    send_idx: np.ndarray      # (k, k, S) int32: local rows p sends to q
    send_counts: np.ndarray   # (k, k) int32: valid prefix of send_idx[p, q]
    halo_src: np.ndarray      # (k, R) int32: flat (q*S + t) recv gather
    halo_counts: np.ndarray   # (k,) int32: valid halo rows per part

    # local sparse block as padded edge lists (sorted by dst)
    edge_dst: np.ndarray      # (k, E) int32 local row in [0, B)
    edge_src: np.ndarray      # (k, E) int32 index into [local; halo]
    edge_w: np.ndarray        # (k, E) float32, 0 on padding
    nnz: np.ndarray           # (k,) true local nnz

    row_valid: np.ndarray     # (k, B) float32 1/0 mask of real rows

    # the same edges split by source locality: ``ledge_src`` indexes local
    # rows [0, B), ``hedge_src`` the halo block [0, R)
    el: int                   # padded local-src nnz per part
    eh: int                   # padded halo-src nnz per part
    ledge_dst: np.ndarray     # (k, EL) int32
    ledge_src: np.ndarray     # (k, EL) int32
    ledge_w: np.ndarray       # (k, EL) float32, 0 on padding
    hedge_dst: np.ndarray     # (k, EH) int32
    hedge_src: np.ndarray     # (k, EH) int32
    hedge_w: np.ndarray       # (k, EH) float32, 0 on padding
    lnnz: np.ndarray          # (k,) true local-src nnz
    hnnz: np.ndarray          # (k,) true halo-src nnz

    # the local-src edges in bucketed width-major ELL layout: bucket j
    # covers the next nb_j rows at width wb_j (``ell_buckets``); its degree
    # histogram also drives the tile classes below
    ell_k: int                # max bucket width (>= 1)
    tl: int                   # padded tail length
    ell_buckets: tuple        # ((nb, wb), ...) static bucket structure
    ell_idx: np.ndarray       # (k, ET) int32 flat local src, 0 on padding
    ell_w: np.ndarray         # (k, ET) float32 flat, 0 on padding
    ltail_dst: np.ndarray     # (k, TL) int32
    ltail_src: np.ndarray     # (k, TL) int32
    ltail_w: np.ndarray       # (k, TL) float32, 0 on padding
    ltail_nnz: np.ndarray     # (k,) true tail nnz
    row_order: str            # 'degree' (bucketed) or 'id'

    # True when the global adjacency is numerically symmetric (Â = Âᵀ)
    symmetric: bool

    # dst-tile layout (lazy, ``ensure_pallas_tiles``): each edge family in
    # tb-row tiles binned into degree-aligned classes, each class padded
    # to its own Emax_c (the max across parts), stored flat per part
    # (class c owns the next T_c·Emax_c slots)
    pallas_tb: int | None = None          # static tile height
    pallas_lclasses: tuple | None = None  # ((T_c, Emax_c), ...) local
    pallas_hclasses: tuple | None = None  # ((T_c, Emax_c), ...) halo
    ptile_lsrc: np.ndarray | None = None  # (k, ΣT_c·Emax_c) int32
    ptile_lld: np.ndarray | None = None   # (k, ΣT_c·Emax_c) int32 local dst
    ptile_lw: np.ndarray | None = None    # (k, ΣT_c·Emax_c) float32
    ptile_hsrc: np.ndarray | None = None  # (k, ΣT_c·Emax_c) int32 halo rank
    ptile_hld: np.ndarray | None = None   # (k, ΣT_c·Emax_c) int32
    ptile_hw: np.ndarray | None = None    # (k, ΣT_c·Emax_c) float32
    ptile_hrsrc: np.ndarray | None = None  # (k, ΣT_c·Emax_c) int32 RING pos
    ptile_hwsrc: np.ndarray | None = None  # (k, ΣT_c·Emax_c) int32 position
    #                                        in the (k·S) a2a receive buffer
    #                                        (port only)

    # combined-edge layout (lazy, ``ensure_cell``; GAT): the full edge
    # list, src in [local; halo], as bucketed ELL over ``cell_buckets``
    # plus the COO tail of hub rows past the width cap
    ctl: int | None = None                 # padded combined-tail length
    cell_buckets: tuple | None = None      # ((nb, wb), ...) static
    cell_idx: np.ndarray | None = None     # (k, CET) int32 flat src
    cell_w: np.ndarray | None = None       # (k, CET) float32, 0 on padding
    ctail_dst: np.ndarray | None = None    # (k, CTL) int32
    ctail_src: np.ndarray | None = None    # (k, CTL) int32
    ctail_w: np.ndarray | None = None      # (k, CTL) float32, 0 on padding
    ctail_nnz: np.ndarray | None = None    # (k,) true combined-tail nnz

    # combined-edge dst tiles (lazy, ``ensure_pallas_cell_tiles``): the
    # same tile classes over ``cell_buckets``, 0/1 MASK weights
    pallas_ctb: int | None = None          # static combined tile height
    pallas_cclasses: tuple | None = None   # ((T_c, Emax_c), ...) combined
    ptile_csrc: np.ndarray | None = None   # (k, ·) int32 src in [0, B+R)
    ptile_cld: np.ndarray | None = None    # (k, ·) int32 local dst
    ptile_cw: np.ndarray | None = None     # (k, ·) float32 0/1 edge mask
    ptile_crsrc: np.ndarray | None = None  # (k, ·) int32 src in [0, B+ΣS_d):
    #                                        halo sources re-based to
    #                                        B + ring position

    # ragged ring layout (lazy, ``ensure_ragged``): round d (1-based)
    # carries part p → (p+d) mod k in a buffer of S_d = max_p
    # send_counts[p, (p+d) mod k] rows; the rounds' slots lie one after
    # another along the trailing axis (round d's start at Σ_{d'<d} S_d')
    rr_sizes: tuple | None = None          # (k-1,) static round sizes S_d
    rsend_idx: np.ndarray | None = None    # (k, ΣS_d) int32 local rows sent
    rhalo_dst: np.ndarray | None = None    # (k, ΣS_d) int32 halo rank per
    #                                        receive slot (r = pad)
    ring_src: np.ndarray | None = None     # (k, ΣS_d) int32 flat stacked
    #                                        row p·B + i of each ring concat
    #                                        slot (port only)
    # the halo-src edges split per arrival round (``ensure_ragged``):
    # round d's edges of part q are those whose source part is (q−d) mod
    # k, src re-based to the round's receive buffer; round d owns the next
    # E_d slots (``rr_edge_sizes``), pads dst B−1, src 0, weight 0
    rr_edge_sizes: tuple | None = None     # (k-1,) static per-round edges
    redge_dst: np.ndarray | None = None    # (k, ΣE_d) int32 local dst row
    redge_src: np.ndarray | None = None    # (k, ΣE_d) int32 round slot
    redge_w: np.ndarray | None = None      # (k, ΣE_d) float32, 0 on pads
    redge_nnz: np.ndarray | None = None    # (k, k-1) int32 true edges per
    #                                        round (port only)

    # a2a receive layout over the stacked parts (lazy, ``ensure_exchange``;
    # port only): recv[q, p·S + t] = h[p, send_idx[p, q, t]]
    recv_src: np.ndarray | None = None     # (k, k·S) int32 flat p·B + i
    halo_src_flat: np.ndarray | None = None  # (k, R) int32 q·k·S +
    #                                          halo_src[q, r]

    # transposed layouts of an asymmetric Â (lazy, ``ensure_transpose_tiles``
    # / ``ensure_cell_transpose_tiles``; port only), each a tile family in
    # the ``ptile_*`` form: ``tl`` the local rows' Âᵀ (dst own row j, src
    # own row i, for every local edge i←j), ``th`` the halo rows' Âᵀ (dst
    # the forward wire slot q·S + t in [0, k·S), src own row i) and ``t1``
    # the weight-1 sum over the reverse wire (dst own row j, src q·S + t
    # for every send_idx[p, q, t] = j); ``tl`` and ``t1`` share their tile
    # classes (the fused entry runs both).  ``tc*`` are GAT's, over the
    # combined-edge 0/1 masks
    pallas_ttb: int | None = None          # static tile height
    pallas_tlclasses: tuple | None = None  # ((T_c, Emax_c), ...) each
    pallas_thclasses: tuple | None = None
    pallas_t1classes: tuple | None = None
    ptile_tlsrc: np.ndarray | None = None  # (k, ·) int32 / int32 / float32
    ptile_tlld: np.ndarray | None = None
    ptile_tlw: np.ndarray | None = None
    ptile_thsrc: np.ndarray | None = None
    ptile_thld: np.ndarray | None = None
    ptile_thw: np.ndarray | None = None
    ptile_t1src: np.ndarray | None = None
    ptile_t1ld: np.ndarray | None = None
    ptile_t1w: np.ndarray | None = None
    rev_src: np.ndarray | None = None      # (k, k·S) int32: rwire[p, q·S +
    #                                        t] = send_rev[q, p·S + t], flat
    #                                        q·rows + p·S + t
    pallas_tctb: int | None = None
    pallas_tclclasses: tuple | None = None
    pallas_tchclasses: tuple | None = None
    pallas_tc1classes: tuple | None = None
    ptile_tclsrc: np.ndarray | None = None
    ptile_tclld: np.ndarray | None = None
    ptile_tclw: np.ndarray | None = None
    ptile_tchsrc: np.ndarray | None = None
    ptile_tchld: np.ndarray | None = None
    ptile_tchw: np.ndarray | None = None
    ptile_tc1src: np.ndarray | None = None
    ptile_tc1ld: np.ndarray | None = None
    ptile_tc1w: np.ndarray | None = None
    rev_csrc: np.ndarray | None = None

    # hot-halo replica layout (lazy, ``ensure_replicas``; the reference's
    # fields and meanings): the top-B boundary rows by λ·degree leave the
    # per-layer wire; ``nrep_*`` is the exchange without them, ``rep_*``
    # where their copies sit on the consumers, ``ronly_*``/``rep_rows``
    # the partial refresh's side channel
    replica_budget: int | None = None     # the budget B ensure_replicas ran at
    rp: int | None = None                 # padded replica slots per part
    replica_rows: int = 0                 # replicated rows (<= B)
    replica_send_saving: int = 0          # Σ λ_v — true rows off the wire
    rep_slots: np.ndarray | None = None   # (k, RP) halo ranks; r = pad
    rep_counts: np.ndarray | None = None  # (k,) true replica slots per part
    nrep_s: int | None = None             # shrunken per-pair bucket pad
    nrep_send_idx: np.ndarray | None = None     # (k, k, S') int32
    nrep_send_counts: np.ndarray | None = None  # (k, k) int32
    nrep_halo_src: np.ndarray | None = None     # (k, R) int32; replica
    #                                             slots point at 0
    nrep_rr_sizes: tuple | None = None          # shrunken round sizes
    nrep_rsend_idx: np.ndarray | None = None    # (k, ΣS'_d) int32
    nrep_rhalo_dst: np.ndarray | None = None    # (k, ΣS'_d) int32; r = pad
    rep_ring_pos: np.ndarray | None = None      # (k, RP) int32 into the full
    #                                             ring concat
    nrep_ring_dst: np.ndarray | None = None     # (k, ΣS'_d) int32 full-ring
    #                                             position per shrunken slot
    #                                             (ΣS_d = pad)
    rs: int | None = None                       # padded owned-replicated rows
    rep_rows: np.ndarray | None = None          # (k, RS) int32 local rows
    rep_row_counts: np.ndarray | None = None    # (k,) int32 true counts
    ronly_s: int | None = None                  # replica-only bucket pad
    ronly_send_idx: np.ndarray | None = None    # (k, k, RS') int32
    ronly_send_counts: np.ndarray | None = None  # (k, k) int32
    ronly_base_pos: np.ndarray | None = None    # (k, k, RS') int32 into
    #                                             rep_rows
    rep_recv_src: np.ndarray | None = None      # (k, RP) int32 o·RS' + pos
    # port only (``ensure_replicas``): the kept (non-replicated) receive
    # slots as flat lists over the stacked parts, real slots only — the
    # source row p·B + send_idx[p, q, t] and the destination in the a2a
    # receive layout q·k·S + p·S + t (``keep_recv_*``) or in the ring
    # concat q·ΣS_d + position (``keep_ring_*``); the replica slots, in
    # (part, rank) order, real only: their destinations (``rep_recv_dst``,
    # ``rep_ring_dst``), owners' rows p·B + i (``rep_src_flat``), rows of
    # the owners' (k·RS) baselines (``rep_base_flat``) and rows of the
    # reference's (k·RP) replica tables (``rep_table_pos``); the owned
    # replicated rows as p·B + rep_rows (``rep_rows_flat``, 0 on a pad)
    # with their 0/1 mask (``rep_row_valid``)
    keep_recv_src: np.ndarray | None = None     # (n_keep,) int32
    keep_recv_dst: np.ndarray | None = None     # (n_keep,) int32
    keep_ring_src: np.ndarray | None = None     # (n_keep,) int32
    keep_ring_dst: np.ndarray | None = None     # (n_keep,) int32
    rep_recv_dst: np.ndarray | None = None      # (n_rep,) int32
    rep_ring_dst: np.ndarray | None = None      # (n_rep,) int32
    rep_src_flat: np.ndarray | None = None      # (n_rep,) int32
    rep_base_flat: np.ndarray | None = None     # (n_rep,) int32
    rep_table_pos: np.ndarray | None = None     # (n_rep,) int32
    rep_rows_flat: np.ndarray | None = None     # (k, rep_base_rows) int32
    rep_row_valid: np.ndarray | None = None     # (k, rep_base_rows) f32
    # port only: where each kept slot arrives in the SHRUNKEN exchange,
    # aligned with ``keep_recv_*`` / ``keep_ring_*`` — its row of the
    # stacked shrunken a2a receive buffers q·k·S' + p·S' + t' (t' its
    # place among the kept rows of p's list to q) or of the shrunken ring
    # concat q·ΣS'_d + j'; a rank packs its shrunken receive into the
    # carried layout by them (``ops/pspmm.py::rank_replica_exchange``)
    keep_nrecv_src: np.ndarray | None = None    # (n_keep,) int32
    keep_nring_src: np.ndarray | None = None    # (n_keep,) int32

    # the part each row of a per-part slice is (``parallel/proxy.py``;
    # ``None`` on a full plan): row 0 of part c's slice self-sends at
    # column c, which the comm counters zero
    chip_ids: np.ndarray | None = None

    # the ELL aggregators' serial-chain layouts (lazy, ``ensure_ell_chains``;
    # port only): flat arrays over the stacked parts and their static
    # level sizes, by name (``ell_chain_layout`` documents each)
    ell_chains: dict | None = None

    def _pallas_family(self, dst, src, w, tb: int, class_tiles):
        """Stack one edge family's per-part tile classes into flat
        ``(k, ΣT_c·Emax_c)`` arrays (per class, Emax_c padded to the max
        across parts) + the static class structure
        (``ops/tile_spmm.py::stack_tile_family``).  Raises if a tile's
        local destinations decrease along its slots (``check_tile_layout``:
        the CUDA kernel finds each row's slots by that order)."""
        from ..ops.tile_spmm import stack_tile_family

        return stack_tile_family([dst[p] for p in range(self.k)],
                                 [src[p] for p in range(self.k)],
                                 [w[p] for p in range(self.k)], self.b, tb,
                                 class_tiles)

    def ensure_pallas_tiles(self, tb: int = 256) -> "CommPlan":
        """Build the dst-tile layout of both edge families on first use:
        ``tb``-row tiles binned into degree-aligned classes
        (``tile_classes_from_buckets`` over ``ell_buckets``).  Pad edges
        carry weight 0 and local dst ``tb-1``."""
        if self.pallas_tb == tb and self.ptile_lsrc is not None:
            return self
        self._full_only("ensure_pallas_tiles()")
        from ..ops.tile_spmm import tile_classes_from_buckets

        class_tiles = tile_classes_from_buckets(self.ell_buckets, self.b, tb)
        (self.ptile_lsrc, self.ptile_lld, self.ptile_lw,
         self.pallas_lclasses) = self._pallas_family(
            self.ledge_dst, self.ledge_src, self.ledge_w, tb, class_tiles)
        (self.ptile_hsrc, self.ptile_hld, self.ptile_hw,
         self.pallas_hclasses) = self._pallas_family(
            self.hedge_dst, self.hedge_src, self.hedge_w, tb, class_tiles)
        # the halo tiles read the a2a receive buffer in place: halo rank →
        # its halo_src position (the same rows in the same slot order)
        self.ptile_hwsrc = np.stack([
            np.asarray(self.halo_src[p])[self.ptile_hsrc[p]]
            for p in range(self.k)]).astype(np.int32)
        self.pallas_tb = tb
        self.ptile_hrsrc = None            # ring re-base follows the layout
        return self

    def ensure_exchange(self) -> "CommPlan":
        """Build the a2a receive layout's flat sources on first use (port
        only): ``recv_src[q, p·S + t] = p·B + send_idx[p, q, t]``, the
        stacked row of ``h`` each receive slot holds, and
        ``halo_src_flat[q, r] = q·k·S + halo_src[q, r]``, each halo row's
        flat position in the stacked ``(k, k·S)`` receive buffers — the
        indices of ``ops/pspmm.py``'s row packs."""
        if self.recv_src is not None:
            return self
        self._full_only("ensure_exchange()")
        k, s, b = self.k, self.s, self.b
        if k * b >= 2 ** 31 or k * k * s >= 2 ** 31:
            raise ValueError(f"stacked exchange of k={k}, B={b}, S={s} "
                             "overflows int32 row indices")
        src = (np.asarray(self.send_idx, np.int64)
               + (np.arange(k, dtype=np.int64) * b)[:, None, None])
        self.recv_src = np.ascontiguousarray(
            src.transpose(1, 0, 2).reshape(k, k * s)).astype(np.int32)
        self.halo_src_flat = (
            np.asarray(self.halo_src, np.int64)
            + (np.arange(k, dtype=np.int64) * k * s)[:, None]).astype(np.int32)
        return self

    def _ring_pos_of_rank(self) -> np.ndarray:
        """(k, R+1) map halo rank → position in the ragged ring's
        round-major receive concat (``rhalo_dst`` inverted; the extra slot
        absorbs the pad rank R)."""
        if self.rhalo_dst is None:
            raise ValueError(
                "ring positions need the ragged layout (ensure_ragged)")
        st = self.rsend_idx.shape[1]
        pos = np.zeros((self.k, self.r + 1), np.int64)
        ar = np.arange(st)
        for p in range(self.k):
            pos[p, self.rhalo_dst[p]] = ar
        return pos

    def ensure_pallas_ragged_tiles(self) -> "CommPlan":
        """Re-base the halo tile sources from halo ranks to ring positions
        (``ptile_hrsrc``): the remote pass reads the ring's round-major
        receive concat in place, with the a2a flavor's tiles and per-tile
        edge order — the ragged == a2a bit-identity.  Needs
        ``ensure_pallas_tiles`` and ``ensure_ragged``."""
        if self.ptile_hrsrc is not None:
            return self
        self._full_only("ensure_pallas_ragged_tiles()")
        if self.ptile_hsrc is None:
            raise ValueError(
                "ragged tiles need the tile layout first "
                "(ensure_pallas_tiles)")
        from ..ops.tile_spmm import check_tile_layout

        # the ring pass reads the a2a halo tiles' destinations as they are
        check_tile_layout(self.ptile_hld, self.pallas_hclasses,
                          self.pallas_tb)
        pos = self._ring_pos_of_rank()
        self.ptile_hrsrc = np.stack([
            pos[p][self.ptile_hsrc[p]] for p in range(self.k)
        ]).astype(np.int32)
        return self

    def ensure_cell(self, buckets: tuple | None = None,
                    ctl: int | None = None,
                    max_buckets: int | None = None) -> "CommPlan":
        """Build the combined-edge bucketed layout on first use (GAT):
        ``_build_ell`` over the whole dst-sorted edge list.  ``buckets`` /
        ``ctl`` force the bucket structure and tail length (the mini-batch
        plans share one), and rebuild a layout built with others;
        ``max_buckets`` caps the bucket count (default 6).  A rebuild
        drops the combined tiles built from the old layout."""
        if (self.cell_buckets is None
                or buckets not in (None, self.cell_buckets)
                or (ctl is not None and ctl != self.ctl)):
            self._full_only("ensure_cell()")
            fields = _cell_fields(_build_ell(
                self.edge_dst, self.edge_src, self.edge_w, self.nnz, self.b,
                row_order=self.row_order, buckets=buckets, tl=ctl,
                max_buckets=6 if max_buckets is None else max_buckets))
            for name, val in fields.items():
                setattr(self, name, val)
            self.ptile_csrc = self.ptile_crsrc = None
            if self.ell_chains is not None:           # built on the old cells
                self.ell_chains.pop("cell", None)
                self.ell_chains.pop("cell_t", None)
        return self

    def ensure_pallas_cell_tiles(self, tb: int = 256) -> "CommPlan":
        """Build the combined-edge dst-tile layout on first use (GAT): the
        ``[local ‖ halo]``-sourced edges in the degree-binned tile classes
        of ``cell_buckets``, with 0/1 MASK weights on ``edge_w != 0`` —
        attention aggregates by edge presence, not Â's values."""
        if self.pallas_ctb == tb and self.ptile_csrc is not None:
            return self
        self._full_only("ensure_pallas_cell_tiles()")
        from ..ops.tile_spmm import tile_classes_from_buckets

        self.ensure_cell()
        class_tiles = tile_classes_from_buckets(self.cell_buckets, self.b,
                                                tb)
        mask = (np.asarray(self.edge_w) != 0).astype(np.float32)
        (self.ptile_csrc, self.ptile_cld, self.ptile_cw,
         self.pallas_cclasses) = self._pallas_family(
            self.edge_dst, self.edge_src, mask, tb, class_tiles)
        self.pallas_ctb = tb
        self.ptile_crsrc = None            # ring re-base follows the layout
        return self

    def ensure_pallas_cell_ragged_tiles(self) -> "CommPlan":
        """Combined-tile sources for the ragged ring (``ptile_crsrc``):
        local sources stay, halo sources (≥ B) re-base to ``B +`` their
        ring position, so the pass reads ``[local table ‖ ring concat]``.
        Needs ``ensure_pallas_cell_tiles`` and ``ensure_ragged``."""
        if self.ptile_crsrc is not None:
            return self
        self._full_only("ensure_pallas_cell_ragged_tiles()")
        if self.ptile_csrc is None:
            raise ValueError(
                "ragged cell tiles need the combined tile layout first "
                "(ensure_pallas_cell_tiles)")
        from ..ops.tile_spmm import check_tile_layout

        check_tile_layout(self.ptile_cld, self.pallas_cclasses,
                          self.pallas_ctb)
        pos = self._ring_pos_of_rank()
        out = []
        for p in range(self.k):
            src = self.ptile_csrc[p]
            halo = src >= self.b
            out.append(np.where(halo, self.b + pos[p][np.where(
                halo, src - self.b, 0)], src))
        self.ptile_crsrc = np.stack(out).astype(np.int32)
        return self

    # ---------------------------------------- transposed (asymmetric Â)
    def _wire_sum_edges(self):
        """Per part the weight-1 edges of the reverse exchange's owner sum:
        owned row j reads ``q·S + t`` of its reverse wire for every
        ``send_idx[p, q, t] = j`` (t below ``send_counts[p, q]``), in q
        order — ``(dst, src, w)`` lists, dst-sorted."""
        out = []
        for p in range(self.k):
            d, s0 = [], []
            for q in range(self.k):
                cnt = int(self.send_counts[p, q])
                d.append(np.asarray(self.send_idx[p, q, :cnt], np.int64))
                s0.append(q * self.s + np.arange(cnt, dtype=np.int64))
            d, s0 = np.concatenate(d), np.concatenate(s0)
            o = np.argsort(d, kind="stable")
            out.append((d[o], s0[o], np.ones(len(d), np.float32)))
        return out

    def _transpose_families(self, local, halo, tb: int):
        """Tile the three transposed families of one model: ``local`` and
        ``halo`` per part ``(dst, src, w)`` of the forward's local-source
        edges (src an own row) and halo-source edges (src a halo rank).
        Returns ``(tl, th, t1, rev_src)``, each family ``(src, ld, w,
        classes)``: the local-ᵀ and weight-1 families over the ``B`` owned
        rows on shared tile classes, the halo-ᵀ family over the ``k·S``
        wire slots, and the reverse pack's flat sources into the halo-ᵀ
        launch's ``(k, T·tb)`` output."""
        from ..ops.tile_spmm import tile_classes_from_buckets

        k, b, s = self.k, self.b, self.s
        tl, th = [], []
        for p in range(k):
            d, s0, w = local[p]
            o = np.argsort(s0, kind="stable")      # by the transposed dst
            tl.append((s0[o], d[o], w[o]))
            d, s0, w = halo[p]
            slot = np.asarray(self.halo_src[p], np.int64)[s0]
            o = np.argsort(slot, kind="stable")
            th.append((slot[o], d[o], w[o]))
        t1 = self._wire_sum_edges()

        def classes(fams, rows):
            # per destination row the most slots any part gives it, summed
            # over the families that share the classes
            prof = sum(np.max([np.bincount(x[0], minlength=rows)
                               for x in fam], axis=0) for fam in fams)
            return tile_classes_from_buckets(_choose_buckets(prof), rows, tb)

        def family(fam, cls):
            return self._pallas_family([x[0] for x in fam],
                                       [x[1] for x in fam],
                                       [x[2] for x in fam], tb, cls)

        own = classes((tl, t1), b)
        fl, f1 = family(tl, own), family(t1, own)
        fh = family(th, classes((th,), k * s))
        rows = int(sum(t for t, _e in fh[3])) * tb
        if k * rows >= 2 ** 31:
            raise ValueError(f"stacked reverse exchange of k={k} parts of "
                             f"{rows} rows overflows int32 row indices")
        q = np.arange(k, dtype=np.int64)[None, :, None]
        p = np.arange(k, dtype=np.int64)[:, None, None]
        t = np.arange(s, dtype=np.int64)[None, None, :]
        rev = (q * rows + p * s + t).reshape(k, k * s).astype(np.int32)
        return fl, fh, f1, rev

    def ensure_transpose_tiles(self, tb: int = 256) -> "CommPlan":
        """Build the GCN backward's transposed layouts of an asymmetric Â
        on first use (port only): ``ptile_tl*`` (``Â_localᵀ``: the forward's
        local edges i←j as j←i, in a stable sort of ``ledge_*`` by source),
        ``ptile_th*`` (``Â_haloᵀ``: each halo edge's destination is the
        forward wire slot ``halo_src[p, r]`` of the halo row it reads, so
        one launch writes each part's ``(k·S, f)`` reverse send buffer;
        slots no edge reaches come out 0), ``rev_src`` (the a2a transpose
        as one flat gather: ``rwire[p, q·S + t] = send_rev[q, p·S + t]``)
        and ``ptile_t1*`` (weight 1.0: owned row j sums the partials
        ``q·S + t`` with ``send_idx[p, q, t] = j``, in q order), with
        their class tuples.  Each output element of the backward is then
        one serial chain: no scatter, no float atomics."""
        if self.pallas_ttb == tb and self.ptile_tlsrc is not None:
            return self
        self._full_only("ensure_transpose_tiles()")
        local, halo = [], []
        for p in range(self.k):
            lc, hc = int(self.lnnz[p]), int(self.hnnz[p])
            local.append((self.ledge_dst[p, :lc], self.ledge_src[p, :lc],
                          self.ledge_w[p, :lc]))
            halo.append((self.hedge_dst[p, :hc], self.hedge_src[p, :hc],
                         self.hedge_w[p, :hc]))
        fl, fh, f1, self.rev_src = self._transpose_families(local, halo, tb)
        (self.ptile_tlsrc, self.ptile_tlld, self.ptile_tlw,
         self.pallas_tlclasses) = fl
        (self.ptile_thsrc, self.ptile_thld, self.ptile_thw,
         self.pallas_thclasses) = fh
        (self.ptile_t1src, self.ptile_t1ld, self.ptile_t1w,
         self.pallas_t1classes) = f1
        self.pallas_ttb = tb
        return self

    def ensure_cell_transpose_tiles(self, tb: int = 256) -> "CommPlan":
        """``ensure_transpose_tiles`` for GAT (port only): the same three
        families over the combined edge list's 0/1 masks (``edge_w !=
        0``), local sources (``< B``) and halo sources (``≥ B``) taken in
        the combined list's order — ``ptile_tcl*``, ``ptile_tch*``,
        ``ptile_tc1*``, ``rev_csrc``."""
        if self.pallas_tctb == tb and self.ptile_tclsrc is not None:
            return self
        self._full_only("ensure_cell_transpose_tiles()")
        local, halo = [], []
        for p in range(self.k):
            c = int(self.nnz[p])
            d, s0 = self.edge_dst[p, :c], self.edge_src[p, :c]
            w = (self.edge_w[p, :c] != 0).astype(np.float32)
            lm = s0 < self.b
            local.append((d[lm], s0[lm], w[lm]))
            halo.append((d[~lm], s0[~lm] - self.b, w[~lm]))
        fl, fh, f1, self.rev_csrc = self._transpose_families(local, halo, tb)
        (self.ptile_tclsrc, self.ptile_tclld, self.ptile_tclw,
         self.pallas_tclclasses) = fl
        (self.ptile_tchsrc, self.ptile_tchld, self.ptile_tchw,
         self.pallas_tchclasses) = fh
        (self.ptile_tc1src, self.ptile_tc1ld, self.ptile_tc1w,
         self.pallas_tc1classes) = f1
        self.pallas_tctb = tb
        return self

    # -------------------------------------------------------- ragged schedule
    def ragged_round_sizes(self) -> tuple:
        """Natural round sizes S_d = max_p send_counts[p, (p+d) mod k] for
        d = 1..k−1: the ring's static buffer sizes."""
        self._full_only("ragged_round_sizes()")
        sc = np.asarray(self.send_counts)
        k = sc.shape[0]
        idx = np.arange(k)
        return tuple(int(sc[idx, (idx + d) % k].max()) for d in range(1, k))

    def ensure_ragged(self, rr_sizes: tuple | None = None,
                      rr_edge_sizes: tuple | None = None) -> "CommPlan":
        """Build the ragged ring layout on first use: ``rr_sizes``, the
        send rows ``rsend_idx`` (round d's slots of part p hold
        ``send_idx[p, (p+d) mod k]``) and the receive map ``rhalo_dst``
        (round d's slots of part q name the halo ranks of the rows owner
        ``(q−d) mod k`` sends; pads name rank R).  The halo order is
        (owner, vertex) and every send list is id-sorted, so a round's
        rows arrive exactly as the owner's contiguous halo slice.

        The halo-src edges are split per arrival round as the reference
        does (``redge_*``, round d in ``rr_edge_sizes[d−1]`` slots, src
        re-based to the round's receive buffer): ``hedge_*`` is sorted by
        (dst, round, receive position), so folding the rounds in order
        adds each row's edges in the a2a fold's order — the ragged == a2a
        bit-identity of the ELL aggregators.  ``redge_nnz`` (port only)
        counts each round's true edges per part.

        ``rr_sizes`` / ``rr_edge_sizes`` force larger per-round envelopes
        (the mini-batch trainer pads every batch plan's rounds to a shared
        envelope, as the reference does); a forced size below the natural
        one raises, and a layout built at other sizes is rebuilt (when the
        round sizes change, with the ring-re-based tile sources,
        ``ptile_hrsrc``/``ptile_crsrc``, dropped)."""
        if (self.rr_sizes is not None and rr_sizes in (None, self.rr_sizes)
                and rr_edge_sizes in (None, self.rr_edge_sizes)):
            return self
        self._full_only("ensure_ragged()")
        nat = self.ragged_round_sizes()
        if rr_sizes is None:
            rr_sizes = nat
        elif (len(rr_sizes) != len(nat)
                or any(a < b for a, b in zip(rr_sizes, nat))):
            raise ValueError(
                f"forced rr_sizes {tuple(rr_sizes)} smaller than natural "
                f"{nat}")
        rr_sizes = tuple(int(x) for x in rr_sizes)
        k, s, r = self.k, self.s, self.r
        sc = np.asarray(self.send_counts)
        owner_rank = np.asarray(self.halo_src) // s       # (k, R) owner per
        pos_rank = np.asarray(self.halo_src) % s          # halo rank + pos
        st = max(1, sum(rr_sizes))
        rsend_idx = np.zeros((k, st), np.int32)
        rhalo_dst = np.full((k, st), r, np.int32)         # r = dropped pad
        off = 0
        for d, sd in enumerate(rr_sizes, start=1):
            for p in range(k):
                cnt = int(sc[p, (p + d) % k])             # send side: p → p+d
                rsend_idx[p, off: off + cnt] = self.send_idx[p, (p + d) % k,
                                                             :cnt]
                o = (p - d) % k                           # recv side: o → p
                rc = int(sc[o, p])
                if rc:
                    hs = int(self.halo_counts[p])
                    ranks = np.nonzero(owner_rank[p, :hs] == o)[0]
                    if len(ranks) != rc:                  # plan invariant
                        raise ValueError(
                            f"halo sublist of owner {o} on part {p} has "
                            f"{len(ranks)} rows, send list says {rc}")
                    rhalo_dst[p, off: off + rc] = ranks.astype(np.int32)
            off += sd
        # per-round halo-src edge families: hedge is (dst, round, pos)-sorted
        # at build time, so each round's subsequence is (dst, pos)-sorted
        rounds = []
        for q in range(k):
            cnt = int(self.hnnz[q])
            d_ = self.hedge_dst[q, :cnt]
            s_ = self.hedge_src[q, :cnt]
            w_ = self.hedge_w[q, :cnt]
            fold = (q - owner_rank[q, s_]) % k            # arrival round
            rounds.append([(d_[fold == d], pos_rank[q, s_[fold == d]],
                            w_[fold == d]) for d in range(1, k)])
        nat_es = tuple(max((len(rounds[q][d][0]) for q in range(k)),
                           default=0) for d in range(max(k - 1, 0)))
        if rr_edge_sizes is None:
            rr_edge_sizes = nat_es
        elif (len(rr_edge_sizes) != len(nat_es)
                or any(a < b for a, b in zip(rr_edge_sizes, nat_es))):
            raise ValueError(
                f"forced rr_edge_sizes {tuple(rr_edge_sizes)} smaller than "
                f"natural {nat_es}")
        rr_edge_sizes = tuple(int(x) for x in rr_edge_sizes)
        et = max(1, sum(rr_edge_sizes))
        redge_dst = np.full((k, et), self.b - 1, np.int32)
        redge_src = np.zeros((k, et), np.int32)
        redge_w = np.zeros((k, et), np.float32)
        redge_nnz = np.zeros((k, max(k - 1, 0)), np.int32)
        off = 0
        for d, ed in enumerate(rr_edge_sizes):
            for q in range(k):
                dd, ss, ww = rounds[q][d]
                redge_dst[q, off: off + len(dd)] = dd
                redge_src[q, off: off + len(ss)] = ss
                redge_w[q, off: off + len(ww)] = ww
                redge_nnz[q, d] = len(dd)
            off += ed
        if rr_sizes != self.rr_sizes:
            # each concat slot's flat stacked row: round d's slots of part q
            # hold what part (q−d) mod k sends
            ring_src = np.zeros((k, st), np.int64)
            off = 0
            for d, sd in enumerate(rr_sizes, start=1):
                for q in range(k):
                    o = (q - d) % k
                    ring_src[q, off: off + sd] = (
                        o * self.b + rsend_idx[o, off: off + sd])
                off += sd
            if k * self.b >= 2 ** 31:
                raise ValueError(f"stacked ring of k={k}, B={self.b} "
                                 "overflows int32 row indices")
            self.ring_src = ring_src.astype(np.int32)
            self.ptile_hrsrc = self.ptile_crsrc = None  # re-based on the ring
        self.rr_sizes = rr_sizes
        self.rsend_idx = rsend_idx
        self.rhalo_dst = rhalo_dst
        self.rr_edge_sizes = rr_edge_sizes
        self.redge_dst = redge_dst
        self.redge_src = redge_src
        self.redge_w = redge_w
        self.redge_nnz = redge_nnz
        if self.ell_chains is not None:
            self.ell_chains.pop("ragged", None)        # built on the old ring
        return self

    # ------------------------------------------------ ELL serial chains
    def ensure_ell_chains(self, schedule: str = "a2a") -> "CommPlan":
        """Lay out the ELL aggregators' sums for ``schedule`` on first use
        (port only; ``ell_chain_layout`` documents the arrays): ``'a2a'``
        and ``'ragged'`` the symmetric aggregation (``ops/pspmm.py::
        PspmmEllSym`` / ``PspmmRaggedSym``), ``'directed'`` the
        split-edge aggregation of an asymmetric Â and its transpose
        (``pspmm_overlap``), ``'edge'`` the combined ``[local; halo]``
        edge list (``pspmm``), ``'cell'`` the GAT slot passes over the
        combined-edge layout (``models/gat.py::GatLayerEll``, either
        transport) and ``'cell_t'`` those plus their transpose (an
        asymmetric plan).  Builds the exchange layout it reads
        (``ensure_exchange``, ``ensure_ragged`` for the ring,
        ``ensure_cell`` for the combined edges).  A one-part slice
        (``parallel/proxy.py``: the shard proxy, a rank) lays out its own
        part's chains over its own buffers; the layouts they read are
        the full plan's, built before slicing (a slice that lacks one
        raises)."""
        if schedule not in ("a2a", "ragged", "directed", "edge", "cell",
                            "cell_t"):
            raise ValueError(f"unknown ELL chain layout {schedule!r}")
        chains = self.ell_chains if self.ell_chains is not None else {}
        if schedule not in chains:
            self.ensure_exchange()
            if schedule == "ragged":
                self.ensure_ragged()
            if schedule in ("cell", "cell_t"):
                self.ensure_cell()
            chains[schedule] = ell_chain_layout(self, schedule)
        self.ell_chains = chains
        return self

    def padding_efficiency(self) -> float:
        """Σ send_counts / (k²·S): the share of the dense a2a's padded
        wire rows that carry real boundary rows (``auto``'s gauge)."""
        wire = self.wire_rows_per_exchange("a2a")
        return float(self.send_counts.sum()) / wire if wire else 1.0

    def wire_rows_per_exchange(self, schedule: str = "a2a",
                               replica: bool = False) -> int:
        """Padded rows the schedule puts on the wire per exchange over all
        parts: the dense a2a ships each part's whole (k, S) buffer, k²·S
        rows in all; the ragged ring ships Σ_d S_d rows per part,
        k·Σ_d S_d in all.  ``replica=True`` prices the shrunken exchange
        of a replica step (``ensure_replicas``): ``nrep_s`` /
        ``nrep_rr_sizes`` in place of ``s`` / ``rr_sizes``."""
        rows, peers = np.asarray(self.send_counts).shape
        if replica and self.rep_slots is None:
            raise ValueError("build the replication layout first "
                             "(ensure_replicas)")
        if schedule == "a2a":
            return int(rows * peers * (self.nrep_s if replica else self.s))
        if schedule == "ragged":
            if replica:
                if self.nrep_rr_sizes is None:
                    raise ValueError(
                        "ragged replica wire needs ensure_ragged() before "
                        "ensure_replicas()")
                sizes = self.nrep_rr_sizes
            else:
                sizes = (self.rr_sizes if self.rr_sizes is not None
                         else self.ragged_round_sizes())
            return int(rows * sum(sizes))
        raise ValueError(f"unknown comm schedule {schedule!r}")

    def wire_buffer_shapes(self, schedule: str = "a2a",
                           replica: bool = False) -> list:
        """The reference's per-dispatch wire-buffer shapes of ONE halo
        exchange, without the lane axis: ``'a2a'`` one ``(peers, S)``
        bucket (``nrep_s`` under ``replica``), ``'ragged'`` one ``(S_d,)``
        per live round (``ops/pspmm.py::ragged_live_rounds``; the
        shrunken ``nrep_rr_sizes`` under ``replica``).  The port's pack
        writes the receive layout directly (``recv_layout_shape``)."""
        if replica and self.rep_slots is None:
            raise ValueError("build the replication layout first "
                             "(ensure_replicas)")
        if schedule == "a2a":
            peers = int(np.asarray(self.send_counts).shape[1])
            return [(peers, self.nrep_s if replica else self.s)]
        if schedule == "ragged":
            from ..ops.pspmm import ragged_live_rounds   # deferred: a cycle

            if replica:
                if self.nrep_rr_sizes is None:
                    raise ValueError(
                        "ragged replica wire needs ensure_ragged() before "
                        "ensure_replicas()")
                sizes = self.nrep_rr_sizes
            else:
                sizes = (self.rr_sizes if self.rr_sizes is not None
                         else self.ragged_round_sizes())
            return [(int(sizes[d - 1]),)
                    for d in ragged_live_rounds(sizes)]
        raise ValueError(f"unknown comm schedule {schedule!r}")

    def recv_layout_shape(self, schedule: str = "a2a") -> tuple:
        """The port's receive layout of one exchange, stacked, without the
        lane axis: ``(k, k·S)`` for the a2a (every sender's padded bucket
        in peer order, ``recv_src``) and ``(k, max(1, Σ_d S_d))`` for the
        ring's round-major concat (``ring_src``) — the table the row pack
        writes and the fused launch reads, and the carries' layout."""
        if schedule == "a2a":
            # a one-part slice (parallel/proxy.py) keeps every peer's
            # bucket: send_idx's second axis, not the slice's k
            peers = int(np.asarray(self.send_idx).shape[1])
            return (int(self.k), int(peers * self.s))
        if schedule == "ragged":
            sizes = (self.rr_sizes if self.rr_sizes is not None
                     else self.ragged_round_sizes())
            return (int(self.k), max(1, int(sum(sizes))))
        raise ValueError(f"unknown comm schedule {schedule!r}")

    # ----------------------------------------------------- hot-halo replicas
    def replica_scores(self) -> tuple:
        """Per (owner part, local row): ``(λ, consumer-edge count)`` of
        every owned row — λ the number of parts it ships to per exchange,
        the edge count the remote halo-source edges that read it.
        ``λ·edges`` is the replica ranking."""
        k, b, s = self.k, self.b, self.s
        lam = np.zeros((k, b), np.int64)
        cons = np.zeros((k, b), np.int64)
        for q in range(k):
            hs = int(self.halo_counts[q])
            if not hs:
                continue
            hedge_cnt = np.bincount(self.hedge_src[q, : int(self.hnnz[q])],
                                    minlength=self.r)
            slots = np.asarray(self.halo_src[q, :hs])
            o = slots // s
            j = slots % s
            rows = self.send_idx[o, q, j]
            np.add.at(lam, (o, rows), 1)
            np.add.at(cons, (o, rows), hedge_cnt[:hs])
        return lam, cons

    def ensure_replicas(self, budget: int) -> "CommPlan":
        """Build the hot-halo replica layout for ``budget`` rows (the
        reference's construction, array for array): the top-``budget``
        boundary rows by λ·degree (ties by (owner, row)) are replicated;
        the shrunken a2a buckets and, when the ring exists, the shrunken
        ring keep every other row in its order; the partial refresh's
        side channel holds exactly the deleted rows.  A budget above the
        boundary row count clamps (everything replicated).  Idempotent per
        budget; call ``ensure_ragged()`` first when the ring is in play.
        Also builds the port-only lists (``keep_*``, ``rep_*_dst``,
        ``rep_src_flat``, ``rep_base_flat``, ``rep_table_pos``,
        ``rep_rows_flat``, ``rep_row_valid``)."""
        if budget < 0:
            raise ValueError(f"replica budget must be >= 0, got {budget}")
        ring = self.rr_sizes is not None
        if (self.replica_budget == budget and self.rep_slots is not None
                and (not ring or self.nrep_rsend_idx is not None)):
            return self
        self._full_only("ensure_replicas()")
        k, b, s, r = self.k, self.b, self.s, self.r
        sc = np.asarray(self.send_counts)
        lam, cons = self.replica_scores()
        score = (lam * cons).ravel()
        boundary = np.nonzero(lam.ravel() > 0)[0]
        order = boundary[np.lexsort((boundary, -score[boundary]))]
        chosen = order[:budget]
        rep_mask = np.zeros(k * b, bool)
        rep_mask[chosen] = True
        rep_mask = rep_mask.reshape(k, b)
        self.replica_rows = int(len(chosen))
        self.replica_send_saving = int(lam.ravel()[chosen].sum())
        # shrunken send buckets: kept entries keep their id-sorted order
        nrep_counts = np.zeros((k, k), np.int32)
        kept_lists: dict[tuple[int, int], np.ndarray] = {}
        for p in range(k):
            for q in range(k):
                cnt = int(sc[p, q])
                if not cnt:
                    continue
                kept = np.nonzero(~rep_mask[p, self.send_idx[p, q, :cnt]])[0]
                kept_lists[(p, q)] = kept
                nrep_counts[p, q] = len(kept)
        nrep_s = max(1, int(nrep_counts.max()) if k else 1)
        nrep_send_idx = np.zeros((k, k, nrep_s), np.int32)
        for (p, q), kept in kept_lists.items():
            nrep_send_idx[p, q, : len(kept)] = self.send_idx[p, q, kept]
        # the partial refresh's side channel: each sender's owned
        # replicated rows and the replica-only per-pair buckets (the
        # deleted rows, in send-list order)
        rows_lists = [np.nonzero(rep_mask[p])[0] for p in range(k)]
        rs = max(1, max((len(x) for x in rows_lists), default=0))
        rep_rows = np.zeros((k, rs), np.int32)
        rep_row_counts = np.zeros(k, np.int32)
        for p in range(k):
            rep_rows[p, : len(rows_lists[p])] = rows_lists[p]
            rep_row_counts[p] = len(rows_lists[p])
        ronly_counts = (sc.astype(np.int32) - nrep_counts)
        ronly_s = max(1, int(ronly_counts.max()) if k else 1)
        ronly_send_idx = np.zeros((k, k, ronly_s), np.int32)
        ronly_base_pos = np.zeros((k, k, ronly_s), np.int32)
        for p in range(k):
            for q in range(k):
                cnt = int(sc[p, q])
                if not cnt:
                    continue
                rows_pq = self.send_idx[p, q, :cnt]
                deleted = np.nonzero(rep_mask[p, rows_pq])[0]
                if not len(deleted):
                    continue
                ronly_send_idx[p, q, : len(deleted)] = rows_pq[deleted]
                ronly_base_pos[p, q, : len(deleted)] = np.searchsorted(
                    rows_lists[p], rows_pq[deleted]).astype(np.int32)
        # receive side: shrunken halo gather and the replica slot lists
        # (ring positions: round d's slice starts at Σ_{d'<d} S_d' and a
        # slot sits at its send-list position j within it)
        offsets = (np.concatenate([[0], np.cumsum(self.rr_sizes)])
                   if ring else None)
        base_pos = np.zeros(k * b, np.int64)     # replicated row → its
        for p in range(k):                       # position in rep_rows[p]
            base_pos[p * b + rows_lists[p]] = np.arange(len(rows_lists[p]))
        nrep_halo_src = np.zeros((k, r), np.int32)
        rep_slot_lists, rep_ring_lists, rep_recv_lists = [], [], []
        rep_base_lists = []
        for q in range(k):
            hs = int(self.halo_counts[q])
            if not hs:
                for lst in (rep_slot_lists, rep_ring_lists, rep_recv_lists,
                            rep_base_lists):
                    lst.append(np.zeros(0, np.int64))
                continue
            slots = np.asarray(self.halo_src[q, :hs])
            o = slots // s
            j = slots % s
            rows = self.send_idx[o, q, j]
            keep = ~rep_mask[o, rows]
            newpos = np.zeros(hs, np.int64)
            npos_del = np.zeros(hs, np.int64)
            for oo in np.unique(o):
                m = o == oo
                newpos[m] = np.cumsum(keep[m]) - 1
                npos_del[m] = np.cumsum(~keep[m]) - 1
            nrep_halo_src[q, :hs] = np.where(
                keep, o * nrep_s + newpos, 0).astype(np.int32)
            reps = np.nonzero(~keep)[0]
            rep_slot_lists.append(reps)
            rep_recv_lists.append(o[reps] * ronly_s + npos_del[reps])
            # port only: the owner's flat baseline row of each replica
            rep_base_lists.append(o[reps] * rs
                                  + base_pos[o[reps] * b + rows[reps]])
            rep_ring_lists.append(offsets[(q - o[reps]) % k - 1] + j[reps]
                                  if ring else np.zeros(0, np.int64))
        rp = max(1, max((len(x) for x in rep_slot_lists), default=0))
        rep_slots = np.full((k, rp), r, np.int32)
        rep_ring_pos = np.zeros((k, rp), np.int32)
        rep_recv_src = np.zeros((k, rp), np.int32)
        for q in range(k):
            rep_slots[q, : len(rep_slot_lists[q])] = rep_slot_lists[q]
            rep_recv_src[q, : len(rep_recv_lists[q])] = rep_recv_lists[q]
            rep_ring_pos[q, : len(rep_ring_lists[q])] = rep_ring_lists[q]
        self.rep_counts = np.array([len(x) for x in rep_slot_lists],
                                   np.int64)
        self.rep_slots = rep_slots
        self.rp = rp
        self.nrep_s = nrep_s
        self.nrep_send_idx = nrep_send_idx
        self.nrep_send_counts = nrep_counts
        self.nrep_halo_src = nrep_halo_src
        self.rep_ring_pos = rep_ring_pos if ring else None
        self.rs = rs
        self.rep_rows = rep_rows
        self.rep_row_counts = rep_row_counts
        self.ronly_s = ronly_s
        self.ronly_send_idx = ronly_send_idx
        self.ronly_send_counts = ronly_counts
        self.ronly_base_pos = ronly_base_pos
        self.rep_recv_src = rep_recv_src
        if ring:
            idxk = np.arange(k)
            nrr = tuple(int(nrep_counts[idxk, (idxk + d) % k].max())
                        for d in range(1, k))
            st = max(1, sum(nrr))
            full_total = int(sum(self.rr_sizes))
            nrep_rsend_idx = np.zeros((k, st), np.int32)
            nrep_rhalo_dst = np.full((k, st), r, np.int32)
            nrep_ring_dst = np.full((k, st), full_total, np.int32)
            off = 0
            for d, sd in enumerate(nrr, start=1):
                for p in range(k):
                    q2 = (p + d) % k
                    cnt = int(nrep_counts[p, q2])
                    if cnt:
                        nrep_rsend_idx[p, off: off + cnt] = \
                            nrep_send_idx[p, q2, :cnt]
                    o = (p - d) % k
                    rc = int(nrep_counts[o, p])
                    if rc:
                        hs = int(self.halo_counts[p])
                        slots = np.asarray(self.halo_src[p, :hs])
                        oarr = slots // s
                        rows = self.send_idx[oarr, p, slots % s]
                        m = (oarr == o) & ~rep_mask[oarr, rows]
                        ranks = np.nonzero(m)[0]
                        if len(ranks) != rc:         # plan invariant
                            raise ValueError(
                                f"kept halo sublist of owner {o} on part "
                                f"{p} has {len(ranks)} rows, shrunken send "
                                f"list says {rc}")
                        nrep_rhalo_dst[p, off: off + rc] = \
                            ranks.astype(np.int32)
                        nrep_ring_dst[p, off: off + rc] = (
                            offsets[d - 1]
                            + (slots % s)[ranks]).astype(np.int32)
                off += sd
            self.nrep_rr_sizes = nrr
            self.nrep_rsend_idx = nrep_rsend_idx
            self.nrep_rhalo_dst = nrep_rhalo_dst
            self.nrep_ring_dst = nrep_ring_dst
        self._replica_lists(rep_mask, rep_slot_lists, rep_base_lists)
        self.replica_budget = int(budget)
        return self

    def _replica_lists(self, rep_mask, rep_slot_lists, rep_base_lists):
        """The port-only flat lists of ``ensure_replicas`` (see the
        fields): real slots only, so a pack writes no pad slot and no
        slot out of range."""
        k, b, s, r = self.k, self.b, self.s, self.r
        if k * b >= 2 ** 31 or k * k * s >= 2 ** 31:
            raise ValueError(f"stacked exchange of k={k}, B={b}, S={s} "
                             "overflows int32 row indices")
        # a2a: receive slot (q, p, t) holds h[p, send_idx[p, q, t]]
        q_, p_, t_ = np.meshgrid(np.arange(k), np.arange(k), np.arange(s),
                                 indexing="ij")
        row = self.send_idx[p_, q_, t_]
        real = t_ < np.asarray(self.send_counts)[p_, q_]
        keep = real & ~rep_mask[p_, row]
        self.keep_recv_src = (p_ * b + row)[keep].astype(np.int32)
        self.keep_recv_dst = (q_ * k * s + p_ * s + t_)[keep].astype(np.int32)
        # a kept slot's place among the kept rows of its (p → q) list
        ns = self.nrep_s
        tk = np.cumsum(keep, axis=-1) - 1
        if k * k * ns >= 2 ** 31:
            raise ValueError(f"shrunken exchange of k={k}, S'={ns} "
                             "overflows int32 row indices")
        self.keep_nrecv_src = (q_ * k * ns + p_ * ns + tk)[keep].astype(
            np.int32)
        reps = [np.asarray(x, np.int64) for x in rep_slot_lists]
        owner_slot = [np.asarray(self.halo_src[q], np.int64)[reps[q]]
                      for q in range(k)]
        self.rep_recv_dst = np.concatenate(
            [q * k * s + owner_slot[q] for q in range(k)]
            + [np.zeros(0, np.int64)]).astype(np.int32)
        self.rep_src_flat = np.concatenate(
            [(x // s) * b + self.send_idx[x // s, q, x % s]
             for q, x in enumerate(owner_slot)]
            + [np.zeros(0, np.int64)]).astype(np.int32)
        self.rep_base_flat = np.concatenate(
            rep_base_lists + [np.zeros(0, np.int64)]).astype(np.int32)
        self.rep_table_pos = np.concatenate(
            [q * self.rp + np.arange(len(x)) for q, x in enumerate(reps)]
            + [np.zeros(0, np.int64)]).astype(np.int32)
        self.rep_rows_flat = (np.asarray(self.rep_rows, np.int64)
                              + (np.arange(k) * b)[:, None]).astype(np.int32)
        self.rep_row_valid = (np.arange(self.rs)[None, :]
                              < self.rep_row_counts[:, None]).astype(
                                  np.float32)
        self.rep_rows_flat *= self.rep_row_valid.astype(np.int32)
        if self.rr_sizes is None:
            self.keep_ring_src = self.keep_ring_dst = None
            self.keep_nring_src = self.rep_ring_dst = None
            return
        # ring: the same slots at their full ring positions
        st = max(1, sum(self.rr_sizes))
        nst = self.nrep_ring_dst.shape[1]       # max(1, ΣS'_d)
        full_total = int(sum(self.rr_sizes))
        dst, src, nsrc = [], [], []
        for q in range(k):
            live = self.nrep_ring_dst[q] < full_total
            pos = self.nrep_ring_dst[q][live].astype(np.int64)
            dst.append(q * st + pos)
            src.append(self.ring_src[q][pos].astype(np.int64))
            nsrc.append(q * nst + np.nonzero(live)[0])
        self.keep_ring_dst = np.concatenate(dst).astype(np.int32)
        self.keep_ring_src = np.concatenate(src).astype(np.int32)
        self.keep_nring_src = np.concatenate(nsrc).astype(np.int32)
        self.rep_ring_dst = np.concatenate(
            [q * st + self.rep_ring_pos[q, : len(x)].astype(np.int64)
             for q, x in enumerate(reps)]
            + [np.zeros(0, np.int64)]).astype(np.int32)

    def replica_carry_shapes(self, fin: int, widths,
                             partial: bool = False) -> dict:
        """The replica mode's carries in the reference's layout (its
        checkpoint's), without the stacked leading ``k`` axis: per layer
        one ``(RP, f_ℓ)`` feature-replica and one gradient-replica table
        at the exchanged width, and under ``partial`` (``refresh_band``)
        the senders' ``(RS, f_ℓ)`` refresh baselines.  The port's trainer
        carries the receive layouts and converts at the checkpoint."""
        from ..models.gcn import exchange_widths   # deferred: avoids a cycle

        if self.rep_slots is None:
            raise ValueError(
                "replica carries need the replication layout; call "
                "ensure_replicas() before replica_carry_shapes()")
        fs = exchange_widths(fin, list(widths))
        out = {"reps": [(self.rp, f) for f in fs],
               "greps": [(self.rp, f) for f in fs]}
        if partial:
            out["rep_base"] = [(self.rep_base_rows, f) for f in fs]
        return out

    @property
    def rep_base_rows(self) -> int:
        """Rows of each part's partial-refresh baselines: ``rs``, and on a
        slice one more where its loopback reads a pad of the side channel
        (``parallel/proxy.py::_spare_row``)."""
        return int(self.rep_rows_flat.shape[1])

    @property
    def partial_refresh_wire_rows(self) -> int:
        """Padded wire rows of one partial-refresh side-channel exchange:
        the dense ``(k, RS')`` bucket per part."""
        if self.ronly_send_counts is None:
            raise ValueError("build the replication layout first "
                             "(ensure_replicas)")
        rows, peers = np.asarray(self.ronly_send_counts).shape
        return int(rows * peers * self.ronly_s)

    @property
    def replica_send_volume(self) -> np.ndarray:
        """Per-part true boundary rows of one shrunken exchange (k,)."""
        if self.nrep_send_counts is None:
            raise ValueError("build the replication layout first "
                             "(ensure_replicas)")
        return self.nrep_send_counts.astype(np.int64).sum(axis=1)

    # ------------------------------------------------------------ stale halo
    def stale_carry_shapes(self, fin: int, widths, delta: bool = False,
                           comm_schedule: str = "a2a") -> dict:
        """Per-layer carry shapes of the stale-halo mode in the
        reference's layout, without the stacked leading ``k`` axis — the
        layout its checkpoints hold.  ``f_ℓ`` is each layer's exchanged
        width (``models.gcn.exchange_widths``, the project-first rule).

        ``'a2a'``: ``halos``/``ghalos`` ``(R, f_ℓ)`` halo tables, ``bases``
        the sender's ``(k, S, f_ℓ)`` delta baseline under ``delta``, else a
        ``(1, 1, 1)`` placeholder.  ``'ragged'``: every carry is the
        ring's round-major receive concat ``(max(1, Σ_d S_d), f_ℓ)``
        (placeholder base ``(1, 1)``); needs ``ensure_ragged()`` first.
        The port's trainer carries the receive layouts the fused launch
        reads in place and converts to these shapes only at the
        checkpoint (``train/fullbatch.py``)."""
        from ..models.gcn import exchange_widths   # deferred: avoids a cycle

        fs = exchange_widths(fin, list(widths))
        if comm_schedule == "ragged":
            if self.rr_sizes is None:
                raise ValueError(
                    "round-structured stale carries need the ragged layout; "
                    "call ensure_ragged() before stale_carry_shapes("
                    "comm_schedule='ragged')")
            st = max(1, sum(self.rr_sizes))
            return {
                "halos": [(st, f) for f in fs],
                "ghalos": [(st, f) for f in fs],
                "bases": [((st, f) if delta else (1, 1)) for f in fs],
            }
        if comm_schedule != "a2a":
            raise ValueError(f"unknown comm_schedule {comm_schedule!r}")
        peers = self.send_idx.shape[1]
        return {
            "halos": [(self.r, f) for f in fs],
            "ghalos": [(self.r, f) for f in fs],
            "bases": [((peers, self.s, f) if delta else (1, 1, 1))
                      for f in fs],
        }

    # ------------------------------------------------------------------ stats
    def offwire_send_counts(self) -> np.ndarray:
        """``send_counts`` with each part's self-slot zeroed — the rows that
        actually leave a part.  On the full square plan row i's self-slot
        is column i; a per-part slice records its part in ``chip_ids``."""
        off = self.send_counts.astype(np.int64).copy()
        if self.chip_ids is not None:
            off[np.arange(off.shape[0]), np.asarray(self.chip_ids)] = 0
        else:
            np.fill_diagonal(off, 0)
        return off

    def _full_only(self, what: str) -> None:
        """Raise on a per-part slice: ``what`` is built over all parts,
        so it must be built on the full plan before slicing."""
        if self.chip_ids is not None:
            raise ValueError(
                f"{what} is built over every part: call it on the full "
                "plan BEFORE shard_proxy_plan (this is a one-part slice)")

    @property
    def predicted_send_volume(self) -> np.ndarray:
        """Per-part boundary rows shipped per exchange (k,) — the
        partitioners' connectivity metric Σ(λ−1)."""
        return self.offwire_send_counts().sum(axis=1)

    @property
    def predicted_message_count(self) -> np.ndarray:
        """Per-part count of non-empty peer messages (k,)."""
        return (self.offwire_send_counts() > 0).sum(axis=1)

    # --------------------------------------------------------- data placement
    def scatter_rows(self, x: np.ndarray, fill: float = 0.0,
                     chips=None) -> np.ndarray:
        """Global (n, f) row data → stacked per-part (k, B, f) padded
        blocks; ``chips`` restricts the stack to those parts, reading only
        the rows they own (a rank's own block)."""
        x = np.asarray(x)
        f = x.shape[1] if x.ndim > 1 else 1
        if chips is None:
            out = np.full((self.k, self.b, f), fill, dtype=x.dtype)
            out[self.owner, self.local_idx] = x.reshape(self.n, f)
            return out
        chips = list(chips)
        out = np.full((len(chips), self.b, f), fill, dtype=x.dtype)
        x2 = x.reshape(self.n, f)
        for i, p in enumerate(chips):
            sel = self.owner == p
            out[i, self.local_idx[sel]] = x2[sel]
        return out

    def gather_rows(self, blocks: np.ndarray) -> np.ndarray:
        """Stacked per-part (k, B, f) blocks → global (n, f) row data."""
        return np.asarray(blocks)[self.owner, self.local_idx]

    def global_row_ids(self) -> np.ndarray:
        """(k, B) int64: the global vertex id in each (part, local slot);
        −1 on padding slots."""
        out = np.full((self.k, self.b), -1, dtype=np.int64)
        out[self.owner, self.local_idx] = np.arange(self.n, dtype=np.int64)
        return out

    def halo_global_rows(self) -> np.ndarray:
        """(k, R) int64: the global vertex id each halo rank holds after one
        exchange; −1 on padding ranks.  Halo rank ``j`` of part ``c`` reads
        receive slot ``halo_src[c, j] = q·S + t``, which owner ``q`` filled
        from its local row ``send_idx[q, c, t]``, so the map comes from the
        plan alone.  Sub-graph serving (``serve/subgraph.py``) maps the halo
        family's sources to global rows through it."""
        si = np.asarray(self.send_idx)
        glob = self.global_row_ids()
        out = np.full((self.k, self.r), -1, dtype=np.int64)
        for c in range(self.k):
            hs = int(self.halo_counts[c])
            flat = np.asarray(self.halo_src[c, :hs], dtype=np.int64)
            q = flat // self.s
            out[c, :hs] = glob[q, si[q, c, flat % self.s]]
        return out


def _relabel(n: int, partvec: np.ndarray, k: int, pad_rows_to: int,
             order_key: np.ndarray | None = None):
    """Vertex relabeling: (owner, local_idx, part_sizes, b, row_valid).

    Within a part, vertices are ranked by global id (``order_key=None``)
    or descending by ``order_key`` with global id as the tie-break.
    """
    owner = np.asarray(partvec, dtype=np.int64)
    if owner.shape[0] != n:
        raise ValueError(f"partvec length {owner.shape[0]} != n {n}")
    if n and (owner.min() < 0 or owner.max() >= k):
        raise ValueError("partvec entries out of range")
    part_sizes = np.bincount(owner, minlength=k)
    b = int(part_sizes.max()) if n else 1
    b = max(1, -(-b // pad_rows_to) * pad_rows_to)
    if order_key is None:
        order = np.lexsort((np.arange(n), owner))
    else:
        order = np.lexsort((np.arange(n), -np.asarray(order_key), owner))
    local_idx = np.empty(n, dtype=np.int64)
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(part_sizes, out=starts[1:])
    local_idx[order] = np.arange(n) - starts[owner[order]]
    row_valid = np.zeros((k, b), dtype=np.float32)
    for p in range(k):
        row_valid[p, : part_sizes[p]] = 1.0
    return owner, local_idx, part_sizes, b, row_valid


def _split_edges(edge_dst, edge_src, edge_w, nnz, b,
                 el: int | None = None, eh: int | None = None,
                 halo_fold_key=None):
    """Split padded (k, E) edge lists into local-src and halo-src lists.

    Local edges (``src < b``) keep their src; halo edges re-base src to the
    halo block (``src - b``).  ``el`` / ``eh`` force a larger padded width
    (the mini-batch plans' shared envelope).  ``halo_fold_key`` ((k, R)
    int, optional): each part's halo edges are re-sorted by (dst, fold,
    rank) — the reference's arrival-round order of the ragged ring, kept
    so the edge order (and the tile layout built from it) matches the
    reference.  Padding edges carry dst ``b-1`` and weight 0.
    """
    k = edge_dst.shape[0]
    parts = []
    for p in range(k):
        cnt = int(nnz[p])
        d, s0, w = edge_dst[p, :cnt], edge_src[p, :cnt], edge_w[p, :cnt]
        lm = s0 < b
        hd, hs, hw = d[~lm], s0[~lm] - b, w[~lm]
        if halo_fold_key is not None and len(hd):
            fk = halo_fold_key[p]
            o = np.lexsort((hs, fk[hs], hd))
            hd, hs, hw = hd[o], hs[o], hw[o]
        parts.append((d[lm], s0[lm], w[lm], hd, hs, hw))
    lnnz = np.array([len(t[0]) for t in parts], dtype=np.int64)
    hnnz = np.array([len(t[3]) for t in parts], dtype=np.int64)
    el_nat = max(1, int(lnnz.max()) if k else 1)
    eh_nat = max(1, int(hnnz.max()) if k else 1)
    el = el_nat if el is None else el
    eh = eh_nat if eh is None else eh
    if el < el_nat or eh < eh_nat:
        raise ValueError("split envelope smaller than natural edge counts")
    ld = np.full((k, el), b - 1, dtype=np.int32)
    ls = np.zeros((k, el), dtype=np.int32)
    lw = np.zeros((k, el), dtype=np.float32)
    hd = np.full((k, eh), b - 1, dtype=np.int32)
    hs = np.zeros((k, eh), dtype=np.int32)
    hw = np.zeros((k, eh), dtype=np.float32)
    for p, (d1, s1, w1, d2, s2, w2) in enumerate(parts):
        ld[p, : len(d1)] = d1
        ls[p, : len(s1)] = s1
        lw[p, : len(w1)] = w1
        hd[p, : len(d2)] = d2
        hs[p, : len(s2)] = s2
        hw[p, : len(w2)] = w2
    return dict(el=el, eh=eh, ledge_dst=ld, ledge_src=ls, ledge_w=lw,
                hedge_dst=hd, hedge_src=hs, hedge_w=hw, lnnz=lnnz, hnnz=hnnz)


def ell_degree_profile(ledge_dst, lnnz, b) -> np.ndarray:
    """Pointwise max over parts of the per-row local in-degree, (b,)."""
    k = ledge_dst.shape[0]
    prof = np.zeros(b, dtype=np.int64)
    for p in range(k):
        np.maximum(prof,
                   np.bincount(ledge_dst[p, : int(lnnz[p])], minlength=b),
                   out=prof)
    return prof


def _choose_buckets(profile: np.ndarray, max_buckets: int = 6,
                    width_cap: int = 64) -> tuple:
    """Optimal ≤``max_buckets`` contiguous row buckets for a descending
    degree profile, minimizing total padded slots Σ nb·wb (wb = max degree
    in the bucket).  DP over degree-change points, subsampled to 64
    candidates on graphs with many distinct degrees.  ``width_cap`` bounds
    every bucket width; rows past it spill to the COO tail."""
    b = len(profile)
    d = np.minimum(np.maximum(np.asarray(profile, dtype=np.int64), 0),
                   width_cap)
    cuts = [0] + [i for i in range(1, b) if d[i] != d[i - 1]] + [b]
    if len(cuts) > 65:
        keep = np.unique(np.linspace(0, len(cuts) - 1, 65).astype(int))
        cuts = [cuts[i] for i in keep]
    m = len(cuts)
    # bucket width = the true segment max (profiles may be only
    # near-descending)
    segmax = [[0] * m for _ in range(m)]
    for i in range(m - 1):
        run = 0
        for j in range(i + 1, m):
            run = max(run, int(d[cuts[j - 1]: cuts[j]].max()))
            segmax[i][j] = run
    inf = float("inf")
    best = [[inf] * (max_buckets + 1) for _ in range(m)]
    back = [[0] * (max_buckets + 1) for _ in range(m)]
    best[0][0] = 0.0
    for j in range(1, m):
        for q in range(1, max_buckets + 1):
            for i in range(j):
                if best[i][q - 1] == inf:
                    continue
                w = max(segmax[i][j], 1)
                c = best[i][q - 1] + (cuts[j] - cuts[i]) * w
                if c < best[j][q]:
                    best[j][q] = c
                    back[j][q] = i
    q = min(range(1, max_buckets + 1), key=lambda t: best[m - 1][t])
    segs = []
    j = m - 1
    while j > 0:
        i = back[j][q]
        segs.append((cuts[j] - cuts[i], max(segmax[i][j], 1)))
        j, q = i, q - 1
    return tuple(reversed(segs))


def _single_bucket_width(alldeg: np.ndarray, tail_frac: float) -> int:
    """Classic ELL width: smallest multiple of 4 whose overflow tail holds
    at most ``tail_frac`` of the edges (capped at the max degree)."""
    maxdeg = int(alldeg.max()) if alldeg.size else 0
    total = max(1, int(alldeg.sum()))
    ell_k = 4
    while ell_k < maxdeg:
        if int(np.maximum(alldeg - ell_k, 0).sum()) <= tail_frac * total:
            break
        ell_k += 4
    return min(ell_k, max(maxdeg, 1))


def _build_ell(ledge_dst, ledge_src, ledge_w, lnnz, b,
               row_order: str = "degree",
               buckets: tuple | None = None, tl: int | None = None,
               tail_frac: float = 0.02, max_buckets: int = 6):
    """Bucketed-ELL layout of dst-sorted edge lists (see CommPlan):
    ``row_order='degree'`` takes the buckets of ``_choose_buckets``,
    ``'id'`` one bucket of the classic tail-bounded width.  ``buckets`` /
    ``tl`` force the bucket structure and a larger tail length (the
    mini-batch plans' shared envelope); edges past a forced row width
    spill to the tail."""
    k = ledge_dst.shape[0]
    degs = [np.bincount(ledge_dst[p, : int(lnnz[p])], minlength=b)
            for p in range(k)]
    if buckets is None:
        if row_order == "degree":
            prof = np.zeros(b, dtype=np.int64)
            for dg in degs:
                np.maximum(prof, dg, out=prof)
            buckets = _choose_buckets(prof, max_buckets=max_buckets)
        else:
            alldeg = (np.concatenate(degs) if k else np.zeros(1, np.int64))
            buckets = ((b, _single_bucket_width(alldeg, tail_frac)),)
    if sum(nb for nb, _ in buckets) != b:
        raise ValueError(f"buckets {buckets} do not cover {b} rows")
    et = sum(nb * wb for nb, wb in buckets)
    # width-major flat layout: bucket at base `off` stores slot t of row r
    # (rank r-r0 in the bucket) at off + t·nb + (r-r0)
    row_base = np.empty(b, dtype=np.int64)
    row_stride = np.empty(b, dtype=np.int64)
    row_cap = np.empty(b, dtype=np.int64)
    off = r0 = 0
    for nb, wb in buckets:
        row_base[r0: r0 + nb] = off + np.arange(nb, dtype=np.int64)
        row_stride[r0: r0 + nb] = nb
        row_cap[r0: r0 + nb] = wb
        off += nb * wb
        r0 += nb
    ell_idx = np.zeros((k, et), dtype=np.int32)
    ell_wv = np.zeros((k, et), dtype=np.float32)
    tails = []
    for p in range(k):
        cnt = int(lnnz[p])
        d = ledge_dst[p, :cnt].astype(np.int64)
        s0 = ledge_src[p, :cnt]
        w = ledge_w[p, :cnt]
        starts = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(degs[p], out=starts[1:])
        pos = np.arange(cnt) - starts[d]
        main = pos < row_cap[d]
        slots = row_base[d[main]] + pos[main] * row_stride[d[main]]
        ell_idx[p][slots] = s0[main]
        ell_wv[p][slots] = w[main]
        tails.append((d[~main].astype(np.int32), s0[~main], w[~main]))
    ltail_nnz = np.array([len(t[0]) for t in tails], dtype=np.int64)
    tl_nat = max(1, int(ltail_nnz.max()) if k else 1)
    tl = tl_nat if tl is None else tl
    if tl < tl_nat:
        raise ValueError("tail envelope smaller than natural tail size")
    ltail_dst = np.full((k, tl), b - 1, dtype=np.int32)
    ltail_src = np.zeros((k, tl), dtype=np.int32)
    ltail_w = np.zeros((k, tl), dtype=np.float32)
    for p, (d, s0, w) in enumerate(tails):
        ltail_dst[p, : len(d)] = d
        ltail_src[p, : len(s0)] = s0
        ltail_w[p, : len(w)] = w
    return dict(ell_k=max(wb for _, wb in buckets), tl=tl,
                ell_buckets=buckets, ell_idx=ell_idx, ell_w=ell_wv,
                ltail_dst=ltail_dst, ltail_src=ltail_src, ltail_w=ltail_w,
                ltail_nnz=ltail_nnz)


def shared_ell_buckets(plans: list, b: int, combined: bool = False) -> tuple:
    """Bucket structure covering every plan's degree profile — the shared
    envelope companion of ``pad_comm_plan`` for mini-batch plans (all
    padded to ``b`` rows).  ``combined=True`` covers the combined
    local + halo edge lists (the GAT layout) instead of the local-src
    ones."""
    prof = np.zeros(b, dtype=np.int64)
    for pl in plans:
        q = (ell_degree_profile(pl.edge_dst, pl.nnz, pl.b) if combined
             else ell_degree_profile(pl.ledge_dst, pl.lnnz, pl.b))
        np.maximum(prof[: pl.b], q, out=prof[: pl.b])
    if all(pl.row_order == "degree" for pl in plans):
        return _choose_buckets(prof)
    # id-ordered rows: one classic tail-bounded width shared by all, each
    # plan's natural combined width read from its degree counts
    if combined:
        widths = []
        for pl in plans:
            alldeg = np.concatenate(
                [np.bincount(pl.edge_dst[p, : int(pl.nnz[p])], minlength=pl.b)
                 for p in range(pl.k)])
            widths.append(_single_bucket_width(alldeg, tail_frac=0.02))
        return ((b, max(widths)),)
    return ((b, max(pl.ell_k for pl in plans)),)


def _cell_fields(ell: dict) -> dict:
    """Rename a ``_build_ell`` result into the combined-edge field names."""
    return dict(ctl=ell["tl"], cell_buckets=ell["ell_buckets"],
                cell_idx=ell["ell_idx"], cell_w=ell["ell_w"],
                ctail_dst=ell["ltail_dst"], ctail_src=ell["ltail_src"],
                ctail_w=ell["ltail_w"], ctail_nnz=ell["ltail_nnz"])


def chain_levels(dst) -> tuple:
    """The serial chains of a scatter-add ``out[dst_e] += v_e`` in stored
    order ``e = 0, 1, …``, as levels: each update's rank among the earlier
    updates of its row is its level, and level ``j`` holds every row's
    ``j``-th update, so no level names a row twice.  Adding the levels in
    order into a zero table forms each row's sum as the one chain
    ``((0 + v_a) + v_b) + …`` in stored order: XLA:CPU's sorted
    ``segment_sum`` and ``.at[].add``, with no two updates of a level
    racing on a row.  Returns ``(perm, sizes)``: the updates in level
    order (stored order within a level) and each level's size."""
    dst = np.asarray(dst, np.int64).reshape(-1)
    n = dst.size
    if n == 0:
        return np.zeros(0, np.int64), ()
    order = np.argsort(dst, kind="stable")
    sd = dst[order]
    start = np.r_[0, np.flatnonzero(sd[1:] != sd[:-1]) + 1]
    first = np.repeat(start, np.diff(np.r_[start, n]))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    return (np.argsort(rank, kind="stable"),
            tuple(int(x) for x in np.bincount(rank)))


def _chain(out: dict, name: str, dst, src, w=None) -> None:
    """Store one scatter-add family as ``{name}_dst/_src[/_w]`` (int32
    flat rows, float32 weights) in level order and ``{name}_levels``."""
    perm, sizes = chain_levels(dst)
    out[f"{name}_dst"] = np.asarray(dst, np.int64)[perm].astype(np.int32)
    out[f"{name}_src"] = np.asarray(src, np.int64)[perm].astype(np.int32)
    if w is not None:
        out[f"{name}_w"] = np.asarray(w, np.float32)[perm]
    out[f"{name}_levels"] = sizes


def _real(plan, dst, src, w, counts, dst_base, src_base):
    """Every part's first ``counts[p]`` edges, flattened over the parts:
    flat dst ``p·dst_base + dst``, flat src ``src_base(p, src)``."""
    ds, ss, ws = [], [], []
    for p in range(plan.k):
        c = int(counts[p])
        ds.append(p * dst_base + np.asarray(dst[p, :c], np.int64))
        ss.append(src_base(p, np.asarray(src[p, :c], np.int64)))
        ws.append(np.asarray(w[p, :c], np.float32))
    return np.concatenate(ds), np.concatenate(ss), np.concatenate(ws)


def ell_chain_layout(plan, schedule: str) -> dict:
    """The flat arrays the ELL aggregators read (port only), over the
    ``k`` parts stacked: a row of part ``p`` is ``p·B + i``, a receive
    slot ``q·k·S + j`` (a2a buffer) or ``q·ΣS_d + j`` (ring concat).
    Only true edges enter a chain; every chain family (``*_dst``,
    ``*_src``, ``*_w``, ``*_levels``) is in ``chain_levels`` order.

      * ``ell_src`` / ``ell_w`` (``'a2a'``, ``'ragged'``): ``ell_idx`` /
        ``ell_w`` re-laid bucket by bucket, slot by slot, part by part,
        so each width slot of a bucket is one ``(k·nb)`` run, in the
        reference's width-major slot order;
      * ``ltail_*``: the hub tail ``ltail_*``, local rows;
      * ``hedge_*`` (``'a2a'``, ``'directed'``): the halo-src edges, each
        source the receive slot of its halo row (``halo_src_flat``), so
        the remote pass reads the exchange's receive buffer in place;
      * ``redge_*`` (``'ragged'``): the per-round split ``redge_*``, round
        after round, each source its slot of the ring concat;
      * ``ledge_*`` (``'directed'``): the local-src edges; ``ledge_t_*``
        and ``hedge_t_*`` their transposes (dst a source row or receive
        slot, in the stored edge order: XLA's transpose of a gather is a
        scatter-add in that order); ``owner_*`` the owners' sum of the
        reverse exchange (dst ``p·B + send_idx[p, q, t]``, src ``p·k·S +
        q·S + t``, weight 1) and ``rev_src`` its pack, ``rwire[p, q·S + t]
        = send_rev[q, p·S + t]`` over ``(k, k·S)`` buffers;
      * ``edge_*`` (``'edge'``): the combined edge list over ``[local;
        halo]`` tables ``(k, B + R, f)``;
      * ``cell_src`` / ``cell_m`` (``'cell'``, ``'cell_t'``): the GAT's
        combined-edge slots ``cell_idx`` re-laid as ``ell_src`` is (one
        ``(k·nb)`` run per slot), each source flat in the stacked
        ``[local; halo]`` table of ``k·(B + R)`` rows, and each slot's
        mask ``cell_w != 0`` as float32 0/1 (pad slots keep source 0 and
        mask 0, as the reference's do); ``chub_*`` the hub tail
        ``ctail_*`` (true edges, dst ``p·B + i``, the same sources, mask
        weights);
      * ``cl_t_*`` / ``ch_t_*`` (``'cell_t'``): the transposes of the
        combined edges in stored edge order, split by source: a local
        source's dst its row ``p·B + j``, a halo source's its receive
        slot (``halo_src_flat``), the src the edge's dst row ``p·B + i``,
        mask weights; with ``owner_*`` and ``rev_src`` as for
        ``'directed'``;
      * ``recv_src`` or ``ring_src``: the exchange's pack.

    A one-part slice of part ``c`` (``parallel/proxy.py``, ``k = 1``)
    gets part ``c``'s entries of the stacked layout, re-based to its own
    buffers: rows ``i`` of its ``(1, B, f)`` table, slots of its own
    ``(1, k·S)`` receive window (its ``halo_src_flat`` is ``halo_src[c]``)
    or ring concat, rows of its ``(1, B + R)`` ``[local; halo]`` table,
    and each chain in the stacked chain's order (``chain_levels`` keeps
    stored order within a row), so every sum is the stacked part's
    serial chain.  Its ``recv_src`` / ``ring_src`` is its send pack's
    index and its ``rev_src`` the loopback's (``_owner_chains``)."""
    k, b, s = plan.k, plan.b, plan.s
    out: dict = {}
    if schedule in ("a2a", "ragged"):
        srcs, ws, off = [], [], 0
        base = (np.arange(k, dtype=np.int64) * b)[:, None, None]
        for nb, wb in plan.ell_buckets:
            blk = np.asarray(plan.ell_idx[:, off: off + nb * wb], np.int64)
            srcs.append((blk.reshape(k, wb, nb) + base).transpose(1, 0, 2)
                        .reshape(-1))
            ws.append(np.asarray(plan.ell_w[:, off: off + nb * wb])
                      .reshape(k, wb, nb).transpose(1, 0, 2).reshape(-1))
            off += nb * wb
        out["ell_src"] = np.concatenate(srcs).astype(np.int32)
        out["ell_w"] = np.concatenate(ws).astype(np.float32)
        _chain(out, "ltail", *_real(
            plan, plan.ltail_dst, plan.ltail_src, plan.ltail_w,
            plan.ltail_nnz, b, lambda p, x: p * b + x))
    hsf = np.asarray(plan.halo_src_flat, np.int64)
    if schedule in ("a2a", "directed"):
        _chain(out, "hedge", *_real(
            plan, plan.hedge_dst, plan.hedge_src, plan.hedge_w, plan.hnnz,
            b, lambda p, x: hsf[p, x]))
        out["recv_src"] = plan.recv_src
    if schedule == "ragged":
        st = plan.ring_src.shape[1]
        ds, ss, ws, levels = [], [], [], ()
        off_s = off_e = 0
        for d, (sd, ed) in enumerate(zip(plan.rr_sizes,
                                         plan.rr_edge_sizes)):
            fam: dict = {}
            cnt = plan.redge_nnz[:, d]
            sl = slice(off_e, off_e + ed)
            _chain(fam, "r", *_real(
                plan, plan.redge_dst[:, sl], plan.redge_src[:, sl],
                plan.redge_w[:, sl], cnt, b,
                lambda p, x, o=off_s: p * st + o + x))
            ds.append(fam["r_dst"])
            ss.append(fam["r_src"])
            ws.append(fam["r_w"])
            levels += fam["r_levels"]
            off_s += sd
            off_e += ed
        out["redge_dst"] = np.concatenate(ds).astype(np.int32)
        out["redge_src"] = np.concatenate(ss).astype(np.int32)
        out["redge_w"] = np.concatenate(ws).astype(np.float32)
        out["redge_levels"] = levels
        out["ring_src"] = plan.ring_src
    if schedule == "directed":
        ld, ls, lw = _real(plan, plan.ledge_dst, plan.ledge_src,
                           plan.ledge_w, plan.lnnz, b,
                           lambda p, x: p * b + x)
        _chain(out, "ledge", ld, ls, lw)
        _chain(out, "ledge_t", ls, ld, lw)
        hd, hs, hw = _real(plan, plan.hedge_dst, plan.hedge_src,
                           plan.hedge_w, plan.hnnz, b, lambda p, x: hsf[p, x])
        _chain(out, "hedge_t", hs, hd, hw)
        _owner_chains(out, plan)
    if schedule in ("cell", "cell_t"):
        rows = b + int(plan.r)
        base = (np.arange(k, dtype=np.int64) * rows)[:, None, None]
        srcs, ms, off = [], [], 0
        for nb, wb in plan.cell_buckets:
            sl = slice(off, off + nb * wb)
            blk = np.asarray(plan.cell_idx[:, sl], np.int64)
            srcs.append((blk.reshape(k, wb, nb) + base).transpose(1, 0, 2)
                        .reshape(-1))
            ms.append((np.asarray(plan.cell_w[:, sl]) != 0)
                      .reshape(k, wb, nb).transpose(1, 0, 2).reshape(-1))
            off += nb * wb
        out["cell_src"] = np.concatenate(srcs).astype(np.int32)
        out["cell_m"] = np.concatenate(ms).astype(np.float32)
        _chain(out, "chub", *_real(
            plan, plan.ctail_dst, plan.ctail_src,
            (np.asarray(plan.ctail_w) != 0).astype(np.float32),
            plan.ctail_nnz, b, lambda p, x: p * rows + x))
    if schedule == "cell_t":
        hsf = np.asarray(plan.halo_src_flat, np.int64)
        fams = {"l": ([], [], []), "h": ([], [], [])}
        for p in range(k):
            c = int(plan.nnz[p])
            d = np.asarray(plan.edge_dst[p, :c], np.int64)
            src = np.asarray(plan.edge_src[p, :c], np.int64)
            m = (np.asarray(plan.edge_w[p, :c]) != 0).astype(np.float32)
            loc = src < b
            for key, sel, dst in (("l", loc, p * b + src[loc]),
                                  ("h", ~loc, hsf[p, src[~loc] - b])):
                fams[key][0].append(dst)
                fams[key][1].append(p * b + d[sel])
                fams[key][2].append(m[sel])
        for key, name in (("l", "cl_t"), ("h", "ch_t")):
            _chain(out, name, *(np.concatenate(x) for x in fams[key]))
        _owner_chains(out, plan)
    if schedule == "edge":
        _chain(out, "edge", *_real(
            plan, plan.edge_dst, plan.edge_src, plan.edge_w, plan.nnz, b,
            lambda p, x: p * (b + plan.r) + x))
        out["recv_src"] = plan.recv_src
        out["halo_src_flat"] = plan.halo_src_flat
    return out


def _owner_chains(out: dict, plan) -> None:
    """The reverse exchange's two ends of an asymmetric Â's backward:
    ``owner_*``, the owners' weight-1 sum of what comes back (dst ``p·B +
    send_idx[p, q, t]``, src ``p·k·S + q·S + t``), and ``rev_src``, its
    pack, ``rwire[p, q·S + t] = send_rev[q, p·S + t]`` over ``(k, k·S)``
    buffers.  ``k`` of the buffers is ``send_idx``'s peer axis: on a
    one-part slice (one row, ``k`` peers) the owners' sum reads the
    rank's own ``(1, k·S)`` received reverse buffer, and ``rev_src`` is
    the loopback's (``parallel/proxy.py::REBASE``: the part's own
    partial goes back in place); a rank's reverse exchange is the
    collective and packs nothing."""
    rows, k = plan.send_counts.shape
    b, s = plan.b, plan.s
    sc = np.asarray(plan.send_counts)
    t = np.arange(s)
    real = t[None, None, :] < sc[:, :, None]                 # (rows, k, S)
    p_, q_, t_ = np.nonzero(real)                            # p, q, t order
    _chain(out, "owner",
           p_ * b + np.asarray(plan.send_idx, np.int64)[p_, q_, t_],
           p_ * k * s + q_ * s + t_)
    if plan.chip_ids is not None:
        out["rev_src"] = np.arange(k * s, dtype=np.int32)[None]
        return
    rev = (np.arange(k)[None, :, None] * (k * s)
           + np.arange(k)[:, None, None] * s + t[None, None, :])
    out["rev_src"] = rev.reshape(k, k * s).astype(np.int32)


def _check_symmetric(a: sp.spmatrix) -> bool:
    """Exact pattern symmetry, values within 1e-6 relative (normalization
    round-off)."""
    a = sp.csr_matrix(a)
    a.eliminate_zeros()
    a.sort_indices()
    at = sp.csr_matrix(a.T)
    at.eliminate_zeros()
    at.sort_indices()
    if not (np.array_equal(a.indptr, at.indptr)
            and np.array_equal(a.indices, at.indices)):
        return False
    if a.nnz == 0:
        return True
    scale = max(float(np.abs(a.data).max()), 1e-30)
    return float(np.abs(a.data - at.data).max()) <= 1e-6 * scale


def choose_replica_budget(plan, decision: dict | None = None) -> int:
    """The ``replica_budget='auto'`` rule of the reference: rank the
    boundary rows by λ·edges (``replica_scores``) and take the knee of
    the descending score curve — the prefix length where the normalized
    cumulative score sits farthest above the diagonal.  Returns B;
    ``decision`` (filled in place) logs the inputs under the reference's
    keys."""
    lam, cons = plan.replica_scores()
    score = (lam.astype(np.float64) * cons).ravel()
    boundary = np.sort(score[lam.ravel() > 0])[::-1]
    log = decision if decision is not None else {}
    m = int(len(boundary))
    log.update(rule="lambda-degree-knee", boundary_rows=m)
    if m == 0 or boundary[0] <= 0:
        log.update(chosen=0, score_covered=0.0)
        return 0
    cum = np.cumsum(boundary)
    gap = cum / cum[-1] - np.arange(1, m + 1) / m
    b = int(np.argmax(gap)) + 1
    log.update(chosen=b, score_total=float(cum[-1]),
               score_covered=float(cum[b - 1] / cum[-1]),
               knee_gap=float(gap[b - 1]))
    return b


def resolve_comm_schedule(schedule: str | None, plans, model: str,
                          decision: dict | None = None,
                          halo_staleness: int = 0,
                          replica_budget: int = 0) -> str:
    """Resolve a ``comm_schedule`` knob to a transport, by the reference's
    rules.

    ``None`` reads ``$SGCN_COMM_SCHEDULE`` (default ``'a2a'``).  An
    explicit ``'a2a'``/``'ragged'`` resolves to itself (callers validate an
    explicit ``'ragged'`` themselves).  ``'auto'`` picks ``'ragged'`` only
    when every plan supports the ring (symmetric, k > 1) and its cost
    rule says so, else ``'a2a'``:

    * exact mode (``halo_staleness=0``): the dense a2a's padding
      efficiency — true rows over wire rows, summed over the plans —
      falls below ``RAGGED_AUTO_EFFICIENCY``;
    * stale mode (``halo_staleness=1``): the exchange has no same-step
      consumer, so only wire bytes count — the ring wins whenever it
      ships strictly fewer wire rows (the hidden-exchange rule).

    ``replica_budget`` (B > 0, ``auto`` already resolved): the transports
    are scored on the shrunken exchange a replica step ships (the full
    figures logged beside it); builds each plan's ring and replica
    layouts as a side effect.

    Every exchange of a plan ships the same row set at every lane width,
    so the byte ratio is the row ratio for both models.

    ``decision`` (a dict, filled in place): the inputs and the rule that
    fired, under the reference's keys."""
    import os
    log = decision if decision is not None else {}
    asked = schedule
    if schedule is None:
        schedule = os.environ.get("SGCN_COMM_SCHEDULE", "a2a")
        asked = f"${{SGCN_COMM_SCHEDULE}}={schedule}"
    if schedule not in ("a2a", "ragged", "auto"):
        raise ValueError(
            f"comm_schedule must be 'a2a', 'ragged' or 'auto', got "
            f"{schedule!r}")
    log.update(asked=asked, model=model, halo_staleness=int(halo_staleness),
               replica_budget=int(replica_budget))

    def resolved(value: str, rule: str) -> str:
        log.update(resolved=value, rule=rule)
        return value

    if schedule != "auto":
        return resolved(schedule, "explicit")
    true = wire = wire_ragged = 0
    for p in plans:
        sc = np.asarray(p.send_counts)
        if not (p.symmetric and sc.shape[1] > 1):
            return resolved("a2a", "plan does not support the ragged ring "
                                   "(asymmetric, sliced, or k == 1)")
        if replica_budget:
            p.ensure_ragged()
            p.ensure_replicas(replica_budget)
        true += int(sc.sum())
        wire += p.wire_rows_per_exchange("a2a")
        wire_ragged += p.wire_rows_per_exchange("ragged")
    log.update(true_rows=true, wire_rows_a2a=wire,
               wire_rows_ragged=wire_ragged)
    if replica_budget:
        true = sum(int(np.asarray(p.nrep_send_counts).sum()) for p in plans)
        wire = sum(p.wire_rows_per_exchange("a2a", replica=True)
                   for p in plans)
        wire_ragged = sum(p.wire_rows_per_exchange("ragged", replica=True)
                          for p in plans)
        log.update(replica_rows=sum(int(p.replica_rows) for p in plans),
                   true_rows_replica=true,
                   wire_rows_a2a_replica=wire,
                   wire_rows_ragged_replica=wire_ragged)
    log.update(padding_efficiency=(true / wire if wire else 1.0),
               threshold=RAGGED_AUTO_EFFICIENCY)
    if halo_staleness:
        if wire_ragged < wire:
            return resolved("ragged", "hidden-exchange wire-byte rule: "
                                      "ragged ships fewer wire rows")
        return resolved("a2a", "hidden-exchange wire-byte rule: ragged "
                               "ships no fewer wire rows")
    if not wire or true / wire >= RAGGED_AUTO_EFFICIENCY:
        return resolved("a2a", "padding efficiency at/above threshold")
    return resolved("ragged", "padding efficiency below threshold")


def relabel_plan(a: sp.spmatrix, partvec: np.ndarray, k: int,
                 pad_rows_to: int = 1) -> CommPlan:
    """Vertex relabeling and padding fields only, no halo or send
    construction (the reference's, array for array): the broadcast
    baseline ships every row every layer, so the partitioned path's
    exchange layout would be dead work.  Fills owner, local_idx,
    part_sizes, b, e, nnz and row_valid (rows ranked by global id); the
    comm fields are trivial."""
    a = sp.coo_matrix(a)
    n = a.shape[0]
    owner, local_idx, part_sizes, b, row_valid = _relabel(
        n, partvec, k, pad_rows_to)
    nnz = np.bincount(owner[a.row], minlength=k)
    e = max(1, int(nnz.max()) if len(nnz) else 1)
    z = np.zeros
    return CommPlan(
        n=n, k=k, b=b, s=1, r=1, e=e,
        owner=owner, local_idx=local_idx,
        part_sizes=part_sizes.astype(np.int64),
        send_idx=z((k, k, 1), np.int32), send_counts=z((k, k), np.int32),
        halo_src=z((k, 1), np.int32), halo_counts=z(k, np.int32),
        edge_dst=z((k, e), np.int32), edge_src=z((k, e), np.int32),
        edge_w=z((k, e), np.float32), nnz=nnz.astype(np.int64),
        row_valid=row_valid,
        el=1, eh=1,
        ledge_dst=z((k, 1), np.int32), ledge_src=z((k, 1), np.int32),
        ledge_w=z((k, 1), np.float32),
        hedge_dst=z((k, 1), np.int32), hedge_src=z((k, 1), np.int32),
        hedge_w=z((k, 1), np.float32),
        lnnz=z(k, np.int64), hnnz=z(k, np.int64),
        ell_k=1, tl=1, ell_buckets=((b, 1),),
        ell_idx=z((k, b), np.int32), ell_w=z((k, b), np.float32),
        ltail_dst=z((k, 1), np.int32), ltail_src=z((k, 1), np.int32),
        ltail_w=z((k, 1), np.float32), ltail_nnz=z(k, np.int64),
        ctl=1, cell_buckets=((b, 1),),
        cell_idx=z((k, b), np.int32), cell_w=z((k, b), np.float32),
        ctail_dst=z((k, 1), np.int32), ctail_src=z((k, 1), np.int32),
        ctail_w=z((k, 1), np.float32), ctail_nnz=z(k, np.int64),
        symmetric=_check_symmetric(a), row_order="id",
    )


def pad_comm_plan(plan: CommPlan, b: int, s: int, r: int, e: int,
                  el: int | None = None, eh: int | None = None,
                  tl: int | None = None, ctl: int | None = None,
                  ell_buckets: tuple | None = None,
                  cell_buckets: tuple | None = None) -> CommPlan:
    """Re-pad a plan to a larger (B, S, R, E) envelope (and EL, EH, TL,
    CTL, the ELL buckets): the reference's construction, array for array,
    by which every mini-batch plan takes one shared envelope.  Pad edges
    carry weight 0 and dst ``b-1`` (each ``edge_dst`` stays
    non-decreasing), the halo sources re-base from ``plan.b`` to ``b``,
    the flat receive slots ``q·S_old + t`` move to ``q·S + t``, and pad
    send / halo slots index row 0.  Returns a plan with none of the lazy
    layouts (tiles, exchange, ring) built; a plan already at the envelope
    comes back as it is."""
    el = plan.el if el is None else el
    eh = plan.eh if eh is None else eh
    tl = plan.tl if tl is None else tl
    if ctl is None:
        ctl = plan.ctl
    if (b, s, r, e, el, eh, tl) == (
            plan.b, plan.s, plan.r, plan.e, plan.el, plan.eh, plan.tl) \
            and ctl == plan.ctl \
            and ell_buckets in (None, plan.ell_buckets) \
            and cell_buckets in (None, plan.cell_buckets):
        return plan
    if (b < plan.b or s < plan.s or r < plan.r or e < plan.e
            or el < plan.el or eh < plan.eh or tl < plan.tl
            or (ctl is not None and plan.ctl is not None and ctl < plan.ctl)):
        raise ValueError("pad_comm_plan cannot shrink an envelope")
    k = plan.k

    send_idx = np.zeros((k, k, s), dtype=np.int32)
    send_idx[:, :, : plan.s] = plan.send_idx
    halo_src = np.zeros((k, r), dtype=np.int32)
    # old flat receive slots q·S_old + t → q·S + t
    q_old, t_old = plan.halo_src // plan.s, plan.halo_src % plan.s
    halo_src[:, : plan.r] = (q_old * s + t_old).astype(np.int32)
    edge_dst = np.full((k, e), b - 1, dtype=np.int32)
    edge_dst[:, : plan.e] = plan.edge_dst
    # the old pad edges pointed at plan.b-1: move them to b-1 (weight 0
    # either way) so each list stays non-decreasing
    for p in range(k):
        edge_dst[p, plan.nnz[p]: plan.e] = b - 1
    edge_src = np.zeros((k, e), dtype=np.int32)
    # the halo block moves from plan.b to b
    old_src = plan.edge_src
    edge_src[:, : plan.e] = np.where(
        old_src >= plan.b, old_src - plan.b + b, old_src)
    edge_w = np.zeros((k, e), dtype=np.float32)
    edge_w[:, : plan.e] = plan.edge_w
    row_valid = np.zeros((k, b), dtype=np.float32)
    row_valid[:, : plan.b] = plan.row_valid

    peers = plan.send_counts.shape[1]
    split = _split_edges(edge_dst, edge_src, edge_w, plan.nnz, b, el=el, eh=eh,
                         halo_fold_key=(np.arange(k)[:, None]
                                        - halo_src // s) % peers)
    ell = _build_ell(split["ledge_dst"], split["ledge_src"], split["ledge_w"],
                     split["lnnz"], b, row_order=plan.row_order,
                     buckets=ell_buckets, tl=tl)
    padded = CommPlan(
        n=plan.n, k=k, b=b, s=s, r=r, e=e,
        owner=plan.owner, local_idx=plan.local_idx, part_sizes=plan.part_sizes,
        send_idx=send_idx, send_counts=plan.send_counts.copy(),
        halo_src=halo_src, halo_counts=plan.halo_counts.copy(),
        edge_dst=edge_dst, edge_src=edge_src, edge_w=edge_w,
        nnz=plan.nnz.copy(), row_valid=row_valid,
        symmetric=plan.symmetric, row_order=plan.row_order,
        **split, **ell,
    )
    if cell_buckets is not None or plan.cell_buckets is not None:
        padded.ensure_cell(buckets=cell_buckets, ctl=ctl)
    return padded


def build_comm_plan(
    a: sp.spmatrix,
    partvec: np.ndarray,
    k: int,
    pad_rows_to: int = 1,
    pad_send_to: int = 1,
    row_order: str = "degree",
) -> CommPlan:
    """Compute the static plan from adjacency + part vector.

    ``pad_rows_to`` / ``pad_send_to`` round B and S up to a multiple.  The
    halo of part ``p`` is every remote vertex its local nonzeros reference;
    the send side is its transpose.  ``row_order='degree'`` relabels each
    part's rows descending by local in-degree; ``'id'`` ranks by global id.
    """
    a = sp.coo_matrix(a)
    n = a.shape[0]
    if row_order not in ("degree", "id"):
        raise ValueError(f"unknown row_order {row_order!r}")
    key = None
    if row_order == "degree":
        ow = np.asarray(partvec, dtype=np.int64)
        local_edge = ow[a.row] == ow[a.col]
        key = np.bincount(a.row[local_edge], minlength=n)
    owner, local_idx, part_sizes, b, row_valid = _relabel(
        n, partvec, k, pad_rows_to, order_key=key)

    src_g, dst_g, w_g = a.col, a.row, a.data.astype(np.float32)
    eo = owner[dst_g]                       # part owning each edge (by row)

    # per-part halo vertex lists, sorted by (owner, id)
    halo_lists: list[np.ndarray] = []
    for p in range(k):
        em = eo == p
        cols = src_g[em]
        remote = cols[owner[cols] != p]
        uniq = np.unique(remote)
        uniq = uniq[np.lexsort((uniq, owner[uniq]))]
        halo_lists.append(uniq)
    halo_counts = np.array([len(h) for h in halo_lists], dtype=np.int32)
    r = max(1, int(halo_counts.max()) if k else 1)

    # send lists per ordered pair (p → q): vertices owned by p in q's halo
    send_lists: dict[tuple[int, int], np.ndarray] = {}
    s = 1
    for q in range(k):
        hq = halo_lists[q]
        ho = owner[hq]
        for p in range(k):
            if p == q:
                continue
            vs = hq[ho == p]                # already sorted by id
            if len(vs):
                send_lists[(p, q)] = vs
                s = max(s, len(vs))
    s = max(1, -(-s // pad_send_to) * pad_send_to)

    send_idx = np.zeros((k, k, s), dtype=np.int32)
    send_counts = np.zeros((k, k), dtype=np.int32)
    for (p, q), vs in send_lists.items():
        send_idx[p, q, : len(vs)] = local_idx[vs]
        send_counts[p, q] = len(vs)

    # halo gather: part p's halo row (owner q, position t in p's per-owner
    # sublist == position in q→p send list) reads recv-flat slot q*S + t
    halo_src = np.zeros((k, r), dtype=np.int32)
    for p in range(k):
        hp = halo_lists[p]
        if not len(hp):
            continue
        ho = owner[hp]
        pos = np.zeros(len(hp), dtype=np.int64)
        for q in np.unique(ho):
            m = ho == q
            pos[m] = q * s + np.arange(m.sum())
        halo_src[p, : len(hp)] = pos

    # per-part padded edge lists; pad dst with the last row (b-1) so each
    # part's edge_dst stays non-decreasing
    nnz = np.bincount(eo, minlength=k)
    e = max(1, int(nnz.max()) if len(nnz) else 1)
    edge_dst = np.full((k, e), b - 1, dtype=np.int32)
    edge_src = np.zeros((k, e), dtype=np.int32)
    edge_w = np.zeros((k, e), dtype=np.float32)
    for p in range(k):
        em = eo == p
        rows = local_idx[dst_g[em]].astype(np.int32)
        cols = src_g[em]
        vals = w_g[em]
        co = owner[cols]
        csrc = np.empty(len(cols), dtype=np.int32)
        lm = co == p
        csrc[lm] = local_idx[cols[lm]].astype(np.int32)
        if (~lm).any():
            # halo position via searchsorted on the (owner, id)-sorted list
            hp = halo_lists[p]
            keys = owner[hp] * (n + 1) + hp
            qkeys = co[~lm] * (n + 1) + cols[~lm]
            csrc[~lm] = b + np.searchsorted(keys, qkeys).astype(np.int32)
        srt = np.argsort(rows, kind="stable")
        cnt = em.sum()
        edge_dst[p, :cnt] = rows[srt]
        edge_src[p, :cnt] = csrc[srt]
        edge_w[p, :cnt] = vals[srt]

    split = _split_edges(edge_dst, edge_src, edge_w, nnz, b,
                         halo_fold_key=(np.arange(k)[:, None]
                                        - halo_src // s) % k)
    ell = _build_ell(split["ledge_dst"], split["ledge_src"], split["ledge_w"],
                     split["lnnz"], b, row_order=row_order)
    return CommPlan(
        n=n, k=k, b=b, s=s, r=r, e=e,
        owner=owner, local_idx=local_idx, part_sizes=part_sizes.astype(np.int64),
        send_idx=send_idx, send_counts=send_counts,
        halo_src=halo_src, halo_counts=halo_counts,
        edge_dst=edge_dst, edge_src=edge_src, edge_w=edge_w,
        nnz=nnz.astype(np.int64), row_valid=row_valid,
        symmetric=_check_symmetric(a), row_order=row_order,
        **split, **ell,
    )
