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
    reference's ``ptile_*``/``pallas_*`` so the two plans compare by name.

Ragged, combined-edge (GAT), replica and stale layouts are not ported yet.
Everything here is offline numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


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

    def _pallas_family(self, dst, src, w, tb: int, class_tiles):
        """Stack one edge family's per-part tile classes into flat
        ``(k, ΣT_c·Emax_c)`` arrays (per class, Emax_c padded to the max
        across parts) + the static class structure."""
        from ..ops.tile_spmm import build_dst_tile_classes

        per = [build_dst_tile_classes(dst[p], src[p], w[p], self.b, tb,
                                      class_tiles)
               for p in range(self.k)]
        fills = (0, tb - 1, 0.0)           # src, local dst, weight pads
        dtypes = (np.int32, np.int32, np.float32)
        flats: list[list] = [[], [], []]
        classes = []
        for c, tc in enumerate(class_tiles):
            emax = max(x[c][0].shape[1] for x in per)
            classes.append((int(tc), int(emax)))
            for i in range(3):
                flats[i].append(np.stack([
                    np.pad(x[c][i], ((0, 0), (0, emax - x[c][i].shape[1])),
                           constant_values=fills[i]).astype(dtypes[i])
                    .reshape(-1) for x in per]))
        return tuple(np.concatenate(f, axis=1) for f in flats) \
            + (tuple(classes),)

    def ensure_pallas_tiles(self, tb: int = 256) -> "CommPlan":
        """Build the dst-tile layout of both edge families on first use:
        ``tb``-row tiles binned into degree-aligned classes
        (``tile_classes_from_buckets`` over ``ell_buckets``).  Pad edges
        carry weight 0 and local dst ``tb-1``."""
        if self.pallas_tb == tb and self.ptile_lsrc is not None:
            return self
        from ..ops.tile_spmm import tile_classes_from_buckets

        class_tiles = tile_classes_from_buckets(self.ell_buckets, self.b, tb)
        (self.ptile_lsrc, self.ptile_lld, self.ptile_lw,
         self.pallas_lclasses) = self._pallas_family(
            self.ledge_dst, self.ledge_src, self.ledge_w, tb, class_tiles)
        (self.ptile_hsrc, self.ptile_hld, self.ptile_hw,
         self.pallas_hclasses) = self._pallas_family(
            self.hedge_dst, self.hedge_src, self.hedge_w, tb, class_tiles)
        self.pallas_tb = tb
        return self

    def wire_rows_per_exchange(self, schedule: str = "a2a") -> int:
        """Padded rows the dense a2a puts on the wire per exchange over all
        parts: each ships its whole (k, S) buffer, k²·S rows in all."""
        if schedule != "a2a":
            raise ValueError(
                f"comm schedule {schedule!r} is not ported yet "
                "(only the dense 'a2a' exchange is)")
        rows, peers = np.asarray(self.send_counts).shape
        return int(rows * peers * self.s)

    # ------------------------------------------------------------------ stats
    def offwire_send_counts(self) -> np.ndarray:
        """``send_counts`` with each part's self-slot zeroed — the rows that
        actually leave a part."""
        off = self.send_counts.astype(np.int64).copy()
        np.fill_diagonal(off, 0)
        return off

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
    def scatter_rows(self, x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Global (n, f) row data → stacked per-part (k, B, f) padded blocks."""
        x = np.asarray(x)
        f = x.shape[1] if x.ndim > 1 else 1
        out = np.full((self.k, self.b, f), fill, dtype=x.dtype)
        out[self.owner, self.local_idx] = x.reshape(self.n, f)
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


def _split_edges(edge_dst, edge_src, edge_w, nnz, b, halo_fold_key=None):
    """Split padded (k, E) edge lists into local-src and halo-src lists.

    Local edges (``src < b``) keep their src; halo edges re-base src to the
    halo block (``src - b``).  ``halo_fold_key`` ((k, R) int, optional):
    each part's halo edges are re-sorted by (dst, fold, rank) — the
    reference's arrival-round order of the ragged ring, kept so the edge
    order (and the tile layout built from it) matches the reference.
    Padding edges carry dst ``b-1`` and weight 0.
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
    el = max(1, int(lnnz.max()) if k else 1)
    eh = max(1, int(hnnz.max()) if k else 1)
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
               row_order: str = "degree", tail_frac: float = 0.02,
               max_buckets: int = 6):
    """Bucketed-ELL layout of the local-src edge lists (see CommPlan):
    ``row_order='degree'`` takes the buckets of ``_choose_buckets``,
    ``'id'`` one bucket of the classic tail-bounded width."""
    k = ledge_dst.shape[0]
    degs = [np.bincount(ledge_dst[p, : int(lnnz[p])], minlength=b)
            for p in range(k)]
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
    tl = max(1, int(ltail_nnz.max()) if k else 1)
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
