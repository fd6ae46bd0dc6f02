"""L-hop sub-graph serving: receptive sets, per-row recipes, compact
forwards (port of ``sgcn_tpu/serve/subgraph.py``).

The full-forward engine recomputes every part's rows for each micro-batch,
so a batch costs ``k·B·L`` computed rows whatever it asks.  A routed batch
of query vertices needs only their L-hop receptive rows, so this module
makes serving query-proportional:

  * :class:`SubgraphIndex` (built once per plan) re-expresses every part's
    per-row aggregation chains in GLOBAL row space.  The port's chains are
    its tile kernel's: a GCN row is the local family's slots (``ledge_*``,
    sources through ``global_row_ids``) then the halo family's
    (``hedge_*``, sources through ``halo_global_rows``), each in the
    stored order ``_pallas_family`` tiles; a GAT row is the combined list
    (``edge_dst``/``edge_src`` with 0/1 masks, sources through
    ``global_row_ids ‖ halo_global_rows``).  The halo family's order is
    the plan's, so one recipe serves the a2a exchange and the ring alike
    (ring == a2a bit for bit).  Only real slots (weight ≠ 0) are kept;
    they are also the adjacency the receptive sets walk.
  * :meth:`SubgraphIndex.receptive` computes, per part, the L-hop closed
    neighborhood of that part's routed queries (``VertexRouter.route``).
  * :func:`build_batch` lays out each part's receptive rows in a compact
    row space (rows by descending degree, then zero pad rows, the last one
    the all-zero dump row every out-of-set source and every tile pad slot
    reads), cuts the compact recipes into dst tiles with the plan's own
    tiling (``ops/tile_spmm.py::stack_tile_family``; GCN's two families
    share one ``class_tiles``, as the fused entry needs) and pads the row
    and query counts up the doubling ladder (``pad_pow2``), as the
    reference does, so a batch's tensors take one of few shapes.
  * :func:`subgraph_forward_gcn` / :func:`subgraph_forward_gat` run the
    compact forward over all ``k`` parts stacked, on the full forward's
    kernels — one fused-entry launch per GCN layer (local + halo chains,
    summed once), K5's mask entry per GAT pass — with no exchange: every
    source row a part needs is computed from features gathered for it.

**The contract.**  Each output element of the tile kernels is a serial
multiply-add chain in stored slot order that starts from +0, so a compact
row that carries exactly its real slots in the full plan's order repeats
the full row's chain: leaving out the weight-0 pad slots of the full tiles
(``acc + ±0 == acc`` on finite tables, and the chain never holds −0) is
exact.  The compact aggregation is therefore bit-identical to the full
one on the same table rows.  Dense projections run at another row count
than the full forward's ``k·B``; whether a GEMM returns the same bits for
a row at another ``M`` is the library's choice, so the whole-forward
contract is what PERF.md records as measured.  GAT's softmax stabilizer
``cg`` is a full-graph maximum: the engine computes it with one full
forward per weight or feature load (``gat_forward_local(
collect_stabilizers=True)``) and passes it in; pad rows' scores are pinned
to it so their ``exp`` stays 1.

Rows on a receptive set's outer shell are computed from incomplete
neighborhoods (their out-of-set sources read the dump row); no complete
row and no query reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.activations import get_activation
from ..models.gat import gat_table_form, score_project
from ..models.gcn import PROJECT_FIRST_MIN_FIN
from ..ops.tile_spmm import (MAX_CLASSES, gat_tiles_pass, spmm_tiles_fused,
                             stack_tile_family)
from .batcher import pad_pow2

def _csr_from_rows(n: int, rows, srcs, ws):
    """A global CSR from (row, src, w) triples, each row's entries kept in
    their given order (stable sort by row)."""
    order = np.argsort(rows, kind="stable")
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return ptr, srcs[order].astype(np.int64), ws[order].astype(np.float32)


def _take_rows(csr, rows):
    """``(counts, srcs, ws)`` of ``rows`` from a global CSR, each row's
    order kept, concatenated row after row."""
    ptr, src, w = csr
    cnt = ptr[rows + 1] - ptr[rows]
    tot = int(cnt.sum())
    flat = (np.repeat(ptr[rows], cnt)
            + np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    return cnt, src[flat], w[flat]


class SubgraphIndex:
    """Host-side per-row recipes in GLOBAL row space (one per plan):
    ``recipes`` holds one CSR ``(ptr, src, w)`` per tile family (GCN: local,
    halo; GAT: combined), ``adj`` the real-edge adjacency ``(ptr, src)``."""

    def __init__(self, plan, model: str = "gcn"):
        if model not in ("gcn", "gat"):
            raise ValueError(f"unknown model {model!r}")
        if model == "gcn" and not plan.symmetric:
            raise ValueError(
                "sub-graph serving reproduces the symmetric ELL fold "
                "(spmm_ell + halo-edge family); this plan is asymmetric — "
                "serve with the full-forward engine")
        self.model = model
        self.n = int(plan.n)
        self.k = int(plan.k)
        glob = plan.global_row_ids()                  # (k, B), −1 pad
        halo_glob = plan.halo_global_rows()           # (k, R), −1 pad
        if model == "gcn":
            fams = ((plan.ledge_dst, plan.ledge_src, plan.ledge_w, glob),
                    (plan.hedge_dst, plan.hedge_src, plan.hedge_w,
                     halo_glob))
        else:
            fams = ((plan.edge_dst, plan.edge_src,
                     (np.asarray(plan.edge_w) != 0).astype(np.float32),
                     np.concatenate([glob, halo_glob], axis=1)),)
        self.recipes = []
        adj_rows, adj_srcs = [], []
        for dst, src, w, src_map in fams:
            rows, srcs, ws = [], [], []
            for c in range(self.k):
                d, s, wc = (np.asarray(x[c]) for x in (dst, src, w))
                real = wc != 0                        # pads carry weight 0
                rows.append(glob[c][d[real]])
                srcs.append(src_map[c][s[real]])
                ws.append(wc[real])
            rows, srcs = np.concatenate(rows), np.concatenate(srcs)
            if len(rows) and min(rows.min(), srcs.min()) < 0:
                raise ValueError("a real edge of the plan names a pad row")
            self.recipes.append(_csr_from_rows(self.n, rows, srcs,
                                               np.concatenate(ws)))
            adj_rows.append(rows)
            adj_srcs.append(srcs)
        rows, srcs = np.concatenate(adj_rows), np.concatenate(adj_srcs)
        self.adj = _csr_from_rows(self.n, rows, srcs,
                                  np.zeros(len(srcs), np.float32))[:2]
        self.degree = np.diff(self.adj[0])            # real slots per row

    def receptive(self, qids, nhops: int) -> np.ndarray:
        """Sorted global ids of the ``nhops``-hop CLOSED neighborhood of
        ``qids`` (the rows an ``nhops``-layer forward for them touches)."""
        ptr, src = self.adj
        u = np.unique(np.asarray(qids, dtype=np.int64))
        for _ in range(nhops):
            cnt = ptr[u + 1] - ptr[u]
            tot = int(cnt.sum())
            if tot == 0:
                break
            flat = (np.repeat(ptr[u], cnt)
                    + np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
            u = np.unique(np.concatenate([u, src[flat]]))
        return u

    def edges_in(self, rows: np.ndarray) -> int:
        """Real recipe edges folded when computing ``rows`` (the per-batch
        aggregation-work gauge; pad slots excluded)."""
        return int(self.degree[rows].sum())


def compact_class_tiles(load) -> tuple:
    """Tile classes of a compact layout from each tile's slot load (rows by
    descending degree, so loads mostly fall): a new class starts where a
    tile needs at most half its class's first tile (floored at the 8
    slots ``build_dst_tile_classes`` gives a class at least), at most
    ``MAX_CLASSES`` classes."""
    out, head = [], 0
    for x in load:
        x = max(int(x), 8)
        if out and (2 * x > head or len(out) == MAX_CLASSES):
            out[-1] += 1
        else:
            out.append(1)
            head = x
    return tuple(out)


@dataclass
class SubgraphBatch:
    """One routed batch's compact layout (numpy, stacked over the ``k``
    parts) and its gauges.  ``gids``: ``(k, rows)`` global id of each
    compact row, −1 on pad rows and the dump row (the last);
    ``families``: per tile family ``(src, ld, w)`` flat arrays, with
    ``classes`` their tile classes (GCN: local, halo; GAT: combined)."""

    key: tuple                   # (model, padded queries, padded rows)
    gids: np.ndarray = None
    families: list = field(default_factory=list)
    classes: list = field(default_factory=list)
    tb: int = 256
    q_owner: np.ndarray = None   # (Qb,) −1 pad
    q_pos: np.ndarray = None     # (Qb,) compact row of each query
    nq: int = 0
    touched_rows: int = 0        # Σ_c |U_c| (true, unpadded)
    recipe_edges: int = 0        # Σ_c real edges folded
    per_chip_rows: tuple = ()

    def to_device(self, device) -> dict:
        """The batch's tensors on ``device``: ``gids`` (int64), ``valid``
        (float32 1/0 per compact row), the families as int32 / int32 /
        float32 (GCN) or int8 masks (GAT, as K5 takes them), ``q_owner``,
        ``q_pos`` (int64)."""
        mask = self.key[0] == "gat"
        fams = [tuple(torch.as_tensor(a).to(device) for a in (
            src, ld, w.astype(np.int8) if mask else w))
            for src, ld, w in self.families]
        return {"gids": torch.as_tensor(self.gids).to(device),
                "valid": torch.as_tensor(
                    (self.gids >= 0).astype(np.float32)).to(device),
                "families": fams,
                "q_owner": torch.as_tensor(self.q_owner).to(device),
                "q_pos": torch.as_tensor(self.q_pos).to(device)}


def build_batch(index: SubgraphIndex, router, qids, nhops: int,
                tb: int = 256, parts=None) -> SubgraphBatch:
    """Route ``qids``, take each part's ``nhops``-hop receptive set, lay
    out the compact rows and cut the compact recipes into tiles (module
    docstring).  ``parts`` (default: every part) selects the parts laid
    out, stacked in that order: a rank of a rank group builds its own
    part's alone (``ServeEngine(mesh=...)``).  ``q_owner`` is then each
    query's place in ``parts``, −1 for a query another part owns (its
    row is masked to zeros) and on padding."""
    qids = np.asarray(qids, dtype=np.int64).reshape(-1)
    owners, _ = router.lookup(qids)
    by_chip = router.route(qids)
    parts = list(range(index.k)) if parts is None else list(parts)
    k = len(parts)
    sets = [index.receptive(by_chip[c], nhops) if c in by_chip
            else np.zeros(0, np.int64) for c in parts]
    rows = pad_pow2(max(len(u) for u in sets) + 1)
    dump = rows - 1
    ntiles = -(-rows // tb)
    gids = np.full((k, rows), -1, np.int64)
    q_pos = np.zeros(pad_pow2(len(qids), 1), np.int64)
    # global id → compact row of the part at hand (the dump row outside
    # its set); reset after each part
    pos_map = np.full(index.n, dump, np.int64)
    lists = [[] for _ in index.recipes]
    loads = np.zeros((len(index.recipes), k, ntiles), np.int64)
    place = np.full(index.k, -1, np.int64)     # part → its place in parts
    place[parts] = np.arange(k)
    for c, u in enumerate(sets):
        # descending degree keeps each tile's rows alike, so its class
        # pads little; each row's own chain does not depend on its place
        cu = u[np.argsort(-index.degree[u], kind="stable")]
        gids[c, :len(cu)] = cu
        pos_map[cu] = np.arange(len(cu))
        mine = owners == parts[c]
        q_pos[:len(qids)][mine] = pos_map[qids[mine]]
        for f, csr in enumerate(index.recipes):
            cnt, srcs, ws = _take_rows(csr, cu)
            dst = np.repeat(np.arange(len(cu)), cnt)
            lists[f].append((dst, pos_map[srcs], ws))
            loads[f, c] = np.bincount(dst // tb, minlength=ntiles)
        pos_map[cu] = dump
    class_tiles = compact_class_tiles(loads.max(axis=1).sum(axis=0))
    families, classes = [], []
    for fam in lists:
        *arrays, cls = stack_tile_family(
            [x[0] for x in fam], [x[1] for x in fam], [x[2] for x in fam],
            rows, tb, class_tiles, src_fill=dump)
        families.append(tuple(arrays))
        classes.append(cls)
    q_owner = np.full(len(q_pos), -1, np.int64)
    q_owner[:len(qids)] = place[owners]
    return SubgraphBatch(
        key=(index.model, len(q_pos), rows), gids=gids, families=families,
        classes=classes, tb=tb, q_owner=q_owner, q_pos=q_pos, nq=len(qids),
        touched_rows=int(sum(len(u) for u in sets)),
        recipe_edges=int(sum(index.edges_in(u) for u in sets)),
        per_chip_rows=tuple(len(u) for u in sets))


# ---------------------------------------------------------------- forwards
def subgraph_forward_gcn(weights, h, fams, classes, tb: int,
                         activation: str = "relu",
                         final_activation: str = "none", halo_dtype=None):
    """Compact GCN forward over the stacked receptive sets, no exchange:
    ``gcn_forward_local``'s layer loop (project-first rule, activations)
    with each aggregation one fused-entry launch — the local family and
    the halo family both over the compact table ``x`` (the halo one over
    ``x`` in bf16 under ``halo_dtype``, the wire's rounding), summed once.
    ``h``: ``(k, rows, fin)``; ``fams``/``classes``: the batch's local and
    halo families on the device.  Returns ``(k, rows, nout)``."""
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(weights)
    for i, w in enumerate(weights):
        project_first = (w.shape[1] < h.shape[-1]
                         and h.shape[-1] >= PROJECT_FIRST_MIN_FIN)
        x = (h @ w) if project_first else h
        remote = x.to(torch.bfloat16) if halo_dtype is not None else x
        z = spmm_tiles_fused(fams[0], x, fams[1], remote, classes[0],
                             classes[1], tb)
        if not project_first:
            z = z @ w
        h = fact(z) if i == nl - 1 else act(z)
    return h


def compact_gat_aggregate(p, s, form, tiles, cclasses, tb: int):
    """Masked Σ of ``[p ‖ s]`` over each compact row's in-edges: the K5
    pass(es) of ``models/gat.py::_gat_tiles_aggregate`` over the compact
    combined tiles, with no exchange — ``'fused'`` one ``(fout+1)``-lane
    pass, ``'split'`` the feature and the scalar passes.  Returns
    ``(N (k, rows, fout), D (k, rows))`` float32."""
    rows, fout = p.shape[1], p.shape[2]
    if form == "fused":
        out = gat_tiles_pass(*tiles, torch.cat([p, s[..., None]], dim=-1),
                             cclasses, tb, rows)
        return out[..., :fout], out[..., fout]
    if form != "split":
        raise ValueError(f"sub-graph GAT serving takes the fused and split "
                         f"table forms (float32), not {form!r}")
    num = gat_tiles_pass(*tiles, p, cclasses, tb, rows)
    den = gat_tiles_pass(*tiles, s[..., None], cclasses, tb, rows)[..., 0]
    return num, den


def subgraph_forward_gat(params, cgs, h, valid, tiles, cclasses, tb: int,
                         activation: str = "none",
                         final_activation: str = "none"):
    """Compact GAT forward over the stacked receptive sets, no exchange and
    no global max: per layer ``z = h·w``, ``score_project``, pad rows'
    ``z2`` pinned to the stabilizer ``cgs[i]`` (so their ``u`` is 1 and
    never overflows into a masked gather), ``u = exp(z2 − cg)``, the K5
    pass(es) of ``gat_table_form``'s form, ``num / max(den, 1e-30)``.
    ``valid``: ``(k, rows)`` 1 on real rows; ``tiles``: the combined
    family (int8 masks).  Returns ``(k, rows, nout)``."""
    act = get_activation(activation)
    fact = get_activation(final_activation)
    nl = len(params)
    for i, p in enumerate(params):
        z = h @ p["w"]
        z2 = torch.where(valid > 0, score_project(z, p["a2"]), cgs[i])
        u = torch.exp(z2 - cgs[i])
        num, den = compact_gat_aggregate(u[..., None] * z, u,
                                         gat_table_form(z.shape[-1]), tiles,
                                         cclasses, tb)
        out = num / torch.clamp(den, min=1e-30)[..., None]
        h = fact(out) if i == nl - 1 else act(out)
    return h
