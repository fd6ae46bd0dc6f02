"""The port's shard proxy against the reference's: one part's share of a
k-way plan on one device (``sgcn_tpu_torch/parallel/proxy.py`` vs
``sgcn_tpu/parallel/proxy.py``), on cora2708 under its 8-part hp
partition.

The reference-equal arrays of a slice must be EQUAL to the reference's
slice; the port-only flat indices follow their re-basing rules; every
``CommPlan`` field is classified.  The proxy's training steps run the
loopback exchange (receive slot ``q·S + t`` holds the part's own row
``send_idx[c, q, t]``), which is what the reference's size-1
``all_to_all`` delivers, so the two proxies train the same function; the
reference's proxy runs on a one-device mesh, where its k-fold gradient
(ROADMAP C3) is 1-fold, so no optimizer scale is needed.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.parallel import plan as ref_plan_mod
from sgcn_tpu.parallel.proxy import shard_proxy_data as ref_proxy_data
from sgcn_tpu.parallel.proxy import shard_proxy_plan as ref_proxy_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.utils.stats import CommStats as RefCommStats
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.ops.row_shuffle import row_pack
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.parallel.plan import (_GLOBAL_ARRAY_FIELDS,
                                          PER_CHIP_ARRAY_FIELDS,
                                          REBASED_ARRAY_FIELDS, CommPlan)
from sgcn_tpu_torch.parallel.proxy import (REBASE, shard_proxy_data,
                                           shard_proxy_plan)
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.train import FullBatchTrainer
from sgcn_tpu_torch.utils.stats import CommStats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
WIDTHS = [16, 7]
STEPS = 3


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    port = build_comm_plan(normalize_adjacency(a), pv, 8)
    ref = ref_build_comm_plan(ref_normalize(a), pv, 8)
    for p in (port, ref):
        p.ensure_pallas_tiles(256)
        p.ensure_ragged()
        p.ensure_pallas_ragged_tiles()
        p.ensure_pallas_cell_tiles(256)
        p.ensure_pallas_cell_ragged_tiles()
        p.ensure_replicas(64)
    port.ensure_exchange()
    port.ensure_transpose_tiles(256)      # port only: sliced too
    port.ensure_cell_transpose_tiles(256)
    return {"feats": feats, "labels": labels, "port": port, "ref": ref}


def test_per_chip_tuples_hold_the_references_members():
    """``PER_CHIP_ARRAY_FIELDS`` starts with the reference's members in
    its order, ``_GLOBAL_ARRAY_FIELDS`` is the reference's, and every
    field of the three tuples that the port has is a dataclass field."""
    ref = ref_plan_mod.PER_CHIP_ARRAY_FIELDS
    assert PER_CHIP_ARRAY_FIELDS[: len(ref)] == ref
    assert _GLOBAL_ARRAY_FIELDS == ref_plan_mod._GLOBAL_ARRAY_FIELDS
    names = {f.name for f in dataclasses.fields(CommPlan)}
    ported = [f for f in PER_CHIP_ARRAY_FIELDS if f in names]
    assert ported == list(PER_CHIP_ARRAY_FIELDS)     # redge_* included
    assert set(REBASED_ARRAY_FIELDS) <= names
    assert tuple(REBASE) == REBASED_ARRAY_FIELDS
    tuples = (set(PER_CHIP_ARRAY_FIELDS), set(_GLOBAL_ARRAY_FIELDS),
              set(REBASED_ARRAY_FIELDS))
    assert not any(a & b for i, a in enumerate(tuples)
                   for b in tuples[i + 1:])


@pytest.mark.parametrize("chip", [0, 5])
def test_reference_equal_arrays_equal_the_references_slice(cora, chip):
    """Every field both plans have and both slices carry is equal, array
    for array (the ``REBASED`` ones are port only), and the scalars and
    static tuples pass through."""
    port = shard_proxy_plan(cora["port"], chip)
    ref = ref_proxy_plan(cora["ref"], chip)
    assert port.k == ref.k == 1
    assert (port.b, port.s, port.r, port.e) == (ref.b, ref.s, ref.r, ref.e)
    np.testing.assert_array_equal(port.chip_ids, ref.chip_ids)
    compared = 0
    for f in dataclasses.fields(ref):
        a = getattr(port, f.name, None)
        b = getattr(ref, f.name)
        if a is None or b is None:
            continue
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            compared += 1
        elif f.name not in ("ell_k",):
            assert a == b, f.name
    assert compared >= 60
    np.testing.assert_array_equal(port.predicted_send_volume,
                                  ref.predicted_send_volume)
    np.testing.assert_array_equal(port.predicted_message_count,
                                  ref.predicted_message_count)
    assert port.predicted_send_volume[0] == \
        cora["port"].predicted_send_volume[chip]
    for sched in ("a2a", "ragged"):
        assert port.wire_rows_per_exchange(sched) == \
            ref.wire_rows_per_exchange(sched)
    st, rst = CommStats.from_plan(port), RefCommStats.from_plan(ref)
    for key in ("send_volume_per_exchange", "recv_volume_per_exchange",
                "send_msgs_per_exchange", "recv_msgs_per_exchange"):
        np.testing.assert_array_equal(getattr(st, key), getattr(rst, key))


@pytest.mark.parametrize("chip", [0, 3])
def test_rebased_fields_follow_their_rules(cora, chip):
    """The port-only flat indices of a slice, each against its rule
    computed here from the full plan: the loopback (receive slot
    ``q·S + t`` reads the own row ``send_idx[c, q, t]``, ring slot ``j``
    the own ``rsend_idx[c, j]``; a kept slot the own row of the shrunken
    send list at its shrunken slot, a replica slot's side channel the own
    baseline row ``ronly_base_pos`` names there, or on a pad of it a row
    past the part's own, which the slice adds where the part fills
    ``rs``: chip 0 with 64 replicas), the part's own entries of the flat
    lists, re-based."""
    full, k, s = cora["port"], cora["port"].k, cora["port"].s
    sl = shard_proxy_plan(full, chip)
    loop = full.send_idx[chip].reshape(-1)
    np.testing.assert_array_equal(sl.recv_src, loop[None])
    np.testing.assert_array_equal(sl.halo_src_flat, full.halo_src[chip:
                                                                  chip + 1])
    np.testing.assert_array_equal(sl.ring_src, full.rsend_idx[chip:
                                                              chip + 1])
    st = sum(full.rr_sizes)
    nst = full.nrep_ring_dst.shape[1]
    for kind, stride, nstride, sends in (
            ("recv", k * s, k * full.nrep_s,
             full.nrep_send_idx[chip].reshape(-1)),
            ("ring", st, nst, full.nrep_rsend_idx[chip])):
        dst = getattr(full, f"keep_{kind}_dst")
        mine = dst // stride == chip
        np.testing.assert_array_equal(getattr(sl, f"keep_{kind}_dst"),
                                      dst[mine] - chip * stride)
        nsrc = getattr(full, f"keep_n{kind}_src")
        np.testing.assert_array_equal(nsrc // nstride == chip, mine)
        np.testing.assert_array_equal(getattr(sl, f"keep_n{kind}_src"),
                                      nsrc[mine] - chip * nstride)
        np.testing.assert_array_equal(getattr(sl, f"keep_{kind}_src"),
                                      sends[nsrc[mine] - chip * nstride])
        rep = getattr(full, f"rep_{kind}_dst")
        np.testing.assert_array_equal(
            getattr(sl, f"rep_{kind}_dst"),
            rep[rep // stride == chip] - chip * stride)
    mine = full.rep_table_pos // full.rp == chip
    np.testing.assert_array_equal(sl.rep_table_pos,
                                  full.rep_table_pos[mine] - chip * full.rp)
    n_rep = int(full.rep_counts[chip])
    src = full.rep_recv_src[chip, :n_rep].astype(np.int64)
    real = src % full.ronly_s < full.ronly_send_counts[chip,
                                                       src // full.ronly_s]
    own = int(full.rep_row_counts[chip])
    base_rows = np.where(real, full.ronly_base_pos[chip].reshape(-1)[src],
                         own)
    np.testing.assert_array_equal(sl.rep_base_flat, base_rows)
    rows = full.rep_rows[chip] * (full.rep_row_valid[chip] > 0)
    np.testing.assert_array_equal(sl.rep_src_flat,
                                  np.append(rows, 0)[base_rows])
    spare = int(own == full.rs and not real.all())
    assert spare == (chip == 0) and sl.rep_base_rows == full.rs + spare
    np.testing.assert_array_equal(sl.rep_rows_flat[0, :full.rs], rows)
    np.testing.assert_array_equal(sl.rep_row_valid[0, :full.rs],
                                  full.rep_row_valid[chip])
    for f in ("rep_rows_flat", "rep_row_valid"):
        assert getattr(sl, f).shape == (1, sl.rep_base_rows), f
        assert not getattr(sl, f)[0, full.rs:].any(), f
    for f in ("rev_src", "rev_csrc"):   # the loopback's transpose
        np.testing.assert_array_equal(getattr(sl, f),
                                      np.arange(k * s)[None])
    for f in REBASED_ARRAY_FIELDS:
        assert getattr(sl, f).dtype == np.int32, f
    # the slice's tile sources index its own receive layouts
    assert sl.ptile_hwsrc.max() < k * s
    assert sl.ptile_hrsrc.max() < max(1, st)


def test_unclassified_stacked_field_fails_loudly(cora):
    """The reference's ``test_proxy_slicing_is_field_driven`` on the
    port's fields: every classified, built field carries the leading k
    axis, every dataclass array with a leading k axis is classified, and a
    new field that looks stacked but is not classified raises."""
    full = cora["port"]
    classified = (set(PER_CHIP_ARRAY_FIELDS) | set(_GLOBAL_ARRAY_FIELDS)
                  | set(REBASED_ARRAY_FIELDS))
    for f in dataclasses.fields(full):
        v = getattr(full, f.name)
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == full.k:
            assert f.name in classified, f.name
    for name in PER_CHIP_ARRAY_FIELDS:
        v = getattr(full, name, None)
        if v is not None:
            assert v.shape[0] == full.k, name

    @dataclasses.dataclass
    class RoguePlan(CommPlan):
        rogue_field: np.ndarray | None = None

    rogue = RoguePlan(
        **{f.name: getattr(full, f.name) for f in dataclasses.fields(full)},
        rogue_field=np.zeros((full.k, 3), dtype=np.float32))
    with pytest.raises(ValueError, match="not classified"):
        shard_proxy_plan(rogue, chip=1)


def test_slice_lacking_a_lazy_layout_raises(cora):
    """A layout built over every part is built on the full plan before
    slicing; asking a slice for one it lacks raises (the reference's
    ``ensure_ragged() BEFORE shard_proxy_plan``)."""
    a, _, _ = load_npz_dataset(os.path.join(FIX, "cora2708.npz"))
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    sl = shard_proxy_plan(build_comm_plan(normalize_adjacency(a), pv, 8), 2)
    assert sl.recv_src is not None and sl.ptile_lsrc is not None
    for call in (sl.ensure_ragged, sl.ensure_pallas_cell_tiles,
                 sl.ensure_transpose_tiles, lambda: sl.ensure_replicas(8)):
        with pytest.raises(ValueError, match="BEFORE shard_proxy_plan"):
            call()
    with pytest.raises(ValueError, match="BEFORE shard_proxy_plan"):
        FullBatchTrainer(sl, fin=8, widths=[4], comm_schedule="ragged",
                         device="cpu")
    with pytest.raises(ValueError, match="already a one-part slice"):
        shard_proxy_plan(sl, 0)
    with pytest.raises(ValueError, match="out of range"):
        shard_proxy_plan(cora["port"], 8)


def test_asymmetric_slice_stats_fail_loudly(cora):
    """``CommStats`` on an asymmetric slice refuses to make up receive
    counters, with the reference's message."""
    sl = dataclasses.replace(shard_proxy_plan(cora["port"], 0),
                             symmetric=False)
    ref = dataclasses.replace(ref_proxy_plan(cora["ref"], 0),
                              symmetric=False)
    with pytest.raises(ValueError, match="ASYMMETRIC") as got:
        CommStats.from_plan(sl)
    with pytest.raises(ValueError, match="ASYMMETRIC") as want:
        RefCommStats.from_plan(ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model,rtol", [("gcn", 1e-5), ("gat", 5e-5)])
def test_proxy_steps_track_the_references_proxy(cora, model, rtol):
    """Three a2a steps of chip 0's slice from the reference's initial
    weights: the port's losses within ``rtol`` of the reference proxy's
    (GCN 1e-5, GAT 5e-5: the attention's score reductions sum in another
    order), the weights after them within 1e-5 for 99 % of the entries;
    the slice's data is the reference's."""
    full, chip = cora["port"], 0
    feats, labels = cora["feats"], cora["labels"]
    ref_sl = ref_proxy_plan(cora["ref"], chip)
    ref = RefTrainer(ref_sl, fin=feats.shape[1], widths=WIDTHS, seed=4,
                     model=model, activation="relu")
    p0 = ([{k: np.asarray(v) for k, v in p.items()} for p in ref.params]
          if model == "gat" else [np.asarray(w) for w in ref.params])
    rdata = ref_proxy_data(cora["ref"], chip, feats, labels)
    ref_losses = [ref.step(rdata) for _ in range(STEPS)]
    data = shard_proxy_data(full, chip, feats, labels)
    np.testing.assert_array_equal(data.h0.numpy(), np.asarray(rdata.h0))
    np.testing.assert_array_equal(data.labels.numpy(),
                                  np.asarray(rdata.labels))
    tr = FullBatchTrainer(shard_proxy_plan(full, chip), fin=feats.shape[1],
                          widths=WIDTHS, model=model, activation="relu",
                          params=p0, comm_schedule="a2a", device="cpu")
    losses = [tr.step(data) for _ in range(STEPS)]
    print(f"{model} proxy losses {losses} vs reference {ref_losses}")
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    got = [p["w"] if isinstance(p, dict) else p for p in tr.params]
    want = [p["w"] if isinstance(p, dict) else p for p in ref.params]
    for g, w in zip(got, want):
        gap = np.abs(g.detach().numpy() - np.asarray(w))
        assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3


@pytest.mark.parametrize("mode", ["replica", "partial"])
def test_proxy_replica_steps_track_the_references_proxy(cora, mode):
    """A replica step's loopback is the SHRUNKEN exchange's (the
    reference proxy's size-1 collective delivers, at each kept slot, the
    part's own row of its shrunken send list), and the partial refresh's
    that of its side channel: four steps of chip 0's slice with 64
    replicas and ``sync_every=2`` (a refresh, a replica step, a refresh —
    partial under ``refresh_band`` — and a replica step) within rtol 1e-5
    of the reference's proxy."""
    full, chip = cora["port"], 0
    kw = dict(replica_budget=64, sync_every=2, comm_schedule="a2a")
    if mode == "partial":
        kw["refresh_band"] = 0.05
    ref = RefTrainer(ref_proxy_plan(cora["ref"], chip),
                     fin=cora["feats"].shape[1], widths=WIDTHS, seed=4,
                     activation="relu", **kw)
    p0 = [np.asarray(w) for w in ref.params]
    rdata = ref_proxy_data(cora["ref"], chip, cora["feats"], cora["labels"])
    want = [ref.step(rdata) for _ in range(4)]
    tr = FullBatchTrainer(shard_proxy_plan(full, chip),
                          fin=cora["feats"].shape[1], widths=WIDTHS,
                          params=p0, device="cpu", **kw)
    data = shard_proxy_data(full, chip, cora["feats"], cora["labels"])
    got = [tr.step(data) for _ in range(4)]
    print(f"{mode}: proxy {got} reference proxy {want}")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_slice_receive_layout_keeps_every_peers_bucket(cora):
    """A slice's a2a receive layout is ``(1, k·S)``: every peer's bucket
    (the loopback pack's rows), as its exchange writes it; a stale
    trainer's zero carries on it have that shape."""
    full = cora["port"]
    sl = shard_proxy_plan(full, 5)
    assert sl.recv_layout_shape("a2a") == (1, full.k * full.s)
    assert sl.recv_layout_shape("ragged") == (1, sum(full.rr_sizes))
    tr = FullBatchTrainer(sl, fin=cora["feats"].shape[1], widths=WIDTHS,
                          device="cpu", halo_staleness=1, halo_delta=True)
    for c in tr.halo_carry["halos"] + tr.halo_carry["ghalos"]:
        assert tuple(c.shape[:2]) == (1, full.k * full.s)


def test_loopback_pack_shape_and_count(cora, monkeypatch):
    """A proxy step's exchange is ONE row pack of ``k·S`` rows per
    aggregation (each of the forward's and the backward's): the loopback
    of the part's own sent rows, with the stacked plan's full receive
    window; on the ring one pack of ``ΣS_d`` rows."""
    import sgcn_tpu_torch.ops.pspmm as pspmm

    full = cora["port"]
    sl = shard_proxy_plan(full, 1)
    data = shard_proxy_data(full, 1, cora["feats"], cora["labels"])
    for sched, rows in (("a2a", full.k * full.s),
                        ("ragged", sum(full.rr_sizes))):
        packs = []

        def counting(src, flat, dtype=None):
            packs.append(tuple(flat.shape))
            return row_pack(src, flat, dtype)

        monkeypatch.setattr(pspmm, "row_pack", counting)
        tr = FullBatchTrainer(sl, fin=cora["feats"].shape[1], widths=WIDTHS,
                              comm_schedule=sched, device="cpu", seed=1)
        tr.step(data)
        # layer 0 projects first (1433 → 16), so both layers' backward
        # aggregations run: 2 forward + 2 backward
        assert packs == [(1, rows)] * 4, (sched, packs)
    monkeypatch.undo()
    recv = pspmm.exchange_recv(data.h0, torch.as_tensor(sl.recv_src))
    assert recv.shape == (1, full.k * full.s, data.h0.shape[-1])
    own = data.h0[0][torch.as_tensor(full.send_idx[1].reshape(-1)).long()]
    assert torch.equal(recv[0], own)


@pytest.mark.parametrize("mode", ["ragged", "stale", "replica", "bf16"])
def test_proxy_runs_the_stacked_modes(cora, mode):
    """The stacked trainer runs a slice unchanged in its other modes:
    three finite, falling GCN losses a mode (the ring, the stale halo,
    hot-halo replicas, the bf16 wire and compute dtype)."""
    full = cora["port"]
    kw = {"ragged": dict(comm_schedule="ragged"),
          "stale": dict(halo_staleness=1, sync_every=2),
          "replica": dict(replica_budget=64, sync_every=2),
          "bf16": dict(halo_dtype="bfloat16")}[mode]
    data = shard_proxy_data(full, 4, cora["feats"], cora["labels"])
    tr = FullBatchTrainer(shard_proxy_plan(full, 4), fin=1433,
                          widths=WIDTHS, device="cpu", seed=2, **kw)
    losses = [tr.step(data) for _ in range(STEPS)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    if mode != "replica":       # a replica step books the shrunken wire
        assert tr.stats.report()["total_send_volume"] == \
            STEPS * 2 * len(WIDTHS) * int(full.predicted_send_volume[4])

