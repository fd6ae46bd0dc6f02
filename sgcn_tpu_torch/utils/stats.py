"""Communication statistics in the reference's vocabulary (port of
``sgcn_tpu/utils/stats.py::CommStats``).

Per part, ``send/recv_comm_volume`` (feature rows shipped) and
``send/recv_message_count``, summed and maxed over parts into one
end-of-run line.  Under the static plan the per-exchange volume is
known at plan time, so the counters advance per step by the reference's
rule: a training step books ``nlayers`` forward and ``nlayers`` backward
exchanges, a forward (evaluation) ``nlayers``.  The rule is kept even for
a layer whose backward exchange never runs (an aggregate-first first
layer has no input gradient), so the counters equal the reference's.
On a symmetric Â the backward ships the gradient's rows the forward's
way; on an asymmetric one (``reverse_backward``) it ships the halo rows'
partials back to their owners — the same rows in reverse — so each
part's backward send volume and messages are its forward receive ones
and the other way round.  The totals are the same either way; the
reference books its asymmetric backward the forward's way, so its
per-part maxima can differ from these.

A stale-mode step (``count_step(hidden=True)``) books its exchanges as
hidden (no same-step consumer) and the exposed/hidden split prices them
apart; the feature and gradient wires have their own itemsizes
(``wire_itemsize``/``wire_itemsize_bwd``: the halo-delta cache narrows
only the feature wire), and a step may override the feature wire's (the
delta cache's float32 re-base on sync steps).  Under hot-halo replicas
(``set_replica``) a replica step books its exchanges at the shrunken
exchange's figures (``count_step(replica=True)``; a composed replica ×
stale step is both hidden and replica), and a partial refresh step adds
its side channel at the rows it really shipped
(``count_partial_refresh_step``), with the reference's figures.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass
class CommStats:
    k: int
    send_volume_per_exchange: np.ndarray   # (k,) boundary rows per exchange
    send_msgs_per_exchange: np.ndarray     # (k,) non-empty peer messages
    recv_volume_per_exchange: np.ndarray   # (k,)
    recv_msgs_per_exchange: np.ndarray     # (k,)
    exchanges: int = 0                     # cumulative halo exchanges
    schedule: str = "a2a"
    wire_rows_per_exchange: int = 0        # padded rows on the wire (k²·S)
    padding_efficiency: float = 1.0        # true / wire rows
    # per-layer wire lane widths (the project-first exchange widths); with
    # them set, report() carries the byte gauges
    lane_widths: tuple = ()
    wire_itemsize: int = 4                 # bytes per f32 lane, forward
    wire_itemsize_bwd: int | None = None   # ... backward (None: forward's)
    halo_bytes_true_total: int = 0
    halo_bytes_wire_total: int = 0
    reverse_backward: bool = False         # the backward ships in reverse
    backward_exchanges: int = 0            # subset of ``exchanges``
    hidden_exchanges: int = 0              # stale-mode exchanges (subset)
    # hot-halo replicas (``set_replica``): the shrunken exchange's figures
    # and the exchanges booked at them
    replica_send_volume_per_exchange: np.ndarray | None = None  # (k,)
    replica_recv_volume_per_exchange: np.ndarray | None = None  # (k,)
    replica_send_msgs_per_exchange: np.ndarray | None = None    # (k,)
    replica_recv_msgs_per_exchange: np.ndarray | None = None    # (k,)
    replica_wire_rows_per_exchange: int | None = None
    replica_rows: int = 0
    replica_exchanges: int = 0             # subset of ``exchanges``
    hidden_replica_exchanges: int = 0      # ... also hidden (composed)
    # the partial refresh's side channel, at the rows really shipped
    partial_refresh_steps: int = 0
    partial_refresh_rows_total: int = 0        # true rows, fwd + bwd
    partial_refresh_wire_rows_total: int = 0   # padded side-channel rows

    @classmethod
    def from_plan(cls, plan, schedule: str = "a2a", lane_widths: tuple = (),
                  wire_itemsize: int = 4,
                  wire_itemsize_bwd: int | None = None) -> "CommStats":
        off = plan.offwire_send_counts()
        send_vol = plan.predicted_send_volume.astype(np.int64)
        send_msg = plan.predicted_message_count.astype(np.int64)
        if off.shape[0] == off.shape[1]:
            recv_vol, recv_msg = off.sum(axis=0), (off > 0).sum(axis=0)
        elif not plan.symmetric:
            # a one-part slice (parallel/proxy.py): the peers' sends are
            # out of view, and only a symmetric pattern receives what it
            # sends — anything else would fabricate the receive counters
            raise ValueError(
                "CommStats.from_plan: shard-proxy slice of an ASYMMETRIC "
                "plan — peers' sends are out of view and per-chip recv "
                "!= send, so recv counters cannot be derived; proxy a "
                "symmetric plan or build stats from the full plan")
        else:
            recv_vol, recv_msg = send_vol, send_msg
        wire = int(plan.wire_rows_per_exchange(schedule))
        true = int(send_vol.sum())
        return cls(
            k=plan.k,
            send_volume_per_exchange=send_vol,
            send_msgs_per_exchange=send_msg,
            recv_volume_per_exchange=recv_vol,
            recv_msgs_per_exchange=recv_msg,
            schedule=schedule,
            wire_rows_per_exchange=wire,
            padding_efficiency=(true / wire if wire else 1.0),
            lane_widths=tuple(int(w) for w in lane_widths),
            wire_itemsize=int(wire_itemsize),
            wire_itemsize_bwd=(None if wire_itemsize_bwd is None
                               else int(wire_itemsize_bwd)),
            reverse_backward=not plan.symmetric,
        )

    @classmethod
    def from_slice(cls, plan, **kw) -> "CommStats":
        """``from_plan`` for a one-part slice of an ASYMMETRIC plan (port
        only; ``from_plan`` refuses it with the reference's message): the
        send counters are the slice's own, and the receive ones are read
        off its halo layout — each halo row arrives once, so the rows
        received are its ``halo_counts`` and the messages the peers its
        ``halo_src`` slots name (``q·S + t`` comes from part ``q``): what
        the full plan's column for the part holds."""
        if plan.chip_ids is None or plan.symmetric:
            raise ValueError("CommStats.from_slice takes a one-part slice of "
                             "an asymmetric plan; use from_plan")
        # the send side as a symmetric slice's, then the receive side
        sym = cls.from_plan(dataclasses.replace(plan, symmetric=True), **kw)
        hc = int(plan.halo_counts[0])
        peers = np.unique(np.asarray(plan.halo_src[0, :hc]) // plan.s)
        sym.recv_volume_per_exchange = np.array([hc], np.int64)
        sym.recv_msgs_per_exchange = np.array([peers.size], np.int64)
        sym.reverse_backward = True
        return sym

    def set_replica(self, plan) -> None:
        """Record the shrunken exchange's figures of a plan with the
        replica layout (``CommPlan.ensure_replicas``);
        ``count_step(replica=True)`` books at them."""
        if plan.nrep_send_counts is None:
            raise ValueError(
                "CommStats.set_replica needs the plan's replication layout "
                "(ensure_replicas)")
        counts = plan.nrep_send_counts.astype(np.int64)
        self.replica_send_volume_per_exchange = counts.sum(axis=1)
        self.replica_send_msgs_per_exchange = (counts > 0).sum(axis=1)
        # a one-part slice receives what it sends (symmetric, from_plan)
        recv = counts if counts.shape[0] == counts.shape[1] else counts.T
        self.replica_recv_volume_per_exchange = recv.sum(axis=0)
        self.replica_recv_msgs_per_exchange = (recv > 0).sum(axis=0)
        self.replica_wire_rows_per_exchange = int(
            plan.wire_rows_per_exchange(self.schedule, replica=True))
        self.replica_rows = int(plan.replica_rows)

    def _bwd_itemsize(self) -> int:
        return (self.wire_itemsize if self.wire_itemsize_bwd is None
                else self.wire_itemsize_bwd)

    def _accumulate_bytes(self, fwd_sweeps: int, bwd_sweeps: int,
                          fwd_itemsize: int | None = None,
                          replica: bool = False) -> None:
        """Advance the byte gauges by ``fwd_sweeps`` forward +
        ``bwd_sweeps`` backward sweeps (one exchange per layer each, at
        that layer's lane width and its direction's itemsize;
        ``fwd_itemsize`` overrides the forward's for this step;
        ``replica``: at the shrunken exchange's figures)."""
        if not self.lane_widths:
            return
        fwd = self.wire_itemsize if fwd_itemsize is None else fwd_itemsize
        factor = sum(self.lane_widths) * (fwd * fwd_sweeps
                                          + self._bwd_itemsize() * bwd_sweeps)
        if replica:
            per_true = int(self.replica_send_volume_per_exchange.sum())
            wire = self.replica_wire_rows_per_exchange
        else:
            per_true = int(self.send_volume_per_exchange.sum())
            wire = self.wire_rows_per_exchange
        self.halo_bytes_true_total += per_true * factor
        self.halo_bytes_wire_total += wire * factor

    def count_step(self, nlayers: int, hidden: bool = False,
                   wire_itemsize: int | None = None,
                   replica: bool = False) -> None:
        """One training step = ``nlayers`` forward + ``nlayers`` backward
        exchanges (the backward exchange mirrors the forward).
        ``hidden=True`` books them as latency-hidden (a stale step);
        ``wire_itemsize`` overrides this step's forward wire itemsize
        (the halo-delta cache's float32 re-base on sync steps);
        ``replica=True`` books them at the shrunken exchange's figures
        (``set_replica`` first): a replica step, or with ``hidden`` a
        composed replica × stale step."""
        if replica and self.replica_send_volume_per_exchange is None:
            raise ValueError(
                "count_step(replica=True) before set_replica()")
        self.exchanges += 2 * nlayers
        self.backward_exchanges += nlayers
        if hidden:
            self.hidden_exchanges += 2 * nlayers
        if replica:
            self.replica_exchanges += 2 * nlayers
        if hidden and replica:
            self.hidden_replica_exchanges += 2 * nlayers
        self._accumulate_bytes(1, 1, fwd_itemsize=wire_itemsize,
                               replica=replica)

    def count_partial_refresh_step(self, nlayers: int, refresh_rows,
                                   wire_rows: int) -> None:
        """One partial refresh step: the shrunken exchange (as
        ``count_step(replica=True)``) plus the side channel — one more
        exchange per layer and direction of ``wire_rows`` padded rows, of
        which ``refresh_rows[ℓ]`` carried a drifted row; the gradient's
        side channel ships one more 0/1 indicator lane."""
        refresh_rows = [int(x) for x in refresh_rows]
        if len(refresh_rows) != nlayers:
            raise ValueError(
                f"count_partial_refresh_step: {len(refresh_rows)} per-layer "
                f"row counts for {nlayers} layers")
        self.count_step(nlayers=nlayers, replica=True)
        self.partial_refresh_steps += 1
        self.partial_refresh_rows_total += 2 * sum(refresh_rows)
        self.partial_refresh_wire_rows_total += 2 * nlayers * int(wire_rows)
        if self.lane_widths:
            fwd, bwd = self.wire_itemsize, self._bwd_itemsize()
            for rows, lane in zip(refresh_rows, self.lane_widths):
                self.halo_bytes_true_total += rows * lane * (fwd + bwd)
                self.halo_bytes_wire_total += int(wire_rows) * (
                    lane * fwd + (lane + 1) * bwd)

    def count_forward(self, nlayers: int) -> None:
        self.exchanges += nlayers
        self._accumulate_bytes(1, 0)

    # ----------------------------------------------------- checkpoint state
    # the reference's cumulative gauges (its ``_CUMULATIVE_ATTRS``).
    # ``backward_exchanges`` is not among them: the trainer re-derives it
    # from its step count (``FullBatchTrainer.restore_resume_state``).
    _CUMULATIVE_ATTRS = (
        "exchanges", "hidden_exchanges", "replica_exchanges",
        "hidden_replica_exchanges", "halo_bytes_true_total",
        "halo_bytes_wire_total", "partial_refresh_steps",
        "partial_refresh_rows_total", "partial_refresh_wire_rows_total")

    def state(self) -> dict:
        """JSON-able snapshot of the cumulative gauges."""
        return {a: int(getattr(self, a)) for a in self._CUMULATIVE_ATTRS}

    def load_state(self, state: dict) -> None:
        """Restore ``state()`` onto a freshly built counter (``from_plan``
        and ``set_replica`` already re-derived the per-exchange
        figures)."""
        for a in self._CUMULATIVE_ATTRS:
            if a in state:
                setattr(self, a, int(state[a]))

    def cumulative(self) -> tuple:
        """Per-part cumulative (send_vol, send_msgs, recv_vol, recv_msgs);
        replica-booked exchanges advance at the shrunken figures; under
        ``reverse_backward`` the backward exchanges book each part's
        forward receive figures as its send ones and the other way
        round (no replica mode runs on such a plan)."""
        per = (self.send_volume_per_exchange, self.send_msgs_per_exchange,
               self.recv_volume_per_exchange, self.recv_msgs_per_exchange)
        if self.replica_exchanges:
            rep = (self.replica_send_volume_per_exchange,
                   self.replica_send_msgs_per_exchange,
                   self.replica_recv_volume_per_exchange,
                   self.replica_recv_msgs_per_exchange)
            full = self.exchanges - self.replica_exchanges
            return tuple(p * full + rp * self.replica_exchanges
                         for p, rp in zip(per, rep))
        if not self.reverse_backward:
            return tuple(p * self.exchanges for p in per)
        fwd, bwd = self.exchanges - self.backward_exchanges, \
            self.backward_exchanges
        return tuple(p * fwd + r * bwd
                     for p, r in zip(per, per[2:] + per[:2]))

    @staticmethod
    def report_from_cumulative(sv, sm, rv, rm) -> dict:
        # the reference's 8-number line: SUM and MAX over parts
        return {
            "total_send_volume": int(sv.sum()),
            "max_send_volume": int(sv.max()) if sv.size else 0,
            "total_send_msgs": int(sm.sum()),
            "max_send_msgs": int(sm.max()) if sm.size else 0,
            "total_recv_volume": int(rv.sum()),
            "max_recv_volume": int(rv.max()) if rv.size else 0,
            "total_recv_msgs": int(rm.sum()),
            "max_recv_msgs": int(rm.max()) if rm.size else 0,
        }

    def report(self) -> dict:
        """The 8-number line, the exposed/hidden split and the
        padded-vs-true wire accounting, under the reference's keys.  The
        ``*_per_step`` byte keys describe the steady (stale) step; the
        ``*_total`` keys add each step at its own itemsizes."""
        rep = self.report_from_cumulative(*self.cumulative())
        per_ex = int(self.send_volume_per_exchange.sum())
        wire = self.wire_rows_per_exchange
        hidden = self.hidden_exchanges
        exposed = self.exchanges - hidden
        # each (exposed/hidden) × (full/replica) subset at its own figure
        rex, hrex = self.replica_exchanges, self.hidden_replica_exchanges
        erex = rex - hrex
        per_ex_rep = (int(self.replica_send_volume_per_exchange.sum())
                      if rex else per_ex)
        rep_wire = (self.replica_wire_rows_per_exchange
                    if rex else wire)
        pwire = self.partial_refresh_wire_rows_total
        rep.update(
            exchanges=self.exchanges,
            exposed_exchanges=exposed,
            hidden_exchanges=hidden,
            exposed_send_volume=per_ex * (exposed - erex) + per_ex_rep * erex,
            hidden_send_volume=per_ex * (hidden - hrex) + per_ex_rep * hrex,
            comm_schedule=self.schedule,
            true_rows_per_exchange=per_ex,
            wire_rows_per_exchange=wire,
            wire_rows_total=(wire * (self.exchanges - rex) + rep_wire * rex
                             + pwire),
            exposed_wire_rows_total=(wire * (exposed - erex)
                                     + rep_wire * erex + pwire),
            hidden_wire_rows_total=wire * (hidden - hrex) + rep_wire * hrex,
            padding_efficiency=self.padding_efficiency,
        )
        if self.replica_wire_rows_per_exchange is not None:
            rep.update(
                replica_exchanges=rex,
                hidden_replica_exchanges=hrex,
                replica_rows=self.replica_rows,
                true_rows_per_exchange_replica=int(
                    self.replica_send_volume_per_exchange.sum()),
                wire_rows_per_exchange_replica=(
                    self.replica_wire_rows_per_exchange),
            )
        if self.partial_refresh_steps:
            rep.update(
                partial_refresh_steps=self.partial_refresh_steps,
                partial_refresh_rows_total=self.partial_refresh_rows_total,
                partial_refresh_wire_rows_total=pwire,
            )
        if self.lane_widths:
            lane_b = sum(self.lane_widths) * (self.wire_itemsize
                                              + self._bwd_itemsize())
            rep.update(
                halo_bytes_true_per_step=per_ex * lane_b,
                halo_bytes_wire_per_step=wire * lane_b,
                halo_bytes_true_total=self.halo_bytes_true_total,
                halo_bytes_wire_total=self.halo_bytes_wire_total,
            )
        return rep

    @staticmethod
    def merged_report(stats_list) -> dict:
        """One report over many counters (one per mini-batch plan), as one
        rank of the reference accumulates across batches: per-part sums
        first, then the sums and maxima over parts.  Each counter's
        per-exchange volumes and wire rows are its own plan's, so the
        exposed/hidden split and the wire totals sum per counter; the
        padding efficiency is the cumulative true / wire ratio.  The
        reference's keys and arithmetic."""
        parts = [s.cumulative() for s in stats_list]
        sums = [np.sum([p[i] for p in parts], axis=0) for i in range(4)]
        rep = CommStats.report_from_cumulative(*sums)
        exchanges = sum(s.exchanges for s in stats_list)
        hidden = sum(s.hidden_exchanges for s in stats_list)
        schedules = {s.schedule for s in stats_list} or {"a2a"}
        wire_total = sum(
            s.wire_rows_per_exchange * (s.exchanges - s.replica_exchanges)
            + (s.replica_wire_rows_per_exchange or 0) * s.replica_exchanges
            + s.partial_refresh_wire_rows_total
            for s in stats_list)

        def split_vol(s, hidden_side: bool) -> int:
            # (exposed/hidden) × (full/replica-booked), each subset at its
            # own per-exchange volume, as a single report() prices them
            per = int(s.send_volume_per_exchange.sum())
            per_rep = (int(s.replica_send_volume_per_exchange.sum())
                       if s.replica_exchanges else per)
            hrex = s.hidden_replica_exchanges
            if hidden_side:
                return per * (s.hidden_exchanges - hrex) + per_rep * hrex
            erex = s.replica_exchanges - hrex
            return per * (s.exchanges - s.hidden_exchanges - erex) \
                + per_rep * erex

        rep.update(
            exchanges=exchanges,
            exposed_exchanges=exchanges - hidden,
            hidden_exchanges=hidden,
            exposed_send_volume=sum(split_vol(s, False) for s in stats_list),
            hidden_send_volume=sum(split_vol(s, True) for s in stats_list),
            comm_schedule=(schedules.pop() if len(schedules) == 1
                           else "mixed"),
            wire_rows_total=wire_total,
            padding_efficiency=(rep["total_send_volume"] / wire_total
                                if wire_total else 1.0),
        )
        if any(s.lane_widths for s in stats_list):
            rep.update(
                halo_bytes_true_total=sum(
                    s.halo_bytes_true_total for s in stats_list),
                halo_bytes_wire_total=sum(
                    s.halo_bytes_wire_total for s in stats_list),
            )
        return rep
