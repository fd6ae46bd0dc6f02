"""Communication statistics in the reference's vocabulary (port of the
exact-mode subset of ``sgcn_tpu/utils/stats.py::CommStats``).

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

The stale, replica and partial-refresh fields of the reference are not
ported (ROADMAP A7): every exchange here is exposed.
"""

from __future__ import annotations

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
    wire_itemsize: int = 4                 # bytes per f32 lane, both ways
    halo_bytes_true_total: int = 0
    halo_bytes_wire_total: int = 0
    reverse_backward: bool = False         # the backward ships in reverse
    backward_exchanges: int = 0            # subset of ``exchanges``

    @classmethod
    def from_plan(cls, plan, schedule: str = "a2a", lane_widths: tuple = (),
                  wire_itemsize: int = 4) -> "CommStats":
        off = plan.offwire_send_counts()
        send_vol = plan.predicted_send_volume.astype(np.int64)
        send_msg = plan.predicted_message_count.astype(np.int64)
        recv_vol, recv_msg = off.sum(axis=0), (off > 0).sum(axis=0)
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
            reverse_backward=not plan.symmetric,
        )

    def _accumulate_bytes(self, fwd_sweeps: int, bwd_sweeps: int) -> None:
        """Advance the byte gauges by ``fwd_sweeps`` forward +
        ``bwd_sweeps`` backward sweeps (one exchange per layer each, at
        that layer's lane width)."""
        if not self.lane_widths:
            return
        factor = (sum(self.lane_widths) * self.wire_itemsize
                  * (fwd_sweeps + bwd_sweeps))
        self.halo_bytes_true_total += int(
            self.send_volume_per_exchange.sum()) * factor
        self.halo_bytes_wire_total += self.wire_rows_per_exchange * factor

    def count_step(self, nlayers: int) -> None:
        """One training step = ``nlayers`` forward + ``nlayers`` backward
        exchanges (the backward exchange mirrors the forward)."""
        self.exchanges += 2 * nlayers
        self.backward_exchanges += nlayers
        self._accumulate_bytes(1, 1)

    def count_forward(self, nlayers: int) -> None:
        self.exchanges += nlayers
        self._accumulate_bytes(1, 0)

    def cumulative(self) -> tuple:
        """Per-part cumulative (send_vol, send_msgs, recv_vol, recv_msgs);
        under ``reverse_backward`` the backward exchanges book each part's
        forward receive figures as its send ones and the other way
        round."""
        per = (self.send_volume_per_exchange, self.send_msgs_per_exchange,
               self.recv_volume_per_exchange, self.recv_msgs_per_exchange)
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
        """The 8-number line, the exposed/hidden split (all exposed here)
        and the padded-vs-true wire accounting, under the reference's
        keys."""
        rep = self.report_from_cumulative(*self.cumulative())
        per_ex = int(self.send_volume_per_exchange.sum())
        wire = self.wire_rows_per_exchange
        rep.update(
            exchanges=self.exchanges,
            exposed_exchanges=self.exchanges,
            hidden_exchanges=0,
            exposed_send_volume=per_ex * self.exchanges,
            hidden_send_volume=0,
            comm_schedule=self.schedule,
            true_rows_per_exchange=per_ex,
            wire_rows_per_exchange=wire,
            wire_rows_total=wire * self.exchanges,
            exposed_wire_rows_total=wire * self.exchanges,
            hidden_wire_rows_total=0,
            padding_efficiency=self.padding_efficiency,
        )
        if self.lane_widths:
            lane_b = sum(self.lane_widths) * 2 * self.wire_itemsize
            rep.update(
                halo_bytes_true_per_step=per_ex * lane_b,
                halo_bytes_wire_per_step=wire * lane_b,
                halo_bytes_true_total=self.halo_bytes_true_total,
                halo_bytes_wire_total=self.halo_bytes_wire_total,
            )
        return rep
