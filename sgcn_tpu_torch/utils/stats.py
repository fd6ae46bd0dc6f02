"""Communication statistics in the reference's vocabulary (port of
``sgcn_tpu/utils/stats.py::CommStats`` without its replica fields).

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
delta cache's float32 re-base on sync steps).  The replica and
partial-refresh fields of the reference are not ported (ROADMAP A7b).
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
    wire_itemsize: int = 4                 # bytes per f32 lane, forward
    wire_itemsize_bwd: int | None = None   # ... backward (None: forward's)
    halo_bytes_true_total: int = 0
    halo_bytes_wire_total: int = 0
    reverse_backward: bool = False         # the backward ships in reverse
    backward_exchanges: int = 0            # subset of ``exchanges``
    hidden_exchanges: int = 0              # stale-mode exchanges (subset)

    @classmethod
    def from_plan(cls, plan, schedule: str = "a2a", lane_widths: tuple = (),
                  wire_itemsize: int = 4,
                  wire_itemsize_bwd: int | None = None) -> "CommStats":
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
            wire_itemsize_bwd=(None if wire_itemsize_bwd is None
                               else int(wire_itemsize_bwd)),
            reverse_backward=not plan.symmetric,
        )

    def _bwd_itemsize(self) -> int:
        return (self.wire_itemsize if self.wire_itemsize_bwd is None
                else self.wire_itemsize_bwd)

    def _accumulate_bytes(self, fwd_sweeps: int, bwd_sweeps: int,
                          fwd_itemsize: int | None = None) -> None:
        """Advance the byte gauges by ``fwd_sweeps`` forward +
        ``bwd_sweeps`` backward sweeps (one exchange per layer each, at
        that layer's lane width and its direction's itemsize;
        ``fwd_itemsize`` overrides the forward's for this step)."""
        if not self.lane_widths:
            return
        fwd = self.wire_itemsize if fwd_itemsize is None else fwd_itemsize
        factor = sum(self.lane_widths) * (fwd * fwd_sweeps
                                          + self._bwd_itemsize() * bwd_sweeps)
        self.halo_bytes_true_total += int(
            self.send_volume_per_exchange.sum()) * factor
        self.halo_bytes_wire_total += self.wire_rows_per_exchange * factor

    def count_step(self, nlayers: int, hidden: bool = False,
                   wire_itemsize: int | None = None) -> None:
        """One training step = ``nlayers`` forward + ``nlayers`` backward
        exchanges (the backward exchange mirrors the forward).
        ``hidden=True`` books them as latency-hidden (a stale step);
        ``wire_itemsize`` overrides this step's forward wire itemsize
        (the halo-delta cache's float32 re-base on sync steps)."""
        self.exchanges += 2 * nlayers
        self.backward_exchanges += nlayers
        if hidden:
            self.hidden_exchanges += 2 * nlayers
        self._accumulate_bytes(1, 1, fwd_itemsize=wire_itemsize)

    def count_forward(self, nlayers: int) -> None:
        self.exchanges += nlayers
        self._accumulate_bytes(1, 0)

    # ----------------------------------------------------- checkpoint state
    # the reference's cumulative gauges (its ``_CUMULATIVE_ATTRS``), all
    # nine written so a port-written file restores cleanly there; the
    # replica and partial-refresh ones are not counted here (ROADMAP A7b)
    # and are written as 0.
    # ``backward_exchanges`` is not among them: the trainer re-derives it
    # from its step count (``FullBatchTrainer.restore_resume_state``).
    _CUMULATIVE_ATTRS = (
        "exchanges", "hidden_exchanges", "replica_exchanges",
        "hidden_replica_exchanges", "halo_bytes_true_total",
        "halo_bytes_wire_total", "partial_refresh_steps",
        "partial_refresh_rows_total", "partial_refresh_wire_rows_total")
    _COUNTED_ATTRS = ("exchanges", "hidden_exchanges",
                      "halo_bytes_true_total", "halo_bytes_wire_total")

    def state(self) -> dict:
        """JSON-able snapshot of the cumulative gauges."""
        return {a: int(getattr(self, a, 0)) for a in self._CUMULATIVE_ATTRS}

    def load_state(self, state: dict) -> None:
        """Restore ``state()`` onto a freshly built counter (``from_plan``
        already re-derived the per-exchange figures)."""
        for a in self._COUNTED_ATTRS:
            if a in state:
                setattr(self, a, int(state[a]))

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
        """The 8-number line, the exposed/hidden split and the
        padded-vs-true wire accounting, under the reference's keys.  The
        ``*_per_step`` byte keys describe the steady (stale) step; the
        ``*_total`` keys add each step at its own itemsizes."""
        rep = self.report_from_cumulative(*self.cumulative())
        per_ex = int(self.send_volume_per_exchange.sum())
        wire = self.wire_rows_per_exchange
        hidden = self.hidden_exchanges
        exposed = self.exchanges - hidden
        rep.update(
            exchanges=self.exchanges,
            exposed_exchanges=exposed,
            hidden_exchanges=hidden,
            exposed_send_volume=per_ex * exposed,
            hidden_send_volume=per_ex * hidden,
            comm_schedule=self.schedule,
            true_rows_per_exchange=per_ex,
            wire_rows_per_exchange=wire,
            wire_rows_total=wire * self.exchanges,
            exposed_wire_rows_total=wire * exposed,
            hidden_wire_rows_total=wire * hidden,
            padding_efficiency=self.padding_efficiency,
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
