"""Multi-process launch: the rendezvous of one process per part (port of
``sgcn_tpu/parallel/launch.py``).

Reference equivalents: the SLURM rendezvous plumbing — ``MASTER_ADDR`` /
``MASTER_PORT`` derived from the job id and nodelist, ``WORLD_SIZE`` =
nodes × tasks (``GPU/pytorch.3node.slurm:46-56``), consumed by
``dist.init_process_group`` through ``SLURM_NPROCS``/``SLURM_PROCID``
(``GPU/PGCN.py:241-260``).

Here one process drives one card (one NCCL rank per card, ROADMAP "Rank
layout"), and ``init_distributed`` opens the port's rank group
(``parallel/mesh.py::init_rank_group``) from whatever launched the
process::

    ctx = init_distributed()            # once per process, before use
    mesh = global_mesh_1d(k)            # the RankGroup (None: one process)
    trainer = FullBatchTrainer(plan, fin, widths, mesh=mesh)
    data = make_train_data_multihost(plan, mesh, features, labels)

``torchrun --nproc_per_node G -m sgcn_tpu_torch.train ... -s K`` on each
of ``K/G`` nodes, or ``srun`` under ``launch/gpu.slurm``, launches the
train CLI this way.  NCCL on ``cuda:<local rank>``; gloo only when the
caller asks for the CPU (``device='cpu'``, the tests' ranks).  There is
no fallback from NCCL to gloo, nor from the card to the CPU.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import RankGroup, init_rank_group

# rendezvous robustness: how long ONE attempt may wait for all peers
# before it is declared stalled, and the backoff before the single retry.
# A transiently late peer (a node still booting, a container being
# rescheduled) is routine on a shared cluster; one retry absorbs it, and a
# peer that misses both attempts gets a clear error instead of a hang.
RENDEZVOUS_TIMEOUT_S = 300.0
RENDEZVOUS_BACKOFF_S = 5.0

# the failure texts a timed-out rendezvous raises (the store's or the
# collective's), as opposed to a bad address, a bound port or a refusal
_STALL_WORDS = ("timed out", "timeout", "deadline", "unavailable")


def _initialize_with_retry(heartbeat, detail: str, coordinator,
                           **kwargs) -> RankGroup:
    """``init_rank_group(**kwargs)`` under an explicit per-attempt
    timeout (``$SGCN_RENDEZVOUS_TIMEOUT``) with ONE retry after
    ``$SGCN_RENDEZVOUS_BACKOFF`` seconds.  Heartbeats mark every
    transition (``rendezvous:start|done|stalled|error|failed``), so an
    operator watching the run directory sees which attempt is in flight.
    A half-made group is destroyed before the retry.  ``coordinator``
    names the rendezvous address in the failure message."""
    timeout = float(os.environ.get("SGCN_RENDEZVOUS_TIMEOUT",
                                   str(RENDEZVOUS_TIMEOUT_S)))
    backoff = float(os.environ.get("SGCN_RENDEZVOUS_BACKOFF",
                                   str(RENDEZVOUS_BACKOFF_S)))
    kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    for attempt in (1, 2):
        heartbeat("rendezvous:start", phase="init_distributed",
                  detail=f"attempt {attempt}/2, {detail}, "
                         f"timeout {timeout:.0f}s")
        try:
            group = init_rank_group(**kwargs)
            heartbeat("rendezvous:done", phase="init_distributed",
                      detail=f"attempt {attempt}/2")
            return group
        except Exception as e:           # noqa: BLE001 — classified below
            # only a timeout-shaped failure is evidence of a STALLED peer;
            # blaming a peer for a bad address or a bound port sends the
            # operator to the wrong place
            text = str(e).lower()
            stall_like = any(t in text for t in _STALL_WORDS)
            if attempt == 2:
                heartbeat("rendezvous:failed", phase="init_distributed",
                          detail=str(e)[-200:])
                cause = (
                    f"a peer stalled past the {timeout:.0f}s timeout on "
                    "both attempts, or the coordinator is unreachable — "
                    "check that every host in the job is up and can reach "
                    f"{coordinator or 'the coordinator'} "
                    "($SGCN_RENDEZVOUS_TIMEOUT / _BACKOFF tune the "
                    "attempt budget)" if stall_like else
                    "NOT a timeout — likely local configuration (bad "
                    "coordinator address, port already bound, auth)")
                raise RuntimeError(
                    f"rendezvous failed twice ({detail}): {cause}; "
                    f"underlying error: {e}") from e
            heartbeat("rendezvous:stalled" if stall_like
                      else "rendezvous:error",
                      phase="init_distributed",
                      detail=f"attempt 1 failed ({str(e)[-120:]}); "
                             f"retrying in {backoff:.0f}s")
            # a group left half made would refuse the second
            # init_process_group outright
            if dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except Exception:       # noqa: BLE001 — nothing to destroy
                    pass
            time.sleep(backoff)


@dataclass
class DistributedContext:
    """What ``init_distributed`` resolved, under the reference's field
    names: ``process_id`` (the rank), ``num_processes`` (the world size),
    ``coordinator`` (``host:port``, or ``None`` without a rendezvous),
    ``local_devices`` (the devices this process drives: 1) and
    ``global_devices`` (one per rank).  Beside them: ``local_rank`` and
    ``local_world`` (the ranks on this node), ``device`` (where the rank
    runs) and ``group`` (the ``RankGroup``; ``None`` for one process)."""

    process_id: int
    num_processes: int
    coordinator: str | None
    local_devices: int
    global_devices: int
    local_rank: int = 0
    local_world: int = 1
    device: torch.device | None = None
    group: RankGroup | None = None

    @property
    def is_coordinator(self) -> bool:
        """Rank-0 check — all end-of-run printing is rank-0-only in the
        reference (``GPU/PGCN.py:230-238``)."""
        return self.process_id == 0

    def close(self) -> None:
        """Destroy the process group, if one was opened (every rank)."""
        if self.group is not None:
            self.group.close()


_CONTEXT: list = [None]          # the process's last init_distributed


def slurm_rendezvous_env() -> tuple[str, int, int] | None:
    """Derive (coordinator, num_processes, process_id) from SLURM variables,
    mirroring the reference's launcher arithmetic
    (``GPU/pytorch.3node.slurm:46-56``: port = 10000 + last 4 digits of the
    job id; master = first node of the nodelist — here the caller passes the
    resolved hostname via ``SGCN_COORDINATOR`` or ``MASTER_ADDR``)."""
    nprocs = os.environ.get("SLURM_NPROCS")
    procid = os.environ.get("SLURM_PROCID")
    if nprocs is None or procid is None:
        return None
    addr = (os.environ.get("SGCN_COORDINATOR")
            or os.environ.get("MASTER_ADDR"))
    if addr is None:
        return None
    port = os.environ.get("MASTER_PORT")
    if port is None:
        # array/het job ids like "1234_5" contain non-digits; keep the
        # digits so the port stays derivable instead of crashing startup
        jobid = "".join(c for c in os.environ.get("SLURM_JOBID", "0")
                        if c.isdigit())
        port = str(10000 + int(jobid[-4:] or "0"))
    return f"{addr}:{port}", int(nprocs), int(procid)


def torchrun_env() -> tuple[str, int, int, int, int] | None:
    """``(coordinator, world size, rank, local rank, local world size)``
    from the variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_WORLD_SIZE``
    where set), or ``None`` when they are absent."""
    env = os.environ
    if any(env.get(v) is None for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                        "MASTER_PORT")):
        return None
    world = int(env["WORLD_SIZE"])
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world,
            int(env["RANK"]), int(env.get("LOCAL_RANK", "0")),
            int(env.get("LOCAL_WORLD_SIZE", str(world))))


def _slurm_local() -> tuple[int, int]:
    """``(local rank, ranks on this node)`` under SLURM."""
    env = os.environ
    local = int(env.get("SLURM_LOCALID", "0"))
    per_node = env.get("SLURM_NTASKS_PER_NODE", "").split("(")[0]
    nodes = int(env.get("SLURM_NNODES", "1") or 1)
    if per_node.isdigit():
        return local, int(per_node)
    return local, -(-int(env["SLURM_NPROCS"]) // max(nodes, 1))


def check_rank_layout(ctx: DistributedContext) -> None:
    """One card hosts one NCCL rank: raise when more ranks share this
    node than it has visible cards (gloo ranks on the CPU have no such
    limit)."""
    if ctx.device is None or ctx.device.type != "cuda":
        return
    cards = torch.cuda.device_count()
    if ctx.local_world > cards or ctx.local_rank >= cards:
        raise RuntimeError(
            f"{ctx.local_world} NCCL ranks on a node with {cards} visible "
            f"card(s) (local rank {ctx.local_rank}): one card hosts one "
            "NCCL rank — launch at most one process per card "
            "(--nproc_per_node / --ntasks-per-node)")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_rank: int | None = None,
                     device=None) -> DistributedContext:
    """Open this process's rank group.  One process (the common dev case
    and the one-card run) is a no-op that still returns a valid context.

    Resolution order: the explicit arguments (``coordinator``
    ``host:port``, ``num_processes``, ``process_id``, ``local_rank``) →
    ``torchrun``'s environment → SLURM's (``SLURM_NPROCS`` /
    ``SLURM_PROCID`` / ``SLURM_LOCALID`` with ``SGCN_COORDINATOR`` or
    ``MASTER_ADDR``) → one process.  The reference's Cloud TPU pod
    autodetection has no counterpart: a GPU cluster names its rendezvous
    through one of the launchers above.

    ``device``: ``None`` or ``'cuda'`` → NCCL on ``cuda:<local rank>``
    (raises without a card, and when more ranks share a node than it has
    cards: ``check_rank_layout``); ``'cpu'`` → gloo.  A world size above
    one rendezvouses through ``_initialize_with_retry`` (heartbeats, one
    retry)."""
    from ..obs.recorder import heartbeat   # no-op unless SGCN_METRICS_OUT

    dev = torch.device("cuda" if device is None else device)
    local_world = None
    init_method = None
    if num_processes is None:
        tr = torchrun_env()
        if tr is not None:
            coordinator, num_processes, process_id, local_rank, \
                local_world = tr
            init_method = "env://"
        else:
            env = slurm_rendezvous_env()
            if env is not None:
                coordinator, num_processes, process_id = env
                local_rank, local_world = _slurm_local()
    num_processes = int(num_processes or 1)
    process_id = int(process_id or 0)
    local_rank = int(local_rank if local_rank is not None else 0)
    if local_world is None:
        # explicit arguments name no node layout: the least it can be
        local_world = local_rank + 1
    if dev.type == "cuda":
        dev = torch.device(f"cuda:{local_rank}")
    ctx = DistributedContext(
        process_id=process_id, num_processes=num_processes,
        coordinator=coordinator if num_processes > 1 else None,
        local_devices=1, global_devices=num_processes,
        local_rank=local_rank, local_world=local_world, device=dev)
    if num_processes > 1:
        if coordinator is None:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address (host:port)")
        check_rank_layout(ctx)
        # heartbeats bracket the rendezvous: a job whose coordinator never
        # comes up looks like a slow start from outside; the last
        # heartbeat's event tells them apart
        ctx.group = _initialize_with_retry(
            heartbeat, f"{num_processes} processes @ {coordinator}",
            coordinator, init_method=init_method or f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id, device=dev)
    _CONTEXT[0] = ctx
    return ctx


def global_mesh_1d(k: int | None = None,
                   ctx: DistributedContext | None = None):
    """The rank group of a ``k``-part run: ``ctx.group`` (default: the
    process's last ``init_distributed``) when the world size is ``k``,
    ``None`` for one process (the stacked layout: all ``k`` parts on one
    device).  Raises for any other world size.  The node's layout (one
    card a NCCL rank, ``check_rank_layout``) was checked by
    ``init_distributed`` before the rendezvous."""
    ctx = ctx if ctx is not None else _CONTEXT[0]
    if ctx is None:
        ctx = init_distributed()
    k = ctx.num_processes if k is None else int(k)
    if ctx.num_processes == 1:
        return None
    if ctx.num_processes != k:
        raise ValueError(
            f"a world of {ctx.num_processes} processes for k={k} parts: "
            f"launch one process per part ({k}), or one process for the "
            "stacked layout")
    return ctx.group


__all__ = ["DistributedContext", "RENDEZVOUS_BACKOFF_S",
           "RENDEZVOUS_TIMEOUT_S", "check_rank_layout", "global_mesh_1d",
           "init_distributed", "slurm_rendezvous_env", "torchrun_env"]
