"""The rank group: one process per part (the role of
``sgcn_tpu/parallel/mesh.py``).

The reference's process topology is flat: k MPI ranks or k
``torch.distributed`` workers, one graph part each
(``Parallel-GCN/main.c:101-103``, ``GPU/PGCN.py:241-253``); the JAX
package's counterpart is a 1-D device mesh.  Here it is a
``torch.distributed`` process group opened with an ``init_method``, world
size and rank given explicitly (``parallel/launch.py::init_distributed``
resolves them from ``torchrun``'s or SLURM's environment), NCCL on cards
and gloo on the CPU.  Rank ``r`` holds part
``r`` of a k-way plan (``world_size == k``); a one-rank group may hold any
one part's slice (``parallel/proxy.py``), whose exchange is then the
loopback through the collective.  ``FullBatchTrainer(mesh=...)`` and
``BroadcastGCN1D(mesh=...)`` and ``ServeEngine(mesh=...)`` take a
``RankGroup`` under the reference's argument name.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import census

# ``all_gather_single`` on a torch that has it (``all_gather_into_tensor``
# is its deprecated name there), else the older name
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class RankGroup:
    """This process's rank in the group of part processes.

    ``rank``/``size``: the rank and world size; ``device``: where the
    rank's tensors live (``cuda:<rank>`` under NCCL, ``cpu`` under
    gloo)."""

    def __init__(self, rank: int, size: int, device):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)

    def peer(self, offset: int) -> int:
        """The rank ``offset`` steps along the ring (mod the world size)."""
        return (self.rank + offset) % self.size

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor (no
        gradient)."""
        out = t.detach().clone()
        census.collective("all_reduce_sum", out)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the ranks, as a new tensor (no
        gradient): the reference's ``lax.pmax`` (GAT's softmax
        stabilizer).  Exact, so every rank holds the stacked max's bits."""
        out = t.detach().clone()
        census.collective("all_reduce_max", out)
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def all_gather(self, t: torch.Tensor, async_op: bool = False):
        """Every rank's ``t`` stacked along the first axis, in rank
        order: ``(size·N, ...)`` for an ``(N, ...)`` ``t`` (one
        collective).  ``async_op=True`` returns ``(out, work)`` at once:
        ``out`` holds the rows once ``work.wait()`` has returned."""
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        census.collective("all_gather", t)
        work = _ALL_GATHER(out, t.contiguous(), async_op=async_op)
        return (out, work) if async_op else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place (every rank
        passes a tensor of the same shape and dtype on ``device``);
        returns ``t``.  The serve engine's batch header and query ids
        (``serve/engine.py``)."""
        census.collective("broadcast", t)
        dist.broadcast(t, src)
        return t

    def close(self) -> None:
        """Destroy the process group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def init_rank_group(init_method: str, world_size: int, rank: int,
                    device=None, timeout=None) -> RankGroup:
    """Open the default process group with an explicit rendezvous:
    ``init_method`` (``file://<path>``, ``tcp://<host>:<port>`` or
    ``env://``: ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets
    them), ``world_size`` and ``rank``.  NCCL on a CUDA ``device``
    (``None`` means ``cuda:<rank>``, made the current device), gloo on the
    CPU.  ``timeout`` (a ``datetime.timedelta``) bounds the rendezvous
    and each collective; ``None`` keeps torch's default."""
    dev = torch.device(f"cuda:{rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank group needs a GPU: pass "
                               "device='cpu' for gloo ranks")
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return RankGroup(rank, world_size, dev)
