"""sgcn_tpu_torch — the PyTorch + CUDA port of ``sgcn_tpu`` for NVIDIA Hopper.

The JAX package ``sgcn_tpu`` stays beside this one as the reference.  This
package imports ``torch``, ``numpy`` and ``scipy`` and never ``jax`` or
anything of ``sgcn_tpu``: the host-side modules it needs (MatrixMarket I/O,
normalization, part vectors, the communication plan) are its own copies.
Module paths mirror the reference so each counterpart is easy to find.

Ported so far: the partitioned GCN *serving* forward on one device —
read graph, normalize Â, read the partition, ``build_comm_plan``, then per
layer halo exchange (a row-pack kernel that writes the receive layout,
``csrc/row_shuffle.cu``) → tile SpMM (a hand-written CUDA kernel for
``sm_90a``, ``csrc/tile_spmm.cu``, whose GCN entry runs the local and halo
passes and their sum in one launch) → dense projection → activation, and
query routing
— and the exact full-batch *trainer* on that forward, whose aggregation
backward runs the same kernel on the gradient (Â is symmetric); GCN and
GAT (the attention pass on the kernel's int8-mask entry point), over the
dense a2a exchange or the ragged ring (``--comm-schedule``); and the
reference's checkpoints (``utils/checkpoint.py``, the same ``.npz``
format), crash-safe resume (``resilience/``) and serving from a
checkpoint with hot swap (``serve/engine.py``).
All ``k`` parts run stacked along a leading axis in one process on one
device (``ops/pspmm.py::halo_exchange`` and ``ring_concat`` are the one
place that knows), or one process per part on a ``torch.distributed``
group (``parallel/mesh.py``, ``FullBatchTrainer(mesh=...)``, GCN and
GAT), opened by the train CLI from ``torchrun``'s or SLURM's environment
(``parallel/launch.py``, ``launch/gpu.slurm``); one part's share runs
alone through ``parallel/proxy.py``.  The CAGNET
broadcast baseline is ``baselines/cagnet1d.py``.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a GPU they raise instead of falling back.  CLI (``python -m
sgcn_tpu_torch`` prints the map): ``python -m sgcn_tpu_torch.serve``,
``python -m sgcn_tpu_torch.train``, ``python -m
sgcn_tpu_torch.baselines`` and
the micro-benchmark ``python -m sgcn_tpu_torch.tools.spmm_micro`` (its
row-shuffle probe is a CUDA kernel too, ``csrc/row_shuffle.cu``).
"""

__version__ = "0.1.0"
