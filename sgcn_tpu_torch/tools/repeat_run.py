"""Repeat one training configuration N times in one process and count how
many different results it gives.

::

    python -m sgcn_tpu_torch.tools.repeat_run --npz tests/fixtures/cora2708.npz \\
        --normalize -p tests/fixtures/cora2708.8.hp -s 8 -l 2 --hidden 16 \\
        --model gat --epochs 5 --warmup 0 --seed 11 --comm-schedule a2a \\
        --runs 200

Takes the train CLI's flags (``python -m sgcn_tpu_torch.train``) and
builds the plan and the data once; then each run makes a fresh
``FullBatchTrainer`` from the same seed and takes ``warmup + epochs``
steps, reading each loss back.  Prints ONE JSON line: the number of
distinct loss histories (each loss's exact float32 value) and of final
weight digests (sha256 of the parameters' float32 bytes in order), with
the count of each.  A run of the port on one device is expected to give
one of each: every kernel sums in one stored order with no float atomics.

``--digest-ops`` also hashes, during steps 1 and 2 of every run, the
output of every ATen op (``TorchDispatchMode``: the matmuls, the
elementwise and reduction ops, the optimizer's) and of every kernel
launch of the port (the tile SpMM family and fused entries and the row
pack, at their Python wrappers), in the order they ran; runs that differ
name the first output that differs.  It reads every output back to the
host, so it slows the run and serializes the device.  ``--deterministic``
sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless set) and
``torch.use_deterministic_algorithms(True)`` before the first run.
``--processes N`` runs the configuration once in each of N fresh Python
processes (this tool with ``--runs 1``, one after another) instead, and
counts their loss histories and weight digests the same way.

Runs on the card by default (``--device cpu`` for the CPU); there is no
fallback.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ATen ops whose output is memory nobody wrote yet: never hashed
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "resize_")

# the port's kernel wrappers, by the modules that call them by name
_KERNEL_WRAPPERS = {
    "sgcn_tpu_torch.ops.tile_spmm": ("spmm_tiles_classes",
                                     "spmm_tiles_fused"),
    "sgcn_tpu_torch.ops.row_shuffle": ("row_pack",),
    "sgcn_tpu_torch.ops.pspmm": ("row_pack",),
}


def tensor_digest(t: torch.Tensor) -> str:
    """sha256 (first 16 hex digits) of a tensor's bytes in row-major order."""
    b = t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()[:16]


def weights_digest(params) -> str:
    """sha256 of the float32 bytes of every parameter, in order."""
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class OpDigests(TorchDispatchMode):
    """Appends ``(op, shape, dtype, digest)`` of every output of every ATen
    op run under it to ``log`` (ops that return unwritten memory
    excepted); ``record(name, out)`` records a kernel launch's output the
    same way."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log

    def record(self, name: str, out) -> None:
        for t in _tensors(out):
            if t.layout == torch.strided:
                self.log.append((name, tuple(t.shape), str(t.dtype),
                                 tensor_digest(t)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in _UNWRITTEN:
            self.record(f"aten.{name}", out)
        return out


class _KernelRecorder:
    """Wraps the port's kernel wrappers (module attributes) so that each
    call's output is recorded while ``active`` is set."""

    def __init__(self):
        self.active = None              # an OpDigests while recording
        self._saved = []

    def __enter__(self):
        for modname, names in _KERNEL_WRAPPERS.items():
            mod = sys.modules.get(modname) or __import__(
                modname, fromlist=["_"])
            for name in names:
                orig = getattr(mod, name)
                self._saved.append((mod, name, orig))
                setattr(mod, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def call(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.active is not None:
                self.active.record(f"kernel.{name}", out)
            return out
        # one attribute dict: the launch counters, which the wrapped
        # function bumps through the module attribute the wrapper replaces
        call.__dict__ = orig.__dict__
        return call

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        self._saved.clear()


def repeat_training(make_trainer, data, steps: int, runs: int,
                    digest_ops: bool = False) -> dict:
    """Train ``runs`` fresh trainers (``make_trainer()``) for ``steps``
    steps each on ``data``.  Returns the distinct loss histories and
    weight digests with their counts and, under ``digest_ops``, the first
    op output of steps 1–2 in which a run differs from the first run."""
    histories = collections.Counter()
    digests = collections.Counter()
    first_ops, first_diff, n_ops = None, None, None
    recorder = _KernelRecorder() if digest_ops else None
    if recorder is not None:
        recorder.__enter__()
    try:
        for r in range(runs):
            tr = make_trainer()
            losses, log = [], []
            for s in range(steps):
                if recorder is not None and s < 2:
                    mode = OpDigests(log)
                    recorder.active = mode
                    with mode:
                        losses.append(tr.step(data))
                    recorder.active = None
                else:
                    losses.append(tr.step(data))
            histories[tuple(float(x).hex() for x in losses)] += 1
            digests[weights_digest(tr.model.parameters())] += 1
            if recorder is None:
                continue
            if first_ops is None:
                first_ops, n_ops = log, len(log)
            elif log != first_ops and first_diff is None:
                i = next((j for j, (x, y) in enumerate(zip(log, first_ops))
                          if x != y), min(len(log), len(first_ops)))
                first_diff = {"run": r, "index": i,
                              "op": log[i][:3] if i < len(log) else None,
                              "this_run": log[i][3] if i < len(log) else None,
                              "first_run": (first_ops[i][3]
                                            if i < len(first_ops) else None),
                              "ops_this_run": len(log),
                              "ops_first_run": len(first_ops)}
    finally:
        if recorder is not None:
            recorder.__exit__(None, None, None)

    def table(c):
        return [{"count": n, "value": list(k) if isinstance(k, tuple) else k}
                for k, n in c.most_common()]

    return {"runs": runs, "steps": steps,
            "distinct_loss_histories": len(histories),
            "distinct_weight_digests": len(digests),
            "loss_histories": table(histories),
            "weight_digests": table(digests),
            "digest_ops": bool(digest_ops), "ops_per_run": n_ops,
            "first_difference": first_diff}


def _in_processes(argv, n: int) -> dict:
    """One run in each of ``n`` fresh processes of this tool: their loss
    histories and weight digests counted as ``repeat_training`` counts
    them."""
    import subprocess

    argv = list(argv)
    i = argv.index("--processes")
    del argv[i: i + 2]
    for flag in ("--runs", "--digest-ops"):
        while flag in argv:
            j = argv.index(flag)
            del argv[j: j + (2 if flag == "--runs" else 1)]
    histories = collections.Counter()
    digests = collections.Counter()
    last = None
    for _ in range(n):
        out = subprocess.run(
            [sys.executable, "-m", "sgcn_tpu_torch.tools.repeat_run", *argv,
             "--runs", "1"], capture_output=True, text=True, check=True)
        last = json.loads(out.stdout.strip().splitlines()[-1])
        histories[tuple(last["loss_histories"][0]["value"])] += 1
        digests[last["weight_digests"][0]["value"]] += 1
    report = {key: last[key] for key in ("steps", "model", "comm_schedule",
                                         "deterministic",
                                         "cublas_workspace_config",
                                         "device")}
    report.update(
        processes=n, distinct_loss_histories=len(histories),
        distinct_weight_digests=len(digests),
        loss_histories=[{"count": c, "value": list(k)}
                        for k, c in histories.most_common()],
        weight_digests=[{"count": c, "value": k}
                        for k, c in digests.most_common()])
    print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> dict:
    from ..train.__main__ import build_parser, load_inputs

    p = build_parser("repeat one training configuration and count the "
                     "distinct results")
    p.add_argument("--runs", type=int, default=10,
                   help="fresh trainers from the same seed, one process")
    p.add_argument("--digest-ops", action="store_true",
                   help="hash every op and kernel output of steps 1-2 and "
                        "name the first that differs between runs")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True) with "
                        "CUBLAS_WORKSPACE_CONFIG=:4096:8")
    p.add_argument("--processes", type=int, default=0,
                   help="run once in each of this many fresh processes "
                        "instead of --runs in this one")
    args = p.parse_args(argv)
    if args.processes:
        return _in_processes(argv if argv is not None else sys.argv[1:],
                             args.processes)
    if args.experiment is not None:
        raise SystemExit("repeat_run repeats a training run; --experiment "
                         "is the train CLI's")
    if args.metrics_out or args.profile or args.memory_budget is not None:
        raise SystemExit("repeat_run repeats a training run; --metrics-out, "
                         "--profile and --memory-budget are the train "
                         "CLI's")
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    from ..parallel.plan import build_comm_plan
    from ..train.fullbatch import MODELS, FullBatchTrainer, make_train_data
    from ..utils.backend import device_name, resolve_device

    device = resolve_device(args.device)
    a, feats, labels, pv, k, f, widths = load_inputs(args)
    plan = build_comm_plan(a, pv, k)
    data = make_train_data(plan, feats, labels, device=device)
    activation = args.activation or MODELS[args.model].activation

    def make_trainer():
        return FullBatchTrainer(plan, fin=f, widths=widths, lr=args.lr,
                                model=args.model, loss=args.loss,
                                activation=activation, seed=args.seed,
                                compute_dtype=args.dtype,
                                halo_dtype=args.halo_dtype,
                                comm_schedule=args.comm_schedule,
                                device=device)

    report = repeat_training(make_trainer, data, args.warmup + args.epochs,
                             args.runs, digest_ops=args.digest_ops)
    report.update(model=args.model, comm_schedule=args.comm_schedule,
                  deterministic=args.deterministic,
                  cublas_workspace_config=os.environ.get(
                      "CUBLAS_WORKSPACE_CONFIG"),
                  device=device_name(device))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
