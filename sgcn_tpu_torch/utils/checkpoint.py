"""Checkpoint / resume for trainer state, with provenance (port of
``sgcn_tpu/utils/checkpoint.py``).

One ``.npz`` format for both packages: a file written here loads in the
reference and the other way round.  It holds the leaves of the reference's
``jax.tree.leaves((params, optax.adam state))`` as ``leaf_<i>``:

  * the params — GCN: ``w_0 … w_{L-1}``; GAT: per layer its dict in sorted
    key order, ``a1, a2, w`` (not the order the port's ``nn.Module``
    registers them);
  * optax's ``count`` (an int32 scalar), then ``mu`` and ``nu`` in the
    params' order.

torch's Adam state maps onto that list BY NAME (``exp_avg`` → ``mu``,
``exp_avg_sq`` → ``nu``, ``step`` → ``count``): ``to_leaves`` /
``from_leaves`` are the one function pair both the trainer and the serve
engine use.  Beside the leaves: ``__step__`` (int64), ``__plan_digest__``
(``obs.recorder.plan_digest``), ``__model_config__`` (JSON),
``__ckpt_version__`` = 2, ``__train_state__`` (JSON: the trainer's
``resume_state()``) and ``__checksums__`` (the CRC32 of every other array).

Provenance: ``load_checkpoint`` and the serve engine verify the recorded
plan digest and model config FIRST and fail with the reference's message
on a mismatch; weights are partition-independent, so a deliberate
same-graph re-partition restore stays possible with ``verify=False``.
Files with no provenance (v1, params-only) still load.  A trainer whose
``checkpoint_plan`` attribute is an explicit ``None`` (the mini-batch
trainer's inner trainer, whose plan is a padded per-batch plan) records
no plan digest, as the reference's sentinel does.  A rank's trainer
(``FullBatchTrainer(mesh=...)``) names its full k-way plan there, so its
files carry the stacked trainer's digest and load on every rank.

Durability: writes are atomic (temp + fsync + rename, ``resilience.
atomic``), every array carries a CRC32, and any damage raises
``CheckpointCorruptError`` so ``resilience.CheckpointManager`` can fall
back to the previous intact file.  A file claiming a NEWER format version
than ``CKPT_VERSION`` is refused.

A stale-halo run (``halo_staleness=1``) or a replica run
(``replica_budget``: ``replica_carry``) also writes ``carry_<i>``: its
carries in the reference's layout and ``jax.tree`` order
(``FullBatchTrainer.carry_leaf_shapes``), so its files and the
reference's restore each other with full state.

Works for the port's ``FullBatchTrainer`` (``params``, ``opt``, ``plan``,
``resume_state``).
"""

from __future__ import annotations

import json
import warnings
import zlib

import numpy as np
import torch

_META_STEP = "__step__"
_META_DIGEST = "__plan_digest__"
_META_MODEL = "__model_config__"
_META_VERSION = "__ckpt_version__"
_META_STATE = "__train_state__"
_META_CHECKSUMS = "__checksums__"

# v1 = params-only (no version key); v2 adds carry_<i> arrays, the train
# state and checksums.  A file claiming a NEWER version fails loudly.
CKPT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed structural or checksum validation —
    truncated container, unreadable member, or a per-array CRC mismatch.
    Distinct from ``ValueError`` (provenance/shape mismatches of an INTACT
    file) so the durable loader (``resilience.CheckpointManager``) can fall
    back to the previous checkpoint on corruption while still failing fast
    on a genuinely wrong restore."""


def _crc(arr: np.ndarray) -> int:
    """CRC32 over an array's dtype, shape and raw bytes."""
    arr = np.ascontiguousarray(arr)
    h = zlib.crc32(repr((arr.dtype.str, arr.shape)).encode())
    return zlib.crc32(arr.tobytes(), h) & 0xFFFFFFFF


# container/member failure modes of a damaged .npz: zipfile raises
# BadZipFile (incl. its own CRC check), zlib.error on a bad stream, OSError
# on short reads, ValueError/KeyError on mangled headers
_NPZ_DAMAGE = (OSError, ValueError, KeyError, zlib.error)


def _open_guarded(path: str):
    """``np.load`` with container damage mapped to CheckpointCorruptError."""
    import zipfile

    try:
        return np.load(path)
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is not a readable .npz (truncated or "
            f"damaged container: {e}) — likely a kill mid-write of a "
            "non-atomic writer, or on-disk corruption; the durable loader "
            "falls back to the previous intact checkpoint") from e
    except _NPZ_DAMAGE as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} failed to open: {e}") from e


def _read_arrays(data, keys, path: str, checksums: dict | None) -> dict:
    """Read + checksum-verify the named members of an open npz."""
    import zipfile

    out = {}
    for key in keys:
        try:
            arr = data[key]
        except (zipfile.BadZipFile, *_NPZ_DAMAGE) as e:
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: member {key!r} is unreadable "
                f"({e}) — corrupt checkpoint; the durable loader falls "
                "back to the previous intact one") from e
        if checksums is not None and key in checksums:
            have = _crc(arr)
            if have != int(checksums[key]):
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: checksum mismatch on {key!r} "
                    f"(recorded {int(checksums[key])}, computed {have}) — "
                    "corrupt checkpoint; the durable loader falls back to "
                    "the previous intact one")
        out[key] = arr
    return out


def _norm(path: str) -> str:
    # np.savez appends .npz itself; normalize so save/load accept the same path
    return path if path.endswith(".npz") else path + ".npz"


# ------------------------------------------- leaves <-> (params, Adam state)
def param_list(params) -> list:
    """The per-layer params (``(fin, fout)`` weights for GCN, ``{w, a1,
    a2}`` dicts for GAT; tensors or numpy arrays) as one flat list in the
    reference's tree order: a dict's entries in sorted key order."""
    out = []
    for p in params:
        if isinstance(p, dict):
            out += [p[key] for key in sorted(p)]
        else:
            out.append(p)
    return out


def _adam_groups(params: list, opt) -> list:
    """The param group of each flat param; raises unless ``opt`` is an
    Adam whose state the optax layout can hold."""
    if not isinstance(opt, torch.optim.Adam):
        raise NotImplementedError(
            f"checkpoints hold Adam state (optax's count/mu/nu); this "
            f"trainer's optimizer is {type(opt).__name__}")
    groups = {}
    for g in opt.param_groups:
        if g.get("amsgrad"):
            raise NotImplementedError(
                "checkpoints hold Adam state without amsgrad (optax.adam "
                "has no max_exp_avg_sq leaf)")
        for p in g["params"]:
            groups[id(p)] = g
    missing = [i for i, p in enumerate(params) if id(p) not in groups]
    if missing:
        raise ValueError(f"params {missing} are not in the optimizer")
    return [groups[id(p)] for p in params]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def to_leaves(params, opt=None) -> list[np.ndarray]:
    """``(params, Adam state)`` → the reference's leaf list (module
    docstring): the params, then, with ``opt``, optax's int32 ``count``
    and the ``mu`` and ``nu`` of every param in the params' order.  A
    param the optimizer has not stepped yet has optax's initial state
    (count 0, zero moments)."""
    flat = param_list(params)
    leaves = [_numpy(p) for p in flat]
    if opt is None:
        return leaves
    _adam_groups(flat, opt)
    states = [opt.state.get(p, {}) for p in flat]
    counts = {int(float(s["step"])) for s in states if "step" in s}
    if len(counts) > 1:
        raise ValueError(f"params were stepped unequally ({sorted(counts)} "
                         "Adam steps): one optax count cannot hold that")
    leaves.append(np.asarray(counts.pop() if counts else 0, np.int32))
    for key in ("exp_avg", "exp_avg_sq"):
        leaves += [_numpy(s[key]) if key in s
                   else np.zeros(tuple(p.shape), np.float32)
                   for p, s in zip(flat, states)]
    return leaves


def _adam_step(group, p, count: int) -> torch.Tensor:
    """A ``step`` tensor as torch's Adam makes it (its lazy state init):
    on ``p``'s device under ``capturable``/``fused``, else a CPU scalar,
    in the optimizer's scalar dtype."""
    from torch.optim.optimizer import _get_scalar_dtype

    if group.get("capturable") or group.get("fused"):
        return torch.full((), float(count), device=p.device,
                          dtype=_get_scalar_dtype(is_fused=group["fused"]))
    return torch.tensor(float(count), dtype=_get_scalar_dtype())


def check_leaves(leaves, params, opt=None, what: str = "checkpoint") -> None:
    """Raise ``ValueError`` unless ``leaves`` fit ``params`` (and, with
    ``opt``, their Adam state) leaf for leaf: count, shapes, dtypes.
    Params-only (``opt=None``) accepts a longer list and reads its
    leading leaves — ``(params, opt_state)`` flattens params-first."""
    flat = param_list(params)
    want = [(tuple(p.shape), np.dtype(np.float32)) for p in flat]
    if opt is not None:
        want += ([((), np.dtype(np.int32))]
                 + [(tuple(p.shape), np.dtype(np.float32))
                    for p in flat + flat])
        if len(leaves) != len(want):
            raise ValueError(f"{what} has {len(leaves)} leaves, trainer "
                             f"expects {len(want)}")
    elif len(leaves) < len(want):
        raise ValueError(
            f"{what} has {len(leaves)} leaves, the params tree needs "
            f"{len(want)} — not a checkpoint of this model config")
    for have, (shape, dtype) in zip(leaves, want):
        if tuple(have.shape) != shape:
            raise ValueError(f"{what} leaf shape {have.shape} != {shape} — "
                             "wrong fin/widths for this checkpoint "
                             "(read_checkpoint_meta shows its config)")
        if have.dtype != dtype:
            raise ValueError(f"{what} leaf dtype {have.dtype} != {dtype}")


def from_leaves(leaves, params, opt=None) -> None:
    """Copy the reference's leaf list into the live ``params`` in place
    (``torch.no_grad()``, ``copy_``: every tensor keeps its storage) and,
    with ``opt``, into its Adam state — created as torch's Adam would
    create it for an optimizer that has not stepped yet, the ``step``
    tensor on the device and in the dtype Adam uses, so the resumed bias
    correction is bit-identical.  Validates everything first
    (``check_leaves``): a failed restore changes nothing."""
    check_leaves(leaves, params, opt)
    flat = param_list(params)
    groups = _adam_groups(flat, opt) if opt is not None else None
    with torch.no_grad():
        for p, leaf in zip(flat, leaves):
            p.copy_(torch.tensor(leaf))
        if opt is None:
            return
        n = len(flat)
        count = int(leaves[n])
        for i, (p, g) in enumerate(zip(flat, groups)):
            st = opt.state[p]
            if "step" not in st:
                st["step"] = _adam_step(g, p, count)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            else:
                st["step"].fill_(float(count))
            st["exp_avg"].copy_(torch.tensor(leaves[n + 1 + i]))
            st["exp_avg_sq"].copy_(torch.tensor(leaves[2 * n + 1 + i]))


# ------------------------------------------------------------- provenance
def model_kind(trainer) -> str | None:
    """``'gcn'``/``'gat'``: the reference keeps the kind in
    ``trainer.model``, the port keeps its ``nn.Module`` there and the kind
    in the resolved forward setup."""
    setup = getattr(trainer, "setup", None)
    if setup is not None:
        return setup.model
    kind = getattr(trainer, "model", None)
    return kind if isinstance(kind, str) else None


def model_config_of(trainer) -> dict | None:
    """The checkpoint's model-identity block, read off a trainer's attrs
    (a trainer without an attribute omits it).  ``gat_fused`` records the
    reference's table-form lever (``$SGCN_GAT_FUSED``): the port has no
    such lever, and its rule (the fused ``fout+1``-lane table while it fits
    128 lanes, else split; ``models/gat.py::gat_table_form``) is the
    reference's default ``'1'``, so that is the form these params were
    trained under."""
    cfg = {}
    kind = model_kind(trainer)
    if kind is not None:
        cfg["model"] = kind
    for attr, key in (("fin", "fin"), ("widths", "widths"),
                      ("activation", "activation"),
                      ("final_activation", "final_activation"),
                      ("loss_name", "loss")):
        v = getattr(trainer, attr, None)
        if v is not None:
            cfg[key] = list(v) if key == "widths" else v
    if cfg.get("model") == "gat":
        cfg["gat_fused"] = "1"
    return cfg or None


def save_checkpoint(trainer, path: str, step: int = 0) -> str:
    """Write one atomic full-state checkpoint (module docstring): the
    (params, Adam state) leaves, the trainer's ``resume_state()``,
    provenance, the format version and a per-array CRC map — committed via
    temp + fsync + rename so a kill at ANY byte leaves either the previous
    checkpoint or the complete new one."""
    leaves = to_leaves(trainer.params, trainer.opt)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrays[_META_STEP] = np.asarray(step, dtype=np.int64)
    # ``checkpoint_plan`` (may be an explicit None) overrides ``plan``: the
    # mini-batch trainer saves through its inner trainer, whose plan is a
    # padded per-batch plan — no stable run identity, so no digest
    plan = getattr(trainer, "checkpoint_plan", getattr(trainer, "plan", None))
    if plan is not None:
        from ..obs.recorder import plan_digest
        arrays[_META_DIGEST] = np.asarray(plan_digest(plan))
    cfg = model_config_of(trainer)
    if cfg is not None:
        arrays[_META_MODEL] = np.asarray(json.dumps(cfg))
    if hasattr(trainer, "resume_state"):
        state, carry_leaves = trainer.resume_state()
        for i, arr in enumerate(carry_leaves):
            arrays[f"carry_{i}"] = arr
        arrays[_META_STATE] = np.asarray(json.dumps(state))
    arrays[_META_VERSION] = np.asarray(CKPT_VERSION, dtype=np.int64)
    # checksum EVERY array, meta blocks included — a bit flip in __step__
    # or a still-parseable __train_state__ digit would otherwise pass as
    # intact.  The checksum map itself is the one uncovered array: any
    # mangling of it either fails to parse or miscompares some covered
    # array — both raise CheckpointCorruptError.
    arrays[_META_CHECKSUMS] = np.asarray(json.dumps(
        {key: _crc(np.asarray(arr)) for key, arr in arrays.items()}))
    path = _norm(path)
    from ..resilience.atomic import atomic_write
    with atomic_write(path, "wb") as fh:
        np.savez(fh, **arrays)
    return path


def read_checkpoint_meta(path: str) -> dict:
    """Provenance block of a checkpoint file: ``{step, plan_digest,
    model_config, n_leaves, version, state, checksums, n_carry}`` —
    digest/config/state ``None`` for files that predate them, ``version``
    1 for params-only files.  Cheap (``np.load`` is lazy; only metadata
    arrays read).  A damaged container raises ``CheckpointCorruptError``."""
    with _open_guarded(_norm(path)) as data:
        meta = _read_meta_open(data, path)
    return meta


def _read_meta_open(data, path: str) -> dict:
    import zipfile

    try:
        checksums = (json.loads(str(data[_META_CHECKSUMS].item()))
                     if _META_CHECKSUMS in data.files else None)
        if checksums is not None:
            # verify the META arrays up front (leaves/carries are checked
            # by _read_arrays at their own read)
            for key in (_META_STEP, _META_DIGEST, _META_MODEL,
                        _META_VERSION, _META_STATE):
                if key in data.files and key in checksums:
                    have = _crc(np.asarray(data[key]))
                    if have != int(checksums[key]):
                        raise CheckpointCorruptError(
                            f"checkpoint {path!r}: checksum mismatch on "
                            f"metadata {key!r} (recorded "
                            f"{int(checksums[key])}, computed {have}) — "
                            "corrupt checkpoint; the durable loader falls "
                            "back to the previous intact one")
        return {
            "step": int(data[_META_STEP]) if _META_STEP in data.files else 0,
            "plan_digest": (str(data[_META_DIGEST].item())
                            if _META_DIGEST in data.files else None),
            "model_config": (json.loads(str(data[_META_MODEL].item()))
                             if _META_MODEL in data.files else None),
            "version": (int(data[_META_VERSION])
                        if _META_VERSION in data.files else 1),
            "state": (json.loads(str(data[_META_STATE].item()))
                      if _META_STATE in data.files else None),
            "checksums": checksums,
            "n_leaves": sum(1 for f in data.files if f.startswith("leaf_")),
            "n_carry": sum(1 for f in data.files if f.startswith("carry_")),
        }
    except (zipfile.BadZipFile, *_NPZ_DAMAGE) as e:
        # json.JSONDecodeError is a ValueError, so a mangled metadata JSON
        # lands here too
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: metadata block unreadable ({e}) — "
            "corrupt checkpoint") from e


def verify_checkpoint_provenance(meta: dict, plan=None,
                                 model: str | None = None,
                                 fin: int | None = None,
                                 widths=None,
                                 activation: str | None = None,
                                 final_activation: str | None = None,
                                 what: str = "checkpoint") -> None:
    """Raise ``ValueError`` with the reference's message when the
    checkpoint's recorded provenance contradicts the given plan / model
    config.  Fields the checkpoint does not record are skipped."""
    if plan is not None and meta.get("plan_digest") is not None:
        from ..obs.recorder import plan_digest
        have = plan_digest(plan)
        if have != meta["plan_digest"]:
            raise ValueError(
                f"{what}: plan digest mismatch — checkpoint was saved under "
                f"plan {meta['plan_digest']}, this run's plan is {have}: a "
                "different graph, partvec, k or comm layout.  Model weights "
                "are partition-independent, so a same-graph re-partition can "
                "be restored deliberately (load_checkpoint(..., "
                "verify=False)); a different GRAPH cannot — check "
                "read_checkpoint_meta before overriding.")
    cfg = meta.get("model_config") or {}
    # activation is part of the served function: the same params under a
    # different activation compute different logits
    for key, want in (("model", model), ("fin", fin),
                      ("widths", list(widths) if widths is not None
                       else None),
                      ("activation", activation),
                      ("final_activation", final_activation)):
        if want is not None and cfg.get(key) is not None and cfg[key] != want:
            raise ValueError(
                f"{what}: model config mismatch on {key!r} — checkpoint "
                f"records {cfg[key]!r}, this run asks for {want!r}; "
                "reconstruct the trainer/engine with the checkpoint's "
                "config (read_checkpoint_meta shows it).")


def load_checkpoint_leaves(path: str) -> tuple[list, dict]:
    """``(leaves, meta)`` — every ``leaf_<i>`` array in index order plus the
    provenance block, checksum-verified (corruption raises
    ``CheckpointCorruptError``).  The serve engine restores its params from
    the leading leaves; carry arrays are not read."""
    path = _norm(path)
    with _open_guarded(path) as data:
        meta = _read_meta_open(data, path)
        _check_version(meta, path)
        arrays = _read_arrays(
            data, [f"leaf_{i}" for i in range(meta["n_leaves"])],
            path, meta["checksums"])
    return [arrays[f"leaf_{i}"] for i in range(meta["n_leaves"])], meta


def _check_version(meta: dict, path: str) -> None:
    if meta["version"] > CKPT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} is format v{meta['version']}, this "
            f"reader understands up to v{CKPT_VERSION} — written by a "
            "newer sgcn_tpu; silently dropping state a newer writer "
            "recorded is not an option, upgrade the reader")


def verify_checkpoint_file(path: str) -> dict:
    """Full structural + checksum verification of EVERY data array (leaves
    and carries); returns the meta block.  Raises
    ``CheckpointCorruptError`` on any damage.  An integrity probe for
    operators auditing a checkpoint directory; the resume path verifies
    through ``load_checkpoint`` in one read pass instead."""
    path = _norm(path)
    with _open_guarded(path) as data:
        meta = _read_meta_open(data, path)
        _check_version(meta, path)
        keys = ([f"leaf_{i}" for i in range(meta["n_leaves"])]
                + [f"carry_{i}" for i in range(meta["n_carry"])])
        _read_arrays(data, keys, path, meta["checksums"])
    return meta


def _trainer_is_stateful(trainer) -> bool:
    """Does this trainer hold state beyond (params, Adam state) — a
    stale or replica carry or a live controller — that a params-only
    restore would silently reinitialize?"""
    return (getattr(trainer, "halo_carry", None) is not None
            or getattr(trainer, "replica_carry", None) is not None
            or getattr(trainer, "controller", None) is not None)


def load_checkpoint(trainer, path: str, verify: bool = True) -> int:
    """Restore the FULL trainer state in place; returns the saved step
    counter.

    The recorded provenance (plan digest, model kind, dims, activations)
    is verified FIRST with a clear message (``verify=False`` skips it),
    then the leaves are validated against the trainer's params and Adam
    state, and a stale or replica run's carry leaves against the trainer's
    ``carry_leaf_shapes()``; nothing is assigned before everything checks
    out.  The file's train state (step counters, the effective
    ``sync_every`` and controller, comm gauges, carries) is restored
    through ``trainer.restore_resume_state``.  A carry-mode mismatch
    either way (a stale file into an exact trainer, an exact or replica
    file into a stale one) loads params-only with the reference's LOUD
    ``RuntimeWarning``, and so does a v1 file into a stateful trainer —
    never silently; ``trainer.last_restore_partial`` then says so."""
    path_n = _norm(path)
    with _open_guarded(path_n) as data:
        meta = _read_meta_open(data, path_n)
        _check_version(meta, path_n)
        keys = ([f"leaf_{i}" for i in range(meta["n_leaves"])]
                + [f"carry_{i}" for i in range(meta["n_carry"])])
        arrays = _read_arrays(data, keys, path_n, meta["checksums"])
    leaves = [arrays[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    file_carry = [arrays[f"carry_{i}"] for i in range(meta["n_carry"])]
    if verify:
        verify_checkpoint_provenance(
            meta, plan=(getattr(trainer, "checkpoint_plan", None)
                        or getattr(trainer, "plan", None)),
            model=model_kind(trainer),
            fin=getattr(trainer, "fin", None),
            widths=getattr(trainer, "widths", None),
            activation=getattr(trainer, "activation", None),
            final_activation=getattr(trainer, "final_activation", None),
            what=f"load_checkpoint({path!r})")
    check_leaves(leaves, trainer.params, trainer.opt, what="checkpoint")
    state, carry_leaves = meta.get("state"), []
    restore_state = state is not None and hasattr(trainer,
                                                  "restore_resume_state")
    if restore_state:
        want_carry = (trainer._carry_attr()
                      if hasattr(trainer, "_carry_attr") else None)
        have_carry = state.get("carry")
        # a carry-MODE mismatch downgrades the whole restore to
        # params-only: importing the other mode's counters and gauges
        # would publish accounting this trainer's mode never produced
        if have_carry is not None and want_carry != have_carry:
            restore_state = False
            warnings.warn(
                f"load_checkpoint({path!r}): checkpoint carries "
                f"{have_carry!r} state but this trainer runs "
                f"{want_carry or 'exact'} mode — full state IGNORED "
                "(params-only restore: carries, step counters, sync "
                "schedule and comm gauges are NOT imported); rebuild the "
                "trainer with the checkpoint's mode flags for a bit-"
                "identical resume", RuntimeWarning, stacklevel=2)
        elif want_carry is not None and have_carry is None:
            restore_state = False
            warnings.warn(
                f"load_checkpoint({path!r}): PARTIAL STATE — this trainer "
                f"carries {want_carry!r} state the checkpoint (saved by "
                "a carry-free mode) does not record; params-only restore "
                "(the carry re-initializes at the next sync step, the "
                "counters and comm gauges restart), so the resumed "
                "trajectory is NOT bit-identical to the uninterrupted "
                "run", RuntimeWarning, stacklevel=2)
        elif have_carry is not None:
            carry_leaves = file_carry
            want = trainer.carry_leaf_shapes()
            if len(carry_leaves) != len(want):
                raise ValueError(
                    f"checkpoint has {len(carry_leaves)} carry leaves, "
                    f"trainer expects {len(want)} — different sync "
                    "schedule/transport flags than the saving run")
            for have, shape in zip(carry_leaves, want):
                if tuple(have.shape) != tuple(shape):
                    raise ValueError(
                        f"checkpoint carry leaf shape {have.shape} != "
                        f"trainer {tuple(shape)} — different mode/transport "
                        "flags than the saving run")
    elif _trainer_is_stateful(trainer):
        warnings.warn(
            f"load_checkpoint({path!r}): PARTIAL STATE — checkpoint "
            f"format v{meta['version']} records params/opt_state only; "
            "this trainer's carry/controller/step-counter state is NOT "
            "restored (carries re-initialize at the next sync step, the "
            "comm gauges restart at zero).  Re-save with this version for "
            "full-state resume", RuntimeWarning, stacklevel=2)
    from_leaves(leaves, trainer.params, trainer.opt)
    if restore_state:
        trainer.restore_resume_state(state, carry_leaves)
    trainer.last_restore_partial = (not restore_state
                                    and _trainer_is_stateful(trainer))
    return meta["step"]
