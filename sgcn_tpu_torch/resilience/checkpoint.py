"""Durable checkpoint directory: rotation, latest-intact discovery, fallback
(port of ``sgcn_tpu/resilience/checkpoint.py``).

One ``CheckpointManager`` owns one directory of step-stamped checkpoints
(``ckpt_<step:08d>.npz``).  The write side is already atomic
(``utils.checkpoint.save_checkpoint`` rides ``resilience.atomic``); this
layer adds the directory-level policies a preemptible run needs:

  * **rotation** — keep the newest ``keep_last`` checkpoints, delete older
    ones AFTER a new save commits (never before: a kill between delete and
    write must not leave the run with fewer restore points than promised);
  * **latest-intact discovery** — ``load_latest`` walks the directory
    newest-first, fully verifying each candidate (structure + per-array
    checksums) and falling back to the previous checkpoint on corruption
    with a LOUD warning naming the damaged file; only when NO intact
    checkpoint exists does it raise;
  * **resume provenance** — the chosen step/path and the list of
    checkpoints that had to be skipped come back to the caller, so the run
    report can say exactly what happened.

The stamps (``ckpt_<step:08d>.npz``) and the file format are the
reference's, so one directory is readable by both packages.
"""

from __future__ import annotations

import os
import re
import warnings

from ..utils.checkpoint import CheckpointCorruptError, load_checkpoint

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


class CheckpointManager:
    """See module docstring."""

    def __init__(self, directory: str, keep_last: int = 3):
        if keep_last < 1:
            raise ValueError(
                f"keep_last must be >= 1, got {keep_last} — a manager that "
                "keeps zero checkpoints cannot resume anything")
        self.dir = directory
        self.keep_last = int(keep_last)
        self._swept = False
        os.makedirs(directory, exist_ok=True)

    def path_for(self, step: int) -> str:
        if step < 0 or step > 10 ** 8 - 1:
            raise ValueError(f"step {step} outside the 8-digit stamp range")
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def checkpoints(self) -> list[tuple[int, str]]:
        """``[(step, path), ...]`` sorted ascending by step — every file in
        the directory matching the stamp pattern, intact or not."""
        out = []
        for name in os.listdir(self.dir):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def save(self, trainer, step: int) -> str:
        """One atomic full-state save + rotation; returns the committed
        path.  Rotation runs strictly AFTER the new checkpoint is durable
        and never touches the file just written — a reused directory
        holding HIGHER-stamped checkpoints from a previous run must not
        make rotation (which orders by step) delete this run's fresh save.
        That situation itself gets a loud warning: ``--resume auto``
        prefers the highest stamp, so stale higher-stamped files from
        another run would shadow this run's checkpoints."""
        from ..utils.checkpoint import save_checkpoint
        from .atomic import sweep_temp_litter

        if not self._swept:
            # sweep temp litter from previous KILLED saves on the first
            # save of this run — here rather than __init__ because only
            # the coordinator calls save(): every rank constructs a
            # manager (restores run everywhere), and a restarting
            # non-writer rank sweeping a shared filesystem could unlink a
            # live coordinator's in-flight temp.  Without the sweep,
            # repeated mid-save preemptions grow the directory past the
            # keep_last disk bound.
            sweep_temp_litter(self.dir, "ckpt_")
            self._swept = True
        path = save_checkpoint(trainer, self.path_for(step), step=step)
        cands = self.checkpoints()
        if any(s > step for s, _ in cands):
            warnings.warn(
                f"checkpoint dir {self.dir!r} holds checkpoints stamped "
                f"PAST this run's step {step} (from a previous run?) — "
                "--resume auto would restore those, not this run's; use "
                "a fresh --checkpoint-dir per logical run",
                RuntimeWarning, stacklevel=2)
        for _, old in cands[:-self.keep_last]:
            if old == path:
                continue
            try:
                os.remove(old)
            except OSError:
                pass                    # a vanished file is already rotated
        return path

    def load_latest(self, trainer, verify: bool = True
                    ) -> tuple[int, str, list[str]]:
        """Restore the newest INTACT checkpoint into ``trainer``; returns
        ``(step, path, skipped)`` where ``skipped`` lists the corrupt
        files that were passed over (newest first).  Raises
        ``FileNotFoundError`` on an empty directory and
        ``CheckpointCorruptError`` when every candidate is damaged.
        Provenance/shape mismatches of an INTACT checkpoint (plain
        ``ValueError``) propagate immediately — falling back PAST a valid
        checkpoint that merely disagrees with the trainer would mask a
        config bug as a resume."""
        cands = self.checkpoints()
        if not cands:
            raise FileNotFoundError(
                f"--resume auto: no ckpt_*.npz in {self.dir!r} — nothing "
                "to resume (run with --checkpoint-every N first)")
        skipped: list[str] = []
        for step, path in reversed(cands):
            try:
                # load_checkpoint verifies EVERYTHING (checksums of leaves
                # AND carries, shapes, provenance) before its first
                # assignment, so corruption surfaces here with the trainer
                # untouched — one read pass, no separate verify sweep
                got = load_checkpoint(trainer, path, verify=verify)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"resume: {path!r} is corrupt ({e}); falling back to "
                    "the previous intact checkpoint", RuntimeWarning,
                    stacklevel=2)
                skipped.append(path)
                continue
            return int(got), path, skipped
        raise CheckpointCorruptError(
            f"--resume auto: all {len(cands)} checkpoint(s) in "
            f"{self.dir!r} are corrupt ({skipped}) — nothing intact to "
            "resume from")
