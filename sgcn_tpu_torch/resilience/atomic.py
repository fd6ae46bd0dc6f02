"""Atomic, durable file writes — the ONE write discipline every artifact
that must survive a kill rides (port of ``sgcn_tpu/resilience/atomic.py``;
here: checkpoints).

A preemption can land anywhere, including mid-``write()``: a plain
``open(path, "w")`` overwrite leaves a truncated file that the next process
then fails to parse (or worse, half-parses).  The classic fix is the only
one that is atomic on POSIX: write the full content to a TEMP file in the
SAME directory, ``flush`` + ``fsync`` it (durability — rename alone only
orders metadata), then ``os.replace`` onto the destination (atomicity — a
reader sees the old file or the new file, never a mix), and best-effort
``fsync`` the directory so the rename itself survives a power cut.

Deliberately dependency-free (stdlib only, no package imports):
``utils/checkpoint.py`` sits below this module's consumers in the import
graph, so this file must never import back into the package.
"""

from __future__ import annotations

import contextlib
import json
import os


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a completed rename survives a power
    cut.  Some filesystems refuse O_RDONLY dir fds — never fatal: the
    rename is still atomic, only its durability window widens."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb"):
    """``with atomic_write(path) as fh: fh.write(...)`` — the temp + fsync +
    rename discipline (module docstring).  On ANY exception inside the
    block the temp file is removed and the destination is untouched — a
    kill or a failed writer can never leave a half-written artifact under
    the real name."""
    if "r" in mode or "a" in mode or "+" in mode:
        raise ValueError(f"atomic_write is write-only, got mode {mode!r}")
    tmp = f"{path}.tmp.{os.getpid()}"
    fh = open(tmp, mode)
    try:
        yield fh
        fh.flush()
        os.fsync(fh.fileno())
    except BaseException:
        fh.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    fh.close()
    os.replace(tmp, path)
    _fsync_dir(path)


def sweep_temp_litter(directory: str, prefix: str) -> None:
    """Remove stranded ``<prefix>*.tmp.<pid>`` files a killed writer left
    behind — the ONE sweep policy of every litter site (checkpoint
    directories; the reference's obs run directories share it).

    MUST only be called from the single legitimate writer of
    ``directory`` (the coordinator's save path, the recorder owner): the
    pid suffix makes temp names unique per process, but another HOST
    cannot tell a dead writer's temp from a live one's — a restarted
    non-writer rank sweeping a shared filesystem could unlink the
    coordinator's in-flight temp mid-save."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if name.startswith(prefix) and ".tmp." in name:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def atomic_write_json(path: str, obj, indent: int | None = 1) -> None:
    """Atomically (re)write one JSON document: a kill mid-rewrite leaves
    the PREVIOUS document parseable, never a truncated one (the
    reference's run manifest rides this; the port's run recorder is
    ROADMAP A10)."""
    with atomic_write(path, "w") as fh:
        json.dump(obj, fh, indent=indent)
