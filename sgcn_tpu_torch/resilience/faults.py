"""Deterministic fault injection — the harness that PROVES the resume story
(port of ``sgcn_tpu/resilience/faults.py``).

A checkpoint/resume layer that has never been killed mid-flight is a story,
not a contract.  This module gives the integration tests (and an operator
doing a game-day drill) env/CLI-driven faults that are deterministic in the
step sequence — no wall-clock, no randomness beyond a fixed seed — so the
crash-resume bit-identity tests (``tests/test_torch_checkpoint.py`` on the
CPU, ``chip_smoke.py`` on the card) kill a REAL training run at a named
step, resume it in a new process, and pin ``==`` parity against the
uninterrupted run.

``$SGCN_FAULT`` grammar (one fault per process):

  * ``kill-after-save:<step>`` — hard ``os._exit(FAULT_EXIT_CODE)`` the
    moment the durable checkpoint at optimizer step ``<step>`` has been
    fully written (fsync'd, renamed, rotated).  The hard exit is the point:
    no atexit handlers, no buffered-write flushes — the closest a test can
    get to a preemption.
  * ``corrupt-after-save:<step>[:<mode>]`` — after the step-``<step>`` save
    completes, corrupt that checkpoint file in place (``bitflip`` default,
    or ``truncate``) and THEN hard-exit: the resume must detect the
    corruption via the checksum loader and fall back to the previous intact
    checkpoint — the fallback path, driven end to end by the harness, never
    by hand-staged files.
  * ``stall:<phase>:<seconds>`` — sleep injection at a named phase hook
    (``maybe_stall``): the heartbeat-stall fault.  In the reference the
    multichip dryrun hooks ``'dryrun'``; a stalled child stops
    heartbeating, which is exactly what the parent's stalled-vs-slow
    classifier (``classify_stall``) must distinguish from a merely slow
    child whose heartbeats keep advancing.  The port has no heartbeat
    writer yet (ROADMAP A10); ``classify_stall`` reads the reference's
    ``heartbeat.jsonl`` layout.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

# the heartbeat file of a run directory (the reference's
# ``obs/schema.py::HEARTBEAT_NAME``)
HEARTBEAT_NAME = "heartbeat.jsonl"

# distinctive exit code the hard kill uses — tests assert it so an ordinary
# crash (rc 1) or an external timeout (rc 124) can never masquerade as a
# successful fault injection
FAULT_EXIT_CODE = 43
FAULT_ENV = "SGCN_FAULT"

CORRUPT_MODES = ("bitflip", "truncate")


@dataclass(frozen=True)
class FaultSpec:
    kind: str                    # 'kill-after-save'|'corrupt-after-save'|'stall'
    step: int | None = None      # the triggering optimizer step (save faults)
    phase: str | None = None     # the triggering phase hook (stall)
    seconds: float | None = None  # stall duration
    mode: str = "bitflip"        # corruption flavor


def _grammar_error(text: str) -> ValueError:
    return ValueError(
        f"unparseable {FAULT_ENV}={text!r} — grammar: "
        "'kill-after-save:<step>', 'corrupt-after-save:<step>[:<mode>]' "
        f"(mode in {CORRUPT_MODES}), 'stall:<phase>:<seconds>'")


def parse_fault(text: str) -> FaultSpec:
    """Parse one ``$SGCN_FAULT`` value; raises ``ValueError`` with the
    grammar on anything malformed — a typo'd fault spec silently injecting
    nothing would make a green harness test meaningless."""
    parts = text.split(":")
    kind = parts[0]
    try:
        if kind == "kill-after-save" and len(parts) == 2:
            return FaultSpec(kind=kind, step=int(parts[1]))
        if kind == "corrupt-after-save" and len(parts) in (2, 3):
            mode = parts[2] if len(parts) == 3 else "bitflip"
            if mode not in CORRUPT_MODES:
                raise _grammar_error(text)
            return FaultSpec(kind=kind, step=int(parts[1]), mode=mode)
        if kind == "stall" and len(parts) == 3:
            return FaultSpec(kind=kind, phase=parts[1],
                             seconds=float(parts[2]))
    except ValueError as e:
        raise _grammar_error(text) from e
    raise _grammar_error(text)


def active_fault() -> FaultSpec | None:
    """The process's injected fault, or None.  Parsed fresh each call (two
    lookups per checkpoint — negligible next to the save itself)."""
    text = os.environ.get(FAULT_ENV)
    return parse_fault(text) if text else None


def _hard_exit() -> None:
    # flush what the run already printed (the test reads the partial log),
    # then die without cleanup — atexit/finally handlers running would make
    # this a graceful shutdown, not a preemption
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(FAULT_EXIT_CODE)


def corrupt_file(path: str, mode: str = "bitflip", seed: int = 0) -> None:
    """Deterministically damage one file in place.

    ``bitflip`` inverts a single byte two-thirds of the way in (past the
    zip directory headers of an ``.npz``, inside array data — the damage a
    checksum must catch because the container still parses); ``truncate``
    cuts the file to 60% (the kill-mid-write shape — the container itself
    no longer parses).  ``seed`` perturbs the bitflip offset so tests can
    hit several positions deterministically."""
    if mode not in CORRUPT_MODES:
        raise ValueError(f"corruption mode {mode!r} not in {CORRUPT_MODES}")
    size = os.path.getsize(path)
    if size < 4:
        raise ValueError(f"{path}: {size} bytes — nothing to corrupt")
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(int(size * 0.6))
        return
    off = (2 * size // 3 + seed * 37) % size
    with open(path, "r+b") as fh:
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 0xFF]))


def after_checkpoint_save(path: str, step: int) -> None:
    """The kill point — called by the durable-checkpoint writer
    (``resilience.runner``) immediately after the step-
    ``step`` save has been fully committed.  No-op without a matching
    ``$SGCN_FAULT``."""
    f = active_fault()
    if f is None or f.step != step:
        return
    if f.kind == "corrupt-after-save":
        corrupt_file(path, mode=f.mode)
        _hard_exit()
    if f.kind == "kill-after-save":
        _hard_exit()


def maybe_stall(phase: str) -> None:
    """The stall hook — a named phase (e.g. the dryrun's step phase) sleeps
    for the injected duration, emitting no heartbeats meanwhile.  No-op
    without a matching ``stall:<phase>:...`` fault."""
    f = active_fault()
    if f is not None and f.kind == "stall" and f.phase == phase:
        time.sleep(f.seconds)


# --------------------------------------------------- stalled-vs-slow reader
def classify_stall(rundir: str, now: float | None = None,
                   threshold_s: float = 60.0,
                   exclude_pid: int | None = None
                   ) -> tuple[str, float | None]:
    """Classify a deadline-blown child from its heartbeat trail:
    ``('slow', age)`` when the last heartbeat in
    ``rundir/heartbeat.jsonl`` is fresher than ``threshold_s`` (the child
    was advancing, just not fast enough), ``('stalled', age)`` when it is
    older (the child stopped making progress), and
    ``('stalled', None)`` when no heartbeat was ever observed — a child
    that never reached its first phase is indistinguishable from a wedged
    one, so it classifies as stalled.  ``exclude_pid`` drops the CALLER's
    own pings (parent and child share one heartbeat file — a child that
    wedged before its first heartbeat must not be judged "slow" off the
    parent's spawn ping).  Pure file read: usable from the parent's
    timeout handler without touching the dead child."""
    now = time.time() if now is None else float(now)
    path = os.path.join(rundir, HEARTBEAT_NAME)
    last_ts = None
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if exclude_pid is not None and ev.get("pid") == exclude_pid:
                    continue
                ts = ev.get("ts")
                if isinstance(ts, (int, float)):
                    last_ts = float(ts)
    except OSError:
        return "stalled", None
    if last_ts is None:
        return "stalled", None
    age = max(0.0, now - last_ts)
    return ("slow" if age <= threshold_s else "stalled"), age
