"""The resumable training loop — steps, durable checkpoints, kill points
(port of ``sgcn_tpu/resilience/runner.py``).

``run_resumable`` is the loop behind the trainer CLI's
``--checkpoint-every N`` / ``--resume auto`` flags: it runs optimizer steps
``start_step .. total_steps-1`` one at a time, saves a durable full-state
checkpoint every ``checkpoint_every`` steps through a
``CheckpointManager``, and calls the fault-injection kill point
(``faults.after_checkpoint_save``) immediately after each committed save —
exactly where a preemption that the checkpoint survives would land.

The resume CONTRACT this loop upholds (``tests/test_torch_checkpoint.py``
on the CPU, ``chip_smoke.py`` on the card): *train s steps → checkpoint →
new process → resume → train t−s steps* yields losses, weights and Adam
state ``==`` (float32 bit for bit) the uninterrupted t-step run, with
cumulative CommStats totals that reconcile across the seam.

The port has no run recorder yet (ROADMAP A10): ``recorder=None`` is the
only path, and no checkpoint or summary event is written anywhere.
"""

from __future__ import annotations

import time

from . import faults


def save_and_record(manager, state_holder, step: int, recorder=None) -> str:
    """The ONE durable-commit protocol: atomic save through the manager,
    then the fault-injection kill point.  Returns the committed path.
    ``recorder`` must be ``None`` (the reference emits its checkpoint event
    here; the port's recorder is ROADMAP A10)."""
    if recorder is not None:
        raise NotImplementedError(
            "the run recorder is not ported yet (ROADMAP A10)")
    path = manager.save(state_holder, step=step)
    # the kill point: a fault-injected run dies HERE, after the save
    # committed — the closest a test gets to a preemption
    faults.after_checkpoint_save(path, step)
    return path


def run_resumable(trainer, data, total_steps: int, *, manager=None,
                  checkpoint_every: int = 0, start_step: int = 0,
                  verbose: bool = True) -> dict:
    """Run steps ``start_step..total_steps-1``; returns the end-of-run
    report (``CommStats.report()`` + ``steps``/``start_step``/``steps_run``
    /``elapsed_s``/``step_s_wall`` + the full-precision per-step ``losses``
    list — resumed runs report the steps THEY ran; the uninterrupted
    run's tail must match them float for float)."""
    if checkpoint_every < 0:
        raise ValueError(f"checkpoint_every must be >= 0, "
                         f"got {checkpoint_every}")
    if checkpoint_every and manager is None:
        raise ValueError("checkpoint_every > 0 needs a CheckpointManager")
    if not 0 <= start_step <= total_steps:
        raise ValueError(
            f"start_step {start_step} outside [0, {total_steps}] — the "
            "checkpoint is ahead of this run's schedule (asked for fewer "
            "total steps than were already trained?)")
    data = data.to(trainer.device)
    losses: list[float] = []
    t0 = time.perf_counter()
    for i in range(start_step, total_steps):
        loss = float(trainer.step(data))        # a device readback per step
        losses.append(loss)
        done = i + 1
        if verbose:
            print(f"step {done}: loss {loss:.6f}", flush=True)
        if manager is not None and checkpoint_every \
                and done % checkpoint_every == 0:
            save_and_record(manager, trainer, done)
    elapsed = time.perf_counter() - t0
    report = trainer.stats.report()
    steps_run = total_steps - start_step
    report.update(
        steps=total_steps,
        start_step=start_step,
        steps_run=steps_run,
        elapsed_s=elapsed,
        # deliberately NOT named epoch_s: fit()'s epoch_s excludes warm-up,
        # while this loop's wall includes the first step's kernel loads and
        # every save — one key for two measurements would poison any
        # cross-run epoch-time comparison
        step_s_wall=elapsed / max(steps_run, 1),
        losses=losses,
    )
    phases = trainer.timer.report()
    if phases:
        report["phases"] = phases
    if trainer.loss_name == "bce" and trainer.last_err is not None:
        # last_err is None on a zero-remaining-steps resume
        report["err"] = float(trainer.last_err)
    return report
