"""Child-process entry of the port's kill-and-resume tests
(``tests/test_torch_checkpoint.py``, ``tests/test_torch_cuda.py``).

A test starts ``run_train_cli`` in a fresh interpreter
(``torch.multiprocessing`` with the ``spawn`` context) and reads the
child's ``exitcode``: 43 (``resilience.faults.FAULT_EXIT_CODE``) when the
injected fault killed it after a save.  ``$SGCN_FAULT`` is set here, in the
child, before the trainer CLI builds anything.  The CLI's standard output
and the warnings it raised land in a JSON file the test reads.  Imports
no JAX, so the card's machine can run it too.
"""

import contextlib
import io
import json
import os
import warnings


def run_train_cli(argv, fault, out_path, threads=2):
    """``python -m sgcn_tpu_torch.train argv`` in this process, under
    ``$SGCN_FAULT=fault`` (``None``: no fault); writes ``{"stdout",
    "warnings"}`` to ``out_path`` when the CLI returns."""
    if fault:
        os.environ["SGCN_FAULT"] = fault
    else:
        os.environ.pop("SGCN_FAULT", None)
    import torch

    torch.set_num_threads(threads)
    from sgcn_tpu_torch.train.__main__ import main

    out = io.StringIO()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(out):
        warnings.simplefilter("always")
        main(list(argv))
    with open(out_path, "w") as fh:
        json.dump({"stdout": out.getvalue(),
                   "warnings": [str(w.message) for w in caught]}, fh)


def spawn_all(jobs, timeout=300.0):
    """Run every ``(argv, fault, out_path)`` job in its own spawned child,
    all at once; returns their exit codes in order.  A child still alive
    after ``timeout`` seconds is terminated and reported as ``None``."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run_train_cli, args=job) for job in jobs]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.terminate()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def read_result(out_path) -> dict:
    """The child's result: its standard output's last line as the CLI's
    JSON report (``report``) and the warnings it raised."""
    with open(out_path) as fh:
        res = json.load(fh)
    res["report"] = json.loads(res["stdout"].strip().splitlines()[-1])
    return res
