"""The port's static-analysis tool (port of ``sgcn_tpu/analysis``;
``docs/torch_static_analysis.md``).

Numeric parity tests cannot see a dispatch regression: an extra exchange,
a float32 wire under ``--halo-dtype bfloat16``, weights reallocated
instead of updated, or a host read inside a step all pass every ``rtol``.
This package makes those contracts machine-checked for every mode the
port supports:

  * :mod:`~sgcn_tpu_torch.analysis.modes` — the mode matrix (one source
    of truth for what the port supports);
  * :mod:`~sgcn_tpu_torch.analysis.expect` — plan-derived expectations;
  * :mod:`~sgcn_tpu_torch.analysis.census` — one step of every mode on
    the reference's audit fixture, its kernel launches and collectives
    recorded through the wrappers' census hooks (``utils/census.py``) and
    held to the expectation (the reference's ``hlo_audit``);
  * :mod:`~sgcn_tpu_torch.analysis.ast_rules` — the source hygiene rules;
  * :mod:`~sgcn_tpu_torch.analysis.registry` — the plan consumer tuples
    (``tests/test_torch_plan_contract.py``).

CLI: ``python -m sgcn_tpu_torch.analysis [--fast] [--json] [--out FILE]
[--no-census] [--no-ast] [--memory] [--device cpu]``.
"""

from __future__ import annotations

ANALYSIS_SCHEMA = "sgcn_analysis_report"
ANALYSIS_SCHEMA_VERSION = 1


def build_report(fast: bool = False, census: bool = True,
                 ast_pass: bool = True, root: str | None = None,
                 memory: bool = False, device=None) -> dict:
    """Run the requested passes and assemble the report: ``ast`` (the
    hygiene rules), ``census`` (the launch and collective census of the
    mode matrix on ``device``: ``None`` is the card, ``'cpu'`` the CPU's
    plain versions) and, with ``memory``, ``memory`` (one measured step
    per mode reconciled with the analytic model; the card only — it
    raises on the CPU)."""
    report: dict = {
        "schema": ANALYSIS_SCHEMA,
        "v": ANALYSIS_SCHEMA_VERSION,
        "fast": bool(fast),
        "ok": True,
    }
    if ast_pass:
        from .ast_rules import run_ast_pass

        report["ast"] = run_ast_pass(root)
        report["ok"] = report["ok"] and report["ast"]["ok"]
    if census or memory:
        import torch

        from ..utils.backend import resolve_device

        dev = resolve_device(device)
        report["torch"] = torch.__version__
    if memory:
        from .census import memory_pass

        # before the census: the memory pass refuses the CPU outright
        report["memory"] = memory_pass(fast=fast, device=dev)
        report["ok"] = report["ok"] and report["memory"]["ok"]
    if census:
        from .census import run_census

        report["census"] = run_census(fast=fast, device=dev)
        report["ok"] = report["ok"] and report["census"]["ok"]
    return report
