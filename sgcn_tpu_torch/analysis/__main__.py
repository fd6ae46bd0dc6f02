"""Analysis CLI — ``python -m sgcn_tpu_torch.analysis``.

Runs the AST hygiene pass over ``sgcn_tpu_torch/`` and the launch and
collective census of every supported mode (``--fast``: the two-mode
subset) on the card, or on the CPU's plain versions with ``--device
cpu``, and prints the report (``--json``: one JSON line).  ``--memory``
adds one measured step per mode reconciled with the analytic footprint
model; it runs on the card only.

Exit code 1 on any violation.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="sgcn_tpu_torch static analysis: launch and collective "
                    "census + AST hygiene")
    p.add_argument("--fast", action="store_true",
                   help="census the 2-mode smoke subset instead of the "
                        "full matrix")
    p.add_argument("--json", action="store_true",
                   help="print the full report as ONE JSON line on stdout")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write the report JSON to FILE")
    p.add_argument("--no-census", action="store_true",
                   help="skip the census (AST pass only)")
    p.add_argument("--no-ast", action="store_true",
                   help="skip the AST pass (census only)")
    p.add_argument("--memory", action="store_true",
                   help="also measure one step of each mode on the card and "
                        "reconcile it with the analytic footprint model "
                        "(the memory-model rule; the card only)")
    p.add_argument("--device", default=None, choices=["cpu"],
                   help="run the census on the CPU's plain versions "
                        "(default: the card; without one this raises)")
    args = p.parse_args(argv)

    if args.memory and args.device == "cpu":
        p.error("--memory measures the card's allocator; it has nothing to "
                "measure on the CPU — drop --device cpu and run it on the "
                "card")
    if args.device == "cpu" and not args.no_census:
        import torch

        # the census's steps are tiny: threads only contend
        torch.set_num_threads(1)

    from . import build_report

    report = build_report(fast=args.fast, census=not args.no_census,
                          ast_pass=not args.no_ast, memory=args.memory,
                          device=args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        _human(report)
    return 0 if report["ok"] else 1


def _human(report: dict) -> None:
    if "ast" in report:
        for name, entry in sorted(report["ast"]["rules"].items()):
            print(f"ast     {name:24s} {'ok' if entry['ok'] else 'FAIL'}")
            for v in entry["violations"]:
                print(f"        - {v}")
    for block in ("memory", "census"):
        if block not in report:
            continue
        for mode_id, entry in sorted(report[block]["modes"].items()):
            extra = (f"  peak/model {entry['ratio']:.2f}"
                     if entry.get("ratio") is not None else "")
            print(f"{block:7s} {mode_id:40s} "
                  f"{'ok' if entry['ok'] else 'FAIL'}{extra}")
            progs = entry.get("programs", {"": entry})
            for label, prog in sorted(progs.items()):
                for v in prog["violations"]:
                    print(f"        - [{label}] {v['rule']}: {v['detail']}")
    print(f"analysis: {'clean' if report['ok'] else 'VIOLATIONS'}")


if __name__ == "__main__":
    sys.exit(main())
