"""The AST hygiene pass over the port's sources (port of
``sgcn_tpu/analysis/ast_rules.py``).

A registry of source rules run over ``sgcn_tpu_torch/**`` with ``ast``:
no scanned module is imported, so no import-time behaviour can defeat a
rule, and every rule function takes ``(relpath, src)`` so a test can feed
it a seeded violation.  Each rule reads the reference's in torch terms:

  * ``traced-host-free`` (``ops/``, ``models/``) — no host clock
    (``time.*``), no numpy RNG (``np.random.*``), and no draw from torch's
    GLOBAL generator (``torch.rand``/``randn``/``randint``/``randperm``/
    ``normal``/``rand_like``/``randn_like``/``randint_like`` called without
    ``generator=``, or ``torch.manual_seed``).  The reference's reason is a
    host value frozen into a traced program; eager torch has no trace, but
    the same calls in per-step code break the port's own contract: every
    random draw comes from an explicit ``torch.Generator`` (the
    ``params_from_jax`` parity tests and ``tools/repeat_run.py`` rely on
    two runs drawing the same numbers), and a host clock inside a step is
    per-step host work the step's census cannot see.  ``ops/_build.py``
    is outside the scope (``TRACED_EXEMPT``): it builds the kernels
    with nvcc once, before the first launch, and times the build;
  * ``sanctioned-sync-only`` (``train/``, ``serve/``, ``ops/``,
    ``models/``, ``obs/``, ``utils/``) — no direct
    ``torch.cuda.synchronize``, ``Event.synchronize`` or
    ``Stream.synchronize``: every device wait goes through
    ``utils/backend.py::synchronize`` or a timer's ``sync=`` callable
    (``utils/timers.py``), the two sanctioned homes (``SYNC_ALLOWLIST``),
    so no wait slips past the measured-time accounting.  The reference's
    names (``block_until_ready``, ``device_get``) do not exist in torch;
  * ``consumer-registered`` (``sgcn_tpu_torch/**``) — every module-level
    ``*_FIELDS*`` tuple of strings is registered in
    ``registry.CONSUMER_TUPLE_SOURCES`` (or is a classification tuple);
  * ``mode-flag-enumerated`` (the train and serve CLIs) — every
    ``--comm-*`` / ``--halo-*`` flag maps to a mode-matrix axis
    (``modes.MODE_FLAGS``) or a recorded non-axis
    (``modes.NON_AXIS_FLAGS``), and every axis flag exists on the trainer
    CLI.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

PKG = "sgcn_tpu_torch"

# modules whose function bodies are per-step device code
TRACED_PREFIXES = (f"{PKG}/ops/", f"{PKG}/models/")
# ... minus the kernels' nvcc build: it runs once, before any step, and its
# perf_counter reads time the build
TRACED_EXEMPT = (f"{PKG}/ops/_build.py",)
# layers where a raw device wait would bypass the span accounting
SYNC_SCOPED_PREFIXES = tuple(f"{PKG}/{d}/" for d in
                             ("train", "serve", "ops", "models", "obs",
                              "utils"))
# the sanctioned homes of a device wait: backend.synchronize (every
# wait of the package goes through it) and the timers' sync= hook
SYNC_ALLOWLIST = (f"{PKG}/utils/backend.py", f"{PKG}/utils/timers.py")

# the CLIs whose mode-like flags must be enumerator-covered
MODE_FLAG_FILES = (f"{PKG}/train/__main__.py", f"{PKG}/serve/__main__.py")
_MODE_LIKE_RE = re.compile(r"^--(comm|halo)-")

_FIELDS_NAME_RE = re.compile(r"^_?[A-Z][A-Z0-9_]*_FIELDS[A-Z0-9_]*$")

# PREFIX roots (the whole dotted name starts with these)
_HOST_TIME_ROOTS = ("time.", "random.")
# CONTAINMENT roots (numpy's RNG, wherever it is reached from)
_HOST_RNG_ROOTS = ("np.random.", "numpy.random.")
# torch's draws that read the global generator unless given generator=
_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "normal",
                "rand_like", "randn_like", "randint_like", "bernoulli",
                "multinomial", "poisson")
# ... and what reseeds it
_TORCH_SEEDS = ("manual_seed", "seed")
# a device wait: torch.cuda.synchronize, or .synchronize() on an Event or
# Stream (any object: a method named synchronize is a wait)
_SYNC_CALLS = ("torch.cuda.synchronize",)


def _dotted(node: ast.AST) -> str:
    """Dotted name of a call target anchored at a plain Name
    (``np.random.default_rng``); ``''`` for chains rooted in a call or a
    subscript."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


@dataclass(frozen=True)
class Rule:
    name: str
    scope: str          # human-readable scope (the docs table)
    fn: object          # (relpath, src) -> list[str]

    def applies(self, relpath: str) -> bool:
        return _SCOPES[self.name](relpath)


def _import_aliases(tree: ast.AST) -> dict:
    """Local name → dotted origin for every import binding (``import time
    as t``, ``from numpy.random import default_rng``, ``from torch import
    randn``), so aliased spellings resolve before matching."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    aliases[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _resolved(node: ast.Call, aliases: dict) -> tuple[str, str]:
    """``(as written, canonical)`` dotted names of a call's target."""
    name = _dotted(node.func)
    if not name:
        return "", ""
    head, _, rest = name.partition(".")
    return name, aliases.get(head, head) + (f".{rest}" if rest else "")


def rule_traced_host_free(relpath: str, src: str) -> list[str]:
    tree = ast.parse(src)
    aliases = _import_aliases(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name, resolved = _resolved(node, aliases)
        if not name:
            continue
        dn = resolved + "."
        if dn.startswith(_HOST_TIME_ROOTS) or any(
                r in dn for r in _HOST_RNG_ROOTS):
            out.append(f"{relpath}:{node.lineno}: call to {name}() "
                       f"(= {resolved}) in per-step device code — a host "
                       "clock or host RNG inside a step is host work the "
                       "step's census cannot see; compute it outside and "
                       "pass it in")
            continue
        mod, _, fn = resolved.rpartition(".")
        if mod == "torch" and fn in _TORCH_SEEDS:
            out.append(f"{relpath}:{node.lineno}: {name}() reseeds torch's "
                       "global generator in per-step device code — draw "
                       "from an explicit torch.Generator")
        elif mod == "torch" and fn in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            out.append(f"{relpath}:{node.lineno}: {name}() draws from "
                       "torch's global generator (no generator=) in "
                       "per-step device code — every draw of the port comes "
                       "from an explicit torch.Generator, or two runs (and "
                       "the parity tests) draw different numbers")
    return out


def rule_sanctioned_sync_only(relpath: str, src: str) -> list[str]:
    tree = ast.parse(src)
    aliases = _import_aliases(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        _name, resolved = _resolved(node, aliases)
        fn = node.func
        method = fn.attr if isinstance(fn, ast.Attribute) else None
        if resolved in _SYNC_CALLS or method == "synchronize":
            what = resolved or f".{method}"
            out.append(f"{relpath}:{node.lineno}: direct {what}() — device "
                       "waits go through utils/backend.py::synchronize (or "
                       "a timer's sync= callable, utils/timers.py) so the "
                       "measured-time accounting sees them")
    return out


def rule_consumer_registered(relpath: str, src: str) -> list[str]:
    from .registry import known_fields_names

    known = known_fields_names()
    out = []
    tree = ast.parse(src)
    for node in tree.body:                      # module level only
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            targets = [node.target]
        for t in targets:
            if not _FIELDS_NAME_RE.match(t.id):
                continue
            val = node.value
            if not (isinstance(val, ast.Tuple) and val.elts and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in val.elts)):
                continue                        # not a field-name tuple
            if t.id not in known:
                out.append(
                    f"{relpath}:{node.lineno}: {t.id} is a *_FIELDS* "
                    "string tuple not registered in analysis/registry.py "
                    "CONSUMER_TUPLE_SOURCES — the plan-contract lint "
                    "cannot validate what it does not know about")
    return out


def rule_mode_flag_enumerated(sources: dict) -> list[str]:
    """Cross-file rule over ``MODE_FLAG_FILES``: takes ``{relpath: src}``."""
    from .modes import MODE_FLAGS, NON_AXIS_FLAGS

    out = []
    train_flags: set = set()
    for relpath, src in sources.items():
        for node in ast.walk(ast.parse(src)):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument" and node.args):
                continue
            for arg in node.args:
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    continue
                flag = arg.value
                if relpath.endswith("train/__main__.py"):
                    train_flags.add(flag)
                if _MODE_LIKE_RE.match(flag) and flag not in MODE_FLAGS \
                        and flag not in NON_AXIS_FLAGS:
                    out.append(
                        f"{relpath}:{node.lineno}: mode-like flag {flag} "
                        "is neither a mode-matrix axis (modes.MODE_FLAGS) "
                        "nor a recorded non-axis (modes.NON_AXIS_FLAGS) — "
                        "a transport/wire knob outside the censused matrix")
    if train_flags:
        for flag in MODE_FLAGS:
            if flag not in train_flags:
                out.append(
                    f"modes.MODE_FLAGS names {flag}, which the trainer CLI "
                    "does not define — a dead matrix axis")
    return out


_SCOPES = {
    "traced-host-free":
        lambda p: p.startswith(TRACED_PREFIXES) and p not in TRACED_EXEMPT,
    "sanctioned-sync-only":
        lambda p: (p.startswith(SYNC_SCOPED_PREFIXES)
                   and p not in SYNC_ALLOWLIST),
    "consumer-registered":
        lambda p: p.startswith(f"{PKG}/"),
    "mode-flag-enumerated":
        lambda p: p in MODE_FLAG_FILES,
}

RULES = (
    Rule("traced-host-free", f"{PKG}/{{ops,models}}/ minus ops/_build.py",
         rule_traced_host_free),
    Rule("sanctioned-sync-only",
         f"{PKG}/{{train,serve,ops,models,obs,utils}}/ minus "
         "utils/backend.py, utils/timers.py",
         rule_sanctioned_sync_only),
    Rule("consumer-registered", f"{PKG}/**", rule_consumer_registered),
    Rule("mode-flag-enumerated", "train/serve CLIs (cross-file)",
         rule_mode_flag_enumerated),
)


def _iter_sources(root: str):
    pkg = os.path.join(root, PKG)
    for dirpath, dirs, files in os.walk(pkg):
        dirs.sort()
        for name in sorted(files):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield os.path.relpath(full, root).replace(os.sep, "/"), full


def run_ast_pass(root: str | None = None) -> dict:
    """Run every rule over the package; returns the report's ``ast``
    block: ``{rules: {name: {ok, violations}}, ok, files}``."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    per_file_rules = [r for r in RULES if r.name != "mode-flag-enumerated"]
    results = {r.name: [] for r in RULES}
    mode_sources: dict = {}
    nfiles = 0
    for relpath, full in _iter_sources(root):
        nfiles += 1
        with open(full) as fh:
            src = fh.read()
        for r in per_file_rules:
            if r.applies(relpath):
                results[r.name] += r.fn(relpath, src)
        if relpath in MODE_FLAG_FILES:
            mode_sources[relpath] = src
    results["mode-flag-enumerated"] = rule_mode_flag_enumerated(mode_sources)
    return {
        "rules": {name: {"ok": not v, "violations": v}
                  for name, v in results.items()},
        "ok": all(not v for v in results.values()),
        "files": nfiles,
    }
