"""The port stands alone: no module of ``sgcn_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``optax`` or the JAX package
``sgcn_tpu`` (whose ``__init__`` imports jax even for its numpy-only
modules).  An AST scan,
so imports inside functions count too."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "sgcn_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "sgcn_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_sees_the_package_and_matches_exact_names():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("sgcn_tpu_torch", "ops", "tile_spmm.py") in names
    # the exact-name rule: the port's own package is allowed
    tree = ast.parse("import sgcn_tpu_torch.ops\nfrom sgcn_tpu.ops import x")
    roots = [n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tree.body]
    assert [r in FORBIDDEN for r in roots] == [False, True]


def test_scan_sees_the_checkpoint_and_resilience_modules():
    """The checkpoint layer (its own copy of ``plan_digest`` included) is
    in the scan, so it too imports nothing of JAX or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for rel in (("obs", "recorder.py"), ("utils", "checkpoint.py"),
                ("resilience", "atomic.py"), ("resilience", "checkpoint.py"),
                ("resilience", "faults.py"), ("resilience", "runner.py"),
                ("resilience", "__init__.py")):
        assert os.path.join("sgcn_tpu_torch", *rel) in names
