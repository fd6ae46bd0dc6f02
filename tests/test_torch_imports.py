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


def test_scan_sees_the_offline_pipeline_modules():
    """The offline pipeline (prep and partition CLIs, the native binding,
    the file family, the generators) is in the scan, so it too imports
    nothing of JAX or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for rel in (("io", "config.py"), ("io", "mtx.py"), ("io", "datasets.py"),
                ("prep", "normalize.py"), ("prep", "__main__.py"),
                ("partition", "native.py"), ("partition", "emit.py"),
                ("partition", "random_part.py"),
                ("partition", "__init__.py"), ("partition", "__main__.py")):
        assert os.path.join("sgcn_tpu_torch", *rel) in names


def test_scan_sees_the_stale_halo_modules():
    """The stale-halo trainer's modules (its own copy of the reference's
    ``CommController`` included) are in the scan, so they too import
    nothing of JAX or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for rel in (("train", "controller.py"), ("train", "fullbatch.py"),
                ("models", "gcn.py"), ("ops", "pspmm.py"),
                ("ops", "tile_spmm.py"), ("parallel", "plan.py"),
                ("utils", "stats.py")):
        assert os.path.join("sgcn_tpu_torch", *rel) in names


def test_scan_sees_the_replica_modules_and_names():
    """The hot-halo replica modules are in the scan, and the names the
    replica modes run on live in them (the destination-indexed pack and
    its plain version, the replica exchanges and converters, the replica
    op, the replica forward, the plan's replica layout), so none of it
    imports JAX or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    want = {("ops", "row_shuffle.py"): ("row_pack_into",
                                        "row_pack_into_plain"),
            ("ops", "pspmm.py"): ("replica_pack", "partial_refresh",
                                  "partial_refresh_grad",
                                  "carry_replica_rows",
                                  "carry_set_replica_rows"),
            ("ops", "tile_spmm.py"): ("PspmmTilesReplica",
                                      "pspmm_tiles_replica"),
            ("models", "gcn.py"): ("gcn_forward_local_replica",),
            ("parallel", "plan.py"): ("choose_replica_budget",
                                      "ensure_replicas",
                                      "replica_carry_shapes"),
            ("train", "__main__.py"): ("--replica-budget",
                                       "--refresh-band")}
    for rel, defs in want.items():
        path = os.path.join("sgcn_tpu_torch", *rel)
        assert path in names
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        for d in defs:
            assert d in text, (path, d)


def test_scan_sees_the_minibatch_and_shp_modules():
    """The stochastic hypergraph partitioner and the mini-batch trainer
    are in the scan, and the names they run on live in them, so none of
    it imports JAX or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    want = {("shp", "__init__.py"): ("run_shp",),
            ("shp", "model.py"): ("sample_sparse_submatrix",
                                  "generate_stochastic_hypergraph",
                                  "communication_volume", "simulate",
                                  "run_shp"),
            ("shp", "__main__.py"): ("write_partvec_pickle",),
            ("train", "minibatch.py"): ("sample_batches", "sample_adjacency",
                                        "MiniBatchTrainer",
                                        "run_epochs_fused",
                                        "evaluate_fullgraph"),
            ("parallel", "plan.py"): ("pad_comm_plan", "shared_ell_buckets"),
            ("train", "__main__.py"): ("--batch-size",
                                       "_fit_minibatch_durable")}
    for rel, defs in want.items():
        path = os.path.join("sgcn_tpu_torch", *rel)
        assert path in names
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        for d in defs:
            assert d in text, (path, d)


def test_scan_sees_the_subgraph_serving_modules():
    """Sub-graph serving (the recipes, the compact layout and forwards,
    the stabilizers, the FLOP gauges, the CLI flags) is in the scan, and
    the names it runs on live in it, so none of it imports JAX or the JAX
    package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    want = {("serve", "subgraph.py"): ("SubgraphIndex", "build_batch",
                                       "subgraph_forward_gcn",
                                       "subgraph_forward_gat",
                                       "compact_gat_aggregate"),
            ("serve", "batcher.py"): ("pad_pow2",),
            ("serve", "engine.py"): ("_submit_subgraph",
                                     "_refresh_stabilizers"),
            ("serve", "__main__.py"): ("--serve-mode", "--concurrent",
                                       "--shed-factor"),
            ("obs", "attribution.py"): ("forward_flops",
                                        "subgraph_batch_flops"),
            ("models", "gat.py"): ("collect_stabilizers",),
            ("ops", "tile_spmm.py"): ("stack_tile_family",),
            ("parallel", "plan.py"): ("halo_global_rows",)}
    for rel, defs in want.items():
        path = os.path.join("sgcn_tpu_torch", *rel)
        assert path in names
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        for d in defs:
            assert d in text, (path, d)


def test_scan_sees_the_telemetry_modules():
    """Run telemetry (the schema's copy, the recorder, the trace parser and
    its one kernel-name table, the memory model, the trainers' and the
    engine's hooks, the CLI flags) is in the scan, and the names it runs
    on live in it, so none of it imports JAX or the JAX package; and
    ``chip_smoke.py`` classifies the card's kernels through that table
    instead of a copy of its own."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    want = {("obs", "schema.py"): ("SCHEMA_VERSION = 6", "validate_event",
                                   "validate_manifest"),
            ("obs", "recorder.py"): ("class RunRecorder", "def load_run",
                                     "set_backend", "record_memory"),
            ("obs", "tracing.py"): ("KERNEL_TABLE", "class SpanTimer",
                                    "def summarize_trace", "profile_to"),
            ("obs", "memory.py"): ("def memory_model", "MemoryBudgetError",
                                   "def parse_bytes", "measure_device_step",
                                   "MEM_MODEL_TOL = 2.5"),
            ("obs", "__init__.py"): ("RunRecorder", "memory_model"),
            ("train", "fullbatch.py"): ("attach_recorder", "measure_step"),
            ("models", "gcn.py"): ("use_reentrant=False",),
            ("models", "gat.py"): ("use_reentrant=False",),
            ("train", "minibatch.py"): ("attach_recorder",
                                        "_comm_snapshot",
                                        "minibatch_memory_model"),
            ("serve", "engine.py"): ("attach_recorder", "record_window",
                                     "record_swap"),
            ("resilience", "runner.py"): ("record_checkpoint",),
            ("train", "__main__.py"): ("--metrics-out", "--profile",
                                       "--memory-budget"),
            ("serve", "__main__.py"): ("--metrics-out", "--memory-budget")}
    for rel, defs in want.items():
        path = os.path.join("sgcn_tpu_torch", *rel)
        assert path in names
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        for d in defs:
            assert d in text, (path, d)
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    assert "kernel_label" in smoke and "phase_telemetry" in smoke
    for key in ('"tile_spmm_fused_kernel"', '"row_pack_kernel"',
                '"sm90_xmma"', '"roll_cuda"'):
        assert key not in smoke, key


def test_scan_sees_the_rank_runtime_and_baseline_modules():
    """The broadcast baseline, its CLI, the dispatcher, the shard proxy
    and the rank group are in the scan, so they too import nothing of JAX
    or the JAX package."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    want = {("__main__.py",): ("_TOOLS",),
            ("baselines", "cagnet1d.py"): ("class BroadcastGCN1D",
                                           "def broadcast_edge_lists"),
            ("baselines", "__main__.py"): ('"oracle"', '"cagnet"'),
            ("parallel", "proxy.py"): ("def shard_proxy_plan",
                                       "def shard_proxy_data", "REBASE"),
            ("parallel", "mesh.py"): ("class RankGroup",
                                      "def init_rank_group"),
            ("parallel", "plan.py"): ("PER_CHIP_ARRAY_FIELDS",
                                      "REBASED_ARRAY_FIELDS",
                                      "def relabel_plan")}
    for rel, defs in want.items():
        path = os.path.join("sgcn_tpu_torch", *rel)
        assert path in names
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read()
        for d in defs:
            assert d in text, (path, d)
