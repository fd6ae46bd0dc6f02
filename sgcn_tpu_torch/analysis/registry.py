"""The one registry of the port's ``CommPlan`` consumer contract tuples
(port of ``sgcn_tpu/analysis/registry.py``).

Every module-level ``*_FIELDS*`` tuple that names plan fields for
shipping or slicing is registered here: the plan-contract lint
(``tests/test_torch_plan_contract.py``) validates each entry against the
dataclass, the ELL chain layouts and the shard proxy, and the AST pass
(``ast_rules.rule_consumer_registered``) fails a new ``*_FIELDS*`` tuple
anywhere in the package that is not registered.

The registry is pure data (name → ``"module:attribute"``), so the AST
pass imports none of the modules it scans;
``resolve_consumer_tuples()`` imports them for the consumers that need
the values.
"""

from __future__ import annotations

import importlib

# every tuple that names plan fields for shipping or slicing: registered
# name → "defining.module:attribute" (strings only: no import at load)
CONSUMER_TUPLE_SOURCES = {
    # the tile kernel's GCN forward (a2a, asymmetric, the ring)
    "TILE_PLAN_FIELDS": "sgcn_tpu_torch.ops.tile_spmm:TILE_PLAN_FIELDS",
    "TILE_PLAN_FIELDS_GEN":
        "sgcn_tpu_torch.ops.tile_spmm:TILE_PLAN_FIELDS_GEN",
    "TILE_PLAN_FIELDS_RAGGED":
        "sgcn_tpu_torch.ops.tile_spmm:TILE_PLAN_FIELDS_RAGGED",
    # the tile kernel's GAT forward
    "GAT_PLAN_FIELDS_PALLAS":
        "sgcn_tpu_torch.models.gat:GAT_PLAN_FIELDS_PALLAS",
    "GAT_PLAN_FIELDS_PALLAS_RAGGED":
        "sgcn_tpu_torch.models.gat:GAT_PLAN_FIELDS_PALLAS_RAGGED",
    "GAT_PLAN_FIELDS_PALLAS_GEN":
        "sgcn_tpu_torch.models.gat:GAT_PLAN_FIELDS_PALLAS_GEN",
    # the ELL aggregator's (SGCN_PALLAS_SPMM=0): chain-layout keys
    "ELL_PLAN_FIELDS": "sgcn_tpu_torch.ops.pspmm:ELL_PLAN_FIELDS",
    "ELL_PLAN_FIELDS_RAGGED":
        "sgcn_tpu_torch.ops.pspmm:ELL_PLAN_FIELDS_RAGGED",
    "ELL_PLAN_FIELDS_GEN": "sgcn_tpu_torch.ops.pspmm:ELL_PLAN_FIELDS_GEN",
    "ELL_GAT_PLAN_FIELDS": "sgcn_tpu_torch.ops.pspmm:ELL_GAT_PLAN_FIELDS",
    "ELL_GAT_PLAN_FIELDS_RAGGED":
        "sgcn_tpu_torch.ops.pspmm:ELL_GAT_PLAN_FIELDS_RAGGED",
    "ELL_GAT_PLAN_FIELDS_GEN":
        "sgcn_tpu_torch.ops.pspmm:ELL_GAT_PLAN_FIELDS_GEN",
    # the replica modes: the reference's tuples under its names, the
    # port's stacked lists and a rank's
    "REPLICA_PLAN_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_PLAN_FIELDS",
    "REPLICA_PLAN_FIELDS_RAGGED":
        "sgcn_tpu_torch.parallel.plan:REPLICA_PLAN_FIELDS_RAGGED",
    "REPLICA_STALE_PLAN_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_STALE_PLAN_FIELDS",
    "REPLICA_STALE_PLAN_FIELDS_RAGGED":
        "sgcn_tpu_torch.parallel.plan:REPLICA_STALE_PLAN_FIELDS_RAGGED",
    "REPLICA_PARTIAL_PLAN_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_PARTIAL_PLAN_FIELDS",
    "REPLICA_TILE_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_TILE_FIELDS",
    "REPLICA_TILE_FIELDS_RAGGED":
        "sgcn_tpu_torch.parallel.plan:REPLICA_TILE_FIELDS_RAGGED",
    "REPLICA_PARTIAL_TILE_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_PARTIAL_TILE_FIELDS",
    "REPLICA_RANK_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_RANK_FIELDS",
    "REPLICA_RANK_FIELDS_RAGGED":
        "sgcn_tpu_torch.parallel.plan:REPLICA_RANK_FIELDS_RAGGED",
    "REPLICA_PARTIAL_RANK_FIELDS":
        "sgcn_tpu_torch.parallel.plan:REPLICA_PARTIAL_RANK_FIELDS",
    # the router reads global vertex-indexed arrays
    "SERVE_ROUTER_FIELDS": "sgcn_tpu_torch.serve.router:SERVE_ROUTER_FIELDS",
}

# the classification tuples (``parallel/plan.py``): they classify rather
# than ship — per part, global, and the port-only flat indices a slice
# re-bases (``parallel/proxy.py::REBASE``) — but are legitimate
# ``*_FIELDS*`` names the AST rule accepts
CLASSIFICATION_TUPLES = ("PER_CHIP_ARRAY_FIELDS", "_GLOBAL_ARRAY_FIELDS",
                         "REBASED_ARRAY_FIELDS")

CLASSIFICATION_SOURCE = "sgcn_tpu_torch.parallel.plan"


def known_fields_names() -> frozenset:
    """Every ``*_FIELDS*`` name the AST rule accepts — names only, no
    imports."""
    return (frozenset(CONSUMER_TUPLE_SOURCES)
            | frozenset(CLASSIFICATION_TUPLES))


def resolve_consumer_tuples() -> dict:
    """name → the live tuple, imported from its defining module (for the
    plan-contract lint).  A registered name that no longer exists raises:
    a stale registry entry fails loudly."""
    out = {}
    for name, src in CONSUMER_TUPLE_SOURCES.items():
        mod, _, attr = src.partition(":")
        out[name] = getattr(importlib.import_module(mod), attr)
    return out


def resolve_classification_tuples() -> dict:
    """name → the live classification tuple (``parallel/plan.py``)."""
    mod = importlib.import_module(CLASSIFICATION_SOURCE)
    return {name: getattr(mod, name) for name in CLASSIFICATION_TUPLES}
