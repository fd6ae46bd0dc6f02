"""Plan-contract lint of the port (the counterpart of
``tests/test_plan_contract.py``): the tuples that ship or slice plan
arrays stay in sync with ``CommPlan``, its ELL chain layouts and the shard
proxy.

The registry of the port's consumer tuples is
``sgcn_tpu_torch.analysis.registry``; this lint validates every entry on a
k = 4 plan with every lazy layout built (and a directed one for the
transposed layouts), and the AST pass (``analysis.ast_rules``) fails any
``*_FIELDS*`` tuple of the package that is not registered there.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from sgcn_tpu_torch.analysis import registry
from sgcn_tpu_torch.io.datasets import er_graph
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.parallel.plan import (_GLOBAL_ARRAY_FIELDS,
                                          PER_CHIP_ARRAY_FIELDS,
                                          REBASED_ARRAY_FIELDS, CommPlan)
from sgcn_tpu_torch.parallel.proxy import shard_proxy_plan
from sgcn_tpu_torch.partition import balanced_random_partition
from sgcn_tpu_torch.prep import normalize_adjacency

_REGISTRY = registry.resolve_consumer_tuples()
_CLASSIFIED = set(PER_CHIP_ARRAY_FIELDS) | set(_GLOBAL_ARRAY_FIELDS) | set(
    REBASED_ARRAY_FIELDS)
_DATACLASS = {f.name for f in dataclasses.fields(CommPlan)}
# the ELL tuples name chain-layout keys (CommPlan.ell_chains[layout]), by
# the layout each ships
_ELL_LAYOUTS = {"ELL_PLAN_FIELDS": "a2a", "ELL_PLAN_FIELDS_RAGGED": "ragged",
                "ELL_PLAN_FIELDS_GEN": "directed",
                "ELL_GAT_PLAN_FIELDS": "cell",
                "ELL_GAT_PLAN_FIELDS_RAGGED": "cell",
                "ELL_GAT_PLAN_FIELDS_GEN": "cell_t"}
# the tuples only an asymmetric plan builds
_DIRECTED = {"TILE_PLAN_FIELDS_GEN", "GAT_PLAN_FIELDS_PALLAS_GEN",
             "ELL_PLAN_FIELDS_GEN", "ELL_GAT_PLAN_FIELDS_GEN"}
# the reference's replica tuples, kept under its names: they name its
# ELL arrays (ell_idx, ...), which the port's plan keeps as the
# reference's fields
_REFERENCE_NAMED = {"REPLICA_PLAN_FIELDS", "REPLICA_PLAN_FIELDS_RAGGED",
                    "REPLICA_STALE_PLAN_FIELDS",
                    "REPLICA_STALE_PLAN_FIELDS_RAGGED",
                    "REPLICA_PARTIAL_PLAN_FIELDS"}


def _build(plan, directed: bool):
    plan.ensure_exchange()
    plan.ensure_cell()
    plan.ensure_pallas_tiles()
    plan.ensure_pallas_cell_tiles()
    if directed:
        plan.ensure_transpose_tiles()
        plan.ensure_cell_transpose_tiles()
        for layout in ("a2a", "directed", "cell_t"):
            plan.ensure_ell_chains(layout)
        return plan
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    plan.ensure_pallas_cell_ragged_tiles()
    plan.ensure_replicas(12)
    for layout in ("a2a", "ragged", "cell"):
        plan.ensure_ell_chains(layout)
    return plan


@pytest.fixture(scope="module")
def plans():
    """k = 4 plans, n ≠ k: a symmetric ER plan with every lazy layout and
    a directed one with the transposed layouts."""
    n, k = 200, 4
    pv = balanced_random_partition(n, k, seed=1)
    sym = _build(build_comm_plan(normalize_adjacency(er_graph(n, 6, seed=0)),
                                 pv, k), False)
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    keep = src != dst
    a = sp.csr_matrix((np.ones(keep.sum(), np.float32),
                       (src[keep], dst[keep])), shape=(n, n))
    a.data[:] = 1.0
    directed = build_comm_plan(normalize_adjacency(a), pv, k)
    assert not directed.symmetric
    return {"sym": sym, "directed": _build(directed, True)}


def _plan_for(name, plans):
    return plans["directed" if name in _DIRECTED else "sym"]


def test_registry_resolves_and_covers_the_package():
    """Every registered name resolves to a non-empty tuple of field names,
    and the AST pass accepts exactly the registry and the classification
    tuples."""
    assert set(_REGISTRY) == set(registry.CONSUMER_TUPLE_SOURCES)
    for name, tup in _REGISTRY.items():
        assert isinstance(tup, tuple) and tup and all(
            isinstance(f, str) for f in tup), name
    classes = registry.resolve_classification_tuples()
    assert set(classes) == set(registry.CLASSIFICATION_TUPLES)
    assert registry.known_fields_names() == set(_REGISTRY) | set(classes)


def test_stale_registry_entry_fails_loudly(monkeypatch):
    monkeypatch.setitem(registry.CONSUMER_TUPLE_SOURCES, "GONE_FIELDS",
                        "sgcn_tpu_torch.ops.tile_spmm:GONE_FIELDS")
    with pytest.raises(AttributeError, match="GONE_FIELDS"):
        registry.resolve_consumer_tuples()


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_tuple_names_real_fields(name, plans):
    """Each entry names only fields ``CommPlan`` has, or for an ELL tuple
    keys of the chain layout it ships."""
    tup = _REGISTRY[name]
    if name in _ELL_LAYOUTS:
        chains = _plan_for(name, plans).ell_chains[_ELL_LAYOUTS[name]]
        unknown = [f for f in tup if f not in chains and f not in _DATACLASS]
    else:
        unknown = [f for f in tup if f not in _DATACLASS]
    assert not unknown, (f"{name} names {unknown}, which neither CommPlan "
                         "nor its chain layout has — the tuple and the plan "
                         "have drifted apart")


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_tuple_fields_are_classified(name, plans):
    """Each dataclass field an entry names is classified per part, global
    or re-based, so the shard proxy knows how to slice it (an ELL chain
    key is laid out again for each slice: the next test)."""
    tup = _REGISTRY[name]
    fields = [f for f in tup if f in _DATACLASS]
    assert fields or name in _ELL_LAYOUTS, name
    for f in fields:
        assert f in _CLASSIFIED, (f"{name}: {f} is in none of "
                                  "PER_CHIP_ARRAY_FIELDS, "
                                  "_GLOBAL_ARRAY_FIELDS, "
                                  "REBASED_ARRAY_FIELDS")


def test_every_array_field_is_classified(plans):
    """Every ndarray field of a fully built plan is classified; a per-part
    one carries the leading k axis."""
    for plan in plans.values():
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if not isinstance(v, np.ndarray):
                continue
            assert f.name in _CLASSIFIED, (
                f"CommPlan.{f.name} is an unclassified array field")
            if f.name in PER_CHIP_ARRAY_FIELDS:
                assert v.shape[0] == plan.k, (f.name, v.shape)


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_shipped_fields_survive_the_shard_proxy(name, plans):
    """Each built field an entry names is sliced by ``shard_proxy_plan``:
    a per-part field to part c's ``(1, ...)`` rows, a re-based one to one
    part's row, a global one as it is, an ELL chain key to the slice's own
    ``(1, ...)`` chains."""
    tup = _REGISTRY[name]
    plan = _plan_for(name, plans)
    sl = shard_proxy_plan(plan, 1)
    checked = 0
    for f in tup:
        if f in _DATACLASS:
            v = getattr(plan, f)
            if v is None:
                # the reference's replica tuples name its ELL arrays,
                # which the port's plan does not build for the tiles
                assert name in _REFERENCE_NAMED, (name, f)
                continue
            got = np.asarray(getattr(sl, f))
            if f in PER_CHIP_ARRAY_FIELDS:
                assert got.shape == (1,) + v.shape[1:], (name, f)
            elif f in REBASED_ARRAY_FIELDS:
                # re-based by its rule: part c's share of the flat index
                assert got.size <= v.size and got.ndim == v.ndim, (
                    name, f, got.shape, v.shape)
            else:
                np.testing.assert_array_equal(got, v)
        else:
            assert f in sl.ell_chains[_ELL_LAYOUTS[name]], (name, f)
        checked += 1
    assert checked, f"{name}: no field of the tuple is built on the plan"
