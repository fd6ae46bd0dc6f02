"""The port's checkpoints against the reference's: one ``.npz`` format for
both packages, crash-safe resume, serving from a checkpoint.

Inputs: cora2708 under its 8-part hp partition, GCN 1433 → 16 → 7 (ReLU)
and GAT 1433 → 16 → 7 (no activation between layers), on the CPU.  The
reference trainer runs on the 8 virtual CPU devices of
``tests/conftest.py`` with its default aggregator.

On this tree's JAX the reference's Adam steps on k × the loss gradient
(ROADMAP C3), so its default optimizer's moments are ``mu``·k and
``nu``·k² of the port's.  ``test_default_optax_moments_are_k_times_the_
ports`` measures k from two checkpoints; the continuation tests hand the
reference ``optax.chain(optax.scale(1/k), optax.adam(lr))`` — the same
``count, mu, nu`` leaves — so both packages' moments are of the true
gradient.  Tolerances are stated per test.

The kill-and-resume tests start real training runs in fresh processes
(``torch.multiprocessing``, ``spawn``; ``tests/torch_resume_child.py``),
kill them through ``$SGCN_FAULT`` after a save, resume them in another
fresh process and require ``==`` on the bits against the uninterrupted
run.
"""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import scipy.io
import torch

from sgcn_tpu.models.gat import init_gat_params as ref_init_gat
from sgcn_tpu.models.gcn import init_gcn_params as ref_init_gcn
from sgcn_tpu.obs.recorder import plan_digest as ref_plan_digest
from sgcn_tpu.obs.recorder import \
    plan_manifest_block as ref_plan_manifest_block
from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.resilience import faults as ref_faults
from sgcn_tpu.resilience.checkpoint import \
    CheckpointManager as RefCheckpointManager
from sgcn_tpu.serve import ServeEngine as RefEngine
from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer
from sgcn_tpu.train.fullbatch import make_train_data as ref_make_train_data
from sgcn_tpu.utils import checkpoint as ref_ckpt
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.obs.recorder import plan_digest, plan_manifest_block
from sgcn_tpu_torch.parallel import build_comm_plan
from sgcn_tpu_torch.partition import read_partvec
from sgcn_tpu_torch.prep import normalize_adjacency
from sgcn_tpu_torch.resilience import atomic, faults
from sgcn_tpu_torch.resilience.checkpoint import CheckpointManager
from sgcn_tpu_torch.resilience.runner import run_resumable
from sgcn_tpu_torch.serve import ServeEngine, synthetic_query_ids
from sgcn_tpu_torch.serve.__main__ import main as serve_main
from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.utils import checkpoint as ckpt
from sgcn_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                             from_leaves, load_checkpoint,
                                             read_checkpoint_meta,
                                             save_checkpoint, to_leaves)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_resume_child as child  # noqa: E402

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
HP8 = os.path.join(FIX, "cora2708.8.hp")
HP4 = os.path.join(FIX, "cora2708.4.hp")
WIDTHS = [16, 7]
FIN = 1433
LR = 0.01
ACT = {"gcn": "relu", "gat": "none"}
CLI = ["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8", "-l", "2",
       "--hidden", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def cora():
    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(HP8)
    plan = build_comm_plan(normalize_adjacency(a), pv, 8)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, 8)
    return {"a": a, "feats": feats, "labels": labels, "pv": pv,
            "plan": plan, "ref_plan": ref_plan,
            "data": make_train_data(plan, feats, labels),
            "ref_data": ref_make_train_data(ref_plan, feats, labels)}


def _ref_init(model, seed):
    dims = list(zip([FIN] + WIDTHS[:-1], WIDTHS))
    init = ref_init_gcn if model == "gcn" else ref_init_gat
    params = init(jax.random.PRNGKey(seed), dims)
    return jax.tree.map(np.asarray, params)


def _port(cora, model, **kw):
    kw.setdefault("activation", ACT[model])
    return FullBatchTrainer(cora["plan"], fin=FIN, widths=WIDTHS, lr=LR,
                            model=model, device="cpu", **kw)


def _ref(cora, model, scale=None, **kw):
    opt = (None if scale is None else
           optax.chain(optax.scale(1.0 / scale), optax.adam(LR)))
    return RefTrainer(cora["ref_plan"], fin=FIN, widths=WIDTHS, lr=LR,
                      model=model, activation=ACT[model], optimizer=opt,
                      **kw)


def _arrays(path):
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _leaves(path):
    arrs = _arrays(path)
    n = sum(1 for key in arrs if key.startswith("leaf_"))
    return [arrs[f"leaf_{i}"] for i in range(n)]


# ------------------------------------------------------------ plan digest
@pytest.mark.parametrize("partvec", ["8-hp", "4-hp"])
def test_plan_digest_equals_reference(cora, partvec):
    if partvec == "8-hp":
        plan, ref_plan = cora["plan"], cora["ref_plan"]
    else:
        pv = read_partvec(HP4)
        plan = build_comm_plan(normalize_adjacency(cora["a"]), pv, 4)
        ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), pv, 4)
    assert plan_digest(plan) == ref_plan_digest(ref_plan)
    assert len(plan_digest(plan)) == 16
    assert plan_manifest_block(plan) == ref_plan_manifest_block(ref_plan)


# ------------------------------------------------- (a) the same .npz format
@pytest.fixture(scope="module")
def c3(cora, tmp_path_factory):
    """ROADMAP C3 measured on checkpoints: one GCN step of the reference's
    default optimizer and one of the port's from the same weights, both
    saved; k is the ratio of their last ``mu`` norms."""
    d = tmp_path_factory.mktemp("c3")
    p0 = _ref_init("gcn", 1)
    ref = _ref(cora, "gcn", seed=1)
    port = _port(cora, "gcn", params=p0)
    ref.step(cora["ref_data"])
    port.step(cora["data"])
    ref_leaves = _leaves(ref_ckpt.save_checkpoint(ref, str(d / "r"), 1))
    port_leaves = _leaves(save_checkpoint(port, str(d / "p"), 1))
    k = (np.linalg.norm(ref_leaves[-3]) / np.linalg.norm(port_leaves[-3]))
    return {"k": k, "ref": ref_leaves, "port": port_leaves}


def test_default_optax_moments_are_k_times_the_ports(c3):
    """The reference's default optimizer's ``mu`` is k × the port's and
    ``nu`` k² × (k = 1 on a JAX that does not psum a replicated input's
    gradient, k = 8 = the part count here), per leaf within rtol 1e-4 on
    the norms (observed ≤ 1e-6)."""
    k = round(c3["k"])
    assert k in (1, 8)
    ref, port = c3["ref"], c3["port"]
    n = (len(port) - 1) // 3
    assert int(ref[n]) == int(port[n]) == 1
    for i in range(n):
        for off, power in ((n + 1, 1), (2 * n + 1, 2)):
            assert np.linalg.norm(ref[off + i]) / np.linalg.norm(
                port[off + i]) == pytest.approx(k ** power, rel=1e-4)


@pytest.fixture(scope="module", params=["gcn", "gat"])
def two_files(request, cora, c3, tmp_path_factory):
    """Both packages' trainers from the reference's initial weights, 2
    steps each (the reference with the C3 chain), each saved at step 2;
    plus the port trainer itself."""
    model = request.param
    d = tmp_path_factory.mktemp(f"two_{model}")
    p0 = _ref_init(model, 3)
    ref = _ref(cora, model, scale=round(c3["k"]), seed=3)
    port = _port(cora, model, params=p0)
    for _ in range(2):
        ref.step(cora["ref_data"])
        port.step(cora["data"])
    ref_path = ref_ckpt.save_checkpoint(ref, str(d / "ref"), step=2)
    port_path = save_checkpoint(port, str(d / "port"), step=2)
    return {"model": model, "ref": ref_path, "port": port_path,
            "trainer": port, "ref_trainer": ref}


def test_same_keys_shapes_and_dtypes(two_files):
    ref, port = _arrays(two_files["ref"]), _arrays(two_files["port"])
    assert sorted(ref) == sorted(port)
    for key in ref:
        assert ref[key].shape == port[key].shape, key
        if ref[key].dtype.kind == "U":      # JSON/digest text: its length
            assert port[key].dtype.kind == "U", key         # varies
        else:
            assert ref[key].dtype == port[key].dtype, key
    n = len(_leaves(two_files["port"]))
    assert n == 3 * (2 if two_files["model"] == "gcn" else 6) + 1
    assert json.loads(str(port["__checksums__"])).keys() == \
        json.loads(str(ref["__checksums__"])).keys()


def test_same_metadata_blocks(two_files):
    ref = ref_ckpt.read_checkpoint_meta(two_files["ref"])
    port = read_checkpoint_meta(two_files["port"])
    assert ref["model_config"] == port["model_config"]
    assert ref["state"].keys() == port["state"].keys()
    assert ref["state"]["comm_stats"].keys() == \
        port["state"]["comm_stats"].keys()
    for key in ("step", "plan_digest", "version", "n_leaves", "n_carry"):
        assert ref[key] == port[key], key
    # the exact path's counters and gauges are the reference's
    assert ref["state"] == port["state"]


def test_leaf_order_is_the_references_tree_order(two_files):
    """Each leaf of the port's file lies at the reference's position,
    after 2 steps from the same weights on the same gradient: the params
    within rtol 1e-4 / atol 1e-6, the count exact, ``mu`` within rtol
    1e-3 / atol 1e-8 and ``nu`` within rtol 1e-3 / atol 1e-12 (observed
    max abs gaps: params 8.7e-7, ``mu`` 1.1e-8, ``nu`` 4.5e-12, where
    the largest ``mu`` are ~1e-2)."""
    ref, port = _leaves(two_files["ref"]), _leaves(two_files["port"])
    n = (len(port) - 1) // 3
    gaps = []
    for i, (r, p) in enumerate(zip(ref, port)):
        tol = ((1e-4, 1e-6) if i < n else (0, 0) if i == n
               else (1e-3, 1e-8) if i <= 2 * n else (1e-3, 1e-12))
        gaps.append(float(np.abs(r.astype(np.float64) - p).max()))
        np.testing.assert_allclose(p, r, rtol=tol[0], atol=tol[1])
    print(f"{two_files['model']}: max abs leaf gaps {gaps}")
    assert int(port[n]) == 2


def test_leaves_round_trip_through_torch_adam(two_files, cora):
    """``to_leaves`` → ``from_leaves`` into a fresh trainer whose Adam has
    not stepped creates the state entries; the leaves come back equal bit
    for bit, and ``step`` is a CPU float32 scalar as torch's Adam makes
    it."""
    tr = two_files["trainer"]
    leaves = to_leaves(tr.params, tr.opt)
    fresh = _port(cora, two_files["model"], seed=11)
    assert not fresh.opt.state
    from_leaves(leaves, fresh.params, fresh.opt)
    again = to_leaves(fresh.params, fresh.opt)
    for a, b in zip(leaves, again):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for p in ckpt.param_list(fresh.params):
        st = fresh.opt.state[p]
        assert st["step"].dtype == torch.float32
        assert st["step"].device.type == "cpu" and float(st["step"]) == 2.0


# ------------------------------------------------------ (b) JAX -> the port
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_jax_checkpoint_continues_in_the_port(cora, c3, model, tmp_path):
    """The reference (C3 chain) trains 2 steps and saves; the port loads
    the file (provenance verified) and trains 3 more.  Losses within rtol
    1e-5 of the reference's own 3 further steps (observed ≤ 1.9e-6 GCN,
    ≤ 2.5e-6 GAT) and final weights within rtol 1e-4 / atol 1e-6 (observed
    max abs gap 3.0e-7 for each)."""
    ref = _ref(cora, model, scale=round(c3["k"]), seed=5)
    for _ in range(2):
        ref.step(cora["ref_data"])
    path = ref_ckpt.save_checkpoint(ref, str(tmp_path / "jax"), step=2)
    ref_losses = [ref.step(cora["ref_data"]) for _ in range(3)]

    port = _port(cora, model, seed=9)
    assert load_checkpoint(port, path) == 2
    assert port._step_count == 2 and port.last_restore_partial is False
    losses = [port.step(cora["data"]) for _ in range(3)]
    print(f"{model}: max rel loss gap "
          f"{np.max(np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)):.3g}")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = [x.detach().numpy() for x in ckpt.param_list(port.params)]
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.params))
    print(f"{model}: max abs weight gap "
          f"{max(np.abs(g - w).max() for g, w in zip(got, want)):.3g}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    # the comm gauges reconcile across the seam
    assert port.stats.report()["exchanges"] == \
        ref.stats.report()["exchanges"]


# ------------------------------------------------------ (c) the port -> JAX
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_port_checkpoint_loads_and_serves_in_the_reference(cora, model,
                                                           tmp_path):
    """A port-written file loads in the reference's ``load_checkpoint``
    (params bit for bit, step counter, the nine comm gauges) and in its
    ``ServeEngine(checkpoint=…)``, whose rows match the port engine's on
    the same file within rtol 1e-4 / atol 1e-5 (``tests/
    test_torch_serve.py``'s tolerance; observed max abs gap 6e-8 GCN,
    2.4e-7 GAT); the port engine's rows equal the
    port trainer's ``predict`` rows bit for bit."""
    port = _port(cora, model, params=_ref_init(model, 4))
    for _ in range(2):
        port.step(cora["data"])
    path = save_checkpoint(port, str(tmp_path / "port"), step=2)

    ref = _ref(cora, model, seed=0)
    assert ref_ckpt.load_checkpoint(ref, path) == 2
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    ckpt.param_list(port.params)):
        assert np.array_equal(g, w.detach().numpy())
    assert ref._step_count == 2
    assert ref.stats.state() == port.stats.state()

    feats = cora["feats"]
    kw = dict(fin=FIN, widths=WIDTHS, model=model, checkpoint=path,
              max_batch=32, buckets=(8, 32))
    ref_eng = RefEngine(cora["ref_plan"], **kw)
    ref_eng.set_features(feats)
    eng = ServeEngine(cora["plan"], device="cpu", **kw)
    eng.set_features(feats)
    assert eng.checkpoint_meta["step"] == 2
    qids = synthetic_query_ids(cora["plan"].n, 32, seed=4)
    got, want = eng.query(qids), ref_eng.query(qids)
    print(f"{model}: max |port - reference| served "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.array_equal(got, port.predict(cora["data"])[qids])


# ------------------------------------------------- (d) kill and resume
KILL_CASES = {
    "gcn-a2a": ["--comm-schedule", "a2a"],
    "gcn-ragged": ["--comm-schedule", "ragged"],
    "gat-a2a": ["--model", "gat"],
}
CORRUPT_MODES = ("bitflip", "truncate")
SCHEDULE = ["--warmup", "0", "--epochs", "6"]


@pytest.fixture(scope="module")
def crash_runs(tmp_path_factory):
    """All children at once: per kill case a run killed after its step-3
    save (``--checkpoint-every 3``) and the same run uninterrupted, per
    corruption mode a run whose step-4 file is corrupted after its save
    (``--checkpoint-every 2``); then, at once, a fresh process per killed
    run that resumes it with ``--resume auto`` to 6 steps.  Every run is a
    child with the same thread count: a CPU matmul's bits depend on it."""
    root = tmp_path_factory.mktemp("crash")
    jobs, resumes, names = [], [], []
    for name, extra in KILL_CASES.items():
        argv = CLI + extra + SCHEDULE + ["--checkpoint-every", "3"]
        jobs.append((argv + ["--checkpoint-dir", str(root / f"{name}.ck"),
                             "--save-checkpoint",
                             str(root / f"{name}.full.npz")],
                     None, str(root / f"{name}.full")))
        argv = argv + ["--checkpoint-dir", str(root / name)]
        jobs.append((argv, "kill-after-save:3", str(root / f"{name}.kill")))
        resumes.append((argv + ["--resume", "auto", "--save-checkpoint",
                                str(root / f"{name}.final.npz")],
                        None, str(root / f"{name}.resume")))
        names.append(name)
    for mode in CORRUPT_MODES:
        argv = CLI + SCHEDULE + ["--checkpoint-dir", str(root / mode),
                                 "--checkpoint-every", "2"]
        jobs.append((argv, f"corrupt-after-save:4:{mode}",
                     str(root / f"{mode}.kill")))
        resumes.append((argv + ["--resume", "auto", "--save-checkpoint",
                                str(root / f"{mode}.final.npz")],
                        None, str(root / f"{mode}.resume")))
        names.append(mode)
    first = dict(zip([job[2] for job in jobs], child.spawn_all(jobs)))
    listing = {name: sorted(os.listdir(root / name)) for name in names}
    resumed = child.spawn_all(resumes)
    return {"root": root, "first": first, "listing": listing,
            "resumed": dict(zip(names, resumed))}


def _first(crash_runs, name):
    return crash_runs["first"][str(crash_runs["root"] / name)]


def _uninterrupted(crash_runs, case):
    """The uninterrupted 6-step run of ``case``: its report and its final
    state file."""
    assert _first(crash_runs, f"{case}.full") == 0
    rep = child.read_result(str(crash_runs["root"] / f"{case}.full"))
    return rep["report"], str(crash_runs["root"] / f"{case}.full.npz")


def _assert_files_equal(a, b):
    """Every array of two state files ``==`` on the bits: weights, Adam
    state, step, counters and gauges (and so the checksums)."""
    fa, fb = _arrays(a), _arrays(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert np.array_equal(fa[key], fb[key]), key


@pytest.mark.parametrize("case", list(KILL_CASES))
def test_kill_after_save_then_resume_equals_uninterrupted(crash_runs, case):
    """Exit code 43 after the step-3 save; the resumed process trains steps
    4–6, and its losses, final weights, Adam state, step counter and comm
    gauges are ``==`` the uninterrupted 6-step run's (float32 bit for
    bit)."""
    assert _first(crash_runs, f"{case}.kill") == faults.FAULT_EXIT_CODE == 43
    assert crash_runs["listing"][case] == ["ckpt_00000003.npz"]
    assert crash_runs["resumed"][case] == 0
    res = child.read_result(str(crash_runs["root"] / f"{case}.resume"))
    rep = res["report"]
    assert rep["resumed"] == {
        "step": 3, "fallback": False,
        "path": str(crash_runs["root"] / case / "ckpt_00000003.npz")}
    assert rep["start_step"] == 3 and rep["steps_run"] == 3
    want, final = _uninterrupted(crash_runs, case)
    assert rep["losses"] == want["losses"][3:]
    for key in ("exchanges", "total_send_volume", "halo_bytes_wire_total"):
        assert rep[key] == want[key], key
    _assert_files_equal(str(crash_runs["root"] / f"{case}.final.npz"),
                        final)


@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_corrupt_after_save_falls_back_to_the_previous_file(crash_runs,
                                                            mode):
    """``corrupt-after-save:4:<mode>``: exit 43 with the step-4 file
    damaged; ``--resume auto`` warns, falls back to step 2, trains steps
    3–6, and ends ``==`` the uninterrupted run."""
    assert _first(crash_runs, f"{mode}.kill") == 43
    assert crash_runs["listing"][mode] == ["ckpt_00000002.npz",
                                           "ckpt_00000004.npz"]
    assert crash_runs["resumed"][mode] == 0
    res = child.read_result(str(crash_runs["root"] / f"{mode}.resume"))
    rep = res["report"]
    assert rep["resumed"]["step"] == 2 and rep["resumed"]["fallback"]
    assert any("ckpt_00000004.npz" in w and "falling back" in w
               for w in res["warnings"])
    want, final = _uninterrupted(crash_runs, "gcn-a2a")
    assert rep["losses"] == want["losses"][2:]
    _assert_files_equal(str(crash_runs["root"] / f"{mode}.final.npz"), final)


# ------------------------------------------------------------ (e) refusals
@pytest.fixture(scope="module")
def gcn_file(cora, tmp_path_factory):
    tr = _port(cora, "gcn", seed=2)
    tr.step(cora["data"])
    return save_checkpoint(
        tr, str(tmp_path_factory.mktemp("gcn") / "gcn"), step=1)


@pytest.mark.parametrize("what", ["partvec", "widths", "activation",
                                  "model"])
def test_provenance_mismatch_raises_the_references_message(cora, gcn_file,
                                                           what):
    """Each mismatch raises ``ValueError`` with the reference's message
    (compared verbatim against ``sgcn_tpu.utils.checkpoint.
    verify_checkpoint_provenance`` on the same file), before any state
    changes; the serve engine refuses the partvec and widths mismatches
    too."""
    kw = dict(model="gcn", activation="relu", widths=WIDTHS)
    plan, ref_plan = cora["plan"], cora["ref_plan"]
    if what == "partvec":
        pv = read_partvec(HP4)
        plan = build_comm_plan(normalize_adjacency(cora["a"]), pv, 4)
        ref_plan = ref_build_comm_plan(ref_normalize(cora["a"]), pv, 4)
    elif what == "widths":
        kw["widths"] = [32, 7]
    elif what == "activation":
        kw["activation"] = "elu"
    else:
        kw.update(model="gat", activation="relu")
    tr = FullBatchTrainer(plan, fin=FIN, lr=LR, device="cpu", **kw)
    before = to_leaves(tr.params, tr.opt)
    with pytest.raises(ValueError) as port_err:
        load_checkpoint(tr, gcn_file)
    with pytest.raises(ValueError) as ref_err:
        ref_ckpt.verify_checkpoint_provenance(
            ref_ckpt.read_checkpoint_meta(gcn_file), plan=ref_plan,
            model=kw["model"], fin=FIN, widths=kw["widths"],
            activation=kw["activation"], final_activation="none",
            what=f"load_checkpoint({gcn_file!r})")
    assert str(port_err.value) == str(ref_err.value)
    assert all(np.array_equal(a, b)
               for a, b in zip(before, to_leaves(tr.params, tr.opt)))
    if what in ("partvec", "widths"):
        match = "plan digest mismatch" if what == "partvec" else \
            "model config mismatch on 'widths'"
        with pytest.raises(ValueError, match=match):
            ServeEngine(plan, fin=FIN, widths=kw["widths"],
                        checkpoint=gcn_file, device="cpu")


def _rewrite(src, dst, drop=(), **replace):
    arrays = _arrays(src)
    for key in drop:
        arrays.pop(key, None)
    arrays.update(replace)
    np.savez(dst, **arrays)
    return dst


def test_newer_format_version_is_refused(cora, gcn_file, tmp_path):
    path = _rewrite(gcn_file, str(tmp_path / "v3.npz"),
                    drop=("__checksums__",),
                    __ckpt_version__=np.asarray(3, np.int64))
    with pytest.raises(ValueError, match="format v3") as port_err:
        load_checkpoint(_port(cora, "gcn"), path)
    with pytest.raises(ValueError) as ref_err:
        ref_ckpt.load_checkpoint_leaves(path)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="format v3"):
        ServeEngine(cora["plan"], fin=FIN, widths=WIDTHS, checkpoint=path,
                    device="cpu")


def test_v1_params_only_file_loads(cora, gcn_file, tmp_path):
    """A v1 file (leaves and ``__step__`` only: no provenance, state or
    checksums) loads into the trainer and the engine; the train state is
    not restored and nothing warns (the exact trainer has no carry)."""
    keep = [k for k in _arrays(gcn_file)
            if k.startswith("leaf_") or k == "__step__"]
    path = _rewrite(gcn_file, str(tmp_path / "v1.npz"),
                    drop=[k for k in _arrays(gcn_file) if k not in keep])
    assert read_checkpoint_meta(path)["version"] == 1
    tr = _port(cora, "gcn", seed=7)
    assert load_checkpoint(tr, path) == 1
    assert tr._step_count == 0 and tr.last_restore_partial is False
    want = _leaves(gcn_file)
    assert all(np.array_equal(a, b)
               for a, b in zip(to_leaves(tr.params, tr.opt), want))
    eng = ServeEngine(cora["plan"], fin=FIN, widths=WIDTHS, checkpoint=path,
                      device="cpu")
    assert all(np.array_equal(p.detach().numpy(), w)
               for p, w in zip(eng.model.layer_params(), want))
    # and the reference reads the same v1 file
    ref = _ref(cora, "gcn", seed=0)
    assert ref_ckpt.load_checkpoint(ref, path) == 1


def test_foreign_carry_state_loads_params_only_with_a_warning(cora, gcn_file,
                                                              tmp_path):
    state = json.loads(str(_arrays(gcn_file)["__train_state__"]))
    state["carry"] = "halo_carry"
    path = _rewrite(gcn_file, str(tmp_path / "stale.npz"),
                    drop=("__checksums__",),
                    __train_state__=np.asarray(json.dumps(state)))
    tr = _port(cora, "gcn", seed=7)
    with pytest.warns(RuntimeWarning, match="full state IGNORED"):
        assert load_checkpoint(tr, path) == 1
    assert tr._step_count == 0


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corruption_raises_and_the_manager_falls_back(cora, tmp_path, mode):
    tr = _port(cora, "gcn", seed=1)
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    for step in (1, 2):
        tr.step(cora["data"])
        mgr.save(tr, step)
    faults.corrupt_file(mgr.path_for(2), mode=mode)
    with pytest.raises(CheckpointCorruptError):
        ckpt.verify_checkpoint_file(mgr.path_for(2))
    fresh = _port(cora, "gcn", seed=4)
    with pytest.warns(RuntimeWarning, match="falling back"):
        step, path, skipped = mgr.load_latest(fresh)
    assert (step, path, skipped) == (1, mgr.path_for(1), [mgr.path_for(2)])
    faults.corrupt_file(mgr.path_for(1), mode=mode)
    with pytest.warns(RuntimeWarning), \
            pytest.raises(CheckpointCorruptError, match="all 2 checkpoint"):
        mgr.load_latest(fresh)


# ------------------------------------------- the directory and the faults
def test_one_directory_serves_both_packages(cora, c3, tmp_path):
    """A directory the reference's manager writes, the port's manager
    resumes from, and the other way round; rotation keeps the newest K
    under the same ``ckpt_<step:08d>.npz`` stamps."""
    ref = _ref(cora, "gcn", scale=round(c3["k"]), seed=2)
    ref_mgr = RefCheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3):
        ref.step(cora["ref_data"])
        ref_mgr.save(ref, step)
    port_mgr = CheckpointManager(str(tmp_path), keep_last=2)
    assert port_mgr.checkpoints() == ref_mgr.checkpoints()
    assert [s for s, _ in port_mgr.checkpoints()] == [2, 3]
    tr = _port(cora, "gcn", seed=8)
    assert port_mgr.load_latest(tr)[:2] == (3, port_mgr.path_for(3))
    tr.step(cora["data"])
    port_mgr.save(tr, 4)
    assert [s for s, _ in ref_mgr.checkpoints()] == [3, 4]
    ref2 = _ref(cora, "gcn", seed=0)
    assert ref_mgr.load_latest(ref2)[0] == 4
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(str(tmp_path), keep_last=0)
    with pytest.raises(ValueError, match="8-digit"):
        port_mgr.path_for(10 ** 8)


@pytest.mark.parametrize("text", [
    "kill-after-save:3", "corrupt-after-save:4", "corrupt-after-save:4:truncate",
    "stall:dryrun:0.5", "kill-after-save", "corrupt-after-save:2:melt",
    "stall:x", "bogus:1"])
def test_fault_grammar_equals_the_references(text):
    try:
        want = ref_faults.parse_fault(text)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            faults.parse_fault(text)
        assert str(err.value) == str(e)
        return
    got = faults.parse_fault(text)
    assert (got.kind, got.step, got.phase, got.seconds, got.mode) == \
        (want.kind, want.step, want.phase, want.seconds, want.mode)


@pytest.mark.parametrize("mode,seed", [("bitflip", 0), ("bitflip", 3),
                                       ("truncate", 0)])
def test_corrupt_file_damages_as_the_reference_does(tmp_path, mode, seed):
    data = np.random.default_rng(seed).bytes(1000)
    for name in ("a", "b"):
        (tmp_path / name).write_bytes(data)
    faults.corrupt_file(str(tmp_path / "a"), mode=mode, seed=seed)
    ref_faults.corrupt_file(str(tmp_path / "b"), mode=mode, seed=seed)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert (tmp_path / "a").read_bytes() != data


def test_classify_stall_equals_the_references(tmp_path):
    cases = []
    assert faults.classify_stall(str(tmp_path)) == \
        ref_faults.classify_stall(str(tmp_path)) == ("stalled", None)
    with open(tmp_path / faults.HEARTBEAT_NAME, "w") as fh:
        fh.write(json.dumps({"ts": 100.0, "pid": 1}) + "\n\nnot json\n")
        fh.write(json.dumps({"ts": 150.0, "pid": 2}) + "\n")
    for now, pid in ((160.0, None), (300.0, None), (160.0, 2), (200.0, 2)):
        got = faults.classify_stall(str(tmp_path), now=now, exclude_pid=pid)
        cases.append(got)
        assert got == ref_faults.classify_stall(str(tmp_path), now=now,
                                                exclude_pid=pid)
    assert [c[0] for c in cases] == ["slow", "stalled", "slow", "stalled"]


def test_stall_fault_sleeps_only_at_its_phase(monkeypatch):
    import time

    monkeypatch.setenv(faults.FAULT_ENV, "stall:dryrun:0.05")
    t0 = time.perf_counter()
    faults.maybe_stall("train")
    assert time.perf_counter() - t0 < 0.05
    faults.maybe_stall("dryrun")
    assert time.perf_counter() - t0 >= 0.05
    faults.after_checkpoint_save("unused", 1)       # no save fault: no-op


def test_atomic_write_keeps_the_old_file_on_failure(tmp_path):
    path = str(tmp_path / "x.json")
    atomic.atomic_write_json(path, {"a": 1})
    with pytest.raises(RuntimeError):
        with atomic.atomic_write(path, "w") as fh:
            fh.write("partial")
            raise RuntimeError("killed mid-write")
    assert json.load(open(path)) == {"a": 1}
    assert os.listdir(tmp_path) == ["x.json"]
    (tmp_path / f"ckpt_1.npz.tmp.{os.getpid() + 1}").write_bytes(b"x")
    atomic.sweep_temp_litter(str(tmp_path), "ckpt_")
    assert os.listdir(tmp_path) == ["x.json"]
    with pytest.raises(ValueError, match="write-only"):
        with atomic.atomic_write(path, "r"):
            pass


def test_run_resumable_validates_and_reports(cora, tmp_path):
    tr = _port(cora, "gcn", seed=6)
    with pytest.raises(ValueError, match="needs a CheckpointManager"):
        run_resumable(tr, cora["data"], 2, checkpoint_every=1)
    with pytest.raises(ValueError, match="outside"):
        run_resumable(tr, cora["data"], 2, start_step=3)
    mgr = CheckpointManager(str(tmp_path), keep_last=1)
    rep = run_resumable(tr, cora["data"], 2, manager=mgr,
                        checkpoint_every=1, verbose=False)
    assert rep["steps"] == rep["steps_run"] == 2 and len(rep["losses"]) == 2
    assert "step_s_wall" in rep and "epoch_s" not in rep
    assert [s for s, _ in mgr.checkpoints()] == [2]
    assert read_checkpoint_meta(mgr.path_for(2))["state"]["step_count"] == 2


# ------------------------------------------------------------ (f) the CLIs
def test_train_cli_checkpoint_dir_resume_and_save(tmp_path, capsys):
    """``--checkpoint-dir`` writes the stamps; ``--resume auto`` on a
    finished schedule trains nothing; ``--resume CKPT`` chains (the saved
    step adds up) and ``--save-checkpoint`` records the absolute step."""
    d = str(tmp_path / "ck")
    base = CLI + ["--warmup", "1", "--epochs", "2"]
    train_main(base + ["--checkpoint-dir", d, "--checkpoint-every", "1",
                       "--keep-checkpoints", "2"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["steps"] == 3 and rep["device"] == "cpu"
    assert sorted(os.listdir(d)) == ["ckpt_00000002.npz",
                                     "ckpt_00000003.npz"]
    train_main(base + ["--checkpoint-dir", d, "--resume", "auto",
                       "--save-checkpoint", str(tmp_path / "a.npz")])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["steps_run"] == 0 and rep["resumed"]["step"] == 3
    assert read_checkpoint_meta(str(tmp_path / "a.npz"))["step"] == 3
    train_main(base + ["--resume", str(tmp_path / "a.npz"),
                       "--save-checkpoint", str(tmp_path / "b.npz")])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "epoch_s" in rep and "resumed" not in rep
    meta = read_checkpoint_meta(str(tmp_path / "b.npz"))
    assert meta["step"] == 6 and meta["state"]["step_count"] == 6


@pytest.mark.parametrize("argv", [
    ["--checkpoint-every", "-1"],
    ["--checkpoint-every", "2"],
    ["--resume", "auto"],
    ["--checkpoint-dir", "d", "--experiment", "accuracy"]])
def test_train_cli_guards_say_what_the_references_do(argv, monkeypatch):
    from sgcn_tpu.train.__main__ import main as ref_main

    monkeypatch.setattr(sys, "argv", ["sgcn_tpu.train", "-p", HP8, "-s",
                                      "8", *argv])
    with pytest.raises(SystemExit) as ref_err:
        ref_main()
    with pytest.raises(SystemExit) as port_err:
        train_main(["-p", HP8, "-s", "8", "--device", "cpu", *argv])
    assert isinstance(port_err.value.code, str)
    assert port_err.value.code == ref_err.value.code


def test_train_cli_accuracy_refuses_checkpoints():
    with pytest.raises(SystemExit, match="--resume/--save-checkpoint are "
                       "not supported"):
        train_main(CLI + ["--experiment", "accuracy", "--save-checkpoint",
                          "x.npz"])


def test_serve_cli_from_a_checkpoint_and_a_watched_directory(cora, tmp_path,
                                                             capsys):
    """``--checkpoint``: model and widths from provenance, ``"weights":
    "checkpoint"``; ``--watch-checkpoint-dir`` swaps the directory's newest
    file in on the first batch (``weights_rev`` 1); a checkpoint trained
    on other features fails with the reference's ``fin`` message."""
    tr = _port(cora, "gat", seed=3)
    tr.step(cora["data"])
    path = save_checkpoint(tr, str(tmp_path / "gat"), step=1)
    q = ["--queries", "16", "--max-batch", "8", "--buckets", "8"]
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--checkpoint", path, "--device", "cpu", *q])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["weights"] == "checkpoint" and rep["model"] == "gat"
    assert rep["widths"] == WIDTHS and rep["activation"] == "none"
    assert rep["weights_rev"] == 0
    CheckpointManager(str(tmp_path / "w")).save(tr, 1)
    serve_main(["--npz", NPZ, "--normalize", "-p", HP8, "-s", "8",
                "--random-init", "--model", "gat", "-l", "2", "--hidden",
                "16", "--watch-checkpoint-dir", str(tmp_path / "w"),
                "--device", "cpu", *q])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["weights"] == "random-init" and rep["weights_rev"] == 1
    mtx = str(tmp_path / "cora.mtx")
    scipy.io.mmwrite(mtx, cora["a"])
    with pytest.raises(SystemExit, match="trained on fin=1433 features, "
                       "this dataset has 16"):
        serve_main(["-a", mtx, "-p", HP8, "-s", "8", "-f", "16",
                    "--checkpoint", path, "--device", "cpu"])


def test_serve_cli_guards_say_what_the_references_do(monkeypatch):
    from sgcn_tpu.serve.__main__ import main as ref_main

    for argv in ([], ["--checkpoint", "x", "--random-init"]):
        monkeypatch.setattr(sys, "argv", ["sgcn_tpu.serve", "-p", HP8, "-s",
                                          "8", *argv])
        with pytest.raises(SystemExit) as ref_err:
            ref_main()
        with pytest.raises(SystemExit) as port_err:
            serve_main(["-p", HP8, "-s", "8", *argv])
        assert port_err.value.code == ref_err.value.code


# ------------------------------------------------------------- hot swap
def test_hot_swap_keeps_storage_and_skips_a_corrupt_newest(cora, tmp_path):
    """One ``poll`` swaps the newest intact file in: rows before equal the
    random-weight rows, rows after equal the trainer's ``predict`` rows
    bit for bit, ``weights_rev`` goes up by one and every parameter keeps
    its ``data_ptr()``.  With the newest file corrupt, the poll warns and
    swaps the one before it in."""
    tr = _port(cora, "gcn", seed=12)
    mgr = CheckpointManager(str(tmp_path / "d"))
    qids = synthetic_query_ids(cora["plan"].n, 24, seed=2)
    rows = {}
    for step in (1, 2):
        tr.step(cora["data"])
        mgr.save(tr, step)
        rows[step] = tr.predict(cora["data"])[qids]
    eng = ServeEngine(cora["plan"], fin=FIN, widths=WIDTHS, seed=5,
                      device="cpu")
    eng.set_features(cora["feats"])
    rand = eng.query(qids)
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    watch = eng.attach_checkpoint_watch(str(tmp_path / "d"))
    assert watch.poll(eng) and eng.weights_rev == 1
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
    assert np.array_equal(eng.query(qids), rows[2])
    assert not watch.poll(eng) and eng.weights_rev == 1
    assert not np.array_equal(rand, rows[2])

    eng2 = ServeEngine(cora["plan"], fin=FIN, widths=WIDTHS, seed=5,
                       device="cpu")
    eng2.set_features(cora["feats"])
    assert np.array_equal(eng2.query(qids), rand)
    faults.corrupt_file(mgr.path_for(2))
    eng2.attach_checkpoint_watch(str(tmp_path / "d"))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        got = eng2.query(qids)              # the batch polls first
    assert eng2.weights_rev == 1 and eng2.checkpoint_meta["step"] == 1
    assert np.array_equal(got, rows[1])
    # a wrong-plan file in the watched directory raises, state unchanged
    bad = FullBatchTrainer(build_comm_plan(normalize_adjacency(cora["a"]),
                                           read_partvec(HP4), 4),
                           fin=FIN, widths=WIDTHS, device="cpu")
    CheckpointManager(str(tmp_path / "d")).save(bad, 5)
    with pytest.raises(ValueError, match="plan digest mismatch"):
        eng2.query(qids)
    assert eng2.weights_rev == 1
    assert np.array_equal(eng2.query(qids[:0]), np.zeros((0, 7)))
