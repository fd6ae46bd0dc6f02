"""The mini-batch trainer and the accuracy experiment on the rank runtime
(ROADMAP A2c's last part): 8 gloo ranks on cora2708 under its 8-part hp
partition, GCN and GAT 1433 → 16 → 7.

Batches of 48, four of them, from seed 24: batch 0 misses one of the
eight parts, so that rank trains on a slice with no real row and still
takes part in every collective.  One module-scoped spawn
(``tests/torch_rank_child.py::minibatch_ranks_main``) runs, per case
(GCN a2a, GCN on the ring, GAT a2a), one epoch of batch steps, the
full-graph evaluation, the merged comm report and one fused epoch, then
the train CLI's ``main()`` under torchrun's variables: ``-n 512``,
``--experiment accuracy -n 1024``, and a ``-n`` run cut after its first
checkpointed epoch and resumed with ``--resume auto``.  Meanwhile the parent runs the
stacked mini-batch trainer, the reference's (``optax.scale(1/k)``, C3)
and the one-process CLI on the same inputs.
"""

import json
import os
import pickle
import tempfile

import numpy as np
import optax
import pytest
import torch

from sgcn_tpu.prep import normalize_adjacency as ref_normalize
from sgcn_tpu.train.minibatch import MiniBatchTrainer as RefMiniBatch
from sgcn_tpu_torch.io.datasets import load_npz_dataset
from sgcn_tpu_torch.parallel import init_rank_group
from sgcn_tpu_torch.train.__main__ import main as train_main
from sgcn_tpu_torch.train.minibatch import sample_batches

import torch_rank_child as child

K = 8
CASES = list(child.MB_CASES)
BASE = ["--npz", child.NPZ, "--normalize", "-p",
        os.path.join(child.FIX, "cora2708.8.hp"), "-s", "8", "-l", "2",
        "--hidden", "16", "--warmup", "0", "--device", "cpu"]
DURABLE = ["-n", "512", "--checkpoint-every", "1", "--checkpoint-dir"]
# the CLI jobs on 8 ranks that also run in one process (the mini-batch
# run's checkpoint directory named at the call)
JOBS = {"minibatch": ["--epochs", "2"] + DURABLE,
        "accuracy": ["--experiment", "accuracy", "-n", "1024", "--epochs",
                     "3"]}
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def _epoch_losses(stdout):
    """The ``epoch i: batch-avg loss X`` lines' losses and the report."""
    lines = stdout.strip().splitlines()
    return ([float(x.rsplit(" ", 1)[1]) for x in lines
             if x.startswith("epoch ")], json.loads(lines[-1]))


@pytest.fixture(scope="module")
def cora():
    """Cora 8-hp and the reference's initial weights of seed 24 (its
    mini-batch trainer draws them from its ``seed``, as its batches)."""
    from sgcn_tpu.parallel import build_comm_plan as ref_build_comm_plan
    from sgcn_tpu.train.fullbatch import FullBatchTrainer as RefTrainer

    ahat, feats, labels, pv, _plan = child.cora_plan("cora2708.8.hp")
    a, _f, _l = load_npz_dataset(child.NPZ)
    ref_plan = ref_build_comm_plan(ref_normalize(a), pv, K)
    kw = dict(fin=child.FIN, widths=child.WIDTHS, seed=child.MB_SEED)
    p0 = {"gcn": [np.asarray(w) for w in RefTrainer(ref_plan, **kw).params],
          "gat": [{k: np.asarray(v) for k, v in p.items()}
                  for p in RefTrainer(ref_plan, **kw, model="gat",
                                      activation="none").params]}
    return {"ahat": ahat, "ref_ahat": ref_normalize(a), "feats": feats,
            "labels": labels, "pv": pv, "p0": p0}


@pytest.fixture(scope="module")
def runs(cora):
    """Every rank's results (one spawn of 8), and meanwhile the stacked
    trainer's, the reference's and the one-process CLI's."""
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as out:
        with open(os.path.join(out, "init.pkl"), "wb") as fh:
            pickle.dump(cora["p0"], fh)
        ck = {name: os.path.join(out, name)
              for name in ("whole", "cut", "one")}
        jobs = {"minibatch": BASE + JOBS["minibatch"] + [ck["whole"]],
                "accuracy": BASE + JOBS["accuracy"],
                "cut": BASE + ["--epochs", "1"] + DURABLE + [ck["cut"]],
                "resumed": BASE + ["--epochs", "2"] + DURABLE
                + [ck["cut"], "--resume", "auto"]}
        with open(os.path.join(out, "jobs.pkl"), "wb") as fh:
            pickle.dump(jobs, fh)
        join = child.start_ranks(child.minibatch_ranks_main, K, out)
        try:
            stacked = {case: child.minibatch_run(
                cora["ahat"], cora["feats"], cora["labels"], cora["pv"],
                case, cora["p0"]) for case in CASES}
            reference = {case: _reference_epoch(cora, case)
                         for case in CASES}
            one = _one_process_cli(ck["one"])
        finally:
            ranks = join()
        files = {name: sorted(os.listdir(d)) for name, d in ck.items()}
        saved = {name: _checkpoint_state(os.path.join(d, "ckpt_00000002.npz"))
                 for name, d in ck.items() if name != "one"}
    return {"ranks": ranks, "stacked": stacked, "reference": reference,
            "one": one, "files": files, "saved": saved}


def _reference_epoch(cora, case):
    """One epoch of the reference's mini-batch trainer on the same
    batches from the same weights (its own init of seed 24: ``p0``),
    ``optax.scale(1/k)`` before Adam."""
    model, sched = child.MB_CASES[case]
    ref = RefMiniBatch(
        cora["ref_ahat"], cora["pv"], K, fin=child.FIN, widths=child.WIDTHS,
        batch_size=child.MB_BATCH, nbatches=child.MB_NBATCHES,
        seed=child.MB_SEED, model=model,
        activation="relu" if model == "gcn" else "none", comm_schedule=sched,
        optimizer=optax.chain(optax.scale(1.0 / K), optax.adam(child.LR)))
    return [ref.step(b) for b in ref.make_batches(cora["feats"],
                                                  cora["labels"])]


def _one_process_cli(ck):
    """The one-process CLI's stdout of each ``JOBS`` job (the launch
    variables unset: the stacked layout), the mini-batch run's
    checkpoints in ``ck``."""
    import contextlib
    import io

    env = {v: os.environ.pop(v) for v in LAUNCH_VARS if v in os.environ}
    try:
        out = {}
        for name, extra in JOBS.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train_main(BASE + extra + ([ck] if name == "minibatch"
                                           else []))
            out[name] = buf.getvalue()
        return out
    finally:
        os.environ.update(env)


def _checkpoint_state(path):
    """A checkpoint file's leaves (weights and Adam state) and step."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files
                if k.startswith("leaf_") or k == "__step__"}


def test_a_batch_misses_a_part(runs):
    """Seed 24 draws a batch with no vertex of some part: that part's
    rank trains batch 0 on a slice with no real row."""
    pv = child.cora_plan("cora2708.8.hp")[3]
    bats = sample_batches(2708, child.MB_BATCH, child.MB_NBATCHES,
                          seed=child.MB_SEED)
    missing = [set(range(K)) - set(pv[b].tolist()) for b in bats]
    assert missing[0] and not any(missing[1:])
    for r in missing[0]:
        assert runs["ranks"][r]["gcn-a2a"]["real_rows"][0] == 0


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_bits(runs, case):
    """After the epoch every rank holds rank 0's losses, weights,
    evaluation and comm report bit for bit."""
    ranks = runs["ranks"]
    for r in range(1, K):
        for key in ("losses", "eval0", "eval", "report", "fused"):
            assert ranks[r][case][key] == ranks[0][case][key], key
        for a, b in zip(ranks[r][case]["params"], ranks[0][case]["params"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_batch_steps_track_the_stacked_trainer(runs, case):
    """Each batch step's loss on 8 ranks within rtol 1e-6 of the stacked
    mini-batch trainer's and the weights after the epoch within 1e-5 for
    99 % of the entries and 5e-3 (half an Adam step) for all (the f32
    contract of ``tests/test_torch_ranks_gat.py``, over all the weights
    at once: the loss's per-part sums and the weight gradients are
    all-reduced in another order than the stacked sums, and on batches of
    48 most rows' only in-edge is their self loop, so GAT's ``a2`` has a
    gradient of rounding size that Adam turns into steps of either sign:
    observed up to 2.4e-3 on its 7 last-layer entries); the merged comm
    report equal (every rank books the full batch plans' figures)."""
    got, want = runs["ranks"][0][case], runs["stacked"][case]
    print(f"{case}: ranks {got['losses']} stacked {want['losses']}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    gap = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        got["params"], want["params"])])
    print(f"{case}: weight gaps: {np.mean(gap <= 1e-5):.4f} within 1e-5, "
          f"max {gap.max():.3g}")
    assert np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 5e-3
    assert got["report"] == want["report"]


@pytest.mark.parametrize("case", CASES)
def test_fused_epoch_and_fullgraph_evaluation(runs, case):
    """``run_epochs_fused`` on 8 ranks equals the ranks' stepwise epoch
    bit for bit (the same launches and collectives in the same order)
    and the stacked fused epoch within the f32 contract;
    ``evaluate_fullgraph`` (the full graph's plan, sliced per rank) at
    the initial weights within rtol 1e-6 of the stacked one's loss (the
    same rows, the loss's sums in another order) and at its accuracy."""
    got, want = runs["ranks"][0][case], runs["stacked"][case]
    assert got["fused"] == [np.float32(x) for x in got["losses"]]
    for a, b in zip(got["fused_params"], got["params"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(got["fused"], want["fused"], rtol=1e-6)
    print(f"{case}: evaluate_fullgraph ranks {got['eval0']} stacked "
          f"{want['eval0']}")
    np.testing.assert_allclose(got["eval0"][0], want["eval0"][0], rtol=1e-6)
    assert got["eval0"][1] == want["eval0"][1]


@pytest.mark.parametrize("case", CASES)
def test_one_epoch_tracks_the_reference(runs, case):
    """Rank 0's epoch against the reference's mini-batch trainer on the
    same batches from the same weights with ``optax.scale(1/k)`` (C3):
    GCN within rtol 1e-5, GAT within 5e-5 (the bounds of
    ``tests/test_torch_minibatch.py``)."""
    got, want = runs["ranks"][0][case]["losses"], runs["reference"][case]
    print(f"{case}: ranks {got} reference {want}")
    rtol = 1e-5 if case.startswith("gcn") else 5e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("job", list(JOBS))
def test_cli_on_ranks_prints_the_one_process_numbers(runs, job):
    """``main()`` on 8 ranks under torchrun's variables with ``-n`` and
    with ``--experiment accuracy``: rank 0 prints the one-process CLI's
    epoch losses and report numbers within rtol 1e-6 (timings aside),
    the other ranks print nothing."""
    ranks = runs["ranks"]
    for r in range(1, K):
        assert ranks[r]["cli"][job] == {"stdout": "", "exit": None}
    assert ranks[0]["cli"][job]["exit"] is None
    got, rep = _epoch_losses(ranks[0]["cli"][job]["stdout"])
    want, wrep = _epoch_losses(runs["one"][job])
    print(f"{job}: ranks {got} {rep}; one process {want} {wrep}")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    timing = ("elapsed_s", "epoch_s", "phases")
    assert set(rep) == set(wrep)
    for key, v in wrep.items():
        if key in timing:
            continue
        if isinstance(v, float):
            np.testing.assert_allclose(rep[key], v, rtol=1e-6, err_msg=key)
        else:
            assert rep[key] == v, key


def test_cli_minibatch_resume_on_ranks_equals_the_whole_run(runs):
    """``-n 512 --checkpoint-dir --checkpoint-every 1`` on 8 ranks: rank
    0 alone writes a checkpoint per epoch; a one-epoch run resumed with
    ``--resume auto`` to two epochs writes the uninterrupted run's epoch-2
    weights and Adam state bit for bit, and prints its second epoch's
    loss."""
    ranks = runs["ranks"]
    assert runs["files"]["whole"] == runs["files"]["cut"] == \
        runs["files"]["one"] == ["ckpt_00000001.npz", "ckpt_00000002.npz"]
    whole, cut = runs["saved"]["whole"], runs["saved"]["cut"]
    assert whole and set(whole) == set(cut)
    for key in whole:
        assert np.array_equal(whole[key], cut[key]), key
    full, _ = _epoch_losses(ranks[0]["cli"]["minibatch"]["stdout"])
    rest, rep = _epoch_losses(ranks[0]["cli"]["resumed"]["stdout"])
    assert rep["resumed"]["step"] == 1 and rest == full[1:]
    for r in range(1, K):
        for job in ("cut", "resumed"):
            assert ranks[r]["cli"][job] == {"stdout": "", "exit": None}


def test_one_rank_group_equals_the_shard_proxy(cora, tmp_path):
    """``MiniBatchTrainer(part=c)`` on a one-rank group (its collectives
    loop back) equals the same part's slices trained stacked, without a
    group (the shard proxy), bit for bit, on the part batch 0 misses."""
    pv = cora["pv"]
    bats = sample_batches(2708, child.MB_BATCH, child.MB_NBATCHES,
                          seed=child.MB_SEED)
    part = min(set(range(K)) - set(pv[bats[0]].tolist()))
    mesh = init_rank_group("file://" + str(tmp_path / "rdv"), 1, 0,
                           device="cpu")
    try:
        out = []
        for group in (None, mesh):
            tr = child.minibatch_trainer(cora["ahat"], pv, "gcn-a2a",
                                         cora["p0"], part=part, mesh=group)
            batches = tr.make_batches(cora["feats"], cora["labels"])
            out.append(([tr.step(b) for b in batches],
                        [w.detach().clone()
                         for w in tr.inner.model.parameters()]))
    finally:
        mesh.close()
    assert out[0][0] == out[1][0] and np.isfinite(out[0][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
