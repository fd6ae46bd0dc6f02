"""Rank-process entries of the port's rank-runtime tests
(``tests/test_torch_ranks.py``, ``tests/test_torch_cagnet1d.py``).

A test spawns one process per part (``torch.multiprocessing``, ``spawn``)
through ``spawn_ranks``; each opens a gloo group on a ``file://``
rendezvous of its own, runs its checks on cora2708 and writes what the
parent compares into ``<out_dir>/rank<r>.pkl``.  Imports no JAX.
"""

import os
import pickle

import numpy as np

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NPZ = os.path.join(FIX, "cora2708.npz")
FIN, WIDTHS, STEPS, LR = 1433, [16, 7], 3, 0.01
LAYER_F = 16                     # one aggregation's width in the op checks


def spawn_ranks(target, world, out_dir, timeout=240.0):
    """Run ``target(rank, world, init_method, out_dir)`` in ``world``
    spawned processes at once; returns every rank's pickled result.
    Raises if a rank fails or outlives ``timeout``."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=target, args=(r, world, init, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"rank processes ended with {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def cora_plan(hp):
    """Cora2708's normalized Â, features, labels and the plan of the part
    vector file ``hp``, with every layout the rank path reads."""
    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency

    a, feats, labels = load_npz_dataset(NPZ)
    pv = read_partvec(os.path.join(FIX, hp))
    ahat = normalize_adjacency(a)
    plan = build_comm_plan(ahat, pv, pv.max() + 1)
    plan.ensure_exchange()
    plan.ensure_pallas_tiles()
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    return ahat, feats, labels, pv, plan


def op_inputs(plan, seed=0):
    """The stacked ``(k, B, LAYER_F)`` rows and gradient every rank's
    one-layer check reads its own part of."""
    rng = np.random.default_rng(seed)
    shape = (plan.k, plan.b, LAYER_F)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _write(out_dir, rank, res):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks.py`` on cora 8-hp:
    one aggregation's forward and VJP per transport and wire, with the
    order of its launches and waits; three training steps per transport
    from the weights in ``<out_dir>/init.pkl``; the refusals."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.ops import tile_spmm
    from sgcn_tpu_torch.parallel import init_rank_group, shard_proxy_plan
    from sgcn_tpu_torch.train import (FullBatchTrainer,
                                      make_train_data_multihost)

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        _ahat, feats, labels, _pv, plan = cora_plan("cora2708.8.hp")
        res = {"order": {}, "fwd": {}, "vjp": {}, "losses": {},
               "params": {}, "errors": {}}
        # the launch and wait order of one aggregation
        log = []
        family, exchange = tile_spmm.spmm_tiles_classes, \
            tile_spmm.rank_exchange

        def logged_family(*a, **kw):
            log.append("family")
            return family(*a, **kw)

        def logged_exchange(*a, **kw):
            log.append("issue")
            recv, wait = exchange(*a, **kw)

            def logged_wait():
                log.append("wait")
                wait()
            return recv, logged_wait

        tile_spmm.spmm_tiles_classes = logged_family
        tile_spmm.rank_exchange = logged_exchange
        sl = shard_proxy_plan(plan, rank)
        h_all, g_all = op_inputs(plan)
        pa = {f: torch.as_tensor(getattr(sl, f)) for f in (
            "recv_src", "ring_src", "ptile_lsrc", "ptile_lld", "ptile_lw",
            "ptile_hwsrc", "ptile_hrsrc", "ptile_hld", "ptile_hw")}
        for sched in ("a2a", "ragged"):
            for wire in (None, "bfloat16"):
                key = f"{sched}-{wire or 'float32'}"
                h = torch.tensor(h_all[rank: rank + 1], requires_grad=True)
                del log[:]
                out = tile_spmm.pspmm_tiles_ranks(
                    h, pa, plan.pallas_tb, plan.pallas_lclasses,
                    plan.pallas_hclasses, mesh,
                    plan.rr_sizes if sched == "ragged" else None, wire)
                res["order"][key] = list(log)
                out.backward(torch.as_tensor(g_all[rank: rank + 1]))
                res["fwd"][key] = out.detach().numpy()
                res["vjp"][key] = h.grad.numpy()
        tile_spmm.spmm_tiles_classes, tile_spmm.rank_exchange = \
            family, exchange

        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        data = make_train_data_multihost(plan, mesh, feats, labels)
        for sched in ("a2a", "ragged"):
            tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, lr=LR,
                                  params=p0, comm_schedule=sched,
                                  mesh=mesh)
            res["losses"][sched] = [tr.step(data) for _ in range(STEPS)]
            res["params"][sched] = [w.detach().numpy() for w in tr.params]
            if sched == "a2a":
                res["eval"] = tr.evaluate(data)
                res["pred"] = tr.predict(data)
                res["report"] = tr.stats.report()
        for name, kw in (("gat", {"model": "gat"}),
                         ("compute_dtype", {"compute_dtype": "bfloat16"}),
                         ("stale", {"halo_staleness": 1}),
                         ("replica", {"replica_budget": 50})):
            try:
                FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, mesh=mesh,
                                 **kw)
            except ValueError as exc:
                res["errors"][name] = str(exc)
        _write(out_dir, rank, res)
    finally:
        mesh.close()


def broadcast_main(rank, world, init, out_dir):
    """The broadcast baseline on ``world`` gloo ranks (cora 4-hp, the
    weights in ``<out_dir>/init.pkl``): each rank's forward, fused and
    phase-split, and its report."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.baselines.cagnet1d import BroadcastGCN1D
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        ahat, feats, _labels, pv, _plan = cora_plan("cora2708.4.hp")
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            job = pickle.load(fh)
        res = {}
        for fused in (False, True):
            bc = BroadcastGCN1D(ahat, pv, world, fin=feats.shape[1],
                                widths=job["widths"], params=job["params"],
                                fused=fused, mesh=mesh)
            report, out = bc.run_epochs(feats, epochs=2)
            res[fused] = {"out": out, "report": report}
        _write(out_dir, rank, res)
    finally:
        mesh.close()
