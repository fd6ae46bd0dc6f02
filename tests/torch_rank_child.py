"""Rank-process entries of the port's rank-runtime tests
(``tests/test_torch_ranks.py``, ``tests/test_torch_ranks_gat.py``,
``tests/test_torch_launch.py``, ``tests/test_torch_cagnet1d.py``,
``tests/test_torch_ranks_carried.py``,
``tests/test_torch_ranks_directed.py``,
``tests/test_torch_ranks_minibatch.py``,
``tests/test_torch_ranks_serve.py``, ``tests/test_torch_ranks_ell.py``,
``tests/test_torch_ranks_analysis.py``).

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
# the rendezvous ports of ``cli_rank_main``'s jobs, below Linux's default
# ephemeral range (32768-60999): a port picked in that range could be
# taken, before its job binds it, by a listener of another rank group
# (gloo's listeners bind ephemeral ports)
PORT_RANGE = (20000, 32768)


def spawn_ranks(target, world, out_dir, timeout=240.0):
    """Run ``target(rank, world, init_method, out_dir)`` in ``world``
    spawned processes at once; returns every rank's pickled result.
    Raises if a rank fails or outlives ``timeout``."""
    return start_ranks(target, world, out_dir, timeout)()


def start_ranks(target, world, out_dir, timeout=240.0):
    """``spawn_ranks`` without waiting: the ranks start, and the returned
    ``join()`` waits for them (at most ``timeout`` seconds from now) and
    returns their results, so the caller can work meanwhile."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=target, args=(r, world, init, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    return lambda: _join_ranks(procs, deadline, out_dir)


def _join_ranks(procs, deadline, out_dir):
    import time

    world = len(procs)
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


# one GAT layer's table form by (fout, compute_dtype): the fused
# (fout + 1)-lane table, the split pair, the packed bf16 words, and the
# fused form on bf16 tables (an odd fout)
GAT_OP_CASES = {"fused": (16, None), "split": (128, None),
                "packed": (16, "bfloat16"), "fused-bf16": (7, "bfloat16")}
SCHEDS = ("a2a", "ragged")
# the trainer cases of A2c's first half: GAT both transports, GAT under
# compute_dtype and remat, and GCN under compute_dtype
STEP_CASES = {"gat-a2a": {"model": "gat", "comm_schedule": "a2a"},
              "gat-ragged": {"model": "gat", "comm_schedule": "ragged"},
              "gat-bf16": {"model": "gat", "compute_dtype": "bfloat16"},
              "gat-remat": {"model": "gat", "remat": True},
              "gcn-bf16": {"compute_dtype": "bfloat16"}}


def step_kwargs(case, p0):
    """``FullBatchTrainer`` keyword arguments of a ``STEP_CASES`` case
    from the initial weights ``p0`` (``{"gcn": [...], "gat": [...]}``)."""
    kw = dict(STEP_CASES[case])
    model = kw.get("model", "gcn")
    kw.setdefault("comm_schedule", "a2a")
    kw["params"] = p0[model]
    if model == "gat":
        kw["activation"] = "none"       # PGAT stacks bare layers
    return kw


def gat_op_inputs(plan, fout, seed=1):
    """The stacked ``(k, B, LAYER_F)`` rows, the ``(k, B, fout)``
    gradient and one layer's ``{w, a1, a2}`` of a one-layer GAT check."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((plan.k, plan.b, LAYER_F)).astype(np.float32)
    g = rng.standard_normal((plan.k, plan.b, fout)).astype(np.float32)
    w = (rng.standard_normal((LAYER_F, fout))
         / np.sqrt(LAYER_F)).astype(np.float32)
    a = (rng.standard_normal((2, fout)) / np.sqrt(fout)).astype(np.float32)
    return h, g, [{"w": w, "a1": a[0], "a2": a[1]}]


def gat_layer_run(plan, setup, h, g, params, compute_dtype, mesh=None):
    """One GAT layer's forward rows and VJP in ``h`` on ``plan`` (the
    stacked plan, or a rank's slice with ``mesh``)."""
    import torch

    from sgcn_tpu_torch.models.gat import (gat_forward_local,
                                           gat_param_tensors)

    pa = setup.ship_arrays(plan, "cpu", compute_dtype)
    h = torch.tensor(h, requires_grad=True)
    out = gat_forward_local(gat_param_tensors(params), h, pa,
                            compute_dtype=compute_dtype, mesh=mesh,
                            **setup.fwd_static)
    out.backward(torch.as_tensor(g))
    return out.detach().numpy(), h.grad.numpy()


def gcn_bf16_op(plan, sched, h, g, mesh=None, rank=None):
    """One GCN aggregation on bf16 rows (``compute_dtype``) and its VJP,
    stacked or on a rank (``mesh``, the rank's slice ``plan``), as
    float32 arrays (the widening is exact)."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_ragged,
                                              pspmm_tiles_ranks,
                                              pspmm_tiles_sym)

    pa = {f: torch.as_tensor(getattr(plan, f)) for f in (
        "recv_src", "ring_src", "ptile_lsrc", "ptile_lld", "ptile_lw",
        "ptile_hwsrc", "ptile_hrsrc", "ptile_hld", "ptile_hw")}
    # the trainer's one rounding of the tile weights through bf16
    for f in ("ptile_lw", "ptile_hw"):
        pa[f] = pa[f].to(torch.bfloat16).float()
    sl = slice(None) if rank is None else slice(rank, rank + 1)
    x = torch.tensor(h[sl]).to(torch.bfloat16).requires_grad_()
    rr = plan.rr_sizes if sched == "ragged" else None
    tiles = (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"])
    if mesh is not None:
        y = pspmm_tiles_ranks(x, pa, plan.pallas_tb, plan.pallas_lclasses,
                              plan.pallas_hclasses, mesh, rr)
    elif rr is None:
        y = pspmm_tiles_sym(x, pa["recv_src"], *tiles, pa["ptile_hwsrc"],
                            pa["ptile_hld"], pa["ptile_hw"], plan.pallas_tb,
                            plan.pallas_lclasses, plan.pallas_hclasses)
    else:
        y = pspmm_tiles_ragged(x, pa["ring_src"], *tiles, pa["ptile_hrsrc"],
                               pa["ptile_hld"], pa["ptile_hw"],
                               plan.pallas_tb, plan.pallas_lclasses,
                               plan.pallas_hclasses, rr)
    y.backward(torch.tensor(g[sl]).to(torch.bfloat16))
    return y.detach().float().numpy(), x.grad.float().numpy()


def gat_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_gat.py`` on cora 8-hp:
    one GAT layer's forward and VJP per table form and transport, one GCN
    aggregation on bf16 rows per transport, and three training steps per
    ``STEP_CASES`` case from the weights in ``<out_dir>/init.pkl``."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.parallel import init_rank_group, shard_proxy_plan
    from sgcn_tpu_torch.train import (FullBatchTrainer,
                                      make_train_data_multihost,
                                      resolve_forward_setup)

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        _ahat, feats, labels, _pv, plan = cora_plan("cora2708.8.hp")
        res = {"gat_op": {}, "gcn_op": {}, "losses": {}, "params": {}}
        for sched in SCHEDS:
            setup = resolve_forward_setup(plan, model="gat",
                                          comm_schedule=sched)
            sl = shard_proxy_plan(plan, rank)
            for form, (fout, cd) in GAT_OP_CASES.items():
                h, g, params = gat_op_inputs(plan, fout)
                res["gat_op"][f"{form}-{sched}"] = gat_layer_run(
                    sl, setup, h[rank: rank + 1], g[rank: rank + 1], params,
                    cd, mesh)
            h_all, g_all = op_inputs(plan)
            res["gcn_op"][sched] = gcn_bf16_op(sl, sched, h_all, g_all,
                                               mesh, rank)
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        data = make_train_data_multihost(plan, mesh, feats, labels)
        for case in STEP_CASES:
            tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, lr=LR,
                                  mesh=mesh, **step_kwargs(case, p0))
            res["losses"][case] = [tr.step(data) for _ in range(STEPS)]
            res["params"][case] = [w.detach().numpy()
                                   for w in tr.model.parameters()]
        _write(out_dir, rank, res)
    finally:
        mesh.close()


def job_port(out_dir, name, rank, timeout=120.0):
    """The rendezvous port of job ``name``: rank 0 picks a free one in
    ``PORT_RANGE`` just before the job and publishes it in
    ``<out_dir>/port.<name>``; the other ranks wait for the file."""
    import random
    import socket
    import time

    path = os.path.join(out_dir, f"port.{name}")
    if rank == 0:
        rng = random.Random()
        while True:
            port = rng.randrange(*PORT_RANGE)
            with socket.socket() as s:
                try:
                    s.bind(("", port))
                except OSError:
                    continue
            break
        with open(path + ".tmp", "w") as fh:
            fh.write(str(port))
        os.replace(path + ".tmp", path)
        return port
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank 0 published no port for job {name}")
        time.sleep(0.02)
    with open(path) as fh:
        return int(fh.read())


def cli_rank_main(rank, world, init, out_dir):
    """``python -m sgcn_tpu_torch.train``'s ``main`` as rank ``rank`` of a
    ``torchrun``-launched world: the launcher's environment set here, one
    job after another from ``<out_dir>/jobs.pkl`` (``{name: argv}``, each
    job its own rendezvous port, ``job_port``); per job the rank's
    standard output and, for a run that exits, its message."""
    import torch

    torch.set_num_threads(1)
    _write(out_dir, rank, _cli_jobs(rank, world, out_dir))


def _cli_jobs(rank, world, out_dir, main=None):
    """``cli_rank_main``'s jobs as rank ``rank``: per job its standard
    output and exit message.  ``main``: the CLI's (default the train
    CLI's)."""
    import contextlib
    import io

    if main is None:
        from sgcn_tpu_torch.train.__main__ import main
    train_main = main

    with open(os.path.join(out_dir, "jobs.pkl"), "rb") as fh:
        jobs = pickle.load(fh)
    res = {}
    for name, argv in jobs.items():
        port = job_port(out_dir, name, rank)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                train_main(list(argv))
            res[name] = {"stdout": buf.getvalue(), "exit": None}
        except SystemExit as e:
            res[name] = {"stdout": buf.getvalue(), "exit": str(e)}
    return res


def _write(out_dir, rank, res):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks.py`` on cora 8-hp:
    one aggregation's forward and VJP per transport and wire, with the
    order of its launches and waits; three training steps per transport
    from the weights in ``<out_dir>/init.pkl``; the refusals."""
    import dataclasses

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
        asym = dataclasses.replace(plan, symmetric=False)
        res["built"] = []
        for name, kw, pl in (("gat", {"model": "gat"}, plan),
                             ("compute_dtype",
                              {"compute_dtype": "bfloat16"}, plan),
                             ("stale", {"halo_staleness": 1}, plan),
                             ("replica", {"replica_budget": 50}, plan),
                             ("asymmetric", {}, asym)):
            try:
                FullBatchTrainer(pl, fin=FIN, widths=WIDTHS, mesh=mesh,
                                 **kw)
                res["built"].append(name)
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


# ------------------------------------------- the carried modes on ranks
# ROADMAP A2c's second half on cora 8-hp (GCN 1433 -> 16 -> 7): each case
# a ``FullBatchTrainer`` mode beside ``sync_every=2`` and the a2a
CARRIED_CASES = {
    "stale-a2a": {"halo_staleness": 1},
    "stale-ring": {"halo_staleness": 1, "comm_schedule": "ragged"},
    "stale-delta": {"halo_staleness": 1, "halo_delta": True},
    "stale-delta-ring": {"halo_staleness": 1, "halo_delta": True,
                         "comm_schedule": "ragged"},
    "stale-bf16": {"halo_staleness": 1, "halo_dtype": "bfloat16"},
    "replica-a2a": {"replica_budget": "auto"},
    "replica-ring": {"replica_budget": "auto", "comm_schedule": "ragged"},
    "replica-bf16": {"replica_budget": "auto", "halo_dtype": "bfloat16"},
    "replica-stale": {"replica_budget": "auto", "halo_staleness": 1},
    "partial": {"replica_budget": "auto", "refresh_band": 0.05},
    "controller": {"halo_staleness": 1, "comm_schedule": "auto"},
}
# ... and the ones held to the exact trainer: a sync every step
EXACT_CASES = {"stale-se1": {"halo_staleness": 1, "sync_every": 1},
               "replica-se1": {"replica_budget": "auto", "sync_every": 1},
               "exact": {}}
# the one-layer checks: a sync step, then a carried one
OP_CASES = ("stale-a2a", "stale-ring", "stale-delta", "stale-delta-ring",
            "stale-bf16", "replica-a2a", "replica-ring", "replica-bf16",
            "replica-stale", "partial")
CARRIED_STEPS = 5


def carried_kwargs(case, **extra):
    """``FullBatchTrainer`` keyword arguments of a ``CARRIED_CASES`` or
    ``EXACT_CASES`` case: ``sync_every=2`` and the a2a unless it says
    otherwise."""
    kw = dict(CARRIED_CASES.get(case) or EXACT_CASES[case])
    if case in CARRIED_CASES:
        kw.setdefault("sync_every", 2)
    kw.setdefault("comm_schedule", "a2a")
    kw.update(extra)
    return kw


def carried_op_inputs(plan):
    """Two steps' stacked ``(k, B, LAYER_F)`` rows and gradients, and the
    ``(LAYER_F, LAYER_F)`` weight of the one-layer checks."""
    rng = np.random.default_rng(7)
    shape = (plan.k, plan.b, LAYER_F)
    hs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    gs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    w = (rng.standard_normal((LAYER_F, LAYER_F))
         / np.sqrt(LAYER_F)).astype(np.float32)
    return hs, gs, w


def carried_layer_steps(tr, hs, gs):
    """One layer of ``tr``'s carried mode (``fin = widths[0] =
    LAYER_F``), two steps from its zero carries: a sync step on ``hs[0]``,
    then a carried one on ``hs[1]`` (a replica step, or under
    ``refresh_band`` the partial refresh), each differentiated against
    ``gs[i]``.  Per step: the rows, the VJP in ``h``, the next feature and
    gradient carries (waited on), the senders' delta baselines (a rank's
    own, or the stacked carry's transpose), the stale mode's
    quantization residual gauge and the refresh count.
    ``hs``/``gs`` are the stacked arrays or a rank's own part of them."""
    import torch

    from sgcn_tpu_torch.models.gcn import (gcn_forward_local_replica,
                                           gcn_forward_local_stale)
    from sgcn_tpu_torch.ops import pspmm

    stale = bool(tr.halo_staleness)
    carry = dict(tr.halo_carry if stale else tr.replica_carry)
    ragged = tr.comm_schedule == "ragged"
    out = []
    for step, (h, g) in enumerate(zip(hs, gs)):
        fresh = step == 0
        x = torch.tensor(h, requires_grad=True)
        gholder = list(carry["ghalos"])
        kw = dict(activation="none", **tr._rank_static(),
                  **tr.setup.fwd_static)
        nship = qerr = None
        if stale:
            bases = list(carry["bases"]) if "bases" in carry else None
            y, halos, qerrs = gcn_forward_local_stale(
                list(tr.model.weights), x, tr.pa, carry["halos"],
                carry["ghalos"], gholder, delta=tr.halo_delta,
                wire_dtype="bfloat16" if tr.halo_delta else tr.halo_dtype,
                gwire_dtype=tr.halo_dtype, fresh=fresh,
                replica=bool(tr.replica_budget), bases=bases, gauges=True,
                **kw)
            qerr = float(qerrs[0])
            nxt = {"halos": halos, "ghalos": gholder}
            if bases is not None:
                nxt["bases"] = bases
        else:
            y, halos, rbases, nships = gcn_forward_local_replica(
                list(tr.model.weights), x, tr.pa, carry["halos"],
                carry["ghalos"], gholder, halo_dtype=tr.halo_dtype,
                fresh=fresh, rep_base=carry.get("rep_base"),
                partial_step=tr.refresh_band is not None and not fresh,
                band=float(tr.refresh_band or 0.0), **kw)
            nxt = {"halos": halos, "ghalos": gholder}
            if "rep_base" in carry:
                nxt["rep_base"] = rbases
            if nships[0] is not None:
                nship = int(nships[0])
        y.backward(torch.as_tensor(g))
        carry = nxt
        res = {"out": y.detach().numpy(), "vjp": x.grad.numpy(),
               "halo": pspmm.settle(carry["halos"][0]).float().numpy(),
               "ghalo": pspmm.settle(carry["ghalos"][0]).float().numpy(),
               "nship": nship, "qerr": qerr}
        if "rep_base" in carry:
            res["rep_base"] = carry["rep_base"][0].numpy()
        if tr.halo_delta:
            if "bases" in carry:
                res["base"] = carry["bases"][0].numpy()
            else:
                c = carry["halos"][0]
                res["base"] = (pspmm.ring_to_send_bases(c, tr.plan.rr_sizes)
                               if ragged else pspmm.recv_to_send_bases(
                                   c, tr.plan.s).reshape(c.shape)).numpy()
        out.append(res)
    return out


def carried_run(tr, data, steps=CARRIED_STEPS):
    """``steps`` training steps of ``tr`` with its drift gauges on: the
    losses, the gauges and refresh counts after each step, the weights,
    the controller's log and the job's comm report."""
    tr.drift_gauges = True
    losses, gauges, rows = [], [], []
    for _ in range(steps):
        losses.append(tr.step(data))
        gauges.append({k: v.copy() for k, v in (tr.last_gauges or {}).items()})
        rows.append(tr.last_refresh_rows)
    tr._settle_carries()
    return {"losses": losses, "gauges": gauges, "rows": rows,
            "params": [w.detach().numpy() for w in tr.params],
            "controller": tr.comm_decision.get("controller"),
            "sync_every": tr.sync_every, "report": tr.job_report()}


def carried_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_carried.py`` on cora
    8-hp: one carried layer's two steps per ``OP_CASES`` case, then
    ``CARRIED_STEPS`` training steps per ``CARRIED_CASES`` and
    ``EXACT_CASES`` case from the weights in ``<out_dir>/init.pkl``, the
    in-flight exchanges of a stale run, the refusals; then the train
    CLI's jobs of ``<out_dir>/jobs.pkl`` (``cli_rank_main``)."""
    import dataclasses

    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.ops import pspmm
    from sgcn_tpu_torch.parallel import init_rank_group
    from sgcn_tpu_torch.train import (FullBatchTrainer,
                                      make_train_data_multihost)

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        _ahat, feats, labels, _pv, plan = cora_plan("cora2708.8.hp")
        res = {"op": {}, "runs": {}, "errors": {}}
        hs, gs, w = carried_op_inputs(plan)
        mine = slice(rank, rank + 1)
        for case in OP_CASES:
            tr = FullBatchTrainer(plan, fin=LAYER_F, widths=[LAYER_F],
                                  params=[w], mesh=mesh,
                                  **carried_kwargs(case))
            res["op"][case] = carried_layer_steps(
                tr, [h[mine] for h in hs], [g[mine] for g in gs])
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        data = make_train_data_multihost(plan, mesh, feats, labels)
        for case in list(CARRIED_CASES) + list(EXACT_CASES):
            tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, lr=LR,
                                  params=p0, mesh=mesh,
                                  **carried_kwargs(case))
            res["runs"][case] = carried_run(tr, data)
        # the stale exchanges stay in flight until their next read
        tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, lr=LR,
                              params=p0, mesh=mesh,
                              **carried_kwargs("stale-a2a"))
        flight = []
        for _ in range(3):
            tr.step(data)
            now = tr.halo_carry["halos"] + tr.halo_carry["ghalos"]
            flight.append({
                "pending": [isinstance(x, pspmm.InFlight) and not x.waited
                            for x in now],
                "before": [x.waited for x in prev] if flight else []})
            prev = [x for x in now if isinstance(x, pspmm.InFlight)]
        tr._settle_carries()
        res["flight"] = flight
        for name, kw, pl in (
                ("stale-ckpt", carried_kwargs("stale-a2a"), plan),
                ("replica-ckpt", carried_kwargs("replica-a2a"), plan),
                ("asymmetric", carried_kwargs("stale-a2a"),
                 dataclasses.replace(plan, symmetric=False))):
            try:
                tr = FullBatchTrainer(pl, fin=FIN, widths=WIDTHS, mesh=mesh,
                                      **kw)
                tr.resume_state()
            except ValueError as exc:
                res["errors"][name] = str(exc)
        tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, mesh=mesh,
                              **carried_kwargs("stale-a2a"))
        try:
            tr.attach_recorder(object())
        except ValueError as exc:
            res["errors"]["recorder"] = str(exc)
    finally:
        mesh.close()
    res["cli"] = _cli_jobs(rank, world, out_dir)
    _write(out_dir, rank, res)


# ------------------------------------------- directed plans on ranks
# ROADMAP A2c's last part on the directed cora2708 8-hp (each undirected
# edge kept in one direction by a seeded coin), 1433 -> 16 -> 7
DIRECTED_CASES = {"gcn": {}, "gcn-halo-bf16": {"halo_dtype": "bfloat16"},
                  "gcn-bf16": {"compute_dtype": "bfloat16"},
                  "gcn-remat": {"remat": True},
                  "gat": {"model": "gat"},
                  "gat-bf16": {"model": "gat", "compute_dtype": "bfloat16"}}
DIRECTED_STEPS = 5
# one GCN aggregation's lever: (halo_dtype, compute_dtype)
GCN_GEN_OPS = {"float32": (None, None), "halo-bf16": ("bfloat16", None),
               "bf16": (None, "bfloat16")}


def cora_directed_plan():
    """The directed cora (``tests/test_torch_asym.py``'s graph): its
    normalized Â, features, labels, part vector and plan, with the
    forward and transposed layouts of both models built."""
    import scipy.sparse as sp

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.train import resolve_forward_setup

    a, feats, labels = load_npz_dataset(NPZ)
    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    ad = sp.csr_matrix((np.ones(up.nnz, np.float32),
                        (np.where(flip, up.col, up.row),
                         np.where(flip, up.row, up.col))), shape=a.shape)
    pv = read_partvec(os.path.join(FIX, "cora2708.8.hp"))
    ahat = normalize_adjacency(ad)
    plan = build_comm_plan(ahat, pv, pv.max() + 1)
    for model in ("gcn", "gat"):
        resolve_forward_setup(plan, model=model)
    return ad, ahat, feats, labels, pv, plan


def directed_kwargs(case, p0):
    """``FullBatchTrainer`` keyword arguments of a ``DIRECTED_CASES``
    case from the initial weights ``p0``."""
    kw = dict(DIRECTED_CASES[case])
    model = kw.get("model", "gcn")
    kw["params"] = p0[model]
    if model == "gat":
        kw["activation"] = "none"
    return kw


def gcn_gen_op(plan, setup, lever, h, g, mesh=None):
    """One directed GCN aggregation and its VJP on ``plan`` (stacked, or a
    rank's slice with ``mesh``) under ``GCN_GEN_OPS[lever]``, as float32
    arrays."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_gen,
                                              pspmm_tiles_gen_ranks)

    halo, cd = GCN_GEN_OPS[lever]
    st = setup.fwd_static
    pa = setup.ship_arrays(plan, "cpu", cd)
    tcls = (st["pallas_tlclasses"], st["pallas_thclasses"],
            st["pallas_t1classes"])
    x = torch.tensor(h)
    x = (x.to(torch.bfloat16) if cd else x).requires_grad_()
    args = (x, pa, st["pallas_tb"], st["pallas_lclasses"],
            st["pallas_hclasses"], tcls)
    y = (pspmm_tiles_gen(*args, halo) if mesh is None
         else pspmm_tiles_gen_ranks(*args, mesh, halo))
    y.backward(torch.tensor(g).to(x.dtype))
    return y.detach().float().numpy(), x.grad.float().numpy()


def _order_logged(run):
    """``run()`` with the rank path's launches and waits logged in
    order: ``family`` per tile family launch, ``issue``/``wait`` of the
    forward exchange, ``rev-issue``/``rev-wait`` of the reverse one."""
    from sgcn_tpu_torch.ops import tile_spmm

    log = []
    saved = (tile_spmm.spmm_tiles_classes, tile_spmm.rank_exchange,
             tile_spmm.rank_reverse_exchange)

    def family(*a, **kw):
        log.append("family")
        return saved[0](*a, **kw)

    def logged(fn, name):
        def issue(*a, **kw):
            log.append(name + "issue")
            recv, wait = fn(*a, **kw)

            def logged_wait():
                log.append(name + "wait")
                wait()
            return recv, logged_wait
        return issue
    (tile_spmm.spmm_tiles_classes, tile_spmm.rank_exchange,
     tile_spmm.rank_reverse_exchange) = (
        family, logged(saved[1], ""), logged(saved[2], "rev-"))
    try:
        out = run()
    finally:
        (tile_spmm.spmm_tiles_classes, tile_spmm.rank_exchange,
         tile_spmm.rank_reverse_exchange) = saved
    return out, log


def directed_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_directed.py``: one
    directed GCN aggregation per lever (the f32 one's launch and wait
    order logged) and one GAT layer per table form, forward and VJP, on
    the rank's slice; then ``DIRECTED_STEPS`` training steps per
    ``DIRECTED_CASES`` case from ``<out_dir>/init.pkl``'s weights, with
    the step-1 weight gradients."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.parallel import init_rank_group, shard_proxy_plan
    from sgcn_tpu_torch.train import (FullBatchTrainer,
                                      make_train_data_multihost,
                                      resolve_forward_setup)

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        _ad, _ahat, feats, labels, _pv, plan = cora_directed_plan()
        sl = shard_proxy_plan(plan, rank)
        mine = slice(rank, rank + 1)
        res = {"gcn_op": {}, "gat_op": {}, "losses": {}, "params": {},
               "grads": {}}
        setup = resolve_forward_setup(plan)
        h, g = op_inputs(plan)
        for lever in GCN_GEN_OPS:
            res["gcn_op"][lever], log = _order_logged(
                lambda lever=lever: gcn_gen_op(sl, setup, lever, h[mine],
                                               g[mine], mesh))
            if lever == "float32":
                res["order"] = log
        gsetup = resolve_forward_setup(plan, model="gat")
        for form, (fout, cd) in GAT_OP_CASES.items():
            hh, gg, params = gat_op_inputs(plan, fout)
            res["gat_op"][form] = gat_layer_run(sl, gsetup, hh[mine],
                                                gg[mine], params, cd, mesh)
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        data = make_train_data_multihost(plan, mesh, feats, labels)
        for case in DIRECTED_CASES:
            tr = FullBatchTrainer(plan, fin=FIN, widths=WIDTHS, lr=LR,
                                  mesh=mesh, **directed_kwargs(case, p0))
            grads = []
            tr.opt.register_step_pre_hook(lambda *_a, tr=tr: grads.append(
                [p.grad.clone().numpy() for p in tr.model.parameters()])
                if not grads else None)
            res["losses"][case] = [tr.step(data)
                                   for _ in range(DIRECTED_STEPS)]
            res["params"][case] = [w.detach().numpy()
                                   for w in tr.model.parameters()]
            res["grads"][case] = grads[0]
            if case == "gcn":
                res["report"] = tr.job_report()
        _write(out_dir, rank, res)
    finally:
        mesh.close()


# ------------------------------------------ the mini-batch trainer on ranks
# a batch size and seed that draw a batch missing a part (batch 0 of the
# four misses one of cora 8-hp's parts)
MB_BATCH, MB_NBATCHES, MB_SEED = 48, 4, 24
MB_CASES = {"gcn-a2a": ("gcn", "a2a"), "gcn-ring": ("gcn", "ragged"),
            "gat-a2a": ("gat", "a2a")}


def minibatch_trainer(ahat, pv, case, p0, **kw):
    """A ``MiniBatchTrainer`` of an ``MB_CASES`` case from ``p0``."""
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    model, sched = MB_CASES[case]
    return MiniBatchTrainer(
        ahat, pv, pv.max() + 1, fin=FIN, widths=WIDTHS, batch_size=MB_BATCH,
        nbatches=MB_NBATCHES, seed=MB_SEED, model=model,
        activation="relu" if model == "gcn" else "none",
        comm_schedule=sched, lr=LR, params=p0[model], device="cpu", **kw)


def minibatch_run(ahat, feats, labels, pv, case, p0, **kw):
    """One epoch of stepwise batch steps, the full-graph evaluation
    before and after it, the merged comm report, and one fused epoch of a
    fresh trainer."""
    from sgcn_tpu_torch.utils.stats import CommStats

    tr = minibatch_trainer(ahat, pv, case, p0, **kw)
    batches = tr.make_batches(feats, labels)
    out = {"eval0": tr.evaluate_fullgraph(feats, labels),
           "losses": [tr.step(b) for b in batches],
           "params": [w.detach().numpy()
                      for w in tr.inner.model.parameters()],
           "eval": tr.evaluate_fullgraph(feats, labels),
           "report": CommStats.merged_report([b.stats for b in batches]),
           "real_rows": [int(b.data.train_valid.sum()) for b in batches]}
    tr = minibatch_trainer(ahat, pv, case, p0, **kw)
    out["fused"] = tr.run_epochs_fused(feats, labels, sync=False) \
        .detach().numpy()[0].tolist()
    out["fused_params"] = [w.detach().numpy()
                           for w in tr.inner.model.parameters()]
    return out


def minibatch_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_minibatch.py`` on cora
    8-hp: ``minibatch_run`` per ``MB_CASES`` case on the group from
    ``<out_dir>/init.pkl``'s weights; then the train CLI's jobs of
    ``<out_dir>/jobs.pkl`` (``cli_rank_main``)."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group(init, world, rank, device="cpu")
    try:
        ahat, feats, labels, pv, _plan = cora_plan("cora2708.8.hp")
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        res = {case: minibatch_run(ahat, feats, labels, pv, case, p0,
                                   mesh=mesh) for case in MB_CASES}
    finally:
        mesh.close()
    res["cli"] = _cli_jobs(rank, world, out_dir)
    _write(out_dir, rank, res)


# ``ServeEngine(mesh=...)``'s cases on cora 8-hp
# (``tests/test_torch_ranks_serve.py``): full mode per transport and wire,
# both models, and sub-graph mode
SERVE_CASES = {"gcn-a2a": {}, "gcn-ring": {"comm_schedule": "ragged"},
               "gcn-bf16": {"halo_dtype": "bfloat16"},
               "gat-a2a": {"model": "gat"},
               "gat-ring": {"model": "gat", "comm_schedule": "ragged"},
               "gcn-sub": {"mode": "subgraph"},
               "gat-sub": {"model": "gat", "mode": "subgraph"}}
SERVE_BATCHES = (5, 17, 32)      # query counts of the batches served
# the full-mode cases served again on the ELL aggregator
# (``SGCN_PALLAS_SPMM=0``: ROADMAP A2d)
ELL_SERVE_CASES = ("gcn-a2a", "gcn-ring", "gat-a2a")


def ell_switch():
    """A context in which ``SGCN_PALLAS_SPMM=0`` selects the ELL
    aggregator (the variable restored after it)."""
    import contextlib

    @contextlib.contextmanager
    def switch():
        before = os.environ.get("SGCN_PALLAS_SPMM")
        os.environ["SGCN_PALLAS_SPMM"] = "0"
        try:
            yield
        finally:
            if before is None:
                del os.environ["SGCN_PALLAS_SPMM"]
            else:
                os.environ["SGCN_PALLAS_SPMM"] = before
    return switch()


def serve_queries(plan, seed=21):
    """The batches of global ids every case serves (``SERVE_BATCHES``),
    drawn from a permutation; the widest holds a vertex of every part
    (the hot-swap batches: every rank's rows read)."""
    rng = np.random.default_rng(seed)
    qs = [rng.permutation(plan.n)[:m] for m in SERVE_BATCHES]
    owner = np.asarray(plan.owner)
    each = [int(np.flatnonzero(owner == c)[0]) for c in range(plan.k)]
    rest = [int(x) for x in qs[-1] if x not in each]
    qs[-1] = np.asarray(each + rest[: SERVE_BATCHES[-1] - plan.k], np.int64)
    return qs


def serve_engine(plan, feats, case, p0, mesh=None, **kw):
    """A ``SERVE_CASES`` engine from the weights ``p0`` (``{"gcn": [...],
    "gat": [...]}``; ``params=None`` in ``kw`` for a checkpoint's), one
    bucket of 32, features loaded; stacked on the CPU without ``mesh``."""
    from sgcn_tpu_torch.serve import ServeEngine

    kw = {**SERVE_CASES[case], **kw}
    model = kw.setdefault("model", "gcn")
    kw.setdefault("params", p0[model])
    eng = ServeEngine(plan, fin=FIN, widths=WIDTHS, max_batch=32,
                      buckets=(32,), mesh=mesh,
                      device=None if mesh is not None else "cpu", **kw)
    eng.set_features(feats)
    return eng


def _serve_round(eng, rank, lead):
    """Rank 0 runs ``lead(eng)`` and closes the engine (also on an
    exception); the others follow.  Returns rank 0's result or a
    follower's ``{served, rev}``; an exception is kept as ``{err}``."""
    try:
        if rank == 0:
            try:
                return lead(eng)
            finally:
                eng.close()
        return {"served": eng.follow(), "rev": eng.weights_rev}
    except ValueError as e:
        return {"err": str(e), "rev": eng.weights_rev}


def _swap_lead(eng, out_dir, q):
    """Rank 0 of the watched-directory case: a batch before any file,
    then one after each file lands in the watched directory: the step-1
    checkpoint, a corrupt step 2, a wrong-plan step 3."""
    import shutil
    import warnings

    import time

    stage, watch = (os.path.join(out_dir, d) for d in ("stage", "watch"))
    while not os.path.exists(os.path.join(stage, "ready")):
        time.sleep(0.02)              # the parent writes the files
    eng.attach_checkpoint_watch(watch)
    rows, revs, warned = [], [], []
    for name in (None, "ckpt_00000001.npz", "ckpt_00000002.npz"):
        if name is not None:
            shutil.copy(os.path.join(stage, name), watch)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rows.append(eng.query(q))
        warned.append(any("corrupt" in str(x.message) for x in w))
        revs.append(eng.weights_rev)
    shutil.copy(os.path.join(stage, "ckpt_00000003.npz"), watch)
    try:
        eng.query(q)
        err = None
    except ValueError as e:
        err = str(e)
    return {"rows": rows, "revs": revs, "warned": warned, "err": err,
            "rev": eng.weights_rev}


def _swap_call_lead(eng, out_dir, q):
    """Rank 0 of the direct swap: a batch, ``swap_weights`` (a header
    with no queries), a batch."""
    before = eng.query(q)
    eng.swap_weights(os.path.join(out_dir, "stage", "gat.npz"))
    return {"rows": [before, eng.query(q)], "rev": eng.weights_rev}


def serve_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_serve.py`` on cora
    8-hp: every ``SERVE_CASES`` engine serving ``serve_queries`` from
    ``<out_dir>/init.pkl``'s weights (rank 0 queries and reads the
    gauges, the others follow), each ``ELL_SERVE_CASES`` engine again on
    the ELL aggregator, a hot swap through a watched directory
    (GCN a2a; the files of ``<out_dir>/stage``) and one by
    ``swap_weights`` (GAT sub-graph mode); then the serve CLI's jobs of
    ``<out_dir>/jobs.pkl`` (``cli_rank_main``)."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.parallel import init_rank_group
    from sgcn_tpu_torch.serve.__main__ import main as serve_main

    mesh = init_rank_group(init, world, rank, device="cpu")
    res = {}
    try:
        _ahat, feats, _labels, _pv, plan = cora_plan("cora2708.8.hp")
        with open(os.path.join(out_dir, "init.pkl"), "rb") as fh:
            p0 = pickle.load(fh)
        qs = serve_queries(plan)
        for case in SERVE_CASES:
            eng = serve_engine(plan, feats, case, p0, mesh)
            res[case] = _serve_round(eng, rank, lambda e: {
                "rows": [e.query(q) for q in qs], "gauges": e.gauges()})
        for case in ELL_SERVE_CASES:
            with ell_switch():
                eng = serve_engine(plan, feats, case, p0, mesh)
            res["ell-" + case] = _serve_round(eng, rank, lambda e: {
                "rows": [e.query(q) for q in qs],
                "aggregator": e.setup.aggregator})
        eng = serve_engine(plan, feats, "gcn-a2a", p0, mesh)
        res["watch"] = _serve_round(
            eng, rank, lambda e: _swap_lead(e, out_dir, qs[-1]))
        eng = serve_engine(plan, feats, "gat-sub", p0, mesh)
        res["swap"] = _serve_round(
            eng, rank, lambda e: _swap_call_lead(e, out_dir, qs[-1]))
    finally:
        mesh.close()
    res["cli"] = _cli_jobs(rank, world, out_dir, serve_main)
    _write(out_dir, rank, res)


# ---------------------------------------------- the ELL aggregators on ranks
# the cases of tests/test_torch_ranks_ell.py: name -> (graph, model,
# trainer kwargs); "sym" is cora 8-hp, "dir" the directed cora; GAT at
# widths [16, 7] ships the fused form, under compute_dtype the packed one
# (fout 16) and the fused bf16 one (fout 7), and "gat-split" runs fin 24
# and widths [128, 7] (fout 128: the split form)
ELL_CASES = {
    "gcn-a2a": ("sym", "gcn", {}),
    "gcn-ring": ("sym", "gcn", {"comm_schedule": "ragged"}),
    "gcn-wire": ("sym", "gcn", {"halo_dtype": "bfloat16"}),
    "gcn-bf16": ("sym", "gcn", {"compute_dtype": "bfloat16"}),
    "gcn-remat": ("sym", "gcn", {"remat": True}),
    "gcn-directed": ("dir", "gcn", {}),
    "gat-a2a": ("sym", "gat", {}),
    "gat-ring": ("sym", "gat", {"comm_schedule": "ragged"}),
    "gat-bf16": ("sym", "gat", {"compute_dtype": "bfloat16"}),
    "gat-split": ("sym", "gat", {}),
    "gat-directed": ("dir", "gat", {}),
}
ELL_STEPS = 2
SPLIT_FIN, SPLIT_WIDTHS = 24, [128, 7]


def ell_dims(case):
    """``(fin, widths)`` of an ``ELL_CASES`` case."""
    return (SPLIT_FIN, SPLIT_WIDTHS) if case == "gat-split" \
        else (FIN, WIDTHS)


def ell_params(case, seed=23):
    """A case's initial weights as numpy from ``default_rng(seed)``, the
    same in every process: GCN a Glorot-uniform ``(fin, fout)`` per
    layer, GAT ``{w, a1, a2}`` (``w`` normal with variance
    ``2/(fin + fout)``, ``a1``/``a2`` normal over ``√fout``)."""
    fin, widths = ell_dims(case)
    rng = np.random.default_rng(seed)
    out = []
    for fi, fo in zip([fin] + widths[:-1], widths):
        if ELL_CASES[case][1] == "gcn":
            lim = np.sqrt(6.0 / (fi + fo))
            out.append(rng.uniform(-lim, lim, (fi, fo)).astype(np.float32))
            continue
        out.append({"w": (rng.standard_normal((fi, fo))
                          * np.sqrt(2.0 / (fi + fo))).astype(np.float32),
                    "a1": (rng.standard_normal(fo)
                           / np.sqrt(fo)).astype(np.float32),
                    "a2": (rng.standard_normal(fo)
                           / np.sqrt(fo)).astype(np.float32)})
    return out


def ell_graphs():
    """``{"sym": (plan, feats, labels), "dir": ...}``: cora 8-hp and the
    directed cora."""
    _ahat, feats, labels, _pv, plan = cora_plan("cora2708.8.hp")
    _ad, _ahat_d, _f, _l, _pv_d, plan_d = cora_directed_plan()
    return {"sym": (plan, feats, labels), "dir": (plan_d, feats, labels)}


def ell_trainer(plan, case, mesh=None):
    """An ``ELL_CASES`` case's ``FullBatchTrainer`` on ``plan``
    (``SGCN_PALLAS_SPMM=0`` set by the caller): stacked on the CPU, or on
    the rank group ``mesh``."""
    from sgcn_tpu_torch.train import FullBatchTrainer

    _graph, model, kw = ELL_CASES[case]
    fin, widths = ell_dims(case)
    return FullBatchTrainer(plan, fin=fin, widths=widths, lr=LR, model=model,
                            activation="none" if model == "gat" else "relu",
                            params=ell_params(case), mesh=mesh,
                            device="cpu" if mesh is None else None, **kw)


def ell_data(graphs, case, mesh=None):
    """A case's ``TrainData``: every part stacked, or rank ``mesh.rank``'s
    part (the features cut to the case's ``fin``)."""
    from sgcn_tpu_torch.train import (make_train_data,
                                      make_train_data_multihost)

    plan, feats, labels = graphs[ELL_CASES[case][0]]
    feats = np.ascontiguousarray(feats[:, :ell_dims(case)[0]])
    return (make_train_data(plan, feats, labels) if mesh is None
            else make_train_data_multihost(plan, mesh, feats, labels))


def ell_cotangent(plan, case, seed=29):
    """The stacked ``(k, B, nout)`` cotangent of a case's model VJP."""
    nout = ell_dims(case)[1][-1]
    return np.random.default_rng(seed).standard_normal(
        (plan.k, plan.b, nout)).astype(np.float32)


def ell_vjp(tr, data, g):
    """The model's forward rows and the digests of its VJP in the input
    features, one per part: ``(rows (k, B, nout) float32, [sha256 hex of
    part p's (B, fin) gradient rows, ...])``."""
    import hashlib

    import torch

    x = data.h0.clone().requires_grad_(True)
    out = tr.model(x, tr.pa).float()
    out.backward(torch.as_tensor(g))
    dh = x.grad.float().numpy()
    tr.opt.zero_grad(set_to_none=True)
    return out.detach().numpy(), [hashlib.sha256(np.ascontiguousarray(
        dh[p]).tobytes()).hexdigest() for p in range(dh.shape[0])]


def ell_ranks_main(rank, world, init, out_dir):
    """The rank checks of ``tests/test_torch_ranks_ell.py`` under
    ``SGCN_PALLAS_SPMM=0``: per ``ELL_CASES`` case the trainer's setup on
    the rank, its model's forward rows and VJP in the features (the
    rank's part of ``ell_cotangent``), then ``ELL_STEPS`` steps; then the
    train CLI's jobs of ``<out_dir>/jobs.pkl`` (``cli_rank_main``)."""
    import torch

    torch.set_num_threads(1)
    os.environ["SGCN_PALLAS_SPMM"] = "0"
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group(init, world, rank, device="cpu")
    res = {"setup": {}, "rows": {}, "dh": {}, "losses": {}, "params": {}}
    try:
        graphs = ell_graphs()
        for case in ELL_CASES:
            plan = graphs[ELL_CASES[case][0]][0]
            tr = ell_trainer(plan, case, mesh)
            data = ell_data(graphs, case, mesh)
            st = tr.setup.fwd_static
            res["setup"][case] = (tr.setup.aggregator, st["ell_layout"],
                                  st["ell_levels"])
            res["rows"][case], res["dh"][case] = ell_vjp(
                tr, data, ell_cotangent(plan, case)[rank: rank + 1])
            res["losses"][case] = [tr.step(data) for _ in range(ELL_STEPS)]
            res["params"][case] = [w.detach().numpy()
                                   for w in tr.model.parameters()]
    finally:
        mesh.close()
    res["cli"] = _cli_jobs(rank, world, out_dir)
    _write(out_dir, rank, res)


# the census cases of a k-rank group (tests/test_torch_ranks_analysis.py):
# (workload, model, schedule[, gat_form])
ANALYSIS_K = 4
ANALYSIS_CASES = (("train", "gcn", "a2a", None), ("train", "gcn", "ragged",
                                                  None),
                  ("train", "gat", "a2a", "fused"),
                  ("serve", "gcn", "ragged", None))


def analysis_ranks_main(rank, world, init, out_dir):
    """One rank of a ``world``-rank gloo group on the census fixture's
    ``world``-part plan: per ``ANALYSIS_CASES`` case one warm step, then
    one censused step (rank 0 serves the batch, the others follow its
    round), held to the plan's expectation.  Writes ``{case: {violations,
    records, overlapped, expected}}``."""
    import torch

    torch.set_num_threads(1)
    from sgcn_tpu_torch.analysis import census, expect
    from sgcn_tpu_torch.analysis.modes import Mode
    from sgcn_tpu_torch.parallel import init_rank_group

    mesh = init_rank_group(init, world, rank, device="cpu")

    class Group:
        def get(self):
            return mesh

    res = {}
    try:
        for wl, model, sched, form in ANALYSIS_CASES:
            mode = Mode(wl, model, sched, gat_form=form, ranks=True)
            owner, ctx = census.build_owner(mode, "cpu", Group(), k=world)
            expect.check_selection(owner, mode)
            if wl == "serve" and rank != 0:
                def step():
                    owner._rank_round(owner._header()).result()
            else:
                step = ctx["step"]
            step()                                   # warm
            rec = census.record_step(step, "cpu")
            label = census.program_labels(mode)[0]
            exp = expect.expectation(owner, ctx, mode, label)
            res[mode.mode_id] = {
                "violations": expect.check(rec, None, exp, mode, "cpu"),
                "records": [tuple(r) for r in rec["records"]],
                "overlapped": expect._overlapped(rec["records"]),
                "expected": {"overlapped": exp.overlapped,
                             "collectives": exp.collectives,
                             "launches": dict(exp.launches)},
                "host_reads": rec["host"]["host_reads"]}
            if wl == "serve":
                if rank == 0:
                    owner.close()
                else:
                    owner.follow()
    finally:
        mesh.close()
    _write(out_dir, rank, res)
