#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for ``sm_90a``), the
CUDA toolkit (``nvcc``) and the repository checkout around this file.  It
imports nothing of JAX or of the JAX package.  Phases, in order; any
failure raises and the script exits non-zero:

  0. print the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, and build every kernel from ``sgcn_tpu_torch/csrc``
     (one ``nvcc`` per source, started together), with its build time and
     the tile kernel's ``-Xptxas -v`` report (registers, shared memory,
     spills per instantiation); then make phase 24's DCSBM flagship graph
     and start its hp and gp partitions on two host threads, which run
     beside phases 1–23;
  1. the tile SpMM kernel (K1) against its plain PyTorch version on the
     card, on random tiles from a numpy seed — one launch over a family
     of 4 classes with a hub row of 1100 slots, an all-pad tile, a
     pad-heavy class, pads and empty rows — at f ∈ {1, 7, 8, 16, 17, 40,
     41, 128, 129}, on a 16-byte aligned table and on a view whose base
     is 4-byte but not 16-byte aligned: bit-identical to the plain version
     and between two launches.  Times the kernel, the plain version and
     the ``torch.sparse.mm`` yardstick with CUDA events at f ∈ {16, 40,
     128}, and prints the kernel's bound for the same work; then (1b) the
     stacked row pack against its plain version at 1, 2, 7, 41, 65 and
     128 words a row, float32 → float32, float32 → bf16 (±inf, NaN and
     rounding ties, NaN bits included) and bf16 → bf16, on aligned and
     4-byte-only aligned bases, and the fused local + remote entry
     against its plain version on phase 1's tiles and a second random
     family, h and the remote table float32/float32, float32/bf16 and
     bf16/bf16, on unaligned tables and with inf/NaN in the pads' row;
  2. the serving main path on real data: cora2708 (k = 8 hp parts), GCN
     1433 → 16 → 7 with ReLU, Glorot weights from a numpy seed carried by
     ``params_from_jax``, 128 synthetic queries through ``ServeEngine`` and
     ``run_loadgen`` on the card.  Every served row is checked against a
     float64 scipy forward ``act(Â·X·W…)`` (rtol 1e-4, atol 1e-5), and the
     launch counts must be exactly forwards × layers: one row pack (the
     exchange) and one fused tile launch (local pass, halo pass and their
     sum) per aggregation; then device time vs wall over 5 batches under
     ``torch.profiler`` (the device's idle share);
  3. the same at the flagship width: Erdős–Rényi n = 169343, average
     degree 14, features N(0, 1), k = 8 balanced random parts, GCN 128 →
     128 → 128 → 40; 512 closed-loop queries, 256 served rows checked
     against the float64 forward; p50/p99 latency, QPS, the per-layer
     kernel time, a per-stage breakdown of one forward, the idle share,
     K1 held against its plain version on this layer's real tiles, the
     pack and the fused entry on this layer's real exchange, and the
     whole K3 op (pack + fused launch) timed against its bound, its plain
     version and ``torch.index_select`` + ``torch.sparse.mm``;
  4. training on real data: ``python -m sgcn_tpu_torch.train``'s ``main``
     in-process on the card, cora2708 (k = 8 hp), GCN 1433 → 16 → 7,
     ``--experiment accuracy --epochs 60``: the dense oracle above 0.75
     test accuracy and the partitioned trainer within 0.03 of it (the JAX
     package's own bands), and the kernel's launch count exact;
  5. training at the flagship width: phase 3's graph, features and plan,
     labels uniform in [0, 40), every row in the train mask; 1 warm-up
     and 5 timed steps of ``FullBatchTrainer.fit``.  The step-1 weight
     gradients are held against a float64 scipy backprop of the same
     loss with the run's ReLU masks (relative Frobenius error ≤ 1e-5 per
     layer; see ``GRAD_RTOL``), the initial loss against its float64
     value (rtol 1e-5), and the largest halo class alone is timed (the
     unit the per-class dispatch launched) beside the halo family's one
     launch; every loss must be finite, the kernel's launches must equal
     steps × (forward passes + the backward passes autograd really runs)
     (one pack and one fused launch each), and the kernels on this run's
     real gradient tables must equal their plain versions bit for bit.
     Prints ``epoch_s``, a per-step breakdown (forward, backward,
     optimizer) from CUDA events, the idle share over 3 steps under
     ``torch.profiler``, and the backward layer's whole-op time, bound
     and library time on the same gradient;
  6. K5, the kernel's int8-mask entry point (the GAT attention pass), on
     phase 1's tiles as 0/1 masks at phase 1's widths and tables:
     bit-identical to its plain version, to K1 on the upcast mask and
     between two launches; timed as phase 1 at f ∈ {1, 41, 128};
  7. serving GAT (no activation between layers): cora2708 8-hp 1433 → 16
     → 7 and phase 3's graph, features and plan at 128 → 128 → 128 → 40
     (split, split, fused table forms).  Served rows against a float64
     host GAT (``gat64``: ``torch.sparse.softmax`` of z1_i + z2_j over
     Â's pattern) within rtol 1e-4 / atol 1e-5, exact mask-kernel
     launches, p50/p99, QPS, a per-stage breakdown of one flagship forward
     and the idle share;
  8. training GAT at the flagship width, 1 warm-up + 5 timed steps: step-1
     gradients of ``w`` and ``a2`` within 1e-5 (relative Frobenius, per
     layer) of ``gat64``'s float64 autograd, ``a1``'s exactly 0, finite
     losses, exact launches (every layer runs its backward passes), the
     kernel on this run's real forward and backward tables == plain, and
     its times at the flagship layer; ``epoch_s``, the step breakdown and
     the idle share;
  9. training cora2708 GAT through the CLI's ``main`` in-process
     (``--model gat``, 5 steps): the losses track the dense GAT oracle
     from the same seed on the card within 1e-4 relative, exact launches;
  10. K4 serving: ragged ``ServeEngine``s (``comm_schedule='ragged'``)
     for GCN and GAT on phase 3's plan, features and weights — every
     served row and the whole forward ``torch.equal`` to the a2a engines'
     of phases 3 and 7, exact launches, p50/p99, QPS, the per-stage
     breakdown with the ring's exchange beside the a2a's, the idle share;
     K1 on the real ring table and K5 on every real ring table of a
     served GAT forward == plain, and the whole K4 op (ring pack + fused
     launch) timed as phase 3 times K3;
  11. K4 training: GCN and GAT on the ring from phases 5 and 8's initial
     weights, 1 warm-up + 5 timed steps: losses and weights after ``fit``
     ``torch.equal`` to the a2a runs', exact launches (forward and
     backward through ``PspmmTilesRagged``), ``epoch_s``, the step
     breakdown, the idle share, K1 on the real ring gradient table and K5
     on every ring table of a training step == plain;
  12. cora2708 8-hp through the train CLI with ``--comm-schedule auto``:
     it resolves to the ring (padding efficiency 0.311 < 0.5) and its
     losses equal the ``--comm-schedule a2a`` run's, GCN and GAT, exact
     launches; then each transport's ``epoch_s`` over 3 CLI runs of 3
     warm-up + 20 timed steps, interleaved;
  13. K6, the row-shuffle kernel, vs its plain version at S = 2048 and
     f ∈ {1, 41, 128} (bit-identical, two launches equal), then
     ``python -m sgcn_tpu_torch.tools.spmm_micro``'s ``main`` at its
     defaults (this card's stream, gather and matmul ceilings), and K6's
     device time per call against its bound and
     ``torch.take_along_dim``;
  14. K1 and K5 on bf16 tables (the kernel's bf16 entry points) vs their
     plain version on phase 1's tiles at f ∈ {1, 7, 8, 16, 17, 40, 41,
     128, 129}: on an 8-byte aligned table, on a view whose base is
     2-byte but not 8-byte aligned, and with inf and NaN in the row the
     pads read — bit-identical (NaN where the plain version has NaN) and
     between two launches; K1-bf16 timed at f ∈ {16, 128} against its
     bound (2 bytes a table value) and ``torch.sparse.mm`` on a bf16 CSR
     where this torch has one;
  15. the flagship GCN of phase 5 under ``halo_dtype='bfloat16'`` and
     ``compute_dtype='bfloat16'``, each on both transports from phase 5's
     initial weights: ragged == a2a bit for bit (losses and weights after
     ``fit``), the 5 losses within the reference's bf16 band (rtol 0.05 /
     atol 0.02) of phase 5's float32 losses and not equal to them, exact
     launches per entry point (the fused entry's bf16-wire flavor under
     ``halo_dtype``, its bf16 one under ``compute_dtype``); ``epoch_s``,
     the step breakdown and the profiler's split (fused, K1/K5, pack,
     gathers, copies, roll, cat, matmul, idle); K1 and the fused entry on
     the compute run's real bf16 forward and gradient tables == plain,
     their times and the whole op's at the flagship layer, and the pack
     and fused entry on the bf16 wire;
  16. flagship GCN serving with ``halo_dtype='bfloat16'`` on both
     transports: served rows within rtol 5e-3 / atol 5e-3 of the float64
     forward, ring == a2a bit for bit, exact launches, p50/p99 and QPS
     beside the float32 engines';
  17. the flagship GAT of phase 8 under ``compute_dtype='bfloat16'`` (every
     layer packed) on both transports: ragged == a2a bit for bit, losses
     within the reference's GAT bf16 band (rtol 0.05 / atol 0.03) of phase
     8's and not equal, exact launches per entry point, the step
     breakdown and split, K5 on every real table of a step == plain; then
     cora2708 GAT ``--dtype bfloat16`` through the train CLI (the odd
     width 7 takes the fused bf16 table) against phase 9's losses;
  18. the row pack and the fused entry against their plain versions on
     every exchange and aggregation one flagship training pass (forward
     and backward) makes, GCN and GAT, both transports;
  19. serving on the directed flagship graph (an asymmetric Â): 14·n
     ordered pairs from ``default_rng(0)``, self pairs dropped,
     ``normalize_adjacency``, phase 3's features and parts, GCN and GAT
     128 → 128 → 128 → 40; 512 closed-loop queries at batch 64, 256
     served rows against the float64 forward with Â (phase 3's and 7's
     gates), exact launches, p50/p99/QPS, the idle share;
  20. training there, GCN and GAT, 1 warm-up + 5 timed steps: step-1
     gradients within 1e-5 (relative Frobenius, per layer) of a float64
     backprop with Âᵀ (GCN, with the run's ReLU masks) or of float64
     autograd (GAT ``w``/``a2``; ``a1``'s exactly 0), exact launches (a
     forward aggregation: one pack, one fused launch; a backward one:
     one K1 family launch of the halo rows' transpose, one reverse pack,
     one fused launch; GAT the K5 passes of each form, then per exchanged
     table one K5 pass, one pack, one fused launch), every family launch,
     pack and fused launch of one training pass == plain bit for bit on
     its real inputs, ``epoch_s``, the step breakdown and the profiler's
     split; one backward aggregation at the layer-0 table (f = 128) timed
     whole and by step against its byte bound, its plain version and
     ``torch.sparse.mm`` + ``torch.index_select`` + ``torch.sparse.mm``;
  21. the directed GCN of phase 20 under ``halo_dtype`` and
     ``compute_dtype``: losses in the reference's bf16 band of the
     float32 run and not equal to it, exact launches per entry, every
     launch of one pass == plain;
  22. the same training repeated in one process
     (``tools/repeat_run.py::repeat_training``, fresh trainers from one
     start): cora2708 GAT a2a (phase 9's run) 20 times, the directed
     flagship GCN and GAT 3 times each — exactly one loss history and one
     weight digest each;
  23. checkpoints at the flagship width (phase 3's graph, features and
     parts, phase 5's labels; GCN a2a and ring, GAT a2a, 128 → 128 → 128
     → 40, float32, 6 steps from the train CLI's seed 0): per run a child
     process (``torch.multiprocessing``, ``spawn``; four at once) runs the
     train CLI with ``--checkpoint-every 3`` under
     ``SGCN_FAULT=kill-after-save:3`` and must exit 43, and one more GCN
     a2a child runs ``--checkpoint-every 2`` under
     ``corrupt-after-save:4:bitflip``; then a new child per run resumes
     with ``--resume auto`` to 6 steps (the corrupt one must fall back to
     step 2 with a warning).  Their losses and the digest of their final
     weights and Adam state must equal the same runs trained here
     uninterrupted, bit for bit.  ``ServeEngine(checkpoint=…)`` on the
     step-6 files (GCN and GAT) serves the trainer's ``predict`` rows bit
     for bit and within rtol 1e-4 / atol 1e-5 of the float64 forward; a
     file under another part vector or other widths is refused with the
     reference's message; one ``poll`` of a watched directory hot-swaps
     the newest file into a random-weight engine (rows move to the
     trainer's, ``weights_rev`` + 1, every parameter keeps its storage)
     and skips a corrupt newest file.  Prints the checkpoint's bytes and
     its save and load ms, each child's start-up against its training
     seconds, and the poll + swap ms, beside the card's name and power
     limit.  The children's inputs come from an ``.npz`` written under
     ``build/chip_smoke_ckpt/``, and every child is stopped when the
     phase ends;
  24. the offline pipeline.  (a) cora2708 through the CLIs: its
     adjacency written with the port's ``write_mtx``, ``python -m
     sgcn_tpu_torch.prep`` on it (the printed line checked) and ``python
     -m sgcn_tpu_torch.partition -k 8 -m hp,gp,rp`` (every part vector
     complete, its printed km1 / edge cut equal to a numpy recount, hp
     and gp sending fewer rows than rp), then the train CLI on
     ``cora.A.mtx`` and
     ``….8.hp`` for 1 + 5 steps on each transport (exact launches; the
     ring's losses and its saved weights and Adam state == a2a's bit for
     bit) and the serve CLI with ``--random-init`` (exact launches),
     every CLI's ``main`` in this process (``cli_child``), one after
     another; files under ``build/chip_smoke_pipeline/``.  (b) the DCSBM flagship
     (``dcsbm_graph(169343)``: 64 communities, degree 14, seed 0; Â
     normalized) on its hp and gp parts from the port's native binding
     (k = 8, seed 1; each partitioned twice, the vectors equal, the
     metrics equal to a numpy recount) and balanced random parts (seed
     1): each plan's B, S, R, true and wire rows and ``auto``'s pick,
     printed; hp and gp must send fewer rows than rp; at 128 → 128 → 128
     → 40 with phase 3's features and phase 5's labels, GCN 1 warm-up + 5
     timed steps on a2a and on the ring on the hp and the rp parts (exact
     launches, ragged == a2a bit for bit), GAT a2a the same on both,
     their ``device_split`` and epoch_s hp against rp; GCN serving on both
     (512 closed-loop queries at batch 64, rows vs the float64 forward,
     exact launches); the row pack and the fused entry == plain on the hp
     plan's layer 0, whose tiles hold the longest row (checked); K3's
     whole op timed on both plans (its plain version on the hp plan's
     alone).  Partition seconds are host seconds.
     K1's float-weight family entries must stay at 0 launches;
  25. the pipelined stale-halo trainer (``halo_staleness=1``) at the
     flagship width of phases 5 and 11 (same plan, data and initial
     weights): ``sync_every=1`` on both transports, delta off and on,
     equals phase 5's losses and weights after ``fit`` bit for bit (and
     under ``halo_dtype`` without delta phase 15's runs); stale ragged ==
     stale a2a bit for bit for ``sync_every`` 0 and 4, delta off and on,
     over 1 + 8 steps; exact launch counts per stale and per sync step
     (packs, fused launches, backward fused launches; K1's family
     entries 0), and the pack and the fused entry == plain on every
     exchange and aggregation of one stale and one sync step of the a2a
     delta run, on their real carry tables; the stale + delta losses
     within the reference's
     band (rtol/atol 1e-2, ``tests/test_stale_halo.py:192-200``) of phase
     5's, the gap printed; epoch_s (host clock and CUDA events) of exact,
     stale and stale + delta on both transports in two interleaved rounds,
     the device split (pack, fused, elementwise, matmul) and idle share,
     the delta arithmetic timed alone, the carries' bytes; a flagship
     child (``cli_child``, GCN a2a, stale + delta, ``--sync-every 3``)
     killed after its step-4 save (started once phase 23 has written its
     inputs, beside phase 24) and resumed in a new one: losses and
     the weights + Adam and carry digests == the uninterrupted run in
     this process; the cora CLI with ``--comm-schedule auto
     --halo-staleness 1 --sync-every 2`` resolves to the ring by the
     hidden-exchange rule and prints the controller's log;
  26. hot-halo replicas (``replica_budget``) at the flagship width: the
     ER plan of phases 5 and 25 on both transports and the DCSBM flagship
     on phase 24's hp parts (not partitioned again), B from ``auto`` (the
     knee and ``score_covered`` printed) and the clamp (B ≥ the boundary
     rows).  ``sync_every=1`` == phase 5's losses and weights bit for bit
     for pure and composed (``halo_staleness=1``) replicas on both
     transports, and under ``halo_dtype`` == phase 15's; replica ring ==
     replica a2a bit for bit at ``sync_every`` 0, 2 and 3; the
     destination-indexed pack (``row_pack_into``) == its plain version
     bit for bit on both flagships' kept lists, f32 and bf16 outputs;
     exact launches per replica step (one kept pack and one fused launch
     per aggregation and direction) and per refresh step (the exact
     exchange's pack), and a replica step at the clamp packs nothing; the
     replica and composed losses within the reference's stale band
     (rtol/atol 1e-2) of phase 5's; ``refresh_band`` 0 ships every
     drifted replica copy and 1e12 none; epoch_s (host clock and CUDA
     events) of exact, replica and composed on both transports (ER) and
     on the a2a (DCSBM hp) in two interleaved rounds, pack rows and ms of
     a replica step's layer against an exact step's, the kept pack
     against its bound and ``index_copy_``, carry bytes, the device
     split; a flagship child (``--replica-budget auto --sync-every 3``)
     killed after its step-4 save (started with phase 25's) and resumed
     == the uninterrupted run;
     the cora CLI with ``--replica-budget auto --sync-every 3``
     (``build/chip_smoke_replica/``);
  27. the mini-batch trainer (``train/minibatch.py``) and the stochastic
     hypergraph partitioner (``shp/``).  The DCSBM flagship of phase 24 at
     batch 4096 (126 batches, each its own plan, padded to the shared
     envelope), 128 → 128 → 128 → 40, on phase 24's hp parts and on the
     stchp parts of ``shp.run_shp`` (100 sampled batches of 4096, 20
     simulated, seed 1; run on the partition threads beside phases 1–23,
     its hp vector asserted == phase 24's): per part vector the envelope,
     the plans' and layouts' host seconds, the pad share of the tiled
     slots and the longest pad chain, GCN 3 epochs on a2a and on the ring
     (ring == a2a bit for bit, exact launches: 5 packs + 5 fused launches
     a step, no K1 family launch, losses finite and falling), the plans'
     send rows per layer pass and their stchp / hp ratio, SHP's km1 and
     simulated volumes; on hp every pack and fused launch of one step on
     the batch plan with the longest pad chain == plain (both transports),
     ``run_epochs_fused`` == the stepwise run bit for bit, the step ms
     (CUDA events) and the device split, GAT 3 epochs (K5 and pack counts
     exact, every K5 pass of one step == plain), GCN under
     ``compute_dtype`` (the reference's bf16 band), ``evaluate_fullgraph``
     on the card; meanwhile, on cora2708, children (one wave after
     another, on a host thread) run ``python -m sgcn_tpu_torch.shp`` and
     the train CLI's ``-n 512`` on its stchp parts, both transports, 2
     epochs with ``--checkpoint-every 1``, then a resume to 3 epochs in
     new ones: == the uninterrupted run in this process, exact launches
     (``build/chip_smoke_minibatch/``);
  28. sub-graph serving (``serve/subgraph.py``, ``ServeEngine(mode=
     'subgraph')``): (a) cora2708 8-hp, GCN 1433 → 16 → 7 on both
     transports and on the bf16 wire and GAT on both transports, batches of
     1, 8 and 32 queries: every routed row within rtol 1e-4 / atol 1e-5 of
     the float64 forward (5e-3 on the bf16 wire) and within ``SUB_TOL``
     of the full engine's (the gaps and whether they are 0 printed), exact launches a batch (GCN one fused launch a layer, no
     pack; GAT K5's passes); (b) the DCSBM flagship on phase 24's hp parts
     (not partitioned again), GCN and GAT 128 → 128 → 128 → 40, batches of
     1, 8 and 32: the largest batch's compact fused and K5 launches ==
     plain bit for bit, exact launches a batch, rows against the full
     engine's; touched rows and recipe edges a query, FLOPs a query
     against a full forward's, the host ms to build a batch against its
     device ms (CUDA events), p50/p99 of sub-graph against full mode on the
     same 128 queries (runs full, sub-graph, sub-graph, full), the idle
     share; (c) meanwhile, on a host thread, serve CLI children: cora from
     phase 24's GCN checkpoint with ``--serve-mode subgraph``, with
     ``--concurrent``, with ``--shed-factor 2``, and in full mode with
     both flags, and the ER flagship from phase 23's GAT checkpoint with
     all three (launches exact; ``build/chip_smoke_subgraph/``);
  29. run telemetry, the memory model and remat (``obs/``): GCN and GAT
     on phase 3's ER plan, a2a and ring, 128 → 128 → 128 → 40 from one
     initial weight set, 1 warm-up + 3 steps plain and with ``remat=True``,
     each under a ``RunRecorder`` (``build/chip_smoke_telemetry/``):
     losses and weights remat == plain bit for bit, exact launches (remat
     adds one forward's packs and fused / K5 launches a step), every event
     and manifest re-validated (``load_run``), the memory block per family
     (model against the live tensors) and the measured step (peak ≤ model
     total × ``MEM_MODEL_TOL`` and × ``MEM_CARD_TOL``, arguments ≤ modeled
     + 256 B, alias ≥ params + Adam), each step's peak and ``epoch_s``
     plain against remat; the budget gate (total − 1 raises
     ``MemoryBudgetError``, ``memory_allocated`` unchanged); the cora
     mini-batch trainer (batch 1024, every batch plan and batch on the
     card) under a recorder, its measured step joined against the model
     of the whole batch set; the cora train CLI with
     ``--metrics-out --profile`` in a child (the port's
     ``summarize_trace``: ``spmm`` and ``exchange`` non-zero, every
     ``tile_spmm*`` kernel under ``spmm`` and every ``row_pack*`` under
     ``exchange``, per-class device seconds beside the CUDA-event step)
     and the serve CLI with ``--metrics-out --memory-budget 8G`` (the
     report's memory block, its peak ≤ the model × ``MEM_CARD_TOL``, the
     serve event);
  30. the paper's comparison and the rank runtime
     (``build/chip_smoke_ranks/``).  (a) The CAGNET broadcast baseline
     (``baselines/cagnet1d.py``): cora2708 8-hp, 1433 → 16 → 7 with
     sigmoid, rows within rtol 1e-4 / atol 1e-5 of the float64
     ``sigmoid((Â·H)·W)`` forward and of the partitioned forward on the
     same weights; on phase 3's ER plan and phase 24's DCSBM hp parts (not
     partitioned again) at 128 → 128 → 128 → 40: layer 0's K1 family
     launch over the gathered ``(k, k·B, f)`` table == plain bit for bit,
     ``fused=True`` == the phase split, exact launches (one pack and one
     K1 launch a layer), per-layer ``data_comm`` and ``local_spmm`` times
     (CUDA events, bound, plain, library) beside the partitioned
     forward's pack and fused launch, the wire rows ``(k−1)·n`` beside
     the a2a's and the ring's.  (b) The shard proxy
     (``parallel/proxy.py``): on every chip of both flagship plans, GCN 1
     + 3 steps of the part's slice (its loopback pack of ``k·S`` rows,
     one per exchange, exact launches), CUDA-event ms a step, the max
     over chips, the stacked 8-part step beside it; chip 0 again (== the
     first run bit for bit) and its GAT.  (c) One NCCL rank (world size
     1, a ``file://`` rendezvous) trains chip 0's ER slice through the
     rank path (the send pack, the collective, the local and halo K1
     family launches) on both transports: losses and weights == the
     stacked proxy's bit for bit; NCCL's kernels on a ``torch.profiler``
     trace, labeled by ``KERNEL_TABLE``; the group destroyed.  Meanwhile
     ``python -m sgcn_tpu_torch.baselines cagnet`` and ``oracle`` run on
     cora in children; then ``python -m sgcn_tpu_torch``'s map;
  31. GAT, bf16 and remat on the rank path and the launch layer
     (``build/chip_smoke_rank_levers/``).  (a) One NCCL rank (world size
     1) on chip 0's slice of phase 3's ER plan, 128 → 128 → 128 → 40 at
     full width: GAT a2a and ring, GAT under ``compute_dtype`` (packed
     layers) a2a, GAT under ``remat`` a2a, and GCN under ``compute_dtype``
     a2a, 1 + 3 steps each: losses and weights == the stacked proxy's bit
     for bit, exact launches per entry (K5 float32 and bf16 tables, the
     GAT backward's, packs, K1's bf16 family entry two a GCN aggregation,
     no fused launch), the K5 launches (float32 and bf16 tables) of one
     GAT step's forward first layer on both transports and its last
     layer on the a2a (float32: the split pair, the fused table; under
     ``compute_dtype`` the packed pairs, and the backward's first layer)
     and of one GCN ``compute_dtype`` step the first aggregation's two
     bf16 family launches forward and backward == plain on their real
     inputs: each table form once; each case's CUDA-event ms of steps 2–4
     beside the stacked proxy's and its host seconds; (b)
     meanwhile the cora train CLI, GCN and GAT, in children under
     ``python -m torch.distributed.run --standalone --nproc_per_node 1``
     with ``--metrics-out``: the launched report == the unlaunched CLI's
     (in this process) bit for bit, timings aside, and the run
     directory's ``heartbeat.jsonl`` valid under the port's schema;
  32. the carried modes on the rank path (``build/chip_smoke_rank_carried
     /``): one NCCL rank (world size 1) on chip 0's slice of phase 3's ER
     plan, 128 → 128 → 128 → 40 at full width, ``sync_every=2``: the
     stale halo (its exchange in flight until the next read) on the a2a
     and the ring, stale + the halo-delta cache, the stale halo on a bf16
     ``halo_dtype`` wire, replicas at the λ·degree knee (``auto``,
     resolved on the full plan) on both transports and on the bf16 wire,
     replica × stale and the partial refresh (``refresh_band=0.05``), 4
     steps each (sync, carried, sync, carried): losses and weights == the
     stacked proxy's bit for bit, exact launches per entry
     (``rank32_launches``: packs, fused launches on a float32 and a bf16
     carry and their backward counts, K1 and K1-bf16 family launches,
     pack-intos), the first fused launch of a stale step on the rank's
     carry and the first pack-into of a replica step from the shrunken
     receive == plain, on both wires, each step's CUDA-event ms
     beside the proxy's; the replica case's sixth step measured against
     the rank's memory model (``MEM_CARD_TOL``);
  33. directed plans and the mini-batch trainer on the rank path
     (``build/chip_smoke_rank_minibatch/``): (a) one NCCL rank on chip 0's
     slice of phase 19's directed flagship plan, 128 → 128 → 128 → 40:
     GCN a2a in float32, on a bf16 ``halo_dtype`` wire and under
     ``compute_dtype``, GAT a2a in float32, 3 steps each — the backward's
     halo rows' partials go back through the reverse
     ``all_to_all_single`` (a loopback on one rank) while the local-ᵀ
     family runs; losses and weights == the stacked proxy's bit for bit,
     exact launches per entry (``rank33_directed_launches``: the halo-ᵀ,
     local-ᵀ and weight-1 K1 launches of every backward aggregation, no
     reverse pack and no fused launch), the first halo-ᵀ launch on the
     slice's ``ptile_th*`` and the first weight-1 launch over a received
     buffer (float32, and bf16 on the bf16 wire) == plain and timed
     against their bounds, each step's CUDA-event ms beside the proxy's,
     and a fresh GCN rank trainer's
     third step against its memory model (``MEM_CARD_TOL``); (b) the
     mini-batch trainer on one NCCL rank training part 0 of phase 3's ER
     graph under its random parts, batch 4096, 6 batches, one epoch: GCN
     a2a and ring, GAT a2a, each batch's loss and the final weights ==
     the shard proxy's (the same part's batch slices trained stacked)
     bit for bit, exact launches, each batch step's ms beside the
     proxy's;
  34. the ELL aggregator under ``SGCN_PALLAS_SPMM=0``
     (``build/chip_smoke_ell/``): cora2708 8-hp GCN on the a2a and the
     ring and the directed cora, 3 steps each; the ER flagship GCN on both
     transports, 3 steps under a ``RunRecorder``; ring == a2a bit for bit,
     losses within rtol 1e-5 / atol 1e-6 of the tile path's from the
     same weights (the weights by the parity tests' rule), no K1, K5 or
     fused launch and exactly one pack an exchange; each step event
     valid under the port's schema, its roofline's wire bytes ==
     ``CommStats``' and its ``stream_ceiling_frac`` ≤ 1.05; the memory
     join within ``MEM_CARD_TOL`` and the budget gate; epoch_s ELL
     against tiles in turns, the device split of both, a profiled ELL
     step's ``exchange_join``; the full-mode server on ELL (3 batches of
     64, both transports) against phase 3's tile engine;
  35. one JSON line ``{"kernels": [...]}`` — per ported kernel (the tile
     SpMM, the GCN aggregation's backward, the GAT attention pass and its
     use in the GAT layer's backward, the ragged ring aggregation and its
     backward, the row shuffle, the tile SpMM's and the GAT pass's bf16
     flavors, the row pack, the fused local + remote entry and the
     destination-indexed pack) its
     launches on the main path (phases 2–5, 7–13, 15–17, 19–21 and
     23–34, the children's included), max
     |kernel − plain|, kernel / plain / bound / library times at the
     flagship layer.  The tile SpMM's own float-weight family entries
     (both tables) launch on the main path only in the asymmetric
     backward (phases 20–21) and in phases 30–33 (the broadcast's local
     SpMM, the rank path's two passes, a rank's directed backward): the
     symmetric phases 2–29 must
     show 0 of them — the fused entry runs their chains and counts those
     launches — and any kernel with no launch on the main path fails the
     run;
  36. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, the script
prints no result and exits with code 2 or 3.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 outside the tensor cores — the K1 bound's two rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the flagship graph's vertex count (bench.py's ER shape, ogbn-arxiv's n)
FLAGSHIP_N = 169343

RTOL, ATOL = 1e-4, 1e-5          # served logits vs the float64 forward
# step-1 weight gradients vs a float64 backprop that uses the float32
# run's ReLU masks: relative Frobenius error per layer.  Float32 rounding
# gives ~2.6e-7 here; with float64's own masks, one pre-activation within
# rounding of 0 at the flagship flips sign and moves the earlier layers'
# gradients by up to ~1e-4 relative — a different function, not an error
GRAD_RTOL = 1e-5


_T_IMPORT = time.perf_counter()


def log(*a):
    """Print a line; a phase's header line gets the seconds since the
    script started."""
    if a and isinstance(a[0], str) and a[0].startswith("phase "):
        a = (*a, f"[{time.perf_counter() - _T_IMPORT:.1f} s]")
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- K1 helpers
def random_class_tiles(rng, k, classes, tb, n):
    """Flat (k, Σ t_c·e_c) tile arrays over the given (t_c, e_c) classes:
    per tile a random count of dst-sorted real edges over the first 3/4
    of the rows (the last quarter and some whole tiles stay empty), pads
    of weight 0 at dst tb-1.  The kernel's edge cases: the first tile of
    the first class is full (the hub tile), and in part 0 1100 of its
    slots are one row's (a hub row); the first tile of the second class
    is all pads; the last class is pad-heavy (at most 8 real slots per
    tile, the rest pads on row tb-1, reading row 0 in even parts and mixed
    rows in odd parts)."""
    import numpy as np

    flats = [[], [], []]
    for ci, (t, e) in enumerate(classes):
        src = np.zeros((k, t, e), np.int32)
        ld = np.full((k, t, e), tb - 1, np.int32)
        w = np.zeros((k, t, e), np.float32)
        for p in range(k):
            for i in range(t):
                c = (0 if (ci, i) == (1, 0) else
                     int(rng.integers(0, 9)) if ci == len(classes) - 1 else
                     e if (ci, i) == (0, 0) else int(rng.integers(0, e + 1)))
                rows = rng.integers(0, 3 * tb // 4, c)
                if (ci, i, p) == (0, 0, 0):
                    rows[:1100] = 5
                src[p, i, :c] = rng.integers(0, n, c)
                ld[p, i, :c] = np.sort(rows)
                w[p, i, :c] = rng.standard_normal(c)
                if ci == len(classes) - 1 and p % 2:
                    src[p, i, c:] = rng.integers(0, n, e - c)
        for j, a in enumerate((src, ld, w)):
            flats[j].append(a.reshape(k, -1))
    return tuple(np.concatenate(f, axis=1) for f in flats)


def unaligned_copy(table):
    """The same rows in a view whose base is aligned to one value (4 bytes
    for float32, 2 for bf16) but not to a 4-value vector (16 or 8 bytes):
    the kernel's one-value-per-lane path."""
    import torch

    odd = torch.empty(table.numel() + 1, dtype=table.dtype,
                      device=table.device)[1:].view(table.shape)
    odd.copy_(table)
    if odd.data_ptr() % (4 * table.element_size()) == 0:
        raise AssertionError("the unaligned view is vector-aligned")
    return odd


def ptxas_report(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its template
    arguments where it has them, registers, shared memory and spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            # the mangled name spells each identifier as <length><name>
            for c in re.finditer(r"(\d+)([A-Za-z_])", name):
                base = name[c.start(2): c.start(2) + int(c.group(1))]
                if base.endswith("_kernel"):
                    t = re.match(r"I(f|a|13__nv_bfloat16)(f|13__nv_bfloat16"
                                 r"|S\d*_)Li(\d+)ELi(\d+)ELi(\d+)E",
                                 name[c.start(2) + len(base):])
                    kinds = {"f": "float", "a": "int8",
                             "13__nv_bfloat16": "bf16"}
                    if t:
                        a, b = kinds[t.group(1)], kinds.get(t.group(2), "")
                        name = base + (
                            f"<{a}, {b or a}, VEC={t.group(3)}, "
                            f"G={t.group(4)}, NV={t.group(5)}>")
                    else:
                        m2 = re.match(r"I(\w+?)EEv",
                                      name[c.start(2) + len(base):])
                        name = base + (f"<{m2.group(1)}>" if m2 else "")
                    break
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {m.group(2)} B "
                         f"smem, {spill}")
            name = None
    return lines


def k1_work(flat_src, flat_w, k, n, f, out_rows, itemsize=4):
    """Bytes and flops the K1 call needs on these inputs: every stored
    slot's (src, ld, w) read once — 12 bytes, 9 with int8 mask weights
    (K5) — each DISTINCT referenced table row read once (``itemsize``
    bytes a value: 4 for float32, 2 for bf16), the float32 output written
    once; 2 flops (multiply, add) per real edge and column."""
    import numpy as np

    src = np.asarray(flat_src, np.int64)
    w = np.asarray(flat_w)
    real = w != 0
    parts = np.broadcast_to(np.arange(k)[:, None], src.shape)
    rows = np.unique(parts[real] * n + src[real]).size
    nbytes = (src.size * (8 + w.itemsize) + rows * f * itemsize
              + out_rows * f * 4)
    flops = 2 * int(real.sum()) * f
    return nbytes, flops


def k1_bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_spmm(flat_src, flat_ld, flat_w, classes, k, n, tb, device,
                 dtype=None):
    """``torch.sparse.mm`` of a CSR holding the same real edges as the
    tile arrays, shaped so ``csr @ table.reshape(k*n, f)`` is the K1
    output — the library yardstick, timed here and used nowhere in the
    port.  ``dtype``: the CSR's values (the table's dtype; float32 by
    default)."""
    import numpy as np
    import torch

    rows, cols, vals = [], [], []
    off = row0 = 0
    t_all = sum(t for t, _e, *_ in classes)
    for t, e, *_ in classes:
        s = flat_src[:, off: off + t * e].reshape(k, t, e).astype(np.int64)
        d = flat_ld[:, off: off + t * e].reshape(k, t, e).astype(np.int64)
        w = flat_w[:, off: off + t * e].reshape(k, t, e)
        real = w != 0
        pk, ti, _ = np.nonzero(real)
        rows.append(pk * t_all * tb + (row0 + ti) * tb + d[real])
        cols.append(pk * n + s[real])
        vals.append(w[real].astype(np.float32))
        off += t * e
        row0 += t
    idx = torch.as_tensor(np.stack([np.concatenate(rows),
                                    np.concatenate(cols)]))
    coo = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)).to(dtype or torch.float32),
        (k * t_all * tb, k * n), device=device)
    return coo.coalesce().to_sparse_csr()


def same_bits(a, b, nan_ok=False):
    """``torch.equal``; with ``nan_ok``, NaN in the same places and equal
    bits everywhere else."""
    import torch

    if not nan_ok:
        return torch.equal(a, b)
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def check_k1(tiles, table, classes, tb, what, nan_ok=False):
    """Kernel vs plain on the card: bit identity and two-launch
    determinism (``nan_ok``: NaN where the plain version has NaN, the
    same bits elsewhere).  Returns the max |kernel − plain| over the
    entries where the plain version is finite (0.0 when identical)."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_classes_plain)

    one = spmm_tiles_classes(*tiles, table, classes, tb)
    two = spmm_tiles_classes(*tiles, table, classes, tb)
    plain = spmm_tiles_classes_plain(*tiles, table, classes, tb)
    torch.cuda.synchronize()
    fin = torch.isfinite(plain)
    diff = float((one[fin] - plain[fin]).abs().max())
    relaunch = same_bits(one, two, nan_ok)
    log(f"  {what}: max |kernel - plain| = {diff!r}  "
        f"(relaunch identical: {relaunch}"
        + (f"; NaN entries {int(torch.isnan(plain).sum())}, in the same "
           f"places: {torch.equal(torch.isnan(one), torch.isnan(plain))}"
           if nan_ok else "") + ")")
    if not relaunch:
        raise AssertionError(f"{what}: two launches differ")
    if not same_bits(one, plain, nan_ok):
        raise AssertionError(f"{what}: kernel != plain version "
                             f"(max diff {diff})")
    return diff


def time_k1(tiles_np, tiles, table, classes, tb, n, what):
    """Kernel, plain and library times (CUDA events) and the bound.  The
    plain version (a host loop over the classes, seconds at the flagship)
    is timed on one call, as the fused entry's is."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes,
                                              spmm_tiles_classes_plain)

    k, f = table.shape[0], table.shape[2]
    t_all = sum(t for t, _e, *_ in classes)
    ms = cuda_ms(lambda: spmm_tiles_classes(*tiles, table, classes, tb))
    plain_ms = cuda_ms(lambda: spmm_tiles_classes_plain(
        *tiles, table, classes, tb), reps=1, warmup=0)
    dense = table.reshape(k * n, f)
    try:
        # on a bf16 table, a bf16 CSR: where this torch has no CUDA kernel
        # for it, there is no library call to time
        csr = library_spmm(*tiles_np, classes, k, n, tb, table.device,
                           dtype=table.dtype)
        lib_out = torch.sparse.mm(csr, dense)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, dense))
    except (RuntimeError, NotImplementedError) as e:
        if table.dtype == torch.float32:
            raise
        log(f"  {what}: torch.sparse.mm on a {table.dtype} CSR is not "
            f"available here ({str(e).splitlines()[0][:120]}): no library "
            "call")
        lib_out, library_ms = None, None
    kern_out = spmm_tiles_classes(*tiles, table, classes, tb).reshape(-1, f)
    lib_diff = (float((lib_out.float() - kern_out).abs().max())
                if lib_out is not None else float("nan"))
    nbytes, flops = k1_work(tiles_np[0], tiles_np[2], k, n, f, k * t_all * tb,
                            itemsize=table.element_size())
    bound_ms, bound_by = k1_bound_ms(nbytes, flops)
    log(f"  {what}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.sparse.mm {library_ms!r} ms (|lib - kernel| {lib_diff:.3g}), "
        f"bound {bound_ms!r} ms by {bound_by} ({nbytes} B, {flops} flop), "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


# ------------------------------------------- the pack and the fused entry
def check_pack(src, flat, dtype, what):
    """The row pack vs its plain version on the card, on the same inputs:
    bit for bit (NaN where the plain version has NaN), and two launches
    the same.  Returns 0.0 (a copy or one rounding: no error to report
    when they agree)."""
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_plain

    one, two = row_pack(src, flat, dtype), row_pack(src, flat, dtype)
    plain = row_pack_plain(src, flat, dtype)
    torch.cuda.synchronize()
    ok = same_bits(one, plain, nan_ok=True) and same_bits(one, two, True)
    # NaN's own bits: the card's cast and the kernel's store agree on them
    nan = torch.isnan(plain)
    if ok and nan.any() and plain.dtype == torch.bfloat16:
        ok = torch.equal(one[nan].view(torch.int16),
                         plain[nan].view(torch.int16))
    if not ok:
        raise AssertionError(f"{what}: row pack != plain version")
    return 0.0


def check_fused(ltiles, h, htiles, remote, lcls, hcls, tb, what):
    """The fused entry vs its plain version (two plain family passes,
    slices, add, cast: torch arithmetic, no kernel) on the card: bit for
    bit (NaN in the same places,
    with the same bits), and two launches the same.  Returns the max
    |kernel − plain| over the finite entries."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_fused,
                                              spmm_tiles_fused_plain)

    one = spmm_tiles_fused(ltiles, h, htiles, remote, lcls, hcls, tb)
    two = spmm_tiles_fused(ltiles, h, htiles, remote, lcls, hcls, tb)
    plain = spmm_tiles_fused_plain(ltiles, h, htiles, remote, lcls, hcls,
                                   tb)
    torch.cuda.synchronize()
    fin = torch.isfinite(plain)
    diff = float((one[fin].float() - plain[fin].float()).abs().max()) \
        if fin.any() else 0.0
    nan = torch.isnan(plain)
    bits = torch.int16 if plain.dtype == torch.bfloat16 else torch.int32
    ok = (same_bits(one, plain, nan_ok=True) and same_bits(one, two, True)
          and torch.equal(one[nan].view(bits), plain[nan].view(bits)))
    log(f"  {what}: max |fused - plain| = {diff!r} (relaunch identical, "
        f"NaN {int(nan.sum())} with the same bits: {ok})")
    if not ok:
        raise AssertionError(f"{what}: fused entry != plain version")
    return diff


def pack_work(src, flat, dtype):
    """Bytes the pack needs on these inputs: each distinct referenced
    source row read once, the index read once, the output written once
    (it does no arithmetic)."""
    import numpy as np
    import torch

    w = src[0, 0].numel()
    rows = np.unique(flat.cpu().numpy()).size
    return (rows * w * src.element_size() + flat.numel() * 4
            + flat.numel() * w * torch.empty((), dtype=dtype).element_size())


def time_pack(src, flat, dtype, what):
    """The pack's time (CUDA events), its plain version's, the library
    yardstick's (``torch.index_select`` of the same rows: one PyTorch
    call; None when the pack also casts) and the bound."""
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_plain

    ms = cuda_ms(lambda: row_pack(src, flat, dtype))
    plain_ms = cuda_ms(lambda: row_pack_plain(src, flat, dtype), reps=5)
    library_ms = None
    if dtype == src.dtype:
        flat2d = src.reshape(src.shape[0] * src.shape[1], -1)
        idx = flat.reshape(-1).long()
        library_ms = cuda_ms(lambda: torch.index_select(flat2d, 0, idx))
    nbytes = pack_work(src, flat, dtype)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {what}: pack {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.index_select {library_ms!r} ms, bound {bound_ms!r} ms by "
        f"bytes ({nbytes} B), {100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}


def fused_work(ltiles, h, htiles, remote):
    """Bytes and flops of the fused launch on these inputs: both
    families' K1 work (``k1_work``, no float32 output) and the (k, b, f)
    output written once in h's dtype."""
    k, b, f = h.shape
    lb, lf = k1_work(ltiles[0].cpu().numpy(), ltiles[2].cpu().numpy(), k,
                     h.shape[1], f, 0, itemsize=h.element_size())
    hb, hf = k1_work(htiles[0].cpu().numpy(), htiles[2].cpu().numpy(), k,
                     remote.shape[1], f, 0, itemsize=remote.element_size())
    return lb + hb + k * b * f * h.element_size(), lf + hf + k * b * f


def library_fused(ltiles, h, htiles, remote, lcls, hcls, tb):
    """The fused launch's library yardstick: ``torch.sparse.mm`` of one
    CSR holding both families' real edges over the stacked ``[h; remote]``
    rows (the concatenation is set-up, outside the timed call), sliced
    to the owned rows by the CSR's own row count.  Returns (csr, dense)
    or None where the tables' dtypes differ."""
    import numpy as np
    import torch

    if h.dtype != remote.dtype:
        return None
    k, b, f = h.shape
    nl, nh = h.shape[1], remote.shape[1]
    rows, cols, vals = [], [], []
    for tiles, cls, base, n in ((ltiles, lcls, 0, nl),
                                (htiles, hcls, k * nl, nh)):
        src, ld, w = (t.cpu().numpy() for t in tiles)
        off = row0 = 0
        for t, e, *_ in cls:
            sl = slice(off, off + t * e)
            s_ = src[:, sl].reshape(k, t, e).astype(np.int64)
            d_ = ld[:, sl].reshape(k, t, e).astype(np.int64)
            w_ = w[:, sl].reshape(k, t, e)
            real = w_ != 0
            pk, ti, _ = np.nonzero(real)
            r = (row0 + ti) * tb + d_[real]
            keep = r < b
            rows.append((pk * b + r)[keep])
            cols.append((base + pk * n + s_[real])[keep])
            vals.append(w_[real][keep].astype(np.float32))
            off += t * e
            row0 += t
    idx = torch.as_tensor(np.stack([np.concatenate(rows),
                                    np.concatenate(cols)]))
    csr = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)).to(h.dtype),
        (k * b, k * (nl + nh)), device=h.device).coalesce().to_sparse_csr()
    dense = torch.cat([h.reshape(k * nl, f), remote.reshape(k * nh, f)])
    return csr, dense


def time_fused(ltiles, h, htiles, remote, lcls, hcls, tb, what,
               plain=True):
    """The fused launch's time, its plain version's (one call: it takes
    seconds at the flagship; ``plain=False`` skips it: ``None``), the
    library yardstick's (``library_fused``) and the bound."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_fused,
                                              spmm_tiles_fused_plain)

    args = (ltiles, h, htiles, remote, lcls, hcls, tb)
    ms = cuda_ms(lambda: spmm_tiles_fused(*args))
    plain_ms = (cuda_ms(lambda: spmm_tiles_fused_plain(*args), reps=1,
                        warmup=0) if plain else None)
    lib = library_fused(*args)
    try:
        library_ms = (cuda_ms(lambda: torch.sparse.mm(*lib))
                      if lib is not None else None)
    except (RuntimeError, NotImplementedError) as e:
        # a bf16 CSR where this torch has no kernel for it: no library call
        if h.dtype == torch.float32:
            raise
        log(f"  {what}: torch.sparse.mm on a {h.dtype} CSR is not "
            f"available here ({str(e).splitlines()[0][:120]})")
        library_ms = None
    nbytes, flops = fused_work(ltiles, h, htiles, remote)
    bound_ms, bound_by = k1_bound_ms(nbytes, flops)
    log(f"  {what}: fused {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.sparse.mm {library_ms!r} ms, bound {bound_ms!r} ms by "
        f"{bound_by} ({nbytes} B, {flops} flop), {100 * bound_ms / ms:.1f}% "
        "of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def time_whole_op(h, pa, st, tb, ragged, what, plain=True):
    """One GCN aggregation (K3, or K4 on the ring) at this table: the
    whole op (exchange pack + fused launch), each part alone, the plain
    version (torch indexing + the plain family passes, add and cast;
    ``plain=False`` skips it and the fused launch's: ``None``), the
    library yardsticks summed, and the whole op's bound (the pack's bytes
    plus the fused launch's)."""
    import torch

    from sgcn_tpu_torch.ops.pspmm import exchange_recv, ring_concat
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_plain
    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_ragged,
                                              pspmm_tiles_sym,
                                              spmm_tiles_fused_plain)

    lt = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    if ragged:
        flat = pa["ring_src"]
        remote = ring_concat(h, flat, st["rr_sizes"])
        ht = [pa["ptile_hrsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    else:
        flat = pa["recv_src"]
        remote = exchange_recv(h, flat)
        ht = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    static = (tb, st["pallas_lclasses"], st["pallas_hclasses"])
    pack = time_pack(h, flat, h.dtype, f"{what} exchange")
    fused = time_fused(lt, h, ht, remote, st["pallas_lclasses"],
                       st["pallas_hclasses"], tb, f"{what} fused launch",
                       plain=plain)
    with torch.inference_mode():
        if ragged:
            op = cuda_ms(lambda: pspmm_tiles_ragged(
                h, flat, *lt, *ht, *static, st["rr_sizes"]))
        else:
            op = cuda_ms(lambda: pspmm_tiles_sym(h, flat, *lt, *ht, *static))
    plain = (cuda_ms(lambda: spmm_tiles_fused_plain(
        lt, h, ht, row_pack_plain(h, flat), *static[1:], tb), reps=1,
        warmup=0) if plain else None)
    bound = (pack["bytes"] + fused["bytes"]) / HBM_BYTES_PER_S * 1e3
    lib = (None if pack["library_ms"] is None or fused["library_ms"] is None
           else pack["library_ms"] + fused["library_ms"])
    log(f"  {what}: whole op {op!r} ms (exchange {pack['ms']!r} + fused "
        f"{fused['ms']!r}); bound {bound!r} ms by bytes, "
        f"{100 * bound / op:.1f}% of bound; plain {plain!r} ms; library "
        f"(index_select + sparse.mm) {lib!r} ms")
    return {"ms": op, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": "bytes", "pack": pack,
            "fused": fused}


PACK_WIDTHS = (1, 2, 7, 41, 65, 128)
FUSED_DTYPES = (("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "bfloat16"))


def special_rows(x):
    """Writes ±inf, NaN and float32 values at bf16 rounding ties (1 +
    2⁻⁸ rounds down to 1, 1 + 3·2⁻⁸ up to 1 + 2⁻⁶: nearest even) into
    the first rows of ``x`` (k, rows, ...) float32."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    vals = (float("inf"), -float("inf"), float("nan"), 1.0 + 2 ** -8,
            1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8))
    for i, v in enumerate(vals):
        flat[:, i % x.shape[1], i % flat.shape[2]] = v
    return x


def phase_pack_fused_random(rng, dev, tiles, classes, tb, n):
    """Phase 1's second half: the row pack at ``PACK_WIDTHS`` words on
    float32 → float32, float32 → bf16 (±inf, NaN, rounding ties) and bf16
    → bf16, on 16-byte aligned and 4-byte-only aligned (bf16: 2-byte)
    bases; then the fused entry on phase 1's tiles as the local family and
    a second random draw (its own Emax, the same tile counts) as the halo
    family, on each of ``FUSED_DTYPES`` at ``BF16_WIDTHS``, on unaligned
    tables, and with inf/NaN in the row the pads read.  Every launch ==
    plain bit for bit.  Returns the max |fused − plain|."""
    import numpy as np
    import torch

    k = tiles[0].shape[0]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    n_pack = 0
    for w in PACK_WIDTHS:
        base = torch.as_tensor(rng.standard_normal((k, 700, w)).astype(
            np.float32)).to(dev)
        special_rows(base)
        flat = torch.as_tensor(rng.integers(0, k * 700, (k, 900)).astype(
            np.int32)).to(dev)
        for sdt, odt in (("float32", "float32"), ("float32", "bfloat16"),
                         ("bfloat16", "bfloat16")):
            src = base.to(dt[sdt])
            for t_, how in ((src, ""), (unaligned_copy(src), " unaligned")):
                t_ = t_ if w > 1 else t_[..., 0]       # a (k, rows) table
                check_pack(t_, flat, dt[odt], f"pack w={w} {sdt}->{odt}{how}")
                n_pack += 1
    log(f"  row pack: {n_pack} cases == plain bit for bit (NaN bits "
        "included), relaunch identical")
    classes2 = tuple((t, max(8, e // 2)) for t, e, *_ in classes)
    htiles_np = random_class_tiles(rng, k, classes2, tb, n)
    htiles = [torch.as_tensor(a).to(dev) for a in htiles_np]
    err = 0.0
    for f in BF16_WIDTHS:
        h32 = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        r32 = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        for hd, rd in FUSED_DTYPES:
            h, r = h32.to(dt[hd]), r32.to(dt[rd])
            cases = [(h, r, "")]
            if f in (7, 40, 129):
                cases.append((unaligned_copy(h), unaligned_copy(r),
                              " unaligned"))
            if f in (1, 40, 129):
                hb, rb = h.clone(), r.clone()
                hb[:, 0, 0], rb[:, 0, -1] = float("inf"), float("nan")
                cases.append((hb, rb, " inf/NaN in the pads' row"))
            for h_, r_, how in cases:
                err = max(err, check_fused(
                    tiles, h_, htiles, r_, classes, classes2, tb,
                    f"fused f={f} h {hd} remote {rd}{how}"))
    return err


# ----------------------------------------------------------- serving path
def glorot_numpy(seed, dims):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.uniform(-np.sqrt(6.0 / (a + b)), np.sqrt(6.0 / (a + b)),
                        (a, b)).astype(np.float32) for a, b in dims]


def oracle_forward(ahat, feats, params):
    """Global float64 forward on the host: ReLU(Â·H·W) per layer, no
    activation after the last."""
    import numpy as np

    a = ahat.astype(np.float64)
    h = np.asarray(feats, np.float64)
    for i, w in enumerate(params):
        h = a @ (h @ np.asarray(w, np.float64))
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


class RecordingEngine:
    """Hands ``run_loadgen`` the engine's batcher and query path, keeping
    every served (qids, logits) pair for the oracle check."""

    def __init__(self, engine):
        self.engine = engine
        self.batcher = engine.batcher
        self.served = []

    def query(self, qids):
        out = self.engine.query(qids)
        self.served.append((list(qids), out))
        return out


def gat_params_numpy(seed, dims):
    """GAT params from a numpy seed: per layer ``w`` N(0, 2/(fin+fout)),
    ``a1``/``a2`` N(0, 1)/√fout (the reference's scales)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)))
             .astype(np.float32),
             "a1": (rng.standard_normal(b) / np.sqrt(b)).astype(np.float32),
             "a2": (rng.standard_normal(b) / np.sqrt(b)).astype(np.float32)}
            for a, b in dims]


def gat64(ahat, feats, params, labels=None):
    """Global float64 GAT on the host, written here apart from the port's
    code: per layer ``z = h·w``, the scores ``s_ij = z1_i + z2_j`` on Â's
    nonzero pattern, ``torch.sparse.softmax`` over each row, ``h = α·z``;
    no activation (PGAT).  Returns the (n, nout) logits, or with
    ``labels`` the mean softmax cross-entropy over every row and its
    gradients by torch autograd on the CPU (per layer ``{w, a1, a2}``).
    A check only: nothing else uses it."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    a = sp.csr_matrix(ahat, dtype=np.float64)
    a.eliminate_zeros()
    a.sort_indices()
    coo = a.tocoo()
    idx = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
    n = a.shape[0]
    grad = labels is not None
    ps = [{k: torch.tensor(np.asarray(v, np.float64), requires_grad=grad)
           for k, v in p.items()} for p in params]
    h = torch.as_tensor(np.asarray(feats, np.float64))
    with torch.set_grad_enabled(grad):
        for p in ps:
            z = h @ p["w"]
            s = (z @ p["a1"])[idx[0]] + (z @ p["a2"])[idx[1]]
            scores = torch.sparse_coo_tensor(idx, s, (n, n), is_coalesced=True,
                                             check_invariants=False)
            alpha = torch.sparse.softmax(scores, dim=1).to_sparse_csr()
            h = torch.sparse.mm(alpha, z)
        if not grad:
            return h.numpy()
        loss = torch.nn.functional.cross_entropy(
            h, torch.as_tensor(np.asarray(labels, np.int64)))
        leaves = [p[k] for p in ps for k in ("w", "a1", "a2")]
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [
        {k: grads[3 * i + j].numpy() for j, k in enumerate(("w", "a1", "a2"))}
        for i in range(len(ps))]


def gat_passes(widths):
    """Kernel passes per class of one GAT forward (or backward): 1 for a
    fused layer, 2 for a split one."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    return sum(1 if gat_table_form(w) == "fused" else 2 for w in widths)


# row-pack launches counted on the main path's runs (drive_serving and the
# training phases add theirs)
MAIN_PATH_PACKS = [0]

# launches of K1's own family entries (float32 weights, on float32 and bf16
# tables) made inside the symmetric main path's runs: the fused entry runs
# K1's two family chains since the K3/K4 redesign, GAT runs the mask
# entries, so these stay 0 (asserted); only the asymmetric backward
# launches them (phases 20-21, counted there)
MAIN_PATH_K1 = {"launches": 0, "bf16_launches": 0}
_K1_AT_OPEN = {}


def k1_open():
    """Marks the start of a main-path run for ``MAIN_PATH_K1``."""
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    _K1_AT_OPEN.update({c: getattr(spmm_tiles, c) for c in MAIN_PATH_K1})


def k1_close():
    """Adds the K1 family-entry launches since ``k1_open``."""
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    for c in MAIN_PATH_K1:
        MAIN_PATH_K1[c] += getattr(spmm_tiles, c) - _K1_AT_OPEN.pop(c)


def pack_launches(model, schedule, widths, compute_dtype=None):
    """Row-pack launches of one forward (or one backward) over these
    layer widths: GCN one per aggregation; GAT per layer on the ring one
    (one ``[p ‖ u]`` concat), on the a2a exchange two per exchanged table
    (the receive layout, then the halo rows): one table for the fused and
    packed forms, two for the split form."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    if model == "gcn" or schedule == "ragged":
        return len(widths)
    return sum(4 if gat_table_form(w, compute_dtype) == "split" else 2
               for w in widths)


def drive_serving(name, eng, queries, seed):
    """Drive the serving main path through ``eng``: warm every bucket, then
    ``queries`` synthetic closed-loop queries through ``run_loadgen``.  The
    launches — GCN: the fused tile entry (one per aggregation, on the
    float32 or the bf16-wire flavor); GAT: the int8-mask entry (one per
    pass) — and the row pack's are counted from 0 and must be exactly
    forwards × passes; the pack's are added to ``MAIN_PATH_PACKS``.
    Returns (recording engine, loadgen result, tile launches)."""
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles, spmm_tiles_fused
    from sgcn_tpu_torch.serve import run_loadgen, synthetic_query_ids

    st, widths = eng.setup.fwd_static, eng.widths
    if eng.setup.model == "gat":
        classes, owner, counter = (st["pallas_cclasses"], spmm_tiles,
                                   "mask_launches")
        passes = gat_passes(widths)
    else:
        classes, owner = st["pallas_lclasses"], spmm_tiles_fused
        counter = "wire_bf16_launches" if eng.halo_dtype else "launches"
        passes = len(widths)                    # one fused launch a layer
    packs = pack_launches(eng.setup.model, eng.comm_schedule, widths)
    qids = synthetic_query_ids(eng.plan.n, queries, seed=seed)
    rec = RecordingEngine(eng)

    setattr(owner, counter, 0)                  # the main path starts here
    k1_open()
    row_pack.launches = 0
    fwd0 = eng.forward_count
    eng.warmup(qids)
    result = run_loadgen(rec, qids)
    k1_close()
    launches = getattr(owner, counter)          # ... and ends here
    n_pack = row_pack.launches
    forwards = eng.forward_count - fwd0
    expected = forwards * passes
    if launches != expected or launches == 0 or n_pack != forwards * packs:
        raise AssertionError(
            f"{name}: tile kernel launched {launches} times, expected "
            f"{forwards} forwards x {passes} passes = {expected}; row pack "
            f"{n_pack}, expected {forwards} x {packs}")
    s = result.summary()
    log(f"  {name}: {s['queries']} queries in {s['batches']} batches, "
        f"{s['achieved_qps']} QPS, p50 {s['latency_p50_ms']} ms, "
        f"p99 {s['latency_p99_ms']} ms; launches: tile kernel "
        f"({counter}) {launches} = {forwards} forwards x {passes} passes "
        f"(each over {len(classes)} classes), row pack {n_pack} = "
        f"{forwards} x {packs}")
    MAIN_PATH_PACKS[0] += n_pack
    return rec, result, launches


def serve_and_check(name, ahat, feats, pv, k, widths, queries, max_batch,
                    seed, check_rows=None, device="cuda", model="gcn",
                    plan=None):
    """Drive the serving main path on the card and hold it to the float64
    forward (GCN: ``oracle_forward``; GAT: ``gat64``).  Returns (engine,
    result, launches): the tile kernel's fused entry's launches for GCN,
    its int8-mask entry point's for GAT."""
    import numpy as np

    from sgcn_tpu_torch.models import gat as gat_model
    from sgcn_tpu_torch.models.gcn import params_from_jax
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.serve import ServeEngine

    n, fin = feats.shape
    t0 = time.perf_counter()
    plan = build_comm_plan(ahat, pv, k) if plan is None else plan
    dims = list(zip([fin] + widths[:-1], widths))
    if model == "gat":
        params = gat_params_numpy(seed, dims)
        torch_params = gat_model.params_from_jax(params)
    else:
        params = glorot_numpy(seed, dims)
        torch_params = params_from_jax(params)
    eng = ServeEngine(plan, fin=fin, widths=widths, model=model,
                      comm_schedule="a2a", params=torch_params,
                      max_batch=max_batch, device=device)
    eng.set_features(feats)
    st = eng.setup.fwd_static
    if model == "gat":
        what = f"combined {[(t, e) for t, e, _ in st['pallas_cclasses']]}"
    else:
        what = (f"local {[(t, e) for t, e, _ in st['pallas_lclasses']]} "
                f"halo {[(t, e) for t, e, _ in st['pallas_hclasses']]}")
    log(f"  {name}: plan + engine {time.perf_counter() - t0:.2f} s; "
        f"b={plan.b} S={plan.s} R={plan.r} classes {what}")
    rec, result, launches = drive_serving(name, eng, queries, seed)

    q = np.concatenate([np.asarray(a, np.int64) for a, _ in rec.served])
    got = np.concatenate([o for _, o in rec.served])
    if len(q) != queries or got.shape != (queries, widths[-1]) \
            or not np.isfinite(got).all():
        raise AssertionError(f"{name}: served {got.shape} rows, finite "
                             f"{np.isfinite(got).all()}")
    if check_rows is not None:
        pick = np.random.default_rng(seed).permutation(len(q))[:check_rows]
        q, got = q[pick], got[pick]
    t0 = time.perf_counter()
    want = (gat64(ahat, feats, params) if model == "gat"
            else oracle_forward(ahat, feats, params))[q]
    err = np.abs(got - want)
    log(f"  {name}: {len(q)} served rows vs float64 forward "
        f"({time.perf_counter() - t0:.2f} s): max abs err {err.max():.3g}, "
        f"max rel err {(err / np.maximum(np.abs(want), 1e-30)).max():.3g}, "
        f"max |float64 row| {np.abs(want).max():.3g}")
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: served logits differ from the "
                             f"float64 forward beyond rtol {RTOL}, atol {ATOL}")
    return eng, result, launches


def forward_breakdown(eng):
    """Device time of each stage of one GCN forward (CUDA events around
    each stage, run back to back): projection, exchange (the a2a receive
    buffer or the ring's concat: one row pack), the fused tile launch
    (local pass, halo pass and their sum), activation — per layer."""
    import torch

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.ops.pspmm import exchange_recv, ring_concat
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_fused

    pa, st = eng.pa, eng.setup.fwd_static
    tb, lcls, hcls = st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"]
    ragged = eng.comm_schedule == "ragged"
    hsrc = pa["ptile_hrsrc"] if ragged else pa["ptile_hwsrc"]
    weights = list(eng.model.weights)
    h = eng._h0
    rows = []
    torch.cuda.synchronize()
    with torch.inference_mode():
        for i, w in enumerate(weights):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
            ev[0].record()
            x = h @ w if pf else h
            ev[1].record()
            remote = (ring_concat(x, pa["ring_src"], st["rr_sizes"])
                      if ragged else exchange_recv(x, pa["recv_src"]))
            ev[2].record()
            z = spmm_tiles_fused(
                (pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]), x,
                (hsrc, pa["ptile_hld"], pa["ptile_hw"]), remote, lcls, hcls,
                tb)
            ev[3].record()
            z = z if pf else z @ w
            ev[4].record()
            h = torch.relu(z) if i < len(weights) - 1 else z
            ev[5].record()
            torch.cuda.synchronize()
            el = [ev[j].elapsed_time(ev[j + 1]) for j in range(5)]
            rows.append({"layer": i, "width": int(x.shape[-1]),
                         "project_ms": el[0] + el[3], "exchange_ms": el[1],
                         "fused_kernel_ms": el[2], "act_ms": el[4]})
        if not torch.equal(h, eng.forward()):
            raise AssertionError("breakdown != the engine's forward")
    return rows


def device_busy(run, reps: int = 5, tries: int = 1):
    """Device time vs wall over ``reps`` calls of ``run`` under
    ``torch.profiler``: returns (wall ms, device ms, top kernels).  The
    device time sums the events the profiler recorded ON the device
    (kernels, copies — one stream, so they do not overlap; the host-side
    aten ops that launched them are not counted again); the profiler's
    own overhead lengthens the wall, so 1 − device/wall is an upper bound
    of the idle share.  The profiler now and then records no device event
    at all (device ms 0): with ``tries`` > 1 the calls are profiled again,
    up to ``tries`` times in all — only for a ``run`` that may be
    repeated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        if rows:
            break
        log(f"  the profiler recorded no device time (try {attempt + 1} "
            f"of {tries})")
    return wall_ms, sum(ms for _, ms in rows), rows[:5]


# device-time classes of a flagship step: printed class -> the labels of
# the port's one kernel-name table (sgcn_tpu_torch/obs/tracing.py
# KERNEL_TABLE) it sums
DEVICE_CLASSES = tuple((lab, (lab,)) for lab in (
    "K3/K4 fused", "K1/K5", "pack", "gathers", "roll", "cat",
    "copies (transpose, casts)", "matmul"))


def device_split(name, run, reps: int = 3, what: str = "steps",
                 classes=DEVICE_CLASSES):
    """Device time of ``reps`` calls of ``run`` under ``torch.profiler``,
    split into ``classes`` by each kernel's ``KERNEL_TABLE`` label (the
    rest as "other"), and the idle share's upper bound; logged and
    returned as a dict.  CUDA events
    around the same calls give ``event_ms``, the span of the stream from
    the first launch to the last kernel's end.  Where the profiler
    recorded no device event (it now and then records none),
    ``device_ms`` and ``idle_le`` are None — not measured — and the
    caller's ``run`` is not repeated, since its launches may be counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgcn_tpu_torch.obs.tracing import kernel_label

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(reps):
            run()
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {label: 0.0 for label, _ in classes}
    split["other"] = 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type != DeviceType.CUDA or ms <= 0:
            continue
        lab = kernel_label(e.key)
        label = next((cls for cls, labels in classes if lab in labels),
                     "other")
        split[label] += ms
    dev_ms = sum(split.values()) or None
    out = {"wall_ms": wall, "event_ms": ev[0].elapsed_time(ev[1]),
           "device_ms": dev_ms,
           "idle_le": (1 - dev_ms / wall) if dev_ms else None, **split}
    if dev_ms is None:
        log(f"  {name}: {reps} {what} under torch.profiler: wall "
            f"{wall:.3f} ms, CUDA events {out['event_ms']:.3f} ms; the "
            "profiler recorded no device time — device time and idle "
            "share not measured")
        return out
    log(f"  {name}: {reps} {what} under torch.profiler: wall {wall:.3f} ms, "
        f"CUDA events {out['event_ms']:.3f} ms, device {dev_ms:.3f} ms, "
        f"idle share <= {out['idle_le']}; device ms by class: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return out


def log_device_busy(name, run, reps: int = 5, what: str = "batches"):
    wall, dev_ms, top = device_busy(run, reps)
    if dev_ms == 0:
        log(f"  {name}: profiler saw no device time — idle share not "
            "measured")
        return
    log(f"  {name}: {reps} {what} under torch.profiler: wall {wall:.3f} ms, "
        f"device {dev_ms:.3f} ms, idle share <= {1 - dev_ms / wall:.3f}; "
        "top: " + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top))


# ---------------------------------------------------------- training path
def backward_passes(fin, widths):
    """Aggregation backward passes one step really runs: autograd calls a
    layer's backward only where its aggregated input needs a gradient —
    every layer past the first, and the first only when it projects
    before aggregating (``agg(h0 @ w0)``)."""
    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN

    first = widths[0] < fin and fin >= PROJECT_FIRST_MIN_FIN
    return len(widths) - 1 + int(first)


def backprop64(ahat, feats, labels, params, masks=None):
    """Float64 host loss and weight gradients of the GCN with ReLU between
    layers, no activation after the last, and the mean softmax
    cross-entropy over every row, in the trainer's layer order (a wide
    input narrowed by the layer projects first).  The backward of each
    aggregation multiplies by Âᵀ (Â itself on a symmetric graph).

    ``masks``: per hidden layer, the ReLU derivative (``z > 0``) to use in
    place of float64's own — the float32 run's, so that an entry whose
    pre-activation lies within rounding of 0 (where the two runs may
    disagree on the sign) does not count as an error of the gradient.
    Returns (loss, grads, per-layer count of entries whose mask differs
    from float64's)."""
    import numpy as np

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN

    a = ahat.astype(np.float64).tocsr()
    at = a.T.tocsr()
    h = np.asarray(feats, np.float64)
    ws = [np.asarray(w, np.float64) for w in params]
    ins, relu, pfs = [], [], []
    for i, w in enumerate(ws):
        pf = w.shape[1] < h.shape[1] and h.shape[1] >= PROJECT_FIRST_MIN_FIN
        ins.append(h if pf else a @ h)        # what the layer's W multiplies
        z = a @ (h @ w) if pf else ins[-1] @ w
        pfs.append(pf)
        if i < len(ws) - 1:
            relu.append(z > 0)
            h = np.maximum(z, 0.0)
        else:
            h = z
    flips = [0] * len(relu)
    if masks is not None:
        flips = [int((m != r).sum()) for m, r in zip(masks, relu)]
        relu = masks
    n = h.shape[0]
    z = h - h.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    loss = -logp[np.arange(n), labels].mean()
    dz = np.exp(logp)
    dz[np.arange(n), labels] -= 1.0
    dz /= n
    grads = [None] * len(ws)
    for i in reversed(range(len(ws))):
        if pfs[i]:                           # z = Â (h W)
            adz = at @ dz
            grads[i] = ins[i].T @ adz
            dh = adz @ ws[i].T
        else:                                # z = (Â h) W
            grads[i] = ins[i].T @ dz
            dh = at @ (dz @ ws[i].T)
        if i:
            dz = dh * relu[i - 1]
    return float(loss), grads, flips


def forward_backward_trace(tr, data):
    """One forward and backward of the trainer's loss at its current
    weights, written out with the public op, without an optimizer step:
    returns the pre-activations of every layer and, by layer, the
    gradient table that reaches each aggregation's backward."""
    import torch

    from sgcn_tpu_torch.models.gcn import PROJECT_FIRST_MIN_FIN
    from sgcn_tpu_torch.ops.tile_spmm import (TILE_PLAN_FIELDS,
                                              TILE_PLAN_FIELDS_RAGGED,
                                              pspmm_tiles_gen,
                                              pspmm_tiles_ragged,
                                              pspmm_tiles_sym)
    from sgcn_tpu_torch.train import LOSSES

    st = tr.model.fwd_static
    static = (st["pallas_tb"], st["pallas_lclasses"], st["pallas_hclasses"])
    if not st.get("symmetric", True):
        def agg(x):
            return pspmm_tiles_gen(
                x, tr.pa, *static, (st["pallas_tlclasses"],
                                    st["pallas_thclasses"],
                                    st["pallas_t1classes"]))
    elif tr.comm_schedule == "ragged":
        def agg(x):
            return pspmm_tiles_ragged(
                x, *(tr.pa[f] for f in TILE_PLAN_FIELDS_RAGGED), *static,
                st["rr_sizes"])
    else:
        def agg(x):
            return pspmm_tiles_sym(
                x, *(tr.pa[f] for f in TILE_PLAN_FIELDS), *static)
    zs, caught = [], {}
    weights = list(tr.model.weights)
    h = data.h0
    for i, w in enumerate(weights):
        pf = w.shape[1] < h.shape[-1] and h.shape[-1] >= PROJECT_FIRST_MIN_FIN
        z = agg(h @ w if pf else h)
        if z.requires_grad:
            z.register_hook(lambda g, i=i: caught.__setitem__(
                i, g.detach().contiguous()))
        z = z if pf else z @ w
        zs.append(z.detach())
        h = torch.relu(z) if i < len(weights) - 1 else z
    loss = LOSSES[tr.loss_name](h, data.labels, data.train_valid)
    torch.autograd.grad(loss, weights)
    torch.cuda.synchronize()
    return zs, caught


def step_breakdown(tr, data, steps: int = 3):
    """Device time of the three parts of a training step — forward with
    the loss, backward, optimizer — from CUDA events around each, over
    ``steps`` steps (the trainer's ``_one_step`` written out)."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    rows = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        tr.opt.zero_grad(set_to_none=True)
        loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                    data.train_valid)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    return {key: sum(r[j] for r in rows) / steps
            for j, key in enumerate(("forward_ms", "backward_ms",
                                     "optimizer_ms"))}


def gat_forward_breakdown(eng):
    """Device time of each stage of one GAT forward, per layer, from CUDA
    events recorded at the boundaries of the model's own functions while
    ``eng.forward()`` runs (``_gat_factored_fwd_core``,
    ``_gat_tiles_aggregate``, ``gat_tiles_pass``): projection (``z =
    h·w``, scores, ``u``, ``p = u·z``: the layer's start to its
    aggregation), exchange (the table or the split pair to the halo or
    the ring, and the ``[local; halo]`` concatenation: to the first
    pass), numerator pass (the one pass of a fused layer), denominator
    pass (a split layer's second pass; a fused one's lane slice: from the
    first pass's end to the aggregation's), division (to the layer's
    end)."""
    import torch

    from sgcn_tpu_torch.models import gat as gat_model

    layers = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        layers[-1].append((label, ev))

    def around(fn, before, after, new_layer=False):
        def wrapped(*args, **kw):
            if new_layer:
                layers.append([])
            mark(before)
            out = fn(*args, **kw)
            mark(after)
            return out
        return wrapped

    names = ("_gat_factored_fwd_core", "_gat_tiles_aggregate",
             "gat_tiles_pass")
    orig = {name: getattr(gat_model, name) for name in names}
    gat_model._gat_factored_fwd_core = around(
        orig["_gat_factored_fwd_core"], "start", "end", new_layer=True)
    gat_model._gat_tiles_aggregate = around(
        orig["_gat_tiles_aggregate"], "agg", "agg_end")
    gat_model.gat_tiles_pass = around(orig["gat_tiles_pass"], "pass",
                                      "pass_end")
    torch.cuda.synchronize()
    try:
        out = eng.forward()
    finally:
        for name, fn in orig.items():
            setattr(gat_model, name, fn)
    torch.cuda.synchronize()
    rows = []
    for i, (marks, p) in enumerate(zip(layers, eng.model.layer_params())):
        at = {}
        for label, ev in marks:                  # first mark of each label
            at.setdefault(label, ev)
        passes = sum(label == "pass" for label, _ in marks)
        fout = p["w"].shape[1]

        def ms(a, b):
            return at[a].elapsed_time(at[b])

        rows.append({"layer": i, "form": "fused" if passes == 1 else "split",
                     "width": fout, "project_ms": ms("start", "agg"),
                     "exchange_ms": ms("agg", "pass"),
                     "numerator_pass_ms": ms("pass", "pass_end"),
                     "denominator_pass_ms": ms("pass_end", "agg_end"),
                     "divide_ms": ms("agg_end", "end")})
    if len(rows) != len(eng.widths) or not torch.equal(out, eng.forward()):
        raise AssertionError("GAT breakdown: the recorded forward != the "
                             "engine's forward")
    return rows


def gat_train_pass(tr, data):
    """One forward and backward of the GAT trainer's loss at its current
    weights, without an optimizer step."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                data.train_valid)
    torch.autograd.grad(loss, list(tr.model.parameters()))


def record_gat_passes(run):
    """Run ``run()`` recording every K5 pass the GAT model makes: the
    arguments of each ``gat_tiles_pass`` call of ``models/gat.py``, the
    tables exactly as the model built them (a2a or ring), grouped by
    aggregation (``_gat_tiles_aggregate``): for a training pass the
    forward's layers in order, then the backward's in reverse.  Each
    group holds one pass for a fused layer, two (numerator, denominator)
    for a split one; each pass is (tiles, table, classes, tb)."""
    import torch

    from sgcn_tpu_torch.models import gat as gat_model

    groups = []
    orig_agg, orig_pass = gat_model._gat_tiles_aggregate, \
        gat_model.gat_tiles_pass

    def aggregate(*args):
        groups.append([])
        return orig_agg(*args)

    def recording(csrc, cld, cw, table, cclasses, tb, num_rows):
        groups[-1].append(([csrc, cld, cw], table.detach(), cclasses, tb))
        return orig_pass(csrc, cld, cw, table, cclasses, tb, num_rows)

    gat_model._gat_tiles_aggregate = aggregate
    gat_model.gat_tiles_pass = recording
    try:
        run()
    finally:
        gat_model._gat_tiles_aggregate = orig_agg
        gat_model.gat_tiles_pass = orig_pass
    torch.cuda.synchronize()
    return groups


def check_time_gat_call(passes, what):
    """K5 on one recorded aggregation's real tables: the mask kernel ==
    its plain version (and two launches) bit for bit per pass, then its
    time, plain time, bound and library time summed over the passes.
    Returns (max |kernel - plain|, timing dict)."""
    err, tot, bound_by = 0.0, {}, None
    for tiles, table, cls, tb in passes:
        f = table.shape[-1]
        err = max(err, check_k1(tiles, table, cls, tb, f"{what} f={f}"))
        t = time_k1([x.cpu().numpy() for x in tiles], tiles, table, cls, tb,
                    table.shape[1], f"{what} f={f}")
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] = tot.get(key, 0.0) + t[key]
        bound_by = bound_by or t["bound_by"]
    tot["bound_by"] = bound_by
    log(f"  {what}: K5 over its {len(passes)} table(s): {tot['ms']!r} ms; "
        f"bound {tot['bound_ms']!r} ms; plain {tot['plain_ms']!r} ms; "
        f"torch.sparse.mm {tot['library_ms']!r} ms")
    return err, tot


def check_gat_passes(groups, what):
    """K5 == plain bit for bit on every recorded pass; returns the max
    |kernel - plain|."""
    err = 0.0
    for j, passes in enumerate(groups):
        for tiles, table, cls, tb in passes:
            err = max(err, check_k1(tiles, table, cls, tb, f"{what} "
                                    f"aggregation {j} f={table.shape[-1]}"))
    return err


# -------------------------------------------------------- the ragged ring
def serve_ragged(name, eng_a, feats, queries, max_batch, seed):
    """Drive the serving main path on the ragged ring: an engine on
    ``eng_a``'s plan, weights and features with ``comm_schedule='ragged'``.
    Its launches must be exact (for GCN, every one through
    ``PspmmTilesRagged``) and every served row must equal the a2a
    engine's row for the same query, bit for bit.  Returns (engine,
    result, launches)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import PspmmTilesRagged
    from sgcn_tpu_torch.serve import ServeEngine

    eng = ServeEngine(eng_a.plan, fin=eng_a.fin, widths=eng_a.widths,
                      model=eng_a.setup.model, comm_schedule="ragged",
                      params=eng_a.model.layer_params(),
                      max_batch=max_batch, device=eng_a.device)
    if eng.comm_schedule != "ragged":
        raise AssertionError(f"{name}: resolved {eng.comm_schedule}")
    eng.set_features(feats)
    PspmmTilesRagged.launches = 0
    rec, result, launches = drive_serving(name, eng, queries, seed)
    if PspmmTilesRagged.launches != (
            0 if eng.setup.model == "gat" else launches):
        raise AssertionError(f"{name}: {PspmmTilesRagged.launches} "
                             "launches through the ring op")
    for q, out in rec.served:
        if not np.array_equal(out, eng_a.query(q)):
            raise AssertionError(f"{name}: served rows != the a2a "
                                 "engine's rows")
    if not torch.equal(eng.forward(), eng_a.forward()):
        raise AssertionError(f"{name}: ragged forward != a2a forward")
    log(f"  {name}: {len(rec.served)} served batches and the whole "
        f"forward == the a2a engine's, bit for bit; wire rows per "
        f"exchange {eng.gauges()['wire_rows_per_exchange']} (a2a "
        f"{eng_a.gauges()['wire_rows_per_exchange']})")
    return eng, result, launches


def log_side_by_side(name, a2a_rows, ring_rows, keys):
    for a, r in zip(a2a_rows, ring_rows):
        log(f"  {name} layer {a['layer']}: " + ", ".join(
            f"{k} a2a {a[k]:.4f} / ring {r[k]:.4f} ms" for k in keys))


def run_train_cli(argv):
    """``python -m sgcn_tpu_torch.train``'s ``main`` in-process: its
    per-epoch losses and its JSON report."""
    from sgcn_tpu_torch.train.__main__ import main as train_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(argv)
    lines = out.getvalue().strip().splitlines()
    return ([float(x.split()[-1]) for x in lines if x.startswith("epoch ")],
            json.loads(lines[-1]))


def k6_bound_ms(idx, f):
    """Bytes the row shuffle needs on these inputs — each distinct
    referenced row read once, the index read once, the output written
    once — over the HBM rate; it does no arithmetic."""
    import numpy as np

    rows = np.unique(idx.cpu().numpy()).size
    s = idx.shape[0]
    return (rows * f * 4 + s * 4 + s * f * 4) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------- the bf16 levers
BF16_WIDTHS = (1, 7, 8, 16, 17, 40, 41, 128, 129)
BAND_GCN = dict(rtol=0.05, atol=0.02)    # tests/test_train_parity.py:122
BAND_GAT = dict(rtol=0.05, atol=0.03)    # tests/test_gat.py:171
SERVE_BF16_TOL = dict(rtol=5e-3, atol=5e-3)   # tests/test_halo_dtype.py:43


def phase_bf16_kernels(rng, dev, tiles_np, tiles, classes, tb, n):
    """Phase 14: K1 and K5 on bf16 tables (the kernel's bf16 entry
    points) vs their plain version, bit for bit and between two launches,
    on phase 1's tiles (hub row, all-pad tile, pad-heavy class) at every
    width of ``BF16_WIDTHS``: on an 8-byte aligned table, on a view whose
    base is 2-byte but not 8-byte aligned, and with inf and NaN in the row
    the pads read.  Times K1-bf16 at f ∈ {16, 128}.  Returns the max
    |kernel − plain| of each and the times."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles

    k = tiles[0].shape[0]
    mtiles = tiles[:2] + [(tiles[2] != 0).to(torch.int8)]
    err = {"k1": 0.0, "k5": 0.0}
    times = {}
    before = (spmm_tiles.launches, spmm_tiles.mask_launches,
              spmm_tiles.bf16_launches, spmm_tiles.bf16_mask_launches)
    for f in BF16_WIDTHS:
        table = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev).bfloat16()
        bad = table.clone()
        bad[:, 0, 0], bad[:, 0, -1] = float("inf"), float("nan")
        for t_, how, nan_ok in ((table, "", False),
                                (unaligned_copy(table), " 2-byte aligned",
                                 False),
                                (bad, " inf/NaN in the pads' row", True)):
            err["k1"] = max(err["k1"], check_k1(
                tiles, t_, classes, tb, f"K1 bf16 f={f}{how}", nan_ok))
            err["k5"] = max(err["k5"], check_k1(
                mtiles, t_, classes, tb, f"K5 bf16 f={f}{how}", nan_ok))
        if f in (16, 128):
            times[f] = time_k1(tiles_np, tiles, table, classes, tb, n,
                               f"K1 bf16 random tiles f={f}")
    after = (spmm_tiles.launches, spmm_tiles.mask_launches,
             spmm_tiles.bf16_launches, spmm_tiles.bf16_mask_launches)
    if after[:2] != before[:2] or after[2] == before[2] \
            or after[3] == before[3]:
        raise AssertionError(f"bf16 tables launched {after} from {before}: "
                             "not (only) the bf16 entries")
    return err, times


def record_aggregations(run):
    """Run ``run()`` recording the table of every GCN aggregation
    (``_pspmm_tiles_once`` of ``ops/tile_spmm.py``, which the forward and
    the backward of ``PspmmTilesSym`` call): the forward's layers in
    order, then the backward's gradient tables."""
    import torch

    from sgcn_tpu_torch.ops import tile_spmm

    calls, orig = [], tile_spmm._pspmm_tiles_once

    def recording(h, *args):
        calls.append(h.detach())
        return orig(h, *args)

    tile_spmm._pspmm_tiles_once = recording
    try:
        run()
    finally:
        tile_spmm._pspmm_tiles_once = orig
    torch.cuda.synchronize()
    return calls


def gcn_train_pass(tr, data):
    """One forward and backward of the GCN trainer's loss at its current
    weights, without an optimizer step."""
    import torch

    from sgcn_tpu_torch.train import LOSSES

    loss = LOSSES[tr.loss_name](tr._forward(data.h0), data.labels,
                                data.train_valid)
    torch.autograd.grad(loss, list(tr.params))


def time_layer(pa, st, table, tb, what):
    """K1 over one aggregation's two families on ``table`` (its halo
    family over the a2a receive buffer, on the table's own dtype): bit for
    bit against the plain version, the fused entry on the same inputs
    likewise, then the two K1 passes' times summed and the whole op's
    (``time_whole_op``).  Returns (max |kernel − plain|, K1 timing dict,
    whole-op timing dict)."""
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    recv = exchange_recv(table, pa["recv_src"])
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    htiles = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    err = max(check_k1(ltiles, table, st["pallas_lclasses"], tb,
                       f"{what} local pass"),
              check_k1(htiles, recv, st["pallas_hclasses"], tb,
                       f"{what} halo pass"),
              check_fused(ltiles, table, htiles, recv, st["pallas_lclasses"],
                          st["pallas_hclasses"], tb, f"{what} fused"))
    t_l = time_k1([t.cpu().numpy() for t in ltiles], ltiles, table,
                  st["pallas_lclasses"], tb, table.shape[1],
                  f"{what} local pass")
    t_h = time_k1([t.cpu().numpy() for t in htiles], htiles, recv,
                  st["pallas_hclasses"], tb, recv.shape[1],
                  f"{what} halo pass")
    out = {key: (None if t_l[key] is None or t_h[key] is None
                 else t_l[key] + t_h[key])
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = t_h["bound_by"]
    log(f"  {what}: K1 over both families {out['ms']!r} ms; bound "
        f"{out['bound_ms']!r} ms; plain {out['plain_ms']!r} ms; "
        f"torch.sparse.mm {out['library_ms']!r} ms")
    return err, out, time_whole_op(table, pa, st, tb, False,
                                   f"{what} whole K3 op")


def split_f32(model, trainers, data):
    """The float32 trainers' step breakdown and profiler split, beside
    which the bf16 runs of phases 15 and 17 are read."""
    for sched, tr in trainers.items():
        log(f"  {model} float32 {sched}: step breakdown (CUDA events, mean "
            f"of 3): {json.dumps(step_breakdown(tr, data))}")
        device_split(f"{model} float32 {sched} training",
                     lambda tr=tr: tr.step(data))


def phase_bf16_gcn_training(plan, data, p_init, widths, rep32, dev, tb,
                            steps, bwd):
    """Phase 15: the flagship GCN trained under each bf16 lever on both
    transports from phase 5's initial weights, 1 warm-up + 5 timed steps:
    ragged == a2a bit for bit (losses and weights after ``fit``), the
    losses inside the reference's bf16 band of phase 5's float32 run and
    not equal to them, exact launches per entry (``halo_dtype`` keeps
    float32 tables: the float32 entry; ``compute_dtype``: the bf16 entry
    only); ``epoch_s``, the step breakdown and the profiler's split; K1
    on the compute run's real bf16 forward and gradient tables == plain,
    and K1-bf16's time at the flagship layer.  Returns (launches per
    entry, max |kernel − plain|, the forward layer's timing, and the
    ``halo_dtype`` runs' losses and weights by transport)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesRagged,
                                              PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer

    fam = 1
    want = steps * (len(widths) + bwd) * fam
    runs, launches = {}, {"wire": 0, "bf16": 0}
    for lever in ("halo_dtype", "compute_dtype"):
        for sched in ("a2a", "ragged"):
            tr = FullBatchTrainer(plan, fin=128, widths=widths,
                                  params=p_init, comm_schedule=sched,
                                  device=dev, **{lever: "bfloat16"})
            # the main path starts here
            for c in ("launches", "wire_bf16_launches", "bf16_launches"):
                setattr(spmm_tiles_fused, c, 0)
            spmm_tiles.launches = spmm_tiles.bf16_launches = 0
            row_pack.launches = 0
            PspmmTilesSym.backward_launches = 0
            PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
            k1_open()
            rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
            k1_close()
            n = (spmm_tiles_fused.launches,           # ... and ends here
                 spmm_tiles_fused.wire_bf16_launches,
                 spmm_tiles_fused.bf16_launches,
                 spmm_tiles.launches + spmm_tiles.bf16_launches)
            n_pack = row_pack.launches
            nbwd = (PspmmTilesRagged.backward_launches if sched == "ragged"
                    else PspmmTilesSym.backward_launches)
            exp = ((0, want, 0, 0) if lever == "halo_dtype"
                   else (0, 0, want, 0))
            log(f"  GCN {lever}=bfloat16 {sched}: fused launches float32 "
                f"{n[0]}, bf16 wire {n[1]}, bf16 {n[2]}; K1 {n[3]}; "
                f"backward {nbwd}; row pack {n_pack}; expected {exp} and "
                f"{want} packs = {steps} steps x ({len(widths)} forward + "
                f"{bwd} backward aggregations); losses "
                f"{rep['loss_history']}; epoch_s {rep['epoch_s']!r}; "
                f"wire bytes per step {rep['halo_bytes_wire_per_step']}")
            if n != exp or nbwd != steps * bwd * fam or n_pack != want:
                raise AssertionError(f"GCN {lever} {sched}: launch counts "
                                     "differ from the passes run")
            launches["wire"] += n[1]
            launches["bf16"] += n[2]
            MAIN_PATH_PACKS[0] += n_pack
            runs[(lever, sched)] = {
                "rep": rep, "tr": tr,
                "w": [w.detach().clone() for w in tr.params]}
        a2a, ring = runs[(lever, "a2a")], runs[(lever, "ragged")]
        same = (a2a["rep"]["loss_history"] == ring["rep"]["loss_history"]
                and all(torch.equal(x, y) for x, y in zip(a2a["w"],
                                                          ring["w"])))
        l16 = np.asarray(a2a["rep"]["loss_history"])
        l32 = np.asarray(rep32["loss_history"])
        band = np.allclose(l16, l32, **BAND_GCN)
        log(f"  GCN {lever}: ragged == a2a (losses, weights): {same}; "
            f"losses vs float32 {l32.tolist()}: max |gap| "
            f"{np.abs(l16 - l32).max():.3g}, inside the band {BAND_GCN}: "
            f"{band}, bit-equal: {np.array_equal(l16, l32)}")
        if not same or not band or np.array_equal(l16, l32) \
                or not np.isfinite(l16).all():
            raise AssertionError(f"GCN {lever}: ragged != a2a, or losses "
                                 "outside the band, or equal to float32")
    for (lever, sched), run in runs.items():
        tr = run["tr"]
        log(f"  GCN {lever} {sched}: epoch_s {run['rep']['epoch_s']!r}; "
            f"step breakdown (CUDA events, mean of 3): "
            f"{json.dumps(step_breakdown(tr, data))}")
        run["split"] = device_split(f"GCN {lever} {sched} training",
                                    lambda tr=tr: tr.step(data))
    tr = runs[("compute_dtype", "a2a")]["tr"]
    calls = record_aggregations(lambda: gcn_train_pass(tr, data))
    if [c.dtype for c in calls] != [torch.bfloat16] * (len(widths) + bwd):
        raise AssertionError(f"compute run's aggregation tables "
                             f"{[c.dtype for c in calls]}")
    st, pa = tr.model.fwd_static, tr.pa
    err_g, _, _ = time_layer(pa, st, calls[len(widths)], tb,
                             "flagship bf16 gradient (layer 2 backward)")
    err_f, t_fwd, op_fwd = time_layer(pa, st, calls[0], tb,
                                      "flagship bf16 layer-0 forward table")
    # the bf16 wire under halo_dtype: the pack narrows, the fused launch
    # reads the bf16 receive buffer beside the float32 h
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    trw = runs[("halo_dtype", "a2a")]["tr"]
    h32 = record_aggregations(lambda: gcn_train_pass(trw, data))[0]
    pw = trw.pa
    check_pack(h32, pw["recv_src"], torch.bfloat16,
               "flagship layer-0 exchange on the bf16 wire")
    wire = exchange_recv(h32, pw["recv_src"], "bfloat16")
    err_w = check_fused(
        [pw["ptile_lsrc"], pw["ptile_lld"], pw["ptile_lw"]], h32,
        [pw["ptile_hwsrc"], pw["ptile_hld"], pw["ptile_hw"]], wire,
        st["pallas_lclasses"], st["pallas_hclasses"], tb,
        "flagship layer-0 fused on the bf16 wire")
    t_wire = time_pack(h32, pw["recv_src"], torch.bfloat16,
                       "flagship layer-0 exchange, bf16 wire")
    halo_runs = {sched: (runs[("halo_dtype", sched)]["rep"]["loss_history"],
                         runs[("halo_dtype", sched)]["w"])
                 for sched in ("a2a", "ragged")}
    return launches, max(err_g, err_f, err_w), t_fwd, op_fwd, t_wire, \
        halo_runs


def phase_bf16_serving(eng_f, eng_fr, res_f, res_fr, ahat, feats, dev):
    """Phase 16: flagship GCN serving with ``halo_dtype='bfloat16'`` on
    both transports, phase 3's plan, weights and features: 512 queries,
    256 served rows within rtol 5e-3 / atol 5e-3 of the float64 forward,
    the ring's rows and whole forward == the a2a engine's bit for bit,
    exact launches (float32 tables: the float32 entry); p50/p99 and QPS
    beside the float32 engines'.  Returns the launches."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.serve import ServeEngine

    params = [w.detach().cpu().numpy() for w in eng_f.model.weights]
    want_all = oracle_forward(ahat, feats, params)
    engines, total = {}, 0
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(eng_f.plan, fin=eng_f.fin, widths=eng_f.widths,
                          comm_schedule=sched, halo_dtype="bfloat16",
                          params=eng_f.model.layer_params(), max_batch=64,
                          device=dev)
        eng.set_features(feats)
        rec, result, launches = drive_serving(
            f"flagship GCN halo_dtype=bfloat16 {sched}", eng, 512, 3)
        total += launches
        q = np.concatenate([np.asarray(a, np.int64) for a, _ in rec.served])
        got = np.concatenate([o for _, o in rec.served])
        pick = np.random.default_rng(3).permutation(len(q))[:256]
        err = np.abs(got[pick] - want_all[q[pick]])
        ok = np.allclose(got[pick], want_all[q[pick]], **SERVE_BF16_TOL)
        log(f"  {sched}: 256 served rows vs float64 forward: max abs err "
            f"{err.max():.3g} (inside {SERVE_BF16_TOL}: {ok})")
        if not ok or not np.isfinite(got).all():
            raise AssertionError(f"halo_dtype serving {sched}: rows off the "
                                 "float64 forward")
        engines[sched] = (eng, rec, result)
    (ea, _ra, res_a), (er, rr, res_r) = engines["a2a"], engines["ragged"]
    for q, out in rr.served:
        if not np.array_equal(out, ea.query(q)):
            raise AssertionError("halo_dtype serving: ring rows != a2a rows")
    if not torch.equal(er.forward(), ea.forward()):
        raise AssertionError("halo_dtype serving: ring forward != a2a")
    for name, r16, r32 in (("a2a", res_a, res_f), ("ring", res_r, res_fr)):
        a, b = r16.summary(), r32.summary()
        log(f"  flagship GCN serving {name}: bf16 wire p50 "
            f"{a['latency_p50_ms']} ms, p99 {a['latency_p99_ms']} ms, "
            f"{a['achieved_qps']} QPS; float32 p50 {b['latency_p50_ms']} "
            f"ms, p99 {b['latency_p99_ms']} ms, {b['achieved_qps']} QPS")
    log("  ring rows and whole forward == a2a, bit for bit; breakdown "
        "a2a: " + json.dumps(forward_breakdown_halo(ea)))
    log_device_busy("flagship GCN halo_dtype a2a",
                    lambda: ea.query(np.arange(64)))
    log_device_busy("flagship GCN halo_dtype ring",
                    lambda: er.query(np.arange(64)))
    return total


def forward_breakdown_halo(eng):
    """One bf16-wire exchange of layer 0 against the float32 one on the
    same table (CUDA events, mean of 10): the wire's effect alone."""
    from sgcn_tpu_torch.ops.pspmm import exchange_recv

    pa, h = eng.pa, eng._h0
    return {"exchange_f32_ms": cuda_ms(lambda: exchange_recv(
                h, pa["recv_src"]), reps=10),
            "exchange_bf16_wire_ms": cuda_ms(lambda: exchange_recv(
                h, pa["recv_src"], "bfloat16"), reps=10)}


def phase_bf16_gat(plan, data, params_g, widths, rep32, dev, steps,
                   cli, cli_losses):
    """Phase 17: the flagship GAT trained under ``compute_dtype=
    'bfloat16'`` on both transports (every layer packed: 128, 128 and 40
    are even), 1 warm-up + 5 timed steps: ragged == a2a bit for bit, the
    losses inside the reference's GAT bf16 band of phase 8's float32 run
    and not equal to them, exact launches per entry (a packed pass runs
    the bf16 entry on the feature lanes and the float32 one on ``u``);
    ``epoch_s``, the step breakdown, the profiler's split; K5 on every
    real table of a training step == plain and K5-bf16's time at the
    flagship layer.  Then cora2708 GAT 1433 → 16 → 7 ``--dtype bfloat16``
    through the train CLI (16 packed, 7 odd: the fused bf16 table),
    against phase 9's float32 CLI run.  Returns (launches per entry, max
    |kernel − plain|, the flagship feature pass's timing)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import GatLayerSym
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles
    from sgcn_tpu_torch.train import FullBatchTrainer

    per_dir = len(widths)                 # one bf16 + one f32 pass a layer
    runs, launches = {}, {"f32": 0, "bf16": 0}
    for sched in ("a2a", "ragged"):
        tr = FullBatchTrainer(plan, fin=128, widths=widths, model="gat",
                              activation="none",
                              params=gat_from_numpy(params_g),
                              comm_schedule=sched, compute_dtype="bfloat16",
                              device=dev)
        spmm_tiles.mask_launches = spmm_tiles.bf16_mask_launches = 0
        row_pack.launches = 0
        GatLayerSym.backward_launches = 0       # the main path starts here
        k1_open()
        rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
        n32, n16 = spmm_tiles.mask_launches, spmm_tiles.bf16_mask_launches
        k1_close()
        nbwd = GatLayerSym.backward_launches    # ... and ends here
        n_pack = row_pack.launches
        MAIN_PATH_PACKS[0] += n_pack
        want = steps * 2 * per_dir
        want_pack = steps * 2 * pack_launches("gat", sched, widths,
                                              "bfloat16")
        log(f"  GAT bf16 {sched}: K5 launches float32 entry {n32}, bf16 "
            f"entry {n16} (backward {nbwd}); expected {want} each = {steps} "
            f"steps x 2 directions x {per_dir} packed layers; row pack "
            f"{n_pack} (expected {want_pack}); losses "
            f"{rep['loss_history']}; epoch_s {rep['epoch_s']!r}; wire bytes "
            f"per step {rep['halo_bytes_wire_per_step']}")
        if (n32, n16, nbwd, n_pack) != (want, want, want, want_pack):
            raise AssertionError(f"GAT bf16 {sched}: K5 launch counts differ "
                                 "from the passes run")
        launches["f32"] += n32
        launches["bf16"] += n16
        runs[sched] = {"rep": rep, "tr": tr, "w": [
            p.detach().clone() for p in tr.model.parameters()]}
    a2a, ring = runs["a2a"], runs["ragged"]
    same = (a2a["rep"]["loss_history"] == ring["rep"]["loss_history"]
            and all(torch.equal(x, y) for x, y in zip(a2a["w"], ring["w"])))
    l16 = np.asarray(a2a["rep"]["loss_history"])
    l32 = np.asarray(rep32["loss_history"])
    band = np.allclose(l16, l32, **BAND_GAT)
    log(f"  GAT bf16: ragged == a2a (losses, weights): {same}; losses vs "
        f"float32 {l32.tolist()}: max |gap| {np.abs(l16 - l32).max():.3g}, "
        f"inside the band {BAND_GAT}: {band}, bit-equal: "
        f"{np.array_equal(l16, l32)}")
    if not same or not band or np.array_equal(l16, l32) \
            or not np.isfinite(l16).all():
        raise AssertionError("GAT bf16: ragged != a2a, or losses outside "
                             "the band, or equal to float32")
    for sched, run in runs.items():
        tr = run["tr"]
        log(f"  GAT bf16 {sched}: epoch_s {run['rep']['epoch_s']!r}; step "
            f"breakdown (CUDA events, mean of 3): "
            f"{json.dumps(step_breakdown(tr, data))}")
        run["split"] = device_split(f"GAT bf16 {sched} training",
                                    lambda tr=tr: tr.step(data))
    calls = record_gat_passes(lambda: gat_train_pass(a2a["tr"], data))
    dtypes = [[str(t.dtype)[6:] for _, t, _, _ in c] for c in calls]
    log(f"  one training pass's K5 tables by aggregation: {dtypes}")
    if dtypes != [["bfloat16", "float32"]] * (2 * per_dir):
        raise AssertionError("GAT bf16: packed passes' tables are not "
                             "bf16 features + float32 u")
    err = check_gat_passes(calls, "flagship GAT bf16")
    tiles, table, cls, tb = calls[0][0]
    t5 = time_k1([x.cpu().numpy() for x in tiles], tiles, table, cls, tb,
                 table.shape[1], "flagship GAT bf16 layer-0 forward "
                 "feature pass f=128")

    spmm_tiles.mask_launches = spmm_tiles.bf16_mask_launches = 0
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0           # the main path starts here
    k1_open()
    losses, rep_c = run_train_cli(cli + ["--model", "gat", "--dtype",
                                         "bfloat16", "--comm-schedule",
                                         "a2a"])
    n32, n16 = spmm_tiles.mask_launches, spmm_tiles.bf16_mask_launches
    k1_close()
    n_pack = row_pack.launches                  # ... and ends here
    MAIN_PATH_PACKS[0] += n_pack
    want_pack = 5 * 2 * pack_launches("gat", "a2a", [16, 7], "bfloat16")
    # per step: forward packed 16 (bf16 + f32) and fused bf16 7 (bf16);
    # backward packed (bf16 + f32) and fused float32 (f32)
    want_c = (5 * 3, 5 * 3)
    band_c = np.allclose(losses, cli_losses, **BAND_GAT)
    log(f"  cora GAT --dtype bfloat16 CLI: losses {losses} (float32 "
        f"{cli_losses}, inside {BAND_GAT}: {band_c}); K5 launches float32 "
        f"{n32}, bf16 {n16} (expected {want_c}), row pack {n_pack} "
        f"(expected {want_pack}); wire bytes per step "
        f"{rep_c['halo_bytes_wire_per_step']}; epoch_s "
        f"{rep_c['epoch_s']!r}")
    if (n32, n16) != want_c or not band_c or rep_c["dtype"] != "bfloat16" \
            or losses == cli_losses or n_pack != want_pack:
        raise AssertionError("cora GAT bf16 CLI: launches, band or dtype")
    launches["f32"] += n32
    launches["bf16"] += n16
    return launches, err, t5


# ------------------------------------------------- asymmetric Â (directed)
def directed_er_graph(n, seed=0):
    """The directed flagship graph: 14·n ordered pairs (i, j) from
    ``default_rng(seed)``, self pairs dropped, every edge of weight 1
    (a pair drawn twice is one edge); the caller normalizes it."""
    import numpy as np
    import scipy.sparse as sp

    r, c = np.random.default_rng(seed).integers(0, n, (2, 14 * n))
    keep = r != c
    a = sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                       (r[keep], c[keep])), shape=(n, n))
    a.data[:] = 1.0
    return a


def record_launches(run):
    """Run ``run()`` recording the inputs of every tile family launch
    (``spmm_tiles_classes``: K1 on float32 weights, K5 on int8 masks),
    every row pack and every fused launch it makes, through the module
    attributes the ops call them by.  Returns (families, packs, fused):
    lists of argument tuples."""
    import torch

    from sgcn_tpu_torch.ops import pspmm, tile_spmm

    fams, packs, fused = [], [], []
    orig = (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
            tile_spmm.spmm_tiles_fused)

    def family(src, ld, w, table, classes, tb):
        fams.append(([src, ld, w], table.detach(), classes, tb))
        return orig[0](src, ld, w, table, classes, tb)

    def pack(src, flat, dtype=None):
        packs.append((src.detach(), flat, dtype or src.dtype))
        return orig[1](src, flat, dtype)

    def fuse(ltiles, h, htiles, remote, lcls, hcls, tb):
        fused.append((ltiles, h.detach(), htiles, remote, lcls, hcls, tb))
        return orig[2](ltiles, h, htiles, remote, lcls, hcls, tb)

    # the wrappers share the wrapped functions' launch counters
    for wrapper, wrapped in zip((family, pack, fuse), orig):
        wrapper.__dict__ = wrapped.__dict__
    (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
     tile_spmm.spmm_tiles_fused) = family, pack, fuse
    try:
        run()
    finally:
        (tile_spmm.spmm_tiles_classes, pspmm.row_pack,
         tile_spmm.spmm_tiles_fused) = orig
    torch.cuda.synchronize()
    return fams, packs, fused


def check_launches(name, recorded):
    """Every recorded family launch, pack and fused launch == its plain
    version on the same (real) inputs, bit for bit.  Returns the max
    |kernel − plain| (0.0 when identical)."""
    fams, packs, fused = recorded
    err = 0.0
    for j, (tiles, table, cls, tb) in enumerate(fams):
        err = max(err, check_k1(tiles, table, cls, tb, f"{name} family "
                                f"launch {j} f={table.shape[-1]}"))
    for j, (src, flat, dtype) in enumerate(packs):
        check_pack(src, flat, dtype, f"{name} pack {j}")
    for j, args in enumerate(fused):
        err = max(err, check_fused(*args, f"{name} fused launch {j}"))
    log(f"  {name}: {len(fams)} family launches, {len(packs)} packs, "
        f"{len(fused)} fused launches == plain, bit for bit")
    return err


def time_transposed_op(g, pa, st, tb, what):
    """One backward aggregation of an asymmetric Â on the table ``g``
    (``pspmm_tiles_transposed``): the whole op (halo-ᵀ family launch,
    reverse pack, fused local-ᵀ + owner sum) by CUDA events, each step
    alone, the plain version once (torch arithmetic), the library
    yardsticks summed (``torch.sparse.mm`` of the halo rows' Âᵀ, the
    ``torch.index_select`` of the reverse wire, ``torch.sparse.mm`` of the
    local rows' Âᵀ beside the owner sum) and the bound: the three steps'
    bytes at the card's memory rate."""
    import torch

    from sgcn_tpu_torch.ops.pspmm import reverse_exchange
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_plain
    from sgcn_tpu_torch.ops.tile_spmm import (pspmm_tiles_transposed,
                                              spmm_tiles_classes,
                                              spmm_tiles_classes_plain,
                                              spmm_tiles_fused_plain)

    tl, th, t1 = ([pa[f"ptile_t{x}{y}"] for y in ("src", "ld", "w")]
                  for x in ("l", "h", "1"))
    cls = (st["pallas_tlclasses"], st["pallas_thclasses"],
           st["pallas_t1classes"])
    send = spmm_tiles_classes(*th, g, cls[1], tb)
    rwire = reverse_exchange(send, pa["rev_src"], dtype=g.dtype)
    fam = time_k1([t.cpu().numpy() for t in th], th, g, cls[1], tb,
                  g.shape[1], f"{what} halo-T family launch")
    pack = time_pack(send, pa["rev_src"], g.dtype, f"{what} reverse pack")
    fused = time_fused(tl, g, t1, rwire, cls[0], cls[2], tb,
                       f"{what} fused local-T + owner sum")
    args = (g, tl, th, t1, pa["rev_src"], tb, *cls)
    with torch.inference_mode():
        op = cuda_ms(lambda: pspmm_tiles_transposed(*args))
    plain = cuda_ms(lambda: spmm_tiles_fused_plain(
        tl, g, t1, row_pack_plain(spmm_tiles_classes_plain(
            *th, g, cls[1], tb), pa["rev_src"], g.dtype), cls[0], cls[2],
        tb), reps=1, warmup=0)
    nbytes = fam["bytes"] + pack["bytes"] + fused["bytes"]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    parts = (fam["library_ms"], pack["library_ms"], fused["library_ms"])
    lib = None if None in parts else sum(parts)
    log(f"  {what}: whole op {op!r} ms (halo-T {fam['ms']!r} + pack "
        f"{pack['ms']!r} + fused {fused['ms']!r}); bound {bound!r} ms by "
        f"bytes ({nbytes} B), {100 * bound / op:.1f}% of bound; plain "
        f"{plain!r} ms; library (sparse.mm + index_select + sparse.mm) "
        f"{lib!r} ms")
    return {"ms": op, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": "bytes", "family": fam,
            "pack": pack, "fused": fused}


def phase_asymmetric(ahat_d, feats, labels, pv, widths, dev, tb, steps,
                     k3b):
    """Phases 19–21: the directed flagship graph (serving, training, the
    backward op's time, the bf16 levers).  Returns the launches per
    kernel entry on these main-path runs, the max |kernel − plain|, the
    trainers' initial weights and plan for the repeat phase."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import GatLayerGen
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesGen, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    n = ahat_d.shape[0]
    out = {"k1": 0, "k1_bf16": 0, "k5": 0, "fused": 0, "err": 0.0}

    def reset():
        for c in ("launches", "mask_launches", "bf16_launches",
                  "bf16_mask_launches"):
            setattr(spmm_tiles, c, 0)
        for c in ("launches", "wire_bf16_launches", "bf16_launches"):
            setattr(spmm_tiles_fused, c, 0)
        row_pack.launches = 0
        PspmmTilesGen.backward_launches = GatLayerGen.backward_launches = 0

    def counts():
        return {"k1": spmm_tiles.launches, "k1_bf16": spmm_tiles.bf16_launches,
                "k5": spmm_tiles.mask_launches
                + spmm_tiles.bf16_mask_launches,
                "fused": spmm_tiles_fused.launches,
                "fused_wire": spmm_tiles_fused.wire_bf16_launches,
                "fused_bf16": spmm_tiles_fused.bf16_launches,
                "pack": row_pack.launches,
                "gen_bwd": PspmmTilesGen.backward_launches,
                "gat_gen_bwd": GatLayerGen.backward_launches}

    def book(c):
        out["k1"] += c["k1"]
        out["k1_bf16"] += c["k1_bf16"]
        out["k5"] += c["k5"]
        out["fused"] += c["fused"] + c["fused_wire"] + c["fused_bf16"]
        MAIN_PATH_PACKS[0] += c["pack"]

    # ---------------------------------------------------------- phase 19
    log("phase 19: serve the directed flagship graph (asymmetric Â), GCN "
        f"and GAT 128 -> {' -> '.join(map(str, widths))}, a2a")
    reset()
    eng, _res, _l = serve_and_check(
        "directed flagship GCN", ahat_d, feats, pv, 8, widths, queries=512,
        max_batch=64, seed=3, check_rows=256)
    book(counts())
    plan = eng.plan
    log(f"  directed flagship plan: nnz {ahat_d.nnz}, B {plan.b}, S "
        f"{plan.s}, R {plan.r}, true halo rows {int(plan.halo_counts.sum())}"
        f", EL/EH per part {plan.el}/{plan.eh}, symmetric {plan.symmetric}; "
        f"transposed classes: local "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_tlclasses']]}, halo "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_thclasses']]}, "
        f"owner sum "
        f"{[c[:2] for c in eng.setup.fwd_static['pallas_t1classes']]}")
    if plan.symmetric or eng.setup.fwd_static.get("symmetric", True):
        raise AssertionError("the directed flagship plan came out symmetric")
    log_device_busy("directed flagship GCN", lambda: eng.query(np.arange(64)))
    reset()
    eng_g, _res_g, _l = serve_and_check(
        "directed flagship GAT", ahat_d, feats, pv, 8, widths, queries=512,
        max_batch=64, seed=3, check_rows=256, model="gat", plan=plan)
    book(counts())
    log_device_busy("directed flagship GAT",
                    lambda: eng_g.query(np.arange(64)))

    # ---------------------------------------------------------- phase 20
    log("phase 20: train the directed flagship graph, GCN and GAT, 1 "
        "warm-up + 5 timed steps; step-1 gradients vs a float64 backprop "
        "with Â^T, exact launches, every launch of one step == plain")
    data = make_train_data(plan, feats, labels, device=dev)
    tr = FullBatchTrainer(plan, fin=128, widths=widths, seed=5,
                          comm_schedule="a2a", device=dev)
    p_init = [w.detach().cpu().numpy().copy() for w in tr.params]
    zs, caught = forward_backward_trace(tr, data)
    masks = [plan.gather_rows((z > 0).cpu().numpy()) for z in zs[:-1]]
    t0 = time.perf_counter()
    loss64, _g64, _ = backprop64(ahat_d, feats, labels, p_init)
    _, grads64m, flips = backprop64(ahat_d, feats, labels, p_init,
                                    masks=masks)
    log(f"  float64 host backprop with A^T {time.perf_counter() - t0:.2f} s"
        f", loss {loss64!r}; ReLU sign flips by hidden layer: {flips}")
    loss0, _ = tr.evaluate(data)
    if abs(loss0 - loss64) > 1e-5 * abs(loss64):
        raise AssertionError(f"directed GCN initial loss {loss0} vs "
                             f"float64 {loss64}")
    step_grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: None if step_grads else
                                  step_grads.append([w.grad.cpu().numpy()
                                                     for w in tr.params]))
    reset()
    rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
    c = counts()
    book(c)
    nf, nb = len(widths), backward_passes(128, widths)
    want = {"fused": steps * (nf + nb), "pack": steps * (nf + nb),
            "k1": steps * nb, "gen_bwd": steps * nb}
    log(f"  GCN launches {json.dumps(c)}; expected {json.dumps(want)} "
        f"({steps} steps x ({nf} forward + {nb} backward aggregations); a "
        "backward: one K1 family, one pack, one fused)")
    if any(c[key] != v for key, v in want.items()) or c["k5"] \
            or c["fused_wire"] or c["fused_bf16"] or c["k1_bf16"]:
        raise AssertionError("directed GCN training: launch counts differ "
                             "from the passes the program runs")
    losses = [loss0] + rep["loss_history"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"directed GCN: non-finite loss {losses}")
    for i, (got, want_g) in enumerate(zip(step_grads[0], grads64m)):
        rel = float(np.linalg.norm(got - want_g) / np.linalg.norm(want_g))
        log(f"  GCN step-1 dW{i} {got.shape}: relative Frobenius error vs "
            f"float64 (A^T backward, the run's ReLU masks) {rel:.3g}")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"directed GCN layer {i} gradient off "
                                 f"float64 by {rel}")
    comm = {key: rep[key] for key in (
        "exchanges", "total_send_volume", "max_send_volume",
        "max_recv_volume", "wire_rows_per_exchange")}
    log(f"  GCN losses {losses}; epoch_s {rep['epoch_s']!r} (5 timed steps, "
        f"host clock); comm {json.dumps(comm)}")
    log(f"  GCN step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(tr, data))}")
    device_split("directed GCN training", lambda: tr.step(data))
    out["err"] = max(out["err"], check_launches(
        "directed GCN training pass",
        record_launches(lambda: gcn_train_pass(tr, data))))
    st, pa = tr.model.fwd_static, tr.pa
    out["op"] = time_transposed_op(data.h0, pa, st, tb, "directed flagship "
                                   "backward aggregation, layer-0 table "
                                   "f=128")
    log(f"  backward aggregation f=128: asymmetric {out['op']['ms']!r} ms "
        f"(bound {out['op']['bound_ms']!r}) vs the symmetric one (phase 5) "
        f"{k3b['ms']!r} ms (bound {k3b['bound_ms']!r})")
    fwd = time_whole_op(data.h0, pa, st, tb, False, "directed flagship "
                        "forward aggregation layer 0 f=128")
    out["fwd_op"] = fwd

    params_g = gat_params_numpy(7, list(zip([128] + widths[:-1], widths)))
    trg = FullBatchTrainer(plan, fin=128, widths=widths, model="gat",
                           activation="none", params=gat_from_numpy(params_g),
                           comm_schedule="a2a", device=dev)
    t0 = time.perf_counter()
    loss64_g, grads64_g = gat64(ahat_d, feats, params_g, labels=labels)
    log(f"  float64 host GAT autograd on the directed pattern "
        f"{time.perf_counter() - t0:.2f} s, loss {loss64_g!r}")
    loss0_g, _ = trg.evaluate(data)
    if abs(loss0_g - loss64_g) > 1e-5 * abs(loss64_g):
        raise AssertionError(f"directed GAT initial loss {loss0_g} vs "
                             f"float64 {loss64_g}")
    gsteps = []
    trg.opt.register_step_pre_hook(lambda opt, a, kw: None if gsteps else
                                   gsteps.append([
                                       {k: v.grad.cpu().numpy()
                                        for k, v in p.items()}
                                       for p in trg.params]))
    reset()
    rep_g = trg.fit(data, epochs=5, warmup=1, verbose=False)
    c = counts()
    book(c)
    fwd_p, tables = gat_passes(widths), gat_passes(widths)
    want = {"k5": steps * (fwd_p + tables),
            "pack": steps * (pack_launches("gat", "a2a", widths) + tables),
            "fused": steps * tables, "gat_gen_bwd": steps * tables}
    log(f"  GAT launches {json.dumps(c)}; expected {json.dumps(want)} "
        f"({steps} steps x forward {fwd_p} K5 passes and "
        f"{pack_launches('gat', 'a2a', widths)} packs, backward per "
        f"exchanged table ({tables}) one K5 pass, one pack, one fused)")
    if any(c[key] != v for key, v in want.items()) or c["k1"] \
            or c["k1_bf16"] or c["fused_wire"] or c["fused_bf16"]:
        raise AssertionError("directed GAT training: launch counts differ "
                             "from the passes the program runs")
    losses_g = [loss0_g] + rep_g["loss_history"]
    if not np.isfinite(losses_g).all():
        raise AssertionError(f"directed GAT: non-finite loss {losses_g}")
    for i, (got, want_g) in enumerate(zip(gsteps[0], grads64_g)):
        if got["a1"].any():
            raise AssertionError(f"directed GAT layer {i}: a1 gradient is "
                                 "not exactly 0")
        for key in ("w", "a2"):
            rel = float(np.linalg.norm(got[key] - want_g[key])
                        / np.linalg.norm(want_g[key]))
            log(f"  GAT step-1 d{key}{i} {got[key].shape}: relative "
                f"Frobenius error vs float64 autograd {rel:.3g}")
            if not rel <= GRAD_RTOL:
                raise AssertionError(f"directed GAT layer {i} d{key} off "
                                     f"float64 by {rel}")
    log(f"  GAT losses {losses_g}; epoch_s {rep_g['epoch_s']!r}")
    log(f"  GAT step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trg, data))}")
    device_split("directed GAT training", lambda: trg.step(data))
    out["err"] = max(out["err"], check_launches(
        "directed GAT training pass",
        record_launches(lambda: gat_train_pass(trg, data))))

    # ---------------------------------------------------------- phase 21
    log("phase 21: the directed flagship GCN under halo_dtype='bfloat16' "
        "and compute_dtype='bfloat16' from phase 20's initial weights: "
        "losses in the reference's bf16 band of the float32 run, exact "
        "launches, every launch of one step == plain")
    l32 = np.asarray(rep["loss_history"])
    for lever in ("halo_dtype", "compute_dtype"):
        trb = FullBatchTrainer(plan, fin=128, widths=widths, params=p_init,
                               comm_schedule="a2a", device=dev,
                               **{lever: "bfloat16"})
        reset()
        rep_b = trb.fit(data, epochs=5, warmup=1, verbose=False)
        c = counts()
        book(c)
        agg = steps * (nf + nb)
        want = ({"fused_wire": agg, "k1": steps * nb} if lever == "halo_dtype"
                else {"fused_bf16": agg, "k1_bf16": steps * nb})
        want.update(pack=agg, gen_bwd=steps * nb)
        l16 = np.asarray(rep_b["loss_history"])
        band = np.allclose(l16, l32, **BAND_GCN)
        log(f"  GCN {lever}: launches {json.dumps(c)}, expected "
            f"{json.dumps(want)}; losses {l16.tolist()} vs float32 "
            f"{l32.tolist()}: max |gap| {np.abs(l16 - l32).max():.3g}, in "
            f"the band {BAND_GCN}: {band}; epoch_s {rep_b['epoch_s']!r}")
        others = {"fused", "fused_wire", "fused_bf16", "k1", "k1_bf16",
                  "k5"} - set(want)
        if any(c[key] != v for key, v in want.items()) \
                or any(c[key] for key in others):
            raise AssertionError(f"directed GCN {lever}: launch counts "
                                 "differ from the passes the program runs")
        if not band or np.array_equal(l16, l32) \
                or not np.isfinite(l16).all():
            raise AssertionError(f"directed GCN {lever}: losses outside the "
                                 "band or equal to float32")
        out["err"] = max(out["err"], check_launches(
            f"directed GCN {lever} training pass",
            record_launches(lambda trb=trb: gcn_train_pass(trb, data))))
    out.update(plan=plan, data=data, p_init=p_init, params_g=params_g)
    return out


def phase_repeat(fix, dev, asym, widths):
    """Phase 22: the same training run repeated in one process
    (``tools/repeat_run.py``'s ``repeat_training``, fresh trainers from
    the same start): cora2708 GAT a2a (phase 9's configuration, 5 steps)
    20 times, the directed flagship GCN and GAT (phase 20's, 1 + 5 steps)
    3 times each.  Each must give exactly one loss history and one weight
    digest."""
    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.tools.repeat_run import repeat_training
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    plan_c = build_comm_plan(normalize_adjacency(a), read_partvec(
        os.path.join(fix, "cora2708.8.hp")), 8)
    data_c = make_train_data(plan_c, feats, labels, device=dev)
    plan, data = asym["plan"], asym["data"]
    cases = (
        ("cora2708 GAT a2a (phase 9)", 20, 5, data_c, lambda: FullBatchTrainer(
            plan_c, fin=1433, widths=[16, 7], model="gat",
            activation="none", seed=11, comm_schedule="a2a", device=dev)),
        ("directed flagship GCN", 3, 6, data, lambda: FullBatchTrainer(
            plan, fin=128, widths=widths, params=asym["p_init"],
            comm_schedule="a2a", device=dev)),
        ("directed flagship GAT", 3, 6, data, lambda: FullBatchTrainer(
            plan, fin=128, widths=widths, model="gat", activation="none",
            params=gat_from_numpy(asym["params_g"]), comm_schedule="a2a",
            device=dev)))
    for name, runs, steps, d, make in cases:
        t0 = time.perf_counter()
        rep = repeat_training(make, d, steps, runs)
        log(f"  {name}: {runs} runs of {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s: "
            f"{rep['distinct_loss_histories']} loss history(ies) "
            f"{[x['count'] for x in rep['loss_histories']]}, "
            f"{rep['distinct_weight_digests']} weight digest(s) "
            f"{[x['count'] for x in rep['weight_digests']]}; losses "
            f"{[float.fromhex(x) for x in rep['loss_histories'][0]['value']]}")
        if rep["distinct_loss_histories"] != 1 \
                or rep["distinct_weight_digests"] != 1:
            raise AssertionError(f"{name}: repeated runs differ: "
                                 f"{json.dumps(rep)}")


# ------------------------------- checkpoints, crash-safe resume, hot swap
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_ckpt")

# phase 23's training runs: (model, transport) by name; every one trains
# 6 steps in all from the CLI's default seed
CKPT_CASES = {"gcn-a2a": ("gcn", "a2a"), "gcn-ragged": ("gcn", "ragged"),
              "gat-a2a": ("gat", "a2a")}


def launch_counts(zero: bool = False) -> dict:
    """The launch counts of every kernel entry phases 23–33's paths run
    (and K1's float-weight family entries, which must stay 0 on the
    symmetric phases 23–29); with
    ``zero``, each is set to 0 first — the start of a path."""
    from sgcn_tpu_torch.models.gat import GatLayerGen, GatLayerSym
    from sgcn_tpu_torch.ops.row_shuffle import row_pack, row_pack_into
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesGenRanks,
                                              PspmmTilesRagged,
                                              PspmmTilesReplica,
                                              PspmmTilesStale,
                                              PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)

    owners = {"fused": (spmm_tiles_fused, "launches"),
              "fused_wire": (spmm_tiles_fused, "wire_bf16_launches"),
              "fused_bf16": (spmm_tiles_fused, "bf16_launches"),
              "stale_bwd": (PspmmTilesStale, "backward_launches"),
              "rep_bwd": (PspmmTilesReplica, "backward_launches"),
              "pack": (row_pack, "launches"),
              "pack_into": (row_pack_into, "launches"),
              "k5": (spmm_tiles, "mask_launches"),
              "k5_bf16": (spmm_tiles, "bf16_mask_launches"),
              "k1": (spmm_tiles, "launches"),
              "k1_bf16": (spmm_tiles, "bf16_launches"),
              "sym_bwd": (PspmmTilesSym, "backward_launches"),
              "gat_bwd": (GatLayerSym, "backward_launches"),
              "ring": (PspmmTilesRagged, "launches"),
              "ring_bwd": (PspmmTilesRagged, "backward_launches"),
              "gen_rank_bwd": (PspmmTilesGenRanks, "backward_launches"),
              "gat_gen_bwd": (GatLayerGen, "backward_launches")}
    if zero:
        for obj, attr in owners.values():
            setattr(obj, attr, 0)
    return {key: getattr(obj, attr) for key, (obj, attr) in owners.items()}


def cli_child(module, argv, fault, out_path):
    """One child process of phases 23 and 24, started with the ``spawn``
    context: ``python -m sgcn_tpu_torch.<module> argv`` in-process (its
    ``main``) under ``$SGCN_FAULT=fault`` (``None``: no fault), set here
    before the CLI builds anything.  When the CLI returns, writes its
    standard output, its JSON report (the last line, where it prints
    one), the warnings it raised, its launch counts and its clock marks
    to ``out_path``; a run the fault kills writes nothing."""
    t_enter = time.time()
    if fault:
        os.environ["SGCN_FAULT"] = fault
    else:
        os.environ.pop("SGCN_FAULT", None)
    sys.path.insert(0, REPO)
    import importlib
    import warnings

    import torch

    main = importlib.import_module(f"sgcn_tpu_torch.{module}.__main__").main
    launch_counts(zero=True)                 # this child's path starts here
    t_imported = time.time()
    out = io.StringIO()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(out):
        warnings.simplefilter("always")
        main(list(argv))
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    launches = launch_counts()                # ... and ends here
    text = out.getvalue()
    last = text.strip().splitlines()[-1] if text.strip() else ""
    with open(out_path, "w") as fh:
        json.dump({"stdout": text,
                   "report": json.loads(last) if last.startswith("{")
                   else None,
                   "warnings": [str(w.message) for w in caught],
                   "launches": launches, "t_enter": t_enter,
                   "t_imported": t_imported, "t_end": time.time()}, fh)


class Children:
    """Phases 23 and 24's child processes (``cli_child``): ``start``
    spawns one per job ``(module, argv, fault, out_path)``, all at once;
    ``join`` waits for them (a child alive past the deadline is
    terminated and fails the run); ``stop`` terminates whatever still
    runs, so no child outlives the script."""

    def __init__(self):
        import torch.multiprocessing as mp

        self.ctx = mp.get_context("spawn")
        self.running = []

    def start(self, jobs):
        procs = []
        for job in jobs:
            p = self.ctx.Process(target=cli_child, args=job)
            t = time.time()
            p.start()
            procs.append((p, t))
        self.running += [p for p, _ in procs]
        return procs

    def join(self, procs, timeout=600.0):
        deadline = time.monotonic() + timeout
        codes = []
        for p, _ in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                self.stop()
                raise AssertionError(f"child {p.pid} still runs "
                                     f"after {timeout:.0f} s")
            codes.append(p.exitcode)
        return codes

    def stop(self):
        for p in self.running:
            if p.is_alive():
                p.terminate()
                p.join()

    def close(self):
        self.stop()


def leaves_digest(leaves) -> str:
    """sha256 over a checkpoint leaf list's dtypes, shapes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for x in leaves:
        x = np.ascontiguousarray(x)
        h.update(repr((x.dtype.str, x.shape)).encode())
        h.update(x.tobytes())
    return h.hexdigest()[:16]


def leaves_equal(got, want) -> bool:
    """Two leaf lists equal array for array (dtype, shape and every
    element's bits; NaN == NaN): ``leaves_digest``'s verdict without its
    copies and hashing of every byte."""
    import numpy as np

    if len(got) != len(want):
        return False
    for x, y in zip(got, want):
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)):
            return False
    return True


def phase_checkpoints(plan, ahat, feats, labels, pv, widths, data, dev, smi,
                      on_inputs=None):
    """Phase 23: checkpoints, crash-safe resume and serving from a
    checkpoint at the flagship width (module docstring).  Returns the
    launch counts of its paths (this process's and the resumed
    children's) by kernel entry.  ``on_inputs()`` runs once the
    children's inputs are written (phases 25–26 start their children
    there)."""
    children = Children()
    try:
        return _phase_checkpoints(children, plan, ahat, feats, labels, pv,
                                  widths, data, dev, smi, on_inputs)
    finally:
        children.stop()


def _phase_checkpoints(children, plan, ahat, feats, labels, pv, widths,
                       data, dev, smi, on_inputs=None):
    import shutil
    import warnings

    import numpy as np
    import scipy.sparse as sp
    import torch

    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import balanced_random_partition
    from sgcn_tpu_torch.resilience import faults
    from sgcn_tpu_torch.resilience.checkpoint import CheckpointManager
    from sgcn_tpu_torch.serve import ServeEngine, synthetic_query_ids
    from sgcn_tpu_torch.serve.engine import CheckpointWatcher
    from sgcn_tpu_torch.train import FullBatchTrainer
    from sgcn_tpu_torch.train.fullbatch import MODELS
    from sgcn_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint, to_leaves)

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    n, fin = feats.shape
    t0 = time.perf_counter()
    npz = os.path.join(CKPT_DIR, "flagship.npz")
    a = sp.csr_matrix(ahat)
    np.savez(npz, adj_data=a.data, adj_indices=a.indices,
             adj_indptr=a.indptr, adj_shape=np.asarray(a.shape),
             attr_matrix=feats, labels=np.asarray(labels))
    parts = os.path.join(CKPT_DIR, "flagship.8.rp")
    np.savetxt(parts, pv, fmt="%d")
    log(f"  inputs for the children (Â as normalized, features, labels, "
        f"parts) written in {time.perf_counter() - t0:.2f} s")
    if on_inputs is not None:
        on_inputs()
    base = ["--npz", npz, "-p", parts, "-s", "8", "-l", str(len(widths)),
            "--hidden", str(widths[0]), "--warmup", "0", "--epochs", "6",
            "--device", "cuda"]
    argv, jobs, resumes = {}, [], []
    for case, (model, sched) in CKPT_CASES.items():
        argv[case] = base + ["--model", model, "--comm-schedule", sched,
                             "--checkpoint-dir", os.path.join(CKPT_DIR, case),
                             "--checkpoint-every", "3"]
        jobs.append(("train", argv[case], "kill-after-save:3",
                     os.path.join(CKPT_DIR, f"{case}.kill.json")))
    argv["bitflip"] = base + ["--comm-schedule", "a2a", "--checkpoint-dir",
                              os.path.join(CKPT_DIR, "bitflip"),
                              "--checkpoint-every", "2"]
    jobs.append(("train", argv["bitflip"], "corrupt-after-save:4:bitflip",
                 os.path.join(CKPT_DIR, "bitflip.kill.json")))
    names = list(CKPT_CASES) + ["bitflip"]

    # ---- (a) 4 children killed after a save, while this process trains
    # the same runs uninterrupted (6 steps from the CLI's seed 0); the
    # a2a GCN also writes the hot-swap directory at steps 4 and 6
    launch_counts(zero=True)                  # the phase's path starts here
    wave = children.start(jobs)
    hot = os.path.join(CKPT_DIR, "hot")
    q = synthetic_query_ids(n, 256, seed=7)
    full, hot_rows = {}, {}
    for case, (model, sched) in CKPT_CASES.items():
        tr = FullBatchTrainer(plan, fin=fin, widths=widths, model=model,
                              activation=MODELS[model].activation, seed=0,
                              comm_schedule=sched, device=dev)
        losses = []
        for step in range(1, 7):
            losses.append(tr.step(data))
            if case == "gcn-a2a" and step in (4, 6):
                CheckpointManager(hot).save(tr, step)
                hot_rows[step] = tr.predict(data)[q]
        full[case] = (tr, losses)
        log(f"  {case}: uninterrupted losses {losses}")
    codes = children.join(wave)
    listing = {c: sorted(os.listdir(os.path.join(CKPT_DIR, c)))
               for c in names}
    log(f"  killed children: exit codes {dict(zip(names, codes))}, "
        f"directories {listing}")
    if codes != [faults.FAULT_EXIT_CODE] * len(jobs):
        raise AssertionError(f"phase 23: killed children exited {codes}, "
                             f"expected {faults.FAULT_EXIT_CODE} each")
    want_ls = {c: ["ckpt_00000003.npz"] for c in CKPT_CASES}
    want_ls["bitflip"] = ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    if listing != want_ls:
        raise AssertionError(f"phase 23: checkpoint directories {listing}")

    # ---- a new process per killed run: --resume auto to 6 steps
    for case in names:
        resumes.append(("train", argv[case] + [
            "--resume", "auto", "--save-checkpoint",
            os.path.join(CKPT_DIR, f"{case}.final.npz")], None,
            os.path.join(CKPT_DIR, f"{case}.resume.json")))
    wave = children.start(resumes)
    codes = children.join(wave)
    if codes != [0] * len(resumes):
        raise AssertionError(f"phase 23: resumed children exited {codes}")
    child_launches = {}
    for (p, t_spawn), case in zip(wave, names):
        with open(os.path.join(CKPT_DIR, f"{case}.resume.json")) as fh:
            res = json.load(fh)
        rep = res["report"]
        model, _ = CKPT_CASES.get(case, ("gcn", "a2a"))
        tr, losses = full[case if case in CKPT_CASES else "gcn-a2a"]
        start = 2 if case == "bitflip" else 3
        setup_s = res["t_end"] - res["t_imported"] - rep["elapsed_s"]
        log(f"  {case}: resumed at step {rep['resumed']['step']} "
            f"(fallback {rep['resumed']['fallback']}), losses "
            f"{rep['losses']}; child start-up {res['t_enter'] - t_spawn:.2f}"
            f" s interpreter + {res['t_imported'] - res['t_enter']:.2f} s "
            f"imports + {setup_s:.2f} s inputs, plan, trainer, resume load "
            f"and final save; training {rep['elapsed_s']:.3f} s "
            f"({rep['steps_run']} steps, step_s_wall "
            f"{rep['step_s_wall']:.4f} s); 4 children at once; card: {smi}")
        if rep["resumed"]["step"] != start or rep["losses"] != losses[start:]:
            raise AssertionError(f"phase 23 {case}: resumed losses "
                                 f"{rep['losses']} != uninterrupted "
                                 f"{losses[start:]}")
        if case == "bitflip" and not (rep["resumed"]["fallback"] and any(
                "ckpt_00000004.npz" in w and "falling back" in w
                for w in res["warnings"])):
            raise AssertionError(f"phase 23: no fallback warning past the "
                                 f"corrupt step-4 file: {res['warnings']}")
        with np.load(os.path.join(CKPT_DIR, f"{case}.final.npz")) as z:
            got = [z[f"leaf_{i}"] for i in range(
                sum(f.startswith("leaf_") for f in z.files))]
            state = json.loads(str(z["__train_state__"]))
        want = to_leaves(tr.params, tr.opt)
        d_got, d_want = leaves_digest(got), leaves_digest(want)
        log(f"  {case}: weights + Adam state digest resumed {d_got}, "
            f"uninterrupted {d_want}; step_count {state['step_count']}")
        if d_got != d_want or state["step_count"] != 6 or \
                state["comm_stats"]["exchanges"] != 6 * 2 * len(widths):
            raise AssertionError(f"phase 23 {case}: the resumed state "
                                 "differs from the uninterrupted run's")
        ln = res["launches"]
        # GAT: K5 passes and packs; GCN: packs and fused launches,
        # through the ring's Function or the a2a one
        need = (["pack", "k5", "gat_bwd"] if model == "gat" else
                ["pack", "fused"] + (["ring", "ring_bwd"] if "ragged" in case
                                     else ["sym_bwd"]))
        if any(not ln[key] for key in need) or ln["k1"] or ln["k1_bf16"]:
            raise AssertionError(f"phase 23 {case}: child launches {ln}")
        child_launches[case] = ln

    # ---- (b) serve from the step-6 files the resumed children wrote
    for case in ("gcn-a2a", "gat-a2a"):
        model = CKPT_CASES[case][0]
        path = os.path.join(CKPT_DIR, case, "ckpt_00000006.npz")
        tr = full[case][0]
        eng = ServeEngine(plan, fin=fin, widths=widths, model=model,
                          comm_schedule="a2a", checkpoint=path,
                          max_batch=64, device=dev)
        eng.set_features(feats)
        rows = np.concatenate([eng.query(q[i:i + 64])
                               for i in range(0, len(q), 64)])
        pred = tr.predict(data)[q]
        params = [{k: v.detach().cpu().numpy() for k, v in p.items()}
                  if isinstance(p, dict) else p.detach().cpu().numpy()
                  for p in tr.params]
        want = (gat64(ahat, feats, params) if model == "gat"
                else oracle_forward(ahat, feats, params))[q]
        err = np.abs(rows - want)
        log(f"  {case}: engine from the step-6 file, {len(q)} rows: == "
            f"the trainer's predict rows {np.array_equal(rows, pred)}; vs "
            f"float64 max abs err {err.max():.3g}, max rel err "
            f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3g}")
        if not np.array_equal(rows, pred):
            raise AssertionError(f"phase 23 {case}: served rows differ from "
                                 "the trainer's predict rows")
        if not np.allclose(rows, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"phase 23 {case}: served rows differ from "
                                 f"float64 beyond rtol {RTOL}, atol {ATOL}")
        del eng
    path = os.path.join(CKPT_DIR, "gcn-a2a", "ckpt_00000006.npz")
    t0 = time.perf_counter()
    plan2 = build_comm_plan(ahat, balanced_random_partition(n, 8, seed=1), 8)
    log(f"  another part vector's plan built in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    for what, p_, w_, msg in (
            ("part vector", plan2, widths,
             "plan digest mismatch — checkpoint was saved under plan"),
            ("widths", plan, [widths[0], 64, widths[-1]],
             "model config mismatch on 'widths'")):
        try:
            ServeEngine(p_, fin=fin, widths=w_, checkpoint=path, device=dev)
        except ValueError as e:
            if msg not in str(e):
                raise
            log(f"  refused under another {what}: {str(e)[:90]}...")
        else:
            raise AssertionError(f"phase 23: a checkpoint under another "
                                 f"{what} was not refused")

    # ---- (c) hot swap on a random-weight engine
    eng = ServeEngine(plan, fin=fin, widths=widths, comm_schedule="a2a",
                      seed=11, max_batch=64, device=dev)
    eng.set_features(feats)
    rows_r = eng.query(q[:64])
    init = [p.detach().cpu().numpy() for p in eng.model.layer_params()]
    if not np.allclose(rows_r, oracle_forward(ahat, feats, init)[q[:64]],
                       rtol=RTOL, atol=ATOL):
        raise AssertionError("phase 23: random-weight rows differ from "
                             "float64")
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    watch = eng.attach_checkpoint_watch(hot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swapped = watch.poll(eng)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    rows = eng.query(q[:64])
    ok = (swapped and eng.weights_rev == 1 and np.array_equal(
        rows, hot_rows[6][:64])
        and [p.data_ptr() for p in eng.model.parameters()] == ptrs)
    log(f"  hot swap: one poll + swap of the step-6 file "
        f"{swap_ms:.2f} ms wall; weights_rev {eng.weights_rev}, rows == "
        f"the trainer's {np.array_equal(rows, hot_rows[6][:64])}, storage "
        f"kept {[p.data_ptr() for p in eng.model.parameters()] == ptrs}; "
        f"card: {smi}")
    if not ok:
        raise AssertionError("phase 23: hot swap failed")
    bad = os.path.join(CKPT_DIR, "hot_corrupt")
    shutil.copytree(hot, bad)
    faults.corrupt_file(os.path.join(bad, "ckpt_00000006.npz"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        swapped = CheckpointWatcher(bad).poll(eng)
    rows = eng.query(q[:64])
    warned = any("corrupt" in str(w.message) for w in caught)
    log(f"  corrupt newest file: swapped {swapped}, warned {warned}, now "
        f"step {eng.checkpoint_meta['step']}, weights_rev "
        f"{eng.weights_rev}, rows == the trainer's step-4 rows "
        f"{np.array_equal(rows, hot_rows[4][:64])}")
    if not (swapped and warned and eng.checkpoint_meta["step"] == 4
            and eng.weights_rev == 2
            and np.array_equal(rows, hot_rows[4][:64])
            and [p.data_ptr() for p in eng.model.parameters()] == ptrs):
        raise AssertionError("phase 23: the poll did not skip the corrupt "
                             "newest file")
    del eng

    # ---- (d) the flagship checkpoint's save and load on the card
    for case in ("gcn-a2a", "gat-a2a"):
        tr = full[case][0]
        path = os.path.join(CKPT_DIR, f"timing_{case}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(tr, path, step=6)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        load_checkpoint(tr, path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        log(f"  {case} flagship checkpoint: {os.path.getsize(path)} bytes, "
            f"save {save_ms:.2f} ms, load {load_ms:.2f} ms wall; card: {smi}")
    parent = launch_counts()                  # ... and ends here
    if parent["k1"] or parent["k1_bf16"]:
        raise AssertionError(f"phase 23: K1 family launches {parent}")
    total = {key: parent[key] + sum(ln[key] for ln in child_launches.values())
             for key in parent}
    log(f"  phase 23 launches (this process {parent}, resumed children "
        f"{child_launches}); phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


# ------------------------- the offline pipeline: prep, partition, the files
PIPE_DIR = os.path.join(REPO, "build", "chip_smoke_pipeline")
# the DCSBM flagship's partitions: k parts, the partition CLI's seed
PART_K, PART_SEED = 8, 1
# phase 27's mini-batch configuration: the reference's SHP → mini-batch
# run (scripts/shp_minibatch_reddit.py: batch 4096, 100 sampled batches,
# 20 simulation iterations, seed 1)
MB_BATCH, SHP_SAMPLED, SHP_SIM = 4096, 100, 20
MB_DIR = os.path.join(REPO, "build", "chip_smoke_minibatch")
# threads and pools that must not outlive the script (closed at exit)
BACKGROUND = []


class FlagshipPartitions:
    """Phase 24's hp and gp partitions of the DCSBM flagship graph, each
    twice (the determinism check), and phase 27's SHP pipeline
    (``shp.run_shp``: the hp partition once more, the stochastic
    hypergraph of ``SHP_SAMPLED`` batches of ``MB_BATCH`` and its
    partition, the simulated batch volumes), on two host threads started
    after phase 0, so that their host seconds pass beside the card's
    phases 1–23 (the native calls release the interpreter lock).
    ``result`` waits for the four partitions and ``shp_result`` for the
    SHP run, each re-raising a failure; ``close`` cancels what has not
    started."""

    def __init__(self, ahat, k, seed):
        from concurrent.futures import ThreadPoolExecutor

        self.pool = ThreadPoolExecutor(max_workers=2,
                                       thread_name_prefix="partition")
        self.futures = {(mode, rep): self.pool.submit(
            self._run, ahat, mode, k, seed)
            for mode in ("hp", "gp") for rep in (0, 1)}
        self.shp = self.pool.submit(self._shp, ahat, k, seed)
        BACKGROUND.append(self)

    @staticmethod
    def _shp(ahat, k, seed):
        from sgcn_tpu_torch.shp import run_shp

        t0, c0 = time.perf_counter(), time.thread_time()
        res = run_shp(ahat, k, nsampled_batches=SHP_SAMPLED,
                      batch_size=MB_BATCH, sim_iters=SHP_SIM, seed=seed)
        return res, time.perf_counter() - t0, time.thread_time() - c0

    def shp_result(self):
        return self.shp.result()

    @staticmethod
    def _run(ahat, mode, k, seed):
        from sgcn_tpu_torch.partition import (partition_graph,
                                              partition_hypergraph_colnet)

        fn = partition_hypergraph_colnet if mode == "hp" else partition_graph
        t0, c0 = time.perf_counter(), time.thread_time()
        pv, metric = fn(ahat, k, seed=seed)
        return pv, metric, time.perf_counter() - t0, time.thread_time() - c0

    def result(self):
        return {key: f.result() for key, f in self.futures.items()}

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)


def check_partvec(pv, n, k, what):
    """A part vector is complete: n entries, every one in [0, k), every
    part non-empty."""
    import numpy as np

    if not (pv.shape == (n,) and pv.min() >= 0 and pv.max() < k
            and len(np.unique(pv)) == k):
        raise AssertionError(f"{what}: part vector incomplete (shape "
                             f"{pv.shape}, ids {pv.min()}..{pv.max()}, "
                             f"{len(np.unique(pv))} parts of {k})")


def edge_cut(a, pv):
    """The graph partitioner's objective recounted in numpy: edges of the
    symmetrized unit pattern, diagonal dropped, whose ends lie in two
    parts."""
    import scipy.sparse as sp

    pat = sp.csr_matrix(a, copy=True)
    pat.data[:] = 1.0
    sym = sp.triu(pat + pat.T, k=1).tocoo()
    return int((pv[sym.row] != pv[sym.col]).sum())


def km1_count(a, pv, k):
    """The hypergraph partitioner's objective recounted in numpy: Σ over
    the columns (nets) of (parts among the column's rows − 1)."""
    import numpy as np
    import scipy.sparse as sp

    c = sp.csc_matrix(a)
    cols = np.repeat(np.arange(c.shape[1], dtype=np.int64), np.diff(c.indptr))
    pairs = np.unique(cols * k + pv[c.indices])
    lam = np.bincount(pairs // k, minlength=c.shape[1])
    return int(np.maximum(lam - 1, 0).sum())


def phase_pipeline(parts_bg, ahat_dc, fix, dev, tb, smi):
    """Phase 24 (module docstring): the cora CLI pipeline, then the
    DCSBM flagship on its hp, gp and rp parts, all in this process.
    Returns the launch counts of its paths by kernel entry, the fused
    entry's max |kernel − plain| on the hp plan and K3's layer-0 times
    there (``time_whole_op``; phase 30 reads them)."""
    cora = _pipeline_cora_clis(fix, smi)
    flag, fused_err, k3_hp = _pipeline_flagship(parts_bg, ahat_dc, dev, tb,
                                                smi)
    return {key: cora[key] + flag[key] for key in flag}, fused_err, k3_hp


def _pipeline_cora_clis(fix, smi):
    import shutil

    import numpy as np

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.io.mtx import read_mtx, write_mtx
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec

    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    os.makedirs(PIPE_DIR)
    a, _, _ = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    raw = os.path.join(PIPE_DIR, "cora2708.mtx")
    write_mtx(raw, a)
    amtx = os.path.join(PIPE_DIR, "cora.A.mtx")
    total = {key: 0 for key in launch_counts()}

    def run(jobs):
        # each CLI's main in this process, one job after another (a child
        # would add ≈ 11 s of start-up; the cora train and serve runs
        # take 1-3 s each)
        out = {}
        for name, module, argv in jobs:
            path = os.path.join(PIPE_DIR, f"{name}.json")
            cli_child(module, argv, None, path)
            with open(path) as fh:
                res = json.load(fh)
            for key in total:
                total[key] += res["launches"][key]
            log(f"  {name} in this process: start-up "
                f"{res['t_imported'] - res['t_enter']:.2f} s, in the CLI "
                f"{res['t_end'] - res['t_imported']:.2f} s")
            out[name] = res
        return out

    # ---- python -m sgcn_tpu_torch.prep on the raw adjacency
    res = run([("prep", "prep", ["-a", raw, "-o", PIPE_DIR, "-n", "cora",
                                 "-l", "2", "-f", "16", "-c", "7"])])["prep"]
    log(f"  prep: {res['stdout'].strip()}")
    if res["stdout"] != (f"wrote cora.A/H/Y.mtx + config (n=2708, "
                         f"widths=[16, 7]) to {PIPE_DIR}\n"):
        raise AssertionError(f"phase 24: prep printed {res['stdout']!r}")

    # ---- python -m sgcn_tpu_torch.partition -k 8 -m hp,gp,rp on Â
    res = run([("partition", "partition",
                ["-a", amtx, "-k", "8", "-m", "hp,gp,rp"])])["partition"]
    lines = res["stdout"].strip().splitlines()
    ahat = read_mtx(amtx)
    sent = {}
    for mode, line in zip(("hp", "gp", "rp"), lines):
        log(f"  partition: {line}")
        path = f"{amtx}.8.{mode}"
        pv = read_partvec(path)
        check_partvec(pv, 2708, 8, f"cora {mode}")
        fields = dict(tok.split("=") for tok in line.split()[2:])
        key, want = {"hp": ("km1", km1_count(ahat, pv, 8)),
                     "gp": ("edgecut", edge_cut(ahat, pv)),
                     "rp": ("none", -1)}[mode]
        if not line.startswith(f"{mode}: {path}  ") \
                or int(fields[key]) != want \
                or int(fields["max_part"]) != np.bincount(pv).max():
            raise AssertionError(f"phase 24: cora {mode} line {line!r}, "
                                 f"numpy recount {key}={want}")
        sent[mode] = int(build_comm_plan(ahat, pv, 8)
                         .predicted_send_volume.sum())
    log(f"  cora rows sent per exchange by part vector: {sent}")
    if len(lines) != 3 or not (sent["hp"] < sent["rp"]
                               and sent["gp"] < sent["rp"]):
        raise AssertionError(f"phase 24: cora partitions {lines}, {sent}")

    # ---- train (both transports) and serve on the files, in this process
    files = ["-a", amtx, "-p", f"{amtx}.8.hp", "-s", "8", "--features-mtx",
             os.path.join(PIPE_DIR, "cora.H.mtx"), "-l", "2", "--hidden",
             "16", "--device", "cuda"]
    train = files + ["--labels-mtx", os.path.join(PIPE_DIR, "cora.Y.mtx"),
                     "--epochs", "5", "--warmup", "1"]
    jobs = [(f"train-{s}", "train", train + [
        "--comm-schedule", s, "--save-checkpoint",
        os.path.join(PIPE_DIR, f"{s}.npz")]) for s in ("a2a", "ragged")]
    jobs.append(("serve", "serve", files + [
        "--random-init", "--classes", "7", "--queries", "256",
        "--max-batch", "32", "--comm-schedule", "a2a"]))
    res = run(jobs)
    steps, bwd = 6, backward_passes(1, [16, 7])
    want = steps * (2 + bwd)
    losses, leaves = {}, {}
    for sched in ("a2a", "ragged"):
        r = res[f"train-{sched}"]
        ln, rep = r["launches"], r["report"]
        losses[sched] = [float(x.split()[-1]) for x in r["stdout"].splitlines()
                         if x.startswith("epoch ")]
        with np.load(os.path.join(PIPE_DIR, f"{sched}.npz")) as z:
            leaves[sched] = [z[f"leaf_{i}"] for i in range(
                sum(f.startswith("leaf_") for f in z.files))]
        ring = ln["ring"] + ln["ring_bwd"]
        log(f"  train {sched}: losses {losses[sched]}, epoch_s "
            f"{rep['epoch_s']!r}, wire rows {rep['wire_rows_per_exchange']}; "
            f"fused {ln['fused']} (backward {ln['sym_bwd']}, ring "
            f"{ring}), row pack {ln['pack']}; expected {want} = {steps} "
            f"steps x (2 + {bwd})")
        if (rep["comm_schedule"] != sched or len(losses[sched]) != 5
                or not np.isfinite(losses[sched]).all()
                or ln["fused"] != want or ln["pack"] != want
                or (ring != want if sched == "ragged"
                    else ln["sym_bwd"] != steps * bwd)
                or ln["k1"] or ln["k1_bf16"]):
            raise AssertionError(f"phase 24: cora train {sched}: {rep}, "
                                 f"launches {ln}")
    same = losses["a2a"] == losses["ragged"] and len(leaves["a2a"]) == len(
        leaves["ragged"]) and all(np.array_equal(x, y) for x, y in zip(
            leaves["a2a"], leaves["ragged"]))
    log(f"  ragged == a2a on the cora hp files (losses, weights + Adam "
        f"state after 6 steps): {same}")
    if not same:
        raise AssertionError("phase 24: cora ragged training != a2a")
    r = res["serve"]
    rep, ln = r["report"], r["launches"]
    log(f"  serve (random init): {rep['queries']} queries, "
        f"{rep['achieved_qps']} QPS, p50 {rep['latency_p50_ms']} ms, p99 "
        f"{rep['latency_p99_ms']} ms, {rep['forwards']} forwards; fused "
        f"{ln['fused']}, row pack {ln['pack']} (expected forwards x 2)")
    if (rep["queries"] != 256 or rep["weights"] != "random-init"
            or rep["comm_schedule"] != "a2a"
            or not np.isfinite([rep["latency_p50_ms"],
                                rep["latency_p99_ms"]]).all()
            or ln["fused"] != 2 * rep["forwards"] or ln["pack"] != ln["fused"]
            or ln["k1"] or ln["k1_bf16"]):
        raise AssertionError(f"phase 24: cora serve {rep}, launches {ln}")
    log(f"  cora CLI pipeline launches {total}; card: {smi}")
    return total


def _pipeline_flagship(parts_bg, ahat_dc, dev, tb, smi):
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.pspmm import exchange_recv
    from sgcn_tpu_torch.parallel import build_comm_plan, resolve_comm_schedule
    from sgcn_tpu_torch.partition import balanced_random_partition
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    n, k = ahat_dc.shape[0], PART_K
    t0 = time.perf_counter()
    res = parts_bg.result()
    log(f"  the partitions' threads: {time.perf_counter() - t0:.2f} s "
        "waited for them here")
    pvs = {}
    for mode, name in (("hp", "km1"), ("gp", "edgecut")):
        (pv, metric, wall, cpu), (pv2, metric2, wall2, cpu2) = \
            res[(mode, 0)], res[(mode, 1)]
        check_partvec(pv, n, k, f"DCSBM {mode}")
        recount = km1_count(ahat_dc, pv, k) if mode == "hp" \
            else edge_cut(ahat_dc, pv)
        log(f"  {mode}: {name}={metric} (numpy recount {recount}); "
            f"partition host seconds {wall!r} and {wall2!r} wall, "
            f"{cpu!r} and {cpu2!r} thread CPU (two runs, two threads beside "
            "phases 1-23); the second run's vector == the first's: "
            f"{np.array_equal(pv, pv2)}")
        if metric != recount or metric2 != metric \
                or not np.array_equal(pv, pv2):
            raise AssertionError(f"phase 24: DCSBM {mode} partition")
        pvs[mode] = pv
    pvs["rp"] = balanced_random_partition(n, k, PART_SEED)
    plans, sent = {}, {}
    for mode, pv in pvs.items():
        t0 = time.perf_counter()
        plan = build_comm_plan(ahat_dc, pv, k)
        t_plan = time.perf_counter() - t0
        decision = {}
        pick = resolve_comm_schedule("auto", [plan], "gcn", decision)
        sizes = np.bincount(pv, minlength=k)
        sent[mode] = int(plan.predicted_send_volume.sum())
        log(f"  {mode}: B {plan.b} S {plan.s} R {plan.r}; true halo rows "
            f"{sent[mode]}, a2a wire rows {plan.wire_rows_per_exchange('a2a')}"
            f" (efficiency {plan.padding_efficiency():.3f}), ring wire rows "
            f"{plan.wire_rows_per_exchange('ragged')}; auto -> {pick}; part "
            f"sizes {sizes.min()}..{sizes.max()} (B {plan.b / (n / k):.4f} x "
            f"the mean); plan built in {t_plan:.2f} s (host)")
        plans[mode] = plan
    if not (sent["hp"] < sent["rp"] and sent["gp"] < sent["rp"]):
        raise AssertionError(f"phase 24: hp/gp send no less than rp: {sent}")

    feats = np.random.default_rng(2).standard_normal((n, 128)).astype(
        np.float32)
    labels = np.random.default_rng(4).integers(0, 40, n)
    widths = [128, 128, 40]
    steps, bwd = 1 + 5, backward_passes(128, widths)
    want = steps * (len(widths) + bwd)
    total = {key: 0 for key in launch_counts()}

    def counted(run):
        launch_counts(zero=True)               # a main-path run starts here
        out = run()
        torch.cuda.synchronize()
        ln = launch_counts()                   # ... and ends here
        for key in total:
            total[key] += ln[key]
        if ln["k1"] or ln["k1_bf16"]:
            raise AssertionError(f"phase 24: K1 family launches {ln}")
        return out, ln

    # ---- GCN: 1 warm-up + 5 timed steps, a2a and the ring, hp and rp
    datas, gcn = {}, {}
    for mode in ("hp", "rp"):
        datas[mode] = data = make_train_data(plans[mode], feats, labels,
                                             device=dev)
        for sched in ("a2a", "ragged"):
            tr = FullBatchTrainer(plans[mode], fin=128, widths=widths, seed=5,
                                  comm_schedule=sched, device=dev)
            rep, ln = counted(lambda: tr.fit(data, epochs=5, warmup=1,
                                             verbose=False))
            ring = ln["ring"] + ln["ring_bwd"]
            log(f"  GCN {mode} {sched}: epoch_s {rep['epoch_s']!r}, losses "
                f"{rep['loss_history']}; fused {ln['fused']} (backward "
                f"{ln['sym_bwd']}, ring {ring}), row pack {ln['pack']}; "
                f"expected {want}")
            if (ln["fused"] != want or ln["pack"] != want
                    or (ring != want if sched == "ragged"
                        else ln["sym_bwd"] != steps * bwd)
                    or not np.isfinite(rep["loss_history"]).all()):
                raise AssertionError(f"phase 24: GCN {mode} {sched}")
            gcn[(mode, sched)] = (tr, rep, [w.detach().clone()
                                            for w in tr.params])
        (_, ra, wa), (_, rr, wr) = gcn[(mode, "a2a")], gcn[(mode, "ragged")]
        same = ra["loss_history"] == rr["loss_history"] and all(
            torch.equal(x, y) for x, y in zip(wa, wr))
        log(f"  GCN {mode}: ragged == a2a bit for bit (losses, weights after "
            f"the 6 steps): {same}")
        if not same:
            raise AssertionError(f"phase 24: GCN {mode} ragged != a2a")
    split = {mode: device_split(f"DCSBM {mode} GCN a2a training",
                                lambda: gcn[(mode, "a2a")][0].step(
                                    datas[mode]), reps=3)
             for mode in ("hp", "rp")}

    # ---- GAT a2a: 1 warm-up + 5 timed steps, hp and rp
    params_g = gat_params_numpy(7, list(zip([128] + widths[:-1], widths)))
    want_g = steps * 2 * gat_passes(widths)
    want_pg = steps * 2 * pack_launches("gat", "a2a", widths)
    gat = {}
    for mode in ("hp", "rp"):
        trg = FullBatchTrainer(plans[mode], fin=128, widths=widths,
                               model="gat", activation="none",
                               params=gat_from_numpy(params_g),
                               comm_schedule="a2a", device=dev)
        rep, ln = counted(lambda: trg.fit(datas[mode], epochs=5, warmup=1,
                                          verbose=False))
        log(f"  GAT {mode} a2a: epoch_s {rep['epoch_s']!r}, losses "
            f"{rep['loss_history']}; K5 {ln['k5']} (backward "
            f"{ln['gat_bwd']}), row pack {ln['pack']}; expected {want_g}, "
            f"{want_pg}")
        if (ln["k5"] != want_g or ln["gat_bwd"] != want_g // 2
                or ln["pack"] != want_pg
                or not np.isfinite(rep["loss_history"]).all()):
            raise AssertionError(f"phase 24: GAT {mode}")
        gat[mode] = rep

    # ---- GCN serving: 512 closed-loop queries at batch 64, hp and rp
    serve = {}
    for mode in ("hp", "rp"):
        launch_counts(zero=True)
        eng, result, launches = serve_and_check(
            f"DCSBM {mode}", ahat_dc, feats, pvs[mode], k, widths,
            queries=512, max_batch=64, seed=3, check_rows=256,
            plan=plans[mode])
        total["fused"] += launches     # drive_serving books its packs
        ln = launch_counts()
        if ln["k1"] or ln["k1_bf16"]:
            raise AssertionError(f"phase 24: K1 family launches {ln}")
        serve[mode] = (eng, result.summary())

    # ---- the fused entry == plain on one hp-plan layer, with the hub rows
    eng = serve["hp"][0]
    pa, st, h0 = eng.pa, eng.setup.fwd_static, eng._h0
    recv = exchange_recv(h0, pa["recv_src"])
    check_pack(h0, pa["recv_src"], h0.dtype, "DCSBM hp layer-0 exchange")
    fused_err = check_fused(
        [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]], h0,
        [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]], recv,
        st["pallas_lclasses"], st["pallas_hclasses"], tb,
        "DCSBM hp layer-0 fused f=128")
    # the hub rows are in that layer: the longest row's slots, local and
    # halo, are all in the plan's edge lists, and every edge is in a tile
    plan = plans["hp"]
    row_nnz = np.diff(ahat_dc.indptr)
    hub = int(np.argmax(row_nnz))
    p, r = int(plan.owner[hub]), int(plan.local_idx[hub])
    lc, hc = int(plan.lnnz[p]), int(plan.hnnz[p])
    local = int((plan.ledge_dst[p, :lc] == r).sum())
    halo = int((plan.hedge_dst[p, :hc] == r).sum())
    tiled = all(int((plan.ptile_lw[q] != 0).sum()) == int(plan.lnnz[q]) and
                int((plan.ptile_hw[q] != 0).sum()) == int(plan.hnnz[q])
                for q in range(k))
    log(f"  the longest row of Â (vertex {hub}, {row_nnz[hub]} slots) in "
        f"the hp plan: part {p}, {local} local + {halo} halo slots; every "
        f"edge in a tile: {tiled}")
    if local + halo != row_nnz[hub] or not tiled:
        raise AssertionError("phase 24: the hp tiles do not hold the "
                             "longest row")
    # the plain versions (≈ 9 s a plan) on the hp plan alone: phase 30
    # reads its K3 times; rp's kernel times are for the ratios below
    k3 = {mode: time_whole_op(e._h0, e.pa, e.setup.fwd_static, tb, False,
                              f"DCSBM {mode} K3 layer 0 forward f=128",
                              plain=mode == "hp")
          for mode, (e, _) in serve.items()}

    # ---- hp against rp
    ratio = {
        "GCN a2a epoch_s": gcn[("hp", "a2a")][1]["epoch_s"]
        / gcn[("rp", "a2a")][1]["epoch_s"],
        "GCN ring epoch_s": gcn[("hp", "ragged")][1]["epoch_s"]
        / gcn[("rp", "ragged")][1]["epoch_s"],
        "GAT a2a epoch_s": gat["hp"]["epoch_s"] / gat["rp"]["epoch_s"],
        "pack ms": k3["hp"]["pack"]["ms"] / k3["rp"]["pack"]["ms"],
        "fused ms": k3["hp"]["fused"]["ms"] / k3["rp"]["fused"]["ms"],
        "K3 ms": k3["hp"]["ms"] / k3["rp"]["ms"],
        "served p50": serve["hp"][1]["latency_p50_ms"]
        / serve["rp"][1]["latency_p50_ms"],
        "device ms a step": (split["hp"]["device_ms"]
                             / split["rp"]["device_ms"])
        if split["hp"]["device_ms"] and split["rp"]["device_ms"] else None,
    }
    log("  hp / rp: " + json.dumps(ratio))
    summary = {mode: {"B": plans[mode].b, "S": plans[mode].s,
                      "R": plans[mode].r, "true_rows": sent[mode],
                      "a2a_wire_rows": plans[mode].wire_rows_per_exchange(
                          "a2a"),
                      "ring_wire_rows": plans[mode].wire_rows_per_exchange(
                          "ragged")} for mode in pvs}
    for mode in ("hp", "gp"):
        summary[mode]["partition_s"] = [res[(mode, r)][2] for r in (0, 1)]
    for mode in ("hp", "rp"):
        summary[mode].update(
            gcn_epoch_s_a2a=gcn[(mode, "a2a")][1]["epoch_s"],
            gcn_epoch_s_ring=gcn[(mode, "ragged")][1]["epoch_s"],
            gat_epoch_s_a2a=gat[mode]["epoch_s"],
            p50_ms=serve[mode][1]["latency_p50_ms"],
            p99_ms=serve[mode][1]["latency_p99_ms"],
            qps=serve[mode][1]["achieved_qps"], k3_ms=k3[mode]["ms"],
            k3_bound_ms=k3[mode]["bound_ms"],
            pack_ms=k3[mode]["pack"]["ms"],
            fused_ms=k3[mode]["fused"]["ms"],
            device_ms_3_steps=split[mode]["device_ms"])
    log("  DCSBM summary: " + json.dumps(summary))
    log(f"  card: {smi}")
    return total, fused_err, k3["hp"]


# ------------------------------------------- the pipelined stale trainer
STALE_DIR = os.path.join(REPO, "build", "chip_smoke_stale")
# the reference's band for the stale + delta losses against the exact run
# (tests/test_stale_halo.py:192-200)
BAND_STALE = dict(rtol=1e-2, atol=1e-2)
# phase 25's device-time classes: DEVICE_CLASSES with the elementwise
# kernels apart (the delta cache's sub, casts and add run there, beside
# the ReLUs and the loss; the delta's share is the difference to the
# plain stale step).  Up to PR 14 the group held every kernel whose name
# holds "elementwise_kernel" or "copy", index kernels such as
# index_elementwise_kernel included; the "gathers" label keeps those in
# (and adds the index kernels without either word in their name)
STALE_CLASSES = (("K3/K4 fused", ("K3/K4 fused",)),
                 ("pack", ("pack",)),
                 ("elementwise", ("elementwise",
                                  "copies (transpose, casts)", "gathers")),
                 ("matmul", ("matmul",)))


def carry_bytes(tr) -> int:
    """Bytes of a stale trainer's carries (feature and gradient, every
    layer) on the card."""
    return sum(x.numel() * x.element_size()
               for v in tr.halo_carry.values() for x in v)


def phase_stale(plan, data, p_init, widths, rep5, fit_w, halo_runs, dev, tb,
                cli_base, killed, smi):
    """Phase 25: the pipelined stale-halo trainer at the flagship width
    (module docstring).  Returns the main path's launches by entry
    (``launch_counts`` keys, this process's and the resumed child's) and
    the max |fused − plain| of its checks.  ``killed``: its child killed
    after a save (``start_killed_children``)."""
    children = Children()
    try:
        return _phase_stale(children, plan, data, p_init, widths, rep5,
                            fit_w, halo_runs, dev, tb, cli_base, killed, smi)
    finally:
        children.stop()


def _phase_stale(children, plan, data, p_init, widths, rep5, fit_w,
                 halo_runs, dev, tb, cli_base, killed, smi):
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops import pspmm
    from sgcn_tpu_torch.resilience import faults
    from sgcn_tpu_torch.train import FullBatchTrainer
    from sgcn_tpu_torch.utils.checkpoint import to_leaves

    nl = len(widths)
    bwd = backward_passes(128, widths)
    per_step = nl + bwd                 # packs = fused launches a step
    totals = {}
    fused_err = 0.0

    def counted(run):
        """``run()`` as a main-path run: counts zeroed before, read after
        and added to the phase's totals; K1's family entries must stay
        0."""
        launch_counts(zero=True)              # the main path starts here
        k1_open()
        out = run()
        k1_close()
        c = launch_counts()                   # ... and ends here
        if c["k1"] or c["k1_bf16"]:
            raise AssertionError(f"phase 25: K1 family launches {c}")
        for key, v in c.items():
            totals[key] = totals.get(key, 0) + v
        return out, c

    def stale(sched, params=p_init, **kw):
        return FullBatchTrainer(plan, fin=128, widths=widths, params=params,
                                comm_schedule=sched, device=dev,
                                halo_staleness=1, **kw)

    marks = [("start", time.perf_counter())]
    # ---- (g) first: the flagship child killed after its step-4 save
    # (started in phase 23), whose resuming child started as it exited
    # and runs in the background while the rest runs here
    codes, listing = killed.killed()
    if codes != [faults.FAULT_EXIT_CODE] or listing != ["ckpt_00000004.npz"]:
        raise AssertionError(f"phase 25: killed child exited {codes}, "
                             f"directory {listing}")
    final = os.path.join(STALE_DIR, "final.npz")
    marks.append(("(g) killed child joined", time.perf_counter()))
    # ---- (a) sync_every=1 == exact, bit for bit
    runs = [(sched, delta, None) for sched in ("a2a", "ragged")
            for delta in (False, True)]
    runs += [(sched, False, "bfloat16") for sched in ("a2a", "ragged")]
    for sched, delta, hd in runs:
        tr = stale(sched, halo_delta=delta, sync_every=1, halo_dtype=hd)
        rep, c = counted(lambda: tr.fit(data, epochs=5, warmup=1,
                                        verbose=False))
        want_l, want_w = ((rep5["loss_history"], fit_w) if hd is None
                          else halo_runs[sched])
        same = rep["loss_history"] == want_l and all(
            torch.equal(a, b) for a, b in zip(tr.params, want_w))
        fused = c["fused_wire" if hd else "fused"]
        n = 6 * per_step
        log(f"  sync_every=1 {sched} delta={delta} halo_dtype={hd}: losses "
            f"and weights == {'phase 15' if hd else 'phase 5'}: {same}; "
            f"packs {c['pack']}, fused {fused}, backward fused "
            f"{c['stale_bwd']} (expected {n}, {n}, {6 * bwd}); hidden "
            f"exchanges {rep['hidden_exchanges']}")
        if not same or (c["pack"], fused, c["stale_bwd"]) != (n, n, 6 * bwd):
            raise AssertionError(f"phase 25: sync_every=1 {sched} "
                                 f"delta={delta} halo_dtype={hd} differs "
                                 "from the exact run or its launches")
        del tr

    marks.append(("(a)", time.perf_counter()))
    # ---- (d) stale ragged == stale a2a, bit for bit, 1 + 8 steps
    for sync_every in (0, 4):
        for delta in (False, True):
            out = {}
            for sched in ("a2a", "ragged"):
                tr = stale(sched, halo_delta=delta, sync_every=sync_every)
                rep, _ = counted(lambda: tr.fit(data, epochs=8, warmup=1,
                                                verbose=False))
                out[sched] = (rep, [w.detach().clone() for w in tr.params])
                del tr
            (ra, wa), (rr, wr) = out["a2a"], out["ragged"]
            same = rr["loss_history"] == ra["loss_history"] and all(
                torch.equal(a, b) for a, b in zip(wa, wr))
            log(f"  stale sync_every={sync_every} delta={delta}: ragged == "
                f"a2a (losses, weights): {same}; losses "
                f"{ra['loss_history']}; hidden exchanges "
                f"{ra['hidden_exchanges']} of {ra['exchanges']}")
            if not same:
                raise AssertionError(f"phase 25: stale ragged != a2a, "
                                     f"sync_every={sync_every}, "
                                     f"delta={delta}")

    marks.append(("(d)", time.perf_counter()))
    # ---- (b, c) launches per stale and per sync step, and the pack and
    # the fused entry == plain on every exchange and aggregation of one
    # stale and one sync step, on their real carry tables
    # (the ring's fused launches read the same rows in the same order:
    # its steps are counted, and (d) holds it to a2a bit for bit)
    for sched, delta in (("a2a", True), ("ragged", False)):
        tr = stale(sched, halo_delta=delta, sync_every=2)
        counted(lambda: tr.step(data))                # the initializing sync
        for kind in ("stale", "sync"):
            def step():
                if sched == "ragged":
                    tr.step(data)
                    return [], [], []
                return record_launches(lambda: tr.step(data))
            (fams, packs, fused), c = counted(step)
            for j, (src, flat, dtype) in enumerate(packs):
                check_pack(src, flat, dtype, f"stale {sched} delta={delta} "
                           f"{kind} step exchange {j}")
            for j, args in enumerate(fused):
                fused_err = max(fused_err, check_fused(
                    *args, f"stale {sched} delta={delta} {kind} step "
                    f"aggregation {j} (carry {tuple(args[3].shape)} "
                    f"{args[3].dtype})"))
            log(f"  {sched} delta={delta} {kind} step: packs {c['pack']}, "
                f"fused {c['fused']}, backward fused {c['stale_bwd']} "
                f"(expected {per_step}, {per_step}, {bwd}); K1 family "
                f"{c['k1']}; {len(packs)} packs and {len(fused)} fused "
                "launches checked == plain")
            if (c["pack"], c["fused"], c["stale_bwd"]) != \
                    (per_step, per_step, bwd) or fams:
                raise AssertionError(f"phase 25: {kind} step launches {c}")
        del tr

    marks.append(("(b, c)", time.perf_counter()))
    # ---- (e) the stale losses against the exact run: the reference's band
    for delta, sync_every in ((True, 2), (False, 0)):
        tr = stale("a2a", halo_delta=delta, sync_every=sync_every)
        rep, _ = counted(lambda: tr.fit(data, epochs=5, warmup=1,
                                        verbose=False))
        got, want = (np.asarray(rep["loss_history"]),
                     np.asarray(rep5["loss_history"]))
        band = bool(np.allclose(got, want, **BAND_STALE))
        log(f"  stale delta={delta} sync_every={sync_every}: losses "
            f"{got.tolist()} vs exact {want.tolist()}: max |gap| "
            f"{np.abs(got - want).max():.3g}, inside {BAND_STALE}: {band}")
        if delta and (not band or not np.isfinite(got).all()):
            raise AssertionError("phase 25: stale + delta losses outside "
                                 "the reference's band of the exact run")
        del tr

    marks.append(("(e)", time.perf_counter()))
    # ---- (f) times, in two interleaved rounds
    cfgs = {}
    for sched in ("a2a", "ragged"):
        cfgs[f"exact {sched}"] = FullBatchTrainer(
            plan, fin=128, widths=widths, params=p_init,
            comm_schedule=sched, device=dev)
        cfgs[f"stale {sched}"] = stale(sched)
        cfgs[f"stale+delta {sched}"] = stale(sched, halo_delta=True)
    times = {name: {"epoch_s": [], "event_ms": []} for name in cfgs}
    for _round in range(2):
        for name, tr in cfgs.items():
            rep, _ = counted(lambda: tr.fit(data, epochs=10, warmup=2,
                                            verbose=False))
            times[name]["epoch_s"].append(rep["epoch_s"])
            (ms, _) = counted(lambda: cuda_ms(
                lambda: tr.step(data, sync=False), reps=10, warmup=1))
            times[name]["event_ms"].append(ms)
    for name, t in times.items():
        tr = cfgs[name]
        extra = (f"; carries {carry_bytes(tr)} B"
                 if tr.halo_carry is not None else "")
        log(f"  {name}: epoch_s {t['epoch_s']!r} (host clock, 10 timed "
            f"steps a round); CUDA events {t['event_ms']!r} ms a step (10 "
            f"steps, no readback){extra}; card: {smi}")
    splits = {}
    for name in ("exact a2a", "stale a2a", "stale+delta a2a",
                 "stale+delta ragged"):
        tr = cfgs[name]
        splits[name], _ = counted(lambda: device_split(
            f"{name} training", lambda: tr.step(data),
            classes=STALE_CLASSES))
    if splits["stale+delta a2a"]["device_ms"] and \
            splits["stale a2a"]["device_ms"]:
        delta_dev = (splits["stale+delta a2a"]["elementwise"]
                     - splits["stale a2a"]["elementwise"]) / 3
        log(f"  the delta cache's elementwise device time, stale+delta a2a "
            f"minus stale a2a: {delta_dev:.3f} ms a step ({nl} layers)")
    else:
        log("  the delta cache's elementwise device time: not measured "
            "(the profiler recorded no device time)")
    # the delta arithmetic of one layer alone, on the real layer-0 carry
    trd = cfgs["stale+delta a2a"]
    carry = trd.halo_carry["halos"][0]
    full = pspmm.exchange_recv(data.h0, trd.pa["recv_src"])
    d_ms = cuda_ms(lambda: pspmm.delta_step(full, carry))
    d_bytes = 3 * carry.numel() * 4     # read full and carry, write carry
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  delta arithmetic alone (ops/pspmm.py::delta_step), one layer "
        f"{tuple(carry.shape)}: {d_ms!r} ms (CUDA events); bound "
        f"{d_bound:.4f} ms by bytes ({d_bytes} B: two float32 reads, one "
        f"write); carries per layer and direction {carry.numel() * 4} B")
    torch.cuda.synchronize()
    log(f"  peak device memory so far {torch.cuda.max_memory_allocated()} B")
    del cfgs, trd, carry, full

    marks.append(("(f)", time.perf_counter()))
    # ---- (h) the controller on the cora CLI
    (losses, rep), _ = counted(lambda: run_train_cli(
        cli_base + ["--epochs", "5", "--warmup", "0", "--comm-schedule",
                    "auto", "--halo-staleness", "1", "--sync-every", "2"]))
    log(f"  cora CLI --comm-schedule auto --halo-staleness 1 --sync-every 2:"
        f" {rep['comm_schedule']} ({rep['wire_rows_per_exchange']} wire rows)"
        f", losses {losses}, hidden exchanges {rep['hidden_exchanges']} of "
        f"{rep['exchanges']}; controller {json.dumps(rep['controller'])}")
    if rep["comm_schedule"] != "ragged" or \
            rep["wire_rows_per_exchange"] != 4128 or \
            rep["controller"]["initial_sync_every"] != 2:
        raise AssertionError(f"phase 25: the stale CLI resolved {rep}")

    marks.append(("(h)", time.perf_counter()))
    # ---- (g) the uninterrupted run here; then the resuming child's end
    tr = FullBatchTrainer(plan, fin=128, widths=widths, seed=0,
                          comm_schedule="a2a", halo_staleness=1,
                          halo_delta=True, sync_every=3, device=dev)
    full_losses, _ = counted(lambda: [tr.step(data) for _ in range(6)])
    marks.append(("(g) uninterrupted run", time.perf_counter()))
    if killed.resumed() != [0]:
        raise AssertionError("phase 25: the resuming child failed")
    marks.append(("(g) resumed child joined", time.perf_counter()))
    with open(os.path.join(STALE_DIR, "resume.json")) as fh:
        res = json.load(fh)
    with np.load(final) as z:
        leaves = [z[f"leaf_{i}"] for i in range(
            sum(f.startswith("leaf_") for f in z.files))]
        carry = [z[f"carry_{i}"] for i in range(
            sum(f.startswith("carry_") for f in z.files))]
    # the saved leaves against the uninterrupted run's, array for array
    # (phase 23 logs the digests; here equality is the check)
    same = (leaves_equal(leaves, to_leaves(tr.params, tr.opt)),
            leaves_equal(carry, tr.resume_state()[1]))
    nbytes = sum(np.asarray(x).nbytes for x in leaves + carry)
    rep = res["report"]
    log(f"  killed child exit {codes[0]} after its step-4 save; resumed at "
        f"step {rep['resumed']['step']}, losses {rep['losses']} vs "
        f"uninterrupted {full_losses[4:]}; weights + Adam == "
        f"{same[0]}, carry == {same[1]} "
        f"({nbytes} B compared); child launches {res['launches']}")
    if rep["losses"] != full_losses[4:] or not all(same):
        raise AssertionError("phase 25: the resumed stale run differs from "
                             "the uninterrupted one")
    for key, v in res["launches"].items():
        totals[key] = totals.get(key, 0) + v
    marks.append(("(g) end", time.perf_counter()))
    log("  phase 25 host seconds by section: " + json.dumps(
        {name: round(t - t0, 1) for (_n, t0), (name, t) in
         zip(marks, marks[1:])}))
    log(f"  phase 25's main-path launches: {json.dumps(totals)}")
    return totals, fused_err


REPLICA_DIR = os.path.join(REPO, "build", "chip_smoke_replica")
# the reference gives no loss band of its own for replica training; the
# replica losses are held to its band for the other approximate-halo mode,
# the stale one (tests/test_stale_halo.py:192-200)
BAND_REPLICA = BAND_STALE


class KillResume:
    """One flagship child killed after its step-4 save and the child that
    resumes it: a watcher thread waits for the first to exit and starts
    the second at once, so both run beside the phases before their own.
    ``killed()`` waits for the watcher and returns the killed child's exit
    codes and its checkpoint directory's listing as the watcher saw them
    (before the resuming child could write there); ``resumed()`` waits
    for the resuming child and returns its exit codes."""

    def __init__(self, children, kill, resume_job, ckdir):
        import threading

        self.children, self.wave = children, None
        self.codes = self.listing = None

        def watch():
            from sgcn_tpu_torch.resilience import faults

            self.codes = children.join(kill)
            self.listing = sorted(os.listdir(ckdir))
            if (self.codes == [faults.FAULT_EXIT_CODE]
                    and self.listing == ["ckpt_00000004.npz"]):
                self.wave = children.start([resume_job])
        self.thread = threading.Thread(target=watch, daemon=True)
        self.thread.start()

    def killed(self):
        self.thread.join()
        return self.codes, self.listing

    def resumed(self):
        self.thread.join()
        return self.children.join(self.wave) if self.wave else None


def start_killed_children(widths):
    """Phases 25 and 26's flagship children killed after their step-4
    save (GCN a2a, stale + delta, and GCN a2a, replicas, each with
    ``--sync-every 3``, on phase 23's inputs), started as soon as phase 23
    has written those inputs, each followed at once by the child that
    resumes it (``--resume auto --save-checkpoint final.npz``), so that
    they run beside phases 23 and 24 and not in series with their own
    phases.  Returns ``{phase: KillResume}``; the children are closed at
    exit."""
    import shutil

    children = Children()
    BACKGROUND.append(children)
    modes = {25: (STALE_DIR, ["--halo-staleness", "1", "--halo-delta"]),
             26: (REPLICA_DIR, ["--replica-budget", "auto"])}
    out = {}
    for phase, (d, mode) in modes.items():
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        argv = ["--npz", os.path.join(CKPT_DIR, "flagship.npz"), "-p",
                os.path.join(CKPT_DIR, "flagship.8.rp"), "-s", "8", "-l",
                str(len(widths)), "--hidden", str(widths[0]), "--warmup",
                "0", "--epochs", "6", "--device", "cuda", "--comm-schedule",
                "a2a", *mode, "--sync-every", "3", "--checkpoint-dir",
                os.path.join(d, "ck"), "--checkpoint-every", "4"]
        kill = children.start([
            ("train", argv, "kill-after-save:4", os.path.join(d, "kill.json"))
        ])
        resume = ("train", argv + ["--resume", "auto", "--save-checkpoint",
                                   os.path.join(d, "final.npz")],
                  None, os.path.join(d, "resume.json"))
        out[phase] = KillResume(children, kill, resume, os.path.join(d, "ck"))
    return out


REPLICA_CLASSES = (("K3/K4 fused", ("K3/K4 fused",)),
                   ("pack", ("pack",)),
                   ("gather/scatter", ("gathers",)),
                   ("elementwise", ("elementwise",
                                    "copies (transpose, casts)")),
                   ("matmul", ("matmul",)))


def replica_carry_bytes(tr) -> int:
    """Bytes of a replica or composed trainer's carries on the card."""
    carry = tr.replica_carry if tr.replica_carry is not None \
        else tr.halo_carry
    return sum(x.numel() * x.element_size() for v in carry.values()
               for x in v)


def check_pack_into(out, src, flat, dst, what):
    """The destination-indexed pack vs its plain version on the card, on
    the same inputs: bit for bit, the rows it does not name untouched,
    two launches the same.  Returns 0.0."""
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import (row_pack_into,
                                                row_pack_into_plain)

    one = row_pack_into(out.clone(), src, flat, dst)
    two = row_pack_into(out.clone(), src, flat, dst)
    plain = row_pack_into_plain(out.clone(), src, flat, dst)
    torch.cuda.synchronize()
    if not (same_bits(one, plain, nan_ok=True)
            and same_bits(one, two, nan_ok=True)):
        raise AssertionError(f"{what}: row_pack_into != plain version")
    return 0.0


def time_pack_into(out, src, flat, dst, what):
    """The destination-indexed pack's time (CUDA events), its plain
    version's, ``index_copy_`` of the already gathered rows (one PyTorch
    call: the store half of the plain version) and the bound: each
    distinct source row read once, the two int32 index lists read once,
    every named row written once (as ``pack_work`` counts the pack)."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import (row_pack_into,
                                                row_pack_into_plain)

    w = out[0, 0].numel()
    ms = cuda_ms(lambda: row_pack_into(out, src, flat, dst))
    plain_ms = cuda_ms(lambda: row_pack_into_plain(out, src, flat, dst),
                       reps=5)
    out2d, d64 = out.view(-1, w), dst.long()
    rows = src.reshape(-1, w).index_select(0, flat.long()).to(out.dtype)
    library_ms = cuda_ms(lambda: out2d.index_copy_(0, d64, rows))
    n = flat.numel()
    distinct = np.unique(flat.cpu().numpy()).size
    nbytes = (distinct * w * src.element_size() + 8 * n
              + n * w * out.element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {what}: {n} rows of {w}: row_pack_into {ms!r} ms, plain "
        f"{plain_ms!r} ms, index_copy_ of the gathered rows {library_ms!r} "
        f"ms, bound {bound_ms!r} ms by bytes ({nbytes} B), "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "rows": n,
            "distinct_rows": distinct}


def phase_replicas(plan, data, p_init, widths, rep5, fit_w, halo_runs,
                   parts_bg, ahat_dc, dev, tb, cli_base, killed, smi):
    """Phase 26: hot-halo replicas at the flagship width (module
    docstring).  Returns the main path's launches by entry
    (``launch_counts`` keys, this process's and the resumed child's) and
    the timing of the destination-indexed pack.  ``killed``: its child
    killed after a save (``start_killed_children``)."""
    children = Children()
    try:
        return _phase_replicas(children, plan, data, p_init, widths, rep5,
                               fit_w, halo_runs, parts_bg, ahat_dc, dev, tb,
                               cli_base, killed, smi)
    finally:
        children.stop()


def _phase_replicas(children, plan, data, p_init, widths, rep5, fit_w,
                    halo_runs, parts_bg, ahat_dc, dev, tb, cli_base, killed,
                    smi):
    import numpy as np
    import torch

    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.parallel.plan import choose_replica_budget
    from sgcn_tpu_torch.resilience import faults
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
    from sgcn_tpu_torch.utils.checkpoint import to_leaves

    nl = len(widths)
    bwd = backward_passes(128, widths)
    per_step = nl + bwd                 # aggregations a step
    totals = {}

    def counted(run):
        """``run()`` as a main-path run: counts zeroed before, read after
        and added to the phase's totals; K1's family entries must stay
        0."""
        launch_counts(zero=True)              # the main path starts here
        k1_open()
        out = run()
        torch.cuda.synchronize()
        k1_close()
        c = launch_counts()                   # ... and ends here
        if c["k1"] or c["k1_bf16"]:
            raise AssertionError(f"phase 26: K1 family launches {c}")
        for key, v in c.items():
            totals[key] = totals.get(key, 0) + v
        return out, c

    def trainer(p, sched, params=p_init, **kw):
        return FullBatchTrainer(p, fin=128, widths=widths, params=params,
                                comm_schedule=sched, device=dev, **kw)

    # ---- the flagship child killed after its step-4 save (started in
    # phase 23), whose resuming child started as it exited, in the
    # background
    codes, listing = killed.killed()
    if codes != [faults.FAULT_EXIT_CODE] or listing != ["ckpt_00000004.npz"]:
        raise AssertionError(f"phase 26: killed child exited {codes}, "
                             f"directory {listing}")
    final = os.path.join(REPLICA_DIR, "final.npz")

    # ---- plans: the ER flagship (phase 5's, both transports) and the
    # DCSBM flagship on phase 24's hp parts; budgets 'auto' and the clamp
    plans = {"ER": plan}
    t0 = time.perf_counter()
    pv_hp = parts_bg.result()[("hp", 0)][0]
    plans["DCSBM hp"] = build_comm_plan(ahat_dc, pv_hp, PART_K)
    log(f"  DCSBM hp plan (phase 24's parts) built in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    budgets = {}
    for name, p in plans.items():
        knee = {}
        budgets[name] = choose_replica_budget(p, decision=knee)
        t0 = time.perf_counter()
        p.ensure_exchange()
        p.ensure_ragged()
        p.ensure_replicas(budgets[name])
        log(f"  {name}: replica_budget auto -> B {budgets[name]} (knee of "
            f"{knee['boundary_rows']} boundary rows, score_covered "
            f"{knee['score_covered']!r}); {p.replica_rows} rows replicated, "
            f"{p.replica_send_saving} copies off the wire; kept receive "
            f"slots {len(p.keep_recv_src)} of {int(p.send_counts.sum())}; "
            f"wire rows a2a {p.wire_rows_per_exchange('a2a')} -> "
            f"{p.wire_rows_per_exchange('a2a', replica=True)}, ring "
            f"{p.wire_rows_per_exchange('ragged')} -> "
            f"{p.wire_rows_per_exchange('ragged', replica=True)}; layout "
            f"{time.perf_counter() - t0:.2f} s (host)")
    n_dc = ahat_dc.shape[0]
    feats_dc = np.random.default_rng(2).standard_normal(
        (n_dc, 128)).astype(np.float32)
    labels_dc = np.random.default_rng(4).integers(0, 40, n_dc)
    data_dc = make_train_data(plans["DCSBM hp"], feats_dc, labels_dc,
                              device=dev)
    datas = {"ER": data, "DCSBM hp": data_dc}
    b_er = budgets["ER"]

    # ---- (a) sync_every=1 == exact, bit for bit: pure and composed on
    # both transports (phase 5/11's fit), pure a2a under halo_dtype
    # (phase 15's)
    runs = [(sched, stale, None) for sched in ("a2a", "ragged")
            for stale in (0, 1)] + [("a2a", 0, "bfloat16")]
    for sched, stale, hd in runs:
        tr = trainer(plan, sched, replica_budget=b_er, sync_every=1,
                     halo_staleness=stale, halo_dtype=hd)
        rep, c = counted(lambda: tr.fit(data, epochs=5, warmup=1,
                                        verbose=False))
        want_l, want_w = ((rep5["loss_history"], fit_w) if hd is None
                          else halo_runs[sched])
        same = rep["loss_history"] == want_l and all(
            torch.equal(a, b) for a, b in zip(tr.params, want_w))
        log(f"  sync_every=1 {sched} {'composed' if stale else 'replica'} "
            f"halo_dtype={hd}: losses and weights == "
            f"{'phase 15' if hd else 'phase 5'}: {same}; packs {c['pack']}, "
            f"kept packs {c['pack_into']} (expected {6 * per_step}, 0)")
        if not same or (c["pack"], c["pack_into"]) != (6 * per_step, 0):
            raise AssertionError(f"phase 26: sync_every=1 {sched} "
                                 f"staleness={stale} halo_dtype={hd}")
        del tr

    # ---- (b) replica ring == replica a2a, bit for bit, 1 + 6 steps
    for sync_every in (0, 2, 3):
        out = {}
        for sched in ("a2a", "ragged"):
            tr = trainer(plan, sched, replica_budget=b_er,
                         sync_every=sync_every)
            rep, _ = counted(lambda: tr.fit(data, epochs=6, warmup=1,
                                            verbose=False))
            out[sched] = (rep, [w.detach().clone() for w in tr.params])
            del tr
        (ra, wa), (rr, wr) = out["a2a"], out["ragged"]
        same = rr["loss_history"] == ra["loss_history"] and all(
            torch.equal(a, b) for a, b in zip(wa, wr))
        log(f"  replica sync_every={sync_every}: ragged == a2a (losses, "
            f"weights): {same}; losses {ra['loss_history']}; replica "
            f"exchanges {ra['replica_exchanges']} of {ra['exchanges']}")
        if not same:
            raise AssertionError(f"phase 26: replica ragged != a2a, "
                                 f"sync_every={sync_every}")

    # ---- (c) the new pack == plain on the flagships' kept lists, f32
    # and bf16, on the real layer-0 rows; (d) launches per replica and
    # per refresh step, both transports, both plans, and at the clamp
    pack_t = {}
    for name, p in plans.items():
        h0 = datas[name].h0
        for sched in ("a2a", "ragged"):
            pre = "ring" if sched == "ragged" else "recv"
            src = torch.as_tensor(getattr(p, f"keep_{pre}_src")).to(dev)
            dst = torch.as_tensor(getattr(p, f"keep_{pre}_dst")).to(dev)
            rows = (max(1, sum(p.rr_sizes)) if sched == "ragged"
                    else p.k * p.s)
            for dt in (torch.float32, torch.bfloat16):
                out = torch.randn((p.k, rows, 128), device=dev).to(dt)
                check_pack_into(out, h0, src, dst, f"{name} {sched} kept "
                                f"pack f32 -> {dt}")
            if sched == "a2a":
                out = torch.zeros((p.k, rows, 128), device=dev)
                pack_t[name] = time_pack_into(
                    out, h0, src, dst, f"{name} replica step's kept pack "
                    "(layer 0, f=128, float32)")
                recv_src = torch.as_tensor(p.recv_src).to(dev)
                exact_ms = cuda_ms(lambda: row_pack(h0, recv_src))
                pack_t[name]["exact_ms"] = exact_ms
                pack_t[name]["exact_rows"] = int(recv_src.numel())
                log(f"  {name}: pack rows and ms a step's layer, replica "
                    f"step {pack_t[name]['rows']} rows {pack_t[name]['ms']!r}"
                    f" ms vs exact step {recv_src.numel()} rows "
                    f"{exact_ms!r} ms (row_pack of the whole receive "
                    f"buffer); card: {smi}")
            tr = trainer(p, sched, params=None, seed=5,
                         replica_budget=budgets[name], sync_every=2)
            counted(lambda: tr.step(datas[name]))   # the initializing refresh
            for kind in ("replica", "refresh"):
                _, c = counted(lambda: tr.step(datas[name]))
                # a refresh is the stale op's sync step: its backward
                # counts there
                want = ((0, per_step, bwd, 0) if kind == "replica"
                        else (per_step, 0, 0, bwd))
                got = (c["pack"], c["pack_into"], c["rep_bwd"],
                       c["stale_bwd"])
                log(f"  {name} {sched} {kind} step: packs, kept packs, "
                    f"replica and sync backward fused {got}, fused "
                    f"{c['fused']} (expected {want}, {per_step})")
                if got != want or c["fused"] != per_step:
                    raise AssertionError(f"phase 26: {name} {sched} {kind} "
                                         f"step launches {c}")
            del tr
    tr = trainer(plan, "a2a", replica_budget=10 ** 7, sync_every=2)
    counted(lambda: tr.step(data))
    _, c = counted(lambda: tr.step(data))
    log(f"  clamp (B 10^7, {plan.replica_rows} boundary rows replicated): "
        f"kept lists {len(plan.keep_recv_src)} rows; a replica step: kept "
        f"packs {c['pack_into']}, packs {c['pack']}, fused {c['fused']} "
        f"(expected 0, 0, {per_step})")
    if (c["pack_into"], c["pack"], c["fused"]) != (0, 0, per_step):
        raise AssertionError(f"phase 26: clamp replica step launches {c}")
    del tr
    plan.ensure_replicas(b_er)

    # ---- (e) replica losses against the exact run: the band
    for stale, sync_every in ((0, 2), (1, 2)):
        tr = trainer(plan, "a2a", replica_budget=b_er,
                     sync_every=sync_every, halo_staleness=stale)
        rep, _ = counted(lambda: tr.fit(data, epochs=5, warmup=1,
                                        verbose=False))
        got, want = (np.asarray(rep["loss_history"]),
                     np.asarray(rep5["loss_history"]))
        band = bool(np.allclose(got, want, **BAND_REPLICA))
        log(f"  {'composed' if stale else 'replica'} sync_every="
            f"{sync_every}: losses {got.tolist()} vs exact {want.tolist()}: "
            f"max |gap| {np.abs(got - want).max():.3g}, inside "
            f"{BAND_REPLICA}: {band}")
        if not band or not np.isfinite(got).all():
            raise AssertionError("phase 26: replica losses outside the band "
                                 "of the exact run")
        del tr

    # ---- (f) the partial refresh: band 0 ships every drifted copy, a
    # huge band none.  The rows that drift are those of the layers whose
    # aggregated input moves with the weights — the ones with a backward
    # pass (an aggregate-first layer 0 exchanges the fixed features)
    for band in (0.0, 1e12):
        tr = trainer(plan, "a2a", replica_budget=b_er, sync_every=2,
                     refresh_band=band)
        rep, _ = counted(lambda: [tr.step(data) for _ in range(5)])
        r = tr.stats.report()
        full = 2 * 2 * bwd * plan.replica_send_saving
        log(f"  refresh_band={band}: {r['partial_refresh_steps']} partial "
            f"refreshes shipped {r['partial_refresh_rows_total']} rows, "
            f"forward and backward (every replica copy of the {bwd} "
            f"drifting layers, each refresh: {full}); losses {rep}")
        if r["partial_refresh_rows_total"] != (full if band == 0 else 0):
            raise AssertionError(f"phase 26: refresh_band={band} shipped "
                                 f"{r['partial_refresh_rows_total']}")
        del tr

    # ---- times, in two interleaved rounds
    cfgs = {}
    for sched in ("a2a", "ragged"):
        cfgs[f"ER exact {sched}"] = trainer(plan, sched)
        cfgs[f"ER replica {sched}"] = trainer(plan, sched,
                                              replica_budget=b_er)
        cfgs[f"ER composed {sched}"] = trainer(plan, sched,
                                               replica_budget=b_er,
                                               halo_staleness=1)
    p_hp = plans["DCSBM hp"]
    for kind, kw in (("exact", {}),
                     ("replica", {"replica_budget": budgets["DCSBM hp"]}),
                     ("composed", {"replica_budget": budgets["DCSBM hp"],
                                   "halo_staleness": 1})):
        cfgs[f"DCSBM hp {kind} a2a"] = trainer(p_hp, "a2a", params=None,
                                               seed=5, **kw)
    times = {name: {"epoch_s": [], "event_ms": []} for name in cfgs}
    for _round in range(2):
        for name, tr in cfgs.items():
            d = data_dc if name.startswith("DCSBM") else data
            rep, _ = counted(lambda: tr.fit(d, epochs=8, warmup=2,
                                            verbose=False))
            times[name]["epoch_s"].append(rep["epoch_s"])
            (ms, _) = counted(lambda: cuda_ms(
                lambda: tr.step(d, sync=False), reps=8, warmup=1))
            times[name]["event_ms"].append(ms)
    for name, t in times.items():
        tr = cfgs[name]
        extra = (f"; carries {replica_carry_bytes(tr)} B"
                 if tr.replica_budget else "")
        log(f"  {name}: epoch_s {t['epoch_s']!r} (host clock, 8 timed steps "
            f"a round; sync_every 0, so a replica or composed trainer "
            f"refreshed once, at its first step); CUDA events "
            f"{t['event_ms']!r} ms a step (8 steps, no readback){extra}; "
            f"card: {smi}")
    counted(lambda: device_split(
        "ER replica a2a training", lambda: cfgs["ER replica a2a"].step(data),
        classes=REPLICA_CLASSES))
    torch.cuda.synchronize()
    log(f"  peak device memory so far {torch.cuda.max_memory_allocated()} B")
    del cfgs

    # ---- (h) the train CLI with --replica-budget auto --sync-every 3
    (losses, rep), _ = counted(lambda: run_train_cli(
        cli_base + ["--epochs", "5", "--warmup", "0", "--replica-budget",
                    "auto", "--sync-every", "3"]))
    log(f"  cora CLI --replica-budget auto --sync-every 3: B "
        f"{rep['replica_budget']} (knee, score_covered "
        f"{rep['replica_auto']['score_covered']!r}), {rep['comm_schedule']}, "
        f"losses {losses}, replica exchanges {rep['replica_exchanges']} of "
        f"{rep['exchanges']}, wire rows {rep['wire_rows_per_exchange']} -> "
        f"{rep['wire_rows_per_exchange_replica']}")
    # steps 1, 2 and 4 of 0-4 are replica steps: 3 x 2 exchanges x 2 layers
    if not (rep["replica_budget"] > 0 and rep["replica_exchanges"] == 12
            and np.isfinite(losses).all()):
        raise AssertionError(f"phase 26: the replica CLI reported {rep}")

    # ---- (g) the uninterrupted run of the killed child, here; then the
    # resuming child's end
    tr = FullBatchTrainer(plan, fin=128, widths=widths, seed=0,
                          comm_schedule="a2a", replica_budget="auto",
                          sync_every=3, device=dev)
    full_losses, _ = counted(lambda: [tr.step(data) for _ in range(6)])
    if killed.resumed() != [0]:
        raise AssertionError("phase 26: the resuming child failed")
    with open(os.path.join(REPLICA_DIR, "resume.json")) as fh:
        res = json.load(fh)
    with np.load(final) as z:
        leaves = [z[f"leaf_{i}"] for i in range(
            sum(f.startswith("leaf_") for f in z.files))]
        carry = [z[f"carry_{i}"] for i in range(
            sum(f.startswith("carry_") for f in z.files))]
    # the saved leaves against the uninterrupted run's, array for array
    # (phase 23 logs the digests; here equality is the check)
    same = (leaves_equal(leaves, to_leaves(tr.params, tr.opt)),
            leaves_equal(carry, tr.resume_state()[1]))
    nbytes = sum(np.asarray(x).nbytes for x in leaves + carry)
    rep = res["report"]
    log(f"  killed child exit {codes[0]} after its step-4 save; resumed at "
        f"step {rep['resumed']['step']}, losses {rep['losses']} vs "
        f"uninterrupted {full_losses[4:]}; weights + Adam == "
        f"{same[0]}, replica carry == {same[1]} "
        f"({nbytes} B compared); child launches {res['launches']}")
    if rep["losses"] != full_losses[4:] or not all(same):
        raise AssertionError("phase 26: the resumed replica run differs "
                             "from the uninterrupted one")
    for key, v in res["launches"].items():
        totals[key] = totals.get(key, 0) + v
    log(f"  phase 26's main-path launches: {json.dumps(totals)}")
    return totals, pack_t["ER"]


# ---------------------------------------------------- the mini-batch trainer
def pad_stats(plans, model):
    """The shared envelope's padding in the tiles the kernel walks, over
    every batch plan: the share of stored tile slots that hold no edge,
    and the longest pad chain — the weight-0 pad edges of one part's
    padded edge list, which all land on row b−1 of its last tile (one
    serial chain there)."""
    if model == "gcn":
        tiled = sum(p.ptile_lw.size + p.ptile_hw.size for p in plans)
        real = sum(int(p.lnnz.sum() + p.hnnz.sum()) for p in plans)
        chain = max(max(int((p.el - p.lnnz).max()),
                        int((p.eh - p.hnnz).max())) for p in plans)
    else:
        tiled = sum(p.ptile_cw.size for p in plans)
        real = sum(int(p.nnz.sum()) for p in plans)
        chain = max(int((p.e - p.nnz).max()) for p in plans)
    return {"pad_share": 1 - real / tiled, "pad_chain": chain,
            "tiled_slots": tiled, "edges": real}


def phase_minibatch(parts_bg, ahat_dc, fix, dev, smi):
    """Phase 27 (module docstring): the mini-batch trainer and SHP.
    Returns the launch counts of its paths by kernel entry (this
    process's and the children's) and the max |kernel − plain| of the
    fused entry and of K5 on the batch plans."""
    children = Children()
    try:
        return _phase_minibatch(children, parts_bg, ahat_dc, fix, dev, smi)
    finally:
        children.stop()


def _phase_minibatch(children, parts_bg, ahat_dc, fix, dev, smi):
    import shutil

    import numpy as np
    import torch

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.io.mtx import write_mtx
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    t_phase = time.perf_counter()
    total = {key: 0 for key in launch_counts()}

    def counted(run):
        launch_counts(zero=True)               # a main-path run starts here
        out = run()
        torch.cuda.synchronize()
        got = launch_counts()                  # ... and ends here
        for key in total:
            total[key] += got[key]
        return out, got

    # ---- (a) the cora CLIs in children, one wave after another on a
    # host thread, beside (b): the SHP CLI, then the train CLI's -n 512 on
    # its stchp parts for 2 epochs with a checkpoint an epoch, then a
    # resume to 3 epochs in new children; each wave's results are read
    # and checked in (c)
    shutil.rmtree(MB_DIR, ignore_errors=True)
    os.makedirs(MB_DIR)
    a_c, _, _ = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    amtx = os.path.join(MB_DIR, "cora.A.mtx")
    write_mtx(amtx, normalize_adjacency(a_c))
    stchp = os.path.join(MB_DIR, "partvec.stchp.8")
    base = ["--npz", os.path.join(fix, "cora2708.npz"), "--normalize", "-p",
            stchp, "-s", "8", "-l", "2", "--hidden", "16", "-n", "512",
            "--warmup", "1"]
    ck = {s_: ["--comm-schedule", s_, "--checkpoint-dir",
               os.path.join(MB_DIR, f"ck-{s_}"), "--checkpoint-every", "1"]
          for s_ in ("a2a", "ragged")}

    def run_waves():
        waves = [
            [("shp", "shp", ["-p", amtx, "-k", "8", "-b", "512", "-m", "10",
                             "-s", "20", "-o", MB_DIR])],
            [(f"train-{s_}", "train", base + ck[s_] + ["--epochs", "2"])
             for s_ in ck],
            [(f"resume-{s_}", "train", base + ck[s_]
              + ["--epochs", "3", "--resume", "auto"]) for s_ in ck]]
        out = {}
        for jobs in waves:
            procs = children.start([
                (module, argv, None, os.path.join(MB_DIR, f"{nm}.json"))
                for nm, module, argv in jobs])
            codes = children.join(procs)
            for (_, t_spawn), (nm, _, _), code in zip(procs, jobs, codes):
                res = None
                if code == 0:
                    with open(os.path.join(MB_DIR, f"{nm}.json")) as fh:
                        res = json.load(fh)
                out[nm] = (code, t_spawn, res)
            if codes != [0] * len(jobs):
                break
        return out

    from concurrent.futures import ThreadPoolExecutor
    cli_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="clis")
    cli_future = cli_pool.submit(run_waves)

    # ---- (b) the DCSBM flagship on its hp and SHP's stchp parts
    n, k = ahat_dc.shape[0], PART_K
    t0 = time.perf_counter()
    parts = parts_bg.result()
    shp, shp_wall, shp_cpu = parts_bg.shp_result()
    log(f"  SHP on the DCSBM flagship (shp.run_shp: k={k}, "
        f"{SHP_SAMPLED} sampled batches of {MB_BATCH}, {SHP_SIM} simulated, "
        f"seed {PART_SEED}) on a host thread beside phases 1-23: "
        f"{shp_wall!r} s wall, {shp_cpu!r} s thread CPU; "
        f"{time.perf_counter() - t0:.2f} s waited for it here")
    pvs = {"hp": parts[("hp", 0)][0], "stchp": shp["partvec_stchp"]}
    check_partvec(pvs["stchp"], n, k, "DCSBM stchp")
    same_hp = np.array_equal(shp["partvec_hp"], pvs["hp"])
    log(f"  SHP: km1 hp {shp['km1_hp']} (phase 24's "
        f"{parts[('hp', 0)][1]}), stchp {shp['km1_stchp']} (on the "
        f"stochastic hypergraph); simulated batch volume hp "
        f"{shp['sim_comm_volume_hp']}, stchp {shp['sim_comm_volume_stchp']}"
        f" (stchp / hp {shp['sim_comm_volume_stchp'] / max(shp['sim_comm_volume_hp'], 1):.4f}); "
        f"its hp vector == phase 24's: {same_hp}")
    if not same_hp or shp["km1_hp"] != parts[("hp", 0)][1]:
        raise AssertionError("phase 27: run_shp's hp partition differs from "
                             "phase 24's with the same arguments")
    feats = np.random.default_rng(2).standard_normal((n, 128)).astype(
        np.float32)
    labels = np.random.default_rng(4).integers(0, 40, n)
    widths = [128, 128, 40]
    per_step = len(widths) + backward_passes(128, widths)   # 3 + 2

    def build(pv, sched, model="gcn", dtype=None):
        tr = MiniBatchTrainer(ahat_dc, pv, k, fin=128, widths=widths,
                              batch_size=MB_BATCH, model=model,
                              activation="relu" if model == "gcn" else "none",
                              comm_schedule=sched, compute_dtype=dtype,
                              seed=0, device=dev)
        batches = tr.make_batches(feats, labels)
        return tr, batches

    summary, fused_err, k5_err = {}, 0.0, 0.0
    runs = {}
    for name, pv in pvs.items():
        for sched in ("a2a", "ragged"):
            tr, batches = build(pv, sched)
            nb = len(batches)
            p0 = tr.plans[0]
            ps = pad_stats(tr.plans, "gcn")
            log(f"  {name} GCN {sched}: {nb} batch plans, envelope B {p0.b} S "
                f"{p0.s} R {p0.r} E {p0.e} (EL {p0.el} EH {p0.eh}"
                + (f", rounds {list(p0.rr_sizes)}" if sched == "ragged"
                   else "") + f"); plans built in {tr.plan_build_s!r} s, "
                f"tile layouts + shipping {tr.layout_s!r} s (host); pad share "
                f"of the tiled slots {ps['pad_share']:.4f} ({ps['edges']} "
                f"edges in {ps['tiled_slots']} slots), longest pad chain "
                f"{ps['pad_chain']}")
            rep, got = counted(lambda: tr.fit(feats, labels, epochs=3,
                                              warmup=0, verbose=False))
            hist = rep["loss_history"]
            steps = 3 * nb
            want = {"pack": steps * per_step, "fused": steps * per_step,
                    "k1": 0, "k1_bf16": 0}
            if sched == "a2a":
                want["sym_bwd"] = steps * (per_step - len(widths))
            else:
                want.update(ring=steps * len(widths),
                            ring_bwd=steps * (per_step - len(widths)))
            log(f"  {name} GCN {sched}: batch-averaged losses {hist}; "
                f"epoch_s {rep['epoch_s']!r} (host clock, one pass over {nb} "
                f"batches); launches {json.dumps({x: got[x] for x in want})}"
                f", expected {json.dumps(want)} ({steps} steps x "
                f"{per_step} aggregations); comm {json.dumps({x: rep[x] for x in ('total_send_volume', 'wire_rows_total', 'padding_efficiency')})}")
            if any(got[x] != v for x, v in want.items()):
                raise AssertionError(f"phase 27: {name} GCN {sched} launch "
                                     "counts differ from the steps run")
            if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
                raise AssertionError(f"phase 27: {name} GCN {sched} losses "
                                     f"not finite and falling: {hist}")
            runs[(name, sched)] = (tr, batches, rep, [
                w.detach().clone() for w in tr.inner.params])
        (_, _, ra, wa), (_, _, rr, wr) = (runs[(name, "a2a")],
                                         runs[(name, "ragged")])
        same = ra["loss_history"] == rr["loss_history"] and all(
            torch.equal(x, y) for x, y in zip(wa, wr))
        log(f"  {name}: ring == a2a bit for bit (3 epochs of losses and the "
            f"weights after): {same}")
        if not same:
            raise AssertionError(f"phase 27: {name} ring != a2a")
        tr = runs[(name, "a2a")][0]
        summary[name] = {
            "nbatches": len(tr.plans), "B": tr.plans[0].b,
            "S": tr.plans[0].s, "R": tr.plans[0].r, "E": tr.plans[0].e,
            "send_rows_per_layer_pass": sum(
                int(p.predicted_send_volume.sum()) for p in tr.plans),
            "plan_build_s": tr.plan_build_s, "layout_s": tr.layout_s,
            "epoch_s_a2a": ra["epoch_s"], "epoch_s_ring": rr["epoch_s"]}
    ratio = (summary["stchp"]["send_rows_per_layer_pass"]
             / max(summary["hp"]["send_rows_per_layer_pass"], 1))
    log(f"  plans' send rows per layer pass: hp "
        f"{summary['hp']['send_rows_per_layer_pass']}, stchp "
        f"{summary['stchp']['send_rows_per_layer_pass']}; "
        f"volume_ratio_stchp_vs_hp {ratio:.4f}")

    # the kernels on the padded batch plan with the longest pad chain
    tr_a, batches_a, rep_a, _ = runs[("hp", "a2a")]
    tr_r, batches_r, _, _ = runs[("hp", "ragged")]
    j = int(np.argmax([max(int((p.el - p.lnnz).max()),
                           int((p.eh - p.hnnz).max())) for p in tr_a.plans]))
    for what, trn, bt in (("a2a", tr_a, batches_a[j]),
                          ("ring", tr_r, batches_r[j])):
        inner = trn.inner
        inner.pa, inner.model.fwd_static = bt.pa, bt.fwd_static
        fused_err = max(fused_err, check_launches(
            f"hp batch plan {j} (longest pad chain) GCN {what} step",
            record_launches(lambda: gcn_train_pass(inner, bt.data))))

    # the epoch sweep (no readback between steps) == stepwise
    trf, _ = build(pvs["hp"], "a2a")
    t0 = time.perf_counter()
    fl, _ = counted(lambda: trf.run_epochs_fused(feats, labels, epochs=3))
    t_sweep = (time.perf_counter() - t0) / 3
    same = fl.tolist() == rep_a["loss_history"] and all(
        torch.equal(x, y) for x, y in zip(trf.inner.params,
                                          runs[("hp", "a2a")][3]))
    log(f"  run_epochs_fused (3 epochs) == fit's stepwise run bit for bit "
        f"(losses {fl.tolist()}, weights): {same}; {t_sweep!r} s an epoch "
        f"(host clock, one readback an epoch) against fit's "
        f"{rep_a['epoch_s']!r}")
    if not same:
        raise AssertionError("phase 27: the epoch sweep != stepwise")

    # per-batch step time (CUDA events), the device's split and idle share
    run_epoch = (lambda: [trf._run(b) for b in trf._fused_batches])
    ms = cuda_ms(run_epoch, reps=1, warmup=0) / len(trf._fused_batches)
    log(f"  hp GCN a2a: {ms!r} ms a batch step (CUDA events over one epoch "
        f"of {len(trf._fused_batches)} steps, no readback); card: {smi}")
    split = device_split("hp GCN a2a mini-batch epoch", run_epoch, reps=1,
                         what="epochs")

    # GAT and the bf16 GCN on hp
    trg, batches_g = build(pvs["hp"], "a2a", "gat")
    ps = pad_stats(trg.plans, "gat")
    rep_g, got = counted(lambda: trg.fit(feats, labels, epochs=3, warmup=0,
                                         verbose=False))
    steps = 3 * len(batches_g)
    want_g = {"k5": steps * 2 * gat_passes(widths),
              "gat_bwd": steps * gat_passes(widths),
              "pack": steps * 2 * pack_launches("gat", "a2a", widths),
              "fused": 0, "k1": 0}
    hist = rep_g["loss_history"]
    log(f"  hp GAT a2a: losses {hist}; epoch_s {rep_g['epoch_s']!r}; "
        f"launches {json.dumps({x: got[x] for x in want_g})}, expected "
        f"{json.dumps(want_g)} (per step 2 directions x "
        f"{gat_passes(widths)} K5 passes, "
        f"{2 * pack_launches('gat', 'a2a', widths)} packs); combined "
        f"envelope {trg.plans[0].cell_buckets} ctl {trg.plans[0].ctl}; pad "
        f"share {ps['pad_share']:.4f}, longest pad chain {ps['pad_chain']}; "
        f"plans {trg.plan_build_s!r} s, layouts {trg.layout_s!r} s (host)")
    if any(got[x] != v for x, v in want_g.items()) \
            or not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError("phase 27: hp GAT launches or losses")
    bg = batches_g[j]
    trg.inner.pa, trg.inner.model.fwd_static = bg.pa, bg.fwd_static
    k5_err = check_gat_passes(record_gat_passes(
        lambda: gat_train_pass(trg.inner, bg.data)),
        f"hp batch plan {j} GAT step")
    log(f"  hp batch plan {j} GAT step: every K5 pass == plain bit for bit")
    trb, _ = build(pvs["hp"], "a2a", dtype="bfloat16")
    rep_b, got = counted(lambda: trb.fit(feats, labels, epochs=3, warmup=0,
                                         verbose=False))
    steps = 3 * len(trb.plans)
    want_b = {"fused_bf16": steps * per_step, "fused": 0,
              "pack": steps * per_step, "k1_bf16": 0, "k1": 0}
    hist, h32 = rep_b["loss_history"], rep_a["loss_history"]
    band = np.allclose(hist, h32, rtol=0.05, atol=0.02)
    log(f"  hp GCN compute_dtype=bfloat16 a2a: losses {hist} (float32 "
        f"{h32}: in the reference's bf16 band rtol 0.05 / atol 0.02: "
        f"{band}); epoch_s {rep_b['epoch_s']!r}; launches "
        f"{json.dumps({x: got[x] for x in want_b})}, expected "
        f"{json.dumps(want_b)}")
    if any(got[x] != v for x, v in want_b.items()) or not band \
            or not np.isfinite(hist).all():
        raise AssertionError("phase 27: hp GCN bf16 launches or losses")

    # evaluation on the full graph's plan, on the card
    t0 = time.perf_counter()
    (loss_e, acc_e), got = counted(lambda: tr_a.evaluate_fullgraph(
        feats, labels))
    ev = tr_a._fullgraph_eval[1]
    log(f"  hp evaluate_fullgraph on the full plan (B {ev.plan.b}, on "
        f"{ev.device}): loss {loss_e!r}, accuracy {acc_e!r} "
        f"({time.perf_counter() - t0:.2f} s with its plan); launches pack "
        f"{got['pack']}, fused {got['fused']} (expected {len(widths)} each)")
    if not (np.isfinite(loss_e) and 0 <= acc_e <= 1
            and ev.device.type == dev.type and got["pack"] == len(widths)
            and got["fused"] == len(widths)):
        raise AssertionError("phase 27: evaluate_fullgraph")

    # ---- (c) the cora CLIs: SHP's stchp parts into the train CLI's -n 512
    t0 = time.perf_counter()
    try:
        waves = cli_future.result()
    finally:
        cli_pool.shutdown()
    log(f"  the cora CLI children ran beside (b); {time.perf_counter() - t0:.2f}"
        " s waited for them here")
    for nm, (code, t_spawn, res) in waves.items():
        if code != 0:
            raise AssertionError(f"phase 27: child {nm} exited {code}")
        for key in total:
            total[key] += res["launches"][key]
        log(f"  {nm} child: start-up {res['t_imported'] - t_spawn:.2f} s, "
            f"in the CLI {res['t_end'] - res['t_imported']:.2f} s")
    if len(waves) != 5:
        raise AssertionError(f"phase 27: children {sorted(waves)} ran")
    lines = waves["shp"][2]["stdout"].strip().splitlines()
    log("  shp CLI: " + " | ".join(lines))
    if len(lines) != 2 or not (
            lines[0].startswith(f"hp: {MB_DIR}/partvec.hp.8  km1=")
            and lines[1].startswith(f"stchp: {stchp}  km1=")):
        raise AssertionError(f"phase 27: the SHP CLI printed {lines}")
    c_step = 2 + backward_passes(1433, [16, 7])
    nb_c = 3 * (2708 // 512 + 1)

    def losses_of(text):
        return [float(x.split()[-1]) for x in text.splitlines()
                if x.startswith("epoch ")]

    cli = {}
    for s_ in ck:
        (full, rep_c), got = counted(lambda: run_train_cli(
            base + ["--comm-schedule", s_, "--epochs", "3"]))
        f_, r_ = waves[f"train-{s_}"][2], waves[f"resume-{s_}"][2]
        seam = losses_of(f_["stdout"]) + losses_of(r_["stdout"])
        want = {"train": (1 + 2 * nb_c) * c_step, "resume": nb_c * c_step,
                "full": (1 + 3 * nb_c) * c_step}
        have = {"train": f_["launches"]["fused"],
                "resume": r_["launches"]["fused"], "full": got["fused"]}
        packs = {"train": f_["launches"]["pack"],
                 "resume": r_["launches"]["pack"], "full": got["pack"]}
        log(f"  cora -n 512 {s_} ({rep_c['nbatches']} batches, "
            f"{rep_c['comm_schedule']}): 2 epochs + resume to 3 {seam}; "
            f"uninterrupted {full}; resumed at {r_['report']['resumed']}; "
            f"fused launches {have}, packs {packs}, expected {want}")
        if (seam != full or rep_c["nbatches"] != nb_c
                or r_["report"]["resumed"]["step"] != 2
                or have != want or packs != want):
            raise AssertionError(f"phase 27: cora -n 512 {s_}: the resume or "
                                 "the launches")
        cli[s_] = full
    if cli["a2a"] != cli["ragged"]:
        raise AssertionError("phase 27: cora -n 512 ring != a2a")
    log(f"  cora -n 512: ring == a2a ({cli['a2a']})")
    summary["split"] = split
    summary["step_ms"] = ms
    summary["shp_s"] = shp_wall
    summary["sim_comm_volume"] = {x: shp[f"sim_comm_volume_{x}"]
                                  for x in ("hp", "stchp")}
    summary["volume_ratio_stchp_vs_hp"] = ratio
    log(f"  mini-batch summary: {json.dumps(summary)}; card: {smi}")
    if total["k1"] or total["k1_bf16"]:
        raise AssertionError(f"phase 27: K1 family launches {total}")
    log(f"  phase 27 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, fused_err, k5_err


# ------------------------------------------------ phase 28: sub-graph serving
SUB_DIR = os.path.join(REPO, "build", "chip_smoke_subgraph")
# the flagship's batch sizes, batches a size, and the queries of the
# p50/p99 comparison against full mode
SUB_QUERIES, SUB_BATCHES, SUB_LOADGEN = (1, 8, 32), 3, 128
# the routed-logit contract of sub-graph mode against the full engine
# (README): the aggregation repeats the full chains bit for bit; the dense
# projections run at another row count, where cuBLAS may pick another GEMM
# (cora's 1433 → 16 layer: rows 1.2e-7 apart at most on an H100, 1.2e-5
# relative; the DCSBM flagship's 128-wide layers: ==), and on the bf16
# wire a last-bit change of a projected row can move its bf16 rounding by
# one bf16 step (1.0e-5 apart at most) — rows within these tolerances, the
# measured gaps printed
SUB_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bf16 wire": dict(rtol=1e-3, atol=1e-4)}


def gap_stats(got, want):
    """(max |got − want|, max |got − want| / |want| over |want| > 1e-3)."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - want)
    big = np.abs(want) > 1e-3
    return float(d.max()), float((d[big] / np.abs(want[big])).max()
                                 if big.any() else 0.0)


@contextlib.contextmanager
def record_subgraph_launches():
    """Record the inputs and outputs of every fused-entry and K5 launch the
    compact forwards make (``serve/subgraph.py``'s names), to hold each
    against its plain version afterwards; launches nothing itself."""
    from sgcn_tpu_torch.serve import subgraph as sg

    real = (sg.spmm_tiles_fused, sg.gat_tiles_pass)
    calls = {"fused": [], "k5": []}

    def fused(*args):
        out = real[0](*args)
        calls["fused"].append((args, out))
        return out

    def k5(*args):
        out = real[1](*args)
        calls["k5"].append((args, out))
        return out

    sg.spmm_tiles_fused, sg.gat_tiles_pass = fused, k5
    try:
        yield calls
    finally:
        sg.spmm_tiles_fused, sg.gat_tiles_pass = real


def check_subgraph_launches(calls, what):
    """Each recorded compact launch == its plain version, bit for bit;
    returns the max |kernel − plain| (0)."""
    import torch

    from sgcn_tpu_torch.ops.tile_spmm import (spmm_tiles_classes_plain,
                                              spmm_tiles_fused_plain)

    for name, (args, out) in [("fused", c) for c in calls["fused"]] + [
            ("K5", c) for c in calls["k5"]]:
        if name == "fused":
            plain = spmm_tiles_fused_plain(*args)
        else:
            *tiles, table, cls, tb, rows = args
            plain = spmm_tiles_classes_plain(*tiles, table, cls, tb)[:, :rows]
        torch.cuda.synchronize()
        if not same_bits(out, plain):
            raise AssertionError(f"{what}: compact {name} launch != plain, "
                                 f"max diff {(out - plain).abs().max()}")
    log(f"  {what}: {len(calls['fused'])} fused and {len(calls['k5'])} K5 "
        "compact launches == plain bit for bit")
    return 0.0


def phase_subgraph(parts_bg, ahat_dc, ahat_c, feats_c, pv_c, dev, smi):
    """Phase 28 (module docstring): sub-graph serving on cora and on the
    DCSBM flagship's hp parts in this process, the serve CLI's sub-graph
    children beside them.  Returns the launch counts of its paths by
    kernel entry and the compact launches' max |kernel − plain|."""
    children = Children()
    try:
        return _phase_subgraph(children, parts_bg, ahat_dc, ahat_c, feats_c,
                               pv_c, dev, smi)
    finally:
        children.stop()


def _phase_subgraph(children, parts_bg, ahat_dc, ahat_c, feats_c, pv_c, dev,
                    smi):
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sgcn_tpu_torch.models import gat as gat_model
    from sgcn_tpu_torch.models.gcn import params_from_jax
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.serve import (ServeEngine, run_loadgen,
                                      synthetic_query_ids)

    t_phase = time.perf_counter()
    total = {key: 0 for key in launch_counts()}

    def counted(run):
        launch_counts(zero=True)               # a main-path run starts here
        out = run()
        torch.cuda.synchronize()
        got = launch_counts()                  # ... and ends here
        for key in total:
            total[key] += got[key]
        return out, got

    # ---- (c) the serve CLI's sub-graph mode in children, on a host
    # thread beside (a) and (b): cora from phase 24's GCN checkpoint (plain,
    # --concurrent, --shed-factor 2; full mode with both flags) and the ER
    # flagship from phase 23's GAT checkpoint
    shutil.rmtree(SUB_DIR, ignore_errors=True)
    os.makedirs(SUB_DIR)
    amtx = os.path.join(PIPE_DIR, "cora.A.mtx")
    cora_cli = ["-a", amtx, "-p", f"{amtx}.8.hp", "-s", "8", "--features-mtx",
                os.path.join(PIPE_DIR, "cora.H.mtx"), "--checkpoint",
                os.path.join(PIPE_DIR, "a2a.npz"), "--queries", "128",
                "--max-batch", "32", "--device", "cuda"]
    sub = ["--serve-mode", "subgraph"]
    jobs = [("sub-gcn", cora_cli + sub),
            ("sub-gcn-concurrent", cora_cli + sub + ["--concurrent"]),
            ("sub-gcn-shed", cora_cli + sub + ["--shed-factor", "2"]),
            ("full-gcn-concurrent-shed", cora_cli + [
                "--concurrent", "--shed-factor", "2"]),
            ("sub-gat-flagship", [
                "--npz", os.path.join(CKPT_DIR, "flagship.npz"), "-p",
                os.path.join(CKPT_DIR, "flagship.8.rp"), "-s", "8",
                "--checkpoint", os.path.join(CKPT_DIR, "gat-a2a.final.npz"),
                "--queries", "64", "--max-batch", "32", "--device", "cuda",
                "--concurrent", "--shed-factor", "2"] + sub)]

    def run_children():
        procs = children.start([("serve", argv, None,
                                 os.path.join(SUB_DIR, f"{nm}.json"))
                                for nm, argv in jobs])
        codes = children.join(procs)
        out = {}
        for (_, t_spawn), (nm, _), code in zip(procs, jobs, codes):
            res = None
            if code == 0:
                with open(os.path.join(SUB_DIR, f"{nm}.json")) as fh:
                    res = json.load(fh)
            out[nm] = (code, t_spawn, res)
        return out

    cli_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="clis")
    cli_future = cli_pool.submit(run_children)

    # ---- (a) cora2708 8-hp: GCN 1433 -> 16 -> 7 (both transports, the
    # bf16 wire) and GAT (both transports), sub-graph against the float64
    # forward and the full engine
    t_part = time.perf_counter()
    widths_c = [16, 7]
    dims_c = list(zip([1433] + widths_c[:-1], widths_c))
    plan_c = build_comm_plan(ahat_c, pv_c, 8)
    q_rng = np.random.default_rng(21)
    gap, same, kerr = {}, True, 0.0
    for model, sched, halo in (("gcn", "a2a", None), ("gcn", "ragged", None),
                               ("gcn", "a2a", "bfloat16"),
                               ("gat", "a2a", None), ("gat", "ragged", None)):
        if model == "gat":
            p_np = gat_params_numpy(31, dims_c)
            params = gat_model.params_from_jax(p_np)
            want64 = gat64(ahat_c, feats_c, p_np)
        else:
            p_np = glorot_numpy(31, dims_c)
            params = params_from_jax(p_np)
            want64 = oracle_forward(ahat_c, feats_c, p_np)
        kw = dict(fin=1433, widths=widths_c, model=model, params=params,
                  comm_schedule=sched, halo_dtype=halo, max_batch=32,
                  device=dev)
        full = ServeEngine(plan_c, **kw)
        full.set_features(feats_c)
        eng = ServeEngine(plan_c, mode="subgraph", **kw)
        counted(lambda: eng.set_features(feats_c))   # GAT: the stabilizers
        name = f"cora {model} {sched}" + (" bf16 wire" if halo else "")
        g, eq, nrow, e64 = (0.0, 0.0), True, 0, 0.0
        sub_tol = SUB_TOL["bf16 wire" if halo else "float32"]
        for nq in (1, 8, 32, 32):
            q = q_rng.permutation(plan_c.n)[:nq]
            got, ln = counted(lambda: eng.query(q))
            rows_full, _ = counted(lambda: full.query(q))
            want = {"pack": 0, "k1": 0, "k1_bf16": 0}
            if model == "gat":
                want.update(k5=gat_passes(widths_c), fused=0)
            else:
                want["fused_wire" if halo else "fused"] = len(widths_c)
            if any(ln[x] != v for x, v in want.items()):
                raise AssertionError(f"phase 28: {name} batch of {nq}: "
                                     f"launches {ln}, expected {want}")
            tol = (dict(rtol=5e-3, atol=5e-3) if halo
                   else dict(rtol=RTOL, atol=ATOL))
            e64 = max(e64, float(np.abs(got - want64[q]).max()))
            if not np.allclose(got, want64[q], **tol):
                raise AssertionError(f"phase 28: {name} rows vs float64")
            if not np.allclose(got, rows_full, **sub_tol):
                raise AssertionError(
                    f"phase 28: {name} rows vs the full engine: max gap "
                    f"{gap_stats(got, rows_full)} (abs, rel)")
            g = tuple(map(max, g, gap_stats(got, rows_full)))
            eq = eq and np.array_equal(got, rows_full)
            nrow += nq
        gap[name], same = g, same and eq
        gz = eng.gauges()
        log(f"  {name}: {nrow} routed rows vs float64 within "
            f"{'5e-3' if halo else 'rtol 1e-4 / atol 1e-5'} (max abs err "
            f"{e64:.3g}); vs the full engine max gap (abs, rel) {g!r} (== "
            f"in every batch: {eq}); touched rows "
            f"a query {gz['touched_rows_per_query']}, recipe edges "
            f"{gz['recipe_edges_total']}, flops a query "
            f"{gz['subgraph_flops_per_query']} vs a full forward's "
            f"{gz['full_forward_flops']}; launches a batch: "
            + ("K5 passes" if model == "gat" else "fused, no pack"))

    # ---- (b) the DCSBM flagship on phase 24's hp parts, 128 -> 128 ->
    # 128 -> 40, GCN and GAT: batches of 1, 8 and 32 queries
    log(f"  (a) took {time.perf_counter() - t_part:.1f} s")
    n = ahat_dc.shape[0]
    t0 = time.perf_counter()
    pv = parts_bg.result()[("hp", 0)][0]
    t_wait = time.perf_counter() - t0
    plan = build_comm_plan(ahat_dc, pv, PART_K)
    log(f"  DCSBM hp plan {time.perf_counter() - t0 - t_wait:.2f} s (host; "
        f"phase 24's parts, {t_wait:.2f} s waited for them)")
    feats = np.random.default_rng(2).standard_normal((n, 128)).astype(
        np.float32)
    widths = [128, 128, 40]
    dims = list(zip([128] + widths[:-1], widths))
    summary = {}
    for model in ("gcn", "gat"):
        t_part = time.perf_counter()
        params = (gat_model.params_from_jax(gat_params_numpy(33, dims))
                  if model == "gat"
                  else params_from_jax(glorot_numpy(33, dims)))
        kw = dict(fin=128, widths=widths, model=model, params=params,
                  comm_schedule="a2a", max_batch=32, device=dev)
        t0 = time.perf_counter()
        full = ServeEngine(plan, **kw)
        full.set_features(feats)
        t_full = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = ServeEngine(plan, mode="subgraph", **kw)
        counted(lambda: eng.set_features(feats))
        log(f"  DCSBM hp {model.upper()}: full engine {t_full:.2f} s, "
            f"sub-graph engine (index, stabilizers) "
            f"{time.perf_counter() - t0:.2f} s (host)")
        per = {}
        for nq in SUB_QUERIES:
            rows = {"host_ms": [], "device_ms": [], "touched": [],
                    "edges": []}
            g, eq = (0.0, 0.0), True
            for b in range(SUB_BATCHES):
                q = q_rng.permutation(n)[:nq]
                t0 = time.perf_counter()
                batch = eng.subgraph_batch(q)
                rows["host_ms"].append((time.perf_counter() - t0) * 1e3)
                last = nq == SUB_QUERIES[-1] and b == SUB_BATCHES - 1
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

                def run():
                    ev[0].record()
                    out = eng.run_subgraph(batch)
                    ev[1].record()
                    return out.cpu().numpy()[:nq]

                if last:        # the largest batch: every launch vs plain
                    with record_subgraph_launches() as calls:
                        got, ln = counted(run)
                    kerr = max(kerr, check_subgraph_launches(
                        calls, f"DCSBM hp {model.upper()} batch of {nq}"))
                else:
                    got, ln = counted(run)
                rows["device_ms"].append(ev[0].elapsed_time(ev[1]))
                rows["touched"].append(batch.touched_rows / nq)
                rows["edges"].append(batch.recipe_edges / nq)
                want = {"pack": 0, "k1": 0, "k1_bf16": 0,
                        "fused": 0 if model == "gat" else len(widths),
                        "k5": gat_passes(widths) if model == "gat" else 0}
                if any(ln[x] != v for x, v in want.items()):
                    raise AssertionError(f"phase 28: DCSBM {model} batch of "
                                         f"{nq}: launches {ln}, expected "
                                         f"{want}")
                full_rows, _ = counted(lambda: full.query(q))
                if not (np.isfinite(got).all() and np.allclose(
                        got, full_rows, **SUB_TOL["float32"])):
                    raise AssertionError(
                        f"phase 28: DCSBM {model} rows vs the full engine: "
                        f"max gap {gap_stats(got, full_rows)} (abs, rel)")
                g = tuple(map(max, g, gap_stats(got, full_rows)))
                eq = eq and np.array_equal(got, full_rows)
            same = same and eq
            gap[f"DCSBM hp {model} {nq}"] = g
            per[nq] = {key: statistics.median(v) for key, v in rows.items()}
            log(f"  DCSBM hp {model.upper()} batches of {nq} ({SUB_BATCHES}):"
                f" host build ms {rows['host_ms']!r}, device ms (CUDA events:"
                f" upload + compact forward + gather) {rows['device_ms']!r}; "
                f"touched rows a query {rows['touched']!r}, recipe edges a "
                f"query {rows['edges']!r}; vs the full engine max gap (abs, "
                f"rel) {g!r} (== in every batch: {eq})")
        gz = eng.gauges()
        log(f"  DCSBM hp {model.upper()}: flops a query "
            f"{gz['subgraph_flops_per_query']} vs a full forward's "
            f"{gz['full_forward_flops']} "
            f"({gz['subgraph_flops_per_query'] / gz['full_forward_flops']:.4g}"
            f"); launches a batch: "
            + (f"{gat_passes(widths)} K5" if model == "gat"
               else f"{len(widths)} fused") + ", no pack, no K1 family")
        # p50 / p99, sub-graph against full mode on the same queries, in
        # turns full, sub-graph, sub-graph, full
        qids = synthetic_query_ids(n, SUB_LOADGEN, seed=9)
        lat = {"full": [], "subgraph": []}
        for e in (full, eng):
            counted(lambda: e.warmup(qids))
        for mode_, e in (("full", full), ("subgraph", eng),
                         ("subgraph", eng), ("full", full)):
            res, _ = counted(lambda: run_loadgen(e, qids))
            s = res.summary()
            lat[mode_].append((s["latency_p50_ms"], s["latency_p99_ms"],
                               s["achieved_qps"]))
        log(f"  DCSBM hp {model.upper()} closed loop, {SUB_LOADGEN} queries "
            f"at batch 32, (p50 ms, p99 ms, QPS) by run: full "
            f"{lat['full']}, sub-graph {lat['subgraph']}")
        q32 = q_rng.permutation(n)[:32]
        wall, dev_ms, _top = device_busy(lambda: eng.query(q32), reps=5)
        idle = (1 - dev_ms / wall) if dev_ms else None
        log(f"  DCSBM hp {model.upper()} sub-graph, 5 batches of 32 under "
            f"torch.profiler: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
            f"idle share <= {idle}")
        summary[model] = {"per_batch": per, "latency": lat, "idle_le": idle,
                          "flops_per_query": gz["subgraph_flops_per_query"],
                          "full_forward_flops": gz["full_forward_flops"]}
        log(f"  (b) {model.upper()} took {time.perf_counter() - t_part:.1f} s")

    # ---- (c) read the children
    t0 = time.perf_counter()
    res = cli_future.result()
    cli_pool.shutdown()
    log(f"  children: {time.perf_counter() - t0:.2f} s waited for them here")
    for nm, (code, t_spawn, r) in res.items():
        if code != 0:
            raise AssertionError(f"phase 28: child {nm} exited {code}")
        rep, ln = r["report"], r["launches"]
        for key in total:
            total[key] += ln[key]
        gat = nm.endswith("flagship")
        nl = len(rep["widths"])
        if rep["serve_mode"] == "subgraph":
            batches = rep["subgraph_batches_total"]
            want = {"pack": rep["forwards"] * pack_launches(
                        "gat", "a2a", rep["widths"]) if gat else 0,
                    "fused": 0 if gat else nl * batches,
                    "k5": gat_passes(rep["widths"]) * (
                        batches + rep["forwards"]) if gat else 0}
        else:
            want = {"pack": nl * rep["forwards"], "fused": nl * rep["forwards"],
                    "k5": 0}
        total_q = 64 if gat else 128
        log(f"  {nm} child: start-up {r['t_imported'] - t_spawn:.2f} s, in "
            f"the CLI {r['t_end'] - r['t_imported']:.2f} s; {rep['queries']} "
            f"served + {rep['shed']} shed in {rep['batches']} batches, p50 "
            f"{rep['latency_p50_ms']} ms, p99 {rep['latency_p99_ms']} ms, "
            f"{rep['achieved_qps']} QPS, concurrent {rep['concurrent']}; "
            + (f"touched rows a query {rep['touched_rows_per_query']}; "
               if rep["serve_mode"] == "subgraph" else "")
            + f"launches {json.dumps({x: ln[x] for x in want})}, expected "
            f"{json.dumps(want)}")
        if (rep["weights"] != "checkpoint"
                or rep["queries"] + rep["shed"] != total_q
                or any(ln[x] != v for x, v in want.items())
                or ln["k1"] or ln["k1_bf16"]
                or not np.isfinite([rep["latency_p50_ms"],
                                    rep["latency_p99_ms"]]).all()):
            raise AssertionError(f"phase 28: child {nm}: {rep}, launches "
                                 f"{ln}")
    if total["k1"] or total["k1_bf16"]:
        raise AssertionError(f"phase 28: K1 family launches {total}")
    log(f"  sub-graph vs full max gaps {json.dumps(gap)}; == in every batch "
        f"measured: {same}; summary {json.dumps(summary)}; card: {smi}")
    log(f"  phase 28 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, kerr


# ------------------------------------- phase 29: run telemetry, memory, remat
TEL_DIR = os.path.join(REPO, "build", "chip_smoke_telemetry")
# the card's band for a measured step's peak against the model's total:
# MEM_MODEL_TOL (2.5) is the reference's structural default; the model
# prices every mode phase 29 runs as an envelope, so a peak more than 5 %
# above the total is a buffer the model does not know about
MEM_CARD_TOL = 1.05


def phase_telemetry(plan, feats, labels, p_init, params_g, widths, fix,
                    dev, smi):
    """Phase 29 (module docstring): remat against the plain step and the
    memory joins at the flagship width under a ``RunRecorder``, the budget
    gate, then the cora train CLI with ``--metrics-out --profile`` and the
    serve CLI with ``--metrics-out --memory-budget`` in children.  Returns
    the launch counts of its paths by kernel entry."""
    children = Children()
    try:
        return _phase_telemetry(children, plan, feats, labels, p_init,
                                params_g, widths, fix, dev, smi)
    finally:
        children.stop()


def _phase_telemetry(children, plan, feats, labels, p_init, params_g,
                     widths, fix, dev, smi):
    import gc
    import shutil

    import torch

    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.obs import (MEM_MODEL_TOL, MemoryBudgetError,
                                    RunRecorder, classify_op,
                                    find_trace_files, load_run,
                                    summarize_trace)
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    t_phase = time.perf_counter()
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    os.makedirs(TEL_DIR)
    total = {key: 0 for key in launch_counts()}
    steps, nl = 1 + 3, len(widths)
    gc.collect()
    torch.cuda.synchronize()

    # ---- (a)+(b) GCN and GAT, a2a and ring: plain and remat from one
    # initial weight set, 1 warm-up + 3 steps under a RunRecorder each
    rows = {}
    for model in ("gcn", "gat"):
        for sched in ("a2a", "ragged"):
            runs = {}
            for remat in (False, True):
                name = f"{model} {sched}{' remat' if remat else ''}"
                rundir = os.path.join(TEL_DIR, name.replace(" ", "-"))
                kw = (dict(params=[w.copy() for w in p_init])
                      if model == "gcn" else
                      dict(model="gat", activation="none",
                           params=gat_from_numpy(params_g)))
                tr = FullBatchTrainer(plan, fin=128, widths=widths,
                                      comm_schedule=sched, remat=remat,
                                      device=dev, **kw)
                data = make_train_data(plan, feats, labels, device=dev)
                rec = RunRecorder(rundir, config={"phase": 29, "run": name},
                                  argv=[])
                rec.set_plan(plan)
                rec.set_backend(dev, parts=plan.k)
                tr.attach_recorder(rec)
                launch_counts(zero=True)        # the main path starts here
                k1_open()
                rep = tr.fit(data, epochs=3, warmup=1, verbose=False)
                k1_close()
                ln = launch_counts()            # ... and ends here
                rec.close()
                for key in total:
                    total[key] += ln[key]
                log_ = load_run(rundir)       # every record re-validated
                runs[remat] = {
                    "losses": [e["loss"] for e in log_.steps()],
                    "w": [p.detach().clone() for p in tr.model.parameters()],
                    "epoch_s": rep["epoch_s"], "ln": ln,
                    "join": tr.memory_join, "model": tr.memory,
                    "events": len(log_.events)}
                del tr, data
                gc.collect()
            plain, re_ = runs[False], runs[True]
            same = plain["losses"] == re_["losses"] and all(
                torch.equal(x, y) for x, y in zip(plain["w"], re_["w"]))
            log(f"  {model} {sched}: remat == plain bit for bit (losses of "
                f"{steps} steps, weights after): {same}; losses "
                f"{plain['losses']}")
            if not same:
                raise AssertionError(f"phase 29: {model} {sched} remat != "
                                     "plain")
            # exact launches: remat re-runs every forward launch once more
            if model == "gcn":
                bwd = backward_passes(128, widths)
                fwd = {"fused": nl, "pack": nl,
                       "ring": nl if sched == "ragged" else 0}
                want = {"fused": steps * (nl + bwd),
                        "pack": steps * (nl + bwd),
                        "sym_bwd": steps * bwd if sched == "a2a" else 0,
                        "ring": steps * nl if sched == "ragged" else 0,
                        "ring_bwd": steps * bwd if sched == "ragged" else 0,
                        "k5": 0, "gat_bwd": 0}
            else:
                gp = gat_passes(widths)
                pk = pack_launches("gat", sched, widths)
                fwd = {"k5": gp, "pack": pk}
                want = {"k5": steps * 2 * gp, "gat_bwd": steps * gp,
                        "pack": steps * 2 * pk, "fused": 0, "sym_bwd": 0,
                        "ring": 0, "ring_bwd": 0}
            want_re = {key: v + steps * fwd.get(key, 0)
                       for key, v in want.items()}
            for tag, run, w in (("plain", plain, want), ("remat", re_,
                                                         want_re)):
                got = {key: run["ln"][key] for key in w}
                log(f"  {model} {sched} {tag} launches {json.dumps(got)}")
                if got != w or run["ln"]["k1"] or run["ln"]["k1_bf16"]:
                    raise AssertionError(
                        f"phase 29: {model} {sched} {tag} launches {got}, "
                        f"expected {w}")
            # the memory joins: peak, arguments and alias
            for tag, run in (("plain", plain), ("remat", re_)):
                join, mm = run["join"], run["model"]
                blk = join["block"]
                meas = {key: blk[key]["measured_bytes"]
                        for key in ("total", "arguments", "donated")}
                rows[(model, sched, tag)] = {
                    "peak": meas["total"], "args": meas["arguments"],
                    "alias": meas["donated"], "epoch_s": run["epoch_s"],
                    "total_model": mm.total_bytes,
                    "families": {f: (e["model_bytes"], e["measured_bytes"])
                                 for f, e in blk["families"].items()}}
                ratio = meas["total"] / mm.total_bytes
                log(f"  {model} {sched} {tag}: memory model vs measured "
                    f"(B): " + json.dumps(rows[(model, sched, tag)])
                    + f"; peak / total {ratio:.4f} (MEM_MODEL_TOL "
                    f"{MEM_MODEL_TOL}, a structural default; the card's band "
                    f"{MEM_CARD_TOL}); {run['events']} events; card: {smi}")
                if join["violations"] or ratio > MEM_CARD_TOL:
                    raise AssertionError(f"phase 29: {model} {sched} {tag} "
                                         f"memory: {join['violations']}, "
                                         f"peak / total {ratio}")
            pk_plain = rows[(model, sched, "plain")]["peak"]
            pk_remat = rows[(model, sched, "remat")]["peak"]
            log(f"  {model} {sched}: a step's peak (max_memory_allocated "
                f"over the trainer's start) plain {pk_plain} B vs remat "
                f"{pk_remat} B ({pk_remat / pk_plain:.4f}); epoch_s plain "
                f"{plain['epoch_s']!r} vs remat {re_['epoch_s']!r} (3 timed "
                f"steps, host clock, recorder on); card: {smi}")
            # remat keeps one layer's intermediates at a time: GCN's peak
            # (the saved activations of every layer) drops; GAT's sits in
            # one layer's backward and must not rise
            if pk_remat > pk_plain * (0.95 if model == "gcn" else 1.0):
                raise AssertionError(f"phase 29: {model} {sched} remat "
                                     f"peak {pk_remat} vs plain {pk_plain}")

    # ---- (c) the budget gate: total − 1 fails before any tensor ships
    need = rows[("gcn", "a2a", "plain")]["total_model"]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        FullBatchTrainer(plan, fin=128, widths=widths, comm_schedule="a2a",
                         memory_budget=need - 1, device=dev)
    except MemoryBudgetError as e:
        msg = str(e)
    else:
        raise AssertionError("phase 29: memory_budget = total - 1 built")
    after = torch.cuda.memory_allocated()
    log(f"  memory_budget = total - 1 ({need - 1} B): MemoryBudgetError "
        f"({msg.splitlines()[0]!r}); memory_allocated {before} -> {after}")
    if after != before or "exceeds --memory-budget" not in msg:
        raise AssertionError("phase 29: the budget gate allocated or "
                             "changed its message")

    # ---- (c') the mini-batch trainer keeps every batch plan and batch on
    # the card: its measured step against the model of the whole set
    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.parallel.plan import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer
    a, fc, lc = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    ahat_c = normalize_adjacency(a)
    pv_c = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    mb = MiniBatchTrainer(ahat_c, pv_c, 8, fin=fc.shape[1], widths=[16, 7],
                          batch_size=1024, device=dev)
    rundir = os.path.join(TEL_DIR, "minibatch")
    rec = RunRecorder(rundir, config={"phase": 29, "run": "minibatch"},
                      argv=[])
    mb.attach_recorder(rec)
    launch_counts(zero=True)                    # a path of its own
    mb.fit(fc, lc, epochs=1, warmup=1, verbose=False)
    ln = launch_counts()
    rec.close()
    for key in total:
        total[key] += ln[key]
    load_run(rundir)                            # every record re-validated
    join, mm = mb.memory_join, mb.memory
    blk = join["block"]
    ratio = blk["total"]["measured_bytes"] / mm.total_bytes
    log(f"  cora mini-batch (batch 1024, {len(mb.plans)} batch plans, "
        "GCN 1433 -> 16 -> 7): memory model vs measured (B): "
        + json.dumps({f: (e["model_bytes"], e["measured_bytes"])
                      for f, e in blk["families"].items()})
        + f"; total {mm.total_bytes}, peak {blk['total']['measured_bytes']} "
        f"({ratio:.4f}), arguments {blk['arguments']['measured_bytes']} vs "
        f"{blk['arguments']['model_bytes']}; the envelope plan alone "
        f"prices {mb.inner.memory.total_bytes}; launches "
        f"{json.dumps({k: v for k, v in ln.items() if v})}; card: {smi}")
    if join["violations"] or ratio > MEM_CARD_TOL or not ln["fused"]:
        raise AssertionError(f"phase 29: mini-batch memory "
                             f"{join['violations']}, peak / total {ratio}, "
                             f"launches {ln}")
    del mb
    gc.collect()

    # ---- (d)+(e) the cora train CLI under --metrics-out --profile and the
    # serve CLI under --metrics-out --memory-budget, in children
    cora = ["--npz", os.path.join(fix, "cora2708.npz"), "--normalize", "-p",
            os.path.join(fix, "cora2708.8.hp"), "-s", "8"]
    run_t, prof = os.path.join(TEL_DIR, "cli-train"), \
        os.path.join(TEL_DIR, "cli-profile")
    run_s = os.path.join(TEL_DIR, "cli-serve")
    jobs = [("train", cora + ["-l", "2", "--hidden", "16", "--epochs", "5",
                              "--warmup", "1", "--metrics-out", run_t,
                              "--profile", prof]),
            ("serve", cora + ["--random-init", "--queries", "64",
                              "--max-batch", "32", "--metrics-out", run_s,
                              "--memory-budget", "8G"])]
    res = {}
    for attempt in range(3):
        # the profiler now and then records no device event: the train
        # child runs again (up to 3 times in all) when its trace has none
        todo = jobs if attempt == 0 else jobs[:1]
        for d in (run_t, prof, run_s)[:len(todo) + 1]:
            shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        procs = children.start([(m, argv, None,
                                 os.path.join(TEL_DIR, f"{m}.json"))
                                for m, argv in todo])
        codes = children.join(procs, timeout=300)
        log(f"  CLI children {[m for m, _ in todo]} "
            f"{time.perf_counter() - t0:.2f} s, exit codes {codes}")
        if any(codes):
            raise AssertionError(f"phase 29: CLI children exited {codes}")
        for m, _ in todo:
            with open(os.path.join(TEL_DIR, f"{m}.json")) as fh:
                res[m] = json.load(fh)
            for key in total:
                total[key] += res[m]["launches"][key]
        paths = find_trace_files(prof)
        if not paths:
            raise AssertionError(f"phase 29: no trace under {prof}")
        ts = summarize_trace(paths[0]["path"])
        if ts.on_device:
            break
        log(f"  the profiler recorded no device event (try {attempt + 1} "
            "of 3)")
    tlog, slog = load_run(run_t), load_run(run_s)
    if tlog.manifest.get("profile", {}).get("trace_files") != paths:
        raise AssertionError(f"phase 29: trace files {paths} vs manifest "
                             f"{tlog.manifest.get('profile')}")
    import gzip
    with gzip.open(paths[0]["path"], "rt") as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"}
    wrong = sorted(n for n in names
                   if ("tile_spmm" in n and classify_op(n) != "spmm")
                   or ("row_pack" in n and classify_op(n) != "exchange"))
    # the same cora configuration's step on CUDA events, in this process
    pc = build_comm_plan(ahat_c, pv_c, 8)
    trc = FullBatchTrainer(pc, fin=fc.shape[1], widths=[16, 7], device=dev)
    dc = make_train_data(pc, fc, lc, device=dev)
    launch_counts(zero=True)                    # a path of its own
    step_ms = cuda_ms(lambda: trc.step(dc, sync=False), reps=10, warmup=2)
    ln = launch_counts()
    for key in total:
        total[key] += ln[key]
    nsteps = len(tlog.steps())
    log(f"  cora train CLI: {nsteps} step events, trace "
        f"{os.path.basename(paths[0]['path'])} ({paths[0]['bytes']} B, "
        f"device tracks: {ts.on_device}); device s by class per step "
        + json.dumps({k: v for k, v in ts.per_step(nsteps).items()})
        + "; by label (whole run) " + json.dumps(ts.labels)
        + f"; the same step on CUDA events {step_ms!r} ms; card: {smi}")
    if not (ts.on_device and ts.classes["spmm"] > 0
            and ts.classes["exchange"] > 0) or wrong:
        raise AssertionError(f"phase 29: trace classes {ts.classes}, "
                             f"misclassified kernels {wrong}")
    # a fresh process's join: the train CLI child's manifest memory block
    tmem = tlog.manifest.get("memory", {})
    t_arg, t_tot = tmem.get("arguments", {}), tmem.get("total", {})
    log("  cora train CLI memory block: total "
        + json.dumps(t_tot) + ", arguments " + json.dumps(t_arg))
    if t_arg.get("measured_bytes") is None or \
            t_arg["measured_bytes"] > t_arg["model_bytes"] + 256 or \
            t_tot["measured_bytes"] > MEM_CARD_TOL * t_tot["model_bytes"]:
        raise AssertionError(f"phase 29: train CLI memory join {tmem}")
    serves = slog.serves()
    srep = res["serve"]["report"]
    log(f"  serve CLI: {len(serves)} serve event(s), memory block "
        + json.dumps(srep.get("memory")) + "; manifest memory total "
        + json.dumps(slog.manifest.get("memory", {}).get("total")))
    donated = slog.manifest.get("memory", {}).get("donated", {})
    smem = srep.get("memory") or {}
    if len(serves) != 1 or not smem.get("measured") or \
            donated.get("measured_bytes") != 0 or \
            smem["measured_peak_bytes"] > MEM_CARD_TOL * smem["model_bytes"]:
        raise AssertionError("phase 29: serve CLI telemetry (a forward "
                             f"aliases 0 B: {donated}; peak within "
                             f"{MEM_CARD_TOL} of the model: {smem})")
    log(f"  phase 29 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, rows


# ----------------------------------- phase 30: the broadcast baseline, the
# shard proxy and the rank runtime
RANKS_DIR = os.path.join(REPO, "build", "chip_smoke_ranks")


def sigmoid64(ahat, feats, params):
    """The broadcast baseline's float64 forward on the host:
    sigmoid((Â·H)·W) on every layer."""
    import numpy as np

    a = ahat.astype(np.float64)
    h = np.asarray(feats, np.float64)
    for w in params:
        h = 1.0 / (1.0 + np.exp(-((a @ h) @ np.asarray(w, np.float64))))
    return h


def event_ms(run, reps):
    """CUDA-event ms per call of ``run`` over ``reps`` calls (no warm-up:
    the caller warms up)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = [run() for _ in range(reps)]
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_ranks(plan, ahat_f, feats_f, labels_f, pv_f, p_init, params_g,
                widths, parts_bg, ahat_dc, ahat_c, feats_c, pv_c, k3, k3_dc,
                dev, tb, smi):
    """Phase 30 (module docstring): the CAGNET broadcast baseline, the
    shard proxy per chip and one NCCL rank of the rank runtime; ``k3`` and
    ``k3_dc`` are the partitioned forward's layer-0 times on the ER and
    DCSBM hp plans (phases 3 and 24).  Returns the launch counts of its
    paths by kernel entry and its measurements."""
    children = Children()
    try:
        return _phase_ranks(children, plan, ahat_f, feats_f, labels_f, pv_f,
                            p_init, params_g, widths, parts_bg, ahat_dc,
                            ahat_c, feats_c, pv_c, k3, k3_dc, dev, tb, smi)
    finally:
        children.stop()


def _phase_ranks(children, plan, ahat_f, feats_f, labels_f, pv_f, p_init,
                 params_g, widths, parts_bg, ahat_dc, ahat_c, feats_c, pv_c,
                 k3, k3_dc, dev, tb, smi):
    import gc
    import shutil

    import numpy as np
    import torch

    from sgcn_tpu_torch.__main__ import main as dispatch_main
    from sgcn_tpu_torch.baselines.cagnet1d import BroadcastGCN1D
    from sgcn_tpu_torch.io.config import ModelConfig, write_config
    from sgcn_tpu_torch.io.mtx import write_mtx
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.models.gcn import gcn_forward_local, params_from_jax
    from sgcn_tpu_torch.obs.tracing import kernel_label
    from sgcn_tpu_torch.parallel import (build_comm_plan, init_rank_group,
                                         shard_proxy_data, shard_proxy_plan)
    from sgcn_tpu_torch.train import (FullBatchTrainer, make_train_data,
                                      resolve_forward_setup)

    t_phase = time.perf_counter()
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    os.makedirs(RANKS_DIR)
    total = {key: 0 for key in launch_counts()}
    nl = len(widths)
    n_f = ahat_f.shape[0]
    gc.collect()

    # ---- the two baseline CLIs on cora in children (beside the rest):
    # the normalized Â and a config; all-ones features at width 16
    a_path = os.path.join(RANKS_DIR, "cora.A.mtx")
    write_mtx(a_path, ahat_c)
    write_config(os.path.join(RANKS_DIR, "config"),
                 ModelConfig(nlayers=2, nvtx=ahat_c.shape[0], widths=[16, 7]))
    cfg = os.path.join(RANKS_DIR, "config")
    cli_jobs = {
        "cagnet": ["cagnet", "-a", a_path, "-c", cfg, "-s", "8",
                   "--epochs", "3"],
        "oracle": ["oracle", "-a", a_path, "-c", cfg, "--epochs", "3"]}
    cli_procs = children.start([
        ("baselines", argv, None, os.path.join(RANKS_DIR, f"{name}.json"))
        for name, argv in cli_jobs.items()])

    # ---- (a) the broadcast baseline: cora2708 8-hp, 1433 -> 16 -> 7
    params_c = glorot_numpy(31, [(1433, 16), (16, 7)])
    bc = BroadcastGCN1D(ahat_c, pv_c, 8, fin=1433, widths=[16, 7],
                        params=params_c, device=dev)
    launch_counts(zero=True)                    # the main path starts here
    rows = bc.forward(feats_c)
    torch.cuda.synchronize()
    ln = launch_counts()                        # ... and ends here
    for key in total:
        total[key] += ln[key]
    want = sigmoid64(ahat_c, feats_c, params_c)
    plan_c = build_comm_plan(ahat_c, pv_c, 8)
    setup = resolve_forward_setup(plan_c)
    with torch.inference_mode():
        part = gcn_forward_local(
            params_from_jax(params_c, dev),
            torch.as_tensor(plan_c.scatter_rows(feats_c)).to(dev),
            setup.ship_arrays(plan_c, dev), activation="sigmoid",
            final_activation="sigmoid", **setup.fwd_static)
    part = plan_c.gather_rows(part.cpu().numpy())
    e64, epart = np.abs(rows - want).max(), np.abs(rows - part).max()
    log(f"  cora broadcast 1433 -> 16 -> 7 (sigmoid): max |rows - float64| "
        f"{e64:.3g}, max |rows - partitioned forward| {epart:.3g} (rtol "
        f"{RTOL} / atol {ATOL} each); launches {json.dumps(ln)}")
    if not (np.allclose(rows, want, rtol=RTOL, atol=ATOL)
            and np.allclose(rows, part, rtol=RTOL, atol=ATOL)) \
            or ln["k1"] != 2 or ln["pack"] != 2:
        raise AssertionError("phase 30: cora broadcast rows or launches")

    # ---- the flagship plans: phase 3's ER and phase 24's DCSBM hp parts
    t0 = time.perf_counter()
    pv_hp = parts_bg.result()[("hp", 0)][0]
    plan_dc = build_comm_plan(ahat_dc, pv_hp, PART_K)
    log(f"  DCSBM hp plan (phase 24's parts) {time.perf_counter() - t0:.2f} "
        "s (host)")
    flag = {"ER": (ahat_f, pv_f, plan), "DCSBM hp": (ahat_dc, pv_hp,
                                                     plan_dc)}
    bcast = {}
    k1_err = 0.0
    for name, (a_, pv_, full) in flag.items():
        t0 = time.perf_counter()
        bc = BroadcastGCN1D(a_, pv_, 8, fin=128, widths=widths,
                            params=p_init, device=dev)
        host_s = time.perf_counter() - t0
        h = torch.as_tensor(bc.plan.scatter_rows(feats_f)).to(dev)
        tiles = [bc.pa["tsrc"], bc.pa["tld"], bc.pa["tw"]]
        with torch.inference_mode():
            table = bc.gather(h)
            k1_err = max(k1_err, check_k1(
                tiles, table, bc.classes, tb,
                f"{name} broadcast local SpMM layer 0 f=128"))
        launch_counts(zero=True)                # the main path starts here
        r_split = bc.forward(feats_f)
        bc.fused = True
        r_fused = bc.forward(feats_f)
        torch.cuda.synchronize()
        ln = launch_counts()                    # ... and ends here
        for key in total:
            total[key] += ln[key]
        if not np.array_equal(r_split, r_fused) or \
                not np.isfinite(r_split).all() or \
                ln["k1"] != 2 * nl or ln["pack"] != 2 * nl:
            raise AssertionError(f"phase 30: {name} broadcast fused != "
                                 f"split, or launches {ln}")
        with torch.inference_mode():
            dc = time_pack(h, bc.pa["bcast_src"], h.dtype,
                           f"{name} broadcast data_comm layer 0")
            ls = time_k1([t.cpu().numpy() for t in tiles], tiles, table,
                         bc.classes, tb, table.shape[1],
                         f"{name} broadcast local SpMM layer 0")
            w0 = bc.params[0]
            layer = cuda_ms(lambda: bc.compute(w0, bc.gather(h)), reps=5)
        kp = k3 if name == "ER" else k3_dc
        wire = {"broadcast": (8 - 1) * n_f,
                "true": int(full.predicted_send_volume.sum()),
                "a2a": full.wire_rows_per_exchange("a2a"),
                "ring": full.wire_rows_per_exchange("ragged")}
        bcast[name] = {"data_comm": dc, "local_spmm": ls, "layer": layer,
                       "wire": wire, "host_s": host_s}
        log(f"  {name} broadcast (host build {host_s:.2f} s, B {bc.plan.b}, "
            f"classes {list(bc.classes)}): fused == split bit for bit; "
            f"per layer (f=128, CUDA events) data_comm {dc['ms']!r} ms, "
            f"local SpMM {ls['ms']!r} ms, whole layer (pack + K1 + matmul "
            f"+ sigmoid) {layer!r} ms; the partitioned forward's pack "
            f"{kp['pack']['ms']!r} ms and fused launch "
            f"{kp['fused']['ms']!r} ms (whole K3 {kp['ms']!r} ms); wire "
            f"rows an exchange: broadcast {wire['broadcast']}, a2a "
            f"{wire['a2a']}, ring {wire['ring']}, true {wire['true']} "
            f"(broadcast / a2a {wire['broadcast'] / wire['a2a']:.2f}); "
            f"card: {smi}")
        del bc, h, table, tiles
        gc.collect()

    # ---- (b) the shard proxy: every chip of both plans, GCN 1 + 3 steps
    def run(full, chip, model="gcn", sched="a2a", mesh=None):
        kw = (dict(params=[w.copy() for w in p_init]) if model == "gcn" else
              dict(model="gat", activation="none",
                   params=gat_from_numpy(params_g)))
        trp = full if chip is None else shard_proxy_plan(full, chip)
        data = (make_train_data(full, feats_f, labels_f, device=dev)
                if chip is None else
                shard_proxy_data(full, chip, feats_f, labels_f, device=dev))
        tr = FullBatchTrainer(trp, fin=128, widths=widths, comm_schedule=sched,
                              device=dev, mesh=mesh, **kw)
        first = tr.step(data)
        launch_counts(zero=True)                # the main path starts here
        ms, losses = event_ms(lambda: tr.step(data, sync=False), 3)
        ln = launch_counts()                    # ... and ends here
        for key in total:
            total[key] += ln[key]
        return {"ms": ms, "losses": [first] + [float(x) for x in losses],
                "w": [p.detach().clone() for p in tr.model.parameters()],
                "ln": ln, "tr": tr, "data": data}

    bwd = backward_passes(128, widths)
    want_gcn = {"fused": 3 * (nl + bwd), "pack": 3 * (nl + bwd),
                "sym_bwd": 3 * bwd, "k1": 0}
    proxy = {}
    for name, (_a, _pv, full) in flag.items():
        full.ensure_pallas_tiles(tb)
        stacked = run(full, None)
        per = []
        for chip in range(full.k):
            r = run(full, chip)
            got = {key: r["ln"][key] for key in want_gcn}
            ks = tuple(r["tr"].pa["recv_src"].shape)
            if got != want_gcn or ks != (1, full.k * full.s) or \
                    not np.isfinite(r["losses"]).all():
                raise AssertionError(f"phase 30: {name} proxy chip {chip}: "
                                     f"launches {got} (want {want_gcn}), "
                                     f"pack rows {ks}, losses {r['losses']}")
            per.append(r["ms"])
            if name == "ER" and chip == 0:
                proxy["er0"] = r
            del r
        proxy[name] = {"per_chip_ms": per, "max_ms": max(per),
                       "stacked_ms": stacked["ms"]}
        log(f"  {name} proxy GCN step ms by chip (CUDA events, 3 steps "
            f"each): {per!r}; max {max(per)!r} ms; the stacked 8-part step "
            f"{stacked['ms']!r} ms; one pack of k*S = {full.k * full.s} "
            f"rows per exchange, launches a chip {json.dumps(want_gcn)}")
        del stacked
        gc.collect()
    again = run(plan, 0)
    same = again["losses"] == proxy["er0"]["losses"] and all(
        torch.equal(a, b) for a, b in zip(again["w"], proxy["er0"]["w"]))
    log(f"  ER chip 0 proxy run twice: losses {again['losses']} == "
        f"{proxy['er0']['losses']} and weights equal: {same}")
    if not same:
        raise AssertionError("phase 30: the proxy's runs differ")
    del again
    plan.ensure_pallas_cell_tiles(tb)
    gat = run(plan, 0, model="gat")
    gp, pk = gat_passes(widths), pack_launches("gat", "a2a", widths)
    want_gat = {"k5": 3 * 2 * gp, "gat_bwd": 3 * gp, "pack": 3 * 2 * pk}
    got = {key: gat["ln"][key] for key in want_gat}
    log(f"  ER chip 0 proxy GAT: {gat['ms']!r} ms a step, losses "
        f"{gat['losses']}, launches {json.dumps(got)}")
    if got != want_gat or not np.isfinite(gat["losses"]).all():
        raise AssertionError(f"phase 30: proxy GAT launches {got}")
    proxy["gat0_ms"] = gat["ms"]
    del gat
    gc.collect()

    # ---- (c) one NCCL rank on chip 0's ER slice, both transports
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    mesh = init_rank_group("file://" + os.path.join(RANKS_DIR, "rendezvous"),
                           1, 0)
    nccl = {}
    try:
        for sched in ("a2a", "ragged"):
            ref_run = (proxy["er0"] if sched == "a2a"
                       else run(plan, 0, sched="ragged"))
            rk = run(plan, 0, sched=sched, mesh=mesh)
            same = rk["losses"] == ref_run["losses"] and all(
                torch.equal(a, b) for a, b in zip(rk["w"], ref_run["w"]))
            want_rk = {"k1": 3 * 2 * (nl + bwd), "pack": 3 * (nl + bwd),
                       "fused": 0}
            got = {key: rk["ln"][key] for key in want_rk}
            log(f"  one NCCL rank, chip 0's ER slice, {sched}: losses "
                f"{rk['losses']}; == the stacked proxy's bit for bit "
                f"(losses and weights): {same}; {rk['ms']!r} ms a step vs "
                f"the stacked proxy's {ref_run['ms']!r} ms; launches "
                f"{json.dumps(got)}")
            if not same or got != want_rk:
                raise AssertionError(f"phase 30: NCCL rank {sched}: same "
                                     f"{same}, launches {got}")
            nccl[sched] = {"ms": rk["ms"], "proxy_ms": ref_run["ms"]}
            if sched == "a2a":
                tr, data = rk["tr"], rk["data"]
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    tr.step(data)
                    torch.cuda.synchronize()
                evs = prof.key_averages()
                names = {e.key: [e.self_device_time_total,
                                 e.self_cpu_time_total]
                         for e in evs if "nccl" in e.key.lower()}
                labels = {k_: kernel_label(k_) for k_ in names}
                top = sorted(((e.self_device_time_total, e.key) for e in evs
                              if e.self_device_time_total > 0),
                             reverse=True)[:8]
                log(f"  NCCL on the trace (device us, host us): "
                    f"{json.dumps(names)}, KERNEL_TABLE labels "
                    f"{json.dumps(labels)}; NCCL kernels with device time: "
                    f"{sum(v[0] > 0 for v in names.values())}; the step's "
                    f"top device events {top}")
                if not names or any(v != "nccl" for v in labels.values()):
                    raise AssertionError("phase 30: no NCCL event on the "
                                         "trace, or one not labeled nccl")
            del rk, ref_run
    finally:
        mesh.close()

    # ---- the CLI children and the dispatcher
    codes = children.join(cli_procs, timeout=300.0)
    res = {}
    for name in cli_jobs:
        with open(os.path.join(RANKS_DIR, f"{name}.json")) as fh:
            res[name] = json.load(fh)
        log(f"  baselines {name} CLI child: {json.dumps(res[name]['report'])}"
            f"; launches {json.dumps(res[name]['launches'])}")
    cg, orc = res["cagnet"]["report"], res["oracle"]["report"]
    if codes != [0, 0] or cg["backend"] != "cuda" or \
            cg["send_volume_per_exchange"] != 7 * ahat_c.shape[0] or \
            cg["phases"]["data_comm"]["count"] != 6 or \
            res["cagnet"]["launches"]["k1"] != 6 or \
            orc["epochs"] != 3 or not np.isfinite(orc["final_loss"]):
        raise AssertionError(f"phase 30: baseline CLIs {codes}: {res}")
    for key in total:
        total[key] += res["cagnet"]["launches"][key]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dispatch_main([])
    tools = [line.split()[2] for line in buf.getvalue().splitlines()
             if line.strip().startswith("python -m")]
    log(f"  python -m sgcn_tpu_torch: exit {rc}, tools {tools}")
    if rc != 0 or "sgcn_tpu_torch.baselines" not in tools:
        raise AssertionError("phase 30: the dispatcher's map")
    log(f"  phase 30 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card: {smi}")
    return total, {"bcast": bcast, "proxy": proxy, "nccl": nccl,
                   "k1_err": k1_err}



RANK31_DIR = os.path.join(REPO, "build", "chip_smoke_rank_levers")

# phase 31's cases: name -> (model, transport, trainer levers)
RANK31_CASES = {
    "GAT a2a": ("gat", "a2a", {}),
    "GAT ring": ("gat", "ragged", {}),
    "GAT bf16 a2a": ("gat", "a2a", {"compute_dtype": "bfloat16"}),
    "GAT remat a2a": ("gat", "a2a", {"remat": True}),
    "GCN bf16 a2a": ("gcn", "a2a", {"compute_dtype": "bfloat16"}),
}


def rank_case_launches(model, sched, widths, lever, steps=3):
    """Exact launches per entry of ``steps`` training steps of a phase 31
    case on the rank path: a GAT layer's K5 passes by table form (fused 1,
    split 2 on float32 tables; packed: the bf16 ``u·z`` lanes and the
    float32 ``u`` lane; the backward ships the same forms, float32 but for
    the packed ``ḡ/D`` lanes), the forward run again in the backward
    under ``remat``; a GCN aggregation one pack and two K1 family
    launches (bf16 tables under ``compute_dtype``); no fused launch."""
    from sgcn_tpu_torch.models.gat import gat_table_form

    cd = lever.get("compute_dtype")
    fwd_runs = 2 if lever.get("remat") else 1
    if model == "gcn":
        aggs = fwd_runs * len(widths) + backward_passes(128, widths)
        return {"pack": steps * aggs,
                "k1_bf16" if cd else "k1": steps * 2 * aggs, "fused": 0,
                "fused_bf16": 0, "k5": 0}
    fwd32 = fwd16 = bwd32 = bwd16 = 0
    for w in widths:
        form = gat_table_form(w, cd)
        if form == "packed":
            fwd32, fwd16, bwd32, bwd16 = (fwd32 + 1, fwd16 + 1, bwd32 + 1,
                                          bwd16 + 1)
        else:
            n = 2 if form == "split" else 1
            if cd:
                fwd16 += n
            else:
                fwd32 += n
            bwd32 += n
    packs = pack_launches("gat", sched, widths, cd)
    return {"k5": steps * (fwd_runs * fwd32 + bwd32),
            "k5_bf16": steps * (fwd_runs * fwd16 + bwd16),
            "gat_bwd": steps * (bwd32 + bwd16),
            "pack": steps * packs * (fwd_runs + 1), "fused": 0, "k1": 0,
            "k1_bf16": 0}


def phase_rank_levers(plan, feats_f, labels_f, p_init, params_g, widths,
                      fix, dev, tb, smi):
    """Phase 31 (module docstring): GAT, bf16 and remat on one NCCL rank
    against the stacked proxy, and the cora train CLI under
    ``torch.distributed.run``.  Returns the launch counts of the rank
    path by kernel entry and its measurements."""
    import shutil

    from sgcn_tpu_torch.obs import load_run

    t_phase = time.perf_counter()
    shutil.rmtree(RANK31_DIR, ignore_errors=True)
    os.makedirs(RANK31_DIR)
    total = {key: 0 for key in launch_counts()}

    # ---- (b) first: the cora CLI under torchrun, in children beside (a)
    cli_base = ["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8", "-l",
                "2", "--hidden", "16", "--epochs", "3", "--warmup", "0"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SGCN_METRICS_OUT"):
        env.pop(var, None)
    procs = {}
    for model in ("gcn", "gat"):
        d = os.path.join(RANK31_DIR, model)
        argv = cli_base + ["--model", model, "--metrics-out", d + "-run",
                           "--checkpoint-dir", d + "-ck"]
        out = open(d + ".out", "w")
        procs[model] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "sgcn_tpu_torch.train", *argv],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT), out, d)

    try:
        t0 = time.perf_counter()
        rank = _rank_levers(plan, feats_f, labels_f, p_init, params_g,
                            widths, dev, tb, smi, total)
        log(f"  (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # the unlaunched CLI, here, beside the launched children
        cli = {}
        for model, (proc, out, d) in procs.items():
            _l, want = run_train_cli(cli_base + [
                "--model", model, "--checkpoint-dir", d + "-ck1"])
            code = proc.wait(timeout=300)
            out.close()
            with open(d + ".out") as fh:
                text = fh.read()
            lines = [x for x in text.splitlines() if x.startswith("{")]
            if code != 0 or not lines:
                raise AssertionError(f"phase 31: torchrun {model} CLI exit "
                                     f"{code}: {text[-2000:]}")
            got = json.loads(lines[-1])
            timing = ("elapsed_s", "step_s_wall", "phases")
            same = ({k: v for k, v in got.items() if k not in timing}
                    == {k: v for k, v in want.items() if k not in timing})
            run = load_run(d + "-run")
            beats = [h["event"] for h in run.heartbeats]
            log(f"  cora {model} CLI under torch.distributed.run "
                f"--standalone --nproc_per_node 1: losses {got['losses']}; "
                f"== the unlaunched CLI's report bit for bit (timings "
                f"aside): {same}; heartbeat.jsonl {beats} (valid), "
                f"{len(run.steps())} step events; JSON lines printed "
                f"{len(lines)}")
            if not same or beats != ["train:start", "train:done"] or \
                    len(lines) != 1:
                raise AssertionError(f"phase 31: launched {model} CLI "
                                     f"{got} != {want}, beats {beats}")
            cli[model] = got["losses"]
        log(f"  (b) after (a): {time.perf_counter() - t0:.1f} s")
    finally:
        for proc, out, _d in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    log(f"  phase 31 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card: {smi}")
    return total, {"rank": rank, "cli": cli}


# ------------------------ phase 32: the carried modes on one NCCL rank
RANK32_DIR = os.path.join(REPO, "build", "chip_smoke_rank_carried")

# phase 32's cases: name -> (transport, trainer levers), each with
# sync_every=2 ('auto': the knee resolved on the full plan)
RANK32_CASES = {
    "stale a2a": ("a2a", {"halo_staleness": 1}),
    "stale ring": ("ragged", {"halo_staleness": 1}),
    "stale + delta a2a": ("a2a", {"halo_staleness": 1, "halo_delta": True}),
    "stale bf16 wire a2a": ("a2a", {"halo_staleness": 1,
                                    "halo_dtype": "bfloat16"}),
    "replica auto a2a": ("a2a", {"replica_budget": "auto"}),
    "replica auto bf16 wire a2a": ("a2a", {"replica_budget": "auto",
                                           "halo_dtype": "bfloat16"}),
    "replica auto ring": ("ragged", {"replica_budget": "auto"}),
    "replica x stale a2a": ("a2a", {"replica_budget": "auto",
                                    "halo_staleness": 1}),
    "partial refresh a2a": ("a2a", {"replica_budget": "auto",
                                    "refresh_band": 0.05}),
}
RANK32_STEPS = 4          # a sync step, a carried step, a sync, a carried


def rank32_launches(lever, widths, fin=128):
    """Exact launches per entry of phase 32's four steps (sync, carried,
    sync, carried) on the rank path.  Every sync step is the stale op's
    fresh step: a pack and one fused launch an aggregation, forward and
    backward.  A stale step the same, its exchange in flight.  A pure
    replica step: the shrunken pack, two K1 family launches and one
    pack-into an aggregation; a partial refresh also packs each side
    channel.  A composed replica × stale step: the shrunken pack and one
    fused launch, the pack-into at the next read (the last one when the
    run waits on its carries).  On a ``halo_dtype`` wire every fused
    launch reads a bf16 carry (the ``_f32_bf16wire`` entry) and a replica
    step's halo family is K1-bf16."""
    nl, bwd = len(widths), backward_passes(fin, widths)
    aggs = nl + bwd
    wire = bool(lever.get("halo_dtype"))
    fused = "fused_wire" if wire else "fused"
    sync = {"pack": aggs, fused: aggs, "stale_bwd": bwd}
    if not lever.get("replica_budget"):
        carried = dict(sync)
    elif lever.get("halo_staleness"):
        carried = {"pack": aggs, fused: aggs, "rep_bwd": bwd,
                   "pack_into": aggs}
    else:
        # the local family over x, the halo family over the carry
        halo = "k1_bf16" if wire else "k1"
        carried = {"pack": aggs, "pack_into": aggs, "k1": aggs}
        carried[halo] = carried.get(halo, 0) + aggs
    steps = [sync, carried, sync, carried]
    if lever.get("refresh_band") is not None:
        steps[2] = {"pack": 2 * aggs, "k1": 2 * aggs, "pack_into": aggs}
    keys = ("pack", "fused", "stale_bwd", "rep_bwd", "pack_into", "k1",
            "k1_bf16", "fused_wire", "sym_bwd", "ring", "ring_bwd")
    return {key: sum(s.get(key, 0) for s in steps) for key in keys}


def phase_rank_carried(plan, feats_f, labels_f, p_init, widths, dev, tb,
                       smi):
    """Phase 32 (module docstring): the carried modes on one NCCL rank
    against the stacked proxy of chip 0's ER slice.  Returns the launch
    counts of the rank runs by kernel entry and the measurements."""
    import shutil

    import numpy as np
    import torch

    from sgcn_tpu_torch.obs.memory import MEM_MODEL_TOL
    from sgcn_tpu_torch.ops import pspmm as ps
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.ops.row_shuffle import row_pack_into_plain
    from sgcn_tpu_torch.parallel import (init_rank_group, shard_proxy_data,
                                         shard_proxy_plan)
    from sgcn_tpu_torch.parallel.plan import choose_replica_budget
    from sgcn_tpu_torch.train import FullBatchTrainer

    t_phase = time.perf_counter()
    shutil.rmtree(RANK32_DIR, ignore_errors=True)
    os.makedirs(RANK32_DIR)
    total = {key: 0 for key in launch_counts()}
    plan.ensure_pallas_tiles(tb)
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    t0 = time.perf_counter()
    knee = {}
    budget = choose_replica_budget(plan, decision=knee)
    plan.ensure_replicas(budget)
    sl = shard_proxy_plan(plan, 0)          # every layout built above
    data = shard_proxy_data(plan, 0, feats_f, labels_f, device=dev)
    log(f"  replica_budget auto -> B {budget} on the full plan "
        f"(score_covered {knee.get('score_covered')}); chip 0's slice: "
        f"{len(sl.keep_recv_dst)} kept a2a slots, {len(sl.rep_recv_dst)} "
        f"replica slots, shrunken a2a {sl.k * sl.nrep_s * plan.k} rows, "
        f"side channel {sl.partial_refresh_wire_rows} rows; layout and "
        f"slice {time.perf_counter() - t0:.2f} s (host)")
    fused_fn, pack_into_fn = ts.spmm_tiles_fused, ps.row_pack_into

    def run(sched, lever, mesh=None, pick=None):
        kw = dict(lever, sync_every=2, comm_schedule=sched, device=dev,
                  params=[w.copy() for w in p_init])
        if kw.get("replica_budget") == "auto":
            kw["replica_budget"] = budget
        tr = FullBatchTrainer(sl, fin=128, widths=widths, mesh=mesh, **kw)
        calls = []

        # the rank forms held against plain: the first fused launch of
        # the first carried step (a rank's carry), or its first pack-into
        # (a shrunken receive into the carried layout)
        def fused_rec(*args):
            out = fused_fn(*args)
            if not calls:
                calls.append(("fused", args, out))
            return out

        def pack_into_rec(out, src, flat, dst):
            before = out.clone() if not calls else None
            res = pack_into_fn(out, src, flat, dst)
            if before is not None:
                calls.append(("pack_into", (before, src, flat, dst),
                              res.clone()))
            return res
        fused_rec.__dict__ = fused_fn.__dict__
        pack_into_rec.__dict__ = pack_into_fn.__dict__
        launch_counts(zero=True)                # the main path starts here
        losses, ms = [], []
        for step in range(RANK32_STEPS):
            if pick is not None and step == 1:
                if pick == "fused":
                    ts.spmm_tiles_fused = fused_rec
                else:
                    ps.row_pack_into = pack_into_rec
            try:
                t, out = event_ms(lambda: tr.step(data, sync=False), 1)
            finally:
                ts.spmm_tiles_fused, ps.row_pack_into = fused_fn, \
                    pack_into_fn
            ms.append(t)
            losses.append(float(out[0]))
        tr._settle_carries()                    # the last in-flight waits
        torch.cuda.synchronize()
        ln = launch_counts()                    # ... and ends here
        return {"tr": tr, "ms": ms, "losses": losses, "ln": ln,
                "w": [p.detach().clone() for p in tr.model.parameters()],
                "calls": calls}

    picks = {"stale a2a": "fused", "replica auto a2a": "pack_into",
             "stale bf16 wire a2a": "fused",
             "replica auto bf16 wire a2a": "pack_into"}
    mesh = init_rank_group("file://" + os.path.join(RANK32_DIR,
                                                    "rendezvous"), 1, 0)
    out, err = {}, {"fused": 0.0, "pack_into": 0.0}
    try:
        for name, (sched, lever) in RANK32_CASES.items():
            t0 = time.perf_counter()
            stacked = run(sched, lever)
            rk = run(sched, lever, mesh=mesh, pick=picks.get(name))
            t_runs = time.perf_counter() - t0
            for key in total:
                total[key] += rk["ln"][key]
            same = rk["losses"] == stacked["losses"] and all(
                torch.equal(a, b) for a, b in zip(rk["w"], stacked["w"]))
            want = rank32_launches(lever, widths)
            got = {key: rk["ln"][key] for key in want}
            checked = []
            for kind, args, k_out in rk["calls"]:
                plain = (ts.spmm_tiles_fused_plain(*args) if kind == "fused"
                         else row_pack_into_plain(*args))
                err[kind] = max(err[kind], float(
                    (k_out.float() - plain.float()).abs().max()))
                if not same_bits(k_out, plain):
                    raise AssertionError(f"phase 32: {name}: the rank's "
                                         f"{kind} launch != plain")
                checked.append(f"{kind} on {tuple(args[3 if kind == 'fused' else 0].shape)}")
            log(f"  one NCCL rank, chip 0's ER slice, {name}: losses "
                f"{rk['losses']}; == the stacked proxy's bit for bit "
                f"(losses and weights): {same}; ms of steps 1-4 (CUDA "
                f"events; sync, carried, sync, carried) {rk['ms']!r}, the "
                f"stacked proxy's {stacked['ms']!r}; launches "
                f"{json.dumps(got)} (expected {json.dumps(want)}); == "
                f"plain: {checked}; host s: runs {t_runs:.1f}, plain "
                f"checks {time.perf_counter() - t0 - t_runs:.1f}; card: "
                f"{smi}")
            if not same or got != want or \
                    len(checked) != (name in picks) or \
                    not np.isfinite(rk["losses"]).all():
                raise AssertionError(f"phase 32: {name}: same {same}, "
                                     f"launches {got} (want {want}), "
                                     f"checked {checked}")
            out[name] = {"ms": rk["ms"], "proxy_ms": stacked["ms"],
                         "losses": rk["losses"]}
            del stacked, rk
        out["memory"] = _rank32_memory(sl, data, p_init, widths, budget,
                                       mesh, dev, smi)
    finally:
        mesh.close()
    log(f"  phase 32 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card: {smi}")
    out["err"] = err
    return total, out


def _rank32_memory(sl, data, p_init, widths, budget, mesh, dev, smi):
    """Phase 32's memory join: a fresh rank trainer in the replica mode
    (``replica_budget`` at the knee, a2a, ``sync_every=2``) measured on
    its sixth step, a replica step, against the rank's memory model; the
    live tensors' bytes and the allocator's before it are logged
    beside the model's argument families."""
    import torch

    from sgcn_tpu_torch.obs.memory import MEM_MODEL_TOL, device_bytes
    from sgcn_tpu_torch.train import FullBatchTrainer

    tr = FullBatchTrainer(sl, fin=128, widths=widths, mesh=mesh,
                          params=[w.copy() for w in p_init],
                          replica_budget=budget, sync_every=2,
                          comm_schedule="a2a")
    for _ in range(5):
        tr.step(data)
    torch.cuda.synchronize()
    held = device_bytes(dev)[0] - tr._mem_base[0]
    live = tr.resident_bytes()
    _loss, measured = tr.measure_step(data)
    join = tr.publish_memory(measured, data)
    peak, model_b = measured["peak_bytes"], tr.memory.total_bytes
    ratio = peak / model_b
    fams = {f: (tr.memory.families.get(f, 0), b) for f, b in live.items()}
    log(f"  replica auto a2a, a fresh rank trainer's sixth step (a replica "
        f"step): memory model {model_b} B (layout "
        f"{tr.memory.config['layout']}), measured peak {peak} B, ratio "
        f"{ratio:.4f} (MEM_MODEL_TOL {MEM_MODEL_TOL}, MEM_CARD_TOL "
        f"{MEM_CARD_TOL}); arguments {measured['argument_bytes']} B (model "
        f"{tr.memory.argument_bytes}, the data made before the trainer), "
        f"the allocator before the step {held} B, the live tensors by "
        f"family (model, live) {json.dumps(fams)} = "
        f"{sum(live.values())} B; violations {join['violations']}; card: "
        f"{smi}")
    if join["violations"] or ratio > MEM_CARD_TOL:
        raise AssertionError(f"phase 32: memory join {join}")
    return {"peak": peak, "model": model_b, "ratio": ratio,
            "arguments": measured["argument_bytes"], "held": held,
            "live": sum(live.values()), "violations": join["violations"]}


def _rank_levers(plan, feats_f, labels_f, p_init, params_g, widths, dev, tb,
                 smi, total):
    """Phase 31 (a): every ``RANK31_CASES`` case on one NCCL rank against
    the stacked proxy of chip 0's slice; adds the rank runs' launches to
    ``total``."""
    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import gat_table_form
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.parallel import (init_rank_group, shard_proxy_data,
                                         shard_proxy_plan)
    from sgcn_tpu_torch.train import FullBatchTrainer

    plan.ensure_pallas_tiles(tb)
    plan.ensure_ragged()
    plan.ensure_pallas_ragged_tiles()
    plan.ensure_pallas_cell_tiles(tb)
    plan.ensure_pallas_cell_ragged_tiles()
    sl = shard_proxy_plan(plan, 0)          # every layout built above
    data = shard_proxy_data(plan, 0, feats_f, labels_f, device=dev)
    family = ts.spmm_tiles_classes

    def run(model, sched, lever, mesh=None, picks=None):
        kw = (dict(params=[w.copy() for w in p_init]) if model == "gcn" else
              dict(model="gat", activation="none",
                   params=gat_from_numpy(params_g)))
        tr = FullBatchTrainer(sl, fin=128, widths=widths, comm_schedule=sched,
                              device=dev, mesh=mesh, **kw, **lever)
        calls = []
        if picks is not None:
            # the first step's family launches kept to hold against their
            # plain versions: those whose index among the step's launches
            # of their entry (K5, K1-bf16) is in ``picks[entry]``
            seen = {"k5": 0, "k1_bf16": 0}

            def recorded(*args):
                out = family(*args)
                key = ("k5" if args[2].dtype == torch.int8 else "k1_bf16"
                       if args[3].dtype == torch.bfloat16 else None)
                if key is not None:
                    if seen[key] in picks.get(key, ()):
                        calls.append((args, out))
                    seen[key] += 1
                return out
            ts.spmm_tiles_classes = recorded
        try:
            first = tr.step(data)
        finally:
            ts.spmm_tiles_classes = family
        launch_counts(zero=True)                # the main path starts here
        steps = [event_ms(lambda: tr.step(data, sync=False), 1)
                 for _ in range(3)]
        ln = launch_counts()                    # ... and ends here
        return {"ms": [ms for ms, _ in steps],
                "losses": [first] + [float(out[0]) for _, out in steps],
                "w": [p.detach().clone() for p in tr.model.parameters()],
                "ln": ln, "calls": calls}

    # the launches held against plain, by their index among the first
    # step's launches of their entry: each table form the rank path ships
    # at flagship width once.  GAT: the forward's first layer (split pair
    # at width 128; packed under compute_dtype: bf16 u·z words and the
    # float32 u lane) and last layer (the fused table at width 40;
    # packed), on the ring the first layer's, and under compute_dtype the
    # backward's first layer too (its packed ḡ/D lanes are float32); GCN
    # under compute_dtype: the first aggregation's two K1-bf16 launches
    # in the forward and in the backward
    def gat_picks(cd, last=True, backward=False):
        n = [1 if gat_table_form(w, cd) == "fused" else 2 for w in widths]
        fwd = sum(n)
        got = set(range(n[0]))
        if last:
            got |= set(range(fwd - n[-1], fwd))
        if backward:
            got |= set(range(fwd, fwd + n[-1]))
        return {"k5": got}
    picks = {"GAT a2a": gat_picks(None), "GAT ring": gat_picks(None, False),
             "GAT bf16 a2a": gat_picks("bfloat16", backward=True),
             "GCN bf16 a2a": {"k1_bf16": {0, 1, 2 * len(widths),
                                         2 * len(widths) + 1}}}
    mesh = init_rank_group("file://" + os.path.join(RANK31_DIR,
                                                    "rendezvous"), 1, 0)
    out = {}
    err = {"k5": 0.0, "k5_bf16": 0.0, "k1_bf16": 0.0}
    try:
        for name, (model, sched, lever) in RANK31_CASES.items():
            t0 = time.perf_counter()
            stacked = run(model, sched, lever)
            pick = picks.get(name)
            rk = run(model, sched, lever, mesh=mesh, picks=pick)
            t_runs = time.perf_counter() - t0
            for key in total:
                total[key] += rk["ln"][key]
            same = rk["losses"] == stacked["losses"] and all(
                torch.equal(a, b) for a, b in zip(rk["w"], stacked["w"]))
            want = rank_case_launches(model, sched, widths, lever)
            got = {key: rk["ln"][key] for key in want}
            checked, lanes = 0, []
            for args, k_out in rk["calls"]:
                plain = ts.spmm_tiles_classes_plain(*args)
                key = ("k1_bf16" if args[2].dtype != torch.int8 else
                       "k5_bf16" if args[3].dtype == torch.bfloat16
                       else "k5")
                err[key] = max(err[key], float(
                    (k_out - plain).detach().abs().max()))
                if not same_bits(k_out, plain):
                    raise AssertionError(f"phase 31: {name} {key} launch "
                                         "!= plain")
                checked += 1
                lanes.append(int(args[3].shape[-1]))
            log(f"  one NCCL rank, chip 0's ER slice, {name}: losses "
                f"{rk['losses']}; == the stacked proxy's bit for bit "
                f"(losses and weights): {same}; ms of steps 2-4 (CUDA "
                f"events) {rk['ms']!r}, the stacked proxy's "
                f"{stacked['ms']!r}; launches {json.dumps(got)} (expected "
                f"{json.dumps(want)}); {checked} family launches of one "
                f"step == plain (table lanes {lanes}); host s: runs "
                f"{t_runs:.1f}, plain checks "
                f"{time.perf_counter() - t0 - t_runs:.1f}; card: {smi}")
            short = pick is not None and checked != sum(
                len(v) for v in pick.values())
            if not same or got != want or short or \
                    not np.isfinite(rk["losses"]).all():
                raise AssertionError(f"phase 31: {name}: same {same}, "
                                     f"launches {got} (want {want})")
            out[name] = {"ms": rk["ms"], "proxy_ms": stacked["ms"],
                         "losses": rk["losses"]}
            del stacked, rk
    finally:
        mesh.close()
    out["err"] = err
    return out


# ------------- phase 33: directed plans and mini-batch on one NCCL rank
RANK33_DIR = os.path.join(REPO, "build", "chip_smoke_rank_minibatch")

# phase 33 (a): the directed flagship's levers on a rank
RANK33_DIRECTED = {
    "directed GCN a2a": {},
    "directed GCN bf16 wire a2a": {"halo_dtype": "bfloat16"},
    "directed GCN compute_dtype a2a": {"compute_dtype": "bfloat16"},
    "directed GAT a2a": {"model": "gat"},
}
# ... (b): the mini-batch trainer's cases, (model, transport)
RANK33_MINIBATCH = {"mini-batch GCN a2a": ("gcn", "a2a"),
                    "mini-batch GCN ring": ("gcn", "ragged"),
                    "mini-batch GAT a2a": ("gat", "a2a")}
RANK33_STEPS = 3
MB33_BATCH, MB33_NBATCHES = 4096, 6
RANK33_KEYS = ("k1", "k1_bf16", "k5", "k5_bf16", "pack", "fused",
               "fused_wire", "fused_bf16", "gen_rank_bwd", "gat_gen_bwd",
               "gat_bwd")


def rank33_directed_launches(lever, widths, steps=RANK33_STEPS, fin=128):
    """Exact launches per entry of ``steps`` directed training steps on
    the rank path.  A GCN aggregation's forward: one pack and two K1
    family launches (local over h, halo over the receive buffer: K1-bf16
    on a bf16 wire or on bf16 rows); its backward: three K1 launches and
    no pack (halo-ᵀ and local-ᵀ over g, the weight-1 family over what the
    reverse all-to-all delivered: K1-bf16 under either lever), counted in
    ``PspmmTilesGenRanks.backward_launches``.  A GAT layer's forward as
    on a symmetric plan (phase 31); its backward per exchanged table one
    K5 (halo-ᵀ masks) and two K1 launches, no pack.  No fused launch."""
    out = {key: 0 for key in RANK33_KEYS}
    if lever.get("model") == "gat":
        tables = gat_passes(widths)          # a table per forward pass
        out.update(k5=steps * 2 * tables, k1=steps * 2 * tables,
                   pack=steps * pack_launches("gat", "a2a", widths),
                   gat_gen_bwd=steps * tables)
        return out
    nf, nb = len(widths), backward_passes(fin, widths)
    cd, wire = lever.get("compute_dtype"), lever.get("halo_dtype")
    k16 = "k1_bf16"
    for key, n in (((k16 if cd else "k1"), nf),
                   ((k16 if cd or wire else "k1"), nf),
                   ((k16 if cd else "k1"), 2 * nb),
                   ((k16 if cd or wire else "k1"), nb)):
        out[key] += steps * n
    out.update(pack=steps * nf, gen_rank_bwd=steps * 3 * nb)
    return out


def rank33_minibatch_launches(model, widths, nbatches, live, fin=128):
    """Exact launches of one epoch of ``nbatches`` batch steps on the
    rank path (symmetric batch plans: phase 31's per-step counts);
    ``live``: whether the batch set's shared ring has a live round (an
    empty ring ships nothing and packs nothing)."""
    out = {key: 0 for key in RANK33_KEYS}
    got = rank_case_launches(model, "a2a", widths, {}, steps=nbatches)
    out.update({key: v for key, v in got.items() if key in out})
    if not live:
        out["pack"] = 0
    return out


def phase_rank_directed_minibatch(asym, ahat_f, feats_f, labels_f, pv_f,
                                  p_init, params_g, widths, dev, smi):
    """Phase 33 (module docstring): directed plans and the mini-batch
    trainer on one NCCL rank against the stacked proxy.  Returns the
    launch counts of the rank runs by kernel entry and the
    measurements."""
    import shutil

    import numpy as np
    import torch

    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops import tile_spmm as ts
    from sgcn_tpu_torch.parallel import (init_rank_group, shard_proxy_data,
                                         shard_proxy_plan)
    from sgcn_tpu_torch.train import FullBatchTrainer, resolve_forward_setup

    t_phase = time.perf_counter()
    shutil.rmtree(RANK33_DIR, ignore_errors=True)
    os.makedirs(RANK33_DIR)
    total = {key: 0 for key in launch_counts()}
    plan = asym["plan"]
    for model in ("gcn", "gat"):
        resolve_forward_setup(plan, model=model)   # built: a no-op
    sl = shard_proxy_plan(plan, 0)
    data = shard_proxy_data(plan, 0, feats_f, labels_f, device=dev)
    family = ts.spmm_tiles_classes

    def model_kw(lever):
        if lever.get("model") == "gat":
            return dict(lever, activation="none",
                        params=gat_from_numpy(params_g))
        return dict(lever, params=[w.copy() for w in p_init])

    def run(lever, mesh=None, picks=()):
        tr = FullBatchTrainer(sl, fin=128, widths=widths, device=dev,
                              mesh=mesh, **model_kw(lever))
        calls = {}
        wanted = {name: tr.pa[f"ptile_{name}src"].data_ptr()
                  for name in picks}

        def recorded(*args):
            out = family(*args)
            for name, ptr in wanted.items():
                if name not in calls and args[0].data_ptr() == ptr:
                    calls[name] = (args, out)
            return out
        recorded.__dict__ = family.__dict__
        launch_counts(zero=True)                # the main path starts here
        ts.spmm_tiles_classes = recorded
        try:
            first = tr.step(data)
        finally:
            ts.spmm_tiles_classes = family
        steps = [event_ms(lambda: tr.step(data, sync=False), 1)
                 for _ in range(RANK33_STEPS - 1)]
        torch.cuda.synchronize()
        ln = launch_counts()                    # ... and ends here
        return {"ms": [ms for ms, _ in steps],
                "losses": [first] + [float(out[0]) for _, out in steps],
                "w": [p.detach().clone() for p in tr.model.parameters()],
                "ln": ln, "calls": calls}

    # the rank forms held against plain: the first halo-ᵀ launch (the
    # slice's ptile_th*) and the first weight-1 launch over a received
    # buffer (ptile_t1*), float32 and on the bf16 wire
    picks = {"directed GCN a2a": ("th", "t1"),
             "directed GCN bf16 wire a2a": ("t1",)}
    mesh = init_rank_group("file://" + os.path.join(RANK33_DIR,
                                                    "rendezvous"), 1, 0)
    out, err = {}, {"th": 0.0, "t1": 0.0, "t1_bf16": 0.0}
    try:
        # ---- (a) the directed flagship's slice
        for name, lever in RANK33_DIRECTED.items():
            t0 = time.perf_counter()
            stacked = run(lever)
            rk = run(lever, mesh=mesh, picks=picks.get(name, ()))
            t_runs = time.perf_counter() - t0
            for key in total:
                total[key] += rk["ln"][key]
            same = rk["losses"] == stacked["losses"] and all(
                torch.equal(a, b) for a, b in zip(rk["w"], stacked["w"]))
            want = rank33_directed_launches(lever, widths)
            got = {key: rk["ln"][key] for key in want}
            checked = []
            for form, (args, k_out) in rk["calls"].items():
                torch.cuda.synchronize()
                t_plain = time.perf_counter()
                plain = ts.spmm_tiles_classes_plain(*args)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t_plain) * 1e3
                key = form + ("_bf16" if args[3].dtype == torch.bfloat16
                              else "")
                err[key] = max(err[key], float(
                    (k_out - plain).abs().max()))
                if not same_bits(k_out, plain):
                    raise AssertionError(f"phase 33: {name}: the rank's "
                                         f"{key} launch != plain")
                # its time on the rank's slice (these launches are not
                # the main path's: its counts were read above)
                table = args[3]
                nbytes, flops = k1_work(
                    args[0].cpu().numpy(), args[2].cpu().numpy(), 1,
                    table.shape[1], table.shape[2], k_out.shape[1],
                    table.element_size())
                bound, by = k1_bound_ms(nbytes, flops)
                out.setdefault("forms", {})[key] = {
                    "ms": cuda_ms(lambda args=args: family(*args)),
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
                checked.append(f"{key} on {tuple(table.shape)} "
                               f"{table.dtype}: "
                               + json.dumps(out["forms"][key]))
            log(f"  one NCCL rank, chip 0's directed slice, {name}: losses "
                f"{rk['losses']}; == the stacked proxy's bit for bit "
                f"(losses and weights): {same}; ms of steps 2-3 (CUDA "
                f"events) {rk['ms']!r}, the stacked proxy's "
                f"{stacked['ms']!r}; launches {json.dumps(got)} (expected "
                f"{json.dumps(want)}); == plain: {checked}; host s: runs "
                f"{t_runs:.1f}, plain checks "
                f"{time.perf_counter() - t0 - t_runs:.1f}; card: {smi}")
            if not same or got != want or \
                    len(checked) != len(picks.get(name, ())) or \
                    not np.isfinite(rk["losses"]).all():
                raise AssertionError(f"phase 33: {name}: same {same}, "
                                     f"launches {got} (want {want}), "
                                     f"checked {checked}")
            out[name] = {"ms": rk["ms"], "proxy_ms": stacked["ms"],
                         "losses": rk["losses"]}
            del stacked, rk
        out["memory"] = _rank33_memory(sl, data, p_init, widths, mesh, dev,
                                       smi)
        del data
        # ---- (b) the mini-batch trainer on part 0's batch slices
        for name, (model, sched) in RANK33_MINIBATCH.items():
            t0 = time.perf_counter()
            runs = [_rank33_minibatch(model, sched, group, ahat_f, feats_f,
                                      labels_f, pv_f, p_init, params_g,
                                      widths, dev)
                    for group in (None, mesh)]
            stacked, rk = runs
            for key in total:
                total[key] += rk["ln"][key]
            same = rk["losses"] == stacked["losses"] and all(
                torch.equal(a, b) for a, b in zip(rk["w"], stacked["w"]))
            want = rank33_minibatch_launches(model, widths, MB33_NBATCHES,
                                             rk["live"])
            got = {key: rk["ln"][key] for key in want}
            log(f"  one NCCL rank, part 0 of the ER batches (batch "
                f"{MB33_BATCH}, {MB33_NBATCHES} padded plans, B "
                f"{rk['b']}, S {rk['s']}, real rows {rk['rows']}), {name}: "
                f"losses {rk['losses']}; == the shard proxy's bit for bit "
                f"(losses and weights): {same}; ms a batch step (CUDA "
                f"events, readback included) {rk['ms']!r}, the proxy's "
                f"{stacked['ms']!r}; launches {json.dumps(got)} (expected "
                f"{json.dumps(want)}); host s {time.perf_counter() - t0:.1f}"
                f" (trainers {rk['build_s']:.1f} + {stacked['build_s']:.1f})"
                f"; card: {smi}")
            if not same or got != want or \
                    not np.isfinite(rk["losses"]).all():
                raise AssertionError(f"phase 33: {name}: same {same}, "
                                     f"launches {got} (want {want})")
            out[name] = {"ms": rk["ms"], "proxy_ms": stacked["ms"],
                         "losses": rk["losses"]}
            del runs, stacked, rk
    finally:
        mesh.close()
    log(f"  phase 33 launches {json.dumps(total)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card: {smi}")
    out["err"] = err
    return total, out


def _rank33_minibatch(model, sched, mesh, ahat, feats, labels, pv, p_init,
                      params_g, widths, dev):
    """One epoch of the mini-batch trainer on part 0's batch slices: on
    the one-rank ``mesh``, or the shard proxy without it; counts zeroed
    before the epoch and read after."""
    import torch

    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy
    from sgcn_tpu_torch.ops.pspmm import ragged_live_rounds
    from sgcn_tpu_torch.train.minibatch import MiniBatchTrainer

    kw = (dict(params=[w.copy() for w in p_init]) if model == "gcn" else
          dict(activation="none", params=gat_from_numpy(params_g)))
    t0 = time.perf_counter()
    tr = MiniBatchTrainer(ahat, pv, 8, fin=128, widths=widths,
                          batch_size=MB33_BATCH, nbatches=MB33_NBATCHES,
                          seed=0, model=model, comm_schedule=sched, part=0,
                          mesh=mesh, device=dev, **kw)
    batches = tr.make_batches(feats, labels)
    build_s = time.perf_counter() - t0
    launch_counts(zero=True)                    # the main path starts here
    steps = [event_ms(lambda b=b: tr.step(b), 1) for b in batches]
    torch.cuda.synchronize()
    ln = launch_counts()                        # ... and ends here
    plan = tr.plans[0]
    return {"ms": [ms for ms, _ in steps],
            "losses": [out[0] for _, out in steps],
            "w": [p.detach().clone() for p in tr.inner.model.parameters()],
            "ln": ln, "build_s": build_s, "b": plan.b, "s": plan.s,
            "rows": [int(b.data.train_valid.sum()) for b in batches],
            "live": sched == "a2a" or bool(ragged_live_rounds(plan.rr_sizes))}


def _rank33_memory(sl, data, p_init, widths, mesh, dev, smi):
    """Phase 33's memory join: a fresh GCN rank trainer on the directed
    slice measured on its third step against the rank's memory model
    (the backward's reverse exchange buffers priced), within
    ``MEM_CARD_TOL``."""
    import torch

    from sgcn_tpu_torch.obs.memory import MEM_MODEL_TOL
    from sgcn_tpu_torch.train import FullBatchTrainer

    tr = FullBatchTrainer(sl, fin=128, widths=widths, mesh=mesh,
                          params=[w.copy() for w in p_init])
    for _ in range(2):
        tr.step(data)
    torch.cuda.synchronize()
    live = tr.resident_bytes()
    _loss, measured = tr.measure_step(data)
    join = tr.publish_memory(measured, data)
    peak, model_b = measured["peak_bytes"], tr.memory.total_bytes
    ratio = peak / model_b
    log(f"  directed GCN a2a, a fresh rank trainer's third step: memory "
        f"model {model_b} B (layout {tr.memory.config['layout']}, wire "
        f"buffers {tr.memory.families['wire_buffers']} B with the reverse "
        f"exchange's), measured peak {peak} B, ratio {ratio:.4f} "
        f"(MEM_MODEL_TOL {MEM_MODEL_TOL}, MEM_CARD_TOL {MEM_CARD_TOL}); "
        f"arguments {measured['argument_bytes']} B (model "
        f"{tr.memory.argument_bytes}), live tensors "
        f"{sum(live.values())} B; violations {join['violations']}; card: "
        f"{smi}")
    if join["violations"] or ratio > MEM_CARD_TOL:
        raise AssertionError(f"phase 33: memory join {join}")
    return {"peak": peak, "model": model_b, "ratio": ratio,
            "arguments": measured["argument_bytes"]}

ELL_DIR = os.path.join(REPO, "build", "chip_smoke_ell")
# the ELL aggregator against the tile path and the reference: rtol 1e-5 /
# atol 1e-6 (tests/test_torch_ell.py)
ELL_TOL = dict(rtol=1e-5, atol=1e-6)


def cora_directed(a):
    """cora2708 with each undirected edge kept in one direction, which one
    by a coin from ``default_rng(0)`` (the CPU tests' directed cora)."""
    import numpy as np
    import scipy.sparse as sp

    up = sp.triu(a, k=1).tocoo()
    flip = np.random.default_rng(0).random(up.nnz) < 0.5
    rows = np.where(flip, up.col, up.row)
    cols = np.where(flip, up.row, up.col)
    return sp.csr_matrix((np.ones(up.nnz, np.float32), (rows, cols)),
                         shape=a.shape)


def weights_track(got, want, lr=0.01):
    """Weights after Adam steps by the trainer parity tests' rule: 99 % of
    the entries within 1e-5, every one within half a step at ``lr``."""
    import numpy as np

    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool(np.mean(gap <= 1e-5) >= 0.99 and gap.max() <= 0.5 * lr), \
        float(gap.max())


def phase_ell(plan, data, p_init, widths, eng_f, feats_f, fix, dev, smi):
    """Phase 34: the ELL aggregator under ``SGCN_PALLAS_SPMM=0``.  Returns
    its main-path launch counts (``launch_counts`` keys).  The variable
    is restored after."""
    prev = os.environ.get("SGCN_PALLAS_SPMM")
    try:
        return _phase_ell(plan, data, p_init, widths, eng_f, feats_f, fix,
                          dev, smi)
    finally:
        if prev is None:
            os.environ.pop("SGCN_PALLAS_SPMM", None)
        else:
            os.environ["SGCN_PALLAS_SPMM"] = prev


def _phase_ell(plan, data, p_init, widths, eng_f, feats_f, fix, dev, smi):
    import shutil

    import numpy as np
    import torch

    from sgcn_tpu_torch.io.datasets import load_npz_dataset
    from sgcn_tpu_torch.obs import (RunRecorder, exchange_join, load_run,
                                    summarize_trace)
    from sgcn_tpu_torch.obs.attribution import (LINK_CEILING_GBS,
                                                STREAM_CEILING_GBS)
    from sgcn_tpu_torch.obs.memory import MemoryBudgetError
    from sgcn_tpu_torch.obs.tracing import find_trace_files, profile_to
    from sgcn_tpu_torch.parallel import build_comm_plan
    from sgcn_tpu_torch.partition import read_partvec
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.serve import ServeEngine
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data

    shutil.rmtree(ELL_DIR, ignore_errors=True)
    os.makedirs(ELL_DIR)
    marks = [("start", time.perf_counter())]
    totals = {}

    def counted(run, packs, what):
        """``run()`` as a main-path ELL run: counts zeroed before, read
        after; no K1, K5 or fused launch, and exactly ``packs`` packs."""
        launch_counts(zero=True)
        k1_open()
        out = run()
        torch.cuda.synchronize()
        k1_close()
        c = launch_counts()
        tiles = {key: v for key, v in c.items()
                 if v and key not in ("pack",)}
        if tiles or c["pack"] != packs:
            raise AssertionError(f"phase 34: {what}: launches {c}, expected "
                                 f"{packs} packs and nothing else")
        for key, v in c.items():
            totals[key] = totals.get(key, 0) + v
        return out

    def trainer(p, fin, ws, sched, params, **kw):
        return FullBatchTrainer(p, fin=fin, widths=ws, params=params,
                                comm_schedule=sched, device=dev, **kw)

    def use_ell(on):
        if on:
            os.environ["SGCN_PALLAS_SPMM"] = "0"
        else:
            os.environ.pop("SGCN_PALLAS_SPMM", None)

    # ---- (a) cora2708 8-hp (a2a, ring) and the directed cora, 3 steps
    a, feats, labels = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    cw = [16, 7]
    for name, g in (("cora", a), ("directed cora", cora_directed(a))):
        cp = build_comm_plan(normalize_adjacency(g), pv, 8)
        cd = make_train_data(cp, feats, labels, device=dev)
        c0 = [w.detach().cpu().numpy() for w in trainer(
            cp, 1433, cw, "a2a", None).params]
        runs = {}
        for sched in ("a2a", "ragged") if cp.symmetric else ("a2a",):
            use_ell(True)
            tr = trainer(cp, 1433, cw, sched, c0)
            if tr.setup.aggregator != "ell":
                raise AssertionError("phase 34: SGCN_PALLAS_SPMM=0 did not "
                                     "select the ELL aggregator")
            runs[sched] = (counted(lambda: [tr.step(cd) for _ in range(3)],
                                   3 * 2 * len(cw), f"{name} {sched}"),
                           [w.detach().clone() for w in tr.params])
        use_ell(False)
        tt = trainer(cp, 1433, cw, "a2a", c0)
        tl = [tt.step(cd) for _ in range(3)]
        (el, ew) = runs["a2a"]
        ring = ("ragged" not in runs or (runs["ragged"][0] == el and all(
            torch.equal(x, y) for x, y in zip(runs["ragged"][1], ew))))
        close = np.allclose(el, tl, **ELL_TOL)
        wt = [weights_track(x.cpu().numpy(), y.detach().cpu().numpy())
              for x, y in zip(ew, tt.params)]
        log(f"  {name} ELL a2a losses {el}, tile {tl}; ring == a2a {ring}; "
            f"within rtol 1e-5 / atol 1e-6: {close}; weights track the tile "
            f"path: {wt}")
        if not (ring and close and all(ok for ok, _ in wt)):
            raise AssertionError(f"phase 34: {name} ELL run differs")
    marks.append(("(a) cora", time.perf_counter()))

    # ---- (b) the flagship, 3 steps a2a and ring under a recorder
    nl = len(widths)
    per_step = nl + backward_passes(128, widths)
    flag = {}
    use_ell(True)
    for sched in ("a2a", "ragged"):
        tr = trainer(plan, 128, widths, sched, p_init)
        d = os.path.join(ELL_DIR, f"flagship-{sched}")
        rec = RunRecorder(d, config={"phase": 34, "comm_schedule": sched})
        tr.attach_recorder(rec)
        losses = counted(lambda: [tr.step(data) for _ in range(3)],
                         3 * per_step, f"flagship {sched}")
        rec.close()
        tr.attach_recorder(None)
        flag[sched] = (tr, losses, d)
    te, el, _ = flag["a2a"]
    ter, rl, _ = flag["ragged"]
    ring = rl == el and all(torch.equal(x, y)
                            for x, y in zip(ter.params, te.params))
    use_ell(False)
    tt = trainer(plan, 128, widths, "a2a", p_init)
    tl = [tt.step(data) for _ in range(3)]
    close = np.allclose(el, tl, **ELL_TOL)
    wt = [weights_track(x.detach().cpu().numpy(), y.detach().cpu().numpy())
          for x, y in zip(te.params, tt.params)]
    same = el == tl and all(torch.equal(x, y)
                            for x, y in zip(te.params, tt.params))
    log(f"  flagship ELL a2a losses {el}, ring {rl}, tile {tl}; ring == "
        f"a2a {ring}; ELL within rtol 1e-5 / atol 1e-6 of the tile path: "
        f"{close} (bit for bit: {same}); weights track: {wt}")
    if not (ring and close and all(ok for ok, _ in wt)):
        raise AssertionError("phase 34: the flagship ELL run differs")
    decision = te.comm_decision["aggregator"]
    log(f"  ELL decision log: {json.dumps(decision)}")
    marks.append(("(b) flagship", time.perf_counter()))

    # ---- (c) the step events: schema, roofline, reconciliation
    fracs = {}
    for sched, (tr, _l, d) in flag.items():
        steps = load_run(d).steps()            # validates every record
        if len(steps) != 3:
            raise AssertionError(f"phase 34: {sched}: {len(steps)} steps")
        rows = []
        for s in steps:
            roof = s["roofline"]
            gs = s["measured_vs_model"]["components"]["gather_stream"]
            if roof["halo_bytes_wire_per_step"] != \
                    s["comm"]["halo_bytes_wire_per_step"]:
                raise AssertionError(f"phase 34: {sched} wire bytes "
                                     f"{roof} vs {s['comm']}")
            if roof["stream_ceiling_frac"] > 1.05:
                raise AssertionError(f"phase 34: {sched} step {s['step']} "
                                     f"stream_ceiling_frac {roof}")
            rows.append({"step": s["step"], "wall_s": s["wall_s"],
                         "gather_GB": roof["gather_GB"],
                         "achieved_gather_GBs": roof["achieved_gather_GBs"],
                         "stream_ceiling_frac": roof["stream_ceiling_frac"],
                         "achieved_GFLOPs": roof["achieved_GFLOPs"],
                         "halo_bytes_wire_per_step":
                             roof["halo_bytes_wire_per_step"],
                         "gather_stream_ratio": gs["ratio"]})
        fracs[sched] = [r["stream_ceiling_frac"] for r in rows]
        log(f"  flagship {sched} step events (schema-valid, wire bytes == "
            f"CommStats'): {json.dumps(rows)}")
        join = tr.memory_join
        blk = join["block"]
        ratio = blk["total"]["measured_bytes"] / tr.memory.total_bytes
        log(f"  flagship {sched} memory: model {tr.memory.total_bytes} B "
            f"(slot_temps {tr.memory.families['slot_temps']}), peak "
            f"{blk['total']['measured_bytes']} B, peak / total {ratio:.4f} "
            f"(the card's band {MEM_CARD_TOL}); arguments "
            f"{blk['arguments']['measured_bytes']} vs "
            f"{blk['arguments']['model_bytes']}")
        if join["violations"] or ratio > MEM_CARD_TOL:
            raise AssertionError(f"phase 34: {sched} memory "
                                 f"{join['violations']}, ratio {ratio}")
    before = torch.cuda.memory_allocated()
    use_ell(True)
    try:
        trainer(plan, 128, widths, "a2a", p_init,
                memory_budget=te.memory.total_bytes - 1)
        raise AssertionError("phase 34: the memory budget did not gate")
    except MemoryBudgetError as e:
        log(f"  memory_budget = total - 1: MemoryBudgetError "
            f"({str(e).splitlines()[0]!r}); memory_allocated {before} -> "
            f"{torch.cuda.memory_allocated()}")
    marks.append(("(c) events", time.perf_counter()))

    # ---- (d) epoch_s ELL against tiles in turns; the device split; a
    # profiled step and its exchange join
    epoch = {"tile": [], "ell a2a": [], "ell ring": []}
    for kind, tr in (("tile", tt), ("ell a2a", te), ("ell ring", ter),
                     ("ell a2a", te), ("tile", tt)):
        run = lambda tr=tr: tr.fit(data, epochs=5, warmup=1, verbose=False)
        rep = (counted(run, 6 * per_step, kind) if kind != "tile"
               else run())
        epoch[kind].append(rep["epoch_s"])
    log(f"  flagship epoch_s (1 warm-up + 5 steps each, in turns tile, ELL "
        f"a2a, ELL ring, ELL a2a, tile): {json.dumps(epoch)}; card: {smi}")
    split = counted(lambda: device_split("flagship ELL a2a step",
                                         lambda: te.step(data), reps=3),
                    3 * per_step, "device split")
    tsplit = device_split("flagship tile a2a step", lambda: tt.step(data),
                          reps=3)
    prof_dir = os.path.join(ELL_DIR, "prof")
    with profile_to(prof_dir, dev):
        counted(lambda: te.step(data), per_step, "profiled step")
    summ = summarize_trace(find_trace_files(prof_dir)[0]["path"])
    per = summ.per_step(1)
    # every exchange of an exact step is exposed (the roofline's
    # exposed_halo_bytes)
    exposed = te._step_cost_model().halo_bytes_wire_per_step
    join = exchange_join(per, exposed)
    log(f"  profiled ELL a2a step: trace on device {summ.on_device}, per "
        f"step {json.dumps({k: round(v, 6) for k, v in per.items()})}; "
        f"exchange join (exposed wire bytes {exposed} at the link ceiling "
        f"{LINK_CEILING_GBS} GB/s, a datasheet figure): {json.dumps(join)}")
    marks.append(("(d) times", time.perf_counter()))

    # ---- (e) the full-mode server on the flagship, both transports
    params = [w.detach().cpu().numpy() for w in eng_f.model.layer_params()]
    q = np.arange(3 * 64).reshape(3, 64) * 883 % plan.n
    want = np.concatenate([eng_f.query(b) for b in q])
    use_ell(True)
    served = {}
    for sched in ("a2a", "ragged"):
        eng = ServeEngine(plan, 128, widths, comm_schedule=sched,
                          params=params, device=dev, max_batch=64)
        if eng.setup.aggregator != "ell":
            raise AssertionError("phase 34: the engine runs the tile path")
        eng.set_features(feats_f)
        served[sched] = counted(
            lambda: np.concatenate([eng.query(b) for b in q]), 3 * nl,
            f"serve {sched}")
    ok = np.array_equal(served["a2a"], served["ragged"])
    close = np.allclose(served["a2a"], want, **ELL_TOL)
    gap = float(np.abs(served["a2a"] - want).max())
    log(f"  flagship full-mode server on ELL: 3 batches of 64, rows finite "
        f"{bool(np.isfinite(served['a2a']).all())}, ring == a2a {ok}, "
        f"within rtol 1e-5 / atol 1e-6 of phase 3's tile engine {close} "
        f"(max gap {gap:.3g})")
    if not (ok and close):
        raise AssertionError("phase 34: the ELL server's rows differ")
    marks.append(("(e) serve", time.perf_counter()))
    log("  phase 34 host seconds by section: " + json.dumps(
        {name: round(t - t0, 1) for (_n, t0), (name, t) in
         zip(marks, marks[1:])}))
    log(f"  phase 34 ceilings: STREAM_CEILING_GBS {STREAM_CEILING_GBS} "
        f"(measured, tools/spmm_micro.py), LINK_CEILING_GBS "
        f"{LINK_CEILING_GBS} (NVLink 4 datasheet, per direction); "
        f"stream_ceiling_frac a2a {fracs['a2a']}, ring {fracs['ragged']}; "
        f"device split ELL {json.dumps(split)}, tile {json.dumps(tsplit)}")
    log(f"  phase 34's main-path launches: {json.dumps(totals)}")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "sgcn_tpu_torch")):
        print("chip_smoke: sgcn_tpu_torch/ is not beside this script — run "
              "it from a checkout of the repository", file=sys.stderr)
        return 3
    import numpy as np

    from sgcn_tpu_torch.io.datasets import (dcsbm_graph, er_graph,
                                            load_npz_dataset)
    from sgcn_tpu_torch.ops import _build
    from sgcn_tpu_torch.ops.tile_spmm import choose_tile_dispatch
    from sgcn_tpu_torch.partition import (balanced_random_partition,
                                          read_partvec)
    from sgcn_tpu_torch.prep import normalize_adjacency
    from sgcn_tpu_torch.utils.backend import resolve_device

    t_start = time.perf_counter()
    # every phase names its transport; the accuracy harness (phase 4) has
    # no knob and takes the default, so the variable must not choose it
    os.environ.pop("SGCN_COMM_SCHEDULE", None)
    # ---------------------------------------------------------- phase 0
    smi = nvidia_smi_line()
    dev = resolve_device("cuda")             # TF32 off for the dense matmuls
    log(f"phase 0: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  kernel build {time.perf_counter() - t0:.2f} s wall: "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for k, v in built.items():
        for line in ptxas_report(v["log"]):
            log(f"    {k}: {line}")
    # phase 24's DCSBM flagship graph; its partitions run on two host
    # threads from here on, beside phases 1-23
    t0 = time.perf_counter()
    ahat_dc = normalize_adjacency(dcsbm_graph(FLAGSHIP_N))
    row_nnz = np.diff(ahat_dc.indptr)
    log(f"  DCSBM flagship graph (n={FLAGSHIP_N}, 64 communities, degree "
        f"14, seed 0), Â normalized, in {time.perf_counter() - t0:.2f} s: "
        f"nnz {ahat_dc.nnz}, longest row {row_nnz.max()} slots, p99 "
        f"{np.percentile(row_nnz, 99):.0f}; its hp and gp partitions (k="
        f"{PART_K}, seed {PART_SEED}, twice each) and phase 27's SHP run "
        "start on two threads")
    parts_bg = FlagshipPartitions(ahat_dc, PART_K, PART_SEED)

    # ---------------------------------------------------------- phase 1
    log("phase 1: tile SpMM kernel vs plain version on random tiles")
    rng = np.random.default_rng(0)
    k, tb, n = 8, 256, 6000
    classes = ((2, 2048, "tile_spmm"), (6, 512, "tile_spmm"),
               (12, 64, "tile_spmm"), (4, 1024, "tile_spmm"))
    tiles_np = random_class_tiles(rng, k, [c[:2] for c in classes], tb, n)
    tiles = [torch.as_tensor(a).to(dev) for a in tiles_np]
    max_err = 0.0
    tables = {}                                  # f -> (aligned, unaligned)
    for f in (1, 7, 8, 16, 17, 40, 41, 128, 129):
        table = torch.as_tensor(rng.standard_normal((k, n, f)).astype(
            np.float32)).to(dev)
        tables[f] = (table, unaligned_copy(table))
        for t_, how in zip(tables[f], ("", " unaligned")):
            max_err = max(max_err, check_k1(tiles, t_, classes, tb,
                                            f"random tiles f={f}{how}"))
        if f in (16, 40, 128):
            time_k1(tiles_np, tiles, table, classes, tb, n,
                    f"random tiles f={f}")
    log("phase 1b: the row pack and the fused local + remote entry vs "
        "their plain versions on random inputs")
    fused_err = phase_pack_fused_random(rng, dev, tiles, classes, tb, n)

    # ---------------------------------------------------------- phase 2
    log("phase 2: serve cora2708, k=8 hp, GCN 1433 -> 16 -> 7 (ReLU)")
    fix = os.path.join(REPO, "tests", "fixtures")
    a, feats, _ = load_npz_dataset(os.path.join(fix, "cora2708.npz"))
    ahat = normalize_adjacency(a)
    pv = read_partvec(os.path.join(fix, "cora2708.8.hp"))
    eng_c, _res_c, launches_c = serve_and_check(
        "cora2708", ahat, feats, pv, 8, [16, 7], queries=128, max_batch=32,
        seed=1)
    log_device_busy("cora2708", lambda: eng_c.query(np.arange(32)))
    pa = eng_c.pa
    st = eng_c.setup.fwd_static
    x16 = torch.as_tensor(rng.standard_normal(
        (8, eng_c.plan.b, 16)).astype(np.float32)).to(dev)
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    ltiles_np = [t.cpu().numpy() for t in ltiles]
    max_err = max(max_err, check_k1(ltiles, x16, st["pallas_lclasses"], tb,
                                    "cora local pass f=16"))
    time_k1(ltiles_np, ltiles, x16, st["pallas_lclasses"], tb,
            eng_c.plan.b, "cora local pass f=16")

    # ---------------------------------------------------------- phase 3
    n_f = FLAGSHIP_N
    log(f"phase 3: serve ER n={n_f} deg 14, k=8 rp, GCN 128 -> 128 -> "
        "128 -> 40 (ReLU)")
    t0 = time.perf_counter()
    ahat_f = normalize_adjacency(er_graph(n_f, avg_deg=14, seed=0))
    feats_f = np.random.default_rng(2).standard_normal(
        (n_f, 128)).astype(np.float32)
    pv_f = balanced_random_partition(n_f, 8, seed=0)
    log(f"  graph + features {time.perf_counter() - t0:.2f} s, "
        f"nnz {ahat_f.nnz}")
    eng_f, res_f, launches_f = serve_and_check(
        "flagship", ahat_f, feats_f, pv_f, 8, [128, 128, 40], queries=512,
        max_batch=64, seed=3, check_rows=256)
    pa, st, plan = eng_f.pa, eng_f.setup.fwd_static, eng_f.plan
    decision = {}
    choose_tile_dispatch(plan, tb=tb, decision=decision)
    log(f"  dispatch: {json.dumps(decision['tile_dispatch'])}")
    bd_f = forward_breakdown(eng_f)
    for row in bd_f:
        log(f"  forward breakdown: {json.dumps(row)}")
    log_device_busy("flagship", lambda: eng_f.query(np.arange(64)))

    from sgcn_tpu_torch.ops.pspmm import exchange_recv
    h0 = eng_f._h0
    recv = exchange_recv(h0, pa["recv_src"])
    ltiles = [pa["ptile_lsrc"], pa["ptile_lld"], pa["ptile_lw"]]
    htiles = [pa["ptile_hwsrc"], pa["ptile_hld"], pa["ptile_hw"]]
    check_pack(h0, pa["recv_src"], h0.dtype, "flagship layer-0 exchange")
    fused_err = max(fused_err, check_fused(
        ltiles, h0, htiles, recv, st["pallas_lclasses"],
        st["pallas_hclasses"], tb, "flagship layer-0 fused f=128"))
    max_err = max(max_err, check_k1(ltiles, h0, st["pallas_lclasses"], tb,
                                    "flagship local pass f=128"))
    max_err = max(max_err, check_k1(htiles, recv, st["pallas_hclasses"], tb,
                                    "flagship halo pass f=128 (on the "
                                    "receive buffer)"))
    t_loc = time_k1([t.cpu().numpy() for t in ltiles], ltiles, h0,
                    st["pallas_lclasses"], tb, plan.b,
                    "flagship local pass f=128")
    t_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, recv,
                     st["pallas_hclasses"], tb, recv.shape[1],
                     "flagship halo pass f=128")
    layer = {key: t_loc[key] + t_halo[key]
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"  flagship per-layer K1 time (local + halo family launches, "
        f"f=128): {layer['ms']!r} ms; bound {layer['bound_ms']!r} ms")
    k3 = time_whole_op(h0, pa, st, tb, False,
                       "flagship K3 layer 0 forward f=128")

    # ---------------------------------------------------------- phase 4
    log("phase 4: train cora2708 on the card, k=8 hp, GCN 1433 -> 16 -> 7 "
        "(python -m sgcn_tpu_torch.train --experiment accuracy --epochs 60)")
    from sgcn_tpu_torch.ops.row_shuffle import row_pack
    from sgcn_tpu_torch.ops.tile_spmm import (PspmmTilesSym, spmm_tiles,
                                              spmm_tiles_fused)
    from sgcn_tpu_torch.train import FullBatchTrainer, make_train_data
    from sgcn_tpu_torch.train.__main__ import main as train_main

    epochs_c = 60
    fam = 1               # an aggregation: one fused tile launch, one pack
    out = io.StringIO()
    t0 = time.perf_counter()
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesSym.backward_launches = 0
    with contextlib.redirect_stdout(out):
        train_main(["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                    "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8",
                    "-l", "2", "--hidden", "16", "--experiment", "accuracy",
                    "--epochs", str(epochs_c)])
    k1_close()
    launches_tc = spmm_tiles_fused.launches     # ... and ends here
    packs_tc = row_pack.launches
    bwd_tc = PspmmTilesSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_tc
    acc = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  report ({time.perf_counter() - t0:.2f} s): {json.dumps(acc)}")
    # per epoch 2 forward + 2 backward passes (layer 0 projects first),
    # then one evaluation forward; every pass launches once: one fused
    # tile launch and one pack
    want_c = (epochs_c * (2 + backward_passes(1433, [16, 7])) + 2) * fam
    want_bwd_c = epochs_c * backward_passes(1433, [16, 7]) * fam
    log(f"  fused launches {launches_tc} (backward {bwd_tc}), row pack "
        f"{packs_tc}; expected {want_c} ({want_bwd_c}), {want_c}")
    if launches_tc != want_c or bwd_tc != want_bwd_c or packs_tc != want_c:
        raise AssertionError("cora training: kernel launch count differs "
                             "from the passes the program runs")
    gap = abs(acc["oracle_test_acc"] - acc["fullbatch_test_acc"])
    if not (acc["oracle_test_acc"] > 0.75 and gap < 0.03):
        raise AssertionError(f"cora accuracy outside the bands (oracle > "
                             f"0.75, |oracle - fullbatch| < 0.03): {acc}")

    # ---------------------------------------------------------- phase 5
    log(f"phase 5: train ER n={n_f} deg 14, k=8 rp, GCN 128 -> 128 -> 128 "
        "-> 40 (ReLU, xent), 1 warm-up + 5 timed steps")
    widths_f = [128, 128, 40]
    labels_f = np.random.default_rng(4).integers(0, 40, n_f)
    tr = FullBatchTrainer(plan, fin=128, widths=widths_f, seed=5,
                          comm_schedule="a2a", device=dev)
    data = make_train_data(plan, feats_f, labels_f, device=dev)
    p_init = [w.detach().cpu().numpy().copy() for w in tr.params]
    zs, caught = forward_backward_trace(tr, data)      # at the step-1 weights
    masks = [plan.gather_rows((z > 0).cpu().numpy()) for z in zs[:-1]]
    t0 = time.perf_counter()
    loss64, grads64, _ = backprop64(ahat_f, feats_f, labels_f, p_init)
    _, grads64m, flips = backprop64(ahat_f, feats_f, labels_f, p_init,
                                    masks=masks)
    log(f"  float64 host backprop {time.perf_counter() - t0:.2f} s (twice), "
        f"loss {loss64!r}; ReLU entries whose sign float32 and float64 "
        f"disagree on, by hidden layer: {flips}")
    loss0, _ = tr.evaluate(data)
    if abs(loss0 - loss64) > 1e-5 * abs(loss64):
        raise AssertionError(f"initial loss {loss0} vs float64 {loss64}")
    step_grads = []
    tr.opt.register_step_pre_hook(lambda opt, a, kw: None if step_grads else
                                  step_grads.append([w.grad.cpu().numpy()
                                                     for w in tr.params]))
    steps_f = 1 + 5
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesSym.backward_launches = 0
    rep = tr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_tf = spmm_tiles_fused.launches     # ... and ends here
    packs_tf = row_pack.launches
    bwd_tf = PspmmTilesSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_tf
    # the weights right after fit, before the breakdown steps move them
    # (phase 11 trains the ring from the same start and must end here)
    fit_f = [w.detach().clone() for w in tr.params]
    bwd_f = backward_passes(128, widths_f)
    want_f = steps_f * (len(widths_f) + bwd_f) * fam
    log(f"  fused launches {launches_tf} (backward {bwd_tf}), row pack "
        f"{packs_tf}; each = {steps_f} steps x ({len(widths_f)} forward + "
        f"{bwd_f} backward aggregations) = {want_f}")
    if launches_tf != want_f or bwd_tf != steps_f * bwd_f * fam \
            or packs_tf != want_f:
        raise AssertionError("flagship training: kernel launch count "
                             "differs from the passes the program runs")
    losses = [loss0] + rep["loss_history"]
    log(f"  losses (initial eval, timed steps): {losses}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    for i, (got, want, own) in enumerate(zip(step_grads[0], grads64m,
                                              grads64)):
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        rel_own = float(np.linalg.norm(got - own) / np.linalg.norm(own))
        log(f"  step-1 dW{i} {got.shape}: relative Frobenius error vs "
            f"float64 {rel:.3g} with the run's ReLU masks, {rel_own:.3g} "
            f"with float64's own")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"layer {i} gradient off float64 by {rel}")
    log(f"  epoch_s {rep['epoch_s']!r} (5 timed steps, host clock); "
        f"phases {json.dumps(rep['phases'])}")
    log(f"  step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(tr, data))}")
    log_device_busy("flagship training", lambda: tr.step(data), reps=3,
                    what="steps")

    layer_b = max(caught)                       # the deepest backward pass
    g = caught[layer_b]
    ghalo = exchange_recv(g, pa["recv_src"])
    grad_err = max(
        check_k1(ltiles, g, st["pallas_lclasses"], tb,
                 f"flagship layer-{layer_b} gradient local pass f=128"),
        check_k1(htiles, ghalo, st["pallas_hclasses"], tb,
                 f"flagship layer-{layer_b} gradient halo pass f=128"))
    fused_err = max(fused_err, check_fused(
        ltiles, g, htiles, ghalo, st["pallas_lclasses"],
        st["pallas_hclasses"], tb, f"flagship layer-{layer_b} gradient "
        "fused f=128"))
    k3b = time_whole_op(g, pa, st, tb, False, f"flagship K3 layer-{layer_b}"
                        " backward (on the gradient) f=128")
    b_halo = time_k1([t.cpu().numpy() for t in htiles], htiles, ghalo,
                     st["pallas_hclasses"], tb, ghalo.shape[1],
                     f"flagship layer-{layer_b} gradient halo pass f=128")
    # K2: the halo family is one launch (timed above); one degree class
    # alone, the largest halo class by stored slots, is the unit the
    # per-class dispatch launched before
    hcls = st["pallas_hclasses"]
    c = max(range(len(hcls)), key=lambda j: hcls[j][0] * hcls[j][1])
    off = sum(t * e for t, e, *_ in hcls[:c])
    size = hcls[c][0] * hcls[c][1]
    ctiles = [x[:, off: off + size] for x in htiles]
    time_k1([x.cpu().numpy() for x in ctiles], ctiles, ghalo, (hcls[c],), tb,
            ghalo.shape[1], f"flagship largest halo class {hcls[c][:2]} on the "
            f"layer-{layer_b} gradient, f=128")
    log(f"  K2: the halo family's {len(hcls)} classes in one launch "
        f"{b_halo['ms']!r} ms (bound {b_halo['bound_ms']!r} ms)")

    # ---------------------------------------------------------- phase 6
    log("phase 6: K5 — the int8-mask entry point vs its plain version and "
        "K1 on the upcast mask, on phase 1's tiles as 0/1 masks")
    from sgcn_tpu_torch.models.gat import GatLayerSym
    from sgcn_tpu_torch.ops.tile_spmm import spmm_tiles_classes

    mask_np = (tiles_np[0], tiles_np[1], (tiles_np[2] != 0).astype(np.int8))
    mtiles = [torch.as_tensor(x).to(dev) for x in mask_np]
    k5_err = 0.0
    for f, (table, odd) in tables.items():
        for t_, how in ((table, ""), (odd, " unaligned")):
            k5_err = max(k5_err, check_k1(mtiles, t_, classes, tb,
                                          f"K5 random tiles f={f}{how}"))
        k1_up = spmm_tiles_classes(*mtiles[:2], mtiles[2].float(), table,
                                   classes, tb)
        if not torch.equal(k1_up, spmm_tiles_classes(*mtiles, table,
                                                     classes, tb)):
            raise AssertionError(f"K5 f={f}: mask kernel != K1 on the "
                                 "upcast mask")
        log(f"  K5 random tiles f={f}: == K1 on the upcast mask")
        if f in (1, 41, 128):
            time_k1(mask_np, mtiles, table, classes, tb, n,
                    f"K5 random tiles f={f}")

    # ---------------------------------------------------------- phase 7
    log("phase 7: serve GAT (no activation): cora2708 k=8 hp 1433 -> 16 -> "
        "7, and phase 3's graph, features and plan at 128 -> 128 -> 128 -> "
        "40")
    eng_gc, _res_gc, launches_gc = serve_and_check(
        "cora2708 GAT", ahat, feats, pv, 8, [16, 7], queries=128,
        max_batch=32, seed=1, model="gat")
    log_device_busy("cora2708 GAT", lambda: eng_gc.query(np.arange(32)))
    widths_f = [128, 128, 40]
    eng_gf, _res_gf, launches_gf = serve_and_check(
        "flagship GAT", ahat_f, feats_f, pv_f, 8, widths_f, queries=512,
        max_batch=64, seed=3, check_rows=256, model="gat", plan=plan)
    cls_g = eng_gf.setup.fwd_static["pallas_cclasses"]
    bd_gf = gat_forward_breakdown(eng_gf)
    for row in bd_gf:
        log(f"  GAT forward breakdown: {json.dumps(row)}")
    log_device_busy("flagship GAT", lambda: eng_gf.query(np.arange(64)))

    # ---------------------------------------------------------- phase 8
    log("phase 8: train GAT on phase 5's graph, features, labels and plan, "
        "128 -> 128 -> 128 -> 40 (no activation, xent), 1 warm-up + 5 timed "
        "steps")
    from sgcn_tpu_torch.models.gat import params_from_jax as gat_from_numpy

    params_g = gat_params_numpy(7, list(zip([128] + widths_f[:-1],
                                            widths_f)))
    trg = FullBatchTrainer(plan, fin=128, widths=widths_f, model="gat",
                           activation="none", params=gat_from_numpy(params_g),
                           comm_schedule="a2a", device=dev)
    t0 = time.perf_counter()
    loss64_g, grads64_g = gat64(ahat_f, feats_f, params_g, labels=labels_f)
    log(f"  float64 host GAT backprop (torch autograd, CPU) "
        f"{time.perf_counter() - t0:.2f} s, loss {loss64_g!r}")
    loss0_g, _ = trg.evaluate(data)
    if abs(loss0_g - loss64_g) > 1e-5 * abs(loss64_g):
        raise AssertionError(f"GAT initial loss {loss0_g} vs float64 "
                             f"{loss64_g}")
    gsteps = []
    trg.opt.register_step_pre_hook(lambda opt, a, kw: None if gsteps else
                                   gsteps.append([
                                       {k: v.grad.cpu().numpy()
                                        for k, v in p.items()}
                                       for p in trg.params]))
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    rep_g = trg.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_gt = spmm_tiles.mask_launches      # ... and ends here
    packs_gt = row_pack.launches
    bwd_gt = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gt
    fit_g = [p.detach().clone() for p in trg.model.parameters()]
    want_gt = steps_f * 2 * gat_passes(widths_f)
    want_pg = steps_f * 2 * pack_launches("gat", "a2a", widths_f)
    log(f"  K5 launches {launches_gt} (backward {bwd_gt}) = {steps_f} steps "
        f"x 2 directions x {gat_passes(widths_f)} passes (each over "
        f"{len(cls_g)} classes) = {want_gt}; row pack {packs_gt} (expected "
        f"{want_pg})")
    if launches_gt != want_gt or bwd_gt != want_gt // 2 \
            or packs_gt != want_pg:
        raise AssertionError("flagship GAT training: K5 launch count "
                             "differs from the passes the program runs")
    losses_g = [loss0_g] + rep_g["loss_history"]
    log(f"  losses (initial eval, timed steps): {losses_g}")
    if not np.isfinite(losses_g).all():
        raise AssertionError(f"non-finite GAT loss: {losses_g}")
    for i, (got, want) in enumerate(zip(gsteps[0], grads64_g)):
        if got["a1"].any():
            raise AssertionError(f"layer {i}: a1 gradient is not exactly 0")
        for key in ("w", "a2"):
            rel = float(np.linalg.norm(got[key] - want[key])
                        / np.linalg.norm(want[key]))
            log(f"  step-1 d{key}{i} {got[key].shape}: relative Frobenius "
                f"error vs float64 {rel:.3g}")
            if not rel <= GRAD_RTOL:
                raise AssertionError(f"GAT layer {i} d{key} off float64 by "
                                     f"{rel}")
        log(f"  step-1 da1{i}: exactly 0 (float64 autograd's "
            f"|da1| {np.linalg.norm(want['a1']):.3g}, zero up to rounding)")
    log(f"  epoch_s {rep_g['epoch_s']!r} (5 timed steps, host clock); "
        f"phases {json.dumps(rep_g['phases'])}")
    log(f"  step breakdown (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trg, data))}")
    log_device_busy("flagship GAT training", lambda: trg.step(data), reps=3,
                    what="steps")
    calls = record_gat_passes(lambda: gat_train_pass(trg, data))
    nl = len(widths_f)
    want_passes = [gat_passes([w]) for w in widths_f]
    if [len(c) for c in calls] != want_passes + want_passes[::-1]:
        raise AssertionError(f"recorded K5 passes per aggregation "
                             f"{[len(c) for c in calls]}, expected the "
                             f"forward's {want_passes} and the backward's "
                             "in reverse")
    # the flagship layer: layer 0's forward and layer 1's backward, both
    # split (f = 128 numerator + f = 1 denominator)
    err_f, gat_fwd = check_time_gat_call(calls[0], "flagship GAT layer-0 "
                                         "forward")
    err_b, gat_bwd = check_time_gat_call(calls[nl + 1], "flagship GAT "
                                         "layer-1 backward")
    err_b = max(err_b, check_gat_passes(           # the other backward passes
        [calls[nl], calls[2 * nl - 1]], "flagship GAT backward"))

    # ---------------------------------------------------------- phase 9
    log("phase 9: train cora2708 GAT on the card through the CLI (--model "
        "gat --epochs 5 --warmup 0), against the dense GAT oracle from the "
        "same seed")
    from sgcn_tpu_torch.baselines import DenseGATOracle

    out = io.StringIO()
    t0 = time.perf_counter()
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    with contextlib.redirect_stdout(out):
        train_main(["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                    "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8",
                    "-l", "2", "--hidden", "16", "--model", "gat",
                    "--epochs", "5", "--warmup", "0", "--seed", "11",
                    "--comm-schedule", "a2a"])
    k1_close()
    launches_gtc = spmm_tiles.mask_launches     # ... and ends here
    packs_gtc = row_pack.launches
    bwd_gtc = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gtc
    lines = out.getvalue().strip().splitlines()
    rep_gc = json.loads(lines[-1])
    cli_losses = [float(x.split()[-1]) for x in lines
                  if x.startswith("epoch ")]
    labels_c = load_npz_dataset(os.path.join(fix, "cora2708.npz"))[2]
    oracle = DenseGATOracle(ahat, 1433, [16, 7], seed=11, device=dev)
    want_losses = oracle.fit(feats, labels_c, epochs=5)
    rel = np.abs(np.asarray(cli_losses) / np.asarray(want_losses) - 1)
    log(f"  CLI report ({time.perf_counter() - t0:.2f} s with the oracle): "
        f"{json.dumps(rep_gc)}")
    log(f"  CLI losses {cli_losses}; dense GAT oracle {want_losses}; max "
        f"relative gap {rel.max():.3g}")
    want_gtc = 5 * 2 * gat_passes([16, 7])
    want_pgc = 5 * 2 * pack_launches("gat", "a2a", [16, 7])
    log(f"  K5 launches {launches_gtc} (backward {bwd_gtc}), row pack "
        f"{packs_gtc}; expected {want_gtc} ({want_gtc // 2}), {want_pgc}")
    if launches_gtc != want_gtc or bwd_gtc != want_gtc // 2 \
            or packs_gtc != want_pgc:
        raise AssertionError("cora GAT training: K5 launch count differs "
                             "from the passes the program runs")
    if rep_gc["model"] != "gat" or len(cli_losses) != 5 \
            or not rel.max() <= 1e-4:
        raise AssertionError("cora GAT: the CLI's losses do not track the "
                             "dense GAT oracle within 1e-4 relative")

    # ---------------------------------------------------------- phase 10
    log("phase 10: K4 serving — the ragged ring for GCN and GAT on phase "
        "3's plan, features and weights; served rows == the a2a engines' "
        "(phases 3 and 7), bit for bit")
    from sgcn_tpu_torch.ops.pspmm import ring_concat
    from sgcn_tpu_torch.ops.tile_spmm import PspmmTilesRagged
    from sgcn_tpu_torch.parallel import resolve_comm_schedule

    d_f = {}
    resolve_comm_schedule("auto", [plan], "gcn", decision=d_f)
    log(f"  flagship ring: rr_sizes {plan.ensure_ragged().rr_sizes}, S "
        f"{plan.s}, R {plan.r}; wire rows per exchange a2a "
        f"{d_f['wire_rows_a2a']}, ragged {d_f['wire_rows_ragged']}, true "
        f"{d_f['true_rows']} (padding efficiency "
        f"{d_f['padding_efficiency']:.3f}); auto resolves "
        f"{d_f['resolved']} ({d_f['rule']})")
    eng_fr, _res_fr, launches_fr = serve_ragged(
        "flagship GCN ragged", eng_f, feats_f, 512, 64, 3)
    log_side_by_side("GCN forward breakdown", bd_f, forward_breakdown(eng_fr),
                     ("exchange_ms", "fused_kernel_ms"))
    log_device_busy("flagship GCN ragged", lambda: eng_fr.query(np.arange(64)))
    pa_r, st_r = eng_fr.pa, eng_fr.setup.fwd_static
    ring0 = ring_concat(h0, pa_r["ring_src"], st_r["rr_sizes"])
    rtiles = [pa_r["ptile_hrsrc"], pa_r["ptile_hld"], pa_r["ptile_hw"]]
    rtiles_np = [t.cpu().numpy() for t in rtiles]
    check_pack(h0, pa_r["ring_src"], h0.dtype, "flagship layer-0 ring")
    fused_err = max(fused_err, check_fused(
        ltiles, h0, rtiles, ring0, st_r["pallas_lclasses"],
        st_r["pallas_hclasses"], tb, "flagship layer-0 ring fused f=128"))
    k4_err = check_k1(rtiles, ring0, st_r["pallas_hclasses"], tb,
                      "flagship ring pass f=128")
    t_ring = time_k1(rtiles_np, rtiles, ring0, st_r["pallas_hclasses"], tb,
                     ring0.shape[1], "flagship ring pass f=128")
    k4 = time_whole_op(h0, pa_r, st_r, tb, True,
                       "flagship K4 layer 0 forward f=128")
    log(f"  one whole aggregation at f=128 (exchange + fused launch): "
        f"ring {k4['ms']!r} ms, a2a {k3['ms']!r} ms; K1 alone on the ring "
        f"pass {t_ring['ms']!r} ms")

    eng_gfr, _res_gfr, launches_gfr = serve_ragged(
        "flagship GAT ragged", eng_gf, feats_f, 512, 64, 3)
    log_side_by_side("GAT forward breakdown", bd_gf,
                     gat_forward_breakdown(eng_gfr),
                     ("exchange_ms", "numerator_pass_ms",
                      "denominator_pass_ms"))
    log_device_busy("flagship GAT ragged",
                    lambda: eng_gfr.query(np.arange(64)))
    k5r_err = check_gat_passes(record_gat_passes(eng_gfr.forward),
                               "flagship GAT ring forward")

    # ---------------------------------------------------------- phase 11
    log("phase 11: K4 training — GCN and GAT on the ring on phases 5 and "
        "8's plan and data from the same initial weights, 1 warm-up + 5 "
        "timed steps; losses and weights == the a2a runs'")
    trr = FullBatchTrainer(plan, fin=128, widths=widths_f, seed=5,
                           comm_schedule="ragged", device=dev)
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
    rep_r = trr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_rt = spmm_tiles_fused.launches     # ... and ends here
    packs_rt = row_pack.launches
    ring_rt = PspmmTilesRagged.launches
    ring_bwd_rt = PspmmTilesRagged.backward_launches
    MAIN_PATH_PACKS[0] += packs_rt
    log(f"  GCN fused launches {launches_rt} (ring forward {ring_rt}, "
        f"ring backward {ring_bwd_rt}), row pack {packs_rt}; expected "
        f"{want_f} each")
    if (launches_rt != want_f or ring_bwd_rt != steps_f * bwd_f * fam
            or ring_rt + ring_bwd_rt != launches_rt or packs_rt != want_f):
        raise AssertionError("ragged GCN training: launch count differs "
                             "from the passes the program runs")
    same_w = all(torch.equal(a, b) for a, b in zip(trr.params, fit_f))
    log(f"  GCN losses {rep_r['loss_history']}; == a2a: "
        f"{rep_r['loss_history'] == rep['loss_history']}; weights == a2a: "
        f"{same_w}")
    if rep_r["loss_history"] != rep["loss_history"] or not same_w:
        raise AssertionError("ragged GCN training differs from a2a")
    log(f"  GCN epoch_s ring {rep_r['epoch_s']!r} (a2a {rep['epoch_s']!r}); "
        f"comm {json.dumps({k: rep_r[k] for k in ('comm_schedule', 'wire_rows_per_exchange', 'true_rows_per_exchange', 'padding_efficiency')})}")
    log(f"  GCN step breakdown on the ring (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trr, data))}")
    log_device_busy("flagship GCN ragged training", lambda: trr.step(data),
                    reps=3, what="steps")
    _zs, caught_r = forward_backward_trace(trr, data)
    g_r = caught_r[layer_b]
    gring = ring_concat(g_r, pa_r["ring_src"], st_r["rr_sizes"])
    k4b_err = max(
        check_k1(ltiles, g_r, st_r["pallas_lclasses"], tb,
                 f"flagship layer-{layer_b} gradient local pass (ring run)"),
        check_k1(rtiles, gring, st_r["pallas_hclasses"], tb,
                 f"flagship layer-{layer_b} gradient ring pass f=128"))
    fused_err = max(fused_err, check_fused(
        ltiles, g_r, rtiles, gring, st_r["pallas_lclasses"],
        st_r["pallas_hclasses"], tb, f"flagship layer-{layer_b} gradient "
        "ring fused f=128"))
    k4b = time_whole_op(g_r, pa_r, st_r, tb, True, f"flagship K4 "
                        f"layer-{layer_b} backward (on the gradient) f=128")

    trgr = FullBatchTrainer(plan, fin=128, widths=widths_f, model="gat",
                            activation="none",
                            params=gat_from_numpy(params_g),
                            comm_schedule="ragged", device=dev)
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    rep_gr = trgr.fit(data, epochs=5, warmup=1, verbose=False)
    k1_close()
    launches_grt = spmm_tiles.mask_launches     # ... and ends here
    packs_grt = row_pack.launches
    bwd_grt = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_grt
    want_pgr = steps_f * 2 * pack_launches("gat", "ragged", widths_f)
    log(f"  GAT K5 launches {launches_grt} (backward {bwd_grt}), row pack "
        f"{packs_grt}; expected {want_gt} ({want_gt // 2}), {want_pgr}")
    if launches_grt != want_gt or bwd_grt != want_gt // 2 \
            or packs_grt != want_pgr:
        raise AssertionError("ragged GAT training: K5 launch count "
                             "differs from the passes the program runs")
    same_g = all(torch.equal(a, b)
                 for a, b in zip(trgr.model.parameters(), fit_g))
    log(f"  GAT losses {rep_gr['loss_history']}; == a2a: "
        f"{rep_gr['loss_history'] == rep_g['loss_history']}; weights == "
        f"a2a: {same_g}")
    if rep_gr["loss_history"] != rep_g["loss_history"] or not same_g:
        raise AssertionError("ragged GAT training differs from a2a")
    log(f"  GAT epoch_s ring {rep_gr['epoch_s']!r} (a2a "
        f"{rep_g['epoch_s']!r})")
    log(f"  GAT step breakdown on the ring (CUDA events, mean of 3): "
        f"{json.dumps(step_breakdown(trgr, data))}")
    log_device_busy("flagship GAT ragged training", lambda: trgr.step(data),
                    reps=3, what="steps")
    k5r_err = max(k5r_err, check_gat_passes(
        record_gat_passes(lambda: gat_train_pass(trgr, data)),
        "flagship GAT ring training"))

    # ---------------------------------------------------------- phase 12
    log("phase 12: cora2708 8-hp through the train CLI with --comm-schedule "
        "auto (resolves to the ring) against --comm-schedule a2a, GCN and "
        "GAT, 5 steps; then each transport's epoch_s with warm-up")
    cli_base = ["--npz", os.path.join(fix, "cora2708.npz"), "--normalize",
                "-p", os.path.join(fix, "cora2708.8.hp"), "-s", "8", "-l",
                "2", "--hidden", "16", "--seed", "11"]
    cli = cli_base + ["--epochs", "5", "--warmup", "0"]
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    losses_ca, rep_ca = run_train_cli(cli + ["--comm-schedule", "a2a"])
    k1_close()
    launches_ca = spmm_tiles_fused.launches     # ... and ends here
    packs_ca = row_pack.launches
    spmm_tiles_fused.launches = 0               # the main path starts here
    k1_open()
    row_pack.launches = 0
    PspmmTilesRagged.launches = PspmmTilesRagged.backward_launches = 0
    losses_cr, rep_cr = run_train_cli(cli + ["--comm-schedule", "auto"])
    k1_close()
    launches_cr = spmm_tiles_fused.launches     # ... and ends here
    packs_cr = row_pack.launches
    ring_cr = PspmmTilesRagged.launches
    ring_bwd_cr = PspmmTilesRagged.backward_launches
    MAIN_PATH_PACKS[0] += packs_ca + packs_cr
    want_cc = 5 * (2 + backward_passes(1433, [16, 7])) * fam
    log(f"  GCN: a2a losses {losses_ca}; auto -> {rep_cr['comm_schedule']} "
        f"(wire rows {rep_cr['wire_rows_per_exchange']} vs "
        f"{rep_ca['wire_rows_per_exchange']}) losses {losses_cr}; fused "
        f"launches {launches_ca} / {launches_cr} (ring {ring_cr} + "
        f"{ring_bwd_cr}), row pack {packs_ca} / {packs_cr}, expected "
        f"{want_cc} each; epoch_s a2a {rep_ca['epoch_s']!r}, ring "
        f"{rep_cr['epoch_s']!r} (host-bound)")
    if (rep_cr["comm_schedule"] != "ragged" or rep_ca["comm_schedule"]
            != "a2a" or losses_cr != losses_ca or len(losses_cr) != 5
            or launches_ca != want_cc or launches_cr != want_cc
            or ring_cr + ring_bwd_cr != want_cc
            or packs_ca != want_cc or packs_cr != want_cc):
        raise AssertionError(
            f"cora GCN CLI: auto did not train the ring with the a2a losses "
            f"and exact launches: schedule {rep_cr['comm_schedule']}, losses "
            f"{losses_cr} vs a2a {losses_ca}, fused launches {launches_ca} / "
            f"{launches_cr} (ring {ring_cr} + {ring_bwd_cr}), row pack "
            f"{packs_ca} / {packs_cr}, expected {want_cc}")
    spmm_tiles.mask_launches = 0                # the main path starts here
    k1_open()
    row_pack.launches = 0
    GatLayerSym.backward_launches = 0
    losses_gcr, rep_gcr = run_train_cli(
        cli + ["--model", "gat", "--comm-schedule", "auto"])
    k1_close()
    launches_gcr = spmm_tiles.mask_launches     # ... and ends here
    packs_gcr = row_pack.launches
    bwd_gcr = GatLayerSym.backward_launches
    MAIN_PATH_PACKS[0] += packs_gcr
    log(f"  GAT: auto -> {rep_gcr['comm_schedule']} losses {losses_gcr}; "
        f"phase 9's a2a {cli_losses}; K5 launches {launches_gcr} (backward "
        f"{bwd_gcr}), expected {want_gtc}; epoch_s a2a "
        f"{rep_gc['epoch_s']!r}, ring {rep_gcr['epoch_s']!r}")
    want_pgcr = 5 * 2 * pack_launches("gat", "ragged", [16, 7])
    if (rep_gcr["comm_schedule"] != "ragged" or losses_gcr != cli_losses
            or launches_gcr != want_gtc or bwd_gcr != want_gtc // 2
            or packs_gcr != want_pgcr):
        raise AssertionError(
            f"cora GAT CLI: auto did not train the ring with the a2a losses "
            f"and exact launches: schedule {rep_gcr['comm_schedule']}, "
            f"losses {losses_gcr} vs a2a {cli_losses}, K5 launches "
            f"{launches_gcr} (backward {bwd_gcr}) vs {want_gtc}, row pack "
            f"{packs_gcr} vs {want_pgcr}")
    # epoch_s of each transport, 3 runs each of 3 warm-up + 20 timed
    # steps, in the order a2a, ring, ring, a2a, a2a, ring so that a drift
    # of the shared host weighs on both alike
    for model in ("gcn", "gat"):
        runs = {"a2a": [], "ragged": []}
        for sched in ("a2a", "ragged", "ragged", "a2a", "a2a", "ragged"):
            runs[sched].append(run_train_cli(
                cli_base + ["--epochs", "20", "--warmup", "3", "--model",
                            model, "--comm-schedule", sched])[1]["epoch_s"])
        med = {key: statistics.median(v) for key, v in runs.items()}
        log(f"  cora {model.upper()} epoch_s, 3 + 20 steps per run: a2a "
            f"{runs['a2a']!r}, ring {runs['ragged']!r}; medians a2a "
            f"{med['a2a']!r}, ring {med['ragged']!r}, ring / a2a "
            f"{med['ragged'] / med['a2a']:.3f}")

    # ---------------------------------------------------------- phase 13
    log("phase 13: K6 — the row shuffle kernel vs its plain version at "
        "S = 2048, then the micro-benchmark (python -m "
        "sgcn_tpu_torch.tools.spmm_micro) at its defaults")
    from sgcn_tpu_torch.ops.row_shuffle import row_shuffle, row_shuffle_plain
    from sgcn_tpu_torch.tools.spmm_micro import main as micro_main

    s_k6 = 2048
    k6_err = 0.0
    for f in (1, 41, 128):
        chunk = torch.as_tensor(rng.standard_normal((s_k6, f)).astype(
            np.float32)).to(dev)
        gidx = torch.as_tensor(rng.integers(0, s_k6, (s_k6, 1)).astype(
            np.int32)).to(dev)
        one, two = row_shuffle(chunk, gidx), row_shuffle(chunk, gidx)
        plain = row_shuffle_plain(chunk, gidx)
        torch.cuda.synchronize()
        diff = float((one - plain).abs().max())
        log(f"  row_shuffle f={f}: max |kernel - plain| = {diff!r} "
            f"(relaunch identical: {torch.equal(one, two)})")
        if not (torch.equal(one, two) and torch.equal(one, plain)):
            raise AssertionError(f"row_shuffle f={f}: kernel != plain")
        k6_err = max(k6_err, diff)
    row_shuffle.launches = 0                    # the main path starts here
    k1_open()
    micro = micro_main([])
    k1_close()
    launches_k6 = row_shuffle.launches          # ... and ends here
    if launches_k6 == 0:
        raise AssertionError("spmm_micro launched no row_shuffle kernel")
    log("  this card's ceilings (spmm_micro): " + "; ".join(
        f"{p_['name']} {p_.get('gbps', p_.get('tflops'))!r} "
        f"{'GB/s' if 'gbps' in p_ else 'TFLOP/s'}"
        for p_ in micro["spmm_micro"]))
    # at this size a call is shorter than the host's launch of it, so
    # CUDA events around back-to-back calls time the host; the device's
    # own time per call comes from the profiler (kernels and copies only)
    idx_l = gidx.long().expand(s_k6, 128)
    calls = {"ms": lambda: row_shuffle(chunk, gidx),
             "plain_ms": lambda: row_shuffle_plain(chunk, gidx),
             "library_ms": lambda: torch.take_along_dim(chunk, idx_l, dim=0)}
    k6 = {key: device_busy(fn, reps=100, tries=3)[1] / 100
          for key, fn in calls.items()}
    if not all(v > 0 for v in k6.values()):
        raise AssertionError(f"the profiler saw no device time: {k6}")
    k6["bound_ms"] = k6_bound_ms(gidx, 128)
    events = {key: cuda_ms(fn) for key, fn in calls.items()}
    log(f"  row_shuffle S={s_k6} f=128, device time per call "
        f"(torch.profiler, 100 calls): kernel {k6['ms']!r} ms, plain "
        f"{k6['plain_ms']!r} ms, torch.take_along_dim "
        f"{k6['library_ms']!r} ms; bound {k6['bound_ms']!r} ms by bytes; "
        f"CUDA events per back-to-back call (host-bound): "
        f"{json.dumps(events)}")

    # ---------------------------------------------------------- phase 14
    log("phase 14: K1 and K5 on bf16 tables (the bf16 entry points) vs "
        "their plain version on phase 1's tiles")
    err16, times16 = phase_bf16_kernels(rng, dev, tiles_np, tiles, classes,
                                        tb, n)

    # ---------------------------------------------------------- phase 15
    log("phase 15: the flagship GCN (phase 5) under halo_dtype='bfloat16' "
        "and compute_dtype='bfloat16', both transports, from phase 5's "
        "initial weights")
    split_f32("GCN", {"a2a": tr, "ragged": trr}, data)
    l15, err15, k1_16, op_16, wire_16, halo_runs = phase_bf16_gcn_training(
        plan, data, p_init, widths_f, rep, dev, tb, steps_f, bwd_f)

    # ---------------------------------------------------------- phase 16
    log("phase 16: flagship GCN serving with halo_dtype='bfloat16', both "
        "transports (phase 3's plan, weights and features)")
    launches_16 = phase_bf16_serving(eng_f, eng_fr, res_f, _res_fr, ahat_f,
                                     feats_f, dev)

    # ---------------------------------------------------------- phase 17
    log("phase 17: the flagship GAT (phase 8) under compute_dtype="
        "'bfloat16', both transports; then cora2708 GAT --dtype bfloat16 "
        "through the CLI")
    split_f32("GAT", {"a2a": trg, "ragged": trgr}, data)
    l17, err17, k5_16 = phase_bf16_gat(
        plan, data, params_g, widths_f, rep_g, dev, steps_f, cli,
        cli_losses)

    # ---------------------------------------------------------- phase 18
    log("phase 18: the row pack and the fused entry on every real exchange "
        "and aggregation of one flagship training pass (forward and "
        "backward), GCN and GAT, both transports: kernel == plain")
    for name, trainer, run in (
            ("GCN a2a", tr, gcn_train_pass), ("GCN ring", trr, gcn_train_pass),
            ("GAT a2a", trg, gat_train_pass),
            ("GAT ring", trgr, gat_train_pass)):
        _fams, packs, fused = record_launches(lambda: run(trainer, data))
        for j, (src, flat, dtype) in enumerate(packs):
            check_pack(src, flat, dtype, f"{name} exchange {j}")
        for j, args in enumerate(fused):
            fused_err = max(fused_err, check_fused(
                *args, f"{name} aggregation {j} fused"))
        log(f"  {name}: {len(packs)} exchanges (tables "
            f"{sorted({tuple(p[0].shape[2:]) for p in packs})}) == plain "
            f"bit for bit; {len(fused)} fused launches == plain")
        if not packs or (name.startswith("GCN") and not fused):
            raise AssertionError(f"{name}: recorded no exchange")

    # ------------------------------------------------------ phases 19-21
    # K1's float-weight family entries make no launch on the symmetric
    # paths above (the fused entry runs their chains); the asymmetric
    # backward launches them (the halo rows' transpose)
    if any(MAIN_PATH_K1.values()):
        raise AssertionError(f"K1 family-entry launches on the symmetric "
                             f"main path: {MAIN_PATH_K1}, expected 0")
    t0 = time.perf_counter()
    ahat_d = normalize_adjacency(directed_er_graph(n_f, seed=0))
    log(f"  directed flagship graph {time.perf_counter() - t0:.2f} s, nnz "
        f"{ahat_d.nnz}")
    asym = phase_asymmetric(ahat_d, feats_f, labels_f, pv_f, widths_f, dev,
                            tb, steps_f, k3b)

    # ---------------------------------------------------------- phase 22
    log("phase 22: repeated runs in one process (tools/repeat_run.py): "
        "cora2708 GAT a2a x 20, the directed flagship GCN and GAT x 3; "
        "exactly one loss history and one weight digest each")
    phase_repeat(fix, dev, asym, widths_f)

    # ---------------------------------------------------------- phase 23
    log("phase 23: checkpoints at the flagship width (GCN a2a and ring, "
        "GAT a2a, float32): kill after a save and resume in a new process, "
        "a corrupt newest file, serving from a checkpoint, hot swap")
    killed = {}
    p23 = phase_checkpoints(
        plan, ahat_f, feats_f, labels_f, pv_f, widths_f, data, dev, smi,
        on_inputs=lambda: killed.update(start_killed_children(widths_f)))
    MAIN_PATH_PACKS[0] += p23["pack"]

    # ---------------------------------------------------------- phase 24
    log("phase 24: the offline pipeline — cora2708 through the prep, "
        "partition (hp, gp, rp), train (both transports) and serve CLIs in "
        "this process; then the DCSBM flagship on its hp, gp and rp "
        "parts: GCN (both transports) and GAT training, GCN serving")
    p24, fused_err24, k3_hp = phase_pipeline(parts_bg, ahat_dc, fix, dev, tb,
                                             smi)
    MAIN_PATH_PACKS[0] += p24["pack"]
    fused_err = max(fused_err, fused_err24)

    # ---------------------------------------------------------- phase 25
    log("phase 25: the pipelined stale-halo trainer (halo_staleness=1) at "
        "the flagship width: sync_every=1 == exact, stale ragged == stale "
        "a2a, launches and kernels == plain per stale and sync step, the "
        "reference's loss band, times, kill and resume, the controller on "
        "the CLI")
    t25 = time.perf_counter()
    p25, fused_err25 = phase_stale(plan, data, p_init, widths_f, rep, fit_f,
                                   halo_runs, dev, tb, cli_base, killed[25],
                                   smi)
    MAIN_PATH_PACKS[0] += p25["pack"]
    fused_err = max(fused_err, fused_err25)
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s")

    # ---------------------------------------------------------- phase 26
    log("phase 26: hot-halo replicas (replica_budget) at the flagship "
        "width, the ER plan on both transports and the DCSBM flagship on "
        "phase 24's hp parts: sync_every=1 == exact, replica ring == a2a, "
        "the kept pack == plain, launches per replica and refresh step, "
        "the clamp, the loss band, the partial refresh's extremes, times, "
        "kill and resume, the CLI")
    t26 = time.perf_counter()
    p26, pack26 = phase_replicas(plan, data, p_init, widths_f, rep, fit_f,
                                 halo_runs, parts_bg, ahat_dc, dev, tb,
                                 cli_base, killed[26], smi)
    MAIN_PATH_PACKS[0] += p26["pack"]
    log(f"  phase 26 took {time.perf_counter() - t26:.1f} s")

    # ---------------------------------------------------------- phase 27
    log("phase 27: the mini-batch trainer (batch 4096, 126 padded batch "
        "plans) on the DCSBM flagship's hp parts and SHP's stchp parts: GCN "
        "on both transports, GAT, GCN under compute_dtype, the epoch sweep, "
        "the kernels on a padded batch plan, full-graph evaluation; the SHP "
        "and the train CLI's -n 512 (checkpoint, resume) on cora2708")
    t27 = time.perf_counter()
    p27, fused_err27, k5_err27 = phase_minibatch(parts_bg, ahat_dc, fix, dev,
                                                 smi)
    MAIN_PATH_PACKS[0] += p27["pack"]
    fused_err = max(fused_err, fused_err27)
    log(f"  phase 27 took {time.perf_counter() - t27:.1f} s")

    # ---------------------------------------------------------- phase 28
    log("phase 28: sub-graph serving — cora2708 GCN (both transports, the "
        "bf16 wire) and GAT, the DCSBM flagship on phase 24's hp parts "
        "(GCN and GAT, batches of 1, 8 and 32): compact launches == plain, "
        "exact launches, rows vs float64 and the full engine, host and "
        "device ms, p50/p99 against full mode; the serve CLI's --serve-mode "
        "subgraph, --concurrent and --shed-factor in children")
    t28 = time.perf_counter()
    p28, sub_err = phase_subgraph(parts_bg, ahat_dc, ahat, feats, pv, dev,
                                  smi)
    MAIN_PATH_PACKS[0] += p28["pack"]
    fused_err = max(fused_err, sub_err)
    log(f"  phase 28 took {time.perf_counter() - t28:.1f} s")

    # ---------------------------------------------------------- phase 29
    log("phase 29: run telemetry, the memory model and remat — GCN and "
        "GAT on both transports at the flagship width, plain and remat "
        "under a RunRecorder (bits, launches, the memory joins, peak and "
        "epoch_s), the budget gate, the cora train CLI with --metrics-out "
        "--profile and the serve CLI with --metrics-out --memory-budget in "
        "children")
    t29 = time.perf_counter()
    p29, _mem29 = phase_telemetry(plan, feats_f, labels_f, p_init, params_g,
                                  widths_f, fix, dev, smi)
    MAIN_PATH_PACKS[0] += p29["pack"]
    log(f"  phase 29 took {time.perf_counter() - t29:.1f} s")

    # ---------------------------------------------------------- phase 30
    log("phase 30: the CAGNET broadcast baseline (cora, the ER and DCSBM hp "
        "flagships: rows, K1 == plain, fused == split, per-layer times and "
        "wire rows against the partitioned forward), the shard proxy on "
        "every chip of both flagship plans, one NCCL rank == the stacked "
        "proxy, the baselines CLIs in children and the dispatcher")
    t30 = time.perf_counter()
    p30, r30 = phase_ranks(plan, ahat_f, feats_f, labels_f, pv_f, p_init,
                           params_g, widths_f, parts_bg, ahat_dc, ahat, feats,
                           pv, k3, k3_hp, dev, tb, smi)
    MAIN_PATH_PACKS[0] += p30["pack"]
    log(f"  phase 30 took {time.perf_counter() - t30:.1f} s")

    # ---------------------------------------------------------- phase 31
    log("phase 31: GAT (a2a, ring, compute_dtype, remat) and GCN "
        "compute_dtype on one NCCL rank == the stacked proxy, exact "
        "launches, K5 and K1-bf16 == plain; the cora train CLI under "
        "torch.distributed.run == the unlaunched CLI, its heartbeats")
    t31 = time.perf_counter()
    p31, r31 = phase_rank_levers(plan, feats_f, labels_f, p_init, params_g,
                                 widths_f, fix, dev, tb, smi)
    MAIN_PATH_PACKS[0] += p31["pack"]
    log(f"  phase 31 took {time.perf_counter() - t31:.1f} s")

    # ---------------------------------------------------------- phase 32
    log("phase 32: the carried modes on one NCCL rank — stale (a2a, ring, "
        "delta, bf16 wire), replicas (auto: a2a, ring, bf16 wire), replica "
        "x stale and the partial refresh on chip 0's ER slice, 4 steps each "
        "== the stacked proxy, exact launches, the rank's fused entry and "
        "pack-into == plain on both wires, the memory join")
    t32 = time.perf_counter()
    p32, r32 = phase_rank_carried(plan, feats_f, labels_f, p_init, widths_f,
                                  dev, tb, smi)
    MAIN_PATH_PACKS[0] += p32["pack"]
    log(f"  phase 32 took {time.perf_counter() - t32:.1f} s")

    # ---------------------------------------------------------- phase 33
    log("phase 33: directed plans (GCN float32, bf16 wire, compute_dtype; "
        "GAT) on one NCCL rank on chip 0's directed flagship slice, the "
        "backward's reverse all_to_all_single; the mini-batch trainer (GCN "
        "a2a and ring, GAT) on one NCCL rank on part 0's ER batch slices; "
        "== the stacked proxy, exact launches, the halo-T and weight-1 "
        "families == plain, the memory join")
    t33 = time.perf_counter()
    p33, r33 = phase_rank_directed_minibatch(
        asym, ahat_f, feats_f, labels_f, pv_f, p_init, params_g, widths_f,
        dev, smi)
    MAIN_PATH_PACKS[0] += p33["pack"]
    log(f"  phase 33 took {time.perf_counter() - t33:.1f} s")

    # ---------------------------------------------------------- phase 34
    log("phase 34: the ELL aggregator (SGCN_PALLAS_SPMM=0) — cora2708 "
        "(a2a, ring) and the directed cora, the flagship GCN on both "
        "transports under a recorder, the full-mode server: ring == a2a, "
        "ELL against tiles, no K1 or fused launch, one pack an exchange, "
        "the roofline and measured_vs_model blocks, the memory join, "
        "epoch_s and the device split")
    t34 = time.perf_counter()
    p34 = phase_ell(plan, data, p_init, widths_f, eng_f, feats_f, fix, dev,
                    smi)
    MAIN_PATH_PACKS[0] += p34["pack"]
    log(f"  phase 34 took {time.perf_counter() - t34:.1f} s")

    # ---------------------------------------------------------- phase 35
    fused_main = (launches_c + launches_f + launches_tc + launches_tf
                  + launches_fr + launches_rt + launches_ca + launches_cr
                  + l15["wire"] + l15["bf16"] + launches_16 + asym["fused"]
                  + p23["fused"] + p24["fused"] + p25["fused"]
                  + p25["fused_wire"] + p26["fused"] + p26["fused_wire"]
                  + p27["fused"] + p27["fused_bf16"] + p28["fused"]
                  + p28["fused_wire"] + p29["fused"] + p30["fused"]
                  + p32["fused"] + p32["fused_wire"])
    kernels = [{
        # K1's own float32-weight family entry: its launches on the main
        # path are the asymmetric backward's halo-ᵀ launches and phases
        # 30-33's (the broadcast's local SpMM, the rank path's local and
        # halo passes, a rank's replica steps, a rank's directed
        # backward: halo-ᵀ, local-ᵀ, weight-1); the symmetric phases 2-29
        # run its chains inside the fused entry, which counts those
        # launches under tile_spmm_fused; the times are its own family
        # launches at the flagship layer
        "name": "tile_spmm",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": (asym["k1"] + p30["k1"] + p31["k1"] + p32["k1"]
                     + p33["k1"]),
        "max_abs_err": max(max_err, grad_err, k4_err, k4b_err, asym["err"],
                           r30["k1_err"], r33["err"]["th"],
                           r33["err"]["t1"]),
        "ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": t_halo["bound_by"],
        "library_ms": layer["library_ms"],
    }, {
        # K3's backward: the whole op (exchange + fused launch) on the
        # gradient
        "name": "pspmm_tiles_sym_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:457-464",
        "launches": (bwd_tc + bwd_tf + p23["sym_bwd"] + p24["sym_bwd"]
                     + p25["sym_bwd"] + p26["sym_bwd"] + p27["sym_bwd"]
                     + p29["sym_bwd"] + p30["sym_bwd"]),
        "max_abs_err": max(grad_err, fused_err),
        "ms": k3b["ms"],
        "plain_ms": k3b["plain_ms"],
        "bound_ms": k3b["bound_ms"],
        "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"],
    }, {
        "name": "gat_tiles_pass",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:530-545",
        "launches": (launches_gc + launches_gf + launches_gt + launches_gtc
                     + launches_gfr + launches_grt + launches_gcr
                     + l17["f32"] + asym["k5"] + p23["k5"] + p24["k5"]
                     + p27["k5"] + p28["k5"] + p29["k5"] + p30["k5"]
                     + p31["k5"] + p33["k5"]),
        "max_abs_err": max(k5_err, err_f, err_b, k5r_err, k5_err27, sub_err,
                           r31["rank"]["err"]["k5"]),
        "ms": gat_fwd["ms"],
        "plain_ms": gat_fwd["plain_ms"],
        "bound_ms": gat_fwd["bound_ms"],
        "bound_by": gat_fwd["bound_by"],
        "library_ms": gat_fwd["library_ms"],
    }, {
        "name": "gat_layer_sym_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/models/gat.py:637-687",
        "launches": (bwd_gt + bwd_gtc + bwd_grt + bwd_gcr + p23["gat_bwd"]
                     + p24["gat_bwd"] + p27["gat_bwd"] + p29["gat_bwd"]
                     + p30["gat_bwd"] + p31["gat_bwd"] + p33["gat_bwd"]),
        "max_abs_err": max(err_b, k5r_err),
        "ms": gat_bwd["ms"],
        "plain_ms": gat_bwd["plain_ms"],
        "bound_ms": gat_bwd["bound_ms"],
        "bound_by": gat_bwd["bound_by"],
        "library_ms": gat_bwd["library_ms"],
    }, {
        # K4: the whole op (ring pack + fused launch) per flagship layer
        "name": "pspmm_tiles_ragged",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:469-527",
        "launches": (launches_fr + ring_rt + ring_cr + p23["ring"]
                     + p24["ring"] + p25["ring"] + p26["ring"]
                     + p27["ring"] + p29["ring"] + p30["ring"]),
        "max_abs_err": max(k4_err, fused_err),
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }, {
        "name": "pspmm_tiles_ragged_backward",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:517-523",
        "launches": (ring_bwd_rt + ring_bwd_cr + p23["ring_bwd"]
                     + p24["ring_bwd"] + p25["ring_bwd"]
                     + p26["ring_bwd"] + p27["ring_bwd"]
                     + p29["ring_bwd"] + p30["ring_bwd"]),
        "max_abs_err": max(k4b_err, fused_err),
        "ms": k4b["ms"],
        "plain_ms": k4b["plain_ms"],
        "bound_ms": k4b["bound_ms"],
        "bound_by": k4b["bound_by"],
        "library_ms": k4b["library_ms"],
    }, {
        "name": "row_shuffle",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/row_shuffle.cu",
        "replaces": "scripts/spmm_micro.py:163",
        "launches": launches_k6,
        "max_abs_err": k6_err,
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k6["library_ms"],
    }, {
        # K1's own family entry on bf16 tables: its main-path launches
        # are the asymmetric compute_dtype backward's, phase 31's (the
        # rank path's two passes under compute_dtype; the stacked
        # compute_dtype path runs it inside the fused bf16 entry) and
        # phase 32's (a rank's replica step on a bf16 carry); the
        # times are its own family launches at the flagship layer
        "name": "tile_spmm_bf16",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:203",
        "launches": (asym["k1_bf16"] + p31["k1_bf16"] + p32["k1_bf16"]
                     + p33["k1_bf16"]),
        "max_abs_err": max(err16["k1"], err15, r31["rank"]["err"]["k1_bf16"],
                           r33["err"]["t1_bf16"]),
        "ms": k1_16["ms"],
        "plain_ms": k1_16["plain_ms"],
        "bound_ms": k1_16["bound_ms"],
        "bound_by": k1_16["bound_by"],
        "library_ms": k1_16["library_ms"],
    }, {
        "name": "gat_tiles_pass_bf16",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:530-545",
        "launches": l17["bf16"] + p31["k5_bf16"],
        "max_abs_err": max(err16["k5"], err17, r31["rank"]["err"]["k5_bf16"]),
        "ms": k5_16["ms"],
        "plain_ms": k5_16["plain_ms"],
        "bound_ms": k5_16["bound_ms"],
        "bound_by": k5_16["bound_by"],
        "library_ms": k5_16["library_ms"],
    }, {
        # the stacked row pack: every exchange of K3 (a2a) and K4 (ring),
        # GCN and GAT; timed on the flagship layer-0 a2a exchange
        "name": "row_pack",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/row_shuffle.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:418",
        "launches": MAIN_PATH_PACKS[0],
        "max_abs_err": 0.0,
        "ms": k3["pack"]["ms"],
        "plain_ms": k3["pack"]["plain_ms"],
        "bound_ms": k3["pack"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3["pack"]["library_ms"],
    }, {
        # the fused local + remote entry: K3/K4's tile work and sum in one
        # launch, every dtype flavor; timed at the flagship layer 0 (a2a)
        "name": "tile_spmm_fused",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/tile_spmm.cu",
        "replaces": "sgcn_tpu/ops/pallas_spmm.py:413-428",
        "launches": fused_main,
        "max_abs_err": max(fused_err, r32["err"]["fused"]),
        "ms": k3["fused"]["ms"],
        "plain_ms": k3["fused"]["plain_ms"],
        "bound_ms": k3["fused"]["bound_ms"],
        "bound_by": k3["fused"]["bound_by"],
        "library_ms": k3["fused"]["library_ms"],
    }, {
        # the destination-indexed pack: a replica step's kept rows into
        # the carried receive layout (K3/K4's exchange under replicas);
        # timed on the ER flagship's layer-0 kept list (a2a, float32)
        "name": "row_pack_into",
        "route": "cuda",
        "source": "sgcn_tpu_torch/csrc/row_shuffle.cu",
        "replaces": "sgcn_tpu/ops/pspmm.py:577",
        "launches": p26["pack_into"] + p32["pack_into"],
        "max_abs_err": r32["err"]["pack_into"],
        "ms": pack26["ms"],
        "plain_ms": pack26["plain_ms"],
        "bound_ms": pack26["bound_ms"],
        "bound_by": "bytes",
        "library_ms": pack26["library_ms"],
    }]
    # every kernel must be on the main path (K1's family entries through
    # the asymmetric backward only: asserted 0 on the symmetric paths)
    for kern in kernels:
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']}: no launch on the main "
                                 "path")
    op = asym["op"]
    log("  asymmetric backward aggregation (flagship, f=128; halo-T K1 + "
        "reverse pack + fused): " + json.dumps(
            {key: op[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}))
    log("  launches on the main path per entry: " + json.dumps(
        {kern["name"]: kern["launches"] for kern in kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for bg in BACKGROUND:
            bg.close()
    sys.exit(code)
