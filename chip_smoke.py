#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the
script exits non-zero:

1. device — requires CUDA; prints the card's name and power limit
   (``nvidia-smi``); turns TF32 off so fp32 products are fp32.
2. build — builds every CUDA kernel of the port from the sources in the
   checkout (``paddle_tpu_torch/kernels/csrc``), one ``nvcc`` per source,
   all started together; prints registers, shared memory and spills per
   variant (K4/K4q; K1–K3 in ``flash_attention.cu`` at head dims 64/96/
   128 and in ``flash_attention_d256.cu`` at 256, and in
   ``flash_attention_mma.cu`` at the others; K5); the wgmma kernels
   (``NO_SPILL_KERNELS``) must not spill.
3. kernel_vs_plain — the paged decode kernel against its plain PyTorch
   version on the card: K4 over fp32/bf16/fp16 pools and K4q over
   int8/fp8 pools (quantized by the port's ``quantize_kv``; fp32, bf16
   and fp16 queries), over a grid of
   shapes, at the engine's shapes, and at shapes that hit its split-K
   design (pos on and beside split boundaries, rows whose later splits
   are all masked, one row at 64 blocks, one 8192-key table); every case
   runs twice and must give the same bits.
4. rms_norm_vs_plain — K5 against its plain version over (x, w) dtypes
   (fp32, fp32), (bf16, bf16), (fp32, bf16), rows {1, 7, 8192}, widths
   {33, 64, 1000, 1536, 2048, 4096}, and [8, 1024, 2048] bf16.
5. flash_vs_plain — the flash-attention kernels K1 (forward), K2 (dQ)
   and K3 (dK/dV) against their plain versions over S in {128, 256,
   1024, 2048}, head dims {64, 96, 128}, causal and not, bf16 and fp32,
   with and without an LSE cotangent; plus one-tile (S 128, one head),
   two-tile (S 256) and non-causal D 96 cases for the Hopper kernels, a
   persistent grid whose items are no multiple of the SMs (35 heads of
   S 2048), dO [B, H, S, D]-contiguous at the training shape, the
   125M fused leg's own shape (batch 16, 12 heads of 64, S 1024, causal:
   1536 K1 items), BERT-large's (batch 16, 16 heads of 64, S 512, no
   mask) in bf16 and fp16, and the fp16 instances (bf16 kernels on
   operands rounded to bf16 in shared memory, fp16 outputs) over S
   {128, 256, 1024} x D {64, 96, 128} x causal, at the 760M shape and
   on operands that are all ties between bf16 values, with subnormals:
   K1's O and LSE, K2's dQ and K3's dK and dV bit for bit the route on
   the wrapper's rounded copies.  Every K2/K3 call runs twice and must
   give the same bits.
5a. flash_hd_vs_plain — K1–K3 at the head dims off ``flash_attention.cu``
   (``flash_attention_mma.cu``, and ``flash_attention_d256.cu``'s K1–K3
   at D 256 in bf16/fp16): 12 head dims from 16 to 256 at S 256,
   then D 256 (B 2, H 16, S 1024), D 32 (B 4, H 32, S 1024) and D 80,
   each causal and not, in fp32, bf16 and fp16; then 20 D 256 cases at
   the persistent loops' edges (S 128; 35 heads of S 1024, no multiple
   of the SMs; S 384; dO [B, H, S, D]-contiguous and strided) in bf16
   and fp16; the same tolerance and equal-bits check.
6. small_reference — a small fp32 model's paged prefill/decode on the
   card against the same model on the CPU (where the kernels' plain
   versions run), over fp32, int8 and fp8 pools.
7. engine — GPT-3 1.3B in bf16 at full width and depth, random weights
   from seed 0, serving 16 greedy requests through
   ``LLMEngine(model, kv_layout="paged")``; the paged-attention launch
   counts are set to 0 just before and read just after (K4 launches ==
   decode_steps x 24, no K4q launch).  Then one decode step on clones of
   the engine's pools, once through the kernel and once through the
   plain attention, compared in bf16 (in_model); and ``torch.profiler``
   over four decode-only engine steps (profile).
7a. prompt_device — ROADMAP C's fault pinned: the first 4 prompts as
   CUDA int64 tensors through the slot, paged, speculative (125M draft)
   engines and an unthreaded ``ServingFleet``: the same sequences as the
   prompts given as lists.
8. engine_quant — the same model and the same 16 requests through
   ``LLMEngine(..., kv_dtype="int8", weight_dtype="int8")`` (K4q-int8
   launches == decode_steps x 24, no K4 launch; the quant counters move),
   its in-model comparison (in_model_quant) and profile (profile_quant);
   then 4 requests through ``kv_dtype="fp8"`` (engine_fp8: K4q-fp8
   launches == decode_steps x 24).
9. int8_epilogue — one decode step's 96 layer matmuls with bf16 weights
   against int8 weights widened per call.
10. engine_slots — the same model and 16 requests through the default
    slot layout ``LLMEngine(model, max_slots=8, max_seq_len=1024)`` (no
    paged-attention launch); greedy agreement with the paged engine is
    printed.  generate — ``model.generate`` on 4 prompts of 128 tokens,
    32 new: greedy, sampled twice with one seed (equal tokens), and eos
    fill; agreement with the slot engine printed.
11. engine_spec — ``LLMEngine(model, draft_model=<GPT-3 125M bf16>,
    spec_k=4)`` over 8 of the requests (K4 launches == draft steps x 12;
    drafted == accepted + rejected; no block leaked); spec_in_model at
    the fullest speculative round (the draft's K4 at head dim 64 against
    its plain version; ``verify_paged`` column 0 against
    ``decode_paged``); then 4 requests self-drafted and 4 over int8
    pools (K4q-int8 launches == draft steps x 12).
11a. engine_lora — the same model through ``LLMEngine(model,
    kv_layout="paged", adapter_slots=4, adapter_rank=8)``, three tenants
    from ``random_lora_factors(cfg, 8, seed=t)``, the 16 requests 4 base
    and 4 a tenant (K4 launches == decode_steps x 24): the base requests'
    tokens must equal the engine phase's; lora_in_model holds one mixed
    decode step's base rows bit-equal to the adapter-free step and its
    tenant rows, through ``_mm_lora``, to the merged-weight step
    (``_self_calibrated``); two tenants with one prompt share no block;
    a cold page-in and a warm acquire are timed.
11b. host_tier — a paged engine whose pool the 16 requests' prefixes
    overflow, ``host_kv_blocks=1024``, serving them twice (pass 1 spills,
    pass 2 restores), in bf16 (K4) and int8 KV (K4q): spilled and
    restored blocks > 0, a block spilled and restored bit-equal (scale
    rows too), pass 2's greedy agreement with the engine phase at least
    the slot layout's; µs and GB/s of a block spill and restore and the
    device busy share.
11c. migration — the 16 requests prefilled on a source with
    ``hold_after_prefill=True`` and handed to a destination engine
    (``export_request``, ``adopt_migration``, ``finish_migrated``), in
    bf16 and int8 KV: copied blocks and scale rows bit-equal, shared
    prefix blocks adopted (copied = the unshared tail), K4/K4q launches
    == the destination's decode_steps x 24, ms a migration; then one
    migration into a self-drafted ``SpeculativeLLMEngine`` (its draft
    re-prefilled, tokens equal to the unmigrated speculative run).
11d. fleet — the 16 requests through ``ServingFleet(model, replicas=3,
    prefill_replicas=1, kv_layout="paged", threaded=True)``, each
    replica the engine phase's shape: tokens equal the engine phase's,
    zero lost, no death or respawn, blocks copied + shared == blocks
    owned, K4 == decode_steps x 24; TTFT/ITL from the merged replica
    histograms, decode tokens/s beside the engine's, host ms a hand-off,
    the busy share; then the same fleet unthreaded (``pump``, tokens
    equal too); fleet_int8 the same with ``kv_dtype="int8"`` (K4q,
    agreement with the bf16 fleet printed).  fleet_chaos (4 layers):
    two unified replicas under ``replica_crash`` + ``decode_stall``, a
    disaggregated pair under ``kv_migrate_drop``, each token-identical
    to its no-fault run with deaths and respawns as injected, pools
    reconciled and dead pools released.  fleet_autoscale (4 layers):
    ``FLAGS_health`` on, ``slow_decode`` burns ITL, the autoscaler
    disaggregates and the alert resolves.
11e. serve_fp16 — GPT-3 1.3B with ``dtype="float16"``, the 16 requests
    through the paged engine (K4 over fp16 pools == decode_steps x 24),
    ``kv_dtype="int8", weight_dtype="int8"`` (K4q with fp16 queries) and
    the slot engine; in-model checks on the live pools; agreement with
    the bf16 engine printed; K4 fp16 and K4q fp16-q timed at the fp16
    engine's shape.
12. slots_in_model — the 1.3B width at 2 layers: the slot path against
    the paged path (prefill and one decode step), each in bf16 and on
    fp32 copies (``_self_calibrated``); then migration_fp32: 8 requests
    migrated at that depth in fp32 give the unmigrated tokens.
12a. servemp — ``bench.py``'s servemp leg (``:1582``) at one rank over
    NCCL in this process (``init_parallel_env()`` with an in-process
    store): GPT-3 760M bf16 at full width and depth, 8 requests of
    32-128 prompt tokens, 24 new each, 8 slots, blocks of 16, chunks of
    128, through the unsharded paged engine, the slot layout (their
    greedy agreement is the bf16 bar), int8 KV + weights, and
    ``LLMEngine(mesh=build_mesh({"mp": 1}))`` in bf16 and int8: the mesh
    engine's tokens equal the unsharded ones, K4/K4q launches == decode
    steps x 24, host collectives issued, ``kv_pool_bytes_per_chip`` and
    ``weight_bytes_per_chip`` printed; the in-model kernel-vs-plain
    step; K4/K4q at 16 heads of 96 against their plain versions and
    timed (servemp_times).
12b. servemp_mp2 — the same model and requests at mp2 in two processes
    on this card over gloo (a correctness run: gloo stages CUDA
    collectives through the host), bf16 and int8: greedy agreement with
    the unsharded engine at least the bf16 bar, equal tokens on both
    ranks, per-rank KV + weight bytes <= 0.6 x the unsharded figure, K4
    / K4q launches == decode steps x 24 on each rank at 8 heads of 96,
    held against their plain versions on the engine's pools; decode
    tokens/s printed, not gated; K4/K4q at 8 x 96 timed
    (servemp_mp2_times).
13. times (K4, K4q) — µs per wrapper call at the engine's mid-run
    shape: K4 over the bf16 pools, K4q over the same pools quantized,
    beside the plain versions, the bounds and (K4) SDPA over gathered
    K/V; then the same at one row of 1024 keys (the engine's last
    request), with its own bounds and yardstick; then K4 at the draft's
    shape (8 rows, 12 heads of 64).
14. times (K5) — K5's main path (``rms_norm`` once at [8, 1024, 2048]
    bf16, counted), then µs per launch beside the plain version, the
    bound and ``torch.nn.functional.rms_norm``.
15. train — GPT-3 760M in bf16 at full width and depth, batch 8 x 1024,
    through ``CompiledTrainStep`` + ``AdamW(1e-4)``: 2 warm-up and 8
    timed steps on one repeated batch.  K1–K3 launch counts are set to 0
    just before and must each equal 24 x steps; losses must be finite and
    fall.
15a. gpt_dygraph — the same model and batch through Paddle's dygraph
    loop on the ``Layer`` (``model(Tensor)``, ``GPTPretrainingCriterion``,
    ``AdamW`` + ``ClipGradByGlobalNorm(1.0)``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``): the first step bit-equal to
    ``CompiledTrainStep``'s from the same weights, K1–K3 24/24/24 a step
    by the counters and the trace; step ms, tokens/s, model-FLOPs share,
    enqueue, busy share, peak GB; then 4 layers in fp16 with an eager
    ``GradScaler``.
16. train_profile — ``torch.profiler`` over one more step of that run
    (busy share, top device ops, device time by kind of op), CUDA events
    around the forward, backward and AdamW update of another, and the
    AdamW update in place (as the optimizer runs it) against the same
    formula out of place, in turns.
17. train_in_model — the 760M width at 2 layers: one forward and
    backward through the kernels, then through their plain versions,
    then through the kernels with ``recompute="selective"`` (the same
    grads; K1 replayed in the backward).
18. train_loop — GPT-3 760M bf16 at full depth with
    ``recompute="selective_lean"`` (``bench.py``'s flagship) through the
    loop users run: ``AdamW`` over ``CosineAnnealingWithWarmupDecay``,
    ``ClipGradByGlobalNorm(1.0)``, no decay on biases and norms,
    ``metrics=True``; 2 warm-up and 8 timed steps.  The lr series must be
    the scheduler's, the grad norms finite, the losses fall, K1–K3
    launches what the recompute mode implies (K1 replayed), the step
    counters one a step; the host's enqueue time a step beside the step
    time; one more step runs with host syncs made errors, and one under
    ``torch.profiler``.
19. train_fused — GPT-3 125M bf16 at 6 of its 12 layers (cut for the
    time limit), ``recompute="selective"``, batch 16 x
    1024 (``bench.py``'s fused leg): ``fused_steps=4`` (CUDA-graph
    replays) against ``fused_steps=1`` from the same weights on the same
    batches, bit-identical losses, parameters and optimizer state over a
    priming window, a captured window, a replayed one and a tail of 2;
    one dispatch and K1–K3 launches of 4 steps a replay, counted by the
    wrappers and, for one replay and for 4 single steps, in the
    profiler's trace of what the device ran; step ms of both and their
    ratio (``fused_speedup``), the device busy share of each; a replay
    with host syncs made errors; dropout at 2 layers drawing a fresh mask
    every step of every replay; NAdam and RAdam (whose updates read the
    step count) in replayed windows at 2 layers, bit-equal to single
    steps.
19a. ckpt_resume — checkpointed, fault-tolerant training fed by the
    input pipeline: GPT-3 125M bf16 at full width and 4 of its 12
    layers (cut for the time limit), dropout
    0.1, ``recompute="selective"``, batch 16 x 1024, the loop of
    train_loop in windows of 4 (``_loop(k=4)``), 24 steps from a
    ``Dataset`` of seeded numpy token rows through ``DataLoader(
    batch_size=16, num_workers=2)`` (numpy batches, so the
    ``StackingPrefetcher``'s pinned host-to-device copies are on the
    path), driven by ``FaultTolerantTrainer`` with an async
    ``CheckpointManager(keep_last=2)`` saving every 8 steps.  Run A is
    uninterrupted; run B takes a transient write error at the step-8
    save (retried), a preemption after step 8 and a loader fault at step
    13 (2 recoveries); run C crashes in its third save (the
    ``SimulatedCrash`` escapes ``run()``, its ``.tmp-`` directory stays
    and is ignored) and is finished by a fresh model (other weights),
    optimizer, step, manager and trainer over the same directory (no
    ``.tmp-`` left after its first save).  B's and C's 24 losses and
    final parameters, masters, accumulators, step count, lr tensors and
    generator states must be bit-equal to A's; each run's goodput ledger
    must account for 99 % of its wall clock; K1–K3 launches must equal
    the steps run (replays included) x 4 x their per-layer count; then
    a byte flipped in A's newest save makes a restore fall back to the
    older save.  Disk space for four checkpoints is checked first.
    Prints the checkpoint's bytes, snapshot, write and restore ms
    (p50/p99), each run's goodput buckets and its ``io.*`` counters.
19b. ckpt_overhead — ``bench.py``'s ckpt leg (``:2044``): GPT-3 125M
    bf16, 16 x 1024, ``AdamW(1e-4)``, 16 steps in windows of 4, bare and
    then with an async save every 2 windows: tokens/s of each,
    ``ckpt_overhead_frac``, save ms; one ``jit.syncs`` a save and no
    CUDA-graph recapture; then one save's parts timed apart (snapshot,
    crc32, ``np.savez``, fsync).
20. scaler_skip — 125M width at 4 layers with a ``GradScaler`` inside
    fused windows, loss weights that overflow the scaled gradients at
    steps 6 and 12: the skipped steps leave parameters and optimizer
    state bit-equal, the scale halves, K=4 equals K=1 bit for bit; then
    ``FLAGS_check_nan_inf`` names step 2 of a 4-step window.
20a. mesh_train — ``bench.py``'s mesh leg (``:1697``) at one rank over
    NCCL: GPT-3 125M bf16 (``selective``, 16 x 1024) through the loop
    with ``fused_steps=4``, without a mesh and built and stepped under
    ``build_mesh({"dp": 1, "mp": 1})``: a priming, a captured and a
    replayed window; losses, parameters and optimizer state bit-equal,
    one dispatch and one capture, the collectives issued inside the
    captured window, K1–K3 == 4 steps' worth a window.
20b. mesh_train_2rank — GPT-3 125M at 6 of its 12 layers (cut for the
    time limit) at dp2 and then mp2 (6 heads of 64 a
    rank) in two processes over gloo, ``fused_steps=1``, 3 steps each
    on the global batch: losses and fp32 master updates against this
    process's one-process steps beside a control, K1–K3 launches ==
    steps x 6 x their per-layer count on each rank, and K1–K3 at 16 x
    1024, 6 x 64 against their plain versions and timed.  In the same
    ranks, auto_parallel_mp2: the model built without a mesh, placed by
    ``shard_layer`` with Shard/Replicate placements on
    ``ProcessMesh([0, 1], ["mp"])`` as fleet's tensor-parallel layers
    split it, trained 3 steps by ``to_static(loss=, optimizer=)``
    (losses and fp32 updates against the fleet-built mp2 run's, K1–K3
    counted), and ``reshard``'s four moves on a 768 x 3072 bf16 weight
    (bit-equal).  The placements split the optimizer state and fp32
    masters only (ZeRO-style): each rank keeps the whole parameters and
    runs all 12 heads on the same batch, so this is not tensor
    parallelism (ROADMAP.md A7h-mp).
20c. moe_serve — GPT-3 760M widths with 8 experts a layer (top-2,
    capacity factor 1.25), bf16, servemp's 8 requests through the paged
    engine (K4), int8 KV + weights (K4q; the expert stacks stay bf16)
    and the slot layout: K4/K4q launches == decode steps x 24, layer 0's
    indexed MoE FFN against the dense ``[T, E, C]`` route at T 128 and 8
    (dispatch bit-equal in fp32, bf16 within 2 ulps, with drops), a
    2-layer model's decode step through K4 and its plain version by
    ``_self_calibrated``, the 24-layer model's in fp32 within the floor;
    decode drop share printed.
20d. moe_train — GPT-3 125M widths with 8 experts, bf16, 8 x 1024,
    8 single steps against a priming and a captured window of 4 (bit
    for bit), K1–K3 launches counted, first-step loss and aux through
    the kernels and their plain versions in bf16 and fp32.
20e. moe_ep_2rank — moe_train's model at dp2 in two gloo processes (4
    experts a rank, the token all-to-all) against one process on the
    global batch beside two controls that must each fail a gate, and
    moe_serve's model at mp2 (experts' hidden units split; its 24-layer
    fp32 decode-step logits within the floor of the unsharded model's);
    then K1–K3 at moe_train's shape against their plain versions and
    timed.
20f. cp_train_2rank — long-context training over ``sep`` in two gloo
    processes: (a) the ring alone (B 1, S 8192 in chunks of 4096, 12
    heads of 64, causal and not) against ``flash_attention_with_lse``
    over the whole sequence in one process, in bf16 and fp32
    (``_self_calibrated`` on O, dQ, dK, dV), and the kernel ring against
    the plain ring at S 2048; (b) GPT-3 125M at full width and 6 of its
    12 layers (cut for the time limit), ``max_seq_len`` 8192, ``context_parallel`` + ``sequence_parallel``,
    bf16, ``selective``, B 2 x 8192 at sep 2 through the loop, 3 steps,
    against one process over the whole sequence (losses, fp32 master
    updates) beside a control whose ring does not rotate, which must miss
    both limits; each rank's peak memory below the one process's; one
    step of the ``sequence_parallel``-only route (the qkv all-gather);
    (c) K1–K3 launches a rank == (rank + 1) x 6 x 3 x their per-layer
    count, collectives and ring shifts issued, no plain fallback; (e) the
    sequence-parallel linears at mp 2 in fp32 against the dense chain;
    then (d) K1–K3 at the chunk pair's shape (B 2, 12 x 64, 4096 x
    4096), the diagonal causal and the older pair full, K2/K3 with a
    nonzero LSE cotangent, against their plain versions and timed
    beside SDPA.
20g. elastic_2rank — GPT-3 125M at 6 of its 12 layers (cut for the time
    limit), B 4 x 1024, over mp2 in worlds that
    ``python -m paddle_tpu_torch.distributed.launch`` starts (two gloo
    ranks on card 0, each running this script with ``--elastic-worker``,
    ``FaultTolerantTrainer`` + ``CheckpointManager``): an uninterrupted
    run, agent run A (rank 1 dies after the step-2 checkpoint; the world
    is relaunched and resumes) and agent run B with ``--min_nproc 1``
    (rank 1 dies again at its next start; the world shrinks to one
    process, which restores the mp2 save resharded), started together:
    A's losses bit-equal to the uninterrupted run's, B's shrunk losses
    within ``ELASTIC_SHRINK_ATOL`` while a control that drops the
    optimizer's moments must miss it, the agents' events, each
    incarnation's K1–K3 == its steps x 6 x their per-layer count.
21. bert_train — BERT-large pretraining on the paddle-style surface
    (``paddle.seed(0)``, ``BertForPretraining`` at full width and depth,
    hidden dropout 0.1, recompute, ``amp.decorate`` O2 bf16,
    ``AdamW(1e-4, weight_decay=0.01)`` with fp32 masters and
    ``ClipGradByGlobalNorm(1.0)``), batch 16 x 512 with MLM labels on
    15 % of the positions and NSP labels, through ``auto_cast``,
    ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``: 2 warm-up
    and 8 timed steps on one repeated batch.  K1/K2/K3 launches == 48/24
    /24 a step (recompute replays K1), losses finite and falling; one
    more step under ``torch.profiler`` whose trace must show the same
    48/24/24 as the counters set to 0 before it.
22. bert_in_model — BERT-large's width at 2 layers: the loss and every
    gradient of one step through K1–K3 against the same step on their
    plain versions, at O2 bf16 and at fp32 (``_self_calibrated``), then
    at O2 fp16 with a ``GradScaler`` (the fp16 instances), and that fp16
    step taken.
22a. flash_hd_in_model — a 2-layer ``nn.TransformerEncoder(4096, 16,
    16384)`` (16 heads of 256) forward and backward at B 4 x S 1024,
    under ``auto_cast`` O2 bf16 and at fp32, through K1–K3 and their
    plain versions (``_self_calibrated``, rows by RMS: see
    ``flash_hd_gates.py``), 2/2/2 launches by the counters and the trace
    (the D 256 wgmma kernels of ``flash_attention_d256.cu``).
22b. sparse_embedding — ``nn.Embedding(1_000_000, 256, sparse=True)``,
    4096 x 26 Zipf ids a step, ``Adam(lazy_mode=True)`` + the global-norm
    clip, 10 steps: untouched rows bit-equal, touched rows against a
    plain row-wise update, ``lazy_mode=False`` against ``sparse=False``.
22b'. ps_sparse — sparse_embedding's data with the table on two
    parameter-server processes (started through ``TRAINING_ROLE=PSERVER``
    and ``fleet``'s role maker), this process the worker:
    ``ps.SparseEmbedding`` pulls each batch's rows onto the card, SGD on
    the servers, 10 steps, against a dense twin on the card (losses and
    rows), a save/clobber/load round trip; pull and push ms printed.
22c. lbfgs — least squares at 8192 x 1024 fp32, 20 ``step(closure)``
    calls, x against the CPU run's, the loss falls.
23. times (K1–K3) — µs per launch at the training shape and at
    BERT-large's beside the plain versions, the bounds and
    ``scaled_dot_product_attention``'s flash forward and backward
    (yardsticks the port never calls), and at GPT-3 125M's shape (the
    ckpt phases' path); then at D 256 (B 2, H 16, S
    1024, causal, bf16: K1–K3 in ``flash_attention_d256.cu``), with the
    ``mma.sync`` instances they replaced timed in the same turns; each
    must beat the one it replaced, as fp16 K1–K3 must beat the route on
    the wrapper's rounded copies.

The ``total`` line gives the whole run's seconds; the line before the
last is the ``kernels`` JSON (K4's and K4q-int8's launches summed over
the engine, LoRA, host-tier, migration and fleet runs; each K1–K3 row's
``gpt125m`` entry holds the ckpt phases' launches and the times at their
shape; K4's and K4q-int8's rows hold the servemp shapes (16 and 8 heads
of 96) and moe_serve's, each K1–K3 row the 125M mp2 slice and
moe_train's shape, each with its launches, error, times and bound, and
cp_train_2rank's chunk pairs); every phase is followed by a line
``{"phase": ..., "seconds": ...}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from importlib import import_module

if __name__ == "__main__":
    # Where the installed torch ships no bytecode and the environment
    # forbids writing it, every process of this script (each rank that
    # _spawn_ranks starts, and each rank's first recompute step, which
    # imports torch._dynamo) compiles torch's modules from source again:
    # over 10 s a process.  Cache the bytecode once under the checkout's
    # build/ (which .gitignore lists); the ranks inherit the setting.
    _PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = _PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False
    # elastic_2rank's run B: rank 1 of incarnation 1 is a process that
    # fails at its start, before any import (as one whose card is lost)
    if sys.argv[1:2] == ["--elastic-worker"] and sys.argv[3] == "B" \
            and os.environ.get("PADDLE_RESTART_COUNT") == "1" \
            and os.environ.get("PADDLE_TRAINER_ID") == "1":
        os._exit(19)

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as paddle
from paddle_tpu_torch import (AdamW, CompiledTrainStep, GPTConfig,
                              GPTForCausalLM, GPTPretrainingCriterion,
                              LLMEngine, flags)
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.io import Window
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertPretrainingCriterion)
from paddle_tpu_torch.models.gpt import _mm
from paddle_tpu_torch.profiler import counters
from paddle_tpu_torch.quantization import PTQ_WEIGHTS, ptq_int8_decode_state
from paddle_tpu_torch.profiler import trace as rtrace
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import (RetryAfter, Router, ServingFleet,
                                      SpeculativeLLMEngine, bucket_length,
                                      random_lora_factors)
from paddle_tpu_torch.serving.adapters import ADAPTER_TARGETS
from paddle_tpu_torch.serving.kvcache import blocks_for_tokens

#: the attention functionals' module (its name is also a function of
#: ``paddle_tpu_torch.nn.functional``)
nnfa = import_module("paddle_tpu_torch.nn.functional.flash_attention")

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor)
#: FLOP/s (the type the paged decode kernel computes in) and dense bf16
#: tensor-core FLOP/s (the flash kernels' products).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FLASH_KERNELS = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
#: each flash wrapper's kernel name in ``fa._library``/``fa._dtype_code``
FLASH_KIND = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
              "flash_bwd_dkv": "dkv"}
#: kernel vs plain version: both compute in fp32 from the same inputs and
#: differ only in the order of their fp32 sums (<= 8192 keys, <= 256
#: dims, unit-scale values)
KERNEL_ATOL = 1e-4


#: the card's name and power limit (``nvidia-smi``), beside every number
CARD = None


def emit(record):
    print(json.dumps(record), flush=True)


def device_phase():
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = CARD = smi.stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, card


def _ptxas(log):
    """Registers, spills, static shared memory and ptxas's wgmma
    serialization notes (C7512) per kernel variant, from ``nvcc
    -Xptxas=-v``."""
    out, name, serialized = {}, None, set()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        c = re.search(r"C7512.*for the function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif c:
            serialized.add(c.group(1))
        elif name and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            out[name].update({f"spill_{k}": int(n) for n, k in nums})
        elif name and re.search(r"Used \d+ registers", line):
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    for name in serialized & out.keys():
        out[name]["wgmma_serialized"] = True
    return out


#: the wgmma kernels that must not spill, as ptxas names them (mangled),
#: by source: K1–K3 at D 256, and K1–K3 at D 64/96/128 (K1's and K3's
#: producer warpgroup, 40 registers a thread, also rounds fp16 tiles; K2
#: has a bf16 instance at 24/240 and an fp16 one at 40/232, its template
#: flag ``Lb0``/``Lb1``)
NO_SPILL_KERNELS = {
    "flash_attention_d256": {("flash_fwd_d256_kernel",),
                             ("flash_bwd_dq_d256_kernel",),
                             ("flash_bwd_dkv_d256_kernel",)},
    "flash_attention": {(k, f"ILi{d}E") for d in (64, 96, 128)
                        for k in ("flash_fwd_wgmma_kernel",
                                  "flash_bwd_dkv_wgmma_kernel")}
                       | {("flash_bwd_dq_wgmma_kernel", f"ILi{d}ELb{f}E")
                          for d in (64, 96, 128) for f in (0, 1)},
}


def _spills(ptxas, kernels):
    """The ptxas records of ``kernels`` (name parts, each matching one
    mangled name) that spill, or a message if one is missing."""
    found = {parts: [v for k, v in ptxas.items()
                     if all(x in k for x in parts)] for parts in kernels}
    missing = [parts for parts, v in found.items() if len(v) != 1]
    if missing:
        return f"not found once: {missing}"
    return {"".join(parts): v[0] for parts, v in found.items()
            if v[0].get("spill_stores", 0) or v[0].get("spill_loads", 0)}


def build_phase():
    """One nvcc per source, all started together; the wgmma kernels of
    ``NO_SPILL_KERNELS`` must not spill."""
    t0 = time.perf_counter()
    names = ("paged_attention", "flash_attention", "flash_attention_d256",
             "flash_attention_mma", "rms_norm")
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.build, names))
    for name in names:
        _build.load(name)
    dtypes = {"bf16": torch.bfloat16, "fp16": torch.float16,
              "fp32": torch.float32}
    # by the library and dtype code the wrapper routes each kernel to
    smem = {f"{kind}_{dt}_{d}": fa._lib(d, torch_dt, kernel)
            .flash_attention_smem_bytes(i, d,
                                        fa._dtype_code(kernel, d, torch_dt))
            for i, (kind, kernel) in enumerate((("K1", "fwd"), ("K2", "dq"),
                                                ("K3", "dkv")))
            for dt, torch_dt in dtypes.items()
            for d in (*fa.KERNEL_HEAD_DIMS, *FLASH_HD_DIMS)}
    ptxas = {n: _ptxas(_build.BUILD_LOGS.get(n, "")) or "(cached)"
             for n in names}
    for name, kernels in NO_SPILL_KERNELS.items():
        if ptxas[name] != "(cached)":
            bad = _spills(ptxas[name], kernels)
            if bad:
                raise AssertionError(f"build: {name}'s wgmma kernels spill "
                                     f"or are missing: {bad}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, "flash_dynamic_smem_bytes": smem})


def _paged_case(gen, B, nh, hd, bs, max_blocks, q_dtype, kv_dtype,
                trash_row, pos=None):
    """q, pools, tables and positions on the card; a ``kv_dtype`` of
    "int8" or "fp8" quantizes unit-normal pools with the port's
    ``quantize_kv`` and appends the two scale pools.  ``pos``, a list of
    B positions, replaces the drawn ones."""
    dev = "cuda"
    n_blocks = B * max_blocks + 1
    quant = kv_dtype in pa.KV_DTYPES
    q = torch.randn(B, nh, hd, generator=gen, device=dev).to(q_dtype)
    pk, pv = (torch.randn(n_blocks, bs, nh, hd, generator=gen, device=dev)
              .to(torch.float32 if quant else kv_dtype) for _ in range(2))
    bt = (torch.randperm(n_blocks - 1, generator=gen, device=dev)[
        :B * max_blocks] + 1).reshape(B, max_blocks).to(torch.int32)
    given = pos
    last = max_blocks * bs - 1
    choices = torch.tensor([0, bs - 1, bs, last], device=dev)
    pos = torch.randint(0, last + 1, (B,), generator=gen, device=dev)
    pos[:min(B, 4)] = choices[:min(B, 4)]
    pos = pos.to(torch.int32)
    if given is not None:
        pos = torch.tensor(given, dtype=torch.int32, device=dev)
    if trash_row and B > 1:
        bt[-1] = 0
        pos[-1] = 0
    if not quant:
        return q, pk, pv, bt, pos
    (pk, sk), (pv, sv) = (pa.quantize_kv(t, kv_dtype) for t in (pk, pv))
    return q, pk, pv, bt, pos, sk, sv


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(B=B, nh=3, hd=hd, bs=bs, max_blocks=6, q_dtype=dt,
                  kv_dtype=dt, trash_row=True)
             for hd in (8, 64, 96, 128) for bs in (4, 16)
             for dt in (fp32, bf16) for B in (1, 7, 16)]
    # head dims off the grid: scalar loads (33), 8 dims a lane (200, 256)
    cases += [dict(B=7, nh=2, hd=hd, bs=16, max_blocks=5, q_dtype=dt,
                   kv_dtype=dt, trash_row=True)
              for hd in (33, 200, 256) for dt in (fp32, bf16)]
    cases += [dict(B=4, nh=2, hd=128, bs=16, max_blocks=5, q_dtype=qd,
                   kv_dtype=kd, trash_row=True)
              for qd in (fp32, bf16) for kd in (fp32, bf16) if qd != kd]
    # the engine's shape: 8 rows, GPT-3 1.3B heads, 1024 tokens in 16s
    cases.append(dict(B=8, nh=16, hd=128, bs=16, max_blocks=64,
                      q_dtype=bf16, kv_dtype=bf16, trash_row=True))
    # K4q: int8 and fp8 pools with per-token scales, the same grid less
    # hd 8, one head dim off it, and the engine's shape
    quant = ("int8", "fp8")
    cases += [dict(B=B, nh=3, hd=hd, bs=bs, max_blocks=6, q_dtype=dt,
                   kv_dtype=kv, trash_row=True)
              for kv in quant for hd in (64, 96, 128) for bs in (4, 16)
              for dt in (fp32, bf16) for B in (1, 7, 16)]
    cases += [dict(B=7, nh=2, hd=33, bs=16, max_blocks=5, q_dtype=dt,
                   kv_dtype=kv, trash_row=True)
              for kv in quant for dt in (fp32, bf16)]
    cases += [dict(B=8, nh=16, hd=128, bs=16, max_blocks=64, q_dtype=bf16,
                   kv_dtype=kv, trash_row=True) for kv in quant]
    # fp16 (B-ii): fp16 q over fp16 pools (K4) and over int8/fp8 pools
    # (K4q), a grid, a head dim off it, and the engine's shape
    fp16 = torch.float16
    cases += [dict(B=B, nh=3, hd=hd, bs=bs, max_blocks=6, q_dtype=fp16,
                   kv_dtype=kv, trash_row=True)
              for kv in (fp16, *quant) for hd in (33, 64, 128)
              for bs in (4, 16) for B in (1, 7)]
    cases += [dict(B=8, nh=16, hd=128, bs=16, max_blocks=64, q_dtype=fp16,
                   kv_dtype=kv, trash_row=True) for kv in (fp16, *quant)]
    # the split design (pa.SPLIT_KEYS = 64 keys a split at bs 4 and 16):
    # pos on and beside split boundaries, rows whose later splits are all
    # masked, one row at 64 blocks, and one long table (512 blocks of 16,
    # 8192 keys, 128 splits) to stress the merge
    k = pa.SPLIT_KEYS
    for kv in (bf16, fp32, *quant):
        qd = fp32 if kv == fp32 else bf16
        split = dict(q_dtype=qd, kv_dtype=kv, trash_row=True)
        for bs in (4, 16):
            cases.append(dict(B=8, nh=4, hd=128, bs=bs, max_blocks=1024 // bs,
                              pos=[k - 1, k, k + 1, 2 * k - 1, 2 * k,
                                   2 * k + 1, 1023, 0], **split))
        cases.append(dict(B=5, nh=4, hd=96, bs=16, max_blocks=64,
                          pos=[0, 1, 17, 40, 0], **split))
        cases += [dict(B=1, nh=16, hd=128, bs=16, max_blocks=64, pos=[p],
                       **split) for p in (1023, 500)]
        cases.append(dict(B=3, nh=16, hd=128, bs=16, max_blocks=512,
                          pos=[8191, 4000, 0], **split))
        cases.append(dict(B=3, nh=2, hd=33, bs=16, max_blocks=64,
                          pos=[1023, 64, 0], **split))
    # the same atol for K4q: both sides widen identical bytes exactly and
    # sum in fp32, the kernel scaling logits and probabilities where the
    # plain version scales the widened values
    worst = dict.fromkeys(("paged_decode_attention", "float16", *quant,
                           *(f"{kv}_fp16q" for kv in quant)), 0.0)
    counts = dict.fromkeys(worst, 0)
    for case in cases:
        q, pk, pv, bt, pos, *scales = _paged_case(gen, **case)
        out = pa.paged_decode_attention(q, pk, pv, bt, pos, *scales,
                                        scale=0.3)
        ref = pa.paged_decode_attention_reference(q, pk, pv, bt, pos,
                                                  *scales, scale=0.3)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or out.shape != ref.shape:
            raise AssertionError(f"paged_decode_attention: {out.dtype} "
                                 f"{tuple(out.shape)} for {case}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged_decode_attention: non-finite "
                                 f"output for {case}")
        err = float((out - ref).abs().max())
        fp16q = case["q_dtype"] == torch.float16
        key = (f"{case['kv_dtype']}{'_fp16q' if fp16q else ''}" if scales
               else "float16" if fp16q else "paged_decode_attention")
        worst[key] = max(worst[key], err)
        counts[key] += 1
        if err > KERNEL_ATOL:
            raise AssertionError(f"paged_decode_attention: max abs err "
                                 f"{err} > {KERNEL_ATOL} for {case}")
        again = pa.paged_decode_attention(q, pk, pv, bt, pos, *scales,
                                          scale=0.3)
        if not torch.equal(again, out):
            raise AssertionError(f"paged_decode_attention: two runs differ "
                                 f"for {case} (the merge is fixed-order)")
    emit({"phase": "kernel_vs_plain", "kernel": "paged_decode_attention",
          "cases": counts, "max_abs_err": worst, "atol": KERNEL_ATOL})
    return worst


def small_reference_phase():
    """A small fp32 model's paged prefill + decode on the card (through
    the kernels) against the same weights on the CPU (plain versions),
    over fp32 pools and over int8 and fp8 pools."""
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=128, initializer_range=0.1)
    models = {d: GPTForCausalLM(cfg, device=d,
                                generator=torch.Generator().manual_seed(1))
              for d in ("cuda", "cpu")}
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 45)
    bs, max_blocks, n_blocks = 16, 8, 12
    table = np.array([3, 9, 1, 5, 0, 0, 0, 0], np.int32)
    bt = np.zeros((3, max_blocks), np.int32)
    bt[0] = table
    bt[1, :2] = [2, 4]
    tok = np.array([prompt[-1], 7, 0], np.int32)
    pos = np.array([45, 20, 0], np.int32)     # row 2 idle on the trash block
    shape = (cfg.num_layers, n_blocks, bs, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    for kv in (None, *pa.KV_DTYPES):
        out = {}
        for d, m in models.items():
            w = m.decode_state()
            dt = pa.KV_DTYPES.get(kv, torch.float32)
            pools = [torch.zeros(shape, dtype=dt, device=d) for _ in "kv"]
            if kv:
                pools += [torch.zeros(shape[:3], device=d) for _ in "kv"]
            logits = []
            for start, length in ((0, 32), (32, 13)):
                ids = np.zeros((1, 32), np.int64)
                ids[0, :length] = prompt[start:start + length]
                logits.append(m.prefill_paged(
                    w, torch.from_numpy(ids).to(d), start, length,
                    torch.from_numpy(table).to(d), *pools))
            logits.append(m.decode_paged(
                w, *(torch.from_numpy(a).to(d) for a in (tok, pos, bt)),
                *pools))
            out[d] = [t.cpu() for t in logits] + [
                t.cpu() for t in pools[:2]]
            if kv:   # compare K/V as the values the pools stand for
                out[d][3:] = [pa.dequantize_kv(t.cpu(), s.cpu())
                              for t, s in zip(pools[:2], pools[2:])]
        _small_reference_check(kv, out)


def _small_reference_check(kv, out):
    torch.cuda.synchronize()
    card, cpu = out["cuda"], out["cpu"]
    if not all(bool(torch.isfinite(t).all()) for t in card):
        raise AssertionError(f"small_reference {kv}: non-finite values on "
                             "the card")
    scale = max(float(t.abs().max()) for t in cpu[:3])
    logit_err = max(float((a - b).abs().max())
                    for a, b in zip(card[:3], cpu[:3]))
    pool_err = max(float((a - b).abs().max())
                   for a, b in zip(card[3:], cpu[3:]))
    if kv is None:
        # fp32 on both sides; sums reordered
        tol = pool_tol = 1e-4 * max(1.0, scale)
        rel = None
    else:
        # Both sides quantize the same K/V up to fp32 rounding, so a value
        # on a rounding boundary lands one quantum apart: one step of the
        # token's scale (amax/qmax) in int8, one e4m3 step (2**-3 of the
        # value) in fp8.  The pools are held to one step of the largest
        # value; the logits to one step relative to their own scale.
        rel = 1.0 / pa.KV_QMAX["int8"] if kv == "int8" else 2.0 ** -3
        pool_tol = rel * max(float(t.abs().max()) for t in cpu[3:]) * 1.001
        tol = rel * max(1.0, scale)
    emit({"phase": "small_reference", "kv_dtype": kv,
          "max_abs_err": logit_err, "atol": tol, "logit_scale": scale,
          "pool_max_abs_err": pool_err, "pool_atol": pool_tol,
          "tolerance_step": rel})
    if logit_err > tol or pool_err > pool_tol:
        raise AssertionError(f"small_reference {kv}: card vs CPU logits "
                             f"{logit_err} > {tol} or pools {pool_err} > "
                             f"{pool_tol}")


def _engine_prompts(V):
    """The 16 requests of the serving phases: prompts of 64-700 tokens,
    half sharing a 256-token system prompt."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, V, 256)
    prompts = []
    for i in range(16):
        if i % 2 == 0:   # half share a 256-token system prompt
            n = int(rng.integers(256 + 16, 701))
            prompts.append(np.concatenate(
                [system, rng.integers(0, V, n - 256)]))
        else:
            prompts.append(rng.integers(0, V, int(rng.integers(64, 701))))
    return rng, prompts


#: gauges (EMAs), not counters: a delta of them means nothing
SPEC_GAUGES = ("serving.spec.acceptance", "serving.spec.yield")


def _expected_launches(eng, moved):
    """The paged-attention launches a counted run must show, by counter
    name; every other count must be 0.  The paged engine launches the
    variant its pools select once a layer a decode step; the speculative
    engine once a draft layer a draft step (the target's verify pass is
    dense attention); the slot engine never (dense attention)."""
    if eng.kv_layout == "slots":
        return {}
    kv = eng.kv_dtype
    name = ("paged_decode_attention" if kv is None
            else f"paged_decode_attention_{kv}")
    if isinstance(eng, SpeculativeLLMEngine):
        return {name: moved.get("serving.spec.draft_steps", 0)
                * eng.draft_model.config.num_layers}
    return {name: moved.get("serving.decode_steps", 0)
            * eng.config.num_layers}


def _serve_counted(eng, prompts, max_new, phase, adapters=None):
    """The counted main-path run: every paged-attention launch count set to
    0 just before, read just after.  ``adapters`` names each request's
    LoRA tenant (None: all base).  Returns the phase record, the handles
    and (paged layout) a snapshot of the fullest decode batch (tables,
    adapter slots and clones of the pools) for the in-model
    comparison."""
    L = eng.config.num_layers
    paged = eng.kv_layout == "paged"
    pa.reset_launch_counts()
    before = counters.snapshot()
    t_run = time.perf_counter()
    handles = [eng.add_request(p, max_new_tokens=max_new,
                               **({} if adapters is None
                                  else {"adapter": adapters[i]}))
               for i, p in enumerate(prompts)]
    first = {}
    decode_only = []          # (seconds, tokens) of steps with no prefill
    snap, best = None, 0
    while not all(h.is_finished for h in handles):
        prefills0 = (counters.get("serving.kv.prefill_chunks"),
                     counters.get("serving.prefill_batches"))
        toks0 = counters.get("serving.decode_tokens")
        t0 = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - t0
        now = time.monotonic_ns()
        if (counters.get("serving.kv.prefill_chunks"),
                counters.get("serving.prefill_batches")) == prefills0:
            decode_only.append((dt, counters.get("serving.decode_tokens")
                                - toks0))
        for ev in events:
            if ev["type"] == "token" and ev["index"] == 0:
                first[ev["request"].rid] = now - ev["request"].arrival_ns
        running = int(eng._running.sum()) if paged else 0
        if running > best:
            # the fullest decode batch so far, for the in-model comparison
            best = running
            snap = dict(
                bt=np.where(eng._running[:, None], eng._bt, 0),
                pos=np.where(eng._running, eng._pos, 0),
                tok=eng._tok.copy(), rows=running,
                aid=np.where(eng._running, eng._aid, 0),
                pools=[t.clone() for t in (eng.pool_k, eng.pool_v,
                                           *eng.scales)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                **{f"paged_decode_attention_{k}": n for k, n in
                   pa.paged_decode_attention.quant_launches.items()}}
    moved = counters.delta(before)

    reasons = {h.finish_reason for h in handles}
    V = eng.config.vocab_size
    for h in handles:
        if h.finish_reason not in ("length", "eos") or not (
                len(h.tokens) == max_new or h.finish_reason == "eos"):
            raise AssertionError(f"{phase}: {h} finished badly: {h.error!r}")
        if not all(0 <= t < V for t in h.tokens):
            raise AssertionError(f"{phase}: token out of range in {h}")
    steps = moved.get("serving.decode_steps", 0)
    want = _expected_launches(eng, moved)
    for name, n in launches.items():
        if n != want.get(name, 0) or (name in want and n <= 0):
            raise AssertionError(
                f"{phase}: {name} launched {n} times, want "
                f"{want.get(name, 0)} (decode_steps {steps}, counters "
                f"{moved})")

    ttft = np.array(sorted(first.values())) / 1e6
    d_s = sum(s for s, _ in decode_only)
    d_tok = sum(n for _, n in decode_only)
    record = {
        "phase": phase, "kv_layout": eng.kv_layout,
        "kv_dtype": eng.kv_dtype, "weight_dtype": eng.weight_dtype,
        "layers": L, "requests": len(handles),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": int(sum(len(h.tokens) for h in handles)),
        "finish_reasons": sorted(reasons), "wall_s": wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "decode_only_steps": len(decode_only),
        "decode_tokens_per_s": d_tok / d_s if d_s else None,
        "decode_step_ms_p50": (float(np.median([s for s, _ in decode_only]))
                               * 1e3 if decode_only else None),
        "output_tokens_per_s": sum(len(h.tokens) for h in handles) / wall,
        "kernel_launches": sum(want.values()), "launches": launches,
        "decode_steps": steps,
        "kv_pool_bytes": (eng.stats()["kv_pool_bytes"] if paged
                          else eng._ck.nbytes + eng._cv.nbytes),
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("serving.kv.prefix", "serving.kv.cow",
                                      "serving.kv.prefill", "serving.decode",
                                      "serving.kv.blocks_evicted",
                                      "serving.kv.quant", "serving.spec",
                                      "serving.prefill", "serving.kv.tier",
                                      "serving.kv.host", "serving.adapter"))
                     and k not in SPEC_GAUGES},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return record, handles, snap


def _in_model(model, w, snap, phase):
    """One decode step on clones of the snapshot's pools, once through the
    kernel and once through its plain version, compared in bf16."""
    dev = "cuda"
    args = [torch.from_numpy(np.ascontiguousarray(snap[k]).astype(
        np.int32)).to(dev) for k in ("tok", "pos", "bt")]
    logits = {}
    for kernel in (True, False):
        pools = [t.clone() for t in snap["pools"]]
        logits[kernel] = model.decode_paged(w, *args, *pools, kernel=kernel)
        del pools
    torch.cuda.synchronize()
    ref = logits[False]
    if not (bool(torch.isfinite(logits[True]).all())
            and bool(torch.isfinite(ref).all())):
        raise AssertionError(f"{phase}: non-finite logits")
    err = float((logits[True] - ref).abs().max())
    scale = float(ref.abs().max())
    # the kernel's and the plain attention outputs agree to fp32 rounding
    # but are cast to bf16 before the projection; a value near a rounding
    # boundary flips by one bf16 ulp (2**-8 relative) and 24 layers carry
    # such flips to the logits: allow 8 bf16 ulps of the logit scale
    tol = 8 * 2.0 ** -8 * max(1.0, scale)
    agree = float((logits[True].argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": phase, "rows_running": snap["rows"], "max_abs_err": err,
          "atol": tol, "logit_scale": scale, "argmax_agreement": agree})
    if err > tol:
        raise AssertionError(f"{phase}: kernel vs plain {err} > {tol}")


def engine_phase():
    cfg = GPTConfig.gpt3_1_3b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = LLMEngine(model, kv_layout="paged", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128)
    rng, prompts = _engine_prompts(cfg.vocab_size)
    # warm-up: cuBLAS handles, kernel load, allocator (not counted)
    eng.generate([rng.integers(0, cfg.vocab_size, 64)], max_new_tokens=2)
    torch.cuda.synchronize()

    record, handles, snap = _serve_counted(eng, prompts, 32, "engine")
    record.update(model="gpt3_1_3b bf16", init_s=init_s)
    if record["counters"].get("serving.kv.prefix_hits", 0) <= 0:
        raise AssertionError(f"engine: no prefix hits ({record})")
    emit(record)
    _in_model(model, eng._w, snap, "in_model")
    profile_phase(eng, rng, "profile")
    tokens = [h.tokens for h in handles]
    return model, prompts, tokens, record, snap


def _agreement(handles, tokens):
    """Share of greedy tokens equal to the bf16 engine's, position by
    position."""
    return float(np.mean([x == y for h, b in zip(handles, tokens)
                          for x, y in zip(h.tokens, b)]))


def engine_quant_phase(model, prompts, tokens, bf16_record):
    """The same 16 requests through int8 KV + int8 weights, then 4 of them
    through fp8 KV alone, on the engine phase's model."""
    eng = LLMEngine(model, kv_layout="paged", kv_dtype="int8",
                    weight_dtype="int8", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128)
    rng = np.random.default_rng(1)
    V = model.config.vocab_size
    eng.generate([rng.integers(0, V, 64)], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    record, handles, snap = _serve_counted(eng, prompts, 32, "engine_quant")
    quant = {k: v for k, v in record["counters"].items()
             if k.startswith("serving.kv.quant")}
    gauges = {k: counters.get(k) for k in ("serving.kv.quant.arena_bytes",
                                           "serving.kv.quant.bytes_saved")}
    if len(quant) != 2 or not all(
            v > 0 for v in (*quant.values(), *gauges.values())):
        raise AssertionError(f"engine_quant: quant counters {quant} "
                             f"gauges {gauges}")
    # printed, not gated: random weights and int8 rounding flip near-ties
    record.update(
        model="gpt3_1_3b bf16, int8 KV + int8 weights", gauges=gauges,
        greedy_requests_equal_to_bf16=sum(
            h.tokens == b for h, b in zip(handles, tokens)),
        greedy_token_agreement_with_bf16=_agreement(handles, tokens),
        bf16_kv_pool_bytes=bf16_record["kv_pool_bytes"],
        bf16_decode_step_ms_p50=bf16_record["decode_step_ms_p50"],
        bf16_ttft_ms_p50=bf16_record["ttft_ms_p50"])
    emit(record)
    _in_model(model, eng._w, snap, "in_model_quant")
    profile_phase(eng, rng, "profile_quant")
    del eng
    _free_cuda()

    eng = LLMEngine(model, kv_layout="paged", kv_dtype="fp8", max_slots=8,
                    max_seq_len=1024, block_size=16, prefill_chunk=128)
    fp8, fp8_handles, _ = _serve_counted(eng, prompts[:4], 32, "engine_fp8")
    fp8["greedy_token_agreement_with_bf16"] = _agreement(fp8_handles,
                                                         tokens)
    emit(fp8)
    del eng
    _free_cuda()
    return record, fp8, snap


def profile_phase(eng, rng, phase):
    """Where a decode step's time goes: ``torch.profiler`` over four
    engine steps that only decode (8 rows), the device's busy share of
    their wall time and the device ops that take it."""
    V = eng.config.vocab_size
    handles = [eng.add_request(rng.integers(0, V, 64), max_new_tokens=12)
               for _ in range(eng.max_slots)]
    for _ in range(2):   # admit + one-chunk prefill, then a first decode
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    while not all(h.is_finished for h in handles):
        eng.step()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side events only: a CPU op's row repeats its kernels' time
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in ops)
    emit({"phase": phase, "steps": 4, "rows": eng.max_slots,
          "wall_us": wall_us, "device_us": busy,
          "device_busy_share": busy / wall_us if busy else None,
          "top_device_ops": [{"name": e.key[:80], "us": dev_us(e),
                              "calls": e.count} for e in ops[:10]
                             if dev_us(e) > 0]})


def _time_ms(fn, n, warmup=3):
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(fn, n, event_ms):
    """Device time per call: CUDA events around ``n`` calls queued behind
    a spin kernel (``torch.cuda._sleep``) long enough for the host to
    enqueue them all, so the card runs them back to back.  Plain events
    around back-to-back calls time the host instead when a wrapper's
    Python costs more than its kernel of a few tens of µs (a one-chip
    machine shares its host's cores).  ``event_ms``, the plain events'
    time per call, bounds the host's time per call and sizes the spin
    (about 2e6 cycles a ms at the H100's clock)."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (2 * n * event_ms + 5)))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _paged_times(q, pools, bt, pos, n_rounds):
    """Device µs per call of K4 (float pools), K4q (int8, fp8), their
    plain versions and, for K4, SDPA over pre-gathered K/V, at one shape;
    launches rotate over the L layers' pools, as decode does, so the K/V
    read does not sit in the 50 MB L2 between launches.  Returns
    ``{kv: record}`` with the bound of each pool type."""
    pk_all, pv_all = pools[None]
    L, n_blocks, bs, nh, hd = pk_all.shape
    B, max_blocks = bt.shape
    S = max_blocks * bs

    def per_layer(fn, kv):
        return lambda i: fn(q, *(t[i % L] for t in pools[kv][:2]), bt, pos,
                            *(t[i % L] for t in pools[kv][2:]), scale=1.0)

    # library yardstick for K4: SDPA over pre-gathered contiguous K/V with
    # a boolean mask.  No PyTorch call attends over int8/fp8 pools with
    # per-token scales, so K4q has none.
    idx = bt.long()
    gk = [pk_all[l][idx].reshape(B, S, nh, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    gv = [pv_all[l][idx].reshape(B, S, nh, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library(i):
        l = i % L
        F.scaled_dot_product_attention(q4, gk[l], gv[l], attn_mask=mask,
                                       scale=1.0)

    fns = {}
    for kv in pools:
        fns[(kv, "kernel")] = (per_layer(pa.paged_decode_attention, kv),
                               n_rounds * 10)
        fns[(kv, "plain")] = (
            per_layer(pa.paged_decode_attention_reference, kv), n_rounds)
    fns[(None, "library")] = (library, n_rounds * 5)
    # in turns within this one call: every function once, then again;
    # then each one's device time
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k, (fn, n) in fns.items():
            runs[k].append(_time_ms(fn, n))
    event_ms = {k: float(np.mean(v)) for k, v in runs.items()}
    ms = {k: _device_ms(fn, max(2, n // 4), event_ms[k])
          for k, (fn, n) in fns.items()}

    keys = int((pos.long() + 1).sum())
    nblk = int((pos.long() // bs + 1).sum())
    bps, n_split = pa.split_count(bs, max_blocks)
    out = {}
    for kv, (pk, *_rest) in pools.items():
        bytes_moved = (q.numel() * q.element_size()      # q
                       + 2 * keys * nh * hd * pk.element_size()  # K and V
                       + (2 * keys * 4 if kv else 0)     # their scales
                       + nblk * 4 + B * 4                # table entries, pos
                       + B * nh * hd * 4)                # fp32 output
        flops = 4 * keys * nh * hd                       # q.k and p.v
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        bound = max(bytes_ms, ops_ms)
        out[kv] = {
            "shape": {"B": B, "nh": nh, "hd": hd, "bs": bs,
                      "max_blocks": max_blocks, "live_keys": keys,
                      "blocks_per_split": bps, "n_split": n_split,
                      "grid_ctas": nh * B * n_split,
                      "dtype": str(pk.dtype)},
            "ms": ms[(kv, "kernel")], "plain_ms": ms[(kv, "plain")],
            "library_ms": ms[(None, "library")] if kv is None else None,
            "event_ms": {k[1]: v for k, v in event_ms.items()
                         if k[0] == kv or k[1] == "library"},
            "runs_ms": {k[1]: v for k, v in runs.items()
                        if k[0] == kv or k[1] == "library"},
            "bytes": bytes_moved, "flops": flops, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return out


def times_phase(snap, max_err, launches):
    """Per-launch times of the whole wrapper call (split kernel and merge)
    at the engine's decode shapes: K4 over the bf16 engine's pools, and
    K4q over the same pools quantized to int8 and to fp8 with the port's
    ``quantize_kv`` (the same rows, tables and live keys).  Then a second
    shape, on a line of its own: one row at pos 1023 over 64 distinct
    blocks of the same pools, the engine when its last request is left."""
    pk_all, pv_all = snap["pools"]
    L, n_blocks, bs, nh, hd = pk_all.shape
    bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
    pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
    B, max_blocks = bt.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = (torch.randn(B, nh, hd, generator=gen, device="cuda")
         / math.sqrt(hd)).to(pk_all.dtype)
    pools = {None: (pk_all, pv_all)}
    for kv in pa.KV_DTYPES:
        (qk, sk), (qv, sv) = (pa.quantize_kv(t, kv) for t in (pk_all,
                                                               pv_all))
        pools[kv] = (qk, qv, sk, sv)
    main = _paged_times(q, pools, bt, pos, 48)
    bt1 = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")[
        :max_blocks] + 1).to(torch.int32)[None]
    pos1 = torch.tensor([max_blocks * bs - 1], dtype=torch.int32,
                        device="cuda")
    one = _paged_times(q[:1].contiguous(), pools, bt1, pos1, 48)

    rows = []
    for kv, rec in main.items():
        name = ("paged_decode_attention" if kv is None
                else f"paged_decode_attention_{kv}")
        library = ("sdpa over pre-gathered K/V" if kv is None else
                   "none: no PyTorch call attends over int8/fp8 pools "
                   "with per-token scales")
        for label, r in (("engine mid-run", rec), ("one row left", one[kv])):
            emit({"phase": "times", "kernel": name, "case": label,
                  "shape": r["shape"],
                  "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
                  "library_us": (None if r["library_ms"] is None
                                 else r["library_ms"] * 1e3),
                  "library": library,
                  "times": "device time per wrapper call, split kernel and "
                           "merge (queued CUDA events)",
                  "event_us": {k: v * 1e3 for k, v in r["event_ms"].items()},
                  "runs_ms": r["runs_ms"], "bytes": r["bytes"],
                  "flops": r["flops"], "bound_us": r["bound_ms"] * 1e3,
                  "bound_by": r["bound_by"],
                  "share_of_bound": r["bound_ms"] / r["ms"],
                  "kernel_gb_per_s": r["bytes"] / (r["ms"] * 1e-3) / 1e9})
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/kernels/csrc/"
                               "paged_attention.cu",
                     "replaces": "paddle_tpu/kernels/paged_attention.py:132",
                     "launches": launches[name],
                     "max_abs_err": max_err[kv or name],
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"],
                     "event_ms": rec["event_ms"]["kernel"]})
    return rows


def int8_epilogue_phase(model):
    """The cost of ``_mm``'s eager int8 epilogue at one decode step (8
    rows, 24 layers x 4 layer matmuls): bf16 weights against int8
    weights widened to bf16 per call.  CUDA events around the step, in
    turns, and the device time of one step under ``torch.profiler``
    (the events also see the host's launch gaps; the profiler's sum
    does not)."""
    c = model.config
    per_layer = {
        name: [{k: t[l] for k, t in lws.items()}
               for l in range(c.num_layers)]
        for name, lws in (("bf16", model.decode_state()["lws"]),
                          ("int8", ptq_int8_decode_state(model)["lws"]))}
    gen = torch.Generator(device="cuda").manual_seed(4)
    xs = {n: torch.randn(8, 1, per_layer["bf16"][0][n].shape[0],
                         generator=gen, device="cuda").to(torch.bfloat16)
          for n in PTQ_WEIGHTS}

    def step(name):
        def run(i):
            with torch.no_grad():
                for lw in per_layer[name]:
                    for n in PTQ_WEIGHTS:
                        _mm(xs[n], lw, n)
        return run

    runs = {name: [] for name in per_layer}
    for _ in range(2):
        for name in per_layer:
            runs[name].append(_time_ms(step(name), 5, warmup=1))
    device_ms = {}
    for name in per_layer:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(name)(0)
            torch.cuda.synchronize()
        device_ms[name] = sum(_dev_us(e) for e in prof.key_averages()
                              if e.device_type
                              == torch.autograd.DeviceType.CUDA) / 1e3
    n_w = sum(per_layer["bf16"][0][n].numel() for n in PTQ_WEIGHTS) \
        * c.num_layers
    emit({"phase": "int8_epilogue", "layers": c.num_layers, "rows": 8,
          "event_ms_per_decode_step": {k: float(np.mean(v))
                                       for k, v in runs.items()},
          "device_ms_per_decode_step": device_ms, "runs_ms": runs,
          "weight_elements": n_w,
          # bytes a step must move: bf16 weights once; int8 weights once
          # plus the bf16 copy written and read again; a fused W8A16
          # product would read the int8 weights once
          "bytes_bf16": 2 * n_w, "bytes_int8_eager": 5 * n_w,
          "bound_ms_bf16": 2 * n_w / HBM_BYTES_PER_S * 1e3,
          "bound_ms_int8_eager": 5 * n_w / HBM_BYTES_PER_S * 1e3,
          "bound_ms_int8_fused": n_w / HBM_BYTES_PER_S * 1e3})


# ---------------------------------------------------------------------------
# the slot layout, generate and speculative decoding
# ---------------------------------------------------------------------------
#: proposals a speculative round drafts
SPEC_K = 4


def _fp32_state(w):
    """fp32 copies of a ``decode_state()`` dict: the serving entry points
    compute in the dtype of the weights and K/V they are given, so one
    model object runs the same step in fp32."""
    return {k: ({n: t.float() for n, t in v.items()} if k == "lws"
                else v.float() if isinstance(v, torch.Tensor) else v)
            for k, v in w.items()}


#: floor of the self-calibrated tolerance, relative to the fp32 logit
#: scale.  Two fp32 paths of the same step differ only by reordered fp32
#: sums (TF32 is off): 1.1e-6 to 1.8e-6 of the scale on an NVIDIA H100
#: 80GB HBM3 at 700 W; a path that attends to a wrong position or block
#: moves logits by far more
SELF_CALIBRATED_FLOOR = 1e-5
#: the per-row gate of ``_self_calibrated(row_stat="rms")``: a path's
#: row RMS distance from the other path's fp32 output against this many
#: times the other path's own row RMS bf16 noise.  In the D 256 encoder
#: of flash_hd_in_model (``flash_hd_gates.py``, three inputs, NVIDIA H100
#: 80GB HBM3, 700 W) correct attention paths sit at 0.76-0.83 of this
#: bound, and the plain path with its bf16 operands cut to 6 mantissa
#: bits (one path's coarser rounding) at 1.15-1.28 on the output and
#: 1.76-2.02 on the input gradient.
ROW_RMS_FACTOR = 1.25


def _self_calibrated(phase, a16, b16, a32, b32,
                     floor_share=SELF_CALIBRATED_FLOOR, row_stat="max",
                     rms_factor=ROW_RMS_FACTOR):
    """Path ``a`` (under test) and path ``b`` (its yardstick) of the same
    step, each in bf16 and on fp32 copies of the same weights and K/V,
    logits ``[rows, V]``.  Gates:

    * fp32 agreement: ``max |a32 - b32| <= floor``
      (``SELF_CALIBRATED_FLOOR`` of the fp32 logit scale);
    * elementwise ``|a16 - b16| <= 2 * max(|a16 - a32|, |b16 - b32|) +
      floor``.  Given the first gate this follows from the triangle
      inequality: it holds whatever either path's bf16 error, so it is no
      margin and catches no bf16 fault;
    * per row, each path's bf16 logits against the other path's fp32
      logits within twice that other path's own bf16 noise: ``max_v |a16
      - b32| <= 2 * max_v |b16 - b32| + floor``, and the same with ``a``
      and ``b`` swapped.  A bf16-only fault in one path (a lost dtype
      order, a coarser rounding of K/V) moves it away from the fp32
      answer while the other path's noise, the bound, stays put.

    Returns the record's numbers (``*_over_bound``: the worst row's
    distance over its bound, under 1 to pass).  ``floor_share``: the
    floor's share of the scale, ``SELF_CALIBRATED_FLOOR`` unless the
    caller measured its own fp32 gap.  ``row_stat="rms"`` measures the
    third gate's rows by their RMS against ``ROW_RMS_FACTOR`` times the
    other path's (the max-based ratios are then only reported): a row's
    max is one element, and where each path's bf16 rounding differs in
    many elements (two online softmaxes, or one and the plain version)
    its ratio swings from input to input for correct paths, while a row's
    RMS over thousands of elements holds still; ``rms_factor`` replaces
    ``ROW_RMS_FACTOR`` where path ``a`` rounds to bf16 more often than
    ``b`` by construction."""
    out, ok = _self_calibrated_record(a16, b16, a32, b32, floor_share,
                                      row_stat, rms_factor)
    if not ok:
        raise AssertionError(f"{phase}: {out}")
    return out


def _self_calibrated_record(a16, b16, a32, b32, floor_share, row_stat,
                            rms_factor=ROW_RMS_FACTOR):
    """:func:`_self_calibrated`'s numbers and whether its gates pass."""
    a16, b16, a32, b32 = (t.float() for t in (a16, b16, a32, b32))
    scale = float(b32.abs().max())
    floor = floor_share * max(1.0, scale)
    noise_a, noise_b = (a16 - a32).abs(), (b16 - b32).abs()
    err = (a16 - b16).abs()

    def cross(x16, y32, y_noise):
        return float(((x16 - y32).abs().amax(-1)
                      / (2 * y_noise.amax(-1) + floor)).max())

    def cross_rms(x16, y32, y_noise):
        rms = lambda t: t.pow(2).mean(-1).sqrt()
        return float((rms(x16 - y32) / (rms_factor * rms(y_noise)
                                        + floor)).max())

    out = {"max_abs_err_bf16": float(err.max()),
           "max_abs_err_fp32": float((a32 - b32).abs().max()),
           "floor": floor, "logit_scale": scale,
           "bf16_noise_max_a": float(noise_a.max()),
           "bf16_noise_max_b": float(noise_b.max()),
           "a16_vs_b32_over_bound": cross(a16, b32, noise_b),
           "b16_vs_a32_over_bound": cross(b16, a32, noise_a),
           "argmax_agreement_bf16": float(
               (a16.argmax(-1) == b16.argmax(-1)).float().mean())}
    gated = ("a16_vs_b32_over_bound", "b16_vs_a32_over_bound")
    if row_stat == "rms":
        out["row_max_reported"] = {k: out.pop(k) for k in gated}
        out.update(row_stat="rms", rms_factor=rms_factor,
                   a16_vs_b32_over_bound=cross_rms(a16, b32, noise_b),
                   b16_vs_a32_over_bound=cross_rms(b16, a32, noise_a))
    ok = (all(bool(torch.isfinite(t).all()) for t in (a16, b16, a32, b32))
          and out["max_abs_err_fp32"] <= floor
          and bool((err <= 2 * torch.maximum(noise_a, noise_b)
                    + floor).all())
          and all(out[k] <= 1.0 for k in gated))
    return out, ok


def engine_slots_phase(model, prompts, tokens, paged_record):
    """The default slot layout, ``LLMEngine(model, max_slots=8,
    max_seq_len=1024)``, over the engine phase's model and its 16 greedy
    requests; no paged-attention launch (dense attention over the
    arena).  Greedy agreement with the paged engine is printed, not
    gated: random weights flip near-ties between two correct bf16
    paths."""
    eng = LLMEngine(model, max_slots=8, max_seq_len=1024)
    rng = np.random.default_rng(2)
    V = model.config.vocab_size
    eng.generate([rng.integers(0, V, 64)], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    record, handles, _ = _serve_counted(eng, prompts, 32, "engine_slots")
    record.update(
        model="gpt3_1_3b bf16", arena_bytes=record.pop("kv_pool_bytes"),
        greedy_requests_equal_to_paged=sum(
            h.tokens == b for h, b in zip(handles, tokens)),
        greedy_token_agreement_with_paged=_agreement(handles, tokens),
        paged_decode_step_ms_p50=paged_record["decode_step_ms_p50"],
        paged_ttft_ms_p50=paged_record["ttft_ms_p50"],
        paged_kv_pool_bytes=paged_record["kv_pool_bytes"])
    emit(record)
    return eng, record


def generate_phase(model, slot_eng):
    """``GPTForCausalLM.generate`` at the 1.3B model: 4 prompts of 128
    tokens, 32 new tokens, greedy; one sampled call (top_p 0.9, seed 11)
    made twice, which must give the same tokens; and eos fill with an
    eos taken from the greedy output.  Greedy agreement with the slot
    engine over the same prompts is printed, not gated."""
    V = model.config.vocab_size
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, V, (4, 128))).cuda()
    model.generate(ids[:, :16], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    wall = {}

    def timed(name, **kw):
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=32, **kw)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    greedy = timed("greedy")
    sampled = [timed(f"sampled_{i}", do_sample=True, top_p=0.9, seed=11)
               for i in range(2)]
    eos = int(greedy[0, 128 + 5])
    with_eos = timed("greedy_eos", eos_token_id=eos)
    for out in (greedy, *sampled, with_eos):
        if out.shape != (4, 160) or not torch.equal(out[:, :128], ids) or \
                not bool(((out >= 0) & (out < V)).all()):
            raise AssertionError(f"generate: output {tuple(out.shape)} "
                                 "malformed")
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("generate: two sampled calls with seed 11 "
                             "differ")
    new, new_eos = greedy[:, 128:].cpu(), with_eos[:, 128:].cpu()
    for r in range(4):
        hit = (new_eos[r] == eos).nonzero()
        cut = int(hit[0]) + 1 if len(hit) else 32
        if not (torch.equal(new_eos[r, :cut], new[r, :cut])
                and bool((new_eos[r, cut:] == eos).all())):
            raise AssertionError(f"generate: row {r} eos fill {new_eos[r]}")
    if int((new_eos[0] == eos).sum()) < 32 - 5:
        raise AssertionError("generate: row 0 does not keep emitting eos")
    handles = [slot_eng.add_request(ids[i].cpu().numpy(), max_new_tokens=32)
               for i in range(4)]
    while not all(h.is_finished for h in handles):
        slot_eng.step()
    emit({"phase": "generate", "model": "gpt3_1_3b bf16", "batch": [4, 128],
          "max_new_tokens": 32, "wall_ms": {k: v * 1e3 for k, v in
                                             wall.items()},
          "ms_per_step": wall["greedy"] * 1e3 / 32,
          "ms_per_token": wall["greedy"] * 1e3 / (4 * 32),
          "sampled_equal_twice": True, "eos": eos,
          "sampled_token_agreement_with_greedy": float(
              (sampled[0] == greedy)[:, 128:].float().mean()),
          "greedy_token_agreement_with_slot_engine": _agreement(
              handles, new.tolist())})


def _spec_engine(model, draft, **kw):
    # the pool covers both namespaces at every slot's worst case
    return LLMEngine(model, draft_model=draft, spec_k=SPEC_K, max_slots=8,
                     max_seq_len=1024, block_size=16, prefill_chunk=128,
                     n_blocks=2 * 8 * 64 + 1, **kw)


def _spec_counted(eng, prompts, phase, paged_record, tokens):
    """A counted speculative run (``_serve_counted``: K4/K4q launches ==
    draft steps x draft layers) with its own gates: drafted = accepted +
    rejected, and no block leaked (free blocks + the prefix tree's blocks
    = the pool's capacity)."""
    record, handles, _ = _serve_counted(eng, prompts, 32, phase)
    c = record["counters"]
    drafted = c.get("serving.spec.drafted", 0)
    accepted = c.get("serving.spec.accepted", 0)
    rejected = c.get("serving.spec.rejected", 0)
    emitted = c.get("serving.decode_tokens", 0)
    free, tree = eng.pool.free_blocks, eng.prefix.nodes
    if drafted <= 0 or drafted != accepted + rejected:
        raise AssertionError(f"{phase}: drafted {drafted} != accepted "
                             f"{accepted} + rejected {rejected}")
    if free + tree != eng.pool.capacity:
        raise AssertionError(f"{phase}: {free} free + {tree} in the prefix "
                             f"tree != capacity {eng.pool.capacity}")
    record.update(
        draft_layers=eng.draft_model.config.num_layers, spec_k=eng.spec_k,
        acceptance=accepted / drafted,
        tokens_per_round_per_row=emitted / max(emitted - accepted, 1),
        rounds=c.get("serving.spec.verify_steps", 0),
        draft_steps=c.get("serving.spec.draft_steps", 0),
        blocks_free_plus_tree=free + tree, blocks_capacity=eng.pool.capacity,
        greedy_token_agreement_with_paged=_agreement(handles, tokens),
        paged_decode_tokens_per_s=paged_record["decode_tokens_per_s"])
    emit(record)
    return record


def _draft_cfg():
    return GPTConfig.gpt3_125m(vocab_size=50304, max_seq_len=1024,
                               dtype="bfloat16")


def engine_spec_phase(model, prompts, tokens, paged_record):
    """Speculative decoding: target = the engine phase's GPT-3 1.3B bf16,
    draft = GPT-3 125M bf16 (12 layers, 12 heads of 64, random weights
    from seed 1), ``spec_k=4``, 8 of the 16 requests, greedy; then 4
    requests self-drafted, and 4 over int8 pools.  Then the in-model
    checks at the fullest speculative round (spec_in_model).  Returns
    that round's draft pools, tables and positions for K4's times at the
    draft's shape."""
    draft = GPTForCausalLM(_draft_cfg(), device="cuda",
                           generator=torch.Generator().manual_seed(1))
    eng = _spec_engine(model, draft)
    rng = np.random.default_rng(4)
    V = model.config.vocab_size
    eng.generate([rng.integers(0, V, 64)], max_new_tokens=8)   # warm-up
    torch.cuda.synchronize()
    _spec_counted(eng, prompts[:8], "engine_spec", paged_record, tokens)
    snap = spec_in_model_phase(eng, rng)
    del eng
    _free_cuda()
    self_eng = _spec_engine(model, model)
    _spec_counted(self_eng, prompts[:4], "engine_spec_self_draft",
                  paged_record, tokens)
    del self_eng
    _free_cuda()
    q_eng = _spec_engine(model, draft, kv_dtype="int8")
    _spec_counted(q_eng, prompts[:4], "engine_spec_int8", paged_record,
                  tokens)
    del q_eng
    _free_cuda()
    return snap


def spec_in_model_phase(eng, rng):
    """At the fullest speculative round (8 fresh requests, all past
    prefill, draft tables grown for the round): the draft's decode step
    through K4 at head dim 64 against its plain version (``_in_model``'s
    tolerance), and the target's ``verify_paged`` logits at column 0
    against ``decode_paged``'s for the same rows and pools
    (``_self_calibrated``: both in bf16 and on fp32 copies)."""
    V = eng.config.vocab_size
    handles = [eng.add_request(rng.integers(0, V, int(n)), max_new_tokens=32)
               for n in rng.integers(64, 701, eng.max_slots)]
    while not all(h.state == "running" for h in handles):
        eng.step()
    K1 = eng.spec_k + 1
    run = eng._running.copy()
    eng._grow_draft_tables(np.where(run, K1, 1).astype(np.int32))
    rows = int(run.sum())
    pos0 = np.where(run, eng._pos, 0).astype(np.int32)
    tok = eng._tok.copy()
    dbt = np.where(run[:, None], eng._dbt, 0)
    bt = np.where(run[:, None], eng._bt, 0)
    dpools = [t.clone() for t in (eng.dpool_k, eng.dpool_v)]
    _in_model(eng.draft_model, eng._dw,
              dict(tok=tok, pos=pos0, bt=dbt, rows=rows, pools=dpools),
              "spec_in_model_draft")

    dev = "cuda"
    toks = np.concatenate([tok[:, None], rng.integers(0, V, (len(tok),
                                                             K1 - 1))], 1)
    nv = np.where(run, K1, 1).astype(np.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)
         for k, a in (("toks", toks), ("tok", tok), ("pos", pos0),
                      ("nv", nv), ("bt", bt))}
    logits = {}
    for name, w, dt in (("bf16", eng._w, None),
                        ("fp32", _fp32_state(eng._w), torch.float32)):
        pools = [p.clone() if dt is None else p.to(dt)
                 for p in (eng.pool_k, eng.pool_v)]
        v = eng.model.verify_paged(w, t["toks"], t["pos"], t["nv"], t["bt"],
                                   *pools)[:, 0]
        pools = [p.clone() if dt is None else p.to(dt)
                 for p in (eng.pool_k, eng.pool_v)]
        d = eng.model.decode_paged(w, t["tok"], t["pos"], t["bt"], *pools)
        logits[name] = (v[run], d[run])
        del pools
    torch.cuda.synchronize()
    rec = _self_calibrated("spec_in_model", *logits["bf16"], *logits["fp32"])
    emit({"phase": "spec_in_model", "rows_running": rows, "spec_k": eng.spec_k,
          "check": "verify_paged column 0 vs decode_paged, bf16 and fp32",
          **rec})
    for h in handles:
        h.cancel()
    while eng.has_work():
        eng.step()
    return dict(pools=dpools, bt=dbt, pos=pos0, rows=rows)


LORA_RANK = 8
LORA_TENANTS = ("t1", "t2", "t3")


def _tenant_of(i):
    """The 16 requests split 4 base and 4 for each tenant, in pairs, so
    each group holds two prompts that share the 256-token prefix and two
    that do not."""
    return (None, *LORA_TENANTS)[(i // 2) % 4]


def _merged_state(w, slabs, slot):
    """``decode_state`` with tenant ``slot``'s LoRA update folded into the
    adapted weights, ``W + A @ B`` in fp32, cast back: the reference the
    gathered ``_mm_lora`` path is held to."""
    lws = dict(w["lws"])
    for t in ADAPTER_TARGETS:
        ab = torch.bmm(slabs["a_" + t][:, slot].float(),
                       slabs["b_" + t][:, slot].float())
        lws[t] = (lws[t].float() + ab).to(lws[t].dtype)
    return dict(w, lws=lws)


def _lora_in_model(eng, snap):
    """One ``decode_paged`` step at the fullest batch of the LoRA run, on
    clones of its pools: base rows with the arena's ids against the same
    step without adapters (bit for bit), and tenant rows through
    ``_mm_lora`` against the merged-weight step of each tenant, in bf16
    and on fp32 copies (``_self_calibrated``)."""
    dev = eng.device
    model, w = eng.model, eng._w
    aid = snap["aid"]
    args = [torch.from_numpy(np.ascontiguousarray(snap[k]).astype(
        np.int32)).to(dev) for k in ("tok", "pos", "bt")]
    ids = torch.from_numpy(aid.astype(np.int64)).to(dev)
    slabs = eng.adapters.slabs()
    base, tenant = aid == 0, aid > 0
    if not (base & (snap["bt"][:, 0] > 0)).any() or not tenant.any():
        raise AssertionError(f"lora_in_model: batch ids {aid} hold no base "
                             "or no tenant row")

    def step(wt, dt, **kw):
        pools = [p.clone() if dt is None else p.to(dt)
                 for p in snap["pools"]]
        out = model.decode_paged(wt, *args, *pools, **kw)
        del pools
        return out

    with_ids = step(w, None, adapters=slabs, adapter_ids=ids)
    without = step(w, None)
    torch.cuda.synchronize()
    rows = torch.from_numpy(base).to(dev)
    if not torch.equal(with_ids[rows], without[rows]):
        raise AssertionError("lora_in_model: base rows differ from the "
                             "adapter-free step")
    w32 = _fp32_state(w)
    s32 = {k: v.float() for k, v in slabs.items()}
    a32 = step(w32, torch.float32, adapters=s32, adapter_ids=ids)
    paths = {"a16": [], "b16": [], "a32": [], "b32": []}
    for s in sorted(set(aid[tenant].tolist())):
        r = torch.from_numpy(aid == s).to(dev)
        paths["a16"].append(with_ids[r])
        paths["a32"].append(a32[r])
        paths["b16"].append(step(_merged_state(w, slabs, s), None)[r])
        paths["b32"].append(step(_merged_state(w32, s32, s),
                                 torch.float32)[r])
    torch.cuda.synchronize()
    rec = _self_calibrated("lora_in_model",
                           *(torch.cat(paths[k]) for k in
                             ("a16", "b16", "a32", "b32")))
    emit({"phase": "lora_in_model", "rows": int(len(aid)),
          "base_rows": int(base.sum()), "tenant_rows": int(tenant.sum()),
          "check": "base rows bit-equal to the adapter-free step; tenant "
                   "rows _mm_lora vs merged weights, bf16 and fp32",
          "base_rows_bit_equal": True, **rec})


def engine_lora_phase(model, prompts, tokens, paged_record):
    """Multi-tenant LoRA serving: ``LLMEngine(model, kv_layout="paged",
    adapter_slots=4, adapter_rank=8)`` with three tenants registered from
    ``random_lora_factors(cfg, 8, seed=t)``, the 16 requests split 4 base
    and 4 a tenant, greedy, 32 new tokens (K4 launches == decode_steps x
    24).  Gates: base rows' tokens equal the adapter-free paged engine's,
    the in-model check (lora_in_model), two tenants with one prompt share
    no block.  Prints the decode step beside the adapter-free engine's
    and the time of a tenant's cold page-in."""
    cfg = model.config
    eng = LLMEngine(model, kv_layout="paged", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128, adapter_slots=4,
                    adapter_rank=LORA_RANK)
    for i, t in enumerate(LORA_TENANTS):
        eng.register_adapter(t, random_lora_factors(cfg, LORA_RANK,
                                                    seed=i + 1))
    rng = np.random.default_rng(6)
    V = cfg.vocab_size
    warm = [eng.add_request(rng.integers(0, V, 64), max_new_tokens=2,
                            adapter=t) for t in (None, *LORA_TENANTS)]
    while not all(h.is_finished for h in warm):
        eng.step()
    torch.cuda.synchronize()
    record, handles, snap = _serve_counted(
        eng, prompts, 32, "engine_lora",
        adapters=[_tenant_of(i) for i in range(len(prompts))])
    base = [i for i in range(len(prompts)) if _tenant_of(i) is None]
    equal = [handles[i].tokens == tokens[i] for i in base]
    tenant_agree = _agreement([handles[i] for i in range(len(prompts))
                               if i not in base],
                              [tokens[i] for i in range(len(prompts))
                               if i not in base])
    if not all(equal):
        raise AssertionError(f"engine_lora: base requests {base} equal to "
                             f"the adapter-free engine: {equal}")
    _lora_in_model(eng, snap)

    # two tenants, one prompt: no block shared, no prefix hit across them
    p = prompts[1]
    h1 = eng.add_request(p, max_new_tokens=4, adapter="t1")
    while h1.state != "running":
        eng.step()
    t1_blocks = set(eng._slot_blocks[h1.slot])
    while not h1.is_finished:
        eng.step()
    hits0 = counters.get("serving.kv.prefix_hits")
    h2 = eng.add_request(p, max_new_tokens=4, adapter="t2")
    while h2.state not in ("running", "finished"):
        eng.step()
    shared = t1_blocks & set(eng._slot_blocks[h2.slot] or ())
    peeks = (eng.prefix_peek(p, tenant="t1"), eng.prefix_peek(p, tenant="t2"))
    while not h2.is_finished:
        eng.step()
    if shared or counters.get("serving.kv.prefix_hits") != hits0 or \
            peeks[0] <= 0:
        raise AssertionError(f"engine_lora: tenants t1/t2 share blocks "
                             f"{sorted(shared)} (peeks {peeks})")

    # a cold page-in: a fourth tenant into the arena's free slot, then a
    # warm acquire of it
    eng.register_adapter("t4", random_lora_factors(cfg, LORA_RANK, seed=4))
    times = {}
    for kind in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eng._cond:
            eng.adapters.acquire("t4")
        torch.cuda.synchronize()
        times[kind] = (time.perf_counter() - t0) * 1e3
    with eng._cond:
        eng.adapters.release("t4")
        eng.adapters.release("t4")
    st = eng.adapters.stats()
    record.update(
        model="gpt3_1_3b bf16", adapter_slots=4, adapter_rank=LORA_RANK,
        tenants=len(LORA_TENANTS), base_requests=len(base),
        base_requests_equal_to_paged=sum(equal),
        tenant_token_agreement_with_base_engine=tenant_agree,
        adapter_free_decode_step_ms_p50=paged_record["decode_step_ms_p50"],
        decode_step_ratio_to_adapter_free=(
            record["decode_step_ms_p50"] / paged_record["decode_step_ms_p50"]
            if record["decode_step_ms_p50"] else None),
        cold_page_in_ms=times["cold"], warm_acquire_ms=times["warm"],
        adapter_arena_bytes=st["arena_bytes"],
        adapter_stats={k: st[k] for k in ("loads", "hits", "misses",
                                          "evictions", "exhausted")},
        tenants_share_no_block=True)
    emit(record)
    del eng
    _free_cuda()
    return record


def _block_copy_times(eng, n):
    """Host µs of ``n`` single-block spills (device to pinned host,
    synchronous) and of their restores (pinned host to device, queued,
    then one wait), each block's bytes, and the device busy share of the
    whole spill-and-restore run (``_profile``)."""
    with eng._cond:
        eng.prefix.clear()
        blocks = eng.pool.alloc_n(n)
    per = {"spill": [], "restore": []}

    def run():
        bufs = []
        for b in blocks:
            t0 = time.perf_counter()
            bufs.append(eng._spill_block(b))
            per["spill"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for b, buf in zip(blocks, bufs):
            eng._restore_block(b, buf)
        eng._restores_done()
        per["restore"].append((time.perf_counter() - t0) / n)
        for buf in bufs:
            eng._host_tier._recycle(buf)

    with eng._cond:
        run()                      # warm: pins the host buffers
        per = {"spill": [], "restore": []}
        run()
        prof = _profile(run, top=4)
        for b in blocks:
            eng.pool.release(b)
    nbytes = sum(t[:, 0].nbytes for t in eng._pools())
    spill_s = float(np.median(per["spill"]))
    restore_s = float(np.mean(per["restore"]))
    return {"blocks": n, "block_bytes": nbytes,
            "spill_us": spill_s * 1e6, "restore_us": restore_s * 1e6,
            "spill_gb_per_s": nbytes / spill_s / 1e9,
            "restore_gb_per_s": nbytes / restore_s / 1e9,
            "device_busy_share": prof["device_busy_share"],
            "top_device_ops": prof["top_device_ops"]}


def host_tier_phase(model, prompts, tokens, bf16_agreement):
    """The host-RAM KV tier: a paged engine whose pool (8 x 46 + 1
    blocks: any 8 of the requests at once) the 16 requests' donated
    prefixes overflow, ``host_kv_blocks=1024``, serving the 16 requests
    twice: pass 1 spills cold prefixes, pass 2 restores them.  In bf16
    (K4) and int8 KV (K4q).  Gates: spilled and restored blocks > 0; one
    block spilled and restored into another is bit-equal (scale rows
    too); the second pass's greedy tokens agree with the adapter-free
    engine's at least as well as two correct bf16 engines do
    (``bf16_agreement``: the slot layout against the paged engine).
    Prints µs and GB/s of a block spill and restore, with the device
    busy share."""
    V = model.config.vocab_size
    need = max(blocks_for_tokens(len(p) + 31, 16) for p in prompts)
    records = {}
    for kv in (None, "int8"):
        eng = LLMEngine(model, kv_layout="paged", kv_dtype=kv, max_slots=8,
                        max_seq_len=1024, block_size=16, prefill_chunk=128,
                        n_blocks=8 * need + 1, host_kv_blocks=1024)
        eng.generate([np.random.default_rng(7).integers(0, V, 64)],
                     max_new_tokens=2)
        torch.cuda.synchronize()
        phase = "host_tier" + ("" if kv is None else f"_{kv}")
        passes = []
        for i in range(2):
            rec, handles, _ = _serve_counted(eng, prompts, 32,
                                             f"{phase}_pass{i + 1}")
            passes.append((rec, handles))
        moved = {k: sum(r["counters"].get(k, 0) for r, _ in passes)
                 for k in ("serving.kv.tier.spilled_blocks",
                           "serving.kv.tier.restored_blocks",
                           "serving.kv.tier.readopted",
                           "serving.kv.tier.spill_drops")}
        if moved["serving.kv.tier.spilled_blocks"] <= 0 or \
                passes[1][0]["counters"].get(
                    "serving.kv.tier.restored_blocks", 0) <= 0:
            raise AssertionError(f"{phase}: tier moved {moved}")
        # one block of the tree spilled and restored into another: bit-equal
        with eng._cond:
            eng.prefix.evict(1)          # room for the destination block
            nodes = list(eng.prefix._root.children.values())
            src = next(n for n in nodes if not n.host).block
            bufs = eng._spill_block(src)
            dst = eng.pool.alloc()
            eng._restore_block(dst, bufs)
            eng._restores_done()
            equal = all(torch.equal(t[:, dst], t[:, src])
                        for t in eng._pools())
            eng._host_tier._recycle(bufs)
            eng.pool.release(dst)
        if not equal:
            raise AssertionError(f"{phase}: restored block differs from the "
                                 "spilled one")
        agree = [_agreement(h, tokens) for _, h in passes]
        if kv is None and agree[1] < bf16_agreement:
            raise AssertionError(
                f"{phase}: pass 2 agrees with the adapter-free engine at "
                f"{agree[1]} < {bf16_agreement} (slot vs paged bf16)")
        times = _block_copy_times(eng, 32)
        st = eng.stats()
        out = {"phase": phase, "model": "gpt3_1_3b bf16", "kv_dtype": kv,
               "n_blocks": eng.n_blocks, "host_kv_blocks": 1024,
               "tier": moved, "block_bit_equal": True,
               "host_arena_bytes": st["host_arena_bytes"],
               "host_buffers_pinned": eng._host_tier.pin_memory,
               "pass_decode_step_ms_p50": [r["decode_step_ms_p50"]
                                           for r, _ in passes],
               "pass_ttft_ms_p50": [r["ttft_ms_p50"] for r, _ in passes],
               "pass_wall_s": [r["wall_s"] for r, _ in passes],
               "greedy_token_agreement_with_paged": agree,
               "bf16_engines_agreement": bf16_agreement,
               "launches": {k: sum(r["launches"][k] for r, _ in passes)
                            for k in passes[0][0]["launches"]},
               "block_copy": times}
        emit(out)
        records[kv] = out
        del eng
        _free_cuda()
    return records


def _migrate_stream(src, dst, prompts, max_new, phase):
    """Serve ``prompts`` through ``src`` with ``hold_after_prefill=True``
    and hand each held request to ``dst`` (``export_request`` →
    ``adopt_migration`` → ``finish_migrated``; a destination without a
    free slot defers the hand-off), checking every copied block against
    the source's, tiles and scale rows; ``dst`` decodes.  Returns the
    destination's handles in prompt order, the migrations' infos and
    their host ms (synchronised)."""
    held = {}
    for i, p in enumerate(prompts):
        held[src.add_request(p, max_new_tokens=max_new,
                             hold_after_prefill=True).rid] = i
    out, infos, ms = [None] * len(prompts), [], []
    waiting = []
    while any(h is None or not h.is_finished for h in out):
        for ev in src.step():
            if ev["type"] == "prefilled":
                waiting.append(ev["request"])
        while waiting and dst._free:
            req = waiting.pop(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mig = src.export_request(req)
            new, info = dst.adopt_migration(mig, src)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            bs = src.pool.block_size
            n_data = blocks_for_tokens(max(info["tokens"], 1), bs)
            lo = info["blocks_shared"]
            si = torch.tensor(mig["table"][lo:n_data], device=dst.device)
            di = torch.tensor(dst._slot_blocks[new.slot][lo:n_data],
                              device=dst.device)
            for sp, dp in zip(src._pools(), dst._pools()):
                if not torch.equal(sp[:, si], dp[:, di]):
                    raise AssertionError(f"{phase}: migrated blocks differ "
                                         f"from the source's ({info})")
            if info["blocks_copied"] != n_data - info["blocks_shared"]:
                raise AssertionError(f"{phase}: {info}")
            src.finish_migrated(req)
            out[held[req.rid]] = new
            infos.append(info)
        dst.step()
    return out, infos, ms


def migration_phase(model, prompts, tokens):
    """Engine-level KV migration between two paged engines over the one
    model: the 16 requests prefill on a source with
    ``hold_after_prefill=True`` and each goes through ``export_request``
    → ``adopt_migration`` → ``finish_migrated`` to a destination that
    decodes it, in bf16 (K4) and int8 KV (K4q).  Gates: copied blocks and
    scale rows bit-equal to the source's; shared prefix blocks adopted by
    refcount (blocks copied = the unshared tail); the destination's
    K4/K4q launches == its decode_steps x 24.  Then one request through a
    ``SpeculativeLLMEngine`` destination (``_adopt_extra``; its tokens
    equal the same request served speculatively unmigrated), and the fp32
    identity at 2 layers (``migration_fp32_phase``).  Prints ms a
    migration."""
    V = model.config.vocab_size
    kw = dict(kv_layout="paged", max_slots=8, max_seq_len=1024,
              block_size=16, prefill_chunk=128)
    records = {}
    for kv in (None, "int8"):
        src = LLMEngine(model, kv_dtype=kv, **kw)
        dst = LLMEngine(model, kv_dtype=kv, **kw)
        for e in (src, dst):
            e.generate([np.random.default_rng(8).integers(0, V, 64)],
                       max_new_tokens=2)
        torch.cuda.synchronize()
        phase = "migration" + ("" if kv is None else f"_{kv}")
        name = ("paged_decode_attention" if kv is None
                else f"paged_decode_attention_{kv}")
        pa.reset_launch_counts()
        before = counters.snapshot()
        t0 = time.perf_counter()
        handles, infos, ms = _migrate_stream(src, dst, prompts, 32, phase)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = counters.delta(before)
        launches = {"paged_decode_attention":
                    pa.paged_decode_attention.launches,
                    **{f"paged_decode_attention_{k}": n for k, n in
                       pa.paged_decode_attention.quant_launches.items()}}
        steps = moved.get("serving.decode_steps", 0)
        for k, n in launches.items():
            want = steps * model.config.num_layers if k == name else 0
            if n != want or (k == name and n <= 0):
                raise AssertionError(f"{phase}: {k} launched {n}, want "
                                     f"{want}")
        shared = sum(i["blocks_shared"] for i in infos)
        if shared <= 0:
            raise AssertionError(f"{phase}: no prefix block adopted by "
                                 f"refcount ({infos})")
        for h in handles:
            if h.finish_reason not in ("length", "eos"):
                raise AssertionError(f"{phase}: {h} finished badly")
        rec = {"phase": phase, "model": "gpt3_1_3b bf16", "kv_dtype": kv,
               "migrations": len(infos), "wall_s": wall,
               "ms_per_migration_p50": float(np.median(ms)),
               "ms_per_migration_max": float(np.max(ms)),
               "blocks_copied": sum(i["blocks_copied"] for i in infos),
               "blocks_shared": shared,
               "bytes_copied": sum(i["blocks_copied"] for i in infos)
               * sum(t[:, 0].nbytes for t in dst._pools()),
               "decode_steps": steps, "launches": launches,
               "kernel_launches": launches[name],
               "blocks_bit_equal": True,
               "greedy_token_agreement_with_paged": (
                   _agreement(handles, tokens) if kv is None else None)}
        emit(rec)
        records[kv] = rec
        del src, dst
        _free_cuda()
    records["spec"] = _migration_spec(model, prompts[0])
    return records


def _migration_spec(model, prompt):
    """One migration into a ``SpeculativeLLMEngine`` (self-drafted):
    ``_adopt_extra`` re-prefills the draft namespace, and the continuation
    equals the same request served unmigrated by a speculative engine."""
    src = LLMEngine(model, kv_layout="paged", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128)
    dst = _spec_engine(model, model)
    ref = _spec_engine(model, model)
    want = ref.generate([prompt], max_new_tokens=32)[0]
    del ref
    _free_cuda()
    req = src.add_request(prompt, max_new_tokens=32,
                          hold_after_prefill=True)
    while req.state != "held":
        src.step()
    pa.reset_launch_counts()
    before = counters.snapshot()
    new, info = dst.adopt_migration(src.export_request(req), src)
    src.finish_migrated(req)
    ready = dst._dslot_blocks[new.slot] is not None
    while not new.is_finished:
        dst.step()
    torch.cuda.synchronize()
    moved = counters.delta(before)
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches}
    draft_steps = moved.get("serving.spec.draft_steps", 0)
    equal = bool(np.array_equal(new.output_ids(), want))
    rec = {"phase": "migration_spec", "model": "gpt3_1_3b bf16",
           "draft": "self", "draft_table_rebuilt": ready,
           "draft_prefill_chunks": moved.get(
               "serving.spec.draft_prefill_chunks", 0),
           "drafted": moved.get("serving.spec.drafted", 0),
           "accepted": moved.get("serving.spec.accepted", 0),
           "draft_steps": draft_steps, "launches": launches,
           "tokens_equal_to_unmigrated": equal, **info}
    emit(rec)
    if not (ready and equal and rec["draft_prefill_chunks"] > 0
            and launches["paged_decode_attention"]
            == draft_steps * model.config.num_layers > 0):
        raise AssertionError(f"migration_spec: {rec}")
    del src, dst
    _free_cuda()
    return rec


def migration_fp32_phase():
    """At the depth of slots_in_model (the 1.3B width, 2 layers), in fp32:
    8 requests migrated from a held source to a destination give the
    tokens of the same requests served unmigrated."""
    cfg = GPTConfig.gpt3_1_3b(dtype="float32")
    cfg.num_layers = 2
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(64, 701, 8)]
    kw = dict(kv_layout="paged", max_slots=8, max_seq_len=1024,
              block_size=16, prefill_chunk=128)
    ref = LLMEngine(model, **kw)
    want = ref.generate(prompts, max_new_tokens=16)
    handles, infos, _ = _migrate_stream(LLMEngine(model, **kw),
                                        LLMEngine(model, **kw), prompts, 16,
                                        "migration_fp32")
    equal = [bool(np.array_equal(h.output_ids(), w))
             for h, w in zip(handles, want)]
    emit({"phase": "migration_fp32", "layers": 2, "dtype": "float32",
          "requests": len(prompts), "tokens_equal_to_unmigrated": equal,
          "blocks_copied": sum(i["blocks_copied"] for i in infos)})
    if not all(equal):
        raise AssertionError(f"migration_fp32: migrated tokens differ "
                             f"from unmigrated ones: {equal}")


# -- the serving fleet ------------------------------------------------------
#: the fleet's per-replica engine shape: the engine phase's, so a decode
#: row's products have that phase's shapes and its greedy tokens
FLEET_ENGINE = dict(kv_layout="paged", max_slots=8, max_seq_len=1024,
                    block_size=16, prefill_chunk=128)
#: the counters a fleet phase gates at what its fault schedule injects
FLEET_FAULT_COUNTERS = ("serving.fleet.replica_deaths",
                        "serving.fleet.respawns",
                        "serving.fleet.monitor_errors", "serving.fleet.lost")


def _launch_counts():
    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            **{f"paged_decode_attention_{k}": n for k, n in
               pa.paged_decode_attention.quant_launches.items()}}


def _fleet_warm(fleet, V):
    """One request through the whole fleet before the counted run (its
    prefill replica, a migration, a decode replica): the first use of
    every path, off the counted run's clock (the engine phases warm up the
    same way)."""
    h = fleet.submit(np.random.default_rng(11).integers(0, V, 64),
                     max_new_tokens=2, seed=0)
    fleet.join([h])
    torch.cuda.synchronize()


def _fleet_pools_reconcile(fleet):
    for rep in fleet._alive():
        pool = rep.engine.pool
        live = sum(1 for b in range(1, len(pool._ref)) if pool._ref[b] > 0)
        if len(pool._free) + live != pool.capacity:
            return False
    return True


def _fleet_counted(fleet, prompts, max_new, phase, schedule=None,
                   on_pump=None):
    """The counted main-path run of a fleet: launch counts set to 0 just
    before, read just after; ``schedule`` is the fault schedule
    (``faultinject`` spec) active during the run; ``on_pump(fleet)`` runs
    after every ``pump`` of an unthreaded fleet.  Returns the handles, the
    counter movement, the launches and the wall seconds."""
    pa.reset_launch_counts()
    before = counters.snapshot()
    faultinject.set_schedule(schedule)
    t0 = time.perf_counter()
    try:
        hs = [fleet.submit(p, max_new_tokens=max_new, seed=i)
              for i, p in enumerate(prompts)]
        if fleet.threaded:
            fleet.join(hs, timeout_s=300)
        else:
            while not all(h.is_finished for h in hs):
                fleet.pump()
                if on_pump is not None:
                    on_pump(fleet)
        torch.cuda.synchronize()
        fired = sorted(faultinject.fired)
    finally:
        faultinject.clear()
    wall = time.perf_counter() - t0
    return hs, counters.delta(before), _launch_counts(), wall, fired


def _fleet_gates(phase, fleet, hs, moved, launches, L, kv_dtype, want=None,
                 faults=None):
    """The gates every fleet phase shares: each request finished
    ``length``; ``serving.fleet.replica_deaths``, ``.respawns``,
    ``.monitor_errors`` and ``.lost`` at exactly what the schedule
    injected (``faults``, default none); K4 (or K4q) launched exactly
    decode_steps x L times and no other variant; every pool reconciles;
    tokens equal ``want`` where given."""
    faults = faults or {}
    for name in FLEET_FAULT_COUNTERS:
        if moved.get(name, 0) != faults.get(name, 0):
            raise AssertionError(f"{phase}: {name} moved "
                                 f"{moved.get(name, 0)}, injected "
                                 f"{faults.get(name, 0)} ({moved})")
    bad = [h for h in hs if h.finish_reason != "length"]
    if bad:
        raise AssertionError(f"{phase}: {bad}")
    k = ("paged_decode_attention" if kv_dtype is None
         else f"paged_decode_attention_{kv_dtype}")
    steps = moved.get("serving.decode_steps", 0)
    for name, n in launches.items():
        want_n = steps * L if name == k else 0
        if n != want_n or (name == k and n <= 0):
            raise AssertionError(f"{phase}: {name} launched {n} times, "
                                 f"want {want_n} (decode_steps {steps})")
    if not _fleet_pools_reconcile(fleet):
        raise AssertionError(f"{phase}: a pool leaks (free + live != "
                             f"capacity)")
    if want is not None:
        diff = [i for i, (h, w) in enumerate(zip(hs, want))
                if list(map(int, h.tokens)) != list(map(int, w))]
        if diff:
            raise AssertionError(f"{phase}: requests {diff} differ from "
                                 f"the reference tokens")


def _ms(ns):
    return ns / 1e6


def fleet_phase(model, prompts, tokens, engine_record, kv_dtype=None,
                bf16_tokens=None):
    """``ServingFleet(model, replicas=3, prefill_replicas=1,
    kv_layout="paged", threaded=True)``: the 16 requests, 32 greedy
    tokens each, prefilled on the prefill replica and migrated to the two
    decode replicas, each replica in its own thread.  Gates: the tokens
    equal the paged engine phase's (bf16); zero lost, no death or
    respawn; blocks copied + shared by the migrations == the blocks the
    requests owned; K4 (K4q with ``kv_dtype``) == decode_steps x 24 and
    the prefill replica never decoded.  Prints TTFT p50/p95 and ITL p50
    from ``Router.latency_summary``, decode tokens/s against the engine
    phase's, host ms a migration (the kv.migrate trace spans) and (bf16)
    the device busy share over a second, profiled pass of 8 requests;
    then (bf16) the same fleet unthreaded (``_fleet_unthreaded``)."""
    phase = "fleet" if kv_dtype is None else f"fleet_{kv_dtype}"
    L = model.config.num_layers
    V = model.config.vocab_size
    fleet = ServingFleet(model, replicas=3, prefill_replicas=1,
                         threaded=True, kv_dtype=kv_dtype, **FLEET_ENGINE)
    _fleet_warm(fleet, V)
    hist0 = Router.aggregate_histograms(fleet._replicas)
    flags.set_flags({"FLAGS_request_trace_sample": 1.0})
    try:
        hs, moved, launches, wall, _ = _fleet_counted(fleet, prompts, 32,
                                                      phase)
        mig_ms = sorted(_ms(s[4] - s[3]) for ctx in rtrace.kept()
                        for s in ctx.spans if s[2] == "kv.migrate")
    finally:
        flags.set_flags({"FLAGS_request_trace_sample": 0.0})
        rtrace.clear()
    _fleet_gates(phase, fleet, hs, moved, launches, L, kv_dtype,
                 want=tokens if kv_dtype is None else None)
    owned = sum(blocks_for_tokens(len(p), 16) for p in prompts)
    mig = {k.rsplit(".", 1)[1]: moved.get(k, 0) for k in (
        "serving.fleet.migrate.requests", "serving.fleet.migrate.blocks_copied",
        "serving.fleet.migrate.blocks_shared",
        "serving.fleet.migrate.deferred", "serving.fleet.migrate.dropped")}
    if (mig["requests"] != len(prompts)
            or mig["blocks_copied"] + mig["blocks_shared"] != owned):
        raise AssertionError(f"{phase}: migrations {mig}, owned {owned}")
    pre = [r for r in fleet._alive() if r.role == "prefill"]
    if len(pre) != 1 or pre[0].engine.stats()["decode_tps_ema"] != 0.0:
        raise AssertionError(f"{phase}: the prefill replica decoded")
    # the counted run's window of the merged replica histograms
    lat = {n: (h.delta(hist0[n]) if n in hist0 else h).summary()
           for n, h in Router.aggregate_histograms(fleet._replicas).items()}
    dec_tok = moved.get("serving.decode_tokens", 0)
    eng_c = engine_record["counters"]
    rec = {
        "phase": phase, "model": "gpt3_1_3b bf16", "layers": L,
        "kv_dtype": kv_dtype, "replicas": 3, "prefill_replicas": 1,
        "threaded": True, "requests": len(hs), "wall_s": wall,
        "generated_tokens": sum(len(h.tokens) for h in hs),
        "ttft_ms_p50": _ms(lat["serving.ttft_ns"]["p50"]),
        "ttft_ms_p95": _ms(lat["serving.ttft_ns"]["p95"]),
        "itl_ms_p50": _ms(lat["serving.itl_ns"]["p50"]),
        "itl_ms_p95": _ms(lat["serving.itl_ns"]["p95"]),
        "decode_tokens_per_s_wall": dec_tok / wall,
        "output_tokens_per_s": sum(len(h.tokens) for h in hs) / wall,
        "engine_decode_tokens_per_s_wall": (
            eng_c.get("serving.decode_tokens", 0) / engine_record["wall_s"]),
        "engine_output_tokens_per_s": engine_record["output_tokens_per_s"],
        "engine_ttft_ms_p50": engine_record["ttft_ms_p50"],
        "migration_host_ms_p50": (float(np.median(mig_ms)) if mig_ms
                                  else None),
        "migration_host_ms_max": max(mig_ms) if mig_ms else None,
        "migrations": mig, "blocks_owned": owned,
        "decode_steps": moved.get("serving.decode_steps", 0),
        "launches": launches,
        "kernel_launches": sum(launches.values()),
        "deaths": moved.get("serving.fleet.replica_deaths", 0),
        "lost": moved.get("serving.fleet.lost", 0),
        "tokens_equal_to_engine_phase": kv_dtype is None,
    }
    if kv_dtype is not None:
        # printed, not gated: int8 rounding flips near-ties
        rec["greedy_token_agreement_with_bf16_fleet"] = _agreement(
            hs, bf16_tokens)
    else:
        prof = _profile(lambda: fleet.join(
            [fleet.submit(p, max_new_tokens=16, seed=i)
             for i, p in enumerate(prompts[:8])], timeout_s=300), top=6)
        rec.update(device_busy_share=prof["device_busy_share"],
                   profiled_wall_us=prof["wall_us"],
                   profiled_device_us=prof["device_us"],
                   top_device_ops=prof["top_device_ops"])
    fleet.drain()
    del fleet
    _free_cuda()
    if kv_dtype is None:
        rec.update(_fleet_unthreaded(model, prompts, tokens))
    emit(rec)
    return rec, [list(map(int, h.tokens)) for h in hs]


def _fleet_unthreaded(model, prompts, tokens):
    """The same fleet with ``threaded=False``: the replicas stepped in
    turn by ``pump()`` in one thread.  Its tokens must equal the engine
    phase's too; its decode tokens/s is printed beside the threaded
    fleet's (the threads share one interpreter)."""
    fleet = ServingFleet(model, replicas=3, prefill_replicas=1,
                         threaded=False, **FLEET_ENGINE)
    _fleet_warm(fleet, model.config.vocab_size)
    hs, moved, launches, wall, _ = _fleet_counted(fleet, prompts, 32,
                                                  "fleet_unthreaded")
    _fleet_gates("fleet_unthreaded", fleet, hs, moved, launches,
                 model.config.num_layers, None, want=tokens)
    fleet.drain()
    del fleet
    _free_cuda()
    return {"unthreaded_wall_s": wall,
            "unthreaded_decode_tokens_per_s_wall":
                moved.get("serving.decode_tokens", 0) / wall,
            "unthreaded_launches": launches,
            "unthreaded_tokens_equal_to_engine_phase": True}


def _fleet_chaos_run(model, prompts, kw, phase, schedule=None, stall=False,
                     faults=None, want=None):
    """One unthreaded fleet over ``prompts`` (16 greedy tokens each);
    ``stall`` sets a hung replica's heartbeat back past the timeout after
    the pump that hung it, so the stall detector trips on the next."""
    L = model.config.num_layers
    fleet = ServingFleet(model, threaded=False, heartbeat_timeout_s=30.0,
                         max_retries=2, **kw, **FLEET_ENGINE)

    def set_back(f):
        for rep in f._alive():
            if rep.hung:
                rep.last_beat -= f.heartbeat_timeout_s + 1.0

    hs, moved, launches, wall, fired = _fleet_counted(
        fleet, prompts, 16, phase, schedule=schedule,
        on_pump=set_back if stall else None)
    alloc = torch.cuda.memory_allocated()
    pool_gb = fleet._alive()[0].engine.stats()["kv_pool_bytes"] / 1e9
    _fleet_gates(phase, fleet, hs, moved, launches, L, None, want=want,
                 faults=faults)
    fleet.drain()
    toks = [list(map(int, h.tokens)) for h in hs]
    rec = {"run": phase, "schedule": schedule, "fired": fired,
           "wall_s": wall, "retries": [h.retries for h in hs],
           "alive_allocated_gb": alloc / 1e9, "pool_gb": pool_gb,
           "launches": launches,
           "moved": {k: v for k, v in moved.items()
                     if k.startswith("serving.fleet.")
                     and k not in ("serving.fleet.decode_tps",)}}
    del fleet
    _free_cuda()
    return toks, rec


def _flight_to_build():
    """Postmortem bundles (replica deaths, health alerts) go under the
    checkout's git-ignored ``build/flight``."""
    flags.set_flags({"FLAGS_flight_dir": os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "flight")})


def _fleet_4layer_model(seed):
    cfg = GPTConfig.gpt3_1_3b(dtype="bfloat16")
    cfg.num_layers = 4          # depth cut for time; width is 1.3B's
    return GPTForCausalLM(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(seed))


def fleet_chaos_phase(prompts):
    """``threaded=False`` fleets at the 1.3B width, 4 layers (depth cut for
    time): two unified replicas under ``replica_crash`` on request 0 and
    ``decode_stall`` on request 1 (the stall detector tripped by setting
    the hung replica's heartbeat back), then a disaggregated pair under
    ``kv_migrate_drop`` on requests 0 and 2.  Gates: zero lost; tokens
    identical to the same fleet's no-fault run; every pool reconciles
    (free + live == capacity); deaths and respawns equal to what was
    injected (2 and 2, 0 and 0); K4 == decode_steps x 4.  Prints
    ``torch.cuda.memory_allocated()`` before and after the phase, and the
    faulted fleets' allocation before drain beside the clean ones': a
    dead replica's pool is released."""
    _flight_to_build()
    model = _fleet_4layer_model(5)
    ps = prompts[:8]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    runs = []
    # unified: crash + stall
    uni = dict(replicas=2)
    want, clean = _fleet_chaos_run(model, ps, uni, "unified_clean")
    got, faulted = _fleet_chaos_run(
        model, ps, uni, "unified_crash_stall",
        schedule="replica_crash@0;decode_stall@1", stall=True,
        faults={"serving.fleet.replica_deaths": 2,
                "serving.fleet.respawns": 2}, want=want)
    if faulted["fired"] != [("decode_stall", 1), ("replica_crash", 0)]:
        raise AssertionError(f"fleet_chaos: fired {faulted['fired']}")
    runs += [clean, faulted]
    # disaggregated pair: migrations severed
    dis = dict(replicas=2, prefill_replicas=1)
    want_d, clean_d = _fleet_chaos_run(model, ps, dis, "disagg_clean")
    got_d, dropped = _fleet_chaos_run(
        model, ps, dis, "disagg_migrate_drop",
        schedule="kv_migrate_drop@0,kv_migrate_drop@2", want=want_d)
    if dropped["moved"].get("serving.fleet.migrate.dropped", 0) != 2:
        raise AssertionError(f"fleet_chaos: {dropped}")
    runs += [clean_d, dropped]
    # a dead replica's pool is released: the faulted unified fleet holds
    # no more than the clean one (well under one pool) before drain
    leak = faulted["alive_allocated_gb"] - clean["alive_allocated_gb"]
    del model
    _free_cuda()
    mem1 = torch.cuda.memory_allocated()
    rec = {"phase": "fleet_chaos", "model": "gpt3_1_3b bf16", "layers": 4,
           "layers_cut_from": 24, "requests": len(ps), "runs": runs,
           "memory_allocated_gb_before": mem0 / 1e9,
           "memory_allocated_gb_after": mem1 / 1e9,
           "faulted_minus_clean_allocated_gb": leak,
           "lost": sum(r["moved"].get("serving.fleet.lost", 0)
                       for r in runs)}
    emit(rec)
    if leak > 0.5 * clean["pool_gb"]:
        raise AssertionError(f"fleet_chaos: the faulted fleet holds "
                             f"{leak} GB more than the clean one (a pool "
                             f"is {clean['pool_gb']} GB)")
    return rec


def fleet_autoscale_phase(prompts):
    """``FLAGS_health`` on, a unified two-replica fleet at the 1.3B width,
    4 layers, an ``itl_burn`` SLO (p95 ITL over 0.5 s windows against the
    default 15 ms objective) and ``FleetAutoscaler(cooldown_ticks=1)``;
    ``slow_decode`` stalls the replica holding the first request 20 ms
    before each of 24 of its iterations (``max_replicas=2``: no spawn).
    New requests arrive whenever the fleet is idle and the admission
    level is not critical (the router would shed them).  Gates: the 24 stalls ran, the alert
    fires, the autoscaler disaggregates (one replica flips to prefill),
    the alert resolves once the stalls end, the 8 requests admitted after
    that migrate; ``serving.autoscale.*`` counters prove the transition;
    zero lost; K4 == decode_steps x 4."""
    from paddle_tpu_torch.profiler.health import SLO
    _flight_to_build()
    model = _fleet_4layer_model(6)
    V = model.config.vocab_size
    L = model.config.num_layers
    flags.set_flags({"FLAGS_health": True})
    slo = SLO("itl_burn", ("hist_p95", "serving.itl_ns"), 15e6,
              windows=((0.5, 1.0),), min_count=4)
    try:
        fleet = ServingFleet(
            model, replicas=2, threaded=False, autoscale=True,
            autoscale_kw=dict(cooldown_ticks=1, ok_streak=10**6,
                              max_replicas=2),
            health_kw=dict(rules=[slo], interval_s=0.05), **FLEET_ENGINE)
        _fleet_warm(fleet, V)
        pa.reset_launch_counts()
        before = counters.snapshot()
        t0 = time.perf_counter()
        marks = {}
        hs = [fleet.submit(p, max_new_tokens=32, seed=i)
              for i, p in enumerate(prompts[:8])]
        faultinject.set_schedule(f"slow_decode@{hs[0].rid}*24")
        rng = np.random.default_rng(12)

        def more(n):
            # new traffic; a request the router sheds (RetryAfter) is not
            # resubmitted
            for _ in range(n):
                try:
                    hs.append(fleet.submit(rng.integers(0, V, 128),
                                           max_new_tokens=32,
                                           seed=len(hs)))
                except RetryAfter:
                    pass

        while time.perf_counter() - t0 < 60:
            fleet.pump()
            d = counters.delta(before)
            if "fired" not in marks and d.get(
                    "health.alerts.fired.itl_burn"):
                marks["fired"] = time.perf_counter() - t0
            if "disaggregate" not in marks and d.get(
                    "serving.autoscale.decisions.disaggregate"):
                marks["disaggregate"] = time.perf_counter() - t0
            if "disaggregate" in marks and d.get(
                    "health.alerts.resolved.itl_burn"):
                marks["resolved"] = time.perf_counter() - t0
                break
            if (all(h.is_finished for h in hs)
                    and fleet.health.admission_level() != "critical"):
                more(8)
        # after the split: new requests prefill on the prefill replica
        # and migrate to the decode one
        n0 = len(hs)
        more(8)
        admitted_after = len(hs) - n0
        while not all(h.is_finished for h in hs):
            fleet.pump()
        torch.cuda.synchronize()
        faultinject.clear()
        moved = counters.delta(before)
        launches = _launch_counts()
        roles = fleet.stats()["roles"]
        history = fleet.autoscaler.summary()["history"]
        _fleet_gates("fleet_autoscale", fleet, hs, moved, launches, L, None)
        fleet.drain()
    finally:
        faultinject.clear()
        flags.set_flags({"FLAGS_health": False})
    auto = {k: v for k, v in moved.items()
            if k.startswith(("serving.autoscale.", "health.alerts."))}
    rec = {"phase": "fleet_autoscale", "model": "gpt3_1_3b bf16",
           "layers": 4, "layers_cut_from": 24, "requests": len(hs),
           "seconds_to": marks, "roles_after": roles,
           "decisions": [h["action"] for h in history],
           "counters": auto,
           "slow_decode_stalls": moved.get(
               "serving.fleet.slow_decode_stalls", 0),
           "migrations": moved.get("serving.fleet.migrate.requests", 0),
           "admitted_after_resolve": admitted_after,
           "health_shed": moved.get("serving.fleet.health_shed", 0),
           "decode_steps": moved.get("serving.decode_steps", 0),
           "launches": launches}
    emit(rec)
    if not (auto.get("health.alerts.fired.itl_burn", 0) >= 1
            and auto.get("serving.autoscale.decisions.disaggregate", 0) >= 1
            and auto.get("serving.autoscale.flips.to_prefill", 0) >= 1
            and auto.get("health.alerts.resolved.itl_burn", 0) >= 1
            and roles == {"prefill": 1, "decode": 1, "unified": 0}
            and rec["slow_decode_stalls"] == 24
            and admitted_after == 8 and rec["migrations"] >= 8):
        raise AssertionError(f"fleet_autoscale: {rec}")
    del fleet, model
    _free_cuda()
    return rec


def slots_in_model_phase():
    """The slot path against the paged path in a 2-layer model at the
    1.3B width: 8 prompts of 64-700 tokens prefilled through
    ``prefill_slot`` into an arena and through ``prefill_paged`` chunks of
    128 into block pools, then one ``decode_slots`` and one
    ``decode_paged`` (K4) step on the same tokens; in bf16 and on fp32
    copies of the same weights, held by ``_self_calibrated``."""
    cfg = GPTConfig.gpt3_1_3b(dtype="bfloat16")
    cfg.num_layers = 2
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(4))
    V, L, nh = cfg.vocab_size, cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // nh
    rng = np.random.default_rng(5)
    lens = rng.integers(64, 701, 8)
    prompts = [rng.integers(0, V, int(n)) for n in lens]
    S, bs, chunk = 1024, 16, 128
    max_blocks = S // bs
    bt = torch.arange(1, 8 * max_blocks + 1, dtype=torch.int32,
                      device="cuda").reshape(8, max_blocks)
    tok = torch.from_numpy(rng.integers(0, V, 8).astype(np.int32)).cuda()
    pos = torch.from_numpy(lens.astype(np.int32)).cuda()
    out = {}
    for name, w, dt in (("bf16", model.decode_state(), torch.bfloat16),
                        ("fp32", _fp32_state(model.decode_state()),
                         torch.float32)):
        arena = [torch.zeros((L, 8, S, nh, hd), dtype=dt, device="cuda")
                 for _ in "kv"]
        pools = [torch.zeros((L, 8 * max_blocks + 1, bs, nh, hd), dtype=dt,
                             device="cuda") for _ in "kv"]
        pre = {"slot": [], "paged": []}
        for b, p in enumerate(prompts):
            T = len(p)
            ids = np.zeros((1, bucket_length(T, 8, S)), np.int64)
            ids[0, :T] = p
            pre["slot"].append(model.prefill_slot(
                w, torch.from_numpy(ids).cuda(), T, arena[0][:, b:b + 1],
                arena[1][:, b:b + 1])[0])
            start = 0
            while start < T:       # the paged engine's chunks of 128
                C = bucket_length(min(T - start, chunk), 8, chunk)
                take = min(T - start, C)
                ids = np.zeros((1, C), np.int64)
                ids[0, :take] = p[start:start + take]
                lg = model.prefill_paged(w, torch.from_numpy(ids).cuda(),
                                         start, take, bt[b], *pools)
                start += take
            pre["paged"].append(lg[0])
        out[name] = {
            "prefill": (torch.stack(pre["slot"]), torch.stack(pre["paged"])),
            "decode": (model.decode_slots(w, tok, pos, *arena),
                       model.decode_paged(w, tok, pos, bt, *pools))}
        del arena, pools
    torch.cuda.synchronize()
    emit({"phase": "slots_in_model", "layers": L, "rows": 8,
          "prompt_tokens": int(lens.sum()),
          "check": "slot path vs paged path, bf16 and fp32",
          **{step: _self_calibrated(f"slots_in_model {step}",
                                    *out["bf16"][step], *out["fp32"][step])
             for step in ("prefill", "decode")}})


def draft_times_phase(snap):
    """K4 at the draft's shape (GPT-3 125M: 12 heads of 64) over the
    fullest speculative round's draft pools, tables and positions,
    beside its plain version, SDPA over the gathered K/V and its bound,
    on a line of its own."""
    pk, pv = snap["pools"]
    L, n_blocks, bs, nh, hd = pk.shape
    bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
    pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = (torch.randn(bt.shape[0], nh, hd, generator=gen, device="cuda")
         / math.sqrt(hd)).to(pk.dtype)
    r = _paged_times(q, {None: (pk, pv)}, bt, pos, 48)[None]
    emit({"phase": "times", "kernel": "paged_decode_attention",
          "case": "draft shape (GPT-3 125M heads), fullest speculative round",
          "rows_running": snap["rows"], "shape": r["shape"],
          "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
          "library_us": r["library_ms"] * 1e3,
          "library": "sdpa over pre-gathered K/V",
          "times": "device time per wrapper call, split kernel and merge "
                   "(queued CUDA events)",
          "event_us": {k: v * 1e3 for k, v in r["event_ms"].items()},
          "runs_ms": r["runs_ms"], "bytes": r["bytes"], "flops": r["flops"],
          "bound_us": r["bound_ms"] * 1e3, "bound_by": r["bound_by"],
          "share_of_bound": r["bound_ms"] / r["ms"],
          "kernel_gb_per_s": r["bytes"] / (r["ms"] * 1e-3) / 1e9})


# ---------------------------------------------------------------------------
# RMSNorm (K5)
# ---------------------------------------------------------------------------
#: K5's main path: its own entry point at the 1.3B width, 8 x 1024 tokens
RMS_SHAPE = (8, 1024, 2048)


def _rms_tol(ref, out):
    """Per-element tolerance of K5 against its plain version.  fp32: 1e-6
    relative (both sum squares in fp32 in another order, rsqrt to an ulp
    or two).  bf16: the normalized value is rounded to bf16 before the
    weight product, and a reordered sum moves that rounding by at most
    one step; one bf16 step of n times w is one to two bf16 steps of the
    product, rounded again: 2 bf16 ulps of the element (the larger of
    the two values)."""
    if ref.dtype == torch.float32:
        return 1e-6 * ref.abs()
    return 2 * _bf16_ulp(torch.maximum(ref.abs(), out.abs()).float())


def rms_phase():
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, fp32 = torch.bfloat16, torch.float32
    pairs = ((fp32, fp32), (bf16, bf16), (fp32, bf16))
    cases = [((rows, H), xd, wd) for xd, wd in pairs for rows in (1, 7, 8192)
             for H in (33, 64, 1000, 1536, 2048, 4096)]
    cases.append((RMS_SHAPE, bf16, bf16))
    worst = {"max_abs_err": 0.0, "err_over_tol": 0.0, "bf16_ulps": 0.0}
    for shape, xd, wd in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(xd)
        w = torch.randn(shape[-1], generator=gen, device="cuda").to(wd)
        out = rn.rms_norm(x, w)
        ref = rn.rms_norm_reference(x, w).to(xd)
        torch.cuda.synchronize()
        where = f"{shape} x {xd} w {wd}"
        if out.dtype != xd or out.shape != x.shape:
            raise AssertionError(f"rms_norm: {out.dtype} {tuple(out.shape)} "
                                 f"at {where}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"rms_norm: non-finite output at {where}")
        err = (out.float() - ref.float()).abs()
        tol = _rms_tol(ref, out)
        over = float((err / tol).nan_to_num(nan=0.0).max())
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        worst["err_over_tol"] = max(worst["err_over_tol"], over)
        if xd == bf16:
            ulps = float((err / _bf16_ulp(ref.float().abs()))
                         .nan_to_num(nan=0.0, posinf=0.0).max())
            worst["bf16_ulps"] = max(worst["bf16_ulps"], ulps)
        if over > 1.0:
            i = int((err - tol).argmax())
            raise AssertionError(
                f"rms_norm: err {float(err.reshape(-1)[i])} > tol "
                f"{float(tol.reshape(-1)[i])} at flat index {i}, {where}")
    emit({"phase": "rms_norm_vs_plain", "cases": len(cases), **worst,
          "tolerance": "per element: fp32 1e-6 relative; bf16 2 bf16 ulps "
                       "of the element"})
    return worst["max_abs_err"]


def rms_times_phase(max_err):
    """K5's main path (its own entry point, once, counted), then its time
    per launch at that shape beside the plain version, the bound and
    ``torch.nn.functional.rms_norm`` (a yardstick the port never calls),
    in turns."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(RMS_SHAPE, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(RMS_SHAPE[-1], generator=gen, device="cuda").to(
        torch.bfloat16)
    rn.rms_norm.launches = 0
    y = rn.rms_norm(x, w)
    torch.cuda.synchronize()
    launches = rn.rms_norm.launches
    if launches != 1 or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"rms_norm main path: {launches} launches")
    fns = {"kernel": (lambda i: rn.rms_norm(x, w), 200),
           "plain": (lambda i: rn.rms_norm_reference(x, w), 50),
           "library": (lambda i: F.rms_norm(x, (RMS_SHAPE[-1],), w,
                                            eps=1e-6), 200)}
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k, (fn, n) in fns.items():
            runs[k].append(_time_ms(fn, n))
    event_ms = {k: float(np.mean(v)) for k, v in runs.items()}
    ms = {k: _device_ms(fn, n // 4, event_ms[k])
          for k, (fn, n) in fns.items()}
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    flops = 4 * x.numel()        # square-add, scale, weight product
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"phase": "times", "kernel": "rms_norm",
          "shape": {"x": list(RMS_SHAPE), "dtype": "bfloat16"},
          "kernel_us": ms["kernel"] * 1e3, "plain_us": ms["plain"] * 1e3,
          "library_us": ms["library"] * 1e3,
          "library": "torch.nn.functional.rms_norm",
          "times": "device time per call (queued CUDA events)",
          "event_us": {k: v * 1e3 for k, v in event_ms.items()},
          "runs_ms": runs,
          "bytes": nbytes, "flops": flops, "bound_us": bound * 1e3,
          "bound_by": by,
          "kernel_gb_per_s": nbytes / (ms["kernel"] * 1e-3) / 1e9})
    return {"name": "rms_norm", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/rms_norm.cu",
            "replaces": "paddle_tpu/kernels/rms_norm.py:29",
            "launches": launches, "max_abs_err": max_err,
            "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": ms["library"],
            "event_ms": event_ms["kernel"]}


# ---------------------------------------------------------------------------
# flash attention (K1-K3) and the training path
# ---------------------------------------------------------------------------
#: 760M's training shape: batch 8 x 1024 tokens, 16 heads of 96
TRAIN_B, TRAIN_S, TRAIN_STEPS, WARMUP = 8, 1024, 8, 2
#: BERT-large pretraining: batch 16 x 512 packed sequences (no mask), 16
#: heads of 64
BERT_B, BERT_S, BERT_H, BERT_D = 16, 512, 16, 64


def _bf16_ulp(x):
    """The bf16 ulp of each element of the fp32 tensor ``x >= 0`` (0 at
    0): x = m * 2**e with m in [0.5, 1) has ulp 2**(e - 8)."""
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x > 0, ulp, torch.zeros_like(x))


def _flash_tol(ref, dtype):
    """Per-element tolerance of a kernel output against its plain version
    on the same inputs, from ``ref``'s own values and the max of its row
    (the last dim).  fp32: both sum in fp32 in another order (<= 2048
    keys): 1e-4 of the row's max.  bf16, and fp16 (whose operands both
    round to bf16 too; its output rounds finer): both round the same operands to
    bf16, but P and dS are rounded from fp32 values that differ in their
    last bits (the kernel's online softmax scales P by a running max), so
    a few of them land one bf16 ulp apart, and the bf16 output may round
    the other way: 2 bf16 ulps of the element plus 2**-7 of the row's
    max.  Both add a floor of a small share of the tensor's max (1e-5 in
    fp32, 2**-12 in bf16) for rows whose exact value is 0 and whose
    outputs are rounding noise (causal dQ of query 0: dP - delta = 0)."""
    r = ref.float().abs()
    row = r.amax(-1, keepdim=True)
    top = float(r.max())
    if dtype == torch.float32:
        return 1e-4 * row + 1e-5 * top
    return 2 * _bf16_ulp(r) + 2.0 ** -7 * row + 2.0 ** -12 * top


def _qkv_views(gen, B, S, H, D, dtype):
    """q, k, v as the model hands them over: [B, H, S, D] views of one
    [B, S, 3*H*D] projection output."""
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda")
    qkv = qkv.to(dtype)
    return [t.reshape(B, S, H, D).transpose(1, 2)
            for t in qkv.split(H * D, -1)]


@contextlib.contextmanager
def _wrapper_rounding():
    """Route every fp16 launch to dtype code 2, the route K1–K3 took
    before they rounded fp16 tiles in shared memory: the wrapper hands
    the kernel bf16 copies of the operands (``_operands``), rounded by
    torch.  To hold the new route to its bits and time it beside it."""
    routed = fa._dtype_code
    fa._dtype_code = lambda kernel, D, dtype: fa._DTYPE_CODE[dtype]
    try:
        yield
    finally:
        fa._dtype_code = routed


def _ties_and_subnormals(gen, ts, head=None):
    """Set every element of the fp16 ``[B, H, S, D]`` views ``ts``
    halfway between two bf16 values (low 3 mantissa bits 0b100: ties to
    even), then head ``head`` of each, if given, to random fp16
    subnormals (whose bf16 roundings are normal): the rounding's edge
    cases, where a kernel that truncated, rounded ties away or flushed
    subnormals gives other bits than torch's cast."""
    for t in ts:
        bits = t.view(torch.int16)
        bits.copy_((bits & -8) | 4)
        if head is None:
            continue
        sub = torch.randint(1, 1024, bits[:, head].shape, generator=gen,
                            device="cuda", dtype=torch.int16)
        sign = torch.randint(0, 2, sub.shape, generator=gen, device="cuda",
                             dtype=torch.int16) * -32768
        bits[:, head].copy_(sub | sign)


def _flash_check(gen, cases, worst, ratio):
    """Hold K1–K3 to their plain versions on each case ``(B, H, S, D,
    dtype, causal[, option])``, per element within :func:`_flash_tol`,
    with an LSE cotangent and without, every call run twice for equal
    bits; ``worst``/``ratio`` gather the max abs error and err/tol by
    output.  dO is a ``[B, S, H, D]``-contiguous view by default;
    option ``"bhsd"`` makes it ``[B, H, S, D]``-contiguous,
    ``"strided"`` the first D dims of rows of 2·D (rows with gaps), and
    ``"ties"`` (fp16) sets q, k, v and dO to ties between bf16 values,
    with subnormals in head 0 of v and dO (:func:`_ties_and_subnormals`).
    Where a kernel rounds fp16 operands in shared memory
    (``fa._dtype_code``), its outputs (K1's O and LSE, K2's dQ, K3's dK
    and dV) must be bit for bit those of the route on the wrapper's
    rounded copies (:func:`_wrapper_rounding`).  Returns the number of
    those equal-bits gates passed."""
    gates = 0
    for B, H, S, D, dtype, causal, *do_layout in cases:
        q, k, v = _qkv_views(gen, B, S, H, D, dtype)
        wide = 2 if do_layout == ["strided"] else 1
        do = torch.randn(B, S, H, wide * D, generator=gen,
                         device="cuda").to(dtype)[..., :D].transpose(1, 2)
        if do_layout == ["bhsd"]:
            do = do.contiguous()
        if do_layout == ["ties"]:
            _ties_and_subnormals(gen, (q, k))
            _ties_and_subnormals(gen, (v, do), head=0)
        sc = 1.0 / math.sqrt(D)
        in_kernel = {n: fa._dtype_code(n, D, dtype) != fa._DTYPE_CODE[dtype]
                     for n in ("fwd", "dq", "dkv")}
        out, lse = fa.flash_fwd(q, k, v, causal, sc)
        if not all(map(torch.equal, (out, lse),
                       fa.flash_fwd(q, k, v, causal, sc))):
            raise AssertionError(f"flash_fwd: two runs differ at B={B} "
                                 f"H={H} S={S} D={D} {dtype} "
                                 f"causal={causal}")
        if in_kernel["fwd"]:
            with _wrapper_rounding():
                copies = fa.flash_fwd(q, k, v, causal, sc)
            if not all(map(torch.equal, (out, lse), copies)):
                raise AssertionError(
                    f"flash_fwd: fp16 rounded in the kernel differs from "
                    f"the wrapper's rounded copies at B={B} H={H} S={S} "
                    f"D={D} causal={causal} {do_layout}")
            gates += 1
            del copies
        rout, rlse = fa._flash_fwd_reference(q, k, v, causal, sc)
        # lse: fp32 log-sum-exps on both sides, 1e-5 relative
        checks = [("flash_fwd", out, rout, _flash_tol(rout, dtype)),
                  ("flash_fwd_lse", lse, rlse,
                   1e-5 * rlse.abs().clamp_min(1.0))]
        for dlse in (None, torch.randn(B, H, S, generator=gen,
                                       device="cuda")):
            delta = fa._delta(rout, do, dlse)
            dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal, sc)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal, sc)
            # K2 and K3 sum in a fixed order: a second run, equal bits
            again = [fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal, sc),
                     *fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal,
                                       sc)]
            for name, got, rerun in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                        again):
                if not torch.equal(got, rerun):
                    raise AssertionError(
                        f"flash_bwd {name}: two runs differ at B={B} H={H} "
                        f"S={S} D={D} {dtype} causal={causal}")
            del again
            if in_kernel["dq"]:
                with _wrapper_rounding():
                    copies = fa.flash_bwd_dq(q, k, v, do, rlse, delta,
                                             causal, sc)
                if not torch.equal(dq, copies):
                    raise AssertionError(
                        f"flash_bwd_dq: fp16 rounded in the kernel differs "
                        f"from the wrapper's rounded copies at B={B} H={H} "
                        f"S={S} D={D} causal={causal} {do_layout}")
                gates += 1
                del copies
            if in_kernel["dkv"]:
                with _wrapper_rounding():
                    copies = fa.flash_bwd_dkv(q, k, v, do, rlse, delta,
                                              causal, sc)
                if not all(map(torch.equal, (dk, dv), copies)):
                    raise AssertionError(
                        f"flash_bwd_dkv: fp16 rounded in the kernel "
                        f"differs from the wrapper's rounded copies at B={B} "
                        f"H={H} S={S} D={D} causal={causal} {do_layout}")
                gates += 1
                del copies
            rdq = fa._bwd_dq_reference(q, k, v, do, rlse, delta, causal, sc)
            rdk, rdv = fa._bwd_dkv_reference(q, k, v, do, rlse, delta,
                                             causal, sc)
            checks += [("flash_bwd_dq", dq, rdq, _flash_tol(rdq, dtype)),
                       ("flash_bwd_dkv", dk, rdk, _flash_tol(rdk, dtype)),
                       ("flash_bwd_dkv", dv, rdv, _flash_tol(rdv, dtype))]
        torch.cuda.synchronize()
        where = (f"B={B} H={H} S={S} D={D} {dtype} causal={causal}"
                 + (f" dO {do_layout[0]}" if do_layout else ""))
        for name, got, ref, tol in checks:
            if got.dtype != ref.dtype or got.shape != ref.shape:
                raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                                     f"vs {ref.dtype} {tuple(ref.shape)}")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: non-finite output at {where}")
            err = (got.float() - ref.float()).abs().reshape(-1)
            tol = torch.broadcast_to(tol, ref.shape).reshape(-1)
            worst[name] = max(worst[name], float(err.max()))
            over = float((err / tol).nan_to_num(nan=0.0, posinf=math.inf)
                         .max())
            ratio[name] = max(ratio[name], over)
            if over > 1.0:
                i = int((err - tol).argmax())
                raise AssertionError(
                    f"{name}: err {float(err[i])} > tol {float(tol[i])} at "
                    f"flat index {i} of {tuple(ref.shape)}, {where}")
        del checks
    return gates


#: head dims of the mma.sync kernels held to their plain versions: the
#: bucket ends and a head dim inside each bucket (B-i)
FLASH_HD_DIMS = (16, 32, 48, 80, 112, 144, 160, 192, 208, 224, 240, 256)


def flash_hd_phase():
    """K1–K3 at head dims off ``flash_attention.cu`` against their plain
    versions: every bucket of ``flash_attention_mma.cu`` small, then D
    256 (B 2, H 16, S 1024: ``nn.MultiHeadAttention(4096, 16)``'s heads;
    K1–K3 in bf16/fp16 are ``flash_attention_d256.cu``'s), D 32 (B 4, H
    32, S 1024) and D 80 (B 2, H 8, S 1024), each causal and not, in
    fp32, bf16 and fp16; then the D 256 wgmma kernels' persistent loops
    at their edges, in bf16 and fp16: S 128 (one K1/K2 item and two K3
    items a head), 35 heads of S 1024 (280 K1/K2 and 560 K3 items, no
    multiple of the SMs), S 384 (an odd count of 128-row tiles), and dO
    [B, H, S, D]-contiguous and strided (K2's and K3's dO tensor
    maps)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"flash_fwd": 0.0, "flash_fwd_lse": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    ratio = dict.fromkeys(worst, 0.0)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cases = [(2, 2, 256, D, dt, causal) for D in FLASH_HD_DIMS
             for dt in dtypes for causal in (False, True)]
    cases += [shape + (dt, causal)
              for shape in ((2, 16, 1024, 256), (4, 32, 1024, 32),
                            (2, 8, 1024, 80))
              for dt in dtypes for causal in (False, True)]
    n_mma = len(cases)
    cases += [shape + (dt, causal) + layout
              for shape, layout in (((1, 1, 128, 256), ()),
                                    ((5, 7, 1024, 256), ()),
                                    ((3, 5, 384, 256), ()),
                                    ((2, 4, 512, 256), ("bhsd",)),
                                    ((2, 4, 512, 256), ("strided",)))
              for dt in (torch.bfloat16, torch.float16)
              for causal in (False, True)]
    t0 = time.perf_counter()
    _flash_check(gen, cases, worst, ratio)
    emit({"phase": "flash_hd_vs_plain", "cases": len(cases),
          "d256_edge_cases": len(cases) - n_mma,
          "head_dims": list(FLASH_HD_DIMS), "equal_bits_on_two_runs": True,
          "max_abs_err": worst, "worst_err_over_tol": ratio,
          "seconds": time.perf_counter() - t0,
          "tolerance": "as flash_vs_plain (_flash_tol)"})
    return worst


def flash_phase():
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"flash_fwd": 0.0, "flash_fwd_lse": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    ratio = dict.fromkeys(worst, 0.0)
    # (B, H, S, D, dtype, causal): the grid, then the training main path's
    # own shape (760M: batch 8, 16 heads of 96, S 1024, causal, bf16)
    cases = [((2, 3) if S <= 256 else (1, 2)) + (S, D, dtype, causal)
             for S in (128, 256, 1024, 2048) for D in (64, 96, 128)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (False, True)]
    cases.append((TRAIN_B, 16, TRAIN_S, 96, torch.bfloat16, True))
    # K1's Hopper kernel takes 128-row query tiles: one tile (S 128, one
    # head), two (S 256), and a non-causal D 96 case over the strided
    # projection views
    cases += [(1, 1, 128, D, torch.bfloat16, causal)
              for D in fa.KERNEL_HEAD_DIMS for causal in (False, True)]
    cases += [(3, 5, 256, 96, torch.bfloat16, causal)
              for causal in (False, True)]
    cases.append((4, 16, TRAIN_S, 96, torch.bfloat16, False))
    # K2/K3's persistent grids: 35 (b, h) x 16 tiles = 560 items, not a
    # multiple of the card's SMs; and dO [B, H, S, D]-contiguous (another
    # stride order for its tensor map) at the training shape
    cases.append((5, 7, 2048, 96, torch.bfloat16, True))
    cases.append((TRAIN_B, 16, TRAIN_S, 96, torch.bfloat16, True, "bhsd"))
    # the 125M training paths' shape (train_fused, scaler_skip)
    cases.append((FUSED_B, 12, TRAIN_S, 64, torch.bfloat16, True))
    # BERT-large pretraining's shape (bert_train: 16 heads of 64, S 512,
    # no mask), in bf16 and fp16; and the fp16 instances (bf16 kernels on
    # operands rounded to bf16, fp16 outputs; K1–K3 round each tile in
    # shared memory, bit for bit the wrapper's rounded copies) over a
    # grid of their own, gpt_dygraph_fp16's shape (760M, 4 layers), and
    # operands that are all ties between bf16 values, with subnormals
    cases += [(BERT_B, BERT_H, BERT_S, BERT_D, dtype, False)
              for dtype in (torch.bfloat16, torch.float16)]
    cases += [((2, 3) if S <= 256 else (1, 2)) + (S, D, torch.float16,
                                                  causal)
              for S in (128, 256, 1024) for D in fa.KERNEL_HEAD_DIMS
              for causal in (False, True)]
    cases.append((TRAIN_B, 16, TRAIN_S, 96, torch.float16, True))
    cases += [(2, 4, 256, D, torch.float16, causal, "ties")
              for D in fa.KERNEL_HEAD_DIMS for causal in (False, True)]
    gates = _flash_check(gen, cases, worst, ratio)
    # K1 once a case, K2 and K3 with and without an LSE cotangent
    want = 5 * sum(c[4] == torch.float16 and c[3] in fa.KERNEL_HEAD_DIMS
                   for c in cases)
    if gates != want:
        raise AssertionError(f"flash_vs_plain: {gates} equal-bits gates of "
                             f"the fp16 route, want {want}")
    emit({"phase": "flash_vs_plain", "cases": len(cases),
          "equal_bits_on_two_runs": True,
          "fp16_in_kernel_equal_to_rounded_copies": gates,
          "max_abs_err": worst, "worst_err_over_tol": ratio,
          "tolerance": "per element: fp32 1e-4 x row max + 1e-5 x tensor "
                       "max; bf16 and fp16 2 bf16 ulps of the element + "
                       "2^-7 x row max + 2^-12 x tensor max; lse 1e-5 x "
                       "max(1, |lse|)"})
    return worst


def _train_cfg(num_layers=None):
    cfg = GPTConfig.gpt3_760m(vocab_size=50304, max_seq_len=TRAIN_S,
                              dtype="bfloat16")
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def _batch(cfg, B, S, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    return ids, labels


def _reset_flash_counts():
    for fn in FLASH_KERNELS:
        fn.launches = 0


def train_phase():
    """The training main path: GPT-3 760M bf16, 24 layers, batch 8 x
    1024, ``CompiledTrainStep`` + ``AdamW(1e-4)`` (fp32 masters)."""
    cfg = _train_cfg()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-4, parameters=model.named_parameters())
    step = CompiledTrainStep(model, lambda m, x, y: crit(m(x), y), opt)
    ids, labels = _batch(cfg, TRAIN_B, TRAIN_S, seed=1)
    n_params = sum(p.numel() for p in torch.nn.Module.parameters(model))
    torch.cuda.reset_peak_memory_stats()

    # -- the counted main-path run ------------------------------------------
    _reset_flash_counts()
    before = counters.snapshot()
    losses, step_s = [], []
    for i in range(WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_s.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    moved = counters.delta(before)

    steps = WARMUP + TRAIN_STEPS
    L = cfg.num_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    for name, n in launches.items():
        if n != L * steps:
            raise AssertionError(f"train: {name} launched {n} times, want "
                                 f"{L} layers x {steps} steps")
    if moved.get("kernels.flash.reference_fallbacks", 0) != 0:
        raise AssertionError(f"train: reference attention ran ({moved})")
    if moved.get("jit.steps") != steps or moved.get("optimizer.steps") != steps:
        raise AssertionError(f"train: step counters {moved}")
    p50 = float(np.median(step_s))
    tokens = TRAIN_B * TRAIN_S
    record = {
        "phase": "train", "model": "gpt3_760m bf16", "layers": L,
        "params": n_params, "batch": [TRAIN_B, TRAIN_S], "init_s": init_s,
        "steps": steps, "warmup": WARMUP, "losses": losses,
        "step_ms_p50": p50 * 1e3,
        "step_ms": [x * 1e3 for x in step_s],
        "tokens_per_s": tokens / p50,
        "model_flops_share_of_bf16_peak": 6 * n_params * tokens / p50
        / BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("jit.", "optimizer.", "kernels."))},
    }
    emit(record)
    train_profile_phase(step, model, crit, opt, ids, labels)
    return record


def _dev_us(e):
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def _device_kind(name):
    if "flash_" in name:
        return "flash K1-K3"
    if any(t in name for t in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
        return "matmul (cuBLAS)"
    return "elementwise, norms, reductions, copies"


#: K1–K3's device function names, as a trace shows them
FLASH_DEVICE_NAMES = {"flash_fwd": "flash_fwd_wgmma_kernel",
                      "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
                      "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}


#: tiny kernels that :func:`_profile` launches inside its trace before
#: the call it traces.  Deep into a process, ``torch.profiler`` on an H100
#: drops the first kernels of a trace: a prefix that grows with the
#: process's age (``trace_prefix_probe.py``: none at 32 s, the first 22
#: at 300 s, the first 32 at 420 s; this script's bert_train trace lost
#: 236 once, past a step's first K1 launch), whatever time margin the
#: trace leaves around the call, and after a warm-up step too.  The
#: pre-roll takes that loss.
PREROLL_KERNELS = 2048
#: the pre-roll's device function (``torch.cuda._sleep``'s)
PREROLL_DEVICE_NAME = "spin_kernel"


def _profile(fn, top=12, names=None):
    """``torch.profiler`` over one call of ``fn`` (synchronised), after a
    pre-roll of ``PREROLL_KERNELS`` tiny kernels in the same trace: its
    wall time, the device time, the device's busy share of the wall
    time, device time by kind of op, the ``top`` device ops, and the
    K1–K3 kernels the device ran, counted in the trace.  The pre-roll is
    left out of every number; a trace that kept none of it may have
    lost more than the pre-roll and raises."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PREROLL_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kept = sum(e.count for e in device if PREROLL_DEVICE_NAME in e.key)
    if not kept:
        raise RuntimeError(f"_profile: the trace kept none of its "
                           f"{PREROLL_KERNELS} pre-roll kernels")
    ops = sorted((e for e in device if PREROLL_DEVICE_NAME not in e.key),
                 key=_dev_us, reverse=True)
    busy = sum(_dev_us(e) for e in ops)
    by_kind = {}
    for e in ops:
        k = _device_kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + _dev_us(e)
    return {"wall_us": wall_us, "device_us": busy,
            "device_busy_share": busy / wall_us if busy else None,
            "device_us_by_kind": by_kind,
            "preroll_kernels_kept": kept,
            "top_device_ops": [{"name": e.key[:80], "us": _dev_us(e),
                                "calls": e.count} for e in ops[:top]
                               if _dev_us(e) > 0],
            "flash_kernels_run": {n: sum(e.count for e in ops if f in e.key)
                                  for n, f in (names or FLASH_DEVICE_NAMES
                                               ).items()},
            # every traced event of those names, whatever device it is
            # attributed to (what a failed gate prints beside its counts)
            "flash_events_any_device": {
                n: sum(1 for e in prof.events() if f in e.name)
                for n, f in (names or FLASH_DEVICE_NAMES).items()}}


def train_profile_phase(step, model, crit, opt, ids, labels):
    """Where a training step's time goes: :func:`_profile` over one more
    ``CompiledTrainStep`` call, then CUDA events around the forward +
    loss, the backward and the AdamW update of one step run by hand, and
    AdamW in place against out of place (:func:`_adamw_times`)."""
    # one more step with any host sync an error: the step reads nothing
    # back (the loss, the norms and the scaler stay on the device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ids, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    prof = _profile(lambda: step(ids, labels))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = crit(model(ids), labels)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    adamw = _adamw_times(opt)
    opt.clear_grad()
    parts = ("forward_and_loss", "backward", "adamw_update")
    emit({"phase": "train_profile", "card": CARD, "steps": 1,
          "adamw_ms": adamw, **prof,
          "step_parts_ms": {n: ev[i].elapsed_time(ev[i + 1])
                            for i, n in enumerate(parts)}})


def _adamw_times(opt):
    """ms of one AdamW update on the gradients the parameters hold: the
    port's in-place update (``opt.step()``) against the same formula out
    of place, every accumulator and master rebuilt as a new tensor each
    step (the port's first AdamW), on copies of the state.  In turns
    (in place, out of place, out of place, in place), 3 calls each."""
    lr_, wd, b1, b2, eps = (opt.get_lr(), opt._wd, opt._beta1, opt._beta2,
                            opt._eps)
    acc = opt._accumulators
    state = [{"p": p, "out": p.detach().clone(),
              "master": opt._master_weights[id(p)].clone(),
              **{k: acc[name][id(p)].clone() for k, name in (
                  ("m", "moment1"), ("v", "moment2"), ("b1p", "beta1_pow"),
                  ("b2p", "beta2_pow"))}}
             for p in opt._parameter_list]

    def out_of_place(_):
        for st in state:
            g = st["p"].grad.float()
            st["m"] = b1 * st["m"] + (1 - b1) * g
            st["v"] = b2 * st["v"] + (1 - b2) * g * g
            st["b1p"] = st["b1p"] * b1
            st["b2p"] = st["b2p"] * b2
            mhat = st["m"] / (1 - st["b1p"])
            vhat = st["v"] / (1 - st["b2p"])
            st["master"] = (st["master"] * (1 - lr_ * wd)
                            - lr_ * mhat / (torch.sqrt(vhat) + eps))
            st["out"].copy_(st["master"])

    times = {"in_place": [], "out_of_place": []}
    for name in ("in_place", "out_of_place", "out_of_place", "in_place"):
        fn = (lambda _: opt.step()) if name == "in_place" else out_of_place
        times[name].append(_time_ms(fn, 3, warmup=1))
    del state
    return {k: float(np.mean(v)) for k, v in times.items()}


def train_in_model_phase():
    """760M width at 2 layers: one forward and backward through K1–K3,
    then through their plain versions, on the same weights and batch."""
    cfg = _train_cfg(num_layers=2)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(2))
    crit = GPTPretrainingCriterion()
    ids, labels = _batch(cfg, TRAIN_B, TRAIN_S, seed=3)
    res = {}
    for run, kernel, recompute in (("kernel", True, False),
                                   ("plain", False, False),
                                   ("kernel_selective", True, "selective")):
        model.config.recompute = recompute
        _reset_flash_counts()
        loss = crit(model(ids, kernel=kernel), labels)
        loss.backward()
        named = torch.nn.Module.named_parameters(model)
        res[run] = (loss.item(), {n: p.grad.float() for n, p in named},
                    {fn.__name__: fn.launches for fn in FLASH_KERNELS})
        model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    (loss_k, gk, _), (loss_p, gp, _) = res["kernel"], res["plain"]
    # Selective recompute replays the same kernels on the same inputs, so
    # the forward (the loss) is the kernel run's exactly, and K1 runs again
    # in the backward.  Its grads reach the shared inputs of two replayed
    # stages by two paths and are summed in bf16 in another grouping: the
    # same 8 bf16 ulps of each grad's scale as below.
    loss_r, gr, launches_r = res["kernel_selective"]
    L = cfg.num_layers
    recompute = {
        "loss": loss_r, "launches": launches_r,
        "worst_err_over_scale": max(
            float((gr[n] - gk[n]).abs().max() / gk[n].abs().max())
            for n in gk),
        "atol_over_scale": 8 * 2.0 ** -8}
    if launches_r != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                      "flash_bwd_dkv": L} or loss_r != loss_k \
            or recompute["worst_err_over_scale"] > 8 * 2.0 ** -8:
        raise AssertionError(f"train_in_model: selective recompute "
                             f"{recompute}")
    # The attention outputs agree to a bf16 rounding (flash_vs_plain); a
    # flip of one bf16 ulp (2^-8 relative) in an activation or a grad
    # passes through two layers and the bf16 grad sums.  So each grad is
    # held to 8 bf16 ulps of its scale at every element and, as a whole,
    # to a relative Frobenius error of 2^-6 (0.0156; 0.0066-0.0083 on an
    # H100 80GB HBM3, about 2 ulps): a kernel that dropped a key tile or
    # summed a tile wrong moves the whole grad by far more.  The loss of
    # a random-init model is ~ln(vocab) whatever attention does, so it is
    # only held to 1e-5 relative (1.2e-6 on that card).
    errs = {}
    for n in ("qkv_w", "proj_w", "fc1_w", "wte", "wpe"):
        scale = float(gp[n].abs().max())
        err = float((gk[n] - gp[n]).abs().max())
        errs[n] = {"max_abs_err": err, "grad_scale": scale,
                   "atol": 8 * 2.0 ** -8 * scale,
                   "rel_fro": float((gk[n] - gp[n]).norm() / gp[n].norm()),
                   "rel_fro_limit": 2.0 ** -6}
    emit({"phase": "train_in_model", "layers": cfg.num_layers,
          "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
          "loss_rel_limit": 1e-5, "grads": errs,
          "selective_recompute": recompute})
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p)
            <= 1e-5 * abs(loss_p)):
        raise AssertionError(f"train_in_model: loss {loss_k} vs {loss_p}")
    for n, e in errs.items():
        if not (math.isfinite(e["max_abs_err"]) and e["max_abs_err"]
                <= e["atol"] and e["rel_fro"] <= e["rel_fro_limit"]):
            raise AssertionError(f"train_in_model: grad {n} {e}")


# ---------------------------------------------------------------------------
# the training loop: scheduler, clipping, metrics, fused windows, GradScaler
# ---------------------------------------------------------------------------
#: GPT-3's published peak learning rates (760M: 2.5e-4, 125M: 6e-4),
#: warmed up over 2 steps, cosine-decayed to a tenth over 1000
LOOP_LR = {"gpt3_760m": 2.5e-4, "gpt3_125m": 6e-4}
#: 125M's fused leg (bench.py's gpt125m_fused): batch 16 x 1024, K = 4.
#: train_fused runs it at 6 of its 12 layers, cut for the script's time
#: limit when cp_train_2rank came, as are mesh_train_2rank (6) and
#: ckpt_resume (4); the rest keeps 12
FUSED_B, FUSED_K = 16, 4
FUSED_LAYERS, MESH2_LAYERS, CKPT_LAYERS = 6, 6, 4
#: mesh_train (one rank) runs 6 of the 12 layers since it took its
#: checkpoint save and restore, cut for the script's time limit (its
#: gates are bit-equalities, which hold at any depth)
MESH1_LAYERS = 6


def _decays(name):
    """``apply_decay_param_fun``: biases and norm weights take no decay."""
    return not (name.endswith("_b") or name.startswith("ln"))


def _flash_per_layer_step(recompute):
    """K1/K2/K3 launches a layer a training step, from the model's code:
    every recompute mode keeps attention inside a checkpointed stage
    (``GPTForCausalLM._block``: ``attend`` sits in ``ckpt(...)`` for
    ``True``, ``"selective"`` and ``"selective_lean"``), so the backward
    replays K1 once; K2 and K3 run once each."""
    return {"flash_fwd": 2 if recompute else 1, "flash_bwd_dq": 1,
            "flash_bwd_dkv": 1}


def _loop_optimizer(model, size):
    """:func:`_loop`'s schedule, optimizer and criterion: AdamW over a
    warmup + cosine schedule, global-norm clipping at 1.0, weight decay
    0.1 on all but biases and norms."""
    top = LOOP_LR[size]
    sched = lr.CosineAnnealingWithWarmupDecay(top, top / 10, 2, 1000)
    opt = AdamW(sched, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=_decays, weight_decay=0.1)
    return sched, opt, GPTPretrainingCriterion()


def _loop(model, size, k=1, scaler=None, loss_fn=None, metrics=True,
          mesh=None, pipeline=None):
    """The training loop as a user runs GPT pretraining: AdamW over a
    warmup + cosine schedule, global-norm clipping at 1.0, weight decay
    0.1 on all but biases and norms, train metrics; ``mesh``: the mesh
    step; ``pipeline``: a ``Pipeline1F1BTrainStep`` of that schedule
    over ``mesh`` (``PP_M`` microbatches) in its place."""
    sched, opt, crit = _loop_optimizer(model, size)
    if pipeline is not None:
        from paddle_tpu_torch.distributed import Pipeline1F1BTrainStep
        return sched, opt, Pipeline1F1BTrainStep(
            model, opt, num_microbatches=PP_M, mesh=mesh, schedule=pipeline)
    fn = loss_fn or (lambda m, x, y: crit(m(x), y))
    step = CompiledTrainStep(model, fn, opt, scaler=scaler, fused_steps=k,
                             metrics=metrics, mesh=mesh)
    return sched, opt, step


def _flash_counts():
    return {fn.__name__: fn.launches for fn in FLASH_KERNELS}


def train_loop_phase():
    """The flagship leg as users run it: GPT-3 760M bf16, 24 layers,
    ``recompute="selective_lean"`` (``bench.py:1995-2001``), batch 8 x
    1024, through :func:`_loop` with ``fused_steps=1``; 2 warm-up and 8
    timed steps on one batch."""
    cfg = _train_cfg()
    cfg.recompute = "selective_lean"
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    flags.set_flags({"FLAGS_peak_tflops": BF16_FLOPS / 1e12})
    sched, opt, step = _loop(model, "gpt3_760m")
    ids, labels = _batch(cfg, TRAIN_B, TRAIN_S, seed=1)
    n_params = sum(p.numel() for p in torch.nn.Module.parameters(model))
    torch.cuda.reset_peak_memory_stats()

    _reset_flash_counts()
    before = counters.snapshot()
    lrs, losses, step_s, enqueue_s = [], [], [], []
    for i in range(WARMUP + TRAIN_STEPS):
        lrs.append(sched())
        t = time.perf_counter()
        losses.append(step(ids, labels))
        queued = time.perf_counter() - t    # the host's share: no sync yet
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_s.append(time.perf_counter() - t)
            enqueue_s.append(queued)
        sched.step()
    launches = _flash_counts()
    moved = counters.delta(before)
    step.sync()
    losses = [float(x) for x in losses]
    series = {n: [v for _, v in step.metrics.series(n)]
              for n in ("lr", "grad_norm", "loss", "tok_s", "mfu")}
    prof = _profile(lambda: step(ids, labels))

    steps = WARMUP + TRAIN_STEPS
    L = cfg.num_layers
    want = {n: c * L * steps
            for n, c in _flash_per_layer_step(cfg.recompute).items()}
    p50 = float(np.median(step_s))
    tokens = TRAIN_B * TRAIN_S
    record = {
        "phase": "train_loop", "card": CARD,
        "model": "gpt3_760m bf16 selective_lean", "layers": L,
        "params": n_params, "batch": [TRAIN_B, TRAIN_S], "steps": steps,
        "warmup": WARMUP, "losses": losses, "lrs": lrs,
        "grad_norms": series["grad_norm"], "step_ms_p50": p50 * 1e3,
        "step_ms": [x * 1e3 for x in step_s], "tokens_per_s": tokens / p50,
        # the host's time to enqueue a step (nothing in it waits for the
        # device): a step whose enqueue is most of its wall is host-bound
        "host_enqueue_ms_p50": float(np.median(enqueue_s)) * 1e3,
        # the profiled step's device time over the unprofiled step's wall
        "device_busy_share_of_p50": prof["device_us"] / 1e3 / (p50 * 1e3),
        "host_enqueue_ms_p50": float(np.median(enqueue_s)) * 1e3,
        "model_flops_share_of_bf16_peak": 6 * n_params * tokens / p50
        / BF16_FLOPS,
        "metrics_tok_s_last": series["tok_s"][-1],
        "metrics_mfu_last": series["mfu"][-1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "launches_want": want,
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("jit.", "optimizer.", "kernels."))},
        "profile_one_more_step": prof}
    emit(record)
    if series["lr"] != lrs:
        raise AssertionError(f"train_loop: lr series {series['lr']} is not "
                             f"the scheduler's {lrs}")
    if not (len(series["grad_norm"]) == steps and all(
            math.isfinite(x) and x > 0 for x in series["grad_norm"])):
        raise AssertionError(f"train_loop: grad norms {series['grad_norm']}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and series["loss"] == losses):
        raise AssertionError(f"train_loop: losses {losses}, series "
                             f"{series['loss']}")
    if launches != want:
        raise AssertionError(f"train_loop: flash launches {launches}, want "
                             f"{want} (selective_lean)")
    if moved.get("kernels.flash.reference_fallbacks", 0) != 0:
        raise AssertionError(f"train_loop: reference attention ran ({moved})")
    for name in ("jit.steps", "jit.host.dispatches", "optimizer.steps"):
        if moved.get(name) != steps:
            raise AssertionError(f"train_loop: {name} moved "
                                 f"{moved.get(name)}, want {steps}")
    return record


def _fused_cfg(num_layers=None, dropout=0.0):
    cfg = GPTConfig.gpt3_125m(vocab_size=50304, max_seq_len=TRAIN_S,
                              dtype="bfloat16", recompute="selective",
                              dropout=dropout)
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def _window(args, lo, hi):
    return Window(tuple(a[lo:hi] for a in args), hi - lo)


def _snapshot(model, opt):
    """Copies of the parameters and the optimizer's state."""
    return ([p.detach().clone() for p in torch.nn.Module.parameters(model)],
            opt.state_dict())


def _same_state(a, b):
    """Whether two snapshots hold the same bits: parameters, masters and
    accumulators."""
    (pa, sa), (pb, sb) = a, b
    pairs = list(zip(pa, pb))
    pairs += [(t, sb["master_weights"][n])
              for n, t in sa["master_weights"].items()]
    pairs += [(t, sb["accumulators"][acc][n])
              for acc, store in sa["accumulators"].items()
              for n, t in store.items()]
    return all(torch.equal(x, y) for x, y in pairs)


def train_fused_phase():
    """GPT-3 125M bf16 at ``FUSED_LAYERS`` layers (``bench.py:2019-2035``:
    recompute "selective", batch 16 x 1024) through :func:`_loop` with
    ``fused_steps=4`` against
    ``fused_steps=1``, from the same weights on the same batches: a
    priming window, two fused windows (a capture, then a replay) and a
    tail of 2 must give bit-identical losses, parameters and optimizer
    state; then steady windows against single steps timed, and dropout
    0.1 at 2 layers for fresh masks a step."""
    cfg = _fused_cfg(num_layers=FUSED_LAYERS)
    K, L = FUSED_K, cfg.num_layers
    n = 3 * K + 2
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = tuple(torch.randint(0, cfg.vocab_size, (n, FUSED_B, TRAIN_S),
                               generator=gen, device="cuda")
                 for _ in range(2))
    runs = {}
    for k in (K, 1):
        model = GPTForCausalLM(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        sched, opt, step = _loop(model, "gpt3_125m", k=k)
        losses, moved = [], []
        bounds = ((0, K), (K, 2 * K), (2 * K, 3 * K), (3 * K, n))
        for lo, hi in (bounds if k > 1 else
                       [(i, i + 1) for i in range(n)]):
            _reset_flash_counts()
            before = counters.snapshot()
            if k > 1:
                losses.append(step(_window(args, lo, hi)))
            else:
                losses.append(step(*(a[lo] for a in args))[None])
            moved.append((counters.delta(before), _flash_counts()))
            for _ in range(hi - lo):
                sched.step()
        torch.cuda.synchronize()
        runs[k] = (model, sched, opt, step, torch.cat(losses), moved)
    (m4, s4, o4, st4, l4, moved4), (m1, s1, o1, st1, l1, _) = \
        runs[K], runs[1]
    same = {"losses": torch.equal(l4, l1),
            "params_and_optimizer_state": _same_state(_snapshot(m4, o4),
                                                      _snapshot(m1, o1)),
            "step": o4._step_count == o1._step_count == n}
    per = _flash_per_layer_step(cfg.recompute)
    steady_moved, steady_launches = moved4[2]
    want = {name: c * L * K for name, c in per.items()}

    # timed: steady windows (replays) against single steps, same batches
    n_win = 5
    win = _window(args, K, 2 * K)
    _reset_flash_counts()
    before = counters.snapshot()
    fused_s = []
    for _ in range(n_win):
        t = time.perf_counter()
        st4(win)
        torch.cuda.synchronize()
        fused_s.append((time.perf_counter() - t) / K)
    timed_moved, timed_launches = counters.delta(before), _flash_counts()
    single_s = []
    for i in range(n_win * K):
        t = time.perf_counter()
        st1(*(a[K + i % K] for a in args))
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t)
    torch.cuda.set_sync_debug_mode("error")   # a replayed window: no sync
    try:
        st4(win)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fused_busy = _profile(lambda: st4(win), top=0)
    single_busy = _profile(lambda: [st1(*(a[K + i] for a in args))
                                    for i in range(K)], top=0)
    fused_ms = float(np.median(fused_s)) * 1e3
    single_ms = float(np.median(single_s)) * 1e3
    del runs, m4, m1, o4, o1, st4, st1
    _free_cuda()
    traces = {"replay": fused_busy, "single_steps": single_busy}
    ran = {k: v["flash_kernels_run"] for k, v in traces.items()}
    any_device = {k: v["flash_events_any_device"] for k, v in traces.items()}
    dropout = _fresh_masks_check()
    step_count = _step_count_optimizers_check()
    record = {
        "phase": "train_fused", "card": CARD,
        "model": "gpt3_125m bf16 selective", "layers": L,
        "batch": [FUSED_B, TRAIN_S], "fused_steps": K,
        "windows": "priming (4 single steps), capture + replay, replay, "
                   "tail of 2",
        "bit_identical": same, "losses_fused": l4.tolist(),
        "steady_window_counters": {
            k: v for k, v in steady_moved.items()
            if k.startswith(("jit.", "optimizer."))},
        "steady_window_launches": steady_launches,
        "launches_want_per_window": want,
        "timed_windows": n_win, "timed_counters": {
            k: v for k, v in timed_moved.items()
            if k.startswith(("jit.", "optimizer."))},
        "timed_launches": timed_launches,
        "fused_step_ms_p50": fused_ms, "single_step_ms_p50": single_ms,
        "fused_speedup": single_ms / fused_ms,
        "fused_busy": fused_busy, "single_busy": single_busy,
        "dropout": dropout, "step_count_optimizers": step_count}
    emit(record)
    if not all(same.values()):
        raise AssertionError(f"train_fused: K={K} against K=1: {same}")
    if (steady_moved.get("jit.host.dispatches") != 1
            or steady_moved.get("jit.steps") != K
            or steady_moved.get("optimizer.steps") != K
            or steady_moved.get("jit.fused_windows") != 1
            or timed_moved.get("jit.host.dispatches") != n_win
            or timed_moved.get("jit.steps") != n_win * K):
        raise AssertionError(f"train_fused: dispatches != steps / {K}: "
                             f"{steady_moved} {timed_moved}")
    if steady_launches != want or timed_launches != {
            name: c * n_win for name, c in want.items()}:
        raise AssertionError(f"train_fused: launches a replay "
                             f"{steady_launches} / {timed_launches}, want "
                             f"{want} a window")
    # the wrappers' counts of a replay are what its capture recorded; the
    # trace shows what the device ran
    if any(r != want for r in ran.values()):
        raise AssertionError(f"train_fused: the trace shows K1-K3 run "
                             f"{ran}, want {want} a window of {K} steps "
                             f"(events on any device: {any_device})")
    if moved4[0][0].get("jit.fused_fallback_steps") != K \
            or moved4[3][0].get("jit.fused_fallback_steps") != n - 3 * K:
        raise AssertionError(f"train_fused: priming/tail fallbacks "
                             f"{moved4[0][0]} {moved4[3][0]}")
    return record


def _fresh_masks_check():
    """Dropout 0.1 at 2 layers, lr 0, one batch repeated over the window:
    the parameters never move, so the losses differ only by their masks.
    Each step of a replayed window, and each replay, must draw anew."""
    cfg = _fused_cfg(num_layers=2, dropout=0.1)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    crit = GPTPretrainingCriterion()
    step = CompiledTrainStep(model, lambda m, x, y: crit(m(x), y),
                             AdamW(0.0, parameters=model.parameters()),
                             fused_steps=FUSED_K)
    ids, labels = _batch(cfg, FUSED_B, TRAIN_S, seed=6)
    win = Window((ids.expand(FUSED_K, -1, -1), labels.expand(
        FUSED_K, -1, -1)), FUSED_K)
    windows = [step(win).tolist() for _ in range(3)]  # priming, 2 replays
    flat = [x for w in windows for x in w]
    out = {"layers": 2, "dropout": 0.1, "losses": windows,
           "distinct": len(set(flat)), "of": len(flat)}
    if len(set(flat)) != len(flat):
        raise AssertionError(f"train_fused: dropout masks repeat {out}")
    return out


def _step_count_optimizers_check():
    """NAdam and RAdam read their step count from a device tensor, so a
    captured window replays their bias corrections step by step: at 2
    layers, a priming window, a captured and a replayed one against 12
    single steps, bit for bit."""
    cfg = _fused_cfg(num_layers=2)
    ids, labels = _batch(cfg, 3 * FUSED_K * 2, 256, seed=8)
    ids, labels = (t.view(3 * FUSED_K, 2, 256) for t in (ids, labels))
    crit = GPTPretrainingCriterion()
    out = {}
    for name in ("NAdam", "RAdam"):
        runs = []
        for k in (FUSED_K, 1):
            model = GPTForCausalLM(cfg, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
            opt = getattr(optim, name)(1e-3, parameters=model.parameters())
            step = CompiledTrainStep(model, lambda m, x, y: crit(m(x), y),
                                     opt, fused_steps=k)
            losses = torch.cat([step(ids[lo:lo + k], labels[lo:lo + k])
                                if k > 1 else step(ids[lo], labels[lo])[None]
                                for lo in range(0, 3 * FUSED_K, k)])
            runs.append((losses, [p.detach().clone()
                                  for p in torch.nn.Module.parameters(model)]))
        (l4, p4), (l1, p1) = runs
        out[name] = {"losses": torch.equal(l4, l1),
                     "params": all(torch.equal(a, b)
                                   for a, b in zip(p4, p1))}
    if not all(v for r in out.values() for v in r.values()):
        raise AssertionError(f"train_fused: NAdam/RAdam windows against "
                             f"single steps {out}")
    return out


# ---------------------------------------------------------------------------
# Checkpointed, fault-tolerant training fed by the input pipeline
# ---------------------------------------------------------------------------
#: ckpt_resume: steps, save interval, rows of the token dataset (one
#: epoch of batches of FUSED_B), the injected faults of run B (a
#: transient write error at the step-8 save, a preemption after step 8, a
#: loader fault at step 13) and run C's crash (the third save)
CKPT_STEPS, CKPT_SAVE_EVERY = 24, 8
CKPT_FAULTS = "ckpt_write@1;preempt@8;loader@13"
CKPT_CRASH = "ckpt_crash@2"
#: ckpt_overhead (bench.py's ckpt leg, :2044): 16 steps in windows of 4,
#: an async save every 2 windows
CKPT_ITERS, CKPT_SAVE_WINDOWS = 16, 2


class _TokenRows(paddle.io.Dataset):
    """``n`` rows of ``S + 1`` tokens from a seeded numpy generator;
    item i is (ids, labels) = (row[:-1], row[1:])."""

    def __init__(self, n, S, vocab, seed):
        rng = np.random.default_rng(seed)
        self.rows = rng.integers(0, vocab, (n, S + 1), dtype=np.int64)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i, :-1], self.rows[i, 1:]


def _numpy_collate(items):
    """Stacks on the host as numpy, so the prefetcher's pinned copies to
    the card are on the path."""
    return tuple(np.stack(col) for col in zip(*items))


def _ckpt_bytes(model, opt_tensors=3):
    """One checkpoint's array bytes for AdamW with fp32 masters: the
    parameters, then a master and two moments a parameter in fp32 (the
    beta powers, lr and generator states are a few bytes)."""
    params = list(torch.nn.Module.parameters(model))
    return sum(p.numel() * (p.element_size() + 4 * opt_tensors)
               for p in params)


def _disk_check(root, need, phase):
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"{phase}: {free} bytes free under {root}, the "
                             f"phase needs {need} (four checkpoints)")
    return free


def _timed_manager(mgr):
    """Time each snapshot, disk write and restore of ``mgr`` (instance
    wrappers; the writes run on the writer thread)."""
    times = {"snapshot_ms": [], "write_ms": [], "restore_ms": []}
    for name, key in (("_snapshot", "snapshot_ms"), ("_write", "write_ms"),
                      ("restore", "restore_ms")):
        fn = getattr(mgr, name)

        def timed(*a, _fn=fn, _key=key, **kw):
            t = time.perf_counter()
            out = _fn(*a, **kw)
            times[_key].append((time.perf_counter() - t) * 1e3)
            return out
        setattr(mgr, name, timed)
    return times


def _p50_p99(xs):
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99)), "n": len(xs)}
            if xs else None)


def _train_state(model, opt):
    """Copies of everything a resumed run must reproduce: parameters,
    masters, accumulators, the step count, the lr tensors and every
    generator's state."""
    from paddle_tpu_torch.tensor import random as prandom
    return {"params": [p.detach().clone()
                       for p in torch.nn.Module.parameters(model)],
            "masters": {i: t.clone()
                        for i, t in opt._master_weights.items()},
            "accs": {(a, i): t.clone() for a, s in opt._accumulators.items()
                     for i, t in s.items()},
            "step": opt._step_count,
            "lr": [t.clone() for t in opt._lr_tensors],
            "gens": [model.dropout_generator.get_state(),
                     *prandom._states().values()]}


def _same_train_state(a, b, ids_a, ids_b):
    """``a`` and ``b`` bit-equal; masters and accumulators are matched by
    parameter position (``ids_*``: parameter ids in order)."""
    pos_a = {pid: i for i, pid in enumerate(ids_a)}
    pos_b = {pid: i for i, pid in enumerate(ids_b)}
    ma = {pos_a[i]: t for i, t in a["masters"].items()}
    mb = {pos_b[i]: t for i, t in b["masters"].items()}
    aa = {(n, pos_a[i]): t for (n, i), t in a["accs"].items()}
    ab = {(n, pos_b[i]): t for (n, i), t in b["accs"].items()}
    return {
        "params": all(torch.equal(x, y)
                      for x, y in zip(a["params"], b["params"])),
        "masters": ma.keys() == mb.keys() and all(
            torch.equal(ma[k], mb[k]) for k in ma),
        "accumulators": aa.keys() == ab.keys() and all(
            torch.equal(aa[k], ab[k]) for k in aa),
        "step": a["step"] == b["step"],
        "lr": all(torch.equal(x, y) for x, y in zip(a["lr"], b["lr"])),
        "generators": len(a["gens"]) == len(b["gens"]) and all(
            torch.equal(x, y) for x, y in zip(a["gens"], b["gens"]))}


def _ckpt_run(cfg, ds, root, schedule=None, weights_seed=0,
              before_run=None):
    """One ``FaultTolerantTrainer`` run of :func:`_loop` (125M, K = 4,
    the config's dropout) over ``ds`` under the fault ``schedule``, with
    an async ``CheckpointManager(root, keep_last=2)``.  Returns a record
    (losses, recoveries, counter delta, K1–K3 launches, the manager's
    timings, the goodput report, what escaped ``run()``) and the trainer,
    model and optimizer."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             FaultTolerantTrainer)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(
                               weights_seed))
    sched, opt, step = _loop(model, "gpt3_125m", k=FUSED_K)
    if before_run is not None:
        before_run(model)
    mgr = CheckpointManager(root, keep_last=2, async_save=True)
    times = _timed_manager(mgr)
    trainer = FaultTolerantTrainer(
        step, lambda epoch: DataLoader(ds, batch_size=FUSED_B,
                                       num_workers=2,
                                       collate_fn=_numpy_collate),
        mgr, scheduler=sched, max_steps=CKPT_STEPS,
        save_every=CKPT_SAVE_EVERY)
    _reset_flash_counts()
    before = counters.snapshot()
    escaped = None
    with (faultinject.fault_schedule(schedule) if schedule
          else contextlib.nullcontext()):
        try:
            trainer.run()
        except faultinject.SimulatedCrash as e:
            escaped = e
    torch.cuda.synchronize()
    moved = counters.delta(before)
    record = {"losses": dict(trainer.losses),
              "recoveries": trainer.recoveries,
              "moved": {k: v for k, v in moved.items() if k.startswith(
                  ("resilience.", "io.", "jit.", "optimizer."))},
              "launches": _flash_counts(), "times": times,
              "goodput": trainer.goodput.report(),
              "escaped": None if escaped is None else repr(escaped)}
    return record, trainer, model, opt


def _flip_chunk_byte(step_dir, prefix="model/"):
    """Flip one payload byte of the first ``prefix`` chunk of a save's
    npz in place: the archive keeps its layout and the bytes are wrong,
    as on a bad disk.  Returns the chunk's key."""
    import zipfile
    fname = next(n for n in os.listdir(step_dir)
                 if n.endswith(".distcp.npz"))
    fpath = os.path.join(step_dir, fname)
    with zipfile.ZipFile(fpath) as z:
        info = next(i for i in z.infolist() if i.filename.startswith(prefix))
    with open(fpath, "r+b") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        name_len = int.from_bytes(local[26:28], "little")
        extra_len = int.from_bytes(local[28:30], "little")
        # past the member's .npy header, inside the tensor's bytes
        at = info.header_offset + 30 + name_len + extra_len + 4096
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))
    return info.filename[:-len(".npy")]


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))


def _tmp_dirs(d):
    return sorted(n for n in os.listdir(d) if n.startswith(".tmp-"))


def ckpt_resume_phase():
    """GPT-3 125M bf16 at full width and ``CKPT_LAYERS`` layers, dropout
    0.1, batch 16 x 1024, ``_loop(k=4)``, fed by ``DataLoader(num_workers=2)`` (numpy
    batches) through a ``StackingPrefetcher`` and driven by
    ``FaultTolerantTrainer`` with an async ``CheckpointManager(keep_last=
    2)``, 24 steps, a save every 8: (A) uninterrupted; (B) a transient
    write error, a preemption and a loader fault; (C) a crash in the
    third save, then a fresh model (other weights), optimizer, step,
    manager and trainer over the same directory.  B's and C's losses and
    final state must be bit-equal to A's; then a byte flipped in A's
    newest save makes a restore fall back to the older save."""
    import tempfile
    from paddle_tpu_torch.resilience import CheckpointManager
    cfg = _fused_cfg(num_layers=CKPT_LAYERS, dropout=0.1)
    ds = _TokenRows(CKPT_STEPS * FUSED_B, TRAIN_S, cfg.vocab_size, seed=15)
    root = tempfile.mkdtemp(prefix="ckpt_resume_")
    disk = {}

    def check_disk(model):
        disk["ckpt_bytes_estimate"] = _ckpt_bytes(model)
        disk["free"] = _disk_check(root, 4 * disk["ckpt_bytes_estimate"],
                                   "ckpt_resume")
    try:
        runs, states = {}, {}

        def keep(tag, rec, model, opt):
            runs[tag] = rec
            states[tag] = (_train_state(model, opt),
                           [id(p) for p in opt._parameter_list])

        t0 = time.perf_counter()
        rec, trainer_a, model, opt = _ckpt_run(
            cfg, ds, os.path.join(root, "A"), before_run=check_disk)
        keep("A", rec, model, opt)
        disk["ckpt_bytes"] = _dir_bytes(
            trainer_a.manager._dir(trainer_a.manager.latest()))
        del model, opt
        rec, trainer, model, opt = _ckpt_run(cfg, ds, os.path.join(root, "B"),
                                             CKPT_FAULTS)
        keep("B", rec, model, opt)
        del trainer, model, opt
        _free_cuda()
        c_dir = os.path.join(root, "C")
        rec, trainer, model, opt = _ckpt_run(cfg, ds, c_dir, CKPT_CRASH)
        rec["tmp_after_crash"] = _tmp_dirs(c_dir)
        rec["latest_after_crash"] = trainer.manager.latest()
        runs["C_crash"] = rec
        del trainer, model, opt
        _free_cuda()
        rec, trainer, model, opt = _ckpt_run(cfg, ds, c_dir, weights_seed=1)
        rec["tmp_after_restart"] = _tmp_dirs(c_dir)
        keep("C_restart", rec, model, opt)
        del trainer, model, opt
        _free_cuda()
        # a byte flipped in A's newest save: the restore falls back
        mgr = CheckpointManager(os.path.join(root, "A"), keep_last=2)
        newest = mgr.latest()
        victim = _flip_chunk_byte(mgr._dir(newest))
        before = counters.snapshot()
        info = mgr.restore(trainer_a.step)
        fallback = {"newest": newest, "flipped_chunk": victim,
                    "restored_step": info["step"],
                    "moved": {k: v for k, v in counters.delta(before).items()
                              if k.startswith("resilience.")}}
        run_s = time.perf_counter() - t0
        del trainer_a
        _free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _ckpt_resume_gates(cfg, runs, states, disk, fallback, run_s)


def _ckpt_resume_gates(cfg, runs, states, disk, fallback, run_s):
    per = _flash_per_layer_step(cfg.recompute)
    L = cfg.num_layers
    a_losses = runs["A"]["losses"]
    merged_c = {**runs["C_crash"]["losses"], **runs["C_restart"]["losses"]}
    same = {tag: _same_train_state(states["A"][0], states[tag][0],
                                   states["A"][1], states[tag][1])
            for tag in ("B", "C_restart")}
    launches_ok = {}
    for tag, rec in runs.items():
        steps = rec["moved"].get("jit.steps", 0)
        want = {n: c * L * steps for n, c in per.items()}
        launches_ok[tag] = rec["launches"] == want
        rec["launches_want"] = want
    times = {k: [x for rec in runs.values() for x in rec["times"][k]]
             for k in ("snapshot_ms", "write_ms", "restore_ms")}
    record = {
        "phase": "ckpt_resume", "card": CARD,
        "model": "gpt3_125m bf16 selective, dropout 0.1", "layers": L,
        "batch": [FUSED_B, TRAIN_S], "fused_steps": FUSED_K,
        "steps": CKPT_STEPS, "save_every": CKPT_SAVE_EVERY,
        "faults_B": CKPT_FAULTS, "crash_C": CKPT_CRASH,
        "checkpoint_bytes": disk["ckpt_bytes"],
        "checkpoint_bytes_estimate": disk["ckpt_bytes_estimate"],
        "disk_free_bytes": disk["free"],
        "snapshot_ms": _p50_p99(times["snapshot_ms"]),
        "write_ms": _p50_p99(times["write_ms"]),
        "restore_ms": _p50_p99(times["restore_ms"]),
        "losses_A": [a_losses[s] for s in sorted(a_losses)],
        "losses_equal": {"B": runs["B"]["losses"] == a_losses,
                         "C": merged_c == a_losses},
        "state_equal": same, "launches_ok": launches_ok,
        "fallback": fallback, "run_s": run_s,
        "runs": {tag: {k: v for k, v in rec.items()
                       if k not in ("losses", "times")}
                 for tag, rec in runs.items()}}
    emit(record)
    if sorted(a_losses) != list(range(1, CKPT_STEPS + 1)) or not all(
            math.isfinite(v) for v in a_losses.values()) \
            or runs["A"]["recoveries"] or runs["A"]["escaped"]:
        raise AssertionError(f"ckpt_resume: run A {runs['A']}")
    if not all(record["losses_equal"].values()):
        raise AssertionError(f"ckpt_resume: losses differ from A's: "
                             f"{record['losses_equal']}")
    if not all(v for r in same.values() for v in r.values()):
        raise AssertionError(f"ckpt_resume: final state differs from A's: "
                             f"{same}")
    b = runs["B"]
    if b["recoveries"] != 2 or b["moved"].get("resilience.retries", 0) < 1 \
            or b["escaped"]:
        raise AssertionError(f"ckpt_resume: run B recoveries "
                             f"{b['recoveries']}, moved {b['moved']}")
    c = runs["C_crash"]
    if ("SimulatedCrash" not in str(c["escaped"])
            or c["tmp_after_crash"] != [".tmp-step-00000016"]
            or c["latest_after_crash"] != CKPT_SAVE_EVERY
            or runs["C_restart"]["tmp_after_restart"]
            or sorted(runs["C_restart"]["losses"])
            != list(range(CKPT_SAVE_EVERY + 1, CKPT_STEPS + 1))):
        raise AssertionError(f"ckpt_resume: run C {c} / "
                             f"{runs['C_restart']}")
    if fallback["restored_step"] >= fallback["newest"] \
            or fallback["moved"].get("resilience.corrupt_detected", 0) < 1:
        raise AssertionError(f"ckpt_resume: corrupt fallback {fallback}")
    accounted = {tag: rec["goodput"]["accounted"]
                 for tag, rec in runs.items()}
    if min(accounted.values()) < 0.99:
        raise AssertionError(f"ckpt_resume: goodput accounted {accounted}")
    if not all(launches_ok.values()):
        got = {t: (r["launches"], r["launches_want"])
               for t, r in runs.items()}
        raise AssertionError(f"ckpt_resume: K1-K3 launches (got, want) "
                             f"{got}")
    return {n: sum(rec["launches"][n] for rec in runs.values())
            for n in per}


def ckpt_overhead_phase():
    """``bench.py``'s ckpt leg (``_run_ckpt_leg``, run at ``:2044``):
    GPT-3 125M bf16 selective, batch 16 x 1024, ``AdamW(1e-4)``, 16 steps
    in windows of 4 (one repeated window), bare and then with an async
    ``CheckpointManager`` save every 2 windows; one ``jit.syncs`` a save
    and no recapture.  Then where one save's time goes: the snapshot,
    crc32 of every chunk, ``np.savez`` and fsync, timed apart."""
    import tempfile
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.resilience import CheckpointManager
    cfg = _fused_cfg()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-4, parameters=torch.nn.Module.parameters(model))
    step = CompiledTrainStep(model, lambda m, x, y: crit(m(x), y), opt,
                             fused_steps=FUSED_K)
    ids, labels = _batch(cfg, FUSED_B, TRAIN_S, seed=16)
    win = Window((ids.expand(FUSED_K, -1, -1).contiguous(),
                  labels.expand(FUSED_K, -1, -1).contiguous()), FUSED_K)
    step(win)
    step(win).cpu()           # priming, then the capture
    n_windows = max(CKPT_SAVE_WINDOWS, CKPT_ITERS // FUSED_K)
    _reset_flash_counts()
    t0 = time.perf_counter()
    for _ in range(n_windows):
        loss = step(win)
    loss.cpu()
    base_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="ckpt_overhead_")
    try:
        _disk_check(root, 4 * _ckpt_bytes(model), "ckpt_overhead")
        mgr = CheckpointManager(root, keep_last=2, async_save=True)
        times = _timed_manager(mgr)
        before = counters.snapshot()
        t0 = time.perf_counter()
        gs = 0
        for i in range(n_windows):
            loss = step(win)
            gs += FUSED_K
            if (i + 1) % CKPT_SAVE_WINDOWS == 0:
                mgr.save(step, gs, blocking=False)
        loss.cpu()
        mgr.wait()
        ckpt_s = time.perf_counter() - t0
        moved = counters.delta(before)
        launches = _flash_counts()
        # one save's parts, timed apart on this state
        t = time.perf_counter()
        arrays, _ = mgr._snapshot(step, gs, None, None)
        parts = {"snapshot_ms": (time.perf_counter() - t) * 1e3}
        # the arrays the save writes: a tensor's bytes, a rank's own
        # streams (ShardChunks) chunk by chunk, the JAX keys as they are
        host = {}
        for k, v in arrays.items():
            if isinstance(v, dck.ShardChunks):
                host.update((f"{k}##{i}", dck.to_numpy(c))
                            for i, (_, _, c) in enumerate(v.chunks))
            else:
                host[k] = v if isinstance(v, np.ndarray) else \
                    dck.to_numpy(v)
        t = time.perf_counter()
        for v in host.values():
            dck._crc32(v)
        parts["crc32_ms"] = (time.perf_counter() - t) * 1e3
        path = os.path.join(root, "parts.npz")
        with open(path, "wb") as f:
            t = time.perf_counter()
            np.savez(f, **host)
            f.flush()
            parts["npz_write_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            os.fsync(f.fileno())
            parts["fsync_ms"] = (time.perf_counter() - t) * 1e3
        parts["bytes"] = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    saves = moved.get("resilience.saves", 0)
    tokens = FUSED_B * TRAIN_S * FUSED_K * n_windows
    record = {
        "phase": "ckpt_overhead", "card": CARD,
        "model": "gpt3_125m bf16 selective", "batch": [FUSED_B, TRAIN_S],
        "fused_steps": FUSED_K, "windows": n_windows, "async_saves": saves,
        "tokens_per_s": tokens / ckpt_s, "bare_tokens_per_s": tokens / base_s,
        "ckpt_overhead_frac": max(0.0, ckpt_s / base_s - 1.0),
        "bare_s": base_s, "ckpt_s": ckpt_s,
        "save_ms": _p50_p99(times["write_ms"]),
        "snapshot_ms": _p50_p99(times["snapshot_ms"]),
        "one_save_parts": parts,
        "syncs": moved.get("jit.syncs", 0),
        "captures": moved.get("jit.captures", 0), "launches": launches,
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("jit.", "resilience."))}}
    emit(record)
    if record["syncs"] != saves or saves != n_windows // CKPT_SAVE_WINDOWS \
            or record["captures"]:
        raise AssertionError(f"ckpt_overhead: {saves} saves, "
                             f"{record['syncs']} syncs, "
                             f"{record['captures']} captures")
    want = {n: c * cfg.num_layers * FUSED_K * 2 * n_windows
            for n, c in _flash_per_layer_step(cfg.recompute).items()}
    if launches != want:
        raise AssertionError(f"ckpt_overhead: K1-K3 launches {launches}, "
                             f"want {want}")
    del step, model, opt
    return launches


def scaler_skip_phase():
    """GPT-3 125M width at 4 layers, bf16, a ``GradScaler(2**16)`` and a
    per-step loss weight of 2**120 at train steps 6 and 12 (index 1 of
    the first fused window, index 3 of the second), so that their scaled
    gradients overflow; the fused run (K = 4) against single steps, bit
    for bit.  Each overflow step leaves the parameters and the optimizer
    state bit-equal to before (the single run, around each; the fused
    run, whose state after its second window must equal the single run's
    before step 12), the scale halves each time, and the steps between
    update the model.  Then, without a scaler, a NaN loss weight at index
    2 of a fused window (that loop's train step 7) under
    ``FLAGS_check_nan_inf``."""
    cfg = _fused_cfg(num_layers=4)
    K = FUSED_K
    n, bad = 3 * K, (K + 1, 3 * K - 1)
    ids, labels = _batch(cfg, n * FUSED_B, TRAIN_S, seed=7)
    ids, labels = (t.view(n, FUSED_B, TRAIN_S) for t in (ids, labels))
    weight = torch.ones(n, device="cuda")
    weight[list(bad)] = 2.0 ** 120
    crit = GPTPretrainingCriterion()

    def loss_fn(m, x, y, w):
        return crit(m(x), y) * w

    runs, before, after = {}, {}, {}
    for k in (K, 1):
        model = GPTForCausalLM(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        scaler = GradScaler(init_loss_scaling=2.0 ** 16,
                            incr_every_n_steps=1000)
        sched, opt, step = _loop(model, "gpt3_125m", k=k, scaler=scaler,
                                 loss_fn=loss_fn)
        args = (ids, labels, weight)
        losses = []
        for lo in range(0, n, k):
            watch = k == 1 and lo in bad
            if watch:
                before[lo] = _snapshot(model, opt)
            losses.append(step(*(a[lo:lo + k] if k > 1 else a[lo]
                                 for a in args)).reshape(-1))
            if watch:
                after[lo] = _snapshot(model, opt)
            for _ in range(k):
                sched.step()
        step.sync()
        runs[k] = (model, opt, scaler, torch.cat(losses), step.metrics)
    (m4, o4, sc4, l4, met4), (m1, o1, sc1, l1, met1) = runs[K], runs[1]
    fused_end = _snapshot(m4, o4)
    skips = [v for _, v in met4.series("scaler_skip")]
    scales = [v for _, v in met4.series("scaler_scale")]
    same = {"losses": torch.equal(l4, l1),
            "params_and_optimizer_state": _same_state(fused_end,
                                                      _snapshot(m1, o1)),
            "step": o4._step_count == o1._step_count == n,
            "scaler": sc4.state_dict() == sc1.state_dict(),
            "series": skips == [v for _, v in met1.series("scaler_skip")]}
    unchanged = {
        "single_run_around_each": all(_same_state(before[b], after[b])
                                      for b in bad),
        "fused_window_ending_on_one": _same_state(fused_end,
                                                  before[bad[1]])}
    later_moved = not _same_state(after[bad[0]], before[bad[1]])
    del runs, m1, o1, sc1, before, after
    _free_cuda()

    # FLAGS_check_nan_inf on a window, without a scaler (which would
    # treat the NaN as an overflow to skip)
    nan_w = torch.ones(n, device="cuda")
    nan_w[K + 2] = float("nan")
    _, _, check_step = _loop(m4, "gpt3_125m", k=K, loss_fn=loss_fn,
                             metrics=False)
    check_step(ids[:K], labels[:K], nan_w[:K])
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        check_step(ids[K:2 * K], labels[K:2 * K], nan_w[K:2 * K])
        named = None
    except FloatingPointError as e:
        named = str(e)
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    want_where = f"train step {2 * K - 1} (step 2 of a {K}-step fused window)"
    record = {"phase": "scaler_skip", "card": CARD, "layers": cfg.num_layers,
              "batch": [FUSED_B, TRAIN_S], "fused_steps": K,
              "overflow_steps": [b + 1 for b in bad], "skips": skips,
              "scales": scales, "bit_identical": same,
              "overflow_steps_left_state_unchanged": unchanged,
              "later_steps_moved_params": later_moved,
              "nan_inf_message": None if named is None else named[:160]}
    emit(record)
    if not all(same.values()):
        raise AssertionError(f"scaler_skip: K={K} against K=1: {same}")
    if skips != [float(i in bad) for i in range(n)]:
        raise AssertionError(f"scaler_skip: skips {skips}")
    if not (scales[bad[0]] == scales[bad[0] - 1] / 2 == 2.0 ** 15
            and scales[bad[1]] == scales[bad[1] - 1] / 2 == 2.0 ** 14):
        raise AssertionError(f"scaler_skip: scales {scales}")
    if not (all(unchanged.values()) and later_moved):
        raise AssertionError(f"scaler_skip: state unchanged {unchanged}, "
                             f"later steps moved {later_moved}")
    if named is None or want_where not in named:
        raise AssertionError(f"scaler_skip: FLAGS_check_nan_inf raised "
                             f"{named!r}, want {want_where!r}")
    return record


# ---------------------------------------------------------------------------
# BERT-large pretraining on the paddle-style surface
# ---------------------------------------------------------------------------
def _bert_batch(cfg, B, S, seed):
    """Random ids, MLM labels on 15 % of the positions (-100 elsewhere)
    and NSP labels, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        device="cuda")
    pick = torch.rand((B, S), generator=gen, device="cuda") < 0.15
    labels = torch.where(pick, torch.randint(0, cfg.vocab_size, (B, S),
                                             generator=gen, device="cuda"),
                         -100)
    nsp = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    return ids, labels, nsp


def _bert_loss(model, crit, batch, level="O2", dtype="bfloat16"):
    """The forward of Paddle's dygraph AMP loop: the loss of ``batch``
    under ``auto_cast``."""
    ids, labels, nsp = batch
    with paddle.amp.auto_cast(enable=level != "O0",
                              level="O1" if level == "O0" else level,
                              dtype=dtype):
        logits, seq_rel = model(ids)
        return crit(logits, seq_rel, labels, nsp)


def _bert_step(model, crit, opt, batch):
    """``loss.backward(); opt.step(); opt.clear_grad()`` at O2 bf16."""
    loss = _bert_loss(model, crit, batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def bert_train_phase():
    """This slice's main path: BERT-large (24 layers, hidden 1024, 16
    heads of 64, intermediate 4096, vocab 30522), random weights from
    ``paddle.seed(0)``, hidden dropout 0.1, no attention dropout,
    recompute over the encoder layers, ``amp.decorate`` O2 bf16,
    ``AdamW(1e-4, weight_decay=0.01)`` with fp32 masters and
    ``ClipGradByGlobalNorm(1.0)``; batch 16 x 512, 2 warm-up and 8 timed
    steps on one repeated batch."""
    paddle.seed(0)
    cfg = BertConfig.bert_large(attention_probs_dropout_prob=0.0,
                                recompute=True)
    t0 = time.perf_counter()
    model = BertForPretraining(cfg)
    crit = BertPretrainingCriterion()
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _bert_batch(cfg, BERT_B, BERT_S, seed=4)
    n_params = sum(p.numel() for p in torch.nn.Module.parameters(model))
    torch.cuda.reset_peak_memory_stats()

    # -- the counted main-path run ------------------------------------------
    _reset_flash_counts()
    before = counters.snapshot()
    losses, step_s, enqueue_s = [], [], []
    for i in range(WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        loss = _bert_step(model, crit, opt, batch)
        queued = time.perf_counter()
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_s.append(time.perf_counter() - t)
            enqueue_s.append(queued - t)
        losses.append(float(loss))
    launches = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    moved = counters.delta(before)
    peak = torch.cuda.max_memory_allocated()

    steps, L = WARMUP + TRAIN_STEPS, cfg.num_hidden_layers
    # recompute replays every layer's forward, K1 with it
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bert_train: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bert_train: loss did not fall: {losses}")
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"bert_train: {name} launched {n} times, "
                                 f"want {per_step[name]} x {steps} steps")
    if moved.get("optimizer.steps") != steps or moved.get(
            "kernels.flash.reference_fallbacks", 0):
        raise AssertionError(f"bert_train: counters {moved}")

    # one more step under the profiler, for the record and for the gate:
    # its trace must show the kernels the counters (set to 0 just before)
    # say were launched
    _reset_flash_counts()
    prof = _profile(lambda: _bert_step(model, crit, opt, batch), top=15)
    traced = prof["flash_kernels_run"]
    counted = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    if traced != per_step or counted != per_step:
        raise AssertionError(
            f"bert_train: one step ran {traced} in the trace and "
            f"{counted} by the counters, want {per_step} (the trace kept "
            f"{prof['preroll_kernels_kept']} of its pre-roll kernels)")
    p50 = float(np.median(step_s))
    tokens = BERT_B * BERT_S
    record = {
        "phase": "bert_train", "model": "bert_large O2 bf16, recompute",
        "card": CARD, "layers": L, "params": n_params,
        "batch": [BERT_B, BERT_S], "init_s": init_s, "steps": steps,
        "warmup": WARMUP, "losses": losses, "step_ms_p50": p50 * 1e3,
        "step_ms": [x * 1e3 for x in step_s], "tokens_per_s": tokens / p50,
        # the host's time to enqueue a step (nothing in it waits for the
        # device): a step whose enqueue is most of its wall is host-bound
        "host_enqueue_ms_p50": float(np.median(enqueue_s)) * 1e3,
        # the profiled step's device time over the unprofiled step's wall
        "device_busy_share_of_p50": prof["device_us"] / 1e3 / (p50 * 1e3),
        "model_flops_share_of_bf16_peak": 6 * n_params * tokens / p50
        / BF16_FLOPS,
        "peak_mem_gb": peak / 1e9, "launches": launches,
        "launches_per_step": per_step,
        "profiled_step": prof,
        "counters": {k: v for k, v in moved.items()
                     if k.startswith(("optimizer.", "kernels."))}}
    emit(record)
    return record


def _bert_grads(model, crit, batch, level, dtype, scaler=None):
    """Loss and every gradient (fp32, unscaled) of one forward and
    backward; the gradients are cleared after."""
    loss = _bert_loss(model, crit, batch, level, dtype)
    (loss if scaler is None else scaler.scale(loss)).backward()
    inv = 1.0 if scaler is None else 1.0 / float(scaler.get_loss_scaling())
    grads = {n: p.grad._data.float() * inv
             for n, p in model.named_parameters() if p.grad is not None}
    model.clear_gradients()
    return loss, grads


class _plain_attention:
    """Inside: the encoder's attention runs K1–K3's plain versions on the
    card instead of the kernels (same route, same AMP casts)."""

    def __enter__(self):
        self._fn = nnfa.flash_attention_fwd
        nnfa.flash_attention_fwd = (
            lambda q, k, v, causal=False, scale=None:
            fa.flash_attention_fwd(q, k, v, causal, scale, kernel=False))

    def __exit__(self, *exc):
        nnfa.flash_attention_fwd = self._fn


#: floor of bert_in_model's self-calibrated check, as a share of each
#: gradient's fp32 scale.  The fp32 kernels and plain versions differ by
#: reordered fp32 sums, which the backward carries into every gradient
#: (sums over up to 8192 positions): 1.6e-5 of a gradient's scale on an
#: NVIDIA H100 80GB HBM3 at 700 W; a kernel that drops or misweights a
#: key tile moves gradients by far more.  The bf16/fp16 noise it is added
#: to is ~0.07 of the scale.
BERT_GRAD_FLOOR = 1e-4


def _scale_of(runs, n):
    """The fp32 scale a gradient is measured in: its own max, but the
    query bias' for a key bias, whose true gradient is 0 (it shifts a
    whole row of logits) and whose values are rounding noise."""
    ref = n.replace("k_proj.bias", "q_proj.bias")
    return max(float(runs["plain32"][ref].abs().max()), 1e-30)


def _as_one_row(runs, tag):
    """Every gradient (and the loss) of run ``tag``, each divided by its
    fp32 scale, flattened into one row: ``_self_calibrated``'s noise is
    then the whole model's, as a share of each tensor's scale (a tensor
    of 2 elements, like the NSP bias, is too few to estimate its own)."""
    return torch.cat([(runs[tag][n] / _scale_of(runs, n)).reshape(-1)
                      for n in runs["plain32"]])[None]


def bert_in_model_phase():
    """BERT-large's width at 2 layers (no dropout, batch 16 x 512): the
    loss and every gradient of one step through K1–K3 against the same
    step with the attention on their plain versions, each at O2 bf16 and
    at fp32 (the model before ``decorate``), held by
    ``_self_calibrated`` over all of them at once, each in units of its
    fp32 scale (``_as_one_row``).  Then the same at O2 fp16 with a
    ``GradScaler`` (the fp16 instances of K1–K3) against the fp32
    runs, and the scaler's step."""
    def build():
        paddle.seed(6)
        cfg = BertConfig.bert_large(num_hidden_layers=2,
                                    hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)
        return cfg, BertForPretraining(cfg)

    cfg, model = build()
    crit = BertPretrainingCriterion()
    batch = _bert_batch(cfg, BERT_B, BERT_S, seed=7)
    runs = {}

    def run(tag, level, dtype, plain, scaler=None):
        _reset_flash_counts()
        if plain:
            with _plain_attention():
                loss, g = _bert_grads(model, crit, batch, level, dtype,
                                      scaler)
        else:
            loss, g = _bert_grads(model, crit, batch, level, dtype, scaler)
        g["loss"] = loss._data.detach().float().reshape(1, 1)
        runs[tag] = g
        return {fn.__name__: fn.launches for fn in FLASH_KERNELS}

    want_k = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    want_p = dict.fromkeys(want_k, 0)
    counts = {"kernel32": run("kernel32", "O0", "bfloat16", False),
              "plain32": run("plain32", "O0", "bfloat16", True)}
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    counts["kernel16"] = run("kernel16", "O2", "bfloat16", False)
    counts["plain16"] = run("plain16", "O2", "bfloat16", True)
    _, model = build()      # the same weights again, for fp16
    scaler = GradScaler(init_loss_scaling=2.0 ** 7)
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="float16")
    counts["kernel_f16"] = run("kernel_f16", "O2", "float16", False, scaler)
    counts["plain_f16"] = run("plain_f16", "O2", "float16", True, scaler)
    # the fp16 step itself: scaled loss, unscale, AdamW
    loss = _bert_loss(model, crit, batch, "O2", "float16")
    scaler.scale(loss).backward()
    scaler.step(opt)
    opt.clear_grad()
    torch.cuda.synchronize()
    out = {"phase": "bert_in_model", "card": CARD, "layers": 2,
           "batch": [BERT_B, BERT_S], "launches": counts,
           "fp16_loss_scale": float(scaler.get_loss_scaling())}
    for low, a16, b16 in (("bf16", "kernel16", "plain16"),
                          ("fp16", "kernel_f16", "plain_f16")):
        r = _self_calibrated(f"bert_in_model {low}",
                             *(_as_one_row(runs, t) for t in
                               (a16, b16, "kernel32", "plain32")),
                             floor_share=BERT_GRAD_FLOOR)
        # per tensor, for the record: its kernel run's distance from the
        # plain fp32 run over twice the plain run's own bf16 noise
        noise = {n: float((runs[b16][n] - runs["plain32"][n]).abs().max())
                 for n in runs["plain32"]}
        worst = {n: float((runs[a16][n] - runs["plain32"][n]).abs().max())
                 / max(2 * noise[n], 1e-30) for n in noise}
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
        r.pop("argmax_agreement_bf16")     # one row: no argmax to agree on
        out[low] = {**r, "tensors": len(noise),
                    "per_tensor_worst": dict(top),
                    "loss_kernel": float(runs[a16]["loss"]),
                    "loss_plain": float(runs[b16]["loss"]),
                    "loss_fp32": float(runs["kernel32"]["loss"])}
    emit(out)
    for tag, c in counts.items():
        if c != (want_p if "plain" in tag else want_k):
            raise AssertionError(f"bert_in_model: {tag} launched {c}")
    if scaler._found_inf or not all(
            bool(torch.isfinite(p._data).all()) for p in model.parameters()):
        raise AssertionError("bert_in_model: the fp16 step overflowed")


@contextlib.contextmanager
def _flash_library(name):
    """Route the flash wrappers to ``csrc/<name>.cu`` whatever the kernel,
    head dim and dtype: to time an instance that a redesign took off the
    path beside the kernel that replaced it."""
    routed = fa._library
    fa._library = lambda D, dtype, kernel="fwd": name
    try:
        yield
    finally:
        fa._library = routed


#: a replaced route of :func:`_flash_shape_times`: fp16 K1–K3 on the
#: wrapper's rounded copies (dtype code 2), not a library
ROUNDING_COPIES = "rounding_copies"


def _replaced_route(name):
    """The context that routes the flash wrappers to a replaced instance:
    :data:`ROUNDING_COPIES` (:func:`_wrapper_rounding`), or the library
    ``csrc/<name>.cu`` (:func:`_flash_library`)."""
    if name == ROUNDING_COPIES:
        return _wrapper_rounding()
    return _flash_library(name)


def _flash_shape_times(B, H, S, D, causal, seed, dtype=torch.bfloat16,
                       replaced=(), dlse=False):
    """K1–K3 per launch at one shape (bf16, or fp16: the bf16 kernels on
    operands rounded to bf16, by the kernels in shared memory at D
    64/96/128 and by the wrapper's copies otherwise; q/k/v strided views
    of one projection output), in turns within this one call, beside the
    plain versions, the bounds and SDPA's flash backend in the same dtype
    (forward; backward against K2 + K3).  ``replaced``: ``(kernel,
    route)`` pairs whose replaced instance (:func:`_replaced_route`: a
    library, or the fp16 route on the wrapper's rounded copies) is timed
    in the same turns (``replaced_us``).  ``dlse``: K2/K3 take δ with a
    random LSE cotangent folded in (ring attention's chunk pairs).
    Returns ``{kernel: record}``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv_views(gen, B, S, H, D, dtype)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    sc = 1.0 / math.sqrt(D)
    out, lse = fa.flash_fwd(q, k, v, causal, sc)
    delta = fa._delta(out, do, torch.randn(
        B, H, S, generator=gen, device="cuda") if dlse else None)
    fns = {
        "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, causal, sc),
                      lambda i: fa._flash_fwd_reference(q, k, v, causal,
                                                        sc)),
        "flash_bwd_dq": (
            lambda i: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc),
            lambda i: fa._bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                           sc)),
        "flash_bwd_dkv": (
            lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc),
            lambda i: fa._bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                            sc)),
    }
    # the yardstick gets contiguous [B, H, S, D] copies of the same values
    ql, kl, vl = (t.contiguous().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                 is_causal=causal, scale=sc)

        def lib_fwd(i):
            with torch.no_grad():
                F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                               scale=sc)

        def lib_bwd(i):
            torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                retain_graph=True)

        def replaced_call(n, route):
            def call(i):
                with _replaced_route(route):
                    fns[n][0](i)
            return call

        olds = {n: replaced_call(n, lib_name) for n, lib_name in replaced}
        # in turns: plain, kernel, replaced, library, then again
        runs = {n: {"kernel": [], "plain": [],
                    **({"replaced": []} if n in olds else {})} for n in fns}
        lib_runs = {"fwd": [], "bwd": []}
        for rnd in range(2):
            for n, (kern, plain) in fns.items():
                runs[n]["plain"].append(_time_ms(plain, 5, warmup=1))
                runs[n]["kernel"].append(_time_ms(kern, 40))
                if n in olds:
                    runs[n]["replaced"].append(_time_ms(olds[n], 40))
            lib_runs["fwd"].append(_time_ms(lib_fwd, 40))
            lib_runs["bwd"].append(_time_ms(lib_bwd, 40))
        event_ms = {n: {k: float(np.mean(v)) for k, v in r.items()}
                    for n, r in runs.items()}
        lib_event_ms = {k: float(np.mean(v)) for k, v in lib_runs.items()}
        # then each one's device time
        ms = {n: {"kernel": _device_ms(kern, 10, event_ms[n]["kernel"]),
                  "plain": _device_ms(plain, 2, event_ms[n]["plain"])}
              for n, (kern, plain) in fns.items()}
        for n, call in olds.items():
            ms[n]["replaced"] = _device_ms(call, 10,
                                           event_ms[n]["replaced"])
        lib_ms = {k: _device_ms(f, 10, lib_event_ms[k])
                  for k, f in (("fwd", lib_fwd), ("bwd", lib_bwd))}

    # (q, k) pairs: all of them, or the causal half with its diagonal
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    elem = B * S * H * D                       # elements of one operand
    stats = B * H * S * 4                      # one fp32 [B, H, S] row
    work = {  # (flops, bytes): each input read once, each output written
        "flash_fwd": (4 * D * pairs, 4 * elem * 2 + stats),
        "flash_bwd_dq": (6 * D * pairs, 5 * elem * 2 + 2 * stats),
        "flash_bwd_dkv": (8 * D * pairs, 6 * elem * 2 + 2 * stats),
    }
    out = {}
    for n in fns:
        flops, nbytes = work[n]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        bound = max(bytes_ms, ops_ms)
        lib = lib_ms["fwd"] if n == "flash_fwd" else lib_ms["bwd"]
        out[n] = {
            "phase": "times", "kernel": n, "card": CARD,
            "shape": {"B": B, "S": S, "H": H, "D": D, "causal": causal,
                      "dtype": str(dtype).removeprefix("torch."),
                      **({"dlse": True} if dlse else {})},
            "kernel_us": ms[n]["kernel"] * 1e3,
            "plain_us": ms[n]["plain"] * 1e3, "library_us": lib * 1e3,
            "library": ("sdpa flash forward" if n == "flash_fwd" else
                        "sdpa flash backward (dQ, dK, dV: K2 + K3)"),
            "times": "device time per call (queued CUDA events)",
            "event_us": {k: v * 1e3 for k, v in event_ms[n].items()},
            "runs_ms": runs[n], "flops": flops, "bytes": nbytes,
            "bound_us": bound * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound / ms[n]["kernel"],
            "kernel_tflops": flops / (ms[n]["kernel"] * 1e-3) / 1e12}
        if n in olds:
            route = dict(replaced)[n]
            out[n].update(
                replaced_us=ms[n]["replaced"] * 1e3,
                replaced_source=(
                    f"{fa._library(D, dtype, FLASH_KIND[n])}.cu, dtype code "
                    "2 on the "
                    "wrapper's rounded copies" if route == ROUNDING_COPIES
                    else f"{route}.cu"),
                replaced_share_of_bound=bound / ms[n]["replaced"])
    emit({"phase": "times", "kernel": "flash_bwd_dq+flash_bwd_dkv",
          "card": CARD, "shape": out["flash_fwd"]["shape"],
          "kernel_us": (ms["flash_bwd_dq"]["kernel"]
                        + ms["flash_bwd_dkv"]["kernel"]) * 1e3,
          "library_us": lib_ms["bwd"] * 1e3,
          "library_event_us": {k: v * 1e3 for k, v in lib_event_ms.items()},
          "library_runs_ms": lib_runs})
    return out


def flash_times_phase(max_err, launches, bert_launches, gpt125m_launches):
    """K1–K3 per launch at the GPT training shape (B=8, S=1024, 16 heads
    of 96, causal) in bf16 and fp16 (gpt_dygraph_fp16's) and at
    BERT-large's (B=16, S=512, 16 heads of 64, no mask) in bf16 and
    fp16; in fp16, beside K1–K3 the route they replaced (dtype code 2 on
    the wrapper's rounded copies) in the same turns.  The
    ``kernels`` rows keep the training shape's numbers and the GPT train
    phase's launches, with BERT's (its launches from bert_train) and the
    fp16 numbers beside them, and GPT-3 125M's shape (16 x 1024, 12
    heads of 64, causal; flash_vs_plain holds the kernels to their plain
    versions there) timed alike, with its launches on the checkpointed
    training path (ckpt_resume's runs and ckpt_overhead)."""
    copies = (("flash_fwd", ROUNDING_COPIES),
              ("flash_bwd_dq", ROUNDING_COPIES),
              ("flash_bwd_dkv", ROUNDING_COPIES))
    train = _flash_shape_times(TRAIN_B, 16, TRAIN_S, 96, True, seed=9)
    train16 = _flash_shape_times(TRAIN_B, 16, TRAIN_S, 96, True, seed=12,
                                 dtype=torch.float16, replaced=copies)
    bert = _flash_shape_times(BERT_B, BERT_H, BERT_S, BERT_D, False,
                              seed=10)
    gpt125m = _flash_shape_times(FUSED_B, 12, TRAIN_S, 64, True, seed=13)
    bert16 = _flash_shape_times(BERT_B, BERT_H, BERT_S, BERT_D, False,
                                seed=11, dtype=torch.float16,
                                replaced=copies)
    replaces = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:116",
                "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:204",
                "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:243"}
    errs = {"flash_fwd": max(max_err["flash_fwd"], max_err["flash_fwd_lse"]),
            "flash_bwd_dq": max_err["flash_bwd_dq"],
            "flash_bwd_dkv": max_err["flash_bwd_dkv"]}
    rows = []
    for n, t in train.items():
        b, h, t16, g = bert[n], bert16[n], train16[n], gpt125m[n]
        emit(g)
        emit(t)
        emit(t16)
        emit(b)
        emit(h)
        # fp16 K1–K3: beside the route they replaced, timed in the same
        # turns; rounding in shared memory must beat the rounding copies
        replaced = {k: v["replaced_us"] / 1e3
                    for k, v in (("fp16_replaced_ms", h),
                                 ("gpt_fp16_replaced_ms", t16))
                    if "replaced_us" in v}
        for v in (h, t16):
            if "replaced_us" in v and v["kernel_us"] >= v["replaced_us"]:
                raise AssertionError(
                    f"flash_times: fp16 {n} {v['kernel_us']} us, not below "
                    f"the replaced route's {v['replaced_us']} us at "
                    f"{v['shape']}")
        rows.append({
            "name": n, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": replaces[n], "launches": launches[n],
            "max_abs_err": errs[n], "ms": t["kernel_us"] / 1e3,
            "plain_ms": t["plain_us"] / 1e3, "bound_ms": t["bound_us"] / 1e3,
            "bound_by": t["bound_by"], "library_ms": t["library_us"] / 1e3,
            "event_ms": t["event_us"]["kernel"] / 1e3,
            "library_covers": ("forward" if n == "flash_fwd"
                               else "the whole backward, K2 + K3"),
            "bert": {"launches": bert_launches[n],
                     "ms": b["kernel_us"] / 1e3,
                     "plain_ms": b["plain_us"] / 1e3,
                     "bound_ms": b["bound_us"] / 1e3,
                     "bound_by": b["bound_by"],
                     "library_ms": b["library_us"] / 1e3,
                     "fp16_ms": h["kernel_us"] / 1e3,
                     "fp16_plain_ms": h["plain_us"] / 1e3,
                     "fp16_library_ms": h["library_us"] / 1e3},
            "gpt125m": {"launches": gpt125m_launches[n],
                        "phases": "ckpt_resume + ckpt_overhead",
                        "ms": g["kernel_us"] / 1e3,
                        "plain_ms": g["plain_us"] / 1e3,
                        "bound_ms": g["bound_us"] / 1e3,
                        "bound_by": g["bound_by"],
                        "library_ms": g["library_us"] / 1e3},
            "gpt_fp16": {"ms": t16["kernel_us"] / 1e3,
                         "plain_ms": t16["plain_us"] / 1e3,
                         "bound_ms": t16["bound_us"] / 1e3,
                         "library_ms": t16["library_us"] / 1e3},
            **replaced})
    return rows


# ---------------------------------------------------------------------------
# CUDA prompts, fp16 serving, the dygraph GPT, head dims off the wgmma
# kernels, sparse embeddings, LBFGS
# ---------------------------------------------------------------------------
#: prompts (the engine phase's first) and new tokens of prompt_device
PROMPT_DEVICE_N, PROMPT_DEVICE_NEW = 4, 8


def prompt_device_phase(model, prompts):
    """ROADMAP C's fault, pinned on the card: the engine phase's first
    prompts as CUDA int64 tensors through the slot engine, the paged
    engine, the speculative engine (a random GPT-3 125M draft) and an
    unthreaded ``ServingFleet``; each must give the sequences the same
    prompts give as lists."""
    t0 = time.perf_counter()
    sub = [np.asarray(p) for p in prompts[:PROMPT_DEVICE_N]]
    on_card = [torch.as_tensor(p, dtype=torch.int64, device="cuda")
               for p in sub]
    draft = GPTForCausalLM(_draft_cfg(), device="cuda",
                           generator=torch.Generator().manual_seed(1))
    engines = {
        "slots": lambda: LLMEngine(model, max_slots=8, max_seq_len=1024),
        "paged": lambda: LLMEngine(model, **FLEET_ENGINE),
        "speculative": lambda: _spec_engine(model, draft),
        "fleet": lambda: ServingFleet(model, replicas=2, threaded=False,
                                      **FLEET_ENGINE)}
    tokens = {}
    for name, make in engines.items():
        runs = []
        for ps in ([p.tolist() for p in sub], on_card):
            eng = make()
            seqs = eng.generate(ps, max_new_tokens=PROMPT_DEVICE_NEW)
            eng.drain()
            runs.append([np.asarray(s).tolist() for s in seqs])
            del eng
        if runs[0] != runs[1]:
            raise AssertionError(f"prompt_device: {name} gave other tokens "
                                 "for CUDA tensor prompts than for lists")
        tokens[name] = sum(len(s) - len(p) for s, p in zip(runs[1], sub))
    del draft
    _free_cuda()
    emit({"phase": "prompt_device", "card": CARD,
          "prompts": PROMPT_DEVICE_N, "prompt_dtype": "torch.int64 on cuda",
          "new_tokens_by_engine": tokens,
          "tokens_equal_to_list_prompts": True,
          "seconds": time.perf_counter() - t0})


def serve_fp16_phase(prompts, bf16_tokens, max_err):
    """GPT-3 1.3B with ``dtype="float16"`` at full width and depth,
    random weights from seed 0, the engine phase's 16 requests through
    the paged engine (K4 over fp16 pools: launches == decode_steps x 24),
    with ``kv_dtype="int8", weight_dtype="int8"`` (K4q with fp16 queries)
    and through the slot engine (no paged launch); each paged run's
    in-model check holds K4/K4q to their plain versions on the live
    pools; greedy agreement with the bf16 engine is printed, not gated.
    Returns the K4 fp16 / K4q-int8 fp16-q rows of the ``kernels`` line."""
    cfg = GPTConfig.gpt3_1_3b(dtype="float16")
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    runs, snaps = {}, {}
    for phase, kw in (("serve_fp16", {}),
                      ("serve_fp16_int8", dict(kv_dtype="int8",
                                               weight_dtype="int8")),
                      ("serve_fp16_slots", None)):
        eng = (LLMEngine(model, max_slots=8, max_seq_len=1024) if kw is None
               else LLMEngine(model, **FLEET_ENGINE, **kw))
        eng.generate([np.arange(64) % cfg.vocab_size], max_new_tokens=2)
        torch.cuda.synchronize()
        rec, hs, snap = _serve_counted(eng, prompts, 32, phase)
        rec.update(model="gpt3_1_3b fp16", card=CARD,
                   greedy_token_agreement_with_bf16=_agreement(hs,
                                                               bf16_tokens))
        emit(rec)
        if snap is not None:
            _in_model(model, eng._w, snap, phase + "_in_model")
            snaps[phase] = snap
        runs[phase] = rec
        del eng
        _free_cuda()
    # per-call times at the fp16 engine's mid-run shape: K4 over its fp16
    # pools, K4q over the same pools quantized to int8, an fp16 query
    snap = snaps["serve_fp16"]
    pk_all, pv_all = snap["pools"]
    bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
    pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(15)
    B, nh, hd = bt.shape[0], pk_all.shape[3], pk_all.shape[4]
    q = (torch.randn(B, nh, hd, generator=gen, device="cuda")
         / math.sqrt(hd)).to(torch.float16)
    (qk, sk), (qv, sv) = (pa.quantize_kv(t, "int8") for t in (pk_all,
                                                              pv_all))
    times = _paged_times(q, {None: (pk_all, pv_all), "int8": (qk, qv, sk,
                                                              sv)},
                         bt, pos, 48)
    del snaps, snap, model
    _free_cuda()
    rows = []
    for kv, name, run, err in ((None, "paged_decode_attention_fp16",
                                "serve_fp16", "float16"),
                               ("int8", "paged_decode_attention_int8_fp16q",
                                "serve_fp16_int8", "int8_fp16q")):
        r = times[kv]
        launched = runs[run]["launches"][
            "paged_decode_attention" if kv is None
            else "paged_decode_attention_int8"]
        emit({"phase": "times", "kernel": name, "card": CARD,
              "case": "fp16 engine mid-run", "shape": r["shape"],
              "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
              "library_us": (None if r["library_ms"] is None
                             else r["library_ms"] * 1e3),
              "bound_us": r["bound_ms"] * 1e3, "bound_by": r["bound_by"],
              "share_of_bound": r["bound_ms"] / r["ms"],
              "event_us": {k: v * 1e3 for k, v in r["event_ms"].items()}})
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/kernels/csrc/"
                               "paged_attention.cu",
                     "replaces": "paddle_tpu/kernels/paged_attention.py:132",
                     "launches": launched,
                     "max_abs_err": max_err[err], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "event_ms": r["event_ms"]["kernel"]})
    return rows


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def gpt_dygraph_phase():
    """GPT-3 760M bf16 at full width and depth (24 layers, 16 heads of
    96), batch 8 x 1024, trained through Paddle's dygraph loop on the
    ``Layer``: ``model(ids)`` on Tensors, ``GPTPretrainingCriterion``,
    ``AdamW(1e-4, parameters=model.parameters(),
    grad_clip=ClipGradByGlobalNorm(1.0))``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``; 2 warm-up and 8 timed steps.
    Gates: the first step's loss and every updated parameter equal
    ``CompiledTrainStep``'s from the same weights and batch bit for bit
    (the same torch ops in the same order; stricter than
    ``_self_calibrated``); K1/K2/K3 24/24/24 a step by the counters and
    in the profiler's trace of one more step.  Then a 4-layer fp16 run
    with an eager ``GradScaler`` (the fp16 instances of K1–K3)."""
    cfg = _train_cfg()
    ids, labels = _batch(cfg, TRAIN_B, TRAIN_S, seed=12)
    crit = GPTPretrainingCriterion()

    def build(c=cfg):
        return GPTForCausalLM(c, device="cuda",
                              generator=torch.Generator().manual_seed(0))

    def optimizer(model):
        return AdamW(1e-4, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))

    # the yardstick: CompiledTrainStep's first step from the same weights
    ref = build()
    step = CompiledTrainStep(ref, lambda m, x, y: crit(m(x), y),
                             optimizer(ref))
    ref_loss = step(ids, labels).clone()
    ref_params = [p.detach().clone() for p in torch.nn.Module.parameters(ref)]
    del step, ref
    _free_cuda()

    model = build()
    opt = optimizer(model)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    n_params = sum(p.numel() for p in torch.nn.Module.parameters(model))

    def dygraph_step():
        loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    before = counters.snapshot()
    losses, step_s, enqueue_s = [], [], []
    for i in range(WARMUP + TRAIN_STEPS):
        t = time.perf_counter()
        loss = dygraph_step()
        queued = time.perf_counter()
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_s.append(time.perf_counter() - t)
            enqueue_s.append(queued - t)
        if i == 0:
            if not isinstance(loss, paddle.Tensor):
                raise AssertionError(f"gpt_dygraph: the loss is {type(loss)}")
            same = [_bits_equal(p.detach(), r) for p, r in
                    zip(torch.nn.Module.parameters(model), ref_params)]
            if not (_bits_equal(loss._data.detach(), ref_loss)
                    and all(same)):
                raise AssertionError(
                    f"gpt_dygraph: first step differs from "
                    f"CompiledTrainStep's: loss {float(loss)} vs "
                    f"{float(ref_loss)}, {same.count(False)} parameters")
            del ref_params
        losses.append(float(loss))
    launches = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    moved = counters.delta(before)
    peak = torch.cuda.max_memory_allocated()
    steps, L = WARMUP + TRAIN_STEPS, cfg.num_layers
    per_step = dict.fromkeys(launches, L)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt_dygraph: losses {losses}")
    if launches != {n: L * steps for n in launches} or moved.get(
            "optimizer.steps") != steps or moved.get(
            "kernels.flash.reference_fallbacks", 0):
        raise AssertionError(f"gpt_dygraph: launches {launches}, counters "
                             f"{moved}")
    # one step profiled, for the record and for the gate (as bert_train)
    _reset_flash_counts()
    prof = _profile(dygraph_step, top=12)
    traced = prof["flash_kernels_run"]
    counted = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    if traced != per_step or counted != per_step:
        raise AssertionError(
            f"gpt_dygraph: one step ran {traced} in the trace and "
            f"{counted} by the counters, want {per_step} (the trace kept "
            f"{prof['preroll_kernels_kept']} of its pre-roll kernels)")
    p50 = float(np.median(step_s))
    tokens = TRAIN_B * TRAIN_S
    record = {
        "phase": "gpt_dygraph", "model": "gpt3_760m bf16", "card": CARD,
        "layers": L, "params": n_params, "batch": [TRAIN_B, TRAIN_S],
        "loop": "model(Tensor), GPTPretrainingCriterion, loss.backward(), "
                "AdamW + ClipGradByGlobalNorm(1.0), opt.step(), "
                "opt.clear_grad()",
        "first_step_bit_equal_to_compiled_train_step": True,
        "steps": steps, "warmup": WARMUP, "losses": losses,
        "step_ms_p50": p50 * 1e3, "step_ms": [s * 1e3 for s in step_s],
        "tokens_per_s": tokens / p50,
        "model_flops_share_of_bf16_peak": 6 * n_params * tokens / p50
        / BF16_FLOPS,
        "host_enqueue_ms_p50": float(np.median(enqueue_s)) * 1e3,
        "device_busy_share_of_p50": prof["device_us"] / 1e3 / (p50 * 1e3),
        "peak_mem_gb": peak / 1e9, "launches": launches,
        "launches_per_step": per_step, "profiled_step": prof}
    emit(record)
    del model, opt, x, y, loss
    _free_cuda()

    # the fp16 instances on the same loop: 4 layers, an eager GradScaler
    cfg16 = GPTConfig.gpt3_760m(vocab_size=50304, max_seq_len=TRAIN_S,
                                dtype="float16")
    cfg16.num_layers = 4
    m16 = build(cfg16)
    opt16 = optimizer(m16)
    scaler = GradScaler(init_loss_scaling=2.0 ** 15)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    _reset_flash_counts()
    losses16 = []
    for _ in range(4):
        loss = crit(m16(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt16)
        opt16.clear_grad()
        losses16.append(float(loss))
    counted = {fn.__name__: fn.launches for fn in FLASH_KERNELS}
    ok = (all(math.isfinite(v) for v in losses16)
          and counted == dict.fromkeys(counted, 4 * 4)
          and not scaler._found_inf
          and all(bool(torch.isfinite(p).all())
                  for p in torch.nn.Module.parameters(m16)))
    emit({"phase": "gpt_dygraph_fp16", "card": CARD, "layers": 4,
          "losses": losses16, "launches": counted,
          "loss_scale": float(scaler.get_loss_scaling())})
    if not ok:
        raise AssertionError(f"gpt_dygraph_fp16: losses {losses16}, "
                             f"launches {counted}")
    del m16, opt16
    _free_cuda()
    return record


#: K1–K3's device functions at head dim 256 in bf16/fp16, as a trace
#: shows them: the wgmma kernels of ``flash_attention_d256.cu``
FLASH_D256_DEVICE_NAMES = {"flash_fwd": "flash_fwd_d256_kernel",
                           "flash_bwd_dq": "flash_bwd_dq_d256_kernel",
                           "flash_bwd_dkv": "flash_bwd_dkv_d256_kernel"}


def _hd_encoder():
    """flash_hd_in_model's 2-layer encoder of 16 heads of 256, seeded.
    GELU, as BERT and GPT: with the default ReLU, forward outputs that
    agree to fp32 rounding flip a few of the 67M ReLU masks, and those
    kinks alone move the input gradient between two fp32 runs far past
    rounding (seen on an H100), which no gradient check of the attention
    can see past."""
    paddle.seed(8)
    return paddle.nn.TransformerEncoder(
        paddle.nn.TransformerEncoderLayer(4096, 16, 16384, dropout=0.0,
                                          activation="gelu"), 2)


def _hd_inputs(seed):
    """The encoder's input and output gradient, B 4 x S 1024."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(4, 1024, 4096, generator=gen, device="cuda"),
            torch.randn(4, 1024, 4096, generator=gen, device="cuda"))


def _hd_run(enc, xs, gs, level, plain):
    """One forward and backward of ``enc`` at AMP ``level`` (O2 bf16 or
    O0), through K1–K3 or their plain versions: (output, input gradient)
    as fp32 ``[rows, 4096]``."""
    x = paddle.to_tensor(xs.clone(), stop_gradient=False)
    with (_plain_attention() if plain else contextlib.nullcontext()), \
            paddle.amp.auto_cast(enable=level != "O0", level=level,
                                 dtype="bfloat16"):
        out = enc(x)
    out.backward(paddle.to_tensor(gs.to(out.dtype)))
    res = (out._data.detach().float().reshape(-1, 4096),
           x.grad._data.float().reshape(-1, 4096))
    enc.clear_gradients()
    return res


def flash_hd_in_model_phase():
    """A 2-layer paddle-style ``nn.TransformerEncoder(d_model=4096,
    nhead=16, dim_feedforward=16384, dropout=0, activation="gelu")`` —
    16 heads of 256, the
    head dim ``scaled_dot_product_attention`` routes to the kernels —
    forward and backward on B 4 x S 1024: under ``auto_cast`` O2 bf16
    and at fp32, each through K1–K3 and through their plain versions;
    outputs and input gradients held by ``_self_calibrated`` (rows by
    RMS, ``ROW_RMS_FACTOR``); K1/K2/K3
    launched 2/2/2 a kernel run (0 a plain one) by the counters, and in
    the profiler's trace of the O2 run under their D 256 kernels' names
    (``FLASH_D256_DEVICE_NAMES``)."""
    enc = _hd_encoder()
    xs, gs = _hd_inputs(13)

    def run(level, plain):
        _reset_flash_counts()
        return (*_hd_run(enc, xs, gs, level, plain),
                {fn.__name__: fn.launches for fn in FLASH_KERNELS})

    runs = {(lv, p): run(lv, p) for lv in ("O2", "O0") for p in (False,
                                                                 True)}
    want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    for (lv, plain), (_, _, launched) in runs.items():
        if launched != (dict.fromkeys(want, 0) if plain else want):
            raise AssertionError(f"flash_hd_in_model: {lv} plain={plain} "
                                 f"launched {launched}")
    rec = {"phase": "flash_hd_in_model", "card": CARD, "layers": 2,
           "d_model": 4096, "heads": 16, "head_dim": 256,
           "batch": [4, 1024], "launches_per_kernel_run": want}
    # rows by RMS: here a row's max swings past twice the other path's for
    # correct kernels on some inputs (flash_hd_gates.py: the mma.sync K1
    # and K3 on two of three inputs, the D 256 wgmma kernels on one),
    # while the row RMS holds still and still catches one path's coarser
    # rounding
    for i, what in enumerate(("output", "input_grad")):
        rec[what] = _self_calibrated(
            f"flash_hd_in_model {what}", runs[("O2", False)][i],
            runs[("O2", True)][i], runs[("O0", False)][i],
            runs[("O0", True)][i],
            floor_share=(SELF_CALIBRATED_FLOOR if i == 0
                         else BERT_GRAD_FLOOR), row_stat="rms")
    traced = _profile(lambda: run("O2", False), top=0,
                      names=FLASH_D256_DEVICE_NAMES)["flash_kernels_run"]
    if traced != want:
        raise AssertionError(f"flash_hd_in_model: the trace shows "
                             f"{traced}, want {want}")
    rec["traced_o2_run"] = traced
    emit(rec)
    del enc, runs
    _free_cuda()
    return want


SPARSE_V, SPARSE_DIM, SPARSE_B, SPARSE_FIELDS = 1_000_000, 256, 4096, 26
SPARSE_STEPS, SPARSE_LR = 10, 1e-3


def _sparse_batches(seed):
    """``SPARSE_STEPS`` batches of 4096 x 26 ids (26: the categorical
    fields of Criteo's display-advertising data), each field's ids drawn
    Zipf-skewed (p_k ∝ 1/(k+1)^1.05 over the table) and scattered over
    the table by a multiplicative hash, with click labels at a 0.25
    rate; numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, SPARSE_V + 1) ** 1.05
    cdf = np.cumsum(p / p.sum())
    out = []
    for _ in range(SPARSE_STEPS):
        ranks = np.searchsorted(cdf, rng.random((SPARSE_B, SPARSE_FIELDS)))
        ranks = np.minimum(ranks, SPARSE_V - 1)
        ids = (ranks * 2654435761 + np.arange(SPARSE_FIELDS) * 40503) \
            % SPARSE_V
        labels = (rng.random(SPARSE_B) < 0.25).astype(np.float32)
        out.append((torch.from_numpy(ids).cuda(),
                    torch.from_numpy(labels).cuda()))
    return out


def _sparse_model(sparse, w0, head0):
    emb = paddle.nn.Embedding(SPARSE_V, SPARSE_DIM, sparse=sparse)
    head = paddle.nn.Linear(SPARSE_DIM, 1)
    emb.weight.set_value(w0)
    head.weight.set_value(head0)
    head.bias.set_value(torch.zeros(1, device="cuda"))
    return emb, head


def _sparse_loss(emb, head, ids, labels):
    """Embedding -> sum over the fields -> Linear -> BCE with logits (the
    port's Tensor has no reductions yet, so the sum and the loss are torch
    ops on its data, inside the same graph)."""
    e = emb(paddle.to_tensor(ids))
    logit = head(paddle.Tensor._wrap(e._data.sum(1)))
    return paddle.Tensor._wrap(F.binary_cross_entropy_with_logits(
        logit._data[:, 0], labels))


def sparse_embedding_phase():
    """``nn.Embedding(1_000_000, 256, sparse=True)`` (a 1.02 GB fp32
    table) -> sum over 26 fields -> ``Linear`` -> BCE, batch 4096,
    ``Adam(1e-3, lazy_mode=True)`` with ``ClipGradByGlobalNorm(1.0)``, 10
    steps.  Gates: rows no batch touched are bit-equal to their start;
    touched rows equal a plain fp32 row-wise update written here (clip
    over the merged rows and the head's gradients, Adam on the unique
    rows) within Adam's bounds; with ``lazy_mode=False`` the trajectory
    equals ``sparse=False`` within the same bounds, losses within 1e-5
    relative.  Step ms of the sparse and the dense table printed."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    w0 = torch.randn(SPARSE_V, SPARSE_DIM, generator=gen, device="cuda")
    head0 = torch.randn(SPARSE_DIM, 1, generator=gen, device="cuda") * 0.05
    batches = _sparse_batches(17)
    b1, b2, eps = 0.9, 0.999, 1e-8
    bound = 2 * SPARSE_STEPS * SPARSE_LR

    def within_adam_bounds(what, got, want):
        """Adam moves an element by at most lr a step, so two runs differ
        by at most 2·steps·lr; an element whose gradient is within
        rounding of 0 may take the other sign, so at most 1e-4 of the
        elements may differ by more than 1% of lr."""
        diff = (got - want).abs()
        off = int((diff > 0.01 * SPARSE_LR).sum())
        if float(diff.max()) > bound or off > 1e-4 * diff.numel():
            raise AssertionError(f"sparse_embedding {what}: max diff "
                                 f"{float(diff.max())}, {off} elements "
                                 "off by more than 1% of lr")
        return {"max_abs_diff": float(diff.max()), "off_by_1pct_lr": off}

    def train(sparse, lazy, reference=False):
        emb, head = _sparse_model(sparse, w0, head0)
        params = [emb.weight, head.weight, head.bias]
        opt = paddle.optimizer.Adam(SPARSE_LR, parameters=params,
                                    lazy_mode=lazy,
                                    grad_clip=ClipGradByGlobalNorm(1.0))
        ref = ({"w": w0.clone(), "m": torch.zeros_like(w0),
                "v": torch.zeros_like(w0)} if reference else None)
        losses, step_s = [], []
        for t, (ids, labels) in enumerate(batches, 1):
            t0 = time.perf_counter()
            loss = _sparse_loss(emb, head, ids, labels)
            loss.backward()
            if ref is not None:
                sr = emb.weight.grad
                if not isinstance(sr, SelectedRows):
                    raise AssertionError("sparse_embedding: the table's "
                                         f"gradient is {type(sr)}")
                rows, inv = torch.unique(sr.rows, return_inverse=True)
                g = torch.zeros(rows.numel(), SPARSE_DIM, device="cuda")
                g.index_add_(0, inv, sr.values.float())
                dense = [p.grad._data.float() for p in params[1:]]
                norm = torch.sqrt((g * g).sum()
                                  + sum((d * d).sum() for d in dense))
                g = g * (1.0 / torch.clamp(norm, min=1.0))
                m = b1 * ref["m"][rows] + (1 - b1) * g
                v = b2 * ref["v"][rows] + (1 - b2) * g * g
                ref["m"][rows], ref["v"][rows] = m, v
                ref["w"][rows] -= SPARSE_LR * (m / (1 - b1 ** t)) / (
                    torch.sqrt(v / (1 - b2 ** t)) + eps)
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        return emb, losses, step_s, ref

    # lazy_mode: the main path
    emb, losses, lazy_s, ref = train(True, True, reference=True)
    touched = torch.zeros(SPARSE_V, dtype=torch.bool, device="cuda")
    for ids, _ in batches:
        touched[ids.reshape(-1)] = True
    w = emb.weight._data.detach()
    if not torch.equal(w[~touched], w0[~touched]):
        raise AssertionError("sparse_embedding: an untouched row moved")
    rec = {"phase": "sparse_embedding", "card": CARD,
           "table": [SPARSE_V, SPARSE_DIM], "batch": [SPARSE_B,
                                                      SPARSE_FIELDS],
           "steps": SPARSE_STEPS, "optimizer": "Adam(1e-3, lazy_mode=True) "
           "+ ClipGradByGlobalNorm(1.0)", "losses_lazy": losses,
           "touched_rows": int(touched.sum()),
           "unique_ids_per_step": [int(torch.unique(i).numel())
                                   for i, _ in batches],
           "untouched_rows_bit_equal": True,
           "touched_vs_plain_row_update": within_adam_bounds(
               "lazy vs the plain row-wise update", w[touched],
               ref["w"][touched])}
    del emb, w, ref, touched
    _free_cuda()
    # lazy_mode=False densifies: the dense table's trajectory
    emb_s, loss_s, dense_sparse_s, _ = train(True, False)
    emb_d, loss_d, dense_s, _ = train(False, False)
    if not np.allclose(loss_s, loss_d, rtol=1e-5, atol=0):
        raise AssertionError(f"sparse_embedding: densified losses {loss_s} "
                             f"vs dense {loss_d}")
    rec["densify_vs_dense_table"] = within_adam_bounds(
        "densified vs dense", emb_s.weight._data, emb_d.weight._data)
    rec.update({
        "step_ms_p50": {"sparse_lazy": float(np.median(lazy_s[2:])) * 1e3,
                        "sparse_densified": float(np.median(
                            dense_sparse_s[2:])) * 1e3,
                        "dense_table": float(np.median(dense_s[2:])) * 1e3},
        "step_times": "host clock around each synchronised step, p50 of "
                      "steps 3-10",
        "seconds": time.perf_counter() - t_phase})
    emit(rec)
    del emb_s, emb_d, w0, batches
    _free_cuda()
    return rec


def lbfgs_phase():
    """Least squares ``||A x - b||^2`` at 8192 x 1024 fp32 (A N(0, 1/8192),
    b = A x* + 0.01 noise), ``LBFGS(lr=0.5, history_size=10)``, 20
    ``step(closure)`` calls from x = 0 on the card and on the CPU: x after
    every step within 1e-4 of its scale of the CPU run's (the same fp32
    dots and products summed in another order, carried through 20
    recursions), and the loss falls below 1e-3 of its start."""
    rng = np.random.default_rng(14)
    A = (rng.standard_normal((8192, 1024)) / math.sqrt(8192)).astype(
        np.float32)
    x_true = rng.standard_normal(1024).astype(np.float32)
    b = (A @ x_true + 0.01 * rng.standard_normal(8192)).astype(np.float32)

    def run(dev):
        At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        x = torch.zeros(1024, device=dev, requires_grad=True)
        opt = optim.LBFGS(learning_rate=0.5, history_size=10,
                          parameters=[x])
        losses, xs = [], []

        def closure():
            opt.clear_grad()
            loss = ((At @ x - bt) ** 2).sum()
            loss.backward()
            losses.append(float(loss))
            return loss

        t0 = time.perf_counter()
        for _ in range(20):
            opt.step(closure)
            xs.append(x.detach().cpu().clone())
        return losses, xs, time.perf_counter() - t0

    card, card_x, card_s = run("cuda")
    cpu, cpu_x, cpu_s = run("cpu")
    worst = max(float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                for a, c in zip(card_x, cpu_x))
    if worst > 1e-4 or not card[-1] < 1e-3 * card[0]:
        raise AssertionError(f"lbfgs: worst x diff {worst} of its scale, "
                             f"losses {card[0]} -> {card[-1]}")
    emit({"phase": "lbfgs", "card": CARD, "A": [8192, 1024],
          "steps": 20, "losses": card, "cpu_losses": cpu,
          "worst_x_diff_over_scale": worst, "tolerance": 1e-4,
          "card_s": card_s, "cpu_s": cpu_s})


#: the source of each kernel at D 256 in bf16/fp16
D256_SOURCES = {"flash_fwd": "flash_attention_d256",
                "flash_bwd_dq": "flash_attention_d256",
                "flash_bwd_dkv": "flash_attention_d256"}


def flash_hd_times_phase(max_err, launches):
    """K1–K3 at D 256 (bf16, B 2, H 16, S 1024, causal: the wgmma
    kernels of ``flash_attention_d256.cu``), in turns beside the
    ``mma.sync`` instances they replaced (called from their library),
    the plain versions, the bounds and SDPA's flash backend; each must
    beat the instance it replaced.  The ``kernels`` rows, with the
    launches of flash_hd_in_model's kernel runs."""
    rows = []
    errs = {"flash_fwd": max(max_err["flash_fwd"], max_err["flash_fwd_lse"]),
            "flash_bwd_dq": max_err["flash_bwd_dq"],
            "flash_bwd_dkv": max_err["flash_bwd_dkv"]}
    replaces = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:116",
                "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:204",
                "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:243"}
    times = _flash_shape_times(
        2, 16, 1024, 256, True, seed=18,
        replaced=tuple((n, "flash_attention_mma") for n in D256_SOURCES))
    for n, t in times.items():
        emit(t)
        if t["kernel_us"] >= t["replaced_us"]:
            raise AssertionError(
                f"flash_hd_times: {n} {t['kernel_us']} us at D 256, not "
                f"below the replaced mma.sync instance's "
                f"{t['replaced_us']} us")
        rows.append({"name": f"{n}_d256", "route": "cuda",
                     "source": "paddle_tpu_torch/kernels/csrc/"
                               f"{D256_SOURCES[n]}.cu",
                     "replaces": replaces[n], "launches": launches[n],
                     "max_abs_err": errs[n], "ms": t["kernel_us"] / 1e3,
                     "plain_ms": t["plain_us"] / 1e3,
                     "bound_ms": t["bound_us"] / 1e3,
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_us"] / 1e3,
                     "event_ms": t["event_us"]["kernel"] / 1e3,
                     "library_covers": ("forward" if n == "flash_fwd"
                                        else "the whole backward, K2 + K3"),
                     "replaced_ms": t["replaced_us"] / 1e3,
                     "replaced_source": t["replaced_source"]})
    return rows


# ---------------------------------------------------------------------------
# the device mesh: tensor-parallel serving (bench's servemp leg) and mesh
# training (its mesh leg)
# ---------------------------------------------------------------------------
#: the defaults of bench.py's servemp function (:1582): 8 requests of
#: S/32..S/8 tokens, 24 new each, 8 slots, blocks of 16, chunks of 128
#: (its leg at :2170 calls it with 16 requests, 64 new, chunks of 256)
SERVEMP_N, SERVEMP_NEW, SERVEMP_S = 8, 24, 1024
#: the largest per-rank share of the unsharded KV-pool + weight bytes
#: (bench.py:1683-1687), held both to the arena's accounting and to the
#: device memory a rank's model and engine hold
SERVEMP_MAX_HBM_FRAC = 0.6
#: 2-rank training: steps of each mesh (the loop's warmup schedule
#: stepped after each, so its learning rates are 0, top/2, top: two
#: updates), the bf16 tolerance of its losses against the one-process
#: step on the same global batch, and of its parameter updates: the
#: relative error of each fp32 master weight's change over the steps (the
#: worst tensor's, gathered whole) against the one-process change.  Each
#: limit lies between the sound runs' largest reading on an H100 (loss
#: 1.13e-4, update 0.032, mp2) and the control's (dp2 without its
#: gradient all-reduce: loss 8.05e-3, update 0.196 on its best tensor,
#: 0.892 on its worst), and the control must exceed both
MESH2_STEPS, MESH2_LOSS_ATOL, MESH2_UPDATE_RTOL = 3, 1e-3, 0.1
#: the mp2 run saves after this many steps; restored on mp2 (the same
#: mesh: its third loss bit-equal), on dp2 and in one process without a
#: mesh (reshardings: within MESH2_LOSS_ATOL of the mp2 run's third loss)
MESH2_SAVE_AT = 2


def _servemp_cfg():
    return GPTConfig.gpt3_760m(vocab_size=50304, max_seq_len=SERVEMP_S,
                               dtype="bfloat16")


def _servemp_prompts(V):
    rng = np.random.RandomState(0)
    lens = [int(rng.randint(max(2, SERVEMP_S // 32), max(3, SERVEMP_S // 8)))
            for _ in range(SERVEMP_N)]
    return [rng.randint(0, V, size=n) for n in lens]


def _servemp_engine(model, mesh=None, **kw):
    return LLMEngine(model, max_slots=8, max_seq_len=SERVEMP_S, min_bucket=8,
                     kv_layout="paged", block_size=16, prefill_chunk=128,
                     mesh=mesh, **kw)


def _servemp_model():
    """GPT-3 760M bf16 at full width and depth, weights from seed 0; under
    a global mesh each rank holds its shards of the same draw."""
    return GPTForCausalLM(_servemp_cfg(), device="cuda",
                          generator=torch.Generator().manual_seed(0))


def _servemp_run(model, prompts, phase, mesh=None, base=0, **kw):
    """A warmed engine's counted run (``_serve_counted``: K4/K4q launches
    == decode steps x 24); returns its record, tokens, snapshot and
    stats.  ``allocated_bytes``: the device memory allocated after the
    warm-up, less ``base`` (read before the model was built), so the
    model and the engine's state."""
    eng = _servemp_engine(model, mesh, **kw)
    eng.generate([prompts[0][:16]], max_new_tokens=2)
    gc.collect()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    record, handles, snap = _serve_counted(eng, prompts, SERVEMP_NEW, phase)
    st = eng.stats()
    record.update(kv_pool_bytes_per_chip=st["kv_pool_bytes_per_chip"],
                  weight_bytes_per_chip=st["weight_bytes_per_chip"],
                  mesh_tag=st["mesh_tag"], allocated_bytes=allocated,
                  rank_disagreements=st["rank_disagreements"])
    return record, [list(map(int, h.tokens)) for h in handles], snap, eng


def _wrapper_vs_plain(q, pools, bt, pos):
    """One K4/K4q call at the pools' shape against its plain version."""
    out = pa.paged_decode_attention(q, *pools[:2], bt, pos, *pools[2:],
                                    scale=1.0)
    ref = pa.paged_decode_attention_reference(q, *pools[:2], bt, pos,
                                              *pools[2:], scale=1.0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K4 at {tuple(pools[0].shape)}: non-finite")
    err = float((out - ref).abs().max())
    if err > KERNEL_ATOL:
        raise AssertionError(f"K4 at {tuple(pools[0].shape)} {pools[0].dtype}"
                             f": max abs err {err} > {KERNEL_ATOL}")
    return err


def _head_slice_times(snap, heads, launches, kv_dtypes=(None, "int8")):
    """K4 and K4q against their plain versions and timed
    (``_paged_times``) on the snapshot's pools cut to their first
    ``heads`` heads; ``launches``: the mesh runs' counts by kernel."""
    pk_all, pv_all = (t[..., :heads, :].contiguous()
                      for t in snap["pools"][:2])
    L, n_blocks, bs, nh, hd = pk_all.shape
    bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
    pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = (torch.randn(bt.shape[0], nh, hd, generator=gen, device="cuda")
         / math.sqrt(hd)).to(pk_all.dtype)
    pools = {None: (pk_all, pv_all)}
    for kv in kv_dtypes:
        if kv is not None:
            (qk, sk), (qv, sv) = (pa.quantize_kv(t, kv) for t in (pk_all,
                                                                   pv_all))
            pools[kv] = (qk, qv, sk, sv)
    errs = {kv: _wrapper_vs_plain(q, tuple(t[0] for t in p), bt, pos)
            for kv, p in pools.items()}
    times = _paged_times(q, pools, bt, pos, 24)
    out = {}
    for kv, r in times.items():
        name = ("paged_decode_attention" if kv is None
                else f"paged_decode_attention_{kv}")
        out[name] = {"shape": r["shape"], "launches": launches.get(name, 0),
                     "max_abs_err": errs[kv], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "share_of_bound": r["bound_ms"] / r["ms"]}
    return out


def servemp_phase():
    """bench.py's servemp function (its defaults) at one rank (NCCL, in
    this process): GPT-3 760M bf16 through the unsharded paged engine,
    the slot layout (the bf16 agreement bar: two engines of the same
    model whose sums differ only in order) and
    ``LLMEngine(mesh=build_mesh({"mp": 1}))``, bf16 and int8 KV +
    weights; the mesh engine's tokens must equal the
    unsharded engine's (the collectives run over a group of one), K4
    launches == decode steps x 24, host collectives issued."""
    from paddle_tpu_torch import distributed as D
    _free_cuda()
    m0 = torch.cuda.memory_allocated()
    model = _servemp_model()
    prompts = _servemp_prompts(model.config.vocab_size)
    base, base_toks, bsnap, beng = _servemp_run(model, prompts,
                                                "servemp_unsharded", base=m0)
    del beng, bsnap
    slot = LLMEngine(model, max_slots=8, max_seq_len=SERVEMP_S)
    slot.generate([prompts[0][:16]], max_new_tokens=2)
    _, slot_handles, _ = _serve_counted(slot, prompts, SERVEMP_NEW,
                                        "servemp_slots")
    bar = float(np.mean([x == y for h, b in zip(slot_handles, base_toks)
                         for x, y in zip(h.tokens, b)]))
    del slot, slot_handles
    q8 = dict(kv_dtype="int8", weight_dtype="int8")
    base8, base8_toks, bsnap, beng = _servemp_run(
        model, prompts, "servemp_unsharded_int8", base=m0, **q8)
    del beng, bsnap
    D.init_parallel_env()
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("servemp: the default backend on the card "
                                 f"is {torch.distributed.get_backend()}")
        mesh = D.build_mesh({"mp": 1})
        c0 = counters.get("dist.collective_launches")
        rec, toks, snap, eng = _servemp_run(model, prompts, "servemp",
                                            mesh=mesh)
        collectives = counters.get("dist.collective_launches") - c0
        _in_model(model, eng._w, snap, "servemp_in_model")
        del eng
        rec8, toks8, _, eng = _servemp_run(model, prompts, "servemp_int8",
                                           mesh=mesh, **q8)
        del eng
    finally:
        D.reset_parallel_env()
    record = {"phase": "servemp", "card": CARD, "model": "gpt3_760m bf16",
              "mesh": "mp1 (nccl, one rank)", "requests": SERVEMP_N,
              "new_tokens": SERVEMP_NEW,
              "tokens_equal_unsharded": toks == base_toks,
              "int8_tokens_equal_unsharded": toks8 == base8_toks,
              "host_collectives": collectives,
              "slot_vs_paged_agreement": bar,
              "kv_pool_bytes_per_chip": rec["kv_pool_bytes_per_chip"],
              "weight_bytes_per_chip": rec["weight_bytes_per_chip"],
              "unsharded": {"kv_pool_bytes_per_chip":
                            base["kv_pool_bytes_per_chip"],
                            "weight_bytes_per_chip":
                            base["weight_bytes_per_chip"]},
              "launches": {**rec["launches"],
                           "paged_decode_attention_int8":
                               rec8["launches"]["paged_decode_attention_int8"]},
              "decode_steps": rec["decode_steps"],
              "decode_tokens_per_s": rec["decode_tokens_per_s"],
              "unsharded_decode_tokens_per_s": base["decode_tokens_per_s"]}
    emit(record)
    if not (record["tokens_equal_unsharded"]
            and record["int8_tokens_equal_unsharded"]):
        raise AssertionError(f"servemp: the one-rank mesh engine's tokens "
                             f"differ from the unsharded engine's: {record}")
    if collectives <= 0:
        raise AssertionError("servemp: the mesh engine issued no collective")
    rows = _head_slice_times(snap, 16, record["launches"])
    emit({"phase": "servemp_times", "card": CARD, "heads": "16 x 96",
          "kernels": rows})
    return {"model": model, "prompts": prompts, "tokens": base_toks,
            "tokens_int8": base8_toks, "bar": bar, "snap": snap,
            "unsharded_bytes": (base["kv_pool_bytes_per_chip"]
                                + base["weight_bytes_per_chip"]),
            "unsharded_bytes_int8": (base8["kv_pool_bytes_per_chip"]
                                     + base8["weight_bytes_per_chip"]),
            "unsharded_allocated": base["allocated_bytes"],
            "unsharded_allocated_int8": base8["allocated_bytes"],
            "rows": rows, "record": record}


def _spawn_ranks(target, world, payload):
    """``target(rank, world, payload)`` of this script in ``world`` processes
    on this card, joined in a gloo group through a ``FileStore`` in a
    temporary directory (the payload goes through a file there); returns
    their results in rank order.  Every process is joined; a rank that
    fails makes this raise with its traceback."""
    import multiprocessing
    import pickle
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=os.environ.get("TMPDIR"))
    path = os.path.join(tmp, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        target, r, world, os.path.join(tmp, "store"), path, q))
        for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + 900
    try:
        while len(got) < world and not errors:
            try:
                rank, ok, value = q.get(timeout=5)
            except Exception:  # noqa: BLE001 - queue.Empty: look at them
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks exited {dead} or timed out with "
                                  f"results from {sorted(got)}")
                continue
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise AssertionError("\n".join(errors))
    return [got[r] for r in range(world)]


def _rank_main(target, rank, world, store, path, q):
    import datetime
    import pickle
    import traceback
    from paddle_tpu_torch import distributed as D
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        D.init_parallel_env(backend="gloo", rank=rank, world_size=world,
                            init_method="file://" + store,
                            timeout=datetime.timedelta(seconds=600))
        q.put((rank, True, globals()[target](rank, world, payload)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises
        q.put((rank, False, traceback.format_exc()))
    finally:
        D.reset_parallel_env()


def _servemp_rank(rank, world, pl):
    """One rank of servemp_mp2: the 760M model built under the mp2 mesh
    (this rank's shards of the seed-0 weights, kept by the engine's
    arena as they are), the mp2 engine in bf16 and then with int8 KV +
    weights; K4/K4q at the rank's 8 heads of 96 against their plain
    versions on the engine's pools; the device memory the rank holds."""
    from paddle_tpu_torch import distributed as D
    m0 = torch.cuda.memory_allocated()
    mesh = D.build_mesh({"mp": world})
    model = _servemp_model()
    out = {}
    for tag, kw in (("bf16", {}),
                    ("int8", dict(kv_dtype="int8", weight_dtype="int8"))):
        rec, toks, snap, eng = _servemp_run(model, pl["prompts"],
                                            f"servemp_mp2_{tag}_rank{rank}",
                                            mesh=mesh, base=m0, **kw)
        pools = tuple(t[0] for t in snap["pools"])
        bt = torch.from_numpy(snap["bt"].astype(np.int32)).cuda()
        pos = torch.from_numpy(snap["pos"].astype(np.int32)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(rank)
        q = torch.randn(bt.shape[0], pools[0].shape[2], pools[0].shape[3],
                        generator=gen, device="cuda").to(torch.bfloat16)
        out[tag] = {"tokens": toks, "launches": rec["launches"],
                    "decode_steps": rec["decode_steps"],
                    "decode_tokens_per_s": rec["decode_tokens_per_s"],
                    "kv_shard_shape": list(eng.arena.shard_shape("pool_k")),
                    "bytes": (rec["kv_pool_bytes_per_chip"]
                              + rec["weight_bytes_per_chip"]),
                    "max_abs_err": _wrapper_vs_plain(q, pools, bt, pos),
                    "mesh_tag": rec["mesh_tag"],
                    "allocated": rec["allocated_bytes"],
                    "rank_disagreements": rec["rank_disagreements"],
                    "wte_shard": list(model.wte.shape)}
        del eng, snap, pools
        torch.cuda.empty_cache()
    return out


def servemp_mp2_phase(sm):
    """bench.py's servemp function (its defaults) at mp2: two processes
    on this card in one gloo group (gloo stages CUDA tensors through the
    host; a correctness run, not a speed run), each serving the same 8
    requests through the mp2 engine over a model built under the mesh,
    bf16 and then int8.  Tokens agree with the unsharded engine's at
    least as well as the slot layout agrees with the paged one (the bf16
    bar); no rank chose a token other than rank 0's before the
    broadcast; per-rank KV-pool + weight bytes, and the device memory a
    rank's model and engine hold, <= 0.6 x the unsharded figures; K4 /
    K4q launches == decode steps x 24 on each rank, at 8 heads of 96,
    held against their plain versions."""
    res = _spawn_ranks("_servemp_rank", 2, {"prompts": sm["prompts"]})
    record = {"phase": "servemp_mp2", "card": CARD,
              "model": "gpt3_760m bf16", "mesh": "mp2 (gloo, 2 processes)",
              "bar": sm["bar"]}
    for tag, want, full, held in (
            ("bf16", sm["tokens"], sm["unsharded_bytes"],
             sm["unsharded_allocated"]),
            ("int8", sm["tokens_int8"], sm["unsharded_bytes_int8"],
             sm["unsharded_allocated_int8"])):
        r0 = res[0][tag]
        agree = float(np.mean([x == y for a, b in zip(r0["tokens"], want)
                               for x, y in zip(a, b)]))
        record[tag] = {
            "agreement_with_unsharded": agree,
            "rank_disagreements": [r[tag]["rank_disagreements"]
                                   for r in res],
            "hbm_frac": [r[tag]["bytes"] / full for r in res],
            "allocated_bytes": [r[tag]["allocated"] for r in res],
            "unsharded_allocated_bytes": held,
            "allocated_frac": [r[tag]["allocated"] / held for r in res],
            "wte_shard": r0["wte_shard"],
            "kv_shard_shape": r0["kv_shard_shape"],
            "launches": [r[tag]["launches"] for r in res],
            "decode_steps": r0["decode_steps"],
            "max_abs_err": max(r[tag]["max_abs_err"] for r in res),
            "decode_tokens_per_s": [r[tag]["decode_tokens_per_s"]
                                    for r in res],
            "mesh_tag": r0["mesh_tag"]}
    emit(record)
    for tag in ("bf16", "int8"):
        r = record[tag]
        if any(r["rank_disagreements"]) or r["mesh_tag"] != "[mp2]":
            raise AssertionError(f"servemp_mp2 {tag}: ranks disagree or no "
                                 f"mp2 mesh: {r}")
        if r["wte_shard"] != [sm["model"].config.vocab_size // 2, 1536]:
            raise AssertionError(f"servemp_mp2 {tag}: the model was not "
                                 f"built in shards: {r}")
        if r["agreement_with_unsharded"] < sm["bar"]:
            raise AssertionError(
                f"servemp_mp2 {tag}: agreement with the unsharded engine "
                f"{r['agreement_with_unsharded']} < the bf16 bar "
                f"{sm['bar']}")
        if max(r["hbm_frac"] + r["allocated_frac"]) > SERVEMP_MAX_HBM_FRAC:
            raise AssertionError(f"servemp_mp2 {tag}: per-rank bytes "
                                 f"{r['hbm_frac']}, allocated "
                                 f"{r['allocated_frac']} of unsharded > "
                                 f"{SERVEMP_MAX_HBM_FRAC}")
        if r["kv_shard_shape"][3:] != [8, 96]:
            raise AssertionError(f"servemp_mp2 {tag}: KV shard "
                                 f"{r['kv_shard_shape']}")
    rows = _head_slice_times(sm["snap"], 8, {
        "paged_decode_attention":
            record["bf16"]["launches"][0]["paged_decode_attention"],
        "paged_decode_attention_int8":
            record["int8"]["launches"][0]["paged_decode_attention_int8"]})
    for name, tag in (("paged_decode_attention", "bf16"),
                      ("paged_decode_attention_int8", "int8")):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        record[tag]["max_abs_err"])
    emit({"phase": "servemp_mp2_times", "card": CARD, "heads": "8 x 96",
          "kernels": rows})
    return rows


# -- the serving extras on a mesh (slice 15) ---------------------------------
#: the legs of serve_extras_mp1/serve_extras_mp2, in their order: (a)
#: speculative decoding with the GPT-3 125M draft, and self-drafted (the
#: random 125M draft's proposals are never accepted; the target's own
#: are, so rounds emit blocks and rank 0's broadcast carries their
#: lengths; at mp2 only, 12 new tokens), (b) LoRA (3 tenants of
#: rank 8 beside base rows), (c) the host tier with a pool cut to spill,
#: bf16 and int8 KV + weights, (d) migration of every request between two
#: engines, (e) a disaggregated fleet (1 prefill + 1 decode replica),
#: threaded and then pumped
EXTRAS_LEGS = ("spec", "spec_self", "lora", "tier", "tier_int8",
               "migration",
               "fleet_threaded", "fleet_pumped")
EXTRAS_Q8 = dict(kv_dtype="int8", weight_dtype="int8")
#: the legs serve_extras_mp1 holds bit-equal to no mesh (one of each
#: extra; int8 and the pumped fleet run at mp2)
EXTRAS_MP1_LEGS = ("spec", "lora", "tier", "migration", "fleet_threaded")


def _extras_draft():
    """GPT-3 125M bf16 (12 heads of 64), weights from seed 1; under a
    global mesh each rank holds its shards (6 heads at mp2)."""
    return GPTForCausalLM(GPTConfig.gpt3_125m(
        vocab_size=50304, max_seq_len=SERVEMP_S, dtype="bfloat16"),
        device="cuda", generator=torch.Generator().manual_seed(1))


def _extras_tenants(n):
    return [(None, *LORA_TENANTS)[i % 4] for i in range(n)]


def _extras_tier_blocks(prompts, new):
    """A pool that holds half the requests at once: the second half's
    admissions spill the first half's donated prefixes to the host, and
    the first half served again restores them."""
    need = max(blocks_for_tokens(len(p) + new - 1, 16) for p in prompts)
    return max(1, len(prompts) // 2) * need + 1


def _extras_leg(leg, model, draft, mesh, prompts, new, phase, warm=True):
    """One leg of the serving extras through the user's entry points
    (``LLMEngine(mesh=...)``, ``ServingFleet(mesh=...)``), its K4/K4q
    launch counts set to 0 just before its counted run and read just
    after (``_serve_counted`` and the fleet's gates want them ==
    decode or draft steps x layers); ``warm``: serve one short request
    first, off the counted run.  Returns the leg's record and the engines
    it built (the caller drops them)."""
    V = model.config.vocab_size
    L = model.config.num_layers
    t0 = time.perf_counter()
    first = [prompts[0][:16]]
    out = {}
    if leg in ("spec", "spec_self", "lora") or leg.startswith("tier"):
        if leg.startswith("spec"):
            eng = _servemp_engine(
                model, mesh, draft_model=model if leg == "spec_self"
                else draft, spec_k=SPEC_K)
        elif leg == "lora":
            eng = _servemp_engine(model, mesh, adapter_slots=4,
                                  adapter_rank=LORA_RANK)
            for i, t in enumerate(LORA_TENANTS):
                eng.register_adapter(t, random_lora_factors(
                    model.config, LORA_RANK, seed=i + 1))
        else:
            eng = _servemp_engine(
                model, mesh, n_blocks=_extras_tier_blocks(prompts, new),
                host_kv_blocks=1024,
                **(EXTRAS_Q8 if leg == "tier_int8" else {}))
        if warm:
            eng.generate(first, max_new_tokens=2)
        torch.cuda.synchronize()
        if leg.startswith("tier"):
            # pass 2 serves the first half again: their prefixes went to
            # the host while the second half ran, and come back from it
            half = prompts[:max(1, len(prompts) // 2)]
            runs = [_serve_counted(eng, p, new, f"{phase}_pass{i + 1}")
                    for i, p in enumerate((prompts, half))]
            moved = {k: sum(r["counters"].get(k, 0) for r, _, _ in runs)
                     for k in ("serving.kv.tier.spilled_blocks",
                               "serving.kv.tier.restored_blocks")}
            if min(moved.values()) <= 0:
                raise AssertionError(f"{phase}: the tier moved {moved}")
            rec, hs = runs[1][0], runs[1][1]
            launches = {k: sum(r["launches"][k] for r, _, _ in runs)
                        for k in rec["launches"]}
            steps = sum(r["decode_steps"] for r, _, _ in runs)
            out.update(tier=moved, pass1_tokens=[
                list(map(int, h.tokens)) for h in runs[0][1]],
                host_tier_bytes_per_rank=eng.stats()["host_arena_bytes"])
        else:
            rec, hs, _ = _serve_counted(
                eng, prompts, new, phase,
                adapters=_extras_tenants(len(prompts))
                if leg == "lora" else None)
            launches, steps = rec["launches"], rec["decode_steps"]
        st = eng.stats()
        engines = [eng]
        kv_bytes = st["kv_pool_bytes_per_chip"]
        if leg.startswith("spec"):
            kv_bytes += st["draft_kv_pool_bytes_per_chip"]
            c = rec["counters"]
            out.update(draft_kv_shard=list(eng.arena.shard_shape(
                "draft_pool_k")), draft_steps=c.get(
                    "serving.spec.draft_steps", 0),
                drafted=c.get("serving.spec.drafted", 0),
                accepted=c.get("serving.spec.accepted", 0))
        if leg == "lora":
            out["adapter_bytes_per_rank"] = st["adapters"]["arena_bytes"]
    elif leg == "migration":
        engines = [_servemp_engine(model, mesh) for _ in range(2)]
        for e in engines if warm else ():
            e.generate(first, max_new_tokens=2)
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        before = counters.snapshot()
        hs, infos, ms = _migrate_stream(*engines, prompts, new, phase)
        torch.cuda.synchronize()
        launches = _launch_counts()
        steps = counters.delta(before).get("serving.decode_steps", 0)
        for k, n in launches.items():
            want = steps * L if k == "paged_decode_attention" else 0
            if n != want or (want and n <= 0):
                raise AssertionError(f"{phase}: {k} launched {n}, want "
                                     f"{want}")
        kv_bytes = sum(e.stats()["kv_pool_bytes_per_chip"] for e in engines)
        out.update(migrations=len(infos),
                   blocks_copied=sum(i["blocks_copied"] for i in infos),
                   blocks_shared=sum(i["blocks_shared"] for i in infos),
                   ms_per_migration_p50=float(np.median(ms)))
    else:
        fleet = ServingFleet(model, replicas=2, prefill_replicas=1,
                             mesh=mesh, threaded=leg == "fleet_threaded",
                             max_slots=8, max_seq_len=SERVEMP_S,
                             min_bucket=8, kv_layout="paged",
                             block_size=16, prefill_chunk=128)
        if warm:
            _fleet_warm(fleet, V)
        hs, moved, launches, wall, _ = _fleet_counted(fleet, prompts, new,
                                                      phase)
        _fleet_gates(phase, fleet, hs, moved, launches, L, None)
        if moved.get("serving.fleet.migrate.requests", 0) != len(prompts):
            raise AssertionError(f"{phase}: migrations {moved}")
        steps = moved.get("serving.decode_steps", 0)
        engines = [r.engine for r in fleet._alive()]
        kv_bytes = sum(e.stats()["kv_pool_bytes_per_chip"] for e in engines)
        out["migrations"] = moved["serving.fleet.migrate.requests"]
        out["wall_s"] = wall
        fleet.drain()
    out.update(tokens=[list(map(int, h.tokens)) for h in hs],
               launches=launches, decode_steps=steps,
               kv_bytes_per_rank=kv_bytes,
               rank_disagreements=sum(e.stats()["rank_disagreements"]
                                      for e in engines),
               seconds=time.perf_counter() - t0)
    return out, engines


def serve_extras_mp1_phase(sm):
    """The serving extras at one rank over NCCL (this process), each leg
    of ``EXTRAS_MP1_LEGS`` on 4 of servemp's requests and 4 new tokens,
    on a mesh of one rank and without a mesh: the tokens must be the same
    (the collectives run over a group of one, nothing else changes).  Before the mesh: the
    unsharded speculative and LoRA engines on servemp's 8 requests and 24
    new tokens, the references serve_extras_mp2 holds its legs to, and
    K4 at the draft's mp2 slice (its first 6 of 12 heads of 64, the
    fullest servemp batch's tables) against its plain version, timed."""
    from paddle_tpu_torch import distributed as D
    model, prompts = sm["model"], sm["prompts"]
    draft = _extras_draft()
    ref = {}
    for leg in ("spec", "lora"):
        rec, engines = _extras_leg(leg, model, draft, None, prompts,
                                   SERVEMP_NEW, f"serve_extras_{leg}_"
                                   "unsharded")
        ref[leg] = rec["tokens"]
        if leg == "spec":
            eng = engines[0]
            ref["draft_rows"] = _head_slice_times(
                {"pools": (eng.dpool_k, eng.dpool_v), "bt": sm["snap"]["bt"],
                 "pos": sm["snap"]["pos"]}, 6, {}, kv_dtypes=(None,))
        del engines
        _free_cuda()
    short = dict(prompts=prompts[:4], new=4)
    D.init_parallel_env()
    equal, legs = {}, {}
    try:
        mesh = D.build_mesh({"mp": 1})
        for leg in EXTRAS_MP1_LEGS:
            got = []
            for m in (None, mesh):
                rec, engines = _extras_leg(
                    leg, model, draft, m, short["prompts"], short["new"],
                    f"serve_extras_mp1_{leg}" + ("" if m else "_unsharded"),
                    warm=False)
                got.append(rec)
                del engines
            equal[leg] = got[0]["tokens"] == got[1]["tokens"]
            legs[leg] = {k: got[1][k] for k in ("launches", "seconds",
                                                "rank_disagreements")}
    finally:
        D.reset_parallel_env()
    del draft
    _free_cuda()
    emit({"phase": "serve_extras_mp1", "card": CARD,
          "model": "gpt3_760m bf16, draft gpt3_125m bf16",
          "mesh": "mp1 (nccl, one rank)", "requests": 4, "new_tokens": 4,
          "tokens_equal_unsharded": equal, "legs": legs,
          "draft_mp2_slice_6x64": ref["draft_rows"]})
    if not all(equal.values()):
        raise AssertionError(f"serve_extras_mp1: the one-rank mesh's tokens "
                             f"differ from no mesh's: {equal}")
    return ref


def _serve_extras_rank(rank, world, pl):
    """One rank of serve_extras_mp2: the 760M model and the 125M draft
    built under the mp2 mesh (this rank's shards), every leg of
    ``EXTRAS_LEGS`` on servemp's 8 requests and 24 new tokens, and K4 at
    the rank's 6 draft heads of 64 against its plain version on the spec
    leg's draft pools (the fullest servemp batch's tables); then the
    control plane's legs (``CONTROL_LEGS``, :func:`_control_leg`).
    ``pl["legs"]``, when given, runs only those of ``EXTRAS_LEGS`` (the
    control legs need ``fleet_pumped``)."""
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"mp": world})
    model = _servemp_model()
    draft = _extras_draft()
    out = {}
    for leg in pl.get("legs", EXTRAS_LEGS):
        # the self-drafted leg checks accepted blocks: half the tokens do
        rec, engines = _extras_leg(leg, model, draft, mesh, pl["prompts"],
                                   SERVEMP_NEW // 2 if leg == "spec_self"
                                   else SERVEMP_NEW,
                                   f"serve_extras_mp2_{leg}_rank{rank}")
        if leg == "spec":
            eng = engines[0]
            bt = torch.from_numpy(pl["bt"].astype(np.int32)).cuda()
            pos = torch.from_numpy(pl["pos"].astype(np.int32)).cuda()
            gen = torch.Generator(device="cuda").manual_seed(rank)
            q = torch.randn(bt.shape[0], *eng.dpool_k.shape[3:],
                            generator=gen, device="cuda").to(torch.bfloat16)
            rec["draft_max_abs_err"] = _wrapper_vs_plain(
                q, (eng.dpool_k[0], eng.dpool_v[0]), bt, pos)
        out[leg] = rec
        del engines
        torch.cuda.empty_cache()
    out["wte_shard"] = list(model.wte.shape)
    out["draft_wte_shard"] = list(draft.wte.shape)
    del draft
    _flight_to_build()      # both ranks' replica_died bundles, one place
    ref = {"tokens": out["fleet_pumped"]["tokens"],
           "wall_s": out["fleet_pumped"]["wall_s"]}
    for leg in CONTROL_LEGS:
        n, new = CONTROL_CUT.get(leg, (SERVEMP_N, SERVEMP_NEW))
        out[leg] = _control_leg(leg, model, mesh, rank, pl["prompts"][:n],
                                new, ref, f"serve_extras_mp2_{leg}_rank{rank}")
        if leg == "fleet_int8":
            ref["int8_tokens"] = out[leg]["tokens"]
        if rank == 0:
            emit({"phase": "serve_extras_mp2_control_leg", "leg": leg,
                  "seconds": out[leg]["seconds"]})
        torch.cuda.empty_cache()
    return out


def serve_extras_mp2_phase(sm, ref):
    """The serving extras at mp2: two processes on this card in one gloo
    group (a correctness run), GPT-3 760M bf16 at full width and depth on
    servemp's requests and engine settings, every leg of
    ``EXTRAS_LEGS``.  Gates, on every leg: greedy tokens agree with the
    same engine without a mesh (``ref``: the unsharded speculative and
    LoRA engines; servemp's unsharded paged engine, bf16 or int8, for the
    self-drafted leg, whose greedy tokens drafting leaves as they are,
    the tier, migration and the fleet) at least as well as the slot
    layout agrees with the paged one (servemp's bf16 bar); no rank chose
    a token other than rank 0's before the broadcast; K4/K4q launched on
    each rank (== decode or draft steps x layers).  The self-drafted leg
    accepted drafted tokens on each rank; the draft's KV shard holds 6
    heads of 64; K4 at that slice equals its plain version.  Prints the
    KV bytes a rank holds on each leg.  Then the control plane's legs
    (``CONTROL_LEGS``), gated on each rank (:func:`_control_leg`) and
    across the ranks (:func:`_control_gates`)."""
    res = _spawn_ranks("_serve_extras_rank", 2, {
        "prompts": sm["prompts"], "bt": sm["snap"]["bt"],
        "pos": sm["snap"]["pos"]})
    want = {"spec": ref["spec"], "spec_self": sm["tokens"],
            "lora": ref["lora"], "tier": sm["tokens"],
            "tier_int8": sm["tokens_int8"], "migration": sm["tokens"],
            "fleet_threaded": sm["tokens"], "fleet_pumped": sm["tokens"]}
    record = {"phase": "serve_extras_mp2", "card": CARD,
              "model": "gpt3_760m bf16, draft gpt3_125m bf16",
              "mesh": "mp2 (gloo, 2 processes)", "bar": sm["bar"],
              "wte_shard": res[0]["wte_shard"],
              "draft_wte_shard": res[0]["draft_wte_shard"]}
    for leg in EXTRAS_LEGS:
        r0 = res[0][leg]
        # a tier leg: both passes (pass 2 is the first half, restored)
        got = r0.get("pass1_tokens", []) + r0["tokens"]
        ref_toks = (want[leg] if "pass1_tokens" not in r0
                    else want[leg] + want[leg][:len(r0["tokens"])])
        record[leg] = {
            "agreement_with_unsharded": float(np.mean([
                x == y for a, b in zip(got, ref_toks)
                for x, y in zip(a, b)])),
            **{k: [r[leg][k] for r in res] for k in (
                "rank_disagreements", "launches", "decode_steps",
                "kv_bytes_per_rank", "seconds")},
            **{k: v for k, v in r0.items() if k not in (
                "tokens", "pass1_tokens", "rank_disagreements", "launches",
                "decode_steps", "kv_bytes_per_rank", "seconds")}}
    emit(record)
    for leg in EXTRAS_LEGS:
        r = record[leg]
        name = ("paged_decode_attention_int8" if leg == "tier_int8"
                else "paged_decode_attention")
        if any(r["rank_disagreements"]):
            raise AssertionError(f"serve_extras_mp2 {leg}: ranks disagree "
                                 f"before the broadcast: {r}")
        if min(x[name] for x in r["launches"]) <= 0:
            raise AssertionError(f"serve_extras_mp2 {leg}: {name} never "
                                 f"launched: {r['launches']}")
        if r["agreement_with_unsharded"] < sm["bar"]:
            raise AssertionError(
                f"serve_extras_mp2 {leg}: agreement with the unsharded "
                f"engine {r['agreement_with_unsharded']} < the bf16 bar "
                f"{sm['bar']}")
    if min(r["spec_self"]["accepted"] for r in res) <= 0:
        raise AssertionError("serve_extras_mp2 spec_self: no drafted token "
                             "was accepted")
    if record["spec"]["draft_kv_shard"][3:] != [6, 64]:
        raise AssertionError(f"serve_extras_mp2: draft KV shard "
                             f"{record['spec']['draft_kv_shard']}")
    control = _control_gates(res)
    rows = ref["draft_rows"]
    k4 = rows["paged_decode_attention"]
    k4["launches"] = record["spec"]["launches"][0]["paged_decode_attention"]
    k4["max_abs_err"] = max(k4["max_abs_err"], *(
        r["spec"]["draft_max_abs_err"] for r in res))
    emit({"phase": "serve_extras_mp2_times", "card": CARD,
          "heads": "6 x 64 (GPT-3 125M draft, mp2 slice)", "kernels": rows})
    return {"draft_6x64": k4, "launches": {
        **{leg: record[leg]["launches"][0] for leg in EXTRAS_LEGS},
        **{leg: control[leg]["launches"] for leg in CONTROL_LEGS}}}


# -- the fleet's control plane on a mesh (slice 17) --------------------------
#: the control plane's legs of serve_extras_mp2, after ``EXTRAS_LEGS``:
#: pumped fleets at mp2 on servemp's requests, rank 0 deciding.  (a)
#: fleet_chaos: two unified replicas under ``replica_crash@0;
#: decode_stall@1``, installed on rank 0 alone, the hung replica's
#: heartbeat set back on rank 0 alone; fleet_chaos_disagg: a prefill +
#: decode pair under ``kv_migrate_drop@0,kv_migrate_drop@2``; fleet_int8
#: and fleet_chaos_int8: the unified pair with int8 KV + weights (K4q),
#: clean (the int8 reference) and then under the crash and stall.  (b)
#: fleet_autoscale: the pair with ``FLAGS_health`` on and the autoscaler
#: (``max_replicas=3``), a TTFT burn recorded on rank 0 alone: one grow,
#: then a retire.  (c) fleet_deadline: two unified replicas, every other
#: request with a deadline of half the fleet_pumped leg's wall time
CONTROL_LEGS = ("fleet_chaos", "fleet_chaos_disagg", "fleet_int8",
                "fleet_chaos_int8", "fleet_autoscale", "fleet_deadline")
#: requests (servemp's first) and new tokens of the chaos legs and the
#: clean int8 fleet, cut for the time limit; the autoscale and deadline
#: legs take servemp's 8 x 24 (the deadline is set from fleet_pumped's
#: wall time at that size)
CONTROL_CUT = {leg: (4, 12) for leg in CONTROL_LEGS[:4]}
#: each faulted leg's schedule and the deaths and respawns it injects
_CRASH_STALL = ("replica_crash@0;decode_stall@1",
                {"serving.fleet.replica_deaths": 2,
                 "serving.fleet.respawns": 2})
CONTROL_FAULTS = {"fleet_chaos": _CRASH_STALL,
                  "fleet_chaos_int8": _CRASH_STALL,
                  "fleet_chaos_disagg": ("kv_migrate_drop@0,"
                                         "kv_migrate_drop@2", {})}
#: the counters a control leg's record prints and the ranks must share
CONTROL_COUNTERS = ("serving.fleet.", "serving.autoscale.",
                    "resilience.faults_injected", "serving.deadline_expired")


def _control_autoscale(fleet, rank, submit):
    """The autoscale leg's ticks t = 0..5: the health plane ticked here
    only, a TTFT burn of 40 samples of 100 s recorded on rank 0 alone
    before t = 1; the requests submitted and served before t = 0, and
    again before t = 3 (the alert resolved at t = 2, on the grown fleet,
    whose spawned replica the autoscaler retires at t = 3).  The handles and the roles
    and alive count after each tick's pump."""
    from paddle_tpu_torch.profiler import metrics
    fleet.health.maybe_tick = lambda now=None: None
    flags.set_flags({"FLAGS_health": True, "FLAGS_health_interval_s": 0.0})
    hs, trail = [], []
    try:
        for t in range(6):
            if t in (0, 3):
                hs += submit()
                while not all(h.is_finished for h in hs):
                    fleet.pump()
            if t == 1 and rank == 0:
                hist = metrics.get_histogram("serving.ttft_ns", "ns")
                for _ in range(40):
                    hist.record(1e11)
            fleet.health.tick(now=float(t))
            fleet.pump()
            st = fleet.stats()
            trail.append((st["roles"], st["alive"]))
    finally:
        flags.set_flags({"FLAGS_health": False,
                         "FLAGS_health_interval_s": 1.0})
    return hs, trail


def _control_leg(leg, model, mesh, rank, prompts, new, ref, phase):
    """One control-plane leg on this rank (``CONTROL_LEGS``): a fresh
    pumped fleet over the mesh, K4/K4q counts set to 0 just before its
    counted run and read just after.  Gates on this rank: the faults'
    deaths and respawns, zero lost, K4 (K4q) == decode steps x 24, every
    pool reconciles, and the tokens equal the clean fleet's (``ref``: the
    fleet_pumped leg's; the fleet_int8 leg's for fleet_chaos_int8) where
    no deadline cut them (a cut request's are a prefix of them, and one
    at least was cut mid-decode).  Returns the leg's record (with the
    tokens of fleet_int8, the int8 reference)."""
    from paddle_tpu_torch.profiler.health import SLO
    L = model.config.num_layers
    kv = "int8" if leg.endswith("int8") else None
    kw = dict(replicas=2, **(EXTRAS_Q8 if kv else {}))
    if leg in ("fleet_chaos_disagg", "fleet_autoscale"):
        kw["prefill_replicas"] = 1
    if leg == "fleet_autoscale":
        kw.update(autoscale=True, autoscale_kw=dict(
            cooldown_ticks=0, ok_streak=2, max_replicas=3),
            health_kw=dict(rules=[SLO(
                "ttft_burn", ("hist_p95", "serving.ttft_ns"), 1e10,
                windows=((1.0, 1.0),), min_count=4)]))
    t0 = time.perf_counter()
    # no prefix cache: a replay (or the autoscale leg's second round)
    # that hit the prefix its first prefill donated would prefill only
    # the rest of the prompt, at other shapes, which moves bf16 logits;
    # without it every prefill is the clean fleet's, bit for bit (whose
    # random prompts share no prefix)
    fleet = ServingFleet(model, mesh=mesh, threaded=False,
                         heartbeat_timeout_s=30.0, max_retries=2,
                         max_slots=8, max_seq_len=SERVEMP_S, min_bucket=8,
                         kv_layout="paged", block_size=16,
                         prefill_chunk=128, prefix_cache=False, **kw)
    schedule, faults = CONTROL_FAULTS.get(leg, (None, {}))
    # half the clean fleet's wall time for as many new tokens
    deadline = (0.5 * ref["wall_s"] * new / SERVEMP_NEW
                if leg == "fleet_deadline" else None)

    def submit():
        return [fleet.submit(p, max_new_tokens=new, seed=i,
                             deadline_s=deadline if i % 2 else None)
                for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    before = counters.snapshot()
    if rank == 0:
        faultinject.set_schedule(schedule)
    trail = None
    try:
        if leg == "fleet_autoscale":
            hs, trail = _control_autoscale(fleet, rank, submit)
        else:
            hs = submit()
            while not all(h.is_finished for h in hs):
                fleet.pump()
                for rep in fleet._alive():
                    if rep.hung and rank == 0:
                        rep.last_beat -= fleet.heartbeat_timeout_s + 1.0
        torch.cuda.synchronize()
        fired = sorted(faultinject.fired)
    finally:
        if rank == 0:
            faultinject.clear()
    moved = counters.delta(before)
    launches = _launch_counts()
    toks = [list(map(int, h.tokens)) for h in hs]
    want = (None if leg == "fleet_int8" else
            [w[:new] for w in (ref["int8_tokens"] if kv
                               else ref["tokens"])[:len(prompts)]])
    if leg == "fleet_deadline":
        _fleet_gates(phase, fleet, [], moved, launches, L, None)
        cut = [i for i, h in enumerate(hs) if h.finish_reason == "deadline"]
        bad = [i for i, (h, w) in enumerate(zip(hs, want))
               if h.finish_reason not in ("length", "deadline")
               or toks[i] != w[:len(toks[i])]
               or (h.finish_reason == "length" and toks[i] != w)]
        if bad or not any(0 < len(toks[i]) < new for i in cut):
            raise AssertionError(f"{phase}: requests {bad} differ from the "
                                 f"reference, or none of {cut} was cut "
                                 f"mid-decode ({[len(t) for t in toks]})")
    else:
        _fleet_gates(phase, fleet, hs, moved, launches, L, kv,
                     want=want and want * (len(hs) // len(prompts)),
                     faults=faults)
    rec = {"seconds": time.perf_counter() - t0, "requests": len(prompts),
           "new_tokens": new, "schedule": schedule,
           "fired": fired, "launches": launches,
           "decode_steps": moved.get("serving.decode_steps", 0),
           "reasons": [h.finish_reason for h in hs],
           "token_counts": [len(t) for t in toks],
           "retries": [h.retries for h in hs], "deadline_s": deadline,
           "rank_disagreements": sum(r.engine.stats()["rank_disagreements"]
                                     for r in fleet._alive()),
           "moved": {k: v for k, v in moved.items()
                     if k.startswith(CONTROL_COUNTERS)
                     and k not in counters._GAUGES}}
    if fleet.autoscaler is not None:
        rec.update(trail=trail, history=fleet.autoscaler.summary()[
            "history"])
    if leg == "fleet_int8":
        rec["tokens"] = toks
    fleet.drain()
    del fleet
    return rec


def _control_gates(res):
    """The control legs across the two ranks: no rank chose a token apart
    from rank 0's; the faults fired, deaths, respawns, migrate drops,
    autoscaler actions and history, finish reasons and token counts the
    same on both ranks, the faults as scheduled and the autoscaler's
    actions a grow and a retire.  Prints each leg's seconds and the
    counters it moved; returns the records."""
    fired_want = {"fleet_chaos": [("decode_stall", 1), ("replica_crash", 0)],
                  "fleet_chaos_int8": [("decode_stall", 1),
                                       ("replica_crash", 0)],
                  "fleet_chaos_disagg": [("kv_migrate_drop", 0),
                                         ("kv_migrate_drop", 2)]}
    record = {"phase": "serve_extras_mp2_control", "card": CARD,
              "model": "gpt3_760m bf16 (24 layers)", "mesh": "mp2 (gloo)"}
    for leg in CONTROL_LEGS:
        r0, r1 = (r[leg] for r in res)
        record[leg] = {"seconds": [r0["seconds"], r1["seconds"]],
                       **{k: v for k, v in r0.items()
                          if k not in ("seconds", "tokens")}}
    emit(record)
    for leg in CONTROL_LEGS:
        r0, r1 = (r[leg] for r in res)
        same = ("fired", "reasons", "token_counts", "retries", "moved",
                "history", "trail", "decode_steps", "launches")
        diff = [k for k in same if r0.get(k) != r1.get(k)]
        if diff or r0["rank_disagreements"] or r1["rank_disagreements"]:
            raise AssertionError(f"serve_extras_mp2 {leg}: the ranks differ "
                                 f"in {diff} or disagree: {r0} {r1}")
        if r0["fired"] != fired_want.get(leg, []):
            raise AssertionError(f"serve_extras_mp2 {leg}: fired "
                                 f"{r0['fired']}")
        if leg == "fleet_chaos_disagg" and r0["moved"].get(
                "serving.fleet.migrate.dropped", 0) != 2:
            raise AssertionError(f"serve_extras_mp2 {leg}: {r0['moved']}")
        if leg == "fleet_autoscale" and (
                [h["action"] for h in r0["history"]] != ["grow_prefill",
                                                         "retire"]
                or r0["moved"].get("serving.autoscale.spawns", 0) != 1
                or r0["moved"].get("serving.autoscale.retires", 0) != 1):
            raise AssertionError(f"serve_extras_mp2 {leg}: {r0['history']} "
                                 f"{r0['moved']}")
    return record


def mesh_train_phase():
    """bench.py's mesh leg at one rank (NCCL, this process): GPT-3 125M
    bf16 at full width and ``MESH1_LAYERS`` of its 12 layers, 16 x 1024,
    ``recompute="selective"``, the training loop of
    :func:`_loop` with ``fused_steps=4``, once without a mesh and once
    built and stepped under ``build_mesh({"dp": 1, "mp": 1})`` (the
    tensor-parallel GPT and the mesh step, every collective over a group
    of one): a priming window, a captured one and a replay.  Losses,
    parameters and optimizer state bit-equal; one dispatch a steady
    window; K1–K3 counted; the collectives issued inside the captured
    window (counted at capture, added at each replay).  The mesh run saves
    through ``CheckpointManager`` after its second window (the manifest
    records the one-rank mesh); at the end it restores that save and
    runs the third window again: the same losses bit for bit, K1–K3
    counted on it."""
    import tempfile
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.env import AXIS_ORDER
    from paddle_tpu_torch.resilience import CheckpointManager
    cfg = _fused_cfg(num_layers=MESH1_LAYERS)
    K, L = FUSED_K, cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = tuple(torch.randint(0, cfg.vocab_size, (3 * K, FUSED_B, TRAIN_S),
                               generator=gen, device="cuda")
                 for _ in range(2))
    runs = {}
    ckpt = tempfile.mkdtemp(prefix="mesh1_ckpt_",
                            dir=os.environ.get("TMPDIR"))
    for mesh in (False, True):
        if mesh:
            D.init_parallel_env()
            D.build_mesh({"dp": 1, "mp": 1})
        try:
            model = GPTForCausalLM(cfg, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
            sched, opt, step = _loop(model, "gpt3_125m", k=K,
                                     mesh=D.get_mesh())
            mgr = CheckpointManager(ckpt)
            losses, moved = [], []
            for w in range(3):
                _reset_flash_counts()
                before = counters.snapshot()
                losses.append(step(_window(args, w * K, (w + 1) * K)))
                moved.append((counters.delta(before), _flash_counts()))
                for _ in range(K):
                    sched.step()
                if mesh and w == 1:
                    mgr.save(step, 2 * K)
            torch.cuda.synchronize()
            snap = _snapshot(model, opt)
            # one more replay, traced, after the snapshot
            trace = (_profile(lambda: step(_window(args, K, 2 * K)), top=8)
                     if mesh else None)
            resumed = None
            if mesh:
                info = mgr.restore(step)
                _reset_flash_counts()
                again = step(_window(args, 2 * K, 3 * K))
                with open(os.path.join(info["path"], "MANIFEST.json")) as f:
                    manifest_mesh = json.load(f)["mesh"]
                resumed = {"losses_bit_equal": torch.equal(again,
                                                           losses[2]),
                           "launches": _flash_counts(),
                           "manifest_mesh": manifest_mesh,
                           "resharded": info["resharded"],
                           "save": mgr.last_save, "restore_ms": info["ms"]}
            runs[mesh] = (torch.cat(losses), snap, moved, trace, resumed)
        finally:
            if mesh:
                D.reset_parallel_env()
                shutil.rmtree(ckpt, ignore_errors=True)
        del model, opt, step, mgr
        _free_cuda()
    (l0, s0, _, _, _), (l1, s1, moved, trace, resumed) = (runs[False],
                                                          runs[True])
    per = _flash_per_layer_step(cfg.recompute)
    want = {n: c * L * K for n, c in per.items()}
    steady = [m for m, _ in moved[1:]]
    nccl = [o["name"] for o in trace["top_device_ops"]
            if "nccl" in o["name"].lower()]
    record = {"phase": "mesh_train", "card": CARD,
              "model": "gpt3_125m bf16 selective",
              "mesh": "dp1 x mp1 (nccl, one rank)", "fused_steps": K,
              "losses_bit_equal": torch.equal(l0, l1),
              "state_bit_equal": _same_state(s0, s1),
              "steady_dispatches": [m.get("jit.host.dispatches") for m in
                                    steady],
              "steady_collectives": [m.get("dist.collective_launches", 0)
                                     for m in steady],
              "captures": moved[1][0].get("jit.captures", 0),
              "steady_launches": [f for _, f in moved[1:]],
              "launches_want_per_window": want,
              "replay_nccl_kernels": nccl,
              "replay_busy_share": trace["device_busy_share"],
              "losses": l1.tolist(), "checkpoint": resumed}
    emit(record)
    if not (record["losses_bit_equal"] and record["state_bit_equal"]):
        raise AssertionError(f"mesh_train: the one-rank mesh differs from "
                             f"no mesh: {record}")
    if record["steady_dispatches"] != [1, 1] or record["captures"] != 1:
        raise AssertionError(f"mesh_train: dispatches {record}")
    if any(c <= 0 for c in record["steady_collectives"]):
        raise AssertionError(f"mesh_train: no collective in the captured "
                             f"window: {record}")
    if any(f != want for f in record["steady_launches"]):
        raise AssertionError(f"mesh_train: K1-K3 launches "
                             f"{record['steady_launches']}, want {want}")
    if not (resumed["losses_bit_equal"] and resumed["launches"] == want
            and not resumed["resharded"]
            and resumed["manifest_mesh"] == {
                "axis_names": list(AXIS_ORDER),
                "shape": [1] * len(AXIS_ORDER)}):
        raise AssertionError(f"mesh_train: the checkpoint's resumed window "
                             f"{resumed}, want its losses bit-equal and "
                             f"K1-K3 {want}")
    return {n: want[n] * 3 for n in want}


#: the key third of ``qkv_b``: a bias added to every key shifts each
#: query's scores by one constant, which the softmax removes, so its
#: gradient is zero and its Adam steps are rounding noise scaled to full
#: size in every run; reported, not held
NOISE_ONLY = "qkv_b[k]"


def _update_rel_err(init, after, d_ref):
    """``{name: |d - d_ref| / |d_ref|}`` of each parameter's change ``d =
    after - init`` against the one-process change ``d_ref`` (numpy
    arrays in the JAX layout), with ``qkv_b``'s key third apart as
    :data:`NOISE_ONLY`."""
    def rel(got, want):
        return float(np.linalg.norm((got - want).ravel())
                     / max(np.linalg.norm(want.ravel()), 1e-30))

    out = {}
    for n, want in d_ref.items():
        got = after[n] - init[n]
        if n == "qkv_b":
            H = want.shape[-1] // 3
            out[NOISE_ONLY] = rel(got[..., H:2 * H], want[..., H:2 * H])
            got, want = (np.concatenate([t[..., :H], t[..., 2 * H:]], -1)
                         for t in (got, want))
        out[n] = rel(got, want)
    return out


def _masters(model, opt):
    """The optimizer's fp32 master weights (a parameter's own value where
    it has none), whole and in the JAX layout (every rank calls: a
    tensor-parallel model gathers its shards, a pipelined one its
    stages' rows)."""
    masters = opt.state_dict()["master_weights"]
    out = {}
    for n, t in model._weights().items():
        t = masters.get(n, t).detach().float()
        out[n] = model.full_weight(n, t).cpu().numpy()
    return out


def _skip_dp_sync(plan):
    """The control's gradient sync: each rank keeps its own half-batch
    gradient (no all-reduce over the data axes)."""
    plan.optimizer._shard_grads = {}
    return {id(p): p.grad for p in plan.params if p.grad is not None}


def _resume_step(degrees, ckpt, ids, labels):
    """A fresh GPT-3 125M (``MESH2_LAYERS``) built under ``degrees`` (or
    without a mesh) restores ``ckpt``'s checkpoint through :func:`_loop`'s
    step and runs the third step on its batch, K1–K3 counted from 0 just
    before it: (its loss, the counts, the restore's info)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.resilience import CheckpointManager
    D.set_mesh(None)
    mesh = D.build_mesh(degrees) if degrees else None
    model = GPTForCausalLM(_fused_cfg(num_layers=MESH2_LAYERS),
                           device="cuda",
                           generator=torch.Generator().manual_seed(5))
    _, _, step = _loop(model, "gpt3_125m", k=1, mesh=mesh)
    info = CheckpointManager(ckpt).restore(step)
    _reset_flash_counts()
    loss = float(step(ids, labels))
    launches = _flash_counts()
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return loss, launches, {k: info[k] for k in (
        "step", "resharded", "streams_restored", "ms")}


def _mesh_train_rank(rank, world, pl):
    """One rank of mesh_train_2rank: GPT-3 125M (seed 0) at dp2, mp2 and
    the dp2 control (the gradient all-reduce skipped), 3 steps each on
    the global batch through :func:`_loop` with its schedule stepped;
    the gathered fp32 masters' changes held against the one-process run's
    (``pl["d_ref"]``); K1–K3 counted.  The mp2 run saves through
    ``CheckpointManager`` after its second step (under ``pl["ckpt"]``);
    then a fresh mp2 model and a fresh dp2 one restore that save and run
    the third step."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.jit.mesh import MeshPlan
    from paddle_tpu_torch.resilience import CheckpointManager
    ids, labels = (torch.from_numpy(pl[k]).cuda() for k in ("ids", "labels"))
    out = {}
    fleet_mp2 = None
    for name, degrees in (("dp2", {"dp": world}), ("mp2", {"mp": world}),
                          ("dp2_control", {"dp": world})):
        D.set_mesh(None)
        mesh = D.build_mesh(degrees)
        model = GPTForCausalLM(_fused_cfg(num_layers=MESH2_LAYERS),
                               device="cuda",
                               generator=torch.Generator().manual_seed(0))
        init = model.gather_numpy_state()
        sched, opt, step = _loop(model, "gpt3_125m", k=1, mesh=mesh)
        _reset_flash_counts()
        sync = MeshPlan.sync_grads
        if name == "dp2_control":
            MeshPlan.sync_grads = _skip_dp_sync
        try:
            losses = []
            for i in range(MESH2_STEPS):
                losses.append(float(step(ids[i], labels[i])))
                sched.step()
                if name == "mp2" and i == MESH2_SAVE_AT - 1:
                    mgr = CheckpointManager(pl["ckpt"])
                    mgr.save(step, MESH2_SAVE_AT)
                    out["save"] = mgr.last_save
        finally:
            MeshPlan.sync_grads = sync
        launches = _flash_counts()
        after = _masters(model, opt)
        errs = _update_rel_err(init, after, pl["d_ref"])
        if name == "mp2":
            fleet_mp2 = (losses, {n: v - init[n] for n, v in after.items()})
        out[name] = {"losses": losses, "launches": launches,
                     "update_rel_err": errs,
                     "qkv_w": list(model.qkv_w.shape)}
        del model, opt, step, init, after
        gc.collect()
        torch.cuda.empty_cache()
    out["auto_parallel"] = _auto_parallel_mp2(rank, world, ids, labels,
                                              *fleet_mp2)
    del fleet_mp2
    i = MESH2_SAVE_AT
    for name, degrees in (("mp2_resumed", {"mp": world}),
                          ("dp2_resumed", {"dp": world})):
        out[name] = _resume_step(degrees, pl["ckpt"], ids[i], labels[i])
    return out


#: auto_parallel_mp2: the JAX GPT's placements of its weights (``gpt.py``
#: ``mk``) as ``Shard`` dims on a one-axis ``mp`` ProcessMesh, the way
#: fleet's tensor-parallel layers split them (columns of qkv and fc1,
#: rows of proj and fc2, the vocabulary of wte); the rest replicated
AP_MP_SHARD_DIMS = {"wte": 0, "qkv_w": 2, "qkv_b": 1, "proj_w": 1,
                    "fc1_w": 2, "fc1_b": 1, "fc2_w": 1}
#: auto_parallel_mp2's reshard moves on a 768 x 3072 bf16 weight (the
#: 125M model's fc1 shape); the Partial summands are the weight on both
#: ranks, so the all-reduced whole is exactly twice it
AP_MOVES = ("shard0_to_replicate", "replicate_to_shard1",
            "shard0_to_shard1", "partial_to_replicate")


def _ap_shard_fn(ap):
    def shard_fn(name, layer, mesh):
        for pname, p in layer.named_parameters(include_sublayers=False):
            dim = AP_MP_SHARD_DIMS.get(pname)
            ap.shard_tensor(p, mesh, [ap.Replicate() if dim is None
                                      else ap.Shard(dim)])
    return shard_fn


def _ap_reshards(ap, pmesh, rank, world):
    """The four moves of :data:`AP_MOVES`: each result's local piece
    against the slice of the whole it must be (bit-equal), and the ms of
    each ``reshard`` (synchronised, host clock)."""
    w = torch.randn(768, 3072, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(21)
                    ).to(torch.bfloat16)
    moves = {"shard0_to_replicate": ([ap.Shard(0)], [ap.Replicate()], w),
             "replicate_to_shard1": ([ap.Replicate()], [ap.Shard(1)],
                                     w.chunk(world, 1)[rank]),
             "shard0_to_shard1": ([ap.Shard(0)], [ap.Shard(1)],
                                  w.chunk(world, 1)[rank]),
             "partial_to_replicate": ([ap.Partial()], [ap.Replicate()],
                                      w * 2)}
    out = {}
    for name in AP_MOVES:
        src, dst, want = moves[name]
        a = (ap.dtensor_from_local(w, pmesh, src) if name.startswith(
            "partial") else ap.shard_tensor(w, pmesh, src))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = ap.reshard(a, pmesh, dst)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = ap.dtensor_to_local(b)._data
        out[name] = {"bit_equal": bool(torch.equal(got, want)), "ms": ms,
                     "local_shape": list(got.shape)}
    return out


def _auto_parallel_mp2(rank, world, ids, labels, fleet_losses, d_fleet):
    """auto_parallel_mp2 on one rank: GPT-3 125M (``MESH2_LAYERS``, seed
    0) built without a mesh, placed by :func:`_ap_shard_fn` on
    ``ProcessMesh([0, 1], ["mp"])`` through ``shard_layer``, trained
    ``MESH2_STEPS`` steps by ``to_static(loss=, optimizer=)`` with
    :func:`_loop_optimizer`'s AdamW, K1–K3 counted; its losses and fp32
    master updates (the storage slices all-gathered) against the
    fleet-built mp2 run's (``fleet_losses``, ``d_fleet``); then
    :func:`_ap_reshards`.  The parameters stay whole: the placements
    split their optimizer state and masters, not the products."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed.sharding_utils import gather_shard
    t0 = time.perf_counter()
    D.set_mesh(None)
    model = GPTForCausalLM(_fused_cfg(num_layers=MESH2_LAYERS),
                           device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init = model.gather_numpy_state()
    pmesh = ap.ProcessMesh(list(range(world)), ["mp"])
    ap.shard_layer(model, pmesh, _ap_shard_fn(ap))
    sched, opt, crit = _loop_optimizer(model, "gpt3_125m")
    step = ap.to_static(model, loss=crit, optimizer=ap.shard_optimizer(opt))
    _reset_flash_counts()
    losses = []
    for i in range(MESH2_STEPS):
        losses.append(float(step(ids[i], labels[i])))
        sched.step()
    launches = _flash_counts()
    plan = step._mesh
    masters = opt.state_dict()["master_weights"]
    after = {}
    for n, t in model._weights().items():
        m = masters.get(n, t).detach().float()
        spec = plan.storage.get(id(t))
        if spec is not None and tuple(m.shape) != tuple(t.shape):
            m = gather_shard(m.contiguous(), spec, plan.mesh)
        after[n] = m.cpu().numpy()
    errs = _update_rel_err(init, after, d_fleet)
    qkv = model._parameters["qkv_w"]
    rec = {"step": type(step).__name__, "losses": losses,
           "fleet_mp2_losses": fleet_losses,
           "max_loss_err": max(abs(a - b) for a, b in zip(losses,
                                                           fleet_losses)),
           "launches": launches,
           "update_rel_err": errs,
           "storage_specs": {n: list(plan.storage[id(t)]) for n, t in
                             model._weights().items()
                             if id(t) in plan.storage},
           "qkv_w_moment": list(opt._accumulators["moment1"][id(qkv)].shape),
           "qkv_w": list(qkv.shape)}
    del model, opt, step, init, after, masters
    gc.collect()
    torch.cuda.empty_cache()
    rec["reshard"] = _ap_reshards(ap, pmesh, rank, world)
    D.set_mesh(None)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _auto_parallel_gates(res, want):
    """auto_parallel_mp2's gates over the ranks' records (``want``: K1–K3
    over its steps); prints them beside the card."""
    recs = [r["auto_parallel"] for r in res]
    worst = {}
    for r in recs:
        for n, e in r["update_rel_err"].items():
            if n != NOISE_ONLY:
                worst[n] = max(worst.get(n, 0.0), e)
    worst_n = max(worst, key=worst.get)
    emit({"phase": "auto_parallel_mp2", "card": CARD,
          "model": "gpt3_125m bf16 selective", "layers": MESH2_LAYERS,
          "batch": [FUSED_B, TRAIN_S], "step": recs[0]["step"],
          "placements": {n: f"Shard({d})" for n, d in
                         AP_MP_SHARD_DIMS.items()},
          "losses": [r["losses"] for r in recs],
          "fleet_mp2_losses": recs[0]["fleet_mp2_losses"],
          "max_loss_err": max(r["max_loss_err"] for r in recs),
          "loss_atol": MESH2_LOSS_ATOL,
          "max_update_rel_err": worst[worst_n], "worst_param": worst_n,
          "update_rtol": MESH2_UPDATE_RTOL,
          "launches": [r["launches"] for r in recs], "launches_want": want,
          "qkv_w_moment": recs[0]["qkv_w_moment"],
          "reshard_768x3072_bf16": [r["reshard"] for r in recs],
          "seconds_a_rank": [r["seconds"] for r in recs]})
    for r in recs:
        if r["step"] != "DistributedTrainStep":
            raise AssertionError(f"auto_parallel_mp2: to_static gave {r}")
        if r["max_loss_err"] > MESH2_LOSS_ATOL:
            raise AssertionError("auto_parallel_mp2: losses "
                                 f"{r['losses']} vs the fleet's mp2 "
                                 f"{r['fleet_mp2_losses']}")
        if r["launches"] != want:
            raise AssertionError(f"auto_parallel_mp2: K1-K3 launches "
                                 f"{r['launches']}, want {want}")
        q = r["qkv_w"]
        if r["qkv_w_moment"] != [q[0], q[1], q[2] // 2]:
            raise AssertionError("auto_parallel_mp2: qkv_w's moment "
                                 f"{r['qkv_w_moment']} is not its mp2 slice")
        bad = [m for m, v in r["reshard"].items() if not v["bit_equal"]]
        if bad:
            raise AssertionError(f"auto_parallel_mp2: reshard {bad} gave "
                                 "other values than the slices they move")
    if worst[worst_n] > MESH2_UPDATE_RTOL:
        raise AssertionError(f"auto_parallel_mp2: {worst_n}'s update "
                             f"differs from the fleet's mp2 by "
                             f"{worst[worst_n]}")
    return recs[0]["launches"]


def _mesh_checkpoint_gates(res, one, want):
    """mesh_train_2rank's checkpoint gates, from the ranks' results and
    this process's one-process resume (``one``); ``want``: K1–K3 a
    resumed step.  Prints the save's bytes and times a rank and each
    restore's time beside the card."""
    i = MESH2_SAVE_AT
    third = [r["mp2"]["losses"][i] for r in res]
    record = {"phase": "mesh_checkpoint", "card": CARD,
              "model": "gpt3_125m bf16 selective", "layers": MESH2_LAYERS,
              "saved": "mp2 after step 2 (gloo, 2 processes)",
              "save_bytes_per_rank": [r["save"]["bytes"] for r in res],
              "save_snapshot_ms": [r["save"]["snapshot_ms"] for r in res],
              "save_write_ms": [r["save"]["write_ms"] for r in res],
              "uninterrupted_third_loss": third,
              "loss_atol": MESH2_LOSS_ATOL, "launches_want": want}
    legs = {"mp2_resumed": [r["mp2_resumed"] for r in res],
            "dp2_resumed": [r["dp2_resumed"] for r in res],
            "one_process_resumed": [one]}
    for name, runs in legs.items():
        record[name] = {"losses": [x[0] for x in runs],
                        "launches": [x[1] for x in runs],
                        "restore_ms": [x[2]["ms"] for x in runs],
                        "resharded": [x[2]["resharded"] for x in runs],
                        "streams_restored": [x[2]["streams_restored"]
                                             for x in runs],
                        "step": [x[2]["step"] for x in runs]}
    emit(record)
    for name, r in ((n, record[n]) for n in legs):
        if any(s != i for s in r["step"]):
            raise AssertionError(f"mesh_checkpoint {name}: restored steps "
                                 f"{r['step']}, want {i}")
        if any(l != want for l in r["launches"]):
            raise AssertionError(f"mesh_checkpoint {name}: K1-K3 launches "
                                 f"{r['launches']} on the resumed step, "
                                 f"want {want}")
        resharded = name != "mp2_resumed"
        if any(x != resharded for x in r["resharded"]) or any(
                x == resharded for x in r["streams_restored"]):
            raise AssertionError(f"mesh_checkpoint {name}: resharded "
                                 f"{r['resharded']}, streams restored "
                                 f"{r['streams_restored']}")
    if record["mp2_resumed"]["losses"] != third:
        raise AssertionError(f"mesh_checkpoint: the same-mesh resume's third "
                             f"loss {record['mp2_resumed']['losses']} is not "
                             f"the uninterrupted {third}")
    for name in ("dp2_resumed", "one_process_resumed"):
        err = max(abs(x - third[0]) for x in record[name]["losses"])
        if err > MESH2_LOSS_ATOL:
            raise AssertionError(f"mesh_checkpoint {name}: third loss "
                                 f"{record[name]['losses']} vs {third[0]}: "
                                 f"{err} > {MESH2_LOSS_ATOL}")


def mesh_train_2rank_phase():
    """bench.py's mesh leg across two processes on this card (gloo: a
    correctness run; ``fused_steps=1``, gloo's collectives cannot be
    captured): GPT-3 125M at full width and ``MESH2_LAYERS`` layers, dp2
    and then mp2 (6 heads of 64 a rank), 3 steps each on the global
    batch of 16 x 1024
    through :func:`_loop` with its schedule stepped (two updates).
    Losses within ``MESH2_LOSS_ATOL`` of this process's one-process
    step; every fp32 master weight's change, gathered whole, within
    ``MESH2_UPDATE_RTOL`` of the one-process change (``qkv_b``'s key third
    apart: :data:`NOISE_ONLY`), while a control with dp2's gradient
    all-reduce skipped must exceed both limits (so each gate can fail);
    K1–K3 launches == steps x layers x their per-layer count on each rank,
    and at the mp2 head slice held against their plain versions and
    timed.  Checkpoints (:func:`_mesh_checkpoint_gates`): the mp2 run
    saves after its second step; a fresh mp2 model restores it on each
    rank (its third loss bit-equal to the uninterrupted third loss), a
    fresh dp2 model and this process without a mesh restore it as
    reshardings (within ``MESH2_LOSS_ATOL``), K1–K3 counted on every
    resumed step."""
    import tempfile
    cfg = _fused_cfg(num_layers=MESH2_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (MESH2_STEPS, FUSED_B, TRAIN_S),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init = model.gather_numpy_state()
    sched, opt, step = _loop(model, "gpt3_125m", k=1)
    ref, lrs = [], []
    for i in range(MESH2_STEPS):
        lrs.append(sched())
        ref.append(float(step(ids[i], labels[i])))
        sched.step()
    d_ref = {n: v - init[n] for n, v in _masters(model, opt).items()}
    del model, opt, step, init
    _free_cuda()
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_",
                            dir=os.environ.get("TMPDIR"))
    try:
        res = _spawn_ranks("_mesh_train_rank", 2,
                           {"ids": ids.cpu().numpy(),
                            "labels": labels.cpu().numpy(), "d_ref": d_ref,
                            "ckpt": ckpt})
        del d_ref
        i = MESH2_SAVE_AT
        one = _resume_step(None, ckpt, ids[i], labels[i])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    per = _flash_per_layer_step(cfg.recompute)
    want = {n: c * cfg.num_layers * MESH2_STEPS for n, c in per.items()}
    record = {"phase": "mesh_train_2rank", "card": CARD,
              "model": "gpt3_125m bf16 selective", "layers": MESH2_LAYERS,
              "batch": [FUSED_B,
                                                             TRAIN_S],
              "lrs": lrs, "one_process_losses": ref,
              "loss_atol": MESH2_LOSS_ATOL,
              "update_rtol": MESH2_UPDATE_RTOL, "launches_want": want}
    for name in ("dp2", "mp2", "dp2_control"):
        errs = [r[name]["update_rel_err"] for r in res]
        worst_n = max((n for n in errs[0] if n != NOISE_ONLY),
                      key=lambda n: max(e[n] for e in errs))
        record[name] = {
            "losses": [r[name]["losses"] for r in res],
            "max_loss_err": max(abs(a - b) for r in res
                                for a, b in zip(r[name]["losses"], ref)),
            "max_update_rel_err": max(e[worst_n] for e in errs),
            "worst_param": worst_n,
            "noise_only_rel_err": max(e[NOISE_ONLY] for e in errs),
            "update_rel_err_rank0": errs[0],
            "launches": [r[name]["launches"] for r in res],
            "qkv_w_shard": res[0][name]["qkv_w"]}
    worst = dict.fromkeys(("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0.0)
    ratio = dict(worst)
    _flash_check(torch.Generator(device="cuda").manual_seed(31),
                 [(FUSED_B, 6, TRAIN_S, 64, torch.bfloat16, True)], worst,
                 ratio)
    record["slice_max_abs_err"] = worst
    record["slice_err_over_tol"] = ratio
    emit(record)
    for name in ("dp2", "mp2"):
        r = record[name]
        if r["max_loss_err"] > MESH2_LOSS_ATOL:
            raise AssertionError(f"mesh_train_2rank {name}: losses {r} vs "
                                 f"one process {ref}")
        if r["max_update_rel_err"] > MESH2_UPDATE_RTOL:
            raise AssertionError(f"mesh_train_2rank {name}: parameter "
                                 f"updates differ from one process: {r}")
        if any(l != want for l in r["launches"]):
            raise AssertionError(f"mesh_train_2rank {name}: K1-K3 launches "
                                 f"{r['launches']}, want {want}")
    ctl = record["dp2_control"]
    if (ctl["max_update_rel_err"] <= MESH2_UPDATE_RTOL
            or ctl["max_loss_err"] <= MESH2_LOSS_ATOL):
        raise AssertionError("mesh_train_2rank: the control without dp's "
                             "gradient all-reduce passes a gate: "
                             f"{ctl}")
    if record["mp2"]["qkv_w_shard"] != [cfg.num_layers, 768, 3 * 384]:
        raise AssertionError(f"mesh_train_2rank: mp2 qkv shard "
                             f"{record['mp2']['qkv_w_shard']}")
    _mesh_checkpoint_gates(res, one, {n: c * cfg.num_layers
                                      for n, c in per.items()})
    ap_launches = _auto_parallel_gates(res, want)
    times = _flash_shape_times(FUSED_B, 6, TRAIN_S, 64, True, seed=14)
    errs = {"flash_fwd": max(worst["flash_fwd"], worst["flash_fwd_lse"]),
            "flash_bwd_dq": worst["flash_bwd_dq"],
            "flash_bwd_dkv": worst["flash_bwd_dkv"]}
    rows = {}
    for n, t in times.items():
        emit(t)
        rows[n] = {"shape": t["shape"],
                   "launches": record["mp2"]["launches"][0][n],
                   "max_abs_err": errs[n], "ms": t["kernel_us"] / 1e3,
                   "plain_ms": t["plain_us"] / 1e3,
                   "bound_ms": t["bound_us"] / 1e3,
                   "bound_by": t["bound_by"],
                   "library_ms": t["library_us"] / 1e3,
                   "share_of_bound": t["share_of_bound"],
                   "auto_parallel_mp2_launches_a_rank": ap_launches[n]}
    return rows


# -- MoE and expert parallelism ----------------------------------------------

#: every layer of the MoE phases' models has 8 experts, top-2, capacity
#: factor 1.25 (the JAX package's defaults); the training objective adds
#: 0.01 x the load-balancing loss (``tests/test_moe.py:184``'s objective)
MOE_E, MOE_AUX = 8, 0.01
#: moe_ep_2rank: the dp2 run and its two controls, each of which must
#: fail one gate; the limits of its losses against one process on the
#: global batch, and of each fp32 master's change (``MESH2_*``'s
#: measures).  A bf16 MoE model routes near-ties apart between any two
#: runs, so the sound dp2 run reads larger than a dense model's.  On an
#: NVIDIA H100 80GB HBM3, 700.00 W: sound loss 4.66e-4, update 0.120
#: (``fc1_w``); each rank capacitating its own tokens, loss 3.07e-3; the
#: expert stacks' gradients all-reduced, update 0.889.  The limits lie
#: between
MOE_EP_RUNS = ("dp2", "local_capacity", "experts_allreduced")
MOE_EP_LOSS_ATOL, MOE_EP_UPDATE_RTOL = 1e-3, 0.3
#: moe_ep_2rank's training runs moe_train's model at 6 of its 12 layers
#: (cut for the script's time limit when mesh_train_2rank took its
#: checkpoint gates; its one-process reference runs at the same depth)
MOE_EP_LAYERS = 6
#: moe_train: batch 8 x 1024, 8 single steps against a priming window and
#: a captured window of 4
MOE_B, MOE_STEPS = 8, 8
#: the indexed MoE layer against the dense ``[T, E, C]`` route in bf16:
#: the routing is the same (the same gates), the dispatch is exact, and
#: the outputs differ only by the order of the combine's fp32 sums before
#: the one rounding to bf16: two bf16 ulps of the output scale
MOE_ROUTE_ULPS = 2
#: moe_train's first step: each path's bf16 aux (a sum over the layers of
#: bf16 values each rounded about four times: mean, count share, product
#: and sum) within two bf16 ulps of its fp32 aux
MOE_AUX_ULPS = 2


def _moe_serve_cfg(num_layers=None):
    cfg = GPTConfig.gpt3_760m(vocab_size=50304, max_seq_len=SERVEMP_S,
                              dtype="bfloat16", num_experts=MOE_E)
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def _moe_serve_model(num_layers=None):
    """GPT-3 760M widths, 8 experts a layer, bf16, weights drawn on the
    card from seed 0 (3.9 B parameters); under a global mesh each rank
    keeps its shards of the same draw."""
    return GPTForCausalLM(_moe_serve_cfg(num_layers), device="cuda",
                          generator=torch.Generator(
                              device="cuda").manual_seed(0))


def _moe_train_cfg(num_layers=None):
    cfg = GPTConfig.gpt3_125m(vocab_size=50304, max_seq_len=TRAIN_S,
                              dtype="bfloat16", recompute="selective",
                              num_experts=MOE_E)
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def _moe_train_model(num_layers=None):
    return GPTForCausalLM(_moe_train_cfg(num_layers), device="cuda",
                          generator=torch.Generator(
                              device="cuda").manual_seed(0))


def _moe_loss():
    crit = GPTPretrainingCriterion()
    return lambda m, x, y: crit(m(x), y) + MOE_AUX * m.moe_aux_loss()


def _moe_run(model, prompts, phase, mesh=None, base=0, **kw):
    """:func:`_servemp_run` with the model's MoE drop counts gathered over
    the counted run (``model.moe_stats``, on the device); adds
    ``dropped_share_decode``: the share of the decode steps' routed
    choices (T = 8 slot rows) that capacity dropped."""
    eng = _servemp_engine(model, mesh, **kw)
    eng.generate([prompts[0][:16]], max_new_tokens=2)
    gc.collect()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    model.moe_stats = {}
    try:
        record, handles, snap = _serve_counted(eng, prompts, SERVEMP_NEW,
                                               phase)
        stats = {T: (int(d), n) for T, (d, n) in model.moe_stats.items()}
    finally:
        model.moe_stats = None
    st = eng.stats()
    dec = stats.get(eng.max_slots, (0, 0))
    record.update(kv_pool_bytes_per_chip=st["kv_pool_bytes_per_chip"],
                  weight_bytes_per_chip=st["weight_bytes_per_chip"],
                  mesh_tag=st["mesh_tag"], allocated_bytes=allocated,
                  rank_disagreements=st["rank_disagreements"],
                  moe_dropped_by_tokens={str(T): v for T, v in
                                         sorted(stats.items())},
                  dropped_share_decode=dec[0] / dec[1] if dec[1] else None)
    return record, [list(map(int, h.tokens)) for h in handles], snap, eng


@torch.no_grad()
def _moe_route_check(lw, T, seed):
    """Layer 0's indexed ``moe_ffn`` against the dense ``[T, E, C]`` route
    (``moe_ffn_dense``) at ``T`` tokens: in fp32 copies of the weights
    the dispatch must be bit-equal, in bf16 the outputs within
    ``MOE_ROUTE_ULPS`` bf16 ulps of their scale and the aux equal; both
    timed (CUDA events per call).  The tokens are drawn around one common
    vector, so the router concentrates and capacity drops choices (as it
    does in the engine's deeper layers); the check needs drops."""
    from paddle_tpu_torch.incubate import moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H = lw["gate_w"].shape[1]
    x = (torch.randn(1, H, generator=gen, device="cuda")
         + 0.5 * torch.randn(T, H, generator=gen, device="cuda"))
    names = ("gate_w", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
    w16 = [lw[n][0] for n in names]
    w32 = [t.float() for t in w16]
    E = w16[0].shape[-1]
    C = moe.moe_capacity(T, E, 2, 1.25)
    gates = torch.softmax(torch.matmul(x, w32[0]), -1)
    dense_dispatch = moe.topk_gating(gates, 2, C)[0]
    r = moe.route(gates, 2, C)
    dispatch_equal = torch.equal(moe.dispatch(x, r), torch.einsum(
        "tec,th->ech", dense_dispatch, x))
    x16 = x.to(torch.bfloat16)
    y, aux = moe.moe_ffn(x16, *w16)
    yd, auxd = moe.moe_ffn_dense(x16, *w16)
    scale = float(yd.float().abs().max())
    err = float((y.float() - yd.float()).abs().max())
    tol = MOE_ROUTE_ULPS * 2.0 ** -8 * scale
    ms = {name: _time_ms(lambda i, f=f: f(x16, *w16), 10) for name, f in
          (("indexed", moe.moe_ffn), ("dense", moe.moe_ffn_dense))}
    out = {"T": T, "capacity": C, "dispatch_bit_equal_fp32": dispatch_equal,
           "max_abs_err_bf16": err, "atol": tol, "output_scale": scale,
           "aux_equal": torch.equal(aux, auxd),
           "dropped_choices": int((r.slots == E * C).sum()),
           "layer_ms": ms}
    if not (dispatch_equal and err <= tol and out["aux_equal"]
            and out["dropped_choices"] > 0 and torch.isfinite(y).all()):
        raise AssertionError(f"moe_serve: the indexed route differs from "
                             f"the dense one: {out}")
    return out


def _moe_step_logits(model, seed=4):
    """One decode step of the MoE GPT ``model`` (a rank's shards under a
    mesh) over 8 rows prefilled through ``prefill_paged`` from empty
    pools: the logits through K4 and through its plain version, in bf16
    and on fp32 copies of the same weights and K/V (``{"bf16": (k4,
    plain), "fp32": (k4, plain)}``)."""
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_layers
    hd = cfg.hidden_size // cfg.num_heads
    nh = model.decode_state()["lws"]["qkv_w"].shape[-1] // 3 // hd
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 129, 8)
    S, bs, chunk = SERVEMP_S, 16, 128
    max_blocks = S // bs
    bt = torch.arange(1, 8 * max_blocks + 1, dtype=torch.int32,
                      device="cuda").reshape(8, max_blocks)
    tok = torch.from_numpy(rng.integers(0, V, 8).astype(np.int32)).cuda()
    pos = torch.from_numpy(lens.astype(np.int32)).cuda()
    prompts = [rng.integers(0, V, int(n)) for n in lens]
    out = {}
    for name, w, dt in (("bf16", model.decode_state(), torch.bfloat16),
                        ("fp32", _fp32_state(model.decode_state()),
                         torch.float32)):
        pools = [torch.zeros((L, 8 * max_blocks + 1, bs, nh, hd), dtype=dt,
                             device="cuda") for _ in "kv"]
        for b, p in enumerate(prompts):
            ids = np.zeros((1, bucket_length(len(p), 8, chunk)), np.int64)
            ids[0, :len(p)] = p
            model.prefill_paged(w, torch.from_numpy(ids).cuda(), 0, len(p),
                                bt[b], *pools)
        out[name] = [model.decode_paged(w, tok, pos, bt,
                                        *[t.clone() for t in pools],
                                        kernel=kernel)
                     for kernel in (True, False)]
        del pools, w
    torch.cuda.synchronize()
    return out


def _fp32_within_floor(rec):
    """The fp32 half of ``_self_calibrated``'s gate on one of its records:
    the two fp32 paths' logits within ``SELF_CALIBRATED_FLOOR`` of their
    scale.  In fp32 the 24-layer MoE model's routing holds between two
    correct paths (their logits differ by sum order, 1e-6 of the scale),
    so a wrong kernel or a wrong shard fails it; in bf16 the router flips
    near-ties, and the bf16 numbers are printed."""
    return (math.isfinite(rec["max_abs_err_fp32"])
            and rec["max_abs_err_fp32"] <= rec["floor"])


def _moe_in_model(logits, phase, layers):
    """:func:`_moe_step_logits`' K4 path (a) against its plain path (b):
    ``_self_calibrated_record``'s numbers and whether its gates pass."""
    rec, ok = _self_calibrated_record(*logits["bf16"], *logits["fp32"],
                                      SELF_CALIBRATED_FLOOR, "max")
    rec.update(phase=phase, layers=layers, rows=8,
               check="K4 (a) vs plain attention (b), bf16 and fp32",
               passes=ok)
    return rec, ok


def moe_serve_phase():
    """The MoE GPT served through the normal entry points: GPT-3 760M
    widths (24 layers, 16 heads of 96) with 8 experts a layer, top-2,
    capacity factor 1.25, bf16, servemp's 8 requests (32-128 prompt
    tokens, 24 new, 8 slots, blocks of 16, chunks of 128) through
    ``LLMEngine(kv_layout="paged")`` (K4), then with ``kv_dtype="int8"``
    and ``weight_dtype="int8"`` (K4q; the expert stacks stay bf16), then
    the slot layout.  Gates: K4/K4q launches == decode steps x 24 (the
    counted runs); layer 0's indexed MoE FFN against the dense route at
    the phase's prefill and decode T; a 2-layer model at this width held
    by ``_self_calibrated`` (K4 vs plain, bf16 vs fp32); the 24-layer
    model's fp32 logits through K4 and through plain attention within the
    floor (:func:`_fp32_within_floor`; its bf16 numbers printed).  Prints decode tokens/s, step
    ms p50, weight bytes and the share of decode choices dropped."""
    _free_cuda()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = _moe_serve_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _servemp_prompts(model.config.vocab_size)
    rec, toks, snap, eng = _moe_run(model, prompts, "moe_serve", base=m0)
    route = [_moe_route_check(eng._w["lws"], T, seed)
             for T, seed in ((128, 1), (eng.max_slots, 2))]
    del eng
    q8 = dict(kv_dtype="int8", weight_dtype="int8")
    rec8, toks8, snap8, eng = _moe_run(model, prompts, "moe_serve_int8",
                                       base=m0, **q8)
    experts_bf16 = all(eng._w["lws"][n].dtype == torch.bfloat16
                       for n in ("fc1_w", "fc2_w", "gate_w"))
    quantized = sorted(k for k in eng._w["lws"] if k.endswith("__scale"))
    del eng, snap8
    slot = LLMEngine(model, max_slots=8, max_seq_len=SERVEMP_S)
    slot.generate([prompts[0][:16]], max_new_tokens=2)
    _, slot_handles, _ = _serve_counted(slot, prompts, SERVEMP_NEW,
                                        "moe_serve_slots")
    bar = float(np.mean([x == y for h, b in zip(slot_handles, toks)
                         for x, y in zip(h.tokens, b)]))
    del slot, slot_handles
    _free_cuda()
    step = {"24_layers": _moe_step_logits(model)}
    full, _ = _moe_in_model(step["24_layers"], "moe_in_model_24_layers", 24)
    two_layer = _moe_serve_model(2)
    step["2_layers"] = _moe_step_logits(two_layer)
    two, two_ok = _moe_in_model(step["2_layers"], "moe_in_model", 2)
    del two_layer
    _free_cuda()
    record = {"phase": "moe_serve", "card": CARD,
              "model": "gpt3_760m widths, 8 experts top-2 cf 1.25, bf16",
              "parameters": sum(t.numel() for t in
                                model._weights().values()),
              "init_s": init_s, "requests": SERVEMP_N,
              "new_tokens": SERVEMP_NEW,
              "launches": {**rec["launches"],
                           "paged_decode_attention_int8":
                               rec8["launches"]["paged_decode_attention_int8"]},
              "decode_steps": rec["decode_steps"],
              "decode_tokens_per_s": rec["decode_tokens_per_s"],
              "decode_step_ms_p50": rec["decode_step_ms_p50"],
              "int8_decode_tokens_per_s": rec8["decode_tokens_per_s"],
              "int8_decode_step_ms_p50": rec8["decode_step_ms_p50"],
              "weight_bytes_per_chip": rec["weight_bytes_per_chip"],
              "int8_weight_bytes_per_chip": rec8["weight_bytes_per_chip"],
              "int8_quantized": quantized,
              "int8_experts_left_bf16": experts_bf16,
              "dropped_share_decode": rec["dropped_share_decode"],
              "int8_dropped_share_decode": rec8["dropped_share_decode"],
              "dropped_by_tokens": rec["moe_dropped_by_tokens"],
              "slot_vs_paged_agreement": bar,
              "int8_vs_bf16_agreement": float(np.mean(
                  [x == y for a, b in zip(toks8, toks)
                   for x, y in zip(a, b)])),
              "route_vs_dense": route, "in_model_2_layers": two,
              "in_model_24_layers_reported": full,
              "peak_mem_gb": rec["peak_mem_gb"]}
    emit(record)
    if not two_ok:
        raise AssertionError(f"moe_serve: the 2-layer in-model check "
                             f"failed: {two}")
    if not _fp32_within_floor(full):
        raise AssertionError(f"moe_serve: the 24-layer model's fp32 logits "
                             f"through K4 and through plain attention "
                             f"differ: {full}")
    if not experts_bf16 or any(k.split("__")[0] not in ("qkv_w", "proj_w")
                               for k in quantized):
        raise AssertionError(f"moe_serve: int8 PTQ touched the expert "
                             f"stacks: {quantized}")
    if not record["dropped_share_decode"]:
        raise AssertionError("moe_serve: no decode step dropped a choice "
                             f"({record['dropped_by_tokens']})")
    rows = _head_slice_times(snap, 16, record["launches"])
    emit({"phase": "moe_serve_times", "card": CARD, "heads": "16 x 96",
          "kernels": rows})
    return {"model": model, "prompts": prompts, "tokens": toks, "bar": bar,
            "step_logits": {t: {k: v[0].cpu() for k, v in d.items()}
                            for t, d in step.items()},
            "unsharded_bytes": (rec["kv_pool_bytes_per_chip"]
                                + rec["weight_bytes_per_chip"]),
            "unsharded_allocated": rec["allocated_bytes"], "rows": rows,
            "record": record}


def _moe_first_step_gates(first):
    """moe_train's first-step gates on :func:`_moe_train_first_step`'s
    runs, self-calibrated where MoE routing allows it.  A router's top-k
    flips on a near-tie for any perturbation, and a flip moves a token's
    output (and, past capacity, which tokens drop), so two paths of one
    step agree token by token in neither dtype (per-token fp32 losses of
    the kernel and plain paths differ by up to 0.098 on an NVIDIA H100
    80GB HBM3, 700.00 W).  Gated:

    * fp32: the batch-mean loss and the aux of the kernel path (a) and
      the plain path (b) within ``SELF_CALIBRATED_FLOOR`` of the scale
      (the mean averages the flips away);
    * bf16: the RMS distance of a path's per-token bf16 losses from its
      own fp32 run, over the batch's 8192 tokens, within
      ``ROW_RMS_FACTOR`` times the other path's (a kernel that adds error
      in bf16 stands out against the other path's rounding and routing
      noise; by sequence, 1024 tokens, the two paths' noise differed by
      up to 15 %);
    * each path's bf16 aux within ``MOE_AUX_ULPS`` bf16 ulps of its fp32
      aux."""
    means = {k: float(v[0].mean()) for k, v in first.items()}
    aux = {k: float(v[1]) for k, v in first.items()}
    floor = {n: SELF_CALIBRATED_FLOOR * max(1.0, abs(d["b32"]))
             for n, d in (("loss", means), ("aux", aux))}
    aux_tol = MOE_AUX_ULPS * 2.0 ** -8 * abs(aux["b32"])
    rms = {p: (first[p + "16"][0] - first[p + "32"][0]).pow(2).mean().sqrt()
           for p in "ab"}
    ratio = {p: float((rms[p] / (ROW_RMS_FACTOR * rms[q]
                                  + floor["loss"])).max())
             for p, q in (("a", "b"), ("b", "a"))}
    out = {"mean_loss": means, "aux": aux, "floor": floor,
           "aux_tol": aux_tol,
           "bf16_rms_noise": {p: float(rms[p]) for p in "ab"},
           "noise_over_bound": ratio,
           "fp32_token_max_abs_err": float(
               (first["a32"][0] - first["b32"][0]).abs().max())}
    ok = (abs(means["a32"] - means["b32"]) <= floor["loss"]
          and abs(aux["a32"] - aux["b32"]) <= floor["aux"]
          and all(r <= 1.0 for r in ratio.values())
          and all(abs(aux[p + "16"] - aux[p + "32"]) <= aux_tol
                  for p in "ab"))
    if not ok:
        raise AssertionError(f"moe_train first step: {out}")
    return out


def _moe_train_first_step(model, ids, labels):
    """The first batch's per-token losses ``[B, S]`` and aux through the
    kernels (a) and their plain versions (b), in bf16 and on an fp32 copy
    of the same weights."""
    cfg = _moe_train_cfg()
    cfg.dtype = "float32"
    f32 = GPTForCausalLM(cfg, device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(0))
    with torch.no_grad():
        for n, t in f32._weights().items():
            t.copy_(model._weights()[n].float())
        out = {}
        for tag, m in (("16", model), ("32", f32)):
            for path, kernel in (("a", True), ("b", False)):
                lg = m(ids, kernel=kernel).float()
                tok = (torch.logsumexp(lg, -1)
                       - lg.gather(-1, labels[..., None])[..., 0])
                out[path + tag] = (tok, m.moe_aux_loss().float())
                del lg
    del f32
    _free_cuda()
    return out


def moe_train_phase():
    """MoE GPT training through ``CompiledTrainStep``: GPT-3 125M widths
    (12 layers, 12 heads of 64) with 8 experts a layer (0.52 B
    parameters), bf16, ``recompute="selective"`` (the MoE FFN replays),
    batch 8 x 1024, :func:`_loop`'s AdamW, loss ``crit + 0.01 * aux``.
    8 single steps, then from the same weights a priming window and a
    captured window of ``fused_steps=4``: losses, parameters and
    optimizer state bit for bit the single steps'.  K1–K3 launches ==
    steps x 12 x their per-layer count in every single step and in both
    windows (their sum is the row's count); losses finite; the first batch's
    loss and aux through the kernels and their plain versions in bf16 and
    fp32 held by ``_self_calibrated``.  Prints step ms p50, tokens/s,
    peak memory and the aux."""
    cfg = _moe_train_cfg()
    K, L = FUSED_K, cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(17)
    args = tuple(torch.randint(0, cfg.vocab_size, (MOE_STEPS, MOE_B,
                                                   TRAIN_S),
                               generator=gen, device="cuda")
                 for _ in range(2))
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    model = _moe_train_model()
    first = _moe_train_first_step(model, args[0][0], args[1][0])
    calib = _moe_first_step_gates(first)
    del first
    runs = {}
    for k in (1, K):
        if k == K:
            model = _moe_train_model()
        sched, opt, step = _loop(model, "gpt3_125m", k=k,
                                 loss_fn=_moe_loss(), metrics=False)
        losses, launches, step_s, auxs = [], [], [], []
        bounds = ([(i, i + 1) for i in range(MOE_STEPS)] if k == 1
                  else [(0, K), (K, 2 * K)])
        for lo, hi in bounds:
            _reset_flash_counts()
            before = counters.snapshot()
            t = time.perf_counter()
            if k == 1:
                losses.append(step(*(a[lo] for a in args))[None])
                auxs.append(model.moe_aux_loss().detach().float())
            else:
                losses.append(step(_window(args, lo, hi)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            launches.append((counters.delta(before), _flash_counts()))
            for _ in range(hi - lo):
                sched.step()
        runs[k] = (torch.cat(losses), _snapshot(model, opt), launches,
                   step_s, auxs)
        del model, opt, step
        _free_cuda()
    (l1, s1, n1, t1, auxs), (l4, s4, n4, _, _) = runs[1], runs[K]
    per = _flash_per_layer_step(cfg.recompute)
    want1 = {n: c * L for n, c in per.items()}
    wantK = {n: c * L * K for n, c in per.items()}
    step_ms = float(np.median(t1[2:])) * 1e3
    record = {"phase": "moe_train", "card": CARD,
              "model": "gpt3_125m widths, 8 experts top-2 cf 1.25, bf16, "
                       "selective", "layers": L, "batch": [MOE_B, TRAIN_S],
              "parameters": sum(t.numel() for t in s1[0]),
              "losses": l1.tolist(), "aux": [float(a) for a in auxs],
              "fused_bit_identical": {
                  "losses": torch.equal(l1, l4),
                  "state": _same_state(s1, s4)},
              "captured_window": n4[1][0].get("jit.captures", 0),
              "window_dispatches": n4[1][0].get("jit.host.dispatches"),
              "launches_single": [f for _, f in n1],
              "launches_windows": [f for _, f in n4],
              "launches_want": {"single": want1, "window": wantK},
              "step_ms_p50": step_ms,
              "tokens_per_s": MOE_B * TRAIN_S / (step_ms / 1e3),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "first_step_self_calibrated": calib}
    emit(record)
    if not bool(torch.isfinite(l1).all()):
        raise AssertionError(f"moe_train: non-finite losses {record}")
    if not all(record["fused_bit_identical"].values()):
        raise AssertionError(f"moe_train: the captured window differs "
                             f"from 4 single steps: {record}")
    if record["captured_window"] != 1 or record["window_dispatches"] != 1:
        raise AssertionError(f"moe_train: no captured window: {record}")
    if any(f != want1 for f in record["launches_single"]) \
            or any(f != wantK for f in record["launches_windows"]):
        raise AssertionError(f"moe_train: K1-K3 launches {record}")
    # the launches counted in this run: every single step and both windows
    return {n: sum(f[n] for f in record["launches_single"]
                   + record["launches_windows"]) for n in per}


def _moe_ep_rank(rank, world, pl):
    """One rank of moe_ep_2rank: moe_train's model built under a dp2 mesh
    (this rank's 4 experts of 8), 3 steps of :func:`_loop` on its rows of
    the global batch, and two controls: the model built whole before the
    mesh, so each rank routes and capacitates its own tokens
    (``local_capacity``), and the expert stacks' gradients all-reduced
    over dp as a replicated parameter's are (``experts_allreduced``);
    then the moe_serve model built under an mp2 mesh serving moe_serve's
    requests."""
    from paddle_tpu_torch import distributed as D
    ids, labels = (torch.from_numpy(pl[k]).cuda() for k in ("ids", "labels"))
    out = {}
    for name in MOE_EP_RUNS:
        D.set_mesh(None)
        if name == "local_capacity":
            model = _moe_train_model(MOE_EP_LAYERS)
            mesh = D.build_mesh({"dp": world})
        else:
            mesh = D.build_mesh({"dp": world})
            model = _moe_train_model(MOE_EP_LAYERS)
        init = model.gather_numpy_state()
        sched, opt, step = _loop(model, "gpt3_125m", k=1, mesh=mesh,
                                 loss_fn=_moe_loss(), metrics=False)
        if name == "experts_allreduced":
            step._mesh.experts = {}
        _reset_flash_counts()
        c0 = counters.get("dist.ep_collectives")
        losses = []
        for i in range(MESH2_STEPS):
            losses.append(float(step(ids[i], labels[i])))
            sched.step()
        out[name] = {"losses": losses, "launches": _flash_counts(),
                     "update_rel_err": _update_rel_err(
                         init, _masters(model, opt), pl["d_ref"]),
                     "fc1_w": list(model.fc1_w.shape),
                     "ep_collectives": counters.get("dist.ep_collectives")
                     - c0}
        del model, opt, step, init
        _free_cuda()
    D.set_mesh(None)
    mesh = D.build_mesh({"mp": world})
    m0 = torch.cuda.memory_allocated()
    model = _moe_serve_model()
    rec, toks, _, eng = _moe_run(model, pl["prompts"],
                                 f"moe_serve_mp2_rank{rank}", mesh=mesh,
                                 base=m0)
    del eng
    calib = {}
    for tag, m in (("24_layers", model), ("2_layers", None)):
        m = m or _moe_serve_model(2)
        step = _moe_step_logits(m)
        want = pl["step_logits"][tag]
        calib[tag] = _self_calibrated_record(
            step["bf16"][0], want["bf16"].cuda(), step["fp32"][0],
            want["fp32"].cuda(), SELF_CALIBRATED_FLOOR, "max")
        del step, m
    out["mp2"] = {"tokens": toks, "launches": rec["launches"],
                  "vs_unsharded_step": calib,
                  "vs_unsharded_passes": calib["2_layers"][1],
                  "decode_steps": rec["decode_steps"],
                  "decode_tokens_per_s": rec["decode_tokens_per_s"],
                  "bytes": (rec["kv_pool_bytes_per_chip"]
                            + rec["weight_bytes_per_chip"]),
                  "allocated": rec["allocated_bytes"],
                  "fc1_w": list(model.decode_state()["lws"]["fc1_w"].shape),
                  "mesh_tag": rec["mesh_tag"],
                  "rank_disagreements": rec["rank_disagreements"]}
    return out


def moe_ep_2rank_phase(ms):
    """Expert parallelism across two processes on this card (gloo: a
    correctness run; ``fused_steps=1``).  dp2: moe_train's model and
    global batch of 8 x 1024 rows, each rank its 4 rows and its 4
    experts (``fc1_w [12, 4, 768, 3072]``), 3 steps of :func:`_loop` with
    the schedule stepped (two updates): losses within
    ``MOE_EP_LOSS_ATOL`` of this process's one-process step on the global
    batch, every fp32 master's change within ``MOE_EP_UPDATE_RTOL``; the
    control that capacitates each rank's own tokens must exceed the loss
    limit and the one that all-reduces the expert stacks' gradients the
    update limit; K1–K3 launches == steps x 12 x their per-layer count.
    mp2 serving: moe_serve's model built under the mesh (the experts'
    hidden units split), its 8 requests: one decode step's logits of a
    2-layer model at this width against the unsharded model's held by
    ``_self_calibrated``, the 24-layer model's fp32 logits within its
    floor of the unsharded model's (:func:`_fp32_within_floor`; its bf16
    numbers printed), greedy agreement with the unsharded MoE engine >=
    moe_serve's slot-vs-paged agreement (a weak bar: bf16 routing flips
    make two correct engines of this model agree on few tokens), no rank
    disagreement, K4 launches == decode steps x 24, per-rank KV + weight
    bytes and device memory <= ``SERVEMP_MAX_HBM_FRAC`` of unsharded.
    The training runs ``MOE_EP_LAYERS`` layers."""
    cfg = _moe_train_cfg(MOE_EP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(19)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (MESH2_STEPS, MOE_B, TRAIN_S),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    model = _moe_train_model(MOE_EP_LAYERS)
    init = model.gather_numpy_state()
    sched, opt, step = _loop(model, "gpt3_125m", k=1, loss_fn=_moe_loss(),
                             metrics=False)
    ref = []
    for i in range(MESH2_STEPS):
        ref.append(float(step(ids[i], labels[i])))
        sched.step()
    d_ref = {n: v - init[n] for n, v in _masters(model, opt).items()}
    del model, opt, step, init
    _free_cuda()
    res = _spawn_ranks("_moe_ep_rank", 2, {
        "ids": ids.cpu().numpy(), "labels": labels.cpu().numpy(),
        "d_ref": d_ref, "prompts": ms["prompts"],
        "step_logits": ms["step_logits"]})
    del d_ref
    per = _flash_per_layer_step(cfg.recompute)
    want = {n: c * cfg.num_layers * MESH2_STEPS for n, c in per.items()}
    record = {"phase": "moe_ep_2rank", "card": CARD,
              "model": "gpt3_125m widths, 8 experts, bf16 selective",
              "mesh": "dp2 (gloo, 2 processes)", "batch": [MOE_B, TRAIN_S],
              "one_process_losses": ref, "loss_atol": MOE_EP_LOSS_ATOL,
              "update_rtol": MOE_EP_UPDATE_RTOL, "launches_want": want}
    for name in MOE_EP_RUNS:
        errs = [r[name]["update_rel_err"] for r in res]
        worst_n = max((n for n in errs[0] if n != NOISE_ONLY),
                      key=lambda n: max(e[n] for e in errs))
        record[name] = {
            "losses": [r[name]["losses"] for r in res],
            "max_loss_err": max(abs(a - b) for r in res
                                for a, b in zip(r[name]["losses"], ref)),
            "max_update_rel_err": max(e[worst_n] for e in errs),
            "worst_param": worst_n,
            "noise_only_rel_err": max(e[NOISE_ONLY] for e in errs),
            "update_rel_err_rank0": errs[0],
            "launches": [r[name]["launches"] for r in res],
            "ep_collectives": [r[name]["ep_collectives"] for r in res],
            "fc1_w_shard": res[0][name]["fc1_w"]}
    mp2 = [r["mp2"] for r in res]
    record["mp2"] = {
        "mesh": "mp2 (gloo, 2 processes)",
        "agreement_with_unsharded": float(np.mean(
            [x == y for a, b in zip(mp2[0]["tokens"], ms["tokens"])
             for x, y in zip(a, b)])),
        "bar": ms["bar"],
        "rank_disagreements": [r["rank_disagreements"] for r in mp2],
        "hbm_frac": [r["bytes"] / ms["unsharded_bytes"] for r in mp2],
        "allocated_frac": [r["allocated"] / ms["unsharded_allocated"]
                           for r in mp2],
        "fc1_w_shard": mp2[0]["fc1_w"], "launches": [r["launches"]
                                                      for r in mp2],
        "decode_steps": mp2[0]["decode_steps"],
        "decode_tokens_per_s": [r["decode_tokens_per_s"] for r in mp2],
        "mesh_tag": mp2[0]["mesh_tag"],
        "vs_unsharded_step": [r["vs_unsharded_step"] for r in mp2]}
    emit(record)
    r = record["dp2"]
    if r["max_loss_err"] > MOE_EP_LOSS_ATOL \
            or r["max_update_rel_err"] > MOE_EP_UPDATE_RTOL:
        raise AssertionError(f"moe_ep_2rank dp2: differs from one process "
                             f"on the global batch: {r} vs {ref}")
    if any(l != want for l in r["launches"]) \
            or r["fc1_w_shard"] != [cfg.num_layers, 4, 768, 3072] \
            or not all(r["ep_collectives"]):
        raise AssertionError(f"moe_ep_2rank dp2: launches, shards or "
                             f"exchanges: {r}")
    if record["local_capacity"]["max_loss_err"] <= MOE_EP_LOSS_ATOL \
            or record["experts_allreduced"]["max_update_rel_err"] \
            <= MOE_EP_UPDATE_RTOL:
        raise AssertionError(
            "moe_ep_2rank: a control passes the gate it must fail: "
            f"{record['local_capacity']} {record['experts_allreduced']}")
    m = record["mp2"]
    if any(m["rank_disagreements"]) or m["mesh_tag"] != "[mp2]" \
            or m["fc1_w_shard"] != [24, MOE_E, 1536, 3072]:
        raise AssertionError(f"moe_ep_2rank mp2: {m}")
    if not all(r["vs_unsharded_passes"] for r in mp2) \
            or not all(_fp32_within_floor(r["vs_unsharded_step"]
                                          ["24_layers"][0]) for r in mp2):
        raise AssertionError(f"moe_ep_2rank mp2: a decode step's logits "
                             f"against the unsharded engine's: {m}")
    if m["agreement_with_unsharded"] < ms["bar"]:
        raise AssertionError(f"moe_ep_2rank mp2: agreement "
                             f"{m['agreement_with_unsharded']} < the bar "
                             f"{ms['bar']}")
    if max(m["hbm_frac"] + m["allocated_frac"]) > SERVEMP_MAX_HBM_FRAC:
        raise AssertionError(f"moe_ep_2rank mp2: per-rank bytes {m}")
    # rank 0's counts (each rank's equal ``want``, checked above)
    return {n: record["dp2"]["launches"][0][n] for n in per}


def moe_flash_rows(train_launches, ep_launches):
    """K1–K3 at moe_train's shape (8 x 12 heads of 64, S 1024, causal),
    which is each EP rank's too (its rows: 4 x 12 x 64), against their
    plain versions and timed; returns rows by kernel."""
    worst = dict.fromkeys(("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0.0)
    ratio = dict(worst)
    _flash_check(torch.Generator(device="cuda").manual_seed(37),
                 [(MOE_B, 12, TRAIN_S, 64, torch.bfloat16, True)], worst,
                 ratio)
    errs = {"flash_fwd": max(worst["flash_fwd"], worst["flash_fwd_lse"]),
            "flash_bwd_dq": worst["flash_bwd_dq"],
            "flash_bwd_dkv": worst["flash_bwd_dkv"]}
    rows = {}
    for n, t in _flash_shape_times(MOE_B, 12, TRAIN_S, 64, True,
                                   seed=38).items():
        emit(t)
        rows[n] = {"shape": t["shape"], "launches": train_launches[n],
                   "ep_2rank_launches_per_rank": ep_launches[n],
                   "max_abs_err": errs[n], "ms": t["kernel_us"] / 1e3,
                   "plain_ms": t["plain_us"] / 1e3,
                   "bound_ms": t["bound_us"] / 1e3,
                   "bound_by": t["bound_by"],
                   "library_ms": t["library_us"] / 1e3,
                   "share_of_bound": t["share_of_bound"]}
    return rows


# -- long-context training over sep: ring attention, the sequence split -------

#: cp_train_2rank: GPT-3 125M at full width and ``CP_LAYERS`` of its 12
#: layers (cut for the script's time limit) over a sequence of 8192
#: tokens (its learned position table grows to 8192 rows), batch 2, 3
#: AdamW steps through :func:`_loop`, sep 2 (chunks of 4096)
CP_S, CP_B, CP_STEPS, CP_LAYERS = 8192, 2, 3, 6
#: the limits of the sep-2 losses against one process over the whole
#: sequence, and of each fp32 master's change (``MESH2_*``'s measures),
#: between the sound run and the control without rotation (each rank
#: attending within its own chunk), which must miss both.  On an NVIDIA
#: H100 80GB HBM3, 700.00 W: sound loss 5.72e-5, update 0.0269
#: (``qkv_w``); control 1.97e-3 and 0.844 (``proj_w``)
CP_LOSS_ATOL, CP_UPDATE_RTOL = 5e-4, 0.1
#: the dropout rate of one more sep-2 step and one-process step, whose
#: peak memories are compared (a rank draws only its chunk's masks)
CP_DROPOUT = 0.1
#: the ring alone (a): B 1, S 8192 (two chunks of 4096), 12 heads of 64;
#: the kernel ring against the plain one at S 2048
CP_RING = (1, 8192, 12, 64)
CP_PLAIN_S = 2048
#: the row RMS factor of the bf16 ring against the whole sequence's K1–K3:
#: the ring rounds more often by construction (each chunk pair's O in
#: bf16 before the fp32 merge, and a chunk's dQ/dK/dV summed in bf16 over
#: its pairs, up to three roundings where one flash call rounds once:
#: sqrt(3) = 1.73 of its noise); the kernel ring against the plain ring
#: (the same roundings) keeps ``ROW_RMS_FACTOR``
CP_RING_RMS_FACTOR = 2.0


def _cp_cfg(context_parallel=True, dropout=0.0):
    cfg = GPTConfig.gpt3_125m(
        vocab_size=50304, max_seq_len=CP_S, dtype="bfloat16",
        recompute="selective", context_parallel=context_parallel,
        sequence_parallel=True, dropout=dropout)
    cfg.num_layers = CP_LAYERS
    return cfg


def _cp_ring_run(qkv, do, dtype, causal, mesh, rank, world, kernel=True):
    """The ring on this rank's chunks of the global fp32 ``qkv``/``do``
    in ``dtype``, and ``flash_attention_with_lse`` over the whole sequence
    in this process: ``(ring, whole)``, each ``[o, dq, dk, dv]`` of this
    rank's chunk as fp32 rows, each the heads of 64 tokens (``[B * S /
    64, 64 * H * D]``): rows of one token's D or H * D elements make the
    gates' row RMS swing (causal dK's last keys take one query's
    gradient each)."""
    from paddle_tpu_torch.kernels.ring_attention import ring_attention
    _, S, H, D = qkv[0].shape
    n = S // world
    sl = slice(rank * n, (rank + 1) * n)
    loc = [t[:, sl].to(dtype).requires_grad_() for t in qkv]
    o = ring_attention(*loc, causal=causal, mesh=mesh, kernel=kernel)
    o.backward(do[:, sl].to(dtype))
    ring = [o.detach()] + [t.grad for t in loc]
    whole = None
    if kernel:
        full = [t.to(dtype).transpose(1, 2).requires_grad_() for t in qkv]
        ow, _ = fa.flash_attention_with_lse(*full, causal, 1.0 / math.sqrt(D))
        ow.backward(do.to(dtype).transpose(1, 2))
        whole = [t.transpose(1, 2)[:, sl] for t in
                 [ow.detach()] + [t.grad for t in full]]
    rows = lambda ts: None if ts is None else [
        t.float().reshape(-1, 64 * H * D) for t in ts]
    return rows(ring), rows(whole)


def _cp_ring_checks(rank, world, mesh):
    """(a): the ring at ``CP_RING``, causal and not, in bf16 and fp32,
    against ``flash_attention_with_lse`` over the whole sequence in one
    process (K1–K3 at S 8192), by :func:`_self_calibrated` on each of O,
    dQ, dK and dV; then the kernel ring against the plain ring
    (``kernel=False``) at S ``CP_PLAIN_S``, the same way."""
    B, S, H, D = CP_RING
    out = {}
    for causal in (True, False):
        for s in (S, CP_PLAIN_S):
            gen = torch.Generator(device="cuda").manual_seed(41 + s)
            qkv = [torch.randn(B, s, H, D, generator=gen, device="cuda")
                   for _ in range(3)]
            do = torch.randn(B, s, H, D, generator=gen, device="cuda")
            if s == S:
                (r16, w16), (r32, w32) = (_cp_ring_run(
                    qkv, do, dt, causal, mesh, rank, world)
                    for dt in (torch.bfloat16, torch.float32))
                pairs = (r16, w16, r32, w32)
                what = "ring_vs_whole"
            else:
                (k16, _), (k32, _), (p16, _), (p32, _) = (
                    _cp_ring_run(qkv, do, dt, causal, mesh, rank, world,
                                 kernel=kern)
                    for kern in (True, False)
                    for dt in (torch.bfloat16, torch.float32))
                pairs = (k16, p16, k32, p32)
                what = "kernel_vs_plain_ring"
            tag = f"{what}_{'causal' if causal else 'full'}_S{s}"
            factor = (CP_RING_RMS_FACTOR if s == S else ROW_RMS_FACTOR)
            out[tag] = {
                name: _self_calibrated(f"cp_train_2rank {tag} {name}",
                                       *(p[i] for p in pairs),
                                       row_stat="rms", rms_factor=factor)
                for i, name in enumerate(("o", "dq", "dk", "dv"))}
            del qkv, do, pairs
    return out


def _cp_no_rotation(q, k, v, causal=True, scale=None, axis="sep",
                    mesh=None, kernel=True):
    """The control's attention: a ring that does not rotate, each rank
    attending within its own chunk only."""
    return fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                  kernel=kernel)


def _cp_train(pl, mesh, cfg, steps, control=False):
    """``cfg`` (seed-0 weights) built under ``mesh`` and trained
    ``steps`` steps on the global batch through :func:`_loop`, its
    schedule stepped: losses, each fp32 master's change against the
    one-process change, the K1–K3 launches, the counters moved, the
    grad norms and this process's peak device memory (over what was
    allocated before the model)."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    ids, labels = (torch.from_numpy(pl[k]).cuda() for k in ("ids", "labels"))
    m0 = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init = model.gather_numpy_state()
    sched, opt, step = _loop(model, "gpt3_125m", k=1, mesh=mesh)
    ring = gpt_mod.ring_attention
    if control:
        gpt_mod.ring_attention = _cp_no_rotation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    c0 = counters.snapshot()
    try:
        losses = []
        for i in range(steps):
            losses.append(float(step(ids[i], labels[i])))
            sched.step()
    finally:
        gpt_mod.ring_attention = ring
    torch.cuda.synchronize()
    moved = counters.delta(c0)
    rec = {"losses": losses, "launches": _flash_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated() - m0,
           "collectives": moved.get("dist.collective_launches", 0),
           "ring_shifts": moved.get("dist.ring_shifts", 0),
           "sep_collectives": moved.get("dist.sep_collectives", 0),
           "fallbacks": moved.get("kernels.flash.reference_fallbacks", 0)}
    step.sync()
    rec["grad_norms"] = [v for _, v in step.metrics.series("grad_norm")]
    if steps == CP_STEPS:
        rec["update_rel_err"] = _update_rel_err(init, _masters(model, opt),
                                                pl["d_ref"])
    del model, opt, step, init
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _cp_sp_linears(rank, world):
    """(e): ``ScatterOp -> ColumnSequenceParallelLinear -> gelu ->
    RowSequenceParallelLinear -> GatherOp`` at mp 2 in fp32 (B 2, S 2048,
    768 -> 3072 -> 768, 125M's FFN) against the dense chain on this
    rank, forward and gradients (the sharded ones gathered whole)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding_utils import (gather_shard,
                                                             local_shard)
    D.set_mesh(None)
    mesh = D.build_mesh({"mp": world})
    gen = torch.Generator(device="cuda").manual_seed(43)
    x = torch.randn(2, 2048, 768, generator=gen, device="cuda")
    full = {"w1": torch.randn(768, 3072, generator=gen, device="cuda") / 28,
            "b1": torch.randn(3072, generator=gen, device="cuda"),
            "w2": torch.randn(3072, 768, generator=gen, device="cuda") / 56,
            "b2": torch.randn(768, generator=gen, device="cuda")}
    dy = torch.randn(2, 2048, 768, generator=gen, device="cuda")
    col = fleet.ColumnSequenceParallelLinear(768, 3072, has_bias=True)
    row = fleet.RowSequenceParallelLinear(3072, 768, has_bias=True)
    ps = {"w1": col.weight, "b1": col.bias, "w2": row.weight, "b2": row.bias}
    with torch.no_grad():
        for n, p in ps.items():
            t = p._data
            t.copy_(local_shard(full[n], t.placements, mesh))
    xs = paddle.to_tensor(x, stop_gradient=False)
    y = fleet.GatherOp.apply(row(paddle.nn.functional.gelu(
        col(fleet.ScatterOp.apply(xs)))))
    y._data.backward(dy)
    got = {"y": y._data.detach(), "dx": xs.grad._data}
    for n, p in ps.items():
        t = p._data
        got[n] = (gather_shard(t.grad, t.placements, mesh)
                  if any(e is not None for e in t.placements) else t.grad)
    ref = {n: t.detach().clone().requires_grad_() for n, t in full.items()}
    xr = x.detach().clone().requires_grad_()
    yr = F.gelu(xr @ ref["w1"] + ref["b1"]) @ ref["w2"] + ref["b2"]
    yr.backward(dy)
    want = {"y": yr.detach(), "dx": xr.grad,
            **{n: t.grad for n, t in ref.items()}}
    errs = {n: float((got[n] - want[n]).abs().max()
                     / want[n].abs().max()) for n in want}
    return {"rel_err": errs, "max_rel_err": max(errs.values())}


def _cp_rank(rank, world, pl):
    """One rank of cp_train_2rank: (a) the ring alone, (b) GPT-3 125M
    over sep 2 (the context-parallel run, its control without rotation,
    the sequence_parallel-only route, one context-parallel step with
    dropout), (e) the sequence-parallel linears after a re-mesh to
    mp 2."""
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"sep": world})
    out = {"ring": _cp_ring_checks(rank, world, mesh)}
    _free_cuda()
    out["cp"] = _cp_train(pl, mesh, _cp_cfg(), CP_STEPS)
    out["control"] = _cp_train(pl, mesh, _cp_cfg(), CP_STEPS, control=True)
    out["sp_only"] = _cp_train(pl, mesh, _cp_cfg(context_parallel=False),
                               CP_STEPS)
    out["dropout"] = _cp_train(pl, mesh, _cp_cfg(dropout=CP_DROPOUT), 1)
    out["sp_linears"] = _cp_sp_linears(rank, world)
    return out


def _cp_launches_want(rank):
    """K1–K3 launches of one sep-2 rank over ``CP_STEPS`` causal steps:
    rank r visits r + 1 chunks a layer (its diagonal, then the older
    ones); selective recompute replays each K1 once; K2/K3 once each."""
    per = _flash_per_layer_step("selective")
    return {n: c * (rank + 1) * CP_LAYERS * CP_STEPS
            for n, c in per.items()}


def _cp_one_process_dropout(ids, labels):
    """One step of the one-process run with dropout ``CP_DROPOUT`` on the
    first batch: its loss and its peak device memory over what was
    allocated before its model."""
    m0 = torch.cuda.memory_allocated()
    model = GPTForCausalLM(_cp_cfg(dropout=CP_DROPOUT), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    _, _, step = _loop(model, "gpt3_125m", k=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = float(step(ids[0], labels[0]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m0
    del model, step
    _free_cuda()
    return loss, peak


def cp_train_2rank_phase():
    """Long-context GPT training over the ``sep`` axis across two
    processes on this card (gloo; ``fused_steps=1``): GPT-3 125M at full
    width and ``CP_LAYERS`` of its 12 layers, ``context_parallel`` and
    ``sequence_parallel``, bf16,
    ``recompute="selective"``, batch 2 x 8192, sep 2 (chunks of 4096)
    through :func:`_loop` with its schedule stepped, 3 steps, against one
    process over the whole sequence: losses within ``CP_LOSS_ATOL``, every
    fp32 master's change within ``CP_UPDATE_RTOL`` (``qkv_b``'s key third
    apart: :data:`NOISE_ONLY`), while the control without rotation must
    miss both; K1–K3 launches a rank by :func:`_cp_launches_want`,
    collectives issued, no plain fallback; each rank's peak memory (over
    what it held before its model) below the one process's, and so with
    dropout ``CP_DROPOUT`` (one step each); the
    ``sequence_parallel``-only route (the qkv all-gather) held to the
    same run and limits as the ring.  (a) the ring alone and (e) the sequence-parallel linears run
    in the same two processes (:func:`_cp_rank`).  (d) K1–K3 at the
    chunk pair's shape (B 2, 12 heads of 64, 4096 x 4096), the diagonal
    causal and the older pair full, K2/K3 with a nonzero LSE cotangent,
    held to their plain versions and timed beside SDPA.  Returns the
    flash rows' additions by kernel."""
    cfg = _cp_cfg()
    gen = torch.Generator(device="cuda").manual_seed(17)
    ids, labels = (torch.randint(0, cfg.vocab_size, (CP_STEPS, CP_B, CP_S),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    m0 = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init = model.gather_numpy_state()
    sched, opt, step = _loop(model, "gpt3_125m", k=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref, lrs = [], []
    for i in range(CP_STEPS):
        lrs.append(sched())
        ref.append(float(step(ids[i], labels[i])))
        sched.step()
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() - m0
    step.sync()
    ref_norms = [v for _, v in step.metrics.series("grad_norm")]
    d_ref = {n: v - init[n] for n, v in _masters(model, opt).items()}
    del model, opt, step, init
    _free_cuda()
    drop_loss, drop_peak = _cp_one_process_dropout(ids, labels)
    res = _spawn_ranks("_cp_rank", 2, {"ids": ids.cpu().numpy(),
                                       "labels": labels.cpu().numpy(),
                                       "d_ref": d_ref})
    del d_ref
    record = {"phase": "cp_train_2rank", "card": CARD,
              "model": "gpt3_125m bf16 selective, context_parallel + "
                       "sequence_parallel, max_seq_len 8192",
              "layers": CP_LAYERS, "batch": [CP_B, CP_S],
              "mesh": "sep2 (gloo, two processes)",
              "lrs": lrs, "one_process_losses": ref,
              "one_process_grad_norms": ref_norms,
              "loss_atol": CP_LOSS_ATOL, "update_rtol": CP_UPDATE_RTOL,
              "ring": [r["ring"] for r in res],
              "sp_linears": [r["sp_linears"] for r in res],
              "peak_bytes": {"one_process": one_peak,
                             "ranks": [r["cp"]["peak_bytes"] for r in res],
                             "dropout_one_process": drop_peak,
                             "dropout_ranks": [r["dropout"]["peak_bytes"]
                                               for r in res]},
              "dropout": {"rate": CP_DROPOUT,
                          "one_process_loss": drop_loss,
                          "losses": [r["dropout"]["losses"] for r in res]},
              "launches_want": [_cp_launches_want(r) for r in range(2)]}
    for name in ("cp", "control", "sp_only"):
        errs = [r[name]["update_rel_err"] for r in res]
        worst_n = max((n for n in errs[0] if n != NOISE_ONLY),
                      key=lambda n: max(e[n] for e in errs))
        record[name] = {
            "losses": [r[name]["losses"] for r in res],
            "max_loss_err": max(abs(a - b) for r in res
                                for a, b in zip(r[name]["losses"], ref)),
            "max_update_rel_err": max(e[worst_n] for e in errs),
            "worst_param": worst_n,
            "noise_only_rel_err": max(e[NOISE_ONLY] for e in errs),
            "update_rel_err_rank0": errs[0],
            **{k: [r[name][k] for r in res] for k in (
                "launches", "collectives", "ring_shifts", "sep_collectives",
                "fallbacks", "grad_norms")}}
    emit(record)
    cp, ctl, spo = record["cp"], record["control"], record["sp_only"]
    if cp["max_loss_err"] > CP_LOSS_ATOL:
        raise AssertionError(f"cp_train_2rank: losses {cp} vs one process "
                             f"{ref}")
    if cp["max_update_rel_err"] > CP_UPDATE_RTOL:
        raise AssertionError(f"cp_train_2rank: parameter updates differ "
                             f"from one process: {cp}")
    if (ctl["max_update_rel_err"] <= CP_UPDATE_RTOL
            or ctl["max_loss_err"] <= CP_LOSS_ATOL):
        raise AssertionError("cp_train_2rank: the control without rotation "
                             f"passes a gate: {ctl}")
    if cp["launches"] != record["launches_want"]:
        raise AssertionError(f"cp_train_2rank: K1-K3 launches "
                             f"{cp['launches']}, want "
                             f"{record['launches_want']}")
    if (any(c <= 0 for c in cp["collectives"] + cp["ring_shifts"])
            or any(cp["fallbacks"] + spo["fallbacks"])):
        raise AssertionError(f"cp_train_2rank: collectives or fallbacks "
                             f"{cp} {spo}")
    if (spo["max_loss_err"] > CP_LOSS_ATOL
            or spo["max_update_rel_err"] > CP_UPDATE_RTOL
            or any(spo["ring_shifts"]) or not all(spo["sep_collectives"])):
        raise AssertionError(f"cp_train_2rank: sequence_parallel-only "
                             f"route {spo} vs one process {ref}")
    if any(r["max_rel_err"] > 1e-5 for r in record["sp_linears"]):
        raise AssertionError(f"cp_train_2rank: sequence-parallel linears "
                             f"{record['sp_linears']}")
    peaks = record["peak_bytes"]
    if (any(p >= one_peak for p in peaks["ranks"])
            or any(p >= drop_peak for p in peaks["dropout_ranks"])):
        raise AssertionError(f"cp_train_2rank: a rank's peak memory is not "
                             f"below one process's: {peaks}")
    if not all(math.isfinite(l) for r in record["dropout"]["losses"]
               for l in r):
        raise AssertionError(f"cp_train_2rank: the dropout step "
                             f"{record['dropout']}")
    # (d) the chunk pairs' K1-K3, held to their plain versions and timed
    worst = dict.fromkeys(("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0.0)
    ratio = dict(worst)
    pair = (CP_B, 12, CP_S // 2, 64)
    _flash_check(torch.Generator(device="cuda").manual_seed(47),
                 [(*pair, torch.bfloat16, c) for c in (True, False)], worst,
                 ratio)
    errs = {"flash_fwd": max(worst["flash_fwd"], worst["flash_fwd_lse"]),
            "flash_bwd_dq": worst["flash_bwd_dq"],
            "flash_bwd_dkv": worst["flash_bwd_dkv"]}
    per_rank = {n: [l[n] for l in cp["launches"]] for n in errs}
    rows = {n: {"launches_per_rank": per_rank[n],
                "launches": sum(per_rank[n]), "max_abs_err": errs[n]}
            for n in errs}
    for causal in (True, False):
        key = "diagonal_causal" if causal else "older_full"
        for n, t in _flash_shape_times(*pair, causal, seed=48,
                                       dlse=True).items():
            emit(t)
            rows[n][key] = {"shape": t["shape"], "ms": t["kernel_us"] / 1e3,
                            "plain_ms": t["plain_us"] / 1e3,
                            "bound_ms": t["bound_us"] / 1e3,
                            "bound_by": t["bound_by"],
                            "library_ms": t["library_us"] / 1e3,
                            "share_of_bound": t["share_of_bound"]}
    return rows


# -- pipeline-parallel training over pp --------------------------------------

#: pp_train_2rank: GPT-3 125M at full width and ``PP_LAYERS`` of its 12
#: layers (2 a stage; cut for the script's time limit), batch 8 x 1024 in M = 4 microbatches of 2, 2 AdamW steps a
#: schedule through :func:`_loop` (its schedule stepped: the first step's
#: lr is 0, so the losses read the pipelined forward and the updates its
#: backward)
PP_B, PP_M, PP_STEPS, PP_LAYERS = 8, 4, 2, 4
#: the schedules: GPipe through ``CompiledTrainStep(mesh=)``, the
#: interleaved one (``virtual_pp_degree=2``, 1 layer a chunk), 1F1B and
#: zero-bubble through ``Pipeline1F1BTrainStep``
PP_RUNS = ("gpipe", "interleaved", "1f1b", "zero_bubble")
#: the controls, GPipe each: stage 1 receives zeros in place of the
#: shifted activation (must miss both limits), and the embedding's and
#: head's gradients are not summed over pp (its losses are the sound
#: run's, as the first update has lr 0: it must miss the update limit)
PP_CONTROLS = ("no_shift", "no_pp_sum")
#: the limits of each schedule's losses against one process on the
#: whole batch, and of each fp32 master's change (``MESH2_*``'s
#: measures), between the sound runs and the controls
PP_LOSS_ATOL, PP_UPDATE_RTOL = 1e-3, 0.1


def _pp_cfg(run):
    cfg = _fused_cfg(num_layers=PP_LAYERS)
    if run == "interleaved":
        cfg.pp_schedule, cfg.virtual_pp_degree = "interleaved", 2
    return cfg


def _pp_launches_want(run, rank):
    """K1–K3 launches of one pp-2 rank over ``PP_STEPS`` steps: each of
    its ``PP_LAYERS / 2`` layers runs K1 once a microbatch forward and,
    under selective recompute, once more in each backward pass, which
    runs K2 and K3 once.  A step has one backward pass a microbatch, but zero-bubble's
    last stage runs two (dX, then W, each through the whole stage)."""
    passes = 2 if run == "zero_bubble" and rank == 1 else 1
    per = {"flash_fwd": 1 + passes, "flash_bwd_dq": passes,
           "flash_bwd_dkv": passes}
    return {n: c * PP_LAYERS // 2 * PP_M * PP_STEPS
            for n, c in per.items()}


def _pp_run(pl, mesh, run, init):
    """One rank's ``run`` (a schedule of :data:`PP_RUNS` or a GPipe
    control) from seed-0 weights built under ``mesh``: losses, each fp32
    master's change against the one-process change, the K1–K3 launches,
    the pipeline shifts, the in-flight gauge and this process's peak
    memory over what it held before the model."""
    from paddle_tpu_torch.distributed import pipeline
    ids, labels = (torch.from_numpy(pl[k]).cuda() for k in ("ids", "labels"))
    m0 = torch.cuda.memory_allocated()
    model = GPTForCausalLM(_pp_cfg(run), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    sched, opt, step = _loop(model, "gpt3_125m", k=1, mesh=mesh,
                             pipeline=run if run in ("1f1b", "zero_bubble")
                             else None)
    shift = pipeline._shift_pp
    if run == "no_shift":
        def no_shift(x, mesh, step):
            y = shift(x, mesh, step)
            return torch.zeros_like(y) if step == 1 else y
        pipeline._shift_pp = no_shift
    if run == "no_pp_sum":
        step._mesh.sum_pp = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    c0 = counters.snapshot()
    t0 = time.perf_counter()
    try:
        losses = []
        for i in range(PP_STEPS):
            losses.append(float(step(ids[i], labels[i])))
            sched.step()
    finally:
        pipeline._shift_pp = shift
    torch.cuda.synchronize()
    rec = {"losses": losses, "seconds": time.perf_counter() - t0,
           "launches": _flash_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated() - m0,
           "pp_shifts": counters.delta(c0).get("dist.pp_shifts", 0),
           "max_in_flight": counters.get("pipeline.max_in_flight", None)
           if run in ("1f1b", "zero_bubble") else None,
           "update_rel_err": _update_rel_err(init, _masters(model, opt),
                                             pl["d_ref"])}
    del model, opt, step
    _free_cuda()
    return rec


def _pp_rank(rank, world, pl):
    """One rank of pp_train_2rank: every schedule and control in turn
    over the pp-2 mesh."""
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"pp": world})
    init = GPTForCausalLM(_pp_cfg("gpipe"), device="cuda",
                          generator=torch.Generator().manual_seed(0)
                          ).gather_numpy_state()
    _free_cuda()
    return {run: _pp_run(pl, mesh, run, init)
            for run in PP_RUNS + PP_CONTROLS}


def pp_train_2rank_phase():
    """Pipeline-parallel GPT training over pp 2 across two processes on
    this card (gloo; ``fused_steps=1``): GPT-3 125M at full width and
    ``PP_LAYERS`` of its 12 layers, bf16, ``recompute="selective"``,
    batch 8 x 1024 in 4
    microbatches of 2, 2 steps through :func:`_loop` with its schedule
    stepped, for each of GPipe (``CompiledTrainStep(mesh=build_mesh(
    {"pp": 2}))``), the interleaved schedule (V 2), 1F1B and zero-bubble
    (``Pipeline1F1BTrainStep``), against this process's one-process run
    from the same weights and batches: losses within ``PP_LOSS_ATOL``,
    every fp32 master's change within ``PP_UPDATE_RTOL`` (``qkv_b``'s key
    third apart: :data:`NOISE_ONLY`); the controls of :data:`PP_CONTROLS`
    must miss them; K1–K3 launches a rank by :func:`_pp_launches_want`;
    each rank's peak memory below one process's, and stage 0's under
    1F1B below its GPipe peak (M 4 > P 2); the 1F1B in-flight gauge P -
    s.  Then K1–K3 at the microbatch's shape (B 2, 12 heads of 64, S
    1024, causal) held to their plain versions and timed beside SDPA.
    Returns the flash rows' additions by kernel."""
    cfg = _pp_cfg("gpipe")
    gen = torch.Generator(device="cuda").manual_seed(21)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (PP_STEPS, PP_B, TRAIN_S), generator=gen,
                                 device="cuda") for _ in range(2))
    m0 = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    init = model.gather_numpy_state()
    sched, opt, step = _loop(model, "gpt3_125m", k=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref, lrs = [], []
    t0 = time.perf_counter()
    for i in range(PP_STEPS):
        lrs.append(sched())
        ref.append(float(step(ids[i], labels[i])))
        sched.step()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() - m0
    d_ref = {n: v - init[n] for n, v in _masters(model, opt).items()}
    del model, opt, step, init
    _free_cuda()
    res = _spawn_ranks("_pp_rank", 2, {"ids": ids.cpu().numpy(),
                                       "labels": labels.cpu().numpy(),
                                       "d_ref": d_ref})
    del d_ref
    record = {"phase": "pp_train_2rank", "card": CARD,
              "model": f"gpt3_125m bf16 selective, {PP_LAYERS} layers, "
                       f"{PP_LAYERS // 2} a stage",
              "batch": [PP_B, TRAIN_S], "microbatches": PP_M,
              "mesh": "pp2 (gloo, two processes)", "lrs": lrs,
              "one_process_losses": ref, "one_process_seconds": one_s,
              "one_process_peak_bytes": one_peak,
              "loss_atol": PP_LOSS_ATOL, "update_rtol": PP_UPDATE_RTOL}
    for run in PP_RUNS + PP_CONTROLS:
        errs = [r[run]["update_rel_err"] for r in res]
        worst_n = max((n for n in errs[0] if n != NOISE_ONLY),
                      key=lambda n: max(e[n] for e in errs))
        record[run] = {
            "max_loss_err": max(abs(a - b) for r in res
                                for a, b in zip(r[run]["losses"], ref)),
            "max_update_rel_err": max(e[worst_n] for e in errs),
            "worst_param": worst_n,
            "noise_only_rel_err": max(e[NOISE_ONLY] for e in errs),
            "launches_want": [_pp_launches_want(run, r) for r in range(2)],
            **{k: [r[run][k] for r in res] for k in (
                "losses", "launches", "peak_bytes", "pp_shifts",
                "max_in_flight", "seconds")}}
    emit(record)
    for run in PP_RUNS:
        r = record[run]
        if (r["max_loss_err"] > PP_LOSS_ATOL
                or r["max_update_rel_err"] > PP_UPDATE_RTOL):
            raise AssertionError(f"pp_train_2rank {run}: against one "
                                 f"process {ref}: {r}")
        if r["launches"] != r["launches_want"]:
            raise AssertionError(f"pp_train_2rank {run}: K1-K3 launches "
                                 f"{r['launches']}, want "
                                 f"{r['launches_want']}")
        if any(p >= one_peak for p in r["peak_bytes"]):
            raise AssertionError(f"pp_train_2rank {run}: a rank's peak "
                                 f"memory is not below one process's "
                                 f"{one_peak}: {r['peak_bytes']}")
    if record["1f1b"]["max_in_flight"] != [2, 1]:
        raise AssertionError(f"pp_train_2rank: 1F1B in flight "
                             f"{record['1f1b']['max_in_flight']}")
    if record["1f1b"]["peak_bytes"][0] >= record["gpipe"]["peak_bytes"][0]:
        raise AssertionError("pp_train_2rank: stage 0's 1F1B peak is not "
                             "below its GPipe peak: "
                             f"{record['1f1b']['peak_bytes']} vs "
                             f"{record['gpipe']['peak_bytes']}")
    ns, nps = record["no_shift"], record["no_pp_sum"]
    if (ns["max_loss_err"] <= PP_LOSS_ATOL
            or ns["max_update_rel_err"] <= PP_UPDATE_RTOL
            or nps["max_update_rel_err"] <= PP_UPDATE_RTOL):
        raise AssertionError(f"pp_train_2rank: a control passes a gate: "
                             f"no_shift {ns}, no_pp_sum {nps}")
    # the microbatch's K1-K3, held to their plain versions and timed
    worst = dict.fromkeys(("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0.0)
    ratio = dict(worst)
    mb = (PP_B // PP_M, 12, TRAIN_S, 64)
    _flash_check(torch.Generator(device="cuda").manual_seed(53),
                 [(*mb, torch.bfloat16, True)], worst, ratio)
    errs = {"flash_fwd": max(worst["flash_fwd"], worst["flash_fwd_lse"]),
            "flash_bwd_dq": worst["flash_bwd_dq"],
            "flash_bwd_dkv": worst["flash_bwd_dkv"]}
    rows = {}
    for n, t in _flash_shape_times(*mb, True, seed=54).items():
        emit(t)
        per = {run: [l[n] for l in record[run]["launches"]]
               for run in PP_RUNS}
        rows[n] = {"shape": t["shape"], "launches_per_rank": per,
                   "launches": sum(sum(v) for v in per.values()),
                   "max_abs_err": errs[n], "ms": t["kernel_us"] / 1e3,
                   "plain_ms": t["plain_us"] / 1e3,
                   "bound_ms": t["bound_us"] / 1e3,
                   "bound_by": t["bound_by"],
                   "library_ms": t["library_us"] / 1e3,
                   "share_of_bound": t["share_of_bound"]}
    return rows


# -- elastic training under the launcher, and the parameter server (A7h) -----

#: elastic_2rank: GPT-3 125M at full width over mp2 (two gloo processes
#: on card 0 under ``python -m paddle_tpu_torch.distributed.launch``),
#: batch 4 x 1024; the uninterrupted run and agent run A take
#: ``ELASTIC_STEPS``, run B stops at ``ELASTIC_B_STEPS`` (its shrunk
#: world resumes from step 2); A and B's worlds of two save every 2
#: steps, the uninterrupted run only at its start and B's shrunk world
#: not at all (no run reads those saves).  6 of the 12
#: layers: at 12 the leg took 81-84 s on an NVIDIA H100 80GB HBM3,
#: 700.00 W, most of it checkpoint writes and process start-up, over its
#: share of the script's time
ELASTIC_LAYERS, ELASTIC_B, ELASTIC_STEPS, ELASTIC_B_STEPS = 6, 4, 6, 4
#: the step after whose checkpoint rank 1 exits in incarnation 0
ELASTIC_CRASH_AT = 2
#: B's shrunk world against the uninterrupted mp2 run, on the loss: between
#: its sound readings (2.38e-5 and 3.43e-5 on an NVIDIA H100 80GB HBM3,
#: 700.00 W) and its control's, which drops the optimizer's moments
#: (2.43e-3 at step 4)
ELASTIC_SHRINK_ATOL = 3e-4
ELASTIC_RUNS = {
    "A": ["launch", "failure", "launch", "done"],
    "B": ["launch", "failure", "launch", "failure", "shrink", "launch",
          "done"]}


def _elastic_record(out, mode, restart, rank, world, losses, marks):
    launches = _flash_counts()
    with open(os.path.join(out, f"rec.{mode}.r{restart}.{rank}.json"),
              "w") as f:
        json.dump({"world": world, "losses": {str(k): v for k, v in
                                              losses.items()},
                   "launches": launches,
                   "marks": {**marks, "recorded": time.time()}}, f)


def _elastic_worker(out, mode, steps, layers):
    """One rank of elastic_2rank, started by the launcher (its rank, world,
    rendezvous, card and incarnation from the environment): GPT-3 125M at
    ``layers`` built under the mp mesh of its world, ``_loop_optimizer``'s
    AdamW through ``DistributedTrainStep``, driven by
    ``FaultTolerantTrainer`` with ``CheckpointManager`` (a save every 2
    steps, written in the background; mode ``ref`` saves only its start
    and a shrunk world, which resumes, nothing: no run reads those saves)
    under ``out/ckpt``; the trainer restores the newest checkpoint at its
    start.  Its losses and K1–K3 counts go to ``out`` after every save
    and at the end.  Mode ``A`` and ``B``: rank 1 exits 17 right after the
    checkpoint of step ``ELASTIC_CRASH_AT`` in incarnation 0; ``B``: rank
    1 also exits 19 at its start in incarnation 1 (the script's first
    lines), and the shrunk world runs :func:`_elastic_control` after its
    run."""
    import datetime
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             FaultTolerantTrainer)
    marks = {"entry": time.time()}
    steps, layers = int(steps), int(layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", 0))
    D.init_parallel_env(timeout=datetime.timedelta(seconds=120))
    marks["rendezvous"] = time.time()
    rank, world = D.get_rank(), D.get_world_size()
    trainer = None

    def record():
        _elastic_record(out, mode, restart, rank, world,
                        trainer.losses if trainer is not None else {},
                        marks)

    D.build_mesh({"mp": world})
    model = GPTForCausalLM(_fused_cfg(num_layers=layers), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    sched, opt, crit = _loop_optimizer(model, "gpt3_125m")
    step = D.DistributedTrainStep(model, lambda m, x, y: crit(m(x), y), opt)
    # every run draws the same ELASTIC_STEPS batches; ``steps`` ends it
    g = torch.Generator().manual_seed(9)
    V = model.config.vocab_size
    ids, labels = (torch.randint(0, V, (ELASTIC_STEPS * ELASTIC_B, TRAIN_S),
                                 generator=g) for _ in range(2))
    ds = tio.TensorDataset([ids, labels])

    class Manager(CheckpointManager):
        def save(self, train_step, at, **kw):
            super().save(train_step, at, **kw)
            if mode in ("A", "B") and restart == 0 and rank == 1 \
                    and at == ELASTIC_CRASH_AT:
                self.wait()
                record()
                os._exit(17)
            record()

    marks["built"] = time.time()
    trainer = FaultTolerantTrainer(
        step, lambda e: tio.DataLoader(ds, batch_size=ELASTIC_B,
                                       shuffle=False),
        Manager(os.path.join(out, "ckpt"), async_save=True),
        scheduler=sched, max_steps=steps,
        save_every=0 if mode == "ref" or world == 1 else 2)
    trainer.run()
    marks["trained"] = time.time()
    record()
    if mode == "B" and world == 1:
        _elastic_control(out, step, sched, ds, steps)
    D.reset_parallel_env()


def _elastic_control(out, step, sched, ds, steps):
    """elastic_2rank B's control, in its shrunk world after the world's
    run: ``step`` restores the save of step ``ELASTIC_CRASH_AT`` (the mp2
    save the world resumed from, resharded) with the optimizer's moments
    dropped, trains to ``steps`` again and saves nothing.  Its losses go
    to ``out/control.B.json``; the incarnation's record is written
    before it, so its K1–K3 counts are the world's run's alone."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             FaultTolerantTrainer)

    class Dropped(CheckpointManager):
        def _committed(self):
            return [s for s in super()._committed()
                    if s <= ELASTIC_CRASH_AT]

        def restore(self, train_step, **kw):
            info = super().restore(train_step, **kw)
            train_step.optimizer._accumulators.clear()
            train_step.invalidate()
            return info

        def save(self, *args, **kw):
            pass

    losses = FaultTolerantTrainer(
        step, lambda e: tio.DataLoader(ds, batch_size=ELASTIC_B,
                                       shuffle=False),
        Dropped(os.path.join(out, "ckpt")), scheduler=sched,
        max_steps=steps, save_every=2).run()
    with open(os.path.join(out, "control.B.json"), "w") as f:
        json.dump({str(k): v for k, v in losses.items()}, f)


def _elastic_launch(root, mode, steps, layers):
    """Start ``mode``'s world through the launcher (elastic for A and B)
    in the background; returns (process, its directory)."""
    d = os.path.join(root, mode)
    os.makedirs(d)
    here = os.path.dirname(os.path.abspath(__file__))
    args = ["--nproc_per_node", "2", "--devices", "0,0", "--log_dir",
            os.path.join(d, "log")]
    if mode != "ref":
        args += ["--elastic", "--max_restarts", "3", "--heartbeat_timeout",
                 "120"] + (["--min_nproc", "1"] if mode == "B" else [])
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           *args, os.path.abspath(__file__), "--elastic-worker", d, mode,
           str(steps), str(layers)]
    log = open(os.path.join(d, "launcher.log"), "w")
    proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                            stderr=subprocess.STDOUT,
                            env={**os.environ,
                                 "PADDLE_DISTRI_BACKEND": "gloo"})
    return proc, log, d


def _elastic_read(d, mode):
    recs = {}
    for name in os.listdir(d):
        if name.startswith(f"rec.{mode}."):
            _, _, r, rank, _ = name.split(".")
            with open(os.path.join(d, name)) as f:
                recs[(int(r[1:]), int(rank))] = json.load(f)
    events = []
    path = os.path.join(d, "log", "elastic_events.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            events = [json.loads(line) for line in f]
    return recs, events


def _elastic_tail(d):
    """The last lines of a run's launcher and worker logs (for a
    failure's message)."""
    out = []
    for root, _, files in os.walk(d):
        for name in sorted(files):
            if name.startswith(("workerlog", "launcher")):
                with open(os.path.join(root, name), errors="replace") as f:
                    out.append(f"== {name}\n" + "".join(f.readlines()[-15:]))
    return "\n".join(out)[-6000:]


def elastic_2rank_phase():
    """A7h's elastic training on the card: the uninterrupted mp2 run
    (the launcher, no agent), agent run A (rank 1 dies after the step-2
    checkpoint; the agent kills rank 0 out of its collective and
    relaunches; the world resumes from that checkpoint) and agent run B
    with ``--min_nproc 1`` (rank 1 dies after the step-2 checkpoint and
    again before its first step, so the agent shrinks the world to one
    process, which restores the mp2 save resharded and finishes), all
    three started together.  Gates: A's losses equal the uninterrupted
    run's bit for bit; B's shrunk losses within ``ELASTIC_SHRINK_ATOL``
    of the uninterrupted run's, while B's control (:func:`_elastic_control`,
    the same restore with the optimizer's moments dropped) must exceed it;
    the agents' events; every incarnation's K1–K3 counts == its steps x
    layers x the recompute factor."""
    import tempfile
    t0, t_wall = time.perf_counter(), time.time()
    root = tempfile.mkdtemp(prefix="elastic_", dir=os.environ.get("TMPDIR"))
    runs = {}
    try:
        for mode, steps in (("ref", ELASTIC_STEPS), ("A", ELASTIC_STEPS),
                            ("B", ELASTIC_B_STEPS)):
            runs[mode] = _elastic_launch(root, mode, steps, ELASTIC_LAYERS)
        codes = {}
        for mode, (proc, log, d) in runs.items():
            try:
                codes[mode] = proc.wait(timeout=400)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        got = {mode: _elastic_read(d, mode) for mode, (_, _, d) in
               runs.items()}
        control = {}
        path = os.path.join(runs["B"][2], "control.B.json")
        if os.path.exists(path):
            with open(path) as f:
                control = json.load(f)
        tails = {m: _elastic_tail(d) for m, (_, _, d) in runs.items()
                 if codes[m] != 0}
    finally:
        for proc, log, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    if any(codes.values()):
        raise AssertionError(f"elastic_2rank: launcher exit codes {codes}\n"
                             + "\n".join(tails.values()))
    per = _flash_per_layer_step(_fused_cfg().recompute)
    ref = got["ref"][0]
    want = {r: ref[(0, r)]["losses"] for r in (0, 1)}
    record = {"phase": "elastic_2rank", "card": CARD,
              "model": "gpt3_125m bf16 selective", "layers": ELASTIC_LAYERS,
              "batch": [ELASTIC_B, TRAIN_S], "mesh": "mp2, gloo, card 0 x 2",
              "uninterrupted_losses": want[0], "seconds": seconds,
              "loss_atol_shrunk": ELASTIC_SHRINK_ATOL}
    problems = []
    for mode in ("A", "B"):
        recs, timed = got[mode]
        events = [e[1:] for e in timed]
        kinds = [k for k, _ in events]
        resumed = {}
        for (restart, rank), rec in sorted(recs.items()):
            if restart > 0:
                resumed.setdefault(rank, {}).update(rec["losses"])
        first = {rank: recs[(0, rank)]["losses"] for rank in (0, 1)
                 if (0, rank) in recs}
        record[mode] = {
            "events": events,
            "event_s": [round(e[0] - t_wall, 3) for e in timed],
            "worker_marks_s": {f"r{r}.rank{k}": {
                m: round(t - t_wall, 3) for m, t in v["marks"].items()}
                for (r, k), v in sorted(recs.items())},
            "incarnations": {f"r{r}.rank{k}": {
                "world": v["world"], "steps": sorted(map(int, v["losses"])),
                "launches": v["launches"]} for (r, k), v in
                sorted(recs.items())},
            "losses_incarnation0": first, "losses_resumed": resumed}
        if kinds != ELASTIC_RUNS[mode]:
            problems.append(f"{mode}: agent events {kinds}")
        for (restart, rank), rec in recs.items():
            n = len(rec["losses"])
            want_l = {k: c * ELASTIC_LAYERS * n for k, c in per.items()}
            if rec["launches"] != want_l:
                problems.append(f"{mode} incarnation {restart} rank {rank}: "
                                f"K1-K3 {rec['launches']} over {n} steps, "
                                f"want {want_l}")
        for rank, losses in first.items():
            if any(losses[k] != want[rank][k] for k in losses) or \
                    len(losses) != ELASTIC_CRASH_AT:
                problems.append(f"{mode} incarnation 0 rank {rank}: "
                                f"losses {losses} vs {want[rank]}")
    # A: the resumed steps are the uninterrupted run's, bit for bit
    recsA = record["A"]["losses_resumed"]
    for rank in (0, 1):
        tail = {k: v for k, v in want[rank].items()
                if int(k) > ELASTIC_CRASH_AT}
        if recsA.get(rank) != tail:
            problems.append(f"A rank {rank}: resumed losses "
                            f"{recsA.get(rank)} vs uninterrupted {tail}")
    # B: the shrunk world of one process resumes from the mp2 save
    recsB, _ = got["B"]
    last = max(r for r, _ in recsB)
    shrunk = recsB.get((last, 0), {"world": None, "losses": {}})
    errs = {k: abs(v - want[0][k]) for k, v in shrunk["losses"].items()}
    ctl = {k: abs(v - want[0][k]) for k, v in control.items()}
    record["B"]["shrunk_world"] = shrunk["world"]
    record["B"]["shrunk_loss_err"] = errs
    record["B"]["control_moments_dropped_loss_err"] = ctl
    resumed_steps = list(range(ELASTIC_CRASH_AT + 1, ELASTIC_B_STEPS + 1))
    if shrunk["world"] != 1 or sorted(map(int, shrunk["losses"])) != \
            resumed_steps:
        problems.append(f"B: the last incarnation {shrunk}")
    if any(e > ELASTIC_SHRINK_ATOL for e in errs.values()):
        problems.append(f"B: shrunk losses off by {errs}")
    if sorted(map(int, ctl)) != resumed_steps or \
            max(ctl.values()) <= ELASTIC_SHRINK_ATOL:
        problems.append("B: the control with the optimizer's moments "
                        f"dropped passes the shrink gate: {ctl}")
    record["launches_all_incarnations"] = {k: sum(
        rec["launches"][k] for mode in ("A", "B")
        for rec in got[mode][0].values()) for k in per}
    emit(record)
    if problems:
        raise AssertionError("elastic_2rank: " + "; ".join(problems))
    return record


#: ps_sparse: sparse_embedding's data (4096 x 26 Zipf ids over 1,000,000,
#: dim 256, click labels) with the table on two parameter-server
#: processes; plain SGD on the servers and for the card's head
PS_LR = 1.0
PS_TABLE = "ctr_emb"
PS_SERVER = """
from paddle_tpu_torch.distributed import fleet
fleet.init(fleet.PaddleCloudRoleMaker())
server = fleet.init_server()
print(server.endpoint, flush=True)
fleet.run_server()
"""


def _ps_servers(n):
    """Start ``n`` parameter-server processes through the role path
    (``TRAINING_ROLE=PSERVER``, ``fleet.init(PaddleCloudRoleMaker())``,
    ``init_server``, ``run_server``); each prints its endpoint when it
    serves (:func:`_ps_endpoints`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(
        [sys.executable, "-c", PS_SERVER], cwd=here, stdout=subprocess.PIPE,
        text=True, env={**os.environ, "TRAINING_ROLE": "PSERVER",
                        "PADDLE_PORT": "0", "CUDA_VISIBLE_DEVICES": ""})
        for _ in range(n)]


def _ps_endpoints(procs):
    eps = [p.stdout.readline().strip() for p in procs]
    if not all(eps):
        raise AssertionError(f"ps_sparse: a server did not start: {eps}, "
                             f"exit codes {[p.poll() for p in procs]}")
    return eps


def _ps_head_step(head_w, head_b, e, labels):
    logit = e.sum(1) @ head_w + head_b
    loss = F.binary_cross_entropy_with_logits(logit[:, 0], labels)
    return loss


def ps_sparse_phase():
    """The parameter-server mode on the card: the embedding table on two
    server processes (rows by ``id % 2``), the chip process the worker
    (``fleet.init_worker``): ``SparseEmbedding`` pulls each batch's
    unique rows onto the card, the card's head and BCE run there,
    ``push_step`` sends the rows' gradient back (plain SGD on the
    servers), 10 steps.  The dense twin: an embedding of the whole table
    on the card whose touched rows were pulled from the servers once
    before step 0, the same SGD.  Gates: the losses equal the twin's
    within fp32 rounding (rtol 1e-5); the rows pulled after training
    equal the twin's rows (atol 1e-6); ``save_tables``/``load_tables``
    (the servers' ``save``/``load``) give back the saved rows bit for
    bit after a clobbering push.  Pull and push ms p50 a step printed."""
    import tempfile
    from paddle_tpu_torch.distributed import fleet, ps
    t0 = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t0

    procs = _ps_servers(2)
    tmp = tempfile.mkdtemp(prefix="ps_", dir=os.environ.get("TMPDIR"))
    try:
        # the data while the servers start
        batches = _sparse_batches(17)
        gen = torch.Generator(device="cuda").manual_seed(18)
        head0 = torch.randn(SPARSE_DIM, 1, generator=gen,
                            device="cuda") * 0.05
        touched = np.unique(np.concatenate(
            [i.reshape(-1).cpu().numpy() for i, _ in batches]))
        twin = torch.zeros(SPARSE_V, SPARSE_DIM, device="cuda")
        client = fleet.init_worker(_ps_endpoints(procs))
        mark("servers_up")
        emb = ps.SparseEmbedding(PS_TABLE, SPARSE_V, SPARSE_DIM,
                                 optimizer="sgd", init_scale=0.01)
        twin[torch.from_numpy(touched).cuda()] = torch.from_numpy(
            client.pull_sparse(PS_TABLE, touched)).cuda()
        twin.requires_grad_(True)
        mark("twin_pulled")

        def run(lookup, after_backward):
            w = head0.clone().requires_grad_(True)
            b = torch.zeros(1, device="cuda", requires_grad=True)
            losses, pull_ms, push_ms = [], [], []
            for ids, labels in batches:
                torch.cuda.synchronize()
                ta = time.perf_counter()
                e = lookup(ids)
                torch.cuda.synchronize()
                pull_ms.append((time.perf_counter() - ta) * 1e3)
                loss = _ps_head_step(w, b, e, labels)
                loss.backward()
                ta = time.perf_counter()
                after_backward()
                torch.cuda.synchronize()
                push_ms.append((time.perf_counter() - ta) * 1e3)
                with torch.no_grad():
                    for p in (w, b):
                        p -= PS_LR * p.grad
                        p.grad = None
                losses.append(float(loss.detach()))
            return losses, pull_ms, push_ms

        def twin_sgd():
            with torch.no_grad():
                twin.sub_(PS_LR * twin.grad)
                twin.grad = None

        ps_losses, pull_ms, push_ms = run(
            lambda ids: emb(ids)._data, lambda: emb.push_step(PS_LR))
        mark("ps_steps")
        twin_losses, _, twin_ms = run(
            lambda ids: F.embedding(ids, twin), twin_sgd)
        mark("twin_steps")
        rows = client.pull_sparse(PS_TABLE, touched)
        want = twin.detach()[torch.from_numpy(touched).cuda()].cpu().numpy()
        row_err = float(np.abs(rows - want).max())
        # save, clobber, load: the saved rows come back bit for bit
        client.save(tmp)
        some = touched[:4096]
        client.push_sparse(PS_TABLE, some, np.ones((some.size, SPARSE_DIM),
                                                   np.float32), 1.0)
        clobbered = not np.array_equal(client.pull_sparse(PS_TABLE, some),
                                       rows[:some.size])
        client.load(tmp)
        reloaded = client.pull_sparse(PS_TABLE, touched)
        mark("save_load")
        size = client.sparse_table_size(PS_TABLE)
        fleet.stop_worker()
        codes = [p.wait(timeout=60) for p in procs]
        mark("stopped")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "ps_sparse", "card": CARD, "servers": 2,
           "table": [SPARSE_V, SPARSE_DIM], "batch": [SPARSE_B,
                                                      SPARSE_FIELDS],
           "steps": SPARSE_STEPS, "sgd_lr": PS_LR,
           "touched_rows": int(touched.size), "table_rows": size,
           "losses": ps_losses, "twin_losses": twin_losses,
           "max_row_err_vs_twin": row_err,
           "rows_reloaded_bit_equal": bool(np.array_equal(reloaded, rows)),
           "clobbered_before_load": clobbered,
           "pull_ms_p50": float(np.median(pull_ms[1:])),
           "push_ms_p50": float(np.median(push_ms[1:])),
           "twin_update_ms_p50": float(np.median(twin_ms[1:])),
           "step_times": "host clock around each synchronised pull "
                         "(unique ids, RPC, host-to-card copy) and push "
                         "(card-to-host copy, RPC, the servers' SGD), p50 "
                         "of steps 2-10",
           "server_exit_codes": codes, "marks_s": marks,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not np.allclose(ps_losses, twin_losses, rtol=1e-5, atol=0):
        raise AssertionError(f"ps_sparse: losses {ps_losses} vs the dense "
                             f"twin's {twin_losses}")
    if row_err > 1e-6:
        raise AssertionError(f"ps_sparse: pulled rows off the twin's by "
                             f"{row_err}")
    if not (rec["rows_reloaded_bit_equal"] and clobbered):
        raise AssertionError(f"ps_sparse: save/load round trip {rec}")
    if size != touched.size or any(codes):
        raise AssertionError(f"ps_sparse: table size {size} vs "
                             f"{touched.size} touched, servers {codes}")
    if not ps_losses[-1] < ps_losses[0]:
        raise AssertionError(f"ps_sparse: the loss did not fall "
                             f"{ps_losses}")
    return rec


def _free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def _timed(fn, *args, **kw):
    """``fn(*args, **kw)``, then ``{"phase": <fn's name>, "seconds": ...}``
    on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": fn.__name__.removesuffix("_phase"),
          "seconds": time.perf_counter() - t0})
    return out


def main():
    t_start = time.perf_counter()
    name, _card = _timed(device_phase)
    _timed(build_phase)
    max_err = _timed(kernel_phase)
    rms_err = _timed(rms_phase)
    flash_err = _timed(flash_phase)
    flash_hd_err = _timed(flash_hd_phase)
    _timed(small_reference_phase)
    model, prompts, tokens, record, snap = _timed(engine_phase)
    _timed(prompt_device_phase, model, prompts)
    quant, fp8, _ = _timed(engine_quant_phase, model, prompts, tokens,
                           record)
    _timed(int8_epilogue_phase, model)
    slot_eng, slot_record = _timed(engine_slots_phase, model, prompts,
                                   tokens, record)
    _timed(generate_phase, model, slot_eng)
    del slot_eng
    _free_cuda()
    draft_snap = _timed(engine_spec_phase, model, prompts, tokens, record)
    lora = _timed(engine_lora_phase, model, prompts, tokens, record)
    tier = _timed(host_tier_phase, model, prompts, tokens,
                  slot_record["greedy_token_agreement_with_paged"])
    mig = _timed(migration_phase, model, prompts, tokens)
    fleet, fleet_tokens = _timed(fleet_phase, model, prompts, tokens, record)
    fleet8, _ = _timed(fleet_phase, model, prompts, tokens, record,
                       kv_dtype="int8", bf16_tokens=fleet_tokens)
    del model
    _free_cuda()
    fp16_rows = _timed(serve_fp16_phase, prompts, tokens, max_err)
    chaos = _timed(fleet_chaos_phase, prompts)
    autoscale = _timed(fleet_autoscale_phase, prompts)
    _timed(slots_in_model_phase)
    _free_cuda()
    _timed(migration_fp32_phase)
    _free_cuda()
    sm = _timed(servemp_phase)
    mp2_rows = _timed(servemp_mp2_phase, sm)
    extras_ref = _timed(serve_extras_mp1_phase, sm)
    extras = _timed(serve_extras_mp2_phase, sm, extras_ref)
    del extras_ref
    sm_rows = sm["rows"]
    del sm
    _free_cuda()
    k4, k4q = "paged_decode_attention", "paged_decode_attention_int8"
    launches = {**record["launches"],
                k4q: quant["launches"][k4q],
                "paged_decode_attention_fp8":
                    fp8["launches"]["paged_decode_attention_fp8"]}
    # the LoRA, host-tier, migration and fleet phases' main-path runs add
    # theirs
    for rec in (lora, tier[None], tier["int8"], mig[None], mig["int8"],
                mig["spec"], fleet, fleet8, *chaos["runs"], autoscale,
                {"launches": fleet["unthreaded_launches"]}):
        for k in (k4, k4q):
            launches[k] += rec["launches"].get(k, 0)
    paged_rows = _timed(times_phase, snap, max_err, launches)
    _timed(draft_times_phase, draft_snap)
    del snap, draft_snap   # the serving phases' pools, before training
    _free_cuda()
    rms_row = _timed(rms_times_phase, rms_err)
    _free_cuda()
    train = _timed(train_phase)
    _free_cuda()
    _timed(gpt_dygraph_phase)
    _timed(train_in_model_phase)
    _free_cuda()
    _timed(train_loop_phase)
    _free_cuda()
    _timed(train_fused_phase)
    _free_cuda()
    ckpt_launches = _timed(ckpt_resume_phase)
    _free_cuda()
    overhead_launches = _timed(ckpt_overhead_phase)
    _free_cuda()
    _timed(scaler_skip_phase)
    _free_cuda()
    mesh_launches = _timed(mesh_train_phase)
    _free_cuda()
    mesh2_rows = _timed(mesh_train_2rank_phase)
    _free_cuda()
    ms = _timed(moe_serve_phase)
    moe_serve_rows = ms.pop("rows")
    del ms["model"]
    _free_cuda()
    moe_train_launches = _timed(moe_train_phase)
    _free_cuda()
    moe_ep_launches = _timed(moe_ep_2rank_phase, ms)
    del ms
    _free_cuda()
    moe_flash = _timed(moe_flash_rows, moe_train_launches, moe_ep_launches)
    _free_cuda()
    cp_rows = _timed(cp_train_2rank_phase)
    _free_cuda()
    pp_rows = _timed(pp_train_2rank_phase)
    _free_cuda()
    elastic = _timed(elastic_2rank_phase)
    _free_cuda()
    bert = _timed(bert_train_phase)
    _free_cuda()
    _timed(bert_in_model_phase)
    _free_cuda()
    hd_launches = _timed(flash_hd_in_model_phase)
    _timed(sparse_embedding_phase)
    _timed(ps_sparse_phase)
    _free_cuda()
    _timed(lbfgs_phase)
    flash_rows = _timed(flash_times_phase, flash_err, train["launches"],
                        bert["launches"],
                        {n: ckpt_launches[n] + overhead_launches[n]
                         for n in ckpt_launches})
    hd_rows = _timed(flash_hd_times_phase, flash_hd_err, hd_launches)
    # the mesh paths' shapes beside each row: 760M serving's 16 x 96 heads
    # and its mp2 slice of 8, 125M training's mp2 slice of 6 x 64, the
    # sep2 ring's chunk pairs, the pp2 microbatch (2 x 12 heads of 64)
    for row in paged_rows:
        if row["name"] in sm_rows:
            row["servemp_760m_16x96"] = sm_rows[row["name"]]
            row["servemp_mp2_8x96"] = mp2_rows[row["name"]]
            # the serving extras' mp2 legs run at that 8 x 96 slice
            row["serve_extras_mp2_launches_a_rank"] = {
                leg: n[row["name"]] for leg, n in
                extras["launches"].items() if n[row["name"]]}
        if row["name"] == "paged_decode_attention":
            row["draft125m_mp2_6x64"] = extras["draft_6x64"]
        if row["name"] in moe_serve_rows:
            row["moe_serve_760m_8experts_16x96"] = moe_serve_rows[
                row["name"]]
    for row in flash_rows:
        row["gpt125m_mp2_6x64"] = mesh2_rows[row["name"]]
        row["moe_train_125m_8experts_8x12x64"] = moe_flash[row["name"]]
        row["mesh_train_one_rank_launches"] = mesh_launches[row["name"]]
        row["cp_sep2_125m_s8192_chunk_pairs_2x12x4096x64"] = cp_rows[
            row["name"]]
        row["gpt125m_pp2_mb2_12x64"] = pp_rows[row["name"]]
        row["elastic_2rank_launches"] = elastic[
            "launches_all_incarnations"][row["name"]]
    torch.cuda.synchronize()
    emit({"phase": "total", "run_s": time.perf_counter() - t_start})
    print(json.dumps({"kernels": [*paged_rows, *fp16_rows, *flash_rows,
                                  *hd_rows, rms_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:
        _elastic_worker(*sys.argv[2:])
    else:
        main()
