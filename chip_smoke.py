"""Drive the PyTorch/CUDA port's serve, train and transport-engine paths
on one NVIDIA card and check them, with every table and figure the JAX
package reproduces.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-fwht EARLIER_FWHT_CU   # the A/B only
    python3 chip_smoke.py --ab-dcqcn EARLIER_DCQCN_CU

The kernels: ``fwht`` and ``fwht_quantize`` (``csrc/fwht.cu``),
``masked_unbias`` (``csrc/unbias.cu``), ``quantize_int8``
(``csrc/quantize.cu``) and ``dcqcn_scan`` (``csrc/dcqcn.cu``, the
engine's DCQCN recurrence).  Phases (any failure exits non-zero; nothing is
caught and carried on):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (FWHT at every coded leaf's tiles, one device's,
   a dp mesh's and a tensor-parallel rank's, and at the gradient
   payload, unbias at its wire layout) and over ``SWEEP`` and
   ``QUANT_SHAPES`` (the FWHT equal in float32 and bfloat16, with and
   without signs and scale, at every n = 2 .. 4096 and ragged tails;
   the quantizers' codes and scales equal, and the fused kernel equal
   to the kernel pair; a misaligned view refused), and time kernel,
   plain version, a PyTorch yardstick, and the bound (``time_ms``: runs
   of back-to-back calls behind a spin kernel, median of 5); the DCQCN
   scan bit for bit in rates and state at (1, 15,240, 128), (4, 4,092,
   1,024) and a ragged (3, 257, 33), at CNP densities 0, 0.001, 0.05 and
   1, on real engine blocks' marks (Fig. 1's, Fig. 3's, Fig. 7's hier,
   Fig. 4's 8-pod, Fig. 6's 1,024-node hier and Fig. 8's KV incast
   blocks, and the legacy Fig.-2 pass's three channels under their
   shared step mask, (3, 76,200, 128)), and over two
   consecutive blocks, each real block timed beside its bound (the
   larger of bytes, operations and the chain of active steps); and
   ``dcqcn.rate_trace`` (one trace as one seed, one scan launch a call)
   on the legacy marks' first steps, the next ones from the state it
   left, and a density-1 trace, bit for bit against the plain scan;
3. serve qwen2-0.5b at full width (24 layers, d 896, 14 heads padded to
   16, kv 2, vocab 151,936, bf16, random weights from seed 0): prefill
   8 prompts of 512 tokens, ship the KV caches through the coded lossy
   transfer at a delivered fraction of 0.9 (64 wire rows, fig8's cell),
   greedy-decode 32 tokens.  Uncoded and clean decodes, a full-mask
   round trip, and smoke-size runs against the CPU (qwen2-0.5b, and
   gemma2-9b on a prompt longer than its window, chatglm3-6b,
   nemotron-4-15b, qwen2-moe-a2.7b, granite-moe-3b-a800m,
   recurrentgemma-9b on a prompt longer than its window and xlstm-350m:
   logits, every degraded KV leaf, greedy tokens) check the results;
4. the kernel bench (``benchmarks/kernel_bench.py``'s quantize rows) at
   (256, 4096) through ``kernels.ops``;
5. train qwen2-0.5b at full width through ``Trainer``: batch 8 x 128
   Markov tokens, AdamW (lr 1e-3, warmup 10), three steps in each of
   ``exact``, ``lossy`` and ``lossy_hadamard``, with 16 FWHT launches a
   coded step (8 coded leaves, encode + decode); then remat's cost on the
   same cell: the loss and its gradients with remat and without, in
   turns (``remat_cost``);
5b. checkpoint and restart at full width, the depth cut to
    ``MESH_LAYERS`` of 24 layers as 6b/6c's (run after 6, which takes
    phase 5's trainer): an ``exact`` ``Trainer(ckpt_dir=...,
    ckpt_every=2)`` fails at ``simulate_fault_at=2``; a fresh trainer
    resumes at step 2 with the saved state bit for bit (bfloat16
    parameters included) and the saved timeout, and its next step
    equals an uninterrupted 3-step run's (run twice first; bit for bit
    where the card repeats itself); a ``lossy_hadamard`` resume launches
    the FWHT 16 times a step; the save, ``save_async``'s blocking part
    and the restores are timed.  ~5 GB of checkpoints under
    ``src/repro_torch/kernels/build/ckpt`` (the free space checked
    first), deleted after;
6. the gradient all-reduce: one step's gradient (499,540,864 values)
   through ``lossy_pmean`` on a one-rank NCCL group, on the int8 wire
   (one fused rotate+quantize launch a call) at drop 0 and 0.05 and on
   the float32 wire at 0.05;
6b. the data-parallel train step: four rank processes on the one card
    over gloo (one launch runs 6b, 6c, 6d, 6f, 6h, 6i and 19m in turn,
    ``MESH_KINDS``), qwen2-0.5b at full width, depth cut to 2 of 24 layers
    (``MESH_LAYERS``), through ``Trainer(mesh=...)``,
    global batch 8 x 128 (2 rows a rank), 2 steps in each cell: on
    ``make_host_mesh((4, 1))`` ``exact``, ``lossy_hadamard`` at drop
    0.05, and the int8 wire at drop 0 (the plain ``lossy`` and the int8
    at 0.05 cells cut for phase 19m);
    on ``make_pod_mesh(2, 2, 1)`` ``hierarchical`` on the int8
    wire at the per-pod vector [0.02, 0.0, 0.05].  ZeRO-1: each rank holds
    its ``zero1_specs`` slice of ``master``, ``mu`` and ``nu`` and the new
    parameters are all-gathered over ``data`` (its ms and bytes a
    rank-step printed); every cell's peak a rank must fall below the
    replicated state's, measured in the same run: one step of the cell
    that peaked highest on the mesh with the state replicated
    (``replicated_peak``).
    Every rank must end every step bit-identical, ``recv_frac`` lie within 0.04 of the mean
    mask rate's complement (1.0 at drop 0, where the int8 loss is within
    5e-3 of exact's), each coded step launch the FWHT 16 times a rank;
    the group's median equals the middle pair's midpoint; world-4 exact
    equals one device on ``global_batch(0, 4)`` (full width in float32,
    2 layers); every cell at smoke size agrees card against CPU;
6c. the tensor-parallel train step: the same four rank processes, each
    holding its shards of the leaves split over ``model``, 2 of 24
    layers as 6b, 2 steps a cell: on ``make_host_mesh((2, 2))`` (data x model) ``exact``,
    ``lossy_hadamard`` at drop 0.05 and the int8 wire at 0 (the plain
    ``lossy``, int8-at-0.05 and ``microbatches=2`` cells cut for phase
    19m; microbatches=2 is still held to the whole rows); on
    ``make_pod_mesh(2, 1, 2)`` ``hierarchical`` int8 at [0.02, 0.0,
    0.05]; on ``make_host_mesh((1, 4))`` ``exact`` (wk/wv split over 4,
    the 2 kv heads not).  The ranks that share a model index must end
    every step bit-identical, each coded step launch the FWHT 16 times
    a rank at ``tp_fwht_shapes``; exact on (2, 2) and on (1, 4) equals
    one device (float32, 2 layers, the shards gathered); each coded
    (2, 2) sync at drop 0 equals the exact pmean on the same gradients;
    ``microbatches=2`` equals the whole rows; every cell at smoke size
    agrees card against CPU; ZeRO-1 on (2, 2) (peak below the replicated
    state's, measured as 6b's).  Each cell prints its
    step, dp sync, model-group collective and ZeRO-1 all-gather times
    and bytes a rank-step.  Then the elastic
    restart: one exact step on (2, 2) checkpointed at full width (every
    rank gathers, rank 0 writes), restored by ``Trainer`` on (4, 1) and
    on (1, 4), every rank's leaves its blocks of the saved state bit for
    bit.  Every cell trains with remat and, its 128 tokens divisible by
    the model axis, with the residual stream split over ``model`` between
    units (sequence parallelism); on a rank's state ``lm_loss`` with it
    equals ``remat=False`` bit for bit in the loss and every gradient, on
    (2, 2) and (1, 4), each printing the sequence all-gathers SP adds
    (count and bytes) and the rank's peak with and without;
6d. the expert-parallel train step: the same four rank processes,
    qwen2-moe-a2.7b at full width (d 2048, 64 padded experts of 1,408,
    4 shared experts, top-4, vocab 151,936), depth cut to 1 of 24
    layers, 3 steps a cell: on ``make_host_mesh((1, 4))`` ``exact`` with
    ``lossy_moe`` off and ``lossy_moe`` at drop 0.1, on (2, 2) ``exact``
    with ``lossy_moe`` at 0.1 (the MoE layers route both dp ranks' rows
    together, as JAX's one GSPMD program does) and ``lossy_hadamard``
    with ``lossy_moe`` at drop 0.05 (ZeRO-1).  Each model rank
    dispatches its quarter (half) of the sequence through the
    ``all_to_all`` over ``model``.  Losses and aux finite; in every
    lossy-MoE dispatch each (sender, expert-shard) block all zero
    exactly where the layer's coin says it was dropped (the dropped
    share equals the coins'); the dp ranks bit-identical; the coded
    step's FWHT launched twice a coded leaf at its shapes (held to the
    plain version there and timed); ``lossy_moe`` at drop 0 = off bit
    for bit; EP = the local path on one full-width layer in float32 at
    capacity factor 50 (rtol 1e-4 + atol 1e-5); the (2, 2) ``exact``
    cell's next step with 2 microbatches (each rank's share of block k
    of the global batch, routed whole), timed beside the cell's steps:
    loss within 1.5 of ln V, finite gradient norm and parameters, the dp
    ranks bit-identical.  Each cell prints its
    step, EP all-to-all and dp sync times, the all-to-all's bytes a
    rank-step and the peak a rank;
6e. the other families trained at full width on one device through
    ``Trainer``, 8 x 128 tokens, 3 steps in ``exact`` and 3 in
    ``lossy_hadamard`` each: chatglm3-6b, gemma2-9b and
    granite-moe-3b-a800m at 2 layers, nemotron-4-15b at 1 (the AdamW
    state, 16 B a parameter, fits no deeper); losses finite, step 0's
    within 1.5 of ln V, the FWHT launched twice a coded leaf a coded
    step and never in ``exact``, recv_frac in [0.4, 1]; the step ms,
    the peak beside the reckoned state and a profiled fourth coded
    step.  Then each family's smoke config in float32, one
    ``lossy_hadamard`` step on the card against the CPU
    (96 tokens: gemma2's window binds) within ``tests/test_torch_train
    .py``'s tolerances, granite-moe's routing ids equal first; and the
    FWHT held to its plain version at every shape of 6e's and 6f's
    coded syncs, timed at each family's largest leaf;
6f. the same four rank processes on the one card over gloo, 2 of the
    families' layers (``MESH_LAYERS``), 2 steps a cell, in one launch:
    gemma2-9b on (2, 2) ``lossy_hadamard`` at drop 0.05 with ZeRO-1 (two
    pattern groups, both softcaps on vocabulary-split logits, the 256k
    tied table split over ``model``) and chatglm3-6b on (1, 4) ``exact``
    (the column-split untied ``embed.unembed``, partial rotary, 2 kv
    heads kept whole): the ranks that share a model index bit-identical,
    the FWHT twice a coded leaf at ``tp_fwht_shapes``; each rank's peak,
    sync ms and bytes a rank-step printed;
6g. the recurrent families and the modality stubs trained at full width
    on one device through ``Trainer`` on text alone (as JAX's Trainer
    runs the stubs), 8 x 128 tokens, 3 steps in ``exact`` and 3 in
    ``lossy_hadamard`` each: recurrentgemma-9b at 5 layers (one (rglru,
    rglru, local) group and the two-rglru tail), xlstm-350m whole (24
    layers), phi-3-vision-4.2b at 2 layers, seamless-m4t-medium whole
    (12 + 12); 6e's checks, a profiled fourth coded step, and each stub's
    ``make_train_step`` step with its extras given by hand (image embeds
    (8, 144, 1024), frames (8, 128, 1024): the frontend, encoder and
    cross-attention backward on the card, every leaf they reach given a
    non-zero first moment); the sLSTM's and RG-LRU's launches a step.
    Then each smoke config's ``lossy_hadamard`` step (a stub's with its
    extras) on the card against the CPU as in 6e, and the FWHT held to
    its plain version at every new shape of 6g's and 6h's coded syncs,
    timed at each config's largest leaf;
6h. the same four rank processes, the (4, 1) data x model mesh with
    ZeRO-1, 2 steps a cell: xlstm-350m at 4 layers ``lossy_hadamard`` at
    drop 0.05 and seamless-m4t-medium at 2 + 2 layers ``exact`` with its
    frames split by rows with the tokens; 6f's checks;
6j. remat at train_4k's length: qwen2-0.5b at full width and depth (24
    layers) on rows of 4,096 tokens (the tiled attention), 4 rows if the
    dry run's reckoned peak of that one-device step, times
    ``RECKON_UNDERCOUNT``, fits the card's memory, else 2,
    3 ``lossy_hadamard`` steps at drop 0.05 through ``Trainer``: step ms,
    peak GB beside the reckoned one, the FWHT 16 times a step; a fourth
    step holds the FWHT kernel to its plain version on the step's own
    inputs, bit for bit.  Then the same config at 2 layers: ``lm_loss``
    with remat and without, the loss and every gradient bit for bit, and
    both peaks;
7. smoke-size training on the card against the CPU (float32, the same
   masks, signs and batch: loss, the first moments, i.e. the synced
   gradient, and the updated parameters), and 14 coded steps that must
   lower the loss;
8. the transport engine: the Fig.-2 protocol at 128 nodes x 40 rounds,
   all four designs, card against CPU in both stream modes, and ``run``
   per design in legacy mode (delivered packets per step exact, times,
   p99 and recv_frac within rtol 1e-5); Fig. 2 on the card through
   ``CollectiveSimulator`` (128 nodes x 300 rounds, legacy streams, one
   scan call) equal to the committed ``fig2_*`` p99s, reduction and
   Celeris loss; the sequential reference loop (host numpy, no device:
   ``figs.fig2_sequential``, four single-threaded child processes)
   with each design's statistics equal to the recorded pre-refactor
   ones, ``fig2_ab_p99_ratio_roce`` equal to the committed 1.005 and
   ``fig2_engine_speedup_x`` (the four runs' seconds over the engine's
   wall) at least 10, no kernel launched; the beyond-paper adaptive
   per-step window (shared
   fabric, 3 scan launches, Celeris's per-flow arrays copied back) equal
   to the committed ``fig2_beyond_step_window_reduction`` against that
   run's RoCE p99, then the paper protocol in the shared-fabric mode (3
   scan launches, RoCE p99 above Celeris's); Fig. 3's largest cell
   (1,024 nodes, seeds 0-3 batched, 120 rounds of 25 MB, 60 scan
   launches), with its host/device split, one block's device busy share
   and peak memory;
9. the closed loop (Fig. 1): the engine's drop schedules at 128 nodes x
   60 rounds for the light / paper / heavy windows, the smoke LM trained
   60 steps from each in ``exact``, ``lossy`` and ``lossy_hadamard``
   (recovery >= 0.9 in the paper regime asserted), and qwen2-0.5b at
   full width for 3 ``lossy_hadamard`` steps from the paper schedule;
10. the hierarchical and faulted engine, card against CPU: fig7's
    32-node smoke fabric on 2 pods (oversubscription 2), 40 rounds, all
    four designs, the ring, hier and perrail schedules and a stall, a
    rail and a straggler cell (delivered packets, per tier and per pod,
    and faulted-flow counts exact; times, p99, recv_frac and tier
    fractions within rtol 1e-5, round and phase windows);
11. Fig. 4's engine grid on the card: the ring over 2/4/8 pods at DCI
    oversubscription 2/4/8, 128 nodes x 100 rounds, through
    ``topology.hier_protocol``, beside the committed ``fig4_*`` keys
    (``BENCH_sim.json``), with the host/device split;
12. Fig. 7 on the card (``fig7_fault_resilience.py``'s protocol through
    the port's ``sweep``): 128 nodes, 4 pods, oversubscription 4, the
    ring/hier/perrail clean passes and pinned budgets, the stall, crash
    and flap rate scans (resilience ratio >= 2 asserted), the rail
    failures under hier and perrail (perrail's DCI loss below hier's
    asserted), and the 512-node hier stall cell with its split and peak
    memory;
13. Fig. 7's closed loop: ``split_schedule_from_engine`` (2 pods, 128
    nodes, window x0.6, stall 1e-4) drives the smoke LM 40 steps
    ``hierarchical`` against 40 ``exact`` (recovery >= 0.9 asserted),
    then qwen2-0.5b at full width for 3 ``hierarchical`` steps (16 FWHT
    launches a step);
14. Tables I-II from the port's ``qp_state`` and ``resource_model``
    (host arithmetic), held to the paper values the reference's tests
    hold: per-QP bytes, BRAM, the BRAM cut, MTBF within 2 %;
15. Fig. 5 on the card (``fig5_schedule_tail.py``'s protocol: ring vs
    hier over 2/4 pods x oversubscription 2/4/8, 128 nodes x 100 rounds
    through ``sweep``, and the hot pod through ``hier_protocol``): all 32
    ``fig5_*`` keys equal to the committed ones;
16. Fig. 6 on the card (``fig6_scale_schedule.py``'s: {ring, hier,
    perrail} x {round, phase} at 128, 512 and 1,024 nodes x
    oversubscription 2/8, 4 pods, 60 rounds, budget x 0.25, through
    ``sweep``): all 126 ``fig6_*`` keys but the wall equal to the
    committed ones, with each cell's host/device split and the device
    busy share over one 1,024-node ring pass;
17. the incast overlay, card against CPU: the smoke KV plan (28 prefill
    -> 4 decode, fan-in 7, 32 nodes x 40 rounds), roce / irn / celeris
    (delivered packets exact, times within rtol 1e-5);
18. Fig. 8 on the card (``fig8_serving_tail.py``'s full tier): one
    engine pass over the 112 -> 16 KV incast plan (128 nodes x 300
    rounds, ``BatchedEngine(plan=)``), the request process and FIFO
    queue per design and load, all 26 engine-derived ``fig8_*`` keys
    equal to the committed ones; then the smoke LM decodes from caches
    degraded at the clipped tail fraction through ``degrade_caches``
    (the FWHT and unbias kernels), coded usable context >= 0.9, and the
    two kernels are held to their plain versions on that cell's caches,
    mask and signs;
19. qwen2-0.5b at full width on a 4,096-token prompt (batch 1): prefill
    through the tiled attention path, the coded KV transfer and 16
    greedy tokens, the transfer's kernels held to their plain versions
    on its caches ((197,376, 64) blocks); layer 0's tiled attention
    against the dense formula within two bf16 ulps of its largest
    output;
19b. gemma2-9b at full width (42 layers alternating local (window
     4,096) and global attention, softcaps 50 and 30, GeGLU, post-norms,
     head_dim 256, vocab 256,000, bf16, random weights from seed 0):
     phase 3's 8 x 512 path and bars on its four KV leaves (two caches
     of two kinds, each K and V its own payload, 8 FWHT and 4 unbias
     launches at least), the kernels held to their plain versions on
     every leaf ((2,924,544, 64) blocks) and timed there;
19c. gemma2-9b on 8,192 tokens (batch 1, the same weights), past its
     window: prefill through the tiled path with local masks and the
     softcap, the local layers' ring caches wrapped (4,096 slots, the
     global ones 8,208), the coded transfer and 16 tokens decoded
     through the ring, its kernels held to their plain versions at both
     leaf sizes; layer 0 (local) and layer 1 (global) tiled attention
     against the dense formula within 2^-6 of the largest output, both
     timed (no library yardstick: SDPA takes no softcap); the clean
     caches' decode at the last position against a teacher-forced
     forward (padded with filler to 9,216 tokens, that position alone
     unembedded) within 0.05 of the largest logit;
19d. chatglm3-6b (partial rotary, untied embeddings) and nemotron-4-15b
     (squared ReLU, untied) at full width through phase 3's path and
     bars, their KV leaves' kernels held to their plain versions and
     timed there;
19e. qwen2-moe-a2.7b at full width (24 MoE layers: 60 routed experts
     padded to 64, top-4, 4 shared experts, d 2048, bf16, random weights
     from seed 0) through phase 3's path and bars, each layer global
     attention and the local expert dispatch; its two KV leaves'
     kernels held to their plain versions and timed there ((3,342,336,
     64) blocks); one more prefill counts the picks each layer's
     capacity (320 slots) dropped;
19f. granite-moe-3b-a800m (32 MoE layers, 40 experts padded to 48,
     top-8, no shared experts, 24 heads padded to 32) the same way
     ((1,114,112, 64) blocks);
19g. recurrentgemma-9b at full width (38 layers: (rglru, rglru, local)
     x 12, then two rglru; d 4096, RG-LRU width 4096, local window
     2,048, 16 heads of 256, one kv head, GeGLU, vocab 256,000, bf16,
     random weights from seed 0) through phase 3's path and bars: its
     two K/V leaves (the 12 local layers' rings, (12, 8, 544, 1, 256))
     each a payload, exactly 4 FWHT and 2 unbias launches, the kernels
     held to their plain versions and timed at (208,896, 64); then the
     RG-LRU scan's share of one prefill and its launches
     (``loop_shares``);
19h. recurrentgemma-9b on 4,096 tokens (batch 1, the same weights): the
     RG-LRU scan in 8 chunks of 512 (208 scan calls), the tiled
     attention, the local rings wrapped (2,048 slots); the coded
     transfer and 16 tokens, its kernels held to their plain versions;
     layer 2's (local) tiled attention against the dense formula; every
     greedy step from the clean caches against a teacher-forced forward
     (padded with filler to 5,120 tokens) at its position, within 0.05
     of the largest logit;
19i. xlstm-350m at full width (24 layers, (mlstm x 3, slstm) x 6, d
     1024, 4 heads, vocab 50,304, bf16) through phase 3's path and bars:
     no K/V leaf, so no kernel launch on the path, and
     ``degrade_caches`` returns the prefill's caches bit for bit; the
     mLSTM's and the sLSTM's shares of one prefill;
19j. phi-3-vision-4.2b at full width (32 layers, d 3072, untied vocab
     32,064, bf16, random weights from seed 0): 8 x 512 text tokens
     after 144 image positions (image embeddings (8, 144, 1024) from
     seed 3, through ``frontend_proj``) through phase 3's path and bars,
     ``kv_position_error`` over all 656 positions; its two K/V leaves
     (32, 8, 688, 32, 96), the largest payloads shipped (2.16 GB each as
     float32): exactly 4 FWHT and 2 unbias launches, the kernels held to
     their plain versions and timed at (8,454,144, 64); 16 decode steps
     from position 656 each within 0.05 of a teacher-forced forward with
     the same image;
19k. seamless-m4t-medium at full width (12 encoder + 12 decoder layers,
     d 1024, tied vocab 256,206, bf16): 8 x 512 frames from seed 3
     encoded once (timed apart), phase 3's path and bars with that
     memory at prefill and every decode step (the cross-attention's
     K/V recomputed from it each step, as in JAX): exactly 4 FWHT and 2
     unbias launches at (835,584, 64), the memory unchanged bit for bit
     (it is not shipped); 16 decode steps against a teacher-forced
     forward with the memory; the cross K/V's share of a decode step;
19l. seamless-m4t-medium on 4,096 frames and 4,096 tokens (batch 1, the
     same weights): the encoder's bidirectional and the decoder's
     cross-attention tiled at 4,096 x 4,096 (and its causal
     self-attention), phase 3's path and bars with 16 tokens; layer 0's
     tiled encoder attention and tiled cross-attention against the
     dense formula within 2^-6 of the largest output (tiled, dense and
     SDPA timed); 16 decode steps against a teacher-forced forward
     padded with filler to 5,120 tokens;
19m. serving on a (data, model) mesh: four rank processes on the one
     card over gloo (the mesh launch's ``serve_mesh`` kind), every
     cell at full width, an 8 x 512 global prompt (each dp rank its
     rows), the KV coded at delivered fraction 0.9 (64 wire rows, each
     rank its own K/V slices), 16 decode steps: qwen2-0.5b on (2, 2)
     (kv heads split, vocab split) and (1, 4) (kv heads whole, padded q
     heads), gemma2-9b (2 layers: the ring, the softcaps, the 256,000-row
     tied vocab split) and granite-moe-3b-a800m (1 layer: EP prefill
     with the dp rows gathered, decode over the gathered experts) on
     (2, 2), recurrentgemma-9b (3 layers: the RG-LRU state by channel,
     the MQA ring whole) on (1, 4), xlstm-350m (4 layers: the mLSTM state
     by head, the sLSTM's whole, nothing shipped) on (2, 2), seamless
     (2 + 2, frames: TP encode, the memory on every rank, the 256,206-row
     vocab whole) on (1, 4).  Every rank's degraded K/V bit for bit the
     slice of the one-device degrade of the gathered clean leaves; the
     FWHT and unbias kernels equal to their plain versions at the rank
     leaf shapes (timed at each cell's first); the prefill within 0.05 of
     one device; each decode step within 0.05 of a teacher-forced mesh
     forward (granite's first 4 in float32 with its capacity lifted;
     xlstm's against one device's steps); the tokens' agreement with one
     device reported; prefill
     ms, decode tok/s, the KV transfer's ms and bytes a rank, the
     model-group and row-gather collectives' ms and bytes, peak GB a rank;
20. the priority cut, the per-step window and the flight recorder, card
    against CPU at 40 rounds: the 32-node 2-pod hier cell with
    layer-depth priority classes under both cut orders and both budget
    windows; per-node traces of all four designs and the per-step window
    in both stream modes; a recorded 2-pod pass with NIC stalls
    (packets, faulted flows, the recorder's packets and fabric counters
    exact; times, fractions and components within rtol 1e-5, a critical
    flow differing only at a near tie);
21. Fig. 10 on the card (``fig10_priority_loss.py``'s full grid: hier on
    4 pods, 128/256/512 nodes x oversubscription 2/8, 40 rounds, budget
    x 0.4, arrival against priority cuts): all 36 ``fig10_*`` keys but
    the wall equal to the committed ones, the two orders' round times
    equal in every cell, every high-priority loss ratio >= 2;
22. Fig. 9 on the card (``fig9_tail_attribution.py``'s full tier: the
    128-node flat ring x 60 rounds and the 2-pod stall cell, recorded):
    all 39 ``fig9_*`` keys but the wall equal to the committed ones,
    ``audit_round`` passing on every recorded pass, the stall cell's
    Perfetto trace written to ``results/fig9_trace.json`` and validated,
    and both passes' stats with the recorder off equal to the recorded
    ones bit for bit;
23. the production-scale dry run (``python -m repro_torch.launch.dryrun``
    in background processes that use no device, started after the build
    and waited for at the end of phase 2, whose times are all device
    times behind the spin kernel, so that no host-clock number of phase 3
    or after shares the host with them): ``--scale-check`` (the
    lossy_hadamard step at 512 and 1,024 ranks, rank 0 and the last), the
    same ``--mode hierarchical`` and the serve check (prefill_32k and
    decode_32k on 16 x 16 and 2 x 16 x 16, one process a mesh), every
    record ``ok`` (plain collectives only) and printed; the one-device
    reckoning 6j reads comes from the same processes.

The protocols of phases 14-16, 18 and 21-22 (and Fig. 2's step window)
are ``repro_torch.benchmarks.figs``'s functions, which the CPU tests also
run (smoke tiers and cut grids).

Each path (3-6j with 5b, and the engine's in 8-9, 11-13, 15-16, 18-19m and
21-22, Fig. 2's step window its own) runs with the kernels' launch counts set
to 0 just before it and read just after.  The last
line is ``{"ok": true, "device": {...}}``; the lines before it carry each
phase's wall seconds (``{"phase_seconds": {...}}``), the card's name and
power limit and a ``{"kernels": [...]}`` record.  Needs CUDA: without it the
script raises before printing any result.

``--ab-fwht`` builds the kernels, then only times ``csrc/fwht.cu``
against an earlier design of the same file (its path given), in turns,
at the serve, largest-leaf and gradient-payload shapes, and prints a
``{"fwht_ab": [...]}`` record.  ``--ab-dcqcn`` does the same for
``csrc/dcqcn.cu`` against the earlier one-thread walk over every step
(``git show 160fc53:src/repro_torch/kernels/csrc/dcqcn.cu``, whose
launch takes no workspace) on the five real blocks, both held equal bit
for bit, and prints ``{"dcqcn_ab": [...]}``.
"""
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

BATCH, PROMPT, GEN = 8, 512, 32
N_ROT, TAU, KV_FRAC = 64, 0.6, 0.9         # fig8's coded-KV recovery cell
# FWHT and unbias: tests/test_kernels.py's shapes, then every other
# template instance n = 2 .. 4096, with ragged tails: row counts that are
# not a multiple of a block's 4096 / n rows, and rows * n not a multiple
# of 16 at n < 16
SWEEP = [(8, 128), (3, 256), (100, 4096), (1, 2), (16, 1024), (257, 512),
         (4097, 2), (33, 4), (33, 8), (5, 16), (300, 32), (3, 64),
         (5, 1024), (3, 2048)]
# the quantizers: the main paths' (121,959, 4096), kernel_bench.py's
# (256, 4096), tests/test_kernels.py's shapes, the two tile extremes,
# and n = 16 and 2048
QUANT_SHAPES = [(121959, 4096), (256, 4096), (8, 128), (64, 512), (3, 64),
                (3, 256), (100, 1024), (4097, 2), (33, 32), (65, 16),
                (7, 2048)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, SMOKE_STEPS = 8, 128, 3, 14
MODES = ("exact", "lossy", "lossy_hadamard")
CODED_LEAVES = 8           # qwen2-0.5b leaves >= min_coded_size (65,536)
GRAD_VALUES, GRAD_PAYLOAD = 499_540_864, (121_959, 4096)   # its gradient
# the FWHT's rows on the train path: the tiles of 4096 of each coded leaf
# (wk/wv, wq/wo, the MLP weights, embed.table)
TRAIN_FWHT_ROWS = (672, 5376, 25536, 33236)
# ... and on a mesh with a model axis (dp_train's (4, 1) and (2, 2, 1),
# at phases 6b/6c's MESH_LAYERS), where each leaf tiles around its model
# dim (tp_fwht_shapes on a (4, 1) mesh; embed.table's model dim leaves
# 896 entries a column, so n_rot 512); on tp_train's (2, 2) mesh each
# rank rotates its half of the model dim
ALLREDUCE_PEERS = (1, 4)   # unbias counts: the one-rank group's and 4 peers'
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores (the kernels' arithmetic) in operations/s
HBM_BPS, F32_OPS = 3.35e12, 67e12
TOP_KERNELS = 4
# kernel timing: runs of K back-to-back calls of about RUN_MS, K at most
# MAX_K, the median of REPEATS runs; a working set that fits in the 50 MB
# L2 is timed cold, a FLUSH_BYTES buffer written before every call
RUN_MS, MAX_K, REPEATS, FLUSH_BYTES = 2.0, 50, 5, 64 << 20
SPIN_HZ = 2e9              # above the H100's SM clock: a spin lasts long enough
PROFILE_WARMUP = 64        # spin kernels that open each profile window


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, cold=False):
    """Device ms of one call of fn.

    CUDA events around a run of K back-to-back calls, divided by K; the
    median over REPEATS runs.  A spin kernel holds the stream while the
    host enqueues the run, so the host's cost per call (Python, the
    wrapper's checks) never leaves the card idle inside the events.
    ``cold``: before each call a 64 MB buffer is written (outside the
    events, which then bracket each call alone), so a working set that
    fits in L2 comes from device memory, as its callers find it.
    """
    fn()
    _sync()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    k = max(1, min(MAX_K, math.ceil(RUN_MS / max(start.elapsed_time(end),
                                                 1e-3))))
    flush = (torch.empty(FLUSH_BYTES // 4, device="cuda") if cold else None)
    runs = []
    for _ in range(REPEATS):
        torch.cuda._sleep(int((2 * k * (host_s + 5e-5) + 1e-4) * SPIN_HZ))
        if cold:
            events = []
            for _ in range(k):
                flush.zero_()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                fn()
                ev[1].record()
                events.append(ev)
            _sync()
            runs.append(statistics.median(a.elapsed_time(b)
                                          for a, b in events))
        else:
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / k)
    return statistics.median(runs)


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return err


def profile_window(fn):
    """Host wall time, device busy time (union of kernel intervals) and
    the kernels that took the most device time, for one call of fn.
    The device intervals are read from the profiler's raw events, not
    ``prof.events()``, whose tree of Python objects takes tens of
    seconds to build over a host-bound call's ~10^5 launches.  Late in
    a long process a window was seen to lose its first device events
    (37 of a 43-kernel call), so each window opens with PROFILE_WARMUP
    spin kernels, kept out of the counts: how many of them the profiler
    saw is reported beside."""
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1)
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
               e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    kernels = [k for k in device if "spin_kernel" not in k[2]]
    warm_seen = len(device) - len(kernels)
    busy_us, end = 0.0, -math.inf
    by_name = {}
    for start, stop, name in sorted(kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    if not kernels:                  # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured",
                "warmup_seen": warm_seen}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "n_kernel_launches": len(kernels), "warmup_seen": warm_seen,
            "top_kernels_ms": {k[:60]: v for k, v in ranked}}


SOURCES = ("fwht", "unbias", "quantize", "dcqcn")


class Launches:
    """The kernel wrappers' launch counters, by kernel name: a path is
    driven with them set to 0 just before it and read just after."""

    def __init__(self, kfwht, kunbias, kquant, kdcqcn):
        self.kfwht, self.kunbias, self.kquant = kfwht, kunbias, kquant
        self.kdcqcn = kdcqcn

    def reset(self):
        self.kfwht.launches = self.kfwht.quantize_launches = 0
        self.kunbias.launches = self.kquant.launches = 0
        self.kdcqcn.launches = 0

    def read(self):
        return {"fwht": self.kfwht.launches,
                "fwht_quantize": self.kfwht.quantize_launches,
                "masked_unbias": self.kunbias.launches,
                "quantize_int8": self.kquant.launches,
                "dcqcn_scan": self.kdcqcn.launches}


def check_equal(name, got, want):
    """Kernel codes and scales against the plain version's: equal, not
    close.  Returns the max abs difference (0)."""
    err = max((g.float() - w.float()).abs().max().item() if g.numel() else 0.0
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (
            f"{name}: differs from its plain version (max abs err {err})")
    return err


def quantize_expression(x, noise):
    """The library yardstick for the quantizers: one torch expression,
    timed only, never called by the port."""
    a = x.abs().amax(-1, keepdim=True)
    s = torch.where(a > 0, a / 127.0, 1.0)
    return (torch.clamp(torch.floor(x / s + noise), -127, 127)
            .to(torch.int8), s[:, 0])


def phase_build(_build):
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{' + '.join(n + '.cu' for n in SOURCES)} in parallel)")
    for name in SOURCES:
        # ptxas -v: one "Used N registers" line and one spill line for
        # each kernel (fwht.cu has one kernel per template instance)
        log = (_build.BUILD / f"{name}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                           "\n".join(lines))]
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and re.search(r"[1-9]\d* bytes spill", ln)]
        print(f"  ptxas {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, spills: "
              f"{spills or 'none'}")


def phase_kernels(dev, cfg, kfwht, kunbias, ref, coding, coupling):
    """Kernel vs plain version; returns the timing records."""
    g = torch.Generator(dev).manual_seed(0)
    # one stacked K (or V) cache of the main path is one coded payload
    kv_elems = (cfg.n_layers * BATCH * (PROMPT + GEN) * cfg.n_kv_heads
                * cfg.resolved_head_dim)
    code = coding.plan(kv_elems, n_rot=N_ROT)
    rows, n = code.n_blocks, code.n_rot          # (208,896, 64)
    records = []

    # FWHT at encode's shape: (n_blocks, n_rot) f32, fused signs and scale
    x = torch.randn(rows, n, generator=g, device=dev)
    signs = coding.rademacher(g, code)
    scale = n ** -0.5
    err = check_equal("fwht main", (kfwht.fwht_cuda(x, signs, scale),),
                      (ref.fwht(x, signs=signs, scale=scale),))
    records.append(fwht_record(kfwht, ref, x, signs, scale, err))

    # unbias at decode's shape: the wire layout (n_rot, n_blocks) f32
    y = torch.randn(n, rows, generator=g, device=dev)
    mask = coupling.kv_hole_masks(np.array([KV_FRAC]), N_ROT, seed=0)[0]
    counts = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    err = check("unbias main", kunbias.masked_unbias_cuda(y, counts, 1),
                ref.masked_unbias(y, counts, 1), 1e-6, 0.0)
    records.append(unbias_record(kunbias, ref, y, counts, 1, err))

    # the sweep: the FWHT equal to its plain version (it keeps its stage
    # order) with and without signs and scale; unbias at its tolerance
    worst = {"fwht": 0.0, "masked_unbias": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for r, m in SWEEP:
            xs = torch.randn(r, m, generator=g, device=dev).to(dtype)
            tag = f"{r}x{m} {dtype}"
            sg = torch.randint(0, 2, (m,), generator=g,
                               device=dev).float() * 2 - 1
            for what, sgn, sc in (("", None, 1.0),
                                  (" signs+scale", sg, m ** -0.5),
                                  (" scale", None, m ** -0.5)):
                worst["fwht"] = max(worst["fwht"], check_equal(
                    f"fwht{what} {tag}", (kfwht.fwht_cuda(xs, sgn, sc),),
                    (ref.fwht(xs, signs=sgn, scale=sc),)))
            cs = torch.randint(0, 5, (r,), generator=g, device=dev).float()
            e3 = check(f"unbias {tag}", kunbias.masked_unbias_cuda(xs, cs, 4),
                       ref.masked_unbias(xs, cs, 4), 1e-6, 0.0)
            worst["masked_unbias"] = max(worst["masked_unbias"], e3)
    check_misaligned(dev, kfwht)
    path_err, path_records = check_train_shapes(dev, g, cfg, kfwht, kunbias,
                                                ref)
    records += path_records
    _sync()
    for rec in records:
        rec["max_abs_err"] = max(rec["max_abs_err"], path_err[rec["name"]],
                                 worst[rec["name"]])
        print(f"kernel {rec['name']} {rec['shape']}: max_abs_err "
              f"{rec['max_abs_err']:.3g} (with the train and all-reduce "
              f"shapes), {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} by {rec['bound_by']}); sweep "
              f"of {len(SWEEP)} shapes x f32/bf16 worst err "
              f"{worst[rec['name']]:.3g}")
    return records


def fwht_record(kfwht, ref, x, signs, scale, err):
    """The FWHT's timing record at x's shape: kernel, plain version, the
    library yardstick and the bound (x read once, out written once)."""
    rows, n = x.shape
    folded = signs[:, None] * ref.hadamard_matrix(n, device=x.device) * scale
    nb, ops = 2 * rows * n * 4 + n * 4, rows * n * (int(math.log2(n)) + 2)
    b_ms, b_by = bound_ms(nb, ops)
    return {
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fwht.cu",
        "replaces": "src/repro/kernels/fwht.py:141",
        "shape": [rows, n], "dtype": "float32", "max_abs_err": err,
        "ms": time_ms(lambda: kfwht.fwht_cuda(x, signs, scale)),
        "plain_ms": time_ms(lambda: ref.fwht(x, signs=signs, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: x @ folded),
        "library": "torch.matmul(x, diag(signs) H scale), TF32 off"}


def unbias_record(kunbias, ref, y, counts, total, err):
    """Masked unbias's timing record at y's shape.  The kernel reads only
    the rows whose count is > 0, so the bound counts those rows read,
    every row written, and the counts."""
    rows, n = y.shape
    present = int((counts > 0).sum())
    nb, ops = (present + rows) * n * 4 + rows * 4, rows * n + rows
    b_ms, b_by = bound_ms(nb, ops)
    c2 = counts[:, None]
    return {
        "name": "masked_unbias", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/unbias.cu",
        "replaces": "src/repro/kernels/unbias.py:25",
        "shape": [rows, n], "dtype": "float32", "max_abs_err": err,
        "ms": time_ms(lambda: kunbias.masked_unbias_cuda(y, counts, total)),
        "plain_ms": time_ms(lambda: ref.masked_unbias(y, counts, total)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.where(
            c2 > 0, y * (total / c2.clamp(min=1)), 0.0)),
        "library": "torch.where(c > 0, y * (total / max(c, 1)), 0)"}


def check_misaligned(dev, kfwht):
    """A contiguous view that starts 4 bytes into its storage makes both
    FWHT wrappers raise ValueError, and launches nothing."""
    before = (kfwht.launches, kfwht.quantize_launches)
    x = torch.zeros(4 * 64 + 1, device=dev)[1:].view(4, 64)
    noise = torch.zeros(4, 64, device=dev)
    for name, call in (("fwht_cuda", lambda: kfwht.fwht_cuda(x)),
                       ("fwht_quantize_cuda",
                        lambda: kfwht.fwht_quantize_cuda(x, noise))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{name} took a misaligned view")
    assert (kfwht.launches, kfwht.quantize_launches) == before


def check_train_shapes(dev, g, cfg, kfwht, kunbias, ref):
    """FWHT (signs and scale fused) at each coded leaf's tiles, one
    device's, a dp mesh's and a (2, 2) tensor-parallel rank's, and at
    the gradient payload, equal to its plain version, and timed at the
    largest leaf's, the payload's, the dp mesh's n_rot-512 leaf and the
    TP rank's two largest; masked unbias at the payload's wire layout
    with counts from drop-0.05 masks at its tolerance, timed at one
    peer's.  The dp and tp shapes are phases 6b/6c's, at MESH_LAYERS.
    Returns the worst error by kernel and the timing records."""
    mesh_cfg = dataclasses.replace(cfg, n_layers=MESH_LAYERS)
    dp = tp_fwht_shapes(mesh_cfg, mesh_shape((DP_WORLD, 1),
                                             ("data", "model")))
    tp = sorted(set(tp_fwht_shapes(mesh_cfg)))
    shapes = ([(rows, GRAD_PAYLOAD[1]) for rows in TRAIN_FWHT_ROWS]
              + sorted(set(dp)) + tp + [GRAD_PAYLOAD])
    timed = ((TRAIN_FWHT_ROWS[-1], GRAD_PAYLOAD[1]), dp[-1], *tp[-2:],
             GRAD_PAYLOAD)
    worst = {"fwht": 0.0, "masked_unbias": 0.0}
    records = []
    for rows, n in shapes:
        x = torch.randn(rows, n, generator=g, device=dev)
        signs = (torch.randint(0, 2, (n,), generator=g, device=dev).float()
                 * 2 - 1)
        err = check_equal(f"fwht train/dp/tp/all-reduce {rows}x{n}",
                          (kfwht.fwht_cuda(x, signs, n ** -0.5),),
                          (ref.fwht(x, signs=signs, scale=n ** -0.5),))
        worst["fwht"] = max(worst["fwht"], err)
        if (rows, n) in timed:
            records.append(fwht_record(kfwht, ref, x, signs, n ** -0.5, err))
        del x
    n = GRAD_PAYLOAD[1]
    y = torch.randn(n, GRAD_PAYLOAD[0], generator=g, device=dev)
    for peers in ALLREDUCE_PEERS:
        counts = (torch.rand(peers, n, generator=g, device=dev) >= 0.05
                  ).sum(0).float()
        err = check(f"unbias all-reduce {n}x{GRAD_PAYLOAD[0]} {peers} peers",
                    kunbias.masked_unbias_cuda(y, counts, peers),
                    ref.masked_unbias(y, counts, peers), 1e-6, 0.0)
        worst["masked_unbias"] = max(worst["masked_unbias"], err)
        if peers == 1:                     # the one-rank all-reduce's case
            records.append(unbias_record(kunbias, ref, y, counts, peers, err))
    print(f"train/dp/tp/all-reduce shapes: fwht at {shapes} worst err "
          f"{worst['fwht']:.3g}; masked_unbias at ({n}, {GRAD_PAYLOAD[0]}), "
          f"counts of {list(ALLREDUCE_PEERS)} peers at drop 0.05, worst err "
          f"{worst['masked_unbias']:.3g}")
    return worst, records


def phase_quant_kernels(dev, kfwht, kquant, ref):
    """The fused rotate+quantize and the int8 quantize kernels against
    their plain versions (codes and scales equal) and the fused kernel
    against the kernel pair, over QUANT_SHAPES; returns the timing
    records at the main paths' shape."""
    g = torch.Generator(dev).manual_seed(5)
    records = []
    for rows, n in QUANT_SHAPES:
        x = torch.randn(rows, n, generator=g, device=dev) * 3
        noise = torch.rand(rows, n, generator=g, device=dev)
        signs = torch.randint(0, 2, (n,), generator=g,
                              device=dev).float() * 2 - 1
        scale = n ** -0.5
        tag = f"{rows}x{n}"
        e_q = check_equal(f"quantize_int8 {tag}",
                          kquant.quantize_int8_cuda(x, noise),
                          ref.quantize_int8(x, noise))
        fused = kfwht.fwht_quantize_cuda(x, noise, signs, scale)
        e_f = check_equal(f"fwht_quantize {tag}", fused,
                          ref.fwht_quantize(x, noise, signs=signs,
                                            scale=scale))
        check_equal(f"fwht_quantize {tag} vs the kernel pair", fused,
                    kquant.quantize_int8_cuda(
                        kfwht.fwht_cuda(x, signs, scale), noise))
        check_equal(f"fwht_quantize {tag} unsigned",
                    kfwht.fwht_quantize_cuda(x, noise),
                    ref.fwht_quantize(x, noise))
        if (rows, n) != QUANT_SHAPES[0]:
            continue
        # timing records at the main shape: x and noise read once, int8
        # codes and a float32 scale per row written once
        nb = rows * n * (4 + 4 + 1) + rows * 4
        log_n = int(math.log2(n))
        h = ref.hadamard_matrix(n, device=dev)
        folded = signs[:, None] * h * scale            # diag(signs) H scale
        for name, err, fn, plain, lib, ops_per, extra_b, src, rep, lname in (
                ("fwht_quantize", e_f,
                 lambda: kfwht.fwht_quantize_cuda(x, noise, signs, scale),
                 lambda: ref.fwht_quantize(x, noise, signs=signs,
                                           scale=scale),
                 lambda: quantize_expression(x @ folded, noise),
                 log_n + 8, n * 4, "src/repro_torch/kernels/csrc/fwht.cu",
                 "src/repro/kernels/fwht.py:94",
                 "torch.matmul(x, diag(signs) H scale), TF32 off, then "
                 "amax/where/div/add/floor/clamp/to(int8)"),
                ("quantize_int8", e_q,
                 lambda: kquant.quantize_int8_cuda(x, noise),
                 lambda: ref.quantize_int8(x, noise),
                 lambda: quantize_expression(x, noise), 7, 0,
                 "src/repro_torch/kernels/csrc/quantize.cu",
                 "src/repro/kernels/quantize.py:31",
                 "amax/where/div/add/floor/clamp/to(int8)")):
            b_ms, b_by = bound_ms(nb + extra_b, rows * n * ops_per)
            records.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "shape": [rows, n], "dtype": "float32",
                "max_abs_err": err, "ms": time_ms(fn),
                "plain_ms": time_ms(plain), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": time_ms(lib),
                "library": lname})
        del x, noise, fused, h, folded
    _sync()
    for rec in records:
        print(f"kernel {rec['name']} {rec['shape']}: codes and scales "
              f"equal to the plain version over {len(QUANT_SHAPES)} shapes "
              f"(fused == kernel pair), {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} by {rec['bound_by']})")
    return records


# the A/B shapes: the FWHT at serve's, the largest leaf's and the
# gradient payload's shape, and the fused kernel at the payload's
AB_SHAPES = (("fwht", (208_896, 64)), ("fwht", (TRAIN_FWHT_ROWS[-1], 4096)),
             ("fwht", GRAD_PAYLOAD), ("fwht_quantize", GRAD_PAYLOAD))


def phase_fwht_ab(dev, earlier_src, _build, kfwht, ref):
    """``csrc/fwht.cu`` against an earlier design of it with the same C
    interface, built from ``earlier_src``: at AB_SHAPES both designs'
    outputs equal the plain version's, and their times are taken in
    turns (earlier, this, this, earlier) into preallocated outputs,
    beside the plain version, the library yardstick and the bound."""
    libs = {"earlier": kfwht.bind(_build.load("fwht_earlier", earlier_src)),
            "this": kfwht.bind(_build.load("fwht"))}
    g = torch.Generator(dev).manual_seed(7)
    records = []
    for name, (rows, n) in AB_SHAPES:
        x = torch.randn(rows, n, generator=g, device=dev)
        signs = torch.randint(0, 2, (n,), generator=g,
                              device=dev).float() * 2 - 1
        scale, log_n = n ** -0.5, n.bit_length() - 1
        folded = signs[:, None] * ref.hadamard_matrix(n, device=dev) * scale
        if name == "fwht":
            out = (torch.empty_like(x),)
            args = (x.data_ptr(), out[0].data_ptr(), signs.data_ptr(), rows,
                    log_n, scale, 0)
            plain = lambda: ref.fwht(x, signs=signs, scale=scale)
            library = lambda: x @ folded
            nb, ops = 2 * rows * n * 4 + n * 4, rows * n * (log_n + 2)
        else:
            noise = torch.rand(rows, n, generator=g, device=dev)
            out = (torch.empty(rows, n, dtype=torch.int8, device=dev),
                   torch.empty(rows, device=dev))
            args = (x.data_ptr(), noise.data_ptr(), signs.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), rows, log_n, scale)
            plain = lambda: ref.fwht_quantize(x, noise, signs=signs,
                                              scale=scale)
            library = lambda: quantize_expression(x @ folded, noise)
            nb = rows * n * (4 + 4 + 1) + rows * 4 + n * 4
            ops = rows * n * (log_n + 8)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        entry = 0 if name == "fwht" else 1
        times = {"earlier": [], "this": []}
        for design in ("earlier", "this", "this", "earlier"):
            launch = libs[design][entry]

            def call():
                err = launch(*args, torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"{design} {name} launch: cudaError {err}"

            for t in out:
                t.zero_()
            call()
            check_equal(f"{design} {name} {rows}x{n}", out, want)
            times[design].append(time_ms(call))
        del want
        b_ms, b_by = bound_ms(nb, ops)
        rec = {"name": name, "shape": [rows, n], "dtype": "float32",
               "earlier_ms": times["earlier"], "ms": times["this"],
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "bound_ms": b_ms, "bound_by": b_by}
        for design, key in (("earlier", "earlier_share"), ("this", "share")):
            rec[key] = b_ms / statistics.mean(times[design])
        records.append(rec)
        print(f"A/B {name} {rows}x{n}: earlier {times['earlier']} ms, this "
              f"{times['this']} ms (bound {b_ms:.4f}, share "
              f"{rec['earlier_share']:.3f} -> {rec['share']:.3f}); plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}")
        del x, out, folded
        torch.cuda.empty_cache()
    return records


# the earlier design's dcqcn_scan_launch: no workspace argument
EARLIER_DCQCN_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3
                          + [ctypes.c_double] * 5
                          + [ctypes.c_int, ctypes.c_void_p])


def phase_dcqcn_ab(dev, earlier_src, _build, kdcqcn, E, ET, P, topology):
    """``csrc/dcqcn.cu`` against an earlier design of it, built from
    ``earlier_src`` (the one-thread walk over every step, whose launch
    takes no workspace, or one with this C interface) on the five real
    blocks: both designs' rates and state equal bit for bit, and their
    times taken in turns (earlier, this, this, earlier), beside the bound
    and its parts."""
    lib = _build.load("dcqcn_earlier", earlier_src)
    if hasattr(lib, "dcqcn_scan_workspace_bytes"):
        early, early_ws = kdcqcn.bind(lib)
    else:
        early, early_ws = lib.dcqcn_scan_launch, None
        early.argtypes = EARLIER_DCQCN_ARGTYPES
        early.restype = ctypes.c_int
    this, ws_bytes = kdcqcn.bind(_build.load("dcqcn"))
    dq = P.DcqcnParams()
    params = (dq.alpha_g, dq.rate_decrease_floor, dq.additive_increase,
              dq.hyper_increase, dq.min_rate, dq.hyper_after)
    records = []
    for name, (cnp, any_t) in real_scan_blocks(E, ET, P, topology,
                                               dev).items():
        S, tb, n = cnp.shape
        state = scan_state(S, n, dev)
        outs = {d: (torch.empty(S, tb, n, device=dev),)
                + tuple(torch.empty_like(t) for t in state)
                for d in ("earlier", "this")}
        work = {d: torch.empty(w(S, tb, n), dtype=torch.uint8, device=dev)
                for d, w in (("earlier", early_ws), ("this", ws_bytes))
                if w is not None}
        ptrs = [cnp.data_ptr(), any_t.data_ptr(),
                *(t.data_ptr() for t in state)]

        def launcher(design):
            o = [t.data_ptr() for t in outs[design]]
            extra = [work[design].data_ptr()] if design in work else []
            fn = early if design == "earlier" else this

            def call():
                err = fn(*ptrs, *o, S, tb, n, *params, *extra,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"{design} dcqcn {name}: cudaError {err}"
            return call

        calls = {d: launcher(d) for d in outs}
        times = {"earlier": [], "this": []}
        for design in ("earlier", "this", "this", "earlier"):
            calls[design]()
            times[design].append(time_ms(calls[design]))
        check_equal(f"dcqcn {name}: this == earlier", outs["this"],
                    outs["earlier"])
        bound, by, parts = scan_bounds(cnp, any_t)
        rec = {"block": name, "shape": [S, tb, n],
               "active_step_share": float(any_t.float().mean()),
               "max_active_steps": int(any_t.sum(1).max()),
               "earlier_ms": times["earlier"], "ms": times["this"],
               "bound_ms": bound, "bound_by": by, **parts,
               "earlier_share": bound / statistics.mean(times["earlier"]),
               "share": bound / statistics.mean(times["this"])}
        records.append(rec)
        print(f"A/B dcqcn_scan {name} {[S, tb, n]}: earlier "
              f"{times['earlier']} ms, this {times['this']} ms (bound "
              f"{bound:.5f} by {by}, share {rec['earlier_share']:.3f} -> "
              f"{rec['share']:.3f}); equal bit for bit")
        del cnp, any_t, outs, work
        torch.cuda.empty_cache()
    return records


def phase_kernel_bench(dev, ops, counts):
    """benchmarks/kernel_bench.py's quantize rows at (256, 4096) through
    ``kernels.ops``: fused-signs FWHT, quantize, the unfused pair and the
    fused kernel.  One pass with the launch counts read around it, then
    the timings."""
    g = torch.Generator(dev).manual_seed(6)
    x = torch.randn(256, 4096, generator=g, device=dev)
    signs = torch.randint(0, 2, (4096,), generator=g,
                          device=dev).float() * 2 - 1
    noise = torch.rand(256, 4096, generator=g, device=dev)
    sc = 4096 ** -0.5
    rows = {
        "fwht_fused_signs": lambda: ops.fwht(x, signs=signs, scale=sc),
        "quantize": lambda: ops.quantize_int8(x, noise),
        "fwht_quant_unfused": lambda: ops.quantize_int8(
            ops.fwht(x, signs=signs, scale=sc), noise),
        "fwht_quant_fused": lambda: ops.fwht_quantize(x, noise, signs=signs,
                                                      scale=sc)}
    _sync()
    counts.reset()
    out = {k: fn() for k, fn in rows.items()}
    _sync()
    launches = counts.read()
    check_equal("kernel bench fused vs unfused", out["fwht_quant_fused"],
                out["fwht_quant_unfused"])
    assert launches == {"fwht": 2, "fwht_quantize": 1, "masked_unbias": 0,
                        "quantize_int8": 2, "dcqcn_scan": 0}, launches
    # 12 MB fits in L2: timed cold, as the real callers find it
    times = {k: time_ms(fn, cold=True) for k, fn in rows.items()}
    print(f"kernel bench (256, 4096) ms: {times}; launches {launches}")
    return {"ms": times, "launches": launches}


def phase_train(dev, C, ts, Trainer, DataConfig, OptConfig, counts):
    """qwen2-0.5b at full width through Trainer, three steps a mode.
    Returns the records and the last (lossy_hadamard) trainer."""
    cfg = C.get("qwen2-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    out, total = {}, {}
    tr = None
    for mode in MODES:
        del tr
        torch.cuda.empty_cache()
        tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                     celeris=ts.CelerisConfig(mode=mode), seed=0,
                     device=str(dev))
        torch.cuda.reset_peak_memory_stats()
        steps = []

        def on_metrics(step, m):
            steps.append(dict(m, launches=counts.read()))
            counts.reset()

        _sync()
        counts.reset()
        hist = tr.run(TRAIN_STEPS, on_metrics=on_metrics)
        for rec in steps:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        assert np.isfinite(hist["loss"]).all(), (mode, hist["loss"])
        fwht_per_step = [rec["launches"]["fwht"] for rec in steps]
        if mode == "lossy_hadamard":
            assert fwht_per_step == [2 * CODED_LEAVES] * TRAIN_STEPS, (
                f"{mode}: FWHT launches per step {fwht_per_step}")
        else:
            assert fwht_per_step == [0] * TRAIN_STEPS, (mode, fwht_per_step)
        if mode != "exact":
            assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"]), (
                mode, hist["recv_frac"])
        step_ms = [rec["wall_s"] * 1e3 for rec in steps]
        out[mode] = {"loss": hist["loss"], "recv_frac": hist["recv_frac"],
                     "drop_rate": hist["drop_rate"], "step_ms": step_ms,
                     "median_step_ms_after_first":
                         statistics.median(step_ms[1:]),
                     "fwht_launches_per_step": fwht_per_step,
                     "peak_mem_gib": peak_gib}
        print(f"train {mode}: loss {hist['loss']}, recv_frac "
              f"{hist['recv_frac']}, step ms {step_ms} (median after the "
              f"first {out[mode]['median_step_ms_after_first']:.1f}), "
              f"FWHT launches/step {fwht_per_step}, peak {peak_gib:.2f} GiB")
    batch = tr.put_batch(TRAIN_STEPS)

    def profiled_step():
        # The step donates its state, so the profiled step's state is
        # kept: it is the only one whose buffers are still whole.
        tr.state, _ = tr.step_fn(tr.state, batch, tr.step_generator(99),
                                 0.05)

    out["profile_lossy_hadamard_step"] = profile_window(profiled_step)
    print(f"profile lossy_hadamard step: "
          f"{out['profile_lossy_hadamard_step']}")
    out["launches"] = total
    out["remat_cost"] = remat_cost(cfg, tr)
    return out, tr


def remat_cost(cfg, tr):
    """Phase 5's cost of remat: the loss and its gradients (``lm_loss``
    and ``autograd.grad``, what remat changes in the step) on the
    trainer's weights and a phase-5 batch, with remat and without in
    turns, REMAT_COST_REPEATS times each after one warm-up of each; host
    wall ms to a synchronised end.  No kernel of the port runs here."""
    from repro_torch.models import convert
    from repro_torch.models import model as M
    params = convert.params_from_leaves(tr.state["params"], cfg)
    batch = tr.put_batch(0)
    ms = {True: [], False: []}
    for i in range(REMAT_COST_REPEATS + 1):
        for remat in (True, False):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            _sync()
            t0 = time.perf_counter()
            loss, _ = M.lm_loss(p, cfg, batch, remat=remat)
            torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            _sync()
            if i:
                ms[remat].append((time.perf_counter() - t0) * 1e3)
    out = {"remat_ms": ms[True], "no_remat_ms": ms[False],
           "ratio_of_medians": statistics.median(ms[True])
           / statistics.median(ms[False])}
    print(f"train remat cost (phase 5's cell, loss + gradients, warm, "
          f"in turns): remat ms {out['remat_ms']}, no remat ms "
          f"{out['no_remat_ms']}, ratio of medians "
          f"{out['ratio_of_medians']:.3f} [{card_name_and_power()}]")
    return out


def phase_allreduce(dev, ts, tr, coding, lc, counts):
    """One full-width gradient through lossy_pmean on a one-rank NCCL
    group: int8 wire at drop 0 and 0.05, float32 wire at 0.05."""
    import socket
    import torch.distributed as dist
    from repro_torch import generator
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        *_, grads = ts.loss_and_grads(tr.cfg, tr.state["params"],
                                      tr.put_batch(TRAIN_STEPS + 1))
        flat, _ = coding.tree_ravel(grads)
        del grads
        code = coding.plan(flat.numel())
        assert flat.numel() == GRAD_VALUES, flat.numel()
        assert (code.n_blocks, code.n_rot) == GRAD_PAYLOAD, code
        signs = coding.rademacher(generator(dev, 2), code)
        lc.exact_psum(torch.ones(8, device=dev))         # NCCL set-up

        def call(drop, quantize_wire, seed):
            return lc.lossy_pmean(flat, seed=seed, drop_rate=drop,
                                  signs=signs, code=code,
                                  quantize_wire=quantize_wire)

        call(0.0, True, 10)                               # warm-up
        out, total = {}, {}
        norm = flat.norm().item()
        for name, drop, q in (("int8_drop0", 0.0, True),
                              ("int8_drop0.05", 0.05, True),
                              ("f32_drop0.05", 0.05, False)):
            _sync()
            counts.reset()
            t0 = time.perf_counter()
            est, frac = call(drop, q, 11)
            _sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = counts.read()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            want = ({"fwht": 1, "fwht_quantize": 1, "masked_unbias": 1,
                     "quantize_int8": 0, "dcqcn_scan": 0} if q else
                    {"fwht": 2, "fwht_quantize": 0, "masked_unbias": 1,
                     "quantize_int8": 0, "dcqcn_scan": 0})
            assert launches == want, (name, launches)
            rel = (est - flat).norm().item() / norm
            frac = frac.item()
            assert torch.isfinite(est).all() and est.shape == flat.shape
            if drop == 0.0:
                assert frac == 1.0 and rel < 0.05, (name, frac, rel)
            else:
                assert abs(frac - 0.95) < 0.04, (name, frac)
            out[name] = {"ms": ms, "recv_frac": frac, "rel_l2_err": rel,
                         "launches": launches}
            print(f"all-reduce {name}: {ms:.2f} ms, recv_frac {frac:.4f}, "
                  f"relative L2 error {rel:.4f}, launches {launches}")
            del est
        out["launches"] = total
        out["payload"] = [code.n_blocks, code.n_rot]
        return out
    finally:
        dist.destroy_process_group()


# A full-width checkpoint: the parameters stored as float32 (2.0 GB) and
# master, mu and nu (6.0 GB); phase 5b writes two, phase 6c one.
CKPT_BYTES = 4 * 4 * 499_540_864
CKPT_DIR = os.path.join(SRC, "repro_torch", "kernels", "build", "ckpt")


def bit_view(x):
    """``x``'s bits as integers, so that ``torch.equal`` compares them."""
    return x.view({torch.bfloat16: torch.int16, torch.float32: torch.int32
                   }.get(x.dtype, x.dtype))


def ckpt_space(directory, n):
    """Make ``directory`` anew and raise unless its disk holds ``n``
    full-width checkpoints."""
    import shutil
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    free = shutil.disk_usage(directory).free
    if free < n * CKPT_BYTES:
        raise RuntimeError(f"{directory}: {free / 1e9:.1f} GB free, "
                           f"{n} checkpoints need {n * CKPT_BYTES / 1e9:.1f}")


def timed_calls(module, names, log):
    """Wrap ``module.<name>`` for each name so that every call appends its
    host-clock seconds to ``log[name]``; returns the saved functions."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return saved


def phase_checkpoint(dev, C, ts, Trainer, DataConfig, OptConfig, ckpt,
                     counts):
    """Phase 5b: checkpoint and restart on one device at full width,
    MESH_LAYERS deep (``mesh_config``: at 24 layers the phase took ~46 s
    of the script's limit on an H100 80GB HBM3).  An
    ``exact`` trainer checkpoints every 2 steps and fails after step 2; a
    fresh one resumes at step 2 with the saved state bit for bit and the
    saved timeout, and its next step equals an uninterrupted 3-step
    run's (run twice first: bit for bit if the card repeats itself, else
    within the spread of the two); a ``lossy_hadamard`` trainer resumes
    from the same checkpoint and launches the FWHT 16 times a step; then
    one ``save`` of the state is timed.  The checkpoints are deleted."""
    import shutil
    cfg = mesh_config(C)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    run_dir, save_dir = (os.path.join(CKPT_DIR, n) for n in ("run", "save"))
    ckpt_space(CKPT_DIR, 2)

    def trainer(mode="exact", directory=None):
        torch.cuda.empty_cache()
        return Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                       celeris=ts.CelerisConfig(mode=mode), seed=0,
                       ckpt_dir=directory, ckpt_every=2, device=str(dev))

    log = {}
    saved_fns = timed_calls(ckpt, ("save", "save_async", "restore"), log)
    try:
        ref = []
        for _ in range(2):
            tr = trainer()
            tr.run(3)
            ref.append([p.cpu() for p in tr.state["params"]])
            del tr
        same = [torch.equal(bit_view(a), bit_view(b)) for a, b in zip(*ref)]
        spread = [(a.double() - b.double()).abs().max().item()
                  for a, b in zip(*ref)]

        tr = trainer(directory=run_dir)
        snap = {}

        def on_metrics(step, m):
            if step == 1:      # the state and timeout the save then takes
                # (a copy: the next step updates the state in place)
                snap["leaves"] = [x.to("cpu", copy=True) for _, x in
                                  ts.state_leaves(tr.state, tr.names)]
                snap["timeout"] = tr.controller.timeout

        try:
            tr.run(3, on_metrics=on_metrics, simulate_fault_at=2)
            raise AssertionError("simulate_fault_at=2 did not raise")
        except RuntimeError as e:
            assert "simulated node failure at step 2" in str(e), e
        del tr
        assert ckpt.latest_step(run_dir) == 2, ckpt.latest_step(run_dir)

        tr = trainer(directory=run_dir)
        assert tr.start_step == 2, tr.start_step
        assert tr.controller.timeout == snap["timeout"], (
            tr.controller.timeout, snap["timeout"])
        for (path, x), want in zip(ts.state_leaves(tr.state, tr.names),
                                   snap["leaves"]):
            x = x.cpu()
            assert x.dtype == want.dtype and torch.equal(
                bit_view(x), bit_view(want)), f"restored {path} differs"
        del snap
        tr.run(1)
        resumed = [p.cpu() for p in tr.state["params"]]
        del tr
        for i, (a, b) in enumerate(zip(resumed, ref[0])):
            if same[i]:
                assert torch.equal(bit_view(a), bit_view(b)), (
                    f"resumed leaf {i} differs from the uninterrupted run")
            else:
                diff = (a.double() - b.double()).abs().max().item()
                assert diff <= 2 * spread[i], (i, diff, spread[i])
        del ref, resumed

        tr = trainer("lossy_hadamard", run_dir)
        assert tr.start_step == 2
        _sync()
        counts.reset()
        hist = tr.run(1)
        launches = counts.read()
        assert launches == {"fwht": 2 * CODED_LEAVES, "fwht_quantize": 0,
                            "masked_unbias": 0, "quantize_int8": 0,
                            "dcqcn_scan": 0}, launches
        assert np.isfinite(hist["loss"]).all(), hist
        ckpt.save(save_dir, 3, ts.state_leaves(tr.state, tr.names),
                  {"timeout": tr.controller.timeout, "arch": cfg.name})
        del tr
        torch.cuda.empty_cache()
        on_disk = sum(os.path.getsize(os.path.join(save_dir, "step_3", f))
                      for f in os.listdir(os.path.join(save_dir, "step_3")))
    finally:
        for name, fn in saved_fns.items():
            setattr(ckpt, name, fn)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    # save: the trainer's background write, then the timed one; restore:
    # the exact and the lossy_hadamard resumes
    out = {"save_s": log["save"], "save_async_blocking_s": log["save_async"],
           "restore_s": log["restore"], "bytes_on_disk": on_disk,
           "layers": cfg.n_layers,
           "deterministic_leaves": sum(same), "spread": spread,
           "launches": launches, "loss_after_resume": hist["loss"]}
    smi = card_name_and_power()
    print(f"checkpoint (qwen2-0.5b full width, {cfg.n_layers} of 24 layers, "
          f"one device): the fault at "
          f"step 2 left LATEST 2; the resume equals the saved state and "
          f"timeout bit for bit, and its step the uninterrupted run's "
          f"({sum(same)} of {len(same)} leaves deterministic run to run); "
          f"{on_disk} B on disk; save s {log['save']}, save_async blocking "
          f"s {log['save_async']}, restore s {log['restore']}; "
          f"lossy_hadamard resume launches {launches} [{smi}]")
    return out


# check_first_step's tolerances: a step's loss and recv_frac (rtol,
# atol); the first moments (rtol, atol as a share of the leaf's largest
# entry, atol); the parameters' atol beyond the explained update.  The
# card's own, and tests/test_torch_train.py's for one whole step.
CARD_STEP_TOL = dict(loss=(2e-4, 2e-4), recv_frac=(2e-4, 2e-4),
                     mu=(1e-4, 1e-4, 0.0), params=2e-4)
TEST_STEP_TOL = dict(loss=(1e-5, 0.0), recv_frac=(0.0, 1e-7),
                     mu=(0.0, 0.0, 1e-8), params=1e-7)


def check_first_step(name, new_dev, new_cpu, opt, steps=None,
                     tol=CARD_STEP_TOL):
    """One AdamW step's state, card against CPU; returns the first
    moments' largest difference.  The first moment is (1 - b1) times the
    synced, clipped gradient g, so it holds whatever the sync (masking,
    the FWHT encode and decode) made of the gradient: ``tol["mu"]``.  The
    first update is lr * g / (|g| + eps), i.e. lr per entry, whose slope
    near g = 0 is lr / eps: each parameter is held to ``tol["params"]``
    plus the update difference that the two sides' own g explain, so a
    sign that rounds the other way at |g| ~ eps is not taken for a fault.
    ``steps`` (leaf index -> float, the int8 wire's ``int8_step_bound``)
    adds one quantization step of g to a first moment's atol."""
    rtol, share, atol = tol["mu"]
    worst = 0.0
    for i, (mu_d, mu_c, p_d, p_c) in enumerate(zip(
            new_dev["opt"]["mu"], new_cpu["opt"]["mu"], new_dev["params"],
            new_cpu["params"])):
        mu_d = mu_d.cpu()
        step = (1 - opt.b1) * (steps or {}).get(i, 0.0)
        worst = max(worst, check(
            f"{name} leaf {i} first moment card vs cpu", mu_d, mu_c, rtol,
            share * mu_c.abs().max().item() + atol + step))
        g_d, g_c = (mu.double() / (1 - opt.b1) for mu in (mu_d, mu_c))
        explained = opt.lr * ((g_d / (g_d.abs() + opt.eps))
                              - (g_c / (g_c.abs() + opt.eps))).abs()
        diff = (p_d.cpu().double() - p_c.double()).abs()
        bad = diff > tol["params"] + explained
        assert not bad.any(), (
            f"{name} leaf {i} params card vs cpu: {int(bad.sum())} entries "
            f"beyond {tol['params']} + explained, max diff "
            f"{diff.max().item():.3g}")
    return worst


def small_steps_card_vs_cpu(dev, ts, cfg, opt, batch, drop, modes, tol,
                            name):
    """One step a mode of ``cfg`` on the card (kernels) against the port's
    CPU step (plain versions): one CPU state from seed 0, the same batch,
    and the same masks and signs (generator 3, a row kept at 1 - ``drop``),
    held to ``tol`` (``check_first_step``'s).  Returns the state and, a
    mode, the card's loss and recv_frac and the first moments' largest
    difference."""
    from repro_torch.models import convert
    cpu = torch.device("cpu")
    state = ts.init_state(torch.Generator(cpu).manual_seed(0), cfg)
    celeris = dict(min_coded_size=1024)
    g = torch.Generator(cpu).manual_seed(3)
    masks, signs = {}, {}
    plans = ts.plan_leaves(convert.leaf_shapes(cfg), None,
                           ts.CelerisConfig(**celeris),
                           convert.leaf_names(cfg))
    for i, plan in enumerate(plans):
        if plan is not None:
            masks[i] = torch.rand(plan.n_rot, generator=g) >= drop
            signs[i] = torch.randint(0, 2, (plan.n_rot,),
                                     generator=g).float() * 2 - 1
    out = {}
    for mode in modes:
        step = ts.make_train_step(cfg, None, opt,
                                  ts.CelerisConfig(mode=mode, **celeris))
        (new_cpu, m_cpu), (new_dev, m_dev) = [
            step(to_device(state, d), to_device(batch, d), None, drop,
                 masks=masks, signs=signs) for d in (cpu, dev)]
        for k in ("loss", "recv_frac"):
            check(f"{name} {mode} {k} card vs cpu", m_dev[k].cpu(),
                  m_cpu[k], *tol[k])
        out[mode] = {"loss": m_dev["loss"].item(),
                     "recv_frac": m_dev["recv_frac"].item(),
                     "first_moment_max_abs_err": check_first_step(
                         f"{name} {mode}", new_dev, new_cpu, opt, tol=tol)}
    return state, out


def over_data(state, dg):
    """A step's new parameters and first moments, the moments gathered
    over ``data`` (ZeRO-1, ``dg`` the step's data group) into this rank's
    shards of the whole, as ``check_first_step`` compares them."""
    from repro_torch import sharding as shd
    mu = state["opt"]["mu"]
    if dg is not None:
        mu = [x if d is None else shd.data_all_gather(x, dg, d)
              for x, d in zip(mu, dg.dims)]
    return {"params": state["params"], "opt": {"mu": mu}}


def int8_scales(grads, plans, masks, signs, lossy, exact=None, model=None):
    """Per coded leaf (index -> (scale, counts)): the int8 wire's scale
    of each wire row, the all-peers maximum of |contribution| / 127, and
    the count of peers that delivered the row, recomputed from this
    rank's gradients the way the step's int8 wire does
    (``ts._int8_wire``, over ``model`` too for a leaf split there); every
    rank gets the same."""
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.core import coding
    from repro_torch.train import train_step as ts
    out = {}
    for i, m in masks.items():
        g = grads[i] if exact is None else ts._pmean(grads[i], exact)
        contrib = (coding.encode_nd(g, signs[i], plans[i])
                   * m[None, :, None].to(torch.float32))
        absmax = torch.amax(contrib.abs(), dim=(0, 2))
        if model is not None and plans[i].sharded_dim is not None:
            shd.model_all_reduce(absmax, model, dist.ReduceOp.MAX)
        absmax = ts._all_reduce(absmax, lossy.group, dist.ReduceOp.MAX)
        out[i] = (absmax / 127.0,
                  ts._all_reduce(m.to(torch.float32), lossy.group))
    return out


def int8_step_bound(cfg, leaves, batch, plans, masks, signs, lossy,
                    exact=None, model=None):
    """Per coded leaf (index -> float): the most that one int8 code
    flipped by one step moves an entry of the synced gradient.  Two sides
    whose gradients differ in the last bits can round a code on either
    side of a ``floor``; after the decode such a flip moves every entry
    of its tile column by scale_r * (peers / count_r) * (n_rot / k) /
    sqrt(n_rot) / peers.  ``model``: the tensor-parallel group of a
    rank holding shards."""
    from repro_torch.train import train_step as ts
    *_, grads = ts.loss_and_grads(cfg, leaves, batch, model)
    out = {}
    for i, (scale, counts) in int8_scales(grads, plans, masks, signs, lossy,
                                          exact, model).items():
        k = int((counts > 0).sum())
        worst = (scale * lossy.size / counts.clamp(min=1)).max()
        out[i] = (float(worst) * plans[i].n_rot / k
                  / math.sqrt(plans[i].n_rot) / lossy.size)
    return out


def int8_noise_bound(grads, plans, masks, signs, lossy, exact=None,
                     model=None):
    """Per coded leaf (index -> float): a bound on the norm of what the
    int8 wire's rounding adds to the synced gradient when every row
    arrives.  A code misses its value by e * scale_r with e in (-1, 1),
    E e = 0 and var e <= 1/4; the peers share the noise, so their errors
    may add up in step: var of the sum <= peers^2 / 4 scale_r^2.  The
    decode is orthonormal in each tile column and divides by the peers,
    so E |err|^2 <= tiles * Ns * sum_r scale_r^2 / 4, Ns this rank's
    columns (a leaf split over ``model`` keeps 1 / size of them).  Returns
    twice that, square-rooted (the squared norm of millions of
    independent entries sits close to its mean)."""
    out = {}
    for i, (scale, _) in int8_scales(grads, plans, masks, signs, lossy,
                                     exact, model).items():
        p = plans[i]
        ns = (p.shape[p.sharded_dim] // (model.size if model else 1)
              if p.sharded_dim is not None else 1)
        out[i] = math.sqrt(2 * p.tiles * ns
                           * float(scale.double().square().sum()) / 4)
    return out


def phase_small_train(dev, C, ts, OptConfig, DataConfig, make_source):
    """Smoke-size qwen2-0.5b in float32: one step a mode on the card
    (kernels) against the CPU (plain versions), same weights, batch,
    masks and signs, with the full learning rate from the first step so
    that the update outweighs the tolerance; then 14 coded steps on the
    card at drop 0.05 must lower the loss (tests/test_distribution.py's
    check)."""
    from repro_torch import generator
    cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=8, seed=1))
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in src.global_batch(0).items()}
    state, _ = small_steps_card_vs_cpu(
        dev, ts, cfg, OptConfig(lr=1e-3, warmup_steps=1), batch, 0.05, MODES,
        CARD_STEP_TOL, "smoke train")

    step = ts.make_train_step(cfg, None, OptConfig(lr=1e-3), ts.CelerisConfig(
        mode="lossy_hadamard", min_coded_size=1024))
    st, losses, fracs = to_device(state, dev), [], []
    for i in range(SMOKE_STEPS):
        b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in src.global_batch(i).items()}
        st, m = step(st, b, generator(dev, 3, i), 0.05)
        losses.append(m["loss"].item())
        fracs.append(m["recv_frac"].item())
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert all(0.9 < f < 1.0 for f in fracs), fracs
    print(f"smoke train f32, card vs CPU: loss, recv_frac, first moments "
          f"and updated params agree in {', '.join(MODES)}; {SMOKE_STEPS} "
          f"coded steps "
          f"at drop 0.05 on the card: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return {"losses": losses, "recv_frac": fracs}


def to_device(tree, d):
    """A state, batch or draw dict moved to device ``d``."""
    if isinstance(tree, dict):
        return {k: to_device(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, d) for v in tree]
    return tree.to(d)


# The train step on a mesh: four ranks share the one card over gloo
# (NCCL refuses two ranks on one device).  Cells: (name, mesh, mode,
# quantize_wire, drop rate or the per-pod vector [intra_pod0, intra_pod1,
# cross], microbatches).  Phase 6b, data parallel: "host" is
# make_host_mesh((4, 1)), "pods" make_pod_mesh(2, 2, 1).  Phase 6c, tensor
# parallel: "dm22" is make_host_mesh((2, 2)) over (data, model), "pdm212"
# make_pod_mesh(2, 1, 2) and "dm14" make_host_mesh((1, 4)), where wk/wv
# split over the 4 model ranks but qwen2-0.5b's 2 kv heads do not.
DP_WORLD, DP_STEPS, DP_TIMEOUT = 4, 2, 900
# phases 6b/6c run qwen2-0.5b at full width, the depth cut to MESH_LAYERS
# of its 24 layers (as 6d's EP_LAYERS): most of a 24-layer step was the
# gloo sync of all 494 M parameters
MESH_LAYERS = 2
# cut to make room for phase 19m: the plain "lossy" cells (its sync at
# drop 0 still held to the exact pmean, ``DP_ZERO_CELLS``/
# ``TP_ZERO_CELLS``), the int8 wire at 0.05 (the hierarchical cells run
# it at their per-pod drops) and 6c's microbatches=2 cell
# (``tp_check_microbatches`` still holds microbatches=2 to the whole rows)
DP_CELLS = (("exact", "host", "exact", False, 0.0, 1),
            ("lossy_hadamard", "host", "lossy_hadamard", False, 0.05, 1),
            ("int8_drop0", "host", "lossy_hadamard", True, 0.0, 1),
            ("hierarchical_int8", "pods", "hierarchical", True,
             (0.02, 0.0, 0.05), 1))
TP_CELLS = (("exact", "dm22", "exact", False, 0.0, 1),
            ("lossy_hadamard", "dm22", "lossy_hadamard", False, 0.05, 1),
            ("int8_drop0", "dm22", "lossy_hadamard", True, 0.0, 1),
            ("hierarchical_int8", "pdm212", "hierarchical", True,
             (0.02, 0.0, 0.05), 1),
            ("exact_tp4", "dm14", "exact", False, 0.0, 1))
MESH_OUT = os.path.join(SRC, "repro_torch", "kernels", "build", "{}_train")
# the meshes with a data axis larger than 1, where ZeRO-1 places the
# optimizer state: every cell's peak a rank must come in below the
# replicated state's, measured in the same run (``replicated_peak``)
ZERO_MESHES = ("host", "pods", "dm22")


def mesh_config(C):
    """Phases 6b/6c's model: qwen2-0.5b at full width, MESH_LAYERS deep."""
    return dataclasses.replace(C.get("qwen2-0.5b"), n_layers=MESH_LAYERS)


def mesh_of(kind, device_type):
    """Phase 6b's ("dp") or 6c's ("tp") meshes, built by every rank in
    the same order; with their cells, drop-0 sync cells and the meshes
    whose exact step is held to one device."""
    from repro_torch.launch import mesh as mesh_mod
    if kind == "dp":
        return ({"host": mesh_mod.make_host_mesh((DP_WORLD, 1),
                                                 device_type=device_type),
                 "pods": mesh_mod.make_pod_mesh(2, 2, 1,
                                                device_type=device_type)},
                DP_CELLS, DP_ZERO_CELLS, ("host",))
    return ({"dm22": mesh_mod.make_host_mesh((2, 2), device_type=device_type),
             "pdm212": mesh_mod.make_pod_mesh(2, 1, 2,
                                              device_type=device_type),
             "dm14": mesh_mod.make_host_mesh((1, 4),
                                             device_type=device_type),
             "dm41": mesh_mod.make_host_mesh((4, 1),
                                             device_type=device_type)},
            TP_CELLS, TP_ZERO_CELLS, ("dm22", "dm14"))


def tp_fwht_shapes(cfg, mesh=None):
    """(rows, n_rot) of the FWHT call of each coded leaf, in leaf order,
    on ``mesh`` (by default the (2, 2) data x model mesh; a coded
    rank-step makes two at each, encode and decode): the leaf's tiles
    times its local columns of the model dim, the plans made from the
    global shapes as the step makes them."""
    from repro_torch import sharding as shd
    from repro_torch.models import convert
    from repro_torch.train import train_step as ts
    mesh = mesh or mesh_shape((2, 2), ("data", "model"))
    tp = shd.axis_size(mesh, (shd.MODEL_AXIS,))
    plans = ts.plan_leaves(convert.leaf_shapes(cfg), mesh,
                           ts.CelerisConfig(mode="lossy_hadamard"),
                           convert.leaf_names(cfg))
    return [(p.tiles * (p.shape[p.sharded_dim] // tp
                        if p.sharded_dim is not None else 1), p.n_rot)
            for p in plans if p is not None]


def mesh_shape(shape, names):
    """A mesh's axis names and sizes, all that ``sharding.axis_sizes``
    reads, for a process (phase 2) that has no process group to build a
    DeviceMesh on."""
    import types
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 mesh=torch.empty(shape))


class FixedDrop:
    """A straggler model that gives every step the same drop rate (or
    hierarchical drop vector)."""
    median_latency = 1.0

    def __init__(self, rate):
        self.rate = rate

    def drop_rate(self, timeout, rng):
        return self.rate


def expected_drop(rate):
    """The mean mask rate a cell's drop input gives: the rate itself, or
    over the pods of a [intra_pod..., cross] vector, 1 - (1 - intra_p)
    (1 - cross) capped at 0.5."""
    r = np.reshape(np.asarray(rate, np.float64), -1)
    if r.size == 1:
        return float(r[0])
    return float(np.mean(np.minimum(1 - (1 - r[:-1]) * (1 - r[-1]), 0.5)))


def fingerprint(leaves, metrics):
    """Per leaf, integer sums of its bits (all, every third, every
    seventh from 1), and the metrics' float64 values: equal on two ranks
    when their parameters and metrics are equal bit for bit."""
    sums = torch.cat([leaf_fingerprint(p.detach()) for p in leaves])
    vals = torch.tensor([metrics[k] for k in sorted(metrics)],
                        dtype=torch.float64)
    return torch.cat([sums.cpu(), vals.view(torch.int64)])


def dp_smoke_draws(cfg, mesh, celeris, drop):
    """Injected draws for the card-vs-CPU cells, the same on every rank:
    per coded leaf all mask peers' masks (this rank keeps its own), the
    signs and, on the int8 wire, the noise at the leaf's global tile
    shape, from one CPU generator."""
    from repro_torch import sharding as shd
    from repro_torch.core import coding
    from repro_torch.models import convert
    from repro_torch.train import train_step as ts
    sync = ts._DpSync.make(mesh, celeris.collective_mode(), celeris,
                           shd.model_group(mesh))
    mode = celeris.collective_mode()
    if mode.hierarchical:
        rates, peer = ts._pod_rates(drop, sync.pod.size), sync.pod.peer
    else:
        rates = torch.full((sync.dp.size,), float(drop))
        peer = sync.dp.peer
    g = torch.Generator().manual_seed(3)
    masks, signs, noise = {}, {}, {}
    for i, plan in enumerate(ts.plan_leaves(convert.leaf_shapes(cfg), mesh,
                                            celeris,
                                            convert.leaf_names(cfg))):
        if plan is None:
            continue
        masks[i] = (torch.rand((rates.shape[0], plan.n_rot), generator=g)
                    >= rates[:, None])[peer]
        signs[i] = coding.rademacher_nd(g, plan)
        if celeris.quantize_wire:
            ns = (plan.shape[plan.sharded_dim]
                  if plan.sharded_dim is not None else 1)
            noise[i] = torch.rand((plan.tiles, plan.n_rot, ns), generator=g)
    return masks, signs, noise, sync


# every four-rank phase runs in one launch of the rank processes, in this
# order (6b, 6c, 6d, 6f, 6h, 6i, 19m): one start-up and warm-up, not seven
MESH_KINDS = ("dp", "tp", "ep", "families", "recurrent_stubs",
              "tp_recurrent_stubs", "serve_mesh")


def mesh_rank(kinds, rank, port, out_dir, device="cuda"):
    """One rank of ``run_mesh_ranks(kinds)`` (``kinds`` comma-separated):
    joins the gloo group, runs each kind's cells and checks in turn
    (:func:`mesh_kind`), and writes ``rank<r>.json``, {kind: its record
    with its ``kind_seconds``}, into ``out_dir``.  Any failed check
    raises, and the rank exits non-zero."""
    import gc
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)          # every rank on the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=DP_WORLD)
    try:
        recs = {}
        for kind in kinds.split(","):
            t0 = time.perf_counter()
            recs[kind] = mesh_kind(kind, rank, dev, out_dir)
            recs[kind]["kind_seconds"] = time.perf_counter() - t0
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(recs, f)
    finally:
        dist.destroy_process_group()


def mesh_kind(kind, rank, dev, out_dir):
    """This rank's record of one four-rank phase: ``dp`` (6b), ``tp``
    (6c), ``ep`` (6d), ``families`` (6f), ``recurrent_stubs`` (6h),
    ``tp_recurrent_stubs`` (6i) or ``serve_mesh`` (19m)."""
    if kind == "ep":
        return ep_rank(rank, dev)
    if kind == "serve_mesh":
        return serve_mesh_rank(rank, dev)
    if kind == "families":
        return family_rank(rank, dev)
    if kind == "recurrent_stubs":
        return family_rank(rank, dev, RS_MESH_CELLS, rs_mesh_config)
    if kind == "tp_recurrent_stubs":
        return family_rank(rank, dev, TP_RS_CELLS, tp_rs_config,
                           tp_checks=True)
    meshes, cells, zero_cells, one = mesh_of(kind, dev.type)
    rec = dp_cells(rank, dev, meshes, cells)
    rec["one_device"] = {mk: dp_check_one_device(rank, dev, meshes[mk])
                         for mk in one}
    rec["coded_vs_exact"] = dp_check_coded_syncs(dev, meshes,
                                                 cells=zero_cells)
    rec["card_vs_cpu"] = dp_check_card_vs_cpu(dev, meshes, cells)
    if kind == "tp":
        rec["seq_parallel"] = tp_check_seq_parallel(dev, meshes)
        rec["microbatches"] = tp_check_microbatches(dev, meshes["dm22"])
        rec["elastic"] = tp_check_elastic_restart(rank, dev, meshes,
                                                  out_dir)
    return rec


def dp_cells(rank, dev, meshes, cells):
    """The full-width cells through ``Trainer(mesh=...)`` (a cell with
    microbatches > 1 swaps in a step that accumulates), then the median
    coordination over the group.  Every step the ranks that share a
    model index must hold the same parameters and metrics bit for bit,
    and a coded step must launch the FWHT 16 times a rank, at
    ``tp_fwht_shapes`` on the cell's mesh."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch import sharding as shd
    from repro_torch.core import timeout as tmo
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import dcqcn as kdcqcn
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    counts = Launches(kfwht, kunbias, kquant, kdcqcn)
    world = dist.group.WORLD
    # the dp sync's host-clock time and the bytes each of its all-reduces
    # moves, the time and bytes of the collectives over the model group,
    # and the FWHT's shapes, read by wrapping the module functions
    stats = {}

    def reset():
        stats.update(sync_s=0.0, bytes=0, model_s=0.0, model_bytes=0,
                     zero_s=0.0, zero_bytes=0, fwht_shapes=[])

    def timed(fn, key):
        def call(*a, **k):
            _sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync()
            stats[key] += time.perf_counter() - t0
            return out
        return call

    def counted(fn, key, seconds=None):
        def call(t, *a, **k):
            stats[key] += t.numel() * t.element_size()
            return fn(t, *a, **k)
        return timed(call, seconds) if seconds else call

    def gathered(fn):
        # ZeRO-1's all-gather: the bytes of the parameters it rebuilds
        def call(*a, **k):
            out = fn(*a, **k)
            stats["zero_bytes"] += out.numel() * out.element_size()
            return out
        return timed(call, "zero_s")

    def shaped_fwht(x, *a, **k):
        stats["fwht_shapes"].append(list(x.shape))
        return plain_fwht(x, *a, **k)

    saved = (ts._sync_dp, ts._all_reduce, shd.model_all_reduce,
             shd.model_all_gather, shd.model_reduce_scatter, ops.fwht,
             shd.data_all_gather)
    sync_dp, all_reduce, *model_ops, plain_fwht, data_gather = saved
    ts._sync_dp = timed(sync_dp, "sync_s")
    shd.data_all_gather = gathered(data_gather)
    ts._all_reduce = counted(all_reduce, "bytes")
    (shd.model_all_reduce, shd.model_all_gather,
     shd.model_reduce_scatter) = (counted(f, "model_bytes", "model_s")
                                  for f in model_ops)
    ops.fwht = shaped_fwht
    cfg = mesh_config(C)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    rec, tr = {"cells": {}}, None
    for name, mk, mode, q, drop, mb in cells:
        del tr
        torch.cuda.empty_cache()
        celeris = ts.CelerisConfig(mode=mode, quantize_wire=q)
        tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, celeris=celeris,
                     mesh=meshes[mk], seed=0, straggler=FixedDrop(drop),
                     device=str(dev))
        if mb > 1:
            tr.step_fn = ts.make_train_step(cfg, meshes[mk], opt, celeris,
                                            microbatches=mb)
        group = tr.step_fn.dp_group
        torch.cuda.reset_peak_memory_stats()
        steps = []

        def on_metrics(step, m):
            steps.append({"wall_ms": m["wall_s"] * 1e3,
                          "sync_ms": stats["sync_s"] * 1e3,
                          "allreduce_bytes": stats["bytes"],
                          "model_ms": stats["model_s"] * 1e3,
                          "model_bytes": stats["model_bytes"],
                          "zero_ms": stats["zero_s"] * 1e3,
                          "zero_bytes": stats["zero_bytes"],
                          "launches": counts.read(),
                          "fwht_shapes": sorted(stats["fwht_shapes"])})
            fp = fingerprint(tr.state["params"], {
                k: v for k, v in m.items() if k not in ("wall_s",
                                                        "drop_rate")})
            every = [torch.empty_like(fp)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(every, fp, group=group)
            assert all(torch.equal(e, fp) for e in every), (
                f"{mk} {name} step {step}: the ranks' parameters or metrics "
                "differ")
            counts.reset()
            reset()

        _sync()
        counts.reset()
        reset()
        hist = tr.run(DP_STEPS, on_metrics=on_metrics)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_zero1_layout(cfg, meshes[mk], tr.state, name)
        zero = tr.step_fn.data_group is not None
        assert all((s["zero_bytes"] > 0) == zero for s in steps), (name,
                                                                  steps)
        assert zero == (mk in ZERO_MESHES), (mk, name, zero)
        fwht = [s["launches"]["fwht"] for s in steps]
        coded = mode in ("lossy_hadamard", "hierarchical")
        want = {"fwht": 2 * CODED_LEAVES if coded else 0,
                "fwht_quantize": 0, "masked_unbias": 0, "quantize_int8": 0,
                "dcqcn_scan": 0}
        assert all(s["launches"] == want for s in steps), (name, steps)
        if coded:
            shapes = sorted(2 * [list(s)
                                 for s in tp_fwht_shapes(cfg, meshes[mk])])
            assert all(s["fwht_shapes"] == shapes for s in steps), (
                name, shapes, steps)
        assert np.isfinite(hist["loss"]).all(), (name, hist["loss"])
        if mode == "exact" or drop == 0.0:
            assert hist["recv_frac"] == [1.0] * DP_STEPS, (name, hist)
        else:
            assert all(abs(f - (1 - expected_drop(drop))) < 0.04
                       for f in hist["recv_frac"]), (name, hist["recv_frac"])
        rec["cells"][name] = {
            "mesh": mk, "mode": mode, "quantize_wire": q,
            "drop": np.asarray(drop).tolist(), "microbatches": mb,
            "loss": hist["loss"], "recv_frac": hist["recv_frac"],
            "steps": steps, "fwht_launches_per_step": fwht,
            "peak_gib": peak}
    (ts._sync_dp, ts._all_reduce, shd.model_all_reduce, shd.model_all_gather,
     shd.model_reduce_scatter, ops.fwht, shd.data_all_gather) = saved
    exact, q0 = rec["cells"]["exact"], rec["cells"]["int8_drop0"]
    assert all(abs(a - b) < 5e-3 for a, b in zip(q0["loss"], exact["loss"])
               ), ("int8 wire at drop 0 vs exact", q0["loss"], exact["loss"])
    # median coordination over the group
    local = np.float32(tr.controller.timeout * (1 + 0.01 * rank))
    agreed = tmo.coordinate_group(torch.tensor(local), world)
    vals = np.sort([np.float32(tr.controller.timeout * (1 + 0.01 * r))
                    for r in range(DP_WORLD)])
    want = (vals[(DP_WORLD - 1) // 2] + vals[DP_WORLD // 2]) * np.float32(0.5)
    assert agreed.item() == want, (agreed.item(), want)
    rec["median"] = {"local": float(local), "agreed": agreed.item()}
    del tr
    torch.cuda.empty_cache()
    # the replicated state's peak, against the ZeRO-1 cell that peaked
    # highest on each mesh that places it
    for mk in sorted({c[1] for c in cells} & set(ZERO_MESHES)):
        on = {n: c for n, c in rec["cells"].items() if c["mesh"] == mk}
        top = max(on, key=lambda n: on[n]["peak_gib"])
        cell = next(c for c in cells if c[0] == top)
        rep_peak = replicated_peak(cfg, meshes[mk], cell, data_cfg, opt, dev)
        assert all(c["peak_gib"] < rep_peak for c in on.values()), (
            f"{mk}: ZeRO-1 peaks a rank "
            f"{ {n: c['peak_gib'] for n, c in on.items()} } GiB, the "
            f"replicated state's {rep_peak:.3f} ({top})")
        for c in on.values():
            c["replicated_peak_gib"] = rep_peak
    return rec


def replicated_peak(cfg, mesh, cell, data_cfg, opt, dev):
    """The peak GiB a rank of one step of ``cell`` with the optimizer
    state replicated (``convert.data_group`` patched to None, as before
    ZeRO-1): the bar each ZeRO-1 cell's peak on that mesh must come in
    below."""
    from repro_torch.models import convert
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    name, _, mode, q, drop, mb = cell
    saved = convert.data_group
    convert.data_group = lambda *a, **k: None
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        celeris = ts.CelerisConfig(mode=mode, quantize_wire=q)
        tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, celeris=celeris,
                     mesh=mesh, seed=0, straggler=FixedDrop(drop),
                     device=str(dev))
        if mb > 1:
            tr.step_fn = ts.make_train_step(cfg, mesh, opt, celeris,
                                            microbatches=mb)
        assert tr.step_fn.data_group is None
        tr.run(1)
        _sync()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        convert.data_group = saved
    del tr
    torch.cuda.empty_cache()
    return peak


def local_shape(shape, spec, sizes):
    """A leaf's shape on a rank that holds its block under ``spec`` (a
    spec shorter than the shape leaves the rest whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // sizes[a] if a is not None else n
                 for n, a in zip(shape, spec))


def check_zero1_layout(cfg, mesh, state, name):
    """Every rank holds its ZeRO-1 block of ``master``, ``mu`` and ``nu``
    (``zero1_specs``: its model shard, split again over ``data``)."""
    from repro_torch import sharding as shd
    from repro_torch.models import convert
    from repro_torch.train import sharding_rules as rules
    shapes = convert.leaf_shapes(cfg)
    sizes = shd.axis_sizes(mesh)
    want = [local_shape(sh, sp, sizes)
            for sh, sp in zip(shapes, rules.zero1_specs(
                shapes, mesh, convert.leaf_names(cfg)))]
    for part in ("master", "mu", "nu"):
        got = [tuple(x.shape) for x in state["opt"][part]]
        assert got == want, (name, part, got, want)


def tp_check_elastic_restart(rank, dev, meshes, out_dir):
    """Phase 6c's elastic restart: ``Trainer(mesh=...)`` on (2, 2) takes
    one exact step at full width and checkpoints it (every rank gathers,
    rank 0 writes); ``Trainer`` on (4, 1) and on (1, 4) restores it, and
    each rank's leaves must be its blocks of the saved state bit for bit.
    The blocks' fingerprints are taken from the whole leaves as the save
    gathers them (so no rank holds the whole state).  Returns the save's
    and the restores' host-clock seconds."""
    import shutil
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import convert
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    cfg = mesh_config(C)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    directory = os.path.join(out_dir, "ckpt")
    if rank == 0:
        ckpt_space(directory, 1)
    dist.barrier()
    shapes, names = convert.leaf_shapes(cfg), convert.leaf_names(cfg)
    targets = {mk: meshes[mk] for mk in ("dm41", "dm14")}
    specs = {mk: [s for _, s in ts.state_leaves(ts.state_specs(
        shapes, m, names), names)] for mk, m in targets.items()}
    want = {mk: [] for mk in targets}
    gather = convert.gather_state

    def noting(leaves, leaf_specs, mesh):
        for full in gather(leaves, leaf_specs, mesh):
            for mk, m in targets.items():
                block = shd.local_slice(full, specs[mk][len(want[mk])], m)
                want[mk].append((tuple(block.shape), block.dtype,
                                 leaf_fingerprint(block)))
            yield full

    log = {}
    saved = timed_calls(ckpt, ("restore",), log)
    convert.gather_state = noting
    try:
        tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                     mesh=meshes["dm22"], seed=0, ckpt_dir=directory,
                     ckpt_every=1, device=str(dev))
        _sync()
        t0 = time.perf_counter()
        tr.run(1)          # the step, the gather, rank 0's write, a barrier
        run_s = time.perf_counter() - t0
        del tr
        torch.cuda.empty_cache()
        assert all(len(w) == 4 * len(shapes) + 2 for w in want.values())
        for mk, mesh in targets.items():
            back = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, mesh=mesh,
                           seed=0, ckpt_dir=directory, device=str(dev))
            assert back.start_step == 1, (mk, back.start_step)
            for (path, x), (shape, dtype, fp) in zip(
                    ts.state_leaves(back.state, names), want[mk]):
                assert (tuple(x.shape), x.dtype) == (shape, dtype) and \
                    torch.equal(leaf_fingerprint(x), fp), (
                        f"{mk} rank {rank}: restored {path} is not its "
                        "block of the saved state")
            del back
            torch.cuda.empty_cache()
    finally:
        convert.gather_state = gather
        ckpt.restore = saved["restore"]
    dist.barrier()
    if rank == 0:
        shutil.rmtree(directory)
    return {"step_and_save_s": run_s, "restore_s": dict(zip(targets,
                                                            log["restore"]))}


def leaf_fingerprint(x):
    """Integer sums of a tensor's bits (all, every third, every seventh
    from 1), on its device: equal for equal tensors."""
    b = bit_view(x.contiguous()).reshape(-1)
    return torch.stack([b.sum(dtype=torch.int64), b[::3].sum(dtype=torch.int64),
                        b[1::7].sum(dtype=torch.int64)])


def dp_check_one_device(rank, dev, mesh):
    """Exact on the mesh = one device: qwen2-0.5b at full width in
    float32, depth cut to 2 layers (the check's tolerances are float32's:
    in bf16 the ranks' gradients and the global batch's round apart),
    one exact step from the same weights on the mesh's global batch,
    ``global_batch(0, n_dp)``, the shards gathered back over ``model``
    and held to ``check_first_step``."""
    import torch.distributed as dist
    from repro_torch import generator
    from repro_torch import sharding as shd
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import convert
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import sharding_rules as rules
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(C.get("qwen2-0.5b"), n_layers=2,
                              dtype="float32")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, mesh=mesh, seed=0,
                 device=str(dev))
    new, m = tr.step_fn(tr.state, tr.put_batch(0), None, 0.0)
    del tr
    shapes, names = convert.leaf_shapes(cfg), convert.leaf_names(cfg)
    new = {"params": convert.gather_leaves(new["params"], mesh, shapes,
                                           names),
           "opt": {"mu": list(convert.gather_state(
               new["opt"]["mu"], rules.zero1_specs(shapes, mesh, names),
               mesh))}}
    out = {"loss": m["loss"].item()}
    if rank == 0:
        step = ts.make_train_step(cfg, None, opt)
        n_dp = shd.axis_size(mesh, shd.dp_axes(mesh))
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in make_source(data_cfg).global_batch(0, n_dp)
                 .items()}
        one, m1 = step(ts.init_state(generator(dev, 0), cfg), batch, None,
                       0.0)
        one = to_device({"params": one["params"],
                         "opt": {"mu": one["opt"]["mu"]}}, "cpu")
        shape = tuple(mesh.mesh.shape)
        check(f"exact on {shape} loss vs one device", m["loss"].cpu(),
              m1["loss"].cpu(), 1e-5, 0.0)
        check_first_step(f"exact on {shape} vs one device", new, one, opt)
        out["one_device_loss"] = m1["loss"].item()
    del new
    dist.barrier()
    return out


def tp_check_microbatches(dev, mesh):
    """``microbatches=2`` against the whole rows on the mesh: qwen2-0.5b
    at full width in float32 with 2 layers, one exact step from the same
    shards and rows; the loss within rtol 1e-5 and each rank's shards
    held to ``check_first_step``."""
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(C.get("qwen2-0.5b"), n_layers=2,
                              dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    tr = Trainer(cfg, data_cfg=DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=1), opt_cfg=opt, mesh=mesh, seed=0,
        device=str(dev))
    batch = tr.put_batch(0)
    dg = tr.step_fn.data_group
    # the accumulating step first: the trainer's own step updates the
    # optimizer state it is given in place (donated)
    acc, m2 = ts.make_train_step(cfg, mesh, opt, microbatches=2)(
        tr.state, batch, None, 0.0)
    whole, m1 = tr.step_fn(tr.state, batch, None, 0.0)
    whole = to_device(over_data(whole, dg), "cpu")
    del tr
    check("tp microbatches=2 loss vs whole rows", m2["loss"].cpu(),
          m1["loss"].cpu(), 1e-5, 0.0)
    check_first_step("tp microbatches=2 vs whole rows", over_data(acc, dg),
                     whole, opt)
    return {"loss": m1["loss"].item(), "loss_mb2": m2["loss"].item()}


# the syncs at drop 0 held to the exact pmean on the same gradients:
# (name, mesh, mode, quantize_wire, drop rate or per-pod vector)
DP_ZERO_CELLS = (("lossy", "host", "lossy", False, 0.0),
                 ("lossy_hadamard", "host", "lossy_hadamard", False, 0.0),
                 ("int8", "host", "lossy_hadamard", True, 0.0),
                 ("hierarchical_int8", "pods", "hierarchical", True,
                  (0.0, 0.0, 0.0)))
TP_ZERO_CELLS = (("lossy", "dm22", "lossy", False, 0.0),
                 ("lossy_hadamard", "dm22", "lossy_hadamard", False, 0.0),
                 ("int8", "dm22", "lossy_hadamard", True, 0.0),
                 ("hierarchical_int8", "pdm212", "hierarchical", True,
                  (0.0, 0.0, 0.0)))


def dp_check_coded_syncs(dev, meshes, cfg=None, min_coded_size=65536,
                         cells=DP_ZERO_CELLS):
    """Each cell's sync at drop 0 against the exact pmean, on this rank's
    gradients (by default at full width: qwen2-0.5b, 2 layers, float32;
    this rank's rows of ``global_batch(0, n_dp)``; its shards on a
    ``model`` axis): the plain island and the float32 coded wire leaf by
    leaf within rtol 1e-5 + 1e-5 of the leaf's largest entry (a float32
    round trip through the FWHT); the int8 wire, plain and hierarchical,
    within ``int8_noise_bound`` in norm.  Returns each cell's worst error
    relative to its bound."""
    from repro_torch import generator
    from repro_torch import sharding as shd
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import convert
    from repro_torch.train import train_step as ts
    cfg = cfg or dataclasses.replace(C.get("qwen2-0.5b"), n_layers=2,
                                     dtype="float32")
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=1))
    out = {}
    for name, mk, mode, q, drop in cells:
        mesh = meshes[mk]
        tp = convert.model_group(cfg, mesh)
        leaves = ts.init_state(generator(dev, 0), cfg, mesh)["params"]
        dp = shd.dp_axes(mesh)
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in src.shard_batch(
                     0, shd.peer_index(mesh, dp),
                     shd.axis_size(mesh, dp)).items()}
        *_, grads = ts.loss_and_grads(cfg, leaves, batch, tp)
        celeris = ts.CelerisConfig(mode=mode, quantize_wire=q,
                                   min_coded_size=min_coded_size)
        plans = ts.plan_leaves(convert.leaf_shapes(cfg), mesh, celeris,
                               convert.leaf_names(cfg))
        assert any(p is not None for p in plans), name
        exact = ts._sync_dp(ts._DpSync.make(mesh, ts.CollectiveMode.EXACT,
                                            celeris, tp),
                            grads, plans, None, 0.0, None, None, None)[0]
        masks, signs, noise, sync = (to_device(d, dev) if isinstance(d, dict)
                                     else d for d in dp_smoke_draws(
                                         cfg, mesh, celeris, drop))
        est, frac = ts._sync_dp(sync, grads, plans, None, drop, masks, signs,
                                noise)
        assert frac.item() == 1.0, (name, frac.item())
        if q:
            lossy = sync.pod if mode == "hierarchical" else sync.dp
            bound = int8_noise_bound(grads, plans, masks, signs, lossy,
                                     sync.data, tp)
        worst = 0.0
        for i, (e, x) in enumerate(zip(est, exact)):
            if q and i in bound:
                err = (e - x).double().norm().item()
                assert err <= bound[i], (
                    f"{mk} {name} at drop 0 leaf {i}: |int8 - exact| "
                    f"{err:.4g} beyond the rounding bound {bound[i]:.4g}")
                worst = max(worst, err / bound[i])
            else:
                atol = 1e-5 * x.abs().max().item()
                err = check(f"{mk} {name} at drop 0 leaf {i} vs exact", e,
                            x, 1e-5, atol)
                worst = max(worst, err / max(atol, 1e-30))
        out[name] = worst
        del grads, exact, est, masks, signs, noise, leaves
    return out


def dp_check_card_vs_cpu(dev, meshes, cells):
    """Every cell at smoke size in float32, one step at world 4 on the
    card and on the CPU (the same ranks, the same gloo group) from the
    same weights (this rank's shards), batch and injected draws, held to
    ``check_first_step`` (plus one quantization step on the int8
    wire)."""
    from repro_torch import sharding as shd
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import convert
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
    cpu = torch.device("cpu")
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=8, seed=1))
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for name, mk, mode, q, drop, mb in cells:
        mesh = meshes[mk]
        state = ts.init_state(torch.Generator(cpu).manual_seed(0), cfg, mesh)
        celeris = ts.CelerisConfig(mode=mode, quantize_wire=q,
                                   min_coded_size=1024)
        step = ts.make_train_step(cfg, mesh, opt, celeris, microbatches=mb)
        dp = shd.dp_axes(mesh)
        batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in
                 src.shard_batch(0, shd.peer_index(mesh, dp),
                                 shd.axis_size(mesh, dp)).items()}
        masks, signs, noise, sync = dp_smoke_draws(cfg, mesh, celeris, drop)
        (new_cpu, m_cpu), (new_dev, m_dev) = [
            step(to_device(state, d), to_device(batch, d), None, drop,
                 masks=masks, signs=signs, noise=noise) for d in (cpu, dev)]
        for k in ("loss", "recv_frac"):
            check(f"{mk} smoke {name} {k} card vs cpu", m_dev[k].cpu(),
                  m_cpu[k], 2e-4, 2e-4)
        steps = None
        if q:
            lossy = sync.pod if mode == "hierarchical" else sync.dp
            steps = int8_step_bound(
                cfg, state["params"], batch,
                ts.plan_leaves(convert.leaf_shapes(cfg), mesh, celeris,
                               convert.leaf_names(cfg)),
                masks, signs, lossy, sync.data, step.model_group)
        dg = step.data_group
        check_first_step(f"{mk} smoke {name}", over_data(new_dev, dg),
                         over_data(new_cpu, dg), opt, steps)
        out[name] = {"loss": m_dev["loss"].item(),
                     "recv_frac": m_dev["recv_frac"].item()}
    return out


def run_mesh_ranks(kinds=MESH_KINDS):
    """Four rank processes on the one card over gloo (``mesh_rank``),
    running ``kinds`` in turn under one deadline.  Any rank that fails
    fails the launch.  Returns each rank's {kind: record}; a phase reads
    its kind's with :func:`kind_ranks`."""
    import shutil
    import socket
    out_dir = MESH_OUT.format(kinds[0] if len(kinds) == 1 else "mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # four ranks of ~15 GiB each share 80 GB: segments that grow in
    # place keep each allocator's free-but-reserved blocks small
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(DP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "--mesh-kind", ",".join(kinds), "--mesh-port", str(port),
         "--mesh-out", out_dir], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    try:
        deadline = time.monotonic() + DP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + "".join(f.readlines()[-40:]))
        raise RuntimeError(f"{','.join(kinds)}: ranks failed\n"
                           + "\n".join(tails))
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"mesh ranks: {', '.join(kinds)} in one launch of {DP_WORLD} "
          f"ranks, {time.perf_counter() - t0:.1f} s")
    return ranks


def kind_ranks(ranks, kind):
    """(each rank's record of ``kind``, the slowest rank's seconds on
    it) from :func:`run_mesh_ranks`."""
    recs = [rk[kind] for rk in ranks]
    return recs, max(r["kind_seconds"] for r in recs)


def phase_mesh_train(kind, mesh_ranks):
    """The train step on a mesh at full width: four rank processes on the
    one card over gloo (``run_mesh_ranks``), each cell 2 steps through
    ``Trainer(mesh=...)``; ``kind`` "dp" is phase 6b (data parallel),
    "tp" phase 6c (tensor parallel over ``model``, and gradient
    accumulation).  Any rank that fails fails the phase."""
    ranks, seconds = kind_ranks(mesh_ranks, kind)
    smi = card_name_and_power()
    out, launches = {"cells": {}}, 0
    for name, *_ in DP_CELLS if kind == "dp" else TP_CELLS:
        cell = ranks[0]["cells"][name]
        steps = cell["steps"]
        rec = {k: cell[k] for k in ("mesh", "mode", "quantize_wire", "drop",
                                    "microbatches", "loss", "recv_frac",
                                    "fwht_launches_per_step")}
        rec.update(
            step_ms=[s["wall_ms"] for s in steps],
            median_step_ms_after_first=statistics.median(
                s["wall_ms"] for s in steps[1:]),
            sync_ms=[s["sync_ms"] for s in steps],
            allreduce_bytes_per_rank_step=steps[-1]["allreduce_bytes"],
            model_collective_ms=[s["model_ms"] for s in steps],
            model_collective_bytes_per_rank_step=steps[-1]["model_bytes"],
            zero1_gather_ms=[s["zero_ms"] for s in steps],
            zero1_gather_bytes_per_rank_step=steps[-1]["zero_bytes"],
            peak_gib_per_rank=[rk["cells"][name]["peak_gib"]
                               for rk in ranks],
            replicated_peak_gib_per_rank=[
                rk["cells"][name].get("replicated_peak_gib")
                for rk in ranks])
        launches += sum(s["launches"]["fwht"] for rk in ranks
                        for s in rk["cells"][name]["steps"])
        out["cells"][name] = rec
        print(f"{kind} train {name} ({rec['mesh']}, {MESH_LAYERS} of 24 "
              f"layers, microbatches {rec['microbatches']}, {DP_WORLD} ranks "
              f"on one card, gloo): "
              f"loss {rec['loss']}, recv_frac {rec['recv_frac']}, step ms "
              f"{rec['step_ms']} (median after the first "
              f"{rec['median_step_ms_after_first']:.1f}), dp sync ms "
              f"{rec['sync_ms']}, dp all-reduce bytes/rank-step "
              f"{rec['allreduce_bytes_per_rank_step']}, model-group "
              f"collectives ms {rec['model_collective_ms']} and bytes/"
              f"rank-step {rec['model_collective_bytes_per_rank_step']}, "
              f"ZeRO-1 all-gather ms {rec['zero1_gather_ms']} and bytes/"
              f"rank-step {rec['zero1_gather_bytes_per_rank_step']}, "
              f"FWHT launches/rank-step {rec['fwht_launches_per_step']}, "
              f"peak GiB/rank "
              f"{[round(g, 2) for g in rec['peak_gib_per_rank']]} (the "
              f"replicated state's {rec['replicated_peak_gib_per_rank']}) "
              f"[{smi}]")
    out.update(seconds=seconds, median=[rk["median"] for rk in ranks],
               one_device=ranks[0]["one_device"],
               coded_vs_exact=[rk["coded_vs_exact"] for rk in ranks],
               card_vs_cpu=ranks[0]["card_vs_cpu"],
               microbatches=ranks[0].get("microbatches"),
               seq_parallel=[rk.get("seq_parallel") for rk in ranks]
               if kind == "tp" else None,
               elastic=[rk.get("elastic") for rk in ranks]
               if kind == "tp" else None,
               launches={"fwht": launches, "fwht_quantize": 0,
                         "masked_unbias": 0, "quantize_int8": 0,
                         "dcqcn_scan": 0})
    zero_worst = {k: max(rk[k] for rk in out["coded_vs_exact"])
                  for k in out["coded_vs_exact"][0]}
    losses = {mk: (v["loss"], v["one_device_loss"])
              for mk, v in out["one_device"].items()}
    print(f"{kind} train: the ranks that share a model index bit-identical "
          f"after every step; median coordination "
          f"{out['median'][0]['agreed']}; exact = one device (full width, "
          f"2 layers, float32; loss on the mesh vs one device {losses}); "
          f"the syncs at drop 0 vs exact on the same gradients (full width,"
          f" 2 layers, float32), worst error / tolerance by cell "
          f"{zero_worst}; microbatches=2 vs whole rows {out['microbatches']};"
          f" card = CPU at smoke size in {len(out['cells'])} cells; "
          + (f"elastic restart (2, 2) -> (4, 1), (1, 4) bit for bit, rank "
             f"0's seconds {out['elastic'][0]}; sequence parallel = "
             f"remat=False bit for bit on every rank, rank 0's "
             f"{out['seq_parallel'][0]}; " if kind == "tp" else "")
          + f"{seconds:.1f} s [{smi}]")
    return out


# phase 6d: expert-parallel training of qwen2-moe-a2.7b at full width,
# depth cut to EP_LAYERS of 24 (at 2 the (2, 2) cells' gloo sync of the
# expert leaves took up to ~12 s a step on an H100 80GB HBM3's host;
# layer 0's coins still drop blocks at 0.1); (name, mesh, mode,
# lossy_moe, drop)
EP_CELLS = (("exact", "dm14", "exact", False, 0.0),
            ("lossy_moe", "dm14", "exact", True, 0.1),
            ("exact_lossy_moe", "dm22", "exact", True, 0.1),
            ("lossy_hadamard_lossy_moe", "dm22", "lossy_hadamard", True,
             0.05))
EP_ARCH, EP_LAYERS, EP_STEPS = "qwen2-moe-a2.7b", 1, 3
# the (2, 2) exact cell also takes one step with microbatches: JAX's
# microbatch k is block k of the global batch, which the MoE layers route
# whole over the dp ranks
EP_MB_CELL, EP_MICROBATCHES = "exact_lossy_moe", 2
EP_CHECK_TOKENS = (2, 64)          # the EP = local layer's (B, S)


def ep_config(C):
    return dataclasses.replace(C.get(EP_ARCH), n_layers=EP_LAYERS)


def ep_meshes(device_type):
    from repro_torch.launch import mesh as mesh_mod
    return {"dm14": mesh_mod.make_host_mesh((1, 4), device_type=device_type),
            "dm22": mesh_mod.make_host_mesh((2, 2), device_type=device_type)}


def ep_rank(rank, dev):
    """One rank of phase 6d: ``EP_CELLS`` through ``Trainer(mesh=...)``,
    ``EP_STEPS`` steps each, then the checks: EP = the local path on one
    full-width MoE layer in float32 at capacity factor 50 (rtol 1e-4 +
    atol 1e-5, ``tests/test_distribution.py``'s bar); ``lossy_moe`` at
    drop 0 = off, bit for bit; and in every lossy-MoE step each
    dispatched (sender, expert-shard) block all zero exactly where the
    layer's coin says it was dropped.  Every step: losses and aux finite,
    the ranks of a dp group bit-identical, the FWHT launched twice a
    coded leaf at ``tp_fwht_shapes``."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch import generator
    from repro_torch import sharding as shd
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import dcqcn as kdcqcn
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.models import convert
    from repro_torch.models import moe as MOE
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    counts = Launches(kfwht, kunbias, kquant, kdcqcn)
    cfg = ep_config(C)
    meshes = ep_meshes(dev.type)
    stats = {}

    def reset():
        stats.update(a2a_s=0.0, a2a_bytes=0, sync_s=0.0, fwht_shapes=[],
                     blocks=0, dropped=0, coin_dropped=0, coin_match=True,
                     dispatches=0)

    def timed_a2a(t, tp):
        _sync()
        t0 = time.perf_counter()
        out = a2a(t, tp)
        _sync()
        stats["a2a_s"] += time.perf_counter() - t0
        stats["a2a_bytes"] += t.numel() * t.element_size()
        return out

    def dispatch_blocks(t, tp):
        # forward calls only: a layer's dispatch, then its return
        if stats["dispatches"] % 2 == 0 and stats.get("lossy"):
            layer = (stats["dispatches"] // 2) % cfg.n_layers
            zero = (t.reshape(tp.size, -1) == 0).all(1).cpu()
            lost = MOE.layer_coins(layer, tp.size)[tp.index] < stats["drop"]
            stats["blocks"] += tp.size
            stats["dropped"] += int(zero.sum())
            stats["coin_dropped"] += int(lost.sum())
            stats["coin_match"] &= bool(torch.equal(zero, lost))
        stats["dispatches"] += 1
        return entry(t, tp)

    def shaped_fwht(x, *a, **k):
        stats["fwht_shapes"].append(list(x.shape))
        return plain_fwht(x, *a, **k)

    def timed_sync(*a, **k):
        _sync()
        t0 = time.perf_counter()
        out = sync_dp(*a, **k)
        _sync()
        stats["sync_s"] += time.perf_counter() - t0
        return out

    saved = (shd.model_all_to_all, shd.all_to_all_model, ops.fwht,
             ts._sync_dp)
    a2a, entry, plain_fwht, sync_dp = saved
    shd.model_all_to_all, shd.all_to_all_model = timed_a2a, dispatch_blocks
    ops.fwht, ts._sync_dp = shaped_fwht, timed_sync
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    rec, tr = {"cells": {}}, None
    try:
        for name, mk, mode, lossy_moe, drop in EP_CELLS:
            del tr
            torch.cuda.empty_cache()
            celeris = ts.CelerisConfig(mode=mode, lossy_moe=lossy_moe)
            tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                         celeris=celeris, mesh=meshes[mk], seed=0,
                         straggler=FixedDrop(drop), device=str(dev))
            group = tr.step_fn.dp_group
            n_coded = sum(p is not None for p in ts.plan_leaves(
                convert.leaf_shapes(cfg), meshes[mk], celeris,
                convert.leaf_names(cfg)))
            torch.cuda.reset_peak_memory_stats()
            steps = []

            def on_metrics(step, m):
                steps.append({
                    "wall_ms": m["wall_s"] * 1e3,
                    "a2a_ms": stats["a2a_s"] * 1e3,
                    "a2a_bytes": stats["a2a_bytes"],
                    "sync_ms": stats["sync_s"] * 1e3,
                    "launches": counts.read(),
                    "fwht_shapes": sorted(stats["fwht_shapes"]),
                    "loss": m["loss"], "aux": m["aux"],
                    "blocks": stats["blocks"], "dropped": stats["dropped"],
                    "coin_dropped": stats["coin_dropped"],
                    "coin_match": stats["coin_match"]})
                fp = fingerprint(tr.state["params"], {
                    k: v for k, v in m.items() if k not in ("wall_s",
                                                            "drop_rate")})
                every = [torch.empty_like(fp)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(every, fp, group=group)
                assert all(torch.equal(e, fp) for e in every), (
                    f"{mk} {name} step {step}: the dp ranks differ")
                counts.reset()
                reset()
                stats.update(lossy=lossy_moe, drop=drop)

            _sync()
            counts.reset()
            reset()
            stats.update(lossy=lossy_moe, drop=drop)
            hist = tr.run(EP_STEPS, on_metrics=on_metrics)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            assert np.isfinite(hist["loss"]).all(), (name, hist["loss"])
            assert all(np.isfinite(s["aux"]) and s["aux"] > 0
                       for s in steps), (name, steps)
            coded = mode == "lossy_hadamard"
            for s in steps:
                assert s["launches"]["fwht"] == (2 * n_coded if coded
                                                 else 0), (name, s)
                assert s["a2a_bytes"] > 0, (name, s)
                if lossy_moe:
                    assert s["coin_match"] and s["blocks"] > 0, (name, s)
            if coded:
                shapes = sorted(2 * [list(x) for x in
                                     tp_fwht_shapes(cfg, meshes[mk])])
                assert all(s["fwht_shapes"] == shapes for s in steps), (
                    name, shapes, steps)
            rec["cells"][name] = {
                "mesh": mk, "mode": mode, "lossy_moe": lossy_moe,
                "drop": drop, "loss": hist["loss"],
                "recv_frac": hist["recv_frac"], "steps": steps,
                "peak_gib": peak, "coded_leaves": n_coded}
            if name == "exact":
                rec["off_vs_zero"] = ep_check_off_vs_zero(tr, cfg, opt, ts)
            if name == EP_MB_CELL:
                rec["cells"][name]["microbatches"] = ep_microbatch_step(
                    tr, cfg, opt, ts, celeris, drop, group, counts)
    finally:
        (shd.model_all_to_all, shd.all_to_all_model, ops.fwht,
         ts._sync_dp) = saved
    del tr
    torch.cuda.empty_cache()
    rec["ep_vs_local"] = ep_check_vs_local(dev, cfg, meshes["dm14"], MOE,
                                           convert, shd, generator)
    return rec


def ep_check_off_vs_zero(tr, cfg, opt, ts):
    """``lossy_moe`` at drop 0 against ``lossy_moe`` off: one step from
    the trainer's state on its next batch, bit for bit."""
    batch = tr.put_batch(tr.start_step)
    ends = []
    for on in (False, True):
        step = ts.make_train_step(cfg, tr.mesh, opt, ts.CelerisConfig(
            mode="exact", lossy_moe=on))
        new, m = step(tr.state, batch, tr.step_generator(tr.start_step), 0.0)
        ends.append(fingerprint(new["params"] + new["opt"]["mu"],
                                {k: float(v) for k, v in m.items()}))
        del new
    assert torch.equal(*ends), "lossy_moe at drop 0 differs from off"
    return True


def ep_microbatch_step(tr, cfg, opt, ts, celeris, drop, group, counts):
    """One step with ``EP_MICROBATCHES`` microbatches from the trainer's
    state on its next batch, timed alone: loss finite and within
    FAMILY_LOSS_BAND of ln V, the gradient norm and the new parameters
    finite, the ranks of the dp ``group`` bit-identical."""
    import torch.distributed as dist
    step = ts.make_train_step(cfg, tr.mesh, opt, celeris,
                              microbatches=EP_MICROBATCHES)
    batch = tr.put_batch(tr.start_step)
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    new, m = step(tr.state, batch, tr.step_generator(tr.start_step), drop)
    _sync()
    wall = time.perf_counter() - t0
    m = {k: float(v) for k, v in m.items()}
    assert abs(m["loss"] - math.log(cfg.vocab_size)) < FAMILY_LOSS_BAND, m
    assert np.isfinite(m["grad_norm"]) and all(
        bool(torch.isfinite(p).all()) for p in new["params"]), m
    fp = fingerprint(new["params"], m)
    every = [torch.empty_like(fp) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, fp, group=group)
    assert all(torch.equal(e, fp) for e in every), "the dp ranks differ"
    return {"loss": m["loss"], "aux": m["aux"], "grad_norm": m["grad_norm"],
            "step_ms": wall * 1e3, "launches": counts.read()}


def ep_check_vs_local(dev, cfg, mesh, MOE, convert, shd, generator):
    """One full-width MoE layer in float32 at capacity factor 50: the EP
    block over the (1, 4) model group against the local path on the
    whole layer, rtol 1e-4 + atol 1e-5; returns the worst error."""
    c = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=50.0))
    whole = MOE.init_moe(generator(dev, 5), c)
    x = torch.randn(EP_CHECK_TOKENS + (c.d_model,),
                    generator=generator(dev, 6), device=dev) * 0.3
    tp = convert.model_group(c, mesh)
    specs = MOE.param_specs(c)
    mine = {k: shd.local_slice(v, specs[k], mesh) for k, v in whole.items()}
    with torch.no_grad():
        y_local, _ = MOE.moe_block(whole, c, x)
        y_ep, _ = MOE.moe_block(mine, c, x, tp=tp)
    err = check("EP vs local (full width, f32, capacity 50)", y_ep, y_local,
                1e-4, 1e-5)
    del whole, mine
    torch.cuda.empty_cache()
    return err


def ep_fwht_shapes(C):
    """The FWHT's (rows, n_rot) in phase 6d's coded cell: the MoE model's
    coded leaves on the (2, 2) mesh."""
    return tp_fwht_shapes(ep_config(C), mesh_shape((2, 2),
                                                   ("data", "model")))


def phase_ep_train(dev, C, kfwht, ref, mesh_ranks):
    """Phase 6d: expert-parallel training of qwen2-moe-a2.7b at full
    width (``EP_LAYERS`` layers), four rank processes on the one card
    over gloo (``ep_rank``); then the FWHT held to its plain version at
    every shape of the coded cell's sync, timed at the two largest.
    Returns the phase's record and the timing records."""
    ranks, seconds = kind_ranks(mesh_ranks, "ep")
    smi = card_name_and_power()
    out, launches = {"cells": {}}, 0
    for name, *_ in EP_CELLS:
        cell = ranks[0]["cells"][name]
        steps = cell["steps"]
        rec = {k: cell[k] for k in ("mesh", "mode", "lossy_moe", "drop",
                                    "loss", "recv_frac", "coded_leaves")}
        rec.update(
            aux=[s["aux"] for s in steps],
            step_ms=[s["wall_ms"] for s in steps],
            median_step_ms_after_first=statistics.median(
                s["wall_ms"] for s in steps[1:]),
            ep_all_to_all_ms=[s["a2a_ms"] for s in steps],
            ep_all_to_all_bytes_per_rank_step=steps[-1]["a2a_bytes"],
            dp_sync_ms=[s["sync_ms"] for s in steps],
            fwht_launches_per_rank_step=[s["launches"]["fwht"]
                                         for s in steps],
            blocks_dropped_share=(
                sum(s["dropped"] for rk in ranks
                    for s in rk["cells"][name]["steps"])
                / max(1, sum(s["blocks"] for rk in ranks
                             for s in rk["cells"][name]["steps"]))),
            coins_share=(
                sum(s["coin_dropped"] for rk in ranks
                    for s in rk["cells"][name]["steps"])
                / max(1, sum(s["blocks"] for rk in ranks
                             for s in rk["cells"][name]["steps"]))),
            peak_gib_per_rank=[rk["cells"][name]["peak_gib"]
                               for rk in ranks])
        assert rec["blocks_dropped_share"] == rec["coins_share"], rec
        launches += sum(s["launches"]["fwht"] for rk in ranks
                        for s in rk["cells"][name]["steps"])
        out["cells"][name] = rec
        if name == EP_MB_CELL:
            rec["microbatches"] = mb = cell["microbatches"]
            print(f"ep train {name} with {EP_MICROBATCHES} microbatches "
                  f"(each rank's share of block k of the global batch, "
                  f"routed whole): its next step, loss {mb['loss']:.4f} "
                  f"(ln V {math.log(ep_config(C).vocab_size):.4f}), aux "
                  f"{mb['aux']:.4g}, grad norm {mb['grad_norm']:.4g}, "
                  f"{mb['step_ms']:.1f} ms, beside the cell's one-"
                  f"microbatch steps {rec['step_ms']} ms [{smi}]")
        print(f"ep train {name} ({rec['mesh']}, {rec['mode']}, lossy_moe "
              f"{rec['lossy_moe']} at {rec['drop']}; {EP_ARCH} full width, "
              f"{EP_LAYERS} layers; {DP_WORLD} ranks on one card, gloo): "
              f"loss {rec['loss']}, aux {rec['aux']}, recv_frac "
              f"{rec['recv_frac']}, step ms {rec['step_ms']} (median after "
              f"the first {rec['median_step_ms_after_first']:.1f}), EP "
              f"all-to-all ms {rec['ep_all_to_all_ms']} and bytes/rank-step "
              f"{rec['ep_all_to_all_bytes_per_rank_step']}, dp sync ms "
              f"{rec['dp_sync_ms']}, FWHT launches/rank-step "
              f"{rec['fwht_launches_per_rank_step']}, dropped blocks "
              f"{rec['blocks_dropped_share']:.4f} = coins' "
              f"{rec['coins_share']:.4f}, peak GiB/rank "
              f"{[round(g, 2) for g in rec['peak_gib_per_rank']]} [{smi}]")
    assert all(rk["off_vs_zero"] for rk in ranks)
    out.update(seconds=seconds,
               ep_vs_local_max_abs_err=[rk["ep_vs_local"] for rk in ranks],
               off_vs_zero_bit_equal=True,
               launches={"fwht": launches, "fwht_quantize": 0,
                         "masked_unbias": 0, "quantize_int8": 0,
                         "dcqcn_scan": 0})
    # the FWHT at the coded cell's own shapes
    g = torch.Generator(dev).manual_seed(7)
    shapes = sorted(set(ep_fwht_shapes(C)))
    worst, records = 0.0, []
    for rows, n in shapes:
        x = torch.randn(rows, n, generator=g, device=dev)
        signs = (torch.randint(0, 2, (n,), generator=g, device=dev).float()
                 * 2 - 1)
        err = check_equal(f"fwht ep sync {rows}x{n}",
                          (kfwht.fwht_cuda(x, signs, n ** -0.5),),
                          (ref.fwht(x, signs=signs, scale=n ** -0.5),))
        worst = max(worst, err)
        if (rows, n) in shapes[-2:]:
            records.append(fwht_record(kfwht, ref, x, signs, n ** -0.5, err))
        del x
    out["fwht_sync_shapes"] = [list(x) for x in shapes]
    out["fwht_sync_max_abs_err"] = worst
    print(f"ep train: EP = local (full width, 1 layer, f32, capacity 50) "
          f"worst err by rank {out['ep_vs_local_max_abs_err']}; lossy_moe at "
          f"drop 0 = off bit for bit; fwht at the coded sync's shapes "
          f"{out['fwht_sync_shapes']} worst err {worst:.3g}; "
          f"{seconds:.1f} s [{smi}]")
    return out, records


# phase 6e: the dense families and granite-moe trained at full width on
# one device, the depth cut because the AdamW state (16 B a parameter:
# bf16 parameter and gradient, f32 master, mu, nu) does not fit the card
# at full depth; nemotron's two 1.57 B-value embedding leaves leave it one
# layer.  (arch, layers)
FAMILY_TRAIN = (("chatglm3-6b", 2), ("gemma2-9b", 2),
                ("granite-moe-3b-a800m", 2), ("nemotron-4-15b", 1))
FAMILY_MODES = ("exact", "lossy_hadamard")
FAMILY_LOSS_BAND = 1.5     # |step-0 loss - ln V| at random weights
FAMILY_SMOKE_SEQ = 96      # over gemma2's 64-token smoke window
# phase 6f: four ranks on the one card over gloo, MESH_LAYERS deep, 2
# steps a cell: (arch, mesh, mode, drop)
FAMILY_MESH_CELLS = (("gemma2-9b", "dm22", "lossy_hadamard", 0.05),
                     ("chatglm3-6b", "dm14", "exact", 0.0))
FAMILY_MESHES = {"dm22": ((2, 2), ("data", "model")),
                 "dm14": ((1, 4), ("data", "model")),
                 "dm41": ((4, 1), ("data", "model"))}


def family_config(C, arch, layers=None):
    """``arch`` at full width, ``layers`` deep (an enc-dec config's
    encoder as deep), or whole with ``layers`` None."""
    cfg = C.get(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=layers, encoder_layers=layers if cfg.is_encdec else 0)


def family_mesh_config(C, arch):
    """Phase 6f's model: ``arch`` at full width, ``MESH_LAYERS`` deep."""
    return family_config(C, arch, MESH_LAYERS)


def family_fwht_shapes(C, train=FAMILY_TRAIN, cells=FAMILY_MESH_CELLS,
                       mesh_config=family_mesh_config):
    """The FWHT's (rows, n_rot) on phases 6e and 6f's paths (or 6g and
    6h's: ``train``, ``cells`` and their ``mesh_config``), in leaf order:
    each model's coded leaves on one device (its tiles of 4096), then
    each coded mesh cell's per rank (``tp_fwht_shapes``)."""
    from repro_torch.models import convert
    from repro_torch.train import train_step as ts
    one = {}
    for arch, layers in train:
        cfg = family_config(C, arch, layers)
        one[arch] = [(p.tiles, p.n_rot) for p in ts.plan_leaves(
            convert.leaf_shapes(cfg), None, ts.CelerisConfig(),
            convert.leaf_names(cfg)) if p is not None]
    mesh = {arch: tp_fwht_shapes(mesh_config(C, arch),
                                 mesh_shape(*FAMILY_MESHES[mk]))
            for arch, mk, mode, _ in cells if mode != "exact"}
    return one, mesh


def phase_train_families(dev, C, ts, Trainer, DataConfig, OptConfig, counts,
                         train=FAMILY_TRAIN):
    """Phase 6e (or 6g's models, ``train``): each model at full width
    through ``Trainer``, 8 x 128 tokens (text alone), ``TRAIN_STEPS``
    steps in ``exact`` and in ``lossy_hadamard``: losses finite, the
    first within ``FAMILY_LOSS_BAND`` of ln V, the FWHT launched twice a
    coded leaf each coded step and never in ``exact``, recv_frac in
    [0.4, 1]; the step ms, the peak beside the reckoned state and a
    profiled fourth coded step (its launches uncounted)."""
    from repro_torch.models import convert
    out, total = {}, {}
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    smi = card_name_and_power()
    for arch, layers in train:
        cfg = family_config(C, arch, layers)
        names = convert.leaf_names(cfg)
        data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=1)
        n_coded = sum(p is not None for p in ts.plan_leaves(
            convert.leaf_shapes(cfg), None, ts.CelerisConfig(), names))
        n_params = sum(math.prod(s) for s in convert.leaf_shapes(cfg))
        rec = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
               "leaves": len(names), "coded_leaves": n_coded,
               "params": n_params,
               "reckoned_state_gb": cfg.param_count() * 16 / 1e9,
               "view_state_gb": n_params * 16 / 1e9}
        for mode in FAMILY_MODES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                         celeris=ts.CelerisConfig(mode=mode), seed=0,
                         device=str(dev))
            steps = []

            def on_metrics(step, m):
                steps.append(dict(m, launches=counts.read()))
                counts.reset()

            _sync()
            counts.reset()
            hist = tr.run(TRAIN_STEPS, on_metrics=on_metrics)
            peak = torch.cuda.max_memory_allocated()
            for st in steps:
                for k, v in st["launches"].items():
                    total[k] = total.get(k, 0) + v
            assert np.isfinite(hist["loss"]).all(), (arch, mode, hist)
            assert abs(hist["loss"][0] - math.log(cfg.vocab_size)) < (
                FAMILY_LOSS_BAND), (arch, mode, hist["loss"])
            fwht = [st["launches"]["fwht"] for st in steps]
            coded = mode == "lossy_hadamard"
            assert fwht == [2 * n_coded if coded else 0] * TRAIN_STEPS, (
                arch, mode, fwht)
            if coded:
                assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"]), (
                    arch, hist["recv_frac"])
            step_ms = [st["wall_s"] * 1e3 for st in steps]
            rec[mode] = {"loss": hist["loss"], "recv_frac": hist["recv_frac"],
                         "step_ms": step_ms,
                         "median_step_ms_after_first":
                             statistics.median(step_ms[1:]),
                         "fwht_launches_per_step": fwht,
                         "peak_gib": peak / 2 ** 30, "peak_gb": peak / 1e9}
            if coded:
                rec[mode]["profile_step"] = profile_window(lambda: tr.run(1))
                counts.reset()
            del tr
            median = rec[mode]["median_step_ms_after_first"]
            enc = (f" + {cfg.encoder_layers} encoder" if cfg.is_encdec
                   else "")
            print(f"train {arch} {mode} (full width, {cfg.n_layers} layers"
                  f"{enc}, {TRAIN_BATCH} x {TRAIN_SEQ} text tokens): loss "
                  f"{hist['loss']}, recv_frac {hist['recv_frac']}, step ms "
                  f"{step_ms} (median after the first {median:.1f}), FWHT "
                  f"launches/step {fwht} ({n_coded} coded leaves), peak "
                  f"{peak / 1e9:.2f} GB against the reckoned state "
                  f"{rec['reckoned_state_gb']:.2f} GB (the view's "
                  f"{rec['view_state_gb']:.2f} GB)"
                  + (f"; profiled step {rec[mode]['profile_step']}"
                     if coded else "") + f" [{smi}]")
        out[arch] = rec
    torch.cuda.empty_cache()
    out["launches"] = total
    return out


def family_smoke_card_vs_cpu(dev, C, ts, OptConfig, DataConfig, make_source):
    """Each family's smoke config in float32 through
    ``small_steps_card_vs_cpu``: one ``lossy_hadamard`` step, a batch of
    4 x 96 tokens (gemma2's 64-token window binds), drop 0.1,
    ``TEST_STEP_TOL``; granite-moe's routing ids on the card equal the
    CPU's, call by call, before any tolerance is applied."""
    from repro_torch.models import moe as MOE
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    route, out = MOE._route, {}
    for arch, _ in FAMILY_TRAIN:
        cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
        src = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=FAMILY_SMOKE_SEQ, global_batch=4,
                                     seed=1))
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in src.global_batch(0).items()}
        routes = {"cpu": [], "cuda": []}

        def recorded(*a, **k):
            res = route(*a, **k)
            ids = routes[res[1].device.type]
            ids.append(res[1].cpu())
            if res[1].device.type == "cuda":
                assert torch.equal(ids[-1], routes["cpu"][len(ids) - 1]), (
                    f"{arch}: routing call {len(ids) - 1} differs")
            return res

        MOE._route = recorded
        try:
            _, rec = small_steps_card_vs_cpu(
                dev, ts, cfg, opt, batch, 0.1, ("lossy_hadamard",),
                TEST_STEP_TOL, f"train families smoke {arch}")
        finally:
            MOE._route = route
        assert len(routes["cpu"]) == len(routes["cuda"]), arch
        out[arch] = dict(rec["lossy_hadamard"],
                         routing_calls_compared=len(routes["cuda"]))
    print(f"train families smoke f32, card vs CPU (one lossy_hadamard step, "
          f"{FAMILY_SMOKE_SEQ} tokens): {out}")
    return out


def check_family_fwht(dev, C, kfwht, ref, shapes=None, seen=(),
                      what="families", time_all=False):
    """The FWHT held to its plain version, bit for bit, at every shape of
    phases 6e and 6f's coded syncs (or ``shapes``, ``family_fwht_shapes``'
    pair, less the ``seen`` ones); timed at each model's largest
    one-device leaf and at each mesh cell's largest, or with
    ``time_all`` at every shape checked."""
    one, mesh = shapes or family_fwht_shapes(C)
    groups = list(one.values()) + list(mesh.values())
    checked = sorted({s for v in groups for s in v} - set(seen))
    timed = set(checked) if time_all else {max(v) for v in groups}
    g = torch.Generator(dev).manual_seed(11)
    worst, records = 0.0, []
    for rows, n in sorted(set(checked) | timed):
        x = torch.randn(rows, n, generator=g, device=dev)
        signs = (torch.randint(0, 2, (n,), generator=g, device=dev).float()
                 * 2 - 1)
        err = check_equal(f"fwht {what} sync {rows}x{n}",
                          (kfwht.fwht_cuda(x, signs, n ** -0.5),),
                          (ref.fwht(x, signs=signs, scale=n ** -0.5),))
        worst = max(worst, err)
        if (rows, n) in timed:
            records.append(fwht_record(kfwht, ref, x, signs, n ** -0.5, err))
        del x
        torch.cuda.empty_cache()
    print(f"train {what}: fwht at the coded syncs' shapes {checked} worst "
          f"err {worst:.3g}; timed at {sorted(timed)}")
    return {"one_device": {a: [list(s) for s in v] for a, v in one.items()},
            "mesh": {a: [list(s) for s in v] for a, v in mesh.items()},
            "shapes": [list(s) for s in checked],
            "max_abs_err": worst}, records


def family_rank(rank, dev, cells=FAMILY_MESH_CELLS, config=None,
                tp_checks=False):
    """One rank of phase 6f (or 6h and 6i: ``cells`` and ``config(C,
    arch)``, the cells' model; a stub's cell then feeds its trainer the
    rank's rows of ``stub_extras``): ``cells`` through
    ``Trainer(mesh=...)``, ``DP_STEPS`` steps each, at full width and by
    default ``MESH_LAYERS`` deep.  Every step: losses finite, the ranks
    that share a model index bit-identical, a coded step's FWHT launched
    twice a coded leaf at ``tp_fwht_shapes``, recv_frac within 0.04 of
    the drop rate's complement; each rank holds its ZeRO-1 slices on a
    data axis.  ``tp_checks`` (6i) adds: step 0's loss within
    ``FAMILY_LOSS_BAND`` of ln V and within ``TP_LOSS_RTOL`` of rank 0's
    one-device loss of the same weights and batch
    (``one_device_loss``), and every step the ranks of a model group
    bit-identical in the loss and every leaf the specs keep whole.
    Records each rank's peak, the dp sync's ms and bytes and the
    model-group collectives' ms and bytes a rank-step."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch import sharding as shd
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import dcqcn as kdcqcn
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.models import convert
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    from repro_torch.launch import mesh as mesh_mod
    counts = Launches(kfwht, kunbias, kquant, kdcqcn)
    config = config or family_mesh_config
    meshes = {mk: mesh_mod.make_host_mesh(FAMILY_MESHES[mk][0],
                                          device_type=dev.type)
              for mk in sorted({cell[1] for cell in cells})}
    stats = {}

    def reset():
        stats.update(sync_s=0.0, bytes=0, model_s=0.0, model_bytes=0,
                     fwht_shapes=[])

    def timed(fn, key=None, bytes_key=None):
        # the seconds under ``key`` (the dp all-reduces run inside the
        # timed sync: bytes only), the first argument's bytes under
        # ``bytes_key``
        def call(*a, **k):
            if bytes_key:
                stats[bytes_key] += a[0].numel() * a[0].element_size()
            _sync()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            _sync()
            if key:
                stats[key] += time.perf_counter() - t0
            return res
        return call

    def shaped_fwht(x, *a, **k):
        stats["fwht_shapes"].append(list(x.shape))
        return plain_fwht(x, *a, **k)

    saved = (ts._sync_dp, ts._all_reduce, shd.model_all_reduce,
             shd.model_all_gather, shd.model_reduce_scatter, ops.fwht)
    sync_dp, all_reduce, *model_ops, plain_fwht = saved
    ts._sync_dp = timed(sync_dp, "sync_s")
    ts._all_reduce = timed(all_reduce, bytes_key="bytes")
    (shd.model_all_reduce, shd.model_all_gather,
     shd.model_reduce_scatter) = (timed(f, "model_s", "model_bytes")
                                  for f in model_ops)
    ops.fwht = shaped_fwht
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    rec = {"cells": {}}
    try:
        for arch, mk, mode, drop in cells:
            torch.cuda.empty_cache()
            cfg = config(C, arch)
            mesh = meshes[mk]
            celeris = ts.CelerisConfig(mode=mode)
            n_coded = sum(p is not None for p in ts.plan_leaves(
                convert.leaf_shapes(cfg), mesh, celeris,
                convert.leaf_names(cfg)))
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, data_cfg=DataConfig(
                vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, seed=1), opt_cfg=opt,
                celeris=celeris, mesh=mesh, seed=0,
                straggler=FixedDrop(drop), device=str(dev))
            group = tr.step_fn.dp_group
            if cfg.frontend:
                tr.put_batch = with_extras(tr.put_batch, cfg, dev,
                                           *tr.shard)
            one_loss = None
            if tp_checks:
                reset()
                one_loss = one_device_loss(tr, cfg, mesh, dev)
                torch.cuda.reset_peak_memory_stats()
            steps = []

            def on_metrics(step, m):
                steps.append({"wall_ms": m["wall_s"] * 1e3,
                              "sync_ms": stats["sync_s"] * 1e3,
                              "allreduce_bytes": stats["bytes"],
                              "model_ms": stats["model_s"] * 1e3,
                              "model_bytes": stats["model_bytes"],
                              "launches": counts.read(),
                              "fwht_shapes": sorted(stats["fwht_shapes"])})
                fp = fingerprint(tr.state["params"], {
                    k: v for k, v in m.items() if k not in ("wall_s",
                                                            "drop_rate")})
                every = [torch.empty_like(fp)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(every, fp, group=group)
                assert all(torch.equal(e, fp) for e in every), (
                    f"{arch} {mk} step {step}: the ranks that share a model "
                    "index differ")
                if tp_checks:
                    check_model_group(tr, cfg, m, f"{arch} {mk} step {step}")
                counts.reset()
                reset()

            _sync()
            counts.reset()
            reset()
            hist = tr.run(DP_STEPS, on_metrics=on_metrics)
            peak = torch.cuda.max_memory_allocated()
            check_zero1_layout(cfg, mesh, tr.state, arch)
            assert (tr.step_fn.data_group is not None) == (
                FAMILY_MESHES[mk][0][0] > 1), (arch, mk)
            del tr
            assert np.isfinite(hist["loss"]).all(), (arch, hist["loss"])
            coded = mode == "lossy_hadamard"
            want = {"fwht": 2 * n_coded if coded else 0, "fwht_quantize": 0,
                    "masked_unbias": 0, "quantize_int8": 0, "dcqcn_scan": 0}
            assert all(s["launches"] == want for s in steps), (arch, steps)
            if coded:
                shapes = sorted(2 * [list(x) for x in
                                     tp_fwht_shapes(cfg, mesh)])
                assert all(s["fwht_shapes"] == shapes for s in steps), (
                    arch, shapes)
                assert all(abs(f - (1 - drop)) < 0.04
                           for f in hist["recv_frac"]), hist["recv_frac"]
            else:
                assert hist["recv_frac"] == [1.0] * DP_STEPS, hist
            if tp_checks:
                assert abs(hist["loss"][0] - math.log(cfg.vocab_size)) < (
                    FAMILY_LOSS_BAND), (arch, hist["loss"])
                assert one_loss is None or abs(hist["loss"][0] - one_loss) <= (
                    TP_LOSS_RTOL * abs(one_loss)), (
                    f"{arch} {mk}: step 0's loss {hist['loss'][0]} vs one "
                    f"device {one_loss}")
            rec["cells"][f"{arch} {mk}"] = {
                "arch": arch, "mesh": mk, "mode": mode, "drop": drop,
                "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
                "extras": EXTRAS_KEY.get(cfg.frontend),
                "coded_leaves": n_coded, "loss": hist["loss"],
                "recv_frac": hist["recv_frac"], "steps": steps,
                "peak_gib": peak / 2 ** 30, "peak_gb": peak / 1e9,
                "one_device_loss": one_loss}
    finally:
        (ts._sync_dp, ts._all_reduce, shd.model_all_reduce,
         shd.model_all_gather, shd.model_reduce_scatter, ops.fwht) = saved
    torch.cuda.empty_cache()
    return rec


def one_device_loss(tr, cfg, mesh, dev):
    """Rank 0's loss (float) of the trainer's whole weights, gathered
    over ``model`` from every rank's shards, on its first step's global
    batch (the dp ranks' rows together; a stub's with its
    ``stub_extras``, bfloat16) on one device, with
    no tensor parallelism; None on the other ranks.  Every rank of the
    mesh calls it together."""
    import torch.distributed as dist
    from repro_torch.models import convert
    from repro_torch.models import model as M
    names = convert.leaf_names(cfg)
    full = convert.gather_leaves(tr.state["params"], mesh,
                                 convert.leaf_shapes(cfg), names)
    loss = None
    if dist.get_rank() == 0:
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in tr.source.global_batch(0, tr.shard[1]).items()}
        batch.update({k: v.to(dev, torch.bfloat16) for k, v in
                      stub_extras(cfg, TRAIN_BATCH, TRAIN_SEQ).items()})
        with torch.no_grad():
            loss = M.lm_loss(convert.params_from_leaves(full, cfg), cfg,
                             batch)[0].item()
        del batch
    del full
    torch.cuda.empty_cache()
    return loss


def check_model_group(tr, cfg, metrics, what):
    """The ranks of this rank's model group hold the same loss and the
    same bits in every parameter that the specs keep whole (norms,
    gates, ``r_h``, ``w_if``, an embedding the guard keeps whole)."""
    import torch.distributed as dist
    from repro_torch.models import convert
    tp = tr.step_fn.model_group
    whole = [p for p, n in zip(tr.state["params"], convert.short_names(cfg))
             if n not in tp.split]
    fp = fingerprint(whole, {"loss": metrics["loss"]})
    every = [torch.empty_like(fp) for _ in range(tp.size)]
    dist.all_gather(every, fp, group=tp.group)
    assert whole and all(torch.equal(e, fp) for e in every), (
        f"{what}: the ranks of a model group differ in the loss or a "
        "whole leaf")


def phase_mesh_train_families(mesh_ranks, kind="families"):
    """Phase 6f: ``FAMILY_MESH_CELLS`` on four rank processes sharing the
    one card over gloo (``family_rank``), in one launch; ``kind``
    "recurrent_stubs" is phase 6h, ``RS_MESH_CELLS``, and
    "tp_recurrent_stubs" phase 6i, ``TP_RS_CELLS`` tensor parallel."""
    ranks, seconds = kind_ranks(mesh_ranks, kind)
    smi = card_name_and_power()
    out, launches = {"cells": {}}, 0
    for name, cell in ranks[0]["cells"].items():
        steps = cell["steps"]
        rec = {k: cell[k] for k in ("arch", "mesh", "mode", "drop", "layers",
                                    "encoder_layers", "extras",
                                    "coded_leaves", "loss", "recv_frac",
                                    "one_device_loss")}
        rec.update(
            step_ms=[s["wall_ms"] for s in steps],
            sync_ms_per_rank=[[s["sync_ms"] for s in rk["cells"][name][
                "steps"]] for rk in ranks],
            allreduce_bytes_per_rank_step=steps[-1]["allreduce_bytes"],
            model_collective_ms=[s["model_ms"] for s in steps],
            model_collective_bytes_per_rank_step=steps[-1]["model_bytes"],
            fwht_launches_per_rank_step=[s["launches"]["fwht"]
                                         for s in steps],
            peak_gb_per_rank=[rk["cells"][name]["peak_gb"] for rk in ranks])
        launches += sum(s["launches"]["fwht"] for rk in ranks
                        for s in rk["cells"][name]["steps"])
        out["cells"][name] = rec
        enc = (f" + {rec['encoder_layers']} encoder"
               if rec["encoder_layers"] else "")
        print(f"train {kind} mesh {name} ({rec['mode']} at {rec['drop']}, "
              f"full width, {rec['layers']} layers{enc}, extras "
              f"{rec['extras']}, {DP_WORLD} ranks on one "
              f"card, gloo): loss {rec['loss']}, recv_frac "
              f"{rec['recv_frac']}, step ms {rec['step_ms']}, dp sync ms by "
              f"rank {rec['sync_ms_per_rank']}, dp all-reduce bytes/"
              f"rank-step {rec['allreduce_bytes_per_rank_step']}, "
              f"model-group collectives ms {rec['model_collective_ms']} and "
              f"bytes/rank-step "
              f"{rec['model_collective_bytes_per_rank_step']}, FWHT "
              f"launches/rank-step {rec['fwht_launches_per_rank_step']}, "
              f"peak GB/rank {[round(g, 2) for g in rec['peak_gb_per_rank']]}"
              + (f", step 0's loss vs one device {rec['one_device_loss']}"
                 if rec["one_device_loss"] is not None else "")
              + f" [{smi}]")
    out.update(seconds=seconds,
               launches={"fwht": launches, "fwht_quantize": 0,
                         "masked_unbias": 0, "quantize_int8": 0,
                         "dcqcn_scan": 0})
    return out


# phase 6g: the recurrent families and the modality stubs trained at full
# width on one device, 8 x 128 text tokens.  AdamW keeps 16 B a parameter
# (bf16 parameter and gradient, f32 master, mu, nu): recurrentgemma-9b's
# 38 layers would hold 136 GB and phi-3-vision-4.2b's 32 layers 61 GB, so
# recurrentgemma runs 5 layers (one (rglru, rglru, local) group and the
# full config's two-rglru tail) and phi-3-vision 2; xlstm-350m (24 layers)
# and seamless-m4t-medium (12 + 12) run whole.  (arch, layers or None)
RS_TRAIN = (("recurrentgemma-9b", 5), ("xlstm-350m", None),
            ("phi-3-vision-4.2b", 2), ("seamless-m4t-medium", None))
# phase 6h: four ranks on the one card over gloo, the (4, 1) data x model
# mesh (ZeRO-1 over data), DP_STEPS steps a cell: (arch, mesh, mode,
# drop); xlstm at 4 layers (one mlstm x 3 + slstm group), seamless at
# 2 + 2 with its frames split by rows with the tokens
RS_MESH_CELLS = (("xlstm-350m", "dm41", "lossy_hadamard", 0.05),
                 ("seamless-m4t-medium", "dm41", "exact", 0.0))
RS_MESH_LAYERS = {"xlstm-350m": 4, "seamless-m4t-medium": 2}
EXTRAS_SEED = 21


def rs_mesh_config(C, arch):
    """Phase 6h's model: ``arch`` at full width, ``RS_MESH_LAYERS`` deep."""
    return family_config(C, arch, RS_MESH_LAYERS[arch])


# phase 6i: the recurrent families and the stubs tensor parallel, four
# ranks on the one card over gloo, DP_STEPS steps a cell: (arch, mesh,
# mode, drop); recurrentgemma at 3 layers (one (rglru, rglru, local)
# group: the RG-LRU by channel, MQA local attention), xlstm at 4 (mlstm x
# 3 + slstm: 2 heads a rank, the sLSTM's gate gather, the FWHT at the TP
# leaves, ZeRO-1 over data), seamless at 2 + 2 with its frames (the
# encoder, the cross-attention and frontend_proj split, its 256,206-row
# vocabulary whole at tp 4)
TP_RS_CELLS = (("recurrentgemma-9b", "dm14", "exact", 0.0),
               ("xlstm-350m", "dm22", "lossy_hadamard", 0.05),
               ("seamless-m4t-medium", "dm14", "exact", 0.0))
TP_RS_LAYERS = {"recurrentgemma-9b": 3, "xlstm-350m": 4,
                "seamless-m4t-medium": 2}
# step 0's loss on the mesh against one device, bfloat16 at full width:
# bfloat16's unit roundoff.  On the CPU at smoke widths in bfloat16 the
# four families' TP loss on (2, 2) and (1, 4) came within 1.4e-4 of the
# one-device loss, relative (2^-12.8)
TP_LOSS_RTOL = 2 ** -9
# the FWHT's TP leaf shapes held to its plain version: each 6i cell's
# coded leaves on its mesh, and phi-3-vision's (frontend_proj) on (1, 4)
TP_RS_FWHT = TP_RS_CELLS + (("phi-3-vision-4.2b", "dm14", "lossy_hadamard",
                             0.05),)


def tp_rs_config(C, arch):
    """Phase 6i's model: ``arch`` at full width, ``TP_RS_LAYERS`` deep
    (phi-3-vision at phase 6g's 2)."""
    return family_config(C, arch, TP_RS_LAYERS.get(arch, 2))


def tp_rs_fwht_shapes(C):
    """The FWHT's (rows, n_rot) of every coded leaf of ``TP_RS_FWHT``'s
    models on their meshes, whatever the cell's mode, as
    ``family_fwht_shapes`` gives them (no one-device shapes)."""
    return {}, {f"{arch} {mk}": tp_fwht_shapes(
        tp_rs_config(C, arch), mesh_shape(*FAMILY_MESHES[mk]))
        for arch, mk, _, _ in TP_RS_FWHT}


# the batch key of each frontend's inputs
EXTRAS_KEY = {"vision_stub": "image_embeds", "audio_stub": "frame_embeds"}


def stub_extras(cfg, batch, seq, step=0, rows=None):
    """A stub's extras for a ``batch``-row global batch, float32 from a
    numpy seed (and ``step``): a vision stub's image embeds (batch,
    n_frontend_tokens, frontend_dim), an enc-dec config's frames (batch,
    seq, frontend_dim); ``rows`` (a slice) keeps those rows.  Empty
    without a frontend."""
    if cfg.frontend is None:
        return {}
    tokens = (cfg.n_frontend_tokens if cfg.frontend == "vision_stub"
              else seq)
    x = np.random.default_rng([EXTRAS_SEED, step]).standard_normal(
        (batch, tokens, cfg.frontend_dim), dtype=np.float32)
    return {EXTRAS_KEY[cfg.frontend]:
            torch.from_numpy(x if rows is None else x[rows])}


def with_extras(put_batch, cfg, dev, peer, n_shards):
    """A trainer's ``put_batch`` that adds its dp rank's rows of the
    step's ``stub_extras`` (of the TRAIN_BATCH-row global batch, the
    rows the rank's tokens are of it) in bfloat16 on ``dev``, the dtype
    of JAX's ``train_input_specs``."""
    rows = TRAIN_BATCH // n_shards

    def put(step):
        batch = put_batch(step)
        extras = stub_extras(cfg, TRAIN_BATCH, TRAIN_SEQ, step,
                             slice(peer * rows, (peer + 1) * rows))
        batch.update({k: v.to(dev, torch.bfloat16)
                      for k, v in extras.items()})
        return batch
    return put


def stub_leaves(names):
    """The leaves that a stub's text alone does not reach: the frontend
    projection, the encoder stack and its norm, the cross-attention."""
    return [n for n in names if n == "frontend_proj"
            or n.startswith(("encoder.", "enc_norm."))
            or ".xattn." in n or ".lnx." in n]


def rs_extras_step(dev, cfg, ts, opt, DataConfig, make_source, counts):
    """A stub's one ``make_train_step`` step at full width
    (``lossy_hadamard`` at drop 0.05, from seed 0, the state donated)
    with its extras given by hand (``stub_extras``: image embeds (8,
    144, 1024) or frames (8, 128, 1024), bfloat16): the loss finite and
    within the band of ln V, the FWHT twice a coded leaf, recv_frac in
    [0.4, 1], and the first moment of every leaf that the text alone
    does not reach non-zero: its backward ran on the card."""
    from repro_torch import generator
    from repro_torch.models import convert
    names = convert.leaf_names(cfg)
    n_coded = sum(p is not None for p in ts.plan_leaves(
        convert.leaf_shapes(cfg), None, ts.CelerisConfig(), names))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_state(generator(dev, 0), cfg)
    step = ts.make_train_step(cfg, None, opt,
                              ts.CelerisConfig(mode="lossy_hadamard"),
                              donate=True)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=1))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in src.global_batch(0).items()}
    extras = stub_extras(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batch.update({k: v.to(dev, torch.bfloat16) for k, v in extras.items()})
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    state, m = step(state, batch, generator(dev, 0, 1), 0.05)
    _sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts.read()
    counts.reset()
    peak = torch.cuda.max_memory_allocated()
    loss, frac = m["loss"].item(), m["recv_frac"].item()
    reached = stub_leaves(names)
    idle = [n for n in reached
            if not state["opt"]["mu"][names.index(n)].any()]
    del state, step
    torch.cuda.empty_cache()
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < (
        FAMILY_LOSS_BAND), (cfg.name, loss)
    assert launches["fwht"] == 2 * n_coded, (cfg.name, launches)
    assert 0.4 <= frac <= 1.0, (cfg.name, frac)
    assert reached and not idle, (cfg.name, "no gradient reached", idle)
    return {"extras": {k: list(v.shape) for k, v in extras.items()},
            "loss": loss, "recv_frac": frac, "step_ms": wall_ms,
            "coded_leaves": n_coded, "leaves_reached_by_extras": len(reached),
            "peak_gb": peak / 1e9, "launches": launches}


def recurrent_block_launches(dev, C):
    """The kernel launches and device time of one sLSTM and one RG-LRU
    block's forward and backward at phase 6g's shapes (8 x 128 tokens,
    full width, random weights): the port's sLSTM time loop and RG-LRU
    doubling scan are torch ops, not kernels of their own, so their
    launches grow with the sequence.  A step's launches are a block's
    times the step's blocks of that kind (6g's depths)."""
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as RG
    from repro_torch.models import xlstm as XL
    out = {}
    for arch, layers, kind, init, block in (
            ("xlstm-350m", None, "slstm", XL.init_slstm, XL.slstm_block),
            ("recurrentgemma-9b", 5, "rglru", RG.init_rglru,
             RG.rglru_block)):
        cfg = family_config(C, arch, layers)
        g = torch.Generator(dev).manual_seed(0)
        p = {k: v.requires_grad_() for k, v in init(g, cfg).items()}
        x = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=g,
                         device=dev) * 0.5).to(L.dtype_of(cfg))
        x.requires_grad_()

        def fwd_bwd():
            y, _ = block(p, cfg, x)
            torch.autograd.grad(y.float().sum(), list(p.values()) + [x])

        fwd_bwd()
        prof = profile_window(fwd_bwd)
        plen = len(cfg.block_pattern)
        n = sum(cfg.block_pattern[i % plen] == kind
                for i in range(cfg.n_layers))
        per = prof.get("n_kernel_launches")
        out[kind] = {"arch": arch, "blocks_per_step": n,
                     "per_block_fwd_bwd": prof,
                     "launches_per_step": (per * n if per is not None
                                           else "not measured")}
        del p, x
        torch.cuda.empty_cache()
    return out


def phase_train_recurrent_stubs(dev, C, ts, Trainer, DataConfig, OptConfig,
                                make_source, counts):
    """Phase 6g: ``RS_TRAIN`` through ``phase_train_families``' checks
    (text alone, as JAX's Trainer runs the stubs); each stub's step with
    its extras (``rs_extras_step``); the sLSTM's and RG-LRU's launches a
    step (``recurrent_block_launches``)."""
    out = phase_train_families(dev, C, ts, Trainer, DataConfig, OptConfig,
                               counts, RS_TRAIN)
    smi = card_name_and_power()
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    for arch, layers in RS_TRAIN:
        cfg = family_config(C, arch, layers)
        if not cfg.frontend:
            continue
        rec = rs_extras_step(dev, cfg, ts, opt, DataConfig, make_source,
                             counts)
        out[arch]["extras_step"] = rec
        for k, v in rec["launches"].items():
            out["launches"][k] += v
        print(f"train {arch} with extras, one lossy_hadamard step: {rec} "
              f"[{smi}]")
    out["block_launches"] = recurrent_block_launches(dev, C)
    print(f"train recurrent blocks, launches of one block's forward + "
          f"backward at {TRAIN_BATCH} x {TRAIN_SEQ}, full width: "
          f"{out['block_launches']} [{smi}]")
    return out


def rs_smoke_card_vs_cpu(dev, C, ts, OptConfig, DataConfig, make_source):
    """Each of the four's smoke config in float32 through
    ``small_steps_card_vs_cpu``: one ``lossy_hadamard`` step on 4 x 96
    tokens (a stub's with its ``stub_extras``), drop 0.1,
    ``TEST_STEP_TOL``."""
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    out = {}
    for arch, _ in RS_TRAIN:
        cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
        src = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=FAMILY_SMOKE_SEQ, global_batch=4,
                                     seed=1))
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in src.global_batch(0).items()}
        batch.update(stub_extras(cfg, 4, FAMILY_SMOKE_SEQ))
        _, rec = small_steps_card_vs_cpu(
            dev, ts, cfg, opt, batch, 0.1, ("lossy_hadamard",),
            TEST_STEP_TOL, f"train recurrent/stubs smoke {arch}")
        out[arch] = dict(rec["lossy_hadamard"], batch=sorted(batch))
    print(f"train recurrent/stubs smoke f32, card vs CPU (one "
          f"lossy_hadamard step, {FAMILY_SMOKE_SEQ} tokens): {out}")
    return out


# phase 6j: qwen2-0.5b at full depth on train_4k's 4,096-token rows with
# remat; REMAT_ROWS rows if the dry run's reckoned peak, times
# RECKON_UNDERCOUNT, fits the card's memory (``costs.HW``), else 2.  The
# reckoning counts the tensors the step allocates, not the allocator's
# caching and fragmentation: on this cell it was 26.77 GB where the card
# measured a peak of 32.84 GB, 1.23 times as much (H100 80GB HBM3, 700 W)
REMAT_SEQ, REMAT_ROWS, REMAT_STEPS, REMAT_DROP = 4096, 4, 3, 0.05
RECKON_UNDERCOUNT = 1.25
REMAT_EQ_LAYERS = 2
# phase 5's remat cost: the loss and its gradients with remat and
# without, in turns, REMAT_COST_REPEATS times each
REMAT_COST_REPEATS = 5
DRYRUN_OUT = os.path.join(SRC, "repro_torch", "kernels", "build", "dryrun")
DRYRUN = ["-m", "repro_torch.launch.dryrun"]
# the serve check's two meshes, one process each (its prefill_32k traces
# take ~2 minutes a mesh)
SERVE_CHECK = ("from repro_torch.launch import dryrun; "
               "dryrun.serve_check(multi_pods=({},))")
DRYRUN_JOBS = {"reckon": DRYRUN + ["--one-device", str(REMAT_ROWS),
                                   "--seq", str(REMAT_SEQ)],
               "scale": DRYRUN + ["--scale-check"],
               "scale_hierarchical": DRYRUN + ["--scale-check", "--mode",
                                               "hierarchical"],
               "serve_16x16": ["-c", SERVE_CHECK.format(False)],
               "serve_2x16x16": ["-c", SERVE_CHECK.format(True)]}
DRYRUN_TIMEOUT = 600
_DRYRUN_PROCS = []


def start_dryruns():
    """Start every ``DRYRUN_JOBS`` entry (``python -m
    repro_torch.launch.dryrun`` or its ``serve_check``: meta tensors on a
    fake process group, no device, one host core each) in a background
    process of its own, its output in ``DRYRUN_OUT/<name>.log``.  Returns
    {name: (process, log path)}; :func:`wait_dryrun` reads one,
    :func:`stop_dryruns` ends any left."""
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for name, argv in DRYRUN_JOBS.items():
        path = os.path.join(DRYRUN_OUT, name + ".log")
        with open(path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, *argv], cwd=os.path.dirname(SRC), env=env,
                stdout=log, stderr=subprocess.STDOUT)
        _DRYRUN_PROCS.append(proc)
        jobs[name] = (proc, path)
    return jobs


def stop_dryruns():
    for proc in _DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_dryrun(jobs, name):
    """Wait for one dry-run job (under ``DRYRUN_TIMEOUT`` from now) and
    return its records: the last line's JSON for ``--one-device``, else
    the records the check saved (its ``saved -> PATH`` line).  A job that
    fails fails the phase."""
    proc, path = jobs[name]
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if "Warning" not in ln and "return func(" not in ln]
    assert proc.returncode == 0, (f"dry run {name} exited "
                                  f"{proc.returncode}:\n"
                                  + "\n".join(lines[-40:]))
    if name == "reckon":
        return json.loads(lines[-1])
    saved = [ln.split("saved -> ", 1)[1] for ln in lines if "saved -> " in ln]
    with open(saved[-1]) as f:
        return json.load(f)


def phase_dryrun(jobs):
    """Phase 23: wait for every dry-run job (started with the kernel
    checks of phase 2), assert every check's record ``ok`` and print
    them.  Returns the records, the one-device reckoning 6j reads under
    ``reckon``."""
    smi = card_name_and_power()
    out = {"reckon": wait_dryrun(jobs, "reckon")}
    for name in ("scale", "scale_hierarchical", "serve_16x16",
                 "serve_2x16x16"):
        recs = wait_dryrun(jobs, name)
        assert recs and all(r["ok"] for r in recs), (name, recs)
        out[name] = recs
        for r in recs:
            print(f"dry run {name}: {r['arch']} {r['shape']} "
                  f"{r.get('mode', r.get('kind'))} mesh {r['mesh']} rank "
                  f"{r['rank']}: ok, collectives {r['collective_ops']}, "
                  f"reckoned peak {r['peak_bytes'] / 1e9:.2f} GB a rank, "
                  f"traced in {r['trace_s']} s on the host (the fake group "
                  f"moves no bytes) [{smi}]")
    return out


def phase_train_remat(dev, C, ts, Trainer, DataConfig, OptConfig, counts,
                      reckoned):
    """Phase 6j (see the module's docstring); ``reckoned``: the dry run's
    one-device record of the cell at ``REMAT_ROWS`` rows."""
    from repro_torch import generator
    from repro_torch.data.pipeline import make_source
    from repro_torch.kernels import ops, ref
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.launch.costs import HW
    smi = card_name_and_power()
    fits = reckoned["peak_bytes"] * RECKON_UNDERCOUNT <= HW["hbm_bytes"]
    rows = REMAT_ROWS if fits else 2
    cfg = C.get("qwen2-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=REMAT_SEQ,
                          global_batch=rows, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    torch.cuda.empty_cache()
    tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                 celeris=ts.CelerisConfig(mode="lossy_hadamard"), seed=0,
                 straggler=FixedDrop(REMAT_DROP), device=str(dev))
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def on_metrics(step, m):
        steps.append({"wall_ms": m["wall_s"] * 1e3,
                      "launches": counts.read()})
        counts.reset()

    _sync()
    counts.reset()
    hist = tr.run(REMAT_STEPS, on_metrics=on_metrics)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: sum(st["launches"][k] for st in steps)
                for k in steps[0]["launches"]}
    fwht = [st["launches"]["fwht"] for st in steps]
    assert fwht == [2 * CODED_LEAVES] * REMAT_STEPS, fwht
    assert np.isfinite(hist["loss"]).all(), hist["loss"]
    assert all(abs(f - (1 - REMAT_DROP)) < 0.04 for f in hist["recv_frac"]
               ), hist["recv_frac"]
    assert peak * 1e9 < HW["hbm_bytes"]
    # the FWHT kernel against its plain version on one more step's own
    # inputs (these launches compare, so they count on no path)
    errs, plain_fwht = {}, ops.fwht

    def checked(x, *, signs=None, scale=1.0):
        out = plain_fwht(x, signs=signs, scale=scale)
        if tuple(x.shape) not in errs:
            errs[tuple(x.shape)] = check_equal(
                f"6j FWHT {tuple(x.shape)}", (out,),
                (ref.fwht(x, signs=signs, scale=scale),))
        return out

    ops.fwht = checked
    try:
        tr.state, _ = tr.step_fn(tr.state, tr.put_batch(REMAT_STEPS),
                                 tr.step_generator(REMAT_STEPS), REMAT_DROP)
        _sync()
    finally:
        ops.fwht = plain_fwht
    counts.reset()
    del tr
    torch.cuda.empty_cache()
    # remat against no remat at REMAT_EQ_LAYERS: loss and every gradient
    cfg2 = dataclasses.replace(cfg, n_layers=REMAT_EQ_LAYERS)
    leaves = convert.jax_leaves(M.init_params(cfg2, generator(dev, 0)), cfg2)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in make_source(data_cfg).global_batch(0).items()}
    res = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p = [x.detach().requires_grad_() for x in leaves]
        loss, _ = M.lm_loss(convert.params_from_leaves(p, cfg2), cfg2, batch,
                            remat=remat)
        grads = torch.autograd.grad(loss, p, allow_unused=True,
                                    materialize_grads=True)
        _sync()
        res[remat] = (loss.detach(), grads,
                      torch.cuda.max_memory_allocated() / 1e9)
    (l1, g1, pk1), (l0, g0, pk0) = res[True], res[False]
    unequal = [n for n, a, b in zip(convert.leaf_names(cfg2), g1, g0)
               if not torch.equal(a, b)]
    assert torch.equal(l1, l0) and not unequal, (
        f"6j: remat differs from no remat: loss {l1.item()} vs {l0.item()}, "
        f"gradients {unequal}")
    del res, g1, g0, leaves
    torch.cuda.empty_cache()
    out = {"rows": rows, "seq": REMAT_SEQ, "layers": cfg.n_layers,
           "rows_why": (f"reckoned {reckoned['peak_bytes'] / 1e9:.2f} GB at "
                        f"{REMAT_ROWS} rows, times {RECKON_UNDERCOUNT}, "
                        + ("fits" if fits else "does not fit")
                        + f" the card's {HW['hbm_bytes'] / 1e9:.0f} GB"),
           "loss": hist["loss"], "recv_frac": hist["recv_frac"],
           "step_ms": [st["wall_ms"] for st in steps],
           "median_step_ms_after_first": statistics.median(
               st["wall_ms"] for st in steps[1:]),
           "fwht_launches_per_step": fwht, "peak_gb": peak,
           "reckoned_peak_gb": (reckoned["peak_bytes"] / 1e9 if fits
                                else None),
           "fwht_check_max_abs_err": max(errs.values()),
           "fwht_check_shapes": sorted(map(list, errs)),
           "equal_layers": REMAT_EQ_LAYERS, "remat_equal_bit_for_bit": True,
           "peak_gb_remat": pk1, "peak_gb_no_remat": pk0,
           "launches": launches}
    print(f"train remat (6j): qwen2-0.5b {cfg.n_layers} layers, {rows} x "
          f"{REMAT_SEQ} "
          f"tokens ({out['rows_why']}), lossy_hadamard at {REMAT_DROP}: loss "
          f"{hist['loss']}, step ms {out['step_ms']} (median after the first "
          f"{out['median_step_ms_after_first']:.1f}), peak {peak:.2f} GB "
          f"(reckoned {out['reckoned_peak_gb']}), FWHT launches/step {fwht}, "
          f"FWHT = plain at {out['fwht_check_shapes']}; {REMAT_EQ_LAYERS} "
          f"layers remat = no remat bit for bit, peak {pk1:.2f} GB with, "
          f"{pk0:.2f} GB without [{smi}]")
    return out


def tp_check_seq_parallel(dev, meshes):
    """6c's sequence-parallel check on a rank's state: qwen2-0.5b at full
    width, ``MESH_LAYERS`` deep, this rank's rows of the phase's batch;
    ``lm_loss`` with remat (the stream split over ``model`` between units)
    against ``remat=False``: the loss and every gradient of the rank's
    shards bit for bit, on (2, 2) and (1, 4).  Counts the all-gathers the
    pin adds (a unit's gather forward, each split's backward) and their
    bytes, and the rank's peak with and without."""
    import repro_torch.configs as C
    from repro_torch import generator
    from repro_torch import sharding as shd
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.serve import serve_step
    cfg = mesh_config(C)
    names = convert.leaf_names(cfg)
    whole = convert.jax_leaves(M.init_params(cfg, generator(dev, 0)), cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    glob = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
            for k, v in make_source(data_cfg).global_batch(0).items()}
    seen = {}
    saved = shd.gather_sequence, shd.split_sequence

    def counting(fn, key):
        def call(x, tp):
            # a gather's output, or the whole stream a split's backward
            # gathers back
            seen[key] += 1
            seen[key + "_bytes"] += (x.numel() * x.element_size()
                                     * (tp.size if key == "gather" else 1))
            return fn(x, tp)
        return call

    shd.gather_sequence = counting(saved[0], "gather")
    shd.split_sequence = counting(saved[1], "split")
    out = {}
    try:
        for mk in ("dm22", "dm14"):
            mesh = meshes[mk]
            leaves = convert.shard_leaves(whole, mesh, names)
            tp = convert.model_group(cfg, mesh)
            batch = serve_step.local_batch(mesh, glob)
            res = {}
            for remat in (True, False):
                seen.update(gather=0, gather_bytes=0, split=0, split_bytes=0)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                p = [x.detach().requires_grad_() for x in leaves]
                loss, _ = M.lm_loss(convert.params_from_leaves(p, cfg), cfg,
                                    batch, tp, remat=remat)
                grads = torch.autograd.grad(loss, p, allow_unused=True,
                                            materialize_grads=True)
                _sync()
                res[remat] = (loss.detach(), grads, dict(seen),
                              torch.cuda.max_memory_allocated() / 1e9)
            (l1, g1, c1, pk1), (l0, g0, c0, pk0) = res[True], res[False]
            unequal = [n for n, a, b in zip(names, g1, g0)
                       if not torch.equal(a, b)]
            assert torch.equal(l1, l0) and not unequal, (
                f"6c {mk}: sequence parallel differs from remat=False: loss "
                f"{l1.item()} vs {l0.item()}, gradients {unequal}")
            assert c1["gather"] > 0 and c0["gather"] == c0["split"] == 0, (
                c1, c0)
            out[mk] = {"tp": tp.size, "equal_bit_for_bit": True,
                       "sp_all_gathers": c1["gather"] + c1["split"],
                       "sp_all_gather_bytes": c1["gather_bytes"]
                       + c1["split_bytes"],
                       "peak_gb_sp": pk1, "peak_gb_no_remat": pk0}
            del res, leaves
    finally:
        shd.gather_sequence, shd.split_sequence = saved
    return out


def phase_main_path(dev, C, M, serve_step, coupling, counts,
                    arch="qwen2-0.5b", params=None, wire_kernels=None,
                    extra=None, batch=None, prompt_len=None, gen=None):
    """``arch`` (qwen2-0.5b) at full width through prefill, coded KV,
    greedy decode; ``params`` its weights when the caller drew them
    (else from seed 0).  With ``wire_kernels`` the coded transfer's
    kernels are then held to their plain versions on every KV leaf of
    this path (``check_kv_wire``) and timed at the first leaf's
    shapes.  ``extra``: a modality stub's prefill inputs
    (``image_embeds``, whose positions come first: the context is
    n_front + prompt_len positions; or an enc-dec model's ``memory``,
    which every decode step reads too); ``batch`` x ``prompt_len``
    tokens, ``gen`` decoded (BATCH, PROMPT and GEN by default)."""
    batch, prompt_len = batch or BATCH, prompt_len or PROMPT
    gen = gen or GEN
    cfg = C.get(arch)
    extra = extra or {}
    memory = extra.get("memory")
    n_ctx = cfg.n_front + prompt_len
    if params is None:
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    prefill = functools.partial(serve_step.make_prefill(cfg, n_ctx + gen),
                                **extra)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)

    def signs_gen():
        return torch.Generator(dev).manual_seed(2)

    # warm-up: cuBLAS handles, allocator pools, kernel modules
    _, warm = prefill(params, prompt)
    serve_step.greedy_decode(cfg, params, serve_step.degrade_caches(
        warm, mask, signs_gen()), prompt[:, -1:], n_ctx, 3, memory)
    del warm
    _sync()

    # --- the main path, with the launch counts read around it ---
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, clean = prefill(params, prompt)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    coded = serve_step.degrade_caches(clean, mask, signs_gen())
    _sync()
    degrade_ms = (time.perf_counter() - t0) * 1e3
    err_coded = serve_step.kv_position_error(clean, coded, n_ctx)
    t0 = time.perf_counter()
    coded_toks = serve_step.greedy_decode(cfg, params, coded, first, n_ctx,
                                          gen, memory)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    assert logits.shape == (batch, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits.float()).all(), "non-finite prefill logits"
    assert coded_toks.shape == (batch, gen), coded_toks.shape
    # each K and V leaf is one payload: two FWHTs and one unbias
    n_leaves = len(clean.leaves())
    assert (launches["fwht"] >= 2 * n_leaves
            and launches["masked_unbias"] >= n_leaves), (
        f"main path missed the kernels: {launches} for {n_leaves} leaves")

    # --- the references the main path is checked against ---
    clean_toks = serve_step.greedy_decode(cfg, params, clean.clone(), first,
                                          n_ctx, gen, memory)
    uncoded = serve_step.degrade_caches(clean, mask, coded=False)
    err_uncoded = serve_step.kv_position_error(clean, uncoded, n_ctx)
    uncoded_toks = serve_step.greedy_decode(cfg, params, uncoded, first,
                                            n_ctx, gen, memory)
    full = serve_step.degrade_caches(
        clean, torch.ones(N_ROT, dtype=torch.bool, device=dev), signs_gen())
    err_full = serve_step.kv_position_error(clean, full, n_ctx).max().item()
    assert err_full <= 1e-2, (
        f"full mask is not a bf16-noise round trip: {err_full}")
    assert torch.isfinite(err_coded).all()
    assert torch.isfinite(err_uncoded).all()

    # where the time goes: one profiled call of each stage
    decode = serve_step.make_decode(cfg)
    steps = 4

    def decode_steps():
        caches, tok = full.clone(), first
        for i in range(steps):
            logits, caches = decode(params, caches, tok, n_ctx + i, memory)
            tok = torch.argmax(logits, -1)[:, None]

    profile = {
        "prefill": profile_window(lambda: prefill(params, prompt)),
        "degrade_caches": profile_window(
            lambda: serve_step.degrade_caches(clean, mask, signs_gen())),
        f"decode_{steps}_steps": profile_window(decode_steps)}

    usable_coded = (err_coded <= TAU).float().mean().item()
    usable_uncoded = (err_uncoded <= TAU).float().mean().item()
    assert usable_coded >= usable_uncoded, (usable_coded, usable_uncoded)
    out = {
        "model": cfg.name, "batch": batch, "prompt": prompt_len, "gen": gen,
        "n_ctx": n_ctx, "kv_frac": KV_FRAC,
        "wire_rows_lost": int(N_ROT - mask.sum().item()),
        "prefill_ms": prefill_ms, "degrade_caches_ms": degrade_ms,
        "decode_s": decode_s,
        "decode_tok_per_s": batch * (gen - 1) / decode_s,
        "usable_coded": usable_coded, "usable_uncoded": usable_uncoded,
        "token_agree_coded": (coded_toks == clean_toks).float().mean().item(),
        "token_agree_uncoded":
            (uncoded_toks == clean_toks).float().mean().item(),
        "full_mask_max_err": err_full, "peak_mem_gib": peak_gib,
        "kv_leaves": [list(t.shape) for t in clean.leaves()],
        "launches": launches, "profile": profile}
    if wire_kernels is not None:
        code = wire_kernels[-1].plan(clean.leaves()[0].numel(), n_rot=N_ROT)
        signs = wire_kernels[-1].rademacher(signs_gen(), code)
        out["wire_check"] = check_kv_wire(f"serve {cfg.name}", clean, mask,
                                          signs, *wire_kernels, timed=True)
    print(f"{cfg.name} prefill {batch}x{prompt_len} ({n_ctx} positions): "
          f"{prefill_ms:.2f} ms; coded KV transfer: {degrade_ms:.2f} ms; "
          f"decode: {batch * (gen - 1)} tokens in {decode_s:.3f} s = "
          f"{out['decode_tok_per_s']:.1f} tok/s")
    print(f"usable context (err <= {TAU}): coded {usable_coded:.4f}, "
          f"uncoded {usable_uncoded:.4f}; token agreement with clean: coded "
          f"{out['token_agree_coded']:.4f}, uncoded "
          f"{out['token_agree_uncoded']:.4f}; launches {launches}")
    for stage, rec in profile.items():
        print(f"profile {stage}: {rec}")
    if wire_kernels is not None:
        wire = out["wire_check"]
        print(f"{cfg.name} KV leaves {out['kv_leaves']}: kernels vs plain "
              f"max abs err {wire['max_abs_err']} at {wire['shapes']}")
    return out


# the smoke-size card-vs-CPU runs: (arch, prompt length); gemma2's and
# recurrentgemma's prompts are longer than their 64-token smoke window,
# so their ring caches wrap
SMALL_REFERENCE = (("qwen2-0.5b", 16), ("gemma2-9b", 80),
                   ("chatglm3-6b", 16), ("nemotron-4-15b", 16),
                   ("qwen2-moe-a2.7b", 16), ("granite-moe-3b-a800m", 16),
                   ("recurrentgemma-9b", 80), ("xlstm-350m", 16),
                   ("phi-3-vision-4.2b", 16), ("seamless-m4t-medium", 16))


def phase_small_reference(dev, C, M, serve_step):
    """Smoke-size models in float32 (``SMALL_REFERENCE``): the card
    (kernels) against the CPU (plain versions), same weights, prompt,
    frontend inputs, mask and signs: logits and every degraded KV leaf
    within 2e-4, the greedy tokens identical (a modality stub's through
    ``greedy_generate(extra=)``: the image positions first, the memory at
    every step)."""
    cpu = torch.device("cpu")
    mask = torch.rand(N_ROT,
                      generator=torch.Generator(cpu).manual_seed(3)) < 0.8
    signs = torch.randint(0, 2, (N_ROT,),
                          generator=torch.Generator(cpu).manual_seed(4)
                          ).float() * 2 - 1
    for arch, plen in SMALL_REFERENCE:
        cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
        params = M.init_params(cfg, torch.Generator(cpu).manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size, (2, plen),
                               generator=torch.Generator(cpu).manual_seed(1))
        extra = serve_step.frontend_inputs(
            cfg, 2, plen, torch.Generator(cpu).manual_seed(3))
        res = []                             # the CPU's, then the card's
        for d in (cpu, dev):
            p = {k: v.to(d) for k, v in params.items()}
            ex = {k: v.to(d) for k, v in extra.items()}
            logits, caches = serve_step.make_prefill(
                cfg, cfg.n_front + plen + 8)(p, prompt.to(d), **ex)
            deg = serve_step.degrade_caches(caches, mask.to(d),
                                            signs=signs.to(d))
            toks = serve_step.greedy_generate(cfg, p, prompt.to(d), 6,
                                              extra=ex)
            res.append([t.cpu() for t in (toks, logits, *deg.leaves())])
        for i, (a, b) in enumerate(zip(res[0][1:], res[1][1:])):
            what = "logits" if i == 0 else f"degraded KV leaf {i - 1}"
            check(f"smoke {arch} {what} card vs cpu", b, a, 2e-4, 2e-4)
        assert torch.equal(res[0][0], res[1][0]), (
            f"smoke {arch} greedy tokens")
        print(f"smoke {arch} f32 ({plen}-token prompt, KV leaves "
              f"{[list(t.shape) for t in res[0][2:]]}), card vs CPU: "
              "logits, degraded caches, greedy tokens agree")


# ----------------------------------------------------------------------
# The transport engine (the DCQCN scan kernel, Figs. 1-3)
# ----------------------------------------------------------------------

# the scan's check shapes: the Fig.-1 schedule's one block (128 nodes x
# 60 rounds of 254 steps), a Fig.-3 block (4 seeds x 2 rounds of 2,046
# steps x 1,024 nodes) and a ragged one; the CNP densities run as the
# seeds of one call (the seeds of a block are independent)
SCAN_SHAPES = ((1, 15_240, 128), (4, 4_092, 1_024), (3, 257, 33))
SCAN_DENSITIES = (0.0, 0.001, 0.05, 1.0)
# H100 SXM float64 rate outside the tensor cores (NVIDIA data sheet), for
# the scan's operation count
F64_OPS = 34e12
# The scan's chain: only the active steps (a mark anywhere in the seed)
# depend on each other; a calm cell is a closed form of its gap's anchor,
# and (1 - alpha_g)^L of a gap is known from any_t before the walk.  The
# dependent latency of one active step's state update, in SM cycles, from
# the walk's operations (csrc/dcqcn.cu) at 4 cycles an int or select op
# and 8 a conversion or float64 op (Hopper's FP64 units).  After a calm
# gap (L > 0): the gap index k from good (3 int ops, 12), the additive
# ramp (conversion, mul, add, min, select: 36) and the hyper ramp on it
# (add, min, select: 20), then the cut on the new rate (mul, max, select,
# max, min: 36): 104; alpha's mul by the gap's pow, mul, add, select, mul
# by 0.5 and sub (48) run beside the ramp.  Right after another active
# step (L = 0) the ramp is the identity: alpha's mul, add, select, mul by
# 0.5, sub (36), then the cut (36): 72.  The chain bound is the largest
# (gap steps x 104 + run steps x 72) of any seed / the SM clock; the
# block's bound is the larger of it, the bytes bound and the operations
# bound, with this block's own marks.  The earlier design walked every
# step on one thread, with libdevice's pow (~288 cycles) and a division
# (~80) on each marked step: --ab-dcqcn times it beside this one.
SCAN_GAP_CYCLES, SCAN_RUN_CYCLES = 104, 72
# the real blocks whose plain-version check covers only their first
# PLAIN_PREFIX_STEPS steps (the kernel still runs and is timed on the
# whole block): the legacy Fig.-2 pass's 76,200 steps, the step window's
# 32,766 and Fig. 4's 8-pod 25,400 took ~101 s of the plain loop on an
# H100 80GB HBM3 (700 W) whole
PLAIN_PREFIX_BLOCKS = ("fig2 legacy", "fig2 step", "fig4 p8 o8")
PLAIN_PREFIX_STEPS = 8192
ENGINE_CHECK_ROUNDS, FIG2_ROUNDS = 40, 300          # 128 nodes
# the sequential reference against the batched engine
# (fig2_tail_latency.py:50-72): the speedup's bar, and the committed
# speedup, which is a ratio of two walls of another machine
SEQ_SPEEDUP_BAR, SEQ_SPEEDUP_COMMITTED = 10.0, 14.6
# dcqcn.rate_trace on the card: the legacy Fig.-2 marks' first steps
# (the plain version is a host-bound loop of ~65 launches a step), as
# (T, channel, flow), and a density-1 trace
RATE_TRACE_STEPS, RATE_TRACE_DENSE = 2048, (2048, 2, 64)
FIG3_NODES, FIG3_SEEDS, FIG3_ROUNDS, FIG3_MB = 1024, (0, 1, 2, 3), 120, 25.0
FIG1_NODES, FIG1_ROUNDS, FIG1_STEPS = 128, 60, 60
FIG1_REGIMES = {"light": 1.0, "paper": 0.6, "heavy": 0.4}
FIG1_RECOVERY_BAR = 0.9


def scan_state(S, n, dev):
    return (torch.ones(S, n, dtype=torch.float64, device=dev),
            torch.ones(S, n, dtype=torch.float64, device=dev),
            torch.ones(S, n, dtype=torch.float64, device=dev),
            torch.zeros(S, n, dtype=torch.int32, device=dev))


def engine_block_marks(E, ET, params, n_rounds, seeds, dev, plan=None):
    """The CNP marks of the first block of an ``n_rounds`` engine run, one
    per seed, from the host pass (the marks the scan sees on the main
    path)."""
    eng = E.BatchedEngine(params, device=str(dev), plan=plan)
    ctx = ET._Plan(eng)
    tb = min(max(1, E._BLOCK_ELEMENTS // (ctx.steps * ctx.n)),
             n_rounds) * ctx.steps
    cnp = [ET._host_block(eng, ET._SeedStreams(eng, s, ["celeris"],
                                               ctx.incast), ctx,
                          0, tb, ["celeris"])["cnp"] for s in seeds]
    return torch.from_numpy(np.stack(cnp)).to(dev)


def legacy_fig2_marks(E, ET, P, n_rounds, dev):
    """The Fig.-2 protocol's legacy pass at 128 nodes: its stacked CNP
    channels (roce, sr, celeris) ``(3, T, 128)`` from the host pass, and
    the step mask the engine gives the scan, the OR over every channel
    and flow, repeated per channel."""
    eng = E.BatchedEngine(P.SimParams(), device=str(dev))
    ctx = ET._Plan(eng)
    host = ET._legacy_host(eng, ctx, list(E.designs.DESIGNS),
                           n_rounds * ctx.steps, 0)
    cnp = torch.from_numpy(host["cnp"]).to(dev)
    C, T, _ = cnp.shape
    return cnp, cnp.any(-1).any(0).expand(C, T).contiguous()


def real_scan_blocks(E, ET, P, topology, dev):
    """The scan's inputs on the engine's paths, ``{name: (cnp, any_t)}``:
    the first block of the Fig.-1 schedule (1, 15,240, 128) and of Fig.
    3's cell (4, 4,092, 1,024); the hierarchical paths' blocks, where the
    DCI tier marks far more steps: Fig. 7's hier schedule on 4 pods,
    Fig. 4's ring over 8 pods at oversubscription 8 and Fig. 6's hier
    schedule at 1,024 nodes and oversubscription 8 (1, 3,612, 1,024); Fig.
    8's KV incast pass (1, 2,400, 128); Fig. 10's hier cells on 4 pods at
    oversubscription 8 and each of its node counts; Fig. 9's 2-pod NIC
    stall cell; the shared-fabric pass of Fig. 2's step window (300
    rounds, so a longer block than Fig. 1's); and the legacy Fig.-2
    pass's three channels with their shared step mask.  (Fig. 9's flat
    cell is Fig. 1's block: the same fabric, rounds and seed.)"""
    from repro_torch.benchmarks import figs
    from repro_torch.serve import traffic
    kv_params, kv_plan = figs.fig8_params(traffic.ServeTrafficParams(
        **figs.FIG8_TP))
    f6 = figs.FIG6
    blocks = {       # name: (params, rounds, seeds, plan override)
        "fig1": (P.SimParams(net=P.NetworkParams(n_nodes=FIG1_NODES)),
                 FIG1_ROUNDS, [0], None),
        "fig3": (P.SimParams(net=P.NetworkParams(n_nodes=FIG3_NODES)),
                 FIG3_ROUNDS, list(FIG3_SEEDS), None),
        "fig7 hier": (topology.hier_params(
            FIG7_PODS, schedule="hier", dci_oversubscription=FIG7_OVERSUB),
            FIG7_ROUNDS, [0], None),
        "fig4 p8 o8": (topology.hier_params(
            FIG4_PODS[-1], n_nodes=FIG4_NODES,
            dci_oversubscription=FIG4_OVERSUBS[-1]), FIG4_ROUNDS, [0], None),
        "fig6 hier n1024 o8": (topology.hier_params(
            f6.pods, n_nodes=f6.nodes[-1], schedule="hier",
            dci_oversubscription=f6.oversubs[-1]), f6.n_rounds, [0], None),
        "fig8 kv": (kv_params, figs.FIG8_ROUNDS, [0], kv_plan),
        **{f"fig10 hier n{nn} o8": (topology.hier_params(
            figs.FIG10_PODS, n_nodes=nn, dci_oversubscription=8.0,
            schedule="hier"), figs.FIG10_ROUNDS, [0], None)
           for nn in figs.FIG10_NODES},
        "fig9 stall": (figs.fig9_fault_params(),
                       figs.FIG9_FAULT_CELL["n_rounds"], [1], None),
        "fig2 step": (P.SimParams(), FIG2_ROUNDS, [0], None)}
    out = {}
    for name, (params, rounds, seeds, plan) in blocks.items():
        cnp = engine_block_marks(E, ET, params, rounds, seeds, dev, plan)
        out[name] = (cnp, cnp.any(-1))
    out["fig2 legacy"] = legacy_fig2_marks(E, ET, P, FIG2_ROUNDS, dev)
    return out


def scan_pair(kdcqcn, ref, dq, cnp, state, any_t=None):
    """The kernel and its plain version on the same block; equal bit for
    bit in the rates and all four state arrays.  ``any_t`` defaults to
    each seed's own mask.  Returns the kernel's result and the plain
    version's device ms (CUDA events, one call: it is a host-bound loop of
    ~65 launches a step)."""
    if any_t is None:
        any_t = cnp.any(-1)
    got = kdcqcn.dcqcn_scan_cuda(cnp, any_t, *state, dq)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = ref.dcqcn_scan(cnp, any_t, *state, dq)
    end.record()
    end.synchronize()
    check_equal(f"dcqcn_scan {tuple(cnp.shape)}", (got[0],) + got[1],
                (want[0],) + want[1])
    return got, start.elapsed_time(end)


def sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def scan_bounds(cnp, any_t):
    """The scan's bound on this block's marks, ``(bound_ms, bound_by,
    parts)``: the larger of the bytes (marks 1 B a cell and any_t read
    once, rates 4 B a cell written once, the state of 3 float64 + 1 int32
    a flow read and written once), the operations (~20 float64 a cell on
    an active step, ~12 float32 on a calm one) and the chain (each seed's
    active steps at SCAN_GAP_CYCLES after a calm gap, SCAN_RUN_CYCLES
    right after another active step, the slowest seed at the SM clock)."""
    S, tb, n = cnp.shape
    active = int(any_t.sum())
    t_bytes = (S * tb * n * 5 + S * tb + 2 * S * n * 28) / HBM_BPS * 1e3
    t_ops = (active * n * 20 / F64_OPS
             + (S * tb - active) * n * 12 / F32_OPS) * 1e3
    clock = sm_clock_hz()
    # an active step opens a run unless the step before it was active
    # (step 0 has no gap before it either)
    gap = any_t.clone()
    gap[:, 0] = False
    gap[:, 1:] &= ~any_t[:, :-1]
    cycles = (gap.sum(1) * SCAN_GAP_CYCLES
              + (any_t & ~gap).sum(1) * SCAN_RUN_CYCLES)
    t_chain = int(cycles.max()) / clock * 1e3
    bound = max(t_bytes, t_ops, t_chain)
    by = "bytes" if t_bytes == bound else "operations"
    return bound, by, {"bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
                       "chain_bound_ms": t_chain, "sm_clock_mhz": clock / 1e6}


def scan_prefix(kdcqcn, ref, dq, cnp, any_t, steps=PLAIN_PREFIX_STEPS):
    """The plain version on a long block's first ``steps`` steps only: the
    kernel on that prefix equals it bit for bit (rates and the four state
    arrays), and, the scan being causal, the kernel's rates over the
    whole block begin with the prefix's, bit for bit.  Returns the plain
    version's ms over the prefix."""
    state = scan_state(cnp.shape[0], cnp.shape[2], cnp.device)
    whole = kdcqcn.dcqcn_scan_cuda(cnp, any_t, *state, dq)
    (rates, _), plain_ms = scan_pair(
        kdcqcn, ref, dq, cnp[:, :steps].contiguous(),
        scan_state(cnp.shape[0], cnp.shape[2], cnp.device),
        any_t=any_t[:, :steps].contiguous())
    check_equal(f"dcqcn_scan {tuple(cnp.shape)}'s first {steps} steps vs "
                "the prefix's", (whole[0][:, :steps],), (rates,))
    return plain_ms


def scan_record(kdcqcn, dq, cnp, plain_ms, shape_note, any_t=None,
                plain_steps=None):
    """The scan's timing record on a block's marks (``any_t`` defaults to
    each seed's own mask); ``plain_steps``: the steps ``plain_ms``
    covers, the whole block by default."""
    S, tb, n = cnp.shape
    if any_t is None:
        any_t = cnp.any(-1)
    state = scan_state(S, n, cnp.device)
    ms = time_ms(lambda: kdcqcn.dcqcn_scan_cuda(cnp, any_t, *state, dq))
    bound, by, parts = scan_bounds(cnp, any_t)
    return {
        "name": "dcqcn_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dcqcn.cu",
        "replaces": "src/repro/core/transport/engine_jax.py:88 "
                    "(_dcqcn_scan, a lax.scan: no Pallas counterpart)",
        "shape": [S, tb, n], "dtype": "bool -> float32", "marks": shape_note,
        "active_step_share": float(any_t.float().mean()), "max_abs_err": 0.0,
        "max_active_steps": int(any_t.sum(1).max()),
        "ms": ms, "ns_per_step": ms * 1e6 / tb, "plain_ms": plain_ms,
        "plain_steps": plain_steps or tb,
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms, **parts,
        "library_ms": None, "library": "none: no PyTorch call computes a scan"}


def phase_dcqcn_kernel(dev, kdcqcn, ref, E, ET, P, topology):
    """The DCQCN scan kernel against its plain version on the card, bit
    for bit (rates and the four state arrays): at SCAN_SHAPES with the
    four densities as seeds, on the marks each engine path's first block
    draws (:func:`real_scan_blocks`; the three longest, in
    PLAIN_PREFIX_BLOCKS, over their first PLAIN_PREFIX_STEPS steps,
    :func:`scan_prefix`), and over two consecutive blocks,
    whose carried state must equal the plain version's and, split where
    every seed has a mark, one long block's.  Timed on every real block,
    beside its bound."""
    dq = P.DcqcnParams()
    g = torch.Generator(dev).manual_seed(11)
    real = real_scan_blocks(E, ET, P, topology, dev)
    records, checks = [], 0
    for S, tb, n in SCAN_SHAPES:
        # the four densities as four seeds, and the ragged shape also at
        # its own seed count
        sets = [SCAN_DENSITIES]
        if 1 < S < len(SCAN_DENSITIES):
            sets.append(SCAN_DENSITIES[-S:])
        for dens in sets:
            u = torch.rand(len(dens), tb, n, generator=g, device=dev)
            synth = u < torch.tensor(dens, device=dev)[:, None, None]
            scan_pair(kdcqcn, ref, dq, synth, scan_state(len(dens), n, dev))
            checks += 1
    for name, (cnp, any_t) in real.items():
        # the plain version is a host-bound loop of ~65 launches a step
        # (~50 s over the legacy pass's 76,200 steps): the longest blocks
        # hold it to their first PLAIN_PREFIX_STEPS steps
        prefix = name in PLAIN_PREFIX_BLOCKS
        if prefix:
            plain_ms = scan_prefix(kdcqcn, ref, dq, cnp, any_t)
        else:
            _, plain_ms = scan_pair(kdcqcn, ref, dq, cnp,
                                    scan_state(*cnp.shape[::2], dev),
                                    any_t=any_t)
        checks += 1
        records.append(scan_record(
            kdcqcn, dq, cnp, plain_ms, f"a real {name} block's", any_t=any_t,
            plain_steps=PLAIN_PREFIX_STEPS if prefix else None))
    # two consecutive blocks against the plain version, and against one
    # long block where the split step has a mark in every seed (there
    # both materialize the same anchor; elsewhere a calm gap cut in two
    # ramps in two closed forms, which round apart by an ulp)
    cnp, any_t = real["fig3"]
    tb = cnp.shape[1]
    cand = torch.nonzero(any_t.all(0)).flatten().tolist()
    split = next((i for i in cand if i >= tb // 2), tb // 2)
    st0 = scan_state(cnp.shape[0], cnp.shape[2], dev)
    (ra, sa), _ = scan_pair(kdcqcn, ref, dq, cnp[:, :split].contiguous(),
                            st0)
    (rb, sb), _ = scan_pair(kdcqcn, ref, dq, cnp[:, split:].contiguous(), sa)
    long = kdcqcn.dcqcn_scan_cuda(cnp, any_t, *st0, dq)
    two = (torch.cat([ra, rb], 1),) + sb
    exact = bool(any_t[:, split].all())
    if exact:
        check_equal(f"dcqcn two blocks split at {split} vs one", two,
                    (long[0],) + long[1])
    else:
        for x, y in zip(two, (long[0],) + long[1]):
            check(f"dcqcn two blocks vs one (calm split {split})", x, y,
                  1e-12 if x.dtype == torch.float64 else 1e-6, 0.0)
    rate_trace = rate_trace_check(dev, kdcqcn, ref, dq,
                                  real["fig2 legacy"][0])
    _sync()
    print(f"dcqcn_scan: kernel == plain version bit for bit in {checks + 2} "
          f"blocks (densities {SCAN_DENSITIES} as seeds at {SCAN_SHAPES}; "
          f"the real blocks {sorted(real)}); "
          f"two blocks split at step {split} "
          f"{'==' if exact else '~='} one long block")
    for rec in records:
        print(f"kernel dcqcn_scan {rec['shape']} ({rec['marks']} marks): "
              f"{rec['ms']:.4f} ms = {rec['ns_per_step']:.1f} ns a step "
              f"(plain {rec['plain_ms']:.1f} ms over its first "
              f"{rec['plain_steps']} steps; bound "
              f"{rec['bound_ms']:.5f} by {rec['bound_by']} = "
              f"{rec['bound_share']:.3f} of the kernel: "
              f"bytes {rec['bytes_bound_ms']:.5f}, chain "
              f"{rec['chain_bound_ms']:.5f} over {rec['max_active_steps']} "
              f"active steps; active share {rec['active_step_share']:.3f})")
    return records, rate_trace


def rate_trace_check(dev, kdcqcn, ref, dq, legacy):
    """``dcqcn.rate_trace`` on the card against the scan's plain version
    on the same marks, bit for bit in the rates and the four state arrays,
    one scan launch a call: the legacy Fig.-2 pass's first
    RATE_TRACE_STEPS steps ((T, 3 channels, 128), one seed whose steps
    are active where any channel's flow is marked), then its next steps
    from the state the first call left, and a density-1 trace.  Returns
    the path's record; its launches are those of the rate_trace calls."""
    from repro_torch.core.transport import dcqcn
    marks = legacy.permute(1, 0, 2)
    n = RATE_TRACE_STEPS
    traces = [("fig2 legacy, first steps", marks[:n], None),
              ("fig2 legacy, next steps", marks[n:2 * n], "carry"),
              ("density 1", torch.ones(RATE_TRACE_DENSE, dtype=torch.bool,
                                       device=dev), None)]
    launches, out, carry = 0, [], None
    for name, cnp, start in traces:
        state = carry if start == "carry" else None
        kdcqcn.launches = 0
        rates, st = dcqcn.rate_trace(cnp, dq, state)
        assert kdcqcn.launches == 1, (name, kdcqcn.launches)
        launches += kdcqcn.launches
        T = cnp.shape[0]
        flat = cnp.reshape(1, T, -1).contiguous()
        init = (scan_state(1, flat.shape[2], dev) if state is None else
                tuple(x.reshape(1, -1).contiguous() for x in (
                    state.rate, state.target, state.alpha,
                    state.good_stages)))
        want, wst = ref.dcqcn_scan(flat, flat.any(2), *init, dq)
        check_equal(f"rate_trace {name} {tuple(cnp.shape)}",
                    (rates, st.rate, st.target, st.alpha, st.good_stages),
                    (want.reshape(cnp.shape),) + tuple(
                        x.reshape(cnp.shape[1:]) for x in wst))
        assert rates.dtype == torch.float32 and st.rate.dtype == torch.float64
        out.append({"trace": name, "shape": list(cnp.shape),
                    "active_steps": int(flat.any(2).sum())})
        carry = st
    launches = {"fwht": 0, "fwht_quantize": 0, "masked_unbias": 0,
                "quantize_int8": 0, "dcqcn_scan": launches}
    print(f"rate_trace: == the scan's plain version bit for bit (rates and "
          f"the four state arrays) on {out}; one scan launch a call")
    return {"traces": out, "launches": launches}


def phase_engine_card_vs_cpu(dev, E, P):
    """The Fig.-2 protocol at 128 nodes x ENGINE_CHECK_ROUNDS, all four
    designs, on the card and on the CPU (plain scan), in both stream
    modes: the traces, ``paper_protocol`` and, in legacy mode, ``run``
    per design (each its own channel set, so its own step mask).
    Delivered packets per step exact; step times, each design's times,
    p99 and recv_frac within rtol 1e-5."""
    out = {}
    for legacy in (False, True):
        runs = []
        for d in (dev, torch.device("cpu")):
            eng = E.BatchedEngine(P.SimParams(), device=str(d))
            tr = eng.traces(E.designs.DESIGNS, ENGINE_CHECK_ROUNDS, 0,
                            legacy_streams=legacy)
            stats = {"pp": eng.paper_protocol(ENGINE_CHECK_ROUNDS, 0,
                                              legacy_streams=legacy)}
            if legacy:
                stats["run"] = {
                    name: eng.run(name, ENGINE_CHECK_ROUNDS, seed=0,
                                  adaptive=False)
                    for name in E.designs.DESIGNS}
            runs.append((tr, stats))
        (tr_d, st_d), (tr_c, st_c) = runs
        worst = 0.0
        for name in E.designs.DESIGNS:
            a, b = tr_d[name], tr_c[name]
            for f in ("deliv", "total", "tier_deliv"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), (
                    legacy, name, f)
            pairs = [(a.nat_us, b.nat_us, "step times")]
            for kind in st_d:
                x, y = st_d[kind][name], st_c[kind][name]
                pairs += [(x.times_us, y.times_us, f"{kind} times"),
                          (x.p99, y.p99, f"{kind} p99"),
                          (x.recv_frac, y.recv_frac, f"{kind} recv_frac")]
            for x, y, what in pairs:
                np.testing.assert_allclose(
                    x, y, rtol=1e-5, atol=0,
                    err_msg=f"legacy={legacy} {name} {what} card vs cpu")
                worst = max(worst, float(np.max(np.abs(np.asarray(x) - y)
                                                / np.abs(y))))
        mode = "legacy" if legacy else "shared"
        print(f"engine card vs CPU ({mode} streams), 128 nodes x "
              f"{ENGINE_CHECK_ROUNDS} rounds: delivered packets per step "
              f"equal, worst relative difference of times/p99/recv_frac "
              f"{worst:.3g}" + (" (traces, paper_protocol, run x 4)"
                                if legacy else ""))
        out[mode] = {"worst_rel_diff": worst,
                     "p99_us": {d: x.p99 for d, x in st_d["pp"].items()}}
    return out


def phase_fig2(dev, E, P, figs, counts, seq_children):
    """Fig. 2 on the card: the paper protocol at 128 nodes x 300 rounds
    (benchmarks/fig2_tail_latency.py) through ``CollectiveSimulator``, in
    its legacy-stream mode (one scan call over the whole trace), held to
    the committed ``fig2_*`` keys at their printed digits; then the
    beyond-paper adaptive per-step window (``figs.fig2_step_window``: the
    shared fabric, 3 blocks, Celeris's per-flow arrays copied back) held
    to the committed ``fig2_beyond_step_window_reduction`` against the
    same run's RoCE p99; then the shared-fabric paper protocol beside it
    (3 engine blocks), held to RoCE p99 above Celeris's."""
    from repro_torch.core.transport.simulator import CollectiveSimulator
    sim = CollectiveSimulator(P.SimParams(), device=str(dev))
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    stats = sim.paper_protocol(FIG2_ROUNDS, 0)
    wall = time.perf_counter() - t0
    launches = counts.read()
    timing = dict(sim._engine.timing)
    assert launches["dcqcn_scan"] == timing["blocks"] == 1, launches
    for st in stats.values():
        assert np.isfinite(st.times_us).all() and st.times_us.shape == (
            FIG2_ROUNDS,)
        assert ((0 < st.recv_frac) & (st.recv_frac <= 1)).all()
    out = {d: {"p50_ms": st.p50 / 1e3, "p99_ms": st.p99 / 1e3,
               "p999_ms": st.p999 / 1e3, "loss": st.mean_loss}
           for d, st in stats.items()}
    ratio = stats["roce"].p99 / stats["celeris"].p99
    # the keys benchmarks/fig2_tail_latency.py commits, rounded as it
    # rounds them
    got = {f"p99_ms_{d}": round(st.p99 / 1e3, 2) for d, st in stats.items()}
    got["p99_reduction"] = round(ratio, 2)
    got["celeris_loss_pct"] = round(stats["celeris"].mean_loss * 100, 2)
    want = {k: committed(f"fig2_{k}") for k in got}
    assert got == want, (
        f"fig2 differs from the committed keys: {got} vs {want}")
    # and the pre-refactor sequential simulator's recorded stats, at
    # tests/test_batched_engine.py's tolerances
    with open(SEQ_STATS) as f:
        seq = json.load(f)
    for d, st in stats.items():
        assert abs(st.p50 / seq[d]["p50_us"] - 1) < 0.01, d
        assert abs(st.p99 / seq[d]["p99_us"] - 1) < 0.05, d
        assert abs(st.mean_loss - seq[d]["data_loss"]) < 0.005, d
    rec = {"designs": out, "roce_celeris_p99_ratio": ratio,
           "committed_keys_equal": want, "wall_s": wall,
           "host_s": timing["host_s"], "device_s": timing["device_s"],
           "launches": launches}
    print(f"fig2 128 nodes x {FIG2_ROUNDS} rounds on the card (legacy "
          f"streams): {got} == the committed fig2_* keys, and within 1 / 5 "
          f"% (p50 / p99) of the sequential simulator's; wall {wall:.2f} s "
          f"= host draws {rec['host_s']:.2f} s + device core "
          f"{rec['device_s']:.2f} s (+ assembly); launches {launches}")
    rec["sequential"] = fig2_sequential_check(P, figs, counts, wall,
                                              stats["roce"].p99, seq_children)

    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    step_keys, step_st, step_timing = figs.fig2_step_window(
        dev, stats["roce"].p99)
    step_wall = time.perf_counter() - t0
    step_launches = counts.read()
    assert step_launches["dcqcn_scan"] == step_timing["blocks"] == 3, (
        step_launches)
    assert np.isfinite(step_st.times_us).all()
    n = assert_committed("fig2 step window", step_keys)
    assert n == 1 and step_keys == {
        "fig2_beyond_step_window_reduction": 3.85}, step_keys
    rec["step_window"] = {
        "keys": step_keys, "p99_ms": step_st.p99 / 1e3,
        "loss": step_st.mean_loss, "wall_s": step_wall,
        "host_s": step_timing["host_s"], "device_s": step_timing["device_s"],
        "node_bytes": step_timing["node_bytes"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": step_launches}
    print(f"fig2 adaptive per-step window (shared fabric, 128 nodes x "
          f"{FIG2_ROUNDS} rounds): {step_keys} == the committed key (celeris "
          f"p99 {step_st.p99 / 1e3:.3f} ms, loss {step_st.mean_loss:.6f}); "
          f"wall {step_wall:.2f} s = host {step_timing['host_s']:.2f} s + "
          f"device {step_timing['device_s']:.2f} s (+ assembly); per-node "
          f"copies {step_timing['node_bytes']} B; peak "
          f"{rec['step_window']['peak_mem_gib']:.2f} GiB; launches "
          f"{step_launches}")

    eng = E.BatchedEngine(P.SimParams(), device=str(dev))
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    shared = eng.paper_protocol(FIG2_ROUNDS, 0, legacy_streams=False)
    s_wall = time.perf_counter() - t0
    s_launches = counts.read()
    assert s_launches["dcqcn_scan"] == eng.timing["blocks"] == 3, s_launches
    s_ratio = shared["roce"].p99 / shared["celeris"].p99
    assert s_ratio > 1.0, f"RoCE p99 not above Celeris's: {s_ratio}"
    rec["shared"] = {
        "p99_ms": {d: st.p99 / 1e3 for d, st in shared.items()},
        "celeris_loss": shared["celeris"].mean_loss,
        "roce_celeris_p99_ratio": s_ratio, "wall_s": s_wall,
        "host_s": eng.timing["host_s"], "device_s": eng.timing["device_s"],
        "launches": s_launches}
    print(f"fig2 shared-fabric mode: p99 ms {rec['shared']['p99_ms']}, "
          f"RoCE/Celeris {s_ratio:.3f}; wall {s_wall:.2f} s = host "
          f"{rec['shared']['host_s']:.2f} s + device "
          f"{rec['shared']['device_s']:.2f} s; launches {s_launches}")
    return rec


def fig2_sequential_check(P, figs, counts, engine_wall, roce_p99, children):
    """Fig. 2's A/B against the sequential reference loop
    (``figs.fig2_sequential``, host numpy, no device) on the host of the
    card: its four designs at 128 nodes x FIG2_ROUNDS as single-threaded
    child processes (``children``, started before the engine's check;
    RoCE, IRN and SRNIC at once, then Celeris at RoCE's window), while
    the script runs nothing else.  Each design's
    statistics equal the recorded pre-refactor ones exactly;
    ``fig2_ab_p99_ratio_roce`` (the engine's RoCE p99 over the loop's)
    equals the committed key; ``fig2_engine_speedup_x`` (the four runs'
    summed seconds over the engine's wall) is at least its bar; no kernel
    launched, in this process or in the children."""
    counts.reset()
    t0 = time.perf_counter()
    keys, stats, seconds, launches = figs.fig2_sequential(
        P.SimParams(), FIG2_ROUNDS, 0, engine_wall, roce_p99,
        children=children)
    cost = time.perf_counter() - t0
    here = counts.read()
    assert not any(launches.values()) and not any(here.values()), (
        launches, here)
    with open(SEQ_STATS) as f:
        recorded = json.load(f)
    for d, st in stats.items():
        got = {"p50_us": st.p50, "p99_us": st.p99, "p999_us": st.p999,
               "mean_us": float(st.times_us.mean()),
               "data_loss": st.mean_loss}
        assert got == recorded[d], (d, got, recorded[d])
    ratio = keys["fig2_ab_p99_ratio_roce"]
    assert ratio == committed("fig2_ab_p99_ratio_roce") == 1.005, keys
    speedup = keys["fig2_engine_speedup_x"]
    assert speedup >= SEQ_SPEEDUP_BAR, keys
    smi = card_name_and_power()
    print(f"fig2 sequential reference (host numpy, no device; 128 nodes x "
          f"{FIG2_ROUNDS} rounds): every design's p50/p99/p999/mean/loss == "
          f"the recorded pre-refactor stats; fig2_ab_p99_ratio_roce {ratio} "
          f"== committed; fig2_sequential_wall_s "
          f"{keys['fig2_sequential_wall_s']} (the four runs' own seconds "
          f"{ {d: round(v, 2) for d, v in seconds.items()} }, summed; they "
          f"ran overlapped in {len(seconds)} single-threaded processes on "
          f"a host of {os.cpu_count()} cores, {cost:.2f} s of the "
          f"script's wall) over the engine's wall {engine_wall:.2f} s = "
          f"fig2_engine_speedup_x {speedup} (bar {SEQ_SPEEDUP_BAR}; "
          f"committed {SEQ_SPEEDUP_COMMITTED}, of another machine); kernel "
          f"launches {launches} [{smi}]")
    return {"keys": keys, "seconds": seconds, "engine_wall_s": engine_wall,
            "script_wall_s": cost, "host_cores": os.cpu_count(),
            "launches": here, "child_launches": launches,
            "p99_ms": {d: st.p99 / 1e3 for d, st in stats.items()},
            "card": smi}


def phase_fig3(dev, E, ET, P, counts):
    """Fig. 3's largest cell on the card: traces_batched at 1,024 nodes,
    seeds 0-3, FIG3_ROUNDS rounds of 25 MB in one batched pass (60
    blocks), then each seed assembled by the paper protocol."""
    p = P.SimParams(net=P.NetworkParams(n_nodes=FIG3_NODES),
                    work=P.WorkloadParams(
                        message_bytes=int(FIG3_MB * 2 ** 20)))
    eng = E.BatchedEngine(p, device=str(dev))
    designs = list(E.designs.DESIGNS)
    # the device busy share over one block (a fresh pass of 2 rounds)
    busy = profile_window(lambda: ET.traces_batched(
        eng, designs, 2, list(FIG3_SEEDS)))
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    trs = ET.traces_batched(eng, designs, FIG3_ROUNDS, list(FIG3_SEEDS))
    traced = time.perf_counter() - t0
    launches = counts.read()
    timing = dict(eng.timing)
    assert launches["dcqcn_scan"] == timing["blocks"] == 60, launches
    p99 = {d: [] for d in designs}
    for seed, tr in zip(FIG3_SEEDS, trs):
        base = eng.assemble(tr["roce"], seed)
        to = float(np.percentile(base.times_us, 50) + base.times_us.std())
        for d in designs:
            st = (eng.assemble(tr[d], seed, celeris_timeout_us=to,
                               adaptive=False) if d == "celeris"
                  else eng.assemble(tr[d], seed))
            assert np.isfinite(st.times_us).all()
            p99[d].append(st.p99 / 1e3)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"nodes": FIG3_NODES, "seeds": list(FIG3_SEEDS),
           "rounds": FIG3_ROUNDS, "rounds_cut_from": 120,
           "p99_ms_by_seed": p99, "wall_s": wall, "traces_s": traced,
           "host_s": timing["host_s"], "device_s": timing["device_s"],
           "one_block_profile": busy, "peak_mem_gib": peak,
           "launches": launches}
    print(f"fig3 {FIG3_NODES} nodes x seeds {list(FIG3_SEEDS)} x "
          f"{FIG3_ROUNDS} rounds (of 120: no cut) on the card: p99 ms by "
          f"seed {p99}; wall {wall:.1f} s (traces {traced:.1f} s = host "
          f"draws {timing['host_s']:.1f} s + device core "
          f"{timing['device_s']:.1f} s); one block: {busy}; peak "
          f"{peak:.2f} GiB; launches {launches}")
    return rec


def fig1_trainer(C, ts, Trainer, DataConfig, OptConfig, mode, straggler,
                 dev):
    """fig1_e2e_loss_tolerance.py's trainer: the smoke LM, seq 64, batch
    8, lr 1e-3, warmup 10, leaves of >= 1,024 values coded."""
    cfg = C.get_smoke("qwen2-0.5b")
    return Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=64, global_batch=8,
                                            seed=1),
                   opt_cfg=OptConfig(lr=1e-3, warmup_steps=10,
                                     total_steps=500),
                   celeris=ts.CelerisConfig(mode=mode, min_coded_size=1024),
                   seed=0, straggler=straggler, device=str(dev))


def phase_fig1(dev, C, ts, Trainer, DataConfig, OptConfig, coupling,
               counts):
    """The closed loop (benchmarks/fig1_e2e_loss_tolerance.py): the
    engine's drop schedule at 128 nodes for each regime, and the smoke LM
    trained FIG1_STEPS steps in exact, lossy and lossy_hadamard from it.
    Recovery = the share of exact's loss decrease that lossy_hadamard
    keeps; the paper regime must reach FIG1_RECOVERY_BAR."""
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    hist = fig1_trainer(C, ts, Trainer, DataConfig, OptConfig, "exact",
                        None, dev).run(FIG1_STEPS)
    loss0 = hist["loss"][0]
    final_exact = float(np.mean(hist["loss"][-5:]))
    out = {"loss0": loss0, "final_loss_exact": final_exact, "regimes": {}}
    scheds = {}
    for name, scale in FIG1_REGIMES.items():
        ts0 = time.perf_counter()
        sched = coupling.schedule_from_engine(
            FIG1_ROUNDS, seed=0, n_nodes=FIG1_NODES, timeout_scale=scale,
            device=str(dev))
        sched_s = time.perf_counter() - ts0
        scheds[name] = sched
        finals = {}
        for mode in ("lossy", "lossy_hadamard"):
            h = fig1_trainer(C, ts, Trainer, DataConfig, OptConfig, mode,
                             coupling.EngineStragglerModel(sched),
                             dev).run(FIG1_STEPS)
            assert h["drop_rate"] == list(sched.rates[:FIG1_STEPS])
            assert np.isfinite(h["loss"]).all(), (name, mode)
            finals[mode] = float(np.mean(h["loss"][-5:]))
        rec = (loss0 - finals["lossy_hadamard"]) / max(loss0 - final_exact,
                                                       1e-9)
        out["regimes"][name] = {
            "timeout_scale": scale, "drop_mean": sched.mean,
            "drop_p99": sched.p99, "source": sched.source,
            "schedule_s": sched_s, "final_loss_lossy": finals["lossy"],
            "final_loss_lossy_hadamard": finals["lossy_hadamard"],
            "recovery": rec}
        print(f"fig1 {name} (window x{scale}): mean drop {sched.mean:.4f} "
              f"(schedule {sched_s:.2f} s); final loss lossy "
              f"{finals['lossy']:.4f}, lossy_hadamard "
              f"{finals['lossy_hadamard']:.4f} (exact {final_exact:.4f}); "
              f"recovery {rec:.4f}")
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = counts.read()
    assert out["launches"]["dcqcn_scan"] == len(FIG1_REGIMES), out["launches"]
    rec = out["regimes"]["paper"]["recovery"]
    assert rec >= FIG1_RECOVERY_BAR, f"paper-regime recovery {rec} < 0.9"
    print(f"fig1 paper-regime recovery {rec:.4f} >= {FIG1_RECOVERY_BAR}; "
          f"launches {out['launches']}")
    return out, scheds["paper"]


def phase_fig1_full_width(dev, C, ts, Trainer, DataConfig, OptConfig,
                          coupling, sched, counts):
    """qwen2-0.5b at full width, TRAIN_STEPS steps of lossy_hadamard with
    the paper regime's engine schedule as its drop source: 16 FWHT
    launches a step and 0.4 <= recv_frac <= 1, as phase_train asserts."""
    cfg = C.get("qwen2-0.5b")
    tr = Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH, seed=1),
                 opt_cfg=OptConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=500),
                 celeris=ts.CelerisConfig(mode="lossy_hadamard"), seed=0,
                 straggler=coupling.EngineStragglerModel(sched),
                 device=str(dev))
    steps = []

    def on_metrics(step, m):
        steps.append(dict(m, launches=counts.read()))
        counts.reset()

    _sync()
    counts.reset()
    hist = tr.run(TRAIN_STEPS, on_metrics=on_metrics)
    fwht = [r["launches"]["fwht"] for r in steps]
    assert fwht == [2 * CODED_LEAVES] * TRAIN_STEPS, fwht
    assert np.isfinite(hist["loss"]).all(), hist["loss"]
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"]), hist["recv_frac"]
    assert hist["drop_rate"] == list(sched.rates[:TRAIN_STEPS])
    total = {}
    for r in steps:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    out = {"loss": hist["loss"], "recv_frac": hist["recv_frac"],
           "drop_rate": hist["drop_rate"],
           "step_ms": [r["wall_s"] * 1e3 for r in steps],
           "fwht_launches_per_step": fwht, "launches": total}
    print(f"fig1 full width lossy_hadamard from the engine schedule: loss "
          f"{hist['loss']}, drop {hist['drop_rate']}, recv_frac "
          f"{hist['recv_frac']}, FWHT launches/step {fwht}")
    return out


# ----------------------------------------------------------------------
# The hierarchical, faulted fabric (Figs. 4 and 7)
# ----------------------------------------------------------------------

# phase 10: fig7_fault_resilience.py's SMOKE_PARAMS fabric (32 nodes,
# burst_on_prob 0.0008) on 2 pods at oversubscription 2, card against
# CPU; (schedule, fault spec) per cell
HIER_CHECK_ROUNDS = 40
HIER_CHECK_CELLS = (("ring", None), ("hier", None), ("perrail", None),
                    ("hier", "stall:0.003"), ("perrail", "rail:0.3"),
                    ("ring", "straggler:0.1"))
# phase 11: fig4_cross_pod_tail.py:32-34 (the engine grid)
FIG4_NODES, FIG4_ROUNDS = 128, 100
FIG4_PODS, FIG4_OVERSUBS = (2, 4, 8), (2.0, 4.0, 8.0)
# phase 12: fig7_fault_resilience.py:64-86 and budgets.py:26 (TAIL_SCALE)
FIG7_NODES, FIG7_PODS, FIG7_OVERSUB, FIG7_ROUNDS = 128, 4, 4.0, 60
FIG7_SCHEDULES = ("ring", "hier", "perrail")
FIG7_SCALE_NODES, FIG7_TAIL_SCALE = 512, 0.25
FIG7_P99_SLACK, FIG7_GOODPUT_FLOOR = 1.5, 0.8
FIG7_RATE_GRID = {
    "stall": (1e-5, 3e-5, 1e-4, 3e-4, 1e-3),
    "crash": (3e-6, 1e-5, 3e-5, 1e-4, 3e-4),
    "flap": (1e-4, 3e-4, 1e-3, 3e-3, 1e-2),
}
FIG7_FAULT_KW = {"crash": {"crash_restart_steps": 64}}
FIG7_RAIL_RATES = (0.1, 0.3)
FIG7_PAPER_CELL = ("stall", 1e-4)
FIG7_RATIO_BAR = 2.0      # the paper's "nearly doubles NIC resilience"
# phase 13: fig7's end-to-end run (fig4_cross_pod_tail.py:41-42 for the
# pods and the window scale), the smoke LM as in fig1_trainer
FIG7_LOOP_PODS, FIG7_LOOP_SCALE, FIG7_LOOP_STEPS = 2, 0.6, 40
BENCH_SIM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "BENCH_sim.json")
SEQ_STATS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "data", "paper_protocol_seed_stats.json")


def committed(key):
    """The JAX package's committed value of a BENCH_sim.json key (numpy
    engine on the CPU), or None."""
    with open(BENCH_SIM) as f:
        return json.load(f).get(key)


def rate_tag(rate):
    """fig7's key-safe rate tag: 3e-05 -> '3em05'."""
    return f"{rate:g}".replace(".", "p").replace("-", "m").replace("+", "")


def hier_cell_params(P, topology, schedule, fault):
    """Phase 10's cell: fig7's smoke fabric on 2 pods at oversubscription
    2 with ``schedule`` and ``fault``."""
    base = P.SimParams(net=P.NetworkParams(n_nodes=32, burst_on_prob=0.0008))
    return topology.hier_params(2, base=base, dci_oversubscription=2.0,
                                schedule=schedule, fault=fault)


def phase_hier_card_vs_cpu(dev, E, P, topology):
    """The hierarchical and faulted engine on the card against the CPU
    (plain scan): HIER_CHECK_CELLS, all four designs, HIER_CHECK_ROUNDS
    rounds.  Delivered packets (per step, tier and pod) and faulted-flow
    counts exact; step times, each design's times, p99, recv_frac and
    tier fractions within rtol 1e-5, under both window policies."""
    worst, cells = 0.0, {}
    designs = list(E.designs.DESIGNS)
    for sched, fault in HIER_CHECK_CELLS:
        p = hier_cell_params(P, topology, sched, fault)
        runs = []
        for d in (dev, torch.device("cpu")):
            eng = E.BatchedEngine(p, device=str(d))
            runs.append((eng, eng.traces(designs, HIER_CHECK_ROUNDS, 0,
                                         legacy_streams=False)))
        (eng_d, tr_d), (eng_c, tr_c) = runs
        name = f"{sched}/{fault or 'clean'}"
        for d in designs:
            a, b = tr_d[d], tr_c[d]
            for f in ("deliv", "total", "tier_deliv", "pod_deliv",
                      "fault_flows"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None) and (
                    y is None or np.array_equal(x, y)), (name, d, f)
            pairs = [(a.nat_us, b.nat_us, "step times")]
            base = eng_c.assemble(tr_c["roce"], 0)
            to = float(np.percentile(base.times_us, 50)
                       + base.times_us.std()) * 0.6
            for window in ("round", "phase"):
                kw = ({"celeris_timeout_us": to, "adaptive": False,
                       "window": window} if d == "celeris" else {})
                sd, sc = eng_d.assemble(a, 0, **kw), eng_c.assemble(b, 0,
                                                                     **kw)
                pairs += [(sd.times_us, sc.times_us, f"{window} times"),
                          (sd.p99, sc.p99, f"{window} p99"),
                          (sd.recv_frac, sc.recv_frac, f"{window} recv_frac"),
                          (sd.tier_recv_frac, sc.tier_recv_frac,
                           f"{window} tier_recv_frac")]
                if d == "celeris":
                    cells.setdefault(name, {})[window] = {
                        "p99_ms": sd.p99 / 1e3, "loss": sd.mean_loss,
                        "dci_loss": sd.tier_loss("dci")}
            for x, y, what in pairs:
                np.testing.assert_allclose(
                    x, y, rtol=1e-5, atol=0,
                    err_msg=f"{name} {d} {what} card vs cpu")
                y = np.asarray(y)
                worst = max(worst, float(np.max(np.abs(np.asarray(x) - y)
                                                / np.maximum(np.abs(y),
                                                             1e-30))))
        if fault is not None and "straggler" not in fault:
            assert tr_d["celeris"].fault_flows.sum() > 0, name
    print(f"hierarchical/faulted engine card vs CPU, 32 nodes x 2 pods x "
          f"{HIER_CHECK_ROUNDS} rounds, cells {[c for c in cells]}: "
          f"delivered packets and faulted flows equal, worst relative "
          f"difference {worst:.3g}; celeris {cells}")
    return {"worst_rel_diff": worst, "celeris": cells}


def phase_fig4(dev, E, P, topology, counts):
    """Fig. 4's engine grid on the card (fig4_cross_pod_tail.py): the ring
    over FIG4_PODS pods at FIG4_OVERSUBS DCI oversubscription, 128 nodes,
    FIG4_ROUNDS rounds, seed 0, through ``topology.hier_protocol``; each
    cell's Celeris p99 and DCI loss beside the committed keys.  A second
    engine pass of each cell splits its wall time into host draws and
    device core."""
    cells, rows = {}, []
    wall = host = device = 0.0
    blocks = 0
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    for npods in FIG4_PODS:
        for ov in FIG4_OVERSUBS:
            p = topology.hier_params(npods, n_nodes=FIG4_NODES,
                                     dci_oversubscription=ov)
            t0 = time.perf_counter()
            stats = topology.hier_protocol(p, n_rounds=FIG4_ROUNDS, seed=0,
                                           device=str(dev))
            wall += time.perf_counter() - t0
            cel = stats["celeris"]
            assert np.isfinite(cel.times_us).all()
            assert cel.tier_loss("dci") >= 0 and cel.pod_recv_frac.shape == (
                FIG4_ROUNDS, npods)
            tag = f"p{npods}_o{int(ov)}"
            cells[tag] = {"p99_ms": cel.p99 / 1e3,
                          "dci_loss": cel.tier_loss("dci"),
                          "roce_p99_ms": stats["roce"].p99 / 1e3,
                          "committed_p99_ms": committed(
                              f"fig4_p99_ms_celeris_{tag}"),
                          "committed_dci_loss": committed(
                              f"fig4_dci_loss_{tag}")}
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for npods in FIG4_PODS:
        for ov in FIG4_OVERSUBS:
            eng = E.BatchedEngine(topology.hier_params(
                npods, n_nodes=FIG4_NODES, dci_oversubscription=ov),
                device=str(dev))
            eng.traces(["roce", "celeris"], FIG4_ROUNDS, 0,
                       legacy_streams=False)
            host += eng.timing["host_s"]
            device += eng.timing["device_s"]
            blocks += eng.timing["blocks"]
    assert launches["dcqcn_scan"] == blocks, (launches, blocks)
    # the device busy share over the last cell's engine pass (one block)
    busy = profile_window(lambda: eng.traces(["roce", "celeris"],
                                             FIG4_ROUNDS, 0,
                                             legacy_streams=False))
    for tag, c in cells.items():
        rows.append(f"{tag}: p99 {c['p99_ms']:.2f} ms (committed "
                    f"{c['committed_p99_ms']}), dci loss {c['dci_loss']:.4f} "
                    f"(committed {c['committed_dci_loss']})")
    rec = {"cells": cells, "wall_s": wall, "host_s": host,
           "device_s": device, "blocks": blocks, "peak_mem_gib": peak,
           "one_block_profile": busy, "launches": launches}
    print(f"fig4 {FIG4_NODES} nodes x {FIG4_ROUNDS} rounds on the card:\n  "
          + "\n  ".join(rows) + f"\n  wall {wall:.2f} s through hier_protocol;"
          f" a second pass: host draws {host:.2f} s + device core "
          f"{device:.2f} s; peak {peak:.2f} GiB; one block (p"
          f"{FIG4_PODS[-1]} o{int(FIG4_OVERSUBS[-1])}): {busy}; launches "
          f"{launches}")
    return rec


def fig7_goodput(st):
    """fig7's absolute mean goodput (delivered fraction per unit time)."""
    return float(np.mean(st.recv_frac / np.maximum(st.times_us, 1e-9)))


def fig7_gupf(st, clean_st):
    """fig7's paired goodput under failure: the faulted rounds' mean
    goodput over the same rounds of the clean run."""
    f = st.faulted
    if not f.any():
        return 1.0
    g = st.recv_frac / np.maximum(st.times_us, 1e-9)
    g0 = clean_st.recv_frac / np.maximum(clean_st.times_us, 1e-9)
    return float(g[f].mean() / max(float(g0[f].mean()), 1e-30))


def fig7_sustained(st, clean):
    return (st.p99 <= FIG7_P99_SLACK * clean.p99
            and fig7_goodput(st) >= FIG7_GOODPUT_FLOOR * fig7_goodput(clean))


def fig7_max_sustained(cells, clean, rates):
    """The highest rate with every rate at or below it sustained."""
    best = 0.0
    for r in rates:
        if not fig7_sustained(cells[r], clean):
            break
        best = r
    return best


def fig7_clean_pass(E, base, nn, npods, sched, n_rounds, seed, tail_scale,
                    dev):
    """fig7's clean pass through the port's ``sweep``: the fault-free
    stats and the pinned Celeris budget.  Returns (clean, budget,
    SweepResult)."""
    res = E.sweep(E.BatchedSimParams(
        n_nodes=(nn,), seeds=(seed,), n_pods=(npods,), schedules=(sched,),
        designs=("roce", "celeris"), n_rounds=n_rounds,
        timeout_scale=tail_scale, base=base), device=str(dev))
    clean = {d: res.stats[res._key(d, nn, 25.0, seed, npods, sched)]
             for d in ("roce", "celeris")}
    roce = clean["roce"]
    budget = float((np.percentile(roce.times_us, 50) + roce.times_us.std())
                   * tail_scale)
    return clean, budget, res


def fig7_fault_sweep(E, P, base, nn, npods, sched, kinds_rates, budget,
                     n_rounds, seed, dev):
    """fig7's pinned-budget sweep over (kind, rate) cells through the
    port's ``sweep``.  Returns ({(kind, rate): {design: stats}},
    SweepResult)."""
    faults = tuple(P.FaultParams.of_kind(k, r, **FIG7_FAULT_KW.get(k, {}))
                   for k, r in kinds_rates)
    res = E.sweep(E.BatchedSimParams(
        n_nodes=(nn,), seeds=(seed,), n_pods=(npods,), schedules=(sched,),
        designs=("roce", "celeris"), n_rounds=n_rounds,
        celeris_timeout_us=budget, faults=faults, base=base),
        device=str(dev))
    return ({(k, r): {d: res.stats[res._key(d, nn, 25.0, seed, npods,
                                            sched, "round", fp.tag)]
                      for d in ("roce", "celeris")}
             for (k, r), fp in zip(kinds_rates, faults)}, res)


def sweep_timing(results):
    """Host draws, device core and blocks summed over sweeps' cells."""
    t = [c for r in results for c in r.timing.values()]
    return (sum(c["host_s"] for c in t), sum(c["device_s"] for c in t),
            sum(c["blocks"] for c in t))


def phase_fig7(dev, E, P, topology, counts):
    """Fig. 7 on the card (fig7_fault_resilience.py's full protocol, all
    through the port's ``sweep``): 128 nodes, 4 pods, oversubscription 4,
    per schedule the clean pass with the pinned budget, then the stall /
    crash / flap rate scans (the resilience ratios); the rail failure
    rates under hier and perrail (the blast radius); and the 512-node
    hier stall cell.  Asserts the worst resilience ratio >= 2 and
    perrail's DCI loss below hier's at each rail rate."""
    base = topology.hier_params(FIG7_PODS, dci_oversubscription=FIG7_OVERSUB)
    out = {"ratios": {}, "max_rate": {}, "rail": {}, "committed": {}}
    sweeps = []
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    for sched in FIG7_SCHEDULES:
        clean, budget, r0 = fig7_clean_pass(
            E, base, FIG7_NODES, FIG7_PODS, sched, FIG7_ROUNDS, 0,
            FIG7_TAIL_SCALE, dev)
        kinds_rates = [(k, r) for k in FIG7_RATE_GRID
                       for r in FIG7_RATE_GRID[k]]
        cells, r1 = fig7_fault_sweep(E, P, base, FIG7_NODES, FIG7_PODS,
                                     sched, kinds_rates, budget, FIG7_ROUNDS,
                                     0, dev)
        sweeps += [r0, r1]
        for k, rates in FIG7_RATE_GRID.items():
            mx = {d: fig7_max_sustained({r: cells[(k, r)][d] for r in rates},
                                        clean[d], rates)
                  for d in ("roce", "celeris")}
            ratio = min(mx["celeris"] / max(mx["roce"], rates[0] / 2), 100.0)
            out["ratios"][f"{k}_{sched}"] = ratio
            out["max_rate"][f"{k}_{sched}"] = mx
            out["committed"][f"{k}_{sched}"] = {
                "ratio": committed(f"fig7_resilience_ratio_{k}_{sched}"),
                "roce": committed(f"fig7_max_rate_roce_{k}_{sched}"),
                "celeris": committed(f"fig7_max_rate_celeris_{k}_{sched}")}
        cel = cells[FIG7_PAPER_CELL]["celeris"]
        out[f"paper_cell_{sched}"] = {
            "gupf": fig7_gupf(cel, clean["celeris"]),
            "recovery_rounds": cel.recovery_rounds(),
            "budget_ms": budget / 1e3,
            "clean_p99_ms": {d: s.p99 / 1e3 for d, s in clean.items()}}
    dci = {}
    for sched in ("hier", "perrail"):
        clean, budget, r0 = fig7_clean_pass(
            E, base, FIG7_NODES, FIG7_PODS, sched, FIG7_ROUNDS, 0,
            FIG7_TAIL_SCALE, dev)
        cells, r1 = fig7_fault_sweep(
            E, P, base, FIG7_NODES, FIG7_PODS, sched,
            [("rail", r) for r in FIG7_RAIL_RATES], budget, FIG7_ROUNDS, 0,
            dev)
        sweeps += [r0, r1]
        for rate in FIG7_RAIL_RATES:
            cel = cells[("rail", rate)]["celeris"]
            dci[(sched, rate)] = cel.tier_loss("dci")
            out["rail"][f"{rate_tag(rate)}_{sched}"] = {
                "dci_loss": dci[(sched, rate)],
                "gupf": fig7_gupf(cel, clean["celeris"]),
                "committed_dci_loss": committed(
                    f"fig7_dci_loss_rail_{rate_tag(rate)}_{sched}")}
    for rate in FIG7_RAIL_RATES:
        out["rail"][f"blast_ratio_{rate_tag(rate)}"] = {
            "ratio": dci[("hier", rate)] / max(dci[("perrail", rate)], 1e-4),
            "committed": committed(f"fig7_rail_blast_ratio_{rate_tag(rate)}")}
    grid_s = time.perf_counter() - t0
    host, device, blocks = sweep_timing(sweeps)
    launches = counts.read()
    assert launches["dcqcn_scan"] == blocks, (launches, blocks)
    grid_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the device busy share over one faulted cell's engine pass (the hier
    # paper cell, one block) and over the 512-node cell's (two blocks)
    paper = P.FaultParams.of_kind(*FIG7_PAPER_CELL)
    busy = {}
    for nn in (FIG7_NODES, FIG7_SCALE_NODES):
        eng = E.BatchedEngine(dataclasses.replace(
            base, net=dataclasses.replace(base.net, n_nodes=nn),
            work=dataclasses.replace(base.work, schedule="hier"),
            fault=paper), device=str(dev))
        busy[nn] = profile_window(lambda: eng.traces(
            ["roce", "celeris"], FIG7_ROUNDS, 0, legacy_streams=False))
    counts.reset()

    # the 512-node hier stall cell: its own wall-time split and peak memory
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    clean, budget, r0 = fig7_clean_pass(
        E, base, FIG7_SCALE_NODES, FIG7_PODS, "hier", FIG7_ROUNDS, 0,
        FIG7_TAIL_SCALE, dev)
    cells, r1 = fig7_fault_sweep(E, P, base, FIG7_SCALE_NODES, FIG7_PODS,
                                 "hier", [FIG7_PAPER_CELL], budget,
                                 FIG7_ROUNDS, 0, dev)
    s_host, s_device, s_blocks = sweep_timing([r0, r1])
    roc, cel = (cells[FIG7_PAPER_CELL][d] for d in ("roce", "celeris"))
    out["n512"] = {
        "p99_ms_roce": roc.p99 / 1e3, "p99_ms_celeris": cel.p99 / 1e3,
        "gupf": fig7_gupf(cel, clean["celeris"]),
        "committed": {k: committed(f"fig7_{k}_n512") for k in (
            "p99_ms_roce_stall", "p99_ms_celeris_stall",
            "gupf_celeris_stall")},
        "wall_s": time.perf_counter() - t1, "host_s": s_host,
        "device_s": s_device, "blocks": s_blocks,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    assert counts.read()["dcqcn_scan"] == s_blocks, counts.read()
    launches["dcqcn_scan"] += s_blocks
    out.update(grid_wall_s=grid_s, grid_host_s=host, grid_device_s=device,
               grid_blocks=blocks, grid_peak_mem_gib=grid_peak,
               hier_stall_profile={str(k): v for k, v in busy.items()},
               launches=launches)

    worst = min(out["ratios"].values())
    out["worst_ratio"] = worst
    for key, ratio in out["ratios"].items():
        print(f"fig7 {key}: max sustained rate roce "
              f"{out['max_rate'][key]['roce']:g} / celeris "
              f"{out['max_rate'][key]['celeris']:g}, resilience ratio "
              f"{ratio:.2f} (committed {out['committed'][key]})")
    for key, r in out["rail"].items():
        print(f"fig7 rail {key}: {r}")
    print(f"fig7 n={FIG7_SCALE_NODES} hier stall {FIG7_PAPER_CELL[1]:g}: "
          f"{out['n512']}")
    print(f"fig7 grid: wall {grid_s:.1f} s = host draws {host:.1f} s + "
          f"device core {device:.1f} s (+ assembly), {blocks} blocks, peak "
          f"{grid_peak:.2f} GiB; hier stall {FIG7_PAPER_CELL[1]:g} pass "
          f"profiles by nodes: {busy}; launches {launches}")
    assert worst >= FIG7_RATIO_BAR, f"worst resilience ratio {worst} < 2"
    for rate in FIG7_RAIL_RATES:
        assert dci[("perrail", rate)] < dci[("hier", rate)], (rate, dci)
    print(f"fig7 worst resilience ratio {worst:.2f} >= {FIG7_RATIO_BAR}; "
          f"perrail's DCI loss below hier's at rail rates {FIG7_RAIL_RATES}")
    return out


def phase_fig7_loop(dev, C, ts, Trainer, DataConfig, OptConfig, coupling,
                    counts):
    """Fig. 7's closed loop: the faulted 2-pod engine's axis-split
    schedule (``split_schedule_from_engine``, 128 nodes, window x0.6,
    stall 1e-4) drives the smoke LM FIG7_LOOP_STEPS steps in
    ``hierarchical`` mode against as many ``exact`` steps; recovery must
    reach FIG1_RECOVERY_BAR."""
    _sync()
    counts.reset()
    t0 = time.perf_counter()
    fault = f"{FIG7_PAPER_CELL[0]}:{FIG7_PAPER_CELL[1]}"
    sched = coupling.split_schedule_from_engine(
        FIG7_LOOP_STEPS, seed=0, n_pods=FIG7_LOOP_PODS, n_nodes=FIG1_NODES,
        timeout_scale=FIG7_LOOP_SCALE, fault=fault, device=str(dev))
    sched_s = time.perf_counter() - t0
    assert sched.per_pod is not None and len(sched.per_pod) == FIG7_LOOP_PODS
    h_exact = fig1_trainer(C, ts, Trainer, DataConfig, OptConfig, "exact",
                           None, dev).run(FIG7_LOOP_STEPS)
    h_hier = fig1_trainer(C, ts, Trainer, DataConfig, OptConfig,
                          "hierarchical",
                          coupling.HierStragglerModel(sched),
                          dev).run(FIG7_LOOP_STEPS)
    assert np.isfinite(h_hier["loss"]).all()
    want = [sched.rates(i) for i in range(FIG7_LOOP_STEPS)]
    assert all(np.array_equal(a, b) for a, b in zip(h_hier["drop_rate"],
                                                    want))
    loss0 = h_exact["loss"][0]
    final_exact = float(np.mean(h_exact["loss"][-5:]))
    final_hier = float(np.mean(h_hier["loss"][-5:]))
    rec = (loss0 - final_hier) / max(loss0 - final_exact, 1e-9)
    out = {"source": sched.source, "schedule_s": sched_s,
           "drop_mean_intra": sched.intra.mean,
           "drop_mean_cross": sched.cross.mean,
           "final_loss_exact": final_exact,
           "final_loss_hierarchical": final_hier, "recovery": rec,
           "committed": {k: committed(f"fig7_{k}") for k in (
               "recovery", "drop_mean_intra", "drop_mean_cross",
               "final_loss_exact", "final_loss_hierarchical")},
           "wall_s": time.perf_counter() - t0, "launches": counts.read()}
    assert out["launches"]["dcqcn_scan"] >= 1, out["launches"]
    print(f"fig7 loop: drop intra {sched.intra.mean:.4f} / cross "
          f"{sched.cross.mean:.4f} (schedule {sched_s:.2f} s); final loss "
          f"exact {final_exact:.4f}, hierarchical {final_hier:.4f}; "
          f"recovery {rec:.4f} (committed {out['committed']['recovery']})")
    assert rec >= FIG1_RECOVERY_BAR, f"fig7 recovery {rec} < 0.9"
    return out, sched


def phase_fig7_full_width(dev, C, ts, Trainer, DataConfig, OptConfig,
                          coupling, sched, counts):
    """qwen2-0.5b at full width, TRAIN_STEPS ``hierarchical`` steps from
    the faulted axis-split schedule: finite loss and 16 FWHT launches a
    step."""
    cfg = C.get("qwen2-0.5b")
    tr = Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH, seed=1),
                 opt_cfg=OptConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=500),
                 celeris=ts.CelerisConfig(mode="hierarchical"), seed=0,
                 straggler=coupling.HierStragglerModel(sched),
                 device=str(dev))
    steps = []

    def on_metrics(step, m):
        steps.append(dict(m, launches=counts.read()))
        counts.reset()

    _sync()
    counts.reset()
    hist = tr.run(TRAIN_STEPS, on_metrics=on_metrics)
    fwht = [r["launches"]["fwht"] for r in steps]
    assert fwht == [2 * CODED_LEAVES] * TRAIN_STEPS, fwht
    assert np.isfinite(hist["loss"]).all(), hist["loss"]
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"]), hist["recv_frac"]
    total = {}
    for r in steps:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    out = {"loss": hist["loss"], "recv_frac": hist["recv_frac"],
           "drop_rate": [list(map(float, d)) for d in hist["drop_rate"]],
           "step_ms": [r["wall_s"] * 1e3 for r in steps],
           "fwht_launches_per_step": fwht, "launches": total}
    print(f"fig7 full width hierarchical from the faulted schedule: loss "
          f"{hist['loss']}, drop {out['drop_rate']}, recv_frac "
          f"{hist['recv_frac']}, FWHT launches/step {fwht}")
    return out


# ----------------------------------------------------------------------
# Tables 1-2, Figs. 5, 6 and 8 and the long prompt (phases 14-19)
# ----------------------------------------------------------------------

# phase 17: the incast overlay, card against CPU
INCAST_CHECK_ROUNDS = 40
# phase 19: a long prompt on the tiled attention path (s * s > 4 Mi)
LONG_PROMPT, LONG_GEN = 4096, 16
# tiled against dense attention: float32 logits in both, the
# probabilities rounded to bfloat16 (dense after normalizing, tiled
# before) and the dense output rounded to bfloat16: 2^-6 of the largest
# output, two bf16 ulps at that size (layer 0 of qwen2-0.5b at 2,048
# tokens on the CPU: 2^-7.8)
LONG_ATTN_RTOL = 2 ** -6


def phase_tables(figs, qp, rm):
    """Tables I-II from the port's copies of ``qp_state`` and
    ``resource_model`` (host arithmetic), held to the paper values that
    tests/test_resource_models.py holds the reference to."""
    keys = figs.table_keys(qp, rm)
    designs = figs.TABLE_DESIGNS
    for d, want in qp.PAPER_QP_BYTES.items():
        assert keys[f"table1_qp_bytes_{d}"] == want, (d, want)
    gain = qp.PAPER_QP_SCALABILITY["celeris"] / qp.PAPER_QP_SCALABILITY["roce"]
    assert abs(qp.qp_capacity("celeris") / qp.qp_capacity("roce") / gain
               - 1) <= 0.05, keys["table1_qp_density_gain"]
    for d, want in rm.PAPER_BRAM.items():
        assert abs(rm.bram_blocks(d) / want - 1) <= 1e-3, (d, want)
    c = rm.bram_blocks("celeris")
    cut_roce, cut_irn = (1 - c / rm.bram_blocks(d) for d in ("roce", "irn"))
    assert 0.60 < cut_roce < 0.68 and 0.70 < cut_irn < 0.75, (cut_roce,
                                                              cut_irn)
    for d, want in rm.PAPER_MTBF_HRS.items():
        got = rm.cluster_mtbf_hours(d)
        assert abs(got - want) / want < 0.02, (d, got, want)
    print(f"tables I-II: per-QP bytes "
          f"{[keys[f'table1_qp_bytes_{d}'] for d in designs]} == the "
          f"paper's; QP density gain {keys['table1_qp_density_gain']}; BRAM "
          f"cut vs IRN {keys['table2_bram_cut_vs_irn_pct']} % (vs RoCE "
          f"{cut_roce * 100:.1f} %); MTBF h "
          f"{[round(keys[f'table2_mtbf_{d}'], 1) for d in designs]} "
          f"within 2 % of the paper's; MTBF gain {keys['table2_mtbf_gain']}")
    return dict(keys, bram_cut_vs_roce=cut_roce)


def assert_committed(name, keys):
    """Every key equal to the committed BENCH_sim.json value (the numpy
    engine on the CPU, rounded as the benchmark rounds it)."""
    want = {k: committed(k) for k in keys}
    bad = {k: (v, want[k]) for k, v in keys.items() if v != want[k]}
    assert not bad, f"{name}: keys differ from the committed ones " \
        f"(port, committed): {bad}"
    return len(keys)


def check_kv_wire(name, caches, mask, signs, kfwht, kunbias, ref, coding,
                  timed=False):
    """The coded KV transfer's kernels against their plain versions on one
    path's own caches, wire-row mask and signs, per K and V leaf
    (``caches.leaves()``, each its own payload in
    ``serve_step.kv_wire_roundtrip``): encode's FWHT on the
    (n_blocks, n_rot) blocks with signs and scale, decode's unbias on the
    masked (n_rot, n_blocks) wire with the mask as counts, and decode's
    FWHT with the scale alone.  The FWHT equal, unbias within rtol 1e-6
    (phase 2's bars).  Run outside a path's counted window.  Returns the
    worst error by kernel and the shapes; ``timed`` adds the timing
    records (``fwht_record``, ``unbias_record``) of encode's FWHT and the
    unbias at the first leaf's shapes."""
    n_rot = int(mask.shape[0])
    counts = mask.to(torch.float32)       # as kv_wire_roundtrip casts it
    worst = {"fwht": 0.0, "masked_unbias": 0.0}
    shapes = set()
    records = []
    for leaf in caches.leaves():
        code = coding.plan(leaf.numel(), n_rot=n_rot)
        assert code.n_rot == n_rot, (code, n_rot)
        x = torch.nn.functional.pad(
            leaf.reshape(-1).to(torch.float32),
            (0, code.padded_len - code.orig_len)).reshape(code.n_blocks,
                                                          n_rot)
        scale = n_rot ** -0.5
        rot = ref.fwht(x, signs=signs, scale=scale)
        e1 = check_equal(f"{name} encode fwht {tuple(x.shape)}",
                         (kfwht.fwht_cuda(x, signs, scale),), (rot,))
        wire = rot.T.contiguous() * counts[:, None]
        est = ref.masked_unbias(wire, counts, 1)
        e2 = check(f"{name} unbias {tuple(wire.shape)}",
                   kunbias.masked_unbias_cuda(wire, counts, 1), est, 1e-6,
                   0.0)
        k = (counts > 0).sum()
        rot_est = est.T.contiguous() * torch.where(
            k > 0, torch.div(n_rot, k.clamp(min=1)), 0.0)
        e3 = check_equal(f"{name} decode fwht {tuple(rot_est.shape)}",
                         (kfwht.fwht_cuda(rot_est, None, scale),),
                         (ref.fwht(rot_est, scale=scale),))
        worst["fwht"] = max(worst["fwht"], e1, e3)
        worst["masked_unbias"] = max(worst["masked_unbias"], e2)
        shapes |= {("fwht", tuple(x.shape)),
                   ("masked_unbias", tuple(wire.shape))}
        if timed and not records:
            records = [fwht_record(kfwht, ref, x, signs, scale, e1),
                       unbias_record(kunbias, ref, wire, counts, 1, e2)]
        del x, rot, wire, est, rot_est
    out = {"max_abs_err": worst,
           "shapes": sorted(f"{k} {list(v)}" for k, v in shapes)}
    if timed:
        out["records"] = records
    return out


def phase_fig5(dev, E, topology, figs, counts):
    """Fig. 5 on the card (fig5_schedule_tail.run(): ring vs hier over 2
    and 4 pods x oversubscription 2, 4 and 8, 128 nodes x 100 rounds
    through ``sweep``, and the hot pod through ``hier_protocol``): all 32
    ``fig5_*`` keys equal to the committed ones."""
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    keys, sweeps, protocol = figs.fig5_keys(dev)
    wall = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host, device, blocks = sweep_timing(sweeps)
    blocks += len(protocol)     # one block a pass at 128 nodes x 100 rounds
    assert launches["dcqcn_scan"] == blocks, (launches, blocks)
    n = assert_committed("fig5", keys)
    assert n == 32, n
    # the device busy share over one engine pass (the 4-pod o8 hier cell,
    # one block)
    eng = E.BatchedEngine(topology.hier_params(
        4, n_nodes=figs.FIG5_NODES, schedule="hier",
        dci_oversubscription=8.0), device=str(dev))
    busy = profile_window(lambda: eng.traces(["roce", "celeris"],
                                             figs.FIG5_ROUNDS, 0,
                                             legacy_streams=False))
    rec = {"keys": keys, "committed_keys_equal": n, "wall_s": wall,
           "sweep_host_s": host, "sweep_device_s": device, "blocks": blocks,
           "peak_mem_gib": peak, "one_block_profile": busy,
           "launches": launches}
    print(f"fig5 {figs.FIG5_NODES} nodes x {figs.FIG5_ROUNDS} rounds on the "
          f"card: {n} fig5_* keys == the committed ones (ring/hier p99 ratio "
          f"p4 o8 {keys['fig5_p99_ratio_p4_o8']}, hot pod "
          f"{keys['fig5_hotpod_p99_ms']} ms); wall {wall:.2f} s, the sweeps' "
          f"host draws {host:.2f} s + device core {device:.2f} s; peak "
          f"{peak:.2f} GiB; one block (p4 o8 hier): {busy}; launches "
          f"{launches}")
    return rec


def phase_fig6(dev, E, topology, figs, counts):
    """Fig. 6 on the card (fig6_scale_schedule.run(): {ring, hier,
    perrail} x {round, phase} at 128, 512 and 1,024 nodes x
    oversubscription {2, 8}, 4 pods, 60 rounds, budget x TAIL_SCALE,
    through ``sweep``): all 126 ``fig6_*`` keys but the wall equal to the
    committed ones; each cell's split, and the device busy share over one
    1,024-node ring pass."""
    tier = figs.FIG6
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    keys, sweeps = figs.fig6_keys(tier, dev)
    wall = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host, device, blocks = sweep_timing(sweeps)
    assert launches["dcqcn_scan"] == blocks, (launches, blocks)
    n = assert_committed("fig6", keys)
    assert n == 126, n
    cells = {f"o{int(ov)} {'/'.join(map(str, k))}": t
             for ov, res in zip(tier.oversubs, sweeps)
             for k, t in res.timing.items()}
    # the device busy share over one engine pass of the largest ring cell
    # (1,024 nodes, oversubscription 8: the physics of its sweep cell)
    eng = E.BatchedEngine(topology.hier_params(
        tier.pods, n_nodes=tier.nodes[-1], schedule="ring",
        dci_oversubscription=tier.oversubs[-1]), device=str(dev))
    busy = profile_window(lambda: eng.traces(["roce", "celeris"],
                                             tier.n_rounds, 0,
                                             legacy_streams=False))
    rec = {"committed_keys_equal": n, "wall_s": wall,
           "committed_wall_s": committed("fig6_wall_s"), "host_s": host,
           "device_s": device, "blocks": blocks, "peak_mem_gib": peak,
           "cell_timing": cells, "ring_n1024_o8_profile": busy,
           "launches": launches,
           "loss_ratio_round_phase_hier": {
               k: v for k, v in keys.items()
               if k.startswith("fig6_loss_ratio_round_phase_hier")}}
    print(f"fig6 on the card: {n} fig6_* keys == the committed ones; wall "
          f"{wall:.2f} s (committed numpy wall {rec['committed_wall_s']} s) "
          f"= host draws {host:.2f} s + device core {device:.2f} s (+ "
          f"assembly), {blocks} blocks, peak {peak:.2f} GiB; one ring pass "
          f"(n1024 o8): {busy}; launches {launches}")
    for k, t in cells.items():
        print(f"  fig6 cell {k}: host {t['host_s']:.2f} s, device "
              f"{t['device_s']:.2f} s, {t['blocks']} blocks")
    return rec


def phase_incast_card_vs_cpu(dev, E, traffic, figs):
    """The incast overlay on the card against the CPU: the smoke KV plan
    (28 prefill -> 4 decode, fan-in 7, 32 nodes), INCAST_CHECK_ROUNDS
    rounds, roce / irn / celeris.  Delivered packets exact; step times,
    p99 and recv_frac within rtol 1e-5."""
    tp = traffic.ServeTrafficParams(**figs.FIG8_SMOKE_TP)
    params, plan = figs.fig8_params(tp)
    assert plan.max_fan_in() == tp.fan_in == 7
    designs = list(figs.FIG8_DESIGNS)
    runs = []
    for d in (dev, torch.device("cpu")):
        eng = E.BatchedEngine(params, plan=plan, device=str(d))
        runs.append((eng, eng.traces(designs, INCAST_CHECK_ROUNDS, 0,
                                     legacy_streams=False)))
    (eng_d, tr_d), (eng_c, tr_c) = runs
    worst = 0.0
    for d in designs:
        a, b = tr_d[d], tr_c[d]
        for f in ("deliv", "total", "tier_deliv"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (d, f)
        steps = b.steps_per_round
        budget = float(np.percentile(b.nat_us.reshape(-1, steps).sum(1),
                                     50)) * figs.FIG8_SLO_SCALE
        kw = ({"celeris_timeout_us": budget, "adaptive": False}
              if d == "celeris" else {})
        sd, sc = eng_d.assemble(a, 0, **kw), eng_c.assemble(b, 0, **kw)
        for x, y, what in ((a.nat_us, b.nat_us, "step times"),
                           (sd.times_us, sc.times_us, "times"),
                           (sd.p99, sc.p99, "p99"),
                           (sd.recv_frac, sc.recv_frac, "recv_frac")):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=0,
                                       err_msg=f"incast {d} {what}")
            y = np.asarray(y)
            worst = max(worst, float(np.max(np.abs(np.asarray(x) - y)
                                            / np.maximum(np.abs(y), 1e-30))))
    lost = float((tr_c["celeris"].deliv < tr_c["celeris"].total).mean())
    print(f"incast (KV plan, fan-in 7, 32 nodes x {INCAST_CHECK_ROUNDS} "
          f"rounds) card vs CPU: delivered packets equal, worst relative "
          f"difference {worst:.3g}; celeris steps with losses {lost:.3f}")
    return {"worst_rel_diff": worst, "celeris_lossy_step_share": lost}


def phase_fig8(dev, traffic, figs, kernels, counts):
    """Fig. 8 on the card (fig8_serving_tail.run()'s full tier): one
    engine pass over the 112 -> 16 KV incast plan (128 nodes x 300
    rounds), then the request process and the FIFO queue per design and
    load; the 26 engine-derived ``fig8_*`` keys equal to the committed
    ones; then the smoke LM decodes from caches degraded at the clipped
    tail fraction, coded usable context >= 0.9, and the coded transfer's
    kernels are held to their plain versions on its caches."""
    tp = traffic.ServeTrafficParams(**figs.FIG8_TP)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    stats, budget, eng = figs.fig8_engine_rounds(tp, figs.FIG8_ROUNDS, 0, dev)
    engine_s = time.perf_counter() - t0
    timing = dict(eng.timing)
    keys, f_cell = figs.fig8_keys(tp, figs.FIG8_LOADS, stats, budget, 0,
                                  "fig8")
    wall = time.perf_counter() - t0
    launches = counts.read()
    assert launches["dcqcn_scan"] == timing["blocks"] == 1, launches
    n = assert_committed("fig8", keys)
    assert n == 26, n
    counts.reset()
    rec_cell, wire = figs.fig8_recovery(dev, f_cell, 0)
    rec_launches = counts.read()
    assert rec_launches["fwht"] > 0 and rec_launches["masked_unbias"] > 0, (
        rec_launches)
    launches = {k: v + rec_launches[k] for k, v in launches.items()}
    wire_check = check_kv_wire("fig8 recovery", *wire, *kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = profile_window(lambda: eng.traces(list(figs.FIG8_DESIGNS),
                                             figs.FIG8_ROUNDS, 0,
                                             legacy_streams=False))
    rec = {"keys": keys, "committed_keys_equal": n, "kv_frac_cell": f_cell,
           "recovery": rec_cell, "wire_check": wire_check,
           "committed_recovery": {k: committed(f"fig8_{k}") for k in (
               "kv_recovery_coded_hiload", "kv_recovery_uncoded_hiload",
               "token_agree_coded_hiload")},
           "wall_s": wall, "engine_s": engine_s,
           "host_s": timing["host_s"], "device_s": timing["device_s"],
           "blocks": timing["blocks"], "peak_mem_gib": peak,
           "one_block_profile": busy, "launches": launches}
    print(f"fig8 {tp.n_prefill} -> {tp.n_decode} KV incast, "
          f"{figs.FIG8_ROUNDS} rounds on the card: {n} engine-derived fig8_* "
          f"keys == the committed ones (SLO {keys['fig8_slo_round_ms']} ms, "
          f"roce/celeris token p99 "
          f"{keys['fig8_p99_ratio_roce_celeris_hiload']}x); wall {wall:.2f} s "
          f"(engine {engine_s:.2f} s = host draws {timing['host_s']:.2f} s + "
          f"device core {timing['device_s']:.2f} s); recovery at kv_frac "
          f"{f_cell}: {rec_cell} (committed {rec['committed_recovery']}); "
          f"its kernels vs plain: {wire_check}; one block: {busy}; launches "
          f"{launches}")
    assert rec_cell["coded"]["usable"] >= figs.FIG8_RECOVERY_BAR, rec_cell
    return rec


# ----------------------------------------------------------------------
# The priority cut, the per-step window and the flight recorder
# ----------------------------------------------------------------------

FEATURE_CHECK_ROUNDS = 40
TRACE_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "results", "fig9_trace.json")
RECORDED_FIELDS = ("times_us", "recv_frac", "tier_recv_frac", "pod_recv_frac",
                   "prio_recv_frac", "fault_steps", "affected_flows")


def worst_rel(pairs, what):
    """Hold each (card, CPU) pair within rtol 1e-5; return the worst
    relative difference."""
    worst = 0.0
    for x, y, name in pairs:
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=0,
                                   err_msg=f"{what} {name} card vs cpu")
        y = np.asarray(y, np.float64)
        worst = max(worst, float(np.max(np.abs(np.asarray(x) - y)
                                        / np.maximum(np.abs(y), 1e-30))))
    return worst


def stats_pairs(a, b, tag):
    """A (card, CPU) RoundStats pair's times, fractions and p99."""
    return [(getattr(a, f), getattr(b, f), f"{tag} {f}")
            for f in ("times_us", "recv_frac", "tier_recv_frac",
                      "pod_recv_frac", "prio_recv_frac")
            if getattr(b, f) is not None] + [(a.p99, b.p99, f"{tag} p99")]


def check_priority_cut(dev, topology, figs):
    """The priority cut, card against CPU: the 32-node 2-pod hier cell
    with layer-depth classes, both cut orders x round and phase windows
    at the smoke budget."""
    p = topology.hier_params(2, base=figs.smoke_params(),
                             dci_oversubscription=8.0, schedule="hier")
    runs = [figs.fig10_traces(p, FEATURE_CHECK_ROUNDS, 0, d)
            for d in (dev, torch.device("cpu"))]
    # one budget for both, the CPU's: a budget an ulp apart could move a
    # cut across a packet
    to = figs.paper_budget(runs[1][2], figs.SMOKE_TAIL_SCALE)
    for f in ("deliv", "tier_deliv", "pod_deliv"):
        assert np.array_equal(getattr(runs[0][1], f), getattr(runs[1][1], f))
    pairs, prio = [], {}
    for order in ("arrival", "priority"):
        for window in ("round", "phase"):
            sd, sc = (figs.fig10_cut(eng, cel, 0, to, order, window)
                      for eng, cel, _ in runs)
            assert np.array_equal(sd.prio_pkts, sc.prio_pkts)
            pairs += stats_pairs(sd, sc, f"{order}/{window}")
            top = sd.prio_pkts.size - 1
            prio[f"{order}/{window}"] = {"hi_loss": sd.prio_loss(top),
                                         "lo_loss": sd.prio_loss(0)}
    return {"worst_rel_diff": worst_rel(pairs, "priority cut"),
            "celeris": prio}


def check_per_node(dev, E, figs):
    """Per-node traces of all four designs and the fixed per-step window
    run from them, card against CPU, in both stream modes (32-node flat
    fabric, a budget that binds)."""
    designs = list(E.designs.DESIGNS)
    out = {}
    for legacy in (False, True):
        res = []
        for d in (dev, torch.device("cpu")):
            eng = E.BatchedEngine(figs.smoke_params(), device=str(d))
            tr = eng.traces(designs, FEATURE_CHECK_ROUNDS, 0,
                            legacy_streams=legacy, per_node_for=designs)
            node_bytes = eng.timing["node_bytes"]
            st = eng.run("celeris", FEATURE_CHECK_ROUNDS, window="step",
                         adaptive=False, legacy_streams=legacy, seed=0,
                         celeris_timeout_us=3_000.0)
            res.append((tr, st, node_bytes))
        (trd, std, nb), (trc, stc, _) = res
        pairs = []
        for name in designs:
            assert np.array_equal(trd[name].node_deliv, trc[name].node_deliv)
            pairs.append((trd[name].node_time_us, trc[name].node_time_us,
                          f"{name} node times"))
        pairs += stats_pairs(std, stc, "step window")
        assert stc.recv_frac.min() < 1.0, "the step window must bind"
        mode = "legacy" if legacy else "shared"
        out[mode] = {"worst_rel_diff": worst_rel(pairs, f"per-node {mode}"),
                     "node_bytes": nb, "step_loss": std.mean_loss}
    return out


def check_recorded_pass(dev, E, figs):
    """A recorded faulted 2-pod pass (Fig. 9's stall cell), card against
    CPU: stats, faulted flows, the recorder's packets and fabric counters
    exact or within rtol 1e-5; the critical flow's components wherever
    the critical flow agrees, and it may differ only where the CPU
    step's two largest times lie within rtol 1e-5."""
    (cd, rd, hp), (cc, rc, _) = (figs.fig9_fault_cell(d, 1)
                                 for d in (dev, torch.device("cpu")))
    pairs, diffs = [], {}
    for name in ("roce", "celeris"):
        (sd, a), (sc, b) = cd[name], cc[name]
        for f in ("fault_steps", "affected_flows"):
            assert np.array_equal(getattr(sd, f), getattr(sc, f)), f
        for f in ("offered_pkts", "delivered_pkts", "lost_pkts"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
        pairs += stats_pairs(sd, sc, f"{name} recorded")
        pairs += [(a.comp_tier, b.comp_tier, f"{name} comp_tier"),
                  (a.comp_crit.sum(-1), b.comp_crit.sum(-1),
                   f"{name} critical time")]
        diff = np.flatnonzero(a.crit_src != b.crit_src)
        ok = np.setdiff1d(np.arange(a.crit_src.size), diff)
        np.testing.assert_allclose(a.comp_crit[ok], b.comp_crit[ok],
                                   rtol=1e-5, atol=1e-9)
        if diff.size:
            tr = E.BatchedEngine(hp, device="cpu").traces(
                [name], figs.FIG9_FAULT_CELL["n_rounds"], 1,
                legacy_streams=False, per_node_for=(name,))[name]
            t = np.sort(tr.node_time_us, axis=1)
            near = np.abs(t[:, -1] - t[:, -2]) <= 1e-5 * np.abs(t[:, -1])
            assert near[diff].all(), (name, diff)
        diffs[name] = int(diff.size)
    for k in rc.fabric:
        assert np.array_equal(rd.fabric[k], rc.fabric[k]), k
    assert cd["celeris"][0].fault_steps.sum() > 0
    return {"worst_rel_diff": worst_rel(pairs, "recorded pass"),
            "critical_flow_differs_at_near_ties": diffs}


def phase_features_card_vs_cpu(dev, E, topology, figs):
    """The new features on the card against the CPU (plain scan), at
    FEATURE_CHECK_ROUNDS rounds: the priority cut, per-node traces with
    the per-step window in both stream modes, and a recorded faulted
    2-pod pass."""
    out = {"priority_cut": check_priority_cut(dev, topology, figs),
           "per_node": check_per_node(dev, E, figs),
           "recorded_fault_pass": check_recorded_pass(dev, E, figs)}
    rec = out["recorded_fault_pass"]
    print(f"new features card vs CPU, {FEATURE_CHECK_ROUNDS} rounds: "
          f"priority cut (32 nodes, 2 pods, both orders x round/phase) "
          f"worst {out['priority_cut']['worst_rel_diff']:.3g}; per-node "
          f"traces + step window worst "
          f"{ {m: v['worst_rel_diff'] for m, v in out['per_node'].items()} }"
          f"; recorded faulted 2-pod pass worst "
          f"{rec['worst_rel_diff']:.3g} (packets, "
          f"faulted flows and fabric counters equal; critical flow differs "
          f"at {rec['critical_flow_differs_at_near_ties']} near-tie steps)")
    return out


def phase_fig10(dev, figs, counts):
    """Fig. 10 on the card (fig10_priority_loss.run()'s full grid: hier on
    4 pods, 128/256/512 nodes x oversubscription 2/8, 40 rounds, the round
    window at the paper rule x 0.4, arrival against priority cuts): all 36
    keys but the wall equal to the committed ones, each cell's two orders
    sharing their round times, every high-priority loss ratio >= 2."""
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    keys, cells = figs.fig10_keys(dev)
    wall = time.perf_counter() - t0
    launches = counts.read()
    blocks = sum(t["blocks"] for _, t in cells.values())
    assert launches["dcqcn_scan"] == blocks, (launches, blocks)
    n = assert_committed("fig10", keys)
    assert n == 36, n
    ratios = {k: v for k, v in keys.items() if "_hi_loss_ratio_" in k}
    assert len(ratios) == 6, ratios
    assert min(ratios.values()) >= figs.FIG10_RATIO_BAR, ratios
    rec = {"committed_keys_equal": n, "ratios": ratios, "wall_s": wall,
           "host_s": sum(t["host_s"] for _, t in cells.values()),
           "device_s": sum(t["device_s"] for _, t in cells.values()),
           "cells": {tag: {"host_s": t["host_s"], "device_s": t["device_s"],
                           "blocks": t["blocks"],
                           "p99_ms": st["arrival"].p99 / 1e3}
                     for tag, (st, t) in cells.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    print(f"fig10 on the card (4 pods, {figs.FIG10_NODES} nodes x oversub "
          f"{figs.FIG10_OVERSUBS}, {figs.FIG10_ROUNDS} rounds): {n} fig10_* "
          f"keys == the committed ones, arrival and priority times equal in "
          f"every cell, hi-loss ratios {sorted(set(ratios.values()))} >= "
          f"{figs.FIG10_RATIO_BAR}; wall {wall:.2f} s = host "
          f"{rec['host_s']:.2f} s + device {rec['device_s']:.2f} s (+ "
          f"assembly); peak {rec['peak_mem_gib']:.2f} GiB; launches "
          f"{launches}")
    return rec


def phase_fig9(dev, figs, trace_export, counts):
    """Fig. 9 on the card (fig9_tail_attribution.run()'s full tier: the
    128-node flat ring, 60 rounds, and the 2-pod NIC-stall cell, 40
    rounds, both recorded): all 39 keys but the wall equal to the
    committed ones, ``audit_round`` passing on every recorded pass, the
    stall cell's Perfetto trace written to results/fig9_trace.json and
    validated; then both passes again with the recorder off, their stats
    equal to the recorded ones bit for bit."""
    _sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(TRACE_OUT), exist_ok=True)
    keys, info = figs.fig9_keys(dev, trace_path=TRACE_OUT)
    wall = time.perf_counter() - t0
    launches = counts.read()
    n = assert_committed("fig9", keys)
    assert n == 39, n
    with open(TRACE_OUT) as f:
        events = trace_export.validate_trace(json.load(f))
    assert events == info["trace_counts"], (events, info["trace_counts"])
    audits = {f"{cell}/{d}": a for cell, by_d in info["audits"].items()
              for d, a in by_d.items()}
    # the recorder only reads: both passes again with it off
    off, _, _ = figs.fig9_recorded_pair(info["flat_params"],
                                        figs.FIG9_ROUNDS, 0, figs.TAIL_SCALE,
                                        dev, record=False)
    off_fault, _, _ = figs.fig9_fault_cell(dev, 1, record=False)
    for on, offs in ((info["cells"], off), (info["fault_cells"], off_fault)):
        for d in ("roce", "celeris"):
            for f in RECORDED_FIELDS:
                x, y = getattr(on[d][0], f), getattr(offs[d][0], f)
                assert (x is None and y is None) or np.array_equal(x, y), (
                    f"recorder on != off: {d} {f}")
    timing = info["timing"]
    rec = {"committed_keys_equal": n, "audits": audits,
           "trace": {"path": os.path.relpath(TRACE_OUT), "events": events,
                     "bytes": os.path.getsize(TRACE_OUT)},
           "provenance_cross_fault": info["provenance"],
           "recorder_on_equals_off": True, "wall_s": wall,
           "flat_cell": {"host_s": timing["host_s"],
                         "device_s": timing["device_s"],
                         "record_bytes": timing["record_bytes"]},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    worst = max(a["time_rel_err"] for a in audits.values())
    print(f"fig9 on the card ({figs.FIG9_NODES}-node flat x "
          f"{figs.FIG9_ROUNDS} rounds + the 2-pod stall cell): {n} fig9_* "
          f"keys == the committed ones; audit_round passes on "
          f"{sorted(audits)} (worst time rel err {worst:.2g}); the stall "
          f"cell's trace {rec['trace']} validates; stats with the recorder "
          f"off == on, bit for bit; cross provenance {info['provenance']}; "
          f"wall {wall:.2f} s (flat cell host {timing['host_s']:.2f} s + "
          f"device {timing['device_s']:.2f} s, recorder copies "
          f"{timing['record_bytes']} B); peak {rec['peak_mem_gib']:.2f} GiB; "
          f"launches {launches}")
    return rec


def phase_serve_long(dev, C, M, L, serve_step, coupling, kernels, counts):
    """qwen2-0.5b at full width on a LONG_PROMPT-token prompt (batch 1):
    prefill through the tiled attention path, the coded KV transfer at
    KV_FRAC, LONG_GEN greedy tokens; the coded transfer's kernels held to
    their plain versions on its caches; and layer 0's tiled attention
    against the dense formula at that length."""
    coding = kernels[-1]
    cfg = C.get("qwen2-0.5b")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=torch.Generator(dev).manual_seed(5),
                           device=dev)
    assert LONG_PROMPT ** 2 > L.FLASH_THRESHOLD
    prefill = serve_step.make_prefill(cfg, LONG_PROMPT + LONG_GEN)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)
    prefill(params, prompt)                 # warm-up
    _sync()
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = torch.argmax(logits, -1)[:, None]
    signs = coding.rademacher(torch.Generator(dev).manual_seed(2),
                              coding.plan(caches.leaves()[0].numel(),
                                          n_rot=N_ROT))
    t0 = time.perf_counter()
    coded = serve_step.degrade_caches(caches, mask, signs=signs)
    toks = serve_step.greedy_decode(cfg, params, coded, first, LONG_PROMPT,
                                    LONG_GEN)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert torch.isfinite(logits.float()).all() and toks.shape == (1,
                                                                   LONG_GEN)
    assert launches["fwht"] >= 4 and launches["masked_unbias"] >= 2, launches
    wire_check = check_kv_wire("serve_long", caches, mask, signs, *kernels)
    del coded
    profile = profile_window(lambda: prefill(params, prompt))

    # layer 0's attention on the prompt: tiled (the prefill's path)
    # against the dense formula, whose (1, 16, 4096, 4096) float32 logits
    # take 1 GiB
    p0 = M.sub_params(params, "layers.0.")
    x = L.rmsnorm(p0["ln1.scale"],
                  L.embed(params["embed.table"], cfg, prompt), cfg.norm_eps)
    pos = torch.arange(LONG_PROMPT, device=dev)
    q, k, v = L.qkv(M.sub_params(p0, "attn."), cfg, x, pos[None])
    rep = cfg.n_heads_padded // cfg.n_kv_heads
    k_rep, v_rep = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    causal = pos[None, None, None, :] <= pos[None, None, :, None]

    def tiled_fn():
        return L.tiled_attention(q, k_rep, v_rep, qpos=pos, kpos=pos)

    def sdpa_fn():
        # the library yardstick, timed only: the same causal attention on
        # the same q/k/v, without the bf16 rounding of the probabilities
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k_rep.transpose(1, 2),
            v_rep.float().transpose(1, 2), is_causal=True).transpose(1, 2)

    tiled = tiled_fn()
    dense = L.dense_attention(q, k, v, causal).float()
    scale = dense.abs().max().item()
    err = (tiled - dense).abs().max().item()
    assert err <= LONG_ATTN_RTOL * scale, (err, scale)
    sdpa_err = (sdpa_fn() - dense).abs().max().item()
    ms = {"tiled": time_ms(tiled_fn),
          "dense": time_ms(lambda: L.dense_attention(q, k, v, causal)),
          "sdpa_library": time_ms(sdpa_fn)}
    rec = {"model": cfg.name, "prompt": LONG_PROMPT, "gen": LONG_GEN,
           "prefill_ms": prefill_ms, "prefill_peak_mem_gib": prefill_peak,
           "decode_s": decode_s, "peak_mem_gib": peak,
           "prefill_profile": profile, "wire_check": wire_check,
           "tiled_vs_dense_max_abs_err": err, "dense_max_abs": scale,
           "sdpa_vs_dense_max_abs_err": sdpa_err,
           "tolerance": f"{LONG_ATTN_RTOL} x max |dense|",
           "layer0_attention_ms": ms, "launches": launches}
    print(f"long prompt {LONG_PROMPT} tokens, qwen2-0.5b full width: prefill "
          f"{prefill_ms:.1f} ms (peak {prefill_peak:.2f} GiB; {profile}), "
          f"coded KV + {LONG_GEN} tokens {decode_s:.2f} s; its kernels vs "
          f"plain: {wire_check}; layer 0 tiled vs "
          f"dense max abs err {err:.3g} (max |dense| {scale:.3g}, bar "
          f"{LONG_ATTN_RTOL} x it; SDPA {sdpa_err:.3g}); layer 0 attention "
          f"ms {ms}; launches {launches}")
    return rec


# phase 19c: gemma2-9b on a prompt longer than its 4,096-token window,
# then a teacher-forced forward over prompt + generated tokens padded
# with filler to a multiple of the tiled path's 1,024-token q tile
GEMMA2_LONG_PROMPT, GEMMA2_FORCED_LEN = 8192, 9216
RING_DECODE_BAR = 0.05         # tests/test_models.py:78-79's bar


def forced_decode_check(cfg, params, M, serve_step, prompt, extra,
                        n_steps=LONG_GEN, pad_to=None):
    """Prefill ``prompt`` with the frontend inputs ``extra`` (clean
    caches), then ``n_steps`` greedy decode steps from position n_front
    + S (the ``memory`` of ``extra`` read by each), every step's logits
    against a teacher-forced forward over the prompt and the tokens fed,
    with the same ``extra``, at that position (``pad_to``: filler after
    them, which the causal masks keep out; only those positions are
    unembedded), within RING_DECODE_BAR of the largest logit
    (``tests/test_models.py:78``'s bar).  Returns the errors."""
    memory = extra.get("memory")
    n_ctx = cfg.n_front + prompt.shape[1]
    logits, caches = serve_step.make_prefill(cfg, n_ctx + n_steps)(
        params, prompt, **extra)
    decode = serve_step.make_decode(cfg)
    tok, fed, got = torch.argmax(logits, -1)[:, None], [], []
    for i in range(n_steps):
        fed.append(tok)
        lg, caches = decode(params, caches, tok, n_ctx + i, memory)
        got.append(lg.float())
        tok = torch.argmax(lg, -1)[:, None]
    del caches, lg
    seq = torch.cat([prompt] + fed, dim=1)
    if pad_to is not None:
        seq = torch.nn.functional.pad(seq, (0, pad_to - seq.shape[1]))
    want = M.head(params, cfg, M.hidden(params, cfg, seq, **extra)[
        :, n_ctx:n_ctx + n_steps])
    errs = []
    for i, g in enumerate(got):
        w = want[:, i].float()
        errs.append((g - w).abs().max().item() / max(1.0, w.abs().max()
                                                     .item()))
        assert torch.isfinite(g).all() and errs[-1] < RING_DECODE_BAR, (
            cfg.name, i, errs)
    return errs


def phase_serve_gemma2(dev, C, M, L, serve_step, coupling, kernels, counts):
    """gemma2-9b at full width: the 8 x 512 serve path
    (``phase_main_path``, its KV leaves' kernels held to their plain
    versions and timed), then the long prompt (``phase_serve_gemma2_long``)
    on the same weights.  Returns both records and the kernel timing
    records at the serve path's KV shapes."""
    cfg = C.get("gemma2-9b")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    serve = phase_main_path(dev, C, M, serve_step, coupling, counts,
                            arch="gemma2-9b", params=params,
                            wire_kernels=kernels)
    records = serve["wire_check"].pop("records")
    torch.cuda.empty_cache()
    long = phase_serve_gemma2_long(dev, cfg, params, M, L, serve_step,
                                   coupling, kernels, counts)
    return serve, long, records


def attention_check(dev, cfg, params, M, L, prompt, layer):
    """Layer ``layer``'s attention on ``prompt``: the tiled path (the
    prefill's, with the layer's softcap and window) against the dense
    formula, whose (1, H, S, S) float32 logits are built whole, within
    LONG_ATTN_RTOL of the largest dense output; both timed.  No library
    yardstick (SDPA takes no softcap)."""
    sub = dataclasses.replace(cfg, n_layers=layer)
    x = (M.hidden(params, sub, prompt) if layer else
         L.embed(params["embed.table"], cfg, prompt))
    p = M.sub_params(params, f"layers.{layer}.")
    h = L.rmsnorm(p["ln1.scale"], x, cfg.norm_eps)
    del x
    n = prompt.shape[1]
    pos = torch.arange(n, device=dev)
    q, k, v = L.qkv(M.sub_params(p, "attn."), cfg, h, pos[None])
    rep = cfg.n_heads_padded // cfg.n_kv_heads
    k_rep, v_rep = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    kind = cfg.block_pattern[layer % len(cfg.block_pattern)]
    window = cfg.window_size if kind == "local" else None
    kp, qp = pos[None, None, None, :], pos[None, None, :, None]
    mask = (kp <= qp) & (kp > qp - window) if window else kp <= qp

    def tiled_fn():
        return L.tiled_attention(q, k_rep, v_rep, qpos=pos, kpos=pos,
                                 softcap=cfg.attn_softcap, window=window)

    def dense_fn():
        return L.dense_attention(q, k, v, mask, cfg.attn_softcap)

    tiled, dense = tiled_fn(), dense_fn().float()
    scale = dense.abs().max().item()
    err = (tiled - dense).abs().max().item()
    assert err <= LONG_ATTN_RTOL * scale, (layer, kind, err, scale)
    del tiled, dense
    return {"kind": kind, "window": window, "max_abs_err": err,
            "dense_max_abs": scale, "tiled_ms": time_ms(tiled_fn),
            "dense_ms": time_ms(dense_fn),
            "library_ms": None,
            "library": ("none: SDPA takes no softcap" if cfg.attn_softcap
                        else "none timed")}


def phase_serve_gemma2_long(dev, cfg, params, M, L, serve_step, coupling,
                            kernels, counts):
    """gemma2-9b at full width on a GEMMA2_LONG_PROMPT-token prompt (batch
    1), past its 4,096-token window: prefill through the tiled path with
    local masks and the softcap, the ring caches wrapped (local leaves
    4,096 slots, global ones prompt + LONG_GEN); the coded KV transfer
    and LONG_GEN greedy tokens through the ring; the transfer's kernels
    held to their plain versions on its caches; layer 0 (local) and
    layer 1 (global) tiled attention against the dense formula; and the
    clean caches' decode through the ring against a teacher-forced
    forward at the last position."""
    coding = kernels[-1]
    n = GEMMA2_LONG_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (1, n),
                           generator=torch.Generator(dev).manual_seed(5),
                           device=dev)
    assert n > cfg.window_size and n % 1024 == 0
    prefill = serve_step.make_prefill(cfg, n + LONG_GEN)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)
    prefill(params, prompt)                 # warm-up
    _sync()
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = torch.argmax(logits, -1)[:, None]
    signs = coding.rademacher(torch.Generator(dev).manual_seed(2),
                              coding.plan(caches.leaves()[0].numel(),
                                          n_rot=N_ROT))
    t0 = time.perf_counter()
    coded = serve_step.degrade_caches(caches, mask, signs=signs)
    _sync()
    degrade_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    toks = serve_step.greedy_decode(cfg, params, coded, first, n, LONG_GEN)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots = [t.shape[2] for t in caches.leaves()]
    assert slots == [cfg.window_size] * 2 + [n + LONG_GEN] * 2, slots
    assert torch.isfinite(logits.float()).all() and toks.shape == (1,
                                                                   LONG_GEN)
    n_leaves = len(caches.leaves())
    assert (launches["fwht"] >= 2 * n_leaves
            and launches["masked_unbias"] >= n_leaves), launches
    wire_check = check_kv_wire("serve_gemma2_long", caches, mask, signs,
                               *kernels)
    del coded
    profile = profile_window(lambda: prefill(params, prompt))

    # decode through the wrapped ring from the clean caches, then one
    # more step feeding the last token, at position n + LONG_GEN - 1,
    # against a teacher-forced forward over the same tokens; filler
    # after them pads the forward to GEMMA2_FORCED_LEN (causal masks keep
    # it out of that position), and only that position is unembedded
    clean_toks = serve_step.greedy_decode(cfg, params, caches, first, n,
                                          LONG_GEN)
    last = n + LONG_GEN - 1
    got, _ = serve_step.make_decode(cfg)(params, caches, clean_toks[:, -1:],
                                         last)
    del caches
    seq = torch.cat([prompt, clean_toks], dim=1)
    seq = torch.nn.functional.pad(seq, (0, GEMMA2_FORCED_LEN - seq.shape[1]))
    want = M.head(params, cfg, M.hidden(params, cfg, seq)[:, last:last + 1])
    got, want = got.float(), want[:, 0].float()
    ring_scale = max(1.0, want.abs().max().item())
    ring_err = (got - want).abs().max().item() / ring_scale
    assert torch.isfinite(got).all() and ring_err < RING_DECODE_BAR, (
        ring_err, ring_scale)
    del seq, want
    torch.cuda.empty_cache()

    attention = {f"layer{i}": attention_check(dev, cfg, params, M, L, prompt,
                                              i) for i in (0, 1)}
    rec = {"model": cfg.name, "prompt": n, "gen": LONG_GEN,
           "kv_leaf_slots": slots, "prefill_ms": prefill_ms,
           "prefill_peak_mem_gib": prefill_peak,
           "degrade_caches_ms": degrade_ms, "decode_s": decode_s,
           "peak_mem_gib": peak, "prefill_profile": profile,
           "wire_check": wire_check,
           "ring_decode_vs_forced_rel_err": ring_err,
           "ring_decode_bar": f"{RING_DECODE_BAR} x max(1, max |logits|)",
           "forced_len": GEMMA2_FORCED_LEN,
           "attention": attention,
           "tolerance": f"{LONG_ATTN_RTOL} x max |dense|",
           "launches": launches}
    print(f"long prompt {n} tokens, gemma2-9b full width: prefill "
          f"{prefill_ms:.1f} ms (peak {prefill_peak:.2f} GiB; {profile}), "
          f"coded KV {degrade_ms:.1f} ms + {LONG_GEN} tokens {decode_s:.2f} "
          f"s; ring slots {slots}; its kernels vs plain: {wire_check}; ring "
          f"decode vs teacher-forced forward rel err {ring_err:.3g} (bar "
          f"{RING_DECODE_BAR}); attention {attention}; launches {launches}")
    return rec


# phase 19d: the rest of the dense family at full width
DENSE_ARCHS = ("chatglm3-6b", "nemotron-4-15b")


def phase_serve_dense(dev, C, M, serve_step, coupling, kernels, counts, arch):
    """``arch`` at full width through ``phase_main_path``'s 8 x 512 path
    and bars, its KV leaves' kernels held to their plain versions; the
    weights freed after.  Returns the record and the kernel timing
    records at its KV shapes."""
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts, arch=arch,
                          wire_kernels=kernels)
    records = rec["wire_check"].pop("records")
    rec.pop("profile")      # printed above; the record stays compact
    torch.cuda.empty_cache()
    return rec, records


MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")


def phase_serve_moe(dev, C, M, serve_step, coupling, kernels, counts, arch):
    """Phases 19e/19f: the MoE model ``arch`` at full width through
    ``phase_main_path``'s 8 x 512 path and bars (each MoE layer runs
    global attention and the local expert dispatch, as one device does),
    its KV leaves' kernels held to their plain versions; then one more
    prefill counts the picks each layer's expert capacity dropped.  The
    weights freed after.  Returns the record and the kernel timing
    records at its KV shapes."""
    from repro_torch.models import moe as MOE
    cfg = C.get(arch)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts, arch=arch,
                          params=params, wire_kernels=kernels)
    records = rec["wire_check"].pop("records")
    rec.pop("profile")      # printed above; the record stays compact
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    MOE.drop_log = []
    try:
        serve_step.make_prefill(cfg, PROMPT + GEN)(params, prompt)
        dropped = [int(t) for t in MOE.drop_log]
    finally:
        MOE.drop_log = None
    picks = BATCH * PROMPT * cfg.moe.top_k
    rec["capacity"] = MOE._capacity(cfg, BATCH * PROMPT, 1)
    rec["picks_dropped_by_capacity"] = dropped
    rec["picks_per_layer"] = picks
    rec["dropped_share"] = sum(dropped) / (picks * cfg.n_layers)
    assert len(dropped) == cfg.n_layers, dropped
    print(f"{cfg.name}: {MOE.padded_experts(cfg)} padded experts, capacity "
          f"{rec['capacity']} a prefill of {BATCH}x{PROMPT}; picks dropped by "
          f"capacity per layer {dropped} of {picks} "
          f"({rec['dropped_share']:.4f}); prefill {rec['prefill_ms']:.1f} ms,"
          f" decode {rec['decode_tok_per_s']:.1f} tok/s, KV transfer "
          f"{rec['degrade_caches_ms']:.1f} ms, peak {rec['peak_mem_gib']:.2f}"
          f" GiB [{card_name_and_power()}]")
    del params
    torch.cuda.empty_cache()
    return rec, records


# phases 19g-19i: the recurrent families at full width
RG_ARCH, XLSTM_ARCH = "recurrentgemma-9b", "xlstm-350m"
# 19h: one 4,096-token prompt (8 RG-LRU chunks of 512, the local rings'
# 2,048 slots wrapped, tiled attention), then a teacher-forced forward
# over prompt + generated tokens padded with filler to a multiple of the
# tiled path's 1,024-token q tile
RG_LONG_PROMPT, RG_FORCED_LEN = 4096, 5120


def loop_shares(run, targets):
    """One call of ``run`` (a prefill) with each ``(module, name)`` of
    ``targets`` (a recurrent loop: the RG-LRU doubling scan, the
    chunkwise mLSTM, the sLSTM time loop) wrapped in a synchronize on
    each side: per loop its calls, host-clock ms and share of that
    call's wall, and the device kernels one call launches (a profiled
    call on the first call's inputs) times the calls.  The synchronizes
    cost the wrapped call its overlap, so the shares are upper bounds."""
    saved, stats = {}, {}
    for mod, name in targets:
        fn = saved[name] = getattr(mod, name)
        st = stats[name] = {"calls": 0, "s": 0.0, "first": None}

        def wrapped(*a, _fn=fn, _st=st, **k):
            _sync()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _sync()
            _st["s"] += time.perf_counter() - t0
            _st["calls"] += 1
            if _st["first"] is None:
                _st["first"] = (a, k)
            return out
        setattr(mod, name, wrapped)
    try:
        _sync()
        t0 = time.perf_counter()
        run()
        _sync()
        wall = time.perf_counter() - t0
    finally:
        for mod, name in targets:
            setattr(mod, name, saved[name])
    out = {"wall_ms": wall * 1e3}
    for _, name in targets:
        st = stats[name]
        a, k = st.pop("first")
        one = profile_window(lambda: saved[name](*a, **k))
        per_call = one.get("n_kernel_launches", "not measured")
        out[name] = {"calls": st["calls"], "ms": st["s"] * 1e3,
                     "share": st["s"] / wall,
                     "launches_per_call": per_call,
                     "launches": (per_call * st["calls"]
                                  if isinstance(per_call, int)
                                  else per_call)}
        del a, k
    return out


def phase_serve_recurrentgemma(dev, C, M, L, serve_step, coupling, kernels,
                               counts):
    """Phases 19g-19h: recurrentgemma-9b at full width.  19g: the 8 x 512
    serve path (``phase_main_path``; its two K/V leaves, the 12 local
    layers' rings stacked, each its own payload: exactly 4 FWHT and 2
    unbias launches, held to their plain versions and timed), and the
    RG-LRU scan's share of one prefill.  19h (``phase_serve_rg_long``) on
    the same weights.  Returns both records and the kernel timing
    records at the serve path's KV shapes."""
    from repro_torch.models import rglru as RG
    cfg = C.get(RG_ARCH)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    serve = phase_main_path(dev, C, M, serve_step, coupling, counts,
                            arch=RG_ARCH, params=params,
                            wire_kernels=kernels)
    records = serve["wire_check"].pop("records")
    want = {"fwht": 4, "masked_unbias": 2, "fwht_quantize": 0,
            "quantize_int8": 0, "dcqcn_scan": 0}
    assert serve["launches"] == want, serve["launches"]
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    prefill = serve_step.make_prefill(cfg, PROMPT + GEN)
    serve["loops"] = loop_shares(lambda: prefill(params, prompt),
                                 [(RG, "linear_scan")])
    print(f"{cfg.name} 8 x {PROMPT}: the RG-LRU scan in one prefill "
          f"{serve['loops']} [{card_name_and_power()}]")
    del prompt
    torch.cuda.empty_cache()
    long = phase_serve_rg_long(dev, cfg, params, M, L, serve_step, coupling,
                               kernels, counts)
    del params
    torch.cuda.empty_cache()
    return serve, long, records


def phase_serve_rg_long(dev, cfg, params, M, L, serve_step, coupling,
                        kernels, counts):
    """Phase 19h: recurrentgemma-9b on RG_LONG_PROMPT tokens (batch 1):
    the prefill runs JAX's chunked RG-LRU scan (8 chunks of 512) and the
    tiled attention, its local rings wrapped (2,048 slots); the coded KV
    transfer and LONG_GEN greedy tokens; the kernels held to their plain
    versions on its caches; layer 2's (local) tiled attention against
    the dense formula; and every decode step from the clean caches
    against a teacher-forced forward (padded with filler to
    RG_FORCED_LEN) at its position, within RING_DECODE_BAR of the
    largest logit."""
    from repro_torch.models import rglru as RG
    coding = kernels[-1]
    n = RG_LONG_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (1, n),
                           generator=torch.Generator(dev).manual_seed(5),
                           device=dev)
    assert n ** 2 > L.FLASH_THRESHOLD and n % RG.CHUNK == 0
    prefill = serve_step.make_prefill(cfg, n + LONG_GEN)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)
    prefill(params, prompt)                 # warm-up
    _sync()
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = torch.argmax(logits, -1)[:, None]
    signs = coding.rademacher(torch.Generator(dev).manual_seed(2),
                              coding.plan(caches.leaves()[0].numel(),
                                          n_rot=N_ROT))
    t0 = time.perf_counter()
    coded = serve_step.degrade_caches(caches, mask, signs=signs)
    _sync()
    degrade_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    toks = serve_step.greedy_decode(cfg, params, coded, first, n, LONG_GEN)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots = [t.shape[2] for t in caches.leaves()]
    assert slots == [cfg.window_size] * 2, slots
    assert torch.isfinite(logits.float()).all() and toks.shape == (1,
                                                                   LONG_GEN)
    assert launches == {"fwht": 4, "masked_unbias": 2, "fwht_quantize": 0,
                        "quantize_int8": 0, "dcqcn_scan": 0}, launches
    wire_check = check_kv_wire("serve_rg_long", caches, mask, signs,
                               *kernels)
    del coded
    profile = profile_window(lambda: prefill(params, prompt))
    loops = loop_shares(lambda: prefill(params, prompt),
                        [(RG, "linear_scan")])
    n_rglru = sum(k == "rglru" for k in (
        cfg.block_pattern * cfg.n_layers)[:cfg.n_layers])
    assert loops["linear_scan"]["calls"] == n_rglru * n // RG.CHUNK, loops

    del caches
    errs = forced_decode_check(cfg, params, M, serve_step, prompt, {},
                               pad_to=RG_FORCED_LEN)
    torch.cuda.empty_cache()
    attention = {"layer2": attention_check(dev, cfg, params, M, L, prompt,
                                           2)}
    rec = {"model": cfg.name, "prompt": n, "gen": LONG_GEN,
           "kv_leaf_slots": slots, "prefill_ms": prefill_ms,
           "prefill_peak_mem_gib": prefill_peak,
           "degrade_caches_ms": degrade_ms, "decode_s": decode_s,
           "peak_mem_gib": peak, "prefill_profile": profile,
           "loops": loops, "wire_check": wire_check,
           "decode_vs_forced_rel_err": errs,
           "decode_bar": f"{RING_DECODE_BAR} x max(1, max |logits|)",
           "forced_len": RG_FORCED_LEN, "attention": attention,
           "tolerance": f"{LONG_ATTN_RTOL} x max |dense|",
           "launches": launches}
    print(f"long prompt {n} tokens, {cfg.name} full width: prefill "
          f"{prefill_ms:.1f} ms (peak {prefill_peak:.2f} GiB; {profile}); "
          f"RG-LRU scan {loops}; coded KV {degrade_ms:.1f} ms + {LONG_GEN} "
          f"tokens {decode_s:.2f} s; ring slots {slots}; its kernels vs "
          f"plain: {wire_check}; decode vs teacher-forced forward rel err "
          f"max {max(errs):.3g} over {LONG_GEN} steps (bar "
          f"{RING_DECODE_BAR}); attention {attention}; launches {launches} "
          f"[{card_name_and_power()}]")
    return rec


def phase_serve_xlstm(dev, C, M, serve_step, coupling, counts):
    """Phase 19i: xlstm-350m at full width through ``phase_main_path``'s
    8 x 512 path and bars.  It has no K/V leaf: no kernel may launch on
    the path, and ``degrade_caches`` must hand back the prefill's
    caches bit for bit.  Then the mLSTM's and the sLSTM's shares of one
    prefill."""
    from repro_torch.models import xlstm as XL
    cfg = C.get(XLSTM_ARCH)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts,
                          arch=XLSTM_ARCH, params=params)
    assert not rec["kv_leaves"], rec["kv_leaves"]
    assert not any(rec["launches"].values()), rec["launches"]
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    prefill = serve_step.make_prefill(cfg, PROMPT + GEN)
    _, clean = prefill(params, prompt)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)
    counts.reset()
    shipped = serve_step.degrade_caches(clean, mask,
                                        torch.Generator(dev).manual_seed(2))
    assert not any(counts.read().values())
    for a, b in zip(shipped.nodes(), clean.nodes()):
        for x, y in zip(a.tensors(), b.tensors()):
            assert torch.equal(x, y), "degrade_caches changed xLSTM state"
    rec["degrade_unchanged_nodes"] = len(clean.nodes())
    del shipped, clean
    rec["loops"] = loop_shares(lambda: prefill(params, prompt),
                               [(XL, "mlstm_parallel"), (XL, "slstm_scan")])
    rec.pop("profile")      # printed above; the record stays compact
    print(f"{cfg.name} 8 x {PROMPT}: no K/V leaf, 0 kernel launches, caches "
          f"unchanged by degrade_caches; prefill {rec['prefill_ms']:.1f} "
          f"ms, decode {rec['decode_tok_per_s']:.1f} tok/s, peak "
          f"{rec['peak_mem_gib']:.2f} GiB; loops in one prefill "
          f"{rec['loops']} [{card_name_and_power()}]")
    del params, prompt
    torch.cuda.empty_cache()
    return rec


# phases 19j-19l: the modality stubs at full width
VISION_ARCH, AUDIO_ARCH = "phi-3-vision-4.2b", "seamless-m4t-medium"
# a K/V transfer of a tree with two K/V leaves, and no other kernel
TRANSFER_LAUNCHES = {"fwht": 4, "masked_unbias": 2, "fwht_quantize": 0,
                     "quantize_int8": 0, "dcqcn_scan": 0}
# 19l: one 4,096-frame, 4,096-token request (the encoder's and the
# cross-attention's non-causal tiled paths at 4,096 x 4,096); the
# teacher-forced forward pads prompt + generated tokens with filler to a
# multiple of the tiled path's 1,024-token q tile
AUDIO_LONG, AUDIO_FORCED_LEN = 4096, 5120


def phase_serve_phi3_vision(dev, C, M, serve_step, coupling, kernels,
                            counts):
    """Phase 19j: phi-3-vision-4.2b at full width (32 layers, d 3072, 32
    heads of 96, untied vocab 32,064, bf16, random weights from seed 0):
    BATCH x PROMPT text tokens after 144 image positions (image_embeds
    (8, 144, 1024) standard normal from seed 3, as the launcher draws
    them) through ``phase_main_path``'s path and bars over n_ctx = 656
    positions, the image's included.  Its two K/V leaves, (32, 8, 688,
    32, 96), are the largest payloads the transfer ships (541,065,216
    values, 2.16 GB as float32): exactly 4 FWHT and 2 unbias launches,
    the kernels held to their plain versions and timed at (8,454,144,
    64).  Then LONG_GEN decode steps from position 656 against a
    teacher-forced forward with the same image.  Returns the record and
    the kernel timing records."""
    cfg = C.get(VISION_ARCH)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    extra = serve_step.frontend_inputs(cfg, BATCH, PROMPT,
                                       torch.Generator(dev).manual_seed(3))
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts,
                          arch=VISION_ARCH, params=params,
                          wire_kernels=kernels, extra=extra)
    records = rec["wire_check"].pop("records")
    assert rec["launches"] == TRANSFER_LAUNCHES, rec["launches"]
    n_ctx = cfg.n_front + PROMPT
    assert rec["kv_leaves"] == [[cfg.n_layers, BATCH, n_ctx + GEN,
                                 cfg.n_kv_heads,
                                 cfg.resolved_head_dim]] * 2, rec["kv_leaves"]
    rec.pop("profile")      # printed above; the record stays compact
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    rec["decode_vs_forced_rel_err"] = forced_decode_check(
        cfg, params, M, serve_step, prompt, extra)
    rec["decode_bar"] = f"{RING_DECODE_BAR} x max(1, max |logits|)"
    print(f"{cfg.name} {BATCH} x ({cfg.n_front} + {PROMPT}): prefill "
          f"{rec['prefill_ms']:.1f}"
          f" ms, KV transfer {rec['degrade_caches_ms']:.1f} ms over leaves "
          f"{rec['kv_leaves']}, decode {rec['decode_tok_per_s']:.1f} tok/s, "
          f"peak {rec['peak_mem_gib']:.2f} GiB; {LONG_GEN} steps from "
          f"{n_ctx} vs teacher-forced forward rel err max "
          f"{max(rec['decode_vs_forced_rel_err']):.3g} (bar {RING_DECODE_BAR})"
          f" [{card_name_and_power()}]")
    del params, extra, prompt
    torch.cuda.empty_cache()
    return rec, records


def timed_encode(M, params, cfg, frames):
    """The encoder on ``frames``: (memory, host ms ending in a
    synchronize, one profiled call), after a warm-up call."""
    M.encode(params, cfg, frames)
    _sync()
    t0 = time.perf_counter()
    memory = M.encode(params, cfg, frames)
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    return memory, ms, profile_window(lambda: M.encode(params, cfg, frames))


def phase_serve_seamless(dev, C, M, L, serve_step, coupling, kernels,
                         counts):
    """Phase 19k: seamless-m4t-medium at full width (12 encoder and 12
    decoder layers, d 1024, 16 heads of 64, tied vocab 256,206, bf16,
    random weights from seed 0): BATCH x PROMPT frames (standard normal
    from seed 3) encoded once (timed and profiled apart), then
    ``phase_main_path``'s BATCH x PROMPT path and bars with that
    ``memory`` at prefill and every decode step: the decoder's two K/V
    leaves, exactly 4 FWHT and 2 unbias launches, the kernels held to
    their plain versions and timed at (835,584, 64); ``memory`` is no
    payload and must come through the path bit for bit.  Then
    LONG_GEN decode steps against a teacher-forced forward with the
    memory, and the share of a decode step that computes the cross K/V
    from the memory anew (``loop_shares`` over ``layers.cross_kv``).
    Returns the record, the kernel timing records and the weights, which
    phase 19l reuses."""
    cfg = C.get(AUDIO_ARCH)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    frames = serve_step.frontend_inputs(
        cfg, BATCH, PROMPT, torch.Generator(dev).manual_seed(3))[
            "frame_embeds"]
    memory, encode_ms, encode_profile = timed_encode(M, params, cfg, frames)
    before = memory.clone()
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts,
                          arch=AUDIO_ARCH, params=params,
                          wire_kernels=kernels, extra={"memory": memory})
    records = rec["wire_check"].pop("records")
    assert rec["launches"] == TRANSFER_LAUNCHES, rec["launches"]
    assert torch.equal(memory, before), "the path changed the encoder memory"
    rec.pop("profile")      # printed above; the record stays compact
    rec["encode_ms"], rec["encode_profile"] = encode_ms, encode_profile
    rec["prefill_with_encoder_ms"] = encode_ms + rec["prefill_ms"]
    rec["memory"] = {"shape": list(memory.shape), "dtype": str(memory.dtype),
                     "mib": memory.numel() * memory.element_size() / 2 ** 20,
                     "shipped": False, "unchanged": True}
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    rec["decode_vs_forced_rel_err"] = forced_decode_check(
        cfg, params, M, serve_step, prompt, {"memory": memory})
    rec["decode_bar"] = f"{RING_DECODE_BAR} x max(1, max |logits|)"

    # the cross K/V a decode step recomputes from the memory
    steps = 4
    logits, caches = serve_step.make_prefill(cfg, PROMPT + steps)(
        params, prompt, memory=memory)
    first = torch.argmax(logits, -1)[:, None]
    decode = serve_step.make_decode(cfg)

    def decode_steps():
        c, tok = caches.clone(), first
        for i in range(steps):
            lg, c = decode(params, c, tok, PROMPT + i, memory)
            tok = torch.argmax(lg, -1)[:, None]

    decode_steps()                          # warm-up
    rec["cross_kv"] = loop_shares(decode_steps, [(L, "cross_kv")])
    rec["cross_kv"]["decode_steps"] = steps
    print(f"{cfg.name} {BATCH} x {PROMPT}: encode {encode_ms:.1f} ms + prefill "
          f"{rec['prefill_ms']:.1f} ms, KV transfer "
          f"{rec['degrade_caches_ms']:.1f} ms over leaves {rec['kv_leaves']}"
          f" (memory {rec['memory']['shape']} {rec['memory']['mib']:g} MiB "
          f"not shipped, unchanged), decode {rec['decode_tok_per_s']:.1f} "
          f"tok/s, peak {rec['peak_mem_gib']:.2f} GiB; {LONG_GEN} steps "
          f"vs teacher-forced forward rel err max "
          f"{max(rec['decode_vs_forced_rel_err']):.3g}; cross K/V in "
          f"{steps} decode steps {rec['cross_kv']} [{card_name_and_power()}]")
    del memory, before, frames, prompt, caches
    torch.cuda.empty_cache()
    return rec, records, params


def noncausal_check(L, q, k, v):
    """One non-causal attention, q (1, S, H, Dh) against k/v (1, S_kv,
    KV, Dh): the tiled path (kv repeated to q's heads, no causal mask)
    against the dense formula with no mask, within LONG_ATTN_RTOL of the
    largest dense output; tiled, dense and the library yardstick (SDPA,
    float32, no mask: these layers have no softcap) timed."""
    rep = q.shape[2] // k.shape[2]
    k_rep, v_rep = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)

    def tiled_fn():
        return L.tiled_attention(q, k_rep, v_rep, qpos=qpos, kpos=kpos,
                                 causal=False)

    def dense_fn():
        return L.dense_attention(q, k, v, None)

    def sdpa_fn():
        return torch.nn.functional.scaled_dot_product_attention(
            q.float().transpose(1, 2), k_rep.float().transpose(1, 2),
            v_rep.float().transpose(1, 2)).transpose(1, 2)

    tiled, dense = tiled_fn(), dense_fn().float()
    scale = dense.abs().max().item()
    err = (tiled - dense).abs().max().item()
    assert err <= LONG_ATTN_RTOL * scale, (err, scale)
    sdpa_err = (sdpa_fn() - dense).abs().max().item()
    del tiled, dense
    return {"shape": [list(q.shape), list(k.shape)], "max_abs_err": err,
            "dense_max_abs": scale, "sdpa_vs_dense_max_abs_err": sdpa_err,
            "tiled_ms": time_ms(tiled_fn), "dense_ms": time_ms(dense_fn),
            "library_ms": time_ms(sdpa_fn),
            "library": "SDPA, float32, no mask"}


def encdec_attention_check(cfg, params, M, L, frames, prompt, memory):
    """Layer 0's two non-causal tiled attentions at phase 19l's length
    (``noncausal_check``): the encoder's self-attention (rotary, no
    mask) on the projected frames, and the decoder's cross-attention
    (no rotary, no mask) on layer 0's input to it, after its
    self-attention, against the encoder's memory."""
    eps = cfg.norm_eps
    enc = M.sub_params(params, "encoder.layers.0.")
    x = frames.to(L.dtype_of(cfg)) @ params["frontend_proj"]
    pos = torch.arange(x.shape[1], device=x.device)[None]
    q, k, v = L.qkv(M.sub_params(enc, "attn."), cfg,
                    L.rmsnorm(enc["ln1.scale"], x, eps), pos)
    out = {"encoder_layer0": noncausal_check(L, q, k, v)}
    del q, k, v
    dec = M.sub_params(params, "layers.0.")
    x = L.embed(params["embed.table"], cfg, prompt)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x = x + L.attention(M.sub_params(dec, "attn."), cfg,
                        L.rmsnorm(dec["ln1.scale"], x, eps), positions=pos)
    xattn = M.sub_params(dec, "xattn.")
    q, _, _ = L.project(xattn, cfg, L.rmsnorm(dec["lnx.scale"], x, eps))
    k, v = L.cross_kv(xattn, cfg, memory)
    out["cross_layer0"] = noncausal_check(L, q, k, v)
    return out


def phase_serve_seamless_long(dev, C, params, M, L, serve_step, coupling,
                              kernels, counts):
    """Phase 19l: seamless-m4t-medium on AUDIO_LONG frames and AUDIO_LONG
    tokens (batch 1, phase 19k's weights): the encoder's bidirectional
    self-attention at 4,096 x 4,096 and the decoder's self- and
    cross-attention on the tiled path; then ``phase_main_path``'s path
    and bars with that memory (LONG_GEN tokens; exactly 4 FWHT and 2
    unbias launches, its kernels held to their plain versions); layer
    0's tiled encoder attention and tiled cross-attention against the
    dense formula (``encdec_attention_check``); and LONG_GEN decode
    steps against a teacher-forced forward (padded with filler to
    AUDIO_FORCED_LEN tokens) with the memory.  Returns the record and
    the kernel timing records."""
    cfg = C.get(AUDIO_ARCH)
    n = AUDIO_LONG
    assert n * n > L.FLASH_THRESHOLD and n % 1024 == 0
    frames = serve_step.frontend_inputs(
        cfg, 1, n, torch.Generator(dev).manual_seed(4))["frame_embeds"]
    memory, encode_ms, encode_profile = timed_encode(M, params, cfg, frames)
    before = memory.clone()
    rec = phase_main_path(dev, C, M, serve_step, coupling, counts,
                          arch=AUDIO_ARCH, params=params,
                          wire_kernels=kernels, extra={"memory": memory},
                          batch=1, prompt_len=n, gen=LONG_GEN)
    records = rec["wire_check"].pop("records")
    assert rec["launches"] == TRANSFER_LAUNCHES, rec["launches"]
    assert torch.equal(memory, before), "the path changed the encoder memory"
    del before
    rec["encode_ms"], rec["encode_profile"] = encode_ms, encode_profile
    rec["prefill_with_encoder_ms"] = encode_ms + rec["prefill_ms"]
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (1, n),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    rec["decode_vs_forced_rel_err"] = forced_decode_check(
        cfg, params, M, serve_step, prompt, {"memory": memory},
        pad_to=AUDIO_FORCED_LEN)
    rec["decode_bar"] = f"{RING_DECODE_BAR} x max(1, max |logits|)"
    rec["forced_len"] = AUDIO_FORCED_LEN
    torch.cuda.empty_cache()
    rec["attention"] = encdec_attention_check(cfg, params, M, L, frames,
                                              prompt, memory)
    rec["tolerance"] = f"{LONG_ATTN_RTOL} x max |dense|"
    print(f"long request {n} frames + {n} tokens, {cfg.name} full width: "
          f"encode {encode_ms:.1f} ms + prefill {rec['prefill_ms']:.1f} ms "
          f"({rec['profile']['prefill']}), KV transfer "
          f"{rec['degrade_caches_ms']:.1f} ms, {LONG_GEN} tokens "
          f"{rec['decode_s']:.2f} s, peak {rec['peak_mem_gib']:.2f} GiB; "
          f"decode vs teacher-forced forward rel err max "
          f"{max(rec['decode_vs_forced_rel_err']):.3g}; attention "
          f"{rec['attention']}; launches {rec['launches']} "
          f"[{card_name_and_power()}]")
    rec.pop("profile")
    del memory, frames, prompt
    torch.cuda.empty_cache()
    return rec, records


# phase 19m: serving on a (data, model) mesh, four ranks on the one card
# over gloo in one launch, every cell at full width: an 8 x 512 global
# prompt, the KV coded at delivered fraction 0.9, 16 decode steps.  Depth
# cut only to keep the phase in budget (qwen2-0.5b whole on (2, 2) and 4
# of 24 layers on (1, 4), where its kv heads stay whole and every layer of
# a decode step gathers wk/wv over four ranks); gemma2-9b's one
# (local, global) group, granite-moe 1 of 32 (a decode step gathers its
# experts, ~226 MB a layer, over gloo), recurrentgemma one (rglru,
# rglru, local) group, xlstm one (mlstm x 3, slstm) group, seamless 2 + 2
# of 12 + 12): (cell, arch, mesh, layers or None)
SERVE_MESH_CELLS = (
    ("qwen2-0.5b dm22", "qwen2-0.5b", "dm22", None),
    ("qwen2-0.5b dm14", "qwen2-0.5b", "dm14", 4),
    ("gemma2-9b dm22", "gemma2-9b", "dm22", 2),
    ("granite-moe-3b-a800m dm22", "granite-moe-3b-a800m", "dm22", 1),
    ("recurrentgemma-9b dm14", "recurrentgemma-9b", "dm14", 3),
    ("xlstm-350m dm22", "xlstm-350m", "dm22", 4),
    ("seamless-m4t-medium dm14", "seamless-m4t-medium", "dm14", 2))
SERVE_MESH_GEN = 16
SERVE_MESH_MOE_CHECK_STEPS = 4   # the MoE cell's float32 decode check
# the mesh prefill's last-position logits against one device's, both
# bf16: the model group sums its partial products in bf16 where one
# device's matmul accumulates in float32 and rounds once
SERVE_MESH_PREFILL_BAR = 0.05


def aligned_blocks(local_shape, spec, n_rot):
    """Whether a rank's block is made of whole ``n_rot``-element blocks of
    the global leaf: its contiguous runs (the local size of the last
    split dim times the whole dims after it; the whole leaf when nothing
    is split) multiples of ``n_rot``.  The runs start at multiples of
    their length, so the coded round trip then acts on the same blocks
    as the one-device degrade of the whole leaf."""
    split = [d for d, a in enumerate(spec) if a is not None]
    last = split[-1] if split else 0
    return math.prod(local_shape[last:]) % n_rot == 0


def gather_blocks(x, dist):
    """Every rank's tensor ``x`` (each the same shape), in rank order."""
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(dist.get_world_size() * flat.numel())
    dist.all_gather_into_tensor(out, flat)
    return [b.reshape(x.shape) for b in out.chunk(dist.get_world_size())]


def gather_caches(caches, specs, mesh, dist, what):
    """The whole caches from every rank's ``caches``, placed by ``specs``
    (``sharding_rules.cache_specs`` with the ``model`` dims), on every
    rank; ranks that hold the same block must hold the same bits."""
    from repro_torch import sharding as shd
    sizes = shd.axis_sizes(mesh)
    coords = [shd.coordinate(mesh, r) for r in range(dist.get_world_size())]

    def whole(t, spec):
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        shape = [n if ax is None else n * math.prod(
            sizes[a] for a in ((ax,) if isinstance(ax, str) else ax))
            for n, ax in zip(t.shape, spec)]
        out = t.new_empty(shape)
        seen = {}
        for r, blk in enumerate(gather_blocks(t, dist)):
            idx = shd.block_slices(shape, spec, sizes, coords[r])
            first = seen.setdefault(repr(idx), blk)
            assert torch.equal(blk, first), (
                f"{what}: ranks holding one cache block differ")
            out[idx] = blk
        return out

    def node(c, sc):
        return type(c)(*(whole(t, sp) for t, sp in zip(c.tensors(),
                                                       sc.tensors())))

    return type(caches)(
        groups=[node(c, sc) for c, sc in zip(caches.groups, specs.groups)],
        tail=[node(c, sc) for c, sc in zip(caches.tail, specs.tail)])


def serve_mesh_rank(rank, dev, cells=SERVE_MESH_CELLS):
    """One rank of phase 19m: every cell of ``cells`` served on its mesh
    through ``serve_step.mesh_groups``: the rank's ``convert.shard_leaves``
    of the whole seed-0 weights and its rows of the seed-1 prompt and
    seed-3 frontend inputs; prefill, the coded KV transfer of its own
    K/V slices (``degrade_caches``), ``SERVE_MESH_GEN`` greedy steps,
    the kernels' launches counted around them.  Checks (any failure
    raises): the launches (2 FWHT and 1 unbias a K/V leaf); every rank's
    degraded K/V bit for bit the matching slice of rank 0's one-device
    ``degrade_caches`` of the gathered clean leaves (each rank's blocks
    whole blocks of the global leaf); the FWHT and unbias kernels equal
    to their plain versions on the rank's leaves (``check_kv_wire``;
    rank 0 times them at each cell's first leaf); rank 0's one-device
    prefill of the whole weights within ``SERVE_MESH_PREFILL_BAR`` (an
    MoE cell's in its check's config, below); each decode step on the
    mesh within ``RING_DECODE_BAR`` of a teacher-forced mesh forward (an
    MoE cell's with its expert capacity lifted and in float32, over
    ``SERVE_MESH_MOE_CHECK_STEPS`` steps, since the forward routes all
    528 positions where a step routes one and bf16 flips near-tied
    picks, then its served bf16 prefill and steps at its capacity on the
    rows routed alike, ``moe_served_check``; the xLSTM's against one
    device's steps fed the same tokens);
    the mesh's greedy tokens beside rank 0's
    one-device serve (agreement and the first step where they part,
    reported).  Records the prefill ms, decode tok/s, the KV transfer's
    ms and the bytes the rank ships, the model-group and row-gather
    collectives' ms and bytes in an instrumented prefill and decode
    step, and the rank's peak."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch import sharding as shd
    from repro_torch.core import coding
    from repro_torch.core.transport import coupling
    from repro_torch.kernels import dcqcn as kdcqcn
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import convert
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import serve_step as S
    from repro_torch.train import sharding_rules as rules
    counts = Launches(kfwht, kunbias, kquant, kdcqcn)
    meshes = {mk: mesh_mod.make_host_mesh(FAMILY_MESHES[mk][0],
                                          device_type=dev.type)
              for mk in sorted({cell[2] for cell in cells})}
    stats = {"on": False}

    def reset():
        stats.update(model_s=0.0, model_bytes=0, rows_s=0.0, rows_bytes=0)

    def timed(fn, key):
        def call(*a, **k):
            if not stats["on"]:
                return fn(*a, **k)
            stats[key + "_bytes"] += a[0].numel() * a[0].element_size()
            _sync()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            _sync()
            stats[key + "_s"] += time.perf_counter() - t0
            return res
        return call

    saved = (shd.model_all_reduce, shd.model_all_gather,
             shd.model_reduce_scatter, shd.model_all_to_all, shd.gather_rows)
    (shd.model_all_reduce, shd.model_all_gather, shd.model_reduce_scatter,
     shd.model_all_to_all) = (timed(f, "model") for f in saved[:4])
    shd.gather_rows = timed(saved[4], "rows")
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)

    def signs_gen():
        return torch.Generator(dev).manual_seed(2)

    rec = {"cells": {}, "records": []}
    try:
        for name, arch, mk, layers in cells:
            torch.cuda.empty_cache()
            rec["cells"][name] = serve_mesh_cell(
                rank, dev, name, family_config(C, arch, layers), meshes[mk],
                mask, signs_gen, counts, stats, reset, rec["records"], dist,
                coding, ref, kfwht, kunbias, convert, L, M, S, rules)
    finally:
        (shd.model_all_reduce, shd.model_all_gather,
         shd.model_reduce_scatter, shd.model_all_to_all,
         shd.gather_rows) = saved
    torch.cuda.empty_cache()
    return rec


def serve_mesh_cell(rank, dev, name, cfg, mesh, mask, signs_gen, counts,
                    stats, reset, records, dist, coding, ref, kfwht,
                    kunbias, convert, L, M, S, rules):
    """One cell of ``serve_mesh_rank``; returns the rank's record."""
    tp, rows = S.mesh_groups(cfg, mesh)
    names = convert.leaf_names(cfg)
    whole = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    params = convert.params_from_leaves(convert.shard_leaves(
        convert.jax_leaves(whole, cfg), mesh, names), cfg)
    if rank:
        del whole
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    inputs = S.frontend_inputs(cfg, BATCH, PROMPT,
                               torch.Generator(dev).manual_seed(3))
    mine = S.local_batch(mesh, dict(inputs, tokens=prompt))
    tokens = mine.pop("tokens")
    gen, n_ctx = SERVE_MESH_GEN, cfg.n_front + PROMPT
    prefill = S.make_prefill(cfg, n_ctx + gen, tp, rows)

    def encode():
        return {"memory": M.encode(params, cfg, mine["frame_embeds"], tp)}

    extra = encode() if cfg.is_encdec else mine
    memory = extra.get("memory")
    _, warm = prefill(params, tokens, **extra)           # warm-up
    S.greedy_decode(cfg, params, S.degrade_caches(warm, mask, signs_gen()),
                    tokens[:, -1:], n_ctx, 3, memory, tp, rows)
    del warm
    _sync()
    dist.barrier()

    # --- the main path, with the launch counts read around it ---
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.is_encdec:
        extra = encode()
        memory = extra["memory"]
    _sync()
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    logits, clean = prefill(params, tokens, **extra)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    coded = S.degrade_caches(clean, mask, signs_gen())
    _sync()
    kv_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    toks = S.greedy_decode(cfg, params, coded.clone(), first, n_ctx, gen,
                           memory, tp, rows)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(clean.leaves())
    assert logits.shape == (tokens.shape[0], cfg.vocab_size), logits.shape
    assert torch.isfinite(logits.float()).all(), name
    assert launches == {"fwht": 2 * n_leaves, "fwht_quantize": 0,
                        "masked_unbias": n_leaves, "quantize_int8": 0,
                        "dcqcn_scan": 0}, (name, launches)

    # --- the collectives of one prefill and one decode step ---
    stats["on"] = True
    reset()
    prefill(params, tokens, **extra)
    coll = {"prefill": {k: stats[k] for k in ("model_s", "model_bytes",
                                              "rows_s", "rows_bytes")}}
    reset()
    S.make_decode(cfg, tp, rows)(params, clean.clone(), first, n_ctx, memory)
    coll["decode_step"] = {k: stats[k] for k in ("model_s", "model_bytes",
                                                 "rows_s", "rows_bytes")}
    stats["on"] = False

    # --- every rank's degraded caches against its cut
    # (``model.local_caches``) of the one-device degrade of the gathered
    # clean caches: bit for bit, each rank's K/V blocks being whole
    # blocks of the global leaves ---
    dims = M.cache_split_dims(cfg, tp)
    specs = rules.cache_specs(mesh, clean,
                              [dims[k] for k in M.cache_kinds(cfg)])
    whole_clean = gather_caches(clean, specs, mesh, dist, name)
    mine = M.local_caches(S.degrade_caches(whole_clean, mask, signs_gen()),
                          cfg, mesh, tp)
    del whole_clean
    aligned = [aligned_blocks(t.shape, sp, N_ROT)
               for c, sc in zip(clean.nodes(), specs.nodes())
               if isinstance(c, L.AttnCache)
               for t, sp in ((c.k, sc.k), (c.v, sc.v))]
    assert all(aligned), (name, aligned)
    for got, want in zip(
            [t for c in coded.nodes() for t in c.tensors()],
            [t for c in mine.nodes() for t in c.tensors()]):
        assert got.dtype == want.dtype and torch.equal(got, want), (
            f"{name}: rank {rank}'s degraded caches are not its cut of the "
            "one-device degrade")
    del mine

    # --- the kernels on the rank's own leaves ---
    wire = None
    if n_leaves:
        code = coding.plan(clean.leaves()[0].numel(), n_rot=N_ROT)
        signs = coding.rademacher(signs_gen(), code)
        wire = check_kv_wire(f"serve mesh {name} rank {rank}", clean, mask,
                             signs, kfwht, kunbias, ref, coding)
        dist.barrier()
        if rank == 0:            # the others wait: the card is its own
            node = next(c for c in clean.nodes() if isinstance(c,
                                                               L.AttnCache))
            records.extend(check_kv_wire(
                f"serve mesh {name} timed", M.Caches(groups=[node], tail=[]),
                mask, signs, kfwht, kunbias, ref, coding,
                timed=True)["records"])
        dist.barrier()

    # --- each decode step against a teacher-forced mesh forward; the
    # xLSTM's against one device's steps fed the same tokens: its
    # teacher-forced forward runs the chunkwise mLSTM and a step the
    # sequential one, which part where the normalizer's floor binds (in
    # JAX too, ROADMAP Queue 3), on one device as on the mesh.  An MoE
    # cell's check runs with its capacity lifted (the forward routes all
    # 528 positions where a step routes one) and in float32: in bf16 a
    # step's and the forward's few-ulp differences flip near-tied top-k
    # picks, a discrete change that is no fault of the cache; its own
    # prefill and SERVE_MESH_MOE_CHECK_STEPS steps (each gathers the
    # experts, in float32); then the served path itself, in bf16 at its
    # capacity, on the rows that route alike (moe_served_check).  The
    # others decode the main path's clean caches ---
    check_cfg, check_params, check_whole = cfg, params, None
    start, steps = (logits, clean.clone()), gen
    if cfg.moe is not None:
        from repro_torch.models import moe as MOE
        check_cfg = dataclasses.replace(
            cfg, dtype="float32", moe=dataclasses.replace(
                cfg.moe, capacity_factor=MOE.padded_experts(cfg)
                / cfg.moe.top_k))
        check_params = {k: v.float() for k, v in params.items()}
        if rank == 0:
            check_whole = {k: v.float() for k, v in whole.items()}
        start, steps = None, SERVE_MESH_MOE_CHECK_STEPS
    forward = "mlstm" not in cfg.block_pattern
    errs, got, fed, check_logits = mesh_forced_decode(
        check_cfg, check_params, tp, rows, tokens, extra, steps, M, S,
        forward, start)
    del check_params, start
    served_check = None
    if cfg.moe is not None:     # and the served path, in bf16 at capacity
        served_check = moe_served_check(
            cfg, params, whole if rank == 0 else None, tp, rows, mesh, tokens,
            prompt, extra, dict(inputs), gen, dist, M, S, MOE)

    # --- the prefill against one device (an MoE cell's with its capacity
    # lifted on both: a mesh routes each sender's tokens against a
    # capacity of its own, one device all of them against one, so the
    # two drop different picks once capacity binds, as JAX's mesh and
    # one device do), and the token agreement ---
    got_all = [gather_blocks(g, dist) for g in got]
    fed_all = gather_blocks(fed, dist)
    lg_all = gather_blocks(logits, dist)
    check_all = gather_blocks(check_logits, dist)
    tok_all = gather_blocks(toks, dist)
    prefill_err = served_err = agree = part = None
    if rank == 0:
        def rows_of(blocks):
            return dp_rows(blocks, mesh, dist.get_world_size())

        def rel_err(a, b):
            b = b.float()
            return ((a.float() - b).abs().max().item()
                    / max(1.0, b.abs().max().item()))

        mesh_toks = rows_of(tok_all)
        extra1 = dict(inputs)
        if cfg.is_encdec:
            extra1 = {"memory": M.encode(whole, cfg,
                                         extra1.pop("frame_embeds"))}
        logits1, clean1 = S.make_prefill(cfg, n_ctx + gen)(whole, prompt,
                                                           **extra1)
        served_err = rel_err(rows_of(lg_all), logits1)
        prefill_err = served_err if check_cfg is cfg else rel_err(
            rows_of(check_all), S.make_prefill(check_cfg, n_ctx + gen)(
                check_whole, prompt, **extra1)[0])
        del check_whole
        toks1 = S.greedy_decode(
            cfg, whole, S.degrade_caches(clean1, mask, signs_gen()),
            torch.argmax(logits1, -1)[:, None], n_ctx, gen,
            extra1.get("memory"))
        same = mesh_toks == toks1
        agree = same.float().mean().item()
        parted = (~same).any(0).nonzero()
        part = int(parted[0]) if parted.numel() else None
        if not forward:
            fed1 = rows_of(fed_all)
            _, caches1 = S.make_prefill(cfg, n_ctx + gen)(whole, prompt,
                                                          **extra1)
            decode1 = S.make_decode(cfg)
            errs = []
            for i in range(len(got_all)):
                w, caches1 = decode1(whole, caches1, fed1[:, i:i + 1],
                                     n_ctx + i, extra1.get("memory"))
                w = w.float()
                g = rows_of(got_all[i])
                errs.append((g - w).abs().max().item()
                            / max(1.0, w.abs().max().item()))
            del caches1
            assert max(errs) < RING_DECODE_BAR, (name, errs)
        del whole, clean1, logits1
        assert prefill_err <= SERVE_MESH_PREFILL_BAR, (name, prefill_err)
    del lg_all, tok_all, got_all, fed_all, got, check_all
    kv_bytes = S.kv_wire_bytes(clean, N_ROT)
    del clean, coded
    return {"arch": cfg.name, "mesh": list(mesh.mesh.shape),
            "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "rows": tokens.shape[0], "prefill_ms": prefill_ms,
            "encode_ms": encode_ms, "kv_ms": kv_ms,
            "kv_bytes": kv_bytes,
            "decode_s": decode_s,
            "decode_tok_per_s": BATCH * (gen - 1) / decode_s,
            "launches": launches, "peak_gb": peak_gb, "collectives": coll,
            "kv_leaves": n_leaves, "aligned": aligned, "wire": wire,
            "prefill_err": prefill_err, "served_prefill_err": served_err,
            "forced_errs": errs, "served_check": served_check,
            "forced_against": ("teacher-forced mesh forward" if forward
                               else "one-device decode, same tokens"),
            "token_agree": agree, "first_part_step": part,
            "vocab_split": L.split_over_model(M.logits_leaf(cfg), tp)
            is not None,
            "kv_split": bool(dims["global"])}


def dp_rows(blocks, mesh, world):
    """The global rows from every rank's block of them (``gather_blocks``),
    in dp order: the blocks of the ranks at ``model`` index 0."""
    from repro_torch import sharding as shd
    coords = [shd.coordinate(mesh, r) for r in range(world)]
    order = sorted((c.get("data", 0), r) for r, c in enumerate(coords)
                   if c.get("model", 0) == 0)
    return torch.cat([blocks[r] for _, r in order])


def moe_served_check(cfg, params, whole, tp, rows, mesh, tokens, prompt,
                     extra, extra1, gen, dist, M, S, MOE):
    """The MoE cell's served path on the mesh (its dtype, its expert
    capacity) held to a teacher-forced forward on one device (rank 0, the
    whole weights ``whole``, the global ``prompt`` and frontend inputs
    ``extra1``) with the capacity lifted: a clean prefill and ``gen``
    greedy steps on the mesh, each logit row of the prefill's last
    position and of every step within ``RING_DECODE_BAR`` of the step's
    largest logit wherever the two routed alike, the row's picks there
    the forward's and none dropped.  With one MoE layer that is the same
    function: its K/V are written before the MoE, so a position's logits
    read its own picks only.  The rest are near-tied picks that the
    served dtype's rounding flips, a discrete change and no fault of the
    path; at least half the rows must be held.  A step routes the global
    rows against a capacity of at least 8 and so drops nothing
    (asserted).  Returns (the largest held error, rows held, rows) on
    rank 0, None on the others."""
    from repro_torch import sharding as shd
    assert cfg.n_layers == 1, cfg.n_layers
    lifted = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE.padded_experts(cfg) / cfg.moe.top_k))
    inner, log = MOE._dispatch_indices, []

    def record(top_i, e_pad, cap):
        flat, slot, keep = inner(top_i, e_pad, cap)
        log.append(torch.where(keep.reshape(top_i.shape), top_i, -1))
        return flat, slot, keep

    n_ctx = cfg.n_front + tokens.shape[1]
    MOE._dispatch_indices = record
    try:
        logits, caches = S.make_prefill(cfg, n_ctx + gen, tp, rows)(
            params, tokens, **extra)
        decode = S.make_decode(cfg, tp, rows)
        tok, fed, got = torch.argmax(logits, -1)[:, None], [], [logits]
        for i in range(gen):
            fed.append(tok)
            lg, caches = decode(params, caches, tok, n_ctx + i,
                                extra.get("memory"))
            got.append(lg)
            tok = torch.argmax(lg, -1)[:, None]
        del caches
        served = list(log)
        assert all((p >= 0).all() for p in served[1:]), "a step dropped"
        # the prefill's picks at its last position, from the rank whose
        # block of the sequence holds it (the EP path splits the sequence
        # over ``model``; every rank holds the rows gathered over dp)
        world = dist.get_world_size()
        holder = {}
        for r in range(world):
            holder.setdefault(shd.coordinate(mesh, r).get("model", 0), r)
        b_all = served[1].shape[0]
        blocks = gather_blocks(served[0], dist)
        blk = served[0].shape[0] // b_all
        j, i = divmod(n_ctx - 1, blk)
        picks = [blocks[holder[j]].reshape(b_all, blk, -1)[:, i]] + served[1:]
        got = [dp_rows(gather_blocks(g, dist), mesh, world) for g in got]
        fed = dp_rows(gather_blocks(torch.cat(fed, dim=1), dist), mesh, world)
        if dist.get_rank():
            return None
        log[:] = []
        seq = torch.cat([prompt, fed], dim=1)
        want = M.head(whole, lifted, M.hidden(whole, lifted, seq, **extra1)[
            :, n_ctx - 1:n_ctx + gen])
        (forward,) = log
    finally:
        MOE._dispatch_indices = inner
    forward = forward.reshape(seq.shape[0], seq.shape[1], -1)
    alike = torch.stack([
        (torch.sort(p, -1)[0]
         == torch.sort(forward[:, n_ctx - 1 + i], -1)[0]).all(-1)
        for i, p in enumerate(picks)], dim=1)              # (rows, gen + 1)
    worst = 0.0
    for i, g in enumerate(got):
        w = want[:, i].float()
        err = ((g.float() - w).abs().amax(-1)
               / max(1.0, w.abs().max().item()))
        assert torch.isfinite(g).all(), (cfg.name, i)
        held = err[alike[:, i]]
        if held.numel():
            worst = max(worst, held.max().item())
    n_held, n_rows = int(alike.sum()), alike.numel()
    assert worst < RING_DECODE_BAR and 2 * n_held >= n_rows, (
        cfg.name, worst, n_held, n_rows)
    return worst, n_held, n_rows


def mesh_forced_decode(cfg, params, tp, rows, tokens, extra, gen, M, S,
                       forward=True, start=None):
    """A clean prefill on the mesh (or ``start``, the (logits, caches) of
    one, which the steps consume) and ``gen`` greedy steps.  With
    ``forward`` each step's logits (whole vocabulary) are held to a
    teacher-forced mesh forward over the prompt and the tokens fed, with
    the same frontend inputs, at that position, within
    ``RING_DECODE_BAR`` of the largest logit (``forced_decode_check``'s
    bar).  Returns (the errors of the rank's rows, or None without
    ``forward``; each step's logits, float32; the tokens fed (rows,
    ``gen``); the prefill's logits)."""
    memory = extra.get("memory")
    n_ctx = cfg.n_front + tokens.shape[1]
    logits, caches = start or S.make_prefill(cfg, n_ctx + gen, tp, rows)(
        params, tokens, **extra)
    decode = S.make_decode(cfg, tp, rows)
    tok, fed, got = torch.argmax(logits, -1)[:, None], [], []
    for i in range(gen):
        fed.append(tok)
        lg, caches = decode(params, caches, tok, n_ctx + i, memory)
        got.append(lg.float())
        tok = torch.argmax(lg, -1)[:, None]
    del caches
    fed = torch.cat(fed, dim=1)
    if not forward:
        return None, got, fed, logits
    seq = torch.cat([tokens, fed], dim=1)
    want = S.whole_logits(M.head(params, cfg, M.hidden(
        params, cfg, seq, tp=tp, rows=rows, **extra)[:, n_ctx:n_ctx + gen],
        tp), cfg, tp)
    errs = []
    for i, g in enumerate(got):
        w = want[:, i].float()
        errs.append((g - w).abs().max().item()
                    / max(1.0, w.abs().max().item()))
        assert torch.isfinite(g).all() and errs[-1] < RING_DECODE_BAR, (
            cfg.name, i, errs)
    return errs, got, fed, logits


def phase_serve_mesh(mesh_ranks):
    """Phase 19m: ``SERVE_MESH_CELLS`` on four rank processes sharing the
    one card over gloo (``serve_mesh_rank``), in one launch.  Any rank
    that fails fails the phase.  Returns the record, the kernel timing
    records at the ranks' K/V shapes and the seconds."""
    ranks, seconds = kind_ranks(mesh_ranks, "serve_mesh")
    smi = card_name_and_power()
    out, launches = {"cells": {}}, {}
    for name, *_ in SERVE_MESH_CELLS:
        cells = [rk["cells"][name] for rk in ranks]
        cell = cells[0]
        for c in cells:
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
        rec = {k: cell[k] for k in (
            "arch", "mesh", "layers", "encoder_layers", "rows",
            "kv_leaves", "kv_split", "vocab_split", "prefill_err",
            "served_prefill_err",
            "token_agree", "first_part_step", "collectives")}
        rec.update(
            prefill_ms=[c["prefill_ms"] for c in cells],
            encode_ms=[c["encode_ms"] for c in cells],
            decode_tok_per_s=[c["decode_tok_per_s"] for c in cells],
            kv_ms=[c["kv_ms"] for c in cells],
            kv_bytes_per_rank=[c["kv_bytes"] for c in cells],
            peak_gb_per_rank=[c["peak_gb"] for c in cells],
            forced_err_max=max(max(c["forced_errs"]) for c in cells
                               if c["forced_errs"] is not None),
            forced_against=cell["forced_against"],
            kernel_shapes=sorted({s for c in cells if c["wire"]
                                  for s in c["wire"]["shapes"]}),
            kernel_err=max((max(c["wire"]["max_abs_err"].values())
                            for c in cells if c["wire"]), default=0.0))
        if cell["served_check"] is not None:       # rank 0's, global rows
            rec["served_check"] = dict(zip(("err_max", "rows_held", "rows"),
                                           cell["served_check"]))
        out["cells"][name] = rec
        co = rec["collectives"]
        served = rec.get("served_check")
        enc = (f", encode {rec['encode_ms'][0]:.1f} ms"
               if rec["encoder_layers"] else "")
        print(f"serve mesh {name} ({rec['layers']} layers"
              + (f" + {rec['encoder_layers']} encoder" if
                 rec["encoder_layers"] else "")
              + f", {BATCH}x{PROMPT} global, {rec['rows']} rows a rank, kv "
              f"{'split' if rec['kv_split'] else 'whole'}, vocab "
              f"{'split' if rec['vocab_split'] else 'whole'}): prefill ms "
              f"{[round(x, 1) for x in rec['prefill_ms']]}{enc}; decode "
              f"tok/s {[round(x, 1) for x in rec['decode_tok_per_s']]}; KV "
              f"transfer ms {[round(x, 2) for x in rec['kv_ms']]}, "
              f"{rec['kv_bytes_per_rank'][0]:,} B a rank; model group "
              f"prefill {co['prefill']['model_s'] * 1e3:.1f} ms "
              f"{co['prefill']['model_bytes']:,} B, decode step "
              f"{co['decode_step']['model_s'] * 1e3:.1f} ms "
              f"{co['decode_step']['model_bytes']:,} B; row gather prefill "
              f"{co['prefill']['rows_s'] * 1e3:.1f} ms "
              f"{co['prefill']['rows_bytes']:,} B, decode step "
              f"{co['decode_step']['rows_s'] * 1e3:.1f} ms "
              f"{co['decode_step']['rows_bytes']:,} B; peak GB/rank "
              f"{[round(g, 2) for g in rec['peak_gb_per_rank']]}; prefill vs "
              f"one device {rec['prefill_err']:.3g} (bar "
              f"{SERVE_MESH_PREFILL_BAR}"
              + (f"; capacity lifted: at the served capacity "
                 f"{rec['served_prefill_err']:.3g}"
                 if rec["served_prefill_err"] != rec["prefill_err"] else "")
              + f"); decode vs {rec['forced_against']} "
              f"{rec['forced_err_max']:.3g} (bar {RING_DECODE_BAR}"
              + (f"; served bf16 prefill and {SERVE_MESH_GEN} steps vs the "
                 f"one-device forward with capacity lifted "
                 f"{served['err_max']:.3g} over the {served['rows_held']} of "
                 f"{served['rows']} row-steps routed alike" if served else "")
              + f"); tokens "
              f"vs one device {rec['token_agree']:.4f}, first parting step "
              f"{rec['first_part_step']}; every rank's degraded caches its cut "
              f"of the one-device degrade, bit for bit; kernels vs plain "
              f"{rec['kernel_err']:.3g} at {rec['kernel_shapes']} [{smi}]")
    out.update(seconds=seconds, launches=launches)
    print(f"serve mesh: {len(out['cells'])} cells on four ranks, launches "
          f"{launches}, {seconds:.1f} s [{smi}]")
    return out, ranks[0]["records"]


def card_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(earlier_fwht=None, earlier_dcqcn=None):
    sys.path.insert(0, SRC)
    from repro_torch import resolve_device
    dev = resolve_device("cuda")            # raises without CUDA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as C
    from repro_torch.benchmarks import figs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import coding
    from repro_torch.core import lossy_collectives as lc
    from repro_torch.core import qp_state, resource_model
    from repro_torch.core.transport import coupling
    from repro_torch.core.transport import engine as E
    from repro_torch.core.transport import engine_torch as ET
    from repro_torch.core.transport import params as P
    from repro_torch.core.transport import topology, trace_export
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.kernels import _build
    from repro_torch.kernels import dcqcn as kdcqcn
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve import serve_step, traffic
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    seconds, t_lap = {}, [t_start]

    def lap(name):
        """The wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - t_lap[0]
        t_lap[0] = now

    counts = Launches(kfwht, kunbias, kquant, kdcqcn)
    phase_build(_build)
    lap("1_build")
    if earlier_fwht is not None or earlier_dcqcn is not None:
        ab = {}
        if earlier_fwht is not None:
            ab["fwht_ab"] = phase_fwht_ab(dev, earlier_fwht, _build, kfwht,
                                          ref)
        if earlier_dcqcn is not None:
            ab["dcqcn_ab"] = phase_dcqcn_ab(dev, earlier_dcqcn, _build,
                                            kdcqcn, E, ET, P, topology)
        print(json.dumps(dict(ab, seconds=time.perf_counter() - t_start)))
        print(card_name_and_power())
        return
    # the dry runs share the host only with phase 2, whose every time is
    # a device time behind the spin kernel (time_ms); phase 3 and all
    # after it, whose host-bound times the host's load would move, start
    # once they have ended
    dryrun_jobs = start_dryruns()
    records = phase_kernels(dev, C.get("qwen2-0.5b"), kfwht, kunbias, ref,
                            coding, coupling)
    records += phase_quant_kernels(dev, kfwht, kquant, ref)
    scan_records, rate_trace = phase_dcqcn_kernel(dev, kdcqcn, ref, E, ET, P,
                                                  topology)
    records += scan_records
    lap("2_kernel_checks")
    dryrun = phase_dryrun(dryrun_jobs)
    lap("23_dryrun_wait")
    main_path = phase_main_path(dev, C, M, serve_step, coupling, counts)
    phase_small_reference(dev, C, M, serve_step)
    lap("3_serve")
    bench = phase_kernel_bench(dev, ops, counts)
    train, tr = phase_train(dev, C, ts, Trainer, DataConfig, OptConfig,
                            counts)
    lap("4-5_bench_train")
    allreduce = phase_allreduce(dev, ts, tr, coding, lc, counts)
    del tr
    torch.cuda.empty_cache()
    lap("6_allreduce")
    checkpoint = phase_checkpoint(dev, C, ts, Trainer, DataConfig, OptConfig,
                                  ckpt, counts)
    lap("5b_checkpoint")
    mesh_ranks = run_mesh_ranks()
    lap("6b-6d_6f_6h_6i_19m_mesh_ranks")
    dp_train = phase_mesh_train("dp", mesh_ranks)
    tp_train = phase_mesh_train("tp", mesh_ranks)
    lap("6b-6c_report")
    train_remat = phase_train_remat(dev, C, ts, Trainer, DataConfig,
                                    OptConfig, counts,
                                    dryrun["reckon"])
    lap("6j_train_remat")
    ep_train, ep_records = phase_ep_train(dev, C, kfwht, ref, mesh_ranks)
    records += ep_records
    lap("6d_ep_train")
    train_families = phase_train_families(dev, C, ts, Trainer, DataConfig,
                                          OptConfig, counts)
    train_families["smoke_card_vs_cpu"] = family_smoke_card_vs_cpu(
        dev, C, ts, OptConfig, DataConfig, make_source)
    train_families["fwht"], family_records = check_family_fwht(dev, C, kfwht,
                                                               ref)
    records += family_records
    lap("6e_train_families")
    train_families_mesh = phase_mesh_train_families(mesh_ranks)
    lap("6f_train_families_mesh")
    train_rs = phase_train_recurrent_stubs(dev, C, ts, Trainer, DataConfig,
                                           OptConfig, make_source, counts)
    train_rs["smoke_card_vs_cpu"] = rs_smoke_card_vs_cpu(
        dev, C, ts, OptConfig, DataConfig, make_source)
    train_rs["fwht"], rs_records = check_family_fwht(
        dev, C, kfwht, ref, family_fwht_shapes(C, RS_TRAIN, RS_MESH_CELLS,
                                               rs_mesh_config),
        map(tuple, train_families["fwht"]["shapes"]), "recurrent/stubs")
    records += rs_records
    lap("6g_train_recurrent_stubs")
    train_rs_mesh = phase_mesh_train_families(mesh_ranks, "recurrent_stubs")
    lap("6h_train_recurrent_stubs_mesh")
    train_tp_rs = phase_mesh_train_families(mesh_ranks,
                                            "tp_recurrent_stubs")
    train_tp_rs["fwht"], tp_rs_records = check_family_fwht(
        dev, C, kfwht, ref, tp_rs_fwht_shapes(C),
        map(tuple, train_families["fwht"]["shapes"]
            + train_rs["fwht"]["shapes"]), "tp recurrent/stubs",
        time_all=True)
    records += tp_rs_records
    lap("6i_tp_recurrent_stubs")
    small_train = phase_small_train(dev, C, ts, OptConfig, DataConfig,
                                    make_source)
    lap("7_small_train")
    # the sequential loop's child processes import while the engine's
    # card-vs-CPU check runs, and wait for their jobs
    seq_children = figs.sequential_children()
    try:
        engine_check = phase_engine_card_vs_cpu(dev, E, P)
        fig2 = phase_fig2(dev, E, P, figs, counts, seq_children)
    finally:
        figs.stop_children(seq_children)
    fig3 = phase_fig3(dev, E, ET, P, counts)
    torch.cuda.empty_cache()
    lap("8_engine_fig2_fig3")
    fig1, paper_sched = phase_fig1(dev, C, ts, Trainer, DataConfig,
                                   OptConfig, coupling, counts)
    fig1["full_width"] = phase_fig1_full_width(
        dev, C, ts, Trainer, DataConfig, OptConfig, coupling, paper_sched,
        counts)
    fig1_launches = {k: v + fig1["full_width"]["launches"][k]
                     for k, v in fig1["launches"].items()}
    lap("9_fig1")
    hier_check = phase_hier_card_vs_cpu(dev, E, P, topology)
    fig4 = phase_fig4(dev, E, P, topology, counts)
    fig7 = phase_fig7(dev, E, P, topology, counts)
    torch.cuda.empty_cache()
    lap("10-12_hier_fig4_fig7")
    fig7["loop"], fault_sched = phase_fig7_loop(
        dev, C, ts, Trainer, DataConfig, OptConfig, coupling, counts)
    fig7["loop"]["full_width"] = phase_fig7_full_width(
        dev, C, ts, Trainer, DataConfig, OptConfig, coupling, fault_sched,
        counts)
    loop_launches = {k: v + fig7["loop"]["full_width"]["launches"][k]
                     for k, v in fig7["loop"]["launches"].items()}
    lap("13_fig7_loop")
    tables = phase_tables(figs, qp_state, resource_model)
    fig5 = phase_fig5(dev, E, topology, figs, counts)
    fig6 = phase_fig6(dev, E, topology, figs, counts)
    incast_check = phase_incast_card_vs_cpu(dev, E, traffic, figs)
    wire_kernels = (kfwht, kunbias, ref, coding)
    fig8 = phase_fig8(dev, traffic, figs, wire_kernels, counts)
    torch.cuda.empty_cache()
    lap("14-18_tables_fig5_fig6_incast_fig8")
    serve_long = phase_serve_long(dev, C, M, L, serve_step, coupling,
                                  wire_kernels, counts)
    torch.cuda.empty_cache()
    lap("19_serve_long")
    serve_gemma2, serve_gemma2_long, gemma2_records = phase_serve_gemma2(
        dev, C, M, L, serve_step, coupling, wire_kernels, counts)
    records += gemma2_records
    torch.cuda.empty_cache()
    lap("19b-19c_gemma2")
    serve_dense = {}
    for arch in DENSE_ARCHS:
        serve_dense[arch], dense_records = phase_serve_dense(
            dev, C, M, serve_step, coupling, wire_kernels, counts, arch)
        records += dense_records
    lap("19d_dense")
    serve_moe = {}
    for arch in MOE_ARCHS:
        torch.cuda.empty_cache()
        serve_moe[arch], moe_records = phase_serve_moe(
            dev, C, M, serve_step, coupling, wire_kernels, counts, arch)
        records += moe_records
    lap("19e-19f_moe")
    torch.cuda.empty_cache()
    serve_rg, serve_rg_long, rg_records = phase_serve_recurrentgemma(
        dev, C, M, L, serve_step, coupling, wire_kernels, counts)
    records += rg_records
    lap("19g-19h_recurrentgemma")
    serve_xlstm = phase_serve_xlstm(dev, C, M, serve_step, coupling, counts)
    lap("19i_xlstm")
    serve_phi3, phi3_records = phase_serve_phi3_vision(
        dev, C, M, serve_step, coupling, wire_kernels, counts)
    records += phi3_records
    lap("19j_serve_phi3_vision")
    serve_seamless, seamless_records, seamless_params = phase_serve_seamless(
        dev, C, M, L, serve_step, coupling, wire_kernels, counts)
    records += seamless_records
    lap("19k_serve_seamless")
    serve_seamless_long, long_records = phase_serve_seamless_long(
        dev, C, seamless_params, M, L, serve_step, coupling, wire_kernels,
        counts)
    records += long_records
    del seamless_params
    torch.cuda.empty_cache()
    lap("19l_serve_seamless_long")
    serve_mesh, serve_mesh_records = phase_serve_mesh(mesh_ranks)
    records += serve_mesh_records
    lap("19m_serve_mesh")
    feature_check = phase_features_card_vs_cpu(dev, E, topology, figs)
    fig10 = phase_fig10(dev, figs, counts)
    fig9 = phase_fig9(dev, figs, trace_export, counts)
    lap("20-22_features_fig10_fig9")
    by_path = {"serve": main_path["launches"],
               "kernel_bench": bench["launches"],
               "train": train["launches"],
               "allreduce": allreduce["launches"],
               "checkpoint": checkpoint["launches"],
               "dp_train": dp_train["launches"],
               "tp_train": tp_train["launches"],
               "train_remat": train_remat["launches"],
               "fig1": fig1_launches, "fig2": fig2["launches"],
               "fig2_shared": fig2["shared"]["launches"],
               "fig3": fig3["launches"], "fig4": fig4["launches"],
               "fig7": fig7["launches"], "fig7_loop": loop_launches,
               "fig5": fig5["launches"], "fig6": fig6["launches"],
               "fig8": fig8["launches"], "serve_long": serve_long["launches"],
               "fig10": fig10["launches"], "fig9": fig9["launches"],
               "fig2_step": fig2["step_window"]["launches"],
               "fig2_sequential": fig2["sequential"]["launches"],
               "rate_trace": rate_trace["launches"],
               "serve_gemma2": serve_gemma2["launches"],
               "serve_gemma2_long": serve_gemma2_long["launches"],
               "serve_chatglm3": serve_dense["chatglm3-6b"]["launches"],
               "serve_nemotron": serve_dense["nemotron-4-15b"]["launches"],
               "ep_train": ep_train["launches"],
               "train_families": train_families["launches"],
               "train_families_mesh": train_families_mesh["launches"],
               "train_recurrent_stubs": train_rs["launches"],
               "train_recurrent_stubs_mesh": train_rs_mesh["launches"],
               "train_tp_recurrent_stubs": train_tp_rs["launches"],
               "serve_qwen2_moe": serve_moe["qwen2-moe-a2.7b"]["launches"],
               "serve_granite_moe":
                   serve_moe["granite-moe-3b-a800m"]["launches"],
               "serve_recurrentgemma": serve_rg["launches"],
               "serve_recurrentgemma_long": serve_rg_long["launches"],
               "serve_xlstm": serve_xlstm["launches"],
               "serve_phi3_vision": serve_phi3["launches"],
               "serve_seamless": serve_seamless["launches"],
               "serve_seamless_long": serve_seamless_long["launches"],
               "serve_mesh": serve_mesh["launches"]}
    wires = [fig8["wire_check"], serve_long["wire_check"],
             serve_gemma2["wire_check"], serve_gemma2_long["wire_check"],
             *(r["wire_check"] for r in serve_dense.values()),
             *(r["wire_check"] for r in serve_moe.values()),
             serve_rg["wire_check"], serve_rg_long["wire_check"],
             serve_phi3["wire_check"], serve_seamless["wire_check"],
             serve_seamless_long["wire_check"]]
    for rec in records:
        for wire in wires:
            rec["max_abs_err"] = max(rec["max_abs_err"], wire[
                "max_abs_err"].get(rec["name"], 0.0))
        rec["launches_by_path"] = {p: c[rec["name"]]
                                   for p, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        assert rec["launches"] > 0, f"no path launched {rec['name']}"
    smi = card_name_and_power()
    print(json.dumps({"main_path": main_path, "kernel_bench": bench,
                      "train": train, "allreduce": allreduce,
                      "checkpoint": checkpoint,
                      "dp_train": dp_train, "tp_train": tp_train,
                      "train_remat": train_remat, "dryrun": dryrun,
                      "ep_train": ep_train, "small_train": small_train,
                      "train_families": train_families,
                      "train_families_mesh": train_families_mesh,
                      "train_recurrent_stubs": train_rs,
                      "train_recurrent_stubs_mesh": train_rs_mesh,
                      "train_tp_recurrent_stubs": train_tp_rs,
                      "engine_card_vs_cpu": engine_check, "fig1": fig1,
                      "fig2": fig2, "fig3": fig3, "rate_trace": rate_trace,
                      "hier_card_vs_cpu": hier_check, "fig4": fig4,
                      "fig7": fig7, "tables": tables, "fig5": fig5,
                      "fig6": fig6, "incast_card_vs_cpu": incast_check,
                      "fig8": fig8,
                      "features_card_vs_cpu": feature_check,
                      "fig10": fig10, "fig9": fig9, "serve_long": serve_long,
                      "serve_gemma2": serve_gemma2,
                      "serve_gemma2_long": serve_gemma2_long,
                      "serve_dense": serve_dense, "serve_moe": serve_moe,
                      "serve_recurrentgemma": serve_rg,
                      "serve_recurrentgemma_long": serve_rg_long,
                      "serve_xlstm": serve_xlstm,
                      "serve_phi3_vision": serve_phi3,
                      "serve_seamless": serve_seamless,
                      "serve_seamless_long": serve_seamless_long,
                      "serve_mesh": serve_mesh,
                      "seconds": time.perf_counter() - t_start}))
    lap("report")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"phase_seconds": seconds,
                      "mesh_kind_seconds": {
                          k: kind_ranks(mesh_ranks, k)[1]
                          for k in MESH_KINDS},
                      "total": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab-fwht", metavar="FWHT_CU", type=os.path.abspath,
                    help="only build the kernels and time csrc/fwht.cu "
                    "against this earlier design of it, in turns")
    ap.add_argument("--ab-dcqcn", metavar="DCQCN_CU", type=os.path.abspath,
                    help="only build the kernels and time csrc/dcqcn.cu "
                    "against this earlier design of it (the C interface "
                    "without a workspace), in turns, on the engine's real "
                    "blocks")
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-kind", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:      # one rank of phase_mesh_train
        mesh_rank(args.mesh_kind, args.mesh_rank, args.mesh_port,
                  args.mesh_out)
    else:
        try:
            main(args.ab_fwht, args.ab_dcqcn)
        finally:
            stop_dryruns()
