#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line (or a few) each; any failure raises and exits non-zero:

1. build   — compile ``csrc/similarity.cu``, ``csrc/aggregate.cu``,
   ``csrc/sketch.cu`` and ``csrc/flash_attention.cu`` for ``sm_90a`` from
   the checkout (all ``nvcc`` in parallel) and print the seconds it took,
   each kernel's ptxas report (registers, spills; a spill in the bf16 flash
   kernel, a similarity kernel or an aggregate kernel fails the run), the
   FP32 and load instructions of each similarity kernel in ``cuobjdump
   -sass`` (an L1 kernel with an FP32 instruction besides FADD fails it),
   the global loads each aggregate kernel issues before its first FFMA (the
   aligned kernel must issue a whole pass of row loads) and the count of
   ``HMMA`` (tensor-core) instructions of each flash kernel (the bf16
   kernel must have some);
2. kernels — hold each kernel against its plain PyTorch version on the card
   at the main path's shapes (Gram: |got − want| ≤ 1e-5·‖g_i‖·‖g_j‖, the
   error on the scale of the entries; L1: atol 1e-4 on entries of order
   0.1–50; both bit-reproducible and symmetric bit for bit, the sketched
   store's (100, 64) in one split, and the device kernels of a call in a
   profiler window: partial and reduce pass once each at (100, 39,760),
   the partial pass alone at (100, 64); aggregate at (11, 39,760),
   (41, 39,760) and a ragged (11, 39,759): rtol and atol 2e-5,
   bit-reproducible, bit-equal for the same values 4 bytes off alignment
   and with one more column, one device kernel a call; SRP:
   |got − want| ≤
   1e-5·‖x_i‖·‖S_:,j‖ with ‖S_:,j‖ = √(d/d′), its signs bit-equal to the
   plain version's, bit-reproducible and independent of the rows it is
   batched with, calls at alternating shapes back to back each bit-equal
   to the same call alone, and its two device kernels once each a call in
   a profiler window; countsketch bit-reproducible; flash attention, f32 on
   the CUDA-core kernel at the reference's test shapes and a ragged
   S = T = 1,000, bf16 on the tensor-core kernel at every padded head dim
   (hd 8 to 128), ragged S = T of 1 to 1,000 around its 64-row tiles, the
   serve paths' (4, 1,000, 12, 2, 128), qwen2-moe-a2.7b's
   (4, 1,000, 16, 16, 128) and whisper-small's (4, 1,000, 12, 12, 64),
   the fl_lm phase's local step
   (4, 64, 16, 8, 128), non-causal with a ragged T, and
   views into a fused projection; the widened domain: head dims 12, 20,
   200, 256 and 320 in f32 and bf16 (the tensor-core kernel's HDP 256 and
   its 128-column chunks above it, the f32 kernel's chunks above 128), f16
   at hd 96 and 128, B·H = 132,000 with H = 66,000, and bf16 views with a
   misaligned base, a sequence stride of 68 and a head-dim stride of 2,
   each launching the kernel once a call and the views bit-equal to their
   contiguous copies; the rows of FLASH_WIDE_ROWS at the serve batch and
   prompt; atol 2e-5 in f32, and in bf16
   min(3e-2, 2⁻⁷·(|want| + Σ_j p_ij·|v_j|)), the error on the scale of the
   softmax-weighted |v|, in f16 the same with 2⁻¹⁰; bit-reproducible) and check the port on the card against the port on
   the CPU on a small input (equal plans, losses and params to atol 1e-4),
   unsketched and with the SRP sketch under Ward and k-means, and the LM's
   greedy generations (reduced qwen2-1.5b and reduced qwen2-moe-a2.7b at 2
   layers, and reduced deepseek-v2-lite-16b at 2 layers, MLA with no
   flash launch; later phases add their own reduced models, whisper-small
   and qwen2-vl-2b with their zero front-end stubs among them: in f32
   equal token ids and logits to atol 1e-4; in bf16,
   through the tensor-core kernel where the model has GQA attention,
   logits to atol 0.1 and equal tokens wherever the CPU's top-2 margin
   exceeds 0.2);
3. slice   — the Algorithm 2 FL round loop at the paper's MNIST width
   (784 → 50 → 10, d = 39,760; 100 clients, m = 10, N = B = 50, lr 0.01):
   5 rounds with the arccos measure, 2 with L1, and 5 arccos rounds with
   the SRP sketch to d′ = 64 (``slice[srp]``). Kernel launch counts are
   reset just before each run and read just after; each kernel of the run
   must have launched, and ``slice[srp]`` once per round each;
4. fleet   — Algorithm 2 over 100,000 clients (m = 20, d = 39,760,
   ``sketch="srp"``, d′ = 64, ``clusterer="kmeans"``) observing 3 rounds of
   64 update rows: the store's resident bytes, the sketch-plus-scatter
   time and ``plan_build_ms``, with a valid plan rebuilt every round;
5. trace   — one more full-width round under ``torch.profiler``, unsketched
   and sketched: device busy time, the idle share of that same round's wall
   time, and device time by kernel;
6. serve   — ``generate`` at qwen2-1.5b's full width and depth (28 layers,
   d_model 1,536, vocab 151,936), bf16 over f32 random parameters, batch
   4, prompt length 1,000, 16 greedy tokens: prefill ms, decode ms per
   token, tokens/s, peak device memory, and exactly 28 flash launches in
   the prefill and 0 in the decode; one more prefill with the attention
   swapped for the plain version on the card, whose last-position tokens
   must agree wherever its top-2 margin exceeds twice the largest logit
   difference; then one prefill and one decode step under
   ``torch.profiler``, with the flash kernel's share of the prefill;
7. times   — each kernel, its plain version and one PyTorch library call
   on the same inputs, timed with CUDA events (and device-busy time from
   the profiler), beside the card's bound; the flash kernel and
   ``scaled_dot_product_attention`` in turns (kernel, library, library,
   kernel), also with the queue filled ahead of the events, and the
   TFLOP/s each reaches; the SRP kernel and ``torch.matmul(X, S)`` in
   turns at c = 10 and 64 (the flash kernel also at qwen2-moe-a2.7b's
   (4, 1,000, 16, 16, 128)), the similarity kernel and ``G @ G.T`` /
   ``torch.cdist(G, G, p=1)`` in turns at (100, 39,760) and (100, 64), and
   the aggregate kernel and ``torch.mv(U.T, w)`` in turns at (11, 39,760)
   and (41, 39,760), with the device time of each kernel they launch; an
   empty kernel on the aggregate's grid (the launch floor); the aggregate
   wrapper's host µs step by step;
8. paper   — the paper's experiments through the port's runners and sweep
   layer (``run_sweep(..., device="cuda")``) at the MNIST width (dim 784,
   the 784 → 50 → 10 MLP, m = 10, N = 10, B = 50, lr 0.05): Fig. 1's four
   schemes on ``by_class_shards`` (100 clients × 500 train / 100 test) and
   Fig. 2's md and algorithm2 over four Dirichlet α on the unbalanced
   profile, each 2 seeds × 5 rounds, with every grid row and each α's
   ``clustered_gain``; one Algorithm 2 cell with the SRP sketch to d′ = 64
   (3 rounds); the variance table's rows; fig1 at dim 32 on the card
   against the CPU (equal draws, weights and Algorithm 2 plans; losses to
   atol 1e-4). Gates: 10 distinct clients in every algorithm1 and target
   round and 10 classes in every target round; eqs. 17 and 23 for every
   client of Algorithm 1's plan and of Algorithm 2's cold-start and
   re-clustered plans, and Section 4's ⌊m p_i⌋ + 2 urns a client on
   Algorithm 1's and the cold-start plan; MD's all-distinct probability
   equal to 100!/(90!·100¹⁰) to 1e-12; 10 distinct clients in all 500 of
   Algorithm 1's balanced draws; counts reset at the phase's start and
   read at its end: one aggregate launch a round on the card, one Gram
   launch an Algorithm 2 plan build, one SRP launch a sketched round. It
   prints each scheme's round ms (host clock ending in
   ``torch.cuda.synchronize()``) and ``plan_build_ms``;
8b. ablations — the Appendix D ablations (D.2 arccos / l2 / l1, D.4 N and
   m, D.5 FedProx μ = 0.1) and the beyond-paper sweeps (staleness decay
   under l2, churn) through the port's ``ablations`` and ``beyond_paper``
   runners at dim 784 (d = 39,760), 4 rounds a cell (cut from 12), with
   every grid row; D.5's FedProx cell and D.2's l2 cell at dim 32 on the
   card against the CPU (equal draws and plans, losses to atol 1e-4).
   Counts reset at the phase's start: one aggregate launch a card round,
   one Gram launch an Algorithm 2 build under arccos or l2, one L1 launch a
   build under l1, no SRP launch. Then ``beyond_paper``'s plan check on the
   card at d = 128 and 39,760 (the f64 host measure and the similarity
   kernel give one plan, bit for bit), ``python -m
   repro_torch.benchmarks.run`` with ``--list``, ``--spec`` and ``--sweep``
   (re-invoked on its store: the cells skipped, the collated CSVs
   identical) as subprocesses on the card, and ``examples/torch_quickstart.py``
   on the card with its table;
9. zoo     — the scheme zoo and client churn at the same width: the port's
   ``scheme_race`` grid (md, uniform, algorithm2, stratified, importance,
   dp_stratified, hybrid; ``by_class_shards``, 100 clients × 500 / 100,
   m = 10) × 2 seeds × 5 rounds through ``run_sweep(..., device="cuda")``,
   with the race's rows (loss, acc, rounds_to_acc, agg_weight_var);
   algorithm2 and stratified under Poisson churn with the availability
   tracker at threshold 0.95 (so from round 2 on algorithm2's rebuilds
   cluster only the clients seen the round before; at least one must),
   and md under 20 % mid-round dropout, 5 rounds each, gated on
   every drawn client being available and ``n_available`` / ``n_dropped``
   equal to the population's masks recomputed on the host; a sketched
   stratified cell (d′ = 64, 3 rounds); the zoo and a churned algorithm2
   at dim 32 on the card against the CPU (equal draws, equal plans, a
   restricted rebuild among them, importance's q within 1e-6 relative,
   losses to atol 1e-4); the
   md-vs-``importance(mix=1.0)`` parity gate on the card. Counts reset at
   the phase's start and read at its end: one aggregate launch a round on
   the card, one Gram launch a plan build of algorithm2, stratified,
   dp_stratified and hybrid (each scheme's builds counted on their own,
   so dp_stratified's host-noised release must reach B1 on the card) and
   none in importance's, one SRP launch a sketched round. It prints each
   scheme's round ms and ``plan_build_ms`` and the DP release's ms;
10. sched  — round schedulers, overselection, checkpoint/resume and the
   service at the same width (algorithm2, Ward, arccos, sync planner,
   ``PAPER_TRAIN``, 6 rounds a run): an explicit ``SyncScheduler``
   bit-identical to no scheduler (params and every record); ``deadline``
   (straggle 0.3, slow 2, discount 0.5) under Poisson churn with the
   tracker at 0.95, gated on ``n_late`` equal to the latency model's mask
   recomputed on the host over the drawn, available, not-dropped clients,
   each round harvesting the round before's late clients, and no late
   update in its round's observation; run twice, bit-identical; killed at
   round 3 with a harvest pending and resumed by a fresh server,
   bit-identical in params, history and store, with no plan build or Gram
   launch at the restore; the same with the SRP sketch to d′ = 64;
   ``overselect`` β = 0.5 (at most m draws aggregated, ``n_late`` the
   surplus, realized plus stale weight 1 within 1e-12; importance raises);
   a dim-32 bundle from the card resumed on the CPU (equal draws and plans
   for 2 rounds); ``fl_service --device cuda`` as a subprocess, SIGTERMed
   after 3 status lines and resumed (exit 0 both times, a contiguous
   history, agg_weights equal to the in-process run). Counts reset at the
   phase's start: one aggregate launch a card round, one Gram launch an
   Algorithm 2 build on the card, one SRP launch a sketched observation
   or harvest scatter with rows. It prints each run's round ms and
   ``plan_build_ms`` and the checkpoint's write ms, bytes and resume ms;
11. train  — ``launch/train.py``'s path: the flash route's gradients (the
   kernel's forward, the torch-ops backward) against autograd through the
   plain version on small inputs (f32 atol 2e-5; bf16 2⁻⁷ of the scale of
   each gradient's summed terms); 5 AdamW steps of the reduced
   qwen3-0.6b (f32) on the card against the CPU (losses and gradient
   norms to atol 1e-4) and the card's train-state bundle restored on the
   CPU bit for bit; then qwen3-0.6b at full width and depth (28 layers,
   596,049,920 parameters), bf16 over f32, batch 4 × seq 1,024, 10 steps
   of AdamW with ``linear_warmup_cosine`` and clip 1.0: every loss and
   gradient norm finite, flash launched 28 times a forward (twice a step
   under remat); step ms, peak memory, one more step under
   ``torch.profiler``, and the flash route at the train shape held
   against the plain version under the bf16 limit, then timed beside SDPA
   (forward and backward);
12. fl_lm  — clustered-sampling federated LM: B2 and B3 at (8,
   596,049,920), qwen3-0.6b's flat rows (B2 against its plain version
   column block by column block, B3 against the plain product on column
   windows of an X zero elsewhere, the last window ending at the last
   column), both timed beside their bounds and their library calls (B3's:
   ``torch.matmul(X[:, w], S_w)`` summed over 2²²-column windows covering
   every column, each S_w made untimed); ``run_federated_lm`` on a
   narrow reduced qwen3 (f32) on the card against the CPU (md, algorithm2,
   algorithm2 with SRP: equal draws and plans, losses to atol 1e-4); then
   at full width with ``FLLMConfig``'s defaults (32 clients, m = 8, 4
   local steps of 4 × 64, lr 0.05) for 3 rounds, with md and with
   algorithm2 on the SRP-sketched store (d′ = 64): launches counted after
   the sampler's construction (aggregate a round, srp a sketched
   observation, gram a rebuild, flash 28 a forward), each rebuild's Gram
   of the (32, 64) store against ``G @ G.T`` in f64, round ms and its
   parts (local steps, flatten, B2, the observation, B3, plan rebuild);
   one local step under ``torch.profiler``;
13. serve_moe — ``generate`` at qwen2-moe-a2.7b's full width and depth (24
   layers, d_model 2,048, 16 heads with 16 kv, 60 routed experts top-4 and
   4 shared, 14,315,735,040 parameters), bf16 over f32 random parameters,
   batch 4, prompt 1,000, 16 greedy tokens, after emptying the allocator's
   cache: prefill ms, decode ms a step, tokens/s, peak memory, 24 flash
   launches in the prefill and 0 in decode, finite logits and tokens equal
   to the per-step argmax; layer 0's MoE FFN at full width in f32 on the
   card against the CPU (the same experts and kept set, outputs within
   1e-4 of their scale); the prefill again through the plain attention,
   its tokens equal wherever the plain margin exceeds twice the largest
   logit difference, with the routing choices that differ between the two
   prefills counted; one prefill and one decode step under
   ``torch.profiler``;
14. serve_mla — ``generate`` at deepseek-v2-lite-16b's full width and
   depth (27 layers: a dense ``("mla", "mlp")`` block of d_ff 10,944, then
   26 ``("mla", "moe")``; d_model 2,048, 16 heads, MLA latent 512 with
   rope / nope / v head dims 64 / 128 / 128; 64 routed experts top-6 and 2
   shared of d_ff 1,408, capacity 240; 15,706,484,224 parameters), bf16
   over f32 random parameters, naive decode, batch 4, prompt 1,000, 16
   greedy tokens, after serve_moe freed its parameters: prefill ms, decode
   ms a step, tokens/s, peak memory, no flash launch (MLA's qk and v head
   dims differ; its attention is torch ops, as the reference's is outside
   Pallas); layer 0's MLA in f32 card vs CPU (output and cache seed within
   1e-4 of their scale); layer 1's MoE FFN card vs CPU (the same experts
   and kept set); one prefill's cache decoded 4 steps in ``"absorbed"``
   mode against ``"naive"``, in bf16 and in f32, tokens equal wherever
   naive's top-2 margin exceeds twice the largest logit difference; one
   prefill and one decode step under ``torch.profiler``;
15. train_moe — reduced deepseek-v2-lite and reduced qwen2-moe (f32) 3
   AdamW steps on the card against the CPU (losses, aux, gradient norms to
   atol 1e-4); ``launch/train.py``'s step on deepseek-v2-lite at full width
   cut to 2 layers (the dense block and one MoE block, 1,085,287,424
   parameters), bf16 over f32, batch 4 × 1,024, AdamW, clip 1.0, remat on,
   10 steps: finite losses, aux > 0, no flash launch, step ms, tokens/s,
   peak memory, one step profiled; one loss and gradient with remat off and
   on (the recompute's expert choices, kept set and gates equal the
   forward's, the loss the same bits, each gradient leaf within 2⁻⁶ of its
   scale);
16. fl_moe — B2 and B3 at (8, 1,085,287,424) as in fl_lm (B3's library
   time too); the narrow reduced deepseek-v2-lite card against CPU (md,
   algorithm2, algorithm2 with SRP); ``run_federated_lm`` on train_moe's
   2-layer cut with ``FLLMConfig``'s defaults, 2 rounds each of md and
   algorithm2 on the SRP-sketched store (d′ = 64): launches exactly
   aggregate a round, srp a sketched round, gram a rebuild, flash none;
   round ms and its parts; one local step under ``torch.profiler``;
17. serve_rglru — ``generate`` at recurrentgemma-9b's full width and
   depth (38 layers: 12 × (rglru, rglru, local) and 2 rglru; d_model and
   lru width 4,096, 16 heads with one kv head of 256, window 2,048, d_ff
   12,288, vocab 256,000; 9,396,408,320 parameters), bf16 over f32 random
   parameters, batch 4, prompt 1,000, 16 greedy tokens, after serve_mla
   freed its parameters: prefill ms, decode ms a step, tokens/s, peak
   memory, no flash launch (the RG-LRU is torch ops, the local attention
   ``attend``, as the reference's); layer 0's RG-LRU block (output, h,
   conv tail) and layer 2's local attention (output, k, v) in f32 card vs
   CPU within 1e-4 of their scale; in f32, batch 1, a 2,060-token prompt
   (past the 2,048 window: the ring rolled by 12) and 4 decode steps
   against one forward over the 2,064 tokens, within 1e-4 of the logits'
   scale; one prefill and one decode step under ``torch.profiler``;
18. serve_xlstm — the same at xlstm-125m's full width and depth (12 layers
   alternating mLSTM and sLSTM, d_model 768, 4 heads, vocab 50,304;
   143,345,712 parameters), the decode-against-forward check at batch 4 ×
   prompt 1,000; ``small_input`` also runs reduced recurrentgemma (5
   layers, past its window of 16) and reduced xLSTM card vs CPU, and
   reduced xLSTM with ``mlstm_chunk`` 8 on a 24-token prompt
   (``mlstm_chunkwise`` in each prefill);
19. train_recurrent — reduced recurrentgemma and reduced xLSTM (f32) 3
   AdamW steps card vs CPU (losses and gradient norms to atol 1e-4); then
   ``launch/train.py``'s step (AdamW lr 3e-3, clip 1.0, remat on, bf16
   over f32) on xlstm-125m at full width and depth and on recurrentgemma-9b
   at full width cut to its first period (1,705,078,784 parameters), 3
   steps of 4 × 1,024 each: finite losses that fall, no flash launch, step
   ms, tokens/s, peak memory, one more step profiled (xLSTM's at 4 × 128);
20. fl_xlstm — B2 and B3 at (8, 143,345,712) as in fl_lm; the narrow
   reduced xLSTM card vs CPU (md, algorithm2, algorithm2 with SRP);
   ``run_federated_lm`` on xlstm-125m at full width with ``FLLMConfig``'s
   defaults but lr 0.01 and 2 local steps, 1 round each of md and sketched
   algorithm2:
   launches exactly aggregate a round, srp a sketched round, gram a
   rebuild, flash none; each Gram against ``G @ G.T`` in f64; round ms and
   its parts; one local step under ``torch.profiler``;
21. serve_whisper — ``generate`` at whisper-small's full width and depth
   (12 ``bidir`` encoder blocks over 1,500 zero stub frames, 12 decoder
   blocks with cross-attention, sinusoidal positions; d_model 768, 12 heads
   with 12 kv heads of 64, vocab 51,865; 294,766,848 parameters), bf16 over
   f32 random parameters, batch 4, prompt 1,000, 16 greedy tokens: prefill
   ms, decode ms a step, tokens/s, peak memory, 12 flash launches in the
   prefill (the decoder's causal self-attention, head dim 64) and 0 in
   decode (the encoder and cross-attention are ``attend``, as the
   reference's); encoder block 0 and decoder block 0 (output, ck, cv) in
   f32 card vs CPU within 1e-4 of their scale; in f32, 4 decode steps after
   a prefill of 1,000 against one forward over the 1,004 tokens, within
   1e-4 of the logits' scale; one prefill and one decode step under
   ``torch.profiler``;
22. serve_vl — the same at qwen2-vl-2b's full width and depth (qwen2-1.5b's
   backbone with M-RoPE sections (16, 24, 24) and 256 zero vision slots;
   1,543,714,304 parameters): 28 flash launches in the prefill and 0 in
   decode; M-RoPE's angles and layer 0's attention in f32 card vs CPU;
   decode against the forward in f32; a profiled prefill and decode step;
23. train_extras — reduced whisper-small and reduced qwen2-vl (f32) 3 AdamW
   steps card vs CPU (losses and gradient norms to atol 1e-4); then
   ``launch/train.py``'s step (AdamW lr 3e-3, clip 1.0, remat on, bf16 over
   f32) on both at full width and depth, whisper with its zero stub frames,
   qwen2-vl with seeded random vision embeddings at the token embeddings'
   scale (under the zero stubs the gradient overflows in both packages at
   its depth), 3 steps of 4 × 1,024 each: finite losses, flash launched 24
   times a step for whisper
   and 56 for qwen2-vl (once an attention layer a forward, again in the
   backward's recompute), step ms, tokens/s, peak memory, one more step
   profiled; then B4 at whisper's train shape (4, 1,024, 12, 12, 64): the
   forward and the torch-ops backward against autograd through the plain
   version (the train phase's limits), timed beside SDPA's forward and
   backward;
24. fl_vl — B2 and B3 at (8, 1,543,714,304) as in fl_lm; the narrow reduced
   qwen2-vl card vs CPU (md, algorithm2, algorithm2 with SRP);
   ``run_federated_lm`` on qwen2-vl-2b at full width and depth with
   ``FLLMConfig``'s defaults (the local step trains on tokens, M-RoPE with
   t = h = w, as the reference's), 1 round each of md and sketched
   algorithm2: launches exactly aggregate a round, srp a sketched round,
   gram a rebuild, flash 56 a local step; each Gram against ``G @ G.T`` in
   f64; round ms and its parts; one local step under ``torch.profiler``;
25. bench — the port's eight ``bench_*`` modules
   (``repro_torch/benchmarks/``) through their ``main`` in full mode on the
   card (``bench_async_planner`` with ``--drift``), their ``common.ROWS``
   gated: each module's row names exactly the reference's in full mode
   (``BENCH_ROWS``; ``bench_kernels``' mapped), a finite positive time on
   every timed row, ``parity=bit-identical`` on the churn sweep's static row
   and the scheduler sweep's sync row, ``bench_kernels``' wrapper rows
   within the kernels' limits above (the Gram's 1e-5·‖g_i‖·‖g_j‖, the
   aggregate's 2e-5, f32 flash 2e-5) and timed at or above the H100 bound
   both by the host clock ending in ``synchronize`` and by events, the
   launches of every kernel a module reaches rising, the aggregate kernel
   once a round of either engine in ``bench_round_engine`` and the SRP
   kernel once a sketched scatter in ``bench_store_scale``; one ``bench``
   JSON line with every row, each module's seconds and launches;
26. block_q — ``cfg.attn_block_q``'s query-row blocks at full width in f32:
   qwen3-0.6b's layer-0 ``attention_full`` and xlstm-125m's
   ``mlstm_parallel`` over 4 × 1,024, blocks of 256 rows against the whole
   form (bq 1,024), output (and k, or the mLSTM's final state) and input
   gradient within 1e-5 of their scale, ms and peak memory of each; then
   two qwen3-0.6b train steps (bf16 over f32, remat on) at bq 512 against
   1,024: the first step's loss within 1e-3 relative, the loss, gradient
   norm, the second step's ms and peak memory printed;
27. dryrun — (after sharded; alone as ``python3 chip_smoke.py dryrun``)
   the dry-run's counting (``launch/roofline.py``) held to the card:
   qwen3-0.6b's train step at TRAIN's 4 × 1,024 on one position and over
   train_sharded's 2 × 2 mesh (3 steps), qwen2-1.5b's prefill at the serve
   shape and one federated round at fl_lm's shapes (one local step) over
   the sharded phase's mesh, each counted on the card and on meta tensors over the same mesh
   (a process a step, started with the phase, done before any step is timed):
   FLOPs, bytes accessed, B4's and B2's calls and work and the bytes moved,
   by position, equal; each kernel's calls in each step equal to its
   wrapper's launches (zeroed before the step), by position on the meshes;
   the 2 × 2 mesh's parameter bytes by position against the placements;
   the one-position train step's and the prefill's counted peaks within
   10 % of ``max_memory_allocated``; each step's median ms in turns, with
   nothing else running, beside its MFU (model FLOPs at the H100 SXM data
   sheet's bf16 peak), its least-work bound (the counted FLOPs at the peak,
   each argument read and each output written once) and its per-op bound
   (every op's bytes, a diagnostic). Alone, then the host's records:
   ``launch.dryrun`` on the 16 × 16 meta mesh for qwen3-0.6b ``train_4k``,
   qwen2-1.5b ``prefill_32k`` and deepseek-v2-lite-16b ``decode_32k`` and
   ``launch.dryrun_fl`` for qwen3-0.6b (N = 8, sync planner), each
   record's per-chip FLOPs, bytes, moved bytes by kind, HBM, terms,
   dominant term and seconds (in the whole run they are left to this mode
   and to ``python -m repro_torch.launch.dryrun``: counting them takes
   ~6 minutes of the host, beside which no step time would hold).

The last lines are the card's name and power limit (nvidia-smi), a JSON
object with one entry per kernel and shape (with the paper, zoo, sched
and fl_lm phases' launches as ``paper_launches``, ``zoo_launches``,
``sched_launches`` and ``fl_lm_launches`` for the Gram, aggregate and SRP
rows, the ablations phase's as ``ablations_launches`` for the Gram, L1
and aggregate rows, the train and fl_lm phases' as ``train_launches`` and
``fl_lm_launches`` for the flash row, serve_moe's as the launches of
the ``flash_attention_moe`` row, fl_moe's as ``fl_moe_launches`` for the
Gram, aggregate, SRP and flash rows, fl_xlstm's as ``fl_xlstm_launches``
for the same rows, fl_vl's as ``fl_vl_launches`` for the same rows, and
serve_mla's, train_moe's, serve_rglru's, serve_xlstm's,
train_recurrent's, serve_vl's and train_extras' (qwen2-vl's) as
``serve_mla_launches``, ``train_moe_launches``, ``serve_rglru_launches``,
``serve_xlstm_launches``, ``train_recurrent_launches``,
``serve_vl_launches`` and ``train_extras_launches`` for the flash row;
serve_whisper's as the launches of the ``flash_attention_whisper`` row,
with whisper's train_extras launches as its ``train_extras_launches``, the
bench phase's as ``bench_launches`` for the Gram, L1, aggregate, SRP and
flash rows, and the dryrun phase's wrapper launches as ``dryrun_launches``
for the aggregate and flash rows; the widened domain's rows, which no
model path reaches, with the kernels phase's launches at their shapes and
``launches_from`` saying so),
and ``{"ok": true, "device": ...}``.
The script imports neither JAX nor the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks (NVIDIA data sheets): device memory bytes/s, f32 FLOP/s
# outside the tensor cores and bf16 dense tensor-core FLOP/s, by the part
# the device name shows.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100 SXM": (3.35e12, 67e12, 989e12),
}

SIM_SHAPES = [(100, 39760), (13, 101), (257, 8193)]  # the path's shape first
SIM_SCALE = 1e-3  # update scale of G rows (θ_i − θ after lr-scaled SGD)
SIM_ATOL = 1e-4  # L1: entries are sums of |differences|, 0.1–50 here
# Gram: tolerance relative to ‖g_i‖·‖g_j‖, so the check is as strict at
# every scale of G; the floor only covers a pair of zero rows
GRAM_RTOL = 1e-5
GRAM_FLOOR = 1e-30
AGG_SHAPE = (11, 39760)  # m = 10 client rows + the θ^t row
# the main path's, bench_round_engine's m = 40, and a ragged p whose rows
# are not 16-byte aligned
AGG_SHAPES = [AGG_SHAPE, (41, 39760), (11, 39759)]
AGG_TOL = 2e-5
AGG_PASS_ROWS = 8  # rows a pass of csrc/aggregate.cu, all in flight before the pass's FMAs
WIDTH = (784, 50, 10)
D_PRIME = 64  # sketch width of slice[srp] and the fleet (bench_store_scale's d')
SKETCHED_SIM_SHAPE = (100, D_PRIME)
# the host-chunked distance path on a host G of 100 rows and 1,080,000,000 B
# of f32, more than one slab of STREAM_D_THRESHOLD columns can ever need on
# the card; its arccos distances against the one-shot op's: an f32 Gram
# over 2.7 M coordinates summed in 330 slabs against one pass
CHUNKED_HOST_D = 2_700_000
CHUNKED_ATOL = 1e-4  # the sketched store the similarity kernel reads
# (c, d, d'): the round's 10 rows, the fleet's 64, a ragged shape, tiny ones
# with fewer k-tiles than splits (d = 96: 2 k-tiles, 8 splits), and 130 rows
# over three row tiles
SRP_SHAPES = [(10, 39760, D_PRIME), (64, 39760, D_PRIME), (13, 1037, 64), (8, 96, 8),
              (5, 96, 64), (130, 39760, D_PRIME)]
SRP_SEED = 7
# SRP: tolerance relative to ‖x_i‖·‖S_:,j‖, the scale of an output entry
SRP_RTOL = 1e-5
SIGN_D = 1037  # the identity block whose sketch is S itself
FLEET = dict(n=100_000, m=20, rows=64, rounds=3)
DEV = "cuda"  # the LM phases' device
# flash attention (B, S, H, KV, hd): the reference's test shapes
# (tests/test_kernels.py), a ragged S = T = 1,000 at hd 128, and the serve
# path's shape
FLASH_F32_SHAPES = [(1, 32, 4, 4, 16), (2, 64, 8, 2, 32), (1, 48, 6, 1, 64), (2, 40, 4, 2, 8),
                    (1, 1000, 4, 2, 128)]
FLASH_PATH = (4, 1000, 12, 2, 128)
FLASH_MOE = (4, 1000, 16, 16, 128)  # qwen2-moe-a2.7b's prefill attention: no GQA sharing
# qwen2-1.5b's attention at a longer prompt (its cell is prefill_32k): the
# plain version's f32 scores are 3.2 GB
FLASH_LONG = (1, 8192, 12, 2, 128)
FLASH_LONG_ROW = "flash_attention_long"
# the wgmma route's instances, flash_fwd_wgmma<T, HDP, NWG>: bf16 and f16,
# HDP 64 and 128, one and two consumer warpgroups
FLASH_WGMMA_INSTANCES = 8
# whisper-small's decoder prefill attention: head dim 64, no GQA sharing
FLASH_WHISPER = (4, 1000, 12, 12, 64)
FLASH_BF16_SHAPES = [
    (1, 32, 4, 2, 16), FLASH_PATH, FLASH_MOE,
    # every padded head dim of the bf16 kernel (32, 64, 128); hd 8 and 72
    # leave pad columns inside a 16-column k-step
    (2, 70, 4, 2, 8), (1, 96, 4, 1, 32), (1, 130, 6, 2, 64), (1, 77, 4, 2, 72),
    # ragged S = T around the 64-row q-tiles and 64-key k-tiles
    (2, 1, 4, 2, 128), (1, 63, 4, 2, 128), (1, 65, 8, 2, 128), (2, 77, 12, 2, 128),
    (1, 1000, 4, 2, 128),
    # qwen3-0.6b's attention in the fl_lm phase's local steps (batch 4 × seq 64)
    (4, 64, 16, 8, 128),
    FLASH_WHISPER,
]
FLASH_NONCAUSAL = [((2, 33, 4, 2, 32), t) for t in (48, 70)]  # ((B, S, H, KV, hd), T)
# head dims the reference takes beyond those, at (B, S, H, KV) with S = T
# ragged around the 64-row and 32-row q-tiles: not multiples of 8 (12, 20:
# copied 8 bytes at a time in bf16), the f32 kernel's 128-column chunks
# (200, 256, 320), the tensor-core kernel's HDP 256 and its 128-column
# chunks above 256 (320); in f32 and bf16
FLASH_WIDE = (2, 130, 4, 2)
FLASH_WIDE_HDS = (12, 20, 200, 256, 320)
# f16 on the tensor-core kernel: hd 96 (HDP 128, pad columns) and 128
FLASH_F16_SHAPES = [(2, 130, 4, 2, 96), (2, 130, 4, 2, 128)]
FLASH_FOLD = (2, 3, 66_000, 6, 16)  # B·H = 132,000 with H past a grid axis's 65,535
# the rows of the widened domain, checked and timed at the serve batch and
# prompt: recurrentgemma-9b's heads (16 query heads, 1 kv head, hd 256) in
# bf16 (HDP 256) and f16, the serve path's in f16, hd 320 in bf16 (the
# 128-column chunks) and hd 200 in f32 (the f32 kernel's chunks)
FLASH_HD256 = (4, 1000, 16, 1, 256)
FLASH_WIDE_ROWS = [("flash_attention_hd256", "bfloat16", FLASH_HD256),
                   ("flash_attention_f16_hd256", "float16", FLASH_HD256),
                   ("flash_attention_f16", "float16", FLASH_PATH),
                   ("flash_attention_hd320", "bfloat16", (4, 1000, 12, 2, 320)),
                   ("flash_attention_f32_hd200", "float32", (4, 1000, 12, 2, 200))]
# mixed dtypes (all 24 combinations of f32, bf16 and f16 for q, k and v that
# are not one dtype) at the reference's smallest test shape, and the serve
# path's shape with q and k bf16 and v f32: the f32 kernel instantiated on
# v's and q's dtypes, FLASH_F32_INSTANCES instances in all
FLASH_MIXED_SHAPE = (1, 32, 4, 2, 16)
FLASH_MIXED_PATH = ("bfloat16", "bfloat16", "float32")
FLASH_MIXED_ROW = "flash_attention_mixed"
# one k-tile: the kernel's p rounding must sit this many times closer to the
# plain version's than p unrounded does
FLASH_P_ROUNDING = 4.0
FLASH_F32_INSTANCES = 9
FLASH_F32_ATOL = 2e-5  # the reference's
FLASH_BF16_ATOL = 3e-2  # the reference's, the loosest the bf16 limit may be
# bf16: two ulps (2⁻⁸ each) of the output's scale, which is bounded by the
# softmax-weighted |v|: p rounded against another running max, and the
# output rounded once
FLASH_BF16_REL = 2.0**-7
FLASH_F16_REL = 2.0**-10  # the same two units of roundoff in f16 (2⁻¹¹ each)
SERVE = dict(arch="qwen2-1.5b", batch=4, prompt_len=1000, gen=16)
SERVE_SMALL = dict(arch="qwen2-1.5b", n_layers=2, batch=2, prompt_len=19, gen=6)
SERVE_SMALL_ATOL = 1e-4
# bf16: the bf16 model test's logit tolerance (tests/test_torch_lm_model.py),
# and tokens must agree wherever the CPU's top-2 margin exceeds 0.2
SERVE_SMALL_BF16_ATOL = 0.1
SERVE_SMALL_BF16_MARGIN = 0.2
# clock cycles the device sleeps before a timed run, so the host has queued
# every call when the first starts (about 5 ms at 2 GHz)
QUEUE_CYCLES = 10_000_000


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def peaks_for(name: str) -> tuple[str, float, float, float]:
    for part in ("H100 PCIe", "H100 NVL"):
        if part.split()[1] in name:
            return (part, *PEAKS[part])
    return ("H100 SXM", *PEAKS["H100 SXM"])


def gram_rel_err(got, want, G) -> float:
    """max |got − want| / (‖g_i‖·‖g_j‖ + floor) over the (n, n) Gram entries."""
    norms = G.double().norm(dim=1)
    scale = norms[:, None] * norms[None, :] + GRAM_FLOOR
    return float(((got.double() - want.double()).abs() / scale).max())


def srp_rel_err(got, want, X, d_prime: int) -> float:
    """max |got − want| / (‖x_i‖·√(d/d′) + floor) over the (c, d′) entries."""
    col = math.sqrt(X.shape[1] / d_prime)  # ‖S_:,j‖: d entries of ±1/√d′
    scale = X.double().norm(dim=1)[:, None] * col + GRAM_FLOOR
    return float(((got.double() - want.double()).abs() / scale).max())


def flash_lowest(*tensors) -> str:
    """The lowest precision among the tensors' dtypes: "bfloat16", else
    "float16", else "float32"."""
    names = {str(t.dtype).removeprefix("torch.") for t in tensors}
    return next(d for d in ("bfloat16", "float16", "float32") if d in names)


def flash_p_rounding(got, q, k, v) -> tuple[float, float]:
    """(mean |got − plain|, mean |got − plain with p unrounded|) of a call
    whose v is 16-bit: within one k-tile (T <= 64) the kernel's running max
    is the row's max, so p rounded to v's dtype matches the plain version's
    but for rare last-bit flips, and a kernel that widened v without
    rounding p would sit as far from the plain version as the unrounded
    form does."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    want = flash_attention_plain(q, k, v).float()
    unrounded = flash_attention_plain(q, k, v.float()).float()
    return (float((got.float() - want).abs().mean()), float((got.float() - unrounded).abs().mean()))


def flash_excess(got, want, q, k, v, causal=True) -> float:
    """max |got − want| / limit over the outputs of a call, at the limit of
    the lowest precision among q, k and v: FLASH_F32_ATOL for f32, for bf16
    min(FLASH_BF16_ATOL, FLASH_BF16_REL·(|want| + A)) with A = Σ_j p_ij·|v_j|,
    the plain version's f32 attention over |v|, and for f16 the same with
    FLASH_F16_REL."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    err = (got.float() - want.float()).abs()
    lowest = flash_lowest(q, k, v)
    if lowest == "float32":
        return float(err.max()) / FLASH_F32_ATOL
    scale = want.float().abs() + flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                                       causal=causal)
    rel = FLASH_BF16_REL if lowest == "bfloat16" else FLASH_F16_REL
    return float((err / (rel * scale).clamp(max=FLASH_BF16_ATOL)).max())


def time_ms(torch, fn, reps: int = 50, queued: bool = False) -> float:
    """Mean ms per call over ``reps`` calls after warm-up, by CUDA events.

    With ``queued`` the device first sleeps QUEUE_CYCLES, so the host has
    enqueued all ``reps`` calls before the first runs: the events then time
    the device's work alone, however slow the host's calls are."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_name(name: str) -> str:
    """``flash_fwd_mma<__half,128>`` from an Itanium-mangled kernel name
    (``_ZN12_GLOBAL__N_113flash_fwd_mmaI6__halfLi128EEEv...``: the innermost
    length-prefixed identifier and its integer, named-type, builtin-type
    (``f``: float) and repeated-type (``S1_``: the first type argument, after
    the namespace and the template's name) template arguments), or from
    a demangled one (``void (anonymous namespace)::pairwise_partial<0, 8>(float
    const*, ...)``: the last name before the arguments)."""
    import re

    i = name.find("_Z")
    if i < 0:
        head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].removeprefix("void ").strip()
        depth, cut = 0, 0
        for k, ch in enumerate(head):
            depth += (ch == "<") - (ch == ">")
            if depth == 0 and head.startswith("::", k):
                cut = k + 2
        return head[cut:].replace(" ", "")[:60] or name[:60]
    i += 3 if name.startswith("_ZN", i) else 2
    ident = None
    while found := re.match(r"\d+", name[i:]):
        n, i = int(found.group()), i + len(found.group())
        ident, i = name[i:i + n], i + n
    if ident is None:
        return name[:60]
    if not name.startswith("I", i):
        return ident
    # template arguments: integers (Li128E), named types (6__half), builtin
    # types (f) and substitutions of an earlier type argument (S1_)
    args, types, i = [], [], i + 1
    while found := re.match(r"Li(-?\d+)E|(\d+)|([fdijb])|S(\d*)_", name[i:]):
        i += len(found.group())
        if found.group(1) is not None:
            args.append(found.group(1))
        elif found.group(2) is not None:
            types.append(name[i:i + int(found.group(2))])
            args.append(types[-1])
            i += int(found.group(2))
        elif found.group(3) is not None:
            args.append({"f": "float", "d": "double", "i": "int", "j": "unsigned", "b": "bool"}[
                found.group(3)])
        else:  # S_ is the namespace, S0_ the template's name, S1_ the first type argument
            k = 0 if found.group(4) == "" else int(found.group(4)) + 1
            args.append(types[k - 2] if 2 <= k < len(types) + 2 else "?")
    return ident + (f"<{','.join(args)}>" if name.startswith("E", i) else "")


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, line) for each register and spill line of a ``-Xptxas -v``
    log, attributed to the entry function it follows."""
    rows, fn = [], "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = _kernel_name(line.split("Function properties for", 1)[1].strip())
        elif "Compiling entry function" in line:
            fn = _kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            rows.append((fn, line.strip()))
    return rows


def ptxas_serialized(log: str) -> list[tuple[str, str]]:
    """(kernel, line) for each "wgmma.mma_async instructions are serialized"
    line of a ``-Xptxas -v`` log, attributed to the kernel it names."""
    rows = []
    for line in log.splitlines():
        if "instructions are serialized" in line:
            named = line.rsplit("'", 2)
            fn = _kernel_name(named[-2]) if len(named) == 3 else "?"
            rows.append((fn, line.strip()))
    return rows


def sass_by_kernel(lib_path) -> dict | None:
    """{kernel: its instruction lines in ``cuobjdump -sass`` of the library,
    in code order}, or None where cuobjdump is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    lines, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line.split("Function :", 1)[1].strip())
            lines[fn] = []
        elif fn is not None:
            lines[fn].append(line)
    return lines


def sass_counts(lib_path, ops=("HMMA",)) -> dict | None:
    """{kernel: {op: count of its instructions}} in ``cuobjdump -sass`` of
    the library, for each opcode in ``ops`` (matched as a whole word before
    any modifier), or None where cuobjdump is missing."""
    import re

    if (sass := sass_by_kernel(lib_path)) is None:
        return None
    pattern = re.compile(r"\s(" + "|".join(ops) + r")[\s.]")
    counts = {}
    for fn, lines in sass.items():
        counts[fn] = dict.fromkeys(ops, 0)
        for found in filter(None, map(pattern.search, lines)):
            counts[fn][found.group(1)] += 1
    return counts


def sass_loads_ahead(lib_path) -> dict | None:
    """{kernel: [LDG before its first FFMA, 64-bit ones among them, LDG in
    all, FFMA in all]} in ``cuobjdump -sass`` of the library, or None where
    cuobjdump is missing."""
    import re

    if (sass := sass_by_kernel(lib_path)) is None:
        return None
    counts = {}
    for fn, lines in sass.items():
        c = counts[fn] = [0, 0, 0, 0]
        for op in filter(None, (re.search(r"\s(LDG|FFMA)((?:\.\w+)*)\s", line) for line in lines)):
            if op.group(1) == "FFMA":
                c[3] += 1
                continue
            c[2] += 1
            if not c[3]:
                c[0] += 1
                c[1] += ".64" in op.group(2)
    return counts


# FP32-pipe opcodes of the similarity kernels: the Gram's product is FFMA,
# L1's is FADD a − b and FADD acc + |·|; any other would be a third
SIM_SASS_OPS = ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "LDS", "LDGSTS")


def phase_build():
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: {secs:.3f} s for {', '.join(s + '.cu' for s in _build.SOURCES)} (sm_90a)")
    spills, f32_kernels, serialized, wgmma_regs = [], [], [], {}
    for name, log in logs.items():
        for fn, line in ptxas_report(log):
            print(f"  ptxas {name} {fn}: {line}")
            if fn.startswith(("flash_fwd_mma", "flash_fwd_wgmma", "flash_fwd_f32", "pairwise_",
                              "aggregate_")) and any(
                    int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                spills.append(f"{fn}: {line}")
            if fn.startswith("flash_fwd_f32") and "registers" in line:
                f32_kernels.append(fn)
            if fn.startswith("flash_fwd_wgmma") and "registers" in line:
                wgmma_regs[fn] = line.split("Used", 1)[-1].strip()
        for fn, line in ptxas_serialized(log):
            print(f"  ptxas {name} {fn}: {line}")
            serialized.append(f"{fn}: {line}")
    if spills:
        fail(f"build: ptxas reports spills in {'; '.join(spills)}")
    # a serialized wgmma pipeline still runs, at mma.sync's rate or worse
    if any(line.startswith("flash_fwd_wgmma") for line in serialized):
        fail(f"build: ptxas serializes wgmma in {'; '.join(serialized)}")
    if len(wgmma_regs) != FLASH_WGMMA_INSTANCES:
        fail(f"build: ptxas reports {len(wgmma_regs)} flash_fwd_wgmma instances, want "
             f"{FLASH_WGMMA_INSTANCES}: {sorted(wgmma_regs)}")
    print(f"build: the {len(wgmma_regs)} flash_fwd_wgmma<T, HDP, NWG> instances (bf16 and f16 at "
          f"32 < hd <= 128), none spilling, no wgmma serialized: "
          + "; ".join(f"{fn} {regs}" for fn, regs in sorted(wgmma_regs.items())))
    # flash_fwd_f32<TV, TO>: v's and the output's types, each f32, bf16 or f16
    if len(f32_kernels) != FLASH_F32_INSTANCES:
        fail(f"build: ptxas reports {len(f32_kernels)} flash_fwd_f32 instances, want "
             f"{FLASH_F32_INSTANCES}: {f32_kernels}")
    print(f"build: the {len(f32_kernels)} flash_fwd_f32 instances (the f32 and mixed-dtype "
          f"routes), none spilling: {', '.join(sorted(f32_kernels))}")
    sim = sass_counts(_build._target("similarity")[1], SIM_SASS_OPS)
    agg = sass_loads_ahead(_build._target("aggregate")[1])
    lib = _build._target("flash_attention")[1]
    counts = sass_counts(lib, ("HMMA", "HGMMA"))
    if counts is None or sim is None or agg is None:
        print(f"build: cuobjdump is missing; HMMA instructions of {lib.name} not counted")
        return
    print(f"build: similarity instructions in cuobjdump -sass by kernel: {json.dumps(sim)}")
    print(f"build: aggregate global loads by kernel (before the first FFMA, 64-bit ones among "
          f"them, all; FFMA): {json.dumps(agg)}")
    if agg.get("aggregate_vec2", [0, 0])[1] < AGG_PASS_ROWS:
        fail(f"build: aggregate_vec2 issues fewer than {AGG_PASS_ROWS} 8-byte row loads before "
             f"its first FFMA: a pass's rows are not all in flight ({agg.get('aggregate_vec2')})")
    for fn, c in sim.items():
        if fn.startswith("pairwise_partial<1") and (c["FFMA"] or c["FMUL"] or c["FMNMX"] or c["FSEL"]):
            fail(f"build: the L1 kernel {fn} has FP32 instructions besides FADD: {c}")
    hgmma = {fn: c["HGMMA"] for fn, c in counts.items() if c["HGMMA"]}
    counts = {fn: c["HMMA"] for fn, c in counts.items()}
    print(f"build: HMMA instructions in cuobjdump -sass of {lib.name}: {json.dumps(counts)}")
    print(f"build: HGMMA (wgmma) instructions: {json.dumps(hgmma)}")
    mma = {fn: n for fn, n in counts.items() if fn.startswith("flash_fwd_mma")}
    if not mma or not all(mma.values()):
        fail(f"build: the bf16 flash kernel has no HMMA instruction: {json.dumps(counts)}")
    wg = [fn for fn in counts if fn.startswith("flash_fwd_wgmma")]
    if len(wg) != FLASH_WGMMA_INSTANCES or not all(hgmma.get(fn) for fn in wg):
        fail(f"build: a flash_fwd_wgmma instance issues no HGMMA: {json.dumps(hgmma)}")


def phase_kernels(torch, gen):
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.similarity.ref import gram_ref, l1_ref

    err = {"gram": 0.0, "l1": 0.0, "aggregate": 0.0}
    for n, d in SIM_SHAPES:
        G = (SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
        for op, ref in (("gram", gram_ref), ("l1", l1_ref)):
            torch.cuda.synchronize()
            got = sim_ops.pairwise_sums(G, op)
            again = sim_ops.pairwise_sums(G, op)
            want = ref(G)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            if op == "gram":
                rel = gram_rel_err(got, want, G)
                if not math.isfinite(rel) or rel > GRAM_RTOL:
                    fail(f"gram kernel at ({n}, {d}): error {rel} of ‖g_i‖·‖g_j‖ > {GRAM_RTOL}")
                limit = f"{rel:.3e} of ‖g_i‖·‖g_j‖ (limit {GRAM_RTOL})"
            else:
                if not math.isfinite(e) or e > SIM_ATOL:
                    fail(f"l1 kernel at ({n}, {d}): max abs error {e} > {SIM_ATOL}")
                limit = f"atol {SIM_ATOL}"
            if not torch.equal(got, again):
                fail(f"{op} kernel at ({n}, {d}) is not bit-reproducible")
            if not torch.equal(got, got.T):
                fail(f"{op} kernel at ({n}, {d}) is not symmetric bit for bit")
            err[op] = max(err[op], e)
            print(f"kernels: {op} ({n}, {d}) max_abs_err {e:.3e}, {limit}, "
                  f"max |want| {float(want.abs().max()):.3e}, reproducible, symmetric")
    n, d = SKETCHED_SIM_SHAPE
    G = (SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
    got, want = sim_ops.pairwise_sums(G, "gram"), gram_ref(G)
    rel = gram_rel_err(got, want, G)
    if not math.isfinite(rel) or rel > GRAM_RTOL:
        fail(f"gram kernel at the sketched store's ({n}, {d}): error {rel} of ‖g_i‖·‖g_j‖")
    got_l1, want_l1 = sim_ops.pairwise_sums(G, "l1"), l1_ref(G)
    e_l1 = float((got_l1 - want_l1).abs().max())
    if not math.isfinite(e_l1) or e_l1 > SIM_ATOL:
        fail(f"l1 kernel at the sketched store's ({n}, {d}): max abs error {e_l1} > {SIM_ATOL}")
    splits, per = sim_ops.split_plan(n, d)
    if splits != 1:
        fail(f"similarity at the sketched store's ({n}, {d}): {splits} d-splits, expected one launch")
    for what, a in (("gram", got), ("l1", got_l1)):
        if not torch.equal(a, a.T) or not torch.equal(a, sim_ops.pairwise_sums(G, what)):
            fail(f"{what} kernel at ({n}, {d}) is not symmetric and bit-reproducible")
    print(f"kernels: gram and l1 ({n}, {d}) (the sketched store: {splits} d-split of {per} "
          f"chunks, one launch) gram {rel:.3e} of ‖g_i‖·‖g_j‖ (limit {GRAM_RTOL}), l1 max_abs_err "
          f"{e_l1:.3e} (atol {SIM_ATOL}), symmetric and reproducible bit for bit")
    sim_kernels_a_call(torch, gen)
    err["srp"] = phase_kernels_srp(torch, gen)
    err["aggregate"] = phase_kernels_agg(torch, gen)
    kernels_trees(torch, gen)
    kernels_chunked(torch, gen)
    err["flash"] = phase_kernels_flash(torch, gen)
    return err


def kernels_trees(torch, gen) -> None:
    """``aggregate_trees`` over AGG_SHAPE's rows as the MNIST MLP's
    parameter dicts (10 clients and θ^t): one B2 launch a call, bit-equal to
    ``aggregate_flat`` over the same flat rows, within AGG_TOL of the plain
    version, each leaf in its shape and dtype."""
    from repro_torch.fl.aggregation import flatten_params, unflatten_params
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref
    from repro_torch.models.simple import init_mlp

    like = init_mlp(WIDTH, seed=0, device=DEV)
    k = AGG_SHAPE[0]
    trees = [{key: (SIM_SCALE * torch.randn(v.shape, generator=gen)).to(DEV) for key, v in like.items()}
             for _ in range(k)]
    w = torch.rand(k, generator=gen).to(DEV)
    before = agg_ops.launches["aggregate"]
    got = agg_ops.aggregate_trees(trees, w)
    launched = agg_ops.launches["aggregate"] - before
    rows = torch.stack([flatten_params(t) for t in trees])
    if rows.shape != AGG_SHAPE:
        fail(f"aggregate_trees: the MLP's rows are {tuple(rows.shape)}, want {AGG_SHAPE}")
    flat = agg_ops.aggregate_flat(rows, w)
    want = unflatten_params(flat, like)
    plain = aggregate_ref(rows, w)
    torch.cuda.synchronize()
    if launched != 1:
        fail(f"aggregate_trees: {launched} aggregate launches in one call, want 1")
    for key, leaf in like.items():
        if got[key].shape != leaf.shape or got[key].dtype != leaf.dtype:
            fail(f"aggregate_trees: leaf {key} came back {got[key].dtype} {tuple(got[key].shape)}")
        if not torch.equal(got[key], want[key]):
            fail(f"aggregate_trees: leaf {key} differs from aggregate_flat over the same rows")
    e = float((flatten_params(got) - plain).abs().max())
    if not math.isfinite(e) or e > AGG_TOL * (1 + float(plain.abs().max())):
        fail(f"aggregate_trees: max abs error {e} against the plain version")
    print(f"kernels: aggregate_trees over {k} MNIST MLP parameter dicts {AGG_SHAPE}: one B2 launch, "
          f"bit-equal to aggregate_flat, max_abs_err {e:.3e} against the plain version")


def kernels_chunked(torch, gen) -> None:
    """``pairwise_distances_chunked`` on host numpy G: at the main path's
    (100, 39,760), B1 once a slab and Algorithm 2's plans equal to the device
    op's (arccos and L1); at CHUNKED_HOST_D columns (at least 1 GB of f32),
    B1 once a slab, the distances within GRAM_RTOL of the one-shot op's on
    the whole block, and both timed (host clock, ending in a synchronise)."""
    import numpy as np

    from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
    from repro_torch.core.types import ClientPopulation
    from repro_torch.kernels.similarity import ops as sim_ops

    n, d = SIM_SHAPES[0]
    rng = np.random.default_rng(SRP_SEED)
    G = (SIM_SCALE * rng.standard_normal((n, d), dtype=np.float32)).astype(np.float32)
    pop = ClientPopulation(rng.integers(50, 500, size=n))
    for measure in ("arccos", "l1"):
        before = sum(sim_ops.launches.values())
        plan = build_plan_algorithm2(pop, 10, G, measure=measure, distance_fn=lambda G, m: (
            sim_ops.pairwise_distances_chunked(G, m)))
        launched = sum(sim_ops.launches.values()) - before
        want = build_plan_algorithm2(pop, 10, torch.from_numpy(G).to(DEV), measure=measure,
                                     distance_fn="auto")
        slabs = -(-d // sim_ops.STREAM_D_THRESHOLD)
        if launched != slabs:
            fail(f"chunked[{measure}] ({n}, {d}): {launched} B1 launches, want {slabs}")
        if not (np.array_equal(plan.r_tokens, want.r_tokens)
                and np.array_equal(plan.cluster_of, want.cluster_of)):
            fail(f"chunked[{measure}] ({n}, {d}): the host-chunked plan differs from the device op's")
        print(f"kernels: chunked[{measure}] host G ({n}, {d}): {launched} B1 launches "
              f"(d_chunk {sim_ops.STREAM_D_THRESHOLD}), plan equal to the device op's")
    d = CHUNKED_HOST_D
    t0 = time.perf_counter()
    G = rng.standard_normal((n, d), dtype=np.float32)
    G *= np.float32(SIM_SCALE)
    made = time.perf_counter() - t0
    before = sim_ops.launches["gram"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sim_ops.pairwise_distances_chunked(G, "arccos")
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launched = sim_ops.launches["gram"] - before
    t0 = time.perf_counter()
    whole = torch.from_numpy(G).to(DEV)
    one = sim_ops.pairwise_distances_device(whole, "arccos")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del whole
    torch.cuda.empty_cache()
    slabs = -(-d // sim_ops.STREAM_D_THRESHOLD)
    if launched != slabs:
        fail(f"chunked host G ({n}, {d}): {launched} B1 launches, want {slabs}")
    e = float((got - one).abs().max())
    if not math.isfinite(e) or e > CHUNKED_ATOL:
        fail(f"chunked host G ({n}, {d}): arccos distances {e} from the one-shot op's")
    print(f"kernels: chunked host G ({n}, {d}), {G.nbytes:,} B of f32 (made in {made:.3f} s): "
          f"{launched} B1 launches of (n, <= {sim_ops.STREAM_D_THRESHOLD}) slabs in {chunked_s:.3f} s "
          f"(host clock, slab copies included); the one-shot op after one {G.nbytes:,} B copy "
          f"{one_s:.3f} s; arccos max |Δ| {e:.3e} (limit {CHUNKED_ATOL})")


def phase_kernels_agg(torch, gen) -> float:
    """The aggregate kernel against its plain version at AGG_SHAPES;
    bit-reproducible, bit-equal between an aligned and a misaligned layout
    of the same values and whether or not p % 4 == 0, and one device kernel
    a call. Returns the max abs error at the main path's shape."""
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref

    path_err = None
    for k, p in AGG_SHAPES:
        U = torch.randn((k, p), generator=gen).cuda()
        w = torch.rand((k,), generator=gen).cuda()
        got, again = agg_ops.aggregate_flat(U, w), agg_ops.aggregate_flat(U, w)
        want = aggregate_ref(U, w)
        # the same values 4 bytes past 16-byte alignment, and with one more
        # column (p + 1 rows: another alignment for every row but the first)
        flat = torch.empty(k * p + 1, device="cuda")
        shifted = flat[1:].view(k, p)
        shifted.copy_(U)
        wide = torch.cat([U, torch.randn((k, 1), generator=gen).cuda()], dim=1)
        got_shifted, got_wide = agg_ops.aggregate_flat(shifted, w), agg_ops.aggregate_flat(wide, w)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=AGG_TOL, atol=AGG_TOL):
            fail(f"aggregate kernel at ({k}, {p}): max abs error {e}, beyond rtol=atol {AGG_TOL}")
        if not torch.equal(got, again):
            fail(f"aggregate kernel at ({k}, {p}) is not bit-reproducible")
        if not torch.equal(got, got_shifted) or not torch.equal(got, got_wide[:p]):
            fail(f"aggregate kernel at ({k}, {p}): the same values in another layout sum to other bits")
        if (k, p) == AGG_SHAPE:
            path_err = e
        print(f"kernels: aggregate ({k}, {p}) max_abs_err {e:.3e} (rtol=atol {AGG_TOL}), max |want| "
              f"{float(want.abs().max()):.3e}, reproducible, bit-equal 4 bytes off alignment and "
              f"at p + 1")
        kernels_a_call(torch, f"aggregate ({k}, {p})", lambda: agg_ops.aggregate_flat(U, w),
                       ("aggregate_",))
    return path_err


def phase_kernels_srp(torch, gen) -> float:
    """The SRP kernel against its plain version, its sign bits and its
    batch independence; countsketch's reproducibility. Returns the max abs
    error over the checked shapes."""
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ops import CountSketcher
    from repro_torch.kernels.sketch.ref import sketch_srp_plain, srp_sign_block

    worst = 0.0
    for c, d, dp in SRP_SHAPES:
        X = (SIM_SCALE * torch.randn((c, d), generator=gen)).cuda()
        got = sk_ops.srp_sketch(X, dp, SRP_SEED)
        again = sk_ops.srp_sketch(X, dp, SRP_SEED)
        head = sk_ops.srp_sketch(X[:5].contiguous(), dp, SRP_SEED)
        want = sketch_srp_plain(X, dp, SRP_SEED)
        torch.cuda.synchronize()
        rel = srp_rel_err(got, want, X, dp)
        e = float((got - want).abs().max())
        if not math.isfinite(rel) or rel > SRP_RTOL:
            fail(f"srp kernel at ({c}, {d}, {dp}): error {rel} of ‖x_i‖·‖S_:,j‖ > {SRP_RTOL}")
        if not torch.equal(got, again):
            fail(f"srp kernel at ({c}, {d}, {dp}) is not bit-reproducible")
        if not torch.equal(got[:5], head):
            fail(f"srp kernel at ({c}, {d}, {dp}): rows 0..4 change with the rows batched beside them")
        worst = max(worst, e)
        print(f"kernels: srp ({c}, {d}, {dp}) max_abs_err {e:.3e}, {rel:.3e} of ‖x_i‖·‖S_:,j‖ "
              f"(limit {SRP_RTOL}), max |want| {float(want.abs().max()):.3e}, reproducible, "
              f"rows 0..4 bit-equal alone")
    srp_alternating(torch, gen)
    srp_kernels_a_call(torch, gen)
    print(f"kernels: srp partial pass: {sk_ops.smem_bytes(SRP_SHAPES[0][0])} B of dynamic shared "
          f"memory a block at c = {SRP_SHAPES[0][0]}, {sk_ops.smem_bytes(SRP_SHAPES[1][0])} B at "
          f"c = {SRP_SHAPES[1][0]}")
    eye = torch.eye(SIGN_D, dtype=torch.float32, device="cuda")
    S = srp_sign_block(SRP_SEED, 0, SIGN_D, 64, SIGN_D, device="cuda")
    got = sk_ops.srp_sketch(eye, 64, SRP_SEED)
    torch.cuda.synchronize()
    if not torch.equal(got, S) or not torch.equal(sketch_srp_plain(eye, 64, SRP_SEED), S):
        fail("srp kernel: the sketch of the identity rows is not S bit for bit")
    print(f"kernels: srp signs: the sketch of the ({SIGN_D} × {SIGN_D}) identity equals the "
          f"plain version's S bit for bit")
    X = (SIM_SCALE * torch.randn((64, 39760), generator=gen)).cuda()
    cs = CountSketcher(39760, D_PRIME, SRP_SEED)
    a, b = cs(X), cs(X)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail("countsketch is not bit-reproducible on the card")
    print(f"kernels: countsketch (64, 39760, {D_PRIME}) bit-reproducible call to call")
    return worst


def srp_alternating(torch, gen):
    """Calls at alternating shapes, back to back with no synchronisation,
    each bit-equal to the same call made alone."""
    from repro_torch.kernels.sketch import ops as sk_ops

    inputs = [((SIM_SCALE * torch.randn((c, d), generator=gen)).cuda(), dp) for c, d, dp in SRP_SHAPES]
    alone = []
    for X, dp in inputs:
        alone.append(sk_ops.srp_sketch(X, dp, SRP_SEED))
        torch.cuda.synchronize()
    got = [sk_ops.srp_sketch(X, dp, SRP_SEED) for _ in range(3) for X, dp in inputs]
    torch.cuda.synchronize()
    for i, y in enumerate(got):
        if not torch.equal(y, alone[i % len(inputs)]):
            c, d, dp = SRP_SHAPES[i % len(inputs)]
            fail(f"srp kernel: call {i} at ({c}, {d}, {dp}) back to back differs from the same call alone")
    print(f"kernels: srp {len(got)} calls back to back at {len(inputs)} alternating shapes, each "
          f"bit-equal to the same call alone")


def kernels_a_call(torch, label, fn, names, reps: int = 20, windows: int = 5):
    """torch.profiler over ``reps`` calls of ``fn`` sees each device kernel
    named in ``names`` at most ``reps`` times and nothing else. The profiler
    on the card drops launches now and then (it kept 19 of 20 of each SRP
    kernel in a window, 7 of 20 aggregate launches in another, none of a
    window at times), so up to 2 fewer are accepted, and a window that kept
    fewer is profiled again, up to ``windows`` windows: dropped events only
    lower the counts. A kernel launched twice, or a copy or a fill per call,
    would show ``reps`` more events, and fails at the first window."""
    for _ in range(windows):
        events = device_events(torch, fn, reps=reps)
        counts = {k: sum(_kernel_name(e.name).startswith(k) for e in events) for k in names}
        others = sorted({_kernel_name(e.name) for e in events
                         if not any(_kernel_name(e.name).startswith(k) for k in names)})
        if others or any(n > reps for n in counts.values()):
            break
        if all(n >= reps - 2 for n in counts.values()):
            print(f"kernels: {label} device kernels a call: the profiler saw {json.dumps(counts)} "
                  f"in {reps} calls and nothing else")
            return
    fail(f"{label}: {counts} and {others} in {reps} calls; expected each of {names} once a call")


def srp_kernels_a_call(torch, gen):
    from repro_torch.kernels.sketch import ops as sk_ops

    c, d, dp = SRP_SHAPES[0]
    X = (SIM_SCALE * torch.randn((c, d), generator=gen)).cuda()
    kernels_a_call(torch, "srp", lambda: sk_ops.srp_sketch(X, dp, SRP_SEED), ("srp_partial", "srp_reduce"))


def sim_kernels_a_call(torch, gen):
    """The similarity call at the main path's (100, 39,760) is the partial
    pass and the reduce pass; at the sketched store's (100, 64), one split,
    the partial pass alone."""
    from repro_torch.kernels.similarity import ops as sim_ops

    for (n, d), names in ((SIM_SHAPES[0], ("pairwise_partial", "pairwise_reduce")),
                          (SKETCHED_SIM_SHAPE, ("pairwise_partial",))):
        G = (SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
        for op in ("gram", "l1"):
            kernels_a_call(torch, f"similarity {op} ({n}, {d})", lambda: sim_ops.pairwise_sums(G, op), names)


def _flash_check(torch, label, got, q, k, v, causal=True, again=None) -> float:
    """Hold one flash call against the plain version (and, with ``again``,
    a second call bit for bit); print it and return its max abs error."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        fail(f"flash kernel {label}: got {got.dtype} {tuple(got.shape)}")
    e = float((got.float() - want.float()).abs().max())
    excess = flash_excess(got, want, q, k, v, causal=causal)
    if not math.isfinite(excess) or excess > 1.0:
        fail(f"flash kernel {label}: max abs error {e}, {excess:.3f}× its limit")
    if again is not None and not torch.equal(got, again):
        fail(f"flash kernel {label} is not bit-reproducible")
    lowest = flash_lowest(q, k, v)
    limit = (f"atol {FLASH_F32_ATOL}" if lowest == "float32" else
             f"limit min({FLASH_BF16_ATOL}, 2^-{7 if lowest == 'bfloat16' else 10}·(|want| + Σ p|v|))")
    print(f"kernels: flash {label} max_abs_err {e:.3e}, {excess:.3f} of its {limit}, max |want| "
          f"{float(want.float().abs().max()):.3e}" + (", reproducible" if again is not None else ""))
    return e


def phase_kernels_flash(torch, gen) -> dict:
    """Every flash kernel against the plain version: causal at every listed
    shape, non-causal with a ragged T, bf16 views into a fused projection,
    head dims that are not multiples of 8 and above 128 and 256, f16, B·H
    past a grid axis, and bf16 views with a misaligned base, a sequence
    stride of 68 and a head-dim stride of 2 (also bit-equal to their
    contiguous copies), the wgmma route's own checks (flash_wgmma_checks)
    and FLASH_LONG; returns the max abs error at the serve paths' bf16
    shapes, by shape, and at FLASH_WIDE_ROWS and FLASH_LONG_ROW, by row
    name, with the launches of those rows' calls as ``"launches"``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def inputs(b, s, h, kv, hd, dtype, t=None):
        t = s if t is None else t
        return (torch.randn(shape, generator=gen).to(DEV, dtype)
                for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))

    def check(label, dtype, shape) -> float:
        q, k, v = inputs(*shape, dtype)
        got = fa_ops.flash_attention_padded(q, k, v)
        again = fa_ops.flash_attention_padded(q, k, v)
        return _flash_check(torch, f"{label} (B, S, H, KV, hd) = {shape}", got, q, k, v, again=again)

    path_err = {}
    for dtype, shapes in ((torch.float32, FLASH_F32_SHAPES), (torch.bfloat16, FLASH_BF16_SHAPES)):
        for shape in shapes:
            e = check(dtype, dtype, shape)
            if dtype == torch.bfloat16 and shape in (FLASH_PATH, FLASH_MOE, FLASH_WHISPER):
                path_err[shape] = e
    for dtype in (torch.float32, torch.bfloat16):
        for shape, t in FLASH_NONCAUSAL:
            q, k, v = inputs(*shape, dtype, t=t)
            got = fa_ops.flash_attention_padded(q, k, v, causal=False)
            again = fa_ops.flash_attention_padded(q, k, v, causal=False)
            _flash_check(torch, f"{dtype} non-causal {shape} T = {t}", got, q, k, v,
                         causal=False, again=again)
    b, s, h, kv, hd = 2, 50, 4, 2, 32
    fused = torch.randn((b, s, (h + 2 * kv) * hd), generator=gen).to(DEV, torch.bfloat16)
    q, k, v = (fused[..., lo * hd: hi * hd].unflatten(-1, (hi - lo, hd))
               for lo, hi in ((0, h), (h, h + kv), (h + kv, h + 2 * kv)))
    got = fa_ops.flash_attention_padded(q, k, v)
    if not torch.equal(got, fa_ops.flash_attention_padded(q.contiguous(), k.contiguous(),
                                                          v.contiguous())):
        fail("flash kernel: bf16 views into the fused projection differ from their copies")
    _flash_check(torch, f"bf16 views into a fused ({b}, {s}, {(h + 2 * kv) * hd}) projection",
                 got, q, k, v, again=fa_ops.flash_attention_padded(q, k, v))
    # the widened domain: each call launches the kernel once
    before = fa_ops.launches["flash_attention"]
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in FLASH_WIDE_HDS:
            check(dtype, dtype, (*FLASH_WIDE, hd))
            calls += 2
    for shape in FLASH_F16_SHAPES:
        check(torch.float16, torch.float16, shape)
        calls += 2
    for dtype in (torch.float32, torch.bfloat16):
        check(f"{dtype} B·H = {FLASH_FOLD[0] * FLASH_FOLD[2]:,}", dtype, FLASH_FOLD)
        calls += 2
    flat = torch.randn(2048, generator=gen).to(DEV, torch.bfloat16)
    views = {"a base 2 bytes past 16-byte alignment": flat[1:1 + 512].view(1, 8, 4, 16),
             "a sequence stride of 68": flat[:8 * 68].view(1, 8, 68)[..., :64].unflatten(-1, (4, 16)),
             "a head-dim stride of 2": flat[:1024].view(1, 8, 4, 32)[..., ::2]}
    for what, q in views.items():
        k, v = q[:, :, :2], q[:, :, 2:]
        got = fa_ops.flash_attention_padded(q, k, v)
        if not torch.equal(got, fa_ops.flash_attention_padded(q.contiguous(), k.contiguous(),
                                                              v.contiguous())):
            fail(f"flash kernel: a bf16 view with {what} differs from its contiguous copy")
        _flash_check(torch, f"bf16 view with {what}", got, q, k, v,
                     again=fa_ops.flash_attention_padded(q, k, v))
        calls += 3
    calls += flash_wgmma_checks(torch, gen)
    launched = fa_ops.launches["flash_attention"] - before
    if launched != calls:
        fail(f"flash wrapper: {launched} launches for the widened domain's {calls} calls")
    print(f"kernels: flash's widened domain launched the kernel at each of its {calls} calls")
    path_err["launches"] = {}
    before = fa_ops.launches["flash_attention"]
    path_err[FLASH_LONG_ROW] = check(f"{FLASH_LONG_ROW} bf16", torch.bfloat16, FLASH_LONG)
    path_err["launches"][FLASH_LONG_ROW] = fa_ops.launches["flash_attention"] - before
    for row, dtype, shape in FLASH_WIDE_ROWS:
        before = fa_ops.launches["flash_attention"]
        path_err[row] = check(f"{row} {dtype}", getattr(torch, dtype), shape)
        path_err["launches"][row] = fa_ops.launches["flash_attention"] - before
    path_err.update(flash_mixed_checks(torch, gen))
    path_err["launches"][FLASH_MIXED_ROW] = path_err.pop("mixed_launches")
    return path_err


def flash_wgmma_checks(torch, gen) -> int:
    """The wgmma route's own checks: views TMA cannot read (a sequence
    stride of 68 at head dim 64, a base 2 bytes past 16-byte alignment at
    128), copied by cp.async into the same swizzled tiles, bit-equal to
    their contiguous copies, which TMA reads; and the serve shape's batch 0
    bit-equal in the 128-row items the launch takes for the whole batch and
    in the 64-row items it takes for batch 0 alone. Returns the kernel
    launches it made."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    calls = 0
    for dtype in (torch.bfloat16, torch.float16):
        s = 200
        flat = torch.randn(3 * s * 68, generator=gen).to(DEV, dtype)
        q, k, v = (flat[i * s * 68:(i + 1) * s * 68].view(1, s, 68)[..., :64].unflatten(-1, (1, 64))
                   for i in range(3))
        flat = torch.randn(1 + 2 * 130 * 6 * 128, generator=gen).to(DEV, dtype)
        qm = flat[1:1 + 130 * 6 * 128].view(1, 130, 6, 128)
        km, vm = (torch.randn((1, 130, 2, 128), generator=gen).to(DEV, dtype) for _ in range(2))
        for what, (a, b, c) in {"a sequence stride of 68 at hd 64": (q, k, v),
                                "a base 2 bytes past 16-byte alignment at hd 128": (qm, km, vm)}.items():
            got = fa_ops.flash_attention_padded(a, b, c)
            if not torch.equal(got, fa_ops.flash_attention_padded(a.contiguous(), b.contiguous(),
                                                                  c.contiguous())):
                fail(f"flash kernel: a {dtype} view with {what} differs from its contiguous copy")
            _flash_check(torch, f"{dtype} view with {what} (wgmma route, copied by cp.async)", got,
                         a, b, c, again=fa_ops.flash_attention_padded(a, b, c))
            calls += 3
    # FLASH_PATH's (128-row q-tile, head, batch) items fill the card, so the
    # launch takes 128-row items (two consumers); its first batch alone
    # does not, and takes 64-row ones: the rows of batch 0 must not move
    b_, s_, h_, kv_, hd_ = FLASH_PATH
    q, k, v = (torch.randn(shape, generator=gen).to(DEV, torch.bfloat16)
               for shape in ((b_, s_, h_, hd_), (b_, s_, kv_, hd_), (b_, s_, kv_, hd_)))
    outs, ran = {}, {}
    for batch, args in ((b_, (q, k, v)), (1, (q[:1], k[:1], v[:1]))):
        outs[batch] = fa_ops.flash_attention_padded(*args)
        calls += 1
        events = []
        for _ in range(3):  # the profiler may keep no device event of a short window
            events = device_events(torch, lambda a=args: fa_ops.flash_attention_padded(*a), reps=2)
            calls += 3
            if events:
                break
        ran[batch] = sorted({_kernel_name(e.name) for e in events if "flash_fwd" in e.name})
    nwg = {b_: 2, 1: 1}  # flash_fwd_wgmma<T, HDP, NWG>'s consumer warpgroups
    if any(len(ran[batch]) != 1 or not ran[batch][0].startswith("flash_fwd_wgmma<")
           or not ran[batch][0].endswith(f",{n}>") for batch, n in nwg.items()):
        fail(f"flash kernel: batches of {b_} and 1 at {FLASH_PATH} ran {ran}, want NWG {nwg}")
    if not torch.equal(outs[b_][:1], outs[1]):
        fail(f"flash kernel: batch 0 of {FLASH_PATH} differs between 128-row and 64-row items")
    _flash_check(torch, f"bf16 {FLASH_PATH}, batch 0 alone, in 64-row items", outs[1], q[:1],
                 k[:1], v[:1])
    print(f"kernels: flash wgmma route: batch 0 of {FLASH_PATH} bit-equal in 128-row items "
          f"({ran[b_][0]}) and alone in 64-row items ({ran[1][0]})")
    return calls


def _mixed_inputs(torch, gen, shape, dtypes):
    b, s, h, kv, hd = shape
    return tuple(torch.randn(dims, generator=gen).to(DEV, getattr(torch, dt))
                 for dims, dt in zip(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)), dtypes))


def flash_mixed_checks(torch, gen) -> dict:
    """Every mixed-dtype combination of q, k and v at FLASH_MIXED_SHAPE,
    and FLASH_MIXED_PATH at the serve path's shape: each call one launch,
    within the lowest precision's limit of the plain version on the card and
    bit-reproducible; each small combination timed beside its bound.
    Returns the serve shape's max abs error under FLASH_MIXED_ROW, and its
    launches under "mixed_launches"."""
    import itertools

    from repro_torch.kernels.flash_attention import ops as fa_ops

    name = torch.cuda.get_device_name(0)
    combos = [c for c in itertools.product(("float32", "bfloat16", "float16"), repeat=3)
              if len(set(c)) > 1]
    before = fa_ops.launches["flash_attention"]
    for dts in combos:
        q, k, v = _mixed_inputs(torch, gen, FLASH_MIXED_SHAPE, dts)
        got = fa_ops.flash_attention_padded(q, k, v)
        again = fa_ops.flash_attention_padded(q, k, v)
        _flash_check(torch, f"mixed (q, k, v) = {dts} {FLASH_MIXED_SHAPE}", got, q, k, v,
                     again=again)
        if dts[0] == "float32" and dts[2] != "float32":  # f32 out, p rounded to 16 bits
            rounded, unrounded = flash_p_rounding(got, q, k, v)
            if not rounded * FLASH_P_ROUNDING < unrounded:
                fail(f"flash kernel mixed {dts}: mean error {rounded:.3e} against the plain version, "
                     f"{unrounded:.3e} against it with p unrounded: p is not rounded to v's dtype")
            print(f"kernels: flash mixed {dts}: p rounded to v's dtype (mean error {rounded:.3e}, "
                  f"{unrounded:.3e} against p unrounded)")
    launched = fa_ops.launches["flash_attention"] - before
    if launched != 2 * len(combos):
        fail(f"flash wrapper: {launched} launches for the mixed dtypes' {2 * len(combos)} calls")
    print(f"kernels: flash's {len(combos)} mixed-dtype combinations launched the kernel at each "
          f"of their {launched} calls")
    for dts in combos:  # timed apart from the checks: launches here are not the checks'
        flash_mixed_times(torch, name, _mixed_inputs(torch, gen, FLASH_MIXED_SHAPE, dts))
    q, k, v = _mixed_inputs(torch, gen, FLASH_PATH, FLASH_MIXED_PATH)
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.flash_attention_padded(q, k, v)
    again = fa_ops.flash_attention_padded(q, k, v)
    err = _flash_check(torch, f"{FLASH_MIXED_ROW} (q, k, v) = {FLASH_MIXED_PATH} {FLASH_PATH}",
                       got, q, k, v, again=again)
    return {FLASH_MIXED_ROW: err, "mixed_launches": fa_ops.launches["flash_attention"] - before}


def flash_bound(name, q, k, v) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, FLOP, bytes) of a flash call on q, k and
    v: each operand and the output moved once at its own itemsize
    (``fa_ops.work``), over the card's memory rate; and the causal QKᵀ and
    PV, half the FLOP each, over the peak for their operands' types: the
    16-bit tensor-core rate for two 16-bit operands of one type, TF32's
    (half of it: exact for a bf16 × f16 product) for two of different
    16-bit types, else the f32 rate. PV's operands are p, rounded to v's
    type, and v."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    _, bw, f32, bf16 = peaks_for(name)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    flops, nbytes = fa_ops.work(b, s, t, h, kv, hd, itemsizes=(
        q.element_size(), k.element_size(), v.element_size()))

    def peak(x, y):
        if x.element_size() == 2 and y.element_size() == 2:
            return bf16 if x.dtype == y.dtype else bf16 / 2
        return f32

    t_bytes = nbytes / bw * 1e3
    t_ops = (flops / 2 / peak(q, k) + flops / 2 / peak(v, v)) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", flops, nbytes


def flash_mixed_times(torch, name, qkv, row_name=None) -> dict:
    """The kernel's and the plain version's ms a call by events on
    mixed-dtype q, k and v, beside the call's bound; no single library call
    computes this function, so there is no library time."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = qkv
    ms = time_ms(torch, lambda: fa_ops.flash_attention_padded(q, k, v), reps=20)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v), reps=5)
    bound, by, flops, nbytes = flash_bound(name, q, k, v)
    dts = tuple(str(a.dtype).removeprefix("torch.") for a in qkv)
    b, s, h, hd = q.shape
    print(f"times: {row_name or 'flash mixed'} (q, k, v) = {dts} {(b, s, h, k.shape[2], hd)}: "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; {nbytes} B, "
          f"{flops} FLOP); no single library call computes this function")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def flash_mixed_row(torch, gen, name, err, launches) -> dict:
    """The kernels line's row of the mixed route at the serve path's shape
    (FLASH_MIXED_PATH): no model path mixes dtypes, so its launches are the
    kernels phase's calls at this shape."""
    qkv = _mixed_inputs(torch, gen, FLASH_PATH, FLASH_MIXED_PATH)
    row = {"name": FLASH_MIXED_ROW, "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:70", "launches": launches,
           "max_abs_err": err, **flash_mixed_times(torch, name, qkv, FLASH_MIXED_ROW),
           "kernel": "flash_fwd_f32",
           "library_ms": None, "dtypes": list(FLASH_MIXED_PATH),
           "library_note": "no single library call computes this function",
           "launches_from": ("the kernels phase's calls of flash_attention_padded at this shape "
                             "and these dtypes; no model path mixes dtypes")}
    return row


def _small_serve_cfg(arch, dtype, **overrides):
    """Reduced ``arch`` at SERVE_SMALL's 2 layers, or the reduced config's
    own depth where one period and its tail take more (recurrentgemma's 5),
    with activations in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config

    reduced = get_config(arch, reduced=True)
    return dataclasses.replace(reduced, n_layers=max(SERVE_SMALL["n_layers"], reduced.n_layers),
                               dtype=dtype, **overrides)


def _serve_small(torch, device, dtype="float32", arch=SERVE_SMALL["arch"],
                 prompt_len=SERVE_SMALL["prompt_len"], **overrides):
    """Greedy generations of reduced ``arch`` (``_small_serve_cfg``) with
    activations in ``dtype``, from parameters made on the CPU; returns
    (token ids, per-step logits)."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import frontend_stubs
    from repro_torch.models import model as mdl

    cfg = _small_serve_cfg(arch, dtype, **overrides)
    params = mdl.init_params(cfg, 0, device="cpu").to(device)
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_SMALL["batch"], prompt_len), generator=g)
    tokens, logits = generate(cfg, params, prompts, SERVE_SMALL["gen"], device=device,
                              **frontend_stubs(cfg, SERVE_SMALL["batch"], device))
    return tokens.cpu(), logits.float().cpu()


def _serve_small_pair(torch, dtype, arch):
    """The small serve on the CPU and on the card; the card's run must
    launch the flash kernel once per attention layer (an MLA layer none)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cpu = _serve_small(torch, "cpu", dtype, arch)
    fa_ops.launches.update(flash_attention=0)
    gpu = _serve_small(torch, DEV, dtype, arch)
    torch.cuda.synchronize()
    n = fa_ops.launches["flash_attention"]
    want = sum(m == "attn" for m, _ in _small_serve_cfg(arch, dtype).all_blocks)
    if n != want:
        fail(f"small input [serve, {arch}, {dtype}]: {n} flash launches, expected {want}, one per "
             "attention layer")
    return cpu, gpu, n


def phase_small_serve(torch, arch=SERVE_SMALL["arch"]):
    label = (f"reduced {arch}, {_small_serve_cfg(arch, 'float32').n_layers} layers, batch "
             f"{SERVE_SMALL['batch']}, prompt {SERVE_SMALL['prompt_len']}, gen {SERVE_SMALL['gen']}")
    cpu, gpu, n = _serve_small_pair(torch, "float32", arch)
    if not torch.equal(cpu[0], gpu[0]):
        fail(f"small input [serve, {arch}]: the card's tokens {gpu[0].tolist()} differ from the "
             f"CPU's {cpu[0].tolist()}")
    e = float((cpu[1] - gpu[1]).abs().max())
    if not math.isfinite(e) or e > SERVE_SMALL_ATOL:
        fail(f"small input [serve, {arch}]: logits differ by {e} > {SERVE_SMALL_ATOL}")
    print(f"kernels: small input [serve] ({label}, f32), card vs CPU: token ids equal, max logit "
          f"diff {e:.2e} (atol {SERVE_SMALL_ATOL}), {n} flash launches")
    cpu, gpu, n = _serve_small_pair(torch, "bfloat16", arch)
    e, steps, held = _compare_bf16_generations(cpu, gpu)
    route = "through the tensor-core kernel" if n else "torch ops, no flash"
    print(f"kernels: small input [serve] ({label}, bf16 {route}), card vs "
          f"CPU: max logit diff {e:.2e} (atol {SERVE_SMALL_BF16_ATOL}) over {steps} row-steps, "
          f"tokens equal at all {held} with a CPU top-2 margin above {SERVE_SMALL_BF16_MARGIN}, "
          f"{n} flash launches")


def _compare_bf16_generations(cpu, gpu) -> tuple[float, int, int]:
    """Per row, step by step until the row's tokens part: logits within
    SERVE_SMALL_BF16_ATOL, and equal tokens wherever the CPU's top-2 margin
    exceeds SERVE_SMALL_BF16_MARGIN. Past a step whose tokens differ the
    row's contexts differ, so its later steps are not compared. Returns
    (max logit diff, row-steps compared, row-steps held to equal tokens)."""
    (tok_c, log_c), (tok_g, log_g) = cpu, gpu
    worst, steps, held = 0.0, 0, 0
    for row in range(tok_c.shape[0]):
        for t in range(tok_c.shape[1]):
            e = float((log_c[t, row] - log_g[t, row]).abs().max())
            if not math.isfinite(e) or e > SERVE_SMALL_BF16_ATOL:
                fail(f"small input [serve, bf16]: row {row} step {t} logits differ by {e} > "
                     f"{SERVE_SMALL_BF16_ATOL}")
            worst, steps = max(worst, e), steps + 1
            top2 = log_c[t, row].topk(2).values
            if float(top2[0] - top2[1]) > SERVE_SMALL_BF16_MARGIN:
                held += 1
                if tok_c[row, t] != tok_g[row, t]:
                    fail(f"small input [serve, bf16]: row {row} step {t}: the card picks "
                         f"{int(tok_g[row, t])}, the CPU {int(tok_c[row, t])}, at a margin of "
                         f"{float(top2[0] - top2[1]):.3f}")
            if tok_c[row, t] != tok_g[row, t]:
                break
    return worst, steps, held


def _tiny_run(device, **sampler_kw):
    """3 Algorithm 2 rounds at a small width; returns (plans, losses, params)."""
    import numpy as np

    from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
    from repro_torch.fl.partition import by_class_shards
    from repro_torch.fl.server import FederatedServer, FLConfig
    from repro_torch.models.simple import init_mlp, params_to_numpy
    from repro_torch.optim.sgd import sgd

    ds = by_class_shards(n_classes=10, clients_per_class=2, train_per_client=40,
                         test_per_client=10, dim=16, seed=0)
    params = init_mlp((16, 8, 10), seed=1, device="cpu")
    d = sum(v.numel() for v in params.values())
    sampler = Algorithm2Sampler(ds.population, 5, update_dim=d, seed=0, device=device, **sampler_kw)
    plans, losses = [], []

    def on_round(rec):
        plans.append(np.array(sampler.plan.r_tokens))
        losses.append(rec.train_loss)

    cfg = FLConfig(n_rounds=3, n_local_steps=5, batch_size=8, seed=0)
    with FederatedServer(ds, sampler, params, sgd(0.05), cfg, device=device) as srv:
        srv.run(on_round=on_round)
    return plans, np.array(losses), params_to_numpy(srv.params)


SMALL_CONFIGS = {
    "unsketched": {},
    "srp+ward": {"sketch": "srp", "sketch_dim": 8},
    "srp+kmeans": {"sketch": "srp", "sketch_dim": 8, "clusterer": "kmeans"},
}


def phase_small_input():
    import numpy as np

    for label, kw in SMALL_CONFIGS.items():
        cpu, gpu = _tiny_run("cpu", **kw), _tiny_run("cuda", **kw)
        for a, b in zip(cpu[0], gpu[0]):
            if not np.array_equal(a, b):
                fail(f"small input [{label}]: the card's plan differs from the CPU's")
        if not np.allclose(cpu[1], gpu[1], atol=1e-4):
            fail(f"small input [{label}]: losses differ, cpu {cpu[1]} vs cuda {gpu[1]}")
        perr = max(float(np.abs(cpu[2][k] - gpu[2][k]).max()) for k in cpu[2])
        if perr > 1e-4:
            fail(f"small input [{label}]: final params differ by {perr}")
        print(f"kernels: small input [{label}], card vs CPU: plans equal over 3 rounds, "
              f"max loss diff {float(np.abs(cpu[1] - gpu[1]).max()):.2e}, max param diff {perr:.2e}")


def _slice_run(torch, ds, params, measure, n_rounds, label, *, mesh=None, record=None,
               **sampler_kw):
    """``mesh`` splits the round and the store over a mesh; ``record``, a
    dict, gets the run's start params, each round's observed (ids, update
    rows: references during the run, host copies after it), its plan
    tokens, its final params (host) and its engine's staged bytes by mesh
    position."""
    import numpy as np

    from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
    from repro_torch.core.samplers.base import validate_plan
    from repro_torch.fl.server import FederatedServer, FLConfig
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.optim.sgd import sgd

    d = sum(v.numel() for v in params.values())
    sampler = Algorithm2Sampler(ds.population, 10, update_dim=d, seed=0, measure=measure,
                                store_mesh_spec=mesh, **sampler_kw)
    cfg = FLConfig(n_rounds=n_rounds, n_local_steps=50, batch_size=50, seed=0, mesh_spec=mesh)
    recs, times = [], []
    srv = FederatedServer(ds, sampler, params, sgd(0.01), cfg)
    if record is not None:
        record.update(start=params, observed=[], plans=[],
                      staged=srv._engine.staged_bytes_by_position(),
                      store=sampler.gradient_store.bytes_by_position())
        real_observe = sampler.observe_updates

        def observe(ids, updates):
            record["observed"].append((np.array(ids), updates))
            real_observe(ids, updates)

        sampler.observe_updates = observe
    torch.cuda.synchronize()
    sim_ops.launches.update(gram=0, l1=0)
    agg_ops.launches.update(aggregate=0)
    sk_ops.launches.update(srp=0)
    last = time.perf_counter()

    def on_round(rec):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - last) * 1e3)
        if record is not None:
            record["plans"].append(sampler.plan.r_tokens.copy())
        last = time.perf_counter() if record is not None else now
        recs.append(rec)

    with srv:
        srv.run(on_round=on_round)
    torch.cuda.synchronize()
    counts = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches}
    if record is not None:
        from repro_torch.launch.mesh import ShardedRows

        record["observed"] = [(ids, (rows.gather("cpu") if isinstance(rows, ShardedRows)
                                     else rows.cpu()).numpy()) for ids, rows in record["observed"]]
        record["final"] = {k: v.cpu() for k, v in srv.params.items()}
    for rec, ms in zip(recs, times):
        print(f"slice[{label}]: round {rec.round} {ms:.3f} ms, plan_build_ms "
              f"{rec.plan_build_ms:.3f}, distinct {rec.n_distinct_clients}, "
              f"train_loss {rec.train_loss:.4f}, test_acc {rec.test_acc:.4f}")
    print(f"slice[{label}]: launches {json.dumps(counts)}")
    if len(recs) != n_rounds:
        fail(f"slice[{label}]: {len(recs)} rounds of {n_rounds}")
    for rec in recs:
        if not (math.isfinite(rec.train_loss) and 0.0 <= rec.test_acc <= 1.0):
            fail(f"slice[{label}]: round {rec.round} loss/acc out of range")
        if not 1 <= rec.n_distinct_clients <= 10:
            fail(f"slice[{label}]: round {rec.round} drew {rec.n_distinct_clients} clients")
    for k, v in srv.params.items():
        if v.shape != params[k].shape or not bool(torch.isfinite(v).all()):
            fail(f"slice[{label}]: parameter {k} is not finite or changed shape")
    validate_plan(sampler.plan, ds.population)
    if len(np.unique(sampler.plan.cluster_of[sampler.plan.cluster_of >= 0])) < 2:
        fail(f"slice[{label}]: the plan never left the cold-start clustering")
    sim_op = "l1" if measure == "l1" else "gram"
    for name in (sim_op, "aggregate"):
        if counts[name] <= 0:
            fail(f"slice[{label}]: kernel {name} was never launched on the main path")
    return srv.params, counts, float(np.median(times)), sampler


#: the slice phase's arccos and srp runs, recorded for the sharded phase
SLICE_RUNS: dict = {}


def phase_slice(torch):
    from repro_torch.fl.partition import by_class_shards
    from repro_torch.models.simple import init_mlp

    t0 = time.perf_counter()
    ds = by_class_shards(n_classes=10, clients_per_class=10, train_per_client=500,
                         test_per_client=100, dim=WIDTH[0], seed=0)
    params = init_mlp(WIDTH, seed=0)
    d = sum(v.numel() for v in params.values())
    if d != 39760:
        fail(f"model width d = {d}, expected 39760")
    print(f"slice: dataset and init {time.perf_counter() - t0:.3f} s, d = {d}, "
          f"{ds.n_clients} clients")
    params, counts_a, round_ms, _ = _slice_run(torch, ds, params, "arccos", 5, "arccos",
                                               record=SLICE_RUNS.setdefault("arccos", {}))
    params, counts_l, _, _ = _slice_run(torch, ds, params, "l1", 2, "l1")
    params, counts_s, srp_round_ms, sampler = _slice_run(
        torch, ds, params, "arccos", 5, "srp", sketch="srp", sketch_dim=D_PRIME,
        record=SLICE_RUNS.setdefault("srp", {}))
    store = sampler._store
    if (store.dim, tuple(store.snapshot().shape)) != (D_PRIME, (ds.n_clients, D_PRIME)):
        fail(f"slice[srp]: the store is {tuple(store.snapshot().shape)}, not ({ds.n_clients}, {D_PRIME})")
    for name in ("srp", "gram", "aggregate"):
        if counts_s[name] != 5:
            fail(f"slice[srp]: {counts_s[name]} {name} launches in 5 rounds, expected 5")
    print(f"slice[srp]: store ({ds.n_clients}, {store.dim}) f32, {store.nbytes} B; one srp, one "
          f"gram on the sketched store and one aggregate launch per round")
    launches = {"gram": counts_a["gram"], "l1": counts_l["l1"], "aggregate": counts_a["aggregate"],
                "srp": counts_s["srp"], "gram_sketched": counts_s["gram"]}
    return launches, ds, params, {"arccos": round_ms, "srp": srp_round_ms}


def phase_fleet(torch) -> int:
    """Algorithm 2 over a 100,000-client fleet on the sketched store:
    bench_store_scale's full setting at the MLP's width."""
    import numpy as np

    from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
    from repro_torch.core.samplers.base import validate_plan
    from repro_torch.core.types import ClientPopulation
    from repro_torch.fl.gradient_store import GradientStore
    from repro_torch.kernels.sketch import ops as sk_ops

    n, m, c, rounds = FLEET["n"], FLEET["m"], FLEET["rows"], FLEET["rounds"]
    d = sum(a * b + b for a, b in zip(WIDTH[:-1], WIDTH[1:]))
    pop = ClientPopulation(np.full(n, 100))
    t0 = time.perf_counter()
    sampler = Algorithm2Sampler(pop, m, update_dim=d, seed=0, sketch="srp", sketch_dim=D_PRIME,
                                clusterer="kmeans")
    torch.cuda.synchronize()
    store = sampler._store
    print(f"fleet: n = {n}, m = {m}, d = {d}, d' = {D_PRIME}: store {store.nbytes} B resident "
          f"({store.nbytes / 1e6:.1f} MB) against {4 * n * d} B ({4 * n * d / 1e9:.1f} GB) "
          f"unsketched; cold-start plan in {(time.perf_counter() - t0) * 1e3:.3f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    blocks = [(rng.choice(n, size=c, replace=False),
               SIM_SCALE * torch.randn((c, d), generator=gen, device="cuda")) for _ in range(rounds)]
    probe = GradientStore(n, d, sketch="srp", sketch_dim=D_PRIME, sketch_seed=0)
    ids, U = blocks[0]
    scatter_ms = time_ms(torch, lambda: probe.update(ids, U), reps=20)
    torch.cuda.synchronize()
    sk_ops.launches.update(srp=0)
    for r, (ids, U) in enumerate(blocks):
        t1 = time.perf_counter()
        sampler.observe_updates(ids, U)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        build_ms, _ = sampler.plan_cost_telemetry()
        version, lag = sampler.plan_telemetry()
        print(f"fleet: round {r} observe {wall:.3f} ms (sketch, scatter, snapshot, rebuild), "
              f"plan_build_ms {build_ms:.3f}, plan version {version}, lag {lag}")
        if (version, lag) != (r + 1, 0):
            fail(f"fleet: round {r} left plan version {version} with lag {lag}; a rebuild was skipped")
    launches = sk_ops.launches["srp"]
    validate_plan(sampler.plan, pop)
    G = store.snapshot()
    rows = np.concatenate([ids for ids, _ in blocks])
    if not bool(torch.isfinite(G).all()) or int((G.abs().sum(dim=1) > 0).sum()) != len(np.unique(rows)):
        fail("fleet: the store does not hold exactly the observed rows, finite")
    if launches != rounds:
        fail(f"fleet: {launches} srp launches in {rounds} rounds")
    groups = len(np.unique(sampler.plan.cluster_of[sampler.plan.cluster_of >= 0]))
    print(f"fleet: sketch + scatter of ({c}, {d}) into the store {scatter_ms:.6f} ms (CUDA events, "
          f"mean of 20); {launches} srp launches in {rounds} rounds; plan valid, {groups} groups")
    sampler.close()
    return launches


def _kernel_events(torch, prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def device_events(torch, fn, reps: int = 20) -> list:
    """The device events torch.profiler keeps of ``reps`` calls of ``fn``.

    On the H100 it may drop some of a short window's kernels (it kept 3 and
    4 of 5 flash-attention launches in two runs), so a busy time divided by
    ``reps`` can undercount."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _kernel_events(torch, prof)


def kept_device_events(torch, fn, reps: int = 20, tries: int = 3) -> list:
    """device_events of the first of ``tries`` windows in which the profiler
    kept any device event (on the card it sometimes keeps none of a short
    window, which says nothing of the calls); [] if it kept none in all."""
    for _ in range(tries):
        events = device_events(torch, fn, reps)
        if events:
            return events
    return []


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device-busy ms per call of ``fn``, from a torch.profiler trace; NaN
    where the profiler kept no device event."""
    events = kept_device_events(torch, fn, reps)
    return _busy_us(events) / 1e3 / reps if events else math.nan


def _ms(t: float) -> str:
    return "not measured (the profiler kept no device event)" if math.isnan(t) else f"{t:.6f} ms"


def phase_trace(torch, ds, params, round_ms, label="arccos", **sampler_kw):
    """One more arccos round under torch.profiler: device busy time by
    kernel, and the idle share of that same round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
    from repro_torch.fl.server import FederatedServer, FLConfig
    from repro_torch.optim.sgd import sgd

    d = sum(v.numel() for v in params.values())
    sampler = Algorithm2Sampler(ds.population, 10, update_dim=d, seed=1, **sampler_kw)
    cfg = FLConfig(n_rounds=2, n_local_steps=50, batch_size=50, seed=1)
    with FederatedServer(ds, sampler, params, sgd(0.01), cfg) as srv:
        srv.run_round(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.run_round(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    _report_trace(torch, prof, wall_ms, label, "one round",
                  f"; the unprofiled median round took {round_ms:.3f} ms")


PORT_KERNELS = ("pairwise_", "aggregate_", "srp_", "flash_fwd")


def _report_trace(torch, prof, wall_ms, label, what, note=""):
    """Print device busy, idle share and device time by kernel; returns
    (busy ms, {kernel name: device ms})."""
    events = _kernel_events(torch, prof)
    if not events:
        fail(f"trace[{label}]: the profiler recorded no device activity in {what}")
    busy_ms = _busy_us(events) / 1e3
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    print(f"trace[{label}]: {what}, device busy {busy_ms:.3f} ms of its {wall_ms:.3f} ms wall "
          f"({len(events)} device events), idle share {1 - busy_ms / wall_ms:.4f}{note}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, ms) in ranked[:10]:
        print(f"trace[{label}]:   {ms:9.4f} ms  {count:5d}x  {name[:90]}")
    for name, (count, ms) in ranked:
        if any(k in name for k in PORT_KERNELS):
            print(f"trace[{label}]:   port kernel {ms:9.4f} ms  {count:5d}x  {name[:90]}")
    return busy_ms, {name: ms for name, (_, ms) in by_name.items()}


def phase_serve(torch):
    """``generate`` at qwen2-1.5b's full width and depth: the LM serve path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as mdl

    cfg = get_config(SERVE["arch"])
    b, p, n_gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, 0, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p), generator=g, device=DEV)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} kv), head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype}: {mdl.param_count(params)} "
          f"parameters made on the card in {time.perf_counter() - t0:.3f} s")
    generate(cfg, params, prompts, 2, device=DEV)  # warm-up: cuBLAS handles, kernel load
    marks, counts = [], []

    def on_step(phase, t):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(fa_ops.launches["flash_attention"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches.update(flash_attention=0)
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, n_gen, device=DEV, on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = (marks[0] - t0) * 1e3
    decode_ms = (marks[-1] - marks[0]) * 1e3 / (n_gen - 1)
    in_prefill, in_decode = counts[0], counts[-1] - counts[0]
    print(f"serve: batch {b}, prompt {p}, {n_gen} tokens: prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms per step ({b * (n_gen - 1) / (marks[-1] - marks[0]):.1f} tokens/s "
          f"decoding, {b * n_gen / (marks[-1] - t0):.1f} tokens/s end to end); peak device memory "
          f"{peak} B ({peak / 2**30:.2f} GiB)")
    print(f"serve: flash_attention launches: {in_prefill} in the prefill, {in_decode} in the "
          f"{n_gen - 1} decode steps")
    print(f"serve: first generated row {tokens[0].tolist()}")
    if (in_prefill, in_decode) != (cfg.n_layers, 0):
        fail(f"serve: flash launches {in_prefill} in the prefill and {in_decode} in the decode, "
             f"expected {cfg.n_layers} and 0")
    if tuple(tokens.shape) != (b, n_gen) or tuple(logits.shape) != (n_gen, b, cfg.vocab_size):
        fail(f"serve: tokens {tuple(tokens.shape)}, logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("serve: logits are not finite")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        fail("serve: a token id is out of range")
    if not torch.equal(tokens, logits.argmax(dim=-1).T):
        fail("serve: the tokens are not the per-step argmax of the logits")
    _serve_against_plain(torch, cfg, params, prompts)
    return cfg, params, prompts, in_prefill + in_decode


def _serve_against_plain(torch, cfg, params, prompts, label="serve"):
    """One prefill through the kernel and one with the model's attention
    swapped for the plain version on the card: the last-position tokens must
    agree in every row whose plain top-2 margin exceeds twice the largest
    logit difference. In an MoE model it counts the routing choices that
    differ between the two prefills (a flipped expert inflates the logit
    difference, and so loosens the rule)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import attention
    from repro_torch.models.layers import moe as moe_lib

    def last_logits():
        routes = []
        route = moe_lib.route
        moe_lib.route = lambda *a: routes.append(route(*a)) or routes[-1]
        try:
            with torch.inference_mode():
                caches = mdl.init_cache(cfg, prompts.shape[0], prompts.shape[1] + 1, device=DEV)
                hidden, _, _ = mdl.forward(cfg, params, prompts, caches=caches)
                logits = mdl.logits_from_hidden(cfg, params, hidden[:, -1:, :])[:, 0].float()
        finally:
            moe_lib.route = route
        return logits, [(r.expert, r.kept) for r in routes]

    kernel, kernel_routes = last_logits()
    again, again_routes = last_logits()
    if not torch.equal(kernel, again) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(kernel_routes, again_routes)):
        fail(f"{label}: two prefills through the kernel differ (logits or routing)")
    swapped = attention.flash_attention
    attention.flash_attention = (
        lambda q, k, v, causal=True: flash_attention_plain(q, k, v, causal=causal))
    try:
        plain, plain_routes = last_logits()
    finally:
        attention.flash_attention = swapped
    if kernel_routes:
        choices = sum(e.numel() for e, _ in kernel_routes)
        flipped = [int((a[0] != b[0]).sum()) for a, b in zip(kernel_routes, plain_routes)]
        kept = sum(int((a[1] != b[1]).sum()) for a, b in zip(kernel_routes, plain_routes))
        print(f"{label}: two prefills through the kernel: logits and routing bit-identical; kernel "
              f"vs plain prefill routing: {sum(flipped)} of {choices} expert choices differ over "
              f"{len(kernel_routes)} MoE layers (by layer {flipped}), {kept} kept/dropped states "
              "differ")
    delta = float((kernel - plain).abs().max())
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * delta
    same = kernel.argmax(dim=-1) == plain.argmax(dim=-1)
    if not math.isfinite(delta) or bool((decided & ~same).any()):
        fail(f"{label}: the kernel's prefill picks other tokens than the plain version's where the "
             f"margin exceeds 2·{delta:.4f}: margins {margin.tolist()}, equal {same.tolist()}")
    print(f"{label}: prefill through the kernel vs the plain version on the card: max |Δ| of the "
          f"last-position logits {delta:.4e}; tokens equal in {int(same.sum())} of "
          f"{same.numel()} rows, {int(decided.sum())} rows with a margin above 2·max|Δ| "
          f"(margins {[round(x, 4) for x in margin.tolist()]})")


def phase_serve_trace(torch, cfg, params, prompts, tag=""):
    """One prefill (with the front end's zero stubs, if any) and one decode
    step under torch.profiler; ``tag`` prefixes the trace labels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import frontend_stubs
    from repro_torch.models import model as mdl

    b, p = prompts.shape
    extras = frontend_stubs(cfg, b, DEV)
    with torch.inference_mode():
        caches = mdl.init_cache(cfg, b, p + 2, device=DEV)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hidden, caches, _ = mdl.forward(cfg, params, prompts, caches=caches, **extras)
            logits = mdl.logits_from_hidden(cfg, params, hidden[:, -1:, :])[:, 0]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, by_name = _report_trace(torch, prof, wall_ms, f"{tag}prefill",
                                      f"one prefill of ({b}, {p})")
        flash = sum(ms for name, ms in by_name.items() if "flash_fwd" in name)
        ran = sorted({_kernel_name(name) for name in by_name if "flash_fwd" in name})
        want = flash_kernel(str(cfg.dtype).removeprefix("torch."), cfg.resolved_head_dim)
        if ran and any(not name.startswith(want + "<") for name in ran):
            fail(f"trace[{tag}prefill]: the prefill ran {ran}, not {want}")
        if ran:
            print(f"trace[{tag}prefill]: the flash kernel that ran, by the profiler's name: {ran}")
        print(f"trace[{tag}prefill]: flash kernel {flash:.3f} ms, {flash / busy:.4f} of the "
              "device-busy time")
        tok = logits.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mdl.decode_step(cfg, params, tok, caches)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _report_trace(torch, prof, wall_ms, f"{tag}decode", "one decode step")


def flash_kernel(dtype: str, hd: int) -> str:
    """The kernel that csrc/flash_attention.cu's route launches for one
    dtype of q, k and v and a head dim."""
    if dtype == "float32":
        return "flash_fwd_f32"
    if 32 < hd <= 128:
        return "flash_fwd_wgmma"
    return "flash_fwd_mma" if hd <= 256 else "flash_fwd_mma_wide"


def flash_time_row(torch, gen, name, err, launches, shape=FLASH_PATH, row_name="flash_attention",
                   dtype="bfloat16", lean=False):
    """The flash kernel at a serve path's shape (bf16 unless ``dtype`` says
    otherwise): its time, the plain version's and
    scaled_dot_product_attention's, beside its bound. The kernel and the
    library are timed in turns (kernel, library, library, kernel), by events
    as called and with the queue filled ahead; ``lean`` keeps the turns as
    called and the plain version's time, and leaves out the queued turns and
    the profiler's device times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    part, bw, f32, bf16 = peaks_for(name)
    b, s, h, kv, hd = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(dims, generator=gen).to(DEV, dt)
               for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    # the yardstick takes (B, H, S, hd) views; the port never calls it
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    fns = {"kernel": lambda: fa_ops.flash_attention_padded(q, k, v),
           "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True)}
    plain = lambda: flash_attention_plain(q, k, v)
    called = {"kernel": [], "library": []}
    queued = {"kernel": [], "library": []}
    for who in ("kernel", "library", "library", "kernel"):
        called[who].append(time_ms(torch, fns[who], reps=20))
        if not lean:
            queued[who].append(time_ms(torch, fns[who], reps=20, queued=True))
    ms, lib_ms = (sum(called[w]) / 2 for w in ("kernel", "library"))
    plain_ms = time_ms(torch, plain, reps=5)
    nbytes = q.element_size() * (2 * b * s * h * hd + 2 * b * s * kv * hd)  # q, out, k, v once
    nops = 2 * b * h * s * s * hd  # causal: QKᵀ and PV over the lower triangle
    peak = f32 if dt == torch.float32 else bf16  # f32 on the CUDA cores, 16-bit on the tensor cores
    t_bytes, t_ops = nbytes / bw * 1e3, nops / peak * 1e3
    row = {
        "name": row_name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:70", "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
        "kernel": flash_kernel(dtype, hd),
    }

    def tflops(t_ms):
        return nops / (t_ms * 1e-3) / 1e12

    print(f"times: {row_name} {shape} {dtype} {ms:.6f} ms, plain {plain_ms:.6f} ms, library "
          f"(scaled_dot_product_attention) {lib_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}; {part} peaks {bw / 1e12:.2f} TB/s, {peak / 1e12:.0f} TFLOP/s "
          f"{'f32' if dt == torch.float32 else 'bf16 and f16'}; {nbytes} B, {nops} FLOP)")
    print(f"times: {row_name} in turns (kernel, library, library, kernel), ms per call by "
          f"events as called: {called['kernel'][0]:.6f}, {called['library'][0]:.6f}, "
          f"{called['library'][1]:.6f}, {called['kernel'][1]:.6f}; kernel "
          f"{tflops(ms):.1f} TFLOP/s, library {tflops(lib_ms):.1f}")
    if lean:
        return row
    q_ms, q_lib = (sum(queued[w]) / 2 for w in ("kernel", "library"))
    lib_events = kept_device_events(torch, fns["library"], reps=5)
    dev = [device_ms(torch, plain, reps=5), _busy_us(lib_events) / 1e3 / 5]
    # the kernel's own device time: the mean of the launches the profiler kept
    kept = [e for e in kept_device_events(torch, fns["kernel"], reps=20) if "flash_fwd" in e.name]
    if not kept:
        fail("times: the profiler kept no flash kernel of 20 launches")
    ran = sorted({_kernel_name(e.name) for e in kept})
    if any(not name.startswith(row["kernel"] + "<") for name in ran):
        fail(f"times: {row_name} ran {ran}, not {row['kernel']}")
    print(f"times: {row_name}: the profiler names the kernel that ran: {ran}")
    dev.insert(0, sum(e.time_range.end - e.time_range.start for e in kept) / 1e3 / len(kept))
    print(f"times: {row_name} with the queue filled ahead, in the same turns: "
          f"{queued['kernel'][0]:.6f}, {queued['library'][0]:.6f}, {queued['library'][1]:.6f}, "
          f"{queued['kernel'][1]:.6f}")
    print(f"times: {row_name} kernel {tflops(ms):.1f} TFLOP/s as called, {tflops(q_ms):.1f} "
          f"queued; library {tflops(lib_ms):.1f} as called, {tflops(q_lib):.1f} queued; kernel / "
          f"library {ms / lib_ms:.3f} as called, {q_ms / q_lib:.3f} queued")
    print(f"times: {row_name} device-busy per call (profiler): kernel {dev[0]:.6f} ms (mean of "
          f"the {len(kept)} of 20 launches it kept), plain {dev[1]:.6f} ms, library {dev[2]:.6f} ms; "
          f"kernel at {tflops(dev[0]):.1f} TFLOP/s")
    print(f"times: scaled_dot_product_attention ran {sorted({e.name[:80] for e in lib_events})}")
    return row


def phase_times(torch, gen, name, err, launches):
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.similarity.ref import gram_ref, l1_ref
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ref import sketch_srp_plain, srp_sign_block

    part, bw, f32, _ = peaks_for(name)
    n, d = SIM_SHAPES[0]
    G = (SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
    ns, ds_ = SKETCHED_SIM_SHAPE
    Gs = (SIM_SCALE * torch.randn((ns, ds_), generator=gen)).cuda()
    k, p = AGG_SHAPE
    U = torch.randn((k, p), generator=gen).cuda()
    w = torch.rand((k,), generator=gen).cuda()
    c10, dx, dp = SRP_SHAPES[0]
    c64 = SRP_SHAPES[1][0]
    X10 = (SIM_SCALE * torch.randn((c10, dx), generator=gen)).cuda()
    X64 = (SIM_SCALE * torch.randn((c64, dx), generator=gen)).cuda()
    # the yardstick torch.matmul(X, S) takes the (d, d') S materialised once;
    # the port never does
    S = srp_sign_block(SRP_SEED, 0, dx, dp, dx, device="cuda")

    # bytes; operations of the i <= j half, n(n+1)/2 pairs × d, in FLOP at the
    # f32 peak: the Gram's FFMA is 2 FLOP, L1's FADD a − b and FADD acc + |·|
    # are two FP32-pipe slots, 4 FLOP of the peak
    def sim_cost(n, d, slots=1):
        return 4 * (n * d + n * n), slots * n * (n + 1) * d

    def srp_cost(c):
        return 4 * (c * dx + c * dp), 2 * c * dx * dp

    agg_bytes = 4 * (k * p + k + p)
    src_sim, src_agg, src_srp = ("src/repro_torch/csrc/similarity.cu", "src/repro_torch/csrc/aggregate.cu",
                                 "src/repro_torch/csrc/sketch.cu")
    rep_sim, rep_agg, rep_srp = ("src/repro/kernels/similarity/kernel.py:142",
                                 "src/repro/kernels/aggregate/kernel.py:33",
                                 "src/repro/kernels/sketch/kernel.py:68")
    cases = [
        ("similarity_gram", src_sim, rep_sim, "gram",
         lambda: sim_ops.pairwise_sums(G, "gram"), lambda: gram_ref(G), lambda: G @ G.T, *sim_cost(n, d)),
        ("similarity_l1", src_sim, rep_sim, "l1",
         lambda: sim_ops.pairwise_sums(G, "l1"), lambda: l1_ref(G),
         lambda: torch.cdist(G, G, p=1), *sim_cost(n, d, slots=2)),
        ("similarity_gram_d64", src_sim, rep_sim, "gram_sketched",
         lambda: sim_ops.pairwise_sums(Gs, "gram"), lambda: gram_ref(Gs), lambda: Gs @ Gs.T,
         *sim_cost(ns, ds_)),
        ("aggregate", src_agg, rep_agg, "aggregate",
         lambda: agg_ops.aggregate_flat(U, w), lambda: aggregate_ref(U, w),
         lambda: torch.mv(U.T, w), agg_bytes, 2 * k * p),
        ("srp_sketch", src_srp, rep_srp, "srp",
         lambda: sk_ops.srp_sketch(X10, dp, SRP_SEED), lambda: sketch_srp_plain(X10, dp, SRP_SEED),
         lambda: torch.matmul(X10, S), *srp_cost(c10)),
        ("srp_sketch_fleet", src_srp, rep_srp, "srp_fleet",
         lambda: sk_ops.srp_sketch(X64, dp, SRP_SEED), lambda: sketch_srp_plain(X64, dp, SRP_SEED),
         lambda: torch.matmul(X64, S), *srp_cost(c64)),
    ]
    errs = {"gram": err["gram"], "l1": err["l1"], "gram_sketched": err["gram"],
            "aggregate": err["aggregate"], "srp": err["srp"], "srp_fleet": err["srp"]}
    # what the operation count of a bound stands for, where it is not plain FLOP
    notes = {"similarity_gram": "one FFMA (2 FLOP) per product of the i <= j half",
             "similarity_l1": "two FP32-pipe instructions per element of the i <= j half (FADD a - b, "
                              "FADD acc + |.|), counted as 4 FLOP at the f32 peak",
             "similarity_gram_d64": "one FFMA (2 FLOP) per product of the i <= j half"}
    rows = []
    for kname, source, replaces, key, kern, plain, lib, nbytes, nops in cases:
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=10)
        lib_ms = time_ms(torch, lib)
        dev = [device_ms(torch, f) for f in (kern, plain, lib)]
        t_bytes = nbytes / bw * 1e3
        t_ops = nops / f32 * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        if kname in notes:
            rows[-1]["bound_note"] = notes[kname]
        print(f"times: {kname} {ms:.6f} ms, plain {plain_ms:.6f} ms, library {lib_ms:.6f} ms, "
              f"bound {bound:.6f} ms ({rows[-1]['bound_by']}; {part} peaks "
              f"{bw / 1e12:.2f} TB/s, {f32 / 1e12:.0f} TFLOP/s f32)")
        print(f"times: {kname} device-busy per call (profiler): kernel {_ms(dev[0])}, "
              f"plain {_ms(dev[1])}, library {_ms(dev[2])}"
              + ("; the event time is wrapper-bound" if dev[0] < 0.5 * ms else ""))
    return rows


def kernels_by_name(events) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches the profiler kept, mean device ms of one)}."""
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(_kernel_name(e.name), [0, 0.0])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    return {k: (n, ms / n) for k, (n, ms) in by_name.items()}


def kernel_turns(torch, label, kernel, lib_name, lib, note=""):
    """A kernel's wrapper and one library call in turns (kernel, library,
    library, kernel), by events as called and with the queue filled ahead,
    and the device time of each kernel one call launches, by name, with the
    call's device-busy time (the union of its spans). ``note`` follows the
    kernel's line."""
    fns = {"kernel": kernel, lib_name: lib}
    called, queued = {"kernel": [], lib_name: []}, {"kernel": [], lib_name: []}
    for who in ("kernel", lib_name, lib_name, "kernel"):
        called[who].append(time_ms(torch, fns[who]))
        queued[who].append(time_ms(torch, fns[who], queued=True))
    print(f"times: {label} in turns (kernel, {lib_name}, {lib_name}, kernel), ms per call by "
          f"events as called: {called['kernel'][0]:.6f}, {called[lib_name][0]:.6f}, "
          f"{called[lib_name][1]:.6f}, {called['kernel'][1]:.6f}; with the queue filled "
          f"ahead: {queued['kernel'][0]:.6f}, {queued[lib_name][0]:.6f}, "
          f"{queued[lib_name][1]:.6f}, {queued['kernel'][1]:.6f}")
    for who in ("kernel", lib_name):
        events = kept_device_events(torch, fns[who], reps=20)
        if not events:
            print(f"times: {label} {who} device time by kernel: not measured (the profiler "
                  f"kept no device event in 3 windows)")
            continue
        split = kernels_by_name(events)
        launches = max(n for n, _ in split.values())
        print(f"times: {label} {who} device time by kernel over 20 calls (launches kept, "
              f"mean ms of one): " + ", ".join(f"{k} {n}x {ms:.6f}" for k, (n, ms) in split.items())
              + f"; device-busy {_busy_us(events) / 1e3 / launches:.6f} ms a call (the union of "
              f"the spans" + (note if who == "kernel" else "") + ")")


def srp_turns(torch, gen):
    """The SRP kernels at the main path's shapes (c = 10, a round's rows;
    c = 64, the fleet's) and torch.matmul(X, S) in turns."""
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ref import srp_sign_block

    _, dx, dp = SRP_SHAPES[0]
    S = srp_sign_block(SRP_SEED, 0, dx, dp, dx, device="cuda")
    for c in (SRP_SHAPES[0][0], SRP_SHAPES[1][0]):
        X = (SIM_SCALE * torch.randn((c, dx), generator=gen)).cuda()
        kernel_turns(torch, f"srp c = {c}", lambda: sk_ops.srp_sketch(X, dp, SRP_SEED), "matmul",
                     lambda: torch.matmul(X, S),
                     "; srp_reduce is a programmatic dependent launch, so its span includes its "
                     "wait for srp_partial")


def sim_turns(torch, gen):
    """The similarity kernels at the main path's shapes (Gram and L1 at
    (100, 39,760), the Gram at the sketched store's (100, 64)) and the
    library calls ``G @ G.T`` and ``torch.cdist(G, G, p=1)`` in turns."""
    from repro_torch.kernels.similarity import ops as sim_ops

    for (n, d), op in ((SIM_SHAPES[0], "gram"), (SIM_SHAPES[0], "l1"), (SKETCHED_SIM_SHAPE, "gram")):
        G = (SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
        lib_name, lib = (("matmul", lambda: G @ G.T) if op == "gram" else
                         ("cdist", lambda: torch.cdist(G, G, p=1)))
        splits, per = sim_ops.split_plan(n, d)
        kernel_turns(torch, f"similarity {op} ({n}, {d})", lambda: sim_ops.pairwise_sums(G, op),
                     lib_name, lib, f"; {splits} d-splits of {per} chunks; a second kernel, if any, "
                     "is a programmatic dependent launch, so its span includes its wait")


def agg_turns(torch, gen):
    """The aggregate kernel at the main path's (11, 39,760) and
    bench_round_engine's (41, 39,760) and torch.mv(U.T, w) in turns; an
    empty kernel on the same grid (the launch floor); the wrapper's host
    time step by step."""
    from repro_torch.kernels.aggregate import ops as agg_ops

    lib = agg_ops._lib()
    part, bw, *_ = peaks_for(torch.cuda.get_device_name(0))
    path = None
    for k, p in AGG_SHAPES[:2]:
        U = torch.randn((k, p), generator=gen).cuda()
        w = torch.rand((k,), generator=gen).cuda()
        path = path or (U, w)
        nbytes = 4 * (k * p + k + p)
        print(f"times: aggregate ({k}, {p}) bound {nbytes / bw * 1e3:.6f} ms ({nbytes} B read or "
              f"written once at {part}'s {bw / 1e12:.2f} TB/s)")
        kernel_turns(torch, f"aggregate ({k}, {p})", lambda: agg_ops.aggregate_flat(U, w), "mv",
                     lambda: torch.mv(U.T, w), "; U is L2-warm: the same rows every call")
        blocks, threads = agg_ops.launch_plan(k, p)

        def floor():
            if lib.aggregate_empty_launch(blocks, threads, torch.cuda.current_stream().cuda_stream):
                fail("times: the empty aggregate kernel did not launch")

        print(f"times: aggregate ({k}, {p}) launch floor, an empty kernel on the same grid "
              f"({blocks} blocks of {threads} threads): {time_ms(torch, floor):.6f} ms a call as "
              f"called, {time_ms(torch, floor, queued=True):.6f} queued; device-busy "
              f"{_ms(device_ms(torch, floor))}")
    agg_wrapper_steps(torch, *path)


def agg_wrapper_steps(torch, U, w, calls: int = 2000):
    """Host µs a call of the aggregate wrapper, step by step: perf_counter
    over ``calls`` calls of each cumulative prefix of its work (a Python
    call, the checks, the plan, the output's allocation, the stream, the
    device guard, the ctypes call and launch), beside the whole wrapper and
    torch.mv(U.T, w);
    then some of the steps alone and the calls they replaced."""
    from repro_torch.kernels.aggregate import ops as agg_ops

    lib = agg_ops._lib()
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    k, p = U.shape
    dev = U.get_device()
    raw_stream = torch._C._cuda_getCurrentRawStream

    def checks():
        shape = U.shape
        if len(shape) != 2 or shape[0] < 1 or shape[1] < 1 or w.shape != shape[:1]:
            fail("shape")
        if U.dtype != torch.float32 or w.dtype != torch.float32:
            fail("dtype")
        if not U.is_cuda or w.get_device() != U.get_device():
            fail("device")
        if not (U.is_contiguous() and w.is_contiguous()):
            fail("contiguous")

    def plan():
        checks()
        return agg_ops.launch_plan(k, p)

    def alloc():
        plan()
        return U.new_empty(p)

    def stream():
        alloc()
        return raw_stream(dev)

    def guard():
        with torch.cuda.device(dev):
            return stream()

    def guard_alone():
        with torch.cuda.device(dev):
            pass

    def launch():
        blocks, threads = plan()
        out = U.new_empty(p)
        with torch.cuda.device(dev):
            lib.aggregate_rows(U.data_ptr(), w.data_ptr(), out.data_ptr(), k, p, blocks, threads,
                               raw_stream(dev))

    blocks, threads = agg_ops.launch_plan(k, p)
    steps = {"a Python call": lambda: None, "+ checks": checks, "+ the plan": plan,
             "+ new_empty": alloc, "+ the raw stream": stream, "+ the device guard": guard,
             "+ data_ptr, ctypes and the launch": launch,
             "the wrapper": lambda: agg_ops.aggregate_flat(U, w), "torch.mv": lambda: torch.mv(U.T, w)}
    alone = {"torch.empty(p, dtype, device)": lambda: torch.empty(p, dtype=torch.float32, device=U.device),
             "new_empty": lambda: U.new_empty(p),
             "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "_cuda_getCurrentRawStream": lambda: raw_stream(dev),
             "torch.cuda.device(dev) entered and left": guard_alone,
             "a ctypes call (cuda_error_string)": lambda: lib.cuda_error_string(0),
             "ctypes and an empty launch": lambda: lib.aggregate_empty_launch(blocks, threads, raw_stream(dev))}

    def host_us(fns):
        us = {}
        for label, fn in fns.items():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us[label] = (time.perf_counter() - t0) * 1e6 / calls
            torch.cuda.synchronize()
        return ", ".join(f"{label} {t:.3f}" for label, t in us.items())

    print(f"times: aggregate ({k}, {p}) wrapper host µs a call (perf_counter over {calls} calls, "
          f"cumulative): {host_us(steps)}")
    print(f"times: aggregate host µs a call of single steps: {host_us(alone)}")


# the paper phase: the runners' sweeps at the paper's MNIST width
PAPER_DATA = {"dim": WIDTH[0], "train_per_client": 500, "test_per_client": 100}  # by_class_shards
PAPER_ROUNDS, PAPER_SEEDS, PAPER_SKETCH_ROUNDS = 5, 2, 3
PAPER_LOSS_ATOL = 1e-4  # the slice phase's card-vs-CPU tolerance


class PaperProbe:
    """What the paper phase runs, counted and timed around the port's own
    calls: each round's wall ms (host clock ending in
    ``torch.cuda.synchronize()``) and ``plan_build_ms`` by sweep and scheme,
    rounds run on the card, and every Algorithm 2 plan build with its
    tokens, by device. Patches ``FederatedServer.run_round`` and
    ``Algorithm2Sampler._build_plan`` for the ``with`` block only."""

    def __init__(self, torch):
        from repro_torch.core.samplers import SAMPLERS
        from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
        from repro_torch.fl.server import FederatedServer

        self.torch = torch
        self.scheme_of = {cls: name for name, cls in SAMPLERS.items()}
        self.label = ""
        self.rounds: dict[tuple[str, str], list[tuple[float, float]]] = {}
        self.card_rounds = 0
        self.builds: dict[str, list] = {"cuda": [], "cpu": []}
        self._targets = [(FederatedServer, "run_round", self._run_round),
                         (Algorithm2Sampler, "_build_plan", self._build_plan)]
        self._saved = []

    def __enter__(self):
        for cls, attr, wrap in self._targets:
            orig = getattr(cls, attr)
            self._saved.append((cls, attr, orig))
            setattr(cls, attr, wrap(orig))
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in self._saved:
            setattr(cls, attr, orig)

    def _card(self, device) -> bool:
        return device.type == "cuda"

    def _run_round(self, orig):
        def run_round(srv, t):
            t0 = time.perf_counter()
            rec = orig(srv, t)
            if self._card(srv.device):
                self.torch.cuda.synchronize()
                self.card_rounds += 1
                key = (self.label, self.scheme_of[type(srv.sampler)])
                self.rounds.setdefault(key, []).append(
                    ((time.perf_counter() - t0) * 1e3, rec.plan_build_ms))
            return rec
        return run_round

    def _build_plan(self, orig):
        def build_plan(sampler, G):
            plan = orig(sampler, G)
            self.builds[sampler._store.device.type].append(plan.r_tokens.copy())
            return plan
        return build_plan


def _paper_sweep(runner_sweep: dict, rounds: int, n_seeds: int, data: dict) -> dict:
    """A runner's SWEEP with the data options, depth and seeds set by path."""
    import copy

    from repro_torch.fl.sweep import set_by_path

    d = copy.deepcopy(runner_sweep)
    for key, value in data.items():
        set_by_path(d, f"base.data.options.{key}", value)
    set_by_path(d, "base.train.n_rounds", rounds)
    set_by_path(d, "n_seeds", n_seeds)
    return d


def _paper_histories(store_root: str, label: str, sweep: dict) -> list:
    """[(cell, History)] of a sweep that run_sweep_emit left under store_root."""
    from repro_torch.fl.sweep import RunStore, SweepSpec

    store = RunStore(Path(store_root) / label)
    return [(c, store.read_history(c.cell_id)) for c in SweepSpec.from_dict(sweep).cells()]


def paper_fig1(probe, store_root: str) -> None:
    from repro_torch.benchmarks import fig1_controlled
    from repro_torch.benchmarks.common import run_sweep_emit

    sweep = _paper_sweep(fig1_controlled.SWEEP, PAPER_ROUNDS, PAPER_SEEDS, PAPER_DATA)
    probe.label = "fig1"
    run_sweep_emit(sweep, "fig1", stats=fig1_controlled.STATS, device="cuda")
    for cell, hist in _paper_histories(store_root, "fig1", sweep):
        name = cell.spec.sampler.name
        if len(hist.records) != PAPER_ROUNDS:
            fail(f"paper[fig1]: {name} seed {cell.seed_index} ran {len(hist.records)} rounds")
        for rec in hist.records:
            if not (math.isfinite(rec.train_loss) and 0.0 <= rec.test_acc <= 1.0):
                fail(f"paper[fig1]: {name} round {rec.round} loss/acc out of range")
            if name in ("algorithm1", "target") and rec.n_distinct_clients != 10:
                fail(f"paper[fig1]: {name} round {rec.round} drew {rec.n_distinct_clients} "
                     "distinct clients, not 10 (each urn holds 10 whole clients)")
            if name == "target" and rec.n_distinct_classes != 10:
                fail(f"paper[fig1]: target round {rec.round} covered {rec.n_distinct_classes} classes")
    print("paper[fig1]: every algorithm1 and target round drew 10 distinct clients, "
          "every target round 10 classes")


def paper_fig2(probe, store_root: str) -> None:
    from repro_torch.benchmarks import fig2_dirichlet
    from repro_torch.benchmarks.common import emit, run_sweep_emit

    sweep = _paper_sweep(fig2_dirichlet.SWEEP, PAPER_ROUNDS, PAPER_SEEDS, {"dim": WIDTH[0]})
    probe.label = "fig2"
    agg = run_sweep_emit(sweep, "fig2", device="cuda")
    for alpha in fig2_dirichlet.ALPHAS:
        rows = {r["sampler.name"]: r for r in agg if r["data.options.alpha"] == str(alpha)}
        gain = rows["md"]["final_loss_mean"] - rows["algorithm2"]["final_loss_mean"]
        emit(f"fig2/alpha={alpha}/clustered_gain", 0.0, f"loss_delta={gain:.4f}")
    for cell, hist in _paper_histories(store_root, "fig2", sweep):
        if len(hist.records) != PAPER_ROUNDS or not all(
                math.isfinite(r.train_loss) for r in hist.records):
            fail(f"paper[fig2]: cell {cell.cell_id} did not run {PAPER_ROUNDS} finite rounds")


def paper_sketched(probe, torch) -> None:
    """One Algorithm 2 cell with the SRP sketch to d' = 64, through the spec."""
    import tempfile

    from repro_torch.benchmarks import fig1_controlled
    from repro_torch.fl.sweep import RunStore, SweepSpec, run_sweep, set_by_path

    sweep = _paper_sweep(fig1_controlled.SWEEP, PAPER_SKETCH_ROUNDS, 1, PAPER_DATA)
    sweep["axes"] = {}
    set_by_path(sweep, "base.sampler", {"name": "algorithm2", "m": 10})
    set_by_path(sweep, "base.planner", {"sketch": "srp", "sketch_dim": D_PRIME})
    probe.label = "sketched"
    with tempfile.TemporaryDirectory(prefix="paper-sketched-") as root:
        run_sweep(sweep, root, device="cuda")
        (cell,) = SweepSpec.from_dict(sweep).cells()
        hist = RunStore(root).read_history(cell.cell_id)
    for rec in hist.records:
        print(f"paper[sketched]: round {rec.round} plan_build_ms {rec.plan_build_ms:.3f}, "
              f"distinct {rec.n_distinct_clients}, train_loss {rec.train_loss:.4f}, "
              f"test_acc {rec.test_acc:.4f}")
    if len(hist.records) != PAPER_SKETCH_ROUNDS:
        fail(f"paper[sketched]: {len(hist.records)} rounds of {PAPER_SKETCH_ROUNDS}")


def paper_table(torch, gen) -> None:
    """The runner's rows, then the paper's theorems on the card's plans."""
    import numpy as np

    from repro_torch.benchmarks import table_variance
    from repro_torch.core import ClientPopulation, max_draws_bound
    from repro_torch.core.statistics import (
        clustered_inclusion_probability,
        md_inclusion_probability,
        md_prob_all_distinct,
        variance_reduction,
    )
    from repro_torch.fl.experiment import build_sampler

    table_variance.main(["--device", "cuda"])
    pop = ClientPopulation(table_variance.PROFILE)
    m, p = 10, pop.importances
    d = WIDTH[0] * WIDTH[1] + WIDTH[1] + WIDTH[1] * WIDTH[2] + WIDTH[2]
    a1 = build_sampler({"name": "algorithm1", "m": m}, pop)
    a2 = build_sampler({"name": "algorithm2", "m": m}, pop, update_dim=d, device="cuda")
    cold = a2.plan
    # re-cluster from representative gradients of every client at the MLP's width
    a2.observe_updates(np.arange(pop.n_clients),
                       (SIM_SCALE * torch.randn((pop.n_clients, d), generator=gen)).cuda())
    bound = np.floor(m * p) + 2
    for name, plan in (("algorithm1", a1.plan), ("algorithm2", cold), ("algorithm2 re-clustered", a2.plan)):
        vr = variance_reduction(plan, pop)
        incl = clustered_inclusion_probability(plan) - md_inclusion_probability(p, m)
        support = max_draws_bound(plan)
        if vr.min() < -1e-12:
            fail(f"paper[table]: {name}: eq. 17 variance reduction {vr.min():.3e} < 0")
        if incl.min() < -1e-12:
            fail(f"paper[table]: {name}: eq. 23 inclusion below MD's by {-incl.min():.3e}")
        print(f"paper[table]: {name}: min variance reduction {vr.min():.3e}, min inclusion gain "
              f"{incl.min():.3e}, max support {int(support.max())} (clients over "
              f"floor(m p_i) + 2: {int((support > bound).sum())})")
    # Section 4's bound is Algorithm 1's; the runner's Algorithm 2 row reads the cold-start plan
    for name, plan in (("algorithm1", a1.plan), ("algorithm2", cold)):
        if (max_draws_bound(plan) > bound).any():
            fail(f"paper[table]: {name}: a client in more than floor(m p_i) + 2 urns")
    exact = math.factorial(100) / (math.factorial(90) * 100**10)
    got = md_prob_all_distinct(np.full(100, 0.01), m)
    if abs(got - exact) > 1e-12:
        fail(f"paper[table]: md_prob_all_distinct {got!r} != 100!/(90!·100^10) = {exact!r}")
    bal = build_sampler({"name": "algorithm1", "m": m}, ClientPopulation(np.full(100, 500)))
    distinct = sum(len(bal.sample(t).unique_clients) == m for t in range(500))
    if distinct != 500:
        fail(f"paper[table]: Algorithm 1 drew 10 distinct clients in {distinct} of 500 draws")
    print(f"paper[table]: md_prob_all_distinct {got!r} (exact {exact!r}); Algorithm 1 drew 10 "
          "distinct clients in 500 of 500 balanced draws")
    for s in (a1, a2, bal):
        s.close()


def paper_card_vs_cpu(probe) -> None:
    """fig1's sweep at dim 32, 2 rounds, 1 seed, on the card and on the CPU."""
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import fig1_controlled
    from repro_torch.fl.sweep import RunStore, SweepSpec, run_sweep

    sweep = _paper_sweep(fig1_controlled.SWEEP, 2, 1, {})
    cells = SweepSpec.from_dict(sweep).cells()
    hists = {}
    first = {dev: len(probe.builds[dev]) for dev in probe.builds}
    for dev in ("cuda", "cpu"):
        probe.label = f"card-vs-cpu[{dev}]"
        with tempfile.TemporaryDirectory(prefix=f"paper-{dev}-") as root:
            run_sweep(sweep, root, device=dev)
            hists[dev] = [RunStore(root).read_history(c.cell_id) for c in cells]
    worst = 0.0
    for cell, card, cpu in zip(cells, hists["cuda"], hists["cpu"]):
        for a, b in zip(card.records, cpu.records):
            if not np.array_equal(a.agg_weights, b.agg_weights):
                fail(f"paper[card vs CPU]: {cell.spec.sampler.name} round {a.round}: draws differ")
            worst = max(worst, abs(a.train_loss - b.train_loss))
    if worst > PAPER_LOSS_ATOL:
        fail(f"paper[card vs CPU]: losses differ by {worst:.3e} > {PAPER_LOSS_ATOL}")
    plans = {dev: probe.builds[dev][first[dev]:] for dev in probe.builds}
    if len(plans["cuda"]) != len(plans["cpu"]) or not all(
            np.array_equal(a, b) for a, b in zip(plans["cuda"], plans["cpu"])):
        fail("paper[card vs CPU]: Algorithm 2's plans differ")
    print(f"paper[card vs CPU]: fig1 at dim 32, 2 rounds, 1 seed: equal draws and agg_weights "
          f"in {len(cells)} cells, {len(plans['cuda'])} equal Algorithm 2 plans, max loss diff "
          f"{worst:.2e}")


def phase_paper(torch, gen) -> dict:
    """The paper's experiments through the port's runners and sweep layer on
    the card: Fig. 1, Fig. 2, a sketched cell, the variance table, and a
    small fig1 sweep on the card against the CPU. Returns the launches."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    t0 = time.perf_counter()
    saved_store = os.environ.get("BENCH_SWEEP_STORE")
    with tempfile.TemporaryDirectory(prefix="paper-") as root, PaperProbe(torch) as probe:
        os.environ["BENCH_SWEEP_STORE"] = root  # keep the runners' stores to read the rounds
        try:
            torch.cuda.synchronize()
            sim_ops.launches.update(gram=0, l1=0)
            agg_ops.launches.update(aggregate=0)
            sk_ops.launches.update(srp=0)
            paper_fig1(probe, root)
            paper_fig2(probe, root)
            srp_before = sk_ops.launches["srp"]
            paper_sketched(probe, torch)
            srp_sketched = sk_ops.launches["srp"] - srp_before
            paper_table(torch, gen)
            paper_card_vs_cpu(probe)
            torch.cuda.synchronize()
            launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches}
        finally:
            if saved_store is None:
                os.environ.pop("BENCH_SWEEP_STORE", None)
            else:
                os.environ["BENCH_SWEEP_STORE"] = saved_store
    card_builds = len(probe.builds["cuda"])
    print(f"paper: launches {json.dumps(launches)}; {probe.card_rounds} rounds and "
          f"{card_builds} Algorithm 2 plan builds on the card")
    if launches["aggregate"] != probe.card_rounds:
        fail(f"paper: {launches['aggregate']} aggregate launches in {probe.card_rounds} rounds")
    if launches["gram"] != card_builds or launches["l1"] != 0:
        fail(f"paper: {launches['gram']} gram and {launches['l1']} l1 launches for "
             f"{card_builds} Algorithm 2 plan builds")
    if launches["srp"] != srp_sketched or srp_sketched != PAPER_SKETCH_ROUNDS:
        fail(f"paper: {launches['srp']} srp launches, {srp_sketched} in the sketched cell's "
             f"{PAPER_SKETCH_ROUNDS} rounds")
    _round_times("paper", probe)
    print(f"paper: {time.perf_counter() - t0:.3f} s")
    return launches


def _round_times(phase: str, probe) -> None:
    """A ``times:`` line of round ms and plan_build_ms by sweep and scheme."""
    import numpy as np

    for (label, scheme), rows in probe.rounds.items():
        ms = np.array([r[0] for r in rows])
        build = np.array([r[1] for r in rows])
        print(f"times: {phase}[{label}] {scheme}: {len(rows)} rounds, round ms median "
              f"{np.median(ms):.3f} (min {ms.min():.3f}, max {ms.max():.3f}), plan_build_ms median "
              f"{np.median(build):.3f}")


# the ablations phase: Appendix D and the beyond-paper sweeps at the MNIST width
ABL_ROUNDS = 4  # the runners' ROUNDS = 12, cut
ABL_SMALL_ROUNDS = 2
ABL_PLAN_DIMS = (128, WIDTH[0] * WIDTH[1] + WIDTH[1] + WIDTH[1] * WIDTH[2] + WIDTH[2])
# (sweep, axis choices) of the cells run on the card against the CPU at the runners' dim 32
ABL_SMALL = {"D5[fedprox]": ("SWEEP_D5", {"sampler.name": "algorithm2"}),
             "D2[l2]": ("SWEEP_D2", {"sampler.options.measure": "l2"})}
ABL_SPEC = {
    "data": {"name": "by_class_shards",
             "options": {"n_classes": 4, "clients_per_class": 3, "dim": 8,
                         "train_per_client": 30, "test_per_client": 8, "seed": 0}},
    "sampler": {"name": "algorithm2", "m": 4},
    "train": {"n_rounds": 3, "n_local_steps": 2, "batch_size": 10, "hidden": [8], "lr": 0.05},
}


class AblationProbe(PaperProbe):
    """The paper phase's probe, also recording the measure of each
    Algorithm 2 plan build on the card."""

    def __init__(self, torch):
        super().__init__(torch)
        self.measures: list[str] = []

    def _build_plan(self, orig):
        def build_plan(sampler, G):
            plan = orig(sampler, G)
            device = sampler._store.device.type
            self.builds[device].append(plan.r_tokens.copy())
            if device == "cuda":
                self.measures.append(sampler.measure)
            return plan
        return build_plan


def ablation_sweeps(probe, store_root: str) -> None:
    """The ablations and beyond_paper runners' sweeps at dim 784 through
    run_sweep_emit on the card, ABL_ROUNDS rounds a cell."""
    from repro_torch.benchmarks import ablations, beyond_paper
    from repro_torch.benchmarks.common import run_sweep_emit

    print(f"ablations: cuts: data.options.dim {ablations.DIM} -> {WIDTH[0]} (d = "
          f"{ABL_PLAN_DIMS[1]}), train.n_rounds {ablations.ROUNDS} -> {ABL_ROUNDS}; seeds and "
          "every other option as the runners set them")
    for sweep, label, stats in ablations.SWEEPS + beyond_paper.SWEEPS:
        d = _paper_sweep(sweep, ABL_ROUNDS, 1, {"dim": WIDTH[0]})
        probe.label = label
        run_sweep_emit(d, label, stats=stats, device="cuda")
        for cell, hist in _paper_histories(store_root, label.replace("/", "_"), d):
            if len(hist.records) != ABL_ROUNDS or not all(
                    math.isfinite(r.train_loss) for r in hist.records):
                fail(f"ablations[{label}]: cell {cell.overrides} did not run {ABL_ROUNDS} finite rounds")


def ablations_card_vs_cpu(probe) -> None:
    """ABL_SMALL's cells at the runners' dim 32, ABL_SMALL_ROUNDS rounds, on
    the card and on the CPU: equal draws and Algorithm 2 plans, losses to
    atol PAPER_LOSS_ATOL."""
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import ablations
    from repro_torch.fl.sweep import RunStore, SweepSpec, run_sweep, set_by_path

    for label, (attr, choice) in ABL_SMALL.items():
        sweep = _paper_sweep(getattr(ablations, attr), ABL_SMALL_ROUNDS, 1, {})
        sweep["axes"] = {}
        for path, value in choice.items():
            set_by_path(sweep, f"base.{path}", value)
        (cell,) = SweepSpec.from_dict(sweep).cells()
        first = {dev: len(probe.builds[dev]) for dev in probe.builds}
        hists = {}
        for dev in ("cuda", "cpu"):
            probe.label = f"card-vs-cpu[{label}][{dev}]"
            with tempfile.TemporaryDirectory(prefix=f"ablation-{dev}-") as root:
                run_sweep(sweep, root, device=dev)
                hists[dev] = RunStore(root).read_history(cell.cell_id)
        worst = 0.0
        for a, b in zip(hists["cuda"].records, hists["cpu"].records):
            if not np.array_equal(a.agg_weights, b.agg_weights):
                fail(f"ablations[card vs CPU, {label}]: round {a.round}: draws differ")
            worst = max(worst, abs(a.train_loss - b.train_loss))
        plans = {dev: probe.builds[dev][first[dev]:] for dev in probe.builds}
        if not plans["cuda"] or len(plans["cuda"]) != len(plans["cpu"]) or not all(
                np.array_equal(a, b) for a, b in zip(plans["cuda"], plans["cpu"])):
            fail(f"ablations[card vs CPU, {label}]: Algorithm 2's plans differ")
        if worst > PAPER_LOSS_ATOL:
            fail(f"ablations[card vs CPU, {label}]: losses differ by {worst:.3e} > {PAPER_LOSS_ATOL}")
        print(f"ablations[card vs CPU]: {label} at dim 32, {ABL_SMALL_ROUNDS} rounds "
              f"(fedprox_mu {cell.spec.train.fedprox_mu}, measure "
              f"{cell.spec.sampler.options.get('measure', 'arccos')}): equal draws, "
              f"{len(plans['cuda'])} equal plans, max loss diff {worst:.2e}")


def ablations_plan_check() -> None:
    """beyond_paper's host-vs-device plan check on the card at ABL_PLAN_DIMS:
    the f64 numpy measure and the similarity kernel give one plan, bit for bit."""
    import numpy as np

    from repro_torch.benchmarks import beyond_paper
    from repro_torch.benchmarks.common import emit

    for d in ABL_PLAN_DIMS:
        same, host, dev = beyond_paper.plan_check(d=d, device="cuda")
        if not same:
            fail(f"ablations[plan check]: at d = {d} the card's plan differs from the host's: "
                 f"max |Δr| {float(np.abs(host.r - dev.r).max()):.3e}")
        emit(f"beyond/pallas_similarity_plan_identical[d={d}]", 0.0, f"identical={same}")


def _door(*args) -> str:
    """``python -m repro_torch.benchmarks.run`` with ``args`` as a subprocess
    on the card (its default device); its stdout, or a failure."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"ablations[doors]: run {' '.join(a[:40] for a in args)} exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def ablations_doors() -> None:
    """run.py's --list, --spec and --sweep (re-invoked to resume) on the card."""
    import tempfile

    listed = _door("--list")
    keys = [line.split(":")[0] for line in listed.splitlines()]
    if keys != ["samplers", "engines", "datasets", "populations", "clusterers", "sketchers",
                "schedulers", "benchmarks"]:
        fail(f"ablations[doors]: --list printed {keys}")
    print("\n".join(f"ablations[--list]: {line}" for line in listed.splitlines()))
    rows = [r for r in _door("--spec", json.dumps(ABL_SPEC)).splitlines() if r.startswith("spec/")]
    if len(rows) != ABL_SPEC["train"]["n_rounds"] + 1:
        fail(f"ablations[doors]: --spec printed {len(rows)} rows")
    print(f"ablations[--spec]: {rows[-1]}")
    sweep = json.dumps({"base": ABL_SPEC, "axes": {"sampler.name": ["md", "algorithm2"]},
                        "root_seed": 5})
    with tempfile.TemporaryDirectory(prefix="door-sweep-") as store:
        first = _door("--sweep", sweep, "--store", store)
        csvs = {p.name: p.read_text() for p in Path(store).glob("*.csv")}
        again = _door("--sweep", sweep, "--store", store)
        if {p.name: p.read_text() for p in Path(store).glob("*.csv")} != csvs or len(csvs) != 2:
            fail("ablations[doors]: --sweep resumed to other collated CSVs")
    ran = [r for r in first.splitlines() if r.startswith("sweep/")]
    resumed = [r for r in again.splitlines() if r.startswith("sweep/")]
    if len(ran) != 2 or not all("status=ran" in r for r in ran) or not all(
            "status=skipped" in r for r in resumed) or len(resumed) != 2:
        fail(f"ablations[doors]: --sweep rows {ran}, resumed {resumed}")
    print(f"ablations[--sweep]: 2 cells ran, resumed as skipped with identical cells.csv and "
          f"summary.csv: {ran}")


def ablations_quickstart() -> None:
    """examples/torch_quickstart.py on the card, its table printed."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_quickstart",
                                                  ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    mod.main([])
    print(f"ablations[quickstart]: {time.perf_counter() - t0:.3f} s on the card")


def phase_ablations(torch) -> dict:
    """The Appendix D ablations and the beyond-paper sweeps through the
    port's runners on the card, two cells card against CPU, the plan check,
    run.py's doors and the quickstart. Returns the sweeps' launches."""
    import os
    import tempfile

    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    t0 = time.perf_counter()
    saved_store = os.environ.get("BENCH_SWEEP_STORE")
    with tempfile.TemporaryDirectory(prefix="ablations-") as root, AblationProbe(torch) as probe:
        os.environ["BENCH_SWEEP_STORE"] = root  # keep the runners' stores to read the rounds
        try:
            torch.cuda.synchronize()
            sim_ops.launches.update(gram=0, l1=0)
            agg_ops.launches.update(aggregate=0)
            sk_ops.launches.update(srp=0)
            ablation_sweeps(probe, root)
            ablations_card_vs_cpu(probe)
            torch.cuda.synchronize()
            launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches}
        finally:
            if saved_store is None:
                os.environ.pop("BENCH_SWEEP_STORE", None)
            else:
                os.environ["BENCH_SWEEP_STORE"] = saved_store
    by_measure = {m: probe.measures.count(m) for m in sorted(set(probe.measures))}
    print(f"ablations: launches {json.dumps(launches)}; {probe.card_rounds} rounds and "
          f"{len(probe.measures)} Algorithm 2 plan builds on the card, by measure "
          f"{json.dumps(by_measure)}")
    if launches["aggregate"] != probe.card_rounds:
        fail(f"ablations: {launches['aggregate']} aggregate launches in {probe.card_rounds} rounds")
    gram_builds = by_measure.get("arccos", 0) + by_measure.get("l2", 0)
    if launches["gram"] != gram_builds or launches["l1"] != by_measure.get("l1", 0):
        fail(f"ablations: {launches['gram']} gram and {launches['l1']} l1 launches for plan builds "
             f"by measure {by_measure}")
    if launches["srp"] != 0:
        fail(f"ablations: {launches['srp']} srp launches in unsketched sweeps")
    _round_times("ablations", probe)
    ablations_plan_check()
    ablations_doors()
    ablations_quickstart()
    print(f"ablations: {time.perf_counter() - t0:.3f} s")
    return launches


# the zoo phase: the scheme race and client churn at the paper's MNIST width
ZOO_ROUNDS, ZOO_SEEDS, ZOO_SKETCH_ROUNDS, ZOO_SMALL_ROUNDS = 5, 2, 3, 2
ZOO_B1 = ("algorithm2", "stratified", "dp_stratified", "hybrid")  # plan builds that run B1
ZOO_Q_RTOL = 1e-6  # importance's q: f32 norms summed in another order on the card
ZOO_POISSON = {"name": "poisson", "seed": 1, "options": {"join_rate": 0.3, "leave_rate": 0.3}}
# a client missing from the last round scores 0.9 < 0.95, so from round 1 on
# algorithm2's rebuilds cluster only the clients seen in the round before
ZOO_TRACK = {"track_availability": True, "avail_threshold": 0.95}
ZOO_CHURN = {  # label: (scheme, population section, track availability)
    "algorithm2+poisson": ("algorithm2", ZOO_POISSON, True),
    "stratified+poisson": ("stratified", ZOO_POISSON, True),
    "md+dropout": ("md", {"name": "dropout", "options": {"rate": 0.2}}, False),
}


class ZooProbe(PaperProbe):
    """The paper phase's probe, widened to the zoo: each round's draw with
    its availability mask, and every plan build of a store-backed scheme
    by (label, scheme, device) with the Gram launches it made and whether
    the tracker restricted it, and the wall ms of each DP release on the
    card by label. Patches for the ``with`` block only."""

    def __init__(self, torch):
        super().__init__(torch)
        from repro_torch.core.samplers.schemes import (
            DPStratifiedSampler,
            HybridSampler,
            ImportanceSampler,
            StratifiedSampler,
        )
        from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
        from repro_torch.fl.server import FederatedServer

        self.draws: dict[tuple[str, str, str], list] = {}
        self.zoo_builds: dict[tuple[str, str, str], list] = {}
        self.release_ms: dict[str, list[float]] = {}
        self._targets = [(FederatedServer, "run_round", self._run_round),
                         (FederatedServer, "_phase_draw", self._phase_draw),
                         (DPStratifiedSampler, "_observe_snapshot", self._release)]
        self._targets += [(cls, "_build_plan", self._build_plan) for cls in (
            Algorithm2Sampler, StratifiedSampler, HybridSampler, ImportanceSampler)]

    def _key(self, sampler, device) -> tuple[str, str, str]:
        return (self.label, self.scheme_of[type(sampler)], "cuda" if self._card(device) else "cpu")

    def _phase_draw(self, orig):
        def phase_draw(srv, t, available):
            out = orig(srv, t, available)
            self.draws.setdefault(self._key(srv.sampler, srv.device), []).append(
                (t, None if available is None else available.copy(), out[0].clients.copy()))
            return out
        return phase_draw

    def _build_plan(self, orig):
        from repro_torch.kernels.similarity import ops as sim_ops

        def build_plan(sampler, G):
            gram = sim_ops.launches["gram"]
            restricted = sampler._cluster_mask() is not None
            plan = orig(sampler, G)
            self.zoo_builds.setdefault(self._key(sampler, sampler._store.device), []).append(
                (plan, sim_ops.launches["gram"] - gram, restricted))
            return plan
        return build_plan

    def _release(self, orig):
        def release(sampler):
            t0 = time.perf_counter()
            out = orig(sampler)
            if out.device.type == "cuda":
                self.torch.cuda.synchronize()
                self.release_ms.setdefault(self.label, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return release


def _zoo_histories(root: str, sweep: dict) -> list:
    from repro_torch.fl.sweep import RunStore, SweepSpec

    return [(c, RunStore(root).read_history(c.cell_id)) for c in SweepSpec.from_dict(sweep).cells()]


def zoo_race(probe, root: str) -> None:
    """The port's scheme_race grid at the paper's MNIST width on the card."""
    from repro_torch.benchmarks import scheme_race

    sweep = _paper_sweep(scheme_race.race_sweep(smoke=False), ZOO_ROUNDS, ZOO_SEEDS, PAPER_DATA)
    probe.label = "race"
    scheme_race.run_race(sweep, root, device="cuda")
    for cell, hist in _zoo_histories(root, sweep):
        name = cell.spec.sampler.name
        if len(hist.records) != ZOO_ROUNDS or not all(
                math.isfinite(r.train_loss) and 0.0 <= r.test_acc <= 1.0 for r in hist.records):
            fail(f"zoo[race]: {name} seed {cell.seed_index} did not run {ZOO_ROUNDS} finite rounds")


def zoo_churn(probe) -> None:
    """Churned runs through build_experiment; the draws held to the
    population's masks recomputed on the host."""
    import numpy as np

    from repro_torch.benchmarks import scheme_race
    from repro_torch.fl.experiment import build_experiment
    from repro_torch.fl.population import build_population

    base = _paper_sweep(scheme_race.race_sweep(smoke=False), ZOO_ROUNDS, 1, PAPER_DATA)["base"]
    for label, (scheme, population, tracked) in ZOO_CHURN.items():
        spec = {**base, "sampler": {"name": scheme, "m": 10}, "population": population}
        if tracked:
            spec["scheduler"] = ZOO_TRACK
        probe.label = f"churn[{label}]"
        with build_experiment(spec, device="cuda") as srv:
            hist = srv.run()
            pop = build_population(population, srv.dataset.n_clients)
        draws = probe.draws[(probe.label, scheme, "cuda")]
        for rec, (t, avail, clients) in zip(hist.records, draws, strict=True):
            want = pop.available_mask(t)
            if not np.array_equal(avail, want) or not want[clients].all():
                fail(f"zoo[{label}]: round {t} drew a client the population had offline")
            dropped = int(pop.dropout_mask(t, np.unique(clients)).sum())
            if (rec.n_available, rec.n_dropped) != (int(want.sum()), dropped):
                fail(f"zoo[{label}]: round {t} n_available/n_dropped {rec.n_available}/"
                     f"{rec.n_dropped}, the host's masks {int(want.sum())}/{dropped}")
            if not math.isfinite(rec.train_loss) or (tracked and not 0.0 <= rec.avail_score_min <= 1.0):
                fail(f"zoo[{label}]: round {t} loss or presence score out of range")
        restricted = ""
        if scheme == "algorithm2":  # the scheme whose rebuilds honour the tracker
            builds = probe.zoo_builds[(probe.label, scheme, "cuda")]
            n = sum(b[2] for b in builds)
            if n == 0:
                fail(f"zoo[{label}]: no rebuild was restricted to the tracker's active clients")
            restricted = f", {n} of {len(builds)} rebuilds restricted to the active clients"
        print(f"zoo[{label}]: n_available {[r.n_available for r in hist.records]}, n_dropped "
              f"{[r.n_dropped for r in hist.records]}, avail_score_min "
              f"{[round(r.avail_score_min, 4) for r in hist.records]}, final loss "
              f"{hist.records[-1].train_loss:.4f}; every draw available, counts equal the "
              f"host's masks{restricted}")


def zoo_sketched(probe) -> None:
    """One stratified cell with the SRP sketch to d' = 64, through the spec."""
    import tempfile

    from repro_torch.benchmarks import scheme_race
    from repro_torch.fl.sweep import run_sweep, set_by_path

    sweep = _paper_sweep(scheme_race.race_sweep(smoke=False), ZOO_SKETCH_ROUNDS, 1, PAPER_DATA)
    sweep["axes"] = {}
    set_by_path(sweep, "base.sampler", {"name": "stratified", "m": 10})
    set_by_path(sweep, "base.planner", {"sketch": "srp", "sketch_dim": D_PRIME})
    probe.label = "sketched"
    with tempfile.TemporaryDirectory(prefix="zoo-sketched-") as root:
        run_sweep(sweep, root, device="cuda")
        ((_, hist),) = _zoo_histories(root, sweep)
    if len(hist.records) != ZOO_SKETCH_ROUNDS:
        fail(f"zoo[sketched]: {len(hist.records)} rounds of {ZOO_SKETCH_ROUNDS}")
    print(f"zoo[sketched]: stratified, d' = {D_PRIME}: plan_build_ms "
          f"{[round(r.plan_build_ms, 3) for r in hist.records]}, final loss "
          f"{hist.records[-1].train_loss:.4f}")


def zoo_card_vs_cpu(probe) -> None:
    """The zoo and a churned algorithm2 at dim 32 on the card and the CPU:
    equal draws, plans and losses (importance: q within ZOO_Q_RTOL). The
    churned run takes one round more, so that its last rebuild is
    restricted to the tracker's active clients."""
    import copy
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import scheme_race
    from repro_torch.fl.sweep import run_sweep

    sweep = _paper_sweep(scheme_race.race_sweep(smoke=False), ZOO_SMALL_ROUNDS, 1, {})
    scheme, population, _ = ZOO_CHURN["algorithm2+poisson"]
    sweep["axes"] = {"sampler.name": ["stratified", "importance", "dp_stratified", "hybrid"]}
    churned = copy.deepcopy({**sweep, "axes": {"sampler.name": [scheme]}})
    churned["base"].update(population=population, scheduler=ZOO_TRACK)
    churned["base"]["train"]["n_rounds"] = ZOO_SMALL_ROUNDS + 1
    losses = {}
    for dev in ("cuda", "cpu"):
        probe.label = f"card-vs-cpu[{dev}]"
        for sw in (sweep, churned):
            with tempfile.TemporaryDirectory(prefix=f"zoo-{dev}-") as root:
                run_sweep(sw, root, device=dev)
                for cell, hist in _zoo_histories(root, sw):
                    losses[(dev, cell.spec.sampler.name)] = [r.train_loss for r in hist.records]
    worst_loss, worst_q, n_plans, n_restricted = 0.0, 0.0, 0, 0
    for name in ("stratified", "importance", "dp_stratified", "hybrid", "algorithm2"):
        card, cpu = (("card-vs-cpu[cuda]", name, "cuda"), ("card-vs-cpu[cpu]", name, "cpu"))
        for (ta, _, ca), (tb, _, cb) in zip(probe.draws[card], probe.draws[cpu], strict=True):
            if ta != tb or not np.array_equal(ca, cb):
                fail(f"zoo[card vs CPU]: {name} round {ta}: draws differ")
        for (pa, _, ra), (pb, _, rb) in zip(probe.zoo_builds[card], probe.zoo_builds[cpu], strict=True):
            if name == "importance":
                worst_q = max(worst_q, float(np.max(np.abs(pa.r - pb.r) / pb.r)))
            elif ra != rb or not (np.array_equal(pa.r_tokens, pb.r_tokens)
                                  and np.array_equal(pa.cluster_of, pb.cluster_of)):
                fail(f"zoo[card vs CPU]: {name}: plans differ")
            n_plans += 1
            n_restricted += ra
        worst_loss = max(worst_loss, float(np.max(np.abs(
            np.subtract(losses[("cuda", name)], losses[("cpu", name)])))))
    if worst_q > ZOO_Q_RTOL:
        fail(f"zoo[card vs CPU]: importance's q differs by {worst_q:.3e} relative > {ZOO_Q_RTOL}")
    if worst_loss > PAPER_LOSS_ATOL:
        fail(f"zoo[card vs CPU]: losses differ by {worst_loss:.3e} > {PAPER_LOSS_ATOL}")
    if n_restricted == 0:
        fail("zoo[card vs CPU]: no plan build was restricted to the tracker's active clients")
    print(f"zoo[card vs CPU]: dim 32, {ZOO_SMALL_ROUNDS} rounds, the zoo and a churned algorithm2 "
          f"({ZOO_SMALL_ROUNDS + 1}): equal draws, {n_plans} equal plans ({n_restricted} restricted "
          f"to the active clients; importance's q within {worst_q:.2e} relative), max loss diff "
          f"{worst_loss:.2e}")


def phase_zoo(torch) -> dict:
    """The scheme race, churned runs, a sketched stratified cell, the zoo
    on the card against the CPU and the md-vs-importance parity gate, on
    the card. Returns the launches."""
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import scheme_race
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="zoo-") as root, ZooProbe(torch) as probe:
        torch.cuda.synchronize()
        sim_ops.launches.update(gram=0, l1=0)
        agg_ops.launches.update(aggregate=0)
        sk_ops.launches.update(srp=0)
        zoo_race(probe, root)
        zoo_churn(probe)
        srp_before = sk_ops.launches["srp"]
        zoo_sketched(probe)
        srp_sketched = sk_ops.launches["srp"] - srp_before
        zoo_card_vs_cpu(probe)
        probe.label = "parity"
        try:
            scheme_race.check_md_importance_parity(device="cuda")
        except SystemExit as e:
            fail(f"zoo[parity]: {e}")
        torch.cuda.synchronize()
        launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches}
    builds = {}  # scheme -> (plan builds on the card, gram launches they made)
    for (_, scheme, dev), rows in probe.zoo_builds.items():
        if dev == "cuda":
            n, g = builds.get(scheme, (0, 0))
            builds[scheme] = (n + len(rows), g + sum(r[1] for r in rows))
    b1_builds = sum(builds[s][0] for s in ZOO_B1)
    print(f"zoo: launches {json.dumps(launches)}; {probe.card_rounds} rounds on the card; plan "
          f"builds on the card (gram launches in them): "
          + ", ".join(f"{s} {n} ({g})" for s, (n, g) in sorted(builds.items())))
    if launches["aggregate"] != probe.card_rounds:
        fail(f"zoo: {launches['aggregate']} aggregate launches in {probe.card_rounds} rounds")
    if launches["gram"] != b1_builds or launches["l1"] != 0:
        fail(f"zoo: {launches['gram']} gram and {launches['l1']} l1 launches for {b1_builds} "
             f"plan builds of {', '.join(ZOO_B1)}")
    for scheme, (n, g) in builds.items():
        want = n if scheme in ZOO_B1 else 0
        if g != want or (scheme in ZOO_B1 and n == 0):
            fail(f"zoo: {scheme}'s {n} plan builds on the card made {g} gram launches, not {want}")
    if launches["srp"] != srp_sketched or srp_sketched != ZOO_SKETCH_ROUNDS:
        fail(f"zoo: {launches['srp']} srp launches, {srp_sketched} in the sketched cell's "
             f"{ZOO_SKETCH_ROUNDS} rounds")
    for (label, scheme), rows in probe.rounds.items():
        ms = np.array([r[0] for r in rows])
        build = np.array([r[1] for r in rows])
        print(f"times: zoo[{label}] {scheme}: {len(rows)} rounds, round ms median "
              f"{np.median(ms):.3f} (min {ms.min():.3f}, max {ms.max():.3f}), plan_build_ms median "
              f"{np.median(build):.3f}")
    for label, rows in probe.release_ms.items():
        ms = np.array(rows)
        print(f"times: zoo[{label}] dp_stratified release (clip + noise on the host, back to the "
              f"card): {len(rows)}, ms median {np.median(ms):.3f} (min {ms.min():.3f}, "
              f"max {ms.max():.3f})")
    print(f"zoo: {time.perf_counter() - t0:.3f} s")
    return launches


# the sched phase: round schedulers, overselection, checkpoint/resume and
# the FL service at the paper's MNIST width
SCHED_ROUNDS, SCHED_KILL, SCHED_CONTINUE = 6, 3, 2
SCHED_DEADLINE = {"name": "deadline", "options": {"straggle_frac": 0.3, "slow_factor": 2.0,
                                                  "harvest_discount": 0.5}, **ZOO_TRACK}
SCHED_OVERSELECT = {"name": "overselect", "options": {"beta": 0.5}}
SCHED_MASS_ATOL = 1e-12  # realized weights + stale weight of an overselected round
SCHED_SERVICE_STOP = 3  # status lines before the service gets its SIGTERM
SERVICE_DEVICE = "cuda"


class SchedProbe(ZooProbe):
    """The zoo probe, widened to the sched phase: each round's whole draw
    (the thinned ``SampleResult``), each store-backed observation with its
    client ids, and each deadline harvest scatter with its row count, by
    label."""

    def __init__(self, torch):
        super().__init__(torch)
        from repro_torch.core.samplers.store_backed import StoreBackedSampler
        from repro_torch.fl.scheduler import DeadlineScheduler

        self.t = -1
        self.results: dict[str, list] = {}
        self.observed: dict[str, list] = {}
        self.harvests: dict[str, list] = {}
        self._targets += [(StoreBackedSampler, "observe_updates", self._observe),
                          (DeadlineScheduler, "begin_round", self._begin_round)]

    def _run_round(self, orig):
        timed = super()._run_round(orig)

        def run_round(srv, t):
            self.t = t
            return timed(srv, t)
        return run_round

    def _phase_draw(self, orig):
        drawn = super()._phase_draw(orig)

        def phase_draw(srv, t, available):
            out = drawn(srv, t, available)
            self.results.setdefault(self.label, []).append(
                (t, None if available is None else available.copy(), out[0]))
            return out
        return phase_draw

    def _observe(self, orig):
        import numpy as np

        def observe(sampler, ids, updates):
            self.observed.setdefault(self.label, []).append(
                (self.t, np.array(ids), self._card(sampler._store.device)))
            return orig(sampler, ids, updates)
        return observe

    def _begin_round(self, orig):
        def begin_round(sched, t, sampler):
            n = orig(sched, t, sampler)
            store = getattr(sampler, "gradient_store", None)
            self.harvests.setdefault(self.label, []).append(
                (t, n, store is not None and self._card(store.device)))
            return n
        return begin_round


def _sched_base(data: dict) -> dict:
    """The race's base spec at ``data``'s options: by_class_shards with 100
    clients, PAPER_TRAIN, algorithm2 (Ward, arccos, sync planner), m = 10."""
    from repro_torch.benchmarks import scheme_race

    base = _paper_sweep(scheme_race.race_sweep(smoke=False), SCHED_ROUNDS, 1, data)["base"]
    return {**base, "sampler": {"name": "algorithm2", "m": 10}}


def _sched_state(srv) -> tuple:
    """(records with wall-clock telemetry normalized, params, store) — the
    bits a kill and resume must reproduce."""
    recs = json.loads(srv.history.to_json())
    for r in recs:
        r["plan_build_ms"] = -1.0
    params = {k: v.detach().cpu().numpy().copy() for k, v in srv.params.items()}
    store = getattr(srv.sampler, "gradient_store", None)
    return recs, params, None if store is None else store.asnumpy().copy()


def _same_state(a, b) -> bool:
    import numpy as np

    return (a[0] == b[0] and a[1].keys() == b[1].keys()
            and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
            and ((a[2] is None and b[2] is None) or np.array_equal(a[2], b[2])))


def _sched_run(probe, label, spec, ds):
    """One run on the card through build_experiment; returns the finished
    server's state and the server (closed)."""
    from repro_torch.fl.experiment import build_experiment

    probe.label = label
    with build_experiment(spec, dataset=ds, device="cuda") as srv:
        srv.run()
    return _sched_state(srv), srv


def sched_sync_parity(probe, base, ds) -> None:
    """An explicit SyncScheduler against scheduler=None, bit for bit."""
    from repro_torch.fl.experiment import build_experiment
    from repro_torch.fl.scheduler import SyncScheduler

    none, _ = _sched_run(probe, "none", base, ds)
    probe.label = "sync"
    with build_experiment(base, dataset=ds, device="cuda") as srv:
        srv.scheduler = SyncScheduler(srv.dataset.n_clients, srv.sampler.m)
        srv.run()
    if not _same_state(none, _sched_state(srv)):
        fail("sched[sync]: an explicit SyncScheduler is not bit-identical to scheduler=None")
    print(f"sched[sync]: {SCHED_ROUNDS} rounds with an explicit SyncScheduler bit-identical to "
          "scheduler=None (params, agg_weights, losses, plan versions)")


def sched_deadline(probe, spec, ds, label):
    """The deadline run under Poisson churn with the tracker, gated against
    the latency model and the population's masks recomputed on the host;
    then the same run again, which must be bit-identical."""
    import numpy as np

    from repro_torch.fl.population import build_population
    from repro_torch.fl.scheduler import LatencyModel

    state, srv = _sched_run(probe, label, spec, ds)
    hist = srv.history.records
    opts = spec["scheduler"]["options"]
    model = LatencyModel(ds.n_clients, seed=spec["scheduler"].get("seed", 0),
                         straggle_frac=opts["straggle_frac"], slow_factor=opts["slow_factor"])
    pop = build_population(spec["population"], ds.n_clients)
    observed = {t: ids for t, ids, _ in probe.observed[label]}
    late_before = 0
    for rec, (t, avail, res) in zip(hist, probe.results[label], strict=True):
        distinct = np.unique(res.clients)
        want_avail = pop.available_mask(t)
        if not np.array_equal(avail, want_avail) or not want_avail[distinct].all():
            fail(f"sched[{label}]: round {t} drew a client the population had offline")
        dropped = pop.dropout_mask(t, distinct)
        late = (model.latencies(t)[distinct] > 1.0) & ~dropped
        if rec.n_late != int(late.sum()) or rec.n_dropped != int(dropped.sum()):
            fail(f"sched[{label}]: round {t} n_late/n_dropped {rec.n_late}/{rec.n_dropped}, the "
                 f"host's latency and dropout masks {int(late.sum())}/{int(dropped.sum())}")
        if set(distinct[late]) & set(observed.get(t, [])):
            fail(f"sched[{label}]: round {t} observed a late client's update")
        if rec.n_harvested != late_before:
            fail(f"sched[{label}]: round {t} harvested {rec.n_harvested}, the round before had "
                 f"{late_before} late")
        late_before = rec.n_late
    if sum(r.n_harvested for r in hist) == 0:
        fail(f"sched[{label}]: no round harvested a late update")
    again, _ = _sched_run(probe, f"{label}[again]", spec, ds)
    if not _same_state(state, again):
        fail(f"sched[{label}]: two uninterrupted runs differ (params, records or store)")
    print(f"sched[{label}]: n_late {[r.n_late for r in hist]}, n_harvested "
          f"{[r.n_harvested for r in hist]}, n_available {[r.n_available for r in hist]}, final "
          f"loss {hist[-1].train_loss:.4f}; n_late equals the host's latency mask over the drawn, "
          f"available, not-dropped clients, no late update observed in its round; a second run "
          "bit-identical")
    return state


def sched_kill_resume(probe, spec, ds, label, full, torch) -> dict:
    """A bundle at round SCHED_KILL with a non-empty harvest buffer, resumed
    by a fresh server: bit-identical to the uninterrupted run, no Gram
    launch at the restore. Returns the write/resume times and bytes."""
    import os
    import tempfile

    from repro_torch.fl.experiment import build_experiment
    from repro_torch.kernels.similarity import ops as sim_ops

    with tempfile.TemporaryDirectory(prefix="sched-") as root:
        path = os.path.join(root, "ck.npz")
        probe.label = f"{label}[kill]"
        with build_experiment(spec, dataset=ds, device="cuda", checkpoint_path=path) as srv:
            for t in range(SCHED_KILL):
                srv.run_round(t)
            if srv.scheduler._harvest_ids.size == 0:
                fail(f"sched[{label}]: the bundle at round {SCHED_KILL} holds no harvest")
            harvest = int(srv.scheduler._harvest_ids.size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.checkpoint()
            write_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(path)
        probe.label = f"{label}[resume]"
        with build_experiment(spec, dataset=ds, device="cuda", checkpoint_path=path) as srv:
            torch.cuda.synchronize()
            gram = sim_ops.launches["gram"]
            builds = len(probe.zoo_builds.get(probe._key(srv.sampler, srv.device), []))
            t0 = time.perf_counter()
            start = srv.resume()
            torch.cuda.synchronize()
            resume_ms = (time.perf_counter() - t0) * 1e3
            restore_gram = sim_ops.launches["gram"] - gram
            restore_builds = len(probe.zoo_builds.get(probe._key(srv.sampler, srv.device), [])) - builds
            if start != SCHED_KILL or restore_gram or restore_builds:
                fail(f"sched[{label}]: resume at {start}, {restore_gram} Gram launches and "
                     f"{restore_builds} plan builds at the restore")
            if not probe._card(srv.params["w0"].device):
                fail(f"sched[{label}]: restored params on {srv.params['w0'].device}")
            srv.run()
        resumed = _sched_state(srv)
    if not _same_state(full, resumed):
        fail(f"sched[{label}]: the resumed run is not bit-identical to the uninterrupted one")
    print(f"sched[{label}]: bundle at round {SCHED_KILL} ({harvest} harvested rows pending, "
          f"{nbytes} B), resumed for rounds {SCHED_KILL}-{SCHED_ROUNDS - 1} bit-identical to the "
          "uninterrupted run (params, history, store); no plan build or Gram launch at the restore")
    d = sum(v.numel() for v in srv.params.values())
    return {"write_ms": write_ms, "bytes": nbytes, "resume_ms": resume_ms, "d": d}


def sched_overselect(probe, base, ds) -> None:
    """Overselection at beta 0.5: at most m draws aggregated, the surplus
    reported as n_late, the mass whole; importance refuses it."""
    import math as _math

    from repro_torch.fl.experiment import build_experiment

    m, beta = base["sampler"]["m"], SCHED_OVERSELECT["options"]["beta"]
    surplus = max(1, _math.ceil(beta * m))
    spec = {**base, "scheduler": SCHED_OVERSELECT}
    _, srv = _sched_run(probe, "overselect", spec, ds)
    worst = 0.0
    for rec, (t, _, res) in zip(srv.history.records, probe.results["overselect"], strict=True):
        if res.clients.size > m or rec.n_late != m + surplus - res.clients.size:
            fail(f"sched[overselect]: round {t} kept {res.clients.size} draws with n_late "
                 f"{rec.n_late}; drew {m + surplus}, aggregates at most {m}")
        worst = max(worst, abs(float(res.agg_weights.sum()) + res.stale_weight - 1.0))
    if worst > SCHED_MASS_ATOL:
        fail(f"sched[overselect]: realized + stale weight off 1 by {worst:.3e}")
    probe.label = "overselect[importance]"
    with build_experiment({**spec, "sampler": {"name": "importance", "m": m}}, dataset=ds,
                          device="cuda") as imp:
        try:
            imp.run_round(0)
        except NotImplementedError:
            pass
        else:
            fail("sched[overselect]: importance accepted overselection")
    print(f"sched[overselect]: beta {beta}: {m + surplus} draws, {m} aggregated and n_late "
          f"{[r.n_late for r in srv.history.records]} every round; realized + stale weight within "
          f"{worst:.2e} of 1; importance raises NotImplementedError")


def sched_bundle_on_cpu(probe, torch) -> None:
    """At dim 32: a bundle written on the card resumes on a CPU server, and
    the next rounds' draws and plans equal the card's own continuation."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.fl.experiment import build_dataset, build_experiment

    spec = {**_sched_base({}), "population": ZOO_POISSON, "scheduler": SCHED_DEADLINE}
    spec["train"] = {**spec["train"], "n_rounds": SCHED_KILL + SCHED_CONTINUE}
    ds = build_dataset(spec["data"])
    with tempfile.TemporaryDirectory(prefix="sched-cpu-") as root:
        path = os.path.join(root, "ck.npz")
        probe.label = "bundle[card]"
        with build_experiment(spec, dataset=ds, device="cuda", checkpoint_path=path) as card:
            for t in range(SCHED_KILL):
                card.run_round(t)
            card.checkpoint()
            n_builds = len(probe.zoo_builds[probe._key(card.sampler, card.device)])
            for t in range(SCHED_KILL, SCHED_KILL + SCHED_CONTINUE):
                card.run_round(t)
        probe.label = "bundle[cpu]"
        with build_experiment(spec, dataset=ds, device="cpu", checkpoint_path=path) as cpu:
            cpu.resume()
            if cpu.params["w0"].device.type != "cpu":
                fail("sched[bundle]: a CPU server restored params off the CPU")
            cpu.run()
    card_key, cpu_key = ("bundle[card]", "algorithm2", "cuda"), ("bundle[cpu]", "algorithm2", "cpu")
    card_draws = probe.draws[card_key][SCHED_KILL:]
    for (ta, _, ca), (tb, _, cb) in zip(card_draws, probe.draws[cpu_key], strict=True):
        if ta != tb or not np.array_equal(ca, cb):
            fail(f"sched[bundle]: round {ta}: the CPU's draws differ from the card's")
    card_plans = probe.zoo_builds[card_key][n_builds:]
    cpu_plans = probe.zoo_builds[cpu_key][1:]  # after the CPU server's cold start
    if len(card_plans) != SCHED_CONTINUE:
        fail(f"sched[bundle]: {len(card_plans)} card plan builds after the bundle")
    for (pa, _, _), (pb, _, _) in zip(card_plans, cpu_plans, strict=True):
        if not (np.array_equal(pa.r_tokens, pb.r_tokens) and np.array_equal(pa.cluster_of, pb.cluster_of)):
            fail("sched[bundle]: the CPU's plans differ from the card's")
    worst = max((abs(a.train_loss - b.train_loss) for a, b in zip(
        card.history.records[SCHED_KILL:], cpu.history.records[SCHED_KILL:], strict=True)
        if not (math.isnan(a.train_loss) and math.isnan(b.train_loss))), default=0.0)
    if not worst <= PAPER_LOSS_ATOL:
        fail(f"sched[bundle]: losses differ by {worst:.3e} > {PAPER_LOSS_ATOL}")
    print(f"sched[bundle]: dim 32, a card bundle at round {SCHED_KILL} resumed on the CPU: "
          f"{SCHED_CONTINUE} rounds of equal draws and {len(card_plans)} equal plans, max loss diff "
          f"{worst:.2e}")


def sched_service(spec, want) -> None:
    """``python3 -m repro_torch.launch.fl_service`` as a process: SIGTERM
    after its SCHED_SERVICE_STOP-th status line, exit 0, --resume to the
    end; the history contiguous and its agg_weights equal to ``want``'s."""
    import os
    import signal
    import tempfile

    import numpy as np

    from repro_torch.fl.history import History

    spec = {**spec, "train": {**spec["train"], "checkpoint_every": 2}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sched-svc-") as root:
        hist_path = os.path.join(root, "history.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.fl_service", "--device", SERVICE_DEVICE,
               "--spec", json.dumps(spec), "--checkpoint", os.path.join(root, "svc.npz"),
               "--history", hist_path]
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        outs, cuts = [], []
        for extra in (["--throttle", "0.5"], ["--resume"]):
            proc = subprocess.Popen(cmd + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env)
            try:
                lines = []
                if "--resume" not in extra:
                    for line in proc.stdout:
                        lines.append(line)
                        if sum(ln.startswith("[round ") for ln in lines) == SCHED_SERVICE_STOP:
                            proc.send_signal(signal.SIGTERM)
                            break
                out, err = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            outs.append("".join(lines) + out)
            if proc.returncode != 0:
                fail(f"sched[service]: exit {proc.returncode} ({' '.join(extra)}): {err[-2000:]}")
            cuts.append(len(History.from_json(open(hist_path).read()).records))
        got = History.from_json(open(hist_path).read()).records
    if "stop requested" not in outs[0] or f"resuming at round {cuts[0]}" not in outs[1]:
        fail(f"sched[service]: no clean stop and resume in the logs: {outs}")
    if [r.round for r in got] != list(range(SCHED_ROUNDS)) or not SCHED_SERVICE_STOP <= cuts[0] < SCHED_ROUNDS:
        fail(f"sched[service]: history rounds {[r.round for r in got]} after a stop at {cuts[0]}")
    for g, w in zip(got, want, strict=True):
        if not np.array_equal(np.asarray(g.agg_weights), np.asarray(w["agg_weights"])):
            fail(f"sched[service]: round {g.round}'s agg_weights differ from the in-process run")
    print(f"sched[service]: SIGTERM after {SCHED_SERVICE_STOP} status lines, exit 0 with "
          f"{cuts[0]} rounds checkpointed; --resume ran to round {SCHED_ROUNDS - 1}, exit 0; history "
          f"contiguous, agg_weights equal to the in-process run ({time.perf_counter() - t0:.3f} s)")


def phase_sched(torch) -> dict:
    """Round schedulers, overselection, checkpoint/resume and the service
    at the paper's MNIST width on the card. Returns the launches."""
    import numpy as np

    from repro_torch.fl.experiment import build_dataset
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    t0 = time.perf_counter()
    base = _sched_base(PAPER_DATA)
    ds = build_dataset(base["data"])
    deadline = {**base, "population": ZOO_POISSON, "scheduler": SCHED_DEADLINE}
    sketched = {**deadline, "planner": {"sketch": "srp", "sketch_dim": D_PRIME}}
    with SchedProbe(torch) as probe:
        torch.cuda.synchronize()
        sim_ops.launches.update(gram=0, l1=0)
        agg_ops.launches.update(aggregate=0)
        sk_ops.launches.update(srp=0)
        sched_sync_parity(probe, base, ds)
        full = sched_deadline(probe, deadline, ds, "deadline")
        ck = sched_kill_resume(probe, deadline, ds, "deadline", full, torch)
        full_srp = sched_deadline(probe, sketched, ds, "deadline[srp]")
        sched_kill_resume(probe, sketched, ds, "deadline[srp]", full_srp, torch)
        sched_overselect(probe, base, ds)
        sched_bundle_on_cpu(probe, torch)
        torch.cuda.synchronize()
        launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches}
    sched_service(deadline, full[0])
    builds = sum(len(rows) for (_, scheme, dev), rows in probe.zoo_builds.items()
                 if dev == "cuda" and scheme == "algorithm2")
    srp_labels = [k for k in probe.observed if k.startswith("deadline[srp]")]
    srp_want = (sum(card and ids.size > 0 for k in srp_labels for _, ids, card in probe.observed[k])
                + sum(card and n > 0 for k in srp_labels for _, n, card in probe.harvests.get(k, [])))
    print(f"sched: launches {json.dumps(launches)}; predicted: aggregate {probe.card_rounds} (card "
          f"rounds), gram {builds} (Algorithm 2 plan builds on the card, none at a restore), srp "
          f"{srp_want} (sketched observe calls and harvest scatters with rows)")
    if launches["aggregate"] != probe.card_rounds:
        fail(f"sched: {launches['aggregate']} aggregate launches in {probe.card_rounds} card rounds")
    if launches["gram"] != builds or launches["l1"] != 0:
        fail(f"sched: {launches['gram']} gram and {launches['l1']} l1 launches for {builds} "
             "Algorithm 2 plan builds on the card")
    if launches["srp"] != srp_want:
        fail(f"sched: {launches['srp']} srp launches, {srp_want} sketched observe calls and "
             "harvest scatters with rows")
    for (label, scheme), rows in probe.rounds.items():
        ms = np.array([r[0] for r in rows])
        build = np.array([r[1] for r in rows])
        print(f"times: sched[{label}] {scheme}: {len(rows)} rounds, round ms median "
              f"{np.median(ms):.3f} (min {ms.min():.3f}, max {ms.max():.3f}), plan_build_ms median "
              f"{np.median(build):.3f}")
    print(f"times: sched checkpoint at ({ds.n_clients}, {ck['d']}): "
          f"write ms {ck['write_ms']:.3f}, bundle bytes {ck['bytes']}, resume ms {ck['resume_ms']:.3f}")
    print(f"sched: {time.perf_counter() - t0:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# train: the LM trainer at qwen3-0.6b's full width and depth
# ---------------------------------------------------------------------------
TRAIN = dict(arch="qwen3-0.6b", batch=4, seq=1024, steps=10, lr=3e-3)
TRAIN_SMALL = dict(steps=5, batch=4, seq=64, lr=3e-3)  # the reduced config, card against CPU
# card against CPU in f32: losses and gradient norms of 5 AdamW steps (the
# slice phase's loss tolerance; the GEMMs sum in other orders)
TRAIN_SMALL_ATOL = 1e-4
# (B, S, H, KV, hd): small inputs of the flash route's gradient gate, GQA,
# ragged S, and the train shape's heads
FLASH_GRAD_SHAPES = [(2, 77, 4, 2, 64), (1, 130, 16, 8, 128)]
FLASH_TRAIN = (4, 1024, 16, 8, 128)  # qwen3-0.6b's attention at the train phase's batch
LM_P = 596_049_920  # qwen3-0.6b's parameters: the flat rows of B2 and B3 in fl_lm
# B3 at (8, LM_P): X is zero outside these column windows (start, width): the
# first, one off the 64-column tiles, the middle and the last, which ends at
# column LM_P; rows 4-7 of each start past flat element 2^31
LM_WINDOWS = [(0, 8192), (123_456_789, 5_000), (LM_P // 2 - 4096, 8192), (LM_P - 8192, 8192)]
LM_AGG_BLOCK = 1 << 26  # B2 against its plain version, column block by column block
# B3's library time at (8, P): torch.matmul(X[:, w], S_w) over windows of
# this many columns covering all P, each S_w (1 GiB f32) made untimed
LM_LIB_WINDOW = 1 << 22
FL_LM = dict(arch="qwen3-0.6b", rounds=3)  # FLLMConfig's defaults otherwise
FL_LM_SKETCH = {"mode": "sync", "sketch": "srp", "sketch_dim": D_PRIME}
# card against CPU on examples/federated_lm.py's narrow reduced qwen3 (f32)
FL_SMALL_NARROW = dict(d_model=64, vocab_size=256, n_heads=2, n_kv_heads=2, head_dim=32)
FL_SMALL = dict(n_clients=12, m=4, n_rounds=3, n_local_steps=2, local_batch=2, seq_len=16, lr=0.1)
FL_SMALL_SIZES = [300, 120, 800, 450, 90, 600, 210, 1000, 75, 330, 520, 260]


def flash_grad_terms(torch, q, k, v, do):
    """The magnitude of the terms each gradient entry of the flash route
    sums: Pᵀ|dO| for dv; hd^-½·E|K| and hd^-½·Eᵀ|Q| for dq and dk, with
    E = P ∘ (M + rowsum(P ∘ M)) and M = |dO| |V|ᵀ (the terms of dS). In f32
    from the upcast inputs, causal."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, s, kv, g, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf, kf) * hd**-0.5
    mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
    p = torch.softmax(torch.where(mask, scores, -1.0e30), dim=-1)
    m = torch.einsum("bskgh,btkh->bkgst", dof.abs(), vf.abs())
    e = p * (m + (p * m).sum(dim=-1, keepdim=True))
    a_dq = torch.einsum("bkgst,btkh->bskgh", e, kf.abs()).reshape(b, s, h, hd) * hd**-0.5
    a_dk = torch.einsum("bkgst,bskgh->btkh", e, qf.abs()) * hd**-0.5
    a_dv = torch.einsum("bkgst,bskgh->btkh", p, dof.abs())
    return a_dq, a_dk, a_dv


def train_flash_grads(torch, gen) -> float:
    """The flash route's gradients (the kernel's forward, the port's torch-ops
    VJP) against autograd through the plain version on the card, on small
    inputs: f32 to atol FLASH_F32_ATOL, bf16 to FLASH_BF16_REL·(|want| + the
    magnitude of the summed terms), B4's relative limit with the gradient's
    own terms in place of Σ p|v|. B4's cap FLASH_BF16_ATOL is left out: it
    bounds outputs no larger than max |v|, and gradient entries reach 4-8,
    where one bf16 ulp (2⁻⁵) is above it. Returns the largest excess over
    the limit."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_GRAD_SHAPES:
            worst = max(worst, flash_grads_at(torch, gen, shape, dtype))
    return worst


def flash_grads_at(torch, gen, shape, dtype, label="train") -> float:
    """``train_flash_grads``' check at one (B, S, H, KV, hd) and dtype;
    returns the largest excess over the limit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    b, s, h, kv, hd = shape
    ins = [torch.randn(dims, generator=gen).to(DEV, dtype)
           for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    do = torch.randn((b, s, h, hd), generator=gen).to(DEV, dtype)
    before = fa_ops.launches["flash_attention"]
    got_in = [a.clone().requires_grad_(True) for a in ins]
    got = torch.autograd.grad(fa_ops.flash_attention(*got_in), got_in, do)
    if fa_ops.launches["flash_attention"] != before + 1:
        fail(f"{label}: the flash route's forward did not launch the kernel once")
    want_in = [a.clone().requires_grad_(True) for a in ins]
    want = torch.autograd.grad(flash_attention_plain(*want_in), want_in, do)
    terms = flash_grad_terms(torch, *ins, do)
    torch.cuda.synchronize()
    errs, worst = [], 0.0
    for name, g_, w, a in zip(("dq", "dk", "dv"), got, want, terms):
        if g_.dtype != dtype or g_.shape != w.shape:
            fail(f"{label}: flash {name} is {g_.dtype} {tuple(g_.shape)}")
        err = (g_.float() - w.float()).abs()
        if dtype == torch.float32:
            excess = float(err.max()) / FLASH_F32_ATOL
        else:
            excess = float((err / (FLASH_BF16_REL * (w.float().abs() + a))).max())
        if not math.isfinite(excess) or excess > 1.0:
            fail(f"{label}: flash {name} {dtype} at {shape}: max abs error "
                 f"{float(err.max())}, {excess:.3f}× its limit")
        errs.append(f"{name} {float(err.max()):.3e} ({excess:.3f} of its limit, max |want| "
                    f"{float(w.float().abs().max()):.3e})")
        worst = max(worst, excess)
    print(f"{label}: flash gradients {dtype} (B, S, H, KV, hd) = {shape} against "
          f"autograd through the plain version: {', '.join(errs)}")
    return worst


class _CpuMadeParams:
    """``init_params`` makes the parameters on the CPU and moves them to the
    device asked for, so card and CPU runs start from the same bits."""

    def __enter__(self):
        from repro_torch.models import model as mdl

        self.mdl, self.orig = mdl, mdl.init_params
        mdl.init_params = lambda cfg, seed=0, *, device="cuda": self.orig(
            cfg, seed, device="cpu").to(device)
        return self

    def __exit__(self, *exc):
        self.mdl.init_params = self.orig


def train_small(torch) -> None:
    """5 steps of the reduced qwen3-0.6b (f32) on the card and on the CPU
    from the same parameters; the card's train-state bundle restored on the
    CPU equals the card's state bit for bit."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.io import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train

    cfg = get_config(TRAIN["arch"], reduced=True)
    out = {}
    with _CpuMadeParams():
        for dev in (DEV, "cpu"):
            out[dev] = train.train(cfg, steps=TRAIN_SMALL["steps"], batch=TRAIN_SMALL["batch"],
                                   seq=TRAIN_SMALL["seq"], lr=TRAIN_SMALL["lr"], device=dev,
                                   log=lambda line: None)
    for key in ("loss", "grad_norm"):
        card = np.array([r[key] for r in out[DEV][1]])
        cpu = np.array([r[key] for r in out["cpu"][1]])
        if not np.allclose(card, cpu, atol=TRAIN_SMALL_ATOL, rtol=0):
            fail(f"train[small]: card {key} {card.tolist()} against the CPU's {cpu.tolist()}")
        print(f"train[small]: {cfg.name} {TRAIN_SMALL['steps']} steps, card against CPU: {key} "
              f"max |Δ| {float(np.abs(card - cpu).max()):.3e} (atol {TRAIN_SMALL_ATOL}); card "
              f"{[round(x, 5) for x in card.tolist()]}")
    state = steps.train_state_tree(out[DEV][0])
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        save_checkpoint(path, state, step=TRAIN_SMALL["steps"])
        restored, step, _ = restore_checkpoint(path, steps.train_state_tree(out["cpu"][0]))
    want, got = _flatten(state), _flatten(restored)
    if step != TRAIN_SMALL["steps"] or list(want) != list(got):
        fail(f"train[small]: the bundle restored at step {step} with other leaves")
    for k, a in want.items():
        if a.dtype != got[k].dtype or not np.array_equal(a, got[k]):
            fail(f"train[small]: bundle leaf {k} restored on the CPU differs from the card's state")
    print(f"train[small]: the card's train-state bundle ({len(want)} leaves: params, opt_state "
          f"mu / nu / count, step) restored on the CPU equals the card's state bit for bit")


def flash_train_times(torch, gen, name, shape=FLASH_TRAIN) -> dict:
    """The flash route at a train phase's attention shape (qwen3-0.6b's
    unless given), bf16: the kernel's forward held against the plain
    version on the same inputs, then timed against
    scaled_dot_product_attention's and the plain version's, beside its
    bound; the port's torch-ops backward against SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    part, bw, _, bf16 = peaks_for(name)
    b, s, h, kv, hd = shape
    q, k, v, do = (torch.randn(dims, generator=gen).to(DEV, torch.bfloat16)
                   for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    ms = {"max_abs_err": _flash_check(torch, f"bf16 train shape {shape}",
                                      fa_ops.flash_attention_padded(q, k, v), q, k, v,
                                      again=fa_ops.flash_attention_padded(q, k, v))}
    qt, kt, vt, dot = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v, do))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    fns = {
        "kernel": lambda: fa_ops.flash_attention_padded(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True),
        "backward": lambda: flash_attention_bwd(q, k, v, do),
        "library_backward": lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                        retain_graph=True),
    }
    times = {w: [] for w in fns}
    for who in ("kernel", "library", "backward", "library_backward",
                "library_backward", "backward", "library", "kernel"):
        times[who].append(time_ms(torch, fns[who], reps=10))
    ms.update({w: sum(t) / 2 for w, t in times.items()})
    ms["plain"] = time_ms(torch, lambda: flash_attention_plain(q, k, v), reps=3)
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    nops = 2 * b * h * s * s * hd
    t_bytes, t_ops = nbytes / bw * 1e3, nops / bf16 * 1e3
    ms["bound"] = max(t_bytes, t_ops)
    print(f"times: flash_attention train shape {shape} bf16: forward kernel {ms['kernel']:.6f} "
          f"ms, plain {ms['plain']:.6f} ms, library (scaled_dot_product_attention) "
          f"{ms['library']:.6f} ms, bound {ms['bound']:.6f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"{part} peaks {bw / 1e12:.2f} TB/s, {bf16 / 1e12:.0f} TFLOP/s bf16); backward (torch ops, "
          f"f32) {ms['backward']:.6f} ms, library backward {ms['library_backward']:.6f} ms; in turns "
          f"{json.dumps({w: [round(x, 6) for x in t] for w, t in times.items()})}")
    return ms


def lm_trace(torch, label, fn, what) -> None:
    """``fn`` once under torch.profiler with host and device activity: device
    busy and idle share, device time by kernel, the device time under the
    flash route's backward node, and the host ops that took the most host
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = _report_trace(torch, prof, wall_ms, label, what)
    groups: dict[str, float] = {}
    for kname, ms in by_name.items():
        low = kname.lower()
        group = ("flash_fwd (B4)" if "flash_fwd" in low else
                 "GEMM bf16" if ("gemm" in low or "xmma" in low or "nvjet" in low or "cutlass" in low)
                 and "bf16" in low else
                 "GEMM other" if any(k in low for k in ("gemm", "xmma", "nvjet", "cutlass")) else
                 "softmax" if "softmax" in low else
                 "reduce" if "reduce" in low else
                 "embedding / index" if any(k in low for k in ("embedding", "index", "scatter", "gather"))
                 else "elementwise and other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"trace[{label}]: device ms by kind: "
          f"{json.dumps({k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])})}")
    avgs = prof.key_averages()
    dev = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    under = {e.key: dev(e) / 1e3 for e in avgs if "FlashAttentionBackward" in e.key}
    print(f"trace[{label}]: device ms under the flash route's backward node: {json.dumps(under)}")
    top = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"trace[{label}]: host ops by self host ms: " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ({e.count}x)" for e in top))


def phase_train(torch, gen, name) -> dict:
    """``launch/train.py``'s path at qwen3-0.6b's full width and depth, bf16
    over f32 parameters, AdamW with ``linear_warmup_cosine``, clip 1.0:
    the flash route's gradients on small inputs, the reduced config card
    against CPU and its bundle, then TRAIN's steps with the flash launches
    counted. Returns the launches and times."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    t0 = time.perf_counter()
    excess = train_flash_grads(torch, gen)
    train_small(torch)
    cfg = get_config(TRAIN["arch"])
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    print(f"train: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} kv), head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype}, remat {cfg.remat}, fused_ce "
          f"{cfg.fused_ce}; batch {TRAIN['batch']} × seq {TRAIN['seq']}, {TRAIN['steps']} steps, "
          f"lr {TRAIN['lr']}")
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches.update(flash_attention=0)
    start = time.perf_counter()
    state, records = train.train(cfg, steps=TRAIN["steps"], batch=TRAIN["batch"], seq=TRAIN["seq"],
                                 lr=TRAIN["lr"], device=DEV, log_every=1, log=lines.append)
    torch.cuda.synchronize()
    launches = fa_ops.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    for line in lines:
        print(f"train: {line}")
    n = mdl.param_count(state["params"])
    marks = [start] + [r["t"] for r in records]
    step_ms = np.diff(marks) * 1e3
    print(f"train: {n} parameters; step ms: first {step_ms[0]:.3f}, then median "
          f"{float(np.median(step_ms[1:])):.3f} (min {step_ms[1:].min():.3f}, max "
          f"{step_ms[1:].max():.3f}); {TRAIN['batch'] * TRAIN['seq'] / np.median(step_ms[1:]) * 1e3:.1f} "
          f"tokens/s; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"train: flash_attention launches {launches} in {TRAIN['steps']} steps, predicted "
          f"{per_step * TRAIN['steps']} ({cfg.n_layers} a forward, the forward run again in the "
          f"backward under remat)")
    if n != LM_P:
        fail(f"train: {n} parameters, expected {LM_P}")
    for r in records:
        if not all(math.isfinite(r[k]) for k in ("loss", "ce", "grad_norm")):
            fail(f"train: a loss or gradient norm is not finite: {r}")
    if launches != per_step * TRAIN["steps"]:
        fail(f"train: {launches} flash launches in {TRAIN['steps']} steps, expected "
             f"{per_step * TRAIN['steps']}")
    for p in state["params"].parameters():
        if not bool(torch.isfinite(p).all()):
            fail("train: a parameter is not finite after the steps")
    step_fn = steps.make_train_step(cfg, adamw(linear_warmup_cosine(
        TRAIN["lr"], TRAIN["steps"] // 10 + 1, TRAIN["steps"])))
    bt = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"], seed=1).next_batch()
    batch = {k: torch.from_numpy(v).to(DEV, torch.int64)
             for k, v in (("tokens", bt.tokens), ("targets", bt.targets))}
    lm_trace(torch, "train", lambda: step_fn(state, batch), "one more train step")
    del state
    times = flash_train_times(torch, gen, name)
    print(f"train: {time.perf_counter() - t0:.3f} s")
    return {"flash": launches, "step_ms": float(np.median(step_ms[1:])), "first_ms": float(step_ms[0]),
            "peak": peak, "grad_excess": excess, "times": times}


# ---------------------------------------------------------------------------
# fl_lm: clustered-sampling federated LM at qwen3-0.6b's full width
# ---------------------------------------------------------------------------
def lm_kernels(torch, name, p=LM_P, windows=LM_WINDOWS, label="fl_lm") -> dict:
    """B2 and B3 at (8, p), a full-width federated round's rows: B2 against
    its plain version column block by column block (and timed, with
    torch.mv and the plain version whole), B3 against the plain product on
    the column windows of an X that is zero elsewhere, and timed beside the
    library's ``torch.matmul(X[:, w], S_w)`` summed over LM_LIB_WINDOW
    windows that cover all p columns. Returns max abs errors and times."""
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ref import srp_sign_block

    part, bw, f32, _ = peaks_for(name)
    m = 8
    g = torch.Generator(device=DEV).manual_seed(3)
    out = {}
    U = torch.randn((m, p), generator=g, device=DEV)
    w = torch.rand((m,), generator=g, device=DEV)
    if p % agg_ops.VEC or U.data_ptr() % (4 * agg_ops.VEC):
        fail(f"{label}: rows of {p} floats at {U.data_ptr():#x} do not take aggregate_vec2")
    got = agg_ops.aggregate_flat(U, w)
    worst = 0.0
    for a in range(0, p, LM_AGG_BLOCK):
        want = aggregate_ref(U[:, a:a + LM_AGG_BLOCK], w)
        blk = got[a:a + LM_AGG_BLOCK]
        if not torch.allclose(blk, want, rtol=AGG_TOL, atol=AGG_TOL):
            fail(f"{label}: aggregate at ({m}, {p}) columns {a}.. beyond rtol=atol {AGG_TOL}")
        worst = max(worst, float((blk - want).abs().max()))
    if not torch.equal(got, agg_ops.aggregate_flat(U, w)):
        fail(f"{label}: aggregate at ({m}, {p}) is not bit-reproducible")
    out["aggregate_err"] = worst
    print(f"{label}: aggregate ({m}, {p}) against the plain version in column blocks of "
          f"{LM_AGG_BLOCK}: max_abs_err {worst:.3e} (rtol=atol {AGG_TOL}), reproducible")
    nbytes = 4 * (m * p + m + p)
    t_b, t_o = nbytes / bw * 1e3, 2 * m * p / f32 * 1e3
    ms = {w_: [] for w_ in ("kernel", "library")}
    fns = {"kernel": lambda: agg_ops.aggregate_flat(U, w), "library": lambda: torch.mv(U.T, w)}
    for who in ("kernel", "library", "library", "kernel"):
        ms[who].append(time_ms(torch, fns[who], reps=5))
    plain_ms = time_ms(torch, lambda: aggregate_ref(U, w), reps=2)
    out["aggregate"] = {"ms": sum(ms["kernel"]) / 2, "library_ms": sum(ms["library"]) / 2,
                        "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
                        "bound_by": "bytes" if t_b >= t_o else "operations"}
    print(f"times: aggregate ({m}, {p}) {out['aggregate']['ms']:.6f} ms (in turns "
          f"{[round(x, 6) for x in ms['kernel']]}), plain {plain_ms:.6f} ms, library (torch.mv) "
          f"{out['aggregate']['library_ms']:.6f} ms ({[round(x, 6) for x in ms['library']]}), bound "
          f"{out['aggregate']['bound_ms']:.6f} ms ({out['aggregate']['bound_by']}; {part} peaks "
          f"{bw / 1e12:.2f} TB/s, {f32 / 1e12:.0f} TFLOP/s f32; {nbytes} B)")
    del U, got, blk  # blk, a view, would keep got's storage
    X = torch.zeros((m, p), device=DEV)
    for a, width in windows:
        X[:, a:a + width] = SIM_SCALE * torch.randn((m, width), generator=g, device=DEV)
    got = sk_ops.srp_sketch(X, D_PRIME, SRP_SEED)
    want = torch.zeros_like(got)
    for a, width in windows:
        want += X[:, a:a + width] @ srp_sign_block(SRP_SEED, a, width, D_PRIME, p, device=DEV)
    ncols = sum(width for _, width in windows)
    sq = sum(X[:, a:a + width].double().square().sum(dim=1) for a, width in windows)  # ‖x_i‖²
    scale = sq.sqrt()[:, None] * math.sqrt(ncols / D_PRIME) + GRAM_FLOOR
    rel = float(((got.double() - want.double()).abs() / scale).max())
    e = float((got - want).abs().max())
    if not math.isfinite(rel) or rel > SRP_RTOL:
        fail(f"{label}: srp at ({m}, {p}, {D_PRIME}): error {rel} of ‖x_i‖·‖S_w,j‖ > {SRP_RTOL}")
    if not torch.equal(got, sk_ops.srp_sketch(X, D_PRIME, SRP_SEED)):
        fail(f"{label}: srp at ({m}, {p}, {D_PRIME}) is not bit-reproducible")
    out["srp_err"] = e
    print(f"{label}: srp ({m}, {p}, {D_PRIME}) against the plain product on {len(windows)} "
          f"column windows {windows} (X zero elsewhere; the last ends at column {p}): "
          f"max_abs_err {e:.3e}, {rel:.3e} of ‖x_i‖·‖S_w,j‖ (limit {SRP_RTOL}), reproducible")
    nbytes = 4 * (m * p + m * D_PRIME)
    t_b, t_o = nbytes / bw * 1e3, 2 * m * p * D_PRIME / f32 * 1e3
    kms = time_ms(torch, lambda: sk_ops.srp_sketch(X, D_PRIME, SRP_SEED), reps=5)
    lib_ms, n_win = 0.0, 0
    for a in range(0, p, LM_LIB_WINDOW):
        Xw = X[:, a:a + LM_LIB_WINDOW]
        S_w = srp_sign_block(SRP_SEED, a, Xw.shape[1], D_PRIME, p, device=DEV)
        lib_ms += time_ms(torch, lambda: torch.matmul(Xw, S_w), reps=3)
        n_win += 1
        del S_w
    out["srp"] = {"ms": kms, "library_ms": lib_ms, "bound_ms": max(t_b, t_o),
                  "bound_by": "bytes" if t_b >= t_o else "operations"}
    print(f"times: srp_sketch ({m}, {p}, {D_PRIME}) {kms:.6f} ms, library {lib_ms:.6f} ms "
          f"(torch.matmul(X[:, w], S_w) summed over {n_win} windows of {LM_LIB_WINDOW} columns, "
          f"each S_w made outside its timed window; S whole would take "
          f"{4 * p * D_PRIME / 1e9:.0f} GB), bound {out['srp']['bound_ms']:.6f} ms "
          f"({out['srp']['bound_by']}; {part} peaks {bw / 1e12:.2f} TB/s, {f32 / 1e12:.0f} "
          "TFLOP/s f32); plain not measured (its S blocks are made inside the call)")
    # Xw, a view, would keep X's storage past the empty_cache: its (8, p)
    # block, cached, would then be split by the next allocations and leave
    # no room for a federated round's own (8, p) stack
    del X, Xw
    torch.cuda.empty_cache()
    return out


def _fl_lm_recorded(sampler, rounds: list):
    """Record each round's draw and the plan it drew from (its tokens)."""
    real = sampler.sample

    def sample(t, *a, **kw):
        tokens = getattr(getattr(sampler, "plan", None), "r_tokens", None)
        res = real(t, *a, **kw)
        rounds.append((None if tokens is None else tokens.copy(), list(map(int, res.clients))))
        return res

    sampler.sample = sample


def fl_lm_small(torch, arch=FL_LM["arch"], narrow=FL_SMALL_NARROW, label="fl_lm") -> None:
    """The narrow reduced ``arch`` (f32) on the card and on the CPU from
    the same parameters: equal draws and plans every round, losses to
    PAPER_LOSS_ATOL, for md, Algorithm 2 and Algorithm 2 with the SRP
    sketch (d′ = 16)."""
    import contextlib
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ClientPopulation
    from repro_torch.launch import fl_train
    from repro_torch.models import model as mdl

    cfg = dataclasses.replace(get_config(arch, reduced=True), **narrow)
    d = mdl.param_count(mdl.init_params(cfg, 0, device="meta"))
    for run, sampler, planner in (("md", "md", "sync"), ("algorithm2", "algorithm2", "sync"),
                                  ("algorithm2[srp]", "algorithm2",
                                   {"mode": "sync", "sketch": "srp", "sketch_dim": 16})):
        fl = fl_train.FLLMConfig(**FL_SMALL, sampler=sampler, planner=planner)
        runs = {}
        with _CpuMadeParams():
            for dev in (DEV, "cpu"):
                rounds = []
                with contextlib.closing(fl_train.make_lm_sampler(
                        fl, ClientPopulation(np.array(FL_SMALL_SIZES)), update_dim=d, device=dev)) as sm:
                    _fl_lm_recorded(sm, rounds)
                    runs[dev] = (fl_train.run_federated_lm(cfg, fl, sm, device=dev), rounds)
        (card, card_rounds), (cpu, cpu_rounds) = runs[DEV], runs["cpu"]
        if not np.allclose(card, cpu, atol=PAPER_LOSS_ATOL, rtol=0):
            fail(f"{label}[small {run}]: card losses {card} against the CPU's {cpu}")
        for t, ((p1, c1), (p2, c2)) in enumerate(zip(card_rounds, cpu_rounds)):
            if c1 != c2 or (p1 is None) != (p2 is None) or (p1 is not None and not np.array_equal(p1, p2)):
                fail(f"{label}[small {run}]: round {t}: the card drew {c1} from another plan than "
                     f"the CPU's {c2}")
        moved = sum(p is not None and not np.array_equal(p, card_rounds[0][0]) for p, _ in card_rounds)
        print(f"{label}[small {run}]: {cfg.name} at d_model {cfg.d_model}, d = {d}, "
              f"{fl.n_rounds} rounds card against CPU: equal draws {[c for _, c in card_rounds]} and "
              f"plans ({moved} rounds off the cold start), losses max |Δ| "
              f"{float(np.abs(np.array(card) - np.array(cpu)).max()):.3e} (atol {PAPER_LOSS_ATOL})")


class FLParts:
    """Each full-width round's wall ms and its parts, host clock around
    calls that synchronise before and after: the local steps (all clients),
    the flatten of θ, B2, the sampler's observation, B3 within it, and its
    ``plan_build_ms``. Patches the fl_train module's names for the ``with``
    block only."""

    def __init__(self, torch):
        self.torch = torch
        self.rounds: list[dict] = []

    def _timed(self, key, fn):
        def wrapped(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            if self.rounds:
                self.rounds[-1][key] = self.rounds[-1].get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    def __enter__(self):
        from repro_torch.kernels.sketch import ops as sk_ops
        from repro_torch.launch import fl_train
        from repro_torch.models import model as mdl

        make_local = fl_train.make_local_sgd
        self._saved = [(mdl, "flatten_lm"), (fl_train, "aggregate_flat"),
                       (fl_train, "make_local_sgd"), (sk_ops, "srp_sketch")]
        self._saved = [(mod, attr, getattr(mod, attr)) for mod, attr in self._saved]
        mdl.flatten_lm = self._timed("flatten", mdl.flatten_lm)
        fl_train.aggregate_flat = self._timed("aggregate", fl_train.aggregate_flat)
        fl_train.make_local_sgd = lambda *a: self._timed("local", make_local(*a))
        sk_ops.srp_sketch = self._timed("srp", sk_ops.srp_sketch)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)

    def attach(self, sampler):
        real_sample, real_observe = sampler.sample, sampler.observe_updates

        def sample(t, *a, **kw):
            self.torch.cuda.synchronize()
            self.rounds.append({"start": time.perf_counter()})
            return real_sample(t, *a, **kw)

        sampler.sample = sample
        if getattr(sampler, "consumes_updates", False):
            timed = self._timed("observe", real_observe)

            def observe(ids, updates):
                timed(ids, updates)
                self.rounds[-1]["plan_build_ms"] = sampler.plan_cost_telemetry()[0]

            sampler.observe_updates = observe

    def close(self):
        """End the last round: each round's ms runs to the next one's start."""
        self.torch.cuda.synchronize()
        ends = [r["start"] for r in self.rounds[1:]] + [time.perf_counter()]
        for r, end in zip(self.rounds, ends):
            r["round"] = (end - r.pop("start")) * 1e3


class GramTap:
    """Record each ``pairwise_sums(G, "gram")`` call's input and output
    (copies) while the context is open, for a check after the run."""

    def __init__(self, sim_ops, into: list):
        self.sim_ops, self.into = sim_ops, into

    def __enter__(self):
        real = self.real = self.sim_ops.pairwise_sums

        def tapped(G, op):
            out = real(G, op)
            if op == "gram":
                self.into.append((G.detach().clone(), out.detach().clone()))
            return out

        self.sim_ops.pairwise_sums = tapped
        return self

    def __exit__(self, *exc):
        self.sim_ops.pairwise_sums = self.real


#: each fl_lm_run's per-round losses by label, for the sharded phase
FL_LM_LOSSES: dict = {}


def fl_lm_run(torch, label, sampler_name, planner, cfg=None, p=LM_P, rounds=FL_LM["rounds"],
              **fl_kw) -> dict:
    """run_federated_lm on ``cfg`` (qwen3-0.6b at full width unless given;
    ``p`` its parameters) with FLLMConfig's defaults but for ``fl_kw`` and
    ``rounds`` rounds; kernel launches counted from after the sampler's
    construction (its cold-start build) to the run's end."""
    import contextlib

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ClientPopulation
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.launch import fl_train

    cfg = cfg or get_config(FL_LM["arch"])
    fl = fl_train.FLLMConfig(n_rounds=rounds, sampler=sampler_name, planner=planner, **fl_kw)
    pop = ClientPopulation(np.full(fl.n_clients, 1000))
    grams = []  # (store snapshot, the sampler's Gram of it) of every plan rebuild
    with FLParts(torch) as parts, GramTap(sim_ops, grams), contextlib.closing(
            fl_train.make_lm_sampler(fl, pop, update_dim=p, device=DEV)) as sampler:
        parts.attach(sampler)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sim_ops.launches.update(gram=0, l1=0)
        agg_ops.launches.update(aggregate=0)
        sk_ops.launches.update(srp=0)
        fa_ops.launches.update(flash_attention=0)
        grams.clear()
        losses = fl_train.run_federated_lm(cfg, fl, sampler, device=DEV)
        FL_LM_LOSSES[label] = losses
        parts.close()
        launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches, **fa_ops.launches}
        store = getattr(sampler, "gradient_store", None)
        plan = getattr(sampler, "plan", None)
    peak = torch.cuda.max_memory_allocated()
    steps = fl.n_rounds * fl.m * fl.n_local_steps
    feedback = sampler_name == "algorithm2"
    n_attn = sum(m == "attn" for m, _ in cfg.all_blocks)
    want = {"aggregate": fl.n_rounds, "srp": fl.n_rounds if feedback else 0,
            "gram": fl.n_rounds if feedback else 0, "l1": 0,
            "flash_attention": n_attn * (2 if cfg.remat else 1) * steps}
    print(f"fl_lm[{label}]: {cfg.name} full width, {cfg.n_layers} layers (d = {p}), {fl.n_clients} clients, m = "
          f"{fl.m}, {fl.n_local_steps} local steps of batch {fl.local_batch} × seq {fl.seq_len}, lr "
          f"{fl.lr}, {fl.n_rounds} rounds: losses {[round(x, 5) for x in losses]}; peak device "
          f"memory {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"fl_lm[{label}]: launches {json.dumps(launches)}; predicted {json.dumps(want)} "
          f"(aggregate a round, srp a sketched observation, gram an Algorithm 2 rebuild, flash "
          f"{n_attn} a forward, one an attention layer, twice a local step under remat)")
    if launches != want:
        fail(f"fl_lm[{label}]: launches {launches}, predicted {want}")
    if len(losses) != fl.n_rounds or not all(math.isfinite(x) for x in losses):
        fail(f"fl_lm[{label}]: losses {losses}")
    if feedback:
        if tuple(store.snapshot().shape) != (fl.n_clients, D_PRIME):
            fail(f"fl_lm[{label}]: the store is {tuple(store.snapshot().shape)}")
        from repro_torch.core.samplers.base import validate_plan

        validate_plan(plan, pop)
    worst = 0.0
    for G, got in grams:
        if tuple(G.shape) != (fl.n_clients, D_PRIME):
            fail(f"fl_lm[{label}]: a plan rebuild's Gram was of a {tuple(G.shape)} store")
        rel = gram_rel_err(got, G.double() @ G.double().T, G)
        if not math.isfinite(rel) or rel > GRAM_RTOL:
            fail(f"fl_lm[{label}]: the sampler's gram at {tuple(G.shape)}: error {rel} of "
                 f"‖g_i‖·‖g_j‖ > {GRAM_RTOL}")
        worst = max(worst, rel)
    if len(grams) != launches["gram"]:
        fail(f"fl_lm[{label}]: {len(grams)} Gram calls seen, {launches['gram']} launches")
    if grams:
        print(f"fl_lm[{label}]: the sampler's {len(grams)} gram calls at ({fl.n_clients}, "
              f"{D_PRIME}) against G @ G.T (f64) on the same store: {worst:.3e} of "
              f"‖g_i‖·‖g_j‖ (limit {GRAM_RTOL})")
    for r in parts.rounds:
        print(f"fl_lm[{label}]: round ms {r['round']:.3f}: local steps {r.get('local', 0.0):.3f}, "
              f"flatten {r.get('flatten', 0.0):.3f}, aggregate (B2) {r.get('aggregate', 0.0):.3f}, "
              f"observe {r.get('observe', 0.0):.3f} (srp (B3) {r.get('srp', 0.0):.3f}, "
              f"plan_build_ms {r.get('plan_build_ms', 0.0):.3f})")
    med = {k: float(np.median([r.get(k, 0.0) for r in parts.rounds]))
           for k in ("round", "local", "flatten", "aggregate", "observe", "srp", "plan_build_ms")}
    print(f"times: fl_lm[{label}] medians of {fl.n_rounds} rounds: {json.dumps(med)}")
    return launches


def local_step_trace(torch, cfg=None, label="local_step") -> None:
    """One client's local step of ``cfg`` (qwen3-0.6b at full width unless
    given; FLLMConfig's batch 4 × seq 64) under torch.profiler, after one
    unprofiled."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import fl_train
    from repro_torch.models import model as mdl

    cfg = cfg or get_config(FL_LM["arch"])
    fl = fl_train.FLLMConfig()
    client = mdl.init_params(cfg, 0, device=DEV).requires_grad_(True)
    toks = np.stack([TokenPipeline(cfg.vocab_size, fl.local_batch, fl.seq_len, seed=1000)
                     .next_batch().tokens])
    toks = torch.from_numpy(toks).to(DEV, torch.int64)
    tgts = (toks + 31) % cfg.vocab_size
    local = fl_train.make_local_sgd(cfg, fl.lr, 1)
    local(client, toks, tgts)
    lm_trace(torch, label, lambda: local(client, toks, tgts),
             f"one local step of a client (batch {fl.local_batch} × seq {fl.seq_len})")


def phase_fl_lm(torch, name) -> dict:
    """B2 and B3 at the full-width rows, the reduced config card against
    CPU, then run_federated_lm at qwen3-0.6b's full width with md and with
    sketched Algorithm 2. Returns the launches of the two full-width runs
    together, and the kernels' errors and times."""
    t0 = time.perf_counter()
    kern = lm_kernels(torch, name)
    fl_lm_small(torch)
    md = fl_lm_run(torch, "md", "md", "sync")
    a2 = fl_lm_run(torch, "algorithm2[srp]", "algorithm2", FL_LM_SKETCH)
    local_step_trace(torch)
    print(f"fl_lm: {time.perf_counter() - t0:.3f} s")
    return {"launches": {k: md[k] + a2[k] for k in md}, "kernels": kern}


# ---------------------------------------------------------------------------
# serve_moe: qwen2-moe-a2.7b's serve path at full width and depth
# ---------------------------------------------------------------------------
SERVE_MOE = dict(arch="qwen2-moe-a2.7b", batch=4, prompt_len=1000, gen=16)
MOE_P = 14_315_735_040  # qwen2-moe-a2.7b's parameters
MOE_LAYER_RTOL = 1e-4  # card vs CPU, f32: of the output's scale max |out|
MOE_AUX_ATOL = 1e-6


def _to_cpu(torch, tree) -> dict:
    """A block's sub-dict of parameters as a dict of CPU tensors."""
    return {k: _to_cpu(torch, v) if isinstance(v, torch.nn.Module) else v.detach().cpu()
            for k, v in tree.items()}


def moe_layer_card_vs_cpu(torch, cfg, params, layer=0, label="serve_moe") -> None:
    """Layer ``layer``'s MoE FFN at full width in f32 (TF32 off) on the card
    and on the CPU, on the same (batch, prompt, d_model) input: the same
    expert choices and kept set, outputs within MOE_LAYER_RTOL of their
    scale."""
    import dataclasses

    from repro_torch.models.layers import moe as moe_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    card = params.blocks[layer]["moe"]

    host = _to_cpu(torch, card)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((SERVE_MOE["batch"], SERVE_MOE["prompt_len"], cfg.d_model), generator=g)
    out = {}
    for where, dev, p in (("card", DEV, card), ("cpu", "cpu", host)):
        xd = x.to(dev)
        with torch.inference_mode():
            r = moe_lib.route(cfg32, p, moe_lib.token_groups(cfg32, xd))
            y, aux = moe_lib.moe_ffn(cfg32, p, xd)
        out[where] = (r.expert.cpu(), r.kept.cpu(), y.cpu(), float(aux))
    (e_g, k_g, y_g, a_g), (e_c, k_c, y_c, a_c) = out["card"], out["cpu"]
    flipped = int((e_g != e_c).sum())
    scale = float(y_c.abs().max())
    rel = float((y_g - y_c).abs().max()) / scale
    print(f"{label}: layer {layer}'s MoE FFN at full width ({tuple(x.shape)}, {e_g.shape[0]} groups of "
          f"{e_g.shape[1]}, capacity {moe_lib.expert_capacity(cfg.moe)}), f32 card vs CPU: "
          f"{flipped} of {e_g.numel()} expert choices differ, {int((k_g != k_c).sum())} kept states "
          f"differ ({int((~k_c).sum())} choices dropped on the CPU), max |Δout| {rel:.3e} of "
          f"max |out| {scale:.3e} (limit {MOE_LAYER_RTOL}), aux {a_g:.7f} vs {a_c:.7f}")
    if flipped or not torch.equal(k_g, k_c):
        fail(f"{label}: the card routes the full-width MoE layer otherwise than the CPU")
    if not math.isfinite(rel) or rel > MOE_LAYER_RTOL or abs(a_g - a_c) > MOE_AUX_ATOL:
        fail(f"{label}: the full-width MoE layer's output differs by {rel:.3e} of its scale, "
             f"aux by {abs(a_g - a_c):.3e}")


def _blocks_summary(cfg) -> str:
    counts: dict = {}
    for kind in cfg.all_blocks:
        counts[kind] = counts.get(kind, 0) + 1
    return ", ".join(f"{n} {kind}" for kind, n in counts.items())


def serve_full_width(torch, label, spec, want_p, describe):
    """``spec["arch"]`` at full width and depth: parameters made on the card
    (bf16 over f32; ``describe(cfg)`` names its own widths), a warm-up,
    then ``generate`` with the prefill and each decode step timed and the
    flash launches counted in each: one a prefill for each "attn" layer and
    none in decode (MLA, the recurrent mixers, windowed attention, the
    encoder's bidirectional attention and cross-attention are torch ops),
    finite logits, tokens the per-step argmax. A model with a front end gets
    its zero stubs, as the serve CLI feeds them. Returns (cfg, params,
    prompts, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import frontend_stubs
    from repro_torch.models import model as mdl

    torch.cuda.empty_cache()
    cfg = get_config(spec["arch"])
    b, p, n_gen = spec["batch"], spec["prompt_len"], spec["gen"]
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, 0, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p), generator=g, device=DEV)
    torch.cuda.synchronize()
    n = mdl.param_count(params)
    print(f"{label}: {cfg.name} ({cfg.source}), {cfg.n_layers} layers ({_blocks_summary(cfg)}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv), head_dim {cfg.resolved_head_dim}, "
          f"{describe(cfg)}, vocab {cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype}: {n} parameters "
          f"made on the card in {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n != want_p:
        fail(f"{label}: {n} parameters, expected {want_p}")
    extras = frontend_stubs(cfg, b, DEV)
    if extras:
        print(f"{label}: zero front-end stubs " + ", ".join(
            f"{k} {tuple(v.shape)} {v.dtype}" for k, v in extras.items()))
    generate(cfg, params, prompts, 2, device=DEV, **extras)  # warm-up
    marks, counts = [], []

    def on_step(phase, t):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(fa_ops.launches["flash_attention"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches.update(flash_attention=0)
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, n_gen, device=DEV, on_step=on_step, **extras)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = (marks[0] - t0) * 1e3
    decode_ms = (marks[-1] - marks[0]) * 1e3 / (n_gen - 1)
    in_prefill, in_decode = counts[0], counts[-1] - counts[0]
    print(f"{label}: batch {b}, prompt {p}, {n_gen} tokens: prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms per step ({b * (n_gen - 1) / (marks[-1] - marks[0]):.1f} tokens/s "
          f"decoding, {b * n_gen / (marks[-1] - t0):.1f} tokens/s end to end); peak device memory "
          f"{peak} B ({peak / 2**30:.2f} GiB)")
    print(f"{label}: flash_attention launches: {in_prefill} in the prefill, {in_decode} in the "
          f"{n_gen - 1} decode steps")
    print(f"{label}: first generated row {tokens[0].tolist()}")
    want_flash = sum(m == "attn" for m, _ in cfg.all_blocks)
    if (in_prefill, in_decode) != (want_flash, 0):
        fail(f"{label}: flash launches {in_prefill} in the prefill and {in_decode} in the decode, "
             f"expected {want_flash} and 0")
    if tuple(tokens.shape) != (b, n_gen) or tuple(logits.shape) != (n_gen, b, cfg.vocab_size):
        fail(f"{label}: tokens {tuple(tokens.shape)}, logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits are not finite")
    if not torch.equal(tokens, logits.argmax(dim=-1).T):
        fail(f"{label}: the tokens are not the per-step argmax of the logits")
    return cfg, params, prompts, {"flash": in_prefill + in_decode, "prefill_ms": prefill_ms,
                                  "decode_ms": decode_ms, "peak": peak}


def phase_serve_moe(torch) -> dict:
    """``generate`` at qwen2-moe-a2.7b's full width and depth (24 layers,
    d_model 2,048, 60 routed experts top-4 + 4 shared), bf16 over f32
    random parameters: prefill and decode times, peak memory, 24 flash
    launches in the prefill and 0 in decode; layer 0's MoE FFN on the card
    against the CPU; the prefill against the plain attention."""
    cfg, params, prompts, out = serve_full_width(torch, "serve_moe", SERVE_MOE, MOE_P, _describe_moe)
    moe_layer_card_vs_cpu(torch, cfg, params)
    _serve_against_plain(torch, cfg, params, prompts, label="serve_moe")
    phase_serve_trace(torch, cfg, params, prompts, tag="moe ")
    del params, prompts
    torch.cuda.empty_cache()
    return out


def _describe_moe(cfg) -> str:
    moe = cfg.moe
    return (f"{moe.n_routed} routed experts top-{moe.top_k} + {moe.n_shared} shared, d_ff_expert "
            f"{moe.d_ff_expert}, group {moe.group_size}, capacity factor {moe.capacity_factor}")


# ---------------------------------------------------------------------------
# serve_mla: deepseek-v2-lite-16b's serve path (MLA + MoE) at full width and depth
# ---------------------------------------------------------------------------
SERVE_MLA = dict(arch="deepseek-v2-lite-16b", batch=4, prompt_len=1000, gen=16)
MLA_P = 15_706_484_224  # deepseek-v2-lite-16b's parameters
MLA_LAYER_RTOL = MOE_LAYER_RTOL  # card vs CPU, f32: of the output's scale max |out|
ABSORBED_STEPS = 4  # decode steps of the absorbed-vs-naive gate


def mla_layer_card_vs_cpu(torch, cfg, params) -> None:
    """Layer 0's MLA at full width in f32 (TF32 off) on the card and on the
    CPU, on the same (batch, prompt, d_model) input: its output and its
    cache seed (latent c, rotary key) within MLA_LAYER_RTOL of their scale."""
    import dataclasses

    from repro_torch.models import model as mdl
    from repro_torch.models.layers import mla as mla_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    card = params.blocks[0]["attn"]
    host = _to_cpu(torch, card)
    g = torch.Generator().manual_seed(6)
    b, p = SERVE_MLA["batch"], SERVE_MLA["prompt_len"]
    x = torch.randn((b, p, cfg.d_model), generator=g)
    out = {}
    for where, dev, prm in (("card", DEV, card), ("cpu", "cpu", host)):
        angles = mdl.make_angles(cfg32, torch.arange(p, device=dev))
        with torch.inference_mode():
            y, seed = mla_lib.mla_full(cfg32, prm, x.to(dev), angles)
        out[where] = {"y": y.cpu(), "c": seed["c"].cpu(), "k_rope": seed["k_rope"].cpu()}
    rels = {}
    for key in ("y", "c", "k_rope"):
        want = out["cpu"][key]
        rels[key] = float((out["card"][key] - want).abs().max()) / float(want.abs().max())
    print(f"serve_mla: layer 0's MLA at full width ({tuple(x.shape)}, {cfg.n_heads} heads, qk head dim "
          f"{cfg.mla.nope_head_dim + cfg.mla.rope_head_dim}, v {cfg.mla.v_head_dim}, latent "
          f"{cfg.mla.kv_lora_rank}), f32 card vs CPU: max |Δ| of its scale "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} (limit {MLA_LAYER_RTOL})")
    if not all(math.isfinite(v) and v <= MLA_LAYER_RTOL for v in rels.values()):
        fail(f"serve_mla: the full-width MLA layer differs card vs CPU by {rels} of its scale")


def _clone_caches(caches: dict) -> dict:
    return {"layers": [{k: v.clone() if hasattr(v, "clone") else v for k, v in layer.items()}
                       for layer in caches["layers"]], "pos": caches["pos"]}


def absorbed_against_naive(torch, cfg, params, prompts) -> None:
    """One prefill, then ABSORBED_STEPS decode steps from copies of its cache
    in ``"naive"`` mode (the config's) and in ``"absorbed"`` mode, both fed
    naive's greedy tokens: max |Δlogit| over the steps, and equal tokens
    wherever naive's top-2 margin exceeds twice it. In the config's bf16 and
    in f32 (TF32 off), where the margin rule decides most row-steps."""
    import dataclasses

    from repro_torch.models import model as mdl

    for dtype in (cfg.dtype, "float32"):
        naive_cfg = dataclasses.replace(cfg, dtype=dtype)
        absorbed = dataclasses.replace(naive_cfg, mla=dataclasses.replace(cfg.mla, decode_mode="absorbed"))
        b, p = prompts.shape
        with torch.inference_mode():
            caches = mdl.init_cache(naive_cfg, b, p + ABSORBED_STEPS + 1, device=DEV)
            hidden, caches, _ = mdl.forward(naive_cfg, params, prompts, caches=caches)
            tok = mdl.logits_from_hidden(naive_cfg, params, hidden[:, -1:, :])[:, 0].argmax(-1, keepdim=True)
            del hidden
            runs = {"naive": (naive_cfg, caches), "absorbed": (absorbed, _clone_caches(caches))}
            logits = {mode: [] for mode in runs}
            for _ in range(ABSORBED_STEPS):
                for mode, (c, cache) in runs.items():
                    step, cache = mdl.decode_step(c, params, tok, cache)
                    runs[mode] = (c, cache)
                    logits[mode].append(step.float())
                tok = logits["naive"][-1].argmax(-1, keepdim=True)
            del runs, caches
        naive, absorb = torch.stack(logits["naive"]), torch.stack(logits["absorbed"])
        delta = float((naive - absorb).abs().max())
        top2 = naive.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        decided = margin > 2 * delta
        same = naive.argmax(-1) == absorb.argmax(-1)
        print(f"serve_mla: {ABSORBED_STEPS} decode steps from one prefill's cache, absorbed vs naive "
              f"({dtype}, both fed naive's tokens): max |Δlogit| {delta:.4e} (logits up to "
              f"{float(naive.abs().max()):.3f}); tokens equal in {int(same.sum())} of {same.numel()} "
              f"row-steps, {int(decided.sum())} with a naive top-2 margin above 2·max|Δ|")
        if not math.isfinite(delta) or bool((decided & ~same).any()):
            fail(f"serve_mla: absorbed decode ({dtype}) picks other tokens than naive where the margin "
                 f"exceeds 2·{delta:.4f}")
        torch.cuda.empty_cache()


def phase_serve_mla(torch) -> dict:
    """``generate`` at deepseek-v2-lite-16b's full width and depth (27
    layers: a dense ``("mla", "mlp")`` block, then 26 ``("mla", "moe")``;
    64 routed experts top-6 + 2 shared), bf16 over f32 random parameters,
    naive MLA decode: prefill and decode times, peak memory, no flash launch;
    layer 0's MLA and layer 1's MoE FFN on the card against the CPU;
    absorbed decode against naive; a profiled prefill and decode step."""
    t_phase = time.perf_counter()
    cfg, params, prompts, out = serve_full_width(torch, "serve_mla", SERVE_MLA, MLA_P, _describe_mla)
    mla_layer_card_vs_cpu(torch, cfg, params)
    moe_layer_card_vs_cpu(torch, cfg, params, layer=1, label="serve_mla")
    absorbed_against_naive(torch, cfg, params, prompts)
    phase_serve_trace(torch, cfg, params, prompts, tag="mla ")
    del params, prompts
    torch.cuda.empty_cache()
    print(f"serve_mla: {time.perf_counter() - t_phase:.3f} s")
    return out


def _describe_mla(cfg) -> str:
    mla = cfg.mla
    return (f"MLA latent {mla.kv_lora_rank}, rope / nope / v head dims {mla.rope_head_dim} / "
            f"{mla.nope_head_dim} / {mla.v_head_dim}, {mla.decode_mode} decode; dense d_ff {cfg.d_ff}; "
            f"{_describe_moe(cfg)}")


# ---------------------------------------------------------------------------
# train_moe: MoE training at deepseek-v2-lite's full width, cut to 2 layers
# ---------------------------------------------------------------------------
TRAIN_MOE = dict(arch="deepseek-v2-lite-16b", n_layers=2, batch=4, seq=1024, steps=10, lr=3e-3)
MOE_TRAIN_P = 1_085_287_424  # the 2-layer cut: the dense block and one ("mla", "moe")
TRAIN_MOE_SMALL = dict(steps=3, batch=4, seq=64, lr=3e-3)  # card against CPU, f32
TRAIN_MOE_SMALL_ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
# remat on against off on the card, bf16: each gradient leaf's max |Δ| of its
# max |g|, two bf16 ulps (should the gather's or the combine's backward sum a
# token's up to top-k = 6 contributions in another order)
REMAT_GRAD_RTOL = 2.0**-6
MOE_WINDOWS = [(0, 8192), (123_456_789, 5_000), (MOE_TRAIN_P // 2 - 4096, 8192),
               (MOE_TRAIN_P - 8192, 8192)]
FL_MOE = dict(rounds=2, narrow=dict(d_model=64, vocab_size=256))


def moe_train_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_MOE["arch"]), n_layers=TRAIN_MOE["n_layers"])


def train_small_card_vs_cpu(torch, archs=TRAIN_MOE_SMALL_ARCHS, label="train_moe") -> None:
    """TRAIN_MOE_SMALL's steps of each reduced config of ``archs`` (f32) on
    the card and on the CPU from the same parameters: losses and gradient
    norms (and the aux loss of a MoE config) to TRAIN_SMALL_ATOL, each
    positive."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    for arch in archs:
        cfg = get_config(arch, reduced=True)
        keys = ("loss", "aux", "grad_norm") if cfg.moe is not None else ("loss", "grad_norm")
        out = {}
        with _CpuMadeParams():
            for dev in (DEV, "cpu"):
                out[dev] = train.train(cfg, steps=TRAIN_MOE_SMALL["steps"], batch=TRAIN_MOE_SMALL["batch"],
                                       seq=TRAIN_MOE_SMALL["seq"], lr=TRAIN_MOE_SMALL["lr"], device=dev,
                                       log=lambda line: None)[1]
        diffs = {}
        for key in keys:
            card = np.array([r[key] for r in out[DEV]])
            cpu = np.array([r[key] for r in out["cpu"]])
            diffs[key] = float(np.abs(card - cpu).max())
            if not np.allclose(card, cpu, atol=TRAIN_SMALL_ATOL, rtol=0) or not (card > 0).all():
                fail(f"{label}[small {arch}]: card {key} {card.tolist()} against the CPU's {cpu.tolist()}")
        print(f"{label}[small]: {cfg.name} (f32) {TRAIN_MOE_SMALL['steps']} steps of "
              f"{TRAIN_MOE_SMALL['batch']} × {TRAIN_MOE_SMALL['seq']}, card against CPU: max |Δ| "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})} (atol "
              f"{TRAIN_SMALL_ATOL}); card losses {[round(r['loss'], 5) for r in out[DEV]]}, aux "
              f"{[round(r['aux'], 5) for r in out[DEV]]}")


def remat_against_plain(torch, cfg, params, batch) -> dict:
    """One loss and gradient at the full-width cut with remat off and on,
    the same parameters and tokens: the recompute routes as the forward
    did, the loss is the same bits, each gradient leaf within
    REMAT_GRAD_RTOL of its scale."""
    import dataclasses

    from repro_torch.models import model as mdl
    from repro_torch.models.layers import moe as moe_lib

    n_moe = sum(f == "moe" for _, f in cfg.all_blocks)
    names, leaves = zip(*params.named_parameters())
    runs = {}
    route = moe_lib.route
    for remat in (False, True):
        routes = []
        moe_lib.route = lambda *a: routes.append(route(*a)) or routes[-1]
        try:
            loss, metrics = mdl.loss_fn(dataclasses.replace(cfg, remat=remat), params,
                                        batch["tokens"], batch["targets"])
            grads = torch.autograd.grad(loss, leaves)
        finally:
            moe_lib.route = route
        runs[remat] = (loss.detach(), float(metrics["aux"].detach()), grads,
                       [(r.expert, r.kept, r.gate.detach()) for r in routes])
        del loss, metrics, grads
    (l0, a0, g0, r0), (l1, a1, g1, r1) = runs[False], runs[True]
    if (len(r0), len(r1)) != (n_moe, 2 * n_moe):
        fail(f"train_moe[remat]: {len(r0)} and {len(r1)} routings, expected {n_moe} and {2 * n_moe}")
    same_route = all(all(torch.equal(x, y) for x, y in zip(a, b))
                     for a, b in zip(r1[:n_moe] + r0, r1[n_moe:] + r1[:n_moe]))
    worst, worst_leaf, equal = -1.0, "", 0
    for n, a, b in zip(names, g0, g1):
        rel = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        equal += bool(torch.equal(a, b))
        if not rel <= worst:
            worst, worst_leaf = rel, n
    kept = sum(int(r[1].sum()) for r in r1[:n_moe])
    choices = sum(r[1].numel() for r in r1[:n_moe])
    print(f"train_moe[remat]: one loss and gradient at the full-width cut, remat off vs on: loss "
          f"{float(l0):.6f} vs {float(l1):.6f} (bit-equal {bool(torch.equal(l0, l1))}), aux {a0:.7f} "
          f"vs {a1:.7f}; the recompute's expert choices, kept set ({kept} of {choices} kept) and gates "
          f"equal the forward's: {same_route}; gradients: {equal} of {len(names)} leaves bit-equal, "
          f"the largest max |Δ| of its leaf's max |g| {worst:.3e} ({worst_leaf}; limit {REMAT_GRAD_RTOL})")
    if not same_route:
        fail("train_moe[remat]: the recompute routed otherwise than the forward")
    if not torch.equal(l0, l1):
        fail(f"train_moe[remat]: the loss differs with remat on ({float(l1)}) and off ({float(l0)})")
    if not math.isfinite(worst) or worst > REMAT_GRAD_RTOL:
        fail(f"train_moe[remat]: gradient leaf {worst_leaf} differs by {worst:.3e} of its scale")
    return {"grad_rel": worst, "equal_leaves": equal}


def phase_train_moe(torch, name) -> dict:
    """``launch/train.py``'s step on deepseek-v2-lite at full width cut to
    2 layers (MLA, the dense block, one MoE block), bf16 over f32, AdamW,
    clip 1.0, remat on: the reduced MoE configs card against CPU, TRAIN_MOE's
    steps with step ms, tokens/s and peak memory, one step profiled, remat
    on against off."""
    import numpy as np

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train_small_card_vs_cpu(torch)
    cfg = moe_train_cfg()
    print(f"train_moe: {cfg.name} at full width cut to {cfg.n_layers} layers ({cfg.all_blocks}), "
          f"{cfg.dtype} over {cfg.param_dtype}, remat {cfg.remat}, fused_ce {cfg.fused_ce}; batch "
          f"{TRAIN_MOE['batch']} × seq {TRAIN_MOE['seq']}, {TRAIN_MOE['steps']} steps, lr {TRAIN_MOE['lr']}")
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches.update(flash_attention=0)
    start = time.perf_counter()
    state, records = train.train(cfg, steps=TRAIN_MOE["steps"], batch=TRAIN_MOE["batch"],
                                 seq=TRAIN_MOE["seq"], lr=TRAIN_MOE["lr"], device=DEV, log_every=1,
                                 log=lines.append)
    torch.cuda.synchronize()
    launches = fa_ops.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    for line, r in zip(lines, records):
        print(f"train_moe: {line} aux {r['aux']:.6f}")
    n = mdl.param_count(state["params"])
    step_ms = np.diff([start] + [r["t"] for r in records]) * 1e3
    print(f"train_moe: {n} parameters; step ms: first {step_ms[0]:.3f}, then median "
          f"{float(np.median(step_ms[1:])):.3f} (min {step_ms[1:].min():.3f}, max "
          f"{step_ms[1:].max():.3f}); {TRAIN_MOE['batch'] * TRAIN_MOE['seq'] / np.median(step_ms[1:]) * 1e3:.1f} "
          f"tokens/s; peak device memory {peak} B ({peak / 2**30:.2f} GiB); flash launches {launches}")
    if n != MOE_TRAIN_P:
        fail(f"train_moe: {n} parameters, expected {MOE_TRAIN_P}")
    for r in records:
        if not all(math.isfinite(r[k]) for k in ("loss", "ce", "aux", "grad_norm")) or not r["aux"] > 0:
            fail(f"train_moe: a loss, aux or gradient norm is not finite, or aux is not positive: {r}")
    if launches:
        fail(f"train_moe: {launches} flash launches, expected none (MLA is torch ops)")
    step_fn = steps.make_train_step(cfg, adamw(linear_warmup_cosine(
        TRAIN_MOE["lr"], TRAIN_MOE["steps"] // 10 + 1, TRAIN_MOE["steps"])))
    bt = TokenPipeline(cfg.vocab_size, TRAIN_MOE["batch"], TRAIN_MOE["seq"], seed=1).next_batch()
    batch = {k: torch.from_numpy(v).to(DEV, torch.int64)
             for k, v in (("tokens", bt.tokens), ("targets", bt.targets))}
    lm_trace(torch, "train_moe", lambda: step_fn(state, batch), "one more train step")
    params = state["params"]
    del state, step_fn
    torch.cuda.empty_cache()
    remat = remat_against_plain(torch, cfg, params, batch)
    del params
    torch.cuda.empty_cache()
    print(f"train_moe: {time.perf_counter() - t0:.3f} s")
    return {"flash": launches, "step_ms": float(np.median(step_ms[1:])), "peak": peak, **remat}


def phase_fl_moe(torch, name) -> dict:
    """The federated LM on a MoE: B2 and B3 at (8, MOE_TRAIN_P), the narrow
    reduced deepseek-v2-lite card against CPU, then run_federated_lm on
    train_moe's 2-layer cut with FLLMConfig's defaults for FL_MOE's rounds,
    md and sketched Algorithm 2. Returns the launches of the two full-width
    runs together, and the kernels' errors and times."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kern = lm_kernels(torch, name, MOE_TRAIN_P, MOE_WINDOWS, label="fl_moe")
    fl_lm_small(torch, TRAIN_MOE["arch"], FL_MOE["narrow"], label="fl_moe")
    cfg = moe_train_cfg()
    md = fl_lm_run(torch, "moe md", "md", "sync", cfg, MOE_TRAIN_P, FL_MOE["rounds"])
    a2 = fl_lm_run(torch, "moe algorithm2[srp]", "algorithm2", FL_LM_SKETCH, cfg, MOE_TRAIN_P,
                   FL_MOE["rounds"])
    torch.cuda.empty_cache()
    local_step_trace(torch, cfg, "moe local_step")
    torch.cuda.empty_cache()
    print(f"fl_moe: {time.perf_counter() - t0:.3f} s")
    return {"launches": {k: md[k] + a2[k] for k in md}, "kernels": kern}


# ---------------------------------------------------------------------------
# the recurrent mixers: recurrentgemma-9b (RG-LRU + local attention) and
# xlstm-125m (mLSTM + sLSTM) served, trained and federated at full width
# ---------------------------------------------------------------------------
SERVE_RGLRU = dict(arch="recurrentgemma-9b", batch=4, prompt_len=1000, gen=16)
RGLRU_P = 9_396_408_320  # recurrentgemma-9b's parameters
SERVE_XLSTM = dict(arch="xlstm-125m", batch=4, prompt_len=1000, gen=16)
XLSTM_P = 143_345_712  # xlstm-125m's parameters
RECURRENT_RTOL = MOE_LAYER_RTOL  # f32 card vs CPU, decode vs forward: of the scale max |·|
# decode past the window at full width, f32: 2,060 mod 2,048 = 12 rolls the ring
RGLRU_PAST_WINDOW = dict(batch=1, prompt_len=2060, steps=4)
XLSTM_DECODE = dict(batch=4, prompt_len=1000, steps=4)
SMALL_CHUNK = dict(arch="xlstm-125m", mlstm_chunk=8, prompt_len=24)  # mlstm_chunkwise on the card
TRAIN_RECURRENT = dict(batch=4, seq=1024, steps=3, lr=3e-3)  # steps cut from 10: the sLSTM loop
# the profiled step's sequence: xLSTM's at 1,024 (657,270 device events and
# more host ones) took the profiler ~400 s to report
TRAIN_RECURRENT_TRACE_SEQ = {"xlstm": 128, "rglru": 1024}
RGLRU_TRAIN_P = 1_705_078_784  # recurrentgemma-9b cut to its first period (rglru, rglru, local)
XLSTM_WINDOWS = [(0, 8192), (123_456_789, 5_000), (XLSTM_P // 2 - 4096, 8192), (XLSTM_P - 8192, 8192)]
# rounds cut from 2 (a round is ~45 s of host launches) and local steps from
# FLLMConfig's 4 (the smoke's time, as the sharded phase joined); lr cut
# from FLLMConfig's 0.05, under which the full-width xLSTM diverged on the
# card (md's second round's loss 14.5 from 11.3, algorithm2's NaN)
FL_XLSTM = dict(rounds=1, lr=0.01, local_steps=2, narrow=dict(d_model=64, vocab_size=256))


def small_serve_chunked(torch) -> None:
    """Reduced xlstm-125m (f32) with ``mlstm_chunk`` 8 and a 24-token prompt
    on the card against the CPU: the prefill runs ``mlstm_chunkwise`` on
    each device; equal tokens, logits to SERVE_SMALL_ATOL."""
    from repro_torch.models.layers import xlstm as xlstm_lib

    arch, chunk, p = SMALL_CHUNK["arch"], SMALL_CHUNK["mlstm_chunk"], SMALL_CHUNK["prompt_len"]
    seen, real = [], xlstm_lib.mlstm_chunkwise
    xlstm_lib.mlstm_chunkwise = lambda cfg, params, z, c: seen.append(z.device.type) or real(cfg, params, z, c)
    try:
        cpu, gpu = (_serve_small(torch, dev, "float32", arch, p, mlstm_chunk=chunk) for dev in ("cpu", DEV))
    finally:
        xlstm_lib.mlstm_chunkwise = real
    if seen != ["cpu", torch.device(DEV).type]:
        fail(f"small input [serve, {arch}, mlstm_chunk {chunk}]: mlstm_chunkwise ran on {seen}")
    e = float((cpu[1] - gpu[1]).abs().max())
    if not torch.equal(cpu[0], gpu[0]) or not math.isfinite(e) or e > SERVE_SMALL_ATOL:
        fail(f"small input [serve, {arch}, mlstm_chunk {chunk}]: tokens {gpu[0].tolist()} vs the "
             f"CPU's {cpu[0].tolist()}, logits differ by {e}")
    print(f"kernels: small input [serve] (reduced {arch}, mlstm_chunk {chunk}, prompt {p}, f32), card "
          f"vs CPU: mlstm_chunkwise in each prefill, token ids equal, max logit diff {e:.2e} (atol "
          f"{SERVE_SMALL_ATOL})")


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def rglru_layers_card_vs_cpu(torch, cfg, params) -> None:
    """Layer 0's RG-LRU block and layer 2's local attention at full width in
    f32 (TF32 off) on the card and on the CPU, on the same (batch, prompt,
    d_model) input: the block's output and final state (h, conv tail), the
    attention's output and its k and v, each within RECURRENT_RTOL of its
    scale."""
    import dataclasses

    from repro_torch.models import model as mdl
    from repro_torch.models.layers import attention as attn_lib
    from repro_torch.models.layers import rglru as rglru_lib

    if (cfg.all_blocks[0][0], cfg.all_blocks[2][0]) != ("rglru", "local"):
        fail(f"serve_rglru: layers 0 and 2 are {cfg.all_blocks[0]} and {cfg.all_blocks[2]}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, p = SERVE_RGLRU["batch"], SERVE_RGLRU["prompt_len"]
    x = torch.randn((b, p, cfg.d_model), generator=torch.Generator().manual_seed(7))
    out = {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        rec, attn = params.blocks[0]["rec"], params.blocks[2]["attn"]
        if dev == "cpu":
            rec, attn = _to_cpu(torch, rec), _to_cpu(torch, attn)
        xd = x.to(dev)
        with torch.inference_mode():
            y, st = rglru_lib.rglru_block(cfg32, rec, xd, None)
            angles = mdl.make_angles(cfg32, torch.arange(p, device=dev))
            ya, kv = attn_lib.attention_full(cfg32, attn, xd, angles, window=cfg.sliding_window)
        out[where] = {"rglru y": y.cpu(), "h": st["h"].cpu(), "conv": st["conv"].cpu(),
                      "local y": ya.cpu(), "k": kv["k"].cpu(), "v": kv["v"].cpu()}
        del y, st, ya, kv
    rels = {k: _rel(out["card"][k], out["cpu"][k]) for k in out["cpu"]}
    print(f"serve_rglru: layer 0's RG-LRU block (lru width {cfg.lru_width or cfg.d_model}, conv "
          f"{cfg.rglru_conv_width}) and layer 2's local attention (window {cfg.sliding_window}, "
          f"{cfg.n_heads} heads, 1 kv head of {cfg.resolved_head_dim}) at full width on {tuple(x.shape)}, "
          f"f32 card vs CPU: max |Δ| of its scale "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} (limit {RECURRENT_RTOL})")
    if not all(math.isfinite(v) and v <= RECURRENT_RTOL for v in rels.values()):
        fail(f"serve_rglru: the full-width layers differ card vs CPU by {rels} of their scale")
    torch.cuda.empty_cache()


def decode_against_forward(torch, label, cfg, params, spec) -> float:
    """In f32 (TF32 off): a prefill of ``prompt_len`` tokens of one random
    sequence, then ``steps`` decode steps each fed the sequence's next
    token; the prefill's last logits and each step's against one full
    forward over prompt_len + steps tokens at the same positions, within
    RECURRENT_RTOL of the logits' scale. Checks the final states a prefill
    hands to decode (and, for recurrentgemma past its window, the ring's
    roll and slot; for whisper the cross-attention's ck / cv). A model with
    a front end gets its zero stubs in both the prefill and the forward."""
    import dataclasses

    from repro_torch.launch.steps import frontend_stubs
    from repro_torch.models import model as mdl

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    n, p, k = spec["batch"], spec["prompt_len"], spec["steps"]
    g = torch.Generator(device=DEV).manual_seed(8)
    seq = torch.randint(0, cfg.vocab_size, (n, p + k), generator=g, device=DEV)
    extras = frontend_stubs(cfg32, n, DEV)
    t0 = time.perf_counter()
    with torch.inference_mode():
        caches = mdl.init_cache(cfg32, n, p + k, device=DEV)
        hidden, caches, _ = mdl.forward(cfg32, params, seq[:, :p], caches=caches, **extras)
        steps = [mdl.logits_from_hidden(cfg32, params, hidden[:, -1:])[:, 0]]
        del hidden
        rings = sorted({c["k"].shape[1] for kind, c in zip(cfg.all_blocks, caches["layers"])
                        if kind[0] == "local"})
        for t in range(k):
            step, caches = mdl.decode_step(cfg32, params, seq[:, p + t:p + t + 1], caches)
            steps.append(step)
        del caches
        full, _, _ = mdl.forward(cfg32, params, seq, **extras)
        want = mdl.logits_from_hidden(cfg32, params, full[:, p - 1:])
        del full
    torch.cuda.synchronize()
    got = torch.stack(steps, dim=1)
    rel = _rel(got, want)
    ring = (f"; local KV ring of {rings} slots, the prefill rolled by {p % cfg.sliding_window}"
            if rings else "")
    print(f"{label}: f32 decode against the forward: batch {n}, prompt {p}, {k} decode steps{ring}: "
          f"logits at positions {p - 1}..{p + k - 1} max |Δ| {rel:.3e} of max |logit| "
          f"{float(want.abs().max()):.3f} (limit {RECURRENT_RTOL}); argmax equal at "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())} of {n * (k + 1)}; {time.perf_counter() - t0:.3f} s")
    if not math.isfinite(rel) or rel > RECURRENT_RTOL:
        fail(f"{label}: decode's logits differ from the forward's by {rel:.3e} of their scale")
    torch.cuda.empty_cache()
    return rel


def phase_serve_rglru(torch) -> dict:
    """``generate`` at recurrentgemma-9b's full width and depth (38 layers:
    12 × (rglru, rglru, local) + 2 rglru; d_model 4,096, 16 heads with one
    kv head of 256, window 2,048, d_ff 12,288), bf16 over f32 random
    parameters: times, peak memory, no flash launch; layer 0's RG-LRU block
    and layer 2's local attention card vs CPU in f32; decode past the
    2,048-token window against a full forward in f32; a profiled prefill
    and decode step."""
    t0 = time.perf_counter()
    cfg, params, prompts, out = serve_full_width(
        torch, "serve_rglru", SERVE_RGLRU, RGLRU_P,
        lambda c: f"window {c.sliding_window}, lru width {c.lru_width or c.d_model}, conv "
                  f"{c.rglru_conv_width}, d_ff {c.d_ff} ({c.act})")
    rglru_layers_card_vs_cpu(torch, cfg, params)
    out["past_window_rel"] = decode_against_forward(torch, "serve_rglru", cfg, params, RGLRU_PAST_WINDOW)
    phase_serve_trace(torch, cfg, params, prompts, tag="rglru ")
    del params, prompts
    torch.cuda.empty_cache()
    print(f"serve_rglru: {time.perf_counter() - t0:.3f} s")
    return out


def phase_serve_xlstm(torch) -> dict:
    """``generate`` at xlstm-125m's full width and depth (12 layers
    alternating mLSTM and sLSTM, d_model 768, 4 heads), bf16 over f32
    random parameters: times, peak memory, no flash launch; decode against
    a full forward in f32; a profiled prefill and decode step."""
    t0 = time.perf_counter()
    cfg, params, prompts, out = serve_full_width(
        torch, "serve_xlstm", SERVE_XLSTM, XLSTM_P,
        lambda c: f"mLSTM / sLSTM projection factors {c.mlstm_proj_factor} / {c.slstm_proj_factor}, "
                  "no FFN")
    out["decode_rel"] = decode_against_forward(torch, "serve_xlstm", cfg, params, XLSTM_DECODE)
    phase_serve_trace(torch, cfg, params, prompts, tag="xlstm ")
    del params, prompts
    torch.cuda.empty_cache()
    print(f"serve_xlstm: {time.perf_counter() - t0:.3f} s")
    return out


def rglru_train_cfg():
    """recurrentgemma-9b at full width cut to its first period: (rglru, rglru, local)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(SERVE_RGLRU["arch"])
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern), tail_blocks=())


def phase_train_recurrent(torch, name) -> dict:
    """``launch/train.py``'s step (AdamW, clip 1.0, remat as each config
    sets it, bf16 over f32) on xlstm-125m at full width and depth and on
    recurrentgemma-9b at full width cut to its first period, TRAIN_RECURRENT's
    steps of 4 × 1,024: the reduced configs card against CPU first; then
    finite losses that fall, no flash launch, step ms, tokens/s, peak
    memory and one more step profiled, for each."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train_small_card_vs_cpu(torch, (SERVE_RGLRU["arch"], SERVE_XLSTM["arch"]), "train_recurrent")
    spec = TRAIN_RECURRENT
    out = {"flash": 0}
    for label, cfg, want_p in (("xlstm", get_config(SERVE_XLSTM["arch"]), XLSTM_P),
                               ("rglru", rglru_train_cfg(), RGLRU_TRAIN_P)):
        print(f"train_recurrent[{label}]: {cfg.name} at full width, {cfg.n_layers} layers "
              f"({_blocks_summary(cfg)}), {cfg.dtype} over {cfg.param_dtype}, remat {cfg.remat}, "
              f"fused_ce {cfg.fused_ce}; batch {spec['batch']} × seq {spec['seq']}, {spec['steps']} "
              f"steps, lr {spec['lr']}")
        lines = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.launches.update(flash_attention=0)
        start = time.perf_counter()
        state, records = train.train(cfg, steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
                                     lr=spec["lr"], device=DEV, log_every=1, log=lines.append)
        torch.cuda.synchronize()
        launches = fa_ops.launches["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            print(f"train_recurrent[{label}]: {line}")
        n = mdl.param_count(state["params"])
        step_ms = np.diff([start] + [r["t"] for r in records]) * 1e3
        med = float(np.median(step_ms[1:]))
        print(f"train_recurrent[{label}]: {n} parameters; step ms: first {step_ms[0]:.3f}, then "
              f"{[round(float(x), 3) for x in step_ms[1:]]} (median {med:.3f}); "
              f"{spec['batch'] * spec['seq'] / med * 1e3:.1f} tokens/s; peak device memory {peak} B "
              f"({peak / 2**30:.2f} GiB); flash launches {launches}")
        if n != want_p:
            fail(f"train_recurrent[{label}]: {n} parameters, expected {want_p}")
        losses = [r["loss"] for r in records]
        if not all(math.isfinite(r[k]) for r in records for k in ("loss", "ce", "grad_norm")):
            fail(f"train_recurrent[{label}]: a loss or gradient norm is not finite: {records}")
        if not losses[-1] < losses[0]:
            fail(f"train_recurrent[{label}]: the loss did not fall: {losses}")
        if launches:
            fail(f"train_recurrent[{label}]: {launches} flash launches, expected none")
        step_fn = steps.make_train_step(cfg, adamw(linear_warmup_cosine(
            spec["lr"], spec["steps"] // 10 + 1, spec["steps"])))
        seq = TRAIN_RECURRENT_TRACE_SEQ[label]
        bt = TokenPipeline(cfg.vocab_size, spec["batch"], seq, seed=1).next_batch()
        batch = {k: torch.from_numpy(v).to(DEV, torch.int64)
                 for k, v in (("tokens", bt.tokens), ("targets", bt.targets))}
        lm_trace(torch, f"train_recurrent[{label}]", lambda: step_fn(state, batch),
                 f"one more train step of {spec['batch']} × {seq}")
        del state, step_fn, batch
        torch.cuda.empty_cache()
        out["flash"] += launches
        out[label] = {"step_ms": med, "peak": peak, "losses": losses}
    print(f"train_recurrent: {time.perf_counter() - t0:.3f} s")
    return out


def phase_fl_xlstm(torch, name) -> dict:
    """The federated LM on xlstm-125m at full width and depth: B2 and B3 at
    (8, XLSTM_P) as in fl_lm, the narrow reduced xLSTM card against CPU,
    then run_federated_lm with FLLMConfig's defaults but FL_XLSTM's rounds,
    local steps and lr, md and sketched Algorithm 2, and one local step profiled. Returns the
    launches of the two full-width runs together, and the kernels' errors
    and times."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kern = lm_kernels(torch, name, XLSTM_P, XLSTM_WINDOWS, label="fl_xlstm")
    fl_lm_small(torch, SERVE_XLSTM["arch"], FL_XLSTM["narrow"], label="fl_xlstm")
    cfg = get_config(SERVE_XLSTM["arch"])
    kw = dict(lr=FL_XLSTM["lr"], n_local_steps=FL_XLSTM["local_steps"])
    md = fl_lm_run(torch, "xlstm md", "md", "sync", cfg, XLSTM_P, FL_XLSTM["rounds"], **kw)
    a2 = fl_lm_run(torch, "xlstm algorithm2[srp]", "algorithm2", FL_LM_SKETCH, cfg, XLSTM_P,
                   FL_XLSTM["rounds"], **kw)
    torch.cuda.empty_cache()
    local_step_trace(torch, cfg, "xlstm local_step")
    torch.cuda.empty_cache()
    print(f"fl_xlstm: {time.perf_counter() - t0:.3f} s")
    return {"launches": {k: md[k] + a2[k] for k in md}, "kernels": kern}


# ---------------------------------------------------------------------------
# the front ends' models: whisper-small (the encoder, cross-attention,
# sinusoidal positions) and qwen2-vl-2b (M-RoPE, vision embeddings) served,
# trained and, qwen2-vl, federated at full width
# ---------------------------------------------------------------------------
SERVE_WHISPER = dict(arch="whisper-small", batch=4, prompt_len=1000, gen=16)
WHISPER_P = 294_766_848  # whisper-small's parameters, its 12 encoder blocks included
SERVE_VL = dict(arch="qwen2-vl-2b", batch=4, prompt_len=1000, gen=16)
VL_P = 1_543_714_304  # qwen2-vl-2b's parameters (qwen2-1.5b's backbone)
EXTRAS_DECODE = dict(batch=4, prompt_len=1000, steps=4)  # f32 decode against the forward
TRAIN_EXTRAS = dict(batch=4, seq=1024, steps=3, lr=3e-3)
FLASH_WHISPER_TRAIN = (4, 1024, 12, 12, 64)  # whisper's decoder attention at the train batch
VL_WINDOWS = [(0, 8192), (123_456_789, 5_000), (VL_P // 2 - 4096, 8192), (VL_P - 8192, 8192)]
# the narrow reduced qwen2-vl's 4 heads of 16 take M-RoPE sections of 8 pairs
FL_VL = dict(rounds=1, narrow=dict(d_model=64, vocab_size=256, mrope_sections=(4, 2, 2)))
DECODER = ("attn", "mlp")
VISION_SEED = 11


class _DrawnVisionEmbeds:
    """``launch/train.py``'s batches get seeded random vision embeddings
    (normal at the token embeddings' scale d^-½, in ``cfg.dtype``) in place
    of the zero stubs, for a VLM only. Under the zero stubs the leading rows
    stay exactly zero through every layer, rmsnorm's Jacobian there is
    1/√ε = 1,000, and the gradient grows ~10³ a layer: at qwen2-vl's depth
    it overflows in the reference as in the port (ROADMAP, "Known state")."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.launch import train

        self.train, self.orig = train, train.frontend_stubs

        def drawn(cfg, batch, device):
            if cfg.frontend != "vision":
                return self.orig(cfg, batch, device)
            g = self.torch.Generator(device=device).manual_seed(VISION_SEED)
            shape = (batch, cfg.n_vision_tokens, cfg.d_model)
            return {"vision_embeds": (self.torch.randn(shape, generator=g, device=device)
                                      * cfg.d_model**-0.5).to(getattr(self.torch, cfg.dtype))}

        train.frontend_stubs = drawn
        return drawn

    def __exit__(self, *exc):
        self.train.frontend_stubs = self.orig


def whisper_layers_card_vs_cpu(torch, cfg, params) -> None:
    """Encoder block 0 and decoder block 0 (self-attention through the f32
    flash kernel, cross-attention to random encoder states) at full width
    in f32 (TF32 off), on the card and on the CPU, on the same inputs: the
    encoder block's output and the decoder block's output and its cache's
    ck and cv, each within RECURRENT_RTOL of its scale."""
    import dataclasses

    from repro_torch.models import blocks as blk

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, p, f = SERVE_WHISPER["batch"], SERVE_WHISPER["prompt_len"], cfg.encoder.n_frames
    g = torch.Generator().manual_seed(7)
    x = torch.randn((b, p, cfg.d_model), generator=g)
    enc = torch.randn((b, f, cfg.d_model), generator=g)
    out = {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        enc_block, dec_block = params.encoder.blocks[0], params.blocks[0]
        if dev == "cpu":
            enc_block, dec_block = _to_cpu(torch, enc_block), _to_cpu(torch, dec_block)
        with torch.inference_mode():
            ye = blk.block_apply(cfg32, blk.ENCODER, enc_block, enc.to(dev), angles=None,
                                 mode="full")[0]
            cache = blk.init_block_cache(cfg32, DECODER, b, p, torch.float32, dev, cross_len=f)
            yd, cache, _ = blk.block_apply(cfg32, DECODER, dec_block, x.to(dev), angles=None,
                                           mode="full", cache=cache, enc_out=enc.to(dev))
        out[where] = {"encoder y": ye.cpu(), "decoder y": yd.cpu(), "ck": cache["ck"].cpu(),
                      "cv": cache["cv"].cpu()}
        del ye, yd, cache
    rels = {k: _rel(out["card"][k], out["cpu"][k]) for k in out["cpu"]}
    print(f"serve_whisper: encoder block 0 (bidirectional, {f} frames) and decoder block 0 (causal "
          f"self-attention, cross-attention to {f} encoder states) at full width, f32 card vs CPU on "
          f"{(b, p, cfg.d_model)} / {(b, f, cfg.d_model)}: max |Δ| of its scale "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} (limit {RECURRENT_RTOL})")
    if not all(math.isfinite(v) and v <= RECURRENT_RTOL for v in rels.values()):
        fail(f"serve_whisper: the full-width layers differ card vs CPU by {rels} of their scale")
    torch.cuda.empty_cache()


def vl_layer_card_vs_cpu(torch, cfg, params) -> None:
    """qwen2-vl's M-RoPE angles at the serve cut's positions, card vs CPU,
    and layer 0's attention rotated by them at full width in f32 (TF32 off):
    its output, k and v within RECURRENT_RTOL of their scale."""
    import dataclasses

    from repro_torch.models import model as mdl
    from repro_torch.models.layers import attention as attn_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, p = SERVE_VL["batch"], SERVE_VL["prompt_len"]
    x = torch.randn((b, p, cfg.d_model), generator=torch.Generator().manual_seed(7))
    out = {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        attn = params.blocks[0]["attn"]
        if dev == "cpu":
            attn = _to_cpu(torch, attn)
        with torch.inference_mode():
            angles = mdl.make_angles(cfg32, torch.arange(p, device=dev))
            y, kv = attn_lib.attention_full(cfg32, attn, x.to(dev), angles)
        out[where] = {"angles": angles.cpu(), "y": y.cpu(), "k": kv["k"].cpu(), "v": kv["v"].cpu()}
        del y, kv
    rels = {k: _rel(out["card"][k], out["cpu"][k]) for k in out["cpu"]}
    print(f"serve_vl: M-RoPE angles (sections {cfg.mrope_sections}, theta {cfg.rope_theta:g}) at "
          f"positions 0..{p - 1} and layer 0's attention at full width, f32 card vs CPU on "
          f"{tuple(x.shape)}: max |Δ| of its scale "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} (limit {RECURRENT_RTOL})")
    if not all(math.isfinite(v) and v <= RECURRENT_RTOL for v in rels.values()):
        fail(f"serve_vl: M-RoPE or the full-width attention differ card vs CPU by {rels}")
    torch.cuda.empty_cache()


def phase_serve_whisper(torch) -> dict:
    """``generate`` at whisper-small's full width and depth (12 encoder
    blocks over 1,500 zero stub frames, 12 decoder blocks with
    cross-attention; d_model 768, 12 heads with 12 kv heads of 64), bf16
    over f32 random parameters: times, peak memory, 12 flash launches in
    the prefill and none in decode; the new layer kinds card vs CPU in f32;
    decode against a full forward in f32; a profiled prefill and decode
    step."""
    t0 = time.perf_counter()
    cfg, params, prompts, out = serve_full_width(
        torch, "serve_whisper", SERVE_WHISPER, WHISPER_P,
        lambda c: f"encoder {c.encoder.n_layers} bidir blocks over {c.encoder.n_frames} frames, "
                  f"cross-attention, sinusoidal positions, d_ff {c.d_ff} ({c.act})")
    whisper_layers_card_vs_cpu(torch, cfg, params)
    out["decode_rel"] = decode_against_forward(torch, "serve_whisper", cfg, params, EXTRAS_DECODE)
    phase_serve_trace(torch, cfg, params, prompts, tag="whisper ")
    del params, prompts
    torch.cuda.empty_cache()
    print(f"serve_whisper: {time.perf_counter() - t0:.3f} s")
    return out


def phase_serve_vl(torch) -> dict:
    """``generate`` at qwen2-vl-2b's full width and depth (28 layers, d_model
    1,536, 12 heads with 2 kv heads of 128, M-RoPE sections (16, 24, 24),
    256 zero vision slots), bf16 over f32 random parameters: times, peak
    memory, 28 flash launches in the prefill and none in decode; M-RoPE and
    layer 0's attention card vs CPU in f32; decode against a full forward in
    f32; a profiled prefill and decode step."""
    t0 = time.perf_counter()
    cfg, params, prompts, out = serve_full_width(
        torch, "serve_vl", SERVE_VL, VL_P,
        lambda c: f"M-RoPE sections {c.mrope_sections}, {c.n_vision_tokens} vision slots, d_ff {c.d_ff}")
    vl_layer_card_vs_cpu(torch, cfg, params)
    out["decode_rel"] = decode_against_forward(torch, "serve_vl", cfg, params, EXTRAS_DECODE)
    phase_serve_trace(torch, cfg, params, prompts, tag="vl ")
    del params, prompts
    torch.cuda.empty_cache()
    print(f"serve_vl: {time.perf_counter() - t0:.3f} s")
    return out


def phase_train_extras(torch, gen, name) -> dict:
    """``launch/train.py``'s step (AdamW, clip 1.0, remat on, bf16 over f32)
    on whisper-small (the zero stub frames) and qwen2-vl-2b (seeded random
    vision embeddings, ``_DrawnVisionEmbeds``) at full width and depth,
    TRAIN_EXTRAS' steps of 4 × 1,024: the reduced configs card against CPU
    first (the zero stubs); then finite losses, flash launched once an attention
    layer a forward and again in the backward under remat, step ms,
    tokens/s, peak memory and one more step profiled, for each; then B4 at
    whisper's train shape, forward and backward held against the plain
    version, and timed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train_small_card_vs_cpu(torch, (SERVE_WHISPER["arch"], SERVE_VL["arch"]), "train_extras")
    spec = TRAIN_EXTRAS
    out = {}
    for label, arch, want_p in (("whisper", SERVE_WHISPER["arch"], WHISPER_P),
                                ("vl", SERVE_VL["arch"], VL_P)):
        cfg = get_config(arch)
        per_step = sum(m == "attn" for m, _ in cfg.all_blocks) * (2 if cfg.remat else 1)
        print(f"train_extras[{label}]: {cfg.name} at full width, {cfg.n_layers} layers "
              f"({_blocks_summary(cfg)}), {cfg.dtype} over {cfg.param_dtype}, remat {cfg.remat}, "
              f"fused_ce {cfg.fused_ce}, {cfg.frontend} front end; batch {spec['batch']} × seq "
              f"{spec['seq']}, {spec['steps']} steps, lr {spec['lr']}")
        lines = []
        with _DrawnVisionEmbeds(torch) as stubs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa_ops.launches.update(flash_attention=0)
            start = time.perf_counter()
            state, records = train.train(cfg, steps=spec["steps"], batch=spec["batch"],
                                         seq=spec["seq"], lr=spec["lr"], device=DEV, log_every=1,
                                         log=lines.append)
            torch.cuda.synchronize()
        launches = fa_ops.launches["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            print(f"train_extras[{label}]: {line}")
        n = mdl.param_count(state["params"])
        step_ms = np.diff([start] + [r["t"] for r in records]) * 1e3
        med = float(np.median(step_ms[1:]))
        print(f"train_extras[{label}]: {n} parameters; step ms: first {step_ms[0]:.3f}, then "
              f"{[round(float(x), 3) for x in step_ms[1:]]} (median {med:.3f}); "
              f"{spec['batch'] * spec['seq'] / med * 1e3:.1f} tokens/s; peak device memory {peak} B "
              f"({peak / 2**30:.2f} GiB); flash launches {launches}, predicted "
              f"{per_step * spec['steps']} ({per_step} a step)")
        if n != want_p:
            fail(f"train_extras[{label}]: {n} parameters, expected {want_p}")
        if not all(math.isfinite(r[k]) for r in records for k in ("loss", "ce", "grad_norm")):
            fail(f"train_extras[{label}]: a loss or gradient norm is not finite: {records}")
        if launches != per_step * spec["steps"]:
            fail(f"train_extras[{label}]: {launches} flash launches, expected "
                 f"{per_step * spec['steps']}")
        step_fn = steps.make_train_step(cfg, adamw(linear_warmup_cosine(
            spec["lr"], spec["steps"] // 10 + 1, spec["steps"])))
        bt = TokenPipeline(cfg.vocab_size, spec["batch"], spec["seq"], seed=1).next_batch()
        batch = {k: torch.from_numpy(v).to(DEV, torch.int64)
                 for k, v in (("tokens", bt.tokens), ("targets", bt.targets))}
        batch.update(stubs(cfg, spec["batch"], DEV))
        lm_trace(torch, f"train_extras[{label}]", lambda: step_fn(state, batch),
                 f"one more train step of {spec['batch']} × {spec['seq']}")
        del state, step_fn, batch
        torch.cuda.empty_cache()
        out[label] = {"flash": launches, "step_ms": med, "peak": peak,
                      "losses": [r["loss"] for r in records]}
    out["grad_excess"] = flash_grads_at(torch, gen, FLASH_WHISPER_TRAIN, torch.bfloat16,
                                        "train_extras")
    out["times"] = flash_train_times(torch, gen, name, FLASH_WHISPER_TRAIN)
    print(f"train_extras: {time.perf_counter() - t0:.3f} s")
    return out


def phase_fl_vl(torch, name) -> dict:
    """The federated LM on qwen2-vl-2b at full width and depth (the local
    step trains on tokens alone, M-RoPE with t = h = w, as in the
    reference): B2 and B3 at (8, VL_P) as in fl_lm, the narrow reduced
    qwen2-vl card against CPU, then run_federated_lm with FLLMConfig's
    defaults for FL_VL's rounds, md and sketched Algorithm 2, and one local
    step profiled. Returns the launches of the two full-width runs together,
    and the kernels' errors and times."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kern = lm_kernels(torch, name, VL_P, VL_WINDOWS, label="fl_vl")
    fl_lm_small(torch, SERVE_VL["arch"], FL_VL["narrow"], label="fl_vl")
    cfg = get_config(SERVE_VL["arch"])
    torch.cuda.empty_cache()  # a round needs its (8, VL_P) stack, 46 GiB, in one block
    md = fl_lm_run(torch, "vl md", "md", "sync", cfg, VL_P, FL_VL["rounds"])
    torch.cuda.empty_cache()
    a2 = fl_lm_run(torch, "vl algorithm2[srp]", "algorithm2", FL_LM_SKETCH, cfg, VL_P,
                   FL_VL["rounds"])
    torch.cuda.empty_cache()
    local_step_trace(torch, cfg, "vl local_step")
    torch.cuda.empty_cache()
    print(f"fl_vl: {time.perf_counter() - t0:.3f} s")
    return {"launches": {k: md[k] + a2[k] for k in md}, "kernels": kern}


# ---------------------------------------------------------------------------
# bench: the port's bench_* modules in full mode on the card
# ---------------------------------------------------------------------------
#: each module's arguments, beside --device cuda (the reference's full mode)
BENCH_ARGS = {
    "bench_fl_collectives": [],
    "bench_sampler_cost": [],
    "bench_round_engine": [],
    "bench_kernels": [],
    "bench_store_scale": [],
    "bench_async_planner": ["--drift"],
    "bench_service_churn": [],
    "bench_scheduler": [],
}
#: each module's rows in full mode, in order: the reference's names
#: (bench_kernels' mapped by its ROW_MAP, and its two wrapper rows with no
#: reference counterpart); tests/test_torch_bench_fl.py holds this list
#: against the reference's modules
BENCH_ROWS = {
    "bench_fl_collectives": [
        "fl_comm/per_client_round_bytes", "fl_comm/sync_dp_equivalent_bytes",
        "fl_comm/clustered_extra_wire_bytes", "fl_comm/server_round_bytes"],
    "bench_sampler_cost": (
        [f"sampler_cost/algorithm1/n={n}" for n in (50, 100, 200, 400)]
        + [f"sampler_cost/algorithm2/n={n}" for n in (50, 100, 200)]
        + [f"sampler_cost/draw/{s}" for s in ("algorithm1", "algorithm2", "dp_stratified", "hybrid",
                                               "importance", "md", "stratified", "target",
                                               "uniform")]),
    "bench_round_engine": [f"round_engine/m={m}/{e}" for m in (5, 10, 40)
                           for e in ("compat", "batched")],
    "bench_kernels": [
        "kernels/similarity_gram_plain", "kernels/similarity_cuda", "kernels/aggregate_plain",
        "kernels/aggregate_cuda", "kernels/flash_attention_plain", "kernels/flash_attention_cuda"],
    "bench_store_scale": (
        [f"store/n={n}/d={d}/{k}" for n, d in ((1_000, 10_000), (1_000, 100_000), (10_000, 10_000),
                                                (10_000, 100_000), (100_000, 10_000))
         for k in ("exact", "srp64")]
        + [f"rebuild/n={n}/d=10000/{k}" for n in (10_000, 100_000) for k in ("exact", "srp64")]),
    "bench_async_planner": (
        [f"async_planner/n={n}/{p}" for n in (200, 400) for p in ("sync", "async")]
        + [f"similarity_streamed/n=128/d={d}/{k}" for d in (512, 2048, 8192)
           for k in ("one_shot", "streamed")]
        + [f"plan_rebuild/n=512/{c}" for c in ("ward_host", "ward_jit", "kmeans")]
        + [f"plan_rebuild/n=10000/{c}" for c in ("kmeans_cold", "kmeans_warm",
                                                  "host_distances_only", "fused_distances")]
        + ["drift_planner/n=200/fixed", "drift_planner/n=200/threshold=0.2"]),
    "bench_service_churn": [f"service_churn/{s}" for s in ("static", "dropout10", "dropout30",
                                                          "poisson", "diurnal+drop")],
    "bench_scheduler": [f"scheduler/{s}" for s in ("sync", "deadline", "overselect")],
}
#: the modules whose rounds or builds reach each kernel (launches must rise)
BENCH_REACHES = {
    "bench_sampler_cost": ("gram",),
    "bench_round_engine": ("aggregate",),
    "bench_kernels": ("gram", "aggregate", "flash_attention"),
    "bench_store_scale": ("srp",),
    "bench_async_planner": ("gram", "aggregate"),
    "bench_service_churn": ("gram", "aggregate"),
    "bench_scheduler": ("gram", "aggregate"),
}
BENCH_ROUNDS = 12  # bench_round_engine's timed rounds a row in full mode
BENCH_BUDGET_S = 150.0


def _bench_fields(derived: str) -> dict:
    return dict(part.split("=", 1) for part in derived.split(";") if "=" in part)


def _bench_check(mod: str, rows: list, launches: dict) -> None:
    """The gates of one module's rows: names, times, parity, the kernels'
    errors and bounds, and launches."""
    names = [r[0] for r in rows]
    if names != BENCH_ROWS[mod]:
        fail(f"bench: {mod} printed rows {names}, expected {BENCH_ROWS[mod]}")
    for name, us, derived in rows:
        untimed = mod == "bench_fl_collectives" or derived.startswith("infeasible")
        if not untimed and not (math.isfinite(us) and us > 0):
            fail(f"bench: {name} has time {us} µs")
    for kernel in BENCH_REACHES.get(mod, ()):
        if launches[kernel] <= 0:
            fail(f"bench: {mod} launched {kernel} {launches[kernel]} times")
    f = {name: _bench_fields(derived) for name, _, derived in rows}
    # the static / sync row carries the gate the module asserted
    if mod in ("bench_service_churn", "bench_scheduler") and f[names[0]].get("parity") != "bit-identical":
        fail(f"bench: {names[0]} lacks parity=bit-identical")
    if mod == "bench_round_engine":  # both engines close a round with one B2 launch
        for name in names:
            if int(f[name]["launches"]) != BENCH_ROUNDS:
                fail(f"bench: {name} launched aggregate {f[name]['launches']} times in "
                     f"{BENCH_ROUNDS} rounds")
    if mod == "bench_store_scale":
        scatters = 0
        for name in names:
            if name.startswith("store/") and name.endswith("srp64"):
                if f[name]["srp_launches"] != f[name]["scatters"]:
                    fail(f"bench: {name}: {f[name]['srp_launches']} srp launches in "
                         f"{f[name]['scatters']} sketched scatters")
                scatters += int(f[name]["scatters"])
        scatters += sum(n.startswith("rebuild/") and n.endswith("srp64") for n in names)
        if launches["srp"] != scatters:
            fail(f"bench: bench_store_scale launched srp {launches['srp']} times in {scatters} "
                 "sketched scatters")
    if mod == "bench_kernels":
        limits = {"kernels/similarity_cuda": ("gram_err", GRAM_RTOL),
                  "kernels/aggregate_cuda": ("max_abs_err", AGG_TOL),
                  "kernels/flash_attention_cuda": ("max_abs_err", FLASH_F32_ATOL)}
        for (name, us, _), (key, limit) in ((r, limits[r[0]]) for r in rows if r[0] in limits):
            err = float(f[name][key].split()[0])
            bound = float(f[name]["h100_bound_ms"])
            ev = float(f[name]["event_ms"])
            if not math.isfinite(err) or err > limit:
                fail(f"bench: {name} {key} {err} > {limit}")
            if us / 1e3 < bound or ev < bound:
                fail(f"bench: {name} timed {us / 1e3} ms (host, synchronised) and {ev} ms "
                     f"(events), below its bound {bound} ms: the timing did not wait for the card")


def phase_bench(torch) -> dict:
    """The port's eight ``bench_*`` modules through their ``main`` in full
    mode on the card, their rows gated (``_bench_check``). Returns each
    kernel's launches over the phase."""
    import importlib

    from repro_torch.benchmarks import common as bc
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    t0 = time.perf_counter()
    counts = (sim_ops.launches, agg_ops.launches, sk_ops.launches, fa_ops.launches)
    total = {k: 0 for c in counts for k in c}
    out = {"rows": [], "seconds": {}, "launches": {}}
    for mod, argv in BENCH_ARGS.items():
        main = importlib.import_module(f"repro_torch.benchmarks.{mod}").main
        torch.cuda.synchronize()
        for c in counts:
            c.update({k: 0 for k in c})
        start, n_rows = time.perf_counter(), len(bc.ROWS)
        main(argv + ["--device", DEV])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: v for c in counts for k, v in c.items()}
        rows = bc.ROWS[n_rows:]
        _bench_check(mod, rows, launches)
        for k, v in launches.items():
            total[k] += v
        out["rows"] += [list(r) for r in rows]
        out["seconds"][mod] = round(seconds, 3)
        out["launches"][mod] = launches
        print(f"bench: {mod} {' '.join(argv)}: {len(rows)} rows in {seconds:.3f} s, launches "
              f"{json.dumps(launches)}")
        torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t0
    print("bench: " + json.dumps(out))
    print(f"bench: {elapsed:.3f} s (budget {BENCH_BUDGET_S:.0f} s)")
    return total


# ---------------------------------------------------------------------------
# block_q: attention's and the mLSTM's query-row blocks at full width
# ---------------------------------------------------------------------------
BLOCK_Q = dict(batch=4, seq=1024, bq=256, whole=1024)  # bq = seq: s > bq fails, the whole form
BLOCK_Q_STEP = dict(arch="qwen3-0.6b", bq=512, whole=1024, steps=2, lr=3e-3)
BLOCK_Q_RTOL = 1e-5  # f32 blocked vs whole: of the output's (or gradient's) scale
BLOCK_Q_LOSS_RTOL = 1e-3  # the bf16 step's loss, blocked vs whole


def _blocked_pair(torch, label, fn, x, dy) -> dict:
    """``fn(bq, x)`` for BLOCK_Q's bq and whole: the output, the input's
    gradient of ⟨out, dy⟩, ms and peak memory above the inputs of a second
    run of each (the first warms the libraries up); gated."""
    res = {}
    for key in ("whole", "bq") * 2:
        xi = x.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        out, extra = fn(BLOCK_Q[key], xi)
        out.backward(dy)
        torch.cuda.synchronize()
        res[key] = {"out": out.detach(), "grad": xi.grad, "extra": extra,
                    "ms": (time.perf_counter() - start) * 1e3,
                    "peak": torch.cuda.max_memory_allocated() - base}
        del out, xi
    rels = {"out": _rel(res["bq"]["out"], res["whole"]["out"]),
            "grad": _rel(res["bq"]["grad"], res["whole"]["grad"])}
    for k, v in res["whole"]["extra"].items():
        rels[k] = _rel(res["bq"]["extra"][k], v)
    w, b = res["whole"], res["bq"]
    print(f"block_q: {label} bq {BLOCK_Q['bq']} against the whole form, f32 forward and input "
          f"gradient (second runs): max |Δ| of the scale {json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} "
          f"(limit {BLOCK_Q_RTOL}); ms {b['ms']:.3f} / {w['ms']:.3f}; peak memory above the "
          f"inputs {b['peak']} B ({b['peak'] / 2**20:.1f} MiB) / {w['peak']} B "
          f"({w['peak'] / 2**20:.1f} MiB), ratio {b['peak'] / w['peak']:.3f}")
    if not all(math.isfinite(v) and v <= BLOCK_Q_RTOL for v in rels.values()):
        fail(f"block_q: {label} blocked differs from the whole form by {rels}")
    return {"rel": rels, "peak": [b["peak"], w["peak"]], "ms": [b["ms"], w["ms"]]}


def phase_block_q(torch) -> dict:
    """``cfg.attn_block_q``'s query-row blocks at full width on the card:
    qwen3-0.6b's layer-0 attention and xlstm-125m's mLSTM parallel form over
    4 × 1,024 in f32, blocks of 256 rows against the whole form (bq 1,024:
    ``s > bq`` fails), forward and input gradient; then a qwen3-0.6b train
    step (bf16 over f32, remat on) at bq 512 against 1,024."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import attention as attn_lib
    from repro_torch.models.layers import xlstm

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    b, s = BLOCK_Q["batch"], BLOCK_Q["seq"]
    out = {}

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), dtype="float32")
    params = attn_lib.init_attention(cfg, gen, DEV)
    angles = mdl.make_angles(cfg, torch.arange(s, device=DEV))
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)
    dy = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)

    def attn(bq, xi):
        y, kv = attn_lib.attention_full(dataclasses.replace(cfg, attn_block_q=bq), params, xi,
                                        angles)
        return y, {"k": kv["k"].detach()}

    out["attention"] = _blocked_pair(torch, f"{cfg.name} layer 0 attention {tuple(x.shape)}",
                                     attn, x, dy)
    del params, x, dy
    torch.cuda.empty_cache()

    xcfg = get_config(SERVE_XLSTM["arch"])
    d_in, _ = xlstm._mlstm_dims(xcfg)
    params = xlstm.init_mlstm_block(xcfg, gen, DEV)
    z = torch.randn((b, s, d_in), generator=gen, device=DEV)
    dy = torch.randn((b, s, d_in), generator=gen, device=DEV)

    def mlstm(bq, zi):
        y, state = xlstm.mlstm_parallel(dataclasses.replace(xcfg, attn_block_q=bq), params, zi)
        return y, {k: v.detach() for k, v in state.items()}

    out["mlstm"] = _blocked_pair(torch, f"{xcfg.name} mLSTM parallel form {tuple(z.shape)}",
                                 mlstm, z, dy)
    del params, z, dy
    torch.cuda.empty_cache()

    scfg = get_config(BLOCK_Q_STEP["arch"])
    steps = {}
    for key in ("whole", "bq"):
        c = dataclasses.replace(scfg, attn_block_q=BLOCK_Q_STEP[key])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        state, records = train.train(c, steps=BLOCK_Q_STEP["steps"], batch=TRAIN["batch"],
                                     seq=TRAIN["seq"], lr=BLOCK_Q_STEP["lr"], device=DEV,
                                     log_every=10**9, log=lambda line: None)
        torch.cuda.synchronize()
        ms = np.diff([start] + [r["t"] for r in records]) * 1e3
        steps[key] = {"loss": records[0]["loss"], "grad_norm": records[0]["grad_norm"],
                      "ms": float(ms[-1]), "peak": torch.cuda.max_memory_allocated()}
        del state
        torch.cuda.empty_cache()
        print(f"block_q: {scfg.name} train step, attn_block_q {c.attn_block_q}: loss "
              f"{steps[key]['loss']:.6f}, grad norm {steps[key]['grad_norm']:.6f}, step ms (the "
              f"second) {steps[key]['ms']:.3f}, peak memory {steps[key]['peak']} B "
              f"({steps[key]['peak'] / 2**30:.2f} GiB)")
    lw, lb = steps["whole"]["loss"], steps["bq"]["loss"]
    if not (math.isfinite(lb) and abs(lb - lw) <= BLOCK_Q_LOSS_RTOL * abs(lw)):
        fail(f"block_q: the blocked step's loss {lb} is not within {BLOCK_Q_LOSS_RTOL} of the "
             f"whole route's {lw}")
    out["step"] = steps
    print(f"block_q: {time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------------------
# sharded: the FL round, the gradient store and the federated LM over a mesh
# ---------------------------------------------------------------------------
SHARDS = 4  # the data groups of the sharded runs, over the visible cards in turn
SHARDED_LM_ROUNDS = 2  # of fl_lm's 3: round 0 reads no aggregate, round 1 the sharded one
SHARDED_LOSS0_RTOL = 1e-6  # round 0's loss: the same clients' steps from the same θ
SHARDED_LOSS1_RTOL = 1e-3  # round 1's: from the sharded aggregate and its plan


def shard_mesh(torch):
    """A SHARDS × 1 data mesh of the visible cards in turn (cuda:{i % count})."""
    import numpy as np

    from repro_torch.launch.mesh import AXES, Mesh

    count = torch.cuda.device_count()
    devs = np.empty((SHARDS, 1), dtype=object)
    devs[:, 0] = [torch.device("cuda", i % count) for i in range(SHARDS)]
    return Mesh(devs, AXES)


def _sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _by_shard(kernel: str, shards: int = SHARDS) -> list:
    from repro_torch.kernels import _build

    return [_build.shard_launches[(kernel, s)] for s in range(shards)]


def _nonempty_blocks(n_rows: int, slots: int, shards: int = SHARDS) -> int:
    """Data groups that hold some of a round's first ``n_rows`` slots."""
    from repro_torch.launch.mesh import blocks

    return sum(a < n_rows for a, b in blocks(slots, shards) if b > a)


def _store_against_replay(torch, label, store, observed, sketch_kw) -> str:
    """The sharded run's store against an unsharded store fed the same
    updates: bit-equal, or (SRP, where B3's tiling might see the row count)
    within B3's limit of each row's last update. Returns which held."""
    import numpy as np

    from repro_torch.fl.gradient_store import GradientStore

    replay = GradientStore(store.n_clients, store.update_dim, sketch_seed=0, device=DEV, **sketch_kw)
    last = {}
    for ids, rows in observed:
        replay.update(ids, torch.from_numpy(rows).to(DEV))
        last.update(zip(ids.tolist(), rows))
    got, want = store.snapshot(), replay.snapshot()
    if torch.equal(got, want):
        return "bit-equal"
    if not sketch_kw:
        fail(f"{label}: the exact sharded store differs from the unsharded replay")
    X = np.zeros((store.n_clients, store.update_dim), np.float32)
    for i, row in last.items():
        X[i] = row
    rel = srp_rel_err(got, want, torch.from_numpy(X).to(DEV), store.dim)
    if not math.isfinite(rel) or rel > SRP_RTOL:
        fail(f"{label}: the sharded SRP store differs from the replay by {rel} of ‖x_i‖·√(d/d′)")
    return f"within B3's limit ({rel:.3e} of ‖x_i‖·√(d/d′), limit {SRP_RTOL})"


def sharded_slice(torch, ds, mesh) -> dict:
    """The slice phase's arccos and srp runs again from the same params,
    under mesh_spec "auto" (one shard on one card: bit-equal to slice) and
    over ``mesh`` (plans equal, θ within 1e-5 + 1e-4·max|θ|, 1/shards of
    the staged bytes a shard, the store equal to an unsharded replay; so
    is "auto" over several cards)."""
    import numpy as np

    from repro_torch.kernels import _build

    launches = {"gram": 0, "aggregate": 0, "srp": 0}
    for run, kw in (("arccos", {}), ("srp", {"sketch": "srp", "sketch_dim": D_PRIME})):
        want = SLICE_RUNS[run]
        medians = {}
        # in turns with unsharded runs of the same rounds: round ms compare
        # only within one call, and the host's speed drifts along the smoke
        for spec_label, spec in (("unsharded", None), ("auto", "auto"), (f"{SHARDS} shards", mesh),
                                 ("unsharded again", None)):
            label = f"sharded[{spec_label}, {run}]"
            rec = {}
            _build.shard_launches.clear()
            _, counts, ms, sampler = _slice_run(torch, ds, want["start"], "arccos", 5, label,
                                                mesh=spec, record=rec, **kw)
            medians[spec_label] = ms
            n_sh = len(rec["staged"])
            for k in launches:
                launches[k] += counts[k]
            plans_equal = all(np.array_equal(a, b) for a, b in zip(rec["plans"], want["plans"]))
            if not plans_equal or len(rec["plans"]) != len(want["plans"]):
                fail(f"{label}: the plans differ from slice[{run}]'s")
            if n_sh == 1:  # "auto" on one card
                same = all(torch.equal(rec["final"][k], want["final"][k]) for k in want["final"])
                upd = all(np.array_equal(i1, i2) and np.array_equal(r1, r2)
                          for (i1, r1), (i2, r2) in zip(rec["observed"], want["observed"]))
                if not (same and upd):
                    fail(f"{label}: not bit-equal to slice[{run}] (θ {same}, updates {upd})")
                print(f"{label}: on {mesh_devices(sampler)}: θ, updates and plans bit-equal to "
                      f"slice[{run}]'s over 5 rounds")
                continue
            theta = np.concatenate([rec["final"][k].numpy().ravel() for k in sorted(rec["final"])])
            ref = np.concatenate([want["final"][k].numpy().ravel() for k in sorted(want["final"])])
            dtheta, lim = float(np.abs(theta - ref).max()), 1e-5 + 1e-4 * float(np.abs(ref).max())
            if not dtheta <= lim:
                fail(f"{label}: θ differs from slice[{run}]'s by {dtheta} > {lim}")
            whole = want["staged"][0]
            if rec["staged"] != [whole // n_sh] * n_sh or whole % n_sh:
                fail(f"{label}: staged bytes by shard {rec['staged']}, not 1/{n_sh} of {whole}")
            held = _store_against_replay(torch, label, sampler.gradient_store, rec["observed"], kw)
            agg, srp = _by_shard("aggregate", n_sh), _by_shard("srp", n_sh)
            if agg != [5] * n_sh:
                fail(f"{label}: aggregate launches by shard {agg}, not once a shard a round")
            want_srp = (sum(_nonempty_blocks(len(ids), 10, n_sh) for ids, _ in rec["observed"])
                        if kw else 0)
            if sum(srp) != want_srp or counts["srp"] != want_srp:
                fail(f"{label}: srp launches by shard {srp}, expected {want_srp} (once a shard "
                     "holding observed rows, a round)")
            print(f"{label}: shards on {mesh_devices(sampler)}; staged bytes by shard {rec['staged']} "
                  f"(unsharded {whole}), store bytes by shard {rec['store']}; launches by shard: "
                  f"aggregate (B2) {agg}, srp (B3) {srp}, gram (B1, on the lead card) "
                  f"{counts['gram']}; plans equal to slice[{run}]'s, θ max |Δ| {dtheta:.3e} (limit "
                  f"{lim:.3e}); the store {held} against an unsharded store fed the same updates")
        print(f"times: sharded[{run}] median round ms of 5, in turns: "
              + ", ".join(f"{k} {v:.3f}" for k, v in medians.items()))
    return launches


def mesh_devices(sampler) -> list:
    store = sampler.gradient_store
    return [str(d) for d in store.mesh.devices.flat] if store.mesh is not None else [str(store.device)]


def sharded_lm(torch, mesh, label, sampler_name, planner) -> dict:
    """run_federated_lm at qwen3-0.6b's full width over ``mesh``, 2 rounds
    with fl_lm's seeds, against fl_lm's own first two rounds."""
    import contextlib

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ClientPopulation
    from repro_torch.core.samplers.base import validate_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.launch import fl_train

    cfg = get_config(FL_LM["arch"])
    fl = fl_train.FLLMConfig(n_rounds=SHARDED_LM_ROUNDS, sampler=sampler_name, planner=planner)
    pop = ClientPopulation(np.full(fl.n_clients, 1000))
    cards = sorted({d.index for d in mesh.devices.flat})
    grams, rounds, starts = [], [], []
    with GramTap(sim_ops, grams), contextlib.closing(
            fl_train.make_lm_sampler(fl, pop, update_dim=LM_P, device=DEV)) as sampler:
        _fl_lm_recorded(sampler, rounds)
        recorded = sampler.sample

        def sample(t, *a, **kw):
            _sync_all(torch)
            starts.append(time.perf_counter())
            return recorded(t, *a, **kw)

        sampler.sample = sample
        _sync_all(torch)
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        sim_ops.launches.update(gram=0, l1=0)
        agg_ops.launches.update(aggregate=0)
        sk_ops.launches.update(srp=0)
        fa_ops.launches.update(flash_attention=0)
        _build.shard_launches.clear()
        grams.clear()
        losses = fl_train.run_federated_lm(cfg, fl, sampler, mesh=mesh, device=DEV)
        _sync_all(torch)
        ends = starts[1:] + [time.perf_counter()]
        launches = {**sim_ops.launches, **agg_ops.launches, **sk_ops.launches, **fa_ops.launches}
        store = getattr(sampler, "gradient_store", None)
        plan = getattr(sampler, "plan", None)
    peaks = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    feedback = sampler_name == "algorithm2"
    steps = fl.n_rounds * fl.m * fl.n_local_steps
    n_attn = sum(m == "attn" for m, _ in cfg.all_blocks)
    per = fl.m // SHARDS
    want_srp = sum(_nonempty_blocks(len(np.unique(c)), fl.m) for _, c in rounds) if feedback else 0
    want = {"aggregate": fl.n_rounds * SHARDS, "srp": want_srp,
            "gram": fl.n_rounds if feedback else 0, "l1": 0,
            "flash_attention": n_attn * (2 if cfg.remat else 1) * steps}
    by_shard = {k: _by_shard(k) for k in ("aggregate", "srp", "flash_attention")}
    ref = FL_LM_LOSSES[label]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"sharded_lm[{label}]: {cfg.name} full width (d = {LM_P}) over {SHARDS} shards on "
          f"{[str(d) for d in mesh.devices.flat]}, m = {fl.m} ({per} clients a shard), "
          f"{fl.n_rounds} rounds: losses {losses} against fl_lm[{label}]'s {ref[:fl.n_rounds]} "
          f"(relative {rel}; limits {SHARDED_LOSS0_RTOL}, {SHARDED_LOSS1_RTOL})")
    for r, (a, b) in enumerate(zip(starts, ends)):
        print(f"sharded_lm[{label}]: round {r} {(b - a) * 1e3:.3f} ms")
    print(f"sharded_lm[{label}]: peak memory by card "
          + ", ".join(f"cuda:{c} {peaks[c]} B ({peaks[c] / 2**30:.2f} GiB)" for c in cards))
    print(f"sharded_lm[{label}]: launches {json.dumps(launches)}; predicted {json.dumps(want)}; by "
          f"shard {json.dumps(by_shard)} (aggregate once a shard a round, srp once a shard holding "
          "observed rows, gram on the lead card)")
    if len(losses) != fl.n_rounds or not all(math.isfinite(x) for x in losses):
        fail(f"sharded_lm[{label}]: losses {losses}")
    if not (rel[0] <= SHARDED_LOSS0_RTOL and rel[1] <= SHARDED_LOSS1_RTOL):
        fail(f"sharded_lm[{label}]: losses {losses} against fl_lm's {ref}: relative {rel}")
    if launches != want or by_shard["aggregate"] != [fl.n_rounds] * SHARDS:
        fail(f"sharded_lm[{label}]: launches {launches} (by shard {by_shard}), predicted {want}")
    if by_shard["flash_attention"] != [want["flash_attention"] // SHARDS] * SHARDS:
        fail(f"sharded_lm[{label}]: flash launches by shard {by_shard['flash_attention']}")
    if feedback:
        if tuple(store.snapshot().shape) != (fl.n_clients, D_PRIME):
            fail(f"sharded_lm[{label}]: the store is {tuple(store.snapshot().shape)}")
        validate_plan(plan, pop)
    for G, got in grams:
        g_rel = gram_rel_err(got, G.double() @ G.double().T, G)
        if not math.isfinite(g_rel) or g_rel > GRAM_RTOL:
            fail(f"sharded_lm[{label}]: the sampler's gram: error {g_rel} of ‖g_i‖·‖g_j‖")
    if len(grams) != launches["gram"]:
        fail(f"sharded_lm[{label}]: {len(grams)} Gram calls seen, {launches['gram']} launches")
    return launches


def kernels_last_card(torch) -> None:
    """Each kernel launched on the last visible card (card 0 current) and
    held to its plain version at the smoke's limits."""
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.similarity.ref import l1_ref
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ref import sketch_srp_plain

    count = torch.cuda.device_count()
    if count < 2:
        print("sharded: the kernels on a card other than card 0 need a second card "
              f"({count} visible); checked by the two-card cases of tests/test_torch_cuda.py")
        return
    dev = torch.device("cuda", count - 1)
    torch.cuda.set_device(0)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    U = torch.randn(AGG_SHAPE, generator=g, device=dev)
    w = torch.rand(AGG_SHAPE[:1], generator=g, device=dev)
    got = agg_ops.aggregate_flat(U, w)
    if not torch.allclose(got, aggregate_ref(U, w), rtol=AGG_TOL, atol=AGG_TOL):
        fail(f"sharded: aggregate on {dev} beyond rtol=atol {AGG_TOL}")
    out["aggregate"] = float((got - aggregate_ref(U, w)).abs().max())
    G = SIM_SCALE * torch.randn(SIM_SHAPES[0], generator=g, device=dev)
    got = sim_ops.pairwise_sums(G, "gram")
    out["gram"] = gram_rel_err(got, G.double() @ G.double().T, G)
    if not out["gram"] <= GRAM_RTOL:
        fail(f"sharded: gram on {dev}: {out['gram']} of ‖g_i‖·‖g_j‖")
    got = sim_ops.pairwise_sums(G, "l1")
    out["l1"] = float((got - l1_ref(G)).abs().max())
    if not out["l1"] <= SIM_ATOL:
        fail(f"sharded: l1 on {dev}: {out['l1']} > {SIM_ATOL}")
    c, d, dp = SRP_SHAPES[0]
    X = SIM_SCALE * torch.randn((c, d), generator=g, device=dev)
    got = sk_ops.srp_sketch(X, dp, SRP_SEED)
    out["srp"] = srp_rel_err(got, sketch_srp_plain(X, dp, SRP_SEED), X, dp)
    if not out["srp"] <= SRP_RTOL:
        fail(f"sharded: srp on {dev}: {out['srp']} of ‖x_i‖·√(d/d′)")
    b, s, h, kv, hd = FLASH_PATH
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    out["flash"] = _flash_check(torch, f"bf16 {FLASH_PATH} on {dev}", fa_ops.flash_attention_padded(q, k, v),
                                q, k, v)
    if torch.cuda.current_device() != 0:
        fail(f"sharded: a launch on {dev} left the current device at {torch.cuda.current_device()}")
    print(f"sharded: each kernel launched on {dev} with cuda:0 current, against its plain version: "
          f"aggregate {AGG_SHAPE} max_abs_err {out['aggregate']:.3e} (rtol=atol {AGG_TOL}); gram "
          f"{SIM_SHAPES[0]} {out['gram']:.3e} of ‖g_i‖·‖g_j‖ (limit {GRAM_RTOL}); l1 {out['l1']:.3e} "
          f"(atol {SIM_ATOL}); srp {SRP_SHAPES[0]} {out['srp']:.3e} of ‖x_i‖·√(d/d′) (limit "
          f"{SRP_RTOL}); flash bf16 {FLASH_PATH} {out['flash']:.3e}")


# ---------------------------------------------------------------------------
# train_sharded: the train step over a 2 × 2 mesh under build_shardings' placements
# ---------------------------------------------------------------------------
TRAIN_SHARDED = dict(steps=3, mesh=(2, 2))  # TRAIN's arch, batch, seq and lr
TRAIN_SHARDED_GATE_LAYERS = 2  # the f32 gate: qwen3-0.6b cut to 2 layers, TF32 off
TRAIN_SHARDED_ATOL = 3e-5  # the trainers' limit on parameters and moments ...
TRAIN_SHARDED_TINY = 10 * 1e-8  # ... the lr where a step's gradient entry is below 10·ε ...
# ... and, on the card at full width, where an entry's gradient is within a few dozen times
# the reduction-order noise of the 4,096-token sums (~5e-8 absolute): every entry within lr,
# those beyond the atol (tiny gradients aside) under this share of all entries (6.6e-6 on an
# H100: 3,703 of 561,136,128 entries, each under lr)
TRAIN_SHARDED_SHARE = 1e-4
TRAIN_SHARDED_RTOL = 1e-5  # the f32 gate's losses and gradient norms, relative
TRAIN_SHARDED_BF16_RTOL = 2.0**-7  # full width in bf16: reported against it, decides nothing
TRAIN_SHARDED_P = 193_101_824  # qwen3-0.6b's parameter elements a position holds on a 2 × 2 mesh


def train_sharded_mesh(torch):
    """A 2 × 2 (data, model) mesh of the visible cards in turn (cuda:{i % count})."""
    import numpy as np

    from repro_torch.launch.mesh import AXES, Mesh

    d, m = TRAIN_SHARDED["mesh"]
    count = torch.cuda.device_count()
    devs = np.empty((d, m), dtype=object)
    devs.flat[:] = [torch.device("cuda", i % count) for i in range(d * m)]
    return Mesh(devs, AXES)


def _train_sharded_pair(torch, cfg, mesh, label, track_tiny):
    """TRAIN_SHARDED's steps of ``cfg`` from one random state, one card and
    over ``mesh`` in turns, on the same batches. Returns both final states,
    the metrics, step ms and launches of each, the peaks by card and, with
    ``track_tiny``, each entry's smallest nonzero one-card gradient."""
    import numpy as np

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun, sharding, steps
    from repro_torch.launch.mesh import sync_mesh
    from repro_torch.models import model as mdl
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw, linear_warmup_cosine

    n = TRAIN_SHARDED["steps"]
    opt = adamw(linear_warmup_cosine(TRAIN["lr"], 1, n))
    shape = InputShape(label, TRAIN["seq"], TRAIN["batch"], "train")
    (state_sh, _), _, _ = dryrun.build_shardings(cfg, shape, mesh, "train", opt)
    state = steps.init_train_state(mdl.init_params(cfg, 0, device=DEV), opt)
    placed = sharding.place(state, state_sh)
    one, sharded = steps.make_train_step(cfg, opt), steps.make_train_step(cfg, opt, mesh=mesh)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"], seed=3)
    cards = sorted({d.index for d in mesh.devices.flat})
    _sync_all(torch)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    _build.shard_launches.clear()
    fa_ops.launches.update(flash_attention=0)
    out = {"one": [], "sharded": [], "one_ms": [], "sharded_ms": [], "one_flash": 0}
    tiny = None
    for _ in range(n):
        bt = pipe.next_batch()
        batch = {k: torch.from_numpy(v).to(DEV, torch.int64)
                 for k, v in (("tokens", bt.tokens), ("targets", bt.targets))}
        mu_prev = {k: v.clone() for k, v in state["opt_state"]["mu"].items()} if track_tiny else None
        before = fa_ops.launches["flash_attention"]
        t0 = time.perf_counter()
        state, m = one(state, batch)
        torch.cuda.synchronize()
        out["one_ms"].append((time.perf_counter() - t0) * 1e3)
        out["one_flash"] += fa_ops.launches["flash_attention"] - before
        out["one"].append({k: float(v) for k, v in m.items()})
        if track_tiny:
            tiny = tiny or {k: torch.full_like(v, math.inf) for k, v in mu_prev.items()}
            for k, t in tiny.items():
                g = (state["opt_state"]["mu"][k] - 0.9 * mu_prev[k]).abs() / 0.1
                tiny[k] = torch.where(g > 0, torch.minimum(t, g), t)
            del mu_prev
        pb = sharding.place(batch, sharding.batch_shardings(mesh, batch))
        t0 = time.perf_counter()
        placed, m = sharded(placed, pb)
        sync_mesh(mesh)
        out["sharded_ms"].append((time.perf_counter() - t0) * 1e3)
        out["sharded"].append({k: float(v) for k, v in m.items()})
    out["peaks"] = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    out["flash_by_position"] = [_build.shard_launches[("flash_attention", p)]
                                for p in range(mesh.devices.size)]
    return state, placed, tiny, out


def _replicas_equal(torch, placed_state) -> bool:
    """Whether every two positions holding the same slices of a leaf hold the same bits."""
    from repro_torch.launch import sharding

    for leaf in sharding.leaves(placed_state):
        first = {}
        for pos, block in enumerate(leaf.blocks):
            key = tuple((s.start, s.stop) for s in leaf.index(pos))
            if key in first and not torch.equal(first[key], block.to(first[key].device)):
                return False
            first.setdefault(key, block)
    return True


def train_sharded_gate(torch, mesh) -> None:
    """The gate that decides: qwen3-0.6b cut to TRAIN_SHARDED_GATE_LAYERS
    layers in f32, sharded against one card over TRAIN_SHARDED's steps:
    every parameter and moment within the lr, and within TRAIN_SHARDED_ATOL
    but for entries whose one-card gradient was nonzero and below 10·ε and
    under TRAIN_SHARDED_SHARE of the others (an entry whose gradient is at
    the noise of the batch's reduction order takes an AdamW step of another
    size); every loss and the first step's gradient norm (the same
    parameters, the batch split alone) within TRAIN_SHARDED_RTOL;
    replicated blocks bit-equal."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN_SHARDED_GATE_LAYERS,
                              dtype="float32")
    state, placed, tiny, out = _train_sharded_pair(torch, cfg, mesh, "train_sharded[gate]", True)
    worst, n_tiny, n_over, total, biggest = 0.0, 0, 0, 0, 0.0
    for part, want_tree, got_tree in (("params", dict(state["params"].named_parameters()), placed["params"]),
                                      ("mu", state["opt_state"]["mu"], placed["opt_state"]["mu"]),
                                      ("nu", state["opt_state"]["nu"], placed["opt_state"]["nu"])):
        for k, want in want_tree.items():
            small = tiny[k] < TRAIN_SHARDED_TINY
            diff = (got_tree[k].gather(want.device) - want.detach()).abs()
            if not bool((diff <= TRAIN["lr"]).all()):
                fail(f"train_sharded[gate]: {part} {k} differs from the one-card step's by "
                     f"{float(diff.max())}, beyond the lr")
            over = (diff > TRAIN_SHARDED_ATOL) & ~small
            worst = max(worst, float(torch.where(small | over, 0.0, diff).max()))
            biggest = max(biggest, float(diff.max()))
            n_tiny, n_over = n_tiny + int(small.sum()), n_over + int(over.sum())
            total += small.numel()
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(out["sharded"], out["one"])]
           for k in ("loss", "grad_norm")}
    print(f"train_sharded[gate]: {cfg.name} cut to {cfg.n_layers} layers, f32, TF32 off, "
          f"{TRAIN_SHARDED['steps']} steps of {TRAIN['batch']} × {TRAIN['seq']}: losses "
          f"{[r['loss'] for r in out['sharded']]} (one card {[r['loss'] for r in out['one']]}); "
          f"relative Δ by step: loss {['%.3e' % x for x in rel['loss']]}, grad norm "
          f"{['%.3e' % x for x in rel['grad_norm']]} (limit {TRAIN_SHARDED_RTOL} on every loss and "
          f"the first grad norm); of the {total} entries of params, mu and nu, {n_tiny} had a "
          f"gradient below 10·ε and {n_over} others ({n_over / total:.3e}, limit "
          f"{TRAIN_SHARDED_SHARE}) differ by more than {TRAIN_SHARDED_ATOL}; max |Δ| "
          f"{biggest:.3e} (limit lr {TRAIN['lr']}), {worst:.3e} over the rest")
    if not all(v <= TRAIN_SHARDED_RTOL for v in rel["loss"] + rel["grad_norm"][:1]):
        fail(f"train_sharded[gate]: losses or the first gradient norm beyond {TRAIN_SHARDED_RTOL}: {rel}")
    if n_over > TRAIN_SHARDED_SHARE * total:
        fail(f"train_sharded[gate]: {n_over} of {total} entries beyond {TRAIN_SHARDED_ATOL}")
    if not _replicas_equal(torch, placed):
        fail("train_sharded[gate]: replicated blocks differ between positions")


def train_sharded(torch, mesh) -> dict:
    """The f32 gate, then qwen3-0.6b at full width (TRAIN's batch and lr,
    bf16 over f32 parameters, remat on) over ``mesh`` against one card:
    losses and gradient norms side by side, bytes by position against
    param_shardings' counts, peak memory by card, step ms in turns, B4's
    launches. Returns the sharded run's B4 launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, steps

    t0 = time.perf_counter()
    train_sharded_gate(torch, mesh)
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN["arch"])
    state, placed, _, out = _train_sharded_pair(torch, cfg, mesh, "train_sharded", False)
    like = steps.abstract_params(cfg)
    shards = sharding.param_shardings(mesh, like)
    per = sum(int(np.prod(sharding.shard_shape(shards[k], p.shape)))
              for k, p in like.named_parameters())
    counts = {part: sharding.bytes_by_position(tree) for part, tree in
              (("params", placed["params"]), ("mu", placed["opt_state"]["mu"]),
               ("nu", placed["opt_state"]["nu"]))}
    groups = len({p for p, n in enumerate(out["flash_by_position"]) if n})
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    want_flash = per_step * groups * TRAIN_SHARDED["steps"]
    for key in ("loss", "grad_norm"):
        one = [r[key] for r in out["one"]]
        got = [r[key] for r in out["sharded"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, one))
        print(f"train_sharded: {key} over {mesh.devices.shape} {got}, one card {one}: relative "
              f"{rel:.3e} ({'within' if rel <= TRAIN_SHARDED_BF16_RTOL else 'beyond'} the bf16 "
              f"limit {TRAIN_SHARDED_BF16_RTOL}, which decides nothing)")
    print(f"train_sharded: {cfg.name} full width, {cfg.dtype} over {cfg.param_dtype}, remat "
          f"{cfg.remat}, on {[str(d) for d in mesh.devices.flat]}; bytes by position: "
          + "; ".join(f"{k} {v}" for k, v in counts.items())
          + f" (param_shardings: {per} elements, {4 * per} B a position)")
    print("train_sharded: peak memory by card "
          + ", ".join(f"cuda:{c} {b} B ({b / 2**30:.2f} GiB)" for c, b in out["peaks"].items()))
    print("train_sharded: step ms in turns (one card, sharded): "
          + ", ".join(f"({a:.3f}, {b:.3f})" for a, b in zip(out["one_ms"], out["sharded_ms"])))
    print(f"train_sharded: flash_attention launches by position {out['flash_by_position']} "
          f"({sum(out['flash_by_position'])}, predicted {want_flash}: {per_step} a step on each of "
          f"{groups} data groups); one card {out['one_flash']} ({per_step} a step)")
    if per != TRAIN_SHARDED_P or any(b != [4 * per] * mesh.devices.size for b in counts.values()):
        fail(f"train_sharded: bytes by position {counts}, expected {4 * TRAIN_SHARDED_P} each")
    if groups != TRAIN_SHARDED["mesh"][0] or sum(out["flash_by_position"]) != want_flash:
        fail(f"train_sharded: flash launches by position {out['flash_by_position']}")
    if out["one_flash"] != per_step * TRAIN_SHARDED["steps"]:
        fail(f"train_sharded: {out['one_flash']} one-card flash launches")
    if not all(math.isfinite(r[k]) for r in out["one"] + out["sharded"] for k in ("loss", "grad_norm")):
        fail("train_sharded: a loss or gradient norm is not finite")
    if not all(bool(torch.isfinite(b).all()) for leaf in sharding.leaves(placed["params"])
               for b in leaf.blocks):
        fail("train_sharded: a parameter is not finite after the steps")
    if not _replicas_equal(torch, placed):
        fail("train_sharded: replicated blocks differ between positions")
    del state, placed
    print(f"train_sharded: {time.perf_counter() - t0:.3f} s")
    return {"flash_attention": sum(out["flash_by_position"]), "step_ms": out["sharded_ms"],
            "one_ms": out["one_ms"], "peaks": out["peaks"]}


def phase_sharded(torch, ds) -> dict:
    """The slice's MNIST runs under mesh_spec "auto" and over a 4-shard
    mesh, the federated LM at qwen3-0.6b's full width over the same mesh,
    the train step over a 2 × 2 mesh (train_sharded) and the kernels on
    the last card. Returns the phase's launches."""
    t0 = time.perf_counter()
    mesh = shard_mesh(torch)
    print(f"sharded: {SHARDS} data shards on {[str(d) for d in mesh.devices.flat]} "
          f"({torch.cuda.device_count()} cards visible)")
    launches = sharded_slice(torch, ds, mesh)
    torch.cuda.empty_cache()
    for label, sampler_name, planner in (("md", "md", "sync"),
                                         ("algorithm2[srp]", "algorithm2", FL_LM_SKETCH)):
        got = sharded_lm(torch, mesh, label, sampler_name, planner)
        for k in ("gram", "aggregate", "srp"):
            launches[k] += got[k]
        launches["flash_attention"] = launches.get("flash_attention", 0) + got["flash_attention"]
        torch.cuda.empty_cache()
    launches["train_sharded"] = train_sharded(torch, train_sharded_mesh(torch))["flash_attention"]
    torch.cuda.empty_cache()
    kernels_last_card(torch)
    print(f"sharded: {time.perf_counter() - t0:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# dryrun: the dry-run's counts on the production mesh, and the counting held
# to the card
# ---------------------------------------------------------------------------
DRYRUN_HOST = [("qwen3-0.6b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
               ("deepseek-v2-lite-16b", "decode_32k")]
DRYRUN_FL = dict(arch="qwen3-0.6b", local_steps=8, planner="sync")
DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_META = ROOT / "build" / "dryrun_meta.json"
DRYRUN_HOST_S = 1000  # the host processes' limit
DRYRUN_META_S = 600  # the meta counts' limit
DRYRUN_PEAK_RTOL = 0.10  # counted peak against max_memory_allocated
DRYRUN_REPS = 3  # timed steps of each kind, in turns
DRYRUN_FL_REPS = 2
DRYRUN_ROUND_STEPS = 1  # the counted round's local steps: fl_lm's shapes, cut from 4 for time


def _start_host(cmds: dict) -> dict:
    """Start ``python3 <args>`` for each label -> args of ``cmds``, at the
    lowest priority, with the port on the path; returns label -> process.
    A run that fails before it waits for them stops them all the same."""
    import atexit
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {label: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                     preexec_fn=lambda: os.nice(19))
             for label, cmd in cmds.items()}
    atexit.register(lambda: [p.kill() for p in procs.values() if p.poll() is None])
    return procs


def _meta_path(label: str) -> Path:
    return DRYRUN_META.with_name(f"{DRYRUN_META.stem}_{label}.json")


def start_dryrun_meta(cards: int) -> dict:
    """:func:`dryrun_meta_counts` of each of :func:`dryrun_steps`' labels
    for ``cards`` cards, a process each (into :func:`_meta_path`)."""
    DRYRUN_META.parent.mkdir(parents=True, exist_ok=True)
    cmds = {}
    for label in DRYRUN_STEPS:
        _meta_path(label).unlink(missing_ok=True)
        cmds[f"meta counts[{label}]"] = [
            "-c", f"import chip_smoke; chip_smoke.dryrun_meta_counts("
                  f"{str(_meta_path(label))!r}, {int(cards)}, {label!r})"]
    return _start_host(cmds)


def start_dryrun_host() -> dict:
    """The host's records, one process each: ``launch.dryrun`` on the
    16 × 16 meta mesh for DRYRUN_HOST and ``launch.dryrun_fl`` for
    DRYRUN_FL, into DRYRUN_DIR."""
    import shutil

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    out = ["--out", str(DRYRUN_DIR)]
    cmds = {f"{a} {s}": ["-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s, *out]
            for a, s in DRYRUN_HOST}
    cmds[f"{DRYRUN_FL['arch']} fl_round"] = [
        "-m", "repro_torch.launch.dryrun_fl", "--arch", DRYRUN_FL["arch"], "--local-steps",
        str(DRYRUN_FL["local_steps"]), "--planner", DRYRUN_FL["planner"], *out]
    return _start_host(cmds)


def dryrun_wait(procs: dict, limit: float) -> None:
    """Wait for every process of ``procs``; fail on one that failed or ran
    past ``limit`` seconds."""
    for label, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dryrun: {label} ran past {limit} s")
        for line in out.strip().splitlines()[-2:]:
            print(f"dryrun[host]: {line}")
        if proc.returncode:
            fail(f"dryrun: {label} exited {proc.returncode}:\n{out[-3000:]}")


def dryrun_host() -> None:
    """Print each host record: per-chip FLOPs, bytes, moved bytes by kind,
    HBM, the three terms, the dominant one and the seconds it took."""
    paths = sorted(DRYRUN_DIR.glob("*.json"))
    for path in paths:
        r = json.loads(path.read_text())
        moved = {k: v["bytes"] for k, v in r["coll_detail"].items() if v["bytes"]}
        if r["kind"] == "fl_round":
            print(f"dryrun[host]: {r['arch']} {r['shape']} mesh {r['mesh']}: m {r['m_clients']}, "
                  f"FLOPs a chip a local step {r['flops_per_chip_per_local_step']:.4e}, moved a "
                  f"round {r['coll_bytes_per_chip_per_round']:.4e} B by kind {moved}, "
                  f"t_collective a step {r['t_collective_per_step'] * 1e3:.3f} ms, hbm "
                  f"{r['hbm_per_chip_gb']} GiB, planner feed {r['planner_feed_bytes']} B "
                  f"({r['compile_s']} s)")
            continue
        print(f"dryrun[host]: {r['arch']} {r['shape']} mesh {r['mesh']} ({r['kind']}): FLOPs a "
              f"chip {r['flops_per_chip']:.4e}, bytes {r['bytes_per_chip']:.4e}, moved "
              f"{r['coll_bytes_per_chip']:.4e} B by kind {moved}, hbm {r['hbm_per_chip_gb']} GiB "
              f"(args {r['arg_bytes_per_chip']:.4e}, temp {r['temp_bytes_per_chip']:.4e}, out "
              f"{r['out_bytes_per_chip']:.4e}); t_compute {r['t_compute'] * 1e3:.3f} ms, "
              f"t_memory {r['t_memory'] * 1e3:.3f} ms, t_collective {r['t_collective'] * 1e3:.3f} "
              f"ms, dominant {r['dominant']}, MODEL/counted {r['utility_ratio']:.4f} "
              f"({r['compile_s']} s)")
    if len(paths) != len(DRYRUN_HOST) + 1:
        fail(f"dryrun: {len(DRYRUN_HOST) + 1} host counts, records {paths}")


def _counted(torch, step, args, positions=1, cuda=True):
    """``step(*args)`` under the dry-run's counter: (summary, bytes by op,
    ms, with ``cuda`` the step's peak over what was allocated before it)."""
    from repro_torch.launch import roofline as rl

    if cuda:
        _sync_all(torch)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with rl.CostCounter(positions, placed=args) as counter:
        out = step(*args)
        if cuda:
            _sync_all(torch)
    ms = (time.perf_counter() - t0) * 1e3
    del out
    peak = torch.cuda.max_memory_allocated() - before if cuda else None
    return counter.summary(), {str(k): v for k, v in counter.by_op.items()}, ms, peak


def _card_against_meta(label, card, meta, card_ops, meta_ops) -> None:
    """Fail unless the card's counts equal the meta run's: FLOPs, the hand
    kernels' calls and work and the moved bytes by position, and the bytes
    accessed, whose differences are printed by op first."""
    for key in ("flops", "kernels", "moved", "colls", "pairs"):
        if card[key] != meta[key]:
            fail(f"{label}: {key} on the card {card[key]} against meta {meta[key]}")
    diff = {op: (card_ops.get(op, 0), meta_ops.get(op, 0)) for op in set(card_ops) | set(meta_ops)
            if card_ops.get(op, 0) != meta_ops.get(op, 0)}
    print(f"{label}: card = meta: FLOPs {card['flops']}, bytes {card['bytes']}, moved "
          f"{card['moved']}, kernels " + ", ".join(
              f"{k} calls {v['calls']} FLOPs {v['flops']} bytes {v['bytes']}"
              for k, v in card["kernels"].items())
          + (f"; bytes by op that differ (card, meta): {diff}" if diff else ""))
    if card["bytes"] != meta["bytes"]:
        fail(f"{label}: bytes accessed differ by op: {diff}")


def _card_of(mesh, position: int) -> int:
    """The card index of a mesh position (0 without a mesh)."""
    return 0 if mesh is None else (mesh.devices.flat[position].index or 0)


def _by_card(counts, mesh) -> tuple:
    """A step's counts by card: (FLOPs, bytes accessed where counted, a
    copy between two positions of one card read and written in its HBM
    (twice its bytes), the larger of what a card sends to and receives
    from the others)."""
    flops, nbytes = collections.Counter(), collections.Counter()
    for p, f in enumerate(counts["flops"]):
        flops[_card_of(mesh, p)] += f
        nbytes[_card_of(mesh, p)] += counts["bytes"][p] if "bytes" in counts else 0
    sent, received = collections.Counter(), collections.Counter()
    for src, dst, moved in counts["pairs"]:
        a, b = _card_of(mesh, src), _card_of(mesh, dst)
        if a == b:
            nbytes[a] += 2 * moved
        else:
            sent[a] += moved
            received[b] += moved
    return flops, nbytes, {c: max(sent[c], received[c]) for c in flops}


def _largest_term(flops, nbytes, link) -> tuple[float, str]:
    """(ms, term): the busiest card's largest term at the H100 SXM data
    sheet's peaks (launch.roofline)."""
    from repro_torch.launch import roofline as rl

    terms = {"compute": max(flops.values()) / rl.PEAK_FLOPS * 1e3,
             "memory": max(nbytes.values()) / rl.HBM_BW * 1e3,
             "collective": max(link.values(), default=0) / rl.LINK_BW * 1e3}
    dom = max(terms, key=terms.get)
    return terms[dom], dom


def _card_bound(counts, mesh=None) -> tuple[float, str]:
    """(ms, term) of a step's per-op counts (every op's bytes) by card."""
    return _largest_term(*_by_card(counts, mesh))


def _storage_bytes(tree, seen: dict) -> dict:
    """Card index -> bytes of the distinct storages of ``tree``'s tensors
    (a Placed tensor's blocks, an LM's parameters and buffers), each once;
    ``seen`` holds the storages already counted."""
    import torch

    from repro_torch.launch.sharding import Placed

    out = collections.Counter()

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (st.device, st.data_ptr())
            if key not in seen:
                seen[key] = st.nbytes()
                out[st.device.index or 0] += st.nbytes()
        elif isinstance(x, Placed):
            for blk in x.blocks:
                walk(blk)
        elif isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def _least_bound(counts, mesh, args, out) -> tuple[float, str]:
    """(ms, term) of a step's least work by card: its counted FLOPs, each
    argument's storage read once and each output's written once, and the
    bytes moved between cards."""
    flops, _, link = _by_card({"flops": counts["flops"], "pairs": counts["pairs"]}, mesh)
    io = _storage_bytes(args, {})
    io.update(_storage_bytes(out, {}))
    return _largest_term(flops, io, link)


def _peak_check(label, args_bytes: int, counted: int, real: int) -> None:
    want, got = args_bytes + real, args_bytes + counted
    print(f"{label}: peak counted {got} B ({got / 2**30:.3f} GiB: arguments {args_bytes} B and the "
          f"step's live bytes {counted} B) against the card's {want} B ({want / 2**30:.3f} GiB: "
          f"the arguments and max_memory_allocated over what was allocated before the step, "
          f"{real} B); relative {abs(got - want) / want:.4f} (limit {DRYRUN_PEAK_RTOL})")
    if abs(got - want) > DRYRUN_PEAK_RTOL * want:
        fail(f"{label}: counted peak {got} B against {want} B")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _dryrun_mesh(shape, cards: int, meta: bool):
    """A (data, model) mesh of ``shape`` over ``cards`` cards in turn
    (cuda:{i % cards}), or its meta mirror: positions that share a card
    share a meta device, as they share the card's storage and work."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import AXES, Mesh, make_meta_mesh

    cards = max(cards, 1)
    if meta:
        return make_meta_mesh(shape, AXES, cards=cards)
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device(DEV, i % cards) for i in range(devs.size)]
    return Mesh(devs.reshape(shape), AXES)


DRYRUN_STEPS = ("train", "train_sharded", "prefill", "fl_round")


def _dryrun_fl():
    """fl_lm's round (FLLMConfig's defaults), DRYRUN_ROUND_STEPS local steps."""
    import dataclasses

    from repro_torch.launch import fl_train

    return dataclasses.replace(fl_train.FLLMConfig(), n_local_steps=DRYRUN_ROUND_STEPS)


def dryrun_steps(torch, meta: bool, cards: int) -> dict:
    """The dryrun phase's four steps, label -> (step, args, mesh or None,
    warm up first, steps counted), on the card with random parameters and
    tokens, or with ``meta`` on meta tensors over the same meshes:
    qwen3-0.6b's train step at TRAIN's batch on one position and over
    train_sharded's 2 × 2 mesh (TRAIN_SHARDED's steps counted),
    qwen2-1.5b's prefill at the serve shape, one federated round at
    fl_lm's shapes (:func:`_dryrun_fl`) over the sharded phase's
    SHARDS × 1 mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, fl_train, sharding, steps
    from repro_torch.models import model as mdl
    from repro_torch.models.config import InputShape

    dev = "meta" if meta else DEV
    gen = torch.Generator().manual_seed(5)

    def params(cfg, seed):
        return steps.abstract_params(cfg) if meta else mdl.init_params(cfg, seed, device=dev)

    def tokens(shape, vocab):
        if meta:
            return torch.empty(shape, dtype=torch.int64, device="meta")
        return torch.randint(0, vocab, shape, generator=gen).to(dev)

    out = {}
    opt = steps.default_optimizer()
    cfg = get_config(TRAIN["arch"])
    b, s = TRAIN["batch"], TRAIN["seq"]
    batch = {"tokens": tokens((b, s), cfg.vocab_size), "targets": tokens((b, s), cfg.vocab_size)}
    state = steps.init_train_state(params(cfg, 0), opt)
    out["train"] = (steps.make_train_step(cfg, opt), (state, batch), None, True, 1)

    mesh = _dryrun_mesh(TRAIN_SHARDED["mesh"], cards, meta)
    (state_sh, batch_sh), _, _ = dryrun.build_shardings(
        cfg, InputShape("dryrun", s, b, "train"), mesh, "train", opt)
    out["train_sharded"] = (steps.make_train_step(cfg, opt, mesh=mesh),
                            (sharding.place(state, state_sh), sharding.place(batch, batch_sh)),
                            mesh, False, TRAIN_SHARDED["steps"])

    pcfg = get_config(SERVE["arch"])
    pshape = InputShape("serve", SERVE["prompt_len"], SERVE["batch"], "prefill")
    prompts = {"tokens": tokens((SERVE["batch"], SERVE["prompt_len"]), pcfg.vocab_size)}
    out["prefill"] = (steps.make_prefill_step(pcfg, pshape), (params(pcfg, 0), prompts), None, True,
                      1)

    fl = _dryrun_fl()
    fmesh = _dryrun_mesh((SHARDS, 1), cards, meta)
    toks = tokens((fl.m, fl.n_local_steps, fl.local_batch, fl.seq_len), cfg.vocab_size)
    weights = torch.full((fl.m,), 1.0 / fl.m, device=dev)
    out["fl_round"] = (fl_train.make_fl_round_step(cfg, fl.lr, fl.n_local_steps, mesh=fmesh),
                       (params(cfg, 1), toks, toks, weights), fmesh, False, 1)
    return out


def _count_steps(torch, step, args, mesh, reps, cuda=True):
    """:func:`_counted` of ``reps`` calls of ``step``."""
    return _counted(torch, lambda *a: [step(*a) for _ in range(reps)], args,
                    1 if mesh is None else mesh.devices.size, cuda=cuda)


def dryrun_meta_counts(path: str, cards: int, label: str) -> None:
    """The meta count of :func:`dryrun_steps`' ``label`` step, written to
    ``path`` as JSON: run in a process of its own while the card counts
    the same steps."""
    import torch

    step, args, mesh, _, reps = dryrun_steps(torch, True, cards)[label]
    summary, ops, ms, _ = _count_steps(torch, step, args, mesh, reps, cuda=False)
    Path(path).write_text(json.dumps({"counts": summary, "ops": ops, "ms": ms}))


def _wrapper_launches() -> dict:
    """The wrappers' own launch counts, by the name each reports its work
    under."""
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.sketch import ops as sk_ops

    return {"flash_attention": fa_ops.launches, "aggregate": agg_ops.launches,
            "gram": sim_ops.launches, "l1": sim_ops.launches, "srp": sk_ops.launches}


def _launches_against_calls(label, card, mesh, launched: dict) -> None:
    """Fail unless each kernel's calls in the counted step equal its
    wrapper's launches in it (``launched``), and, over a mesh, the launches
    tallied by position: every call launched the kernel on the card."""
    from repro_torch.kernels import _build

    n = len(card["flops"])
    for k in sorted(set(card["kernels"]) | {k for k, v in launched.items() if v}):
        calls = card["kernels"].get(k, {"calls": [0] * n})["calls"]
        by_pos = [_build.shard_launches[(k, p)] for p in range(n)] if mesh is not None else None
        print(f"dryrun[{label}]: {k} calls {calls}, launches {launched[k]}"
              + (f", by position {by_pos}" if by_pos is not None else ""))
        if sum(calls) != launched[k] or (by_pos is not None and calls != by_pos):
            fail(f"dryrun[{label}]: {k} calls {calls} against launches {launched[k]}, "
                 f"by position {by_pos}")


def phase_dryrun(torch, name, host: bool) -> dict:
    """The counting of launch/roofline.py held to the card: each of
    :func:`dryrun_steps` counted on the card (each kernel's calls against
    its wrapper's launches, zeroed before the step) and held equal to its
    meta count (processes started with the phase, waited for before any
    step is timed); the 2 × 2 mesh's B4 calls by position and its
    parameter bytes by position against the placements; the one-position
    train step's and the prefill's counted peaks against
    max_memory_allocated; each step's median ms in turns, nothing else
    running, beside its MFU, its least-work bound and its per-op bound at
    the data sheet's peaks. With ``host``, then the host's records.
    Returns the phase's B4 and B2 launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import sync_mesh

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    meta_proc = start_dryrun_meta(torch.cuda.device_count())
    built = dryrun_steps(torch, False, torch.cuda.device_count())
    wrappers = _wrapper_launches()
    counted = {}
    launches = {"flash_attention": 0, "aggregate": 0}
    for label, (step, args, mesh, warm, reps) in built.items():
        if warm:  # the kernels' libraries, cuBLAS's workspace
            step(*args)
        for d in wrappers.values():
            d.update(dict.fromkeys(d, 0))
        _build.shard_launches.clear()
        card, ops, ms, real = _count_steps(torch, step, args, mesh, reps)
        launched = {k: d[k] for k, d in wrappers.items()}
        _launches_against_calls(label, card, mesh, launched)
        for k in launches:
            launches[k] += launched[k]
        counted[label] = (card, ops, real)
        print(f"dryrun[{label}]: {reps} step(s) counted on the card in {ms:.1f} ms")
    dryrun_wait(meta_proc, DRYRUN_META_S)
    meta = {label: json.loads(_meta_path(label).read_text()) for label in counted}
    for label, (card, ops, real) in counted.items():
        _card_against_meta(f"dryrun[{label}]", card, meta[label]["counts"], ops, meta[label]["ops"])
        print(f"dryrun[{label}]: counted on meta in {meta[label]['ms']:.1f} ms")
    for label, tensors in (("train", _train_state_tensors(built["train"][1])),
                           ("prefill", list(built["prefill"][1][0].parameters())
                            + list(built["prefill"][1][1].values()))):
        card, _, real = counted[label]
        _peak_check(f"dryrun[{label}]", _nbytes(tensors), card["peak"][0], real)
    cfg = get_config(TRAIN["arch"])
    per = cfg.n_layers * (2 if cfg.remat else 1) * TRAIN_SHARDED["steps"]
    calls = counted["train_sharded"][0]["kernels"]["flash_attention"]["calls"]
    if calls != [per, 0, per, 0]:
        fail(f"dryrun[train_sharded]: B4 by position {calls}, want {[per, 0, per, 0]}")
    placed = built["train_sharded"][1][0]["params"]
    by_pos = sharding.bytes_by_position(placed)
    want = sharding.placement_bytes({k: v.placement for k, v in placed.items()},
                                    {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                                     for k, v in placed.items()})
    print(f"dryrun[train_sharded]: parameter bytes by position {by_pos}, placements {want}")
    if by_pos != want or by_pos != [4 * TRAIN_SHARDED_P] * len(by_pos):
        fail(f"dryrun[train_sharded]: parameter bytes {by_pos} against {want}")
    agg = counted["fl_round"][0]["kernels"]["aggregate"]["calls"]
    if agg != [1] * SHARDS:
        fail(f"dryrun[fl_round]: B2 calls by position {agg}")

    # model FLOPs (6·N·D a train token, 2·N·D a prefill token; N active)
    fl = _dryrun_fl()
    n_train = rl.active_params(built["train"][1][0]["params"], cfg)[1]
    n_serve = rl.active_params(built["prefill"][1][0], get_config(SERVE["arch"]))[1]
    model = {"train": rl.model_flops(n_train, TRAIN["batch"] * TRAIN["seq"], "train"),
             "train_sharded": rl.model_flops(n_train, TRAIN["batch"] * TRAIN["seq"], "train"),
             "prefill": rl.model_flops(n_serve, SERVE["batch"] * SERVE["prompt_len"], "prefill"),
             "fl_round": rl.model_flops(n_train, fl.m * fl.n_local_steps * fl.local_batch
                                        * fl.seq_len, "train")}

    # times in turns, beside the bounds of a step's counts
    times, least = {k: [] for k in built}, {}
    for r in range(DRYRUN_REPS):
        for k in (list(built) if r % 2 == 0 else list(built)[::-1]):
            if k == "fl_round" and len(times[k]) >= DRYRUN_FL_REPS:
                continue
            step, args, mesh, _, reps = built[k]
            _sync_all(torch)
            t1 = time.perf_counter()
            out = step(*args)
            sync_mesh(mesh) if mesh is not None else torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t1) * 1e3)
            if k not in least:
                one = {"flops": [f // reps for f in counted[k][0]["flops"]],
                       "pairs": [[a, b, n / reps] for a, b, n in counted[k][0]["pairs"]]}
                least[k] = _least_bound(one, mesh, args, out)
            del out
    for k, (counts, _, _) in counted.items():
        reps, mesh = built[k][4], built[k][2]
        one = {key: [v / reps for v in counts[key]] for key in ("flops", "bytes")}
        one["pairs"] = [[a, b, n / reps] for a, b, n in counts["pairs"]]
        bound, term = _card_bound(one, mesh)
        lbound, lterm = least[k]
        cards = 1 if mesh is None else len({_card_of(mesh, p) for p in range(mesh.devices.size)})
        med = float(np.median(times[k]))
        peak_ms = med * 1e-3 * rl.PEAK_FLOPS * cards
        print(f"dryrun[times]: {k} {med:.3f} ms median of {[round(x, 3) for x in times[k]]} (in "
              f"turns, nothing else running); mfu {model[k] / peak_ms:.4f} (model FLOPs "
              f"{model[k]:.4e}), counted FLOPs {sum(one['flops']) / peak_ms:.4f} of the peak; "
              f"least-work bound {lbound:.3f} ms ({lterm}), share {lbound / med:.4f}; per-op bound "
              f"{bound:.3f} ms ({term}; every op's bytes, a diagnostic), share {bound / med:.4f}; "
              f"at the H100 SXM data sheet's 989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s; {name}")
    del built, counted
    torch.cuda.empty_cache()
    if host:
        t1 = time.perf_counter()
        dryrun_wait(start_dryrun_host(), DRYRUN_HOST_S)
        dryrun_host()
        print(f"dryrun[host]: the four records in {time.perf_counter() - t1:.3f} s")
    else:
        print("dryrun[host]: the 16 × 16 records are left to `chip_smoke.py dryrun` and "
              "`python -m repro_torch.launch.dryrun` (minutes of host counting)")
    print(f"dryrun: {time.perf_counter() - t0:.3f} s")
    return launches


def _train_state_tensors(args) -> list:
    """The tensors of a one-card train step's state and batch."""
    state, batch = args
    opt = state["opt_state"]
    return (list(state["params"].parameters()) + list(opt["mu"].values())
            + list(opt["nu"].values()) + [opt["count"], state["step"]] + list(batch.values()))


def dryrun_only(torch) -> int:
    """``python3 chip_smoke.py dryrun``: the dryrun phase alone, the
    kernels' build first."""
    t0 = time.perf_counter()
    phase_build()
    name = torch.cuda.get_device_name(0)
    print(f"dryrun: launches {json.dumps(phase_dryrun(torch, name, host=True))}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"total: {time.perf_counter() - t0:.3f} s")
    print(smi)
    return 0


def sharded_only(torch) -> int:
    """``python3 chip_smoke.py sharded``: the sharded phase and what it is
    held to (the slice runs, fl_lm's first rounds at full width) alone,
    on every visible card; the kernels' build first."""
    t0 = time.perf_counter()
    phase_build()
    _, ds, _, _ = phase_slice(torch)
    fl_lm_run(torch, "md", "md", "sync", rounds=SHARDED_LM_ROUNDS)
    fl_lm_run(torch, "algorithm2[srp]", "algorithm2", FL_LM_SKETCH, rounds=SHARDED_LM_ROUNDS)
    torch.cuda.empty_cache()
    print(f"sharded: launches {json.dumps(phase_sharded(torch, ds))}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"total: {time.perf_counter() - t0:.3f} s")
    print(smi)
    return 0


def main(argv=()) -> int:
    import torch

    if list(argv) not in ([], ["sharded"], ["dryrun"]):
        print(f"chip_smoke: unknown arguments {list(argv)}; run with none, 'sharded' or 'dryrun'",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}; run from a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # full f32 in every product: TF32 error can flip a Ward merge
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if list(argv) == ["sharded"]:
        return sharded_only(torch)
    if list(argv) == ["dryrun"]:
        return dryrun_only(torch)
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    phase_build()
    err = phase_kernels(torch, gen)
    phase_small_input()
    phase_small_serve(torch)
    phase_small_serve(torch, SERVE_MOE["arch"])
    phase_small_serve(torch, SERVE_MLA["arch"])
    phase_small_serve(torch, SERVE_RGLRU["arch"])
    phase_small_serve(torch, SERVE_XLSTM["arch"])
    small_serve_chunked(torch)
    phase_small_serve(torch, SERVE_WHISPER["arch"])
    phase_small_serve(torch, SERVE_VL["arch"])
    launches, ds, params, round_ms = phase_slice(torch)
    launches["srp_fleet"] = phase_fleet(torch)
    phase_trace(torch, ds, params, round_ms["arccos"])
    phase_trace(torch, ds, params, round_ms["srp"], "srp", sketch="srp", sketch_dim=D_PRIME)
    cfg, lm, prompts, flash_launches = phase_serve(torch)
    phase_serve_trace(torch, cfg, lm, prompts)
    del lm, prompts  # 6.2 GB of qwen2-1.5b parameters, not the later phases' memory
    rows = phase_times(torch, gen, name, err, launches)
    srp_turns(torch, gen)
    sim_turns(torch, gen)
    agg_turns(torch, gen)
    rows.append(flash_time_row(torch, gen, name, err["flash"][FLASH_PATH], flash_launches))
    # its launches are serve_moe's, set below
    moe_row = flash_time_row(torch, gen, name, err["flash"][FLASH_MOE], None, FLASH_MOE,
                             "flash_attention_moe")
    rows.append(moe_row)
    # its launches are serve_whisper's, set below
    whisper_row = flash_time_row(torch, gen, name, err["flash"][FLASH_WHISPER], None, FLASH_WHISPER,
                                 "flash_attention_whisper")
    rows.append(whisper_row)
    rows.append(flash_time_row(torch, gen, name, err["flash"][FLASH_LONG_ROW],
                               err["flash"]["launches"][FLASH_LONG_ROW], FLASH_LONG, FLASH_LONG_ROW))
    rows[-1]["launches_from"] = ("the kernels phase's calls of flash_attention_padded at this shape; "
                                 "the serve path runs qwen2-1.5b's prefill_32k cut to a prompt of "
                                 "1,000")
    # the widened domain's instantiations, which no model path reaches: their
    # launches are the kernels phase's calls at the row's shape
    for row_name, dtype, shape in FLASH_WIDE_ROWS:
        rows.append(flash_time_row(torch, gen, name, err["flash"][row_name],
                                   err["flash"]["launches"][row_name], shape, row_name, dtype,
                                   lean=True))
        rows[-1]["launches_from"] = ("the kernels phase's calls of flash_attention_padded at this "
                                     "shape; no model path reaches this head dim or dtype")
    rows.append(flash_mixed_row(torch, gen, name, err["flash"][FLASH_MIXED_ROW],
                                err["flash"]["launches"][FLASH_MIXED_ROW]))
    paper = phase_paper(torch, gen)
    ablations = phase_ablations(torch)
    zoo = phase_zoo(torch)
    sched = phase_sched(torch)
    trained = phase_train(torch, gen, name)
    fl_lm = phase_fl_lm(torch, name)
    sharded = phase_sharded(torch, ds)
    dryrun_launches = phase_dryrun(torch, name, host=False)
    moe_row["launches"] = phase_serve_moe(torch)["flash"]
    serve_mla = phase_serve_mla(torch)
    train_moe = phase_train_moe(torch, name)
    fl_moe = phase_fl_moe(torch, name)
    serve_rglru = phase_serve_rglru(torch)
    serve_xlstm = phase_serve_xlstm(torch)
    train_rec = phase_train_recurrent(torch, name)
    fl_xlstm = phase_fl_xlstm(torch, name)
    whisper_row["launches"] = phase_serve_whisper(torch)["flash"]
    serve_vl = phase_serve_vl(torch)
    train_extras = phase_train_extras(torch, gen, name)
    whisper_row["train_extras_launches"] = train_extras["whisper"]["flash"]
    fl_vl = phase_fl_vl(torch, name)
    bench = phase_bench(torch)
    phase_block_q(torch)
    for row in rows:
        key = {"similarity_gram": "gram", "similarity_l1": "l1", "aggregate": "aggregate",
               "srp_sketch": "srp", "flash_attention": "flash_attention"}.get(row["name"])
        if key is not None:
            row["bench_launches"] = bench[key]
        key = {"similarity_gram": "gram", "aggregate": "aggregate", "srp_sketch": "srp"}.get(row["name"])
        if key is not None:
            row["paper_launches"] = paper[key]
            row["zoo_launches"] = zoo[key]
            row["sched_launches"] = sched[key]
            row["fl_lm_launches"] = fl_lm["launches"][key]
            row["fl_moe_launches"] = fl_moe["launches"][key]
            row["fl_xlstm_launches"] = fl_xlstm["launches"][key]
            row["fl_vl_launches"] = fl_vl["launches"][key]
            row["sharded_launches"] = sharded[key]
        if row["name"] == "aggregate":
            row["dryrun_launches"] = dryrun_launches["aggregate"]
        key = {"similarity_gram": "gram", "similarity_l1": "l1", "aggregate": "aggregate"}.get(row["name"])
        if key is not None:
            row["ablations_launches"] = ablations[key]
        if row["name"] == "flash_attention":
            row["train_launches"] = trained["flash"]
            row["fl_lm_launches"] = fl_lm["launches"]["flash_attention"]
            row["serve_mla_launches"] = serve_mla["flash"]
            row["train_moe_launches"] = train_moe["flash"]
            row["fl_moe_launches"] = fl_moe["launches"]["flash_attention"]
            row["serve_rglru_launches"] = serve_rglru["flash"]
            row["serve_xlstm_launches"] = serve_xlstm["flash"]
            row["train_recurrent_launches"] = train_rec["flash"]
            row["fl_xlstm_launches"] = fl_xlstm["launches"]["flash_attention"]
            row["serve_vl_launches"] = serve_vl["flash"]
            row["train_extras_launches"] = train_extras["vl"]["flash"]
            row["fl_vl_launches"] = fl_vl["launches"]["flash_attention"]
            row["sharded_launches"] = sharded["flash_attention"]
            row["train_sharded_launches"] = sharded["train_sharded"]
            row["dryrun_launches"] = dryrun_launches["flash_attention"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"total: {time.perf_counter() - t0:.3f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
