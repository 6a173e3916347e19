#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:

1. Print the card's name and power limit; switch TF32 off.
2. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
3. Kernel parity: every kernel against its plain PyTorch version on the
   card, f32 and bf16, over the port's copy of the kernel-harness grids and
   the full-width llava-1.5-7b shapes and the bf16 tiles' edges, at the
   harness tolerances; the grouped kernel also at the mamba2 decode shape
   and its own edges (``harness.GROUPED_LORA_EDGE_SHAPES``), its rows
   bit-identical to the single-adapter kernel in f32, and its identity rows
   (ids outside [0, N)) exactly x. The bf16
   flash and LoRA kernels (tensor cores) also against their rounding models
   at ``harness.BF16_MODEL_TOLERANCES`` (LoRA also at most
   ``harness.LORA_MODEL_MAX_SHARE`` of its elements differing), and, at the
   main-path shapes, against the f32 function beside the exact plain version
   and the models beside the exact plain versions (``[accuracy]``).
4. Smoke-size serving: the engine on the card (kernels, f32) and on the CPU
   (plain versions) give the same tokens and prefill logits.
5. Full-width serving: ``ServingEngine`` on llava-1.5-7b (32 layers,
   d_model 4096, bf16, random weights from a seed) with the three kernels,
   16 requests from 4 tenants and base traffic. Launch counters are reset
   just before this run and read just after it. The same requests then run
   with the kernels replaced by their plain versions, in bf16 and again with
   the same weights upcast to f32: prefill logits must agree within
   LOGIT_TOL. Each bf16 run is also measured against the f32 plain run.
6. Training kernel parity: the fisher_merge and fisher_fold kernels against
   their plain versions, f32 bit for bit (the port's copy of the harness grid
   plus the slice's K=2, N=262,144 on (K, N) stacks, and whole adapter trees:
   the harness trees, llava's 4 leaves at K = 1, 2, 5 and the tree kernel's
   edges), and the gradients of the LoRA and flash-attention
   Functions (kernel forward, hand-written backward) against torch.autograd
   through the plain versions, f32 and bf16, including x (128, 4096) and
   (256, 4096) (the text and image rows NanoEdge gives the kernel), x
   (384, 4096) and q/k/v (4, 96, 32, 128); flash attention's bf16 backward
   kernel at the training cells' shapes (``harness.FLASH_BWD_SHAPES[:2]``)
   against its rounding model (``harness.BF16_MODEL_TOLERANCES``) and
   the exact plain backward on the same saved out and lse (``[accuracy]``).
7. Smoke-size training: two FedNano rounds of smoke llava on the card
   (kernels, f32) and on the CPU (plain versions): round losses, global
   adapters and the first step's loss and adapter gradients within 1e-5,
   comm totals equal.
8. Full-width training, the slice's main path: ``run_federated`` with
   strategy fednano on llava-1.5-7b (32 layers, d_model 4096, bf16 backbone
   from a seed, f32 rank-64 text and image adapters), 2 clients, 2 rounds,
   2 local steps and 2 Fisher batches each, batch 4 of 64 patches + 32 text
   tokens, kernels on (``cfg.use_pallas`` and ``use_pallas``). Launch counters
   are reset just before and read just after; the server's merge must be one
   fisher_merge launch a round for the whole adapter tree. A second run with
   ``agg_chunk=1`` takes round 0 through the fisher_fold kernel, one launch an
   upload, also with its counters reset around it; its streamed merge must
   equal the fisher_merge kernel's batch merge of the same uploads to f32
   summation order.
9. Full-width kernel check: the loss and adapter gradients of the first
   local step and of the trained adapters, kernel path against the
   plain-version path, in f32 on the same weights upcast (within 1e-4) and in
   bf16 (a gross bound, GRAD_TOL); the whole bf16 run's round losses against
   a run on the plain versions.
10. Time each kernel at its main-path shape (CUDA events), beside its plain
   version, one PyTorch library call where one computes the same function,
   and the H100 bound (LoRA also at (256, 4096) and (384, 4096), with its
   bytes-only floor, an f32 ``torch.addmm`` beside the bf16 one and the
   device time of each CUDA kernel it launches; flash also at (4, 96, 32,
   128); grouped LoRA at the decode step with 4, 1 and 8 of its 8 adapters
   in use); flash attention's backward kernel at the training cells' shapes
   (``flash_bwd_timing``: warm and cold, its bound, the plain backward,
   SDPA's backward); the gradients beside autograd through the plain
   versions and SDPA; the Fisher merge and fold on whole adapter trees (``FISHER_TIMED``:
   llava's at K = 2 and 5, mamba2's, and one llava leaf); and the training
   step, Fisher batch, merge (also at K = 5, with its launches and aten ops)
   and round end to end.
   Warm times replay 50 calls on the same inputs; the kernels whose inputs
   fit in the 50 MB L2 (LoRA, grouped LoRA, flash attention, the SSD scan,
   Fisher merge and fold) are also
   timed cold (``time_ms_cold``: the calls rotate over copies of the inputs,
   more than 100 MB apart), and their ``[time]`` lines give both times'
   share of the bound. The kernels' line is printed at the end.
11. Profile a short full-width serving run and one full-width local step
   (torch.profiler): device busy share and device time by kernel.
12. The paper's strategies on its second backbone, minigpt4-7b (llava's 32
   layers, d_model 4096, MHA with 32 heads of 128, d_ff 11008, vocab 32000;
   a connector from 32 query embeddings of width 768), drawn after llava's
   server is freed:
   a. smoke minigpt4-7b in f32, each of the eight strategies for two rounds,
      card (kernels) against CPU (plain versions): round losses and the
      first step's loss and gradients within 1e-5, the global adapters and
      the clients' own (LocFT's, FedDPA-F's personal ones) within
      ROUNDING_MARGIN times the CPU f32 run's distance from a CPU f64 run of
      the same weights and clients (at least 1e-5, at most
      SMOKE_ADAPTER_TOL), comm totals equal;
   b. full width, bf16 weights from seed 0, 2 clients x 2 rounds x 2 local
      steps (2 Fisher batches), batch 4 x (32 query embeddings + 32
      tokens): each strategy with the kernels (counters reset around each
      run; LoRA dx launches only under FedDPA-F, fisher_merge only under
      FedNano and FedNano-EF) and on the plain versions from a fresh copy of
      the server, round 0 within RUN_LOSS_TOL_BF16 (round 1 reported), comm
      totals against the expected bytes; the final evaluation counted with
      the run (FedDPA-F's personal adapters one LoRA launch a batch); the
      local step and the server merge timed; the same runs in f32 on the
      first STRATEGY_F32_LAYERS layers upcast, round 0 within LOSS_TOL, round 1 within
      STRATEGY_RUN_TOL_F32, one step's loss and gradient within LOSS_TOL and
      GRAD_TOL; FedNano-EF's agg_chunk=1 round through fisher_fold (the
      streamed merge within 1e-6 of fisher_merge's); FedAvg with top-k
      (0.1), int8 + EF and DP clip (noise 0), and a UniformSampler(0.5)
      cohort of 4 clients, wire bytes equal to the reference's formula.
13. The ssm family (mamba2-130m, 24 layers, d_model 768, 24 SSD heads of 64,
   state 128, chunk 256), through the SSD scan kernel:
   a. kernel parity: the SSD kernel against its plain version over the
      harness grid, its phase and tile edges and the full-width shapes
      (1, 512) and (4, 1024), f32 at 1e-6 (1e-5 at full width) and bf16 at
      5e-2, its gradients (kernel forward, backward recomputed through the
      plain version) against autograd, the bf16 kernel (tensor cores)
      against its rounding model at ``harness.BF16_MODEL_TOLERANCES`` with at
      most ``harness.SSD_MODEL_MAX_SHARE`` of its elements differing, the
      accuracy of both against the f32 function at full width
      (``[accuracy]``), and the LoRA and Fisher kernels at d_model 768;
   b. smoke mamba2 in f32, card (kernels) against CPU (plain versions):
      serving tokens equal, two FedNano rounds within 1e-5;
   c. full-width serving, bf16 weights from seed 0: 16 requests from 4
      tenants and base traffic, ragged prompts of 64-512 tokens and one of
      2, prefill_len 512 (two chunks), 16 new tokens, 8 decode slots, 8
      adapter slots, counters reset around the run; prefill logits, kernels
      against plain versions, in bf16 and in f32 on the same weights;
   d. full-width training: FedNano, 2 clients x 2 rounds, 2 local steps and
      2 Fisher batches, batch 4 x 1024 text tokens (four chunks a row),
      kernels on, counters reset around the run, and one agg_chunk=1 round;
      loss and adapter gradients of one step, kernels against plain
      versions, in f32 (1e-4) and bf16;
   e. timings: the SSD kernel at both full-width shapes against its plain
      version and its bound (bf16 tensor-core rate, and the f32 CUDA-core
      rate beside it), with the device time of each of its three launches;
      the LoRA kernel at d_model 768 and the grouped kernel at mamba2's
      decode step (x (8, 768), 4 adapters in use), the local step, Fisher batch, merge and
      round; a profiled local step, and a profiled full-width prefill of 512
      tokens with four decode steps.
14. The dense family, one arch after another, each freed before the next
   is drawn: h2o-danube-1.8b (24 layers, d_model 2560, 32 heads of 80 over 8
   KV heads, a 4,096-key sliding window), glm4-9b (40 layers, d_model 4096,
   GQA 16, QKV bias, vocab 151,552), qwen1.5-4b (40 layers, d_model 2560, 20
   heads, QKV bias) and internlm2-20b (48 layers, d_model 6144, GQA 6), at
   published width and full depth in bf16, weights from seed 0:
   a. serving: 16 requests of 4 tenants and base traffic (``DENSE_SERVE_KW``)
      through the kernels, counters reset around the run, prefill logits held
      against the plain versions at LOGIT_TOL; for h2o-danube also 8 prompts
      of 3,900-4,096 tokens with 64 new tokens, so decode wraps its
      4,096-slot KV ring (``H2O_RING_KW``);
   b. training: FedNano 2 clients x 2 rounds x 2 steps at batch 4 x 32
      tokens and one agg_chunk=1 round (as phase 8), round 0 held against
      round 0 on the plain versions at RUN_LOSS_TOL_BF16; the loop's times
      (``loop_timings``);
   c. the same weights upcast to f32 in place (internlm2-20b at 16 of its 48
      layers: 79.6 GB in f32 does not fit one card): prefill logits of the
      16 requests at 1e-4, one step's loss and adapter gradients at 1e-4;
   d. h2o-danube's window on the training path: one local step at batch 1 x
      6,144 tokens on 2 of its 24 layers, bf16 and f32, kernels against
      plain versions at LOSS_TOL and GRAD_TOL; and its ring in f32 on 2
      layers: a prefill below the window and one above it, each decoded
      past position 4,096, every decode step's logits held at 1e-4 against
      the full windowed forward of the same tokens, kernels and plain
      versions (``ring_decode_check``);
   e. the flash kernel at head dim 80 timed at h2o-danube's prefill and
      training shapes beside SDPA and its bound, and head dim 128 at the
      prefill's length.
   Phase 3 covers head dim 80 (``harness.FLASH_EDGE_SHAPES``) and the dense
   family's full-width attention shapes (``harness.DENSE_FLASH_SHAPES``).
15. qwen2-vl-72b (80 layers, d_model 8192, 64 heads of 128 over 8, QKV
   bias, M-RoPE, 64 image patches of width 1,280) and the MoE family,
   llama4-scout-17b-a16e (48 layers, d_model 5120, 40 heads over 8, 16
   experts top-1 of d_ff 8192 and a shared expert) and grok-1-314b (64
   layers, d_model 6144, 48 heads over 8, 8 experts top-2 of d_ff 32768,
   GELU, attention logits capped at 30):
   a. smoke size, card (kernels, f32) against CPU (plain versions): phase
      4's serving (tokens and prefill logits) and phase 7's two FedNano
      rounds, the adapters held as phase 12a holds them;
   b. each at published width in bf16, weights from seed 0, cut to its
      first MOE_LAYERS layers (published depth does not fit one card; the
      line says why), one after another, each freed before the next is
      drawn: serving and training as phase 14 (``DENSE_SERVE_KW``, qwen2-vl
      with 64 patches a request and a row), bf16 prefill logits at 1e-1 and
      round 0 at 2e-2; every run on the plain versions that is held
      against a kernel run takes that run's expert choices
      (``replayed_routes``: rounding flips near-tied choices of the random
      routers). For the MoE pair, the choices the capacity dropped in each
      layer over the prefills, one decode step (each page routes alone and
      drops none, else it fails) and one training batch, and the share of
      expert choices on which free kernel and plain runs differ, by layer;
      then the weights upcast to f32 in place at MOE_F32_LAYERS: prefill
      logits at 1e-4, one step's loss and adapter gradients at 1e-4, round
      0's loss at 1e-4 with its adapters beside a witness (the same round
      by the use_pallas=False path), and the flips by layer of bf16 kernels
      against bf16 plain versions and of bf16 plain versions against f32
      plain versions at that depth;
   c. the flash kernel timed at the three prefill shapes (grok's with its
      softcap, beside no SDPA). Phase 3 holds the flash kernel at these
      configs' full-width attention shapes (``harness.MOE_FLASH_SHAPES``)
      and the softcap at GQA 5 and 6 (``harness.FLASH_EDGE_SHAPES``), the
      LoRA kernel at their NanoEdge rows and the grouped kernel at their
      decode banks, d_model 5,120, 6,144 and 8,192
      (``harness.MOE_LORA_SHAPES``, ``MOE_GROUPED_SHAPES``; bf16 also
      against the rounding model); phase 6 the flash gradient with the
      softcap (``harness.MOE_FLASH_GRAD_SHAPES``) and the LoRA gradients at
      those rows (``harness.MOE_LORA_GRAD_SHAPES``).
16. The last two families: recurrentgemma-9b (hybrid: 12 (rec, rec, attn)
   triples and 2 trailing RG-LRU layers, d_model 4096, 16 heads of 256 on
   one KV head at a 2,048-key local window, GeGLU) and whisper-base (audio:
   6 encoder and 6 decoder layers, d_model 512, 8 heads of 64, LayerNorm,
   learned positions, 1,500 frames a clip through the connector and the
   image adapter):
   a. smoke size, card (kernels, f32) against CPU (plain versions): phase
      4's serving (tokens and prefill logits) and phase 7's two FedNano
      rounds, the adapters held as phase 12a holds them; smoke
      recurrentgemma at 5 layers (``SMOKE_OVERRIDES``), so its extra
      recurrent layers run, decoding past its 64-slot ring;
   b. recurrentgemma-9b at published width and depth (38 layers) in bf16,
      weights from seed 0: 16 requests with prompts of 2 and 64 to 2,048
      tokens at prefill_len 2,048 (``NEW_SERVE_KW``) and FedNano as phase
      14, bf16 prefill logits at 1e-1 and round 0 at 2e-2; then the same
      weights upcast to f32 in place: prefill logits of ``NEW_F32_REQUESTS``
      at 1e-4, one step's loss and adapter gradients at 1e-4; the line
      prints the params' bytes, and ``[serve]`` the peak memory and the
      decode step; then its ring in f32 on 5 layers (1 triple + 2 extras,
      ``RGEMMA_RING_CHECK``): a prefill below the window and one above it,
      each decoded past position 2,048, every step's logits held at 1e-4
      against the full forward, kernels and plain versions;
   c. whisper-base at published width and depth, the same in bf16 and f32,
      with 1,500 frames a request and a training row;
   d. the flash kernel timed at ``harness.HYBRID_FLASH_SHAPES`` and
      ``AUDIO_FLASH_SHAPES`` beside SDPA (a band mask where the window cuts
      keys) and its bound, the LoRA kernel over whisper's frames and the grouped
      kernel at d_model 512.
   Phase 3 holds the flash kernel at those shapes and the LoRA and grouped
   kernels at ``harness.NEW_FAMILY_LORA_SHAPES`` and ``AUDIO_GROUPED_SHAPES``;
   phase 6 the gradients at ``NEW_FAMILY_FLASH_GRAD_SHAPES`` and
   ``NEW_FAMILY_LORA_GRAD_SHAPES``.

17. Resume under failures, checkpoint-loaded tenants and the naive loop,
   run right after phase 11 on phase 8's llava-1.5-7b server:
   a. smoke llava in f32, FedNano with 3 clients for RESUME_ROUNDS rounds
      under a FailureModel (dropout 0.3, crash 0.3, the seed of
      FAILURE_KW), uninterrupted against cut after RESUME_CUT and resumed,
      on the card (kernels) and on the CPU (plain versions): each device's
      resumed run equal to its uninterrupted one (RESUME_TOL), card against
      CPU round losses within 1e-5, participants, drops, crashes and comm
      totals equal, the global and the clients' adapters each within
      ROUNDING_MARGIN times their spread on the CPU (the largest gap
      between the kernels' plain order, the use_pallas=False order and f64);
   b. the CLIs on the card: ``train --checkpoint-every 1 --crash-prob 0.3``,
      ``train --resume``, ``serve --ckpt-root`` over the written server
      checkpoint and ``serve --naive``, each exiting 0 with token parity;
   c. full width, bf16, kernels on: the same runs at llava's training shape
      (3 clients, batch 4 x (64 patches + 32 tokens), 2 steps, 2 Fisher
      batches), counters reset just before and read just after them
      (``resume_llava``): round losses, counts, comm and every adapter of
      the resumed run within RESUME_TOL of the uninterrupted one; the
      snapshots' size and save and load seconds;
   d. the resumed run's global and client adapters written as bare ``.npz``
      tenants and served, 16 requests with base traffic (``SERVE_KW``),
      through ``ServingEngine`` with ``checkpoint_adapter_loader``
      (``ckpt_serve_llava``) and through ``generate_naive``
      (``naive_llava``), each with its counters reset around it: tokens/s of
      both, the speedup, the share of equal tokens in bf16;
   e. the weights upcast to f32 in place: the engine against the naive loop,
      every token equal or each first difference a near tie of the
      reference (top-2 logits within NEAR_TIE of ‖logits‖∞), and step c
      again at RESUME_TOL;
   f. the LoRA kernel timed at one row (1, 4096) and flash at the unpadded
      prefill (1, 67, 32, 128). Phase 3 holds both shapes
      (``harness.FULL_LORA_SHAPES``, ``FULL_FLASH_SHAPES``).

18. The vmap and buffered round engines, on phase 8's llava-1.5-7b server.
   Phase 3 holds the vmap engine's batched LoRA kernel (``lora_residual_many``,
   one call over K clients, each with its own adapter) against its plain
   version at ``harness.MANY_LORA_SHAPES``, ``FULL_MANY_LORA_SHAPES`` (llava's
   cohort of 4 clients' text and image rows, and K = 1, 3, 8) and
   ``MANY_LORA_EDGE_SHAPES``, f32 and bf16, bf16 against its rounding model,
   f32 rows bit-identical to the one-adapter kernel's, its gradients at
   ``MANY_LORA_GRAD_SHAPES``; phase 10 times it (``[time]
   lora_residual_many``) beside K one-adapter launches and torch.baddbmm.
   Run right after phase 11, before phase 17, in bf16:
   a. smoke llava in f32, 4 clients, card (kernels) against CPU (plain
      versions): the vmap engine for fednano, fedprox and feddpa_f (which
      reaches the batched kernel's dx launch), 2 rounds; the buffered
      engine at one buffer of all 4 (then also against the sequential
      engine's streaming merge: staleness 0, the same arithmetic) and with
      client 0 at 3 ticks, FedBuffOpt(0.5) and a FailureModel that drops,
      crashes and straggles, 4 merges; losses within 1e-5, counts and comm
      equal, adapters as phase 17a holds them;
   b. full width, bf16: FedNano with 4 clients (COHORT_DATA), 2 rounds of 2
      steps and 2 Fisher batches, ``engine="vmap"`` against
      ``engine="sequential"`` on the same server and data, counters reset
      around each run (the batched LoRA 8 launches a round against the
      sequential 32 one-adapter launches, flash 64 a cohort step against
      256: 32 layers, each launched again in remat's recompute), round 0
      within RUN_LOSS_TOL_BF16 (round 1 reported), comm equal;
      a vmap run with ``agg_chunk=2`` folds two cohorts by fisher_fold,
      held against fisher_merge of the same uploads at 1e-6; a cohort step
      against a sequential client step (host ms, trained tokens/s, busy
      share under the profiler), round wall and peak memory of each engine;
   c. full width, bf16: the buffered engine, 4 clients, client 0 at 3
      ticks, buffer 2, FedBuffOpt(0.5), FailureModel(straggler_prob 0.3),
      4 merges: every merge of 2, staleness above 0 in one at least; the
      run snapshots after every merge, and a run resumed from merge 2 must
      equal it (RESUME_TOL; zero printed); the snapshot's MB, save and load
      ms.
   After phase 17 (which upcasts the weights in place), 18b in f32 on the
   first COHORT_F32_LAYERS layers: round 0 within 1e-4, the first cohort
   step's per-client loss and adapter gradients against each client's own
   step within 1e-4, and the adapters after both rounds within
   ROUNDING_MARGIN times the gap between two f32 orders of the sequential
   engine (kernels, and use_pallas=False).
19. The split-learning runtime, rank-heterogeneous NanoAdapters and the
   sharded round engine, on phase 8's llava-1.5-7b server at phase 18's batch
   (4 x (64 patches + 32 tokens)), kernels on. Phase 3 holds LoRA at ranks
   16 and 32 at d 4,096 (``harness.HETERO_LORA_SHAPES``) and the batched
   kernel at rank 16 (``HETERO_MANY_LORA_SHAPES``).
   a. After phase 18, in bf16, and after 18b's f32 half, in f32: one split
      step (``split_train_grads``: NanoEdge on the client, the backbone's
      forward and backward with respect to the wire, the client's backward)
      against the fused gradient of ``fednano_loss`` on adapters off
      identity, f32 within SPLIT_TOL (bf16 printed); the wire bytes equal to
      ``split_activation_bytes_per_step``; the ms of a split and a fused step.
   b. f32: three clients at ranks 16, 32 and 64 (alpha 2r) each take one
      local step through the kernels; ``hetero_fisher_merge`` of their
      uploads against the fisher_merge kernel on the padded trees (1e-6);
      ranks 16 and 32 alone in rank-64 space leave every coordinate past 32
      exactly 0 (no NaN), plain and kernel; the merge's rank-16 slice padded
      back to 64 gives the slice's NanoEdge output through the LoRA kernel
      (1e-6).
   c. f32 on the first SHARDED_LAYERS layers: FedNano, 8 clients, the
      sharded engine on ``client_mesh()`` against the vmap engine (round 0,
      1e-5), with the Fisher kernels' per-client merge against its stacked
      merge (1e-5), an ``agg_chunk=2`` round by fisher_fold against
      fisher_merge (1e-6), overlap on against off and a resume from round 1
      (both to the bit), a mesh of two ``cuda:0`` entries against one
      (1e-5); round time and peak memory of each run, the busy share of a
      round with overlap on and off, the host syncs of a round
      (``torch.cuda.set_sync_debug_mode``). Counters are reset around each
      run; phase 19 must launch lora_residual, lora_residual_many,
      flash_attention, fisher_merge and fisher_fold.
20. The launch layer's step functions (``repro_torch.launch.steps``) at the
   production shapes (``INPUT_SHAPES``), last:
   a. ``[dryrun]``: every assigned arch x shape's analytic per-card
      footprint on one card (1x1) and on an eight-card node (1x8), from
      meta tensors, and the roofline record (``dryrun.roofline_report``) of
      each pair below.
   b. At full width and depth, bf16, kernels on (``LAUNCH_RUNS``):
      h2o-danube-1.8b and mamba2-130m at train_4k, prefill_32k, decode_32k
      (128 rows at position 32,767) and long_500k (position 524,287), and
      recurrentgemma-9b at the two decode shapes. Each at its global batch or
      the largest batch the card holds (``dryrun.fit_batch``, whose two
      probe steps warm it up; else one warm-up step; a train step with
      remat on, as the config has it), LAUNCH_ITERS steps
      timed by CUDA events, counters reset around them; the measured peak beside the
      analytic footprint, the ms beside the roofline's terms. Phase 20 must
      launch lora_residual, flash_attention and ssd_scan.
   c. Each step with kernels against the plain path on the first
      LAUNCH_CHECK_LAYERS layers, bf16 and f32 (train: LOSS_TOL, GRAD_TOL;
      prefill and decode logits and state: LOGIT_TOL); for h2o-danube the
      flash kernel against ``chunked_sdpa`` at 32,768 positions (f32 at
      ATTN_F32_TOL, bf16 printed) and ``chunked_lm_loss`` against
      ``lm_loss`` at train_4k rows (CHUNKED_LOSS_TOL, peak memory of
      each); for h2o-danube and recurrentgemma the decode to position
      524,287 against the full windowed forward (f32, LOGIT_TOL).
21. The port's three examples (``repro_torch.examples``) through their ``run``
   functions, last:
   a. at the JAX examples' own tiny dims in f32, from the same CPU-drawn
      weights, the card (kernels) against the CPU (plain versions):
      quickstart's six epoch losses and federated VQA's round losses and
      per-client accuracies (``EXAMPLES_VQA_SMOKE``) within EXAMPLES_TOL,
      split serving's tokens equal (or each first difference a near tie of
      the CPU's logits, under NEAR_TIE), the wire and ledger bytes equal;
   b. llava-1.5-7b at full width, bf16 weights from seed 0, kernels on,
      counters reset around each run: quickstart for EXAMPLES_FULL_EPOCHS
      epochs, federated VQA's three strategies (``EXAMPLES_VQA_FULL``) and
      split serving's 8 requests of 5 tokens, each again on the plain
      versions from the same weights: the first epoch's and each strategy's
      round-0 loss held at RUN_LOSS_TOL_BF16, the rest and the token
      agreement reported; ms a quickstart step, round wall s by strategy,
      prefill and decode-step ms, peak memory. Each kernel run records the
      inputs of the path's LoRA, flash and Fisher-merge calls (the last call
      of each shape, ``path_inputs``) and calls each wrapper again on them
      against its plain version at ``harness.TOLERANCES``, bf16 LoRA and
      flash also against their rounding models at
      ``harness.BF16_MODEL_TOLERANCES``, each LoRA call again with a random
      up-projection whose term is max(1, ‖x‖∞) (``[examples-kernels]``).
      Phase 21 must launch lora_residual, flash_attention and fisher_merge.
22. ``remat`` (``ModelConfig.remat``, on in every full config, so every
   full-width training run above checkpoints each layer body and launches
   flash attention and the SSD scan once more a layer in the backward's
   recompute), last:
   a. h2o-danube-1.8b and mamba2-130m at train_4k, full width and depth,
      bf16, kernels on, with remat off (``--override remat=false``): the
      peak a row from ``dryrun.fit_batch``'s two probe steps, the rows the
      card holds and ms a step at that batch, counters reset around it,
      beside phase 20's run of the same shape with remat on; the per-row
      peak split into the layer inputs (``dryrun.train_transients``), the
      larger of two transients that do not peak together (the f32 logits and
      their gradient; h2o-danube's flash backward kernel of one layer,
      measured alone) and the rest;
   b. llava-1.5-7b's local step (batch 4 x (64 + 32)) with remat on and
      off: ms a step and the peak above the weights;
   c. one step's loss and adapter gradients, remat on against off on the
      same inputs (``remat_hold``): equal to the bit; each setting's launches
      counted, flash and SSD exactly twice as many with remat, every other
      kernel (the flash backward among them) as many. Held for a and b at batch 1 and 4, and at the depths
      their phases run for llama4-scout (15b, MOE_LAYERS), recurrentgemma-9b
      and whisper-base (16b, full depth).
   MoE routes recorded or replayed (``recorded_routes``,
   ``replayed_routes``) skip the recompute's calls: a replayed recompute
   takes its layer's forward choices. Every phase logs its seconds
   (``[phase N ...]`` or ``[phaseN]``).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside this file, it fails before printing a result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The port's package; alone (without the checkout around it) the import fails.
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by
# type, the constants of the launch layer's roofline too.
from repro_torch.launch.mesh import HBM_BYTES_PER_S, PEAK_OPS  # noqa: E402

SCALE = 2.0
# Full-width prefill logits, kernels vs their plain versions, relative to ‖ref‖∞.
# f32 holds the kernels to their arithmetic through all 32 layers. In bf16 a
# one-ulp difference in a kernel's rounded output grows through 32 layers of
# random weights (3.5e-2 and 3.8e-2 measured on an H100 at 700 W, where 2e-2
# was hoped for; the model's own use_pallas=False path differs by 5e-2 to
# 6e-2), so bf16 gets a gross-error bound.
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
TRAIN_HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)
TRAIN_DATA = dict(n_clients=2, examples_per_client=32, batch_size=4, seq_len=32, seed=0)
# Full-width loss and adapter gradients of one step, kernels vs plain
# versions, relative to ‖ref‖∞: f32 holds the kernels' arithmetic through 32
# layers forward and back (2.8e-6 and 3.2e-6 for the gradients measured on an
# H100 at 700 W). In bf16 the forward's rounding differences (3.5e-2 to
# 3.8e-2 in PR 11's logits) pass through the backward's 32 layers again:
# 2.4e-2 and 3.0e-2 measured for the gradients, 6.4e-4 and 4.7e-3 for the
# losses. The bf16 bounds are about 3x those: they catch a gross fault of
# the bf16 path, while the kernels themselves are held by the f32 bound
# and by phase 6's bf16 check at 2e-2.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The whole bf16 run's round losses, kernels vs plain versions: AdamW's first
# step moves every adapter element with |g| >> 1e-8 by about lr·sign(g), so
# bf16 noise in small gradient elements moves whole entries (the final
# adapters differ by 1.1 of ‖ref‖∞), and round 1 starts from other adapters:
# 5.1e-3 measured on the H100. About 4x that, for a gross fault.
RUN_LOSS_TOL_BF16 = 2e-2
MAMBA = "mamba2-130m"
# Full-width serving of each arch: engine settings and the number of requests.
SERVE_KW = {
    "llava-1.5-7b": dict(max_slots=8, prefill_len=128, max_new_tokens=16, adapter_slots=8),
    MAMBA: dict(max_slots=8, prefill_len=512, max_new_tokens=16, adapter_slots=8),
}
# Smoke-size serving and training of each arch, card against CPU. mamba2's
# prompts and rows cross its smoke config's 32-step SSD chunk.
SMOKE_SERVE = {"llava-1.5-7b": (dict(max_slots=3, prefill_len=8, max_new_tokens=6,
                                     adapter_slots=4), 6),
               MAMBA: (dict(max_slots=3, prefill_len=40, max_new_tokens=6, adapter_slots=4),
                       12)}
SMOKE_SEQ = {"llava-1.5-7b": 16, MAMBA: 40, "minigpt4-7b": 16}
TRAIN_DATA_BY_ARCH = {"llava-1.5-7b": TRAIN_DATA, MAMBA: dict(TRAIN_DATA, seq_len=1024)}
# The dense family, one arch after another at published width and full depth
# in bf16: 16 requests of 4 tenants and base traffic as llava's [serve], and
# FedNano 2 clients x 2 rounds x 2 steps at batch 4 x 32 tokens (TRAIN_DATA).
H2O = "h2o-danube-1.8b"
DENSE_ARCHS = (H2O, "glm4-9b", "qwen1.5-4b", "internlm2-20b")
DENSE_SERVE_KW = dict(max_slots=8, prefill_len=128, max_new_tokens=16, adapter_slots=8)
# f32 on the same weights upcast: internlm2-20b needs 79.6 GB in f32, more than
# one 80 GB card, so its f32 checks keep the first 16 of its 48 layers.
DENSE_F32_LAYERS = {"internlm2-20b": 16}
# h2o-danube past its 4,096-key window. Serving: prefill_len 4096, the most
# the engine's window guard allows, 8 prompts of 3,900-4,096 tokens and 64 new
# tokens, so decode wraps the 4,096-slot ring. Training: one local step at
# batch 1 x 6,144 tokens, where the window masks keys; the plain path holds a
# (32, 6144, 6144) f32 score matrix a layer for autograd (4.8 GB), so this
# step runs the first 2 of the 24 layers.
H2O_RING_KW = dict(max_slots=8, prefill_len=4096, max_new_tokens=64, adapter_slots=8)
H2O_RING_PROMPTS = (3900, 4096)
H2O_WINDOW_STEP = dict(seq_len=6144, n_layers=2)
# h2o-danube's ring in f32 on its first 2 layers: one sequence of 4,300
# tokens, prefilled to 4,000 positions (below the window; decode wraps the ring
# at 4,096) and to 4,200 (above it; the seeded ring is rolled), and decoded
# teacher-forced to its end. Every decode step's logits are held against the
# full windowed forward of the 4,300 tokens, kernels and plain versions.
H2O_RING_CHECK = dict(n_layers=2, seq_len=4300, prefills=(4000, 4200))
# qwen2-vl-72b (M-RoPE, 64 heads on 8, QKV bias, 64 image patches of width
# 1,280) and the MoE family, llama4-scout-17b-a16e (16 experts, top-1, a
# shared expert; 40 heads on 8) and grok-1-314b (8 experts, top-2, GELU;
# attention logits capped at 30; 48 heads on 8), at published width in bf16.
# Published depth does not fit one 80 GB card (141, 211 and 630 GB of bf16
# weights), so each keeps its first MOE_LAYERS layers (about 47, 57 and 52
# GB), and its f32 checks, on the same weights upcast in place, its first
# MOE_F32_LAYERS (about 38, 44 and 46 GB). The dense one-hot dispatch reads
# every expert's weights on every call.
MOE_ARCHS = ("qwen2-vl-72b", "llama4-scout-17b-a16e", "grok-1-314b")
MOE_LAYERS = {"qwen2-vl-72b": 24, "llama4-scout-17b-a16e": 12, "grok-1-314b": 5}
MOE_F32_LAYERS = {"qwen2-vl-72b": 8, "llama4-scout-17b-a16e": 4, "grok-1-314b": 2}
SMOKE_SERVE.update({a: (dict(max_slots=3, prefill_len=8, max_new_tokens=6, adapter_slots=4), 6)
                    for a in MOE_ARCHS})
SMOKE_SEQ.update({a: 16 for a in MOE_ARCHS})
# The last two families at published width and depth: recurrentgemma-9b
# (hybrid: 12 (rec, rec, attn) triples + 2 recurrent layers, d_model 4096, 16
# heads of 256 on one KV head at a 2,048-key local window, GeGLU; 10.4 B
# params, 20.9 GB in bf16 and 41.8 GB in f32, so it runs at full depth in
# either dtype) and whisper-base (audio: 6 encoder + 6 decoder layers,
# d_model 512, 8 heads of 64, LayerNorm, learned positions, 1,500 frames).
# Smoke recurrentgemma takes 5 layers, so that its two extra recurrent
# layers run (``reduced()`` keeps one triple); its serving decodes past the
# 64-slot ring and its training rows cross it.
RGEMMA, WHISPER = "recurrentgemma-9b", "whisper-base"
NEW_ARCHS = (RGEMMA, WHISPER)
SMOKE_OVERRIDES = {RGEMMA: dict(n_layers=5)}
SMOKE_SERVE.update({RGEMMA: (dict(max_slots=3, prefill_len=40, max_new_tokens=30,
                                  adapter_slots=4), 6),
                    WHISPER: (dict(max_slots=3, prefill_len=8, max_new_tokens=6,
                                   adapter_slots=4), 6)})
SMOKE_SEQ.update({RGEMMA: 80, WHISPER: 16})
# Serving: 16 requests of 4 tenants and base traffic. recurrentgemma at
# prefill_len 2,048, the most its window guard allows, with prompts of 2 and
# 64 to 2,048 tokens; whisper at prefill_len 128 with 1,500 frames a request.
NEW_SERVE_KW = {RGEMMA: dict(max_slots=8, prefill_len=2048, max_new_tokens=16, adapter_slots=8),
                WHISPER: DENSE_SERVE_KW}
# The f32 prefill check on the weights upcast takes these requests (a 2,048-
# position f32 prefill of recurrentgemma costs about 41 TFLOP on the CUDA
# cores): the shortest prompt and the three longest.
NEW_F32_REQUESTS = {RGEMMA: (0, 13, 14, 15)}
# recurrentgemma's ring in f32 on its first 5 layers (1 triple + the 2 extra
# recurrent layers): one sequence of 2,200 tokens, prefilled to 2,000
# positions (below the window; decode wraps the ring at 2,048) and to 2,100
# (above it; the seeded ring is rolled), and decoded teacher-forced to its
# end, each decode step held against the full forward.
RGEMMA_RING_CHECK = dict(n_layers=5, seq_len=2200, prefills=(2000, 2100))
# The kernels each main path must launch.
SERVING_KERNELS_BY_ARCH = {"llava-1.5-7b": ("lora_residual", "grouped_lora_residual",
                                            "flash_attention"),
                           MAMBA: ("lora_residual", "grouped_lora_residual", "ssd_scan"),
                           **{a: ("lora_residual", "grouped_lora_residual", "flash_attention")
                              for a in DENSE_ARCHS + MOE_ARCHS + NEW_ARCHS}}
TRAINING_KERNELS_BY_ARCH = {"llava-1.5-7b": ("lora_residual", "flash_attention",
                                             "flash_attention_bwd", "fisher_merge"),
                            MAMBA: ("lora_residual", "ssd_scan", "fisher_merge"),
                            **{a: ("lora_residual", "flash_attention", "flash_attention_bwd",
                                   "fisher_merge")
                               for a in DENSE_ARCHS + MOE_ARCHS + NEW_ARCHS}}


class BwdCounter:
    """``flash_attention.bwd_launches`` (the backward kernel's calls) as a
    launch counter, beside the wrappers' own ``launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.bwd_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.bwd_launches = n


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase_time(what: str):
    """Log the seconds the block took as ``[phase <what>]: <seconds> s`` when it ends."""
    t0 = time.perf_counter()
    yield
    log(f"[phase {what}]: {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def rel_gap(got, want):
    """-> (max |got - want| / max(1, ‖want‖∞), share of elements that differ)."""
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    diff = (g - w).abs()
    return float(diff.max()) / scale, float((diff > 0).float().mean())


def parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref):
    """-> ({kernel: max |err| at its main-path shape in bf16}, {bf16 kernel:
    its gaps to its rounding model and to the exact plain version})."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    main_err = {}
    gaps = {"lora_residual": [0.0, 0.0], "flash_attention": [0.0, 0.0]}  # vs model: err, share
    n_cases = 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for t, d, r, _ in (harness.LORA_SHAPES + harness.FULL_LORA_SHAPES
                           + harness.LORA_EDGE_SHAPES + harness.MOE_LORA_SHAPES
                           + harness.NEW_FAMILY_LORA_SHAPES + harness.HETERO_LORA_SHAPES):
            x, down, up = randn((t, d), dtype=dtype), randn((d, r), 0.05), randn((r, d), 0.05)
            got = lora_ops.lora_residual(x, down, up, scale=SCALE)
            err = harness.check_close(got, lora_ref.lora_residual(x, down, up, scale=SCALE),
                                      dtype_name, f"lora t{t}d{d}r{r}")
            n_cases += 1
            if dtype_name == "bfloat16":
                model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
                harness.check_close(got, model, dtype_name, f"lora t{t}d{d}r{r} vs model",
                                    harness.BF16_MODEL_TOLERANCES)
                harness.check_share(got, model, harness.LORA_MODEL_MAX_SHARE,
                                    f"lora t{t}d{d}r{r} vs model")
                g = rel_gap(got, model)
                gaps["lora_residual"] = [max(a, b) for a, b in zip(gaps["lora_residual"], g)]
            if (t, d, r) == harness.FULL_LORA_SHAPES[0][:3] and dtype_name == "bfloat16":
                main_err["lora_residual"] = err
        # the grid and the full-width decode shapes (ids uniform in [-1, n)),
        # then the grouped kernel's edges (id patterns, ranks, widths, x off
        # 16-byte alignment)
        grouped = ([(f"t{t}d{d}n{n}", t, d, r, n, None, 0) for t, d, r, n, _ in
                    harness.GROUPED_LORA_SHAPES + harness.FULL_GROUPED_SHAPES
                    + harness.MAMBA_GROUPED_SHAPES + harness.MOE_GROUPED_SHAPES
                    + harness.AUDIO_GROUPED_SHAPES]
                   + harness.GROUPED_LORA_EDGE_SHAPES)
        for label, t, d, r, n, ids, offset in grouped:
            x = harness.offset_view(randn((t, d), dtype=dtype), offset)
            down, up = randn((n, d, r), 0.05), randn((n, r, d), 0.05)
            if ids is None:
                idx = torch.randint(-1, n, (t,), generator=gen, device=dev, dtype=torch.int32)
            else:
                idx = harness.grouped_ids(ids, t, n, seed=t + d + n).to(dev)
            got = lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE)
            want = lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE)
            err = harness.check_close(got, want, dtype_name, f"grouped {label}")
            ident = (idx < 0) | (idx >= n)
            if not torch.equal(got[ident], x[ident]):
                raise AssertionError(f"grouped {label}: identity rows differ from x")
            if dtype_name == "float32":
                for a in range(n):
                    single = lora_ops.lora_residual(x, down[a], up[a], scale=SCALE)
                    if not torch.equal(got[idx == a], single[idx == a]):
                        raise AssertionError(f"grouped {label}: adapter {a} rows are not "
                                             "bit-identical to the single-adapter kernel")
            n_cases += 1
            if (t, d, r, n, ids) == harness.FULL_GROUPED_SHAPES[0][:4] + (None,) \
                    and dtype_name == "bfloat16":
                main_err["grouped_lora_residual"] = err
        for shape in (harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES
                      + harness.FLASH_EDGE_SHAPES + harness.DENSE_FLASH_SHAPES
                      + harness.MOE_FLASH_SHAPES + harness.HYBRID_FLASH_SHAPES
                      + harness.AUDIO_FLASH_SHAPES):
            label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
            q = randn((b, sq, h, d), dtype=dtype)
            k, v = randn((b, sk, hkv, d), dtype=dtype), randn((b, sk, hkv, d), dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap, return_lse=True)
            got, got_lse = fa_ops.flash_attention(q, k, v, **kw)
            want, want_lse = fa_ref.attention(q, k, v, **kw)
            err = harness.check_close(got, want, dtype_name, f"flash {label}")
            harness.check_close(got_lse, want_lse, dtype_name, f"flash {label} lse")
            n_cases += 1
            if dtype_name == "bfloat16":
                model, model_lse = fa_ref.attention_bf16_model(q, k, v, **kw)
                harness.check_close(got, model, dtype_name, f"flash {label} vs model",
                                    harness.BF16_MODEL_TOLERANCES)
                harness.check_close(got_lse, model_lse, "float32", f"flash {label} lse vs model")
                g = rel_gap(got, model)
                gaps["flash_attention"] = [max(a, b) for a, b in zip(gaps["flash_attention"], g)]
            if label == harness.FULL_FLASH_SHAPES[0][0] and dtype_name == "bfloat16":
                main_err["flash_attention"] = err
    try:
        q = randn((1, 4, 2, 96))
        fa_ops.flash_attention(q, q, q)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention accepted head dim 96")
    torch.cuda.synchronize()
    log(f"[parity] {n_cases} kernel-vs-plain cases passed (f32 and bf16, tile edges and "
        f"head dim 80 included; the dense, MoE, qwen2-vl, recurrentgemma and whisper "
        f"full-width attention shapes "
        f"{[sh[0] for sh in harness.DENSE_FLASH_SHAPES + harness.MOE_FLASH_SHAPES + harness.HYBRID_FLASH_SHAPES + harness.AUDIO_FLASH_SHAPES]}; "
        f"the MoE, qwen2-vl, recurrentgemma and whisper LoRA rows "
        f"{[sh[:2] for sh in harness.MOE_LORA_SHAPES + harness.NEW_FAMILY_LORA_SHAPES]} and "
        f"grouped banks "
        f"{[sh[:2] for sh in harness.MOE_GROUPED_SHAPES + harness.AUDIO_GROUPED_SHAPES]}); "
        f"main-path bf16 max |err|: {json.dumps(main_err)}")
    bound = harness.BF16_MODEL_TOLERANCES["bfloat16"]
    for name, (err, share) in gaps.items():
        log(f"[parity] {name} bf16 kernel vs its rounding model over the grid, full-width and "
            f"edge shapes: max |err| / max(1, ‖ref‖∞) {err:.3e}, elements that differ "
            f"{share:.3e} (bound rtol {bound['rtol']}, atol {bound['atol_scale']})")
    accuracy_gaps(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, randn)
    return main_err


def accuracy_gaps(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, randn):
    """Log what the bf16 kernels' arithmetic costs at the main-path shapes:
    each kernel's bf16 output and the exact plain version's bf16 output,
    both against the exact function in f32 (bf16 inputs upcast); each
    rounding model against the exact plain version (LoRA in f32, flash in
    bf16); and, for LoRA, the share of bf16 outputs that differ from the
    split-TF32 model for the kernel and for the designs it does not use."""
    bf16 = torch.bfloat16
    out = {}
    for t, d, r, _ in harness.FULL_LORA_SHAPES[:1] + harness.MAMBA_LORA_SHAPES[1:]:
        x, down, up = randn((t, d), dtype=bf16), randn((d, r), 0.05), randn((r, d), 0.05)
        exact = lora_ref.lora_residual(x.float(), down, up, scale=SCALE)
        got = lora_ops.lora_residual(x, down, up, scale=SCALE)
        plain = lora_ref.lora_residual(x, down, up, scale=SCALE)
        model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
        shares = {"kernel": got, "exact plain": plain,
                  "single-pass TF32": lora_ref.lora_residual_tf32(x, down, up, scale=SCALE),
                  "bf16 adapters": lora_ref.lora_residual(x, down.to(bf16).float(),
                                                          up.to(bf16).float(), scale=SCALE)}
        out[f"lora x ({t}, {d})"] = dict(
            kernel=rel_gap(got, exact), plain=rel_gap(plain, exact),
            kernel_vs_plain=rel_gap(got, plain),
            model=rel_gap(lora_ref.lora_residual_split_tf32(x.float(), down, up, scale=SCALE),
                          exact),
            shares={k: rel_gap(y, model)[1] for k, y in shares.items()})
    for shape in harness.FULL_FLASH_SHAPES[:1] + harness.FULL_FLASH_GRAD_SHAPES:
        label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
        q, k, v = (randn(s, dtype=bf16) for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
        exact = fa_ref.attention(q.float(), k.float(), v.float(), causal=causal)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        plain = fa_ref.attention(q, k, v, causal=causal)
        out[f"flash {label}"] = dict(
            kernel=rel_gap(got, exact), plain=rel_gap(plain, exact),
            kernel_vs_plain=rel_gap(got, plain),
            model=rel_gap(fa_ref.attention_bf16_model(q, k, v, causal=causal), plain))
    torch.cuda.synchronize()
    for key, g in out.items():
        log(f"[accuracy] {key} bf16, max |err| / max(1, ‖ref‖∞) against the f32 function of "
            f"the same inputs: kernel {g['kernel'][0]:.3e} | exact plain version rounded to "
            f"bf16 {g['plain'][0]:.3e} | kernel vs plain {g['kernel_vs_plain'][0]:.3e}, "
            f"elements that differ {g['kernel_vs_plain'][1]:.3e} | rounding model vs exact "
            f"plain version {g['model'][0]:.3e}")
        if "shares" in g:
            log(f"[accuracy] {key} bf16, share of elements that differ from the split-TF32 "
                f"model (limit {harness.LORA_MODEL_MAX_SHARE}): "
                + ", ".join(f"{k} {v:.3e}" for k, v in g["shares"].items()))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serving_smoke(torch, get_smoke_config, init_backbone, synth, make_requests, Engine,
                  arch="llava-1.5-7b"):
    """Smoke ``arch`` on the card (kernels, f32) vs on the CPU (plain versions)."""
    from repro_torch.utils import tree_map

    names = ["tenant0", "tenant1"]
    kw, n_req = SMOKE_SERVE[arch]
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = get_smoke_config(arch, **SMOKE_OVERRIDES.get(arch, {})).with_(use_pallas=True)
        backbone = init_backbone(cfg, seed=1, device="cpu")
        tenants = synth(1, cfg, names, "cpu")
        if dev == "cuda":
            backbone = tree_map(lambda t: t.to(dev), backbone)
            tenants = tree_map(lambda t: t.to(dev), tenants)
        eng = Engine(cfg, backbone, adapter_loader=tenants.__getitem__,
                     use_pallas_grouped=True, **kw)
        reqs = make_requests(cfg, names, n_req, kw["prefill_len"], kw["max_new_tokens"], 1)
        done = eng.run(reqs)
        runs[dev] = ({rid: c.tokens for rid, c in done.items()},
                     torch.stack([eng.prefill_logits(r).cpu() for r in reqs]))
    tok_gpu, lg_gpu = runs["cuda"]
    tok_cpu, lg_cpu = runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    bound = 1e-5 * float(lg_cpu.abs().max())
    if err > bound:
        raise AssertionError(f"smoke prefill logits: card vs CPU max |err| {err:.3e} > {bound:.3e}")
    if tok_gpu != tok_cpu:
        raise AssertionError(f"smoke tokens differ: card {tok_gpu} cpu {tok_cpu}")
    log(f"[smoke] smoke {arch} f32: card (kernels) == CPU (plain) tokens for {n_req} "
        f"requests; prefill logits max |err| {err:.3e} (bound {bound:.3e})")


def serve_requests(arch, cfg, names, make_requests, kw, seed):
    """The main path's 16 requests: ``make_requests``' mix of tenants and base
    traffic (whisper's with 1,500 frames each); for mamba2 and
    recurrentgemma with ragged prompts of 64 to prefill_len tokens (512 and
    2,048) and one of 2."""
    import numpy as np

    reqs = make_requests(cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], seed)
    if arch in (MAMBA, RGEMMA):
        rng = np.random.default_rng(seed + 1)
        top = kw["prefill_len"]
        lengths = [2] + [int(v) for v in np.linspace(min(64, top), top, len(reqs) - 1)]
        for r, n in zip(reqs, lengths):
            r.prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    return reqs


def serving_full(torch, get_config, init_backbone, synth, make_requests, Engine, counters,
                 arch="llava-1.5-7b"):
    """-> launches per kernel in the main-path run."""
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config(arch).with_(use_pallas=True)
    t0 = time.perf_counter()
    backbone = init_backbone(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(backbone))
    log(f"[serve] {arch} backbone: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    names = [f"tenant{i}" for i in range(4)]
    tenants = synth(0, cfg, names, "cuda")
    kw = dict(SERVE_KW[arch], adapter_loader=tenants.__getitem__)
    reqs = serve_requests(arch, cfg, names, make_requests, kw, 0)
    log(f"[serve] {arch}: prompt lengths {[len(r.prompt) for r in reqs]}, prefill_len "
        f"{kw['prefill_len']}, tenants {[r.tenant for r in reqs]}")

    launches, done, kernel16, done_plain, plain16 = serve_main_path(
        torch, cfg, backbone, Engine, counters, kw, reqs, arch)

    # for information: the model's plain path (use_pallas off: bf16 adapter
    # products, probabilities cast to bf16 before the product with V)
    jnp_path = Engine(cfg.with_(use_pallas=False), backbone, use_pallas_grouped=False, **kw)
    done_jnp = jnp_path.run(reqs)
    jnp16 = [jnp_path.prefill_logits(r) for r in reqs]
    log(f"[serve] {arch} bf16, kernels vs the use_pallas=False path: prefill logits max |err| / "
        f"‖ref‖∞ = {rel_err(kernel16, jnp16):.3e}; {agreement(reqs, done, done_jnp)}")

    # f32 on the same weights, upcast exactly: the kernels against their plain
    # versions without bf16 rounding, and the reference for the bf16 runs
    del jnp_path
    cfg32 = cfg.with_(dtype="float32")
    backbone32 = tree_map(lambda t: t.float(), backbone)
    eng32 = Engine(cfg32, backbone32, use_pallas_grouped=True, **kw)
    done32 = eng32.run(reqs)
    kernel32 = [eng32.prefill_logits(r) for r in reqs]
    done32_plain, plain32, _ = run_plain_versions(cfg32, backbone32, Engine, kw, reqs)
    worst = hold(torch, cfg32.dtype, reqs, kernel32, plain32)
    log(f"[serve] {arch} f32, kernels vs their plain versions: prefill logits max |err| / "
        f"‖ref‖∞ = {worst:.3e} (limit {LOGIT_TOL['float32']}); "
        f"{agreement(reqs, done32, done32_plain)}")
    log(f"[serve] {arch} bf16 runs vs the f32 plain run, prefill logits max |err| / ‖ref‖∞: "
        f"kernels {rel_err(kernel16, plain32):.3e}, plain versions "
        f"{rel_err(plain16, plain32):.3e}, use_pallas=False {rel_err(jnp16, plain32):.3e}; "
        f"kernels' tokens: {agreement(reqs, done, done32_plain)}")
    return launches


def serve_main_path(torch, cfg, backbone, Engine, counters, kw, reqs, what):
    """Serve ``reqs`` through the kernels, with the launch counters reset just
    before the run and read just after it; then on the plain versions, and
    hold the prefill logits at LOGIT_TOL (an MoE config's plain prefills
    take the kernel prefills' expert choices, ``replayed_routes``).
    -> (launches, completions, kernel logits, the plain run's completions,
    plain logits)."""
    # warm-up: cuBLAS handles, allocator pools, first kernel launches
    Engine(cfg, backbone, use_pallas_grouped=True, **kw).run(
        [dataclasses.replace(r, max_new_tokens=2) for r in reqs[:2]])
    torch.cuda.synchronize()

    eng = Engine(cfg, backbone, use_pallas_grouped=True, **kw)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if sorted(done) != [r.rid for r in reqs]:
        raise AssertionError(f"completed {sorted(done)} of {len(reqs)} requests")
    for r in reqs:
        toks = done[r.rid].tokens
        if len(toks) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {r.rid}: tokens {toks}")
    arch = cfg.name
    if not all(launches[n] for n in SERVING_KERNELS_BY_ARCH[arch]):
        raise AssertionError(f"a kernel of the {arch} serving path never launched: {launches}")
    if launches["flash_attention_bwd"]:
        raise AssertionError(f"the {arch} serving path ran an attention backward: {launches}")
    st = eng.stats
    n_tok = sum(len(c.tokens) for c in done.values())
    log(f"[serve] {what}: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s | prefill {1e3 * st['prefill_s'] / st['prefills']:.2f} "
        f"ms/request | decode step {1e3 * st['decode_s'] / st['decode_steps']:.2f} ms "
        f"({st['decode_steps']} steps, occupancy {eng.mean_occupancy():.2f}/{kw['max_slots']}) "
        f"| peak memory {peak / 2**30:.2f} GiB | launches {json.dumps(launches)}")

    kernel_lg, routes = prefill_routes(eng, reqs)
    done_plain, plain_lg, own = run_plain_versions(cfg, backbone, Engine, kw, reqs, routes)
    worst = hold(torch, cfg.dtype, reqs, kernel_lg, plain_lg)
    log(f"[serve] {what} bf16, kernels vs their plain versions: prefill logits max |err| / "
        f"‖ref‖∞ = {worst:.3e} (limit {LOGIT_TOL['bfloat16']}{replay_note(routes, own)}); "
        f"{agreement(reqs, done, done_plain)}")
    return launches, done, kernel_lg, done_plain, plain_lg


def run_plain_versions(cfg, backbone, Engine, kw, reqs, routes=None):
    """Serve ``reqs`` with each kernel replaced by its plain version, then
    prefill each alone (taking the expert choices of ``routes``, another
    run's prefills of ``reqs``, where given). -> (completions, prefill
    logits per request, their own routing records)."""
    with plain_versions():
        plain = Engine(cfg, backbone, use_pallas_grouped=True, **kw)
        done = plain.run(reqs)
        return (done, *prefill_routes(plain, reqs, routes))


def rel_err(got, want) -> float:
    """Largest max |got - want| / ‖want‖∞ over paired logit vectors."""
    return max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))


def hold(torch, dtype, reqs, got, want) -> float:
    """Raise unless every request's logits are finite and within LOGIT_TOL[dtype]."""
    for r, g, w in zip(reqs, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"request {r.rid}: non-finite prefill logits")
        if (e := rel_err([g], [w])) > LOGIT_TOL[dtype]:
            raise AssertionError(f"{dtype} request {r.rid}: prefill logits differ from the "
                                 f"plain run by {e:.3e} of their ∞-norm (> {LOGIT_TOL[dtype]})")
    return rel_err(got, want)


def agreement(reqs, a, b) -> str:
    first = sum(a[r.rid].tokens[0] == b[r.rid].tokens[0] for r in reqs)
    same = total = 0
    for r in reqs:
        x, y = a[r.rid].tokens[1:], b[r.rid].tokens[1:]
        same += sum(i == j for i, j in zip(x, y))
        total += len(x)
    return (f"first tokens equal {first}/{len(reqs)}, decode tokens equal {same}/{total} "
            f"({same / max(total, 1):.3f})")


@contextlib.contextmanager
def plain_versions():
    """Swap each kernel wrapper for its plain version inside its ops module
    (the model code looks the wrapper up there at every call)."""
    from repro_torch.kernels.fisher_merge import ops as fm_ops, ref as fm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops, ref as lora_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref

    # (module, wrapper attribute, plain version)
    swaps = [(lora_ops, "lora_residual", lora_ref.lora_residual),
             (lora_ops, "lora_residual_many", lora_ref.lora_residual_many),
             (lora_ops, "grouped_lora_residual", lora_ref.grouped_lora_residual),
             (fa_ops, "flash_attention", fa_ref.attention),
             (fm_ops, "fisher_merge", fm_ref.fisher_merge),
             (fm_ops, "fisher_merge_leaves", fm_ref.fisher_merge_leaves),
             (fm_ops, "fisher_fold", fm_ref.fisher_fold),
             (fm_ops, "fisher_fold_leaves", fm_ref.fisher_fold_leaves),
             (ssd_ops, "ssd", ssd_ref.ssd_chunked)]
    wrappers = [getattr(mod, attr) for mod, attr, _ in swaps]
    try:
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        yield
    finally:
        for (mod, attr, _), wrapper in zip(swaps, wrappers):
            setattr(mod, attr, wrapper)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sq_loss_grads(fn, *tensors):
    """Gradients of sum(fn(*tensors)²), in f32, by torch.autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    (fn(*leaves).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


def fisher_parity(torch, harness, fm_ops, fm_ref, gen, dtype_name, shapes, trees):
    """The Fisher kernels against their plain versions in ``dtype_name``: the
    single-leaf wrappers on (K, N) stacks, and the tree wrappers on K clients'
    leaf lists, each client folded in turn. In f32 the kernels must give the
    plain versions' bits (both sum over the clients in order); bf16 merges are
    held at the harness tolerance. -> (cases, {(k, leaf sizes): (merge, fold)
    max |err|})."""
    dev, dtype = gen.device, getattr(torch, dtype_name)

    def check(got, want, what, dt=dtype_name):
        err = harness.check_close(got, want, dt, what)
        if dt == "float32" and not torch.equal(got, want):
            raise AssertionError(f"{what}: the f32 kernel differs from the plain version "
                                 f"(max |err| {err:.3e})")
        return err

    def leaves(sizes, positive):
        return [((torch.rand((n,), generator=gen, device=dev) + 0.01) if positive
                 else torch.randn((n,), generator=gen, device=dev)).to(dtype) for n in sizes]

    n_cases, errs = 0, {}
    for k, n, _ in shapes:
        theta = torch.stack(leaves((n,) * k, False))
        fisher = torch.stack(leaves((n,) * k, True))
        w = (torch.rand((k,), generator=gen, device=dev) + 0.1).cpu()
        check(fm_ops.fisher_merge(theta, fisher, w), fm_ref.fisher_merge(theta, fisher, w),
              f"fisher_merge k{k}n{n}")
        num, den = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        pnum, pden = num.clone(), den.clone()
        for i in range(k):
            fm_ops.fisher_fold(num, den, theta[i], fisher[i], float(w[i]))
            fm_ref.fisher_fold(pnum, pden, theta[i], fisher[i], float(w[i]))
        check(num, pnum, f"fisher_fold num k{k}n{n}", "float32")
        check(den, pden, f"fisher_fold den k{k}n{n}", "float32")
        n_cases += 2
    for k, sizes in trees:
        thetas = [leaves(sizes, False) for _ in range(k)]
        fishers = [leaves(sizes, True) for _ in range(k)]
        w = (torch.rand((k,), generator=gen, device=dev) + 0.1).cpu()
        err_m = max(check(g, p, f"fisher_merge_leaves k{k} leaf {i} of {len(sizes)}")
                    for i, (g, p) in enumerate(zip(fm_ops.fisher_merge_leaves(thetas, fishers, w),
                                                   fm_ref.fisher_merge_leaves(thetas, fishers, w))))
        nums = [torch.zeros(n, device=dev) for n in sizes]
        dens = [torch.zeros(n, device=dev) for n in sizes]
        pnums, pdens = [t.clone() for t in nums], [t.clone() for t in dens]
        for i in range(min(k, 8)):
            fm_ops.fisher_fold_leaves(nums, dens, thetas[i], fishers[i], float(w[i]))
            fm_ref.fisher_fold_leaves(pnums, pdens, thetas[i], fishers[i], float(w[i]))
        err_f = max(check(a, b, f"fisher_fold_leaves k{k} of {len(sizes)} leaves", "float32")
                    for a, b in zip(nums + dens, pnums + pdens))
        errs[(k, sizes)] = (err_m, err_f)
        n_cases += 2
    return n_cases, errs


def training_parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, fm_ops, fm_ref):
    """-> {kernel: max |err| at its main-path shape in f32}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    main_err, n_cases = {}, 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        cases, errs = fisher_parity(
            torch, harness, fm_ops, fm_ref, gen, dtype_name,
            harness.FISHER_SHAPES + harness.FISHER_EXTRA_SHAPES + harness.FULL_FISHER_SHAPES,
            harness.FISHER_TREES + harness.FULL_FISHER_TREES + harness.FISHER_TREE_EDGES)
        n_cases += cases
        if dtype_name == "float32":  # the main path: llava's tree at K = 2
            main_err["fisher_merge"], main_err["fisher_fold"] = errs[harness.FULL_FISHER_TREES[1]]
        for t, d, r, _ in (harness.LORA_GRAD_SHAPES + harness.FULL_LORA_GRAD_SHAPES
                           + harness.MOE_LORA_GRAD_SHAPES + harness.NEW_FAMILY_LORA_GRAD_SHAPES):
            x, down, up = randn((t, d), dtype=dtype), randn((d, r), 0.05), randn((r, d), 0.05)
            got = sq_loss_grads(lambda a, b, c: lora_ops.lora_residual(a, b, c, scale=SCALE),
                                x, down, up)
            want = sq_loss_grads(lambda a, b, c: lora_ref.lora_residual(a, b, c, scale=SCALE),
                                 x, down, up)
            for name, g, wt in zip(("dx", "dA", "dB"), got, want):
                err = harness.check_close(g, wt, dtype_name, f"lora grad {name} t{t}d{d}r{r}")
                if (t, d, r, _) in harness.FULL_LORA_GRAD_SHAPES:
                    key = f"lora_residual {name} {dtype_name}"
                    main_err[key] = max(main_err.get(key, 0.0), err)
                elif (t, d, r, _) in (harness.MOE_LORA_GRAD_SHAPES
                                      + harness.NEW_FAMILY_LORA_GRAD_SHAPES):
                    key = f"lora_residual {name} {dtype_name} d{d}"
                    main_err[key] = max(main_err.get(key, 0.0), err)
            n_cases += 1
        for shape in (harness.FLASH_GRAD_SHAPES + harness.FULL_FLASH_GRAD_SHAPES
                      + harness.MOE_FLASH_GRAD_SHAPES + harness.NEW_FAMILY_FLASH_GRAD_SHAPES):
            label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
            q = randn((b, sq, h, d), dtype=dtype)
            k_, v = randn((b, sk, hkv, d), dtype=dtype), randn((b, sk, hkv, d), dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            got = sq_loss_grads(lambda *a: fa_ops.flash_attention(*a, **kw), q, k_, v)
            want = sq_loss_grads(lambda *a: fa_ref.attention(*a, **kw), q, k_, v)
            full = label == harness.FULL_FLASH_GRAD_SHAPES[0][0]
            wider = harness.MOE_FLASH_GRAD_SHAPES + harness.NEW_FAMILY_FLASH_GRAD_SHAPES
            wide = full or shape in wider
            tol = harness.FULL_FLASH_GRAD_TOLERANCES if wide else harness.FLASH_GRAD_TOLERANCES
            for name, g, wt in zip(("dq", "dk", "dv"), got, want):
                err = harness.check_close(g, wt, dtype_name, f"flash grad {name} {label}", tol)
                if full:
                    main_err[f"flash_attention {name} {dtype_name}"] = err
                elif shape in wider:
                    main_err[f"flash_attention {name} {dtype_name} {label}"] = err
            n_cases += 1
    bwd_gaps = {}
    for shape in harness.FLASH_BWD_SHAPES[:2]:  # the training cells' attention
        label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
        kw = dict(causal=causal, window=window, softcap=cap)
        q = randn((b, sq, h, d), dtype=torch.bfloat16)
        k_, v = (randn((b, sk, hkv, d), dtype=torch.bfloat16) for _ in range(2))
        out, lse = fa_ops.flash_attention(q, k_, v, return_lse=True, **kw)
        args = (q, k_, v, out, lse, randn(out.shape, dtype=torch.bfloat16))
        got = fa_ops._backward(*args, **kw)
        model = fa_ref.attention_bwd_bf16_model(*args, **kw)
        exact = fa_ref.attention_bwd(*args, **kw)
        for name, g, m, e in zip(("dq", "dk", "dv"), got, model, exact):
            harness.check_close(g, m, "bfloat16", f"flash bwd {name} {label} vs model",
                                harness.BF16_MODEL_TOLERANCES)
            err = harness.check_close(g, e, "bfloat16", f"flash bwd {name} {label}",
                                      harness.FLASH_GRAD_TOLERANCES)
            bwd_gaps[f"{label} {name}"] = (rel_gap(g, m), rel_gap(g, e), rel_gap(m, e))
            if shape is harness.FLASH_BWD_SHAPES[1]:  # the longdoc row: the table's shape
                main_err["flash_attention_bwd"] = max(main_err.get("flash_attention_bwd", 0.0),
                                                      err)
        del args, got, model, exact
        n_cases += 1
    torch.cuda.synchronize()
    for key, (km, ke, me) in bwd_gaps.items():
        log(f"[accuracy] flash_attention_bwd {key} bf16, max |err| / max(1, ‖ref‖∞): kernel vs "
            f"its rounding model {km[0]:.3e} (elements that differ {km[1]:.3e}; limit "
            f"{harness.BF16_MODEL_TOLERANCES['bfloat16']}) | kernel vs the exact plain "
            f"backward {ke[0]:.3e} | model vs the exact plain backward {me[0]:.3e}")
    log(f"[train-parity] {n_cases} kernel-vs-plain cases passed (fisher_merge, fisher_fold on "
        f"(K, N) stacks and whole adapter trees, f32 bit for bit; LoRA and flash gradients; f32 "
        f"and bf16); full-width max |err|: {json.dumps(main_err)}")
    return main_err


def fresh_server(server):
    """The same backbone and global adapters with an empty comm log (the
    engine appends to the one it is given)."""
    from repro_torch.core.comm import CommLog

    return dataclasses.replace(server, comm=CommLog(), round_idx=0)


def tree_rel_err(got, want) -> float:
    """Largest max |got - want| / ‖want‖∞ over the leaves of two adapter trees
    (a leaf that is zero in both, as the down-projection's gradient at the
    first step, counts 0)."""
    from repro_torch.utils import tree_leaves

    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def upcast_clients(tr, strategy, cfg):
    """``strategy`` with its clients drawn for ``cfg`` (f32) and upcast to f64,
    so an f64 run starts from the f32 run's adapters."""
    from repro_torch.utils import tree_map

    base = tr["get_strategy"](strategy)
    up = lambda tree: tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)

    def init_client(gen, _cfg, cid, n_examples):
        st = base.init_client(gen, cfg, cid, n_examples)
        return dataclasses.replace(st, adapters=up(st.adapters),
                                   local_adapters=up(st.local_adapters),
                                   opt_state=up(st.opt_state))

    strat = copy.copy(base)
    object.__setattr__(strat, "init_client", init_client)
    return strat


def eval_params_err(strat, got, want):
    """(global adapters, the clients' own evaluated adapters: LocFT's and
    FedDPA-F's personal ones) of run ``got`` against run ``want``, relative
    to ‖want‖∞."""
    from repro_torch.utils import tree_map

    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    glob = tree_rel_err(cpu(got.server.global_adapters), want.server.global_adapters)
    own = 0.0
    for gc, wc in zip(got.clients, want.clients):
        gp = strat.eval_params(got.server.global_adapters, gc)
        wp = strat.eval_params(want.server.global_adapters, wc)
        for g, w in zip(gp, wp):
            if w is not None and w is not want.server.global_adapters:
                own = max(own, tree_rel_err(cpu(g), w))
    return glob, own


def training_smoke(torch, tr, arch="llava-1.5-7b", strategy="fednano", adapter_tol=1e-5,
                   f64_witness=False, both_paths=False):
    """Two rounds of ``strategy`` on smoke ``arch`` in f32: card (kernels) vs CPU
    (plain). The adapters each client evaluates after the two rounds are held
    at ``adapter_tol``, the rest at 1e-5. With ``f64_witness`` the CPU run is
    also held against a CPU f64 run from the same weights and clients, and
    the adapters' bound becomes ``adapter_tol`` or ROUNDING_MARGIN times that
    distance (f32's own rounding), whichever is smaller, but not below 1e-5.
    With ``both_paths`` the witness is the larger distance from the f64 run
    of two f32 summation orders on the CPU: the kernels' plain versions and
    the model's ``use_pallas=False`` path (AdamW turns the rounding of one
    order into sign-sized steps that another order does not take)."""
    from repro_torch.utils import tree_map

    cfg = tr["get_smoke_config"](arch, **SMOKE_OVERRIDES.get(arch, {})).with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    data_kw = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=SMOKE_SEQ[arch],
                   seed=0)
    server_cpu = tr["init_server"](cfg, seed=3, device="cpu")
    runs, step = {}, {}
    for dev in ("cuda", "cpu"):
        server = server_cpu
        if dev == "cuda":
            server = dataclasses.replace(server_cpu, backbone=tree_map(lambda t: t.to(dev),
                                                                   server_cpu.backbone),
                                         global_adapters=tree_map(lambda t: t.to(dev),
                                                              server_cpu.global_adapters))
        train, evald, _ = tr["make_federated_data"](cfg, device=dev, **data_kw)
        batch = train[0][0]
        step[dev] = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](cfg, server.backbone, a, batch), server.global_adapters)
        runs[dev] = tr["run_federated"](0, cfg, train, evald, strategy=strategy, rounds=2,
                                        hp=hp, use_pallas=True, server=fresh_server(server))
    gpu, cpu = runs["cuda"], runs["cpu"]
    gl = [m["mean_loss"] for m in gpu.round_metrics]
    cl = [m["mean_loss"] for m in cpu.round_metrics]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    step_loss = abs(float(step["cuda"][0]) - float(step["cpu"][0])) / abs(float(step["cpu"][0]))
    step_grad = tree_rel_err(tree_map(lambda t: t.cpu(), step["cuda"][2]), step["cpu"][2])
    if loss_err > 1e-5 or step_loss > 1e-5 or step_grad > 1e-5:
        raise AssertionError(f"smoke training, card vs CPU: round losses {gl} vs {cl} "
                             f"({loss_err:.3e}), first step loss {step_loss:.3e}, "
                             f"grads {step_grad:.3e} (bound 1e-5)")
    strat = tr["get_strategy"](strategy)
    adp_err, own_err = eval_params_err(strat, gpu, cpu)
    witness = ""
    if f64_witness:
        f64 = f64_run(tr, cfg, server_cpu, data_kw, strategy, hp, rounds=2)
        w_glob, w_own = eval_params_err(strat, cpu, f64)
        witness = (f"; CPU f32 vs CPU f64 (plain, the same weights and clients): global "
                   f"{w_glob:.3e}, the clients' own {w_own:.3e}")
        if both_paths:
            cfg_p = cfg.with_(use_pallas=False)
            train, evald, _ = tr["make_federated_data"](cfg_p, device="cpu", **data_kw)
            other = tr["run_federated"](0, cfg_p, train, evald, strategy=strategy, rounds=2,
                                        hp=hp, use_pallas=False, server=fresh_server(server_cpu))
            o_glob, o_own = eval_params_err(strat, other, f64)
            w_glob, w_own = max(w_glob, o_glob), max(w_own, o_own)
            witness += (f"; the use_pallas=False order vs f64: global {o_glob:.3e}, the "
                        f"clients' own {o_own:.3e}")
        adapter_tol = min(adapter_tol, max(1e-5, ROUNDING_MARGIN * max(w_glob, w_own)))
    if max(adp_err, own_err) > adapter_tol or gpu.comm_totals != cpu.comm_totals:
        raise AssertionError(f"smoke training {strategy}: global adapters {adp_err:.3e}, the "
                             f"clients' own {own_err:.3e} (bound {adapter_tol:.3e}{witness}); "
                             f"comm {gpu.comm_totals} vs {cpu.comm_totals}")
    log(f"[train-smoke] smoke {arch} {strategy} f32, 2 rounds: card (kernels) vs CPU (plain): round "
        f"losses {gl} vs {cl}, max rel err {loss_err:.3e}; first step loss {step_loss:.3e}, "
        f"grads {step_grad:.3e} (bound 1e-5); after 2 rounds global adapters {adp_err:.3e}, "
        f"the clients' own {own_err:.3e} (bound {adapter_tol:.3e}{witness}); comm totals equal")


def f64_run(tr, cfg, server_cpu, data_kw, strategy, hp, **kw):
    """``strategy`` on the CPU in f64 from ``server_cpu``'s weights and the
    f32 clients upcast: the witness of f32's own rounding."""
    from repro_torch.utils import tree_map

    cfg64 = cfg.with_(dtype="float64", adapter=dataclasses.replace(cfg.adapter, dtype="float64"))
    up = lambda tree: tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)
    server64 = dataclasses.replace(server_cpu, cfg=cfg64, backbone=up(server_cpu.backbone),
                                   global_adapters=up(server_cpu.global_adapters))
    train, evald, _ = tr["make_federated_data"](cfg64, device="cpu", **data_kw)
    return tr["run_federated"](0, cfg64, train, evald, strategy=upcast_clients(tr, strategy, cfg),
                               hp=hp, use_pallas=True, server=fresh_server(server64), **kw)


def training_full(torch, tr, counters, arch="llava-1.5-7b", server=None):
    """A training main path at full width, on ``server`` or on one drawn from
    seed 0. -> (state for later phases, launches per kernel on its runs)."""
    from repro_torch.utils import tree_leaves

    cfg = (server.cfg if server is not None else tr["get_config"](arch)).with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    t0 = time.perf_counter()
    if server is None:
        server = tr["init_server"](cfg, seed=0, device="cuda")
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda",
                                                **TRAIN_DATA_BY_ARCH.get(arch, TRAIN_DATA))
    torch.cuda.synchronize()
    b0 = train[0][0]
    n_patches = b0.patches.shape[1] if b0.patches is not None else 0
    tokens_per_step = b0.tokens.shape[0] * (b0.tokens.shape[1] + n_patches)
    log(f"[train] {arch} backbone {cfg.dtype}, rank-{cfg.adapter.rank} "
        f"{cfg.adapter.dtype} adapters {list(cfg.adapter.modalities)}, data "
        f"{[len(train[c]) for c in sorted(train)]} train / {[len(evald[c]) for c in sorted(evald)]}"
        f" eval batches per client, batch {tuple(b0.tokens.shape)} tokens + {n_patches} "
        f"patches a row ({tokens_per_step} positions a step); drawn in "
        f"{time.perf_counter() - t0:.1f} s")

    # warm-up: cuBLAS handles, allocator pools, first launches
    tr["client"].train_step(cfg, tr["get_strategy"]("fednano"), hp, server.backbone,
                            server.global_adapters,
                            tr["adamw_init"](server.global_adapters), b0, server.global_adapters)
    torch.cuda.synchronize()

    def main_path_run(**kw):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with recorded_routes() as routes:
            res = tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp,
                                      use_pallas=True, server=fresh_server(server), **kw)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, {n: fn.launches for n, fn in counters.items()},
                torch.cuda.max_memory_allocated(), routes)

    res, wall, launches, peak, routes = main_path_run(rounds=2)
    losses = [m["mean_loss"] for m in res.round_metrics]
    leaf_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(server.global_adapters))
    want_bytes = 2 * 2 * leaf_bytes
    if (len(losses) != 2 or not all(math.isfinite(x) for x in losses)
            or [m["participants"] for m in res.round_metrics] != [2, 2]):
        raise AssertionError(f"full-width training: round metrics {res.round_metrics}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.server.global_adapters)):
        raise AssertionError("full-width training: non-finite global adapters")
    c = res.comm_totals
    if not c["param_up"] == c["fisher_up"] == c["param_down"] == want_bytes:
        raise AssertionError(f"full-width training: comm totals {c}, want {want_bytes} each")
    if not all(0.0 <= a <= 1.0 for a in res.client_accuracy.values()):
        raise AssertionError(f"client accuracy {res.client_accuracy}")
    for name in TRAINING_KERNELS_BY_ARCH[arch]:
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel never launched on the {arch} training "
                                 f"path: {launches}")
    if launches["fisher_merge"] != len(losses) or launches["fisher_fold"] != 0:
        raise AssertionError(f"the server's merge must be one fisher_merge launch a round "
                             f"for the whole adapter tree: {launches}")
    log(f"[train] {arch} fednano, 2 clients x 2 rounds x ({hp.local_steps} steps + "
        f"{hp.fisher_batches} Fisher batches), merge by fisher_merge: round losses {losses}, "
        f"client accuracy {res.client_accuracy}, comm {c}; wall {wall:.3f} s with final eval; "
        f"peak memory {peak / 2**30:.2f} GiB | launches {json.dumps(launches)}")

    path = "train" if arch == "llava-1.5-7b" else f"train_{arch.split('-')[0]}"
    state = dict(cfg=cfg, hp=hp, server=server, train=train, evald=evald, res=res,
                 routes=routes, tokens_per_step=tokens_per_step, peak=peak)
    # round 0 alone, its MoE routing kept for ``run_vs_plain(held=1)``
    res_f, wall_f, launches_f, _, state["round0_routes"] = main_path_run(
        rounds=1, agg_chunk=1, final_eval=False)
    uploads = [(cl.adapters, cl.fisher, cl.n_examples) for cl in res_f.clients]
    if launches_f["fisher_fold"] != len(uploads) or launches_f["fisher_merge"] != 0:
        raise AssertionError(f"agg_chunk=1 must fold each upload's whole tree in one "
                             f"fisher_fold launch ({len(uploads)} uploads): {launches_f}")
    batch = tr["get_strategy"]("fednano").aggregate([u[0] for u in uploads],
                                                    [u[1] for u in uploads],
                                                    [u[2] for u in uploads], use_pallas=True)
    fold_err = tree_rel_err(res_f.server.global_adapters, batch)
    loss0 = res_f.round_metrics[0]["mean_loss"]
    if fold_err > 1e-6 or abs(loss0 - losses[0]) > 1e-5 * abs(losses[0]):
        raise AssertionError(f"round 0 by fisher_fold vs fisher_merge: adapters {fold_err:.3e} "
                             f"(bound 1e-6); loss {loss0} vs {losses[0]}")
    log(f"[train] {arch} agg_chunk=1, round 0 folded one client at a time by fisher_fold: loss "
        f"{loss0} (merge run {losses[0]}); streamed merge vs fisher_merge of the same uploads "
        f"{fold_err:.3e} of ‖ref‖∞ (bound 1e-6); wall {wall_f:.3f} s | launches "
        f"{json.dumps(launches_f)}")
    return state, {path: {n: launches[n] + launches_f[n] for n in launches}}


def step_check(torch, tr, cfg, backbone, points, batch, what=None):
    """One step's loss and adapter gradients at each (label, adapters) of
    ``points``, kernel path against the plain-version path, held at
    LOSS_TOL and GRAD_TOL of ``cfg.dtype``; logged."""
    dtype = cfg.dtype

    def loss_and_grads(adapters):
        loss, _, grads = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](cfg, backbone, a, batch), adapters)
        return float(loss), grads

    out = []
    for label, adp in points:
        with recorded_routes() as routes:
            lk, gk = loss_and_grads(adp)
        with plain_versions(), replayed_routes(routes):
            lp, gp = loss_and_grads(adp)
        le, ge = abs(lk - lp) / abs(lp), tree_rel_err(gk, gp)
        del gk, gp
        if not math.isfinite(lk) or le > LOSS_TOL[dtype] or ge > GRAD_TOL[dtype]:
            raise AssertionError(f"{what or cfg.name} {dtype} {label}: loss {lk} vs {lp} "
                                 f"({le:.3e}, bound {LOSS_TOL[dtype]}), adapter grads "
                                 f"{ge:.3e} of ‖ref‖∞ (bound {GRAD_TOL[dtype]})")
        out.append((label, lk, lp, le, ge))
    torch.cuda.empty_cache()
    for label, lk, lp, le, ge in out:
        log(f"[train-check] {what or cfg.name} {dtype} {label}: loss kernels {lk:.7f} plain "
            f"{lp:.7f} (rel {le:.3e}, bound {LOSS_TOL[dtype]}); adapter grads max |err| / "
            f"‖ref‖∞ {ge:.3e} (bound {GRAD_TOL[dtype]})")


def run_vs_plain(torch, tr, st, held: int):
    """The bf16 run's round losses, kernels against a run on the plain
    versions from the same server (an MoE config's taking the kernel run's
    expert choices), held at RUN_LOSS_TOL_BF16. ``held=2``: both rounds and
    the final evaluation, the global adapters' gap reported; ``held=1``: the
    plain run takes round 0 only, without the evaluation (a cut that keeps
    the script inside its time, PERF.md §4)."""
    cfg, server = st["cfg"], st["server"]
    routes = st["routes"] if held == 2 else st["round0_routes"]
    with plain_versions(), replayed_routes(routes) as own:
        plain = tr["run_federated"](0, cfg, st["train"], st["evald"], strategy="fednano",
                                    hp=st["hp"], rounds=held, use_pallas=True,
                                    server=fresh_server(server), final_eval=held == 2)
    kl = [m["mean_loss"] for m in st["res"].round_metrics]
    pl = [m["mean_loss"] for m in plain.round_metrics]
    errs = [abs(a - b) / abs(b) for a, b in zip(kl, pl)]
    if len(pl) != held or max(errs) > RUN_LOSS_TOL_BF16:
        raise AssertionError(f"bf16 run, kernels vs plain versions: round losses {kl} vs {pl}")
    gap = ("" if held == 1 else "; final global adapters "
           f"{tree_rel_err(st['res'].server.global_adapters, plain.server.global_adapters):.3e}"
           " of ‖ref‖∞ (reported)")
    log(f"[train-check] {cfg.name} bf16 run, kernels vs plain versions: round losses "
        f"{kl} vs {pl} (rel {[f'{e:.3e}' for e in errs]}; held at "
        f"{RUN_LOSS_TOL_BF16}{replay_note(routes, own)}){gap}")


def training_check(torch, tr, st):
    """Full-width loss and adapter gradients, kernel path vs plain-version path."""
    from repro_torch.utils import tree_map

    cfg, server, batch = st["cfg"], st["server"], st["train"][0][0]
    points = (("first step", server.global_adapters),
              ("trained", st["res"].server.global_adapters))
    for dtype in ("bfloat16", "float32"):
        backbone = server.backbone if dtype == "bfloat16" else tree_map(lambda t: t.float(),
                                                                    server.backbone)
        step_check(torch, tr, cfg.with_(dtype=dtype), backbone, points, batch)
        del backbone
    run_vs_plain(torch, tr, st, held=2)


STRATEGY_ARCH = "minigpt4-7b"
# Smoke minigpt4-7b in f32, card (kernels) against CPU (plain versions): the
# adapters after two rounds, relative to ‖ref‖∞. AdamW turns the kernels'
# rounding-level gradient differences (1.0e-6 at the first step) into larger
# ones of its update: FedDPA-F's global adapters 1.43e-5 and personal ones
# 1.66e-5, LocFT's 1.21e-5, FedProx's 1.02e-5, the others 3.2e-6 to 8.0e-6
# (H100 at 700 W), where 1e-5 was hoped for. The CPU's own f32 run is as far
# from an f64 run of the same weights and clients (``f64_witness``). So each
# strategy's adapters are held at ROUNDING_MARGIN times that f32-to-f64
# distance (two f32 runs, each that far from f64), not below 1e-5 and never
# above SMOKE_ADAPTER_TOL, the CPU parity tests' ADAPTER_TOL. Round losses and
# the first step's loss and gradients stay at 1e-5, llava's FedNano run too.
SMOKE_ADAPTER_TOL = 1e-4
ROUNDING_MARGIN = 2.0
# Full-width minigpt4-7b in bf16, kernels against plain versions: round 0
# starts both runs from the same adapters and is held at RUN_LOSS_TOL_BF16
# (1.4e-4 measured, 7.0e-3 under FedDPA-F). Round 1 is reported only: by then
# bf16 noise has flipped AdamW's sign-sized steps in small-gradient elements
# (the clients' adapters end 0.7 to 1.4 of ‖ref‖∞ apart), so no bound there
# tells a wrong kernel from bf16 rounding. The kernels' arithmetic after
# round 0 is held by the same runs in f32 on the same weights upcast: round 0
# at LOSS_TOL, round 1 at STRATEGY_RUN_TOL_F32, and one local step's loss and
# gradient at the run's end at LOSS_TOL and GRAD_TOL.
#
# The f32 runs after round 0, where AdamW has amplified the f32 rounding:
# 1.3e-5 under FedAvg, 3.6e-4 under FedDPA-F, whose personal adapters are
# trained in round 0 from zero (H100 at 700 W); about 3x the largest.
STRATEGY_RUN_TOL_F32 = 1e-3
# The f32 half runs on the first 8 of minigpt4-7b's 32 layers upcast: each
# layer left out runs the same kernels at the same shapes as one kept, and the
# cut keeps the script inside its time (f32 GEMMs without TF32 bound its steps).
STRATEGY_F32_LAYERS = 8
# 2 clients x 2 rounds of 2 local steps (and 2 Fisher batches), batch 4 x (32
# query embeddings of width 768 + 32 tokens); the sampler run has 4 clients.
STRATEGY_DATA = dict(n_clients=2, examples_per_client=32, batch_size=4, seq_len=32, seed=0)
FISHER_STRATEGIES = ("fednano", "fednano_ef")


def reference_wire(kind, sizes, itemsize=4):
    """Bytes one upload puts on the wire, by the JAX package's formulas
    (``transforms.py``, ``compression.py``): top-k keeps max(1, round(0.1·n))
    values and int32 indices a leaf; int8 one byte an element and an f32
    scale a leaf; DP and the dense tree every element."""
    if kind == "topk":
        return sum(max(1, int(round(0.1 * n))) * (itemsize + 4) for n in sizes)
    if kind == "int8":
        return sum(sizes) + 4 * len(sizes)
    return sum(sizes) * itemsize


def strategies_full(torch, tr, counters):
    """The paper's eight strategies and the upload plugins at the full width
    of minigpt4-7b, each through ``run_federated`` with the kernels, the
    strategies also on the plain versions from a fresh copy of the server.
    -> launches per kernel over the kernel runs."""
    from repro_torch.core.fisher import FisherAccumulator
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.utils import tree_bytes, tree_leaves, tree_map

    S = tr["strategies"]
    cfg = tr["get_config"](STRATEGY_ARCH).with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    log(f"[strategies] device memory before drawing {STRATEGY_ARCH}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    data = {2: tr["make_federated_data"](cfg, device="cuda", **STRATEGY_DATA)[:2],
            4: tr["make_federated_data"](cfg, device="cuda",
                                         **dict(STRATEGY_DATA, n_clients=4))[:2]}
    torch.cuda.synchronize()
    train, evald = data[2]
    b0 = train[0][0]
    sizes = [t.numel() for t in tree_leaves(server.global_adapters)]
    leaf = tree_bytes(server.global_adapters)
    log(f"[strategies] {STRATEGY_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, frontend {cfg.frontend_dim}, {cfg.dtype}) and "
        f"its data drawn in {time.perf_counter() - t0:.1f} s; batch "
        f"{tuple(b0.tokens.shape)} tokens + {tuple(b0.patches.shape)} query embeddings; "
        f"adapter tree {len(sizes)} x {sizes[0]} f32 ({leaf} bytes)")
    # warm-up: cuBLAS handles, allocator pools, first launches (the dx path too)
    tr["run_federated"](0, cfg, train, evald, strategy="feddpa_f", hp=hp, rounds=1,
                        use_pallas=True, server=fresh_server(server), final_eval=False)
    torch.cuda.synchronize()

    total = {n: 0 for n in counters}

    def run(strategy, clients=2, plain=False, srv=server, main_path=True, **kw):
        """One run on ``srv``'s weights; the bf16 kernel runs (``main_path``)
        add their launches to the phase's total."""
        for fn in counters.values():
            fn.launches = 0
        lora_ops.lora_residual.dx_launches = 0
        tr_, ev_ = data[clients]
        ctx = plain_versions() if plain else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            res = tr["run_federated"](0, srv.cfg, tr_, ev_, strategy=strategy, hp=hp,
                                      use_pallas=True, server=fresh_server(srv),
                                      final_eval=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        launches["lora_dx"] = lora_ops.lora_residual.dx_launches
        if main_path and not plain:
            for n in counters:
                total[n] += launches[n]
        return res, wall, launches

    def check_run(what, res, n_rounds, participants):
        losses = [m["mean_loss"] for m in res.round_metrics]
        if (len(losses) != n_rounds or not all(math.isfinite(x) for x in losses)
                or [m["participants"] for m in res.round_metrics] != [participants] * n_rounds):
            raise AssertionError(f"[strategies] {what}: round metrics {res.round_metrics}")
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.server.global_adapters)):
            raise AssertionError(f"[strategies] {what}: non-finite global adapters")
        return losses

    for name in tr["available_strategies"]():
        strat = tr["get_strategy"](name)
        res, wall, launches = run(name, rounds=2)
        losses = check_run(name, res, 2, 2)
        plain, _, _ = run(name, plain=True, rounds=2)
        pl = [m["mean_loss"] for m in plain.round_metrics]
        le = [abs(a - b) / abs(b) for a, b in zip(losses, pl)]
        ce = max(tree_rel_err(a.adapters, b.adapters) for a, b in zip(res.clients, plain.clients))
        if le[0] > RUN_LOSS_TOL_BF16:
            raise AssertionError(f"[strategies] {name} bf16, kernels vs plain versions: round 0 "
                                 f"loss {losses[0]} vs {pl[0]} (bound {RUN_LOSS_TOL_BF16})")

        # the final evaluation, on the params the strategy designates, counted
        # with the run; FedDPA-F's personal adapters add one LoRA launch a batch
        def evaluate(with_personal=True):
            for fn in counters.values():
                fn.launches = 0
            acc = {}
            for cid, cl in zip(sorted(evald), res.clients):
                adp, local = strat.eval_params(res.server.global_adapters, cl)
                acc[cid] = tr["client"].eval_client(cfg, server.backbone, adp,
                                                    local if with_personal else None, evald[cid])
            return acc, {n: fn.launches for n, fn in counters.items()}

        acc, eval_launches = evaluate()
        for n in counters:
            total[n] += eval_launches[n]
        if not all(0.0 <= a <= 1.0 for a in acc.values()):
            raise AssertionError(f"[strategies] {name}: client accuracy {acc}")
        personal = 0
        if strat.dual_adapters:
            personal = (eval_launches["lora_residual"]
                        - evaluate(with_personal=False)[1]["lora_residual"])
            if personal != sum(len(evald[cid]) for cid in evald):
                raise AssertionError(f"[strategies] {name}: the personal adapters' evaluation "
                                     f"launched LoRA {personal} times, want one a batch")
        ups = 0 if name == "locft" else 4
        want = {"param_up": ups * leaf, "param_up_wire": ups * leaf,
                "param_down": (2 if name == "locft" else 4) * leaf,
                "fisher_up": 4 * leaf if name in FISHER_STRATEGIES else 0, "act_up": 0,
                "act_down": 0}
        if res.comm_totals != want:
            raise AssertionError(f"[strategies] {name}: comm {res.comm_totals}, want {want}")
        merges = 2 if name in FISHER_STRATEGIES else 0
        if (launches["lora_residual"] <= 0 or launches["flash_attention"] <= 0
                or launches["fisher_merge"] != merges or launches["fisher_fold"] != 0
                or (launches["lora_dx"] > 0) != (name == "feddpa_f")):
            raise AssertionError(f"[strategies] {name}: launches {launches} (want LoRA and flash "
                                 f"> 0, fisher_merge {merges}, no fold, LoRA dx only under "
                                 f"feddpa_f)")
        # one local step as the run takes it, and one server merge of the run's uploads
        cl = res.clients[0]
        adp, opt = res.server.global_adapters, tr["adamw_init"](res.server.global_adapters)
        fisher_acc = FisherAccumulator.init(adp) if strat.wants_fisher == "streaming" else None
        step_ms = time_host(torch, lambda: float(tr["client"].train_step(
            cfg, strat, hp, server.backbone, adp, opt, b0, adp, local_adapters=cl.local_adapters,
            fisher_acc=fisher_acc)[2]))
        ups_ = [(c.adapters, c.fisher, c.n_examples) for c in res.clients]
        merge_ms = opt_ms = None
        if strat.aggregates:
            merge_ms = time_host(torch, lambda: strat.aggregate(
                *([u[i] for u in ups_] for i in range(3)), use_pallas=True), reps=100)
        if strat.server_opt() is not None:
            so = strat.server_opt()
            state0 = so.init(adp)
            opt_ms = time_host(torch, lambda: so.apply(state0, adp, ups_[0][0]), reps=100)
        log(f"[strategies] {STRATEGY_ARCH} {name}: round losses {losses} (plain versions {pl}, "
            f"rel {le[0]:.3e} (bound {RUN_LOSS_TOL_BF16}), round 1 {le[1]:.3e} (reported); the "
            f"clients' adapters {ce:.3e} of ‖ref‖∞ apart); client accuracy {acc}, evaluation "
            f"launches {json.dumps(eval_launches)}"
            f"{f', the personal adapters {personal}' if strat.dual_adapters else ''}; comm "
            f"{json.dumps(res.comm_totals)}; local step {step_ms:.2f} ms; server merge "
            f"{'none' if merge_ms is None else f'{merge_ms:.3f} ms'}"
            f"{'' if opt_ms is None else f', server-opt step {opt_ms:.3f} ms'}; 2-round wall "
            f"{wall:.3f} s (no eval) | launches {json.dumps(launches)}")

    # the same runs in f32 on the same weights upcast, first STRATEGY_F32_LAYERS
    # layers: the kernels' arithmetic
    cfg32, cut = cut_depth(cfg.with_(dtype="float32"), server.backbone, STRATEGY_F32_LAYERS)
    server32 = dataclasses.replace(server, cfg=cfg32,
                                   backbone=tree_map(lambda t: t.float(), cut))
    del cut
    for name in tr["available_strategies"]():
        strat = tr["get_strategy"](name)
        got, _, _ = run(name, srv=server32, main_path=False, rounds=2)
        want, _, _ = run(name, plain=True, srv=server32, main_path=False, rounds=2)
        kl, pl = ([m["mean_loss"] for m in r.round_metrics] for r in (got, want))
        le = [abs(a - b) / abs(b) for a, b in zip(kl, pl)]
        ae = tree_rel_err(got.server.global_adapters, want.server.global_adapters)

        # one local step's wrapped loss and shared-adapter gradient at the run's
        # end: the personal adapters' LoRA forward and dx under FedDPA-F, and
        # FedProx's term against the initial adapters
        def step(adp=got.server.global_adapters, local=got.clients[0].local_adapters):
            loss, _, grads = tr["client"].value_and_grad(strat.wrap_local_loss(
                lambda a: tr["client"].combined_loss(cfg32, server32.backbone, a, local, b0),
                hp, server32.global_adapters), adp)
            return float(loss), grads

        lk, gk = step()
        with plain_versions():
            lp, gp = step()
        sl, sg = abs(lk - lp) / abs(lp), tree_rel_err(gk, gp)
        if (le[0] > LOSS_TOL["float32"] or le[1] > STRATEGY_RUN_TOL_F32
                or sl > LOSS_TOL["float32"] or sg > GRAD_TOL["float32"]
                or got.comm_totals != want.comm_totals):
            raise AssertionError(f"[strategies] {name} f32, kernels vs plain versions: round "
                                 f"losses {kl} vs {pl} ({le[0]:.3e}, {le[1]:.3e}; bounds "
                                 f"{LOSS_TOL['float32']}, {STRATEGY_RUN_TOL_F32}); one step's "
                                 f"loss {sl:.3e}, gradient {sg:.3e} (bound 1e-4)")
        log(f"[strategies] {STRATEGY_ARCH} {name} f32 (the same weights upcast, "
            f"{STRATEGY_F32_LAYERS} of {cfg.n_layers} layers), kernels vs "
            f"plain versions: round losses {kl} vs {pl}, rel {le[0]:.3e}, {le[1]:.3e} (bounds "
            f"{LOSS_TOL['float32']}, {STRATEGY_RUN_TOL_F32}); one step at the run's end: loss "
            f"{sl:.3e}, shared-adapter gradient {sg:.3e} of ‖ref‖∞ (bounds "
            f"{LOSS_TOL['float32']}, {GRAD_TOL['float32']}); global adapters {ae:.3e} of "
            f"‖ref‖∞ (reported)")
    del server32
    torch.cuda.empty_cache()

    # FedNano-EF's streamed merge: one agg_chunk=1 round through fisher_fold
    res, wall, launches = run("fednano_ef", rounds=1, agg_chunk=1)
    check_run("fednano_ef agg_chunk=1", res, 1, 2)
    ups_ = [(c.adapters, c.fisher, c.n_examples) for c in res.clients]
    if launches["fisher_fold"] != len(ups_) or launches["fisher_merge"] != 0:
        raise AssertionError(f"[strategies] fednano_ef agg_chunk=1: launches {launches} (want "
                             f"one fisher_fold an upload, no merge)")
    batch = tr["get_strategy"]("fednano_ef").aggregate(*([u[i] for u in ups_] for i in range(3)),
                                                       use_pallas=True)
    fold_err = tree_rel_err(res.server.global_adapters, batch)
    if fold_err > 1e-6:
        raise AssertionError(f"[strategies] fednano_ef streamed merge vs fisher_merge "
                             f"{fold_err:.3e} (bound 1e-6)")
    log(f"[strategies] {STRATEGY_ARCH} fednano_ef agg_chunk=1, one round folded by fisher_fold: "
        f"loss {res.round_metrics[0]['mean_loss']}; streamed merge vs fisher_merge of the same "
        f"uploads {fold_err:.3e} of ‖ref‖∞ (bound 1e-6); wall {wall:.3f} s | launches "
        f"{json.dumps(launches)}")

    # FedAvg with each upload transform, and with a sampled cohort of 4 clients
    for kind, kw, clients in (
            ("topk", dict(transforms=(S.TopKSparsify(frac=0.1),)), 2),
            ("int8", dict(transforms=(S.Int8EFQuant(),)), 2),
            ("dp", dict(transforms=(S.ClipNoiseDP(clip_norm=1.0, noise_mult=0.0),)), 2),
            ("sampler", dict(sampler=S.UniformSampler(frac=0.5, seed=0)), 4)):
        res, wall, launches = run("fedavg", clients=clients, rounds=2, **kw)
        losses = check_run(f"fedavg + {kind}", res, 2, 2)
        want_wire = 4 * reference_wire(kind, sizes)
        c = res.comm_totals
        if c["param_up_wire"] != want_wire or c["param_up"] != 4 * leaf:
            raise AssertionError(f"[strategies] fedavg + {kind}: comm {c}, want param_up_wire "
                                 f"{want_wire} and param_up {4 * leaf}")
        if launches["lora_residual"] <= 0 or launches["flash_attention"] <= 0:
            raise AssertionError(f"[strategies] fedavg + {kind}: launches {launches}")
        log(f"[strategies] {STRATEGY_ARCH} fedavg + {kind} ({clients} clients): round losses "
            f"{losses}, cohorts {[m['participants'] for m in res.round_metrics]}; comm "
            f"{json.dumps(c)}: param_up_wire {c['param_up_wire']} = the reference's formula "
            f"over 4 uploads ({c['param_up_wire'] / c['param_up']:.4f} of dense); wall "
            f"{wall:.3f} s | launches {json.dumps(launches)}")
    return total


def time_host(torch, fn, reps: int = 5) -> float:
    """Host ms per call of ``fn`` ending in a device synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def time_events(torch, fn, iters: int = 20) -> float:
    """Device ms per call from CUDA events around ``iters`` calls issued from
    Python (for work a CUDA graph cannot capture, such as autograd's backward)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def training_timings(torch, F, tr, st, fm_ops, fm_ref, lora_ops, lora_ref, fa_ops, fa_ref):
    """The new kernels at the slice's shapes and the training loop end to end."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = st["cfg"]
    out = fisher_timings(torch, fm_ops, fm_ref, gen)

    # gradients at the training shapes, forward + backward, bf16 activations
    bf16 = torch.bfloat16
    T, D, r = st["tokens_per_step"], cfg.d_model, cfg.adapter.rank
    x = torch.randn((T, D), generator=gen, device=dev).to(bf16)
    A = (torch.randn((D, r), generator=gen, device=dev) * 0.05).requires_grad_(True)
    Bm = (torch.randn((r, D), generator=gen, device=dev) * 0.05).requires_grad_(True)

    def lora_step(fn):
        return lambda: torch.autograd.grad(fn(x, A, Bm, scale=SCALE).float().square().sum(),
                                           (A, Bm))

    # inputs x, A, B and the output gradient; outputs y, dA, dB
    b_ms, b_by = bound(3 * nbytes(x) + 2 * nbytes(A, Bm), 12 * T * D * r, "f32")
    k_ms, p_ms = time_events(torch, lora_step(lora_ops.lora_residual)), \
        time_events(torch, lora_step(lora_ref.lora_residual))
    log(f"[time] lora_residual forward + dA, dB (x frozen) at x ({T}, {D}) bf16, r {r}: "
        f"device ms per step (issued): Function {k_ms:.5f} | plain autograd {p_ms:.5f} | "
        f"bound {b_ms:.5f} ({b_by})")
    Bsz, S, H, hd = 4, T // 4, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = ((torch.randn((Bsz, S, H, hd), generator=gen, device=dev)).to(bf16)
               .requires_grad_(True) for _ in range(3))
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))

    def attn_step(fn, *args):
        return lambda: torch.autograd.grad(fn(*args).float().square().sum(), args)

    pairs = S * (S + 1) // 2 * H * Bsz
    # inputs q, k, v and the output gradient; outputs o, dq, dk, dv. Forward
    # 4·hd a pair, backward 10·hd (s again, dp, dv, dq, dk)
    b_ms, b_by = bound(2 * nbytes(q, k, v) + 2 * nbytes(q), 14 * hd * pairs, "bf16")
    k_ms = time_events(torch, attn_step(lambda *a: fa_ops.flash_attention(*a, causal=True),
                                        q, k, v))
    p_ms = time_events(torch, attn_step(lambda *a: fa_ref.attention(*a, causal=True), q, k, v))
    l_ms = time_events(torch, attn_step(
        lambda *a: F.scaled_dot_product_attention(*a, is_causal=True), qt, kt, vt))
    log(f"[time] flash_attention forward + backward at q/k/v ({Bsz}, {S}, {H}, {hd}) bf16 "
        f"causal: device ms per step (issued): Function {k_ms:.5f} | plain autograd "
        f"{p_ms:.5f} | SDPA forward + backward {l_ms:.5f} | bound {b_ms:.5f} ({b_by})")

    loop_timings(torch, tr, st)
    return out


# The Fisher kernels' timed shapes, (K, leaf sizes): llava-1.5-7b's adapter
# tree (4 leaves of 4096 x 64) at K = 2 (the training path) and K = 5
# (launch/train.py's default), mamba2-130m's (2 leaves of 768 x 64) at K = 2,
# and llava's single leaf at K = 2 (the first port's per-leaf launch).
FISHER_TIMED = {"llava tree K=2": (2, (4096 * 64,) * 4), "llava tree K=5": (5, (4096 * 64,) * 4),
                "mamba2 tree K=2": (2, (768 * 64,) * 2), "single leaf K=2": (2, (4096 * 64,))}


def fisher_timings(torch, fm_ops, fm_ref, gen):
    """Rows 4 and 5 at FISHER_TIMED's f32 shapes, warm and cold (the server
    merges uploads written long before, with the step's activations through
    L2 in between), beside their plain versions and bounds: the merge reads
    the K clients' θ and F leaves and writes one tree, 4K + 2 operations a
    column; the fold of one upload reads num, den, θ and F and writes num and
    den, 4 operations a column. -> {kernel: kernel-table row, the main path's
    llava tree at K = 2 first}."""
    dev = gen.device
    rows = {"fisher_merge": {}, "fisher_fold": {}}
    for label, (K, sizes) in FISHER_TIMED.items():
        L, N = len(sizes), sum(sizes)
        thetas = [[torch.randn((n,), generator=gen, device=dev) for n in sizes] for _ in range(K)]
        fishers = [[torch.rand((n,), generator=gen, device=dev) + 0.01 for n in sizes]
                   for _ in range(K)]
        w = [1.0 / K] * K
        flat = tuple(t for c in thetas for t in c) + tuple(f for c in fishers for f in c)
        nums = tuple(torch.zeros((n,), device=dev) for n in sizes)
        dens = tuple(torch.zeros((n,), device=dev) for n in sizes)

        def clients(a):  # K * L leaves -> K lists of L
            return [list(a[c * L:(c + 1) * L]) for c in range(K)]

        def merge(*a, f=fm_ops.fisher_merge_leaves):
            return f(clients(a[:K * L]), clients(a[K * L:]), w)

        def fold(*a, f=fm_ops.fisher_fold_leaves):
            return f(a[:L], a[L:2 * L], a[2 * L:3 * L], a[3 * L:], 0.5)

        merged = merge(*flat)
        fold_args = nums + dens + tuple(thetas[0]) + tuple(fishers[0])
        for name, kernel, plain, args, n_bytes, n_ops in (
                ("fisher_merge", merge, lambda *a: merge(*a, f=fm_ref.fisher_merge_leaves), flat,
                 nbytes(*flat, *merged), (4 * K + 2) * N),
                ("fisher_fold", fold, lambda *a: fold(*a, f=fm_ref.fisher_fold_leaves),
                 fold_args, nbytes(*fold_args, *nums, *dens), 4 * N)):
            if name == "fisher_fold" and label == "llava tree K=5":
                continue  # one upload's fold does not depend on K
            (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: kernel(*args)),
                                          time_ms(torch, lambda: plain(*args)))
            c_ms = time_ms_cold(torch, kernel, args, n_bytes)
            b_ms, b_by = bound(n_bytes, n_ops, "f32")
            rows[name][label] = dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=None,
                                     bound_ms=b_ms, bound_by=b_by, issued_ms=k_is,
                                     shape=[K, list(sizes)])
            what = f"K={K}" if name == "fisher_merge" else "one upload"
            log(f"[time] {name} {label} ({what}, {L} x {sizes[0]} f32 leaves, "
                f"{n_bytes / 1e6:.3f} MB), device ms per call (issued from Python): kernel "
                f"{k_ms:.5f} ({k_is:.5f}), cold {c_ms:.5f} | plain {p_ms:.5f} ({p_is:.5f}) | "
                f"library None | bound {b_ms:.5f} ({b_by}) | bound / time: warm "
                f"{b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}")
        if label == "llava tree K=2":
            kernel_breakdown(torch, lambda: merge(*flat), f"fisher_merge {label}")
            kernel_breakdown(torch, lambda: fold(*fold_args), f"fisher_fold {label}")
    return {name: dict(by_shape["llava tree K=2"], shapes=by_shape)
            for name, by_shape in rows.items()}


# steps and Fisher batches ``loop_timings`` times after its warm-up call (a cut
# that keeps the script inside its time, PERF.md §4)
LOOP_REPS = 2


def loop_timings(torch, tr, st):
    """The training loop end to end at full width: local step, Fisher batch,
    server merge (the run's uploads, and at K = 5), round."""
    from repro_torch.utils import tree_leaves, tree_map

    cfg, hp, server, train = st["cfg"], st["hp"], st["server"], st["train"]
    strat = tr["get_strategy"]("fednano")
    adp = st["res"].server.global_adapters
    opt = tr["adamw_init"](adp)
    step_ms = time_host(torch, lambda: float(tr["client"].train_step(
        cfg, strat, hp, server.backbone, adp, opt, train[0][0], adp)[2]), reps=LOOP_REPS)
    fisher_ms = time_host(torch, lambda: tr["fisher_pass"](
        lambda a, b: tr["client"].fisher_grad(cfg, server.backbone, a, b), adp, train[0][:1]),
        reps=LOOP_REPS)
    ups = [(cl.adapters, cl.fisher, cl.n_examples) for cl in st["res"].clients]
    thetas, fishers, sizes = ([u[i] for u in ups] for i in range(3))
    merge_ms = time_host(torch, lambda: strat.aggregate(thetas, fishers, sizes, use_pallas=True),
                         reps=100)
    # K = 5, launch/train.py's default: the run's uploads and three made from them
    k5 = (thetas + [tree_map(lambda t, i=i: t + 0.01 * (i + 1), thetas[i % 2]) for i in range(3)],
          fishers + [fishers[i % 2] for i in range(3)], sizes + [sizes[0]] * 3)
    merge5_ms = time_host(torch, lambda: strat.aggregate(*k5, use_pallas=True), reps=100)
    merge_ops = {len(thetas): merge_call_ops(torch, strat, (thetas, fishers, sizes)),
                 5: merge_call_ops(torch, strat, k5)}
    t0 = time.perf_counter()
    tr["run_federated"](0, cfg, train, st["evald"], strategy="fednano", hp=hp, rounds=1,
                        use_pallas=True, server=fresh_server(server), final_eval=False)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    log(f"[train-time] {cfg.name} local step (forward, backward, AdamW, float(loss)) "
        f"{step_ms:.2f} ms: {st['tokens_per_step'] / step_ms * 1e3:.1f} trained tokens/s | "
        f"Fisher-pass batch {fisher_ms:.2f} ms | server merge ({len(tree_leaves(adp))} leaves, "
        f"fisher_merge) {merge_ms:.3f} ms, at K=5 {merge5_ms:.3f} ms | round wall (2 clients, "
        f"no eval) {round_s:.3f} s | peak memory of the main run {st['peak'] / 2**30:.2f} GiB")
    log(f"[train-time] {cfg.name} one server merge (strat.aggregate, use_pallas): fisher_merge "
        f"launches and aten ops by K: {json.dumps(merge_ops)}")


def merge_call_ops(torch, strat, uploads):
    """-> (fisher_merge launches, {aten op: calls}) of one ``strat.aggregate``
    on the card; raises unless it is one launch and builds no stack."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.fisher_merge import ops as fm_ops

    before = fm_ops.fisher_merge.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        strat.aggregate(*uploads, use_pallas=True)
    launches = fm_ops.fisher_merge.launches - before
    ops = Counter(e.name for e in prof.events() if e.name.startswith("aten::"))
    if launches != 1 or ops["aten::stack"] or ops["aten::cat"]:
        raise AssertionError(f"one server merge of K={len(uploads[0])}: {launches} fisher_merge "
                             f"launches, aten ops {dict(ops)} (want one launch, no stack)")
    return launches, dict(ops)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 50):
    """-> (device ms per call, issued ms per call), both from CUDA events.

    Device: the calls captured once in a CUDA graph and replayed, so host
    launch overhead drops out. Issued: the calls launched from Python one
    after another, as the engine launches them; it includes that overhead
    whenever the host is slower than the device.
    """
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    issued = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, issued


# Cold timing: between two uses of one copy of the inputs, the calls touch
# more than twice the H100's 50 MB L2, so each call reads its inputs from HBM
# as the engine does (a decode step streams about 14 GB of llava weights
# between two calls of the grouped kernel).
COLD_BYTES = 100e6


def time_ms_cold(torch, fn, args, touched: float, iters: int = 50) -> float:
    """-> device ms per call of ``fn(*copy)`` with the copies of ``args``
    cold in L2: the calls, captured in one CUDA graph, rotate over enough
    copies that ``touched`` bytes a call add up to more than COLD_BYTES
    between two uses of a copy (``iters`` rounded up to whole rotations)."""
    n = math.ceil(COLD_BYTES / touched) + 1
    copies = [tuple(args)] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
    iters = n * math.ceil(iters / n)
    for c in copies[:3]:
        fn(*c)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*copies[i % n])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_breakdown(torch, fn, what, calls: int = 20):
    """Log the mean device time of each CUDA kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    parts = [f"{name.replace('(anonymous namespace)::', '').split('(')[0][-40:]} "
             f"{t / n:.3f} us ({n} launches)" for name, (t, n) in by_name.items()]
    log(f"[time] {what} device kernels per call (torch.profiler, {calls} calls): "
        + ("; ".join(parts) or "none recorded"))


def lora_timing(torch, lora_ops, lora_ref, x, A, B, what=""):
    """The LoRA kernel at x (T, D) bf16 beside its plain version, two
    torch.addmm yardsticks (adapters cast to bf16, as a bf16 model would
    run them; and the f32 form on x upcast, the kernel's own precision), its
    bound and its bytes-only floor. The bound counts the split-TF32 work the
    f32-accurate products need on the tensor cores: x·A in two TF32
    products and h·B in three, 10·T·D·r operations at the TF32 rate.
    -> a kernel-table row."""
    T, D = x.shape
    r = A.shape[1]
    y = lora_ops.lora_residual(x, A, B, scale=SCALE)
    A16, B16, xf = A.to(torch.bfloat16), B.to(torch.bfloat16), x.float()
    (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: lora_ops.lora_residual(x, A, B, scale=SCALE)),
                                  time_ms(torch, lambda: lora_ref.lora_residual(x, A, B, scale=SCALE)))
    l_ms, l_is = time_ms(torch, lambda: torch.addmm(x, x @ A16, B16, alpha=SCALE))
    l32_ms, _ = time_ms(torch, lambda: torch.addmm(xf, xf @ A, B, alpha=SCALE))
    n_bytes = nbytes(x, A, B, y)
    c_ms = time_ms_cold(torch, lambda *a: lora_ops.lora_residual(*a, scale=SCALE), (x, A, B),
                        n_bytes)
    b_ms, b_by = bound(n_bytes, 10 * T * D * r, "tf32")
    floor_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    log(f"[time] lora_residual at x ({T}, {D}) bf16, r {r}{what}, device ms per call (issued "
        f"from Python): kernel {k_ms:.5f} ({k_is:.5f}), cold {c_ms:.5f} | plain {p_ms:.5f} "
        f"({p_is:.5f}) | library torch.addmm with bf16 adapters {l_ms:.5f} ({l_is:.5f}), f32 "
        f"torch.addmm(xf, xf @ A, B) {l32_ms:.5f} | bound {b_ms:.5f} ({b_by}; 10·T·D·r "
        f"operations at the TF32 rate) | bytes-only floor {floor_ms:.5f} | bound / time: warm "
        f"{b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}")
    return dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, library_f32_ms=l32_ms, bytes_floor_ms=floor_ms, shape=[T, D, r])


def grouped_timing(torch, lora_ops, lora_ref, gen, D, ids, what="", r=64, N=8):
    """The grouped kernel at x (len(ids), D) bf16 into an (N, D, r) f32 bank,
    warm and cold, beside its plain version and its bound: x read and y
    written once, the adapters in use read once, 4·r + 2 f32 operations a
    live row and column. -> a kernel-table row."""
    dev = gen.device
    x = torch.randn((len(ids), D), generator=gen, device=dev).to(torch.bfloat16)
    downs = torch.randn((N, D, r), generator=gen, device=dev) * 0.05
    ups = torch.randn((N, r, D), generator=gen, device=dev) * 0.05
    idx = torch.tensor(ids, dtype=torch.int32, device=dev)
    used = len({i for i in ids if 0 <= i < N})
    live = sum(0 <= i < N for i in ids)
    y = lora_ops.grouped_lora_residual(x, downs, ups, idx, scale=SCALE)
    n_bytes = nbytes(x, y, idx) + used * nbytes(downs[0], ups[0])
    b_ms, b_by = bound(n_bytes, (4 * r + 2) * live * D, "f32")
    (k_ms, k_is), (p_ms, p_is) = (
        time_ms(torch, lambda: lora_ops.grouped_lora_residual(x, downs, ups, idx, scale=SCALE)),
        time_ms(torch, lambda: lora_ref.grouped_lora_residual(x, downs, ups, idx, scale=SCALE)))
    c_ms = time_ms_cold(torch, lambda *a: lora_ops.grouped_lora_residual(*a, scale=SCALE),
                        (x, downs, ups, idx), n_bytes)
    kernel_breakdown(torch, lambda: lora_ops.grouped_lora_residual(x, downs, ups, idx,
                                                                   scale=SCALE),
                     f"grouped_lora_residual at x ({len(ids)}, {D}), {used} in use")
    log(f"[time] grouped_lora_residual at x ({len(ids)}, {D}) bf16, idx {ids} ({used} in use), "
        f"bank ({N}, {D}, {r}) f32{what}, device ms per call (issued from Python): kernel "
        f"{k_ms:.5f} ({k_is:.5f}), cold {c_ms:.5f} | plain {p_ms:.5f} ({p_is:.5f}) | library "
        f"None | bound {b_ms:.5f} ({b_by}, {n_bytes / 1e6:.3f} MB) | bound / time: warm "
        f"{b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}")
    return dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, ids=list(ids), shape=[len(ids), D, r, N])


def causal_pairs(s: int, window=None) -> int:
    """Unmasked (query, key) pairs of one causal head of length s, with a window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_timing(torch, F, fa_ops, fa_ref, q, k, v, what="", window=None, softcap=0.0):
    """The flash kernel (causal, with ``window`` and ``softcap``) beside its
    plain version, SDPA and its bound. SDPA has no softcap: it is timed
    wherever none applies, takes GQA's K/V heads as they are
    (``enable_gqa``), and takes a window shorter than the sequence as a
    boolean band mask built before the timing (``attention.causal_mask``).
    -> a kernel-table row."""
    from repro_torch.models.attention import causal_mask

    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
    pairs = causal_pairs(S, window) * H * B
    b_ms, b_by = bound(nbytes(q, k, v, o, lse), 4 * hd * pairs, "bf16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw)),
                                  time_ms(torch, lambda: fa_ref.attention(q, k, v, **kw)))
    l_ms = l_is = None
    lib_note = "None (no softcap in SDPA)"
    if not softcap:
        sdpa_kw = dict(enable_gqa=True) if Hkv != H else {}
        if window is None or window >= S:
            sdpa_kw["is_causal"] = True
            lib_note = "causal"
        else:
            sdpa_kw["attn_mask"] = causal_mask(S, S, window=window, device=q.device)
            lib_note = f"band mask of window {window}"
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw).transpose(1, 2)
        lib_err = float((lib_out.float() - o.float()).abs().max())
        if not lib_err <= 1e-1 * float(o.float().abs().max()):
            raise AssertionError(f"SDPA ({lib_note}) is not the kernel's function: "
                                 f"max abs difference {lib_err:.3e}")
        lib_note += f", max abs difference from the kernel {lib_err:.3e}"
        l_ms, l_is = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           **sdpa_kw))
    c_ms = time_ms_cold(torch, lambda *a: fa_ops.flash_attention(*a, **kw), (q, k, v),
                        nbytes(q, k, v, o, lse))
    lib = f"{l_ms:.5f} ({l_is:.5f}; {lib_note})" if l_ms is not None else lib_note
    log(f"[time] flash_attention at q ({B}, {S}, {H}, {hd}) k/v Hkv {Hkv} bf16 causal"
        f"{f' window {window}' if window else ''}{f' softcap {softcap}' if softcap else ''}"
        f"{what}, device ms per call (issued from "
        f"Python): kernel {k_ms:.5f} ({k_is:.5f}), cold {c_ms:.5f} | plain {p_ms:.5f} "
        f"({p_is:.5f}) | library SDPA {lib} | bound {b_ms:.5f} ({b_by}) | bound / time: warm "
        f"{b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}")
    return dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, shape=[B, S, H, Hkv, hd, window] + ([softcap] if softcap else []))


def flash_bwd_timing(torch, F, fa_ops, fa_ref, gen, b, s_, h, hkv, hd, what=""):
    """Flash attention's backward kernel at one causal bf16 shape, warm and
    cold, beside its bound (10·D operations a visible pair at the bf16 peak,
    or its bytes at 3.35 TB/s, the larger), the plain backward
    (``ref.attention_bwd``) and SDPA's backward as the library yardstick
    (forward and backward through autograd, less the forward alone; K/V
    heads as they are, ``enable_gqa``). -> a kernel-table row."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)

    kw = dict(causal=True, window=None, softcap=0.0)
    q, g = randn((b, s_, h, hd)), randn((b, s_, h, hd))
    k, v = randn((b, s_, hkv, hd)), randn((b, s_, hkv, hd))
    out, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, g)
    grads = fa_ops._backward(*args, **kw)
    n_bytes = nbytes(*args, *grads)
    b_ms, b_by = bound(n_bytes, 10 * hd * causal_pairs(s_) * h * b, "bf16")
    k_ms, k_is = time_ms(torch, lambda: fa_ops._backward(*args, **kw))
    c_ms = time_ms_cold(torch, lambda *a: fa_ops._backward(*a, **kw), args, n_bytes)
    p_ms = time_events(torch, lambda: fa_ref.attention_bwd(*args, **kw), iters=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    sdpa_kw = dict(is_causal=True, enable_gqa=hkv != h)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        torch.autograd.grad(o, (qt, kt, vt), gt)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

    l_ms = time_events(torch, sdpa_fwd_bwd) - time_events(torch, sdpa_fwd)
    kernel_breakdown(torch, lambda: fa_ops._backward(*args, **kw),
                     f"flash_attention_bwd at q ({b}, {s_}, {h}, {hd})", calls=5)
    log(f"[time] flash_attention_bwd at q ({b}, {s_}, {h}, {hd}) k/v Hkv {hkv} bf16 causal"
        f"{what}, device ms per call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}), "
        f"cold {c_ms:.5f} | plain {p_ms:.5f} | library SDPA backward (forward + backward less "
        f"the forward) {l_ms:.5f} | bound {b_ms:.5f} ({b_by}; 10·D operations a visible pair) "
        f"| bound / time: warm {b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}; "
        f"{10 * hd * causal_pairs(s_) * h * b / k_ms / 1e9:.1f} TFLOP/s at 10·D, "
        f"{18 * hd * causal_pairs(s_) * h * b / k_ms / 1e9:.1f} at the 18·D it computes")
    return dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, shape=[b, s_, h, hkv, hd])


def timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref):
    """Each kernel at its main-path shape: llava-1.5-7b, prefill_len 128,
    64 patches, 8 decode slots, 8 adapter slots, rank 64, bf16 activations;
    LoRA also at training's (256, 4096) image rows and (384, 4096), flash
    also at training's (4, 96, 32, 128)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf16 = torch.bfloat16
    out = {}
    T, D, r, N = 128, 4096, 64, 8

    # text NanoAdapter at prefill: x (T, D) bf16, adapters f32; then training's rows
    lora = {}
    for t in (T, 256, 384):
        lora[t] = lora_timing(torch, lora_ops, lora_ref, randn((t, D), dtype=bf16),
                              randn((D, r), 0.05), randn((r, D), 0.05))
    out["lora_residual"] = dict(lora[T], shapes={f"x ({t}, {D})": row for t, row in lora.items()})
    x, A, B = randn((T, D), dtype=bf16), randn((D, r), 0.05), randn((r, D), 0.05)
    kernel_breakdown(torch, lambda: lora_ops.lora_residual(x, A, B, scale=SCALE),
                     f"lora_residual at x ({T}, {D})")

    # text bank at decode: 8 slots, 4 tenants + 1 base row + adapters reused;
    # then 1 and all 8 of the bank's adapters in use
    grouped = {label: grouped_timing(torch, lora_ops, lora_ref, gen, D, ids, f" ({label})")
               for label, ids in (("4 in use", [0, 1, 2, 3, 0, 1, 2, -1]),
                                  ("1 in use", [0, 0, 0, 0, 0, 0, 0, -1]),
                                  ("8 in use", list(range(N))))}
    out["grouped_lora_residual"] = dict(grouped["4 in use"], shapes=grouped)

    # prefill attention: 64 image + 128 text positions, 32 heads of 128, causal;
    # then the training step's batch 4 of 96 positions
    H, hd = 32, 128
    flash = {}
    for label, (b, s_) in (("prefill", (1, 64 + T)), ("train", (4, 96))):
        q, k, v = (randn((b, s_, H, hd), dtype=bf16) for _ in range(3))
        flash[label] = flash_timing(torch, F, fa_ops, fa_ref, q, k, v, f" ({label})")
    out["flash_attention"] = dict(flash["prefill"], shapes=flash)

    # the backward kernel at the training cells' attention: internlm2-20b's
    # 4 rows of 2,048 tokens (GQA 6; the table's shape) and qwen2-vl-72b's
    # cohort of 32 rows of 256 (GQA 8)
    bwd = {}
    for label, (b, s_, h, hkv) in (("longdoc", (4, 2048, 48, 8)),
                                   ("vqa-cohort", (32, 256, 64, 8))):
        bwd[label] = flash_bwd_timing(torch, F, fa_ops, fa_ref, gen, b, s_, h, hkv, hd,
                                      f" ({label})")
    out["flash_attention_bwd"] = dict(bwd["longdoc"], shapes=bwd)
    return out


# ---------------------------------------------------------------------------
# the ssm family: the SSD scan kernel and mamba2-130m's widths
# ---------------------------------------------------------------------------

def ssd_inputs(torch, gen, b, s, h, p, n, dtype):
    """The JAX harness's input scales: x·0.5, dt in [0.01, 0.2), A in (-2, -0.5]."""
    dev = gen.device
    x = (torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    dt = (torch.rand((b, s, h), generator=gen, device=dev) * 0.19 + 0.01).to(dtype)
    A = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
    B, C = ((torch.randn((b, s, n), generator=gen, device=dev) * 0.3).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C


def ssd_work(b, s, h, p, n, q, itemsize):
    """-> (bytes, operations) the SSD scan needs at these shapes: each
    input read once and y written once; per (b, chunk) C·Bᵀ once (it does not
    depend on the head) over the causal pairs j <= i, and per head the masked
    product with x over those pairs, the carried state's read (C·h) on every
    chunk but the first (h = 0 there) and its update (B·xᵀ) on every chunk
    but the last (only y is returned), 2 operations a multiply-add."""
    pairs = 0
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    for r in rows:
        pairs += r * (r + 1) // 2
    carried = (s - rows[0]) + (s - rows[-1])   # steps of C·h reads + state updates
    ops = b * (2 * pairs * n + h * (2 * pairs * p + 2 * carried * n * p))
    n_bytes = itemsize * (2 * b * s * h * p + b * s * h + 2 * b * s * n) + 4 * h
    return n_bytes, ops


def mamba_parity(torch, harness, ssd_ops, ssd_ref, lora_ops, lora_ref, fm_ops, fm_ref):
    """The SSD kernel and its gradients against the plain version, and the
    LoRA and Fisher kernels at mamba2's widths. -> {kernel: max |err|}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    main_err, n_cases, full = {}, 0, {}
    names = ("dx", "ddt", "dA", "dB", "dC")

    def rel(got, want):  # max |got - want| / max(1, ‖want‖∞), the harness's scale
        return float((got.double() - want.double()).abs().max()) / max(
            1.0, float(want.double().abs().max()))

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in harness.SSD_SHAPES + harness.SSD_EDGE_SHAPES + harness.FULL_SSD_SHAPES:
            b, s, h, p, n, q = shape
            is_full = shape in harness.FULL_SSD_SHAPES
            tol = harness.ssd_tolerances(*shape)
            args = ssd_inputs(torch, gen, b, s, h, p, n, dtype)
            y_k = ssd_ops.ssd(*args, chunk=q)
            y_p = ssd_ref.ssd_chunked(*args, chunk=q)
            err = harness.check_close(y_k, y_p, dtype_name, f"ssd {shape}", tol)
            got = sq_loss_grads(lambda *a: ssd_ops.ssd(*a, chunk=q), *args)
            want = sq_loss_grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *args)
            gerr = max(rel(g, w) for g, w in zip(got, want))
            for name, g, w in zip(names, got, want):
                harness.check_close(g, w, dtype_name, f"ssd grad {name} {shape}", tol)
            n_cases += 2
            if not is_full:
                continue
            line = (f"forward max |err| {err:.3e}, {rel(y_k, y_p):.3e} of max(1, ‖ref‖∞); "
                    f"gradients {gerr:.3e} (bound {tol[dtype_name]['atol_scale']})")
            if dtype_name == "float32":
                # both f32 paths against the same scan in float64
                a64 = [t.double() for t in args]
                y64 = ssd_ref.ssd_chunked(*a64, chunk=q)
                g64 = sq_loss_grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *a64)
                line += (f"; against float64: forward kernel {rel(y_k, y64):.3e}, plain "
                         f"{rel(y_p, y64):.3e}; gradients Function "
                         f"{max(rel(g, w) for g, w in zip(got, g64)):.3e}, plain autograd "
                         f"{max(rel(g, w) for g, w in zip(want, g64)):.3e}")
            full[f"{dtype_name} {shape[:2]}"] = line
            if shape == harness.FULL_SSD_SHAPES[-1] and dtype_name == "bfloat16":
                main_err["ssd_scan"] = err
        for t, d, r, _ in harness.MAMBA_LORA_SHAPES:
            x, down, up = (torch.randn((t, d), generator=gen, device=dev).to(dtype),
                           torch.randn((d, r), generator=gen, device=dev) * 0.05,
                           torch.randn((r, d), generator=gen, device=dev) * 0.05)
            harness.check_close(lora_ops.lora_residual(x, down, up, scale=SCALE),
                                lora_ref.lora_residual(x, down, up, scale=SCALE), dtype_name,
                                f"lora t{t}d{d}r{r}")
            n_cases += 1
        for t, d, r, nb, _ in harness.MAMBA_GROUPED_SHAPES:
            x = torch.randn((t, d), generator=gen, device=dev).to(dtype)
            down = torch.randn((nb, d, r), generator=gen, device=dev) * 0.05
            up = torch.randn((nb, r, d), generator=gen, device=dev) * 0.05
            idx = torch.randint(-1, nb, (t,), generator=gen, device=dev, dtype=torch.int32)
            harness.check_close(lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE),
                                lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE),
                                dtype_name, f"grouped t{t}d{d}n{nb}")
            n_cases += 1
        for t, d, r, _ in harness.MAMBA_LORA_GRAD_SHAPES:
            x = torch.randn((t, d), generator=gen, device=dev).to(dtype)
            down = torch.randn((d, r), generator=gen, device=dev) * 0.05
            up = torch.randn((r, d), generator=gen, device=dev) * 0.05
            got = sq_loss_grads(lambda a, b_, c: lora_ops.lora_residual(a, b_, c, scale=SCALE),
                                x, down, up)
            want = sq_loss_grads(lambda a, b_, c: lora_ref.lora_residual(a, b_, c, scale=SCALE),
                                 x, down, up)
            for name, g, w in zip(("dx", "dA", "dB"), got, want):
                harness.check_close(g, w, dtype_name, f"lora grad {name} t{t}d{d}r{r}")
            n_cases += 1
        n_cases += fisher_parity(torch, harness, fm_ops, fm_ref, gen, dtype_name,
                                 harness.MAMBA_FISHER_SHAPES, harness.MAMBA_FISHER_TREES)[0]
    torch.cuda.synchronize()
    log(f"[ssd-parity] {n_cases} kernel-vs-plain cases passed (SSD forward and gradients over "
        f"the harness grid, the edges and the full-width shapes; LoRA, grouped LoRA, LoRA "
        f"gradients and Fisher kernels at d_model 768; f32 and bf16)")
    for key, line in full.items():
        log(f"[ssd-parity] full width {key}: {line}")
    ssd_model_gaps(torch, harness, ssd_ops, ssd_ref, gen)
    return main_err


def ssd_model_gaps(torch, harness, ssd_ops, ssd_ref, gen):
    """The bf16 SSD kernel against its rounding model over the grid, edge and
    full-width shapes (held at harness.BF16_MODEL_TOLERANCES and
    harness.SSD_MODEL_MAX_SHARE), and at the full-width shapes what its
    arithmetic costs: the kernel, the exact plain version and the model
    against the f32 function of the same bf16 inputs."""
    bf16 = torch.bfloat16
    worst, acc = [0.0, 0.0], {}
    for shape in harness.SSD_SHAPES + harness.SSD_EDGE_SHAPES + harness.FULL_SSD_SHAPES:
        b, s, h, p, n, q = shape
        args = ssd_inputs(torch, gen, b, s, h, p, n, bf16)
        got = ssd_ops.ssd(*args, chunk=q)
        model = ssd_ref.ssd_chunked_bf16_model(*args, chunk=q)
        what = f"ssd {shape} vs model"
        harness.check_close(got, model, "bfloat16", what, harness.BF16_MODEL_TOLERANCES)
        harness.check_share(got, model, harness.SSD_MODEL_MAX_SHARE, what)
        worst = [max(a, b_) for a, b_ in zip(worst, rel_gap(got, model))]
        if shape in harness.FULL_SSD_SHAPES:
            exact = ssd_ref.ssd_chunked(*(t.float() for t in args), chunk=q)
            plain = ssd_ref.ssd_chunked(*args, chunk=q)
            acc[shape[:2]] = dict(kernel_model=rel_gap(got, model), plain_model=rel_gap(plain, model),
                                  kernel=rel_gap(got, exact), plain=rel_gap(plain, exact),
                                  model=rel_gap(model, exact), kernel_plain=rel_gap(got, plain))
    torch.cuda.synchronize()
    bound = harness.BF16_MODEL_TOLERANCES["bfloat16"]
    log(f"[ssd-parity] ssd_scan bf16 kernel vs its rounding model over the grid, edge and "
        f"full-width shapes: max |err| / max(1, ‖ref‖∞) {worst[0]:.3e}, elements that differ "
        f"{worst[1]:.3e} (bound rtol {bound['rtol']}, atol {bound['atol_scale']}; share limit "
        f"{harness.SSD_MODEL_MAX_SHARE})")
    for key, g in acc.items():
        log(f"[accuracy] ssd x {key} bf16, max |err| / max(1, ‖ref‖∞) against the f32 function "
            f"of the same inputs: kernel {g['kernel'][0]:.3e} | exact plain version rounded to "
            f"bf16 {g['plain'][0]:.3e} | rounding model {g['model'][0]:.3e} | kernel vs plain "
            f"{g['kernel_plain'][0]:.3e}, elements that differ {g['kernel_plain'][1]:.3e} | "
            f"against the rounding model: kernel {g['kernel_model'][0]:.3e}, elements that "
            f"differ {g['kernel_model'][1]:.3e}; exact plain version {g['plain_model'][0]:.3e}, "
            f"elements that differ {g['plain_model'][1]:.3e}")


def mamba_timings(torch, ssd_ops, ssd_ref, lora_ops, lora_ref, harness):
    """The SSD kernel at both full-width shapes and the LoRA kernel at d_model
    768, bf16 activations, beside their plain versions and bounds.
    -> (SSD kernel-table row, LoRA rows by shape)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    shapes = {}
    for label, shape in zip(("serve", "train"), harness.FULL_SSD_SHAPES):
        b, s, h, p, n, q = shape
        args = ssd_inputs(torch, gen, b, s, h, p, n, bf16)
        (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: ssd_ops.ssd(*args, chunk=q)),
                                      time_ms(torch, lambda: ssd_ref.ssd_chunked(*args, chunk=q)))
        n_bytes, n_ops = ssd_work(b, s, h, p, n, q, 2)
        # the bf16 kernel's products run on the tensor cores; the f32 CUDA-core
        # figure is the bound of the same products at f32
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        b32_ms, b32_by = bound(n_bytes, n_ops, "f32")
        c_ms = time_ms_cold(torch, lambda *a: ssd_ops.ssd(*a, chunk=q), args, n_bytes)
        shapes[label] = dict(shape=list(shape), ms=k_ms, cold_ms=c_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b32_ms)
        log(f"[time] ssd_scan at x ({b}, {s}, {h}, {p}) bf16, N {n}, chunk {q} ({label}): "
            f"device ms per call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}), cold "
            f"{c_ms:.5f} (bound / time {b_ms / c_ms:.3f}) | plain "
            f"{p_ms:.5f} ({p_is:.5f}) | library None | bound {b_ms:.5f} ({b_by}; "
            f"{n_ops / 1e9:.4f} GFLOP at the bf16 tensor-core rate, {n_bytes / 1e6:.3f} MB) | "
            f"bound at the f32 CUDA-core rate {b32_ms:.5f} ({b32_by}) | kernel at "
            f"{n_ops / k_ms / 1e9:.3f} TFLOP/s")
        kernel_breakdown(torch, lambda: ssd_ops.ssd(*args, chunk=q),
                         f"ssd_scan at x ({b}, {s}, {h}, {p}) ({label})")
        if label == "train":
            # what a local step pays per layer: SSDScan (kernel forward, then the
            # plain forward recomputed and differentiated) against plain autograd.
            # A is frozen; x, dt, B and C lie downstream of the adapter.
            leaves = [t.detach().requires_grad_(i != 2) for i, t in enumerate(args)]
            g = torch.randn(args[0].shape, generator=gen, device=dev).to(bf16)

            def fwd_bwd(fn):
                return torch.autograd.grad(fn(*leaves, chunk=q),
                                           [t for t in leaves if t.requires_grad], g)

            (f_ms, _), (a_ms, _) = (time_ms(torch, lambda: fwd_bwd(ssd_ops.ssd), iters=10),
                                    time_ms(torch, lambda: fwd_bwd(ssd_ref.ssd_chunked),
                                            iters=10))
            shapes[label].update(fwd_bwd_ms=f_ms, plain_fwd_bwd_ms=a_ms)
            log(f"[time] ssd_scan forward + backward at x ({b}, {s}, {h}, {p}) bf16 (train): "
                f"device ms: SSDScan {f_ms:.5f} (kernel forward + plain recompute and backward) "
                f"| plain autograd {a_ms:.5f} | so the backward alone about "
                f"{a_ms - p_ms:.5f} and the kernel forward adds {f_ms - a_ms:.5f}")
    lora = {}
    for t, d, r, _ in harness.MAMBA_LORA_SHAPES:
        x = torch.randn((t, d), generator=gen, device=dev).to(bf16)
        A = torch.randn((d, r), generator=gen, device=dev) * 0.05
        Bm = torch.randn((r, d), generator=gen, device=dev) * 0.05
        lora[f"x ({t}, {d})"] = lora_timing(torch, lora_ops, lora_ref, x, A, Bm, " (mamba2-130m)")
    kernel_breakdown(torch, lambda: lora_ops.lora_residual(x, A, Bm, scale=SCALE),
                     f"lora_residual at x {tuple(x.shape)} (mamba2-130m)")
    _, d, r, n, _ = harness.MAMBA_GROUPED_SHAPES[0]
    grouped = grouped_timing(torch, lora_ops, lora_ref, gen, d, [0, 1, 2, 3, 0, 1, 2, -1],
                             " (mamba2-130m)", r=r, N=n)
    main = shapes["train"]
    return {"ssd_scan": dict(ms=main["ms"], cold_ms=main["cold_ms"], plain_ms=main["plain_ms"],
                             library_ms=None, bound_ms=main["bound_ms"],
                             bound_by=main["bound_by"], shapes=shapes)}, lora, grouped


def breakdown(torch, get_config, init_backbone, synth, make_requests, Engine,
              arch="llava-1.5-7b"):
    """Device busy share and device time by kernel over a short full-width
    serving run, from torch.profiler: for llava-1.5-7b 8 requests of 5
    tokens, for mamba2-130m one prefill of prefill_len tokens and 4 decode
    steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch).with_(use_pallas=True)
    backbone = init_backbone(cfg, seed=0, device="cuda")
    names = ["tenant0", "tenant1"]
    tenants = synth(0, cfg, names, "cuda")
    top = SERVE_KW[arch]["prefill_len"]
    reqs = make_requests(cfg, names, 8 if arch != MAMBA else 1, top, 5, 0)
    if arch == MAMBA:
        reqs[0].prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, top).astype(np.int32)
    kw = dict(SERVE_KW[arch], max_new_tokens=5, adapter_loader=tenants.__getitem__,
              use_pallas_grouped=True)
    Engine(cfg, backbone, **kw).run(reqs[:1])  # warm-up
    eng = Engine(cfg, backbone, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(torch, prof, wall,
                    f"{arch} serving, {len(reqs)} request(s) of {[len(r.prompt) for r in reqs]} "
                    f"prompt tokens x 5 tokens ({eng.stats['prefills']} prefills, "
                    f"{eng.stats['decode_steps']} decode steps)")


def step_profile(torch, tr, st):
    """Device busy share and device time by kernel over one full-width local
    step (forward, backward, AdamW, float(loss)), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg, server = st["cfg"], st["server"]
    adp = st["res"].server.global_adapters
    opt = tr["adamw_init"](adp)

    def step():
        return float(tr["client"].train_step(cfg, tr["get_strategy"]("fednano"), st["hp"],
                                              server.backbone, adp, opt, st["train"][0][0],
                                              adp)[2])

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(torch, prof, wall, "one full-width local step")


def profile_summary(torch, prof, wall, what):
    """Log the busy share and the largest device times by kernel name. -> the
    busy share (None where the profiler saw no device activity)."""
    # device activities only (kernels, copies, sets): a CPU op's device time
    # would count its kernels a second time
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log(f"[profile] {what}: the profiler recorded no device activity: busy share not "
            "measured")
        return None
    busy_us, reach = 0.0, float("-inf")
    by_name = {}
    for start, end, name in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + end - start, n + 1)
    log(f"[profile] {what} under the profiler: wall {1e3 * wall:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, busy share {busy_us / 1e6 / wall:.3f} "
        f"({len(spans)} device activities)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {t / 1e3:9.3f} ms  {n:6d} x  {name[:90]}")
    # the port's kernels by the names of their CUDA functions
    ours = {"flash_attention": ("flash_fwd",), "lora_residual": ("tc::",),
            "grouped_lora_residual (and f32 lora_residual)": ("cc::",),
            "ssd_scan": ("chunk_state", "state_passing", "chunk_output"), "fisher": ("fisher_",)}
    parts = []
    for kernel, keys in ours.items():
        t = sum(v[0] for name, v in by_name.items() if any(key in name for key in keys))
        n = sum(v[1] for name, v in by_name.items() if any(key in name for key in keys))
        if n:
            parts.append(f"{kernel} {t / 1e3:.3f} ms over {n} launches "
                         f"({t / busy_us:.3f} of busy)")
    log(f"[profile]   the port's kernels: {'; '.join(parts) or 'none'}")
    return busy_us / 1e6 / wall


# ---------------------------------------------------------------------------
# the dense family: h2o-danube-1.8b, glm4-9b, qwen1.5-4b, internlm2-20b
# ---------------------------------------------------------------------------

def upcast_in_place(torch, backbone, n_layers):
    """Keep the first ``n_layers`` layers (a stack of ``layers``; the hybrid
    and encoder-decoder stacks are kept whole, at full depth) and turn every
    weight to f32 in place, one tensor at a time, so the bf16 copy is freed
    as the f32 one is made (every holder of a weight sees it in f32)."""
    from repro_torch.utils import tree_leaves

    if "layers" in backbone:
        del backbone["layers"][n_layers:]
    torch.cuda.empty_cache()
    for t in tree_leaves(backbone):
        t.data = t.data.float()
    torch.cuda.empty_cache()


def window_step_batch(torch, cfg, seq_len):
    """Batch 1 x ``seq_len`` tokens from a seeded generator, answer mask on
    the second half: a training row longer than h2o-danube's window."""
    from repro_torch.core.types import Batch

    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq_len + 1), generator=gen, device="cuda")
    mask = torch.zeros((1, seq_len), device="cuda")
    mask[:, seq_len // 2:] = 1.0
    return Batch(tokens=tokens[:, :-1], labels=tokens[:, 1:], mask=mask)


def dense_arch(torch, tr, sv, counters, arch):
    """One dense arch at published width. -> launches per kernel by path."""
    from repro_torch.utils import tree_leaves

    log(f"[dense] device memory before drawing {arch}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfg = tr["get_config"](arch).with_(use_pallas=True)
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(server.backbone))
    log(f"[dense] {arch} backbone: {n_params / 1e9:.3f} B params ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv_bias "
        f"{cfg.qkv_bias}, window {cfg.sliding_window}, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    short = arch.split("-")[0]
    launches = {}

    # serving: 16 requests of 4 tenants and base traffic
    names = [f"tenant{i}" for i in range(4)]
    tenants = sv["synth"](0, cfg, names, "cuda")
    kw = dict(DENSE_SERVE_KW, adapter_loader=tenants.__getitem__)
    reqs = sv["make_requests"](cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], 0)
    launches[f"serve_{short}"], *_ = serve_main_path(torch, cfg, server.backbone, sv["Engine"],
                                                     counters, kw, reqs, arch)
    if cfg.sliding_window is not None:
        launches[f"serve_{short}_ring"] = serve_past_window(torch, cfg, server.backbone, sv,
                                                            counters, tenants, names)
    torch.cuda.empty_cache()

    # training: FedNano 2 clients x 2 rounds, and one agg_chunk=1 round
    st, train_launches = training_full(torch, tr, counters, arch=arch, server=server)
    launches.update(train_launches)
    run_vs_plain(torch, tr, st, held=1)
    loop_timings(torch, tr, st)
    trained = st["res"].server.global_adapters
    if cfg.sliding_window is not None:
        window_step(torch, tr, cfg, server.backbone, trained)

    # f32 on the same weights upcast (internlm2-20b at DENSE_F32_LAYERS)
    n32 = min(DENSE_F32_LAYERS.get(arch, cfg.n_layers), cfg.n_layers)
    cfg32, _ = f32_checks(torch, tr, sv, cfg, server, kw, reqs, trained, st["train"][0][0],
                          n32, "dense")
    if cfg.sliding_window is not None:
        window_step(torch, tr, cfg32, server.backbone, trained)
        ring_decode_check(torch, tr, cfg32, server.backbone)
    del st, server, trained
    torch.cuda.empty_cache()
    return launches


def f32_checks(torch, tr, sv, cfg, server, kw, reqs, trained, batch, n32, phase):
    """The server's weights upcast to f32 in place, its first ``n32`` layers:
    the prefill logits of ``reqs``, kernels against plain versions, at
    LOGIT_TOL; one step's loss and adapter gradients at the first step and
    at ``trained``, at LOSS_TOL and GRAD_TOL. The plain runs take the kernel
    runs' expert choices. -> (the f32 config, the MoE routing records of
    each prefill: the kernels', and the plain versions' own)."""
    upcast_in_place(torch, server.backbone, n32)
    cfg32 = cfg.with_(dtype="float32", n_layers=n32)
    depth = f"{n32} of {cfg.n_layers} layers" if n32 < cfg.n_layers else "full depth"
    log(f"[{phase}] {cfg.name} upcast to f32 ({depth}): "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine = lambda: sv["Engine"](cfg32, server.backbone, use_pallas_grouped=True, **kw)
    kernel32, routes = prefill_routes(engine(), reqs)
    with plain_versions():
        plain32, plain_routes = prefill_routes(engine(), reqs, routes)
    worst = hold(torch, "float32", reqs, kernel32, plain32)
    log(f"[serve] {cfg.name} f32 ({depth}), kernels vs their plain versions: prefill logits of "
        f"{len(reqs)} requests max |err| / ‖ref‖∞ = {worst:.3e} (limit {LOGIT_TOL['float32']})")
    step_check(torch, tr, cfg32, server.backbone,
               (("first step", server.global_adapters), ("trained", trained)), batch,
               what=f"{cfg.name} ({depth})")
    return cfg32, (routes, plain_routes)


def detached(routing):
    """A ``moe.Routing`` cut from autograd's graph."""
    return type(routing)(*(t.detach() if hasattr(t, "detach") else t for t in routing))


@contextlib.contextmanager
def recorded_routes():
    """Yield a list that receives every MoE layer's ``moe.Routing`` while
    inside, detached, one record a forward call (``moe.route`` swapped for a
    recording wrapper); a ``remat`` recompute's calls
    (``transformer.recomputing()``), which repeat forward calls on the same
    inputs, are not recorded."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import recomputing

    routes, route = [], moe_lib.route

    def recording(*args):
        r = route(*args)
        if not recomputing():
            routes.append(detached(r))
        return r

    moe_lib.route = recording
    try:
        yield routes
    finally:
        moe_lib.route = route


@contextlib.contextmanager
def replayed_routes(recorded):
    """Inside, the n-th ``moe.route`` call keeps the expert choices, slots
    and drops of ``recorded[n]`` (another run's routing, in call order) and
    takes its gates from this run's own router probabilities at those
    choices. A run on the plain versions held against a kernel run then
    meets the same experts: in bf16 the two runs' rounding flips near-tied
    router choices (``moe_routing`` prints the share), and a token sent to
    another expert meets other weights. Yields a list that receives this
    run's own routing of each call, detached; fails unless the calls match
    ``recorded`` one for one. A ``remat`` recompute's call (in the backward,
    layers in reverse order) takes the choices its layer's forward call took
    last, with gates from the recompute's own probabilities, so the
    gradient belongs to the replayed routing; it is neither recorded nor
    counted, and fails if its layer made no forward call inside."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import recomputing

    own, route, last = [], moe_lib.route, {}

    def replaying(cfg, router, xg):
        r = route(cfg, router, xg)
        if recomputing():
            if id(router) not in last:
                raise AssertionError("routing replay: a remat recompute routed through a "
                                     "layer that made no forward call in the replay")
            want = last[id(router)]
        else:
            own.append(detached(r))
            n = len(own) - 1
            if n >= len(recorded) or recorded[n].idx.shape != r.idx.shape:
                raise AssertionError(f"routing replay: call {n} of {len(recorded)} recorded "
                                     f"has choices {tuple(r.idx.shape)}")
            want = last[id(router)] = recorded[n]
        gates = r.probs.gather(-1, want.idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        return r._replace(gates=gates, idx=want.idx, keep=want.keep, slot=want.slot)

    moe_lib.route = replaying
    try:
        yield own
    finally:
        moe_lib.route = route
    if len(own) != len(recorded):
        raise AssertionError(f"routing replay: {len(own)} calls, {len(recorded)} recorded")


def replay_note(recorded, own) -> str:
    """The log's note on a replayed run (empty for a config without experts)."""
    flat = lambda rs: [x for r in rs for x in (r if isinstance(r, list) else [r])]
    recorded, own = flat(recorded), flat(own)
    if not recorded:
        return ""
    return (f"; the plain run took the kernel run's expert choices, where its own, layer by "
            f"layer, agree on {route_agreement([recorded], [own]):.5f}")


def prefill_routes(eng, reqs, replay=None):
    """Prefill each of ``reqs`` alone on engine ``eng``. -> (its logits, its
    MoE routing, one record a layer; empty for a config without experts).
    With ``replay`` (another run's routing of the same prefills) each
    prefill takes that run's expert choices, and the records are its own."""
    logits, routes = [], []
    for i, r in enumerate(reqs):
        with (recorded_routes() if replay is None else replayed_routes(replay[i])) as rec:
            logits.append(eng.prefill_logits(r))
        routes.append(rec)
    return logits, routes


def serve_past_window(torch, cfg, backbone, sv, counters, tenants, names):
    """h2o-danube's prompts of 3,900-4,096 tokens and 64 new tokens: decode
    wraps the 4,096-slot ring. -> launches per kernel."""
    import numpy as np

    kw = dict(H2O_RING_KW, adapter_loader=tenants.__getitem__)
    reqs = sv["make_requests"](cfg, names, kw["max_slots"], kw["prefill_len"],
                               kw["max_new_tokens"], 1)
    rng = np.random.default_rng(2)
    for r, n in zip(reqs, np.linspace(*H2O_RING_PROMPTS, len(reqs)).astype(int)):
        r.prompt = rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
    eng = sv["Engine"](cfg, backbone, **kw)
    ring = eng.slots.state["layers"].k.shape[2]
    del eng
    last = max(len(r.prompt) + r.max_new_tokens - 1 for r in reqs)
    if ring != cfg.sliding_window or last < ring:
        raise AssertionError(f"the ring has {ring} slots and decode reaches position {last}")
    log(f"[serve] {cfg.name} past the window: prompt lengths {[len(r.prompt) for r in reqs]}, "
        f"prefill_len {kw['prefill_len']}, {kw['max_new_tokens']} new tokens; the KV ring has "
        f"{ring} slots and decode reaches position {last}")
    launches, *_ = serve_main_path(torch, cfg, backbone, sv["Engine"], counters, kw, reqs,
                                   f"{cfg.name} past the window")
    return launches


def window_step(torch, tr, cfg, backbone, adapters):
    """One local step at batch 1 x 6,144 tokens, past h2o-danube's window,
    on the first 2 layers: loss and adapter gradients, kernels against plain
    versions, at LOSS_TOL and GRAD_TOL."""
    n, seq = H2O_WINDOW_STEP["n_layers"], H2O_WINDOW_STEP["seq_len"]
    cut = dict(backbone, layers=backbone["layers"][:n])
    torch.cuda.reset_peak_memory_stats()
    step_check(torch, tr, cfg.with_(n_layers=n), cut, (("trained", adapters),),
               window_step_batch(torch, cfg, seq),
               what=f"{cfg.name} window step (batch 1 x {seq} tokens, window "
                    f"{cfg.sliding_window}, {n} of {cfg.n_layers} layers)")
    log(f"[train-check] {cfg.name} {cfg.dtype} window step: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def cut_depth(cfg, backbone, n):
    """``cfg`` and ``backbone`` cut to their first ``n`` layers: a hybrid
    stack keeps its first n // 3 triples and n % 3 of its extra layers."""
    if cfg.family == "hybrid":
        n_t = n // 3
        extras = (backbone["extras"] or [])[:n - 3 * n_t] or None
        return cfg.with_(n_layers=n), dict(backbone, triples=backbone["triples"][:n_t],
                                           extras=extras)
    return cfg.with_(n_layers=n), dict(backbone, layers=backbone["layers"][:n])


def ring_decode_check(torch, tr, cfg, backbone, check=H2O_RING_CHECK):
    """A config's KV ring in f32 on its first ``check["n_layers"]`` layers,
    past the window: prefill (kernels) and teacher-forced decode of one
    sequence of ``check["seq_len"]`` tokens from each of ``check["prefills"]``;
    every decode step's logits held at LOGIT_TOL against the logits of the
    full windowed forward of the same tokens, run once through the kernels
    and once through the plain versions (which hold each other at the same
    bound). h2o-danube's ring is its sliding window, recurrentgemma's its
    attention layers' local window (its recurrent layers carry their state
    through the same steps)."""
    model = tr["model"]
    n, N = check["n_layers"], check["seq_len"]
    depth = cfg.n_layers
    cfg, cut = cut_depth(cfg, backbone, n)
    w = cfg.rglru.local_window if cfg.family == "hybrid" else cfg.sliding_window
    tol = LOGIT_TOL["float32"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (1, N), generator=gen, device="cuda")
    pos = torch.arange(N, device="cuda")[None]
    with torch.no_grad():
        emb = model.embed_tokens(cfg, cut, tokens)
        full = model.logits(cfg, cut, model.forward(cfg, cut, emb, pos)[0])[0]
        with plain_versions():
            plain = model.logits(cfg, cut, model.forward(cfg, cut, emb, pos)[0])[0]
        gap = rel_err(full, plain)
        finite = bool(torch.isfinite(full).all()) and bool(torch.isfinite(plain).all())
        worst = {}
        for P in check["prefills"]:
            state, _ = model.prefill(cfg, cut, emb[:, :P], pos[:, :P], capacity=N)
            kv = state["triples"]["attn"] if cfg.family == "hybrid" else state["layers"]
            if kv.k.shape[2] != w:
                raise AssertionError(f"the ring has {kv.k.shape[2]} slots, not the window's {w}")
            errs = []
            for t in range(P, N):
                got, state = model.decode_step(cfg, cut, emb[:, t:t + 1], state, t)
                finite = finite and bool(torch.isfinite(got).all())
                errs.append(max(rel_err([got[0, 0]], [full[t]]), rel_err([got[0, 0]], [plain[t]])))
            worst[P] = (max(errs), P + errs.index(max(errs)))
    if not finite or gap > tol or any(e > tol for e, _ in worst.values()):
        raise AssertionError(f"{cfg.name} ring decode: finite {finite}, forward kernels vs "
                             f"plain {gap:.3e}, "
                             f"decode vs forward {worst} (bound {tol})")
    log(f"[serve-check] {cfg.name} f32 ring ({n} of {depth} layers, {w}-slot ring, {N} tokens): "
        f"full windowed forward, kernels vs plain versions {gap:.3e}; decode vs the forwards, "
        + "; ".join(f"prefill {P}, {N - P} steps to position {N - 1}: worst {e:.3e} at "
                    f"position {t}" for P, (e, t) in worst.items())
        + f" (bound {tol} of ‖ref‖∞)")


def dense_timings(torch, F, fa_ops, fa_ref):
    """The flash kernel at head dim 80: h2o-danube's prefill (1, 4096, 32, 80)
    and training batch (4, 32, 32, 80), Hkv 8, its window 4096, bf16; and,
    to tell the head dim from the sequence length, head dim 128 at the
    prefill's 4,096 positions."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for label, (b, s_, hd) in (("h2o prefill", (1, 4096, 80)), ("h2o train", (4, 32, 80)),
                               ("d128 at 4096", (1, 4096, 128))):
        q = torch.randn((b, s_, 32, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s_, 8, hd), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out[label] = flash_timing(torch, F, fa_ops, fa_ref, q, k, v, f" ({label})",
                                  window=4096)
    return out


# ---------------------------------------------------------------------------
# qwen2-vl-72b and the MoE family: llama4-scout-17b-a16e, grok-1-314b
# ---------------------------------------------------------------------------

def moe_arch(torch, tr, sv, counters, arch):
    """qwen2-vl-72b or an MoE config at published width and MOE_LAYERS depth.
    -> launches per kernel by path."""
    from repro_torch.utils import tree_leaves

    full = tr["get_config"](arch)
    n = MOE_LAYERS[arch]
    cfg = full.with_(use_pallas=True, n_layers=n)
    log(f"[moe] device memory before drawing {arch}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    size = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    per_layer = size(server.backbone["layers"][0])
    rest = size({k: v for k, v in server.backbone.items() if k != "layers"})
    experts = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff {cfg.d_ff}"
               + (f" + a shared expert of {cfg.moe.shared_d_ff}" if cfg.moe.shared_d_ff else "")
               + f", capacity factor {cfg.moe.capacity_factor}"
               if cfg.moe else f"d_ff {cfg.d_ff}")
    log(f"[moe] {arch}: {n} of its {full.n_layers} layers, because published depth holds "
        f"{(full.n_layers * per_layer + rest) / 1e9:.1f} GB of {cfg.dtype} weights, more than "
        f"one 80 GB card ({per_layer / 1e9:.2f} GB a layer, {rest / 1e9:.2f} GB outside the "
        f"layers; {n} layers: {(n * per_layer + rest) / 1e9:.1f} GB); published width: d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.resolved_head_dim}, "
        f"{experts}, vocab {cfg.vocab_size}, {cfg.act}, pos {cfg.pos_type}"
        f"{f' {cfg.mrope_sections}' if cfg.mrope_sections else ''}, qkv_bias {cfg.qkv_bias}, "
        f"softcap {cfg.logit_softcap}; drawn in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    short = arch.split("-")[0]
    launches = {}

    # serving: 16 requests of 4 tenants and base traffic (qwen2-vl: 64 patches each)
    names = [f"tenant{i}" for i in range(4)]
    tenants = sv["synth"](0, cfg, names, "cuda")
    kw = dict(DENSE_SERVE_KW, adapter_loader=tenants.__getitem__)
    reqs = sv["make_requests"](cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], 0)
    launches[f"serve_{short}"], *_ = serve_main_path(torch, cfg, server.backbone, sv["Engine"],
                                                     counters, kw, reqs, f"{arch} ({n} layers)")
    torch.cuda.empty_cache()

    # training: FedNano 2 clients x 2 rounds, and one agg_chunk=1 round
    st, train_launches = training_full(torch, tr, counters, arch=arch, server=server)
    launches.update(train_launches)
    trained, batch = st["res"].server.global_adapters, st["train"][0][0]
    run_vs_plain(torch, tr, st, held=1)
    loop_timings(torch, tr, st)
    if arch in REMAT_HOLD_ARCHS:  # phase 22's check of this family
        hold = remat_hold(torch, tr, counters, cfg, server.backbone, trained, batch,
                          f"{arch} ({n} layers, batch {tuple(batch.tokens.shape)})")
        launches.update({f"remat_{short}_{k}": v for k, v in hold.items()})

    # f32 on the same weights upcast, MOE_F32_LAYERS deep
    n32 = MOE_F32_LAYERS[arch]
    if cfg.moe is not None:
        moe_routing(torch, tr, sv, cfg, server, kw, reqs, trained, batch)
        cut = dict(server.backbone, layers=server.backbone["layers"][:n32])
        plain16, kernel16 = free_prefill_routes(sv["Engine"], cfg.with_(n_layers=n32), cut, kw,
                                                reqs)
        del cut
    cfg32, (routes, plain_routes) = f32_checks(torch, tr, sv, cfg, server, kw, reqs, trained,
                                               batch, n32, "moe")
    if cfg.moe is not None:
        plain32, kernel32 = free_prefill_routes(sv["Engine"], cfg32, server.backbone, kw, reqs)
        log(f"[moe] {arch} f32 ({n32} layers), kernels vs plain versions: expert choices "
            f"agree on {route_agreement(routes, plain_routes):.5f} of the (layer, token, "
            f"choice) picks of {len(reqs)} prefills (the plain run's own, given the kernel "
            f"run's choices in the layers before)")
        log(f"[moe] {arch} routing flips by layer, first {n32} layers, {len(reqs)} prefills, "
            f"free runs (share of picks that differ): bf16 kernels vs bf16 plain versions "
            f"{flips_by_layer(kernel16, plain16)}; bf16 plain versions vs f32 plain versions "
            f"on the same weights {flips_by_layer(plain16, plain32)}; f32 kernels vs f32 plain "
            f"versions {flips_by_layer(kernel32, plain32)}")
    f32_round(torch, tr, st, cfg32, server)
    del st, server, trained, batch
    torch.cuda.empty_cache()
    return launches


def free_prefill_routes(Engine, cfg, backbone, kw, reqs):
    """Prefill routing records of ``reqs``, on the plain versions and on the
    kernels, each run choosing its own experts. -> (plain, kernel records)."""
    engine = lambda: Engine(cfg, backbone, use_pallas_grouped=True, **kw)
    with plain_versions():
        _, plain = prefill_routes(engine(), reqs)
    return plain, prefill_routes(engine(), reqs)[1]


def f32_round(torch, tr, st, cfg32, server):
    """Round 0 of the FedNano run on the server's f32 weights, kernels against
    the plain versions (taking the kernel run's expert choices), its loss
    held at LOSS_TOL. The adapters are reported beside a witness: the same
    round by the model's use_pallas=False path, another f32 order of the
    same arithmetic, against the plain versions. AdamW's first steps move
    each entry by about lr·sign(g) whatever |g| (above eps 1e-8), so an
    entry whose gradient is at the f32 noise of either order can step the
    other way, and the Fisher merge divides by F + 1e-8 where F is that
    small; the counts beside each gap say how many entries moved how far."""
    from repro_torch.utils import tree_leaves

    kw = dict(strategy="fednano", hp=st["hp"], rounds=1, final_eval=False)
    run = lambda cfg: tr["run_federated"](0, cfg, st["train"], st["evald"],
                                          server=fresh_server(dataclasses.replace(server, cfg=cfg)),
                                          use_pallas=cfg.use_pallas, **kw)
    with recorded_routes() as routes:
        got = run(cfg32)
    with plain_versions(), replayed_routes(routes) as own:
        want = run(cfg32)
    with replayed_routes(routes):
        other = run(cfg32.with_(use_pallas=False))
    g, w = got.round_metrics[0]["mean_loss"], want.round_metrics[0]["mean_loss"]
    err = abs(g - w) / abs(w)
    if not math.isfinite(g) or err > LOSS_TOL["float32"]:
        raise AssertionError(f"{cfg32.name} f32 round 0, kernels vs plain versions: loss {g} vs "
                             f"{w} ({err:.3e}, bound {LOSS_TOL['float32']})")

    def gaps(a):
        uploads = max(tree_rel_err(x.adapters, y.adapters)
                      for x, y in zip(a.clients, want.clients))
        glob = (a.server.global_adapters, want.server.global_adapters)
        return (f"clients' uploads {uploads:.3e}, global adapters {tree_rel_err(*glob):.3e} of "
                f"‖ref‖∞ (entries more than 1e-3, 1e-1 of ‖ref‖∞ apart: "
                f"{far_entries(*glob, 1e-3)}, {far_entries(*glob, 1e-1)} of "
                f"{sum(t.numel() for t in tree_leaves(glob[1]))})")

    log(f"[train-check] {cfg32.name} f32 ({cfg32.n_layers} layers) round 0, kernels vs plain "
        f"versions: loss {g:.7f} vs {w:.7f} (rel {err:.3e}, bound {LOSS_TOL['float32']}"
        f"{replay_note(routes, own)}); {gaps(got)} (reported); witness, the use_pallas=False "
        f"path vs the plain versions: loss {other.round_metrics[0]['mean_loss']:.7f}, "
        f"{gaps(other)}")


def far_entries(got, want, rel) -> int:
    """Entries of the leaves of ``got`` more than ``rel`` of their leaf's
    ‖want‖∞ from ``want``."""
    from repro_torch.utils import tree_leaves

    return sum(int(((g.float() - w.float()).abs() > rel * float(w.abs().max())).sum())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def moe_routing(torch, tr, sv, cfg, server, kw, reqs, adapters, batch):
    """The MoE layers' routing in bf16, each run choosing its own experts:
    the (token, choice) pairs that the capacity dropped in each layer over
    the requests' prefills (pads included), on one decode step over every
    page, and on one training batch; and the share of expert choices on
    which the kernels' and the plain versions' prefills and training batch
    differ, by layer (a flipped choice changes the layers after it too)."""
    plain_routes, routes = free_prefill_routes(sv["Engine"], cfg, server.backbone, kw, reqs)
    eng = sv["Engine"](cfg, server.backbone, use_pallas_grouped=True, **kw)
    for r in reqs[:kw["max_slots"]]:
        eng.submit(r)
    eng._admit({})
    with recorded_routes() as decode_routes:
        eng._decode()
    with torch.no_grad():
        with recorded_routes() as train_routes:
            tr["fednano_loss"](cfg, server.backbone, adapters, batch)
        with plain_versions(), recorded_routes() as train_plain:
            tr["fednano_loss"](cfg, server.backbone, adapters, batch)
    decode_routes, train_routes, train_plain = [decode_routes], [train_routes], [train_plain]
    dec = dropped_by_layer(decode_routes)
    if any(dec):
        raise AssertionError(f"{cfg.name}: a decode step routes each page alone and drops no "
                             f"choice, but dropped {dec}")
    K, C = cfg.moe.top_k, routes[0][0].capacity
    log(f"[moe] {cfg.name} bf16 dropped (token, choice) pairs by layer: {len(reqs)} prefills of "
        f"{kw['prefill_len']} positions, pads included (capacity {C} a group of "
        f"{kw['prefill_len']}, {len(reqs) * kw['prefill_len'] * K} choices a layer): "
        f"{dropped_by_layer(routes)}; one decode step over {kw['max_slots']} pages, each routed "
        f"alone (capacity {decode_routes[0][0].capacity}): {dec}; one training batch "
        f"{tuple(batch.tokens.shape)} as one group (capacity {train_routes[0][0].capacity}): "
        f"{dropped_by_layer(train_routes)}")
    log(f"[moe] {cfg.name} bf16 free runs, kernels vs plain versions: expert choices agree on "
        f"{route_agreement(routes, plain_routes):.5f} of the (layer, token, choice) picks of "
        f"{len(reqs)} prefills, flips by layer {flips_by_layer(routes, plain_routes)}; on the "
        f"trained adapters' first training batch {route_agreement(train_routes, train_plain):.5f}"
        f", flips by layer {flips_by_layer(train_routes, train_plain)}")


def flips_by_layer(a, b):
    """Share of each layer's expert picks on which two runs differ; ``a`` and
    ``b`` hold one list of per-layer records a call."""
    return [f"{1 - route_agreement([[x[i]] for x in a], [[y[i]] for y in b]):.4f}"
            for i in range(len(a[0]))]


def dropped_by_layer(routes):
    """Dropped (token, choice) pairs of each layer, summed over the calls."""
    return [sum(int((~call[i].keep).sum()) for call in routes) for i in range(len(routes[0]))]


def route_agreement(a, b) -> float:
    """Share of (layer, token, choice) expert picks on which two runs agree."""
    same = total = 0
    for call_a, call_b in zip(a, b):
        for x, y in zip(call_a, call_b):
            same += int((x.idx == y.idx).sum())
            total += x.idx.numel()
    return same / total


def moe_timings(torch, F, fa_ops, fa_ref):
    """The flash kernel at the new paths' prefill shapes, head dim 128 on 8 KV
    heads, bf16: grok-1's 48 heads with its softcap of 30 (no SDPA beside
    it), llama4-scout's 40 (GQA 5) and qwen2-vl's 64 over 64 patches + 128."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for label, (s_, h, cap) in (("grok prefill", (128, 48, 30.0)),
                                ("llama4 prefill", (128, 40, 0.0)),
                                ("qwen2-vl prefill", (192, 64, 0.0))):
        q = torch.randn((1, s_, h, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((1, s_, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out[label] = flash_timing(torch, F, fa_ops, fa_ref, q, k, v, f" ({label})",
                                  softcap=cap)
    return out


# ---------------------------------------------------------------------------
# the last two families: recurrentgemma-9b (hybrid) and whisper-base (audio)
# ---------------------------------------------------------------------------

def new_family_arch(torch, tr, sv, counters, arch):
    """recurrentgemma-9b or whisper-base at published width and depth, bf16
    weights from seed 0, then the same weights upcast to f32 in place.
    -> launches per kernel by path."""
    from repro_torch.utils import tree_leaves

    cfg = tr["get_config"](arch).with_(use_pallas=True)
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(server.backbone))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(server.backbone))
    if arch == RGEMMA:
        shape = (f"{cfg.n_layers} layers = {len(server.backbone['triples'])} (rec, rec, attn) "
                 f"triples + {len(server.backbone['extras'])} rec, d_rnn {cfg.rglru.d_rnn}, "
                 f"conv {cfg.rglru.conv_width}, local window {cfg.rglru.local_window}")
    else:
        shape = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
                 f"{cfg.enc_seq_len} frames, {cfg.norm}, {cfg.pos_type} positions "
                 f"({cfg.max_seq_len} rows)")
    log(f"[new] {arch} backbone at published width and depth: {n_params / 1e9:.4f} B params, "
        f"{n_bytes / 1e9:.3f} GB of {cfg.dtype} weights ({shape}; d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff} {cfg.act}, vocab {cfg.vocab_size}); drawn in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    short = arch.split("-")[0]
    launches = {}

    # serving: 16 requests of 4 tenants and base traffic
    names = [f"tenant{i}" for i in range(4)]
    tenants = sv["synth"](0, cfg, names, "cuda")
    kw = dict(NEW_SERVE_KW[arch], adapter_loader=tenants.__getitem__)
    reqs = serve_requests(arch, cfg, names, sv["make_requests"], kw, 0)
    frames = reqs[0].patches.shape if reqs[0].patches is not None else None
    log(f"[serve] {arch}: prompt lengths {[len(r.prompt) for r in reqs]}, prefill_len "
        f"{kw['prefill_len']}, frames a request {frames}, tenants {[r.tenant for r in reqs]}")
    launches[f"serve_{short}"], *_ = serve_main_path(torch, cfg, server.backbone, sv["Engine"],
                                                     counters, kw, reqs, arch)
    torch.cuda.empty_cache()

    # training: FedNano 2 clients x 2 rounds, and one agg_chunk=1 round
    st, train_launches = training_full(torch, tr, counters, arch=arch, server=server)
    launches.update(train_launches)
    trained, batch = st["res"].server.global_adapters, st["train"][0][0]
    run_vs_plain(torch, tr, st, held=1)
    loop_timings(torch, tr, st)
    if arch in REMAT_HOLD_ARCHS:  # phase 22's check of this family
        hold = remat_hold(torch, tr, counters, cfg, server.backbone, trained, batch,
                          f"{arch} ({cfg.n_layers} layers, batch {tuple(batch.tokens.shape)})")
        launches.update({f"remat_{short}_{k}": v for k, v in hold.items()})

    # f32 on the same weights upcast in place, at full depth
    picked = [reqs[i] for i in NEW_F32_REQUESTS.get(arch, range(len(reqs)))]
    cfg32, _ = f32_checks(torch, tr, sv, cfg, server, kw, picked, trained, batch, cfg.n_layers,
                          "new")
    log(f"[new] {arch} f32 at full depth: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated; the f32 prefill check took requests {[r.rid for r in picked]} (prompts "
        f"{[len(r.prompt) for r in picked]})")
    if arch == RGEMMA:
        ring_decode_check(torch, tr, cfg32, server.backbone, RGEMMA_RING_CHECK)
    del st, server, trained, batch
    torch.cuda.empty_cache()
    return launches


def new_family_timings(torch, F, fa_ops, fa_ref, lora_ops, lora_ref, harness):
    """The flash kernel at recurrentgemma's head dim 256 (16 heads on one KV
    head, its 2,048 window: the serving prefill, the training batch and a
    4,096-position forward where the window masks keys) and whisper's
    decoder at head dim 64 (8 heads, MHA), beside SDPA (with the band mask
    where the window masks keys) and the bound; the LoRA kernel over whisper's 4 x 1,500
    training frames and one request's 1,500 at d_model 512, and the grouped
    kernel at its decode step. -> (flash rows, LoRA rows, the grouped row)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    flash = {}
    for label, b, s_, _, h, hkv, hd, _, window, cap, _, _ in (harness.HYBRID_FLASH_SHAPES
                                                             + harness.AUDIO_FLASH_SHAPES):
        q = torch.randn((b, s_, h, hd), generator=gen, device="cuda").to(bf16)
        k, v = (torch.randn((b, s_, hkv, hd), generator=gen, device="cuda").to(bf16)
                for _ in range(2))
        flash[label] = flash_timing(torch, F, fa_ops, fa_ref, q, k, v, f" ({label})",
                                    window=window, softcap=cap)
    lora = {}
    for t, d, r, _ in harness.NEW_FAMILY_LORA_SHAPES[:2]:
        x = torch.randn((t, d), generator=gen, device="cuda").to(bf16)
        A = torch.randn((d, r), generator=gen, device="cuda") * 0.05
        Bm = torch.randn((r, d), generator=gen, device="cuda") * 0.05
        lora[f"whisper frames x ({t}, {d})"] = lora_timing(torch, lora_ops, lora_ref, x, A, Bm,
                                                           " (whisper-base frames)")
    _, d, r, n, _ = harness.AUDIO_GROUPED_SHAPES[0]
    grouped = grouped_timing(torch, lora_ops, lora_ref, gen, d, [0, 1, 2, 3, 0, 1, 2, -1],
                             " (whisper-base)", r=r, N=n)
    return flash, lora, grouped


# ---------------------------------------------------------------------------
# phase 17: resume under failures, checkpoint-loaded tenants, the naive loop
# ---------------------------------------------------------------------------

# FedNano with 3 clients at llava's training shape for RESUME_ROUNDS rounds,
# cut after RESUME_CUT and resumed. The failure seed was picked on the CPU
# (the schedule is the same on every device) so that round 0 holds a drop and
# a crash, rounds 1-2 another of each, and every round a survivor:
# [[drop, run, crash], [run, drop, run], [run, crash, drop]] over cids 0-2.
RESUME_ROUNDS, RESUME_CUT = 3, 1
RESUME_DATA = dict(TRAIN_DATA, n_clients=3)
FAILURE_KW = dict(dropout_prob=0.3, crash_prob=0.3, seed=2)
# resumed against uninterrupted, relative (JAX tests/test_resume.py)
RESUME_TOL = 1e-6
# a token the engine and the naive loop choose apart in f32 passes only where
# the reference's top-2 logits are closer than this share of ‖logits‖∞
NEAR_TIE = 1e-4


def failure_schedule(fm, n_clients, rounds):
    """[[drop | crash | run per cid] per round] of a FailureModel."""
    return [["drop" if fm.drops(c, r) else "crash" if fm.crashes(c, r) else "run"
             for c in range(n_clients)] for r in range(rounds)]


def tree_gap(got, want) -> float:
    """max |got - want| / ‖want‖∞ over two trees' leaves, paired by path."""
    from repro_torch.utils import tree_flatten_with_path

    g, w = dict(tree_flatten_with_path(got)), dict(tree_flatten_with_path(want))
    if sorted(g) != sorted(w):
        raise AssertionError(f"trees differ in their leaves: {sorted(g)} vs {sorted(w)}")
    return max(float((g[k].float().cpu() - w[k].float().cpu()).abs().max())
               / max(float(w[k].float().abs().max()), 1e-30) for k in w)


@contextlib.contextmanager
def timed_snapshots():
    """Time every RunState save and load of the round engine: -> {"save": [s],
    "load": [s]}."""
    from repro_torch.core import federated

    spent = {"save": [], "load": []}
    real = {"save": federated.save_run_state, "load": federated.load_run_state}

    def timed(kind):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[kind](*a, **kw)
            spent[kind].append(time.perf_counter() - t0)
            return out
        return call

    federated.save_run_state, federated.load_run_state = timed("save"), timed("load")
    try:
        yield spent
    finally:
        federated.save_run_state, federated.load_run_state = real["save"], real["load"]


def resume_runs(tr, cfg, server, train, evald, hp, failures, root):
    """RESUME_ROUNDS rounds uninterrupted, RESUME_CUT rounds into ``root``/cut,
    then a resume from there to RESUME_ROUNDS; every run snapshots each round.
    -> (uninterrupted, resumed)."""
    def run(**kw):
        return tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp,
                                   use_pallas=True, failures=failures, checkpoint_every=1,
                                   server=fresh_server(server), final_eval=False, **kw)

    full = run(rounds=RESUME_ROUNDS, checkpoint_dir=str(Path(root) / "full"))
    run(rounds=RESUME_CUT, checkpoint_dir=str(Path(root) / "cut"))
    resumed = run(rounds=RESUME_ROUNDS, checkpoint_dir=str(Path(root) / "cut"),
                  resume=str(Path(root) / "cut"))
    return full, resumed


def hold_resume(full, resumed, what, tol=RESUME_TOL):
    """Raise unless the resumed run equals the uninterrupted one: round
    losses within ``tol`` relative, participants, drops, crashes and comm
    totals equal, global and client adapters within ``tol`` of ‖ref‖∞.
    -> the largest gap."""
    fl = [m["mean_loss"] for m in full.round_metrics]
    rl = [m["mean_loss"] for m in resumed.round_metrics]
    counts = lambda res: [(m["participants"], m["dropped"], m["crashed"])
                          for m in res.round_metrics]
    gaps = [abs(a - b) / abs(a) for a, b in zip(fl, rl) if a is not None]
    gaps.append(tree_gap(resumed.server.global_adapters, full.server.global_adapters))
    gaps += [tree_gap(r.adapters, f.adapters) for f, r in zip(full.clients, resumed.clients)]
    if (len(fl) != len(rl) or [a is None for a in fl] != [b is None for b in rl]
            or counts(full) != counts(resumed) or full.comm_totals != resumed.comm_totals
            or max(gaps) > tol or not all(math.isfinite(x) for x in fl if x is not None)):
        raise AssertionError(f"{what}: resumed run differs from the uninterrupted one: losses "
                             f"{rl} vs {fl}, counts {counts(resumed)} vs {counts(full)}, comm "
                             f"{resumed.comm_totals} vs {full.comm_totals}, largest gap "
                             f"{max(gaps):.3e} (bound {tol})")
    return max(gaps)


def resume_smoke(torch, tr):
    """Smoke llava, 3 clients under the failure schedule, f32: resumed against
    uninterrupted on the card and on the CPU, then card against CPU (losses
    1e-5, counts and comm equal, the global and the clients' adapters each at
    ROUNDING_MARGIN times their spread over two CPU f32 orders and f64)."""
    from repro_torch.core import FailureModel
    from repro_torch.utils import tree_map

    cfg = tr["get_smoke_config"]("llava-1.5-7b").with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    data_kw = dict(n_clients=3, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
    fm = FailureModel(**FAILURE_KW)
    server_cpu = tr["init_server"](cfg, seed=3, device="cpu")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            server = server_cpu if dev == "cpu" else dataclasses.replace(
                server_cpu, backbone=tree_map(lambda t: t.to(dev), server_cpu.backbone),
                global_adapters=tree_map(lambda t: t.to(dev), server_cpu.global_adapters))
            train, evald, _ = tr["make_federated_data"](cfg, device=dev, **data_kw)
            runs[dev] = resume_runs(tr, cfg, server, train, evald, hp, fm, f"{tmp}/{dev}")
            hold_resume(*runs[dev], f"smoke llava {dev}")
    (_, gpu), (_, cpu) = runs["cuda"], runs["cpu"]
    gl = [m["mean_loss"] for m in gpu.round_metrics]
    cl = [m["mean_loss"] for m in cpu.round_metrics]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl) if b is not None)
    counts = [[(m["participants"], m["dropped"], m["crashed"]) for m in r.round_metrics]
              for r in (gpu, cpu)]
    f64 = f64_run(tr, cfg, server_cpu, data_kw, "fednano", hp, rounds=RESUME_ROUNDS,
                  failures=fm, final_eval=False)
    cfg_p = cfg.with_(use_pallas=False)
    train, evald, _ = tr["make_federated_data"](cfg_p, device="cpu", **data_kw)
    other = tr["run_federated"](0, cfg_p, train, evald, strategy="fednano", hp=hp,
                                rounds=RESUME_ROUNDS, use_pallas=False, failures=fm,
                                server=fresh_server(server_cpu), final_eval=False)

    # Each tree is held at ROUNDING_MARGIN times its spread on the CPU: the
    # largest gap between two of the kernels' plain order, the model's
    # use_pallas=False order (both f32) and f64. AdamW's ill-conditioned
    # steps part the two f32 orders by 3.8e-4 on a client's adapters, more
    # than SMOKE_ADAPTER_TOL, so that bound is not applied here.
    pairs = {"plain vs f64": adapter_gaps(cpu, f64), "use_pallas=False vs f64":
             adapter_gaps(other, f64), "plain vs use_pallas=False": adapter_gaps(cpu, other)}
    spread = [max(g[t] for g in pairs.values()) for t in (0, 1)]
    bound = [max(1e-5, ROUNDING_MARGIN * w) for w in spread]
    e_glob, e_own = adapter_gaps(gpu, cpu)
    held = (f"global adapters {e_glob:.3e} (bound {bound[0]:.3e}), the clients' {e_own:.3e} "
            f"(bound {bound[1]:.3e}); CPU spread (global, clients): "
            + ", ".join(f"{k} ({g[0]:.3e}, {g[1]:.3e})" for k, g in pairs.items()))
    if (loss_err > 1e-5 or counts[0] != counts[1] or gpu.comm_totals != cpu.comm_totals
            or e_glob > bound[0] or e_own > bound[1]):
        raise AssertionError(f"smoke resume, card vs CPU: losses {gl} vs {cl} ({loss_err:.3e}), "
                             f"counts {counts}, comm {gpu.comm_totals} vs {cpu.comm_totals}, "
                             f"{held}")
    log(f"[resume-smoke] smoke llava fednano f32, 3 clients x {RESUME_ROUNDS} rounds, cut at "
        f"{RESUME_CUT} and resumed, schedule {failure_schedule(fm, 3, RESUME_ROUNDS)}: card vs "
        f"CPU round losses {gl} vs {cl} (max rel {loss_err:.3e}, bound 1e-5); (participants, "
        f"dropped, crashed) {counts[0]} on both; comm totals equal; {held}")


def cli_smoke():
    """The CLIs on the card at smoke size: train under crashes with a snapshot
    a round, resume it, serve its server checkpoint, then the naive check."""
    import io

    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        out, root = Path(tmp) / "run", Path(tmp) / "tenants"
        common = ["--device", "cuda", "--use-pallas", "--clients", "3", "--local-steps", "1",
                  "--examples-per-client", "8", "--batch-size", "4", "--seq-len", "16",
                  "--checkpoint-every", "1", "--crash-prob", "0.3", "--failure-seed", "2",
                  "--out", str(out)]
        serve_args = ["--device", "cuda", "--pallas-grouped", "--naive", "--requests", "8",
                      "--gen-tokens", "6"]
        steps = (("train --rounds 2", train_cli.main, common + ["--rounds", "2"]),
                 ("train --resume", train_cli.main,
                  common + ["--rounds", "3", "--resume", str(out / "state")]),
                 ("serve --ckpt-root --naive", serve_cli.main,
                  serve_args + ["--ckpt-root", str(root)]),
                 ("serve --naive", serve_cli.main, serve_args))
        for label, main_fn, args in steps:
            if label.startswith("serve --ckpt-root"):
                root.mkdir()
                (out / "ckpt").rename(root / "fednano")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = main_fn(args)
            lines = text.getvalue().splitlines()
            if rc != 0 or (label.startswith("serve")
                           and not any("token parity OK" in ln for ln in lines)):
                raise AssertionError(f"{label}: exit {rc}, output {lines}")
            if label == "train --resume" and not any("resumed at round 2" in ln for ln in lines):
                raise AssertionError(f"{label} did not resume: {lines}")
            shown = [ln.strip() for ln in lines if "round" in ln or "parity" in ln
                     or "serving" in ln]
            log(f"[resume-cli] {label}: exit 0; {' | '.join(shown)}")


def resume_llava(torch, tr, counters, st, root):
    """Full-width llava FedNano with 3 clients under the failure schedule,
    uninterrupted against cut and resumed, kernels on, counters reset just
    before the three runs and read just after. -> (launches, the resumed
    run, the bf16 gap)."""
    from repro_torch.core import FailureModel

    cfg, server, hp = st["cfg"], st["server"], st["hp"]
    fm = FailureModel(**FAILURE_KW)
    schedule = failure_schedule(fm, RESUME_DATA["n_clients"], RESUME_ROUNDS)
    cut, rest = sum(schedule[:RESUME_CUT], []), sum(schedule[RESUME_CUT:], [])
    if not all(k in part for part in (cut, rest) for k in ("drop", "crash")):
        raise AssertionError(f"failure schedule {schedule} lacks a drop or a crash on a side "
                             f"of the cut at {RESUME_CUT}")
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **RESUME_DATA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with timed_snapshots() as spent:
        full, resumed = resume_runs(tr, cfg, server, train, evald, hp, fm, f"{root}/bf16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    gap = hold_resume(full, resumed, f"{cfg.name} bf16")
    for name in TRAINING_KERNELS_BY_ARCH[cfg.name]:
        if not launches[name]:
            raise AssertionError(f"the {name} kernel never launched on the resume path: "
                                 f"{launches}")
    snap = Path(root) / "bf16" / "cut" / f"round_{RESUME_CUT:06d}"
    snap_bytes = sum(f.stat().st_size for f in snap.iterdir())
    log(f"[resume] {cfg.name} bf16 fednano, 3 clients x {RESUME_ROUNDS} rounds x "
        f"({hp.local_steps} steps + {hp.fisher_batches} Fisher batches), batch 4 x (64 patches "
        f"+ 32 tokens), failure schedule {schedule} (FailureModel {fm.to_dict()}): "
        f"uninterrupted vs cut at {RESUME_CUT} + resume: round losses "
        f"{[m['mean_loss'] for m in full.round_metrics]} vs "
        f"{[m['mean_loss'] for m in resumed.round_metrics]}, (participants, dropped, crashed) "
        f"{[(m['participants'], m['dropped'], m['crashed']) for m in full.round_metrics]}, comm "
        f"{full.comm_totals} equal; largest gap {gap:.3e} (bound {RESUME_TOL}; zero: "
        f"{gap == 0.0})")
    log(f"[resume] {cfg.name} snapshots: {len(spent['save'])} saves of "
        f"{snap_bytes / 1e6:.3f} MB each ({len(list(snap.iterdir()))} files), save "
        f"{1e3 * min(spent['save']):.1f}-{1e3 * max(spent['save']):.1f} ms, load "
        f"{', '.join(f'{1e3 * x:.1f}' for x in spent['load'])} ms; the three runs {wall:.3f} s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
        f"{json.dumps(launches)}")
    return launches, resumed


def naive_llava(torch, tr, sv, counters, cfg, backbone, resumed, root):
    """The resumed run's global and client adapters written as bare
    ``<tenant>.npz`` files and served, 16 requests of the 4 tenants and base
    traffic, through ``ServingEngine`` with ``checkpoint_adapter_loader`` and
    through ``generate_naive`` with the same adapters, each with its counters
    reset just before and read just after. -> (launches by path, requests,
    adapters by tenant)."""
    from repro_torch.checkpoint import save_pytree
    from repro_torch.serving import checkpoint_adapter_loader, generate_naive
    from repro_torch.utils import tree_map

    adapters = {"global": resumed.server.global_adapters,
                **{f"client{c.cid}": c.adapters for c in resumed.clients}}
    for name, tree in adapters.items():
        save_pytree(f"{root}/{name}.npz", tree)
    loader = checkpoint_adapter_loader(cfg, root)
    tenants = {name: tree_map(lambda t: t.to("cuda"), loader(name)) for name in adapters}
    gap = max(tree_gap(tenants[n], adapters[n]) for n in adapters)
    if gap != 0.0:
        raise AssertionError(f"adapters read back from {root} differ from those written: {gap}")
    names = sorted(adapters)
    kw = dict(SERVE_KW[cfg.name], adapter_loader=loader)
    reqs = sv["make_requests"](cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], 0)
    # warm-up of both paths
    sv["Engine"](cfg, backbone, use_pallas_grouped=True, **kw).run(
        [dataclasses.replace(r, max_new_tokens=2) for r in reqs[:2]])
    generate_naive(cfg, backbone, [dataclasses.replace(reqs[0], max_new_tokens=2)], tenants)
    torch.cuda.synchronize()

    def measured(fn):
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()},
                torch.cuda.max_memory_allocated())

    eng = sv["Engine"](cfg, backbone, use_pallas_grouped=True, **kw)
    done, wall_e, launches_e, peak_e = measured(lambda: eng.run(reqs))
    ref, wall_n, launches_n, peak_n = measured(lambda: generate_naive(cfg, backbone, reqs,
                                                                      tenants))
    for got in (done, ref):
        for r in reqs:
            toks = got[r.rid].tokens
            if len(toks) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"request {r.rid}: tokens {toks}")
    if eng.cache.stats()["misses"] != len(names) or not all(
            launches_e[n] for n in SERVING_KERNELS_BY_ARCH[cfg.name]):
        raise AssertionError(f"engine over checkpoint tenants: cache {eng.cache.stats()}, "
                             f"launches {launches_e}")
    if not (launches_n["lora_residual"] and launches_n["flash_attention"]) \
            or launches_n["grouped_lora_residual"]:
        raise AssertionError(f"the naive loop's kernels: {launches_n}")
    n_tok = sum(len(c.tokens) for c in done.values())
    log(f"[naive] {cfg.name} {cfg.dtype}, 16 requests of tenants {names} and base traffic "
        f"(adapters from {len(names)} .npz files), prefill_len {kw['prefill_len']}, "
        f"{kw['max_new_tokens']} new tokens, {kw['max_slots']} pages, on {card_line()}: engine "
        f"{n_tok} tokens in {wall_e:.3f} s ({n_tok / wall_e:.1f} tokens/s, peak "
        f"{peak_e / 2**30:.2f} GiB) | naive loop {wall_n:.3f} s ({n_tok / wall_n:.1f} tokens/s, "
        f"peak {peak_n / 2**30:.2f} GiB) | engine speedup {wall_n / wall_e:.2f}x | engine vs "
        f"naive: {agreement(reqs, done, ref)} | launches engine {json.dumps(launches_e)}, naive "
        f"{json.dumps(launches_n)}")
    return {"ckpt_serve_llava": launches_e, "naive_llava": launches_n}, reqs, tenants


def teacher_forced_gap(torch, cfg, backbone, req, adapters, tokens, k):
    """Top-2 gap of the logits that choose token ``k`` of ``req`` given its
    first ``k`` tokens (one full forward), relative to ‖logits‖∞."""
    import numpy as np

    from repro_torch.core import adapters as nano
    from repro_torch.core.types import Batch
    from repro_torch.models import model as model_lib

    ids = np.concatenate([np.asarray(req.prompt, np.int64), np.asarray(tokens[:k], np.int64)])
    t = torch.from_numpy(ids[None]).to("cuda")
    patches = torch.as_tensor(np.asarray(req.patches, np.float32)[None], device="cuda")
    batch = Batch(tokens=t, labels=torch.zeros_like(t),
                  mask=torch.zeros(t.shape, dtype=torch.float32, device="cuda"), patches=patches)
    with torch.no_grad():
        embeds, positions, _, _, enc = nano.nanoedge_forward(cfg, backbone, adapters, batch)
        hidden, _ = model_lib.forward(cfg, backbone, embeds, positions, enc)
        lg = model_lib.logits(cfg, backbone, hidden[:, -1:])[0, 0].float()
    top2 = torch.topk(lg, 2).values
    return float(top2[0] - top2[1]) / float(lg.abs().max())


def naive_f32(torch, sv, cfg, backbone, reqs, tenants):
    """On the weights upcast to f32: the engine against ``generate_naive``,
    every token equal, or each request's first difference a near tie of the
    reference (top-2 gap under NEAR_TIE of ‖logits‖∞)."""
    from repro_torch.serving import generate_naive

    kw = dict(SERVE_KW[cfg.name], adapter_loader=tenants.__getitem__)
    done = sv["Engine"](cfg, backbone, use_pallas_grouped=True, **kw).run(reqs)
    ref = generate_naive(cfg, backbone, reqs, tenants)
    identity = {m: {n: torch.zeros_like(t) for n, t in d.items()}
                for m, d in next(iter(tenants.values())).items()}
    ties = []
    for r in reqs:
        a, b = done[r.rid].tokens, ref[r.rid].tokens
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = teacher_forced_gap(torch, cfg, backbone, r, tenants.get(r.tenant, identity), b, k)
        if gap >= NEAR_TIE:
            raise AssertionError(f"f32 request {r.rid}: engine {a} vs naive {b} part at {k}, "
                                 f"where the top-2 logits are {gap:.3e} of ‖logits‖∞ apart "
                                 f"(a near tie needs < {NEAR_TIE})")
        ties.append((r.rid, k, gap))
    log(f"[naive] {cfg.name} f32 (weights upcast in place), engine vs naive loop: "
        f"{agreement(reqs, done, ref)}; differing requests (rid, first position, top-2 gap): "
        f"{ties or 'none'}")


def naive_timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref):
    """The naive loop's new kernel shapes: LoRA at one row of llava's width
    (each decoded token's text adapter), flash at an unpadded prefill of 64
    patches and 3 prompt tokens. -> (LoRA rows, flash rows)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    x = torch.randn((1, 4096), generator=gen, device="cuda").to(bf16)
    A = torch.randn((4096, 64), generator=gen, device="cuda") * 0.05
    Bm = torch.randn((64, 4096), generator=gen, device="cuda") * 0.05
    lora = {"naive x (1, 4096)": lora_timing(torch, lora_ops, lora_ref, x, A, Bm,
                                             " (the naive loop's decode token)")}
    q, k, v = (torch.randn((1, 67, 32, 128), generator=gen, device="cuda").to(bf16)
               for _ in range(3))
    flash = {"naive prefill (1, 67)": flash_timing(torch, F, fa_ops, fa_ref, q, k, v,
                                                   " (the naive loop's unpadded prefill)")}
    return lora, flash


def resume_naive_phase(torch, tr, sv, counters, st):
    """Phase 17 on the llava server of phases 8-11: -> launches by path. The
    backbone is upcast to f32 in place on the way; nothing uses it after."""
    from repro_torch.core import FailureModel

    t0 = time.perf_counter()
    resume_smoke(torch, tr)
    cli_smoke()
    with tempfile.TemporaryDirectory() as tmp:
        launches, resumed = resume_llava(torch, tr, counters, st, tmp)
        launches = {"resume_llava": launches}
        root = Path(tmp) / "tenants"
        root.mkdir()
        cfg, server = st["cfg"], st["server"]
        more, reqs, tenants = naive_llava(torch, tr, sv, counters, cfg, server.backbone,
                                                resumed, str(root))
        launches.update(more)
        del resumed
        torch.cuda.empty_cache()
        upcast_in_place(torch, server.backbone, cfg.n_layers)
        cfg32 = cfg.with_(dtype="float32")
        server32 = dataclasses.replace(server, cfg=cfg32)
        naive_f32(torch, sv, cfg32, server.backbone, reqs, tenants)
        train, evald, _ = tr["make_federated_data"](cfg32, device="cuda", **RESUME_DATA)
        full, resumed = resume_runs(tr, cfg32, server32, train, evald, st["hp"],
                                    FailureModel(**FAILURE_KW), f"{tmp}/f32")
        gap = hold_resume(full, resumed, f"{cfg.name} f32")
        log(f"[resume] {cfg.name} f32 (weights upcast in place), the same runs: round losses "
            f"{[m['mean_loss'] for m in full.round_metrics]}; largest gap {gap:.3e} (bound "
            f"{RESUME_TOL}; zero: {gap == 0.0})")
    log(f"[phase17] resume, checkpoint tenants and the naive loop: "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the vmap and buffered round engines
# ---------------------------------------------------------------------------

# Full width: 4 clients of phase 8's data (llava-1.5-7b, batch 4 x (64
# patches + 32 tokens)), whose first two batches are whole for every client,
# as the vmap engine's stacked steps need.
COHORT_DATA = dict(TRAIN_DATA, n_clients=4)
# 18b's f32 half on the first 8 of the 32 layers upcast (f32 GEMMs without
# TF32 bound its steps; cut to keep the script inside its time)
COHORT_F32_LAYERS = 8
COHORT_SMOKE_DATA = dict(n_clients=4, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
COHORT_SMOKE_STRATEGIES = ("fednano", "fedprox", "feddpa_f")
# 18c: buffer of 2 completions, 4 merges, a straggling draw of 0.3 a dispatch
BUFFERED_RUN = dict(buffer_size=2, rounds=4)
BUFFERED_FAILURES = dict(straggler_prob=0.3, seed=2)
SMOKE_FAILURES = dict(dropout_prob=0.2, crash_prob=0.2, straggler_prob=0.3, seed=2)
COHORT_KERNELS = ("lora_residual_many", "flash_attention", "fisher_merge")
# Adapters after two rounds, card against CPU: phase 17a's bound (ROUNDING_MARGIN
# times the CPU's spread) on all but a few elements. AdamW's first steps move
# an element by lr·m/(√v + eps), and where m/√v sits on a cancellation any f32
# order moves it apart: under FedDPA-F, element 61 of text/up parts the card's
# vmap run from the CPU's by 3.19e-4 of ‖ref‖∞ in every client, 5.7e-5 for the
# card's sequential engine, 8.0e-5 for the CPU's f32 against f64, while the
# other 1,023 elements of the leaf stay within 1e-5 (H100 80GB HBM3, 700 W).
# So at most ADAPTER_OUTLIER_SHARE of the elements may pass that bound, and
# none ADAPTER_GROSS_TOL or ROUNDING_MARGIN times the bound, whichever is
# larger (at full width in f32 two f32 orders of the sequential engine part
# by 5.8e-2 after two rounds, and the vmap engine's largest gap, 0.158, is in
# 10 of 5,242,880 elements); a fault moves many elements, and by about lr.
ADAPTER_OUTLIER_SHARE = 1e-3
ADAPTER_GROSS_TOL = 1e-3


def slow_client0(cid, version):
    """The buffered engine's latency: client 0 takes 3 ticks, the others 1."""
    return 3 if cid == 0 else 1


def many_parity(torch, harness, lora_ops, lora_ref):
    """lora_residual_many (one call over K clients) against its plain version
    at the harness's cohort grids, f32 and bf16; bf16 against the split-TF32
    model; f32 rows bit-identical to the one-adapter kernel's; gradients
    (dx by the batched kernel, dA and dB by bmm) against autograd through
    the plain version. -> {kernel: max |err| at llava's text cohort, bf16}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)

    def inputs(k, t, d, r, dtype):
        return ((torch.randn((k, t, d), generator=gen, device=dev)).to(dtype),
                torch.randn((k, d, r), generator=gen, device=dev) * 0.05,
                torch.randn((k, r, d), generator=gen, device=dev) * 0.05)

    main_err, n_cases, model_gap = {}, 0, [0.0, 0.0]
    shapes = (harness.MANY_LORA_SHAPES + harness.FULL_MANY_LORA_SHAPES
              + harness.MANY_LORA_EDGE_SHAPES + harness.HETERO_MANY_LORA_SHAPES)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for k, t, d, r in shapes:
            x, down, up = inputs(k, t, d, r, dtype)
            before = lora_ops.lora_residual_many.launches
            got = lora_ops.lora_residual_many(x, down, up, scale=SCALE)
            if lora_ops.lora_residual_many.launches != before + 1:
                raise AssertionError("lora_residual_many: one call must count one launch")
            what = f"lora_many k{k}t{t}d{d}r{r}"
            err = harness.check_close(
                got, lora_ref.lora_residual_many(x, down, up, scale=SCALE), dtype_name, what)
            if dtype_name == "float32":
                one = torch.stack([lora_ops.lora_residual(x[i], down[i], up[i], scale=SCALE)
                                   for i in range(k)])
                if not torch.equal(got, one):
                    raise AssertionError(f"{what}: f32 rows differ from the one-adapter kernel")
            else:
                model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
                harness.check_close(got, model, dtype_name, f"{what} vs model",
                                    harness.BF16_MODEL_TOLERANCES)
                harness.check_share(got, model, harness.LORA_MODEL_MAX_SHARE, f"{what} vs model")
                model_gap = [max(a, b) for a, b in zip(model_gap, rel_gap(got, model))]
            if (k, t, d, r) == harness.FULL_MANY_LORA_SHAPES[0] and dtype_name == "bfloat16":
                main_err["lora_residual_many"] = err
            n_cases += 1
        for k, t, d, r in harness.MANY_LORA_GRAD_SHAPES:
            x, down, up = inputs(k, t, d, r, dtype)
            before = lora_ops.lora_residual_many.dx_launches
            got = sq_loss_grads(lambda a, b, c: lora_ops.lora_residual_many(a, b, c, scale=SCALE),
                                x, down, up)
            if lora_ops.lora_residual_many.dx_launches != before + 1:
                raise AssertionError("lora_residual_many: the backward's dx is one launch")
            want = sq_loss_grads(lambda a, b, c: lora_ref.lora_residual_many(a, b, c,
                                                                             scale=SCALE),
                                 x, down, up)
            for name, g, w in zip(("dx", "dA", "dB"), got, want):
                err = harness.check_close(g, w, dtype_name, f"lora_many grad {name} k{k}t{t}")
                if (k, t, d, r) in harness.FULL_MANY_LORA_SHAPES:
                    key = f"lora_residual_many {name} {dtype_name}"
                    main_err[key] = max(main_err.get(key, 0.0), err)
            n_cases += 1
    torch.cuda.synchronize()
    log(f"[parity] lora_residual_many: {n_cases} kernel-vs-plain cases passed (cohorts "
        f"{[s[:2] for s in harness.FULL_MANY_LORA_SHAPES]} at d 4096 and the tile edges, f32 "
        f"rows bit-identical to the one-adapter kernel, gradients at "
        f"{harness.MANY_LORA_GRAD_SHAPES}); bf16 vs its rounding model max |err| / "
        f"max(1, ‖ref‖∞) {model_gap[0]:.3e}, elements that differ {model_gap[1]:.3e}; "
        f"max |err| {json.dumps(main_err)}")
    return main_err


def many_timing(torch, lora_ops, lora_ref, x, A, B, what=""):
    """lora_residual_many at x (K, T, D) bf16 beside its plain version,
    torch.baddbmm(x, torch.bmm(x, A), B) with the adapters in bf16 (the
    library call), K launches of the one-adapter kernel, and its bound: x
    read and y written once, the K adapters read once, 10·K·T·D·r split-TF32
    operations at the TF32 rate (row 1's count). -> a kernel-table row."""
    K, T, D = x.shape
    r = A.shape[-1]
    y = lora_ops.lora_residual_many(x, A, B, scale=SCALE)
    A16, B16 = A.to(torch.bfloat16), B.to(torch.bfloat16)
    k_ms, k_is = time_ms(torch, lambda: lora_ops.lora_residual_many(x, A, B, scale=SCALE))
    p_ms, _ = time_ms(torch, lambda: lora_ref.lora_residual_many(x, A, B, scale=SCALE))
    l_ms, _ = time_ms(torch, lambda: torch.baddbmm(x, torch.bmm(x, A16), B16, alpha=SCALE))
    s_ms, s_is = time_ms(torch, lambda: [lora_ops.lora_residual(x[i], A[i], B[i], scale=SCALE)
                                         for i in range(K)])
    n_bytes = nbytes(x, A, B, y)
    c_ms = time_ms_cold(torch, lambda *a: lora_ops.lora_residual_many(*a, scale=SCALE),
                        (x, A, B), n_bytes)
    b_ms, b_by = bound(n_bytes, 10 * K * T * D * r, "tf32")
    log(f"[time] lora_residual_many at x ({K}, {T}, {D}) bf16, r {r}{what}, device ms per "
        f"call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}), cold {c_ms:.5f} | "
        f"{K} launches of the one-adapter kernel {s_ms:.5f} ({s_is:.5f}) | plain {p_ms:.5f} | "
        f"library torch.baddbmm(x, torch.bmm(x, A), B), bf16 adapters {l_ms:.5f} | bound "
        f"{b_ms:.5f} ({b_by}; {n_bytes / 1e6:.2f} MB) | bound / time: warm {b_ms / k_ms:.3f}, "
        f"cold {b_ms / c_ms:.3f}")
    return dict(ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, single_launches_ms=s_ms, shape=[K, T, D, r])


def many_timings(torch, lora_ops, lora_ref):
    """The batched LoRA kernel at llava's cohort rows: K = 4 clients of batch
    4, the text (4 x 32) and image (4 x 64) rows of each."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = {}
    for label, t in (("text", 128), ("image", 256)):
        x = torch.randn((4, t, 4096), generator=gen, device=dev).to(torch.bfloat16)
        A = torch.randn((4, 4096, 64), generator=gen, device=dev) * 0.05
        B = torch.randn((4, 64, 4096), generator=gen, device=dev) * 0.05
        rows[f"x (4, {t}, 4096) {label}"] = many_timing(torch, lora_ops, lora_ref, x, A, B,
                                                        f" ({label})")
    return dict(rows["x (4, 128, 4096) text"], shapes=rows)


def adapter_gaps(got, want):
    """(global adapters, the clients' own: adapters and personal adapters) of
    run ``got`` against run ``want``, paired by path, relative to ‖want‖∞."""
    own = [tree_gap(g.adapters, w.adapters) for g, w in zip(got.clients, want.clients)]
    own += [tree_gap(g.local_adapters, w.local_adapters)
            for g, w in zip(got.clients, want.clients) if w.local_adapters is not None]
    return tree_gap(got.server.global_adapters, want.server.global_adapters), max(own)


def adapter_outliers(got, want, bound):
    """-> (largest relative gap, elements beyond ``bound``, elements) over the
    global adapters and every client's own (adapters and personal adapters)
    of run ``got`` against run ``want``, each leaf relative to its ‖want‖∞."""
    from repro_torch.utils import tree_flatten_with_path

    pairs = [(got.server.global_adapters, want.server.global_adapters)]
    pairs += [(g.adapters, w.adapters) for g, w in zip(got.clients, want.clients)]
    pairs += [(g.local_adapters, w.local_adapters) for g, w in zip(got.clients, want.clients)
              if w.local_adapters is not None]
    top, over, total = 0.0, 0, 0
    for gt, wt in pairs:
        g, w = dict(tree_flatten_with_path(gt)), dict(tree_flatten_with_path(wt))
        for k in w:
            wk = w[k].float().cpu()
            rel = (g[k].float().cpu() - wk).abs() / max(float(wk.abs().max()), 1e-30)
            top, over, total = max(top, float(rel.max())), over + int((rel > bound).sum()), \
                total + rel.numel()
    return top, over, total


def hold_adapters(got, want, bound, what):
    """Raise unless the adapters of run ``got`` are within ``bound`` of run
    ``want``'s but for at most ADAPTER_OUTLIER_SHARE of their elements, and
    every element within the larger of ADAPTER_GROSS_TOL and ROUNDING_MARGIN
    times ``bound``. -> a description of the hold."""
    top, over, total = adapter_outliers(got, want, bound)
    gross = max(ADAPTER_GROSS_TOL, ROUNDING_MARGIN * bound)
    if over > ADAPTER_OUTLIER_SHARE * total or top > gross:
        raise AssertionError(f"{what}: adapters' largest gap {top:.3e}, {over} of {total} "
                             f"elements beyond {bound:.3e} (at most {ADAPTER_OUTLIER_SHARE} of "
                             f"them, and none beyond {gross:.3e})")
    return (f"adapters largest gap {top:.3e}, {over} of {total} elements beyond {bound:.3e} "
            f"(share bound {ADAPTER_OUTLIER_SHARE}, gross bound {gross:.3e})")


def run_metrics(res):
    """A run's round metrics without the losses (counts, staleness)."""
    return [{k: v for k, v in m.items() if k != "mean_loss"} for m in res.round_metrics]


def cohort_smoke(torch, tr, counters):
    """Phase 18a: smoke llava in f32, 4 clients, card (kernels) against CPU
    (plain versions), each round engine case: losses 1e-5, counts and comm
    equal, adapters at ROUNDING_MARGIN times their CPU spread (two f32
    orders and f64), as phase 17a holds them; and the buffered engine at
    one buffer of all four clients against the sequential engine's
    streaming merge, on the card."""
    from repro_torch.core import FailureModel
    from repro_torch.strategies import FedBuffOpt
    from repro_torch.utils import tree_map

    cfg = tr["get_smoke_config"]("llava-1.5-7b").with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    server_cpu = tr["init_server"](cfg, seed=3, device="cpu")
    server_gpu = dataclasses.replace(
        server_cpu, backbone=tree_map(lambda t: t.cuda(), server_cpu.backbone),
        global_adapters=tree_map(lambda t: t.cuda(), server_cpu.global_adapters))
    data = {dev: tr["make_federated_data"](cfg, device=dev, **COHORT_SMOKE_DATA)
            for dev in ("cuda", "cpu")}
    cases = [(f"vmap {s}", dict(strategy=s, engine="vmap", rounds=2))
             for s in COHORT_SMOKE_STRATEGIES]
    cases += [("buffered uniform, buffer 4", dict(strategy="fednano", engine="buffered",
                                                  buffer_size=4, rounds=2)),
              ("buffered stragglers", dict(
                  strategy="fednano", engine="buffered", buffer_size=2, latency_fn=slow_client0,
                  server_opt=FedBuffOpt(lr=0.5), failures=FailureModel(**SMOKE_FAILURES),
                  rounds=4))]
    many = counters["lora_residual_many"]
    for label, kw in cases:
        runs = {}
        for dev, server in (("cuda", server_gpu), ("cpu", server_cpu)):
            train, evald, _ = data[dev]
            many.launches = many.dx_launches = 0
            runs[dev] = tr["run_federated"](0, cfg, train, evald, hp=hp, use_pallas=True,
                                            server=fresh_server(server), final_eval=False, **kw)
            if dev == "cuda":
                launched = (many.launches, many.dx_launches)
        if kw["engine"] == "vmap" and (launched[0] == 0
                                       or (kw["strategy"] == "feddpa_f") != (launched[1] > 0)):
            raise AssertionError(f"{label}: lora_residual_many launches {launched} (dx only "
                                 f"under FedDPA-F)")
        gpu, cpu = runs["cuda"], runs["cpu"]
        gl = [m["mean_loss"] for m in gpu.round_metrics]
        cl = [m["mean_loss"] for m in cpu.round_metrics]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        f64 = f64_run(tr, cfg, server_cpu, COHORT_SMOKE_DATA, kw["strategy"], hp,
                      final_eval=False, **{k: v for k, v in kw.items() if k != "strategy"})
        cfg_p = cfg.with_(use_pallas=False)
        train, evald, _ = tr["make_federated_data"](cfg_p, device="cpu", **COHORT_SMOKE_DATA)
        other = tr["run_federated"](0, cfg_p, train, evald, hp=hp, use_pallas=False,
                                    server=fresh_server(server_cpu), final_eval=False, **kw)
        pairs = {"plain vs f64": adapter_gaps(cpu, f64), "use_pallas=False vs f64":
                 adapter_gaps(other, f64), "plain vs use_pallas=False": adapter_gaps(cpu, other)}
        bound = max(1e-5, ROUNDING_MARGIN * max(max(g) for g in pairs.values()))
        e_glob, e_own = adapter_gaps(gpu, cpu)
        held = (f"global adapters {e_glob:.3e}, the clients' own {e_own:.3e}; "
                f"{hold_adapters(gpu, cpu, bound, f'phase 18a {label}')}; CPU spread (global, "
                "clients): " + ", ".join(f"{k} ({g[0]:.3e}, {g[1]:.3e})"
                                         for k, g in pairs.items()))
        if (loss_err > 1e-5 or run_metrics(gpu) != run_metrics(cpu)
                or gpu.comm_totals != cpu.comm_totals):
            raise AssertionError(f"phase 18a {label}, card vs CPU: losses {gl} vs {cl} "
                                 f"({loss_err:.3e}), metrics {run_metrics(gpu)} vs "
                                 f"{run_metrics(cpu)}, comm {gpu.comm_totals} vs "
                                 f"{cpu.comm_totals}, {held}")
        log(f"[cohort-smoke] smoke llava {label} f32, 4 clients x {kw['rounds']} rounds: card vs "
            f"CPU round "
            f"losses {gl} vs {cl} (max rel {loss_err:.3e}, bound 1e-5); metrics "
            f"{run_metrics(gpu)} equal; comm equal; {held}; card lora_residual_many launches "
            f"{launched[0]} (dx {launched[1]})")
        if label.startswith("buffered uniform"):
            train, evald, _ = data["cuda"]
            seq = tr["run_federated"](0, cfg, train, evald, rounds=2, hp=hp, use_pallas=True,
                                      server=fresh_server(server_gpu), final_eval=False,
                                      strategy="fednano", agg_chunk=4)
            sl = [m["mean_loss"] for m in seq.round_metrics]
            s_err = max(abs(a - b) / abs(b) for a, b in zip(gl, sl))
            s_glob = tree_gap(gpu.server.global_adapters, seq.server.global_adapters)
            if (s_err > 1e-5 or s_glob > 1e-5 or seq.comm_totals != gpu.comm_totals
                    or any(m["mean_staleness"] for m in gpu.round_metrics)):
                raise AssertionError(f"buffered (buffer 4, uniform) vs sequential: losses {gl} "
                                     f"vs {sl}, adapters {s_glob:.3e}, comm "
                                     f"{gpu.comm_totals} vs {seq.comm_totals}")
            log(f"[cohort-smoke] smoke llava buffered (buffer of all 4, uniform latency: "
                f"staleness 0) vs the sequential engine's streaming merge (agg_chunk 4), card "
                f"f32: losses {gl} vs {sl} (rel {s_err:.3e}), global adapters {s_glob:.3e} "
                f"(bounds 1e-5), comm equal")


def cohort_runs(torch, tr, counters, cfg, server, train, evald, hp, engines, **kw):
    """FedNano on ``server`` by each engine of ``engines``, counters and peak
    memory reset just before each run and read just after. -> {engine:
    (result, wall s, launches, peak bytes)}."""
    out = {}
    for engine in engines:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp,
                                  use_pallas=True, server=fresh_server(server),
                                  final_eval=False, engine=engine, **kw)
        torch.cuda.synchronize()
        out[engine] = (res, time.perf_counter() - t0, {n: fn.launches for n, fn in
                                                       counters.items()},
                       torch.cuda.max_memory_allocated())
    return out


def cohort_full(torch, tr, counters, st):
    """Phase 18b in bf16 on phase 8's llava server: the vmap engine against
    the sequential one (4 clients, 2 rounds), a vmap run folded by
    fisher_fold (agg_chunk 2), launches, step and round times, busy share,
    peak memory. -> launches by path."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils import tree_stack

    cfg, server, hp = st["cfg"], st["server"], st["hp"]
    client, strat = tr["client"], tr["get_strategy"]("fednano")
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **COHORT_DATA)
    k = len(train)
    b0 = train[0][0]
    tokens_per_step = b0.tokens.shape[0] * (b0.tokens.shape[1] + b0.patches.shape[1])
    runs = cohort_runs(torch, tr, counters, cfg, server, train, evald, hp,
                       ("sequential", "vmap"), rounds=2)
    (seq, seq_wall, seq_l, seq_peak), (vm, vm_wall, vm_l, vm_peak) = (runs["sequential"],
                                                                      runs["vmap"])
    sl = [m["mean_loss"] for m in seq.round_metrics]
    vl = [m["mean_loss"] for m in vm.round_metrics]
    errs = [abs(a - b) / abs(b) for a, b in zip(vl, sl)]
    steps = hp.local_steps + hp.fisher_batches
    # a step's flash launches: one a layer, and under remat one more a layer in
    # the backward's recompute (the local steps and the Fisher batches alike)
    want_many = 2 * steps * 2
    want_flash = cfg.n_layers * (2 if cfg.remat else 1) * steps * 2
    if (not all(math.isfinite(x) for x in vl) or errs[0] > RUN_LOSS_TOL_BF16
            or [m["participants"] for m in vm.round_metrics] != [k, k]
            or vm.comm_totals != seq.comm_totals):
        raise AssertionError(f"18b bf16 vmap vs sequential: losses {vl} vs {sl}, metrics "
                             f"{vm.round_metrics}, comm {vm.comm_totals} vs {seq.comm_totals}")
    if (vm_l["lora_residual_many"] != want_many or vm_l["lora_residual"] != 0
            or vm_l["flash_attention"] != want_flash or vm_l["fisher_merge"] != 2
            or seq_l["lora_residual"] != k * want_many or seq_l["lora_residual_many"] != 0):
        raise AssertionError(f"18b launches: vmap {vm_l}, sequential {seq_l} (want the batched "
                             f"LoRA {want_many} and flash {want_flash} a run of 2 rounds)")
    log(f"[cohort] {cfg.name} bf16 fednano, 4 clients x 2 rounds x ({hp.local_steps} steps + "
        f"{hp.fisher_batches} Fisher batches), batch 4 x (64 patches + 32 tokens), kernels on: "
        f"vmap round losses {vl} vs sequential {sl} (rel {[f'{e:.3e}' for e in errs]}; round 0 "
        f"held at {RUN_LOSS_TOL_BF16}, round 1 reported); comm equal {vm.comm_totals}")
    log(f"[cohort] launches, 2 rounds (counters reset around each run): vmap "
        f"{json.dumps(vm_l)} | sequential {json.dumps(seq_l)}; per round: batched LoRA "
        f"{vm_l['lora_residual_many'] // 2} vs one-adapter LoRA {seq_l['lora_residual'] // 2}, "
        f"flash {vm_l['flash_attention'] // 2} vs {seq_l['flash_attention'] // 2} "
        f"({vm_l['flash_attention'] // (2 * steps)} vs {seq_l['flash_attention'] // (2 * steps)} "
        f"a cohort step)")
    # agg_chunk 2: two cohorts of 2 clients, each upload folded by fisher_fold
    fold = cohort_runs(torch, tr, counters, cfg, server, train, evald, hp, ("vmap",),
                       rounds=1, agg_chunk=2)["vmap"]
    res_f, _, fold_l, _ = fold
    uploads = [(cl.adapters, cl.fisher, cl.n_examples) for cl in res_f.clients]
    batch_merge = strat.aggregate(*(list(u) for u in zip(*uploads)), use_pallas=True)
    fold_err = tree_gap(res_f.server.global_adapters, batch_merge)
    if fold_err > 1e-6 or fold_l["fisher_fold"] != k or fold_l["fisher_merge"] != 0:
        raise AssertionError(f"18b agg_chunk=2: streamed merge vs fisher_merge {fold_err:.3e} "
                             f"(bound 1e-6); launches {fold_l}")
    log(f"[cohort] vmap agg_chunk=2 (two cohorts of 2), round 0: loss "
        f"{res_f.round_metrics[0]['mean_loss']}; streamed merge by fisher_fold ({k} launches) "
        f"vs fisher_merge of the same uploads {fold_err:.3e} of ‖ref‖∞ (bound 1e-6) | launches "
        f"{json.dumps(fold_l)}")

    # step times: one cohort step of the 4 clients' first batches against one
    # sequential client step, each ending in its losses on the host
    adp = server.global_adapters
    stacked = tree_stack([adp] * k)
    opt = tree_stack([tr["adamw_init"](adp)] * k)
    batch = tree_stack([train[c][0] for c in sorted(train)])
    opt1 = tr["adamw_init"](adp)

    def cohort_step():
        return client.cohort_train_step(cfg, strat, hp, server.backbone, stacked, opt, batch,
                                        adp, k)[2].cpu()

    def client_step():
        return float(client.train_step(cfg, strat, hp, server.backbone, adp, opt1, b0, adp)[2])

    cohort_ms, step_ms = time_host(torch, cohort_step), time_host(torch, client_step)
    for what, fn in (("one full-width cohort step (4 clients)", cohort_step),
                     ("one full-width sequential client step", client_step)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(torch, prof, wall, what)
    log(f"[cohort-time] {cfg.name} bf16: cohort step (4 clients, forward, backward, AdamW, "
        f"losses to the host) {cohort_ms:.2f} ms = {cohort_ms / k:.2f} ms a client step, "
        f"{k * tokens_per_step / cohort_ms * 1e3:.1f} trained tokens/s | sequential client "
        f"step {step_ms:.2f} ms, {tokens_per_step / step_ms * 1e3:.1f} trained tokens/s | "
        f"speedup a client step {step_ms * k / cohort_ms:.2f}x | round wall (4 clients, no "
        f"eval): vmap {vm_wall / 2:.3f} s, sequential {seq_wall / 2:.3f} s | peak memory: vmap "
        f"{vm_peak / 2**30:.2f} GiB, sequential {seq_peak / 2**30:.2f} GiB")
    launches = {"cohort_vmap": {n: vm_l[n] + fold_l[n] for n in vm_l},
                "cohort_sequential": seq_l}
    for name in COHORT_KERNELS:
        if not launches["cohort_vmap"][name]:
            raise AssertionError(f"the {name} kernel never launched on the vmap path")
    return launches


def buffered_full(torch, tr, counters, st, root):
    """Phase 18c in bf16 on phase 8's llava server: the buffered engine with
    client 0 straggling by latency and every dispatch by the FailureModel,
    FedBuffOpt(0.5), merges of 2; the uninterrupted run snapshots after each
    merge, and a run resumed from the snapshot at merge 2 must equal it.
    -> launches by path."""
    from repro_torch.core import FailureModel
    from repro_torch.strategies import FedBuffOpt

    cfg, server, hp = st["cfg"], st["server"], st["hp"]
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **COHORT_DATA)
    fm = FailureModel(**BUFFERED_FAILURES)
    kw = dict(strategy="fednano", hp=hp, use_pallas=True, engine="buffered",
              latency_fn=slow_client0, server_opt=FedBuffOpt(lr=0.5), failures=fm,
              final_eval=False, **BUFFERED_RUN)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with timed_snapshots() as spent:
        full = tr["run_federated"](0, cfg, train, evald, server=fresh_server(server),
                                   checkpoint_dir=f"{root}/full", checkpoint_every=1, **kw)
        mids = sorted(p.name for p in Path(f"{root}/full").glob("round_*")
                      if 0 < int(p.name.split("_")[1]) < BUFFERED_RUN["rounds"])
        if not mids:
            raise AssertionError("18c: no snapshot between merges")
        cut = "round_000002" if "round_000002" in mids else mids[-1]
        resumed = tr["run_federated"](0, cfg, train, evald, server=fresh_server(server),
                                      resume=f"{root}/full/{cut}", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    stale = [m["mean_staleness"] for m in full.round_metrics]
    if (any(m["participants"] != BUFFERED_RUN["buffer_size"] for m in full.round_metrics)
            or max(stale) <= 0.0 or len(full.round_metrics) != BUFFERED_RUN["rounds"]):
        raise AssertionError(f"18c merges: {full.round_metrics}")
    gap = hold_resume(full, resumed, f"{cfg.name} buffered")
    if [m["straggled"] for m in full.round_metrics] != \
            [m["straggled"] for m in resumed.round_metrics]:
        raise AssertionError("18c: the resumed run straggled otherwise")
    snap = Path(root) / "full" / cut
    snap_bytes = sum(f.stat().st_size for f in snap.iterdir())
    if not launches["lora_residual"] or not launches["flash_attention"]:
        raise AssertionError(f"18c launches {launches}")
    log(f"[buffered] {cfg.name} bf16 fednano buffered, 4 clients (client 0 at 3 ticks), "
        f"buffer 2, FedBuffOpt(0.5), FailureModel {fm.to_dict()}, 4 merges: losses "
        f"{[m['mean_loss'] for m in full.round_metrics]}, (participants, staleness, "
        f"straggled) {[(m['participants'], m['mean_staleness'], m['straggled']) for m in full.round_metrics]}; "
        f"resumed from {cut}: largest gap {gap:.3e} (bound {RESUME_TOL}; zero: {gap == 0.0}); "
        f"comm {full.comm_totals} equal")
    log(f"[buffered] snapshots: {len(spent['save'])} saves of {snap_bytes / 1e6:.3f} MB at "
        f"{cut}, save {1e3 * min(spent['save']):.1f}-{1e3 * max(spent['save']):.1f} ms, load "
        f"{', '.join(f'{1e3 * x:.1f}' for x in spent['load'])} ms; both runs {wall:.3f} s | "
        f"launches {json.dumps(launches)}")
    return {"buffered": launches}


def cohort_full_f32(torch, tr, counters, st):
    """Phase 18b in f32 on the weights phase 17 upcast in place: round 0 of
    the vmap engine against the sequential one and the first cohort step's
    per-client loss and adapter gradients at 1e-4, the adapters after both
    rounds at ROUNDING_MARGIN times the gap between two f32 orders of the
    sequential engine (kernels, and the model's use_pallas=False path)."""
    from repro_torch.utils import tree_stack, tree_unstack

    cfg, cut = cut_depth(st["cfg"].with_(dtype="float32"), st["server"].backbone,
                         COHORT_F32_LAYERS)
    server = dataclasses.replace(st["server"], cfg=cfg, backbone=cut)
    hp = st["hp"]
    client = tr["client"]
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **COHORT_DATA)
    k = len(train)
    runs = cohort_runs(torch, tr, counters, cfg, server, train, evald, hp,
                       ("sequential", "vmap"), rounds=2)
    seq, vm = runs["sequential"][0], runs["vmap"][0]
    cfg_p = cfg.with_(use_pallas=False)
    other = tr["run_federated"](0, cfg_p, train, evald, strategy="fednano", hp=hp, rounds=2,
                                use_pallas=False, server=fresh_server(server), final_eval=False)
    sl = [m["mean_loss"] for m in seq.round_metrics]
    vl = [m["mean_loss"] for m in vm.round_metrics]
    errs = [abs(a - b) / abs(b) for a, b in zip(vl, sl)]
    witness = adapter_gaps(other, seq)
    bound = max(1e-5, ROUNDING_MARGIN * max(witness))
    e_glob, e_own = adapter_gaps(vm, seq)
    held = hold_adapters(vm, seq, bound, "18b f32 vmap vs sequential")
    # the first cohort step: per-client loss and adapter gradients
    adp = server.global_adapters
    batch = tree_stack([train[c][0] for c in sorted(train)])

    def total(a):
        per_client = client.cohort_loss(cfg, server.backbone, a, None, batch, k)[0]
        return per_client.sum(), per_client.detach()

    _, losses, grads = client.value_and_grad(total, tree_stack([adp] * k))
    step_err = grad_err = 0.0
    for i, (c, g) in enumerate(zip(sorted(train), tree_unstack(grads, k))):
        loss, _, want = client.value_and_grad(
            lambda a: tr["fednano_loss"](cfg, server.backbone, a, train[c][0]), adp)
        step_err = max(step_err, abs(float(losses[i]) - float(loss)) / abs(float(loss)))
        grad_err = max(grad_err, tree_gap(g, want))
    torch.cuda.empty_cache()
    if (errs[0] > LOSS_TOL["float32"] or step_err > LOSS_TOL["float32"]
            or grad_err > GRAD_TOL["float32"] or vm.comm_totals != seq.comm_totals):
        raise AssertionError(f"18b f32 vmap vs sequential: round losses {vl} vs {sl}, first "
                             f"step loss {step_err:.3e} grads {grad_err:.3e}, adapters "
                             f"({e_glob:.3e}, {e_own:.3e}); {held}")
    log(f"[cohort] {cfg.name} f32 (weights upcast in place, {cfg.n_layers} of 32 layers), "
        f"fednano 4 clients x 2 rounds: "
        f"vmap round losses {vl} vs sequential {sl} (rel {[f'{e:.3e}' for e in errs]}; round 0 "
        f"bound {LOSS_TOL['float32']}); first cohort step vs each client's own step: loss "
        f"{step_err:.3e}, adapter grads {grad_err:.3e} (bounds 1e-4); after 2 rounds global "
        f"adapters {e_glob:.3e}, the clients' {e_own:.3e}: {held}, the witness: the "
        f"sequential engine's use_pallas=False order vs its kernels' ({witness[0]:.3e}, "
        f"{witness[1]:.3e}); peak memory: vmap "
        f"{runs['vmap'][3] / 2**30:.2f} GiB, sequential {runs['sequential'][3] / 2**30:.2f} GiB")
    return {"cohort_vmap_f32": runs["vmap"][2]}


# Phase 19: the split runtime, rank-heterogeneous adapters and the sharded
# engine on phase 8's llava-1.5-7b server, at phase 18's batch (4 x (64
# patches + 32 tokens)).
SPLIT_BATCH = (4, 32, 64)       # rows, text tokens, image patches
HETERO_RANKS = (16, 32, 64)     # alpha = 2r: every client's scale is 2
# 19c: 8 clients x 2 rounds in f32 on the first SHARDED_LAYERS of the 32
# layers (the runs below take 13 rounds of 8 clients; at full depth in f32,
# where a local step's 11 TFLOP run on the CUDA cores, that is about 80 s).
# 4 layers keep the script inside its time (PERF.md §4), each layer left out
# running what a kept one runs.
SHARDED_DATA = dict(TRAIN_DATA, n_clients=8)
SHARDED_LAYERS = 4
# at the split's shape
SPLIT_TOL = {"float32": 1e-5}
PHASE19_KERNELS = ("lora_residual", "lora_residual_many", "flash_attention", "fisher_merge",
                   "fisher_fold")


def phase19_server(st, dtype_name, n_layers=None):
    """Phase 8's llava server as ``dtype_name`` names it (phase 17 upcasts the
    weights in place), cut to its first ``n_layers``."""
    cfg = st["cfg"].with_(dtype=dtype_name)
    server = dataclasses.replace(st["server"], cfg=cfg)
    if n_layers is not None:
        cfg, backbone = cut_depth(cfg, server.backbone, n_layers)
        server = dataclasses.replace(server, cfg=cfg, backbone=backbone)
    return cfg, server


def split_phase(torch, tr, counters, st, dtype_name):
    """Phase 19a: one split-learning step (client NanoEdge forward, the
    server's backbone forward and backward with respect to the wire, the
    client's backward) against the fused gradient of ``fednano_loss``, on the
    adapters off identity; the wire bytes against the analytic count; the
    ms of each. -> launches of one split step."""
    from repro_torch.core import split

    cfg, server = phase19_server(st, dtype_name)
    rows, seq, n_patches = SPLIT_BATCH
    train, _, _ = tr["make_federated_data"](cfg, device="cuda", **TRAIN_DATA)
    batch = train[0][0]
    if tuple(batch.tokens.shape) != (rows, seq) or batch.patches.shape[1] != n_patches:
        raise AssertionError(f"19a batch {tuple(batch.tokens.shape)} + {batch.patches.shape}")
    gen = torch.Generator(device="cuda").manual_seed(19)
    adapters = {m: {"down": a["down"], "up": torch.randn(a["up"].shape, generator=gen,
                                                         device="cuda") * 0.05}
                for m, a in server.global_adapters.items()}
    for fn in counters.values():
        fn.launches = 0
    loss, grads, traffic = split.split_train_grads(cfg, server.backbone, adapters, batch)
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in counters.items()}
    floss, _, fgrads = tr["client"].value_and_grad(
        lambda a: tr["fednano_loss"](cfg, server.backbone, a, batch), adapters)
    loss_gap = abs(float(loss) - float(floss)) / abs(float(floss))
    grad_gap = tree_gap(grads, fgrads)
    want = split.split_activation_bytes_per_step(cfg, rows, seq, n_patches=n_patches)
    if traffic != want:
        raise AssertionError(f"19a {dtype_name}: wire bytes {traffic}, analytic {want}")
    if dtype_name in SPLIT_TOL and (loss_gap > SPLIT_TOL[dtype_name]
                                    or grad_gap > SPLIT_TOL[dtype_name]):
        raise AssertionError(f"19a {dtype_name}: split vs fused loss {loss_gap:.3e}, adapter "
                             f"grads {grad_gap:.3e} (bound {SPLIT_TOL[dtype_name]})")
    if (not math.isfinite(float(loss)) or not launched["lora_residual"]
            or not launched["flash_attention"]):
        raise AssertionError(f"19a {dtype_name}: loss {float(loss)}, launches {launched}")
    split_ms = time_host(torch, lambda: float(split.split_train_grads(
        cfg, server.backbone, adapters, batch)[0]))
    fused_ms = time_host(torch, lambda: float(tr["client"].value_and_grad(
        lambda a: tr["fednano_loss"](cfg, server.backbone, a, batch), adapters)[0]))
    held = (f"(bound {SPLIT_TOL[dtype_name]})" if dtype_name in SPLIT_TOL
            else "(reported: bf16 rounds the wire)")
    log(f"[split] {cfg.name} {dtype_name}, batch {rows} x ({n_patches} patches + {seq} tokens), "
        f"kernels on: split loss {float(loss):.6f} vs fused {float(floss):.6f} (rel "
        f"{loss_gap:.3e}), adapter grads {grad_gap:.3e} of ‖ref‖∞ {held}; wire bytes "
        f"{traffic} = analytic {want}; split step {split_ms:.2f} ms, fused step "
        f"{fused_ms:.2f} ms (host ms, ending in the loss on the host) | launches of one split "
        f"step {json.dumps(launched)}")
    return {f"split_{dtype_name}": launched}


def hetero_phase(torch, tr, counters, st):
    """Phase 19b in f32: three clients at ranks 16, 32 and 64 (alpha 2r) each
    take one local step through the kernels from the global adapters cut to
    their rank, with its squared gradient as Fisher; their uploads merged in
    rank-64 space (plain) against the fisher_merge kernel on the padded
    trees; the merge without the rank-64 client leaves the coordinates past
    rank 32 at exactly 0; the rank-16 slice, padded back to 64, gives that
    slice's NanoEdge output through the LoRA kernel. -> launches."""
    from repro_torch.core.aggregation import fisher_merge
    from repro_torch.core.fisher import FisherAccumulator
    from repro_torch.core.hetero import hetero_fisher_merge, pad_nanoedge, truncate_nanoedge

    cfg, server = phase19_server(st, "float32")
    hp, strat = st["hp"], tr["get_strategy"]("fednano")
    train, _, _ = tr["make_federated_data"](cfg, device="cuda", **COHORT_DATA)
    rank_cfg = {r: cfg.with_(adapter=dataclasses.replace(cfg.adapter, rank=r, alpha=2.0 * r))
                for r in HETERO_RANKS}
    for fn in counters.values():
        fn.launches = 0
    thetas, fishers, losses = [], [], []
    for c, r in enumerate(HETERO_RANKS):
        adp = truncate_nanoedge(server.global_adapters, r)
        adp = {m: {n: t.contiguous() for n, t in a.items()} for m, a in adp.items()}
        acc = FisherAccumulator.init(adp)
        new, _, loss, acc = tr["client"].train_step(
            rank_cfg[r], strat, hp, server.backbone, adp, tr["adamw_init"](adp), train[c][0],
            adp, fisher_acc=acc)
        thetas.append(new)
        fishers.append(acc.finalize())
        losses.append(float(loss))
    sizes = [len(train[c]) for c in range(len(HETERO_RANKS))]
    rmax = max(HETERO_RANKS)
    merged = hetero_fisher_merge(thetas, fishers, HETERO_RANKS, sizes)
    kernel = fisher_merge([pad_nanoedge(t, rmax) for t in thetas],
                          [pad_nanoedge(f, rmax) for f in fishers], sizes, use_pallas=True)
    merge_gap = tree_gap(merged, kernel)
    # without the rank-64 client: no Fisher mass past rank 32
    low = [r for r in HETERO_RANKS if r < rmax]
    part = hetero_fisher_merge(thetas[:len(low)], fishers[:len(low)], low, sizes[:len(low)],
                               rank_max=rmax)
    part_k = fisher_merge([pad_nanoedge(t, rmax) for t in thetas[:len(low)]],
                          [pad_nanoedge(f, rmax) for f in fishers[:len(low)]], sizes[:len(low)],
                          use_pallas=True)
    part_gap = tree_gap(part, part_k)
    empty = [(t[:, max(low):] if n == "down" else t[max(low):])
             for tree in (part, part_k) for a in tree.values() for n, t in a.items()]
    live = [t[:, :max(low)] if n == "down" else t[:max(low)]
            for a in part_k.values() for n, t in a.items()]
    nan = any(bool(torch.isnan(t).any()) for tree in (merged, kernel, part, part_k)
              for a in tree.values() for t in a.values())
    # the rank-16 slice of the merge, and the same slice padded back to 64
    r0 = HETERO_RANKS[0]
    sub = truncate_nanoedge(merged, r0)
    sub = {m: {n: t.contiguous() for n, t in a.items()} for m, a in sub.items()}
    with torch.no_grad():
        want = tr["adapters"].nanoedge_forward(rank_cfg[r0], server.backbone, sub, train[0][0])
        # rank 64 at alpha 128: the slice's own scale, alpha / rank = 2
        got = tr["adapters"].nanoedge_forward(rank_cfg[rmax], server.backbone,
                                              pad_nanoedge(sub, rmax), train[0][0])
    slice_gap = float((got[0] - want[0]).abs().max()) / float(want[0].abs().max())
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in counters.items()}
    if (merge_gap > 1e-6 or part_gap > 1e-6 or slice_gap > 1e-6 or nan
            or any(bool(t.any()) for t in empty) or not all(bool(t.any()) for t in live)
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"19b: merge plain vs kernel {merge_gap:.3e}, without the rank-64 "
                             f"client {part_gap:.3e}, rank-16 slice {slice_gap:.3e} (bounds "
                             f"1e-6), NaN {nan}, zero past rank {max(low)} "
                             f"{not any(bool(t.any()) for t in empty)}, losses {losses}")
    log(f"[hetero] {cfg.name} f32, clients at ranks {list(HETERO_RANKS)} (alpha 2r), one "
        f"local step each through the kernels: losses {losses}; merged in rank-{rmax} space "
        f"(plain) vs the fisher_merge kernel on the padded trees {merge_gap:.3e} of ‖ref‖∞; "
        f"ranks {low} alone in rank-{rmax} space: {part_gap:.3e}, every coordinate past rank "
        f"{max(low)} exactly 0 in both, no NaN; the rank-{r0} slice padded to {rmax} vs the "
        f"slice through the LoRA kernel {slice_gap:.3e} (bounds 1e-6) | launches "
        f"{json.dumps(launched)}")
    return {"hetero": launched}


def same_run(a, b) -> bool:
    """Two runs equal to the bit: round metrics, comm, every adapter, AdamW
    state and Fisher."""
    from repro_torch.utils import tree_leaves

    trees = lambda res: ([res.server.global_adapters]
                         + [t for c in res.clients for t in (c.adapters, c.opt_state, c.fisher)])
    return (a.round_metrics == b.round_metrics and a.comm_totals == b.comm_totals
            and all(torch_equal(x, y) for ta, tb in zip(trees(a), trees(b))
                    for x, y in zip(tree_leaves(ta), tree_leaves(tb))))


def torch_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x, y))


def run_gaps(got, want):
    """(round 0's loss, the global adapters, the clients' adapters): largest
    relative gaps."""
    l0 = abs(got.round_metrics[0]["mean_loss"] - want.round_metrics[0]["mean_loss"]) / abs(
        want.round_metrics[0]["mean_loss"])
    return (l0, tree_gap(got.server.global_adapters, want.server.global_adapters),
            max(tree_gap(g.adapters, w.adapters) for g, w in zip(got.clients, want.clients)))


@contextlib.contextmanager
def counted_syncs(torch):
    """Count the host syncs CUDA work makes inside the block
    (``torch.cuda.set_sync_debug_mode("warn")``): -> {"file:line" of the
    Python call that synced: count}."""
    import warnings

    seen = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchronizing" not in str(w.message):
            continue
        key = f"{Path(w.filename).name}:{w.lineno}"
        seen[key] = seen.get(key, 0) + 1


def sharded_phase(torch, tr, counters, st, root):
    """Phase 19c in f32 on the first SHARDED_LAYERS layers: FedNano, 8
    clients, the sharded engine on client_mesh() (one card) against the
    vmap engine (round 0: losses and adapters 1e-5), with the Fisher kernels
    (the per-client path) against the stacked merge (1e-5), overlap on
    against off (to the bit), a mesh of two cuda:0 entries against one
    (1e-5), a resume from round 1 against the uninterrupted run (to the bit),
    an agg_chunk=2 round folded by fisher_fold (1e-6 of fisher_merge's);
    round time, busy share and peak memory with overlap on and off, the host
    syncs of a round. -> launches by run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sharding import ClientMesh, client_mesh

    cfg, server = phase19_server(st, "float32", SHARDED_LAYERS)
    hp = st["hp"]
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **SHARDED_DATA)
    mesh1, mesh2 = client_mesh(device="cuda"), ClientMesh([torch.device("cuda", 0)] * 2)
    if mesh1.size != torch.cuda.device_count():
        raise AssertionError(f"client_mesh() over {mesh1.size} of "
                             f"{torch.cuda.device_count()} cards")
    launches, timing = {}, {}

    def run(label, engine="sharded", **kw):
        kw.setdefault("rounds", 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp,
                                  server=fresh_server(server), final_eval=False, engine=engine,
                                  **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {n: fn.launches for n, fn in counters.items()}
        timing[label] = (wall / kw["rounds"], torch.cuda.max_memory_allocated())
        if not all(math.isfinite(m["mean_loss"]) for m in res.round_metrics):
            raise AssertionError(f"19c {label}: {res.round_metrics}")
        return res

    vm = run("vmap", engine="vmap", rounds=1)
    vm1 = run("vmap, cohorts of 1 (agg_chunk 1)", engine="vmap", rounds=1, agg_chunk=1)
    fast = run("mesh 1, 1 round", devices=mesh1, rounds=1)
    kern = run("mesh 1, Fisher kernels, 1 round", devices=mesh1, rounds=1, use_pallas=True)
    fold = run("mesh 1, Fisher kernels, agg_chunk 2, 1 round", devices=mesh1, rounds=1,
               use_pallas=True, agg_chunk=2)
    on = run("mesh 1, overlap on", devices=mesh1, checkpoint_dir=f"{root}/sharded",
             checkpoint_every=1)
    off = run("mesh 1, overlap off", devices=mesh1, overlap=False)
    two = run("mesh of 2 x cuda:0", devices=mesh2)
    resumed = run("mesh 1, resumed from round 1", devices=mesh1,
                  resume=f"{root}/sharded/round_000001")
    vm1_gap, kern_gap = run_gaps(fast, vm1), run_gaps(kern, fast)
    # against the whole cohort in one vmap pass: other GEMM shapes on the
    # card, so other f32 orders, which AdamW turns into sign-sized steps on
    # isolated elements; the witness is the vmap engine against itself at
    # cohorts of 1 (no sharded code)
    vm_gap, witness = run_gaps(fast, vm), run_gaps(vm1, vm)
    vm_held = hold_adapters(fast, vm, max(1e-5, ROUNDING_MARGIN * max(witness[1:])),
                            "19c sharded vs vmap (one cohort)")
    _, vm_over, vm_total = adapter_outliers(fast, vm, 1e-5)
    two_gap = run_gaps(two, on)
    uploads = [(c.adapters, c.fisher, c.n_examples) for c in fold.clients]
    batch_merge = tr["get_strategy"]("fednano").aggregate(*(list(u) for u in zip(*uploads)),
                                                          use_pallas=True)
    fold_gap = tree_gap(fold.server.global_adapters, batch_merge)
    k = SHARDED_DATA["n_clients"]
    if (max(vm1_gap) > 1e-5 or vm_gap[0] > 1e-5 or max(kern_gap) > 1e-5
            or max(two_gap) > 1e-5 or fold_gap > 1e-6
            or not same_run(on, off) or not same_run(on, resumed)
            or fast.comm_totals != vm.comm_totals or kern.comm_totals != vm.comm_totals
            or [m["participants"] for m in on.round_metrics] != [k, k]):
        raise AssertionError(
            f"19c: sharded vs vmap in cohorts of 1 (loss, global, clients) {vm1_gap}, vs vmap "
            f"in one cohort {vm_gap}, Fisher kernels vs stacked "
            f"merge {kern_gap}, mesh of 2 vs 1 {two_gap} (bounds 1e-5), agg_chunk 2 fold vs "
            f"merge {fold_gap:.3e} (1e-6), overlap off equal {same_run(on, off)}, resumed "
            f"equal {same_run(on, resumed)}, comm {fast.comm_totals} vs {vm.comm_totals}")
    folds = launches["mesh 1, Fisher kernels, agg_chunk 2, 1 round"]
    if (launches["mesh 1, 1 round"]["fisher_merge"] != 0
            or launches["mesh 1, Fisher kernels, 1 round"]["fisher_merge"] != 1
            or folds["fisher_fold"] != k or not launches["mesh 1, 1 round"][
                "lora_residual_many"]):
        raise AssertionError(f"19c launches {launches}")
    # one round with overlap on and off, in turns: its wall and busy share
    # (device activities only, so the profiler adds little host work); then
    # the host syncs of a round
    busy = {"on": [], "off": []}
    for label in ("on", "off"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp, rounds=1,
                                server=fresh_server(server), final_eval=False,
                                engine="sharded", devices=mesh1, overlap=label == "on")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        share = profile_summary(torch, prof, wall, f"one sharded round ({k} clients, "
                                f"{SHARDED_LAYERS} layers, f32), overlap {label}")
        busy[label].append(f"{1e3 * wall:.1f} ms at busy share "
                           f"{'not measured' if share is None else f'{share:.3f}'}")
    with counted_syncs(torch) as syncs:
        tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp, rounds=1,
                            server=fresh_server(server), final_eval=False, engine="sharded",
                            devices=mesh1)
        torch.cuda.synchronize()
    log(f"[sharded] {cfg.name} f32 cut to {SHARDED_LAYERS} of 32 layers, fednano {k} clients "
        f"x 2 rounds x ({hp.local_steps} steps + {hp.fisher_batches} Fisher batches), batch 4 x "
        f"(64 patches + 32 tokens), kernels on: mesh 1 (client_mesh(), chunks of 1) vs vmap "
        f"in cohorts of 1, round 0 (loss, global, clients) "
        f"{tuple(f'{x:.3e}' for x in vm1_gap)}; vs vmap in one cohort of {k} "
        f"{tuple(f'{x:.3e}' for x in vm_gap)} ({vm_over} of {vm_total} adapter elements "
        f"beyond 1e-5): {vm_held}, the witness vmap in cohorts of 1 vs "
        f"one cohort {tuple(f'{x:.3e}' for x in witness)}; the Fisher "
        f"kernels' per-client merge vs the stacked merge {tuple(f'{x:.3e}' for x in kern_gap)}; "
        f"mesh of 2 x cuda:0 vs mesh 1 after 2 rounds {tuple(f'{x:.3e}' for x in two_gap)} "
        f"(bounds 1e-5, loss of one cohort too); agg_chunk 2 by fisher_fold ({folds['fisher_fold']} launches) vs "
        f"fisher_merge {fold_gap:.3e} (1e-6); overlap off equal to on to the bit; resumed from "
        f"round 1 equal to the bit; losses {[m['mean_loss'] for m in on.round_metrics]}; comm "
        f"{on.comm_totals}")
    log("[sharded] round wall and peak memory: " + "; ".join(
        f"{label} {1e3 * w:.1f} ms a round, {p / 2**30:.2f} GiB" for label, (w, p)
        in timing.items()) + f" | one round, in turns: overlap on {', '.join(busy['on'])}; "
        f"off {', '.join(busy['off'])} | host syncs in one round (overlap on), by the Python "
        f"line that synced: {json.dumps(syncs)}")
    log(f"[sharded] launches by run (counters reset around each): {json.dumps(launches)}")
    return {"phase19c": {n: sum(v[n] for v in launches.values()) for n in counters}}


# ---------------------------------------------------------------------------
# phase 20: the launch step functions at the production shapes
# ---------------------------------------------------------------------------

# The launch layer's three step functions (``repro_torch.launch.steps``) at
# ``INPUT_SHAPES``, full width and depth, bf16, kernels on: h2o-danube-1.8b and
# mamba2-130m at all four shapes, recurrentgemma-9b at the two decode shapes
# (22.6 and 19.5 GiB analytic; its train and prefill need 83-84 GiB).
LAUNCH_RUNS = ((H2O, ("train_4k", "prefill_32k", "decode_32k", "long_500k")),
               (MAMBA, ("train_4k", "prefill_32k", "decode_32k", "long_500k")),
               (RGEMMA, ("decode_32k", "long_500k")))
# A shape runs at its global batch or the largest batch the card holds
# (``dryrun.fit_batch``: the peaks of steps at batch 1 and 2). One warm-up step
# at that batch (the allocator grows to it there), then steps timed by kind: a
# train or prefill step at that batch takes seconds (0.5 s a row of
# h2o-danube's prefill_32k), so one is timed.
LAUNCH_ITERS = {"train": 1, "prefill": 1, "decode": 3}
# The kernels against the plain path on the first LAUNCH_CHECK_LAYERS layers,
# bf16 as drawn and f32 on those layers upcast: batch 1 for train and prefill,
# the whole batch for decode (a random state). Every layer left out runs the
# same kernels at the same shapes as one kept (recurrentgemma's 5: a triple
# and the two extra recurrent layers). The cut is forced: h2o's plain prefill
# at 32,768 positions takes chunked_sdpa's 0.8 s a layer and row, its plain
# train step keeps each layer's f32 chunk logits for the backward, and a
# decode check at 128 rows holds four decode states (input, the plain run's
# copy, both outputs) of 33.42 GiB at full depth. The kernels at the runs'
# own batches: ``scale_check``.
LAUNCH_CHECK_LAYERS = {H2O: 2, MAMBA: 24, RGEMMA: 5}
# scale_check's plain sides in blocks: LoRA rows, SSD batch rows
SCALE_LORA_ROWS = 1 << 17
SCALE_SSD_ROWS = 4
# Flash against chunked_sdpa at prefill_32k (the plain side: sdpa's (S, S)
# scores would take 137 GB), f32, at the harness's bound.
ATTN_F32_TOL = 1e-6
CHUNKED_LOSS_TOL = 1e-5
# Far-position decode in f32: a sequence whose last position is 524,287,
# prefilled from a ring-aligned start (a multiple of the ring's slots) and
# decoded teacher-forced for FAR_STEPS steps, each held against the full
# windowed forward at the same absolute positions.
FAR_LAYERS = {H2O: 2, RGEMMA: 5}
FAR_STEPS = 16
FAR_POS = 524_287
LAUNCH_KERNELS = ("lora_residual", "flash_attention", "ssd_scan")


def fill_random(torch, tree, seed):
    """Every leaf of a decode state drawn in place from N(0, 0.25)."""
    from repro_torch.utils import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in tree_leaves(tree):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.5)
    return tree


def launch_adapters(torch, cfg):
    """The text adapter drawn from seed 0 with ``up`` off zero, so that
    ``down`` carries gradient."""
    from repro_torch.core.adapters import init_nanoedge

    gen = torch.Generator(device="cuda").manual_seed(0)
    adapters = init_nanoedge(gen, cfg)
    for a in adapters.values():
        a["up"].copy_(torch.randn(a["up"].shape, generator=gen, device="cuda") * 0.05)
    return adapters


def fit_table(dryrun, archs, shapes):
    """``[dryrun]``: every pair's per-card footprint on one card and on an
    eight-card node, from meta tensors."""
    for lay in ("1x1", "1x8"):
        for arch in archs:
            cells = []
            for name in shapes:
                rec = dryrun.run_fit(arch, name, lay, verbose=False)
                cells.append(f"{name} skip ({rec['reason']})" if rec["status"] == "skip" else
                             f"{name} {rec['analytic_footprint']['total'] / 2**30:.2f} GiB "
                             f"{'fits' if rec['fits'] else 'over 80 GiB'}")
            log(f"[dryrun] fit {lay} {arch}, analytic (TPU remat allowance): "
                + "; ".join(cells))


def roofline_text(rep) -> str:
    return (f"{rep.hlo_flops:.4e} FLOP, {rep.hlo_bytes:.4e} B; compute "
            f"{1e3 * rep.t_compute:.3f} ms, memory {1e3 * rep.t_memory:.3f} ms "
            f"({rep.bottleneck}-bound), useful {rep.useful_ratio:.3f}")


def launch_arch(torch, tr, counters, dryrun, arch, shapes, card, records):
    """One arch's shapes at full width and depth, bf16, kernels on: each run
    timed at the largest batch the card holds (or the cut), launches counted;
    then its checks. A train run (remat on, the config's default) leaves its
    record in ``records`` by arch, for phase 22. -> launches by run."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import steps

    cfg0 = tr["get_config"](arch).with_(use_pallas=True)
    t0 = time.perf_counter()
    backbone = tr["model"].init_backbone(cfg0, seed=0, device="cuda")
    adapters = launch_adapters(torch, cfg0)
    torch.cuda.synchronize()
    log(f"[launch] {arch}: {cfg0.n_layers} layers, d_model {cfg0.d_model}, {cfg0.dtype}, drawn "
        f"in {time.perf_counter() - t0:.1f} s")
    short = arch.split("-")[0]
    launches = {}
    for name in shapes:
        shape = INPUT_SHAPES[name]
        cfg = steps.exec_config(cfg0, shape, "full")
        run = dryrun.step_runner(cfg, shape, backbone, adapters)
        fits, probe = shape.global_batch, None
        if shape.global_batch > 2:
            fits, probe = dryrun.fit_batch(cfg, shape, run, "cuda")
        batch = fits
        rep, _ = dryrun.roofline_report(arch, cfg0, shape, "1x1")
        for fn in counters.values():
            fn.launches = 0
        rec = dryrun.run_record(arch, cfg0, cfg, shape, run, batch, "cuda", probe,
                                iters=LAUNCH_ITERS[shape.kind],
                                rep=rep if batch == shape.global_batch else None)
        launches[f"launch_{short}_{name}"] = {n: fn.launches for n, fn in counters.items()}
        if shape.kind == "train":
            records[arch] = rec
        foot = dryrun.analytic_footprint(cfg, shape, {"data": 1, "model": 1})["total"]
        per_row = "" if probe is None else (
            f"probes: peak {probe['peak_b1'] / 2**30:.2f} GiB at batch 1, "
            f"{probe['peak_b2'] / 2**30:.2f} at 2, {probe['per_row'] / 2**30:.3f} GiB a row; ")
        mean = sum(rec["ms"]) / len(rec["ms"])
        log(f"[launch] {arch} x {name} ({shape.kind}, seq {shape.seq_len}, global batch "
            f"{shape.global_batch}{', remat on' if shape.kind == 'train' and cfg.remat else ''}"
            f"): {per_row}ran at batch {batch}"
            f"{'' if batch == shape.global_batch else ', the largest the card holds'}; one "
            f"warm-up step at that batch, then ms "
            f"{', '.join(f'{t:.2f}' for t in rec['ms'])} (mean {mean:.2f}); peak "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB against the analytic {rec['footprint'] / 2**30:.2f}"
            f" GiB at batch {batch} ({foot / 2**30:.2f} GiB at {shape.global_batch}); roofline at "
            f"batch {batch}: compute {1e3 * rec['t_compute']:.3f} ms, memory "
            f"{1e3 * rec['t_memory']:.3f} ms, measured / max {rec['ms_over_bound']:.3f}; launches "
            f"{json.dumps({k: v for k, v in launches[f'launch_{short}_{name}'].items() if v})} | "
            f"{card}")
        log(f"[dryrun] roofline {arch} x {name} at batch {shape.global_batch} on 1x1: "
            f"{roofline_text(rep)}")
        if shape.kind != "decode":  # decode's launch_check runs the whole batch
            scale_check(torch, cfg, shape, batch, adapters)
        launch_check(torch, tr, dryrun, arch, cfg, shape, backbone, adapters)
        torch.cuda.empty_cache()
    if arch == H2O:
        attention_32k_check(torch, tr, dryrun, cfg0, backbone, adapters)
        chunked_loss_check(torch, tr, cfg0, backbone, adapters)
    if arch in FAR_LAYERS:
        far_decode_check(torch, tr, cfg0, backbone, adapters)
    del backbone, adapters
    torch.cuda.empty_cache()
    return launches


def outputs_gap(torch, got, want) -> float:
    """Largest max |got - want| / ‖want‖∞ over the tensors of two output trees."""
    from repro_torch.utils import tree_leaves

    gaps = [0.0]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite output")
        scale = float(w.float().abs().max())
        if scale > 0:
            gaps.append(float((g.float() - w.float()).abs().max()) / scale)
    return max(gaps)


def launch_check(torch, tr, dryrun, arch, cfg, shape, backbone, adapters):
    """The step with the kernels against the plain path (``use_pallas=False``:
    the plain attention, chunked past ``attn_chunk``, the plain LoRA and SSD)
    on the first LAUNCH_CHECK_LAYERS layers, in bf16 and in f32 on those
    layers upcast: train loss at LOSS_TOL and adapter gradients at GRAD_TOL
    (``step_check``), prefill logits and state and decode logits and state
    at LOGIT_TOL."""
    from repro_torch.utils import tree_map

    n = LAUNCH_CHECK_LAYERS[arch]
    ccfg, cut = cut_depth(cfg, backbone, n) if n < cfg.n_layers else (cfg, backbone)
    rows = shape.global_batch if shape.kind == "decode" else 1
    for dtype in ("bfloat16", "float32"):
        bb = cut if dtype == "bfloat16" else tree_map(lambda t: t.float(), cut)
        c = ccfg.with_(dtype=dtype)
        what = f"{arch} x {shape.name} ({n} of {cfg.n_layers} layers, batch {rows}, {dtype})"
        ins = dryrun.make_inputs(c, shape, rows, "cuda", seed=1)
        if shape.kind == "train":
            step_check(torch, tr, c, bb, (("launch step", adapters),), ins["batch"], what=what)
            continue
        if shape.kind == "decode":
            fill_random(torch, ins["state"], seed=2)
        plain_ins = tree_map(lambda t: t.clone(), ins)
        got = dryrun.step_runner(c, shape, bb, adapters)(ins)
        want = dryrun.step_runner(c.with_(use_pallas=False), shape, bb, adapters)(plain_ins)
        lg = outputs_gap(torch, got[1 if shape.kind == "prefill" else 0],
                         want[1 if shape.kind == "prefill" else 0])
        st = outputs_gap(torch, got[0 if shape.kind == "prefill" else 1],
                         want[0 if shape.kind == "prefill" else 1])
        if lg > LOGIT_TOL[dtype] or st > LOGIT_TOL[dtype]:
            raise AssertionError(f"{what}: kernels vs plain path, logits {lg:.3e}, state "
                                 f"{st:.3e} (bound {LOGIT_TOL[dtype]})")
        log(f"[launch-check] {what}: kernels vs plain path, logits {lg:.3e}, state {st:.3e} "
            f"of ‖ref‖∞ (bound {LOGIT_TOL[dtype]})")
        del got, want, ins, plain_ins, bb
        torch.cuda.empty_cache()


def scale_check(torch, cfg, shape, batch, adapters):
    """The kernels of a train or prefill run at the run's own batch, which
    ``launch_check`` (batch 1) does not reach, bf16 at the harness's bounds:
    LoRA on the batch x seq rows of d_model the text adapter sees (h2o-danube's
    prefill_32k at 24 rows: 2.0e9 elements, within 7 % of 2^31) against its
    plain version in blocks of SCALE_LORA_ROWS rows; flash on q (batch, S, H,
    hd), each row bit for bit the kernel's own batch-1 call on that row and
    the first and last rows against ``chunked_sdpa``; the SSD scan on x
    (batch, S, H, P) against its plain version in blocks of SCALE_SSD_ROWS."""
    from repro_torch.kernels import harness
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.kernels.lora import ref as lora_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    S = steps.text_seq_len(cfg, shape.seq_len)
    what = f"{cfg.name} x {shape.name} at batch {batch}"
    a, sc = adapters["text"], cfg.adapter.alpha / cfg.adapter.rank
    x = torch.randn((batch * S, cfg.d_model), generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        y = lora_ops.lora_residual(x, a["down"], a["up"], scale=sc)
        lora_err = max(harness.check_close(
            y[r0:r0 + SCALE_LORA_ROWS],
            lora_ref.lora_residual(x[r0:r0 + SCALE_LORA_ROWS], a["down"], a["up"], scale=sc),
            "bfloat16", f"{what}: lora rows {r0}..") for r0 in range(0, x.shape[0], SCALE_LORA_ROWS))
        del x, y
        if cfg.family == "ssm":
            m = cfg.ssm
            h = m.expand * cfg.d_model // m.head_dim
            args = ssd_inputs(torch, gen, batch, S, h, m.head_dim, m.d_state, bf16)
            y = ssd_ops.ssd(*args, chunk=m.chunk_size)
            errs = []
            for b0 in range(0, batch, SCALE_SSD_ROWS):
                part = [t if t.dim() == 1 else t[b0:b0 + SCALE_SSD_ROWS] for t in args]
                errs.append(harness.check_close(
                    y[b0:b0 + SCALE_SSD_ROWS], ssd_ref.ssd_chunked(*part, chunk=m.chunk_size),
                    "bfloat16", f"{what}: ssd rows {b0}..", harness.FULL_SSD_TOLERANCES))
            kernel = (f"ssd_scan at x ({batch}, {S}, {h}, {m.head_dim}) vs plain in blocks of "
                      f"{SCALE_SSD_ROWS} rows, max |err| {max(errs):.3e}")
            del args, y
        else:
            H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
            q = torch.randn((batch, S, H, hd), generator=gen, device="cuda").to(bf16)
            k, v = (torch.randn((batch, S, Hkv, hd), generator=gen, device="cuda").to(bf16)
                    for _ in range(2))
            kw = dict(causal=True, window=cfg.sliding_window, softcap=cfg.logit_softcap)
            o = fa_ops.flash_attention(q, k, v, **kw)
            for b in range(batch):
                if not torch.equal(o[b:b + 1], fa_ops.flash_attention(q[b:b + 1], k[b:b + 1],
                                                                      v[b:b + 1], **kw)):
                    raise AssertionError(f"{what}: flash row {b} differs from the kernel's "
                                         "batch-1 call on that row")
            errs = [harness.check_close(
                o[b:b + 1], attn.chunked_sdpa(cfg, q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                              chunk=cfg.attn_chunk),
                "bfloat16", f"{what}: flash row {b}") for b in sorted({0, batch - 1})]
            kernel = (f"flash_attention at q ({batch}, {S}, {H}, {hd}) on {Hkv} kv heads, window "
                      f"{cfg.sliding_window}: every row equal to the batch-1 call to the bit, rows "
                      f"0 and {batch - 1} vs chunked_sdpa (chunk {cfg.attn_chunk}) max |err| "
                      f"{max(errs):.3e}")
            del q, k, v, o
    torch.cuda.empty_cache()
    log(f"[launch-check] {what}, the kernels at the run's batch, bf16 (the harness's bounds): "
        f"lora_residual at x ({batch * S}, {cfg.d_model}) = {batch * S * cfg.d_model:.3e} "
        f"elements vs plain in blocks of {SCALE_LORA_ROWS} rows, max |err| {lora_err:.3e}; "
        f"{kernel}")


def attention_32k_check(torch, tr, dryrun, cfg0, backbone, adapters):
    """h2o-danube at prefill_32k on batch 1 and 2 layers, ``attn_chunk``
    1,024 as ``exec_config``'s full mode sets it: the flash kernel against
    ``chunked_sdpa`` on the first layer's q, k, v of the kernel run (32,768
    positions, window 4,096), f32 at ATTN_F32_TOL; the bf16 gap printed."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn
    from repro_torch.utils import tree_map

    shape = INPUT_SHAPES["prefill_32k"]
    cfg, cut = cut_depth(steps.exec_config(cfg0, shape, "full"), backbone, 2)
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.with_(dtype=dtype)
        bb = cut if dtype == "bfloat16" else tree_map(lambda t: t.float(), cut)
        seen, wrapper = [], fa_ops.flash_attention

        def record(q, k, v, **kw):
            if not seen:
                seen.append((q, k, v, kw))
            return wrapper(q, k, v, **kw)

        record.launches = 0  # the comparison's launches stay off the counters
        fa_ops.flash_attention = record
        try:
            dryrun.step_runner(c, shape, bb, adapters)(dryrun.make_inputs(c, shape, 1, "cuda",
                                                                          seed=3))
        finally:
            fa_ops.flash_attention = wrapper
        q, k, v, kw = seen[0]
        with torch.no_grad():
            got = wrapper(q, k, v, **kw)
            want = attn.chunked_sdpa(c, q, k, v, chunk=c.attn_chunk)
        gaps[dtype] = float((got.float() - want.float()).abs().max()) / float(
            want.float().abs().max())
        del seen, q, k, v, got, want, bb
        torch.cuda.empty_cache()
    if gaps["float32"] > ATTN_F32_TOL:
        raise AssertionError(f"flash vs chunked_sdpa at 32,768 positions: {gaps}")
    log(f"[launch-check] {cfg0.name} flash vs chunked_sdpa (chunk {cfg.attn_chunk}) at q "
        f"(1, {shape.seq_len}, {cfg.n_heads}, {cfg.resolved_head_dim}) on {cfg.n_kv_heads} kv "
        f"heads, window {cfg.sliding_window}, layer 0 of the prefill_32k step: f32 "
        f"{gaps['float32']:.3e} (bound {ATTN_F32_TOL}), bf16 {gaps['bfloat16']:.3e} (printed)")


def chunked_loss_check(torch, tr, cfg0, backbone, adapters):
    """``chunked_lm_loss`` against the full logits' ``lm_loss`` at h2o-danube's
    train_4k rows (batch 2 x 4,096, 2 layers, f32, kernels on): the step's
    loss and adapter gradients at CHUNKED_LOSS_TOL; and the loss head alone
    on the same final hidden states (loss and d/dhidden at the same bound),
    with the peak memory each takes above its inputs."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import chunked_lm_loss, lm_loss
    from repro_torch.utils import tree_map

    shape = INPUT_SHAPES["train_4k"]
    rows, chunk = 2, 1024
    cfg, cut = cut_depth(cfg0.with_(dtype="float32"), backbone, 2)
    bb = tree_map(lambda t: t.float(), cut)
    batch = dryrun.make_inputs(cfg, shape, rows, "cuda", seed=4)["batch"]
    out = {}
    for label, c in (("lm_loss", cfg), ("chunked_lm_loss", cfg.with_(loss_chunk=chunk))):
        loss, _, grads = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](c, bb, a, batch), adapters)
        out[label] = (float(loss), grads)
    (lf, gf), (lc, gc) = out["lm_loss"], out["chunked_lm_loss"]
    le, ge = abs(lc - lf) / abs(lf), tree_rel_err(gc, gf)
    # the loss head alone: the same hidden states, the untied table
    model, nano = tr["model"], tr["adapters"]
    with torch.no_grad():
        emb, pos, labels, mask, _ = nano.nanoedge_forward(cfg, bb, adapters, batch)
        hidden = model.forward(cfg, bb, emb, pos)[0]
    table = bb["unembed"]["table"]
    head, peaks = {}, {}
    for label, fn in (("lm_loss", lambda h: lm_loss(model.logits(cfg, bb, h), labels, mask)),
                      ("chunked_lm_loss", lambda h: chunked_lm_loss(h, table, labels, mask,
                                                                    chunk=chunk))):
        h = hidden.detach().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        val = fn(h)
        (dh,) = torch.autograd.grad(val, h)
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() - base
        head[label] = (float(val.detach()), dh)
        del val, h
    hv = abs(head["chunked_lm_loss"][0] - head["lm_loss"][0]) / abs(head["lm_loss"][0])
    hg = rel_err([head["chunked_lm_loss"][1]], [head["lm_loss"][1]])
    if max(le, ge, hv, hg) > CHUNKED_LOSS_TOL:
        raise AssertionError(f"chunked_lm_loss vs lm_loss: step loss {lc} vs {lf}, adapter "
                             f"grads {ge:.3e}; head loss {hv:.3e}, d/dhidden {hg:.3e}")
    log(f"[launch-check] {cfg0.name} chunked_lm_loss (chunk {chunk}) vs lm_loss at batch {rows} "
        f"x {shape.seq_len}, 2 layers, f32: step loss {lc:.7f} vs {lf:.7f} (rel {le:.3e}), "
        f"adapter grads {ge:.3e}; loss head alone: loss {hv:.3e}, d/dhidden {hg:.3e} (bound "
        f"{CHUNKED_LOSS_TOL}); the head's peak above its inputs {peaks['chunked_lm_loss'] / 2**30:.3f}"
        f" GiB chunked vs {peaks['lm_loss'] / 2**30:.3f} GiB full logits (vocab "
        f"{cfg.vocab_size}, {rows * shape.seq_len * cfg.vocab_size * 4 / 1e9:.2f} GB of f32 "
        f"logits)")


def far_decode_check(torch, tr, cfg0, backbone, adapters):
    """The decode step at position 524,287 in f32 on the first FAR_LAYERS
    layers: tokens at positions p0 .. 524,287 (p0 a multiple of the ring's C
    slots, 2C positions), the text adapter on their embeddings, prefilled to
    524,287 - FAR_STEPS + 1 and decoded teacher-forced to 524,287; every
    decode step's logits held at LOGIT_TOL against the full windowed forward
    of the 2C tokens at the same absolute positions, through the kernels and
    through the plain versions."""
    from repro_torch.core import adapters as nano
    from repro_torch.utils import tree_map

    model = tr["model"]
    n = FAR_LAYERS[cfg0.name]
    cfg, cut = cut_depth(cfg0.with_(dtype="float32"), backbone, n)
    cut = tree_map(lambda t: t.float(), cut)
    ring = cfg.rglru.local_window if cfg.family == "hybrid" else cfg.sliding_window
    N = 2 * ring
    p0 = FAR_POS + 1 - N
    if p0 % ring:
        raise AssertionError(f"start {p0} is not a multiple of the ring's {ring} slots")
    tol = LOGIT_TOL["float32"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, N), generator=gen, device="cuda")
    pos = torch.arange(p0, p0 + N, device="cuda")[None]
    a = adapters["text"]
    with torch.no_grad():
        emb = nano.nano_adapter_apply(a, model.embed_tokens(cfg, cut, tokens),
                                      rank=cfg.adapter.rank, alpha=cfg.adapter.alpha,
                                      use_pallas=True)
        full = model.logits(cfg, cut, model.forward(cfg, cut, emb, pos)[0])[0]
        with plain_versions():
            plain = model.logits(cfg, cut, model.forward(cfg, cut, emb, pos)[0])[0]
        gap = rel_err([full], [plain])
        P = N - FAR_STEPS
        state, _ = model.prefill(cfg, cut, emb[:, :P], pos[:, :P], capacity=N)
        errs = []
        for t in range(P, N):
            got, state = model.decode_step(cfg, cut, emb[:, t:t + 1], state, p0 + t)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{cfg.name}: non-finite decode logits at {p0 + t}")
            errs.append(max(rel_err([got[0, 0]], [full[t]]), rel_err([got[0, 0]], [plain[t]])))
    if gap > tol or max(errs) > tol:
        raise AssertionError(f"{cfg.name} decode at {FAR_POS}: forward kernels vs plain "
                             f"{gap:.3e}, decode vs forward {errs} (bound {tol})")
    log(f"[launch-check] {cfg.name} f32 far decode ({n} of {cfg0.n_layers} layers, {ring}-slot "
        f"ring): positions {p0}..{FAR_POS}, prefilled to {p0 + P - 1}, {FAR_STEPS} decode steps "
        f"to {FAR_POS}: worst {max(errs):.3e} (at {p0 + P + errs.index(max(errs))}), last "
        f"{errs[-1]:.3e}; forward kernels vs plain {gap:.3e} (bound {tol} of ‖ref‖∞)")


def launch_timings(torch, F, fa_ops, lora_ops, lora_ref, ssd_ops, ssd_ref):
    """The kernels at the shapes phase 20 gives them, beside their plain
    versions, a library call where one fits, and the bound: flash at
    h2o-danube's prefill_32k q (1, 32768, 32, 80) on 8 kv heads, window 4,096
    (plain: ``chunked_sdpa``, chunk 1,024, as sdpa's (S, S) scores do not
    fit; SDPA on the memory-efficient backend with a band mask, K/V heads
    repeated); LoRA at decode_32k's 128 rows of 2,560; the SSD scan at
    mamba2-130m's prefill_32k x (1, 32768, 24, 64). Slow plain versions are
    timed by events over 2 calls. -> rows by kernel."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16 = torch.bfloat16
    cfg = get_config(H2O).with_(attn_chunk=1024)
    B, S, H, Hkv, hd, w = 1, 32768, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 4096
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(bf16) for _ in range(2))
    kw = dict(causal=True, window=w)
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
    b_ms, b_by = bound(nbytes(q, k, v, o, lse), 4 * hd * causal_pairs(S, w) * H * B, "bf16")
    k_ms, k_is = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw), iters=10)
    c_ms = time_ms_cold(torch, lambda *a: fa_ops.flash_attention(*a, **kw), (q, k, v),
                        nbytes(q, k, v, o, lse), iters=10)
    with torch.no_grad():
        p_ms = time_events(torch, lambda: attn.chunked_sdpa(cfg, q, k, v, chunk=1024), iters=2)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous() for t in (k, v))
    mask = attn.causal_mask(S, S, window=w, device="cuda")
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2)
            lib_err = float((lib.float() - o.float()).abs().max())
            del lib
            l_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                            attn_mask=mask),
                              iters=5)
        lib_note = (f"{l_ms:.5f} (memory-efficient backend, band mask of window {w}, max abs "
                    f"difference from the kernel {lib_err:.3e})")
    except RuntimeError as e:  # a library yardstick only: no backend takes this call
        l_ms, lib_note = None, f"None (SDPA with a band mask at {S}: {str(e)[:120]})"
    del qt, kt, vt, mask
    torch.cuda.empty_cache()
    log(f"[time] flash_attention at q ({B}, {S}, {H}, {hd}) k/v Hkv {Hkv} bf16 causal window "
        f"{w} (h2o-danube-1.8b prefill_32k), device ms per call: kernel {k_ms:.5f} ({k_is:.5f} "
        f"issued), cold {c_ms:.5f} | plain chunked_sdpa (chunk 1024) {p_ms:.5f} | library SDPA "
        f"{lib_note} | bound {b_ms:.5f} ({b_by}) | bound / time: warm {b_ms / k_ms:.3f}, cold "
        f"{b_ms / c_ms:.3f}")
    rows = {"flash_attention": {"h2o prefill_32k": dict(
        ms=k_ms, cold_ms=c_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        shape=[B, S, H, Hkv, hd, w])}}
    del q, k, v, o, lse
    x = torch.randn((128, cfg.d_model), generator=gen, device="cuda").to(bf16)
    A = torch.randn((cfg.d_model, 64), generator=gen, device="cuda") * 0.05
    Bm = torch.randn((64, cfg.d_model), generator=gen, device="cuda") * 0.05
    rows["lora_residual"] = {"h2o decode_32k (128, 2560)": lora_timing(
        torch, lora_ops, lora_ref, x, A, Bm, " (h2o-danube-1.8b decode_32k rows)")}
    m = get_config(MAMBA).ssm
    h = m.expand * get_config(MAMBA).d_model // m.head_dim
    args = ssd_inputs(torch, gen, 1, S, h, m.head_dim, m.d_state, bf16)
    q_ = m.chunk_size
    n_bytes, n_ops = ssd_work(1, S, h, m.head_dim, m.d_state, q_, 2)
    b_ms, b_by = bound(n_bytes, n_ops, "bf16")
    k_ms, k_is = time_ms(torch, lambda: ssd_ops.ssd(*args, chunk=q_), iters=10)
    c_ms = time_ms_cold(torch, lambda *a: ssd_ops.ssd(*a, chunk=q_), args, n_bytes, iters=10)
    with torch.no_grad():
        p_ms = time_events(torch, lambda: ssd_ref.ssd_chunked(*args, chunk=q_), iters=2)
    log(f"[time] ssd_scan at x (1, {S}, {h}, {m.head_dim}) bf16, N {m.d_state}, chunk {q_} "
        f"(mamba2-130m prefill_32k): device ms per call: kernel {k_ms:.5f} ({k_is:.5f} issued), "
        f"cold {c_ms:.5f} | plain {p_ms:.5f} | library None | bound {b_ms:.5f} ({b_by}; "
        f"{n_ops / 1e9:.4f} GFLOP, {n_bytes / 1e6:.3f} MB) | bound / time: warm "
        f"{b_ms / k_ms:.3f}, cold {b_ms / c_ms:.3f}")
    rows["ssd_scan"] = {"prefill_32k (1, 32768)": dict(
        shape=[1, S, h, m.head_dim, m.d_state, q_], ms=k_ms, cold_ms=c_ms, plain_ms=p_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by)}
    del args
    torch.cuda.empty_cache()
    return rows


def launch_phase(torch, tr, counters, kernels):
    """Phase 20: the fit table, each LAUNCH_RUNS arch at its shapes, then the
    kernels at phase 20's shapes (``kernels``: the ops and plain-version
    modules ``launch_timings`` takes). -> (launches by run, timing rows, the
    train runs' records by arch)."""
    from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    card = card_line()
    torch.cuda.empty_cache()
    fit_table(dryrun, ASSIGNED_ARCHS, INPUT_SHAPES)
    log(f"[dryrun] fit table: {time.perf_counter() - t0:.1f} s")
    launches, records = {}, {}
    # Their steps allocate blocks of about 10 GB. After the earlier phases the
    # caching allocator's segments had no room left for one (20.60 GiB reserved
    # but unallocated at h2o-danube's prefill_32k, 23 rows, on an H100 80GB), so
    # the runs take expandable segments; the timings after them capture CUDA
    # graphs, with the default segments again.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch, shapes in LAUNCH_RUNS:
            launches.update(launch_arch(torch, tr, counters, dryrun, arch, shapes, card,
                                        records))
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    for name in LAUNCH_KERNELS:
        if not sum(v[name] for v in launches.values()):
            raise AssertionError(f"phase 20 never launched the {name} kernel: {launches}")
    rows = launch_timings(torch, *kernels)
    log(f"[phase20] the launch step functions at the production shapes: "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return launches, rows, records


# ---------------------------------------------------------------------------
# phase 21: the three examples
# ---------------------------------------------------------------------------

# (a) at the JAX examples' own tiny dims, f32: the card (kernels) against the
# CPU (plain versions), from the same CPU-drawn weights
EXAMPLES_VQA_SMOKE = dict(rounds=2, clients=3, local_steps=2)
EXAMPLES_TOL = 1e-5
# (b) llava-1.5-7b at full width, bf16 weights from seed 0, kernels against
# the plain versions: 2 of quickstart's epochs, federated VQA's three
# strategies over 2 clients x 2 rounds x 2 local steps, split serving's 8
# requests of 5 tokens
EXAMPLES_FULL_EPOCHS = 2
EXAMPLES_VQA_FULL = dict(strategies=("locft", "fedavg", "fednano"), rounds=2, clients=2,
                         local_steps=2)
EXAMPLES_KERNELS = ("lora_residual", "flash_attention", "fisher_merge")


def to_cuda(tree):
    from repro_torch.utils import tree_map

    return tree_map(lambda t: t.to("cuda"), tree)


def server_to_cuda(server):
    return dataclasses.replace(server, backbone=to_cuda(server.backbone),
                               global_adapters=to_cuda(server.global_adapters))


def first_difference_ties(torch, got, want):
    """Each request whose tokens differ: (request, first differing step, the
    top-2 gap of ``want``'s logits there relative to their ∞-norm). Raises
    unless every such gap is a near tie (under NEAR_TIE)."""
    ties = []
    for i, (a, b) in enumerate(zip(got["tokens"], want["tokens"])):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = want["step_logits"][k][i].float()
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1]) / float(lg.abs().max())
        if gap >= NEAR_TIE:
            raise AssertionError(f"split serving request {i}: tokens {a} vs {b} part at step "
                                 f"{k}, where the top-2 logits are {gap:.3e} of ‖logits‖∞ "
                                 f"apart (a near tie needs < {NEAR_TIE})")
        ties.append((i, k, gap))
    return ties


def vqa_losses(out):
    return {name: [m["mean_loss"] for m in res.round_metrics]
            for name, res in out["results"].items()}


class _Recording:
    """An ops module as its caller sees it, with one wrapper replaced."""

    def __init__(self, module, name, fn):
        self._module, self._name, self._fn = module, name, fn

    def __getattr__(self, attr):
        return self._fn if attr == self._name else getattr(self._module, attr)


@contextlib.contextmanager
def path_inputs(record):
    """Route the examples' path's calls of the LoRA, flash-attention and
    Fisher-merge wrappers through a recorder: for each distinct shape and
    dtype it keeps the last call's inputs in ``record`` (references to the
    path's own tensors, no copies), then calls the wrapper as before. The
    recorder stands in the callers' modules (the NanoEdge adapters, the
    attention, the aggregation), so the ops modules and their launch counts
    are untouched."""
    from repro_torch.core import adapters as adapters_lib, aggregation
    from repro_torch.models import attention

    lora, flash, merge = (adapters_lib.lora_ops.lora_residual,
                          attention.flash_ops.flash_attention,
                          aggregation.fm_ops.fisher_merge_leaves)

    def dtype_of(t):
        return str(t.dtype).removeprefix("torch.")

    def rec_lora(x, down, up, *, scale):
        record[("lora_residual", tuple(x.shape), dtype_of(x))] = (
            (x.detach(), down.detach(), up.detach()), dict(scale=scale))
        return lora(x, down, up, scale=scale)

    def rec_flash(q, k, v, **kw):
        record[("flash_attention", tuple(q.shape), tuple(k.shape), dtype_of(q))] = (
            (q.detach(), k.detach(), v.detach()), kw)
        return flash(q, k, v, **kw)

    def rec_merge(thetas, fishers, weights, **kw):
        record[("fisher_merge", len(thetas), sum(t.numel() for t in thetas[0]),
                dtype_of(thetas[0][0]))] = ((thetas, fishers, weights), kw)
        return merge(thetas, fishers, weights, **kw)

    swaps = [(adapters_lib, "lora_ops", "lora_residual", rec_lora),
             (attention, "flash_ops", "flash_attention", rec_flash),
             (aggregation, "fm_ops", "fisher_merge_leaves", rec_merge)]
    modules = [getattr(caller, attr) for caller, attr, _, _ in swaps]
    try:
        for (caller, attr, name, fn), module in zip(swaps, modules):
            setattr(caller, attr, _Recording(module, name, fn))
        yield
    finally:
        for (caller, attr, _, _), module in zip(swaps, modules):
            setattr(caller, attr, module)


def hold_path_inputs(torch, record, what):
    """Each recorded call of the examples' path again through its wrapper,
    held against its plain version on the same inputs at the harness's bound
    for the inputs' dtype (``harness.TOLERANCES``), the bf16 LoRA and flash
    calls also against their rounding models at BF16_MODEL_TOLERANCES, as
    the parity phase holds them. Logs one line per call; these launches fall
    outside the counted runs."""
    from repro_torch.kernels import harness
    from repro_torch.kernels.fisher_merge import ops as fm_ops, ref as fm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops, ref as lora_ref

    if not record:
        raise AssertionError(f"{what}: no kernel call of the path was recorded")
    calls = []  # (label, dtype, kernel, plain version, rounding model or None, args, kw)
    for key, (args, kw) in sorted(record.items(), key=lambda kv: str(kv[0])):
        name, dtype = key[0], key[-1]
        label = f"{what} {name} {key[1:-1]} {dtype}"
        if name == "lora_residual":
            x, down, up = args
            x = x.reshape(-1, x.shape[-1])
            model = lora_ref.lora_residual_split_tf32 if dtype == "bfloat16" else None
            calls.append((label, dtype, lora_ops.lora_residual, lora_ref.lora_residual, model,
                          (x, down, up), kw))
            # the path's rows again with a random up-projection scaled so that
            # the adapter term's ∞-norm is max(1, ‖x‖∞): the harness's bounds,
            # relative to max(1, ‖ref‖∞), then see a kernel that drops or
            # garbles the term (the path's own up-projection may be 0)
            gen = torch.Generator(device=up.device).manual_seed(0)
            up = torch.randn(up.shape, generator=gen, device=up.device, dtype=up.dtype)
            with torch.no_grad():
                term = (kw["scale"] * (x.float() @ down.float()) @ up.float()).abs().max()
                up = up * (max(1.0, float(x.float().abs().max())) / float(term))
            calls.append((label + " (random up, term max(1, ‖x‖∞))", dtype,
                          lora_ops.lora_residual, lora_ref.lora_residual, model,
                          (x, down, up), kw))
        elif name == "flash_attention":
            model = fa_ref.attention_bf16_model if dtype == "bfloat16" else None
            calls.append((label, dtype, fa_ops.flash_attention, fa_ref.attention, model, args,
                          kw))
        else:
            flat = lambda fn: lambda *a, **k: torch.cat([t.flatten() for t in fn(*a, **k)])
            calls.append((label, dtype, flat(fm_ops.fisher_merge_leaves),
                          flat(fm_ref.fisher_merge_leaves), None, args, kw))
    for label, dtype, kernel, plain, model, args, kw in calls:
        with torch.no_grad():
            got, want = kernel(*args, **kw), plain(*args, **kw)
            ref_model = None if model is None else model(*args, **kw)
        err = harness.check_close(got, want, dtype, label)
        bound = harness.TOLERANCES[dtype]
        line = (f"kernel vs plain max |err| {err:.3e}, max |err| / max(1, ‖ref‖∞) "
                f"{rel_gap(got, want)[0]:.3e} (bound rtol {bound['rtol']}, atol "
                f"{bound['atol_scale']}; ‖ref‖∞ {float(want.float().abs().max()):.3e})")
        if ref_model is not None:
            harness.check_close(got, ref_model, dtype, f"{label} vs model",
                                harness.BF16_MODEL_TOLERANCES)
            mb = harness.BF16_MODEL_TOLERANCES[dtype]
            line += (f"; vs its rounding model {rel_gap(got, ref_model)[0]:.3e} (bound rtol "
                     f"{mb['rtol']}, atol {mb['atol_scale']})")
        if kernel is lora_ops.lora_residual:
            x = args[0]
            line += (f"; adapter term ‖s·(x·A)·B‖∞ "
                     f"{float((want.float() - x.float()).abs().max()):.3e} beside ‖x‖∞ "
                     f"{float(x.float().abs().max()):.3e}")
        log(f"[examples-kernels] {label}: {line}")
    torch.cuda.synchronize()


def examples_smoke(torch, examples, init_backbone, init_server, card):
    """Phase 21a: each example at its own tiny dims, f32, on the card with the
    kernels against the CPU on the plain versions, from the same weights."""
    quickstart, federated_vqa, split_serving = examples
    t0 = time.perf_counter()
    cfg = quickstart.tiny_config()
    backbone = init_backbone(cfg, seed=0, device="cpu")
    cpu = quickstart.run(cfg, device="cpu", backbone=backbone)
    gpu = quickstart.run(cfg.with_(use_pallas=True), device="cuda", backbone=to_cuda(backbone))
    errs = [abs(a - b) / abs(b) for a, b in zip(gpu["epoch_losses"], cpu["epoch_losses"])]
    if gpu["param_count"] != cpu["param_count"] or max(errs) > EXAMPLES_TOL:
        raise AssertionError(f"quickstart card vs CPU: epoch losses {gpu['epoch_losses']} vs "
                             f"{cpu['epoch_losses']}")
    log(f"[examples-smoke] quickstart f32, card (kernels) vs CPU (plain versions): epoch losses "
        f"{gpu['epoch_losses']} vs {cpu['epoch_losses']} (max rel {max(errs):.3e}, bound "
        f"{EXAMPLES_TOL}); {gpu['param_count']:,} adapter params")

    cfg = federated_vqa.scale_config("tiny")
    server = init_server(cfg, seed=0, device="cpu")
    cpu = federated_vqa.run(cfg, device="cpu", server=server, verbose=False,
                            **EXAMPLES_VQA_SMOKE)
    gpu = federated_vqa.run(cfg.with_(use_pallas=True), device="cuda",
                            server=server_to_cuda(server), verbose=False, **EXAMPLES_VQA_SMOKE)
    gl, cl = vqa_losses(gpu), vqa_losses(cpu)
    worst = 0.0
    for name in cl:
        g, c = gpu["results"][name], cpu["results"][name]
        errs = [abs(a - b) / abs(b) for a, b in zip(gl[name], cl[name])]
        acc = max(abs(g.client_accuracy[k] - c.client_accuracy[k]) for k in c.client_accuracy)
        if (len(errs) != len(cl[name]) or max(errs) > EXAMPLES_TOL or acc > EXAMPLES_TOL
                or g.comm_totals != c.comm_totals):
            raise AssertionError(f"federated VQA {name} card vs CPU: losses {gl[name]} vs "
                                 f"{cl[name]}, accuracy {g.client_accuracy} vs "
                                 f"{c.client_accuracy}, comm {g.comm_totals} vs {c.comm_totals}")
        worst = max(worst, *errs, acc)
    log(f"[examples-smoke] federated VQA f32 {EXAMPLES_VQA_SMOKE}, card (kernels) vs CPU (plain "
        f"versions): round losses {gl} vs {cl}, per-client accuracies and round losses within "
        f"{worst:.3e} (bound {EXAMPLES_TOL}); ledger {gpu['ledger_name']} {gpu['ledger']} equal")

    cfg = split_serving.tiny_config()
    backbone = init_backbone(cfg, seed=0, device="cpu")
    cpu = split_serving.run(cfg, device="cpu", backbone=backbone)
    gpu = split_serving.run(cfg.with_(use_pallas=True), device="cuda",
                            backbone=to_cuda(backbone))
    ties = first_difference_ties(torch, gpu, cpu)
    wire = [(k, gpu[k], cpu[k]) for k in ("wire_up", "wire_down", "backbone_bytes")]
    if any(g != c for _, g, c in wire):
        raise AssertionError(f"split serving card vs CPU: wire bytes {wire}")
    log(f"[examples-smoke] split serving f32, card (kernels) vs CPU (plain versions): tokens "
        f"{'equal' if not ties else 'equal but near ties ' + str(ties)}; wire bytes "
        f"{[(k, g) for k, g, _ in wire]} equal; {time.perf_counter() - t0:.1f} s on {card}")


def examples_full(torch, examples, counters, init_server, get_config, card):
    """Phase 21b: the three examples at llava-1.5-7b's full width, bf16, kernels
    on, counters reset around each run; each again on the plain versions from
    the same weights. -> the launches of the kernel runs."""
    quickstart, federated_vqa, split_serving = examples
    t0 = time.perf_counter()
    cfg = get_config("llava-1.5-7b").with_(use_pallas=True)
    server = init_server(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[examples] llava-1.5-7b {cfg.n_layers} layers, d_model {cfg.d_model}, backbone "
        f"{cfg.dtype}, rank-{cfg.adapter.rank} {cfg.adapter.dtype} adapters: drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {n: 0 for n in counters}

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {n: f.launches for n, f in counters.items()}
        for n in got:
            launches[n] += got[n]
        return out, got, torch.cuda.max_memory_allocated() / 2**30

    def plain(fn):
        with plain_versions():
            return fn()

    quick = lambda: quickstart.run(cfg, device="cuda", backbone=server.backbone,
                                   epochs=EXAMPLES_FULL_EPOCHS)
    with path_inputs(rec := {}):
        qk, ql, qpeak = counted(quick)
    hold_path_inputs(torch, rec, "quickstart")
    qp = plain(quick)
    err = abs(qk["epoch_losses"][0] - qp["epoch_losses"][0]) / abs(qp["epoch_losses"][0])
    if not all(math.isfinite(x) for x in qk["epoch_losses"]) or err > RUN_LOSS_TOL_BF16:
        raise AssertionError(f"quickstart full width: epoch losses {qk['epoch_losses']} vs plain "
                             f"{qp['epoch_losses']}")
    steps = qk["step_s"]
    log(f"[examples] quickstart llava-1.5-7b bf16, {EXAMPLES_FULL_EPOCHS} epochs of "
        f"{len(steps) // EXAMPLES_FULL_EPOCHS} batches of 8 x (8 patches + 24 tokens): epoch "
        f"losses kernels {qk['epoch_losses']} plain {qp['epoch_losses']} (epoch 0 rel "
        f"{err:.3e}, bound {RUN_LOSS_TOL_BF16}; later epochs reported); ms per step "
        f"{1e3 * sum(steps[1:]) / len(steps[1:]):.3f} (first step {1e3 * steps[0]:.3f}); peak "
        f"memory {qpeak:.2f} GiB; {qk['param_count']:,} adapter params | launches "
        f"{json.dumps(ql)} | {card}")

    vqa = lambda: federated_vqa.run(cfg, device="cuda", server=server, verbose=False,
                                    **EXAMPLES_VQA_FULL)
    with path_inputs(rec := {}):
        vk, vl, vpeak = counted(vqa)
    hold_path_inputs(torch, rec, "federated VQA")
    vp = plain(vqa)
    kl, pl = vqa_losses(vk), vqa_losses(vp)
    for name in kl:
        e0 = abs(kl[name][0] - pl[name][0]) / abs(pl[name][0])
        if not all(math.isfinite(x) for x in kl[name]) or e0 > RUN_LOSS_TOL_BF16:
            raise AssertionError(f"federated VQA {name} full width: round losses {kl[name]} vs "
                                 f"plain {pl[name]}")
    wall = {n: round(s, 3) for n, s in vk["wall_s"].items()}
    per_round = {n: round(s / EXAMPLES_VQA_FULL["rounds"], 3) for n, s in wall.items()}
    log(f"[examples] federated VQA llava-1.5-7b bf16 {EXAMPLES_VQA_FULL}: round losses kernels "
        f"{kl} plain {pl} (round 0 held at {RUN_LOSS_TOL_BF16}, round 1 reported); per-client "
        f"accuracy {({n: r.client_accuracy for n, r in vk['results'].items()})}; wall s per "
        f"strategy {wall} (the rounds and the final eval), a round {per_round}; ledger "
        f"{vk['ledger_name']} {vk['ledger']}; peak memory {vpeak:.2f} GiB | launches "
        f"{json.dumps(vl)} | {card}")

    split = lambda: split_serving.run(cfg, device="cuda", backbone=server.backbone)
    with path_inputs(rec := {}):
        sk, sl, speak = counted(split)
    hold_path_inputs(torch, rec, "split serving")
    sp = plain(split)
    first = sum(a[0] == b[0] for a, b in zip(sk["tokens"], sp["tokens"]))
    same = sum(x == y for a, b in zip(sk["tokens"], sp["tokens"]) for x, y in zip(a, b))
    total = sum(len(a) for a in sk["tokens"])
    dec = sk["decode_step_s"]
    log(f"[examples] split serving llava-1.5-7b bf16, 8 requests x 5 tokens: tokens kernels vs "
        f"plain versions: first tokens equal {first}/8, all tokens equal {same}/{total} "
        f"(reported); prefill ms {1e3 * sk['prefill_s']:.3f}, decode step ms "
        f"{1e3 * sum(dec) / len(dec):.3f} ({[round(1e3 * d, 3) for d in dec]}); wire bytes up "
        f"{sk['wire_up']} down {sk['wire_down']} vs the backbone's {sk['backbone_bytes']}; peak "
        f"memory {speak:.2f} GiB | launches {json.dumps(sl)} | {card}")
    del server
    torch.cuda.empty_cache()
    for name in EXAMPLES_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"phase 21 never launched the {name} kernel: {launches}")
    return launches


def examples_phase(torch, counters, init_backbone, init_server, get_config):
    """Phase 21: the port's three examples through their ``run`` functions.
    -> {"examples": launches per kernel on the full-width kernel runs}."""
    from repro_torch.examples import federated_vqa, quickstart, split_serving

    examples = (quickstart, federated_vqa, split_serving)
    t0 = time.perf_counter()
    card = card_line()
    torch.cuda.empty_cache()
    examples_smoke(torch, examples, init_backbone, init_server, card)
    launches = examples_full(torch, examples, counters, init_server, get_config, card)
    log(f"[phase21] the examples: {time.perf_counter() - t0:.1f} s on {card}")
    return {"examples": launches}


# ---------------------------------------------------------------------------
# phase 22: remat, each layer body checkpointed in training
# ---------------------------------------------------------------------------

# train_4k at full width and depth, bf16, kernels on, with remat off; phase 20
# ran the same shape with remat on (every full config's default).
REMAT_RUNS = (H2O, MAMBA)
# The other families, held on against off at the depths their phases run:
# llama4-scout (moe) at MOE_LAYERS, recurrentgemma-9b and whisper-base in full.
REMAT_HOLD_ARCHS = ("llama4-scout-17b-a16e",) + NEW_ARCHS
# launched inside a layer body, so once more a layer in remat's recompute
REMAT_KERNELS = ("flash_attention", "ssd_scan")
REMAT_ITERS = 3  # llava-1.5-7b's local step: one warm-up step, then these timed


def grads_equal(torch, a, b) -> bool:
    from repro_torch.utils import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def remat_hold(torch, tr, counters, cfg, backbone, adapters, batch, what):
    """One step's loss and adapter gradients with remat on and off, on the
    same weights, adapters and batch: equal to the bit, as the recompute
    runs the same kernels on the same inputs and no kernel uses atomics.
    Each run's launches are counted with the counters reset just before it:
    flash attention and the SSD scan launch once more a layer with remat,
    every other kernel as often. The peak is above the memory allocated
    before the step. -> launches by setting."""
    out = {}
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for fn in counters.values():
            fn.launches = 0
        loss, _, grads = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](c, backbone, a, batch), adapters, allow_unused=True)
        torch.cuda.synchronize()
        out[remat] = (loss, grads, {n: fn.launches for n, fn in counters.items()},
                      torch.cuda.max_memory_allocated() - base)
    (l_on, g_on, n_on, p_on), (l_off, g_off, n_off, p_off) = out[True], out[False]
    if (not math.isfinite(float(l_on)) or not torch.equal(l_on, l_off)
            or not grads_equal(torch, g_on, g_off)):
        raise AssertionError(f"[remat] {what}: remat on vs off not equal to the bit: loss "
                             f"{float(l_on)} vs {float(l_off)}, adapter grads "
                             f"{tree_rel_err(g_on, g_off):.3e} of ‖ref‖∞ apart")
    want = {n: (2 if n in REMAT_KERNELS else 1) * v for n, v in n_off.items()}
    if n_on != want or not any(n_off[n] for n in REMAT_KERNELS):
        raise AssertionError(f"[remat] {what}: launches with remat {n_on}, without {n_off}; "
                             f"want flash and SSD launched once more a layer: {want}")
    log(f"[remat] {what}, {cfg.dtype}, kernels on: one step's loss and adapter gradients, "
        f"remat on vs off: equal to the bit (loss {float(l_on):.7f}); launches on "
        f"{json.dumps({n: v for n, v in n_on.items() if v})}, off "
        f"{json.dumps({n: v for n, v in n_off.items() if v})}; peak above the resident "
        f"memory on {p_on / 2**30:.3f} GiB, off {p_off / 2**30:.3f} GiB")
    return {"on": n_on, "off": n_off}


def flash_bwd_peak(torch, cfg, s: int) -> int:
    """Bytes the flash backward of one layer (the bf16 kernel) takes above
    its inputs at batch 1 and ``s`` positions, measured alone."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(17)
    hd = cfg.resolved_head_dim
    q, g = (torch.randn((1, s, cfg.n_heads, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, s, cfg.n_kv_heads, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=cfg.sliding_window, softcap=cfg.logit_softcap)
    with torch.no_grad():
        out, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = fa_ops._backward(q, k, v, out, lse, g, **kw)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del q, k, v, g, out, lse, grads
    torch.cuda.empty_cache()
    return peak


def remat_line(rec) -> str:
    probe = rec["probe"]
    mean = sum(rec["ms"]) / len(rec["ms"])
    return (f"peak a row {probe['per_row'] / 2**30:.3f} GiB (probes {probe['peak_b1'] / 2**30:.2f}"
            f" GiB at batch 1, {probe['peak_b2'] / 2**30:.2f} at 2), holds {rec['batch']} rows, "
            f"ms a step {mean:.2f} at {rec['batch']} rows ({mean / rec['batch']:.2f} a row), "
            f"peak {rec['peak_bytes'] / 2**30:.2f} GiB")


def remat_train_4k(torch, tr, counters, dryrun, arch, on, card):
    """Phase 22a: ``arch`` at train_4k, full width and depth, bf16, kernels
    on, with remat off: the peak a row from ``dryrun.fit_batch``'s two probe
    steps, the rows the card holds and ms a step at that batch (one warm-up
    step, then LAUNCH_ITERS timed), counters reset around them, beside phase
    20's run with remat on (``on``, its record); the per-row peak's split into
    the layer inputs (``dryrun.train_transients``), the larger of the f32
    logits with their gradient and the flash backward of one layer
    (measured alone), which do not peak together, and the rest; one step at
    batch 1 held on against off (``remat_hold``). -> launches by run."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import steps

    shape = INPUT_SHAPES["train_4k"]
    cfg0 = tr["get_config"](arch).with_(use_pallas=True)
    backbone = tr["model"].init_backbone(cfg0, seed=0, device="cuda")
    adapters = launch_adapters(torch, cfg0)
    cfg = steps.exec_config(cfg0, shape, "full", {"remat": False})
    run = dryrun.step_runner(cfg, shape, backbone, adapters)
    batch, probe = dryrun.fit_batch(cfg, shape, run, "cuda")
    for fn in counters.values():
        fn.launches = 0
    off = dryrun.run_record(arch, cfg0.with_(remat=False), cfg, shape, run, batch, "cuda",
                            probe, iters=LAUNCH_ITERS["train"])
    short = arch.split("-")[0]
    launches = {f"remat_{short}_train_4k_off": {n: fn.launches for n, fn in counters.items()}}
    on_row, off_row = on["probe"]["per_row"], probe["per_row"]
    on_ms = sum(on["ms"]) / len(on["ms"]) / on["batch"]
    off_ms = sum(off["ms"]) / len(off["ms"]) / off["batch"]
    log(f"[remat] {arch} x train_4k (seq {shape.seq_len}, bf16, kernels on, full width and "
        f"depth): remat on (phase 20's run): {remat_line(on)} | remat off: {remat_line(off)} | "
        f"remat on / off: peak a row {on_row / off_row:.3f}, ms a row {on_ms / off_ms:.3f}, "
        f"rows held {on['batch']} vs {off['batch']} | {card}")
    # the row's peak: the layer inputs kept through the backward, plus the
    # larger of two transients that do not peak together (the f32 logits and
    # their gradient at the loss; one layer's flash backward, measured
    # alone), plus the rest
    flash = 0 if cfg0.family == "ssm" else flash_bwd_peak(torch, cfg0, shape.seq_len)
    terms = []
    for label, c, row in (("on", cfg0, on_row), ("off", cfg, off_row)):
        t = dryrun.train_transients(steps.exec_config(c, shape, "full"), shape, 1)
        top = max(flash, t["logits"])
        terms.append(f"remat {label}: measured {row / 2**30:.3f} GiB a row = layer inputs "
                     f"{t['layer_inputs'] / 2**30:.3f} + the larger of the flash backward "
                     f"{flash / 2**30:.3f} and the f32 logits and their gradient "
                     f"{t['logits'] / 2**30:.3f} + the rest (activations kept or recomputed "
                     f"at the peak, not split further) "
                     f"{(row - t['layer_inputs'] - top) / 2**30:.3f}")
    log(f"[remat] {arch} x train_4k split of the per-row peak (GiB; layer inputs and logits "
        f"from dryrun.train_transients at batch 1, the flash backward kernel of one layer "
        + ("measured alone at batch 1 above its inputs" if flash else "absent: no attention")
        + f"): {' | '.join(terms)}")
    ins = dryrun.make_inputs(cfg0, shape, 1, "cuda", seed=1)
    hold = remat_hold(torch, tr, counters, cfg0, backbone, adapters, ins["batch"],
                      f"{arch} x train_4k (batch 1, {cfg0.n_layers} layers)")
    launches.update({f"remat_{short}_train_4k_{k}": v for k, v in hold.items()})
    del backbone, adapters, run, ins
    torch.cuda.empty_cache()
    return launches


def remat_llava(torch, tr, counters, card):
    """Phase 22b: llava-1.5-7b's local step (``client.train_step``) at full
    width, bf16, kernels on, batch 4 x (64 patches + 32 tokens), remat on and
    off: ms a step (one warm-up step, then REMAT_ITERS timed by CUDA events)
    and the peak above the resident weights; one step held on against off.
    -> launches by run."""
    cfg = tr["get_config"]("llava-1.5-7b").with_(use_pallas=True)
    server = tr["init_server"](cfg, seed=0, device="cuda")
    train, _, _ = tr["make_federated_data"](cfg, device="cuda", **TRAIN_DATA)
    b0 = train[0][0]
    adapters = launch_adapters(torch, cfg)
    hp, strat = tr["HyperParams"](**TRAIN_HP), tr["get_strategy"]("fednano")
    cells = []
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        opt = tr["adamw_init"](adapters)
        step = lambda: tr["client"].train_step(c, strat, hp, server.backbone, adapters, opt, b0,
                                               adapters)
        step()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(REMAT_ITERS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() - base
        cells.append(f"remat {'on' if remat else 'off'}: ms {', '.join(f'{t:.2f}' for t in times)}"
                     f" (mean {sum(times) / len(times):.2f}), peak above the weights "
                     f"{peak / 2**30:.3f} GiB")
    log(f"[remat] llava-1.5-7b local step (client.train_step, fednano), batch "
        f"{tuple(b0.tokens.shape)} tokens + {b0.patches.shape[1]} patches a row, bf16, kernels "
        f"on, 32 layers: {' | '.join(cells)} | {card}")
    hold = remat_hold(torch, tr, counters, cfg, server.backbone, adapters, b0,
                      "llava-1.5-7b local step (batch 4 x (64 + 32), 32 layers)")
    del server, train, adapters
    torch.cuda.empty_cache()
    return {f"remat_llava_{k}": v for k, v in hold.items()}


def remat_phase(torch, tr, counters, on_records):
    """Phase 22: h2o-danube-1.8b and mamba2-130m at train_4k with remat off
    beside phase 20's runs with it on (``on_records`` by arch), then
    llava-1.5-7b's local step on and off. -> launches by run."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    card = card_line()
    launches = {}
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch in REMAT_RUNS:
            launches.update(remat_train_4k(torch, tr, counters, dryrun, arch, on_records[arch],
                                           card))
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    launches.update(remat_llava(torch, tr, counters, card))
    log(f"[phase22] remat, each layer body checkpointed in training: "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return launches


SOURCES = {
    "lora_residual": ("src/repro_torch/csrc/lora.cu", "src/repro/kernels/lora/lora.py:49"),
    # jax.vmap of lora_residual_2d's pallas_call: the vmap engine's batched call
    "lora_residual_many": ("src/repro_torch/csrc/lora.cu", "src/repro/kernels/lora/lora.py:49"),
    "grouped_lora_residual": ("src/repro_torch/csrc/lora.cu",
                              "src/repro/kernels/lora/lora.py:115"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:121"),
    # no Pallas kernel: the JAX backward is plain jnp
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/ops.py:46 (_fa_bwd, plain jnp)"),
    "fisher_merge": ("src/repro_torch/csrc/fisher_merge.cu",
                     "src/repro/kernels/fisher_merge/fisher_merge.py:100"),
    "fisher_fold": ("src/repro_torch/csrc/fisher_merge.cu",
                    "src/repro/kernels/fisher_merge/fisher_merge.py:62"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:81"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA card",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import HyperParams, init_server, run_federated
    from repro_torch.core import adapters as adapters_lib
    from repro_torch.core import client as client_lib
    from repro_torch.core.adapters import fednano_loss
    from repro_torch.core.fisher import fisher_pass
    from repro_torch.data import make_federated_data
    from repro_torch.kernels import build, harness
    from repro_torch.kernels.fisher_merge import ops as fm_ops
    from repro_torch.kernels.fisher_merge import ref as fm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.kernels.lora import ref as lora_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch.serve import make_requests, synth_tenant_adapters
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import init_backbone
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch import strategies
    from repro_torch.strategies import available_strategies, get_strategy

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {lib.parent.name}: {time.perf_counter() - t0:.1f} s (nvcc for each source "
        "in parallel, then link)")
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        log(f"[ptxas] {ln}")

    with phase_time("3-4 kernel parity, smoke serving"):
        main_err = parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref)
        main_err.update(many_parity(torch, harness, lora_ops, lora_ref))
        serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                      make_requests, ServingEngine)
    counters = {"lora_residual": lora_ops.lora_residual,
                "lora_residual_many": lora_ops.lora_residual_many,
                "grouped_lora_residual": lora_ops.grouped_lora_residual,
                "flash_attention": fa_ops.flash_attention,
                "flash_attention_bwd": BwdCounter(fa_ops.flash_attention),
                "fisher_merge": fm_ops.fisher_merge,
                "fisher_fold": fm_ops.fisher_fold,
                "ssd_scan": ssd_ops.ssd}
    with phase_time("5 full-width serving"):
        launches = {"serve": serving_full(torch, get_config, init_backbone,
                                          synth_tenant_adapters, make_requests, ServingEngine,
                                          counters)}
        torch.cuda.empty_cache()

    tr = dict(get_config=get_config, get_smoke_config=get_smoke_config,
              HyperParams=HyperParams, init_server=init_server, run_federated=run_federated,
              client=client_lib, fednano_loss=fednano_loss, fisher_pass=fisher_pass,
              make_federated_data=make_federated_data, adamw_init=adamw_init,
              get_strategy=get_strategy, available_strategies=available_strategies,
              strategies=strategies, model=model_lib, adapters=adapters_lib)
    with phase_time("6-7 training parity, smoke training"):
        main_err.update(training_parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref,
                                        fm_ops, fm_ref))
        training_smoke(torch, tr)
    with phase_time("8-9 full-width training and its check"):
        st, train_launches = training_full(torch, tr, counters)
        launches.update(train_launches)
        training_check(torch, tr, st)

    with phase_time("10-11 timings and profiles"):
        times = timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref)
        times["lora_residual_many"] = many_timings(torch, lora_ops, lora_ref)
        times.update(training_timings(torch, F, tr, st, fm_ops, fm_ref, lora_ops, lora_ref,
                                      fa_ops, fa_ref))
        breakdown(torch, get_config, init_backbone, synth_tenant_adapters, make_requests,
                  ServingEngine)
        step_profile(torch, tr, st)
    # phase 18 in bf16 on the same llava server: the vmap and buffered engines
    t18 = time.perf_counter()
    cohort_smoke(torch, tr, counters)
    launches.update(cohort_full(torch, tr, counters, st))
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(buffered_full(torch, tr, counters, st, tmp))
    t18 = time.perf_counter() - t18
    # phase 19a in bf16, on the same server before phase 17 upcasts it
    t19 = time.perf_counter()
    launches.update(split_phase(torch, tr, counters, st, "bfloat16"))
    t19 = time.perf_counter() - t19
    # phase 17 on the same llava server: resume under failures, checkpoint
    # tenants, the naive loop; then the server's weights are f32
    sv = dict(synth=synth_tenant_adapters, make_requests=make_requests, Engine=ServingEngine)
    launches.update(resume_naive_phase(torch, tr, sv, counters, st))
    lora_times, flash_times = naive_timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref)
    times["lora_residual"]["shapes"].update(lora_times)
    times["flash_attention"]["shapes"].update(flash_times)
    # phase 18b's f32 half, on the weights phase 17 upcast
    t0 = time.perf_counter()
    launches.update(cohort_full_f32(torch, tr, counters, st))
    log(f"[phase18] the vmap and buffered engines: {t18 + time.perf_counter() - t0:.1f} s")
    # phase 19 in f32: the split step, rank-heterogeneous adapters, the sharded engine
    t0 = time.perf_counter()
    phase19 = split_phase(torch, tr, counters, st, "float32")
    phase19.update(hetero_phase(torch, tr, counters, st))
    with tempfile.TemporaryDirectory() as tmp:
        phase19.update(sharded_phase(torch, tr, counters, st, tmp))
    phase19["split_bfloat16"] = launches["split_bfloat16"]
    for name in PHASE19_KERNELS:
        if not sum(path[name] for path in phase19.values()):
            raise AssertionError(f"phase 19 never launched the {name} kernel: {phase19}")
    launches.update(phase19)
    log(f"[phase19] the split step, hetero ranks, the sharded engine: "
        f"{t19 + time.perf_counter() - t0:.1f} s")
    del st
    torch.cuda.empty_cache()

    # the paper's strategies on its second backbone, minigpt4-7b
    with phase_time("12 strategies on minigpt4-7b"):
        with phase_time("12a smoke strategies, card against CPU"):
            for name in available_strategies():
                training_smoke(torch, tr, arch=STRATEGY_ARCH, strategy=name,
                               adapter_tol=SMOKE_ADAPTER_TOL, f64_witness=True)
        launches["strategies_minigpt4"] = strategies_full(torch, tr, counters)
        torch.cuda.empty_cache()

    # the ssm family: mamba2-130m through the SSD scan kernel
    with phase_time("13 mamba2-130m"):
        main_err.update(mamba_parity(torch, harness, ssd_ops, ssd_ref, lora_ops, lora_ref,
                                     fm_ops, fm_ref))
        serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                      make_requests, ServingEngine, arch=MAMBA)
        launches["serve_mamba2"] = serving_full(torch, get_config, init_backbone,
                                                synth_tenant_adapters, make_requests,
                                                ServingEngine, counters, arch=MAMBA)
        torch.cuda.empty_cache()
        training_smoke(torch, tr, arch=MAMBA)
        st, train_launches = training_full(torch, tr, counters, arch=MAMBA)
        launches.update(train_launches)
        training_check(torch, tr, st)
        ssd_times, lora_times, grouped_time = mamba_timings(torch, ssd_ops, ssd_ref, lora_ops,
                                                            lora_ref, harness)
        times.update(ssd_times)
        times["lora_residual"]["shapes"].update(lora_times)
        times["grouped_lora_residual"]["shapes"]["mamba2-130m 4 in use"] = grouped_time
        loop_timings(torch, tr, st)
        step_profile(torch, tr, st)
        del st
        torch.cuda.empty_cache()
        breakdown(torch, get_config, init_backbone, synth_tenant_adapters, make_requests,
                  ServingEngine, arch=MAMBA)

    # the dense family: h2o-danube-1.8b, glm4-9b, qwen1.5-4b, internlm2-20b
    with phase_time("14 the dense family"):
        for arch in DENSE_ARCHS:
            with phase_time(f"14 {arch}"):
                launches.update(dense_arch(torch, tr, sv, counters, arch))
        times["flash_attention"]["shapes"].update(dense_timings(torch, F, fa_ops, fa_ref))

    # qwen2-vl-72b and the MoE family: smoke size card vs CPU, then published width
    with phase_time("15 qwen2-vl-72b and the MoE family"):
        for arch in MOE_ARCHS:
            serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                          make_requests, ServingEngine, arch=arch)
            training_smoke(torch, tr, arch=arch, adapter_tol=SMOKE_ADAPTER_TOL,
                           f64_witness=True, both_paths=True)
        for arch in MOE_ARCHS:
            with phase_time(f"15 {arch}"):
                launches.update(moe_arch(torch, tr, sv, counters, arch))
        times["flash_attention"]["shapes"].update(moe_timings(torch, F, fa_ops, fa_ref))

    # the last two families: recurrentgemma-9b (hybrid) and whisper-base (audio)
    with phase_time("16 recurrentgemma-9b and whisper-base"):
        for arch in NEW_ARCHS:
            serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                          make_requests, ServingEngine, arch=arch)
            training_smoke(torch, tr, arch=arch, adapter_tol=SMOKE_ADAPTER_TOL,
                           f64_witness=True)
        for arch in NEW_ARCHS:
            with phase_time(f"16 {arch}"):
                launches.update(new_family_arch(torch, tr, sv, counters, arch))
        flash_times, lora_times, grouped_time = new_family_timings(torch, F, fa_ops, fa_ref,
                                                                   lora_ops, lora_ref, harness)
        times["flash_attention"]["shapes"].update(flash_times)
        times["lora_residual"]["shapes"].update(lora_times)
        times["grouped_lora_residual"]["shapes"]["whisper-base 4 in use"] = grouped_time

    # phase 20: the launch layer's step functions at the production shapes
    launch_launches, launch_rows, train_records = launch_phase(
        torch, tr, counters, (F, fa_ops, lora_ops, lora_ref, ssd_ops, ssd_ref))
    launches.update(launch_launches)
    for name, rows in launch_rows.items():
        times[name]["shapes"].update(rows)

    # phase 21: the three examples, at their own size and at llava's full width
    launches.update(examples_phase(torch, counters, init_backbone, init_server, get_config))

    # phase 22: remat off beside phase 20's train_4k runs with it on, llava's local step
    launches.update(remat_phase(torch, tr, counters, train_records))

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": main_err[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        **{k: t[k] for k in ("cold_ms", "shapes") if k in t}})
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
