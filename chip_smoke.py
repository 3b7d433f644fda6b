#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the placement pipeline,
the hymba-1.5b serving path, the dense-GQA serving path (glm4-9b,
olmo-1b, h2o-danube-1.8b, nemotron-4-15b), the encoder-decoder and VLM
serving paths (seamless-m4t-medium, internvl2-2b), the pure-SSM serving
path (mamba2-2.7b), the MoE serving path (qwen3-moe-30b-a3b), the MLA
serving path (deepseek-v3-671b) and the training paths (olmo-1b,
mamba2-2.7b with hymba-1.5b's SSM checked beside it, and deepseek-v3-671b's
MLA).

    python3 chip_smoke.py                      # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printed on a line of its own:

1. build       — compile the ten CUDA sources from ``src/repro_torch/csrc``
                 (with the header ``wgmma.cuh`` they share);
                 the line gives the registers, spills and blocks per SM of
                 the tensor-core (wgmma) instances of flash_attention (bf16
                 at D 64, 128 and 80, ``WGMMA_HEAD_DIMS``), the registers
                 and spills of the serving path's decode_attention
                 instance (bf16, G 5), of the dense path's CUDA-core
                 instances (``DENSE_INSTANCES``: flash f32 at D 128 and 80,
                 decode bf16 blocks of 8, 6, 4 and 1 heads) and of every
                 ssd_scan instance (state, chain and output pass), and
                 requires no spills in the tensor-core flash instances, the
                 serving path's ssd passes and glm4-9b's decode instance
                 (bf16, blocks of 8 heads; ``DENSE_NO_SPILL``); it also
                 gives the registers and spills of the four latent (MLA)
                 instances (``MLA_INSTANCES``: the bf16 prefill and decode
                 on the tensor-core kernel, the f32 prefill and decode on
                 the CUDA cores) and requires no spill in the tensor-core
                 ones; and of flash_attention's backward
                 (``BWD_INSTANCES``, each of which the build must make: the
                 delta pass in f32 and bf16, and the dk / dv and dq passes
                 of ``BWD_DISPATCH``, on the tensor cores for bf16 at D 64,
                 80 and 128, with their blocks per SM and shared memory,
                 no spill allowed; on the CUDA cores for f32 at D 32, 64,
                 80 and 128 and bf16 at D 32); and of ssd_scan's backward
                 (``SSD_BWD_INSTANCES``, each of which the build must make:
                 the state pass (the chunk states and both chains) and the
                 gradient pass for f32 and bf16 x at P 16, 32 and 64, the
                 reduce pass; no spill allowed), with the gradient pass's
                 shared memory at P 64, N 128; and of flash_attention_latent's
                 backward (``MLA_BWD_INSTANCES``, each of which the build
                 must make: the delta and sum passes for bf16 and f32
                 storage, the bf16 query and key sides on the tensor cores
                 (no spill allowed, ``MLA_BWD_NO_SPILL``) and the f32 ones
                 on the CUDA cores), with the shared memory of its four
                 row-walking passes.
2. kernels     — hold each kernel against its plain PyTorch version on the
                 card and time kernel, plain version, library call (where
                 one PyTorch call computes the same function) and the
                 bound of the work: the placement kernels at the
                 pipeline's shapes (exact match required), flash_attention,
                 decode_attention and ssd_scan at hymba-1.5b's serving
                 shapes in bf16 (within one bf16 ulp of the output, and
                 differing from the plain version in under 1% of the
                 elements) and f32 (within 2e-4); each check must also
                 reject a wrong variant (no window mask, a truncating
                 bf16 store).  flash_attention in bf16 (the wgmma instance)
                 is also checked at serve-check's prefill length, S = T =
                 1528 (batch 2), which no tile size divides.
                 decode_attention is also checked, by the same rule, over a
                 wrapped ring buffer with empty slots and per-row q_pos
                 (window None and 40), at D 32 with G 1 and D 128 with G 8,
                 at batch 1, and at serve's warm-up step (18 slots, one
                 split, q at an odd offset); its serving rows add
                 ``device_ms``, the profiler's device time per call, for the
                 kernel and SDPA.  ssd_scan (y and h_last, f32 for either x
                 dtype, within 2e-4 of the plain version at the requested
                 chunk) must also reject the scan with h0 dropped; its
                 serving rows (``SSD_SERVING``: hymba-1.5b's prefill, 50
                 heads at N 16, and mamba2-2.7b's, 80 heads at N 128, whose
                 passes run at chunk 128) add ``device_ms`` in total and
                 per pass.  It is also checked at serve's warm-up (S 16),
                 serve-check's prompt (S 1536) and prefill (S 1528), P 16
                 and P 32, N 64 at chunk 64 and 256, N 128 at chunk 128 and
                 256, serve-ssm-check's prefill (S 1528 at N 128), N 72 at
                 chunk 256 (run at 224), odd N and chunk, and x at an odd
                 element offset; each row's passes must run at the chunk
                 ``run_chunk`` gives, every ssd instance the build made must
                 have run in one of these rows, and N 129 must be refused
                 before any launch.  lockstep_peel is checked at LMBR's pow2 classes,
                 in both size classes (the C side's class choice must agree
                 with ``uses_shared_memory`` at the class edges), at the
                 fit's shapes ((K, U) 128 x 64 at G 1, 8 and 512, 64 x 64
                 and 64 x 32, 128 x 256), odd K and U, weights too heavy
                 for the packed argmin, and on a tie-heavy batch, where
                 the check must also reject ties broken to the highest
                 slot; its rows add ``device_ms`` and device us per round.
                 cover_rounds is also checked at fig9's path bucket
                 (14 027, 35, 1) and at each edge of its three classes
                 (the C side's class must agree with ``rounds_class``), on
                 tied best gains (the lowest id must win) and on queries
                 that go bad after good rounds; its rows add
                 ``device_ms``.
                 The dense configs by the same rules: flash_attention at
                 their prefill (``DENSE_FLASH``: B 8, S = T 2048; glm4-9b
                 H 32 / K 2, nemotron-4-15b 48 / 8, olmo-1b 16 / 16 at D
                 128, h2o-danube-1.8b 32 / 8 at D 80, global and window
                 1024; bf16 on the tensor-core instance, f32 at glm4's and
                 danube's on the CUDA-core one), at S = T 1528 (D 128), in
                 bf16 at a window of 40, under one 64-key tile, at D 128
                 and 80 and at S = T 1528 at D 80 (``DENSE_FLASH_EDGES``),
                 and at D 32; decode_attention at
                 their serving cache (``DENSE_DECODE``: B 8, T 2112, a
                 wrapped ring with empty slots and per-row q_pos; G 16 in
                 two head groups, 6, 4 with window 40, 1) and at G 2, 3,
                 7, 9, 10 and 12; the serving rows add ``device_ms`` and
                 SDPA's ``library_ms`` / ``library_device_ms``.  The MoE
                 config likewise, in bf16: flash_attention at its prefill
                 (``MOE_FLASH``: B 8, S = T 2048, H 32 / K 4, D 128) and
                 decode_attention at its serving cache (``MOE_DECODE``:
                 G 8, one head group).  The encoder-decoder and VLM
                 configs likewise (``FRONTEND_FLASH``): flash_attention
                 non-causal at seamless-m4t-medium's encoder (B 8, S = T
                 1024, H = K 16, D 64) and cross-attention prefill (S 2048
                 over T 1024), at S 760 over T 1000 (B 2, bf16 and f32),
                 and causal at internvl2-2b's prefill (B 8, S = T 2048, H
                 16 / K 8, D 128); each non-causal check must also reject
                 the causal variant.  decode_attention over seamless's
                 encoder k / v (``CROSS_DECODE``: B 8, T 1024, kv_pos
                 0..1023, the query at 1023; bf16 and f32; the check must
                 reject queries at decoder positions below the frames) and
                 at internvl2's serving cache (``VLM_DECODE``: G 2).  The
                 MLA config's latent kernels
                 by the same rules, bf16 and f32, at deepseek-v3's widths
                 (H 128, R 512, Dr 64, scale 192^-0.5):
                 flash_attention_latent at its prefill (``MLA_FLASH``: B 8,
                 S = T 2048), at S = T 1528 (B 2) and at B 1, S 77, H 3
                 (64-row blocks that span positions), decode_attention_latent
                 over its serving cache (``MLA_DECODE``: B 8, T 2112, H
                 128, a wrapped ring with empty slots and per-row q_pos),
                 over serve's warm-up cache (T 18, one split) and at B 2,
                 T 777, H 3 (a partial row tile, a partial last split and
                 splits with no visible slot); each row must launch its
                 dtype's instance (bf16 ``wgmma``, f32 ``fma``); their rows
                 time
                 SDPA with the shared key head on the first backend that
                 takes D 576 / Dv 512 and record what the others say.  Every
                 flash and every decode instance the build made must run
                 in some row, and the wrapper's head groups must be the
                 source's.  Every flash row also runs the launch that
                 stores lse (``flash_attention_lse``, as training's
                 forward): its output must equal the serving launch's and
                 its lse the plain version's within ``LSE_TOL``, and the
                 check must reject the lse of the other causality.
                 flash_attention's backward (dq, dk, dv from q, k, v, the
                 kernel forward's output and lse, and a standard-normal
                 output gradient) against flash_attention_bwd_plain at
                 ``FLASH_BWD``: olmo-1b's training shape (B 8, S = T 1024,
                 H = K 16, D 128) in bf16 and f32, glm4-9b's heads (H 32,
                 K 2), D 64 and D 80 under a window of 1024, S = T 1000,
                 non-causal S 760 over T 1000, the --reduced olmo-1b (D
                 32, G 4, f32) and bf16 D 32 under a window of 40 (every
                 instance the build makes); f32 within 2e-4 of each tensor's largest
                 |value|, bf16 each element within 2^-6 of itself plus 2^-8
                 of the largest; each check must reject the backward
                 without the causal mask (with it, in the non-causal row)
                 and, where G > 1, dk / dv of the first query head of each
                 group only; each call must run the instance of
                 ``BWD_DISPATCH`` (bf16 at D 64, 80, 128 ``wgmma``, the
                 rest ``fma``).  Its rows time the kernel (the training
                 shapes also per pass: delta, kv, q), the plain version
                 and SDPA's backward (``library_ms``) beside the bound.
                 ssd_scan's backward (dx, ddt, da, dB, dC, dh0 from the
                 forward kernel's y, a standard-normal dy and a nonzero h0
                 and dh_last) against ssd_scan_bwd_plain at ``SSD_BWD``:
                 mamba2-2.7b's training shape (B 8, S 1024, H 80, P 64, N
                 128, chunk 256) and hymba-1.5b's (H 50, N 16), a ragged S
                 at P 32, N 12, chunk 100, P 16 at N 72 with no dh_last
                 and N 13 (rows not a multiple of 16 bytes), x in bf16
                 and f32 (every instance the build makes); every f32
                 output within 1e-4 of its largest |value|, a bf16 dx
                 each element within 2^-7 of itself plus 1e-4 of the
                 largest; each check must reject the backward with h0
                 dropped and, where given, with dh_last dropped; at the
                 training shapes two calls must give the same outputs bit
                 for bit.  Its rows time the kernel (the training shapes
                 also per pass: state, grad, reduce) and the plain version
                 beside the bound (the split products at the tensor-core
                 peaks, ``_ssd_bwd_work``; no PyTorch call computes it)
                 and the workspace's bytes.
                 flash_attention_latent's backward (dq_lat, dq_rope, dc_kv,
                 dk_rope from the latent kernel forward's output and lse,
                 whose lse must match the plain version's within
                 ``LSE_TOL`` and reject the lse of no causal mask, and a
                 standard-normal output gradient) against
                 flash_attention_latent_bwd_plain at ``MLA_BWD``:
                 deepseek-v3-671b's training shape (train-mla's B 4, S = T
                 1024, H 128, R 512, Dr 64, scale 192^-0.5) in bf16 and
                 f32, B 8 in bf16, S = T 1528 at B 2, and H 3 at S 77
                 (blocks that span positions); f32 within 1e-4 of each
                 gradient's largest |value|, bf16 by flash's backward
                 rule; each check must reject dc_kv without its value part
                 and the backward without the causal mask, each call run
                 its dtype's instance (bf16 ``wgmma``, f32 ``fma``), and
                 two calls at the training shapes give the same bits.  Its
                 rows time the kernel (the training shapes also per pass,
                 ``MLA_BWD_PASSES``: delta, q_wgmma, kv_wgmma, reduce in
                 bf16; delta, q, kv, reduce in f32), the plain version and
                 SDPA's backward (autograd, causal, the one latent key
                 head shared by the H heads, key 576 / value 512, on the
                 backend SDPA's dispatch picks, named by its graph)
                 beside the bound.
3. fit-stress  — ``Simulator(64, 50).run(lmbr_stress_workload(seed=0), lmbr,
                 seed=0, max_moves=1200)`` on the card with the dense peel
                 and the span_gain kernel pinned; the summary and member
                 matrix must equal the same call on the CPU bit for bit, and
                 every placement kernel must have launched.  The line gives
                 the peel launches by (K, U) class and the peel's rounds
                 (each launch's longest pair, summed).
4. fit-paper   — the same fit and CPU cross-check on the largest fig9
                 circuit (ibm10-like, 69 429 nodes, 35 partitions, capacity
                 ceil(n/20), max_moves 600).
5. paper-algos — the paper's six algorithms (random, hpa, ihpa, ds, pra,
                 lmbr) through ``Simulator(n, cap, device="cuda").run(hg,
                 ALGORITHMS[name], name=name, seed=0)`` with the dense peel
                 and the span_gain kernel pinned, at fig6's paper default
                 (``random_workload(1000, 4000, 3, 11, 20, seed=0)``, 40
                 partitions, capacity 50), IHPA alone at 30 partitions
                 (where its §4.2 shrink runs), and fig9's ibm01-like circuit
                 (12 752 nodes, 35 partitions, capacity 638, lmbr
                 ``max_moves=600``).  Each run must equal the same call on
                 the CPU bit for bit and its avg_span the JAX package's
                 (``PAPER_RUNS``, pinned by a CPU test); span_gain must
                 launch in every ihpa and ds run and in fig6's pra run,
                 cover_rounds in every fig9 run, lockstep_peel in every
                 lmbr run.  The line
                 gives each run's launches and the (B, N, W) of every
                 cover_rounds launch.
6. placement-api — the production API, the fixed-RF algorithms and the
                 bridges through the port's entry points at full size,
                 each run on the card and again at ``device="cpu"`` (each
                 inside its own partition memo), held against its CPU twin
                 and the JAX package's values (``API_HELD``, pinned by a
                 CPU test): ``PlacementService("lmbr").fit`` of fig8's
                 TPC-H-heterogeneous workload (2 000 items, 4 000
                 queries) on 45 partitions of 100 GB with a random
                 ``NodeProfile`` and ``durability_eps=0.05``, then its
                 avg_span on cover_rounds; ``refit`` on the seed-1 trace
                 under ``nodecost0.5`` with partitions 3 and 17 masked
                 (no copy may land there, the old plan must stay inside
                 the new one); ``fit_hierarchical`` at 4 pods x 10 hosts;
                 ``Simulator(60, 50).compare`` of the four 3-way
                 algorithms at fig. 6(f)-(h)'s paper point; an expert plan
                 for DeepSeek-V3's 256 experts, top-8, on 32 ranks x 9
                 slots against the contiguous layout; a pra3 shard plan
                 (1 000 shards, 2 000 recipes, 48 hosts, capacity 80)
                 whose spans run once more on the span engine.  Each run
                 must launch the kernels ``API_RUNS`` names; the line
                 gives its held values, walls and launches.
7. online      — online serving through the port's entry points, each run
                 on the card and again at ``device="cpu"`` (each inside its
                 own partition memo), held against its CPU twin and the JAX
                 package's values (``ONLINE_HELD``, pinned by a CPU test):
                 ``ReplicaRouter.route_csr`` of the lmbr-stress trace
                 (10 000 queries) on the random layout of 64 x 50 in
                 27 microbatches of 384, default and balanced (sha256s of
                 covers, pin attribution and ledger; every 97th default
                 cover against ``cover_for_query``), then its queries/s
                 pinned to cover_rounds, under ``auto`` and on the CPU;
                 ``Simulator(40, 50).run_online`` with the drift detector
                 on fig6's splice (2 000 queries of seed 0, then 4 000 of
                 seed 7; lmbr ``max_moves=120``, ``refit_moves=400``), with
                 three partitions failing and returning, and migrating the
                 random layout onto lmbr's paced by ``migbw1`` through an
                 outage (summaries, sha256s of spans and final member);
                 ``refit(as_migration=True)`` of that lmbr plan on the seed-1
                 queries (the schedule's JSON, copies only).  Each run must
                 launch the kernels ``ONLINE_RUNS`` names, and every kernel
                 exactly as often as the CPU twin's dispatch calls its
                 wrapper; the line gives its held values, walls and
                 launches.
8. serve       — ``repro_torch.launch.serve`` on hymba-1.5b at full width
                 and depth (32 layers, bf16, random weights from seed 0):
                 16 requests in batches of 8, prompt 2048, 64 greedy decode
                 steps; finite logits, prefill tokens/s, decode ms/step,
                 peak memory, and each model kernel's launch count, which
                 must be 32 x 2 (flash, ssd) and 32 x 64 x 2 (decode), every
                 flash launch on the tensor-core (wgmma) instance.
9. serve-check — hymba-1.5b at full width and 4 layers (global, window,
                 window, global) in f32 with TF32 off, prompt 1536: the
                 kernel route against the plain route on the card (logits
                 within 1e-3) and teacher-forced decode after prefill
                 against the cache-free forward (within 2e-3).
10. serve-dense — ``repro_torch.launch.serve`` on the dense configs at full
                 width (bf16, random weights from seed 0, one model on the
                 card at a time): glm4-9b at its full depth (40 layers)
                 with serve's traffic, olmo-1b, h2o-danube-1.8b and
                 nemotron-4-15b at 4 layers with one batch of 8 (prompt
                 2048, 32 decode steps) (``DENSE_SERVES``); finite logits
                 of shape (8, vocab), prefill tokens/s, decode ms/step,
                 peak memory, launches L x batches (flash, every one on
                 the tensor-core instance) and L x steps x batches
                 (decode), no ssd_scan.
11. serve-dense-check — ``DENSE_CHECKS`` (glm4-9b; h2o-danube-1.8b with its
                 window cut to 1024) at full width and 4 layers in f32 with
                 TF32 off, prompt 1536, held as serve-check holds hymba.
12. serve-encdec — ``repro_torch.launch.serve`` on seamless-m4t-medium at
                 full width and depth (12 encoder and 12 decoder layers,
                 16 heads of 64, LayerNorm, gelu, vocab 256 206; bf16,
                 random weights from seed 0) with serve's traffic, each
                 batch with 1 024 standard-normal frames; finite logits,
                 prefill tokens/s, decode ms/step, peak memory, launches
                 (12 + 2 x 12) x 2 (flash: the non-causal encoder, the
                 decoder's self- and cross-attention; every one on the
                 tensor-core instance) and 2 x 12 x 64 x 2 (decode, cross
                 included), no other model kernel (``frontend_launches``).
13. serve-encdec-check — seamless at full width, 4 encoder and 4 decoder
                 layers, in f32 with TF32 off, 1 000 frames, prompt 768,
                 prefill 760 (cross-attention ragged at S != T; every
                 decode position below the frames), held as serve-check
                 holds hymba (``FRONTEND_CHECKS``).
14. serve-vlm  — the same for internvl2-2b (24 layers, 16 / 8 heads of
                 128, RMSNorm, SwiGLU, rope 1e6; 256 patches in place of
                 the first prompt positions): launches 24 x 2 (flash) and
                 24 x 64 x 2 (decode).
15. serve-vlm-check — internvl2-2b at full width and 4 layers in f32,
                 prompt 1536 with its 256 patches, prefill 1528.
16. serve-ssm  — ``repro_torch.launch.serve`` on mamba2-2.7b at full
                 width and depth (64 layers, 80 SSM heads of 64, state 128,
                 chunk 256, no FFN; bf16, random weights from seed 0) with
                 serve's traffic; finite logits of shape (8, vocab),
                 prefill tokens/s, decode ms/step, peak memory, launches
                 64 x 2 (ssd_scan, every one with its passes at chunk 128)
                 and none of flash or decode.
17. serve-ssm-check — mamba2-2.7b at full width and 4 layers in f32 with
                 TF32 off, prompt 1536, prefill 1528, held as serve-check
                 holds hymba (``ssd_scan`` patched to its plain version on
                 the plain route).
18. serve-moe  — ``repro_torch.launch.serve`` on qwen3-moe-30b-a3b at full
                 width and depth (48 layers, 32 / 4 heads of 128, 128
                 experts top-8 of d_ff 768; bf16, random weights from
                 seed 0 created on the card, ~61 GB; every earlier model
                 freed first) with serve's traffic and the identity
                 expert dispatch; finite logits of shape (8, vocab),
                 prefill tokens/s, decode ms/step, peak memory, each
                 batch's prefill ``drop_frac`` summed over the layers,
                 launches 48 x 2 (flash, every one on the tensor-core
                 instance) and 48 x 64 x 2 (decode), no ssd_scan; then
                 the reference serve CLI's expert refit (LMBR on a seed-1
                 routing trace, 4 EP ranks of 34 slots) fitted on the
                 card, whose spans must be the reference's
                 (``MOE_REFIT``).
19. serve-moe-check — qwen3-moe-30b-a3b at full width and 4 layers in f32
                 with TF32 off, prompt 1536, prefill 1528, at capacity
                 factor E / top_k = 16 (no token can drop), held as
                 serve-check holds hymba; besides, every MoE call of the
                 two routes must pick the same top-k expert set for every
                 token and drop nothing, and the forward under the
                 refit's replicated ``dispatch_from_plan`` dispatch (136
                 slots) on the same per-expert weights must come within
                 1e-3 of the identity dispatch's logits.
20. serve-mla  — ``repro_torch.launch.serve`` on deepseek-v3-671b at full
                 width (d_model 7168, 128 heads, MLA with q_lora 1536,
                 kv_lora 512, rope 64; 256 experts top-8 of d_ff 2048 and a
                 shared expert; vocab 129 280) cut to 4 layers (its three
                 dense layers and one MoE layer; bf16, random weights from
                 seed 0 created on the card, every earlier model freed
                 first) with serve's traffic and the identity dispatch;
                 finite logits of shape (8, vocab), prefill tokens/s,
                 decode ms/step, peak memory, each batch's prefill
                 ``drop_frac``, launches 4 x 2 (flash_attention_latent, all
                 on its tensor-core ``wgmma`` instance) and
                 4 x 64 x 2 (decode_attention_latent, all on its ``wgmma``
                 instance), none of flash,
                 decode or ssd_scan; then the serve CLI's refit (4 EP ranks
                 of 66 slots) fitted on the card, whose spans must be the
                 reference's (``MLA_REFIT``).
21. serve-mla-check — deepseek-v3-671b at full width and 3 layers (the
                 dense MLA layers) in f32 with TF32 off, prompt 1536,
                 prefill 1528, held as serve-check holds hymba (the latent
                 kernels patched to their plain versions on the plain
                 route); the kernel route's latent prefill and decode
                 launch all on their CUDA-core ``fma`` instances.  No
                 serving phase's latent launch stores lse.
22. train      — ``make_train_step`` on olmo-1b at full width and depth
                 (16 layers, d_model 2048, bf16, random weights from seed
                 0; AdamW lr 3e-4, accum 1; ``TRAIN``) fed by
                 ``PlacementAwarePipeline`` at B 8, S 1024 for 8 steps, no
                 checkpoint: parameters, loss and grad norm a step, step ms
                 after the first, tokens/s, peak memory, the device's idle
                 share over one more profiled step; exactly 2 x 16 flash
                 forward launches a step (all on the wgmma instance) and
                 16 backward calls (``train_launches``), all on the wgmma
                 instance, each reading the lse that its forward stored;
                 no serving phase stores lse; no other model
                 kernel, no plain version (each is swapped for a function
                 that raises); finite losses and grad norms; every layer's
                 wq, wk and wv gradient nonzero.
23. train-check — (a) olmo-1b at full width and 2 layers in f32 with TF32
                 off: the train step's gradient (``loss_and_grads``) on the
                 kernel route against the plain route on the card (loss
                 within 1e-5 relative, every gradient leaf within 1e-4 of
                 its largest |value|, every forward and backward call on
                 the fma instance, no launch on the plain route); the two
                 decode kernels, which serve only, refuse a gradient
                 (NotImplementedError); (b) ``python -m
                 repro_torch.launch.train`` with the reference e2e test's
                 arguments (``TRAIN_CLI``: reduced olmo-1b, 60 steps, B 8,
                 S 64, lr 3e-3, a checkpoint every 25, an input host
                 killed) on the card: exit 0, ``improved``, the failure
                 event and a ``step_*`` checkpoint.
24. train-ssm  — ``make_train_step`` on mamba2-2.7b at full width and
                 depth (64 layers, 80 SSM heads of 64, state 128, chunk
                 256, d_model 2560; bf16, random weights from seed 0;
                 AdamW lr 3e-4, accum 1) fed by ``PlacementAwarePipeline``
                 at ``TRAIN``'s B 8, S 1024 for 8 steps: loss and grad norm
                 a step, step ms after the first, tokens/s, peak memory,
                 the device's idle share and device s by group (``ssd_bwd``,
                 ``ssd_fwd``, GEMMs, the rest) over one more profiled step;
                 exactly 2 x 64 ssd_scan forward launches and 64 backward
                 calls a step (``train_launches``), no other model kernel,
                 no plain version (each swapped for a function that
                 raises); finite losses and grad norms; every layer's w_in,
                 w_out, a_log and dt_bias gradient nonzero.
25. train-ssm-check — mamba2-2.7b and hymba-1.5b at full width and 2
                 layers in f32 with TF32 off (``TRAIN_SSM_CHECK``: B 4, S
                 1024): ``loss_and_grads`` on the kernel route (ssd_scan's
                 forward and backward kernels, hymba's attention on
                 flash's) against the plain route (``ssd_scan_plain`` and
                 ``flash_attention_plain`` under autograd): loss within
                 1e-5 relative, every gradient leaf within 1e-4 of its
                 largest |value|, 2 L forward launches and L backward calls
                 of each kernel on the kernel route, none on the plain.
26. train-mla  — ``make_train_step`` on deepseek-v3-671b at its published
                 widths (d_model 7168, 128 heads, MLA with q_lora 1536,
                 kv_lora 512, rope 64, d_ff 18 432, vocab 129 280) cut to
                 its three dense layers with its MTP group (``TRAIN_MLA``:
                 4.29 B parameters; bf16, random weights from seed 0 made
                 on the card after every earlier model is freed; AdamW lr
                 3e-4, accum 1, the step donating its parameters and
                 state) fed by ``PlacementAwarePipeline`` at B 4 (B 8 runs
                 out of memory) and ``TRAIN``'s S 1024 for 8 steps: loss
                 and grad norm a step, step
                 ms after the first, tokens/s, peak memory, the device's
                 idle share and device s by group (``mla_bwd``,
                 ``mla_fwd``, GEMMs, the rest) over one more profiled
                 step; exactly 2 x 3 + 1 latent forward launches (every
                 layer twice under remat, the MTP block once; all on the
                 ``wgmma`` instance, each backward reading the lse its
                 forward stored) and 3 + 1 backward calls a step (all on
                 the tensor-core ``wgmma`` instance; ``train_launches``),
                 no other model
                 kernel, no plain version (each swapped for a function
                 that raises); finite losses and grad norms; every
                 layer's and the MTP block's wq_a, wq_b, wkv_a, wk_b, wv_b
                 and wo gradient nonzero.
27. train-mla-check — deepseek-v3-671b at full width, 2 dense layers and
                 the MTP group in f32 with TF32 off (``TRAIN_MLA_CHECK``:
                 B 2, S 1024): ``loss_and_grads`` on the kernel route (the
                 latent forward's fma instance and the backward kernel's
                 CUDA-core fma instance) against the plain route
                 (``flash_attention_latent_plain`` under autograd): loss
                 within 1e-5 relative, every gradient leaf within 1e-4 of
                 its largest |value|, 2 L + 1 forward launches and L + 1
                 backward calls on the kernel route, none on the plain.
28. health     — ``Simulator(40, 50).run_online`` of fig6's paper default
                 (lmbr ``max_moves=120``) under the flags-built
                 ``HealthMonitor`` (``HEALTH_VARIANT``: snapshots every 100
                 queries, window 4, skew SLO 3.0), with a storm (partitions
                 3, 5 and 7 down at query 1 000, no automatic repair, a
                 repair pass at 2 500, back at 2 501) and with no events;
                 each run on the card and again at ``device="cpu"``, held
                 against its CPU twin and the JAX package's values
                 (``HEALTH_HELD``: the summary with ``alerts_fired`` /
                 ``alerts_resolved``, sha256s of spans and member, the
                 monitor's transitions); launches as the twin's dispatch.
                 The storm fires and resolves degraded_rate, and the same
                 storm unmonitored serves the same spans, access load and
                 member; the clean replay fires nothing.
29. scale      — the cluster-scale pipeline at bench_scale's sizes:
                 ``web_scale_chunks(seed=0)`` (100 000 items, 1 000 000
                 queries) through ``StreamingHypergraphBuilder``, plain and
                 with duplicates merged (host only); the sharded lmbr fits
                 fit-quick (10 000 items, 50 000 queries on 32 x 650, 8
                 shards) and web-mid (2 500 items, 10 000 queries on 24 x
                 210, 4 shards), serial, with their avg_span on the span
                 engine; ``PlacementService.fit_sharded`` of web-mid with
                 a profile and the durability pass.  Each run is held
                 against its CPU twin (run after the card runs; fit-quick's
                 as recorded, ``SCALE_DISPATCH``) and the JAX package's
                 values (``SCALE_HELD``), with launches as the twin's
                 dispatch and the peel's launches printed by
                 (K, U) class; then fit-quick (on
                 min(8, cores), at least 2, workers) and web-mid (on 2)
                 once more with their shards on spawned card workers, each
                 equal to its serial fit.

``--profile`` runs each fit once more under torch.profiler and the
package's tracer, and one serving batch (prefill, 8 decode steps) of
hymba-1.5b (serve), glm4-9b (serve-dense), seamless-m4t-medium
(serve-encdec), internvl2-2b (serve-vlm), mamba2-2.7b (serve-ssm),
qwen3-moe-30b-a3b (serve-moe) and deepseek-v3-671b at 4 layers
(serve-mla, its latent kernels' device time as the ``mla_attention``
group) under torch.profiler,
and prints where the time goes (for the fits also
lockstep_peel's device time per launch and per peel round and
cover_rounds' device time per launch; for
paper-algos, fig9's IHPA fit with span_gain's and cover_rounds' device
time per launch; for placement-api, service-fit split into HPA, the LMBR
move loop, the durability pass and the plan's spans, with each placement
kernel's device time per launch; for online, the drift run split into
the fit, routing, the refits and the rest, with the device's idle
share; for scale, fit-quick's serial fit split into its shard, fit,
merge and repair stages, with the device's idle share).

Then: the card's name and power limit (nvidia-smi), one JSON line with
every kernel's numbers, and the device line.  Any failed check raises and
the script exits non-zero without the device line.  Exits non-zero at once
when CUDA is unavailable or the package sources are missing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32, NVIDIA data sheet
TF32_OPS_PER_S = 495e12      # H100 SXM dense tf32 tensor cores, data sheet
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores, data sheet
PHASES = ("build", "kernels", "fit-stress", "fit-paper", "paper-algos",
          "placement-api", "online", "serve", "serve-check", "serve-dense",
          "serve-dense-check", "serve-encdec", "serve-encdec-check",
          "serve-vlm", "serve-vlm-check", "serve-ssm", "serve-ssm-check",
          "serve-moe", "serve-moe-check", "serve-mla", "serve-mla-check",
          "train", "train-check", "train-ssm", "train-ssm-check",
          "train-mla", "train-mla-check", "health", "scale")
PAPER_NODES = 69429          # ibm10, the largest fig9 circuit
# paper-algos: the workloads (generator, arguments) and the runs (workload,
# partitions, capacity, algorithm, extra arguments, avg_span of the JAX
# package's ``Simulator(n, cap).run(hg, ALGORITHMS[name], name=name,
# seed=0, **extra)`` on the CPU; tests/test_torch_chip_smoke_constants.py
# recomputes every row)
PAPER_WORKLOADS = {
    "fig6": ("random_workload", dict(num_items=1000, num_queries=4000,
                                     min_query=3, max_query=11, density=20,
                                     seed=0)),
    "fig9-ibm01": ("ispd_like_workload", dict(num_nodes=12752, seed=0)),
}
PAPER_RUNS = (
    ("fig6", 40, 50, "random", {}, 6.309),
    ("fig6", 40, 50, "hpa", {}, 4.969),
    ("fig6", 40, 50, "ihpa", {}, 4.3455),
    ("fig6", 40, 50, "ds", {}, 4.51525),
    ("fig6", 40, 50, "pra", {}, 4.74225),
    ("fig6", 40, 50, "lmbr", {}, 4.21625),
    ("fig6", 30, 50, "ihpa", {}, 4.733),
    ("fig9-ibm01", 35, 638, "random", {}, 3.5707563983745634),
    ("fig9-ibm01", 35, 638, "hpa", {}, 1.1980466243672916),
    ("fig9-ibm01", 35, 638, "ihpa", {}, 1.0),
    ("fig9-ibm01", 35, 638, "ds", {}, 1.0),
    ("fig9-ibm01", 35, 638, "pra", {}, 1.0562486632922221),
    ("fig9-ibm01", 35, 638, "lmbr", dict(max_moves=600), 1.0),
)
# summary keys that record wall time or which backend ran
BACKEND_KEYS = {"placement_s", "fit_peel", "fit_cover_engine"}
# placement-api: the runs in order, each with its flag variant, the
# kernels it must launch (at least that many times) and the values it
# holds; every held value is what the JAX package gives for the same call
# on the CPU (tests/test_torch_chip_smoke_constants.py recomputes them)
API_RUNS = {
    "service-fit": ("peeldevice+spandevice",
                    {"span_gain": 1, "lockstep_peel": 1, "cover_rounds": 1}),
    "service-refit": ("peeldevice+spandevice+nodecost0.5",
                      {"span_gain": 1, "lockstep_peel": 1}),
    "service-hier": ("peeldevice+spandevice",
                     {"span_gain": 1, "lockstep_peel": 1}),
    # the replay bucket (4 000 queries x 60 partitions x 1 word) is above
    # span_round_threshold, so every replay goes whole to cover_rounds
    "three-way": ("spandevice", {"cover_rounds": 4}),
    "experts": ("peeldevice+spandevice",
                {"span_gain": 1, "lockstep_peel": 1}),
    "shards": ("spandevice", {"span_gain": 1}),
}
API_HELD = {
    "service-fit": dict(
        json_sha256="7e52dceb1dcb13a614e4720e5cc2813b"
                    "6142c57367233846cdcd3477291c6686",
        durability_copies=753, avg_span=1.00725),
    "service-refit": dict(
        json_sha256="835ee1bafb7f1f57abed46a5cf32f56f"
                    "6b1b1639ecb986c9a24528f2cd367d21",
        copies_added=169, avg_span_before=1.0895, avg_span_after=1.0685),
    "service-hier": dict(
        host_member_sha256="5b61d8000746f6520bdb777ea5d3ac22"
                           "1d9c3cbb82f9b04db849ad7f71a5bf36",
        mean_pod_span=1.0, mean_host_span=1.00825,
        mean_weighted_span=0.00825),
    "three-way": {
        "random3": dict(avg_span=5.036, member_sha256=(
            "ce9dfd3b451941d0c2ccf938f7b77db866f3ab852fdda3497c57ff4fd5d1c795")),
        "sda": dict(avg_span=4.30875, member_sha256=(
            "54548a69f494038c4be9bb0d92608eb4cd2076eb30203f79d539e83371715981")),
        "ihpa3": dict(avg_span=4.0025, member_sha256=(
            "22deb3ae0477c057f832917edc31f021164ea94344c8ab90902da70f6b6dd746")),
        "pra3": dict(avg_span=4.1935, member_sha256=(
            "18c8a0c137d4e8082b7bb5503d803eff0ccbd2704a37b65969911d2f3f436570")),
    },
    "experts": dict(
        member_sha256="3782656412f3e2f54eca33c6429c7425"
                      "18b536839c8b8202fc118bf3a0c7eb4e",
        tables_sha256="313b97ea0901d430e585e040188e8488"
                      "2c665eb0e240d3980d9bf450b84755b2",
        avg_span=4.028564453125, baseline_avg_span=7.18115234375),
    "shards": dict(
        member_sha256="a2edc84e8f2d2b7d8e6b7b485ef316df"
                      "d458ae160a1994686fc954e9abd6e830",
        survives_2_failures=True, avg_span=1.1255),
}


# online: the runs in order, each with its flag variant and the kernels it
# must launch (as many times as the CPU twin's dispatch calls their
# wrappers), the events of the failover and migration runs (the migrate
# target is the lmbr fit the run makes), and the held values, each what
# the JAX package gives for the same call on the CPU
# (tests/test_torch_chip_smoke_constants.py recomputes them)
ONLINE_RUNS = {
    # one 384-query microbatch at N 64, W 1 packs to 24 576 words, under
    # span_round_threshold, so the router reaches cover_rounds only pinned
    "router": ("spandevice+spanrounddevice", ("cover_rounds",)),
    "drift": ("peeldevice+spandevice", ("span_gain", "lockstep_peel")),
    "failover": ("peeldevice+spandevice", ("span_gain", "lockstep_peel")),
    "migration": ("peeldevice+spandevice+migbw1",
                  ("span_gain", "lockstep_peel")),
    "refit-migration": ("peeldevice+spandevice",
                        ("span_gain", "lockstep_peel")),
}
ONLINE_EVENTS = {
    "failover": ((400, "down", 7), (800, "down", 21), (1300, "up", 7),
                 (2000, "down", 33), (2600, "up", 21), (3300, "up", 33)),
    "migration": ((500, "migrate", None), (900, "down", 5),
                  (1800, "up", 5)),
}
ONLINE_HELD = {
    "router": {
        "default": {
            "cover_sha256": "8c2a15bbabc2f85fbddf645e86f49c3e"
                            "5e675762720d28d571fc0701ecce2b7b",
            "ledger_sha256": "12d34a15a983f43ffd8706e43fbb8112"
                             "de02f216ccf9961522d6c613bb9666fe",
            "avg_span": 6.6261,
            "load_imbalance": 1.3077979505289687,
            "microbatches": 27,
        },
        "balanced": {
            "cover_sha256": "ddb8a6cc06b7f7c260514204b2287a4d"
                            "26a774597f12f233725562e9c5b2dc5e",
            "ledger_sha256": "2d26ee51a7bc6f560d9dbadd9e7a70cd"
                             "27665bc86ef37971c743ee7e48a899d3",
            "avg_span": 6.6262,
            "load_imbalance": 1.307778213757508,
            "microbatches": 27,
        },
    },
    "drift": {
        "algorithm": 'lmbr+drift',
        "avg_span": 5.6605,
        "max_span": 11,
        "energy_kj": 15437.31,
        "shipped_gb": 30878.0,
        "rf": 1.8,
        "load_imbalance": 1.359,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": 'item',
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 6000,
        "microbatches": 16,
        "plan_swaps": 2,
        "degraded_queries": 0,
        "partitions_down": 0,
        "repaired_items": 0,
        "unrepairable_items": 0,
        "drift_fires": 2,
        "refits": 2,
        "windowed_avg_span": 5.5762,
        "spans_sha256": "dac8007494ba93cd31b9703e36193937"
                        "433d710b6f4b80bf3761a84a6ba72744",
        "member_sha256": "fe79ce43b3c81fb8ffe7b04e47df2d11"
                         "683cff95bb528050ffcfb32e103335c4",
    },
    "failover": {
        "algorithm": 'lmbr',
        "avg_span": 5.1143,
        "max_span": 11,
        "energy_kj": 9655.53,
        "shipped_gb": 19244.0,
        "rf": 1.208,
        "load_imbalance": 1.605,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": 'item',
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 4000,
        "microbatches": 14,
        "plan_swaps": 0,
        "degraded_queries": 0,
        "partitions_down": 3,
        "repaired_items": 76,
        "unrepairable_items": 0,
        "spans_sha256": "461c1d5cce2b26b9abcd2b8ceaa83172"
                        "8c438c438248d7efd5da67eea99675c6",
        "member_sha256": "f1346a443bfa8762fab0d7db3d136745"
                         "bdde5da170009acf2294a8b214dc6a42",
    },
    "migration": {
        "algorithm": 'random',
        "avg_span": 5.5365,
        "max_span": 11,
        "energy_kj": 10131.48,
        "shipped_gb": 20139.0,
        "rf": 1.152,
        "load_imbalance": 1.3,
        "active_machines": 37,
        "cluster_power_w": 9550.0,
        "served_queries": 4000,
        "microbatches": 13,
        "plan_swaps": 1,
        "degraded_queries": 0,
        "partitions_down": 1,
        "repaired_items": 24,
        "unrepairable_items": 0,
        "migrations": 1,
        "migration_copies": 1074,
        "migration_drops": 1942,
        "migration_transfer_gb": 1070.0,
        "migration_wasted_gb": 0.0,
        "migration_max_inflight_gb": 144.0,
        "migration_ticks": 1322,
        "migration_done": True,
        "spans_sha256": "ce2f037e02c520ddb7eb0d3b5370f44c"
                        "8f5cdffc3900e4c7ec07a8076b40a8f3",
        "member_sha256": "477a7a7f5aee7e2320a4273b5982f5d5"
                         "0aa8d57db2a068658e9119dcbe15b428",
    },
    "refit-migration": {
        "json_sha256": "0b28125648806818fa7d32ebcd51c3ef"
                       "00dc956a20ed369532eeb42c29cfe83d",
        "copies": 69,
        "drops": 0,
        "avg_span_before": 6.198,
        "avg_span_after": 5.9755,
    },
}

# health: fig6's paper default (lmbr, 120 moves, on 40 x 50) served under
# the flags-built health monitor, each run with its events and the values
# it holds, each what the JAX package gives for the same call on the CPU
# (tests/test_torch_chip_smoke_constants.py recomputes them).  The storm
# is benchmarks/bench_obs.py:239-244 at N 40: partitions 3, 5 and 7 down at
# query 1 000 with no automatic repair, a repair pass at 2 500, the
# partitions back at 2 501; degraded_rate fires and resolves.
HEALTH_VARIANT = ("peeldevice+spandevice+routermb64+obscounters+obssnap100"
                  "+obshealth1+healthw4+healthskew3.0")
HEALTH_OFF_VARIANT = "peeldevice+spandevice+routermb64"
HEALTH_KERNELS = ("span_gain", "lockstep_peel")
HEALTH_EVENTS = {
    "health-storm": ((1000, "down", 3), (1000, "down", 5),
                     (1000, "down", 7), (2500, "repair", 1),
                     (2501, "up", 3), (2501, "up", 5), (2501, "up", 7)),
    "health-clean": (),
}
HEALTH_HELD = {
    "health-storm": {
        "algorithm": "lmbr",
        "avg_span": 5.051,
        "max_span": 11,
        "energy_kj": 8262.24,
        "shipped_gb": 16384.0,
        "rf": 1.205,
        "load_imbalance": 1.524,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": "item",
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 3471,
        "microbatches": 65,
        "plan_swaps": 0,
        "degraded_queries": 529,
        "partitions_down": 3,
        "repaired_items": 73,
        "unrepairable_items": 0,
        "alerts_fired": 1,
        "alerts_resolved": 1,
        "spans_sha256": "5ef4618ababddc8427fe38c814af3b4b"
                        "1dfe793dc9e3e196a36d06486e636268",
        "member_sha256": "fb2a258236d975e82be3f9821ed8ea14"
                         "fd4dbc777f33a1bbca5259e5a6d3afc3",
        "history": [["degraded_rate", "fire", 1192.0],
                    ["degraded_rate", "resolve", 2949.0]],
    },
    "health-clean": {
        "algorithm": "lmbr",
        "avg_span": 5.155,
        "max_span": 11,
        "energy_kj": 9701.92,
        "shipped_gb": 19338.0,
        "rf": 1.132,
        "load_imbalance": 1.344,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": "item",
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 4000,
        "microbatches": 63,
        "plan_swaps": 0,
        "degraded_queries": 0,
        "partitions_down": 0,
        "repaired_items": 0,
        "unrepairable_items": 0,
        "alerts_fired": 0,
        "alerts_resolved": 0,
        "spans_sha256": "a3240cb2093616a28c47ce2edf640071"
                        "a797bd4b15235495d77873bb2882ad21",
        "member_sha256": "3ce9afb3ff3a1d59610752b5649abd42"
                         "b383ef441104c33264ec53ba706a993e",
        "history": [],
    },
}

# scale: benchmarks/bench_scale.py's streaming tier and sharded fits
# (:127-130, :248-265) through the port's entry points, each run with the
# kernels it must launch (as often as the CPU twin's dispatch calls their
# wrappers) and the values it holds, each what the JAX package gives for
# the same call on the CPU (tests/test_torch_chip_smoke_constants.py
# recomputes them).  Each fit: the web_scale_workload arguments,
# partitions, capacity and fit arguments; the pooled runs' worker counts
# (fit-quick's follows the host's cores, as bench_scale's does).
SCALE_VARIANT = "peeldevice+spandevice"
SCALE_RUNS = {
    "stream": (),
    "fit-quick": ("span_gain", "lockstep_peel", "cover_rounds"),
    "web-mid": ("span_gain", "lockstep_peel", "cover_rounds"),
    "service": ("span_gain", "lockstep_peel"),
}
SCALE_FITS = {
    "fit-quick": (dict(num_items=10_000, num_queries=50_000,
                       num_clusters=256, seed=0), 32, 650,
                  dict(num_shards=8, max_moves=100, boundary_repair=64)),
    "web-mid": (dict(num_items=2500, num_queries=10_000, num_clusters=48,
                     cross_frac=0.05, seed=0), 24, 210,
                dict(num_shards=4, max_moves=150, boundary_repair=128)),
}
SCALE_POOLED = {"fit-quick": None, "web-mid": 2}
# fit-quick's CPU twin as counted once, in place of running it (~150 s of
# host time): its dispatch, which the card's launches must equal.  Its held
# values are SCALE_HELD's, and its member is pinned there bit for bit, so
# the calls it makes do not change from run to run
SCALE_DISPATCH = {
    "fit-quick": {"span_gain": 1004, "cover_rounds": 2,
                  "lockstep_peel": 1479},
}
SCALE_STATS = ("shards", "components", "boundary_edges", "boundary_cost",
               "shard_moves", "repair_moves")
SCALE_SECONDS = ("shard_seconds", "fit_seconds", "merge_seconds",
                 "repair_seconds")
SCALE_SERVICE_EPS = 0.02
SCALE_HELD = {
    "stream": {
        "plain": {
            "edges": 1000000,
            "pins": 4780516,
            "csr_sha256": "1518c176106344986f15ace5c9fd80b0"
                          "0aba43b847c485089035d7902c52e59a",
        },
        "merged": {
            "edges": 966454,
            "pins": 4671425,
            "csr_sha256": "268999a5a46c625410a2e24e3aaee6be"
                          "84947030bed31fe8f590cbaa48f1f428",
        },
    },
    "fit-quick": {
        "shards": 8,
        "components": 2,
        "boundary_edges": 7933,
        "boundary_cost": 10025.0,
        "shard_moves": 255,
        "repair_moves": 64,
        "member_sha256": "e9e1ef48e90f7306536a85d2742081b0"
                         "bade42de63ff9796eb0446db6b1ef4c1",
        "avg_span": 1.41094,
    },
    "web-mid": {
        "shards": 4,
        "components": 1,
        "boundary_edges": 1783,
        "boundary_cost": 1799.0,
        "shard_moves": 232,
        "repair_moves": 128,
        "member_sha256": "7f106e3596d76c0185fb0cb77a9f4ee4"
                         "0f741ca950753eb6baa05614b5ead85f",
        "avg_span": 1.3408,
    },
    "service": {
        "json_sha256": "65431e2e4484b88fde6f19aadaa69051"
                       "aaf91937ef981e9904ae633dc40c9884",
        "algorithm": "lmbr+sharded",
        "durability_copies": 965,
        "shards": 4,
        "components": 1,
        "boundary_edges": 1783,
        "boundary_cost": 1799.0,
        "shard_moves": 232,
        "repair_moves": 128,
    },
}

def _bound_ms(nbytes: float, ops: float,
              peak: float = FP32_OPS_PER_S) -> tuple[float, str]:
    return _bound_ms_by_type(nbytes, ((ops, peak),))


def _bound_ms_by_type(nbytes: float, work) -> tuple[float, str]:
    """The bound of work done as (ops, peak) parts, each at the card's
    peak for its type and one after another, against ``nbytes`` moved."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_times(torch, fn, iters: int) -> dict:
    """Device ms per call of each kernel (by name) that ``iters`` calls of
    ``fn`` launch: the profiler's self device time over ``iters`` (empty
    when the profiler saw no device activity).  Unlike ``_cuda_ms`` it
    leaves out the host's share of a call that the device waits for."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def _device_ms(torch, fn, iters: int) -> float | None:
    """Device time per call of everything ``fn`` launches (None when the
    profiler saw no device activity)."""
    times = _device_times(torch, fn, iters)
    return sum(times.values()) if times else None


def _fmt_ms(x) -> str:
    return "not_measured" if x is None else f"{x:.4f}"


def _max_abs(got, want) -> float:
    diffs = [float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
             for g, w in zip(got, want)]
    return max(diffs)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ inputs
def _span_inputs(np, torch, rng, A, N, W, dev):
    codes = rng.integers(0, 2**64, size=(A, N, W), dtype=np.uint64)
    rem = rng.integers(0, 2**64, size=(A, W), dtype=np.uint64)
    # all-ones words, the sign bit of the int64 view included
    codes[: A // 8, 0, :] = np.uint64(0xFFFFFFFFFFFFFFFF)
    rem[: A // 16, :] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return (torch.from_numpy(codes.view(np.int64)).to(dev),
            torch.from_numpy(rem.view(np.int64)).to(dev))


def _cover_inputs(np, torch, rng, B, N, W, dev, copies=3):
    """Packed buckets whose every pin is stored on 1..copies partitions;
    a few queries fill a whole word on one partition."""
    lo = 3 if W == 1 else 64 * (W - 1) + 1
    hi = 11 if W == 1 else 64 * W
    sizes = rng.integers(lo, hi + 1, size=B)
    sizes[: max(1, B // 100)] = 64 * W
    codes = np.zeros((B, N, W), dtype=np.uint64)
    rem = np.zeros((B, W), dtype=np.uint64)
    for b in range(B):
        s = int(sizes[b])
        for j in range(s):
            rem[b, j // 64] |= np.uint64(1) << np.uint64(j % 64)
        if b < max(1, B // 100):
            codes[b, int(rng.integers(N)), :] = rem[b]
            continue
        j = np.arange(s)
        for _ in range(int(rng.integers(1, copies + 1))):
            parts = rng.integers(0, N, size=s)
            np.bitwise_or.at(codes[b], (parts, j // 64),
                             np.uint64(1) << (j % 64).astype(np.uint64))
    return (torch.from_numpy(codes.view(np.int64)).to(dev),
            torch.from_numpy(rem.view(np.int64)).to(dev))


def _peel_inputs(np, torch, rng, G, K, U, dev):
    """Integer-weight peel batch: every edge holds 1..4 of its pair's valid
    item slots; weights below 2^24 in total."""
    nvalid = rng.integers(max(1, U // 2), U + 1, size=G).astype(np.int32)
    pins = (rng.random((G, K, 4)) * nvalid[:, None, None]).astype(np.int64)
    cnt = rng.integers(1, 5, size=(G, K))
    keep = np.arange(4)[None, None, :] < cnt[:, :, None]
    g_idx = np.broadcast_to(np.arange(G)[:, None, None], pins.shape)[keep]
    k_idx = np.broadcast_to(np.arange(K)[None, :, None], pins.shape)[keep]
    inc = torch.zeros(G * K * U, dtype=torch.float32, device=dev)
    inc[torch.from_numpy((g_idx * K + k_idx) * U + pins[keep]).to(dev)] = 1.0
    we = rng.integers(1, 9, size=(G, K)).astype(np.float32)
    nodew = rng.integers(1, 5, size=(G, U)).astype(np.float32)
    nodew[np.arange(U)[None, :] >= nvalid[:, None]] = 0.0
    return (inc.view(G, K, U), torch.from_numpy(we).to(dev),
            torch.from_numpy(nodew).to(dev), torch.from_numpy(nvalid).to(dev))


def _peel_tie_inputs(torch, G, K, U, dev):
    """Equal weights over a regular incidence: pair g's edge k holds slots
    k mod U and (k + 1 + g) mod U, every slot valid, so every degree starts
    equal and most rounds are decided by the lowest-slot rule."""
    k = torch.arange(K, device=dev)
    inc = torch.zeros((G, K, U), dtype=torch.float32, device=dev)
    for g in range(G):
        inc[g, k, k % U] = 1.0
        inc[g, k, (k + 1 + g) % U] = 1.0
    return (inc, torch.ones((G, K), device=dev),
            torch.ones((G, U), device=dev),
            torch.full((G,), U, dtype=torch.int32, device=dev))


def _peel_highest_slot(torch, plain, inc, we, nodew, nv):
    """The plain peel with ties broken to the highest slot (every slot
    valid): the plain version over the slots in reverse order, mapped
    back."""
    U = inc.shape[2]
    _require(bool((nv == U).all()), "highest-slot variant needs nvalid U")
    peel, rtot, rben = plain(inc.flip(2).contiguous(), we,
                             nodew.flip(1).contiguous(), nv)
    return torch.where(peel >= 0, U - 1 - peel, peel), rtot, rben


# ------------------------------------------------------------------ phases
def _ptxas_entries(report: str) -> list[dict]:
    """Each kernel entry of a ``ptxas -v`` report: its source, mangled name,
    registers and spill bytes."""
    out, source, entry, spills = [], None, None, (0, 0)
    for line in report.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spills = m.group(1), (0, 0)
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line):
            spills = (int(m.group(1)), int(m.group(2)))
        if (m := re.search(r"Used (\d+) registers", line)) and entry:
            out.append(dict(source=source, entry=entry,
                            registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            entry = None
    return out


def _ssd_instance(entry: str):
    """(pass, x dtype, P) of an ssd_scan kernel's mangled name; the chain
    pass has neither dtype nor P."""
    m = re.search(r"ssd_scan_(state|chain|output)_kernel", entry)
    if not m:
        return None
    if m.group(1) == "chain":
        return ("chain", None, None)
    p = re.search(r"Li(\d+)E", entry)
    return (m.group(1), "bf16" if "__nv_bfloat16" in entry else "f32",
            int(p.group(1)))


def _ssd_bwd_instance(entry: str):
    """(pass, x dtype, P) of an ssd_scan backward kernel's mangled name;
    the reduce pass has neither dtype nor P."""
    m = re.search(r"ssd_bwd_(state|grad|reduce)_kernel", entry)
    if not m:
        return None
    if m.group(1) == "reduce":
        return ("reduce", None, None)
    p = re.search(r"Li(\d+)E", entry)
    return (m.group(1), "bf16" if "__nv_bfloat16" in entry else "f32",
            int(p.group(1)))


# the backward's instances the build must make: the state and gradient
# passes for each x dtype and P, one reduce pass
SSD_BWD_INSTANCES = (
    tuple((p, dt, hd) for p in ("state", "grad") for dt in ("f32", "bf16")
          for hd in (16, 32, 64))
    + (("reduce", None, None),))
# the backward's passes, in launch order
SSD_BWD_PASSES = ("state", "grad", "reduce")


def _attention_instance(entry: str):
    """(kernel, dtype, D or G) of a CUDA-core flash_attention or a
    decode_attention instance's mangled name: ("flash", "bf16", 128) for
    flash_attention_kernel<__nv_bfloat16, 128, 2>, ("decode", "f32", 8)
    for decode_attention_kernel<float, 8>; None for any other entry."""
    m = re.search(r"(flash|decode)_attention_kernelI(13__nv_bfloat16|f)"
                  r"Li(\d+)E", entry)
    if not m:
        return None
    return (m.group(1), "bf16" if m.group(2) != "f" else "f32",
            int(m.group(3)))


# the tensor-core flash instances: D 64 (hymba-1.5b), 128 (glm4-9b, olmo-1b,
# nemotron-4-15b) and 80 (h2o-danube-1.8b); none may spill
WGMMA_HEAD_DIMS = (64, 128, 80)


def _bwd_instance(entry: str):
    """(pass, dtype, D, instance) of a flash_attention_bwd kernel's mangled
    name: ("delta", dtype, None, None) for flash_bwd_delta_kernel<T>, (kv
    or q, dtype, D, "fma") for the CUDA-core flash_bwd_{kv,q}_kernel<T, D,
    TPR>, (kv or q, "bf16", D, "wgmma") for the tensor-core
    flash_bwd_{kv,q}_wgmma_kernel<D>; None for any other."""
    if m := re.search(r"flash_bwd_delta_kernelI(13__nv_bfloat16|f)E",
                      entry):
        return ("delta", "bf16" if m.group(1) != "f" else "f32", None,
                None)
    if m := re.search(r"flash_bwd_(kv|q)_wgmma_kernelILi(\d+)E", entry):
        return (m.group(1), "bf16", int(m.group(2)), "wgmma")
    m = re.search(r"flash_bwd_(kv|q)_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                  entry)
    if not m:
        return None
    return (m.group(1), "bf16" if m.group(2) != "f" else "f32",
            int(m.group(3)), "fma")


# the backward's dispatch: (dtype, D) -> the instance of its dk / dv and
# dq passes, as the forward's (bf16 at D 64, 80 and 128 on the tensor
# cores); the delta pass has one instance per dtype
BWD_DISPATCH = {(dt, d): ("wgmma" if dt == "bf16" and d in WGMMA_HEAD_DIMS
                          else "fma")
                for dt in ("f32", "bf16") for d in (32, 64, 80, 128)}
BWD_INSTANCES = (
    tuple(("delta", dt, None, None) for dt in ("f32", "bf16"))
    + tuple((p, dt, d, inst) for (dt, d), inst in BWD_DISPATCH.items()
            for p in ("kv", "q")))


def _wgmma_instance(entry: str):
    """("flash", "bf16", D) of a tensor-core flash_attention instance's
    mangled name (flash_attention_wgmma_kernel<D>); None for any other."""
    m = re.search(r"flash_attention_wgmma_kernelILi(\d+)E", entry)
    return ("flash", "bf16", int(m.group(1))) if m else None


# the CUDA-core instances of the dense configs: flash in f32 at D 128 and
# 80 (serve-dense-check), and the decode blocks of 8 (glm4's G 16 in two
# groups), 6, 4 and 1 query heads
DENSE_INSTANCES = (("flash", "f32", 128), ("flash", "f32", 80),
                   ("decode", "bf16", 8), ("decode", "bf16", 6),
                   ("decode", "bf16", 4), ("decode", "bf16", 1))
# of these, glm4-9b's bf16 decode instance must not spill
DENSE_NO_SPILL = (("decode", "bf16", 8),)


def _mla_instance(entry: str):
    """(dtype, "prefill" or "decode", "wgmma" or "fma") of a latent
    attention kernel's mangled name: a bf16 instance of the tensor-core
    kernel (mla_attention_wgmma_kernel<decode>) or a CUDA-core instance
    (mla_attention_kernel<T, decode>); None for any other."""
    if m := re.search(r"mla_attention_wgmma_kernelILb([01])E", entry):
        return ("bf16", "decode" if m.group(1) == "1" else "prefill",
                "wgmma")
    m = re.search(r"mla_attention_kernelI(13__nv_bfloat16|f)Lb([01])E",
                  entry)
    if not m:
        return None
    return ("bf16" if m.group(1) != "f" else "f32",
            "decode" if m.group(2) == "1" else "prefill", "fma")


# the latent (MLA) kernels the build must make: bf16 prefill and decode on
# the tensor cores (no spill allowed), f32 prefill and decode on the CUDA
# cores
MLA_INSTANCES = (("bf16", "prefill", "wgmma"), ("f32", "prefill", "fma"),
                 ("bf16", "decode", "wgmma"), ("f32", "decode", "fma"))
MLA_NO_SPILL = (("bf16", "prefill", "wgmma"), ("bf16", "decode", "wgmma"))


def _latent_bwd_instance(entry: str):
    """(pass, dtype) of a latent backward kernel's mangled name: the pass
    is the name's middle (mla_bwd_{delta,q,kv,reduce}_kernel<T>, or the
    bf16 tensor-core mla_bwd_{q,kv}_wgmma_kernel); None for any other."""
    if m := re.search(r"mla_bwd_(q|kv)_wgmma_kernel", entry):
        return (f"{m.group(1)}_wgmma", "bf16")
    m = re.search(r"mla_bwd_(delta|q|kv|reduce)_kernelI(13__nv_bfloat16|f)E",
                  entry)
    if not m:
        return None
    return (m.group(1), "bf16" if m.group(2) != "f" else "f32")


# the latent backward's passes by instance: bf16 ("wgmma") runs its query
# and key sides on the tensor cores, f32 ("fma") on the CUDA cores; both
# share the delta pass and the sum of the key side's chunks
MLA_BWD_PASSES = {"wgmma": ("delta", "q_wgmma", "kv_wgmma", "reduce"),
                  "fma": ("delta", "q", "kv", "reduce")}
MLA_BWD_DTYPES = {"wgmma": "bf16", "fma": "f32"}
# the instances the build must make, and those that must not spill
MLA_BWD_INSTANCES = tuple((p, MLA_BWD_DTYPES[inst])
                          for inst, passes in MLA_BWD_PASSES.items()
                          for p in passes)
MLA_BWD_NO_SPILL = (("q_wgmma", "bf16"), ("kv_wgmma", "bf16"))
# flash_attention_latent_bwd_smem_bytes's passes: the f32 query and key
# sides, then the tensor-core ones
MLA_BWD_SMEM_PASSES = ("q", "kv", "q_wgmma", "kv_wgmma")


def phase_build(_build):
    so = _build.build(force=True)
    # read now: _build.lib() below finds the library built and resets them
    build_s = _build.BUILD_INFO["seconds"]
    entries = _ptxas_entries(_build.BUILD_INFO["ptxas"])
    tc = {_wgmma_instance(e["entry"]): e for e in entries
          if _wgmma_instance(e["entry"])}
    _require(sorted(n for _, _, n in tc) == sorted(WGMMA_HEAD_DIMS),
             f"build: ptxas reports tensor-core flash_attention instances "
             f"at D {sorted(n for _, _, n in tc)}, want {WGMMA_HEAD_DIMS}")
    blocks = {d: _build.lib().flash_attention_wgmma_blocks_per_sm(d)
              for d in WGMMA_HEAD_DIMS}
    # the decode instance of the serving path: bf16, G = 5
    dec = [e for e in entries
           if "decode_attention_kernelI13__nv_bfloat16Li5E" in e["entry"]]
    _require(len(dec) == 1, "build: no ptxas report of the bf16 G 5 "
             "decode_attention instance")
    # every ssd_scan instance: (pass, x dtype, P) -> registers and spills
    ssd = {_ssd_instance(e["entry"]): e for e in entries
           if _ssd_instance(e["entry"])}
    serving = [("state", "bf16", 64), ("chain", None, None),
               ("output", "bf16", 64)]
    for inst in serving:
        _require(inst in ssd, f"build: no ptxas report of ssd_scan {inst}")
        e = ssd[inst]
        _require(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                 f"build: the serving ssd_scan instance {inst} spills "
                 f"({e['spill_stores']} / {e['spill_loads']} bytes)")
    ssd_line = ", ".join(
        f"{k[0]}{'' if k[1] is None else f' {k[1]} P {k[2]}'} "
        f"registers={e['registers']} spills={e['spill_stores']}/"
        f"{e['spill_loads']}"
        for k, e in sorted(ssd.items(), key=lambda kv: str(kv[0])))
    # every CUDA-core flash and decode instance; the dense path's spill
    # nothing
    att = {_attention_instance(e["entry"]): e for e in entries
           if _attention_instance(e["entry"])}
    for inst in DENSE_INSTANCES:
        _require(inst in att, f"build: no ptxas report of {inst}")
    dense_line = ", ".join(
        f"{k} {dt} {'D' if k == 'flash' else 'G'} {n} "
        f"registers={att[k, dt, n]['registers']} "
        f"spills={att[k, dt, n]['spill_stores']}/{att[k, dt, n]['spill_loads']}"
        for k, dt, n in DENSE_INSTANCES)
    # the latent (MLA) kernels' four instances
    mla = {_mla_instance(e["entry"]): e for e in entries
           if _mla_instance(e["entry"])}
    _require(sorted(mla) == sorted(MLA_INSTANCES),
             f"build: ptxas reports mla_attention instances {sorted(mla)}, "
             f"want {sorted(MLA_INSTANCES)}")
    mla_line = ", ".join(
        f"{k} {d} {r} registers={mla[d, k, r]['registers']} "
        f"spills={mla[d, k, r]['spill_stores']}/"
        f"{mla[d, k, r]['spill_loads']}" for d, k, r in MLA_INSTANCES)
    # ssd_scan's backward: every instance built, and the gradient pass's
    # shared memory at mamba2's widths
    ssd_bwd = {_ssd_bwd_instance(e["entry"]): e for e in entries
               if _ssd_bwd_instance(e["entry"])}
    _require(set(ssd_bwd) == set(SSD_BWD_INSTANCES),
             f"build: ptxas reports ssd_scan_bwd instances "
             f"{sorted(ssd_bwd, key=str)}, want {SSD_BWD_INSTANCES}")
    ssd_bwd_line = ", ".join(
        f"{k[0]}{'' if k[1] is None else f' {k[1]} P {k[2]}'} "
        f"registers={ssd_bwd[k]['registers']} spills="
        f"{ssd_bwd[k]['spill_stores']}/{ssd_bwd[k]['spill_loads']}"
        for k in SSD_BWD_INSTANCES)
    ssd_bwd_smem = _build.lib().ssd_scan_bwd_grad_smem_bytes(64, 128)
    _require(ssd_bwd_smem <= 232448, f"build: the ssd_scan_bwd gradient "
             f"pass needs {ssd_bwd_smem} bytes of shared memory at P 64, "
             "N 128")
    for inst, e in ssd_bwd.items():
        _require(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                 f"build: the ssd_scan_bwd instance {inst} spills "
                 f"({e['spill_stores']} / {e['spill_loads']} bytes)")
    # flash_attention_latent's backward: every instance built, and the
    # shared memory of its two row-walking passes
    mla_bwd = {_latent_bwd_instance(e["entry"]): e for e in entries
               if _latent_bwd_instance(e["entry"])}
    _require(set(mla_bwd) == set(MLA_BWD_INSTANCES),
             f"build: ptxas reports mla_attention_bwd instances "
             f"{sorted(mla_bwd)}, want {MLA_BWD_INSTANCES}")
    mla_bwd_smem = {
        p: _build.lib().flash_attention_latent_bwd_smem_bytes(i)
        for i, p in enumerate(MLA_BWD_SMEM_PASSES)}
    _require(0 < min(mla_bwd_smem.values())
             and max(mla_bwd_smem.values()) <= 232448,
             f"build: the latent backward needs {mla_bwd_smem} bytes of "
             "shared memory a block")
    mla_bwd_line = ", ".join(
        f"{p} {dt} registers={mla_bwd[p, dt]['registers']} spills="
        f"{mla_bwd[p, dt]['spill_stores']}/{mla_bwd[p, dt]['spill_loads']}"
        + (f" smem_bytes={mla_bwd_smem[p]}" if p in mla_bwd_smem else "")
        for p, dt in MLA_BWD_INSTANCES)
    # flash_attention's backward: every instance built
    bwd = {_bwd_instance(e["entry"]): e for e in entries
           if _bwd_instance(e["entry"])}
    _require(set(bwd) == set(BWD_INSTANCES),
             f"build: ptxas reports flash_attention_bwd instances "
             f"{sorted(bwd, key=str)}, want {BWD_INSTANCES}")
    # the tensor-core passes' blocks per SM and dynamic shared memory
    lib = _build.lib()
    bwd_blocks = {(p, d): (
        lib.flash_attention_bwd_wgmma_blocks_per_sm(d, p == "q"),
        lib.flash_attention_bwd_wgmma_smem_bytes(d, p == "q"))
        for p, _, d, inst in BWD_INSTANCES if inst == "wgmma"}
    bwd_line = ", ".join(
        f"{p} {dt}{'' if d is None else f' D {d}'}"
        f"{'' if inst is None else f' {inst}'} "
        f"registers={bwd[p, dt, d, inst]['registers']} "
        f"spills={bwd[p, dt, d, inst]['spill_stores']}/"
        f"{bwd[p, dt, d, inst]['spill_loads']}"
        + (f" blocks_per_sm={bwd_blocks[p, d][0]} "
           f"smem_bytes={bwd_blocks[p, d][1]}" if inst == "wgmma" else "")
        for p, dt, d, inst in BWD_INSTANCES)
    tc_line = ", ".join(
        f"D {n} registers={tc[k]['registers']} spills="
        f"{tc[k]['spill_stores']}/{tc[k]['spill_loads']} "
        f"blocks_per_sm={blocks[n]}"
        for n in WGMMA_HEAD_DIMS for k in [("flash", "bf16", n)])
    print(f"build: {build_s:.2f} s -> {Path(so).name} "
          f"flash_attention wgmma instances (bf16, spill stores/loads "
          f"bytes): {tc_line}; decode_attention bf16 G 5 "
          f"instance: registers={dec[0]['registers']} "
          f"spill_stores={dec[0]['spill_stores']} "
          f"spill_loads={dec[0]['spill_loads']}; dense path instances "
          f"(spill stores/loads bytes): {dense_line}; ssd_scan instances "
          f"(spill stores/loads bytes): {ssd_line}; mla_attention "
          f"instances (spill stores/loads bytes): {mla_line}; "
          f"flash_attention_bwd instances (spill stores/loads bytes): "
          f"{bwd_line}; ssd_scan_bwd instances (spill stores/loads "
          f"bytes): {ssd_bwd_line}, grad smem_bytes={ssd_bwd_smem} at P 64 "
          f"N 128; mla_attention_bwd instances (spill stores/loads bytes): "
          f"{mla_bwd_line}", flush=True)
    for e in entries:
        print(f"  {e['source']} {e['entry'][:60]} registers={e['registers']} "
              f"spill_stores={e['spill_stores']} "
              f"spill_loads={e['spill_loads']}")
    for inst, e in [*tc.items(), *((i, att[i]) for i in DENSE_NO_SPILL),
                    *((i, mla[i]) for i in MLA_NO_SPILL),
                    *((i, mla_bwd[i]) for i in MLA_BWD_NO_SPILL),
                    *((i, e) for i, e in bwd.items() if i[3] == "wgmma")]:
        _require(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                 f"build: the instance {inst} spills "
                 f"({e['spill_stores']} / {e['spill_loads']} bytes)")
    for d, n in blocks.items():
        _require(n >= 1, f"build: the D {d} tensor-core flash instance "
                 f"fits no block on an SM ({n})")
    for (p, d), (n, _) in bwd_blocks.items():
        _require(n >= 1, f"build: the D {d} tensor-core backward {p} pass "
                 f"fits no block on an SM ({n})")
    # the instances the kernels phase must run: the tensor-core flash ones
    # under the same (kernel, dtype, D) keys as the CUDA-core ones
    return set(ssd), set(ssd_bwd), set(att) | set(tc)


def phase_kernels(np, torch, dev):
    from repro_torch import _build
    from repro_torch.kernels.cover_rounds.ops import (
        cover_rounds, cover_rounds_plain, rounds_class)
    from repro_torch.kernels.lockstep_peel.ops import (
        lockstep_peel, lockstep_peel_plain, uses_shared_memory)
    from repro_torch.kernels.span_gain.ops import span_gains, span_gains_plain

    rng = np.random.default_rng(0)
    rows = {}

    # span_gain: one greedy round of 4096 active queries
    sg = []
    for N in (35, 64, 256):
        for W in (1, 2):
            c, r = _span_inputs(np, torch, rng, 4096, N, W, dev)
            got, want = span_gains(c, r), span_gains_plain(c, r)
            torch.cuda.synchronize()
            err = _max_abs([got], [want])
            _require(err == 0, f"span_gain N={N} W={W}: max|diff| {err}")
            A = 4096
            nbytes = A * N * W * 8 + A * W * 8 + A * N * 4
            bound, by = _bound_ms(nbytes, 3 * A * N * W)
            sg.append(dict(shape=f"A4096.N{N}.W{W}", max_abs_err=err,
                           ms=_cuda_ms(torch, lambda: span_gains(c, r), 200),
                           plain_ms=_cuda_ms(
                               torch, lambda: span_gains_plain(c, r), 20),
                           bound_ms=bound, bound_by=by))
    rows["span_gain"] = dict(sg[2], shapes=sg)   # stress tier: N=64, W=1

    # cover_rounds: the class the C side picks agrees with ops.py at the
    # class edges
    lib = _build.lib()
    classes = ("register", "shared", "global")
    for N in (0, 1, 31, 32, 33, 64, 65, 128, 129, 255, 256, 257, 1024, 1025,
              2048, 2049, 65536):
        for W in (0, 1, 2, 3, 7, 8, 9, 32):
            _require(rounds_class(N, W)
                     == classes[lib.cover_rounds_class(N, W)],
                     f"cover_rounds class of N={N} W={W}: ops.py and the "
                     "source disagree")
    # the stress tier's full bucket (10 000 queries, N 64, W 1), a
    # multi-word bucket, one over the warp classes, fig9's path bucket
    # (14 027 queries, N 35, W 1), then each class edge: the rows a lane
    # holds in the register class (32 / 33, 64 / 65, 128 / 129, 256), the
    # shared class past it (N 257 at W 1) up to 2048 words (N 2048 at W 1,
    # N 256 at W 8), and one past that (global)
    cr = []
    cases = [(10_000, 64, 1), (2_000, 35, 2), (64, 256, 32), (14_027, 35, 1),
             (4096, 32, 1), (4096, 33, 1), (4096, 65, 1), (4096, 128, 1),
             (4096, 129, 1), (4096, 256, 1), (2048, 257, 1), (512, 2048, 1),
             (512, 2049, 1), (1024, 256, 8), (1024, 257, 8), (1024, 40, 5),
             (512, 16, 9)]
    for i, (B, N, W) in enumerate(cases):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        torch.cuda.synchronize()
        err = _max_abs([ch, bad.int()], [ch_p, bad_p.int()])
        _require(err == 0, f"cover_rounds B={B} N={N} W={W}: max|diff| {err}")
        _require(not bool(bad.any()), "coverable bucket flagged bad")
        spans = (ch_p >= 0).sum(dim=1)
        Rmax = ch.shape[1]
        nbytes = B * N * W * 8 + B * W * 8 + B * Rmax * 4 + B
        ops = float(spans.sum()) * N * (3 * W + 1)
        bound, by = _bound_ms(nbytes, ops)
        times = _device_times(torch, lambda: cover_rounds(c, r), 50)
        dev_ms = sum(t for k, t in times.items() if "cover_rounds" in k)
        cr.append(dict(shape=f"B{B}.N{N}.W{W}", cls=rounds_class(N, W),
                       max_abs_err=err,
                       ms=_cuda_ms(torch, lambda: cover_rounds(c, r), 50),
                       device_ms=dev_ms if times else None,
                       plain_ms=_cuda_ms(
                           torch, lambda: cover_rounds_plain(c, r), 3)
                       if i < 4 else None,
                       bound_ms=bound, bound_by=by,
                       spans_max=int(spans.max())))
    _require({row["cls"] for row in cr} == set(classes),
             "a cover_rounds class was not exercised")
    _require(cr[0]["cls"] == cr[3]["cls"] == "register",
             "a path shape of cover_rounds left the register class")
    # equal best gains: every query stores all its pins on two or more
    # partitions (on one lane or on several); the lowest id must win, and
    # the check must be able to see a highest-id rule
    for B, N, W in ((4096, 35, 1), (4096, 256, 1), (1024, 100, 3),
                    (64, 256, 32)):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        tied = torch.from_numpy(rng.random((B, N)) < 4.0 / N).to(dev)
        tied[:, 5] = tied[:, 37 % N] = True
        c = torch.where(tied[:, :, None], r[:, None, :], c)
        # every partition that stores all the pins (a few queries of the
        # inputs already hold one)
        tied = ((c & r[:, None, :]) == r[:, None, :]).all(dim=2)
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        low = torch.argmax(tied.int(), dim=1).int()
        high = N - 1 - torch.argmax(tied.flip(1).int(), dim=1).int()
        _require(torch.equal(ch, ch_p) and torch.equal(bad, bad_p),
                 f"cover_rounds ties B={B} N={N} W={W}: kernel and plain "
                 "version differ")
        _require(torch.equal(ch[:, 0], low) and bool((ch[:, 1] == -1).all()),
                 f"cover_rounds ties N={N} W={W}: not the lowest id")
        _require(bool((high != low).all()), "tie check cannot see a "
                 "highest-id rule")
    # an uncoverable query is flagged, the others still resolve
    c, r = _cover_inputs(np, torch, rng, 8, 16, 1, dev)
    c[3] = 0
    (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
    _require(bad.tolist() == bad_p.tolist() and bool(bad[3])
             and int(bad.sum()) == 1, "bad flag mismatch")
    _require(torch.equal(ch, ch_p), "cover_rounds bad-row chosen mismatch")
    # queries that go bad after good rounds (pin 0 stored nowhere) keep
    # their earlier choices, in every class; a spoiled query that uses all
    # N partitions first ends at Rmax, not bad, as in the reference
    for B, N, W in ((14_027, 35, 1), (2_000, 35, 2), (64, 256, 32)):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        spoil = torch.from_numpy(rng.random(B) < 0.05).to(dev)
        c[:, :, 0] = torch.where(spoil[:, None], c[:, :, 0] & ~1, c[:, :, 0])
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        _require(torch.equal(bad, bad_p) and bool(bad.any())
                 and not bool((bad & ~spoil).any()),
                 f"cover_rounds late-bad B={B} N={N} W={W}: bad flags")
        _require(torch.equal(ch, ch_p),
                 f"cover_rounds late-bad B={B} N={N} W={W}: chosen mismatch")
        _require(bool((ch[bad, 0] >= 0).any()),
                 "no query went bad after a good round")
    rows["cover_rounds"] = dict(cr[0], shapes=cr)

    # lockstep_peel: the size class the C side picks agrees with ops.py at
    # the class edges
    for K in (0, 1, 31, 32, 33, 255, 256, 257, 1024, 8192, 65536):
        for U in (1, 31, 32, 33, 255, 256, 257, 512):
            _require(uses_shared_memory(K, U)
                     == bool(lib.lockstep_peel_uses_shared_memory(K, U)),
                     f"lockstep_peel size class of K={K} U={U}: ops.py and "
                     "the source disagree")
    # pow2 classes of the LMBR dispatch (at most 2^22 floats per launch):
    # the widest warp class, then the global-scratch class, with the scale
    # fits' heaviest cells (K, U) (4096, 1024), (4096, 512) and (2048, 512);
    # then the warp class at fit-stress's and fit-paper's shapes: (128, 64)
    # at G 1, 8 (the headline) and 512 (a full launch), (64, 64) and
    # (64, 32), odd K and U, fit-paper's widest class (128, 256), a
    # tie-heavy batch, and weights too heavy for the packed argmin
    lp = []
    cases = [((256, 256, 64), "random"), ((64, 1024, 64), "random"),
             ((1, 8192, 512), "random"), ((1, 4096, 1024), "random"),
             ((2, 4096, 512), "random"), ((2, 2048, 512), "random"),
             ((1, 128, 64), "random"),
             ((8, 128, 64), "random"), ((512, 128, 64), "random"),
             ((3, 64, 64), "random"), ((3, 64, 32), "random"),
             ((4, 101, 97), "random"), ((3, 128, 256), "random"),
             ((8, 128, 64), "ties"),
             ((8, 128, 64), "heavy")]
    for (G, K, U), kind in cases:
        if kind == "ties":
            inc, we, nodew, nv = _peel_tie_inputs(torch, G, K, U, dev)
        else:
            inc, we, nodew, nv = _peel_inputs(np, torch, rng, G, K, U, dev)
        if kind == "heavy":
            # totals past 2^21 (still below 2^24): the kernel's argmin
            # cannot pack degree and slot into one key
            we = we * 16384.0
        got = lockstep_peel(inc, we, nodew, nv)
        want = lockstep_peel_plain(inc, we, nodew, nv)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        label = f"G{G}.K{K}.U{U}" + ("" if kind == "random" else f".{kind}")
        _require(err == 0, f"lockstep_peel {label}: max|diff| {err}")
        extra = {}
        if kind == "ties":
            # the check sees the tie rule: ties to the highest slot differ
            high = _peel_highest_slot(torch, lockstep_peel_plain, inc, we,
                                      nodew, nv)
            _require(not torch.equal(high[0], got[0]),
                     f"lockstep_peel {label}: the check cannot see ties "
                     "broken to the highest slot")
            extra["highest_slot_peels_differ"] = int(
                (high[0] != got[0]).sum())
        rounds = (want[0] >= 0).sum(dim=1).double()
        nbytes = (G * K * U * 4 + G * K * 4 + G * U * 4 + G * 4
                  + 3 * G * U * 4)
        # degree build + updates (2 K U each) and per-round argmin + column
        design_ops = float((4.0 * K * U + rounds * (U + K)).sum())
        bound, by = _bound_ms(nbytes, design_ops)
        dev_ms = _device_ms(torch, lambda: lockstep_peel(inc, we, nodew, nv),
                            20)
        lp.append(dict(shape=label, max_abs_err=err,
                       smem=uses_shared_memory(K, U),
                       ms=_cuda_ms(torch,
                                   lambda: lockstep_peel(inc, we, nodew, nv),
                                   20),
                       device_ms=dev_ms,
                       plain_ms=_cuda_ms(
                           torch,
                           lambda: lockstep_peel_plain(inc, we, nodew, nv),
                           2),
                       bound_ms=bound, bound_by=by,
                       rounds_max=int(rounds.max()),
                       device_us_per_round=(
                           None if dev_ms is None or not rounds.max()
                           else dev_ms * 1e3 / float(rounds.max())),
                       design_ops=design_ops,
                       tpu_design_ops=float(rounds.max()) * 2 * K * U * G,
                       **extra))
    _require(not any(r["smem"] for r in lp[1:6]),
             "a global-scratch peel shape left its class")
    _require(all(r["smem"] for r in lp[6:]), "a warp-class peel shape left "
             "the warp class")
    rows["lockstep_peel"] = dict(lp[7], shapes=lp)   # (128, 64) at G 8

    parts = []
    for name, row in rows.items():
        parts.append(f"{name} max|diff|={row['max_abs_err']:g} "
                     f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={row['bound_ms']:.5f}")
    print("kernels: " + "; ".join(parts), flush=True)
    for name, row in rows.items():
        for s in row["shapes"]:
            print(f"  {name} {json.dumps(s)}")
    return rows


# hymba-1.5b serving shapes: batch 8, 25 query / 5 kv heads of 64, a 2048-
# token prompt and 64 decode steps (cache 2112), 50 SSM heads of 64,
# state 16, chunk 256
SERVE = dict(batch=8, requests=16, prefill_len=2048, decode_len=64)
# Kernel and plain version both compute in fp32 and round once on the bf16
# store, so their outputs differ by at most one bf16 ulp of the output
# (2^-7 of |x| at most; atol covers the fp32 difference near zero), and only
# where the two fp32 values straddle a rounding boundary, which is rare.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_DIFF_SHARE = 0.01                # largest share of differing elements
TOL32 = dict(rtol=2e-4, atol=2e-4)    # f32


def _close(torch, got, want, tol) -> bool:
    return all(bool(torch.allclose(g.float(), w.float(), **tol))
               for g, w in zip(got, want))


# the wrong variants a check must reject: its field and what it is
WRONG_VARIANTS = {"no_window": "a missing window mask",
                  "causal": "a causal mask where none belongs"}


def _attention_check(torch, label, dtype, got, want, plain32, unmasked,
                     wrong="no_window"):
    """Hold an attention kernel's output against its plain version and
    show that the check rejects two wrong variants: the plain version
    ``unmasked`` (without the window mask, window layers only; or, with
    ``wrong="causal"``, with a causal mask in a non-causal row) and, in
    bf16, a store that truncates the fp32 result (``plain32``) instead of
    rounding it.  Returns the row's check fields."""
    err = _max_abs([got], [want])
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL32
    _require(_close(torch, [got], [want], tol),
             f"{label}: max|diff| {err}")
    out = dict(max_abs_err=err)
    if dtype == torch.bfloat16:
        share = float((got != want).float().mean())
        _require(share <= BF16_DIFF_SHARE,
                 f"{label}: {share:.4%} of the bf16 outputs differ")
        trunc = (plain32.view(torch.int32) & -65536).view(torch.float32)
        trunc_share = float((trunc.to(dtype) != want).float().mean())
        _require(trunc_share > BF16_DIFF_SHARE,
                 f"{label}: the check cannot see a truncating store")
        out.update(bf16_diff_share=share, trunc_store_share=trunc_share,
                   trunc_store_err=_max_abs([trunc], [want]))
    if unmasked is not None:
        out[f"{wrong}_err"] = _max_abs([unmasked], [want])
        _require(not _close(torch, [unmasked], [want], tol),
                 f"{label}: the check cannot see {WRONG_VARIANTS[wrong]}")
    return out


# The forward's lse against its plain version: each element within
# LSE_TOL[1] + LSE_TOL[0] |want| (fp32 both; the kernel sums the scores and
# the exponentials in another order), and the check must reject the lse of
# the other causality
LSE_TOL = (1e-5, 1e-4)


def _lse_err(torch, got, want) -> float:
    """The largest |got - want| over its allowance (at most 1 passes)."""
    w = want.double()
    allow = LSE_TOL[1] + LSE_TOL[0] * w.abs()
    return float(((got.double() - w).abs() / allow).max())


def _lse_check(torch, label, got, want, wrong) -> dict:
    err = _lse_err(torch, got, want)
    _require(err <= 1.0, f"{label}: lse off by {err:.3g} of its tolerance")
    werr = _lse_err(torch, wrong, want)
    _require(werr > 1.0, f"{label}: the lse check cannot see the lse of "
             f"the other causality ({werr:.3g})")
    return dict(lse_max_abs_err=float((got - want).abs().max()),
                lse_tol_ratio=err, lse_wrong_ratio=werr)


def _flash_pairs(torch, dev, S, T, causal, window):
    """(visible (query, key) mask or None when every pair is visible, the
    number of visible pairs) of one (batch, head)."""
    if not causal and window is None:
        return None, float(S * T)
    qi = torch.arange(S, device=dev)[:, None]
    kj = torch.arange(T, device=dev)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask, float(mask.sum())


def _flash_rows(torch, randn, dev, dtype, peak, B, S, H, K, D,
                windows=(None, 1024), label="", T=None, causal=True):
    """flash_attention at (B, S, T (default S), H, K, D) in the global and
    window-1024 layers (or ``windows``), causal or not: the check against
    the plain version (a non-causal row must also reject the causal
    variant); the launch that stores lse (``flash_attention_lse``) must
    give the same output and its lse must pass ``_lse_check``; and the
    times, kernel and SDPA (with no mask where every pair is visible) each
    also as profiler device time per call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_lse, flash_attention_lse_plain,
        flash_attention_plain, instance)

    T = S if T is None else T
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    q = randn(B, S, H, D).to(dtype)
    k, v = randn(B, T, K, D).to(dtype), randn(B, T, K, D).to(dtype)
    qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    wants, rows = {}, []
    for window in windows:
        got = flash_attention(q, k, v, causal=causal, window=window)
        # the launch that stores lse, as training's forward runs it
        lse_out, lse = flash_attention_lse(q, k, v, causal=causal,
                                           window=window)
        want, want_lse = flash_attention_lse_plain(q, k, v, causal=causal,
                                                   window=window)
        wants[window] = want
        other, wrong_lse = flash_attention_lse_plain(
            q, k, v, causal=not causal, window=window)
        plain32 = (flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
                   if dtype == torch.bfloat16 else None)
        if causal:
            wrong, name = (wants[None] if window else None), "no_window"
        else:
            wrong, name = other, "causal"
        torch.cuda.synchronize()
        row = (f"flash_attention {label}{tag} S={S} T={T} D={D} "
               f"causal={causal} window={window}")
        check = _attention_check(torch, row, dtype, got, want, plain32,
                                 wrong, name)
        _require(torch.equal(lse_out, got),
                 f"{row}: the launch that stores lse gave another output")
        check.update(_lse_check(torch, row, lse, want_lse, wrong_lse))
        del got, plain32, wrong, other, lse_out, lse, want_lse, wrong_lse
        mask, pairs = _flash_pairs(torch, dev, S, T, causal, window)
        nbytes = (2 * B * S * H * D + 2 * B * T * K * D) * esz
        bound, by = _bound_ms(nbytes, 4.0 * D * pairs * B * H, peak)

        def kern():
            return flash_attention(q, k, v, causal=causal, window=window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=mask, enable_gqa=True)

        rows.append(dict(
            shape=f"{label}B{B}.S{S}" + (f".T{T}" if T != S else "")
            + f".H{H}.K{K}.D{D}.{tag}.w{window}"
            + ("" if causal else ".noncausal"),
            instance=instance(dtype, D), kernel_instance=f"{tag}.D{D}",
            **check,
            ms=_cuda_ms(torch, kern, 5),
            device_ms=_device_ms(torch, kern, 5),
            plain_ms=_cuda_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=causal, window=window), 2),
            library_ms=_cuda_ms(torch, sdpa, 5),
            library_device_ms=_device_ms(torch, sdpa, 5),
            bound_ms=bound, bound_by=by))
    return rows


def _decode_domain_rows(torch, dev, dtype):
    """decode_attention beyond the serving shape, through the same check:
    (a) a ring buffer that wrapped (positions out of slot order), empty
    slots, one row with nothing visible, per-row q_pos, T no multiple of
    the 64-slot chunks the splits take; (b) the same with a window of 40,
    under one chunk; (c) D 32 with G 1 and D 128 with G 8; (d) batch 1 at
    the serving cache, global and window 1024; and serve's warm-up step,
    batch 1 with 17 of 18 slots filled (one split), windows none, 8 and
    1024, its q a view at an odd element offset (only k and v must be
    16-byte aligned)."""
    from repro_torch.kernels.decode_attention.ops import (
        CHUNK, decode_attention, decode_attention_plain, resident_blocks,
        split_plan)

    gen = torch.Generator(device=dev).manual_seed(14)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    # fill: slots 0 .. fill - 1 hold positions 0 .. fill - 1; None: a ring
    cases = (  # label, B, H, K, D, T, fill, windows
        ("ring", 8, 25, 5, 64, 1000, None, (None, 40)),
        ("D32.G1", 2, 4, 4, 32, 777, None, (None, 40)),
        ("D128.G8", 2, 16, 2, 128, 1500, None, (None, 40)),
        ("batch1", 1, 25, 5, 64, 2112, 2080, (None, 1024)),
        ("warmup", 1, 25, 5, 64, 18, 17, (None, 8, 1024)),
    )
    rows = []
    for label, B, H, K, D, T, fill, windows in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        if label == "warmup":
            q = randn(B * H * D + 1).to(dtype)[1:].view(B, H, D)
            _require(q.data_ptr() % 16 != 0, "decode warmup: q is aligned")
        else:
            q = randn(B, H, D).to(dtype)
        k, v = randn(B, T, K, D).to(dtype), randn(B, T, K, D).to(dtype)
        slot = torch.arange(T, device=dev, dtype=torch.int32)
        if fill is None:
            roll = torch.tensor([0, 17, 150, 611, 3, 999, 500, 64][:B],
                                device=dev, dtype=torch.int32)
            kv_pos = ((slot[None] - roll[:, None]) % T).to(torch.int32)
            kv_pos[min(2, B - 1), :30] = -1
            if B > 3:
                kv_pos[3] = -1
            q_pos = torch.randint(60, T, (B,), generator=gen, device=dev,
                                  dtype=torch.int32)
        else:
            kv_pos = torch.where(slot < fill, slot, -1)[None].expand(B, T)
            q_pos = torch.full((B,), fill - 1, dtype=torch.int32, device=dev)
        kv_pos = kv_pos.contiguous()
        ns = split_plan(B, K, T, resident_blocks(
            torch.cuda.current_device(), H // K))
        if fill is None:
            _require(T % CHUNK != 0, f"decode {label}: T {T} is a multiple "
                     f"of the {CHUNK}-slot chunk the splits are cut into")
        wants = {}
        for window in windows:
            got = decode_attention(q, k, v, kv_pos, q_pos, window=window)
            wants[window] = want = decode_attention_plain(
                q, k, v, kv_pos, q_pos, window=window)
            plain32 = (decode_attention_plain(q.float(), k.float(),
                                              v.float(), kv_pos, q_pos,
                                              window=window)
                       if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            # the no-window variant is a wrong kernel only where the window
            # hides a slot that is otherwise visible (not so at warm-up's
            # 1024)
            seen = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            hides = window is not None and bool(
                (seen & (kv_pos <= q_pos[:, None] - window)).any())
            check = _attention_check(
                torch, f"decode_attention {label} {tag} window={window}",
                dtype, got, want, plain32, wants[None] if hides else None)
            rows.append(dict(shape=f"{label}.B{B}.T{T}.H{H}.K{K}.D{D}.{tag}"
                             f".w{window}", kernel_instance=f"{tag}.G{H // K}",
                             splits=ns, **check))
    return rows


# the dense configs' prefill (B 8, S = T 2048): label, H, K, D, windows
DENSE_FLASH = (
    ("glm4-9b", 32, 2, 128, (None,)),
    ("nemotron-4-15b", 48, 8, 128, (None,)),
    ("olmo-1b", 16, 16, 128, (None,)),
    ("h2o-danube-1.8b", 32, 8, 80, (None, 1024)),
)
# the tensor-core instance's edges at the dense head dims, bf16: a window
# of 40, under one 64-key tile (the per-warpgroup tile skip and the window
# edge inside a tile), at D 128 and D 80, and D 80 at the ragged S = T 1528
# with danube's serve-dense-check window: label, B, S, H, K, D, windows
DENSE_FLASH_EDGES = (
    ("window40", 2, 2048, 32, 2, 128, (None, 40)),
    ("window40", 2, 2048, 32, 8, 80, (None, 40)),
    ("ragged", 2, 1528, 32, 8, 80, (None, 1024)),
)
# their decode over the serving cache (B 8, T 2112): label, H, K, D, windows
DENSE_DECODE = (
    ("glm4-9b", 32, 2, 128, (None,)),              # G 16: two head groups
    ("nemotron-4-15b", 48, 8, 128, (None,)),       # G 6
    ("h2o-danube-1.8b", 32, 8, 80, (None, 40)),    # G 4
    ("olmo-1b", 16, 16, 128, (None,)),             # G 1
)
# decode's other group sizes (D 64, small): every block instance G 1..8
# runs in some row, and G 9, 10 and 12 take 3, 2 and 2 head groups
DECODE_GROUPS = (2, 3, 7, 9, 10, 12)
# the MoE config's prefill (B 8, S = T 2048) and decode over the serving
# cache (B 8, T 2112), bf16: label, H, K, D, windows (G 8, one head group)
MOE_FLASH = (("qwen3-moe-30b-a3b", 32, 4, 128, (None,)),)
MOE_DECODE = (("qwen3-moe-30b-a3b", 32, 4, 128, (None,)),)
# the encoder-decoder's and the VLM's prefill: seamless-m4t-medium's
# encoder (non-causal, S = T = its 1024 frames) and cross-attention
# (non-causal, the 2048-token prompt over the frames), the same at
# serve-encdec-check's ragged prefill 760 over 1000 frames (no 64-key tile
# divides T; in f32 as well), and internvl2-2b's causal prefill (G 2):
# label, B, S, T, H, K, D, causal, also in f32
FRONTEND_FLASH = (
    ("seamless-encoder", 8, 1024, 1024, 16, 16, 64, False, False),
    ("seamless-cross", 8, 2048, 1024, 16, 16, 64, False, False),
    ("ragged-cross", 2, 760, 1000, 16, 16, 64, False, True),
    ("internvl2-2b", 8, 2048, 2048, 16, 8, 128, True, False),
)
# seamless's cross-attention decode over the encoder's k / v: every slot
# valid (kv_pos 0..F-1) and the query at F - 1: label, B, T = F, H, K, D
CROSS_DECODE = (("seamless-cross", 8, 1024, 16, 16, 64),)
# the decoder positions that serve-encdec-check's decode runs at, all
# below its frames: a query there would hide frames (the wrong variant)
CROSS_DECODE_LOW_POS = 760
# internvl2-2b's self-attention decode over the serving cache (B 8, T
# 2112), bf16: label, H, K, D, windows (G 2, one head group)
VLM_DECODE = (("internvl2-2b", 16, 8, 128, (None,)),)


def _decode_dense_rows(torch, dev, dtype, peak, table=DENSE_DECODE,
                       groups=DECODE_GROUPS):
    """decode_attention at a serving cache (B 8, T 2112; ``table``: the
    dense configs') over a wrapped ring buffer with empty slots and per-row
    q_pos, checked and timed beside SDPA; then the ``groups`` rows,
    checked."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain, head_groups,
        resident_blocks, split_plan)

    gen = torch.Generator(device=dev).manual_seed(19)
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    Bs, Ts = SERVE["batch"], SERVE["prefill_len"] + SERVE["decode_len"]
    cases = ([(label, Bs, H, K, D, Ts, windows, True)
              for label, H, K, D, windows in table]
             + [(f"G{g}", 2, 2 * g, 2, 64, 300, (None,), False)
                for g in groups])
    rows = []
    for label, B, H, K, D, T, windows, timed in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        q = randn(B, H, D).to(dtype)
        k, v = randn(B, T, K, D).to(dtype), randn(B, T, K, D).to(dtype)
        slot = torch.arange(T, device=dev, dtype=torch.int32)
        roll = torch.randint(0, T, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        kv_pos = ((slot[None] - roll[:, None]) % T).to(torch.int32)
        kv_pos[1, :30] = -1
        q_pos = torch.randint(T - 64, T, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        g = H // K
        ng = head_groups(g)
        ns = split_plan(B, K * ng, T, resident_blocks(
            torch.cuda.current_device(), g // ng))
        wants = {}
        for window in windows:
            got = decode_attention(q, k, v, kv_pos, q_pos, window=window)
            wants[window] = want = decode_attention_plain(
                q, k, v, kv_pos, q_pos, window=window)
            plain32 = (decode_attention_plain(q.float(), k.float(),
                                              v.float(), kv_pos, q_pos,
                                              window=window)
                       if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            check = _attention_check(
                torch, f"decode_attention {label} {tag} window={window}",
                dtype, got, want, plain32,
                wants[None] if window is not None else None)
            row = dict(shape=f"{label}.B{B}.T{T}.H{H}.K{K}.D{D}.{tag}"
                       f".w{window}", kernel_instance=f"{tag}.G{g // ng}",
                       head_groups=ng, splits=ns, **check)
            if timed:
                vis = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
                if window is not None:
                    vis &= kv_pos > q_pos[:, None] - window
                nvis = float(vis.sum())
                nbytes = (nvis * K * D * 2 * esz + B * T * 4 + B * 4
                          + 2 * B * H * D * esz)
                bound, by = _bound_ms(nbytes, 4.0 * D * H * nvis, peak)
                qT, kT, vT = (q[:, :, None], k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
                mask = vis[:, None, None, :]

                def kern():
                    return decode_attention(q, k, v, kv_pos, q_pos,
                                            window=window)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qT, kT, vT, attn_mask=mask, enable_gqa=True)

                row.update(
                    ms=_cuda_ms(torch, kern, 50),
                    device_ms=_device_ms(torch, kern, 50),
                    plain_ms=_cuda_ms(torch, lambda: decode_attention_plain(
                        q, k, v, kv_pos, q_pos, window=window), 10),
                    library_ms=_cuda_ms(torch, sdpa, 50),
                    library_device_ms=_device_ms(torch, sdpa, 50),
                    bound_ms=bound, bound_by=by)
            rows.append(row)
    return rows


def _cross_decode_rows(torch, dev, dtype, peak):
    """decode_attention as an encoder-decoder's cross-attention runs it in
    decode (``CROSS_DECODE``): over the encoder's k / v with every slot
    valid and the query at the last encoder position, so nothing is
    masked; the check must also reject queries at decoder positions below
    the frames (``CROSS_DECODE_LOW_POS`` on), which hide some.  Checked,
    and timed beside SDPA with no mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain, head_groups,
        resident_blocks, split_plan)

    gen = torch.Generator(device=dev).manual_seed(23)
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    rows = []
    for label, B, T, H, K, D in CROSS_DECODE:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        q = randn(B, H, D).to(dtype)
        k, v = randn(B, T, K, D).to(dtype), randn(B, T, K, D).to(dtype)
        kv_pos = torch.arange(T, device=dev, dtype=torch.int32).expand(
            B, T).contiguous()
        q_pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        low = torch.arange(CROSS_DECODE_LOW_POS, CROSS_DECODE_LOW_POS + B,
                           device=dev, dtype=torch.int32)
        got = decode_attention(q, k, v, kv_pos, q_pos)
        want = decode_attention_plain(q, k, v, kv_pos, q_pos)
        plain32 = (decode_attention_plain(q.float(), k.float(), v.float(),
                                          kv_pos, q_pos)
                   if dtype == torch.bfloat16 else None)
        wrong = decode_attention_plain(q, k, v, kv_pos, low)
        torch.cuda.synchronize()
        check = _attention_check(
            torch, f"decode_attention {label} {tag}", dtype, got, want,
            plain32, wrong, "causal")
        g = H // K
        ng = head_groups(g)
        ns = split_plan(B, K * ng, T, resident_blocks(
            torch.cuda.current_device(), g // ng))
        nbytes = (2 * B * T * K * D * esz + B * T * 4 + B * 4
                  + 2 * B * H * D * esz)
        bound, by = _bound_ms(nbytes, 4.0 * D * H * B * T, peak)
        qT, kT, vT = (q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous())

        def kern():
            return decode_attention(q, k, v, kv_pos, q_pos)

        def sdpa():
            return F.scaled_dot_product_attention(qT, kT, vT,
                                                  enable_gqa=True)

        rows.append(dict(
            shape=f"{label}.B{B}.T{T}.H{H}.K{K}.D{D}.{tag}.qpos{T - 1}",
            kernel_instance=f"{tag}.G{g // ng}", head_groups=ng, splits=ns,
            **check,
            ms=_cuda_ms(torch, kern, 50),
            device_ms=_device_ms(torch, kern, 50),
            plain_ms=_cuda_ms(torch, lambda: decode_attention_plain(
                q, k, v, kv_pos, q_pos), 10),
            library_ms=_cuda_ms(torch, sdpa, 50),
            library_device_ms=_device_ms(torch, sdpa, 50),
            bound_ms=bound, bound_by=by))
    return rows


# ssd_scan at the serving prefills: label, SSM heads, state N (B 8, S 2048,
# P 64, chunk 256); mamba2's N 128 runs its passes at chunk 128
SSD_SERVING = (("hymba-1.5b", 50, 16), ("mamba2-2.7b", 80, 128))


def _ssd_work(bf16: bool, B, S, NH, P, N, Lr) -> tuple:
    """(ops, peak) of ssd_scan's passes at run chunk ``Lr``, a chunk of one
    head and batch each: the state pass's x^T (w B) in fp32 FMA; the
    output pass's C B^T (lower triangle) and C h^T as split TF32 (three
    products each) and att . x as three bf16 products (bf16 x) or split
    TF32 (f32 x); the chain's multiply-add per state element."""
    nch = B * NH * -(-S // Lr)
    tri = Lr * (Lr + 1) / 2
    attx = 3 * tri * 2 * P * nch
    return ((nch * (2 * Lr * P * N + 2 * P * N), FP32_OPS_PER_S),
            (3 * nch * (tri * 2 * N + 2 * Lr * P * N)
             + (0 if bf16 else attx), TF32_OPS_PER_S),
            (attx if bf16 else 0, BF16_OPS_PER_S))


def _ssd_serving_row(torch, randn, dtype, label, NH, N):
    """ssd_scan at a serving prefill (B 8, S 2048, ``NH`` heads of 64,
    state ``N``, chunk 256) from a nonzero h0: the check against the plain
    version at chunk 256 (which must also refuse the scan with h0
    dropped), times per call and per pass, and the bound of the work the
    passes do at the chunk they run at."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ops import (run_chunk, ssd_scan,
                                                  ssd_scan_plain)

    B, S = SERVE["batch"], SERVE["prefill_len"]
    P, L = 64, 256
    Lr = run_chunk(N, L)
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    x = randn(B, S, NH, P).to(dtype)
    dt = F.softplus(randn(B, S, NH) - 1.0)
    a = -torch.exp(randn(NH, scale=0.3))
    bm, cm = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
    h0 = randn(B, NH, P, N, scale=0.1)
    ran = dict(ssd_scan.chunk_launches)
    got = ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)
    _require(ssd_scan.chunk_launches.get(Lr, 0) == ran.get(Lr, 0) + 1,
             f"ssd_scan {label} {tag}: the passes did not run at chunk {Lr}")
    want = ssd_scan_plain(x, dt, a, bm, cm, chunk=L, h0=h0)
    torch.cuda.synchronize()
    err = _max_abs(got, want)
    _require(_close(torch, got, want, TOL32),
             f"ssd_scan {label} {tag}: max|diff| {err}")
    # a kernel that dropped h0 (started from zero) must fail the check
    no_h0 = ssd_scan_plain(x, dt, a, bm, cm, chunk=L)
    no_h0_err = _max_abs(no_h0, want)
    _require(not _close(torch, no_h0, want, TOL32),
             f"ssd_scan {label} {tag}: the check cannot see a dropped h0")
    del got, want, no_h0
    nbytes = (B * S * NH * P * (esz + 4) + B * S * NH * 4 + NH * 4
              + 2 * B * S * N * 4 + 2 * B * NH * P * N * 4)
    bound, by = _bound_ms_by_type(nbytes, _ssd_work(dtype == torch.bfloat16,
                                                    B, S, NH, P, N, Lr))

    def kern():
        return ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)

    times = _device_times(torch, kern, 20)
    return dict(
        shape=f"{label}.B{B}.S{S}.H{NH}.P{P}.N{N}.L{L}.{tag}",
        instance=f"{tag}.P{P}", run_chunk=Lr,
        max_abs_err=err, no_h0_err=no_h0_err,
        ms=_cuda_ms(torch, kern, 20),
        device_ms=sum(times.values()) if times else None,
        device_ms_by_pass={p: sum(t for k, t in times.items()
                                  if f"ssd_scan_{p}_kernel" in k)
                           for p in ("state", "chain", "output")},
        plain_ms=_cuda_ms(torch, lambda: ssd_scan_plain(
            x, dt, a, bm, cm, chunk=L, h0=h0), 2),
        library_ms=None, library_device_ms=None, bound_ms=bound,
        bound_by=by)


# ssd_scan beyond the serving shape: label, B, S, H, P, N, chunk
SSD_DOMAIN = (
    ("warmup", 1, 16, 50, 64, 16, 256),         # serve's warm-up prompt
    ("serve-check", 2, 1536, 50, 64, 16, 256),  # serve-check's prompt
    ("ragged", 2, 1528, 50, 64, 16, 256),       # ... and its prefill
    ("P16", 2, 1000, 8, 16, 16, 256),
    ("P32", 2, 1000, 8, 32, 16, 256),
    ("N64.L64", 2, 1000, 8, 64, 64, 64),
    ("N64.L256", 1, 1000, 8, 64, 64, 256),      # the most shared memory
    ("N128.L128", 1, 2048, 80, 64, 128, 128),   # mamba2-2.7b's SSM widths
    ("N128.L256", 1, 2048, 80, 64, 128, 256),   # ... at its chunk (run 128)
    ("mamba2-ragged", 2, 1528, 80, 64, 128, 256),  # serve-ssm-check's prefill
    ("N72.L256", 1, 1000, 8, 64, 72, 256),      # run at 224
    ("N12.L100", 2, 777, 8, 32, 12, 100),       # N, chunk and S unpadded
    ("P16.N24.L72", 2, 500, 4, 16, 24, 72),
    ("x-offset", 1, 300, 4, 32, 16, 128),       # x at an odd element offset
)
SSD_REFUSED = (64, 129, 256)   # P, N, chunk: N past the domain's 128


def _ssd_domain_rows(torch, dev, dtype):
    """ssd_scan at every row of ``SSD_DOMAIN`` from a nonzero h0, y and
    h_last against the plain version within TOL32; and a shape outside the
    kernel's domain, which the wrapper must refuse before any launch."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ops import (
        kernel_takes, run_chunk, ssd_scan, ssd_scan_plain)

    gen = torch.Generator(device=dev).manual_seed(18)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(B, S, H, P, N):
        return (randn(B, S, H, P).to(dtype), F.softplus(randn(B, S, H) - 1.0),
                -torch.exp(randn(H, scale=0.3)), randn(B, S, N, scale=0.3),
                randn(B, S, N, scale=0.3), randn(B, H, P, N, scale=0.1))

    rows = []
    for label, B, S, H, P, N, L in SSD_DOMAIN:
        _require(kernel_takes(P, N, L), f"ssd_scan {label}: outside the "
                 "kernel's domain")
        x, dt, a, bm, cm, h0 = inputs(B, S, H, P, N)
        if label == "x-offset":   # the wrapper copies x to 16-byte alignment
            x = torch.empty(x.numel() + 1, dtype=dtype,
                            device=dev)[1:].view_as(x).copy_(x)
            _require(x.data_ptr() % 16 != 0, "ssd_scan x-offset: x aligned")
        Lr = run_chunk(N, L)
        ran = ssd_scan.chunk_launches.get(Lr, 0)
        got = ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)
        _require(ssd_scan.chunk_launches.get(Lr, 0) == ran + 1,
                 f"ssd_scan {label} {tag}: the passes did not run at chunk "
                 f"{Lr}")
        want = ssd_scan_plain(x, dt, a, bm, cm, chunk=L, h0=h0)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        _require(_close(torch, got, want, TOL32),
                 f"ssd_scan {label} {tag}: max|diff| {err}")
        rows.append(dict(shape=f"{label}.B{B}.S{S}.H{H}.P{P}.N{N}.L{L}.{tag}",
                         instance=f"{tag}.P{P}", run_chunk=Lr,
                         max_abs_err=err))
    P, N, L = SSD_REFUSED
    _require(not kernel_takes(P, N, L), "ssd_scan: the refused shape is in "
             "the domain")
    before = ssd_scan.launches
    try:
        ssd_scan(*inputs(1, 64, 2, P, N)[:5], chunk=L)
        refused = False
    except ValueError:
        refused = True
    torch.cuda.synchronize()
    _require(refused and ssd_scan.launches == before,
             f"ssd_scan P={P} N={N} chunk={L}: not refused before launch")
    return rows


# ssd_scan's backward: label, B, S, H, P, N, chunk, x dtypes, dh_last given.
# mamba2-2.7b's and hymba-1.5b's training shapes (the TRAIN batch, their
# SSM widths), then a ragged S with P 32 at an odd N and chunk, P 16 at N
# 72 with no dh_last, so that every (x dtype, P) instance runs, and N 13,
# whose rows the passes stage in 4-byte pieces and store one by one
SSD_BWD = (
    ("mamba2-2.7b", 8, 1024, 80, 64, 128, 256, ("bf16", "f32"), True),
    ("hymba-1.5b", 8, 1024, 50, 64, 16, 256, ("bf16", "f32"), True),
    ("ragged.P32", 2, 1000, 8, 32, 12, 100, ("bf16", "f32"), True),
    ("P16.N72", 2, 777, 4, 16, 72, 256, ("bf16", "f32"), False),
    ("N13", 1, 200, 3, 64, 13, 64, ("bf16", "f32"), True),
)
# the rows at training shapes, whose times add the profiler's device ms
SSD_BWD_PROFILED = ("mamba2-2.7b", "hymba-1.5b")
# The backward's tolerance: every f32 output (ddt, da, dB, dC, dh0, and
# dx for f32 x) within 1e-4 of its largest |value|; dx for bf16 x, rounded
# once from fp32 sums taken in another order and at another chunk, each
# element within 2^-7 of itself (one bf16 ulp) plus 1e-4 of the largest
SSD_BWD_TOL32 = 1e-4
SSD_BWD_TOL_BF16 = (2.0 ** -7, 1e-4)
# the wrong variants the check must reject
SSD_BWD_WRONG = {"no_h0": "the backward with h0 dropped",
                 "no_dh_last": "the backward with dh_last dropped"}


def _ssd_bwd_err(torch, got, want) -> float:
    """The largest |got - want| over its allowance, over dx, ddt, da, dB,
    dC and dh0 (at most 1 passes)."""
    worst = 0.0
    for g, w in zip(got, want):
        bf16 = g.dtype == torch.bfloat16
        g, w = g.double(), w.double()
        big = float(w.abs().max()) if w.numel() else 0.0
        if bf16:
            allow = SSD_BWD_TOL_BF16[0] * w.abs() + SSD_BWD_TOL_BF16[1] * big
        else:
            allow = torch.full_like(w, SSD_BWD_TOL32 * big)
        if w.numel():
            worst = max(worst, float(((g - w).abs()
                                      / allow.clamp_min(1e-30)).max()))
    return worst


def _ssd_bwd_work(bf16: bool, B, S, NH, P, N, Lb) -> tuple:
    """(ops, peak) of ssd_scan's backward at its chunk ``Lb``, 2 flops a
    multiply-add, each split product counted as its three products on the
    tensor cores.  Per chunk of one head: the state pass's two (P x N)
    sums over the chunk, the gated dy x^T (lower triangle), dxh (a
    triangle and a rank-N product) and the rank-P parts of dC and dB.
    Per chunk of one batch row, since B and C are shared by every head: C
    B^T and the triangles of dC and dB, taken once on the gated tile
    summed over the heads.  Against bf16 x, x^T (w B), dy x^T and x g are
    three bf16 products; the rest (all of them for f32 x) split TF32.  The
    chains: two fp32 multiply-adds per state element and chunk."""
    chunks = B * -(-S // Lb)
    nch = chunks * NH
    tri = Lb * (Lb + 1) / 2
    vs_x = nch * (2 * Lb * P * N + tri * P)   # x^T (w B), x g, dy x^T
    f32 = (nch * (2 * Lb * P * N              # dy^T (e C), dy h_c
                  + tri * P + Lb * N * P)     # dxh
           + chunks * 3 * tri * N)            # C B^T, dC and dB triangles
    return ((6.0 * (f32 + (0 if bf16 else vs_x)), TF32_OPS_PER_S),
            (6.0 * vs_x if bf16 else 0.0, BF16_OPS_PER_S),
            (4.0 * nch * P * N, FP32_OPS_PER_S))


def _ssd_bwd_rows(torch, dev):
    """ssd_scan_bwd (three launches: state, grad, reduce) against
    ssd_scan_bwd_plain at ``SSD_BWD``, from a nonzero h0, on the y of the
    forward kernel and standard-normal dy (and dh_last, 0.1 of it): within
    the tolerance, and rejecting the wrong variants (``SSD_BWD_WRONG``).
    At the training shapes a second call must give the same six outputs
    bit for bit.  Each row times the kernel (host and, at the training
    shapes, profiler device ms in all and per pass), the plain version and
    the bound: the operations by type (``_ssd_bwd_work``) against x, dy,
    y, dt, B, C, h0, dh_last and the outputs moved once; and the
    workspace's bytes."""
    import torch.nn.functional as F

    from repro_torch import _build
    from repro_torch.kernels.ssd_scan.ops import (
        BWD_CHUNK, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = []
    for label, B, S, H, P, N, L, tags, with_dh in SSD_BWD:
        for tag in tags:
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            esz = torch.finfo(dtype).bits // 8
            x = randn(B, S, H, P).to(dtype)
            dt = F.softplus(randn(B, S, H) - 2.0)
            a = -torch.exp(randn(H, scale=0.3))
            bm, cm = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
            h0 = randn(B, H, P, N, scale=0.1)
            dy = randn(B, S, H, P)
            dh = randn(B, H, P, N, scale=0.1) if with_dh else None
            y, _ = ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)
            name = (f"ssd_scan_bwd {label} {tag} B={B} S={S} H={H} P={P} "
                    f"N={N} chunk={L} dh_last={with_dh}")
            before = ssd_scan.backward_launches
            got = ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=L, h0=h0,
                               dh_last=dh, y=y)
            _require(ssd_scan.backward_launches == before + 1,
                     f"{name}: the backward did not launch once")
            want = ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, chunk=L, h0=h0,
                                      dh_last=dh)
            torch.cuda.synchronize()
            _require(got[0].dtype == dtype, f"{name}: dx in {got[0].dtype}")
            err = _ssd_bwd_err(torch, got, want)
            _require(err <= 1.0, f"{name}: max error {err:.3g} of the "
                     "tolerance")
            check = dict(max_abs_err=_max_abs(got, want), tol_ratio=err,
                         max_abs_err_by_output={
                             k: _max_abs([g], [w]) for k, g, w in zip(
                                 ("dx", "ddt", "da", "dB", "dC", "dh0"),
                                 got, want)})
            profiled = label in SSD_BWD_PROFILED
            if profiled:   # no atomics: a second call is bit-identical
                again = ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=L, h0=h0,
                                     dh_last=dh, y=y)
                torch.cuda.synchronize()
                _require(all(torch.equal(u, v) for u, v in zip(got, again)),
                         f"{name}: two calls differ")
                check["deterministic"] = True
                del again
            del got
            wrongs = {"no_h0": ssd_scan_bwd_plain(
                x, dt, a, bm, cm, dy, chunk=L, dh_last=dh)}
            if with_dh:
                wrongs["no_dh_last"] = ssd_scan_bwd_plain(
                    x, dt, a, bm, cm, dy, chunk=L, h0=h0)
            for wname, wrong in wrongs.items():
                werr = _ssd_bwd_err(torch, wrong, want)
                _require(werr > 1.0, f"{name}: the check cannot see "
                         f"{SSD_BWD_WRONG[wname]} ({werr:.3g})")
                check[f"{wname}_ratio"] = werr
            del wrongs, want
            nbytes = (B * S * H * P * (2 * esz + 8) + 2 * B * S * H * 4
                      + H * 8 + 4 * B * S * N * 4
                      + (3 if with_dh else 2) * B * H * P * N * 4)
            bound, by = _bound_ms_by_type(nbytes, _ssd_bwd_work(
                tag == "bf16", B, S, H, P, N, BWD_CHUNK))

            def kern():
                return ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=L, h0=h0,
                                    dh_last=dh, y=y)

            passes = _device_times(torch, kern, 3) if profiled else {}
            rows.append(dict(
                shape=f"{label}.B{B}.S{S}.H{H}.P{P}.N{N}.L{L}.{tag}"
                + ("" if with_dh else ".no_dh_last"),
                instance=f"{tag}.P{P}", run_chunk=BWD_CHUNK, **check,
                workspace_bytes=4 * _build.lib().ssd_scan_bwd_workspace(
                    B, S, H, P, N),
                ms=_cuda_ms(torch, kern, 3),
                device_ms=sum(passes.values()) if passes else None,
                device_ms_by_pass={p: sum(v for k, v in passes.items()
                                          if f"ssd_bwd_{p}_kernel" in k)
                                   for p in SSD_BWD_PASSES}
                if passes else None,
                plain_ms=_cuda_ms(torch, lambda: ssd_scan_bwd_plain(
                    x, dt, a, bm, cm, dy, chunk=L, h0=h0, dh_last=dh), 2),
                library_ms=None, library_device_ms=None,
                bound_ms=bound, bound_by=by))
            del x, dt, a, bm, cm, h0, dy, dh, y
            torch.cuda.empty_cache()
    return rows


# the latent (MLA) kernels at deepseek-v3's widths (H 128, R 512, Dr 64,
# scale 192^-0.5): prefill (label, B, S = T, H) at serve's (B 8, S 2048),
# at serve-mla-check's prefill S 1528 (B 2), a multiple of no tile, and at
# H 3, S 77 (B 1), whose 64-row blocks span positions (a row of 0.11 s in
# bf16 and 0.05 s in f32, its plain and SDPA times included); decode
# (label, B, T, H) over serve's cache (B 8, T 2112, a wrapped ring with
# empty slots and per-row q_pos), serve's warm-up cache (B 1, T 18, one
# split) and at H 3 over a wrapped ring of 777 slots (B 2) whose batch row
# 1 has its first 128 slots empty: in bf16 13 splits of one 64-slot tile,
# the last partial, and two with no visible slot
MLA_HEADS, MLA_RANK, MLA_ROPE = 128, 512, 64
MLA_SCALE = (128 + 64) ** -0.5
MLA_FLASH = (("serve", 8, 2048, MLA_HEADS), ("ragged", 2, 1528, MLA_HEADS),
             ("small-H", 1, 77, 3))
MLA_DECODE = (("serve", 8, 2112, MLA_HEADS), ("warm-up", 1, 18, MLA_HEADS),
              ("small-H", 2, 777, 3))


def _latent_prefill_bound(B, S, H, esz, peak):
    """Causal latent prefill at S = T: 2 (R + Dr + R) flops a visible
    (query row, key) pair, q_lat, q_rope, c_kv and k_rope read once and
    out written once."""
    R, Dr = MLA_RANK, MLA_ROPE
    ops = 2.0 * B * H * (S * (S + 1) / 2) * (2 * R + Dr)
    nbytes = (B * S * H * (2 * R + Dr) + B * S * (R + Dr)) * esz
    return _bound_ms(nbytes, ops, peak)


def _latent_decode_bound(B, T, H, nvis, esz, peak):
    """Latent decode over ``nvis`` visible slots (all batch rows): their
    latent rows, the slot and query positions and q read once, out
    written once."""
    R, Dr = MLA_RANK, MLA_ROPE
    ops = 2.0 * H * nvis * (2 * R + Dr)
    nbytes = (nvis * (R + Dr) * esz + B * T * 4 + B * 4
              + B * H * (2 * R + Dr) * esz)
    return _bound_ms(nbytes, ops, peak)


def _sdpa_library(torch, call, iters):
    """Time one SDPA call on the first backend that takes it (flash,
    memory-efficient, cuDNN, math), keeping why each backend before it
    refused (its warnings' reasons, else its error)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    refused = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return call()

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                why = []
                for w in caught:
                    line = str(w.message).splitlines()[0]
                    if "not used because" not in line and line not in why:
                        why.append(line[:160])
                refused[name.lower()] = " | ".join(why or [str(e)[:160]])
                continue
        return dict(library_ms=_cuda_ms(torch, fn, iters),
                    library_device_ms=_device_ms(torch, fn, iters),
                    library_backend=name.lower(), library_refused=refused)
    return dict(library_ms=None, library_device_ms=None,
                library_backend=None, library_refused=refused)


def _latent_rows(torch, dev, dtype, peak):
    """flash_attention_latent and decode_attention_latent at ``MLA_FLASH``
    and ``MLA_DECODE``: each checked against its plain version (by
    ``_attention_check``'s rules) and timed beside its plain version and
    one SDPA call with the shared key head (``enable_gqa``) and the
    caller's scale."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        LATENT_TILE_KEYS, decode_attention_latent,
        decode_attention_latent_plain, latent_decode_instance,
        latent_split_plan)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_latent, flash_attention_latent_plain,
        latent_instance)

    gen = torch.Generator(device=dev).manual_seed(31)
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    R, Dr, scale = MLA_RANK, MLA_ROPE, MLA_SCALE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(label, fn, plain, args):
        got = fn(*args, scale=scale)
        want = plain(*args, scale=scale)
        plain32 = (plain(*(a.float() if a.is_floating_point() else a
                           for a in args), scale=scale)
                   if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        return _attention_check(torch, label, dtype, got, want, plain32,
                                None)

    flash, decode = [], []
    for label, B, S, Hq in MLA_FLASH:
        t_row = time.perf_counter()
        args = (randn(B, S, Hq, R), randn(B, S, Hq, Dr), randn(B, S, R),
                randn(B, S, Dr))
        before = dict(flash_attention_latent.instance_launches)
        fields = check(f"flash_attention_latent {label} {tag} B={B} S={S} "
                       f"H={Hq}", flash_attention_latent,
                       flash_attention_latent_plain, args)
        inst = latent_instance(dtype)
        _require(flash_attention_latent.instance_launches[inst]
                 == before[inst] + 1,
                 f"flash_attention_latent {label} {tag}: not launched on "
                 f"its {inst} instance")
        bound, by = _latent_prefill_bound(B, S, Hq, esz, peak)
        qT = torch.cat(args[:2], -1).transpose(1, 2).contiguous()
        kT = torch.cat(args[2:], -1)[:, None]
        vT = args[2][:, None]

        def kern():
            return flash_attention_latent(*args, scale=scale)

        def sdpa():
            return F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=True, scale=scale, enable_gqa=True)

        flash.append(dict(
            shape=f"{label}.B{B}.S{S}.H{Hq}.R{R}.Dr{Dr}.{tag}",
            kernel_instance=f"{tag}.prefill.{inst}", **fields,
            ms=_cuda_ms(torch, kern, 3), device_ms=_device_ms(torch, kern, 3),
            plain_ms=_cuda_ms(torch, lambda: flash_attention_latent_plain(
                *args, scale=scale), 1),
            **_sdpa_library(torch, sdpa, 3), bound_ms=bound, bound_by=by,
            row_s=time.perf_counter() - t_row))
        del args, qT, kT, vT
    inst = latent_decode_instance(dtype)
    for label, B, T, Hq in MLA_DECODE:
        slot = torch.arange(T, device=dev, dtype=torch.int32)
        if label == "warm-up":
            # serve's warm-up (prompt 16): slots 0..16 filled, q at 16
            kv_pos = torch.where(slot <= 16, slot, -1)[None].expand(
                B, T).contiguous()
            q_pos = torch.full((B,), 16, dtype=torch.int32, device=dev)
        else:
            roll = torch.randint(0, T, (B,), generator=gen, device=dev,
                                 dtype=torch.int32)
            kv_pos = ((slot[None] - roll[:, None]) % T).to(torch.int32)
            kv_pos[1, :30 if label == "serve" else 128] = -1
            q_pos = torch.randint(T - 64, T, (B,), generator=gen,
                                  device=dev, dtype=torch.int32)
        args = (randn(B, Hq, R), randn(B, Hq, Dr), randn(B, T, R),
                randn(B, T, Dr), kv_pos, q_pos)
        before = dict(decode_attention_latent.instance_launches)
        fields = check(f"decode_attention_latent {label} {tag} B={B} T={T} "
                       f"H={Hq}", decode_attention_latent,
                       decode_attention_latent_plain, args)
        _require(decode_attention_latent.instance_launches[inst]
                 == before[inst] + 1,
                 f"decode_attention_latent {label} {tag}: not launched on "
                 f"its {inst} instance")
        vis = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        bound, by = _latent_decode_bound(B, T, Hq, float(vis.sum()), esz,
                                         peak)
        ns, per = latent_split_plan(
            B, Hq, T, torch.cuda.get_device_properties(
                dev).multi_processor_count, LATENT_TILE_KEYS[dtype])
        qT = torch.cat(args[:2], -1)[:, :, None]
        kT = torch.cat(args[2:4], -1)[:, None]
        vT = args[2][:, None]
        mask = vis[:, None, None, :]

        def kern():
            return decode_attention_latent(*args, scale=scale)

        def sdpa():
            return F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=mask, scale=scale, enable_gqa=True)

        decode.append(dict(
            shape=f"{label}.B{B}.T{T}.H{Hq}.R{R}.Dr{Dr}.{tag}",
            kernel_instance=f"{tag}.decode.{inst}", splits=ns,
            split_slots=per,
            **fields, ms=_cuda_ms(torch, kern, 50),
            device_ms=_device_ms(torch, kern, 50),
            plain_ms=_cuda_ms(torch, lambda: decode_attention_latent_plain(
                *args, scale=scale), 10),
            **_sdpa_library(torch, sdpa, 50), bound_ms=bound, bound_by=by))
    return flash, decode


# flash_attention_bwd on the card: (label, B, S, T, H, K, D, causal, window,
# dtypes).  olmo-1b's training shape (the train phase's attention), glm4-9b's
# heads (G 16), D 64 and D 80 under a window of 1024, S = T 1000 (a
# multiple of neither the 64-row blocks nor the 32-row tiles), non-causal S
# 760 over T 1000, the --reduced olmo-1b that train-check's CLI run trains
# (D 32, G 4, f32), and bf16 at D 32 under a window of 40: every (dtype,
# D) instance of the build runs in some row
FLASH_BWD = (
    ("olmo-1b", 8, 1024, 1024, 16, 16, 128, True, None, ("bf16", "f32")),
    ("glm4-9b", 2, 1024, 1024, 32, 2, 128, True, None, ("bf16",)),
    ("D64.window", 2, 2048, 2048, 8, 2, 64, True, 1024, ("bf16",)),
    ("D80.window", 2, 2048, 2048, 8, 2, 80, True, 1024, ("bf16", "f32")),
    ("ragged", 2, 1000, 1000, 8, 2, 128, True, None, ("bf16", "f32")),
    ("noncausal", 2, 760, 1000, 16, 16, 64, False, None, ("bf16", "f32")),
    ("reduced", 8, 64, 64, 4, 1, 32, True, None, ("f32",)),
    ("D32", 2, 777, 777, 4, 4, 32, True, 40, ("bf16",)),
)
# The backward's tolerance: f32 within 2e-4 of each tensor's largest
# |value|; bf16, whose dq / dk / dv are rounded once from fp32 sums taken
# in another order than the plain version's, each element within 2^-6 of
# itself plus 2^-8 of the tensor's largest |value|
BWD_TOL32 = 2e-4
BWD_TOL_BF16 = (2.0 ** -6, 2.0 ** -8)
# the rows at training shapes, whose times add the profiler's device ms
# (the edge rows time by CUDA events only)
FLASH_BWD_PROFILED = ("olmo-1b", "glm4-9b", "D64.window", "D80.window")
# the wrong variants the check must reject
BWD_WRONG = {"no_causal": "the backward without the causal mask",
             "causal": "a causal mask where none belongs",
             "first_head": "dk / dv of the first query head of each group "
                           "only"}


def _bwd_err(torch, got, want, dtype) -> float:
    """The largest |got - want| over its allowance, over dq, dk and dv
    (at most 1 passes)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        big = float(w.abs().max())
        if dtype == torch.bfloat16:
            allow = BWD_TOL_BF16[0] * w.abs() + BWD_TOL_BF16[1] * big
        else:
            allow = torch.full_like(w, BWD_TOL32 * big)
        worst = max(worst, float(((g - w).abs()
                                  / allow.clamp_min(1e-30)).max()))
    return worst


def _flash_bwd_rows(torch, dev):
    """flash_attention_bwd (three launches: delta, dk / dv, dq) against
    flash_attention_bwd_plain at ``FLASH_BWD``, on the output and lse of
    the kernel forward (``flash_attention_lse``; its lse must pass
    ``_lse_check``) and a standard-normal output gradient: within the
    tolerance, and rejecting the wrong variants (``BWD_WRONG``; the first
    head's dk / dv only where G > 1); each call must run its dtype and
    head dim's instance (``BWD_DISPATCH``).  Each row times the kernel
    (host and profiler device ms per call), the plain version and SDPA's
    backward (autograd through ``scaled_dot_product_attention`` at the
    same inputs, ``is_causal`` where that is the mask, else the mask),
    beside the bound: five products of 2 D flops per visible (query, key)
    pair and head, at the dtype's peak, against q, k, v, o, do, dq, dk and
    dv moved once; the rows of ``FLASH_BWD_PROFILED`` also by profiler
    device time, in all and per pass (delta, kv, q)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_lse, flash_attention_lse_plain)

    gen = torch.Generator(device=dev).manual_seed(34)
    rows = []
    for label, B, S, T, H, K, D, causal, window, tags in FLASH_BWD:
        G = H // K
        for tag in tags:
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            peak = BF16_OPS_PER_S if tag == "bf16" else FP32_OPS_PER_S
            esz = torch.finfo(dtype).bits // 8

            def randn(*shape):
                return torch.randn(shape, generator=gen,
                                   device=dev).to(dtype)

            q, k, v, do = (randn(B, S, H, D), randn(B, T, K, D),
                           randn(B, T, K, D), randn(B, S, H, D))
            kw = dict(causal=causal, window=window)
            o, lse = flash_attention_lse(q, k, v, **kw)
            name = (f"flash_attention_bwd {label} {tag} B={B} S={S} T={T} "
                    f"H={H} K={K} D={D} causal={causal} window={window}")
            lse_check = _lse_check(
                torch, name, lse, flash_attention_lse_plain(q, k, v, **kw)[1],
                flash_attention_lse_plain(q, k, v, causal=not causal,
                                          window=window)[1])
            inst = BWD_DISPATCH[tag, D]
            before = dict(flash_attention.backward_instance_launches)
            got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
            ran = {i: n - before[i] for i, n in
                   flash_attention.backward_instance_launches.items()}
            _require(ran == {"wgmma": 0, "fma": 0} | {inst: 1},
                     f"{name}: backward instances {ran}, want one {inst}")
            want = flash_attention_bwd_plain(q, k, v, o, do, **kw)
            torch.cuda.synchronize()
            err = _bwd_err(torch, got, want, dtype)
            _require(err <= 1.0, f"{name}: max error {err:.3g} of the "
                     "tolerance")
            check = dict(max_abs_err=_max_abs(got, want), tol_ratio=err,
                         **lse_check)
            del got
            wrongs = {("no_causal" if causal else "causal"):
                      flash_attention_bwd_plain(q, k, v, o, do,
                                                causal=not causal,
                                                window=window)}
            if G > 1:
                first = flash_attention_bwd_plain(
                    q[:, :, ::G].contiguous(), k, v,
                    o[:, :, ::G].contiguous(), do[:, :, ::G].contiguous(),
                    **kw)
                wrongs["first_head"] = (want[0],) + tuple(first[1:])
            for wname, wrong in wrongs.items():
                werr = _bwd_err(torch, wrong, want, dtype)
                _require(werr > 1.0, f"{name}: the check cannot see "
                         f"{BWD_WRONG[wname]} ({werr:.3g})")
                check[f"{wname}_ratio"] = werr
            del wrongs, want
            mask, pairs = _flash_pairs(torch, dev, S, T, causal, window)
            nbytes = (4 * B * S * H * D + 4 * B * T * K * D) * esz
            bound, by = _bound_ms(nbytes, 10.0 * D * pairs * B * H, peak)

            def kern():
                return flash_attention_bwd(q, k, v, o, do, lse, **kw)

            qT, kT, vT = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            doT = do.transpose(1, 2).contiguous()
            sdpa_kw = ({"is_causal": True} if causal and window is None
                       and S == T else {"attn_mask": mask})
            outT = F.scaled_dot_product_attention(qT, kT, vT,
                                                  enable_gqa=True, **sdpa_kw)

            def sdpa_bwd():
                return torch.autograd.grad(outT, (qT, kT, vT), doT,
                                           retain_graph=True)

            profiled = label in FLASH_BWD_PROFILED
            passes = _device_times(torch, kern, 3) if profiled else {}
            pass_ms = {p: sum(v for k, v in passes.items()
                              if f"flash_bwd_{p}_" in k)
                       for p in ("delta", "kv", "q")}
            rows.append(dict(
                shape=f"{label}.B{B}.S{S}" + (f".T{T}" if T != S else "")
                + f".H{H}.K{K}.D{D}.{tag}.w{window}"
                + ("" if causal else ".noncausal"),
                kernel_instance=f"{tag}.D{D}", instance=inst, **check,
                ms=_cuda_ms(torch, kern, 3),
                device_ms=sum(passes.values()) if passes else None,
                device_ms_by_pass=pass_ms if passes else None,
                plain_ms=_cuda_ms(torch, lambda: flash_attention_bwd_plain(
                    q, k, v, o, do, **kw), 2),
                library_ms=_cuda_ms(torch, sdpa_bwd, 3),
                library_device_ms=(_device_ms(torch, sdpa_bwd, 3)
                                   if profiled else None),
                bound_ms=bound, bound_by=by))
            del q, k, v, o, lse, do, qT, kT, vT, doT, outT, mask
            torch.cuda.empty_cache()
    return rows


# flash_attention_latent's backward on the card: (label, B, S = T, H,
# dtypes) at deepseek-v3's widths (R 512, Dr 64, scale 192^-0.5): its
# training shape (train-mla's B 4, TRAIN's S 1024, H 128), TRAIN's B 8 in
# bf16, a ragged S 1528 (B 2, a multiple of no tile) and H 3 at S 77 (B 1:
# 32-row blocks that span positions, so the mask is per row)
MLA_BWD = (
    ("train", 4, 1024, MLA_HEADS, ("bf16", "f32")),
    ("B8", 8, 1024, MLA_HEADS, ("bf16",)),
    ("ragged", 2, 1528, MLA_HEADS, ("bf16", "f32")),
    ("small-H", 1, 77, 3, ("bf16", "f32")),
)
# the rows at the training shapes: two calls must give the same bits, and
# their times add the profiler's device ms, in all and per pass
MLA_BWD_PROFILED = ("train", "B8")
# The tolerance: f32 within 1e-4 of each gradient's largest |value| (fp32
# sums in another order than the plain version's); bf16, each gradient
# rounded once from such sums, by flash's backward rule (``BWD_TOL_BF16``)
MLA_BWD_TOL32 = 1e-4
# the wrong variants the check must reject
MLA_BWD_WRONG = {"no_value_part": "dc_kv without its value part p^T dO",
                 "no_causal": "the backward without the causal mask"}


def _latent_bwd_err(torch, got, want) -> float:
    """The largest |got - want| over its allowance, over dq_lat, dq_rope,
    dc_kv and dk_rope (at most 1 passes)."""
    worst = 0.0
    for g, w in zip(got, want):
        bf16 = g.dtype == torch.bfloat16
        g, w = g.double(), w.double()
        big = float(w.abs().max()) if w.numel() else 0.0
        if bf16:
            allow = BWD_TOL_BF16[0] * w.abs() + BWD_TOL_BF16[1] * big
        else:
            allow = torch.full_like(w, MLA_BWD_TOL32 * big)
        if w.numel():
            worst = max(worst, float(((g - w).abs()
                                      / allow.clamp_min(1e-30)).max()))
    return worst


def _latent_bwd_bound(B, S, H, esz, peak):
    """Causal latent backward at S = T: five products of 2 (576, 512, 512,
    576, 576) flops a visible (row, key) pair at the dtype's peak; q_lat,
    q_rope, c_kv, k_rope, o, dO and lse read once, the four gradients
    written once."""
    R, Dr = MLA_RANK, MLA_ROPE
    ops = 2.0 * (3 * (R + Dr) + 2 * R) * B * H * (S * (S + 1) / 2)
    nbytes = (esz * (B * S * H * (3 * R + Dr) + B * S * (R + Dr))
              + 4 * B * S * H
              + esz * (B * S * H * (R + Dr) + B * S * (R + Dr)))
    return _bound_ms(nbytes, ops, peak)


def _latent_bwd_rows(torch, dev, labels=None):
    """flash_attention_latent_bwd (four launches: delta, the query side,
    the key side's partial sums, their sum) against
    flash_attention_latent_bwd_plain at ``MLA_BWD`` (the rows of
    ``labels`` only, when given), on the output and lse
    of the kernel forward (``flash_attention_latent_lse``; its lse against
    the plain version's within ``LSE_TOL``, rejecting the lse of no causal
    mask) and a standard-normal output gradient: within
    ``_latent_bwd_err``'s tolerance, rejecting the wrong variants
    (``MLA_BWD_WRONG``), each call on its dtype's instance; at the
    training shapes two calls bit for bit; the gradient through
    ``flash_attention_latent`` under autograd equals the direct call's.
    Each row times the kernel
    (host ms and, at the training shapes, the profiler's device ms in all
    and per pass), the plain version and SDPA's backward (autograd through
    ``scaled_dot_product_attention``, causal, the one latent key head
    shared by the H query heads, key 576 / value 512, on the backend its
    dispatch picks: ``library_backend`` is the graph's backward node)
    beside the bound (``_latent_bwd_bound``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    fal = ops.flash_attention_latent
    gen = torch.Generator(device=dev).manual_seed(39)
    rows = []
    for label, B, S, H, tags in MLA_BWD:
        if labels is not None and label not in labels:
            continue
        for tag in tags:
            t_row = time.perf_counter()
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            peak = BF16_OPS_PER_S if tag == "bf16" else FP32_OPS_PER_S
            esz = torch.finfo(dtype).bits // 8

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)

            x = (randn(B, S, H, MLA_RANK), randn(B, S, H, MLA_ROPE),
                 randn(B, S, MLA_RANK), randn(B, S, MLA_ROPE))
            do = randn(B, S, H, MLA_RANK)
            kw = dict(scale=MLA_SCALE)
            name = f"flash_attention_latent_bwd {label} {tag} B={B} S={S} H={H}"
            o, lse = ops.flash_attention_latent_lse(*x, **kw)
            no_causal = torch.stack([torch.logsumexp(ops._latent_scores(
                *x[:2], x[2][i].float(), x[3][i].float(), i, MLA_SCALE,
                causal=False), dim=-1) for i in range(B)])
            lse_check = _lse_check(
                torch, name, lse,
                ops.flash_attention_latent_lse_plain(*x, **kw)[1], no_causal)
            del no_causal
            inst = ops.latent_bwd_instance(dtype)
            before = dict(fal.backward_instance_launches)
            got = ops.flash_attention_latent_bwd(*x, o, do, lse, **kw)
            ran = {i: n - before[i]
                   for i, n in fal.backward_instance_launches.items()}
            _require(ran == {"wgmma": 0, "fma": 0} | {inst: 1},
                     f"{name}: backward instances {ran}, want one {inst}")
            want = ops.flash_attention_latent_bwd_plain(*x, o, do, **kw)
            torch.cuda.synchronize()
            _require(all(g.dtype == dtype for g in got),
                     f"{name}: gradients in {[g.dtype for g in got]}")
            err = _latent_bwd_err(torch, got, want)
            _require(err <= 1.0, f"{name}: max error {err:.3g} of the "
                     "tolerance")
            check = dict(max_abs_err=_max_abs(got, want), tol_ratio=err,
                         max_abs_err_by_output={
                             k: _max_abs([g], [w]) for k, g, w in zip(
                                 ("dq_lat", "dq_rope", "dc_kv", "dk_rope"),
                                 got, want)}, **lse_check)
            profiled = label in MLA_BWD_PROFILED
            if profiled:   # no atomics: a second call is bit-identical
                again = ops.flash_attention_latent_bwd(*x, o, do, lse, **kw)
                torch.cuda.synchronize()
                _require(all(torch.equal(u, v) for u, v in zip(got, again)),
                         f"{name}: two calls differ")
                check["deterministic"] = True
                del again
            # the autograd route: the Function's backward is the same call
            leaves = [t.detach().requires_grad_(True) for t in x]
            auto = torch.autograd.grad(fal(*leaves, **kw), leaves, do)
            _require(all(torch.equal(u, v) for u, v in zip(auto, got)),
                     f"{name}: the gradient under autograd differs from "
                     "the direct call's")
            check["autograd_equal"] = True
            del got, leaves, auto
            for wname, wkw in (("no_value_part", dict(value_part=False)),
                               ("no_causal", dict(causal=False))):
                wrong = ops._latent_bwd(*x, o, do, MLA_SCALE, **wkw)
                werr = _latent_bwd_err(torch, wrong, want)
                _require(werr > 1.0, f"{name}: the check cannot see "
                         f"{MLA_BWD_WRONG[wname]} ({werr:.3g})")
                check[f"{wname}_ratio"] = werr
                del wrong
            del want
            bound, by = _latent_bwd_bound(B, S, H, esz, peak)

            def kern():
                return ops.flash_attention_latent_bwd(*x, o, do, lse, **kw)

            passes = _device_times(torch, kern, 2) if profiled else {}
            timed = dict(
                ms=_cuda_ms(torch, kern, 2),
                device_ms=sum(passes.values()) if passes else None,
                device_ms_by_pass={p: sum(v for k, v in passes.items()
                                          if f"mla_bwd_{p}_kernel" in k)
                                   for p in MLA_BWD_PASSES[inst]}
                if passes else None,
                plain_ms=_cuda_ms(torch, lambda: (
                    ops.flash_attention_latent_bwd_plain(*x, o, do, **kw)),
                    1))
            qT = torch.cat(x[:2], -1).transpose(1, 2).contiguous() \
                .requires_grad_(True)
            kT = torch.cat(x[2:], -1)[:, None].requires_grad_(True)
            vT = x[2][:, None].contiguous().requires_grad_(True)
            doT = do.transpose(1, 2).contiguous()
            outT = F.scaled_dot_product_attention(
                qT, kT.expand(B, H, S, MLA_RANK + MLA_ROPE),
                vT.expand(B, H, S, MLA_RANK), is_causal=True,
                scale=MLA_SCALE)

            def sdpa_bwd():
                return torch.autograd.grad(outT, (qT, kT, vT), doT,
                                           retain_graph=True)

            rows.append(dict(
                shape=f"{label}.B{B}.S{S}.H{H}.R{MLA_RANK}.Dr{MLA_ROPE}.{tag}",
                instance=inst, **check, **timed,
                library_ms=_cuda_ms(torch, sdpa_bwd, 2),
                library_device_ms=_device_ms(torch, sdpa_bwd, 2),
                library_backend=type(outT.grad_fn).__name__,
                bound_ms=bound, bound_by=by,
                row_s=time.perf_counter() - t_row))
            del x, o, lse, do, qT, kT, vT, doT, outT
            torch.cuda.empty_cache()
    return rows


def phase_model_kernels(np, torch, dev):
    """flash_attention, decode_attention, ssd_scan and the latent (MLA)
    kernels against their plain versions at the serving paths' shapes, in
    bf16 and f32, with kernel,
    plain and library times and the bound of the work."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, K, D = SERVE["batch"], 25, 5, 64
    S = SERVE["prefill_len"]
    Tc = S + SERVE["decode_len"]
    rows = {"flash_attention": [], "decode_attention": [], "ssd_scan": [],
            "flash_attention_latent": [], "decode_attention_latent": []}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    gen_ragged = torch.Generator(device=dev).manual_seed(13)

    def randn_ragged(*shape):
        return torch.randn(shape, generator=gen_ragged, device=dev)

    for dtype, peak in ((torch.bfloat16, BF16_OPS_PER_S),
                        (torch.float32, FP32_OPS_PER_S)):
        esz = torch.finfo(dtype).bits // 8
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        # flash_attention: prefill, causal, global and window-1024 layers;
        # in bf16 also serve-check's prefill length, a multiple of neither
        # the 64-key tile nor the 128-row block
        shapes = ((B, S, randn), (2, 1528, randn_ragged))
        for fb, fs, rnd in shapes if tag == "bf16" else shapes[:1]:
            rows["flash_attention"] += _flash_rows(
                torch, rnd, dev, dtype, peak, fb, fs, H, K, D)
        # the dense configs' prefill at D 128 and 80 (bf16 on the
        # tensor-core instance; f32, glm4's and danube's, on the CUDA-core
        # one), serve-dense-check's prefill length S = T 1528 at D 128, in
        # bf16 the tensor-core instance's edges (``DENSE_FLASH_EDGES``),
        # and D 32 (so that every instance the build makes runs in some
        # row)
        for label, dh, dk, dd, windows in DENSE_FLASH:
            if tag == "bf16" or label in ("glm4-9b", "h2o-danube-1.8b"):
                rows["flash_attention"] += _flash_rows(
                    torch, randn, dev, dtype, peak, B, S, dh, dk, dd,
                    windows=windows, label=label + ".")
        rows["flash_attention"] += _flash_rows(
            torch, randn_ragged, dev, dtype, peak, 2, 1528, 32, 2, 128,
            windows=(None,), label="ragged.")
        for label, eb, es, dh, dk, dd, windows in (
                DENSE_FLASH_EDGES if tag == "bf16" else ()):
            rows["flash_attention"] += _flash_rows(
                torch, randn_ragged, dev, dtype, peak, eb, es, dh, dk, dd,
                windows=windows, label=label + ".")
        rows["flash_attention"] += _flash_rows(
            torch, randn_ragged, dev, dtype, peak, 2, 777, 4, 4, 32,
            windows=(None, 40), label="D32.")
        # the MoE config's prefill, bf16 on the tensor-core instance
        for label, dh, dk, dd, windows in MOE_FLASH if tag == "bf16" else ():
            rows["flash_attention"] += _flash_rows(
                torch, randn, dev, dtype, peak, B, S, dh, dk, dd,
                windows=windows, label=label + ".")
        # the encoder-decoder's non-causal encoder and cross-attention (S
        # != T) and the VLM's prefill
        for (label, fb, fs, ft, dh, dk, dd, causal,
             f32) in FRONTEND_FLASH:
            if tag == "bf16" or f32:
                rows["flash_attention"] += _flash_rows(
                    torch, randn_ragged, dev, dtype, peak, fb, fs, dh, dk,
                    dd, windows=(None,), label=label + ".", T=ft,
                    causal=causal)

        # decode_attention: one step in the middle of decode (2080 of the
        # 2112 slots filled), global and window-1024 layers
        fill = S + SERVE["decode_len"] // 2
        q = randn(B, H, D).to(dtype)
        k, v = randn(B, Tc, K, D).to(dtype), randn(B, Tc, K, D).to(dtype)
        slot = torch.arange(Tc, device=dev, dtype=torch.int32)
        kv_pos = torch.where(slot < fill, slot, -1)[None].expand(B, Tc)
        kv_pos = kv_pos.contiguous()
        q_pos = torch.full((B,), fill - 1, dtype=torch.int32, device=dev)
        qT, kT, vT = (q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous())
        wants = {}
        for window in (None, 1024):
            got = decode_attention(q, k, v, kv_pos, q_pos, window=window)
            wants[window] = want = decode_attention_plain(
                q, k, v, kv_pos, q_pos, window=window)
            plain32 = (decode_attention_plain(q.float(), k.float(),
                                              v.float(), kv_pos, q_pos,
                                              window=window)
                       if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            check = _attention_check(
                torch, f"decode_attention {tag} window={window}", dtype, got,
                want, plain32, wants[None] if window else None)
            vis = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            if window is not None:
                vis &= kv_pos > q_pos[:, None] - window
            nvis = float(vis.sum())
            nbytes = (nvis * K * D * 2 * esz + B * Tc * 4 + B * 4
                      + 2 * B * H * D * esz)
            bound, by = _bound_ms(nbytes, 4.0 * D * (H // K) * K * nvis, peak)
            mask = vis[:, None, None, :]

            def kern():
                return decode_attention(q, k, v, kv_pos, q_pos, window=window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask, enable_gqa=True)

            rows["decode_attention"].append(dict(
                shape=f"B{B}.T{Tc}.fill{fill}.H{H}.K{K}.D{D}.{tag}.w{window}",
                kernel_instance=f"{tag}.G{H // K}", **check,
                ms=_cuda_ms(torch, kern, 50),
                device_ms=_device_ms(torch, kern, 50),
                plain_ms=_cuda_ms(torch, lambda: decode_attention_plain(
                    q, k, v, kv_pos, q_pos, window=window), 10),
                library_ms=_cuda_ms(torch, sdpa, 50),
                library_device_ms=_device_ms(torch, sdpa, 50),
                bound_ms=bound, bound_by=by))
        del q, k, v, qT, kT, vT, wants, want
        rows["decode_attention"] += _decode_domain_rows(torch, dev, dtype)
        rows["decode_attention"] += _decode_dense_rows(torch, dev, dtype,
                                                       peak)
        if tag == "bf16":
            rows["decode_attention"] += _decode_dense_rows(
                torch, dev, dtype, peak, MOE_DECODE, ())
            rows["decode_attention"] += _decode_dense_rows(
                torch, dev, dtype, peak, VLM_DECODE, ())
        # the encoder-decoder's cross-attention decode
        rows["decode_attention"] += _cross_decode_rows(torch, dev, dtype,
                                                       peak)
        # the latent (MLA) kernels at deepseek-v3's prefill and decode
        flash, decode = _latent_rows(torch, dev, dtype, peak)
        rows["flash_attention_latent"] += flash
        rows["decode_attention_latent"] += decode

        # ssd_scan: prefill of the SSM branch from a nonzero state, then
        # the domain rows
        for label, nh, n in SSD_SERVING:
            rows["ssd_scan"].append(_ssd_serving_row(torch, randn, dtype,
                                                     label, nh, n))
        rows["ssd_scan"] += _ssd_domain_rows(torch, dev, dtype)
    # flash_attention's backward, olmo-1b's training shape in bf16 first
    rows["flash_attention_bwd"] = _flash_bwd_rows(torch, dev)
    # ssd_scan's backward, mamba2-2.7b's training shape in bf16 first
    rows["ssd_scan_bwd"] = _ssd_bwd_rows(torch, dev)
    # the latent backward, deepseek-v3's training shape in bf16 first
    rows["flash_attention_latent_bwd"] = _latent_bwd_rows(torch, dev)

    out = {}
    for name, shapes in rows.items():
        # the row of the line: bf16, the global (window-free) layer first
        out[name] = dict(shapes[0], shapes=shapes)
        for row in shapes:
            print(f"  {name} {json.dumps(row)}")
    print("kernels (model): " + "; ".join(
        f"{n}{'[' + r['instance'] + ']' if 'instance' in r else ''} "
        f"max|diff|={r['max_abs_err']:g} ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f}"
        + ("" if "device_ms" not in r else
           f" device_ms={_fmt_ms(r['device_ms'])} library_ms="
           f"{_fmt_ms(r['library_ms'])} library_device_ms="
           f"{_fmt_ms(r['library_device_ms'])}")
        for n, r in out.items()), flush=True)
    return out


def _load_timed(torch, arch, dev, **overrides):
    """(cfg, params, init seconds, parameter count) of ``arch`` at
    published widths, bf16, random weights from seed 0."""
    from repro_torch.launch.serve import load_model

    t0 = time.perf_counter()
    cfg, params = load_model(arch, device=dev, seed=0, **overrides)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return cfg, params, init_s, sum(t.numel() for t in _leaves(params))


def _measured_serve(torch, kernels, label, cfg, params, requests,
                    decode_len):
    """``repro_torch.launch.serve`` in batches of 8 with prompt 2048, after
    a warm-up (cuBLAS handles, allocator; a prompt of at least the
    frontend's length) outside the measured run: the
    result with each kernel's launches, the peak memory, prefill tokens/s
    and decode ms/step.  The last batch's logits must be finite, (8,
    vocab)."""
    from repro_torch.launch.serve import serve

    # a VLM's prompt holds its patches
    serve(cfg, params, requests=1, batch=1,
          prefill_len=max(16, cfg.frontend_len), decode_len=2)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    res = serve(cfg, params, requests=requests, batch=SERVE["batch"],
                prefill_len=SERVE["prefill_len"], decode_len=decode_len)
    res["launches"] = _counts(kernels)
    for name in ("flash_attention", "flash_attention_latent"):
        _require(kernels[name].lse_launches == 0,
                 f"{label}: a serving {name} launch stored lse")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["prefill_tok_per_s"] = res["prefill_tokens"] / res["prefill_s"]
    res["decode_ms_per_step"] = (res["decode_s"] * 1e3
                                 / (res["batches"] * decode_len))
    _require(bool(torch.isfinite(res["logits"]).all()),
             f"{label}: non-finite logits")
    _require(res["logits"].shape == (SERVE["batch"], cfg.vocab_size),
             f"{label}: logits shape")
    return res


def _serve_line(res) -> str:
    return (f"prefill_len={res['prefill_len']} "
            f"decode_len={res['decode_len']} prefill_s={res['prefill_s']:.3f} "
            f"prefill_tok_per_s={res['prefill_tok_per_s']:.1f} "
            f"decode_s={res['decode_s']:.3f} "
            f"decode_ms_per_step={res['decode_ms_per_step']:.3f} "
            f"peak_mem_gb={res['peak_gb']:.3f}")


def _require_launches(label, launches, want):
    for name, n in want.items():
        _require(launches[name] == n,
                 f"{label}: {name} launched {launches[name]} times, want {n}")


def phase_serve(torch, kernels, dev):
    """The full-width, full-depth hymba-1.5b serving run through
    ``repro_torch.launch.serve``: 16 requests in batches of 8, prompt 2048,
    64 greedy decode steps, bf16, random weights from seed 0."""
    cfg, params, init_s, nparams = _load_timed(torch, "hymba-1.5b", dev)
    res = _measured_serve(torch, kernels, "serve", cfg, params,
                          SERVE["requests"], SERVE["decode_len"])
    launches = res["launches"]
    flash_instances = dict(kernels["flash_attention"].instance_launches)
    chunks = dict(kernels["ssd_scan"].chunk_launches)
    L, nb = cfg.num_layers, res["batches"]
    want = {"flash_attention": L * nb,
            "decode_attention": L * SERVE["decode_len"] * nb,
            "ssd_scan": L * nb}
    _require_launches("serve", launches, want)
    _require(flash_instances == {"wgmma": L * nb, "fma": 0},
             f"serve: flash_attention instances {flash_instances}, want "
             f"every launch on the tensor-core (wgmma) instance")
    _require(chunks == {cfg.ssm.chunk_size: L * nb},
             f"serve: ssd_scan launches by chunk run {chunks}, want every "
             f"launch at chunk {cfg.ssm.chunk_size}")
    print(f"serve: hymba-1.5b layers={L} d_model={cfg.d_model} "
          f"params={nparams} bf16 init_s={init_s:.2f} "
          f"requests={SERVE['requests']} batch={SERVE['batch']} "
          f"{_serve_line(res)} "
          f"launches={ {n: launches[n] for n in want} } "
          f"flash_attention_instances={flash_instances} "
          f"ssd_scan_chunk_launches={chunks}", flush=True)
    return dict(launches=launches, flash_instances=flash_instances,
                chunk_launches=chunks)


def phase_serve_profile(np, torch, dev, arch="hymba-1.5b", layers=None):
    """One serving batch of ``arch`` (full width, and full depth unless
    ``layers`` cuts it) once more under
    torch.profiler: the prefill, then 8 decode steps, each with its device
    busy time, idle share and device time by kernel group.  Numbers are
    under the profiler (its per-op cost inflates the host-bound decode's
    wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import load_model
    from repro_torch.models import decode_step, prefill

    cfg, params = load_model(arch, device=dev, seed=0,
                             **({"num_layers": layers} if layers else {}))
    B, S, n_dec = SERVE["batch"], SERVE["prefill_len"], 8
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).to(dev)}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model), dtype=np.float32)).to(dev)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(
            cfg, params, batch, max_len=S + SERVE["decode_len"])

    def run_decode():
        tok = state["logits"].argmax(-1)[:, None]
        for t in range(n_dec):
            pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
            logits, state["cache"] = decode_step(cfg, params, state["cache"],
                                                 tok, pos)
            tok = logits.argmax(-1)[:, None]

    groups = (("mla_attention", ("mla_attention", "mla_decode_merge")),
              ("flash_attention", ("flash_attention",)),
              ("decode_attention", ("decode_attention",)),
              ("ssd_scan", ("ssd_scan",)),
              ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
              ("sort", ("sort", "radix")),
              ("gather/scatter", ("index", "gather", "scatter")))
    for label, fn in (("prefill", run_prefill), ("decode x8", run_decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        if not rows:
            print(f"profile serve {arch} {label}: wall_s={wall:.3f} device "
                  "time not measured (the profiler saw no device activity)")
            continue
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        by_group = {g: 0.0 for g, _ in groups}
        by_group["other"] = 0.0
        for e in rows:
            name = e.key.lower()
            g = next((g for g, keys in groups
                      if any(k in name for k in keys)), "other")
            by_group[g] += e.self_device_time_total / 1e6
        print(f"profile serve {arch} layers={cfg.num_layers} {label}: "
              f"wall_s={wall:.3f} "
              f"device_launches={sum(e.count for e in rows)} "
              f"device_busy_s={busy:.4f} device_idle_share="
              f"{1 - busy / wall:.4f} device_s_by_group="
              f"{ {g: round(v, 4) for g, v in by_group.items()} }",
              flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.key[:70]!r} count={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3:.3f}")
    del params, state
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _route_run(torch, cfg, params, tokens, n_prefill, frontend=None):
    """Cache-free forward logits, prefill's last logits and teacher-forced
    decode logits of one route; ``frontend``: the frames or patches that
    the forward and the prefill take."""
    from repro_torch.models import decode_step, forward, prefill

    full, _ = forward(cfg, params, tokens, frontend_embeds=frontend)
    batch = {"tokens": tokens[:, :n_prefill]}
    if frontend is not None:
        batch["frontend"] = frontend
    last, cache = prefill(cfg, params, batch, max_len=tokens.shape[1])
    steps = []
    for t in range(n_prefill, tokens.shape[1]):
        pos = torch.full((tokens.shape[0], 1), t, dtype=torch.int32,
                         device=tokens.device)
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    pos)
        steps.append(logits)
    torch.cuda.synchronize()
    return full, last, torch.stack(steps, dim=1)


def _hold_routes(torch, kernels, label, cfg, params, tokens, n_prefill,
                 patched, on_route=None, frontend=None):
    """``_route_run`` (with ``frontend``) on the kernel route, then on the
    plain route with
    each (module, name, plain version) of ``patched`` swapped in: no
    launch on the plain route, the routes' logits within 1e-3, and
    teacher-forced decode after prefill within 2e-3 of the cache-free
    forward, all finite.  ``on_route("kernel")`` / ``on_route("plain")``,
    if given, runs before each route.  Returns the kernel route's
    launches, launches by instance, ssd launches by chunk run and
    cache-free logits, both max|diff|s and the largest |logit|."""
    if on_route is not None:
        on_route("kernel")
    _zero_counts(kernels)
    kern = _route_run(torch, cfg, params, tokens, n_prefill, frontend)
    launches = _counts(kernels)
    for name in ("flash_attention", "flash_attention_latent"):
        _require(kernels[name].lse_launches == 0,
                 f"{label}: a serving {name} launch stored lse")
    chunks = dict(kernels["ssd_scan"].chunk_launches)
    instances = {name: dict(fn.instance_launches)
                 for name, fn in kernels.items()
                 if hasattr(fn, "instance_launches")}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    if on_route is not None:
        on_route("plain")
    _zero_counts(kernels)
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        plain = _route_run(torch, cfg, params, tokens, n_prefill,
                           frontend)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    _require(all(n == 0 for n in _counts(kernels).values()),
             f"{label}: the plain route launched a kernel")
    route_err = _max_abs(kern, plain)
    _require(_close(torch, kern, plain, dict(rtol=1e-3, atol=1e-3)),
             f"{label}: kernel vs plain route max|diff| {route_err}")
    full, last, steps = kern
    forward_tail = [full[:, n_prefill - 1], full[:, n_prefill:]]
    tf_err = _max_abs([last, steps], forward_tail)
    _require(_close(torch, [last, steps], forward_tail,
                    dict(rtol=2e-3, atol=2e-3)),
             f"{label}: decode vs forward max|diff| {tf_err}")
    _require(all(bool(torch.isfinite(t).all()) for t in kern),
             f"{label}: non-finite logits")
    return dict(launches=launches, chunk_launches=chunks,
                instance_launches=instances,
                route_err=route_err, tf_err=tf_err, full=full,
                max_abs_logit=float(full.abs().max()))


def _routes_line(held, n_prefill, S) -> str:
    return (f"prompt={S} prefill={n_prefill} decode={S - n_prefill} "
            f"kernel_vs_plain_max_abs={held['route_err']:.3e} (tol 1e-3) "
            f"decode_vs_forward_max_abs={held['tf_err']:.3e} (tol 2e-3) "
            f"max_abs_logit={held['max_abs_logit']:.4f} "
            f"launches={held['launches']}")


def phase_serve_check(np, torch, kernels, dev):
    """hymba-1.5b at full width and 4 layers (global, window, window,
    global; window 1024) in f32, prompt 1536: the kernel route against the
    plain route on the card (logits within 1e-3), and teacher-forced decode
    after prefill against the cache-free forward (within 2e-3).  TF32 is
    off for both matmul and cuDNN, so f32 products run in full f32."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_plain
    from repro_torch.launch.serve import load_model
    from repro_torch.models import attention, layer_windows, ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = load_model("hymba-1.5b", device=dev, seed=1, num_layers=4,
                             dtype="float32")
    wins = layer_windows(cfg)
    _require(wins == [None, 1024, 1024, None], f"serve-check windows {wins}")
    B, S, n_prefill = 2, 1536, 1528
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    held = _hold_routes(
        torch, kernels, "serve-check", cfg, params, tokens, n_prefill,
        [(attention, "flash_attention", flash_attention_plain),
         (attention, "decode_attention", decode_attention_plain),
         (ssm, "ssd_scan", ssd_scan_plain)])
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        _require(held["launches"][name] > 0,
                 f"serve-check: kernel route never launched {name}")
    print(f"serve-check: hymba-1.5b full width, layers=4 windows={wins} f32 "
          f"tf32=off batch={B} {_routes_line(held, n_prefill, S)}",
          flush=True)


# serve-dense: arch, layers (None: the published depth), requests and
# decode steps; batches of 8, prompt 2048, bf16, random weights from seed 0
DENSE_SERVES = (
    ("glm4-9b", None, SERVE["requests"], SERVE["decode_len"]),
    ("olmo-1b", 4, 8, 32),
    ("h2o-danube-1.8b", 4, 8, 32),
    ("nemotron-4-15b", 4, 8, 32),
)
# serve-dense-check: arch and config overrides (4 layers, f32); danube's
# window cut to 1024 so that it bites inside the 1536-token prompt
DENSE_CHECKS = (
    ("glm4-9b", {}),
    ("h2o-danube-1.8b", {"sliding_window": 1024}),
)


def phase_serve_dense(torch, kernels, dev):
    """The dense-GQA configs through ``repro_torch.launch.serve`` at full
    width, bf16, random weights from seed 0: glm4-9b at its full depth (40
    layers) with serve's traffic (16 requests in batches of 8, prompt 2048,
    64 greedy decode steps), the other three at 4 layers with one batch of
    8 (32 decode steps).  One model on the card at a time.  Returns each
    kernel's launches summed over the four."""
    from repro_torch.kernels.decode_attention.ops import head_groups

    total = {name: 0 for name in kernels}
    for arch, layers, requests, decode_len in DENSE_SERVES:
        extra = {} if layers is None else {"num_layers": layers}
        cfg, params, init_s, nparams = _load_timed(torch, arch, dev, **extra)
        label = f"serve-dense {arch}"
        res = _measured_serve(torch, kernels, label, cfg, params, requests,
                              decode_len)
        launches = res["launches"]
        flash_instances = dict(kernels["flash_attention"].instance_launches)
        L, nb = cfg.num_layers, res["batches"]
        want = {"flash_attention": L * nb,
                "decode_attention": L * decode_len * nb, "ssd_scan": 0}
        _require_launches(label, launches, want)
        _require(flash_instances == {"wgmma": L * nb, "fma": 0},
                 f"{label}: flash_attention instances {flash_instances}, "
                 "want every launch on the tensor-core (wgmma) instance")
        g = cfg.num_heads // cfg.num_kv_heads
        print(f"serve-dense: {arch} layers={L} d_model={cfg.d_model} "
              f"head_dim={cfg.resolved_head_dim} G={g} "
              f"head_groups={head_groups(g)} window={cfg.sliding_window} "
              f"vocab={cfg.vocab_size} params={nparams} bf16 "
              f"init_s={init_s:.2f} requests={requests} "
              f"batch={SERVE['batch']} {_serve_line(res)} "
              f"launches={ {n: launches[n] for n in want} } "
              f"flash_attention_instances={flash_instances}", flush=True)
        for name in kernels:
            total[name] += launches[name]
        del params, res
        torch.cuda.empty_cache()
    return total


def phase_serve_dense_check(np, torch, kernels, dev):
    """``DENSE_CHECKS`` at full width and 4 layers in f32 (TF32 off),
    prompt 1536: the kernel route against the plain route on the card
    (logits within 1e-3), teacher-forced decode after prefill against the
    cache-free forward (within 2e-3), and no launch on the plain route."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.launch.serve import load_model
    from repro_torch.models import attention, layer_windows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, n_prefill = 2, 1536, 1528
    for arch, overrides in DENSE_CHECKS:
        cfg, params = load_model(arch, device=dev, seed=1, num_layers=4,
                                 dtype="float32", **overrides)
        wins = layer_windows(cfg)
        rng = np.random.default_rng(6)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
        label = f"serve-dense-check {arch}"
        held = _hold_routes(
            torch, kernels, label, cfg, params, tokens, n_prefill,
            [(attention, "flash_attention", flash_attention_plain),
             (attention, "decode_attention", decode_attention_plain)])
        launches = held["launches"]
        _require(launches["flash_attention"] > 0
                 and launches["decode_attention"] > 0
                 and launches["ssd_scan"] == 0,
                 f"{label}: kernel route launches {launches}")
        print(f"serve-dense-check: {arch} full width, layers=4 "
              f"head_dim={cfg.resolved_head_dim} "
              f"G={cfg.num_heads // cfg.num_kv_heads} windows={wins} f32 "
              f"tf32=off batch={B} {_routes_line(held, n_prefill, S)}",
              flush=True)
        del params
        torch.cuda.empty_cache()


# serve-encdec / serve-vlm: the encoder-decoder seamless-m4t-medium (12
# encoder and 12 decoder layers) and the VLM internvl2-2b (24 layers) at
# their published widths and depths with serve's traffic, each batch with
# standard-normal frames / patches (launch.serve draws them).
# FRONTEND_CHECKS: the -check phases at the same widths in f32: arch,
# overrides (4 layers; seamless 4 encoder and 4 decoder layers), frames or
# patches, prompt, prefill.  seamless's prefill of 760 tokens over 1000
# frames runs its cross-attention ragged at S != T, and every decode
# position (760..767) lies below the frame count
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "internvl2-2b"
FRONTEND_CHECKS = {
    "serve-encdec-check": (ENCDEC_ARCH, dict(num_layers=4, encoder_layers=4),
                           1000, 768, 760),
    "serve-vlm-check": (VLM_ARCH, dict(num_layers=4), 256, 1536, 1528),
}


def frontend_launches(cfg, batches: int, decode_len: int) -> dict:
    """flash and decode launches of ``batches`` served batches: per batch
    one flash an encoder layer, and per decoder layer one for
    self-attention and, with an encoder, one for cross-attention, in the
    prefill and in each decode step."""
    calls = 2 if cfg.encoder_layers else 1
    return {"flash_attention":
            (cfg.encoder_layers + calls * cfg.num_layers) * batches,
            "decode_attention": calls * cfg.num_layers * decode_len * batches}


def phase_serve_frontend(torch, kernels, dev, arch, label):
    """``arch`` (``ENCDEC_ARCH`` or ``VLM_ARCH``) through
    ``repro_torch.launch.serve`` at full width and depth (bf16, random
    weights from seed 0) with serve's traffic: every prefill attention on
    flash's tensor-core instance and every decode attention on
    decode_attention, as many as ``frontend_launches`` says, no other
    model kernel.  Returns the launches."""
    t_phase = time.perf_counter()
    cfg, params, init_s, nparams = _load_timed(torch, arch, dev)
    res = _measured_serve(torch, kernels, label, cfg, params,
                          SERVE["requests"], SERVE["decode_len"])
    launches = res["launches"]
    flash_instances = dict(kernels["flash_attention"].instance_launches)
    nb = res["batches"]
    want = dict(frontend_launches(cfg, nb, SERVE["decode_len"]),
                ssd_scan=0, flash_attention_latent=0,
                decode_attention_latent=0)
    _require_launches(label, launches, want)
    _require(flash_instances == {"wgmma": want["flash_attention"], "fma": 0},
             f"{label}: flash_attention instances {flash_instances}, want "
             "every launch on the tensor-core (wgmma) instance")
    print(f"{label}: {arch} layers={cfg.num_layers} "
          f"encoder_layers={cfg.encoder_layers} frontend={cfg.frontend} "
          f"frontend_len={cfg.frontend_len} d_model={cfg.d_model} "
          f"head_dim={cfg.resolved_head_dim} "
          f"G={cfg.num_heads // cfg.num_kv_heads} vocab={cfg.vocab_size} "
          f"params={nparams} bf16 init_s={init_s:.2f} "
          f"requests={SERVE['requests']} batch={SERVE['batch']} "
          f"{_serve_line(res)} launches={ {n: launches[n] for n in want} } "
          f"flash_attention_instances={flash_instances} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params, res
    torch.cuda.empty_cache()
    return dict(launches=launches, flash_instances=flash_instances)


def phase_serve_frontend_check(np, torch, kernels, dev, phase):
    """``FRONTEND_CHECKS[phase]`` at full width in f32 with TF32 off, batch
    2, standard-normal frames or patches: the kernel route against the
    plain route on the card (logits within 1e-3), teacher-forced decode
    after prefill against the cache-free forward (within 2e-3), the
    launches ``frontend_launches`` counts for a forward and a prefill (all
    flash on the CUDA-core instance) and the decode steps, and nothing on
    the plain route."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.launch.serve import load_model
    from repro_torch.models import attention

    t_phase = time.perf_counter()
    arch, overrides, frames, S, n_prefill = FRONTEND_CHECKS[phase]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = load_model(arch, device=dev, seed=1, dtype="float32",
                             **overrides)
    if cfg.encoder_layers:
        _require(S <= frames, f"{phase}: a decode position at or past the "
                 f"{frames} frames")
    B = 2
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    frontend = torch.from_numpy(rng.standard_normal(
        (B, frames, cfg.d_model), dtype=np.float32)).to(dev)
    held = _hold_routes(
        torch, kernels, phase, cfg, params, tokens, n_prefill,
        [(attention, "flash_attention", flash_attention_plain),
         (attention, "decode_attention", decode_attention_plain)],
        frontend=frontend)
    launches = held["launches"]
    flash_instances = held["instance_launches"]["flash_attention"]
    # a forward and a prefill, then S - n_prefill decode steps
    want = dict(frontend_launches(cfg, 2, 0),
                decode_attention=frontend_launches(
                    cfg, 1, S - n_prefill)["decode_attention"],
                ssd_scan=0, flash_attention_latent=0,
                decode_attention_latent=0)
    _require_launches(phase, launches, want)
    _require(flash_instances == {"wgmma": 0, "fma": want["flash_attention"]},
             f"{phase}: flash_attention instances {flash_instances}, want "
             "every f32 launch on the CUDA-core (fma) instance")
    print(f"{phase}: {arch} full width, layers={cfg.num_layers} "
          f"encoder_layers={cfg.encoder_layers} frontend_len={frames} f32 "
          f"tf32=off batch={B} {_routes_line(held, n_prefill, S)} "
          f"flash_attention_instances={flash_instances} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params, held
    torch.cuda.empty_cache()


# serve-ssm: mamba2-2.7b at its published widths and depth with serve's
# traffic; serve-ssm-check: the same widths at 4 layers in f32
SSM_ARCH = "mamba2-2.7b"
SSM_CHECK_LAYERS = 4


def phase_serve_ssm(torch, kernels, dev):
    """mamba2-2.7b through ``repro_torch.launch.serve`` at full width and
    depth (64 layers, bf16, random weights from seed 0) with serve's
    traffic (16 requests in batches of 8, prompt 2048, 64 greedy decode
    steps): every prefill layer on ssd_scan with its passes at the chunk
    ``run_chunk`` gives (128 at N 128), no attention kernel.  Returns the
    launches and the ssd launches by chunk run."""
    from repro_torch.kernels.ssd_scan.ops import run_chunk

    cfg, params, init_s, nparams = _load_timed(torch, SSM_ARCH, dev)
    res = _measured_serve(torch, kernels, "serve-ssm", cfg, params,
                          SERVE["requests"], SERVE["decode_len"])
    launches = res["launches"]
    chunks = dict(kernels["ssd_scan"].chunk_launches)
    L, nb = cfg.num_layers, res["batches"]
    _require_launches("serve-ssm", launches, {
        "flash_attention": 0, "decode_attention": 0, "ssd_scan": L * nb})
    s_cfg = cfg.ssm
    lr = run_chunk(s_cfg.state_dim, s_cfg.chunk_size)
    _require(chunks == {lr: L * nb}, f"serve-ssm: ssd_scan launches by "
             f"chunk run {chunks}, want {{{lr}: {L * nb}}}")
    print(f"serve-ssm: {SSM_ARCH} layers={L} d_model={cfg.d_model} "
          f"ssm_heads={cfg.d_model * s_cfg.expand // s_cfg.head_dim} "
          f"head_dim={s_cfg.head_dim} state={s_cfg.state_dim} "
          f"chunk={s_cfg.chunk_size} run_chunk={lr} vocab={cfg.vocab_size} "
          f"params={nparams} bf16 init_s={init_s:.2f} "
          f"requests={SERVE['requests']} batch={SERVE['batch']} "
          f"{_serve_line(res)} launches={launches} "
          f"ssd_scan_chunk_launches={chunks}", flush=True)
    del params, res
    torch.cuda.empty_cache()
    return dict(launches=launches, chunk_launches=chunks)


def phase_serve_ssm_check(np, torch, kernels, dev):
    """mamba2-2.7b at full width and 4 layers in f32 with TF32 off, batch
    2, prompt 1536, prefill 1528 (a part chunk at the end): the kernel
    route against the plain route on the card (logits within 1e-3),
    teacher-forced decode after prefill against the cache-free forward
    (within 2e-3), and no launch on the plain route."""
    from repro_torch.kernels.ssd_scan.ops import run_chunk, ssd_scan_plain
    from repro_torch.launch.serve import load_model
    from repro_torch.models import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = load_model(SSM_ARCH, device=dev, seed=1,
                             num_layers=SSM_CHECK_LAYERS, dtype="float32")
    B, S, n_prefill = 2, 1536, 1528
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    held = _hold_routes(torch, kernels, "serve-ssm-check", cfg, params,
                        tokens, n_prefill, [(ssm, "ssd_scan", ssd_scan_plain)])
    # forward and prefill: one launch a layer each, at the chunk run
    lr = run_chunk(cfg.ssm.state_dim, cfg.ssm.chunk_size)
    n = 2 * cfg.num_layers
    _require(held["launches"] == {**{k: 0 for k in kernels}, "ssd_scan": n}
             and held["chunk_launches"] == {lr: n},
             f"serve-ssm-check: kernel route launches {held['launches']}, "
             f"by chunk run {held['chunk_launches']}")
    print(f"serve-ssm-check: {SSM_ARCH} full width, layers={cfg.num_layers} "
          f"f32 tf32=off batch={B} {_routes_line(held, n_prefill, S)} "
          f"ssd_scan_chunk_launches={held['chunk_launches']}", flush=True)
    del params, held
    torch.cuda.empty_cache()


# serve-moe: qwen3-moe-30b-a3b as published with serve's traffic and the
# identity expert dispatch; serve-moe-check: the same widths at 4 layers in
# f32.  MOE_REFIT: the reference serve CLI's refit of qwen3's 128 experts
# (``launch/serve.py`` ``expert_refit``: 4 EP ranks of 34 slots), the
# contiguous layout's and LMBR's avg span, pinned by a CPU test
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_CHECK_LAYERS = 4
MOE_REFIT = (3.565, 2.21)


def phase_serve_moe(torch, kernels, dev):
    """qwen3-moe-30b-a3b through ``repro_torch.launch.serve`` at full width
    and depth (48 layers, 128 experts top-8; bf16, random weights from seed
    0, created on the card) with serve's traffic (16 requests in batches of
    8, prompt 2048, 64 greedy decode steps) and the identity dispatch:
    every flash launch on the tensor-core instance, no ssd_scan.  Prints
    each batch's prefill ``drop_frac`` summed over the layers and the
    serve-time expert refit, whose spans must be the reference's
    (``MOE_REFIT``).  Every earlier model is freed first: the weights take
    ~61 GB of the card.  Returns the launches."""
    import gc

    from repro_torch.launch.serve import expert_refit, refit_line

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg, params, init_s, nparams = _load_timed(torch, MOE_ARCH, dev)
    res = _measured_serve(torch, kernels, "serve-moe", cfg, params,
                          SERVE["requests"], SERVE["decode_len"])
    launches = res["launches"]
    flash_instances = dict(kernels["flash_attention"].instance_launches)
    L, nb = cfg.num_layers, res["batches"]
    want = {"flash_attention": L * nb,
            "decode_attention": L * SERVE["decode_len"] * nb, "ssd_scan": 0}
    _require_launches("serve-moe", launches, want)
    _require(flash_instances == {"wgmma": L * nb, "fma": 0},
             f"serve-moe: flash_attention instances {flash_instances}, want "
             "every launch on the tensor-core (wgmma) instance")
    drops = res["prefill_drop_frac"]
    _require(len(drops) == nb and all(math.isfinite(x) for x in drops),
             f"serve-moe: prefill drop_frac {drops}")
    line = _serve_line(res)
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base_span, plan_span, _ = expert_refit(cfg, device=dev)
    refit_s = time.perf_counter() - t0
    _require((base_span, plan_span) == MOE_REFIT,
             f"serve-moe: refit spans {(base_span, plan_span)}, want the "
             f"reference's {MOE_REFIT}")
    m = cfg.moe
    print(f"serve-moe: {MOE_ARCH} layers={L} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} experts={m.num_experts} "
          f"top_k={m.top_k} d_ff_expert={m.d_ff_expert} "
          f"capacity_factor={m.capacity_factor} vocab={cfg.vocab_size} "
          f"params={nparams} bf16 held_before_gb={held_gb:.3f} "
          f"init_s={init_s:.2f} requests={SERVE['requests']} "
          f"batch={SERVE['batch']} {line} "
          f"prefill_drop_frac_sum_over_layers={drops} "
          f"launches={ {n: launches[n] for n in want} } "
          f"flash_attention_instances={flash_instances}", flush=True)
    print(f"serve-moe: {refit_line(base_span, plan_span)} "
          f"(reference {MOE_REFIT[0]} -> {MOE_REFIT[1]}; fit on the card in "
          f"{refit_s:.3f} s) phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return dict(launches=launches)


def _slotted(params, dispatch):
    """``params`` with every MoE layer's expert weights gathered to the
    slots of ``dispatch`` (the same per-expert weights, replicas
    included)."""
    import torch

    s2e = torch.as_tensor(dispatch.slot_to_expert, dtype=torch.int64,
                          device=params["embed"]["table"].device)
    return dict(params, blocks=[
        dict(p, moe={k: (v[s2e] if k.startswith("we_") else v)
                     for k, v in p["moe"].items()}) if "moe" in p else p
        for p in params["blocks"]])


def phase_serve_moe_check(np, torch, kernels, dev):
    """qwen3-moe-30b-a3b at full width and 4 layers in f32 with TF32 off,
    batch 2, prompt 1536, prefill 1528, at capacity factor E / top_k (16),
    where a slot takes every token, so nothing drops: the kernel route
    against the plain route on the card (logits within 1e-3), teacher-
    forced decode after prefill against the cache-free forward (within
    2e-3), no launch on the plain route, every MoE call of both routes
    choosing the same top-k expert set for every token (0 tokens differ)
    and dropping nothing.  Then the cache-free forward once more under the
    refit's ``dispatch_from_plan`` dispatch (4 ranks of E // 4 + 2 slots,
    replicas) on the same per-expert weights gathered to its slots, at
    capacity factor slots / top_k: within 1e-3 of the identity dispatch's
    logits, nothing dropped."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.launch.serve import expert_refit, load_model
    from repro_torch.models import attention, dispatch_from_plan, forward, moe

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pub = get_config(MOE_ARCH).moe
    cf = pub.num_experts / pub.top_k
    cfg, params = load_model(
        MOE_ARCH, device=dev, seed=1, num_layers=MOE_CHECK_LAYERS,
        dtype="float32", moe=dataclasses.replace(pub, capacity_factor=cf))
    B, S, n_prefill = 2, 1536, 1528
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    # every MoE call's top-k sets (sorted) and dropped count, by route
    calls = {"kernel": [], "plain": []}
    state = {}
    route_fn = moe.route

    def recording_route(*a, **kw):
        r = route_fn(*a, **kw)
        calls[state["route"]].append(
            (r["top_e"].sort(-1).values, (~r["keep"]).sum()))
        return r

    def on_route(name):
        state["route"] = name

    moe.route = recording_route
    try:
        held = _hold_routes(
            torch, kernels, "serve-moe-check", cfg, params, tokens,
            n_prefill,
            [(attention, "flash_attention", flash_attention_plain),
             (attention, "decode_attention", decode_attention_plain)],
            on_route=on_route)
    finally:
        moe.route = route_fn
    launches = held["launches"]
    _require(launches["flash_attention"] > 0
             and launches["decode_attention"] > 0
             and launches["ssd_scan"] == 0,
             f"serve-moe-check: kernel route launches {launches}")
    # forward and prefill: one call a layer each, then one a decode step
    n_calls = cfg.num_layers * (2 + S - n_prefill)
    _require(len(calls["kernel"]) == len(calls["plain"]) == n_calls,
             f"serve-moe-check: MoE calls {len(calls['kernel'])} / "
             f"{len(calls['plain'])}, want {n_calls}")
    differ = sum(int((a != b).any(-1).sum())
                 for (a, _), (b, _) in zip(calls["kernel"], calls["plain"]))
    dropped = sum(int(d) for route in calls.values() for _, d in route)
    _require(differ == 0, f"serve-moe-check: {differ} tokens choose other "
             "experts on the kernel route than on the plain route")
    _require(dropped == 0, f"serve-moe-check: {dropped} assignments "
             f"dropped at capacity factor {cf}")
    tokens_routed = sum(a.shape[0] for a, _ in calls["kernel"])
    identity = held.pop("full")
    del calls
    # the refit's replicated dispatch on the same per-expert weights
    _, _, plan = expert_refit(cfg, device=dev)
    d = dispatch_from_plan(plan)
    cfg_plan = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=d.num_slots / cfg.moe.top_k))
    slotted = _slotted(params, d)
    got, _, aux = forward(cfg_plan, slotted, tokens, moe_dispatch=d,
                          return_aux=True)
    torch.cuda.synchronize()
    plan_err = _max_abs([got], [identity])
    _require(_close(torch, [got], [identity], dict(rtol=1e-3, atol=1e-3)),
             f"serve-moe-check: replicated dispatch vs identity max|diff| "
             f"{plan_err}")
    plan_drop = float(aux["drop_frac"])
    _require(plan_drop == 0.0, f"serve-moe-check: the replicated dispatch "
             f"dropped {plan_drop} (summed over layers)")
    replicas = int(d.num_slots - len(set(d.slot_to_expert.tolist())))
    print(f"serve-moe-check: {MOE_ARCH} full width, "
          f"layers={cfg.num_layers} experts={cfg.moe.num_experts} "
          f"top_k={cfg.moe.top_k} capacity_factor={cf} f32 tf32=off "
          f"batch={B} {_routes_line(held, n_prefill, S)} "
          f"moe_calls={n_calls} tokens_routed={tokens_routed} "
          f"topk_sets_differ={differ} dropped={dropped} "
          f"replicated_dispatch slots={d.num_slots} ranks={d.num_ranks} "
          f"replicas={replicas} vs_identity_max_abs={plan_err:.3e} "
          f"(tol 1e-3) drop_frac={plan_drop} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params, slotted, held, identity, got
    torch.cuda.empty_cache()


# serve-mla: deepseek-v3-671b at its published widths cut to MLA_LAYERS
# layers (its three dense layers and one MoE layer: the least depth that
# runs both of its block kinds; the whole model is ~1.3 TB in bf16) with
# serve's traffic; serve-mla-check: its three dense MLA layers in f32 (a
# full-width MoE layer in f32 is 46 GB, and serve-moe-check holds the MoE
# block).  MLA_REFIT: the reference serve CLI's refit of deepseek-v3's 256
# experts (4 EP ranks of 66 slots), pinned by a CPU test
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4
MLA_CHECK_LAYERS = 3
MLA_REFIT = (3.615, 1.96)


def phase_serve_mla(torch, kernels, dev):
    """deepseek-v3-671b through ``repro_torch.launch.serve`` at full width
    (d_model 7168, 128 heads, q_lora 1536, kv_lora 512, rope 64, 256
    experts top-8 of d_ff 2048 and a shared expert, vocab 129 280) and
    ``MLA_LAYERS`` layers (bf16, random weights from seed 0, created on
    the card after every earlier model is freed) with serve's traffic and
    the identity dispatch: every attention launch on the latent kernels
    (L x batches prefill, L x steps x batches decode), none of the GQA or
    SSD kernels.  Prints each batch's prefill ``drop_frac`` summed over the
    layers and the serve-time expert refit, whose spans must be the
    reference's (``MLA_REFIT``).  Returns the launches."""
    import gc

    from repro_torch.launch.serve import expert_refit, refit_line

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg, params, init_s, nparams = _load_timed(torch, MLA_ARCH, dev,
                                               num_layers=MLA_LAYERS)
    res = _measured_serve(torch, kernels, "serve-mla", cfg, params,
                          SERVE["requests"], SERVE["decode_len"])
    launches = res["launches"]
    latent_instances = dict(
        kernels["flash_attention_latent"].instance_launches)
    decode_instances = dict(
        kernels["decode_attention_latent"].instance_launches)
    L, nb = cfg.num_layers, res["batches"]
    want = {"flash_attention_latent": L * nb,
            "decode_attention_latent": L * SERVE["decode_len"] * nb,
            "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    _require_launches("serve-mla", launches, want)
    _require(latent_instances == {"wgmma": L * nb, "fma": 0},
             f"serve-mla: flash_attention_latent instances "
             f"{latent_instances}, want every launch on the tensor-core "
             f"(wgmma) kernel")
    _require(decode_instances == {
        "wgmma": want["decode_attention_latent"], "fma": 0},
             f"serve-mla: decode_attention_latent instances "
             f"{decode_instances}, want every launch on the tensor-core "
             f"(wgmma) kernel")
    drops = res["prefill_drop_frac"]
    _require(len(drops) == nb and all(math.isfinite(x) for x in drops),
             f"serve-mla: prefill drop_frac {drops}")
    line = _serve_line(res)
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base_span, plan_span, _ = expert_refit(cfg, device=dev)
    refit_s = time.perf_counter() - t0
    _require((base_span, plan_span) == MLA_REFIT,
             f"serve-mla: refit spans {(base_span, plan_span)}, want the "
             f"reference's {MLA_REFIT}")
    m, a = cfg.moe, cfg.mla
    print(f"serve-mla: {MLA_ARCH} layers={L} (first_k_dense="
          f"{m.first_k_dense}) d_model={cfg.d_model} heads={cfg.num_heads} "
          f"q_lora={a.q_lora_rank} kv_lora={a.kv_lora_rank} "
          f"rope={a.qk_rope_head_dim} experts={m.num_experts} "
          f"top_k={m.top_k} d_ff_expert={m.d_ff_expert} "
          f"shared={m.num_shared_experts} capacity_factor="
          f"{m.capacity_factor} vocab={cfg.vocab_size} params={nparams} "
          f"bf16 held_before_gb={held_gb:.3f} init_s={init_s:.2f} "
          f"requests={SERVE['requests']} batch={SERVE['batch']} {line} "
          f"prefill_drop_frac_sum_over_layers={drops} "
          f"launches={ {n: launches[n] for n in want} } "
          f"flash_attention_latent_instances={latent_instances} "
          f"decode_attention_latent_instances={decode_instances}",
          flush=True)
    print(f"serve-mla: {refit_line(base_span, plan_span)} "
          f"(reference {MLA_REFIT[0]} -> {MLA_REFIT[1]}; fit on the card in "
          f"{refit_s:.3f} s) phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return dict(launches=launches, latent_instances=latent_instances,
                decode_instances=decode_instances)


def phase_serve_mla_check(np, torch, kernels, dev):
    """deepseek-v3-671b at full width and ``MLA_CHECK_LAYERS`` layers (its
    dense MLA layers) in f32 with TF32 off, batch 2, prompt 1536, prefill
    1528: the kernel route against the plain route on the card (logits
    within 1e-3), teacher-forced decode after prefill against the
    cache-free forward (within 2e-3), the latent kernels launched on the
    kernel route and nothing on the plain route."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_latent_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_latent_plain)
    from repro_torch.launch.serve import load_model
    from repro_torch.models import attention

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = load_model(MLA_ARCH, device=dev, seed=1,
                             num_layers=MLA_CHECK_LAYERS, dtype="float32")
    _require(all("moe" not in p for p in params["blocks"]),
             "serve-mla-check: the layers must be the dense MLA ones")
    B, S, n_prefill = 2, 1536, 1528
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    held = _hold_routes(
        torch, kernels, "serve-mla-check", cfg, params, tokens, n_prefill,
        [(attention, "flash_attention_latent", flash_attention_latent_plain),
         (attention, "decode_attention_latent",
          decode_attention_latent_plain)])
    launches = held["launches"]
    latent_instances = held["instance_launches"]["flash_attention_latent"]
    decode_instances = held["instance_launches"]["decode_attention_latent"]
    L = cfg.num_layers
    want = {"flash_attention_latent": 2 * L,
            "decode_attention_latent": (S - n_prefill) * L,
            "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    _require_launches("serve-mla-check", launches, want)
    _require(latent_instances == {"wgmma": 0, "fma": 2 * L},
             f"serve-mla-check: flash_attention_latent instances "
             f"{latent_instances}, want every f32 launch on the CUDA-core "
             f"(fma) kernel")
    _require(decode_instances == {
        "wgmma": 0, "fma": want["decode_attention_latent"]},
             f"serve-mla-check: decode_attention_latent instances "
             f"{decode_instances}, want every f32 launch on the CUDA-core "
             f"(fma) kernel")
    print(f"serve-mla-check: {MLA_ARCH} full width, layers={L} (dense MLA) "
          f"f32 tf32=off batch={B} {_routes_line(held, n_prefill, S)} "
          f"flash_attention_latent_instances={latent_instances} "
          f"decode_attention_latent_instances={decode_instances} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params, held
    torch.cuda.empty_cache()


# train: olmo-1b at full width and depth (16 layers, bf16) through
# make_train_step, fed by PlacementAwarePipeline, AdamW at lr 3e-4, accum
# 1, no checkpoint (a full-width one is ~12 GB of npz).  A remat step runs
# every block's forward twice: 2 L forward launches (all on the wgmma
# instance) and L backward calls a step.
TRAIN = dict(arch="olmo-1b", batch=8, seq=1024, steps=8, lr=3e-4,
             num_shards=64, num_hosts=8)
# train-check: (a) olmo-1b at full width and 2 layers in f32, one
# gradient on the kernel route against the plain route; (b) the train
# CLI at the reference e2e test's arguments (reduced olmo-1b, f32, D 32)
TRAIN_CHECK = dict(layers=2, batch=4, seq=1024)
TRAIN_CLI = ("--arch", "olmo-1b", "--reduced", "--steps", "60", "--batch",
             "8", "--seq", "64", "--lr", "3e-3", "--ckpt-every", "25",
             "--inject-failures")

# train-mla: deepseek-v3-671b at its published widths (d_model 7168, 128
# heads, MLA with q_lora 1536, kv_lora 512, rope 64, dense d_ff 18432,
# vocab 129 280) cut to its three dense layers (first_k_dense) with its
# MTP group (a dense block and a 2 d x d projection): 4.29 B parameters.
# Under AdamW that is 8.6 GB of bf16 weights, 8.6 GB of gradients and
# 34.3 GB of fp32 moments; the step donates its parameters and state
# (``make_train_step(donate=True)``, as the reference's jit donates them),
# since a second copy of the moments would not fit beside them.  Its
# first MoE layer would add 10.8 B parameters (~130 GB under AdamW): the
# MoE layers train with the mesh (ROADMAP Queue 1 item 9.6).  TRAIN's
# sequence, lr and steps at batch 4: at TRAIN's B 8 the backward ran out
# of the card's 79.18 GiB (73.6 GiB allocated when the main head's fp32
# logit gradient, 3.94 GiB, was asked for: the two heads' fp32 logits are
# 4.2 GB each at B 8 x S 1024 x vocab 129 280), so only the batch is cut.
# A remat step runs each layer's latent forward twice and the MTP block's
# once, and each backward once (``train_launches``).
TRAIN_MLA = dict(arch=MLA_ARCH, layers=3, batch=4, seq=TRAIN["seq"])
# train-mla-check: the same widths at 2 dense layers and the MTP group in
# f32 (3.7 B parameters, 14.8 GB; two routes' gradients beside them), the
# kernel route against the plain route
TRAIN_MLA_CHECK = dict(layers=2, batch=2, seq=1024)


def train_launches(cfg, steps: int) -> dict:
    """The attention (or scan) kernel's forward launches and backward calls
    in ``steps`` train steps of ``cfg``, one a block: ``train_loss`` runs
    each decoder block under ``torch.utils.checkpoint`` (its forward twice,
    its backward once) and, with an ``mtp`` group (deepseek-v3), applies
    the MTP block once more without it (``models/model.py``
    ``train_loss``): one forward and one backward."""
    mtp = 1 if cfg.mtp_depth else 0
    return dict(forward=(2 * cfg.num_layers + mtp) * steps,
                backward=(cfg.num_layers + mtp) * steps)


def _no_plain(mod, names):
    """Swap each ``mod.<name>`` for a function that raises; returns the
    originals, to restore with ``setattr``."""
    saved = {n: getattr(mod, n) for n in names}

    def refuse(*_, **__):
        raise AssertionError("a plain version ran on the card's main path")

    for n in names:
        setattr(mod, n, refuse)
    return saved


def _train_setup(torch, arch, dev, layers=None, batch=None, donate=False):
    """``arch`` as published (cut to ``layers`` layers when given), bf16,
    random weights from seed 0, AdamW at ``TRAIN``'s lr through
    ``make_train_step`` (donating its parameters and optimizer state when
    ``donate``), batches of the placement-aware pipeline at ``batch``
    (``TRAIN``'s by default) and ``TRAIN``'s sequence: a dict of cfg,
    params, opt_state, step, next_batch, init_s, nparams, batch and
    seq."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import PlacementAwarePipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    batch = batch or TRAIN["batch"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = adamw(TRAIN["lr"])
    step, _ = make_train_step(cfg, optimizer=opt, donate=donate)
    pipe = PlacementAwarePipeline(
        num_shards=TRAIN["num_shards"], num_hosts=TRAIN["num_hosts"],
        vocab_size=cfg.vocab_size, batch_size=batch,
        seq_len=TRAIN["seq"], device=dev)

    def next_batch():
        b = pipe.next_batch()
        return {k: torch.from_numpy(b[k]).to(dev)
                for k in ("tokens", "targets")}

    return dict(cfg=cfg, params=params, opt_state=opt.init(params),
                step=step, next_batch=next_batch, init_s=init_s,
                nparams=sum(t.numel() for t in _leaves(params)),
                batch=batch, seq=TRAIN["seq"], donate=donate)


def _train_steps(torch, kernels, run, n):
    """``n`` steps of ``run`` (``_train_setup``) from zeroed launch counts
    and a reset peak: (losses, grad norms, step walls s, peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    losses, gnorms, walls = [], [], []
    for _ in range(n):
        batch = run["next_batch"]()
        t0 = time.perf_counter()
        run["params"], run["opt_state"], m = run["step"](
            run["params"], run["opt_state"], batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    return losses, gnorms, walls, torch.cuda.max_memory_allocated() / 1e9


def _profiled_step(torch, run, kernel_groups):
    """One more step of ``run`` under torch.profiler: (its batch, wall s,
    device busy s, device s by group), the groups ``kernel_groups``
    (name, key substrings) first, then GEMMs and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = run["next_batch"]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run["params"], run["opt_state"], _ = run["step"](
            run["params"], run["opt_state"], batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    groups = (*kernel_groups,
              ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))
    by_group = {g: 0.0 for g, _ in groups} | {"other": 0.0}
    for e in rows:
        g = next((g for g, keys in groups
                  if any(k in e.key.lower() for k in keys)), "other")
        by_group[g] += e.self_device_time_total / 1e6
    return batch, wall, busy, by_group


def _train_line(run, losses, gnorms, walls, peak_gb, prof_wall, busy,
                by_group) -> str:
    """The step, memory and device figures shared by the train lines."""
    steady = walls[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens = run["batch"] * run["seq"]
    return (f"params={run['nparams']} bf16 init_s={run['init_s']:.2f} "
            f"adamw lr={TRAIN['lr']} accum=1 donate={run['donate']} "
            f"batch={run['batch']} seq={run['seq']} steps={len(walls)} "
            f"losses={[round(x, 4) for x in losses]} "
            f"grad_norms={[round(x, 4) for x in gnorms]} "
            f"first_step_ms={1e3 * walls[0]:.1f} step_ms={step_ms:.1f} "
            f"tokens_per_s={tokens / (step_ms / 1e3):.1f} "
            f"peak_mem_gb={peak_gb:.3f} "
            f"profiled_step_s={prof_wall:.3f} device_busy_s={busy:.4f} "
            f"device_idle_share={1 - busy / prof_wall:.4f} "
            f"device_idle_share_of_step_ms={1 - busy / (step_ms / 1e3):.4f} "
            f"device_s_by_group="
            f"{ {g: round(v, 4) for g, v in by_group.items()} }")


def phase_train(np, torch, kernels, dev):
    """``make_train_step`` on olmo-1b at full width and depth (``TRAIN``):
    bf16, random weights from seed 0, batches of the placement-aware
    pipeline.  Finite losses and grad norms; exactly ``train_launches``
    flash launches (every forward on the wgmma instance) and no other
    model kernel; the plain versions swapped for functions that raise.
    Then one step under torch.profiler (device idle share) and, on the
    last batch, every layer's wq / wk / wv gradient nonzero."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import loss_and_grads

    t_phase = time.perf_counter()
    run = _train_setup(torch, TRAIN["arch"], dev)
    cfg, n = run["cfg"], TRAIN["steps"]
    saved = _no_plain(flash_ops, ("flash_attention_plain",
                                  "flash_attention_lse_plain",
                                  "flash_attention_bwd_plain"))
    try:
        losses, gnorms, walls, peak_gb = _train_steps(torch, kernels, run,
                                                      n)
        launches = _counts(kernels)
        backward = kernels["flash_attention"].backward_launches
        instances = dict(kernels["flash_attention"].instance_launches)
        bwd_instances = dict(
            kernels["flash_attention"].backward_instance_launches)
        lse_launches = kernels["flash_attention"].lse_launches
        want = train_launches(cfg, n)
        _require_launches("train", launches, {
            "flash_attention": want["forward"], "decode_attention": 0,
            "ssd_scan": 0, "flash_attention_latent": 0,
            "decode_attention_latent": 0})
        _require(kernels["ssd_scan"].backward_launches == 0,
                 "train: ssd_scan's backward launched")
        _require(backward == want["backward"],
                 f"train: {backward} backward calls, want {want['backward']}")
        _require(instances == {"wgmma": want["forward"], "fma": 0},
                 f"train: flash_attention instances {instances}, want every "
                 "forward on the tensor-core (wgmma) instance")
        _require(bwd_instances == {"wgmma": want["backward"], "fma": 0},
                 f"train: backward instances {bwd_instances}, want every "
                 "backward call on the tensor-core (wgmma) instance")
        # every backward reads the lse of its recomputed forward
        _require(want["backward"] <= lse_launches <= want["forward"],
                 f"train: {lse_launches} forward launches stored lse, want "
                 f"{want['backward']} to {want['forward']}")
        _require(all(math.isfinite(x) for x in losses + gnorms),
                 f"train: non-finite losses {losses} or grad norms {gnorms}")
        # one more step under the profiler: the device's busy and idle share
        batch, prof_wall, busy, by_group = _profiled_step(
            torch, run, (("flash_bwd", ("flash_bwd",)),
                         ("flash_fwd", ("flash_attention",))))
        # every layer's attention projections get a gradient
        _, _, grads = loss_and_grads(cfg, run["params"], batch)
        zero = [(i, w) for i, g in enumerate(grads["blocks"])
                for w in ("wq", "wk", "wv")
                if not bool(g["attn"][w].abs().amax() > 0)]
        _require(not zero, f"train: zero gradients at (layer, weight) {zero}")
        del grads
    finally:
        for name, fn in saved.items():
            setattr(flash_ops, name, fn)
    print(f"train: {TRAIN['arch']} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} "
          + _train_line(run, losses, gnorms, walls, peak_gb, prof_wall,
                        busy, by_group)
          + f" flash_per_step={launches['flash_attention'] // n} "
          f"backward_per_step={backward // n} "
          f"lse_launches_per_step={lse_launches / n:g} "
          f"flash_attention_instances={instances} "
          f"backward_instances={bwd_instances} "
          f"wq_wk_wv_grads=nonzero phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    del run
    torch.cuda.empty_cache()
    return dict(launches={**launches, "flash_attention_bwd": backward},
                backward=backward, backward_instances=bwd_instances)


# train-ssm: mamba2-2.7b at full width and depth (64 layers, bf16) through
# make_train_step at the TRAIN batch, lr and steps; every layer's
# ssd_scan forward twice a step (remat) and its backward once.
# train-ssm-check: mamba2-2.7b and hymba-1.5b at full width and
# TRAIN_SSM_CHECK["layers"] layers in f32, the kernel route against the
# plain route
TRAIN_SSM_ARCH = "mamba2-2.7b"
TRAIN_SSM_CHECK = dict(archs=("mamba2-2.7b", "hymba-1.5b"), layers=2,
                       batch=4, seq=1024)


def phase_train_ssm(np, torch, kernels, dev):
    """``make_train_step`` on mamba2-2.7b at full width and depth: bf16,
    random weights from seed 0, batches of the placement-aware pipeline at
    ``TRAIN``'s batch, sequence, lr and steps.  Finite losses and grad
    norms; exactly ``train_launches`` ssd_scan forward launches and
    backward calls and no other model kernel; the plain versions swapped
    for functions that raise.  Then one step under torch.profiler (device
    idle share, device s by group) and, on the last batch, every layer's
    w_in, w_out, a_log and dt_bias gradient nonzero."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.steps import loss_and_grads

    t_phase = time.perf_counter()
    run = _train_setup(torch, TRAIN_SSM_ARCH, dev)
    cfg, n = run["cfg"], TRAIN["steps"]
    ssd = kernels["ssd_scan"]
    saved = _no_plain(ssd_ops, ("ssd_scan_plain", "ssd_scan_bwd_plain"))
    try:
        losses, gnorms, walls, peak_gb = _train_steps(torch, kernels, run,
                                                      n)
        launches = _counts(kernels)
        backward = ssd.backward_launches
        chunks = dict(ssd.chunk_launches)
        want = train_launches(cfg, n)
        _require_launches("train-ssm", launches, {
            "ssd_scan": want["forward"], "flash_attention": 0,
            "decode_attention": 0, "flash_attention_latent": 0,
            "decode_attention_latent": 0})
        _require(backward == want["backward"],
                 f"train-ssm: {backward} ssd_scan backward calls, want "
                 f"{want['backward']}")
        _require(kernels["flash_attention"].backward_launches == 0,
                 "train-ssm: flash_attention's backward launched")
        _require(all(math.isfinite(x) for x in losses + gnorms),
                 f"train-ssm: non-finite losses {losses} or grad norms "
                 f"{gnorms}")
        batch, prof_wall, busy, by_group = _profiled_step(
            torch, run, (("ssd_bwd", ("ssd_bwd_",)),
                         ("ssd_fwd", ("ssd_scan_",))))
        # every layer's SSM weights get a gradient
        _, _, grads = loss_and_grads(cfg, run["params"], batch)
        zero = [(i, w) for i, g in enumerate(grads["blocks"])
                for w in ("w_in", "w_out", "a_log", "dt_bias")
                if not bool(g["ssm"][w].abs().amax() > 0)]
        _require(not zero, f"train-ssm: zero gradients at (layer, weight) "
                 f"{zero}")
        del grads
    finally:
        for name, fn in saved.items():
            setattr(ssd_ops, name, fn)
    s_cfg = cfg.ssm
    print(f"train-ssm: {TRAIN_SSM_ARCH} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} "
          f"ssm_heads={cfg.d_model * s_cfg.expand // s_cfg.head_dim} "
          f"head_dim={s_cfg.head_dim} state={s_cfg.state_dim} "
          f"chunk={s_cfg.chunk_size} "
          + _train_line(run, losses, gnorms, walls, peak_gb, prof_wall,
                        busy, by_group)
          + f" ssd_scan_per_step={launches['ssd_scan'] // n} "
          f"backward_per_step={backward // n} "
          f"ssd_scan_chunk_launches={chunks} "
          f"w_in_w_out_a_log_dt_bias_grads=nonzero "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del run
    torch.cuda.empty_cache()
    return dict(launches={**launches, "ssd_scan_bwd": backward},
                backward=backward)


def phase_train_ssm_check(np, torch, kernels, dev):
    """``TRAIN_SSM_CHECK``: mamba2-2.7b and hymba-1.5b at full width and 2
    layers in f32 (TF32 off), ``loss_and_grads`` on the kernel route
    (ssd_scan's forward and backward kernels; hymba's attention on flash's
    fma instances) against the plain route (``ssd_scan_plain`` and
    ``flash_attention_plain`` under autograd) on the same batch: loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its largest
    |value|, exact launches on the kernel route, none on the plain
    route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_plain
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention, init_params, ssm
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = TRAIN_SSM_CHECK["batch"], TRAIN_SSM_CHECK["seq"]
    parts = []
    for arch in TRAIN_SSM_CHECK["archs"]:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TRAIN_SSM_CHECK["layers"],
                                  dtype="float32")
        params = init_params(cfg, seed=1, device=dev)
        rng = np.random.default_rng(13)
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S + 1))).to(dev)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "targets": toks[:, 1:].contiguous()}
        _zero_counts(kernels)
        loss, _, grads = loss_and_grads(cfg, params, batch)
        launches = _counts(kernels)
        backward = {k: kernels[k].backward_launches
                    for k in ("ssd_scan", "flash_attention")}
        L = cfg.num_layers
        attn = cfg.attention != "none"
        _require(launches == {**{k: 0 for k in kernels},
                              "ssd_scan": 2 * L,
                              "flash_attention": 2 * L if attn else 0}
                 and backward == {"ssd_scan": L,
                                  "flash_attention": L if attn else 0},
                 f"train-ssm-check {arch}: kernel route launches "
                 f"{launches}, backward {backward}")
        _zero_counts(kernels)
        saved = (ssm.ssd_scan, attention.flash_attention)
        try:
            ssm.ssd_scan = ssd_scan_plain
            attention.flash_attention = flash_attention_plain
            plain_loss, _, plain_grads = loss_and_grads(cfg, params, batch)
        finally:
            ssm.ssd_scan, attention.flash_attention = saved
        _require(all(v == 0 for v in _counts(kernels).values())
                 and all(kernels[k].backward_launches == 0
                         for k in ("ssd_scan", "flash_attention")),
                 f"train-ssm-check {arch}: the plain route launched a "
                 "kernel")
        loss_rel = (abs(float(loss) - float(plain_loss))
                    / abs(float(plain_loss)))
        _require(loss_rel <= 1e-5, f"train-ssm-check {arch}: loss "
                 f"{float(loss)} against {float(plain_loss)} "
                 f"({loss_rel:.3g} relative)")
        worst, worst_at = 0.0, None
        for (path, g), pg in zip(tree_flatten_with_path(grads),
                                 tree_leaves(plain_grads)):
            big = float(pg.abs().max())
            ratio = float((g - pg).abs().max()) / max(big, 1e-30)
            if ratio > worst:
                worst, worst_at = ratio, path
        _require(worst <= 1e-4, f"train-ssm-check {arch}: gradient "
                 f"{worst_at} off by {worst:.3g} of its largest |value|")
        parts.append(f"{arch} layers={L} loss={float(loss):.6f} "
                     f"loss_rel_diff={loss_rel:.3e} (tol 1e-5) "
                     f"grad_max_rel_diff={worst:.3e} at {worst_at} "
                     f"(tol 1e-4) launches={launches} backward={backward}")
        del params, grads, plain_grads
        torch.cuda.empty_cache()
    print(f"train-ssm-check: full width f32 tf32=off batch={B} seq={S}: "
          + "; ".join(parts)
          + f" phase_s={time.perf_counter() - t_phase:.1f}", flush=True)


# the weights of an MLA block whose gradients must be nonzero
MLA_WEIGHTS = ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_train_mla(np, torch, kernels, dev, bwd_rows=None):
    """``make_train_step`` on deepseek-v3-671b at its published widths,
    ``TRAIN_MLA``: bf16, random weights from seed 0 made on the card after
    every earlier model is freed, batches of the placement-aware pipeline
    at B 4 and ``TRAIN``'s sequence, lr and steps, the step donating its
    parameters and state.  Finite losses and grad norms; exactly
    ``train_launches`` latent forward launches (all on the tensor-core
    ``wgmma`` instance, each backward reading the lse its forward stored)
    and backward calls (all on the tensor-core ``wgmma`` instance), no
    other model kernel;
    the plain versions swapped for functions that raise.  Then one step
    under torch.profiler (device idle share, device s by group) and, on
    the last batch, every layer's and the MTP block's MLA weight gradients
    nonzero.  The line gives the backward's device ms a call beside its
    bound at the step's shape and, when the kernels phase ran
    (``bwd_rows``), SDPA's backward at that shape, with the card."""
    import gc

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import loss_and_grads

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    run = _train_setup(torch, TRAIN_MLA["arch"], dev,
                       layers=TRAIN_MLA["layers"], batch=TRAIN_MLA["batch"],
                       donate=True)
    cfg, n = run["cfg"], TRAIN["steps"]
    fal = kernels["flash_attention_latent"]
    saved = _no_plain(flash_ops, ("flash_attention_latent_plain",
                                  "flash_attention_latent_lse_plain",
                                  "flash_attention_latent_bwd_plain"))
    try:
        losses, gnorms, walls, peak_gb = _train_steps(torch, kernels, run,
                                                      n)
        launches = _counts(kernels)
        backward = fal.backward_launches
        instances = dict(fal.instance_launches)
        bwd_instances = dict(fal.backward_instance_launches)
        lse_launches = fal.lse_launches
        want = train_launches(cfg, n)
        _require_launches("train-mla", launches, {
            "flash_attention_latent": want["forward"], "flash_attention": 0,
            "decode_attention": 0, "ssd_scan": 0,
            "decode_attention_latent": 0})
        _require(backward == want["backward"],
                 f"train-mla: {backward} latent backward calls, want "
                 f"{want['backward']}")
        _require(kernels["flash_attention"].backward_launches == 0
                 and kernels["ssd_scan"].backward_launches == 0,
                 "train-mla: flash_attention's or ssd_scan's backward "
                 "launched")
        _require(instances == {"wgmma": want["forward"], "fma": 0},
                 f"train-mla: flash_attention_latent instances {instances}, "
                 "want every forward on the tensor-core (wgmma) instance")
        _require(bwd_instances == {"wgmma": want["backward"], "fma": 0},
                 f"train-mla: backward instances {bwd_instances}, want "
                 "every call on the tensor-core (wgmma) instance")
        # every backward reads the lse of its (recomputed) forward
        _require(want["backward"] <= lse_launches <= want["forward"],
                 f"train-mla: {lse_launches} forward launches stored lse, "
                 f"want {want['backward']} to {want['forward']}")
        _require(all(math.isfinite(x) for x in losses + gnorms),
                 f"train-mla: non-finite losses {losses} or grad norms "
                 f"{gnorms}")
        batch, prof_wall, busy, by_group = _profiled_step(
            torch, run, (("mla_bwd", ("mla_bwd_",)),
                         ("mla_fwd", ("mla_attention",))))
        # every layer's and the MTP block's MLA weights get a gradient
        _, _, grads = loss_and_grads(cfg, run["params"], batch)
        blocks = [*enumerate(grads["blocks"]), ("mtp", grads["mtp"]["block"])]
        zero = [(i, w) for i, g in blocks for w in MLA_WEIGHTS
                if not bool(g["attn"][w].abs().amax() > 0)]
        _require(not zero, f"train-mla: zero gradients at (layer, weight) "
                 f"{zero}")
        del grads
    finally:
        for name, fn in saved.items():
            setattr(flash_ops, name, fn)
    a = cfg.mla
    per_call = by_group["mla_bwd"] * 1e3 / (backward // n)
    bound, _ = _latent_bwd_bound(run["batch"], run["seq"], cfg.num_heads, 2,
                                 BF16_OPS_PER_S)
    shape = f"train.B{run['batch']}.S{run['seq']}.H{cfg.num_heads}"
    sdpa = next((r["library_device_ms"] for r in bwd_rows or ()
                 if r["shape"].startswith(shape) and r["instance"] == "wgmma"),
                None)
    print(f"train-mla: {MLA_ARCH} layers={cfg.num_layers} (dense; "
          f"first_k_dense={cfg.moe.first_k_dense}) + mtp block "
          f"d_model={cfg.d_model} heads={cfg.num_heads} "
          f"q_lora={a.q_lora_rank} kv_lora={a.kv_lora_rank} "
          f"rope={a.qk_rope_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} held_before_gb={held_gb:.3f} "
          + _train_line(run, losses, gnorms, walls, peak_gb, prof_wall,
                        busy, by_group)
          + f" latent_per_step={launches['flash_attention_latent'] // n} "
          f"backward_per_step={backward // n} "
          f"lse_launches_per_step={lse_launches / n:g} "
          f"flash_attention_latent_instances={instances} "
          f"backward_instances={bwd_instances} "
          f"mla_bwd_device_ms_per_call={per_call:.4f} "
          f"mla_bwd_bound_ms={bound:.4f} "
          f"sdpa_bwd_device_ms={_fmt_ms(sdpa)} card={_card()!r} "
          f"mla_weight_grads=nonzero "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={**launches, "flash_attention_latent_bwd": backward},
                backward=backward, backward_instances=bwd_instances)


def phase_train_mla_check(np, torch, kernels, dev):
    """``TRAIN_MLA_CHECK``: deepseek-v3-671b at full width, 2 dense layers
    and the MTP group in f32 (TF32 off), ``loss_and_grads`` on the kernel
    route (the latent forward on its CUDA-core ``fma`` instance, the
    backward kernel's CUDA-core ``fma`` instance) against the plain route
    (``flash_attention_latent_plain`` under autograd) on the same batch:
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest |value|, exact launches on the kernel route, none on the plain
    route."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_latent_plain)
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention, init_params
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MLA_ARCH),
                              num_layers=TRAIN_MLA_CHECK["layers"],
                              dtype="float32")
    params = init_params(cfg, seed=1, device=dev)
    _require("mtp" in params and all("moe" not in b
                                     for b in params["blocks"]),
             "train-mla-check: want the dense MLA layers and the MTP group")
    rng = np.random.default_rng(17)
    B, S = TRAIN_MLA_CHECK["batch"], TRAIN_MLA_CHECK["seq"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).to(
        dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    fal = kernels["flash_attention_latent"]
    _zero_counts(kernels)
    loss, _, grads = loss_and_grads(cfg, params, batch)
    launches = _counts(kernels)
    backward = fal.backward_launches
    instances = dict(fal.instance_launches)
    bwd_instances = dict(fal.backward_instance_launches)
    want = train_launches(cfg, 1)
    _require(launches == {**{k: 0 for k in kernels},
                          "flash_attention_latent": want["forward"]}
             and backward == want["backward"]
             and instances == {"wgmma": 0, "fma": want["forward"]}
             and bwd_instances == {"wgmma": 0, "fma": want["backward"]},
             f"train-mla-check: kernel route launches {launches}, backward "
             f"{backward}, instances {instances}, backward instances "
             f"{bwd_instances}, want {want}")
    _zero_counts(kernels)
    saved = attention.flash_attention_latent
    try:
        attention.flash_attention_latent = flash_attention_latent_plain
        plain_loss, _, plain_grads = loss_and_grads(cfg, params, batch)
    finally:
        attention.flash_attention_latent = saved
    _require(all(v == 0 for v in _counts(kernels).values())
             and fal.backward_launches == 0,
             "train-mla-check: the plain route launched a kernel")
    loss_rel = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
    _require(loss_rel <= 1e-5, f"train-mla-check: loss {float(loss)} "
             f"against {float(plain_loss)} ({loss_rel:.3g} relative)")
    worst, worst_at = 0.0, None
    for (path, g), pg in zip(tree_flatten_with_path(grads),
                             tree_leaves(plain_grads)):
        big = float(pg.abs().max())
        ratio = float((g - pg).abs().max()) / max(big, 1e-30)
        if ratio > worst:
            worst, worst_at = ratio, path
    _require(worst <= 1e-4, f"train-mla-check: gradient {worst_at} off by "
             f"{worst:.3g} of its largest |value|")
    print(f"train-mla-check: {MLA_ARCH} full width, layers={cfg.num_layers} "
          f"(dense) + mtp block f32 tf32=off batch={B} seq={S} "
          f"loss={float(loss):.6f} loss_rel_diff={loss_rel:.3e} (tol 1e-5) "
          f"grad_max_rel_diff={worst:.3e} at {worst_at} (tol 1e-4) "
          f"launches={launches} backward={backward} "
          f"flash_attention_latent_instances={instances} "
          f"backward_instances={bwd_instances} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params, grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()


def _refusals(torch, dev):
    """Each model kernel without a backward (the two decode kernels, which
    serve only) raises NotImplementedError on CUDA inputs that require
    grad."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_latent)

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    calls = {
        "decode_attention": lambda x: decode_attention(
            x, t(1, 8, 1, 32), t(1, 8, 1, 32), t(1, 8, dtype=i32),
            t(1, dtype=i32)),
        "decode_attention_latent": lambda x: decode_attention_latent(
            x, t(1, 2, 64), t(1, 8, 512), t(1, 8, 64), t(1, 8, dtype=i32),
            t(1, dtype=i32), scale=0.1),
    }
    first = {"decode_attention": (1, 2, 32),
             "decode_attention_latent": (1, 2, 512)}
    for name, call in calls.items():
        x = t(*first[name]).requires_grad_(True)
        try:
            call(x)
        except NotImplementedError:
            continue
        raise AssertionError(f"train-check: {name} did not refuse a "
                             "gradient on the card")
    return sorted(calls)


def phase_train_check(np, torch, kernels, dev):
    """(a) olmo-1b at full width and ``TRAIN_CHECK["layers"]`` layers in
    f32 (TF32 off): ``loss_and_grads``, the train step's gradient, on the
    kernel route (flash forward on the fma instance and the backward
    kernel) against the plain route (``flash_attention_plain`` under
    autograd) on the same batch: loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest |value|, no launch on the plain route;
    then the kernels without a backward refuse a gradient.  (b) ``python
    -m repro_torch.launch.train`` with ``TRAIN_CLI`` on the card: exit 0,
    ``improved``, ``event@0: input_host_dead:0`` and a ``step_*``
    checkpoint."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention, init_params
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              num_layers=TRAIN_CHECK["layers"],
                              dtype="float32")
    params = init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(11)
    B, S = TRAIN_CHECK["batch"], TRAIN_CHECK["seq"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).to(
        dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    _zero_counts(kernels)
    loss, _, grads = loss_and_grads(cfg, params, batch)
    launches = _counts(kernels)
    backward = kernels["flash_attention"].backward_launches
    instances = dict(kernels["flash_attention"].instance_launches)
    bwd_instances = dict(kernels["flash_attention"].backward_instance_launches)
    L = cfg.num_layers
    _require(launches["flash_attention"] == 2 * L and backward == L
             and instances == {"wgmma": 0, "fma": 2 * L}
             and bwd_instances == {"wgmma": 0, "fma": L},
             f"train-check: kernel route launches {launches}, backward "
             f"{backward}, instances {instances}, backward instances "
             f"{bwd_instances}")
    _zero_counts(kernels)
    saved = attention.flash_attention
    try:
        attention.flash_attention = flash_attention_plain
        plain_loss, _, plain_grads = loss_and_grads(cfg, params, batch)
    finally:
        attention.flash_attention = saved
    _require(all(v == 0 for v in _counts(kernels).values())
             and kernels["flash_attention"].backward_launches == 0,
             "train-check: the plain route launched a kernel")
    loss_rel = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
    _require(loss_rel <= 1e-5, f"train-check: loss {float(loss)} against "
             f"{float(plain_loss)} ({loss_rel:.3g} relative)")
    worst, worst_at = 0.0, None
    for (path, g), pg in zip(tree_flatten_with_path(grads),
                             tree_leaves(plain_grads)):
        big = float(pg.abs().max())
        ratio = float((g - pg).abs().max()) / max(big, 1e-30)
        if ratio > worst:
            worst, worst_at = ratio, path
    _require(worst <= 1e-4, f"train-check: gradient {worst_at} off by "
             f"{worst:.3g} of its largest |value|")
    del params, grads, plain_grads
    torch.cuda.empty_cache()
    refused = _refusals(torch, dev)
    t_cli = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="train_check_")
    try:
        env = dict(os.environ, PYTHONPATH=str(SRC))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             "--ckpt-dir", ckpt], env=env, capture_output=True, text=True,
            timeout=300)
        saved_steps = sorted(d for d in os.listdir(ckpt)
                             if d.startswith("step_"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = proc.stdout
    _require(proc.returncode == 0 and "(improved)" in out
             and "event@0: input_host_dead:0" in out and saved_steps,
             f"train-check: the train CLI (rc {proc.returncode}, "
             f"checkpoints {saved_steps}):\n{out}\n{proc.stderr[-2000:]}")
    print(f"train-check: {TRAIN['arch']} full width, layers={L} f32 "
          f"tf32=off batch={B} seq={S} loss={float(loss):.6f} "
          f"loss_rel_diff={loss_rel:.3e} (tol 1e-5) "
          f"grad_max_rel_diff={worst:.3e} at {worst_at} (tol 1e-4) "
          f"launches={launches} backward={backward} "
          f"flash_attention_instances={instances} "
          f"backward_instances={bwd_instances} refused={refused}; "
          f"cli {' '.join(TRAIN_CLI)}: "
          + " | ".join(line.strip() for line in out.splitlines())
          + f" checkpoints={saved_steps} cli_s={time.perf_counter() - t_cli:.1f}"
          f" phase_s={time.perf_counter() - t_phase:.1f}", flush=True)


def _zero_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0
        for count in ("backward_launches", "lse_launches"):
            if hasattr(fn, count):
                setattr(fn, count, 0)
        for by in ("instance_launches", "backward_instance_launches"):
            for inst in getattr(fn, by, {}):
                getattr(fn, by)[inst] = 0
        getattr(fn, "class_launches", {}).clear()
        getattr(fn, "chunk_launches", {}).clear()


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _compare(np, dev_res, cpu_res, label):
    a, b = dev_res.summary(), cpu_res.summary()
    _require(set(a) == set(b), f"{label}: summary keys differ")
    diff = {k: (a[k], b[k]) for k in a if k not in BACKEND_KEYS and a[k] != b[k]}
    _require(not diff, f"{label}: summary differs from the CPU run: {diff}")
    _require(np.array_equal(dev_res.member, cpu_res.member),
             f"{label}: member matrix differs from the CPU run")
    _require(np.array_equal(dev_res.spans, cpu_res.spans),
             f"{label}: replay spans differ from the CPU run")


def _check_result(np, res, hg, label):
    _require(res.spans.shape == (hg.num_edges,), f"{label}: spans shape")
    _require(bool((res.spans >= 1).all()), f"{label}: a query has span 0")
    _require(math.isfinite(res.avg_span) and math.isfinite(res.energy_joules),
             f"{label}: non-finite result")


def phase_fit(np, torch, kernels, label, hg, n, capacity, max_moves,
              cpu_check):
    from repro_torch import flags
    from repro_torch.core import Simulator, lmbr, peel_counters

    from repro_torch.core import algorithms

    flags.set_variant("peeldevice+spandevice")
    peel0 = peel_counters()
    _zero_counts(kernels)
    # keep each dense-peel launch's peel tensor: its rounds are read after
    # the fit, so the fit itself does no extra device work or sync
    peels, peel_fn = [], algorithms.lockstep_peel

    def recording(inc, we, nodew, nvalid):
        out = peel_fn(inc, we, nodew, nvalid)
        peels.append(out[0])
        return out

    algorithms.lockstep_peel = recording
    try:
        t0 = time.perf_counter()
        res = Simulator(n, capacity, device="cuda").run(
            hg, lmbr, seed=0, max_moves=max_moves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        algorithms.lockstep_peel = peel_fn
    launches = _counts(kernels)
    peel_classes = dict(kernels["lockstep_peel"].class_launches)
    peel1 = peel_counters()
    flags.reset()
    _check_result(np, res, hg, label)
    for name, count in launches.items():
        _require(count > 0, f"{label}: kernel {name} never launched")
    _require(sum(peel_classes.values()) == launches["lockstep_peel"]
             == len(peels), f"{label}: peel launches by class do not add up")
    # the peel is a chain of rounds: each launch lasts as long as its
    # longest pair
    peel_rounds = sum(int((p >= 0).sum(dim=1).max()) for p in peels)
    del peels
    classes = ", ".join(f"K{k}.U{u}: {c}" for (k, u), c in sorted(
        peel_classes.items(), key=lambda kv: -kv[1]))
    line = (f"{label}: avg_span={res.avg_span:.4f} "
            f"placement_s={res.placement_seconds:.2f} wall_s={wall:.2f} "
            f"moves={res.placement_stats['moves']} launches={launches} "
            f"peel_pairs={ {k: peel1[k] - peel0[k] for k in peel0} } "
            f"peel_launches_by_class={{{classes}}} "
            f"peel_rounds={peel_rounds}")
    cpu_wall = None
    if cpu_check:
        t0 = time.perf_counter()
        cpu = Simulator(n, capacity, device="cpu").run(
            hg, lmbr, seed=0, max_moves=max_moves)
        cpu_wall = time.perf_counter() - t0
        _compare(np, res, cpu, label)
        line += (f" cpu_placement_s={cpu.placement_seconds:.2f} "
                 f"cpu_wall_s={cpu_wall:.2f} cpu_match=bitwise")
    print(line, flush=True)
    return dict(launches=launches, wall=wall, cpu_wall=cpu_wall,
                placement_s=res.placement_seconds, avg_span=res.avg_span,
                peel_rounds=peel_rounds)


def phase_profile(torch, label, hg, n, capacity, max_moves, peel_rounds):
    """The fit of ``phase_fit`` once more under torch.profiler and the
    package tracer: host-side split (HPA, LMBR move loop, replay), the
    device's busy time by kernel, lockstep_peel's device time per peel
    round (``peel_rounds`` from ``phase_fit``'s run of the same fit) and
    cover_rounds' device ms per launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import flags, obs
    from repro_torch.core import Simulator, lmbr

    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        Simulator(n, capacity, device="cuda").run(hg, lmbr, seed=0,
                                                  max_moves=max_moves)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {name: sum(e["dur"] for e in obs.tracer().spans(name)) / 1e6
            for name in ("fit.place", "fit.hpa", "fit.lmbr", "replay.cover")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"profile {label}: wall_s={wall:.3f} hpa_s={host['fit.hpa']:.3f} "
          f"lmbr_loop_s={host['fit.lmbr'] - host['fit.hpa']:.3f} "
          f"replay_s={host['replay.cover']:.3f} device_busy_s={busy:.4f} "
          f"device_idle_share={1 - busy / wall:.4f}"
          if rows else f"profile {label}: wall_s={wall:.3f} device time "
          "not measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    peel = [e for e in rows if "lockstep_peel" in e.key]
    if peel:
        peel_ms = sum(e.self_device_time_total for e in peel) / 1e3
        count = sum(e.count for e in peel)
        print(f"profile {label} lockstep_peel: device_ms={peel_ms:.3f} "
              f"count={count} device_ms_per_launch={peel_ms / count:.5f} "
              f"rounds={peel_rounds} device_us_per_round="
              + (f"{peel_ms * 1e3 / peel_rounds:.4f}" if peel_rounds
                 else "not_measured"), flush=True)
    _print_kernel_device_ms(rows, f"profile {label}", "cover_rounds")


def _paper_kernels_required(workload: str, name: str) -> set:
    """The kernels a paper-algos run must launch: span_gain in IHPA's and
    DS's residual rounds and in fig6's replay rounds, cover_rounds in
    fig9's whole buckets (at or above ``span_round_threshold`` words),
    lockstep_peel in LMBR.  PRA's only span work is the replay (its
    per-edge covers are host numpy, as in the reference), so at fig9 it
    launches cover_rounds alone."""
    need = set()
    if name in ("ihpa", "ds") or (name == "pra" and workload == "fig6"):
        need.add("span_gain")
    if workload.startswith("fig9"):
        need.add("cover_rounds")
    if name == "lmbr":
        need.add("lockstep_peel")
    return need


def phase_paper_algos(np, torch, kernels, graphs):
    """Every run of ``PAPER_RUNS`` on the card, each held bit for bit
    against the same call on the CPU and against the JAX package's
    avg_span.  Records each run's kernel launches and the (B, N, W) of
    every cover_rounds launch."""
    from repro_torch import flags
    from repro_torch.core import ALGORITHMS, Simulator, setcover

    rounds_fn = setcover.cover_rounds
    shapes = []

    def recording(codes, rem):
        if codes.shape[0]:
            shapes.append(tuple(codes.shape))
        return rounds_fn(codes, rem)

    runs = []
    for workload, n, cap, name, extra, want in PAPER_RUNS:
        hg = graphs[workload]
        label = f"paper-algos {workload} ({n}, {cap}) {name}"
        flags.set_variant("peeldevice+spandevice")
        _zero_counts(kernels)
        first = len(shapes)
        setcover.cover_rounds = recording
        try:
            t0 = time.perf_counter()
            res = Simulator(n, cap, device="cuda").run(
                hg, ALGORITHMS[name], name=name, seed=0, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            setcover.cover_rounds = rounds_fn
        launches = _counts(kernels)
        flags.reset()
        _check_result(np, res, hg, label)
        run_shapes = shapes[first:]
        _require(len(run_shapes) == launches["cover_rounds"],
                 f"{label}: cover_rounds shapes do not match its launches")
        for kernel in sorted(_paper_kernels_required(workload, name)):
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        t0 = time.perf_counter()
        cpu = Simulator(n, cap, device="cpu").run(
            hg, ALGORITHMS[name], name=name, seed=0, **extra)
        cpu_wall = time.perf_counter() - t0
        _compare(np, res, cpu, label)
        _require(res.avg_span == want,
                 f"{label}: avg_span {res.avg_span!r} is not the "
                 f"reference's {want!r}")
        counted = {}
        for shape in run_shapes:
            counted[shape] = counted.get(shape, 0) + 1
        print(f"{label}: avg_span={res.avg_span!r} reference={want!r} "
              f"placement_s={res.placement_seconds:.3f} wall_s={wall:.3f} "
              f"cpu_placement_s={cpu.placement_seconds:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"launches={launches} cover_rounds_shapes="
              + "{" + ", ".join(f"{b}x{n_}x{w}: {c}" for (b, n_, w), c
                                in sorted(counted.items())) + "}",
              flush=True)
        runs.append(dict(workload=workload, n=n, name=name,
                         launches=launches, wall=wall, cpu_wall=cpu_wall))
    return runs


def phase_paper_profile(torch, hg, n, capacity, name):
    """One paper-algos run once more under torch.profiler and the package
    tracer: host split (HPA, the algorithm's own loop, replay), the
    device's busy time, and span_gain's and cover_rounds' device ms per
    launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import flags, obs
    from repro_torch.core import ALGORITHMS, Simulator

    label = f"paper-algos {name} (n={hg.num_nodes}, {n}, {capacity})"
    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        Simulator(n, capacity, device="cuda").run(hg, ALGORITHMS[name],
                                                  name=name, seed=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("fit.place", "fit.hpa", "replay.cover")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    # the wall also holds the profiler's start; the fit and the replay are
    # what the traced spans time
    traced = host["fit.place"] + host["replay.cover"]
    print(f"profile {label}: wall_s={wall:.3f} hpa_s={host['fit.hpa']:.3f} "
          f"algorithm_loop_s={host['fit.place'] - host['fit.hpa']:.3f} "
          f"replay_s={host['replay.cover']:.3f} device_busy_s={busy:.4f} "
          f"device_idle_share={1 - busy / wall:.4f} "
          f"device_idle_share_of_fit_replay={1 - busy / traced:.4f}"
          if rows else f"profile {label}: wall_s={wall:.3f} device time "
          "not measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "cover_rounds"):
        _print_kernel_device_ms(rows, f"profile {label}", kernel)


def _sha256(data) -> str:
    import hashlib

    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha256(data).hexdigest()


def api_inputs(np):
    """The placement-api runs' inputs, made by the port's generators:
    fig8's TPC-H-heterogeneous workload at its largest N (2 000 items,
    4 000 queries, seeds 0 and 1), a 45-partition profile of 100 GB nodes,
    the refit's mask of partitions 3 and 17, fig. 6(f)-(h)'s 3-way paper
    point, DeepSeek-V3's routing trace and the shard recipes."""
    from repro_torch import core

    rng = np.random.default_rng(0)
    profile = core.NodeProfile(
        capacity=np.full(45, 100.0), fail_prob=rng.uniform(0.01, 0.1, 45),
        power_idle=100.0, power_active=300.0,
        access_cost=rng.uniform(0, 1, 45))
    mask = np.ones(45, dtype=bool)
    mask[[3, 17]] = False
    return dict(
        tpch=core.tpch_heterogeneous(num_items=2000, num_queries=4000,
                                     seed=0).queries,
        tpch1=core.tpch_heterogeneous(num_items=2000, num_queries=4000,
                                      seed=1).queries,
        profile=profile, mask=mask,
        fig6=core.random_workload(1000, 4000, 3, 11, 20,
                                  seed=0).hypergraph,
        trace=core.synthetic_routing_trace(256, 4096, top_k=8, seed=0),
        recipes=core.mixture_batch_recipes(1000, 2000, seed=0),
    )


def api_run(np, name, inp, device, state):
    """One placement-api run on ``device`` through the port's entry
    points; returns the values it holds.  ``state`` carries the fitted
    plan from service-fit to service-refit and each run's results."""
    from repro_torch import core, flags

    svc = core.PlacementService("lmbr", seed=0, device=device)
    if name == "service-fit":
        plan = svc.fit(inp["tpch"], 2000, 45, profile=inp["profile"],
                       durability_eps=0.05)
        state["plan"] = plan
        flags.set_variant("spanrounddevice")
        return dict(json_sha256=_sha256(plan.to_json()),
                    durability_copies=plan.stats["durability_copies"],
                    avg_span=plan.avg_span(inp["tpch"]))
    if name == "service-refit":
        old = state["plan"]
        new = svc.refit(old, inp["tpch1"], max_moves=64,
                        dest_mask=inp["mask"], profile=inp["profile"])
        added = new.member & ~old.member
        _require(not added[~inp["mask"]].any(),
                 "service-refit: a copy landed on a masked partition")
        _require(bool((new.member | ~old.member).all()),
                 "service-refit: the old plan is not inside the new one")
        return dict(json_sha256=_sha256(new.to_json()),
                    copies_added=int(added.sum()),
                    avg_span_before=old.avg_span(inp["tpch1"]),
                    avg_span_after=new.avg_span(inp["tpch1"]))
    if name == "service-hier":
        plan = svc.fit_hierarchical(inp["tpch"], 2000, num_pods=4,
                                    hosts_per_pod=10, host_capacity=100.0)
        spans = np.array([plan.spans(q) for q in inp["tpch"]])
        weighted = [plan.weighted_span(q) for q in inp["tpch"]]
        return dict(host_member_sha256=_sha256(plan.host_member.tobytes()),
                    mean_pod_span=float(spans[:, 0].mean()),
                    mean_host_span=float(spans[:, 1].mean()),
                    mean_weighted_span=float(np.mean(weighted)))
    if name == "three-way":
        hg = inp["fig6"]
        n = 3 * core.min_partitions(hg, 50)
        res = core.Simulator(n, 50, device=device).compare(
            hg, core.THREE_WAY_ALGORITHMS, seed=0)
        state["three-way"] = res
        return {algo: dict(avg_span=r.avg_span,
                           member_sha256=_sha256(r.member.tobytes()))
                for algo, r in res.items()}
    if name == "experts":
        trace = inp["trace"]
        plan = core.plan_expert_placement(trace, 256, 32, slots_per_rank=9,
                                          algorithm="lmbr", seed=0,
                                          device=device)
        base = core.baseline_contiguous_placement(256, 32, 9)
        return dict(member_sha256=_sha256(plan.member.tobytes()),
                    tables_sha256=_sha256(plan.slot_to_expert.tobytes()
                                          + plan.expert_slot_table.tobytes()),
                    avg_span=plan.avg_span(trace),
                    baseline_avg_span=base.avg_span(trace))
    if name == "shards":
        recipes = inp["recipes"]
        plan = core.plan_shard_placement(recipes, 1000, 48, capacity=80,
                                         algorithm="pra3", device=device)
        # the plan's spans once more through the span engine on ``device``
        spans = core.spans_for_workload(
            core.Hypergraph.from_edges(recipes, num_nodes=1000),
            core.Placement.from_member(plan.member, 80.0), device=device)
        _require(float(spans.mean()) == plan.avg_span(recipes),
                 "shards: the engine's spans differ from the plan's")
        return dict(member_sha256=_sha256(plan.member.tobytes()),
                    survives_2_failures=plan.survives_failures(2),
                    avg_span=float(spans.mean()))
    raise ValueError(f"unknown placement-api run {name!r}")


def phase_placement_api(np, torch, kernels, inp):
    """Every run of ``API_RUNS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its
    own memo) and against ``API_HELD``; each must launch the kernels
    ``API_RUNS`` names."""
    from repro_torch import core, flags

    dev_state, cpu_state, runs = {}, {}, []
    for name, (variant, need) in API_RUNS.items():
        label = f"placement-api {name}"
        flags.set_variant(variant)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held = api_run(np, name, inp, "cuda", dev_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.set_variant(variant)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            cpu_held = api_run(np, name, inp, "cpu", cpu_state)
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == API_HELD[name],
                 f"{label}: {held} is not the reference's {API_HELD[name]}")
        if name == "three-way":
            for algo in held:
                _compare(np, dev_state[name][algo], cpu_state[name][algo],
                         f"{label} {algo}")
        for kernel, least in need.items():
            _require(launches[kernel] >= least,
                     f"{label}: kernel {kernel} launched {launches[kernel]} "
                     f"times, fewer than {least}")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
    return runs


def phase_api_profile(torch, inp):
    """service-fit once more under torch.profiler and the package tracer:
    host split (HPA, the LMBR move loop, the durability pass, the plan's
    spans), the device's busy time and each placement kernel's device ms
    per launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs
    from repro_torch.core import placement_service

    timed = {"durability": 0.0}
    originals = (placement_service.ensure_durability,
                 placement_service.validate_durability)

    def clocked(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timed["durability"] += time.perf_counter() - t
        return run

    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    placement_service.ensure_durability = clocked(originals[0])
    placement_service.validate_durability = clocked(originals[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            with core.fresh_partition_cache():
                plan = core.PlacementService("lmbr", seed=0).fit(
                    inp["tpch"], 2000, 45, profile=inp["profile"],
                    durability_eps=0.05)
            torch.cuda.synchronize()
            fit_wall = time.perf_counter() - t1
            flags.FLAGS["span_round_backend"] = "device"
            t1 = time.perf_counter()
            plan.avg_span(inp["tpch"])
            torch.cuda.synchronize()
            spans_s = time.perf_counter() - t1
    finally:
        (placement_service.ensure_durability,
         placement_service.validate_durability) = originals
    wall = time.perf_counter() - t0
    host = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("service.fit", "fit.hpa", "fit.lmbr")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    label = "profile placement-api service-fit"
    # the wall also holds the profiler's start and teardown; the fit and
    # the spans are what the host clock and the traced spans time
    print(f"{label}: wall_s={wall:.3f} fit_wall_s={fit_wall:.3f} "
          f"algorithm_s={host['service.fit']:.3f} "
          f"hpa_s={host['fit.hpa']:.3f} "
          f"lmbr_loop_s={host['fit.lmbr'] - host['fit.hpa']:.3f} "
          f"durability_s={timed['durability']:.3f} spans_s={spans_s:.3f} "
          f"device_busy_s={busy:.4f} device_idle_share={1 - busy / wall:.4f} "
          f"device_idle_share_of_fit_spans="
          f"{1 - busy / (fit_wall + spans_s):.4f}"
          if rows else f"{label}: wall_s={wall:.3f} device time not "
          "measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


# ------------------------------------------------------------------ online
def online_inputs(np):
    """The online runs' inputs, made by the port's generators: the
    lmbr-stress trace (2 500 items, 10 000 queries), fig6's paper default
    (``random_workload(1000, 4000, 3, 11, 20, seed=0)``), the drift splice
    (its first 2 000 queries, then the 4 000 of seed 7) and the seed-1
    queries the refit-migration run adapts to."""
    from repro_torch import core

    fig6 = core.random_workload(1000, 4000, 3, 11, 20, seed=0).hypergraph
    new = core.random_workload(1000, 4000, 3, 11, 20, seed=7).hypergraph
    splice = core.Hypergraph.from_edges(
        [fig6.edge(e) for e in range(2000)]
        + [new.edge(e) for e in range(new.num_edges)], num_nodes=1000)
    return dict(
        stress=core.lmbr_stress_workload(seed=0).hypergraph,
        fig6=fig6, splice=splice,
        seed1=core.random_workload(1000, 4000, 3, 11, 20, seed=1).queries,
    )


def online_held(np, res):
    """What an online run holds: its summary without the wall and backend
    keys, and the sha256s of its served spans and its final member."""
    held = {k: v for k, v in res.summary().items()
            if k not in BACKEND_KEYS}
    held.update(spans_sha256=_sha256(res.spans.tobytes()),
                member_sha256=_sha256(res.member.tobytes()))
    return held


def _routed(np, router, hg):
    """The router's held values after routing all of ``hg``."""
    batch = router.route_csr(hg.edge_ptr, hg.edge_nodes)
    return batch, dict(
        cover_sha256=_sha256(batch.spans.tobytes()
                             + batch.cover_parts.tobytes()
                             + batch.pin_parts.tobytes()),
        ledger_sha256=_sha256(router.load.tobytes()),
        avg_span=float(batch.spans.mean()),
        load_imbalance=router.load_imbalance(),
        microbatches=router.stats["microbatches"])


def online_run(np, name, inp, device, state):
    """One online run on ``device`` through the port's entry points;
    returns the values it holds.  ``state`` keeps the router run's layout
    for the throughput rows and each run's result."""
    from repro_torch import core, flags
    from repro_torch.online import ReplicaRouter

    variant = ONLINE_RUNS[name][0]
    if name == "router":
        hg = inp["stress"]
        pl = core.ALGORITHMS["random"](hg, 64, 50, seed=0, device=device)
        state["router_member"] = pl.member
        batch, default = _routed(np, ReplicaRouter(pl.member, device=device),
                                 hg)
        for e in range(0, hg.num_edges, 97):
            chosen, accessed = core.cover_for_query(hg.edge(e), pl.member)
            _require(batch.chosen(e).tolist() == chosen
                     and [x.tolist() for x in batch.cover(e).values()]
                     == [x.tolist() for x in accessed],
                     f"online router: query {e} differs from "
                     "cover_for_query")
        flags.set_variant(variant + "+routerbal1")
        _, balanced = _routed(np, ReplicaRouter(pl.member, device=device), hg)
        flags.set_variant(variant)
        return dict(default=default, balanced=balanced)
    sim = core.Simulator(40, 50, device=device)
    lmbr = core.ALGORITHMS["lmbr"]
    if name == "drift":
        res = sim.run_online(
            inp["fig6"], lmbr, name="lmbr+drift", trace=inp["splice"],
            service=core.PlacementService("lmbr", seed=0, device=device),
            refit_moves=400, seed=0, max_moves=120)
    elif name == "failover":
        res = sim.run_online(
            inp["fig6"], lmbr, name="lmbr", seed=0, max_moves=120,
            repair_k=1, events=ONLINE_EVENTS["failover"])
        _require(bool((res.loads <= 50 + 1e-9).all()),
                 "online failover: a load is over capacity")
    elif name == "migration":
        target = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120,
                      device=device)
        events = [(at, kind, target if kind == "migrate" else arg)
                  for at, kind, arg in ONLINE_EVENTS["migration"]]
        res = sim.run_online(inp["fig6"], core.ALGORITHMS["random"],
                             name="random", seed=0, events=events)
        _require(bool((res.loads <= 50 * 1.10 + 1e-9).all()),
                 "online migration: a load is over the headroom bound")
    elif name == "refit-migration":
        # the fit the other runs make: a service fit fills the space that
        # LMBR can use, and a refit of it adds no copy
        pl = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120, device=device)
        plan = core.PlacementPlan(pl.member, 50, pl.node_weights, "lmbr",
                                  device=device)
        svc = core.PlacementService("lmbr", seed=0, device=device)
        mp = svc.refit(plan, inp["seed1"], max_moves=64, as_migration=True)
        _require(mp.num_drops == 0,
                 "online refit-migration: a warm-started refit dropped "
                 "a replica")
        _require(bool((mp.apply(plan.member.copy())
                       == mp.target.member).all()),
                 "online refit-migration: the schedule does not land on "
                 "its target")
        return dict(json_sha256=_sha256(mp.to_json()),
                    copies=mp.num_copies, drops=mp.num_drops,
                    avg_span_before=plan.avg_span(inp["seed1"]),
                    avg_span_after=mp.target.avg_span(inp["seed1"]))
    else:
        raise ValueError(f"unknown online run {name!r}")
    state[name] = res
    return online_held(np, res)


class _DispatchCount:
    """Counts the kernel wrapper calls that the span engine and LMBR make
    (each one a launch on the card), by patching the wrappers where the
    engine calls them; used on the CPU twin, whose wrappers run the plain
    versions."""

    def __init__(self):
        from repro_torch.core import algorithms, setcover

        self.sites = ((setcover, "span_gains", "span_gain",
                       lambda c, r: c.shape[0] * c.shape[1] > 0),
                      (setcover, "cover_rounds", "cover_rounds",
                       lambda c, r: c.shape[0] > 0),
                      (algorithms, "lockstep_peel", "lockstep_peel",
                       lambda inc, *_: inc.shape[0] * inc.shape[2] > 0))
        self.counts = {kernel: 0 for _, _, kernel, _ in self.sites}

    def __enter__(self):
        self.saved = []
        for module, attr, kernel, nonempty in self.sites:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def counted(*args, _fn=fn, _kernel=kernel, _nonempty=nonempty):
                if _nonempty(*args):
                    self.counts[_kernel] += 1
                return _fn(*args)
            setattr(module, attr, counted)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)
        return False


def phase_online(np, torch, kernels, inp):
    """Every run of ``ONLINE_RUNS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its own
    memo) and against ``ONLINE_HELD``.  Each run must launch every kernel
    that it names, as many times as the CPU twin's dispatch called the
    kernel's wrapper."""
    from repro_torch import core, flags

    dev_state, cpu_state, runs = {}, {}, []
    for name, (variant, need) in ONLINE_RUNS.items():
        label = f"online {name}"
        flags.set_variant(variant)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held = online_run(np, name, inp, "cuda", dev_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.set_variant(variant)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            cpu_held = online_run(np, name, inp, "cpu", cpu_state)
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == ONLINE_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{ONLINE_HELD[name]}")
        if name in dev_state:
            _compare(np, dev_state[name], cpu_state[name], label)
        _require(launches == dispatch.counts,
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {dispatch.counts}")
        for kernel in need:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches} "
              f"cpu_dispatch={dispatch.counts}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
        if name == "router":
            _router_throughput(torch, inp["stress"],
                               dev_state["router_member"])
    return runs


def _router_throughput(torch, hg, member):
    """Queries/s of the default router over the whole lmbr-stress trace,
    best of three, on the card with the kernels pinned, on the card under
    ``auto`` (the host loop at this microbatch) and on the CPU."""
    from repro_torch import flags
    from repro_torch.online import ReplicaRouter

    for label, variant, device in (
            ("card spandevice+spanrounddevice", "spandevice+spanrounddevice",
             "cuda"),
            ("card auto", "baseline", "cuda"),
            ("cpu auto", "baseline", "cpu")):
        flags.set_variant(variant)
        router = ReplicaRouter(member, device=device)
        router.route_csr(hg.edge_ptr, hg.edge_nodes)
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.route_csr(hg.edge_ptr, hg.edge_nodes)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        flags.reset()
        print(f"online router throughput {label}: "
              f"queries_per_s={hg.num_edges / best:.1f} "
              f"wall_s={best:.4f}", flush=True)


def phase_online_profile(torch, inp):
    """The drift run once more under torch.profiler and the package
    tracer: the fit, the routing (every microbatch), the refits and the
    rest, the device's busy time and each placement kernel's device ms per
    launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs

    flags.set_variant(ONLINE_RUNS["drift"][0] + "+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            core.Simulator(40, 50).run_online(
                inp["fig6"], core.ALGORITHMS["lmbr"], name="lmbr+drift",
                trace=inp["splice"],
                service=core.PlacementService("lmbr", seed=0),
                refit_moves=400, seed=0, max_moves=120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    part = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("fit.place", "serve.microbatch", "drift.refit")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    rest = wall - sum(part.values())
    label = "profile online drift"
    print(f"{label}: wall_s={wall:.3f} fit_s={part['fit.place']:.3f} "
          f"routing_s={part['serve.microbatch']:.3f} "
          f"refits_s={part['drift.refit']:.3f} rest_s={rest:.3f} "
          + (f"device_busy_s={busy:.4f} "
             f"device_idle_share={1 - busy / wall:.4f}" if rows else
             "device time not measured (the profiler saw no device "
             "activity)"), flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


def _print_kernel_device_ms(rows, label: str, kernel: str) -> None:
    """One kernel's device ms in all and per launch, from the profiler's
    device rows of a profiled run."""
    hits = [e for e in rows if kernel in e.key]
    if hits:
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        count = sum(e.count for e in hits)
        print(f"{label} {kernel}: device_ms={ms:.4f} count={count} "
              f"device_ms_per_launch={ms / count:.5f}", flush=True)
    else:
        print(f"{label} {kernel}: not measured (no launch under the "
              "profiler)", flush=True)


# ------------------------------------------------------------------ health
def health_inputs(np):
    """The health runs' input, made by the port's generator: fig6's paper
    default (``random_workload(1000, 4000, 3, 11, 20, seed=0)``)."""
    from repro_torch import core

    return dict(fig6=core.random_workload(1000, 4000, 3, 11, 20,
                                          seed=0).hypergraph)


def health_run(np, name, inp, device, monitored=True):
    """One health run on ``device``: the storm or the clean replay served
    under the flags-built monitor (or under no monitor); returns the held
    values (``online_held`` and, monitored, the monitor's transitions as
    [alert, kind, t]) and the result."""
    from repro_torch import core, flags, obs

    flags.set_variant(HEALTH_VARIANT if monitored else HEALTH_OFF_VARIANT)
    obs.reset()
    monitor = obs.HealthMonitor.from_flags() if monitored else None
    res = core.Simulator(40, 50, device=device).run_online(
        inp["fig6"], core.ALGORITHMS["lmbr"], name="lmbr", seed=0,
        max_moves=120, events=list(HEALTH_EVENTS[name]), auto_repair=False,
        health=monitor)
    obs.reset()
    held = online_held(np, res)
    if monitor is not None:
        held["history"] = [[h["alert"], h["kind"], h["t"]]
                           for h in monitor.history]
    return held, res


def phase_health(np, torch, kernels, inp):
    """Every run of ``HEALTH_EVENTS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its own
    memo) and against ``HEALTH_HELD``; launches as the CPU twin's dispatch
    calls the wrappers.  The storm runs once more on the card with no
    monitor and must serve the same spans, access load and member:
    observation changes nothing."""
    from repro_torch import core, flags

    runs = []
    for name in HEALTH_EVENTS:
        label = f"health {name}"
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held, res = health_run(np, name, inp, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            cpu_held, cpu_res = health_run(np, name, inp, "cpu")
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == HEALTH_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{HEALTH_HELD[name]}")
        _compare(np, res, cpu_res, label)
        _require(launches == dispatch.counts,
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {dispatch.counts}")
        for kernel in HEALTH_KERNELS:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        line = ""
        if HEALTH_EVENTS[name]:
            _require(held["alerts_fired"] > 0 and held["alerts_resolved"] > 0,
                     f"{label}: the storm fired or resolved no alert")
            with core.fresh_partition_cache():
                _, off = health_run(np, name, inp, "cuda", monitored=False)
            flags.reset()
            _require(np.array_equal(off.spans, res.spans)
                     and np.array_equal(off.access_load, res.access_load)
                     and np.array_equal(off.member, res.member),
                     f"{label}: the monitor changed what was served")
            line = " unmonitored_match=spans,access_load,member"
        else:
            _require(held["alerts_fired"] == 0 and not held["history"],
                     f"{label}: the clean replay fired an alert")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches} "
              f"cpu_dispatch={dispatch.counts}{line}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
    return runs


# ------------------------------------------------------------------- scale
def scale_inputs(np):
    """The sharded fits' workloads, streamed by the port's generator."""
    from repro_torch import core

    return {name: core.web_scale_workload(**kw).hypergraph
            for name, (kw, _, _, _) in SCALE_FITS.items()}


def _csr_held(hg) -> dict:
    return dict(edges=hg.num_edges, pins=hg.num_pins,
                csr_sha256=_sha256(hg.edge_ptr.tobytes()
                                   + hg.edge_nodes.tobytes()
                                   + hg.edge_weights.tobytes()))


def scale_service_profile(np):
    """web-mid's partitions as a profile: capacity 210, fail probabilities
    and access costs from seed 0, so that the durability pass at
    ``SCALE_SERVICE_EPS`` copies the items held only where p > eps."""
    from repro_torch import core

    rng = np.random.default_rng(0)
    return core.NodeProfile(
        capacity=np.full(24, 210.0), fail_prob=rng.uniform(0.005, 0.05, 24),
        power_idle=100.0, power_active=250.0,
        access_cost=rng.uniform(0, 1, 24))


def sharded_fit(name, inp, device, workers):
    """``fit_sharded_placement`` of one of ``SCALE_FITS`` on ``device``."""
    from repro_torch.scale import fit_sharded_placement

    _, n, cap, kw = SCALE_FITS[name]
    return fit_sharded_placement(inp[name], n, cap, seed=0, workers=workers,
                                 device=device, **kw)


def scale_run(np, name, inp, device):
    """One scale run on ``device`` through the port's entry points (the
    fits serial); returns the values it holds and the pipeline stats."""
    from repro_torch import core
    from repro_torch.scale import StreamingHypergraphBuilder

    if name == "stream":
        held = {}
        for mode, merge in (("plain", False), ("merged", True)):
            builder = StreamingHypergraphBuilder(
                core.WEB_SCALE_DEFAULTS["num_items"], merge_duplicates=merge)
            for ptr, pins in core.web_scale_chunks(seed=0):
                builder.add_csr(ptr, pins)
            held[mode] = _csr_held(builder.build())
        return held, None
    if name == "service":
        _, n, _, kw = SCALE_FITS["web-mid"]
        service = core.PlacementService("lmbr", seed=0, device=device)
        plan = service.fit_sharded(
            inp["web-mid"], n, profile=scale_service_profile(np), workers=1,
            durability_eps=SCALE_SERVICE_EPS, **kw)
        return dict(json_sha256=_sha256(plan.to_json()),
                    algorithm=plan.algorithm,
                    durability_copies=plan.stats["durability_copies"],
                    **{k: plan.stats[k] for k in SCALE_STATS}), plan.stats
    res = sharded_fit(name, inp, device, 1)
    held = {k: res.stats[k] for k in SCALE_STATS}
    held.update(member_sha256=_sha256(res.member.tobytes()),
                avg_span=float(core.spans_for_workload(
                    inp[name], res.placement, device=device).mean()))
    return held, res.stats


def scale_twins(np, inp) -> dict:
    """The CPU twins of the scale runs, each inside its own partition memo
    under ``SCALE_VARIANT``, counting the dispatch; those of
    ``SCALE_DISPATCH`` as recorded (no wall)."""
    from repro_torch import core, flags

    out = {}
    for name in SCALE_RUNS:
        if name in SCALE_DISPATCH:
            out[name] = dict(held=SCALE_HELD[name], wall=None,
                             dispatch=SCALE_DISPATCH[name])
            continue
        flags.set_variant(SCALE_VARIANT)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            held, _ = scale_run(np, name, inp, "cpu")
        out[name] = dict(held=held, wall=time.perf_counter() - t0,
                         dispatch=dispatch.counts)
        flags.reset()
    return out


def phase_scale(np, torch, kernels, inp):
    """Every run of ``SCALE_RUNS`` on the card, each inside its own
    partition memo, held against its CPU twin (``scale_twins``, run after
    the card runs so that these have the host to themselves; recorded for
    ``SCALE_DISPATCH``) and against ``SCALE_HELD``, with launches as the
    twin's dispatch calls the wrappers.  ``stream`` is host numpy and
    launches nothing.  Then the fits of ``SCALE_POOLED`` once more with
    their shards on spawned card workers: the pool must have run and the
    member must equal the serial run's.  The pooled runs' launches are the parent's (the repair); the
    workers' own are not counted."""
    import os

    from repro_torch import core, flags

    card = {}
    for name in SCALE_RUNS:
        flags.set_variant(SCALE_VARIANT)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held, stats = scale_run(np, name, inp, "cuda")
        torch.cuda.synchronize()
        card[name] = dict(
            held=held, stats=stats, launches=_counts(kernels),
            peel_classes=dict(kernels["lockstep_peel"].class_launches),
            wall=time.perf_counter() - t0)
        flags.reset()
    twins = scale_twins(np, inp)
    runs = []
    for name, need in SCALE_RUNS.items():
        label = f"scale {name}"
        held, launches = card[name]["held"], card[name]["launches"]
        twin = twins[name]
        _require(held == twin["held"],
                 f"{label}: {held} differs from the CPU run's {twin['held']}")
        _require(held == SCALE_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{SCALE_HELD[name]}")
        _require(launches == twin["dispatch"],
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {twin['dispatch']}")
        for kernel in need:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        stats = card[name]["stats"] or {}
        seconds = {k: stats[k] for k in SCALE_SECONDS if k in stats}
        classes = ", ".join(f"K{k}.U{u}: {c}" for (k, u), c in sorted(
            card[name]["peel_classes"].items(), key=lambda kv: -kv[1]))
        cpu = ("cpu_twin=recorded" if twin["wall"] is None else
               f"cpu_wall_s={twin['wall']:.3f} cpu_match=bitwise")
        print(f"{label}: {json.dumps(held)} wall_s={card[name]['wall']:.3f} "
              f"{cpu} reference_match=exact launches={launches} "
              f"cpu_dispatch={twin['dispatch']}"
              + (f" stage_s={json.dumps(seconds)}" if seconds else "")
              + (f" peel_launches_by_class={{{classes}}}" if classes
                 else ""), flush=True)
        runs.append(dict(name=name, launches=launches,
                         wall=card[name]["wall"],
                         cpu_wall=twin["wall"]))
    for name, workers in SCALE_POOLED.items():
        if workers is None:
            workers = max(2, min(8, os.cpu_count() or 1))
        label = f"scale {name} pooled"
        flags.set_variant(SCALE_VARIANT)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            res = sharded_fit(name, inp, "cuda", workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.reset()
        _require(res.stats["used_pool"] is True and
                 res.stats["workers"] == workers,
                 f"{label}: the shard fits did not run on {workers} "
                 f"spawned workers: {res.stats}")
        _require(_sha256(res.member.tobytes())
                 == SCALE_HELD[name]["member_sha256"],
                 f"{label}: the member differs from the serial run's")
        _require({k: res.stats[k] for k in SCALE_STATS}
                 == {k: card[name]["stats"][k] for k in SCALE_STATS},
                 f"{label}: stats differ from the serial run's")
        print(f"{label}: workers={workers} used_pool=True "
              f"wall_s={wall:.3f} serial_wall_s={card[name]['wall']:.3f} "
              f"member_match=serial parent_launches={launches} stage_s="
              f"{json.dumps({k: res.stats[k] for k in SCALE_SECONDS})}",
              flush=True)
    return runs


def phase_scale_profile(torch, inp):
    """fit-quick's serial fit once more under torch.profiler and the
    package tracer: the pipeline's stages (``scale.shard``, ``scale.fit``,
    ``scale.merge``, ``scale.repair``), the device's busy time and idle
    share, and each placement kernel's device ms per launch.  Numbers are
    under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs

    flags.set_variant(SCALE_VARIANT + "+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            sharded_fit("fit-quick", inp, "cuda", 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
              for key in ("scale.shard", "scale.fit", "scale.merge",
                          "scale.repair")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    label = "profile scale fit-quick"
    print(f"{label}: wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in stages.items()) + " "
          + (f"device_busy_s={busy:.4f} "
             f"device_idle_share={1 - busy / wall:.4f}" if rows else
             "device time not measured (the profiler saw no device "
             "activity)"), flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each fit phase and the serve phase, run "
                    "it once more under torch.profiler and print where the "
                    "time goes")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: package sources not found under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import _build
    from repro_torch.core import (ispd_like_workload, lmbr_stress_workload,
                                  random_workload)
    from repro_torch.core import LMBR_STRESS_DEFAULTS as STRESS
    from repro_torch.kernels.cover_rounds.ops import cover_rounds
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_latent)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_latent)
    from repro_torch.kernels.lockstep_peel.ops import lockstep_peel
    from repro_torch.kernels.span_gain.ops import span_gains
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    fit_kernels = {"span_gain": span_gains, "cover_rounds": cover_rounds,
                   "lockstep_peel": lockstep_peel}
    model_kernels = {"flash_attention": flash_attention,
                     "decode_attention": decode_attention,
                     "ssd_scan": ssd_scan,
                     "flash_attention_latent": flash_attention_latent,
                     "decode_attention_latent": decode_attention_latent}
    latent = ("flash_attention_latent", "decode_attention_latent")
    kernels = {**fit_kernels, **model_kernels}
    rows = {}
    launches = {}
    path_launches = {}   # phase -> kernel -> launches on that path
    ssd_chunks = {}      # phase -> ssd_scan launches by the chunk run
    flash_instances = latent_instances = decode_instances = None
    bwd_instances = latent_bwd_instances = None
    ssd_built = ssd_bwd_built = att_built = None
    if "build" in phases:
        ssd_built, ssd_bwd_built, att_built = phase_build(_build)
    if "kernels" in phases:
        rows = phase_kernels(np, torch, dev)
        rows.update(phase_model_kernels(np, torch, dev))
        if ssd_built is not None:
            # every ssd_scan instance the build made ran in a checked row,
            # the backward's included
            for name, built in (("ssd_scan", ssd_built),
                                ("ssd_scan_bwd", ssd_bwd_built)):
                ran = {r["instance"] for r in rows[name]["shapes"]}
                missed = sorted(f"{d}.P{p}" for _, d, p in built
                                if d is not None and f"{d}.P{p}" not in ran)
                _require(not missed, f"kernels: no {name} row ran {missed}")
            # ... and every flash and every decode instance
            ran = {(name, r["kernel_instance"]) for name in
                   ("flash_attention", "decode_attention")
                   for r in rows[name]["shapes"]}
            built = {(f"{kind}_attention",
                      f"{d}.{'D' if kind == 'flash' else 'G'}{n}")
                     for kind, d, n in att_built}
            missed = sorted(built - ran)
            _require(not missed, f"kernels: no row ran {missed}")
            # ... and both instances of the latent backward (the build
            # made every pass of each)
            ran = {r["instance"]
                   for r in rows["flash_attention_latent_bwd"]["shapes"]}
            missed = sorted(set(MLA_BWD_PASSES) - ran)
            _require(not missed, f"kernels: no flash_attention_latent_bwd "
                     f"row ran {missed}")
            # the wrapper's head groups are the C side's
            from repro_torch.kernels.decode_attention.ops import (
                MAX_GROUP, head_groups)
            _require(all(head_groups(g)
                         == _build.lib().decode_attention_head_groups(g)
                         for g in range(1, MAX_GROUP + 1)),
                     "kernels: decode head groups differ from the source")
    if "fit-stress" in phases:
        hg = lmbr_stress_workload(seed=0).hypergraph
        stress = phase_fit(np, torch, fit_kernels, "fit-stress", hg,
                           STRESS["num_partitions"], STRESS["capacity"],
                           STRESS["max_moves"], cpu_check=True)
        launches.update(stress["launches"])
        path_launches["fit-stress"] = stress["launches"]
        if args.profile:
            phase_profile(torch, "fit-stress", hg, STRESS["num_partitions"],
                          STRESS["capacity"], STRESS["max_moves"],
                          stress["peel_rounds"])
    if "fit-paper" in phases:
        n_nodes = PAPER_NODES
        hg = ispd_like_workload(num_nodes=n_nodes, seed=9).hypergraph
        label = f"fit-paper(n={n_nodes})"
        cap = int(math.ceil(n_nodes / 20))
        paper = phase_fit(np, torch, fit_kernels, label, hg, 35, cap, 600,
                          cpu_check=True)
        path_launches["fit-paper"] = paper["launches"]
        if args.profile:
            phase_profile(torch, label, hg, 35, cap, 600,
                          paper["peel_rounds"])
    if "paper-algos" in phases:
        makers = {"random_workload": random_workload,
                  "ispd_like_workload": ispd_like_workload}
        graphs = {key: makers[fn](**kw).hypergraph
                  for key, (fn, kw) in PAPER_WORKLOADS.items()}
        algo_runs = phase_paper_algos(np, torch, fit_kernels, graphs)
        path_launches["paper-algos"] = {
            name: sum(r["launches"][name] for r in algo_runs)
            for name in fit_kernels}
        if args.profile:
            phase_paper_profile(torch, graphs["fig9-ibm01"], 35, 638, "ihpa")
    if "placement-api" in phases:
        inp = api_inputs(np)
        api_runs = phase_placement_api(np, torch, fit_kernels, inp)
        path_launches["placement-api"] = {
            name: sum(r["launches"][name] for r in api_runs)
            for name in fit_kernels}
        if args.profile:
            phase_api_profile(torch, inp)
    if "online" in phases:
        inp = online_inputs(np)
        online_runs = phase_online(np, torch, fit_kernels, inp)
        path_launches["online"] = {
            name: sum(r["launches"][name] for r in online_runs)
            for name in fit_kernels}
        if args.profile:
            phase_online_profile(torch, inp)
    if "serve" in phases:
        served = phase_serve(torch, kernels, dev)
        launches.update({n: served["launches"][n] for n in model_kernels
                         if n not in latent})
        path_launches["serve"] = {n: served["launches"][n]
                                  for n in model_kernels}
        flash_instances = served["flash_instances"]
        ssd_chunks["serve"] = served["chunk_launches"]
        if args.profile:
            phase_serve_profile(np, torch, dev)
    if "serve-check" in phases:
        phase_serve_check(np, torch, kernels, dev)
    if "serve-dense" in phases:
        dense = phase_serve_dense(torch, kernels, dev)
        path_launches["serve-dense"] = {n: dense[n] for n in model_kernels}
        if args.profile:
            phase_serve_profile(np, torch, dev, "glm4-9b")
    if "serve-dense-check" in phases:
        phase_serve_dense_check(np, torch, kernels, dev)
    for phase, arch in (("serve-encdec", ENCDEC_ARCH),
                        ("serve-vlm", VLM_ARCH)):
        if phase in phases:
            served = phase_serve_frontend(torch, kernels, dev, arch, phase)
            path_launches[phase] = {n: served["launches"][n]
                                    for n in model_kernels}
            if args.profile:
                phase_serve_profile(np, torch, dev, arch)
        if f"{phase}-check" in phases:
            phase_serve_frontend_check(np, torch, kernels, dev,
                                       f"{phase}-check")
    if "serve-ssm" in phases:
        served = phase_serve_ssm(torch, kernels, dev)
        path_launches["serve-ssm"] = {n: served["launches"][n]
                                      for n in model_kernels}
        ssd_chunks["serve-ssm"] = served["chunk_launches"]
        if args.profile:
            phase_serve_profile(np, torch, dev, SSM_ARCH)
    if "serve-ssm-check" in phases:
        phase_serve_ssm_check(np, torch, kernels, dev)
    if "serve-moe" in phases:
        served = phase_serve_moe(torch, kernels, dev)
        path_launches["serve-moe"] = {n: served["launches"][n]
                                      for n in model_kernels}
        if args.profile:
            phase_serve_profile(np, torch, dev, MOE_ARCH)
    if "serve-moe-check" in phases:
        phase_serve_moe_check(np, torch, kernels, dev)
    if "serve-mla" in phases:
        served = phase_serve_mla(torch, kernels, dev)
        launches.update({n: served["launches"][n] for n in latent})
        latent_instances = served["latent_instances"]
        decode_instances = served["decode_instances"]
        path_launches["serve-mla"] = {n: served["launches"][n]
                                      for n in model_kernels}
        if args.profile:
            phase_serve_profile(np, torch, dev, MLA_ARCH, MLA_LAYERS)
    if "serve-mla-check" in phases:
        phase_serve_mla_check(np, torch, kernels, dev)
    if "train" in phases:
        trained = phase_train(np, torch, kernels, dev)
        launches["flash_attention_bwd"] = trained["backward"]
        bwd_instances = trained["backward_instances"]
        path_launches["train"] = trained["launches"]
    if "train-check" in phases:
        phase_train_check(np, torch, kernels, dev)
    if "train-ssm" in phases:
        trained = phase_train_ssm(np, torch, kernels, dev)
        launches["ssd_scan_bwd"] = trained["backward"]
        path_launches["train-ssm"] = trained["launches"]
    if "train-ssm-check" in phases:
        phase_train_ssm_check(np, torch, kernels, dev)
    if "train-mla" in phases:
        trained = phase_train_mla(
            np, torch, kernels, dev,
            rows.get("flash_attention_latent_bwd", {}).get("shapes"))
        launches["flash_attention_latent_bwd"] = trained["backward"]
        latent_bwd_instances = trained["backward_instances"]
        path_launches["train-mla"] = trained["launches"]
    if "train-mla-check" in phases:
        phase_train_mla_check(np, torch, kernels, dev)
    if "health" in phases:
        health_runs = phase_health(np, torch, fit_kernels, health_inputs(np))
        path_launches["health"] = {
            name: sum(r["launches"][name] for r in health_runs)
            for name in fit_kernels}
    if "scale" in phases:
        inp = scale_inputs(np)
        scale_runs = phase_scale(np, torch, fit_kernels, inp)
        path_launches["scale"] = {
            name: sum(r["launches"][name] for r in scale_runs)
            for name in fit_kernels}
        if args.profile:
            phase_scale_profile(torch, inp)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    replaces = {
        "span_gain": ("src/repro_torch/csrc/span_gain.cu",
                      "src/repro/kernels/span_gain/kernel.py:41"),
        "cover_rounds": ("src/repro_torch/csrc/cover_rounds.cu",
                         "src/repro/core/setcover.py:338"),
        "lockstep_peel": ("src/repro_torch/csrc/lockstep_peel.cu",
                          "src/repro/kernels/lockstep_peel/kernel.py:89"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:94"),
        # the gradient of the same kernel; the reference differentiates
        # chunked_attention in jnp (its train_loss)
        "flash_attention_bwd": (
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:94"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:77"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:71"),
        # the gradient of the same kernel; the reference differentiates
        # ssd_chunked in jnp (its train_loss)
        "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                         "src/repro/kernels/ssd_scan/kernel.py:71"),
        # the latent forms of the two attention kernels: the reference's
        # MLA runs chunked_attention in jnp at these shapes
        "flash_attention_latent": (
            "src/repro_torch/csrc/mla_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:94"),
        "decode_attention_latent": (
            "src/repro_torch/csrc/mla_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:77"),
        # the gradient of the latent prefill; the reference differentiates
        # chunked_attention in jnp at these shapes (its train_loss)
        "flash_attention_latent_bwd": (
            "src/repro_torch/csrc/mla_attention_bwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:94"),
    }
    report = []
    for name, (source, tpu) in replaces.items():
        row = rows.get(name, {})
        report.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=launches.get(name),
            max_abs_err=row.get("max_abs_err"), ms=row.get("ms"),
            plain_ms=row.get("plain_ms"), bound_ms=row.get("bound_ms"),
            bound_by=row.get("bound_by"), library_ms=row.get("library_ms"),
            device_ms=row.get("device_ms"),
            library_device_ms=row.get("library_device_ms"),
            launches_by_path={path: counts[name] for path, counts
                              in path_launches.items() if name in counts},
        ))
        if name == "flash_attention":
            # ms is the instance's that the serving path runs
            report[-1].update(instance=row.get("instance"),
                              instance_launches=flash_instances)
        if name in latent:
            # ms is the bf16 (wgmma) kernel's, which serve-mla runs
            report[-1].update(instance=row.get("kernel_instance"),
                              instance_launches=(
                                  latent_instances if name == latent[0]
                                  else decode_instances))
        if name == "ssd_scan":
            report[-1].update(chunk_launches_by_path=ssd_chunks)
        if name == "flash_attention_bwd":
            # launches: backward calls on the train path, three kernel
            # launches each (delta, dk / dv, dq); ms is the bf16 (wgmma)
            # instance's, which train runs
            report[-1].update(computes="jax.vjp of src/repro/models/"
                              "attention.py:27 chunked_attention, as "
                              "train_loss differentiates it "
                              "(src/repro/models/model.py:323)",
                              launches_per_call=3,
                              instance=row.get("instance"),
                              instance_launches=bwd_instances,
                              device_ms_by_pass=row.get(
                                  "device_ms_by_pass"))
        if name == "ssd_scan_bwd":
            # launches: backward calls on the train-ssm path, three kernel
            # launches each (state, grad, reduce); ms is the bf16
            # row's at mamba2-2.7b's training shape, which train-ssm runs
            report[-1].update(computes="jax.vjp of src/repro/models/"
                              "ssm.py:63 ssd_chunked, as train_loss "
                              "differentiates it (src/repro/models/"
                              "model.py:323)",
                              launches_per_call=len(SSD_BWD_PASSES),
                              instance=row.get("instance"),
                              device_ms_by_pass=row.get(
                                  "device_ms_by_pass"))
        if name in latent:
            report[-1].update(computes="src/repro/models/attention.py:27 "
                              "chunked_attention, as mla_attention calls it "
                              "(:273-286)",
                              library_backend=row.get("library_backend"))
        if name == "flash_attention_latent_bwd":
            # launches: backward calls on the train-mla path, four kernel
            # launches each (delta, the query side, the key side's partial
            # sums, their sum); ms is
            # the bf16 row's at deepseek-v3's training shape, which
            # train-mla runs
            report[-1].update(computes="jax.vjp of src/repro/models/"
                              "attention.py:27 chunked_attention, as "
                              "mla_attention calls it (:273-286) and "
                              "train_loss differentiates it "
                              "(src/repro/models/model.py:323)",
                              launches_per_call=len(
                                  MLA_BWD_PASSES["wgmma"]),
                              instance=row.get("instance"),
                              instance_launches=latent_bwd_instances,
                              library_backend=row.get("library_backend"),
                              device_ms_by_pass=row.get(
                                  "device_ms_by_pass"))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
