#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on one NVIDIA GPU and fails (non-zero exit, no
result line) if anything is off:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from this checkout's sources (one
   ``nvcc`` per source, all started together), with ``-Xptxas -v``'s
   registers, stack frames and spills (kernels F, A, B, C and D per
   instantiation on lines of their own; a kernel-A, B, C or D
   instantiation that spills fails, and so does a kernel-C or D
   instantiation with a stack frame);
2. kernel A (``untangled_deconv2d``) against its plain PyTorch version on
   the card, both held to the float64 oracle's ULP bound, at the full-width
   DCGAN sites (B = 1 and 64), the cGAN sites, the VAE's decoder sites
   (B = 1 and 64), a non-uniform-phase case, an
   empty-phase case (stride > kernel) and ragged C/N — every output, and
   the split K's workspace, comes from ``torch.empty`` on memory pre-filled
   with NaN; a second launch bit-equal to the first; each site's schedule
   (tile, slices, work units);
2b. kernel B (``untangled_conv2d_superpack``) the same way, at the four
   DCGAN discriminator sites (B = 1 and 64), both cGAN discriminator sites
   (B = 16), the VAE's encoder sites (B = 1 and 64; the stem's C = 3),
   dilated (d = 2, 4), ragged C/N and odd-output cases, the
   output and the split K's workspace on NaN-filled memory, two launches
   bit-equal, each site's schedule (tile, slices, work units);
2c. kernel B's int8 entry (kernel E inside B) and its plain version against
   the f64 oracle of ``(x, dequantize_int8(q, scale))``, at the 10 SegNet
   sites (B = 1 and 64), the six discriminator sites (B = 16), the VAE's
   encoder sites (B = 1 and 64) and ragged
   C/N, each superpack with an all-zero row; the int8 kernel bit-equal to
   the f32 kernel on the dequantized superpack, two launches bit-equal, on
   NaN-filled output and workspace;
2d. kernel A's int8 entry the same way, at the DCGAN (B = 1 and 64) and
   cGAN (B = 16) generator sites, the VAE's decoder sites (B = 1 and 64),
   the non-uniform, empty-phase and ragged cases, two launches bit-equal;
3. serving at full width: the Table-1 DCGAN on the 'cuda' route behind
   ``DynamicImageBatcher``, one CUDA graph per bucket: every bucket's
   capture records 4 kernel-A launches and its replay is bit-equal to the
   eager forward (one replay's device kernels of A from ``torch.profiler``
   beside, "not measured" where the trace holds none), a burst answered
   once per request, 4 kernel launches per batcher launch (captured count
   x replays; no eager launch while serving), each row equal to a B = 1
   forward;
3b. training at full width: the Table-1 DCGAN generator and discriminator
   on the 'cuda' route through ``train_step`` (3 SGD steps at B = 16), with
   finite losses and params, A and B launched exactly once per planned
   forward, and every gradient of one step equal to the 'torch' route's
   within ``max|Δ| ≤ TOL_GRAD·max|g_torch|`` per tensor (TF32 off);
3c. SegNet serving at full width (``SEGNET``, 64 px, width 128) on the
   'cuda' route, f32 and int8, on the bucket graphs (checked as in 3): a
   burst answered once per request, kernel B (f32 or int8 entry) launched
   exactly 10 times per batcher launch (captured x replays), every
   served argmax map equal to a B = 1 forward's, the int8 logits within
   10/127 rel L∞ of the f32 twin's and the int8 weights at most half the
   f32 bytes; the forward's time per bucket, and at B = 1 and 64 its device
   time by kernel and idle share (``torch.profiler``);
3d. the int8 DCGAN generator served the same way: 4 int8 kernel-A launches
   per batcher launch (captured x replays, every bucket's replay bit-equal
   to its eager forward), rows equal to B = 1 forwards, output within 4/127
   rel L∞ of the f32 generator from the same seed;
4. times (CUDA events): per DCGAN generator site at B = 1 and 64 kernel A,
   its plain version, ``F.conv_transpose2d`` as the library yardstick and
   the roofline bound, with the kernel's and the library's device time per
   call (``torch.profiler``; at B = 1 the events time the host's Python)
   and the site's schedule (at least 132 work units at B = 1); one full
   generator forward per bucket;
4b. per discriminator site at B = 1 and 64 the same for kernel B, with
   ``F.conv2d`` on the pre-padded plane as the yardstick (device times and
   the schedule too; at least 132 work units at every DCGAN site at B = 1
   whose K the schedule splits); ms per train step at B = 16 and 64 on
   'cuda' and on 'torch';
4c. the int8 entries: kernel B at every SegNet site and kernel A at every
   DCGAN site (B = 1 and 64) against the f32 kernel, the plain version, the
   library call on the dequantized weights and the bound (1 B per weight
   plus 4 B per scale row), with device times and the schedule (at least
   132 work units at SegNet L1-L8 at B = 1); the SegNet forward per
   bucket, f32 and int8;
2e. kernel C (``untangled_conv2d_superpack`` with ``sp_tiles=``) and its
   int8 entry against the plain version and the f64 oracle's ULP bound on
   NaN-poisoned outputs, at the four tiled sites of the U-Net at a 512 px
   image (B = 1, the routes' block tiles), the 385 px 32->32 d = 2 context
   site and a d = 4 twin, the geometries of
   ``tests/test_tiled_kernels.py:SINGLE_CASES`` with their tiles, C = 3
   and N = 3 sites, a 3x3 site at every BN (4, 32, 64, 128), the stem's C
   = 3, a stride-2 site, a ragged C not divisible by 4, a 7x7 site and
   the VAE's two k4 s2 encoder sites (autotune candidates); the
   int8 entry bit-equal to the f32 entry on the dequantized superpack
   everywhere, two launches of either bit-equal; each site's schedule
   (``tiled_conv_schedule``: tile, BN, tap loop, halo, ring, blocks an
   SM);
2f. kernel D (``untangled_deconv2d`` with ``sp_tiles=``) and its int8 entry
   the same way, at the U-Net's tiled up0 (512 px, B = 1; there the
   cropped ``F.conv_transpose2d`` of phase 4d too), the geometries of
   ``DECONV_CASES`` (DCGAN and cGAN phases, an empty phase, stride 1) and
   each path and edge on the card's tiles (the shared-window path at k4
   s2, the run-time path at k5 s2, nine phases, C % 4 != 0, N not a
   multiple of BN, BN 4 and 128), the VAE's decoder sites and DCGAN DC1
   and DC4 (autotune candidates), empty phases written as zeros; each
   site's schedule (``tiled_deconv_schedule``: tap loop, BN, register
   split, tile, halo, ring);
3e. the U-Net on the 'cuda' route, f32 and int8: ``UNET`` (32 px) at B = 1
   and 64 and a 512 px image at B = 1 and 16, one ``unet_apply`` per bucket
   with the launches counted per kernel (512 px: 4 C + 1 D + 4 B + 1 A; 32
   px: 8 B + 2 A; the int8 model in the int8 counters), each forward within
   ``2e-4·max|y_torch|`` of the 'torch' route on the same weights, the int8
   model within ``0.15·max|y32| + 1e-3`` of its f32 twin, and an 8-step
   ``denoise_loop`` at 512 px that stays finite;
4d. times of kernels C and D (f32 and int8) at every tiled 512 px site at
   B = 1 and 16 beside the plain version, the library (kernel C:
   ``F.conv2d``; kernel D: ``F.conv_transpose2d`` at ``padding=0``
   cropped to up0's pad (1, 3), one call and a view) and the bound, with
   the schedules and D's device times; the U-Net forward per
   bucket, and one 512 px forward's device time by kernel, its busy share
   and kernel B's share of the device time;
2g. kernel F (``flash_attention``) against its plain version and the f64
   dense oracle, f32 (the FFMA entry) and bf16 (the tensor-core entry, its
   worst error and share of the tolerance), on NaN-poisoned outputs: the
   four geometries of ``tests/test_flash_attention_kernel.py``, ragged
   (1, 1000, 32, 8, 64) causal, (2, 77, 4, 2, 128) non-causal, a
   decode-style row at q_offset 300 over 512 keys, gemma3-1b's window-512
   D = 256 layer, a llama3.2-1b layer at S = 4096, the GQA groups of
   qwen2-7b (7), glm4-9b (16) and qwen2-vl-2b (6) at D = 128,
   recurrentgemma-2b's window-2048 D = 256 layer, gemma3-1b's global
   D = 256 layer at S = 4096, deepseek-v3-671b's MLA geometry (128/128
   heads, D = 192) at S = 1024 and a ragged D = 192 case;
3f. the llama3.2-1b prefill step at full width in bf16 (seeded weights) at
   B = 1, S = 4096 and B = 8, S = 512: 16 F launches per forward, finite
   f32 logits (off the bf16 grid: the tied readout does not round them),
   the kernel route's last-position logits within 3e-2·max|logits|
   of the plain attention route's on the same weights, the same argmax on
   every row whose top two logits are not within twice that error;
3g. greedy serving at full width: ``serve(reduced=False, batch=4,
   prompt_len=8, gen_tokens=16)``, then 6 requests over 4 slots of
   ``ContinuousBatcher``, each request's tokens equal to its lone run's, 0
   F launches at decode (JAX decodes with a dense softmax), tok/s;
4e. kernel F a layer at both prefill geometries (bf16) beside its f32
   FFMA entry on the same values, its plain version,
   ``F.scaled_dot_product_attention`` as the library yardstick and the
   bound (the unmasked pairs' FLOPs at the bf16 tensor-core peak,
   or the bytes of q, k, v and o); the prefill step's ms; its device time
   split into F, dense products and the rest with the idle share
   (``torch.profiler``); ``decode_step`` ms at B = 4;
3j. the LM families at full width in bf16 (seeded weights), one at a
   time, each cut to its first layers (``FAMILY_DEPTH``: 12, 10, 10, 10,
   9, 8): gemma3-1b, qwen2-7b, glm4-9b, qwen2-vl-2b,
   recurrentgemma-2b and mamba2-130m. A prefill step at B = 1, S = 4096
   launches F once an attention layer (12, 10, 10, 10, 3, 0), its logits
   finite and within 3e-2·max|logits| of the plain attention route's
   (the 3f argmax rule); ``serve`` gives 16 greedy tokens at B = 4; for
   gemma3-1b, recurrentgemma-2b and mamba2-130m (local KV, RG-LRU and
   SSD state caches, written in place) 5 requests over 4 slot graphs of
   ``ContinuousBatcher`` (one slot recycled), each request's tokens equal
   to an eager ``graphs=False`` run's and to its lone run's; 0 F
   launches at decode;
4i. times of 3j: each prefill's ms with its device split (F, dense
   products, the rest) and idle share, a B = 4 ``decode_step``; kernel F
   at gemma3-1b's local (window 512) and global layers, B = 1, S = 4096,
   beside its plain version, SDPA with ``enable_gqa`` (an explicit
   boolean ``attn_mask`` for the window) and the bound over the pairs
   the mask leaves;
3k. dbrx-132b (4 of its 40 ``moe`` layers) and deepseek-v3-671b (its 3
   dense ``mla`` layers and 2 of its 58 ``mla_moe`` layers) at full width
   in bf16 (seeded weights), one at a time with every earlier allocation
   freed: a prefill at B = 1, S = 4096 launches F once an attention layer
   (4, 5; deepseek's MLA at D = 192); F's bf16 output at every attention
   layer within its bf16 bound of the plain version on that layer's q, k,
   v, and each MoE layer's output on its own input, over its first 64
   positions, within the same rule of the f32 all-experts combine
   (``moe_apply_dense``), each gate failing a planted fault at every
   layer; the routing flips between the kernel and the plain attention
   route counted (a flipped expert is a whole-token difference, so the
   logits of the two bf16 routes are reported, not gated); an f32 copy at
   the depth that fits (dbrx 1 layer, deepseek 1 ``mla`` + 1 ``mla_moe``):
   F's f32 entry against the plain route within 1e-4·max|logits|;
   ``serve`` 16 greedy tokens at B = 4; 5 requests over 4 slot graphs of
   ``ContinuousBatcher`` (MoE decode, MLA's compressed cache) equal to an
   eager run's and to each lone run's; 0 F launches at decode;
4j. times of 3k: each prefill's ms with its device split (F, dense
   products, the MoE's dispatch, the rest) and idle share, a B = 4
   ``decode_step``, one MoE layer's B = 1 decode beside the selected
   experts' weight bytes; kernel F at deepseek's MLA layer (128/128
   heads, D = 192) and dbrx's (48/8, D = 128), B = 1, S = 4096, beside
   its plain version, SDPA and the bound;
3l. seamless-m4t-large-v2 at full width and depth in bf16 (seeded
   weights, 2.04 B params): the encoder over 3072 stub frames and a
   512-token decoder prefill through the prefill step launch F 72 times
   (once an encoder layer, non-causal; twice a decoder layer, causal
   self-attention and cross attention over the 3072 memory rows); F's
   bf16 output at every one of those layers within its bound of the
   plain version on the layer's own q, k, v, the planted fault failing
   at each; the logits within 3e-2·max|logits| of the plain route's;
   ``serve`` at B = 4 over the encoded memory (16 greedy tokens, 24 F
   launches a decode step: the cross attention); 5 requests over 4 slot
   graphs of ``ContinuousBatcher`` over one memory (each graph's capture
   records 24 F launches) equal to an eager run's and each lone run's;
   the same requests through ``LMBackend(memory=)`` behind the control
   plane, answered with the same tokens;
4k. times of 3l: the prefill's ms with its device split (F, products,
   the rest) and idle share, an eager B = 4 ``decode_step`` over the
   memory; kernel F at the encoder layer (B = 1, S = 3072, 16/16 heads,
   D = 64, non-causal) and at a cross layer (Sq = 512, Sk = 3072) beside
   its plain version, SDPA and the bound;
3m. llama3.2-1b training at full width and depth in bf16 (seeded
   weights), B = 2, S = 4096, AdamW from ``opt_config_for``, remat on:
   the loss and its gradients launch F 32 times (16 forward, 16
   recomputed in the backward), F's bf16 output held at each call
   inside the training forward with its planted fault caught; the loss
   and every gradient tensor within ``TOL_TRAIN_LOSS`` /
   ``TOL_TRAIN_GRAD`` of the plain attention route's (F's plain version
   forward through the same backward); 3 steps of ``make_train_step``
   on one batch: the loss falls, 32 F launches a step; ``train()`` at
   full width cut to one layer, killed by ``fail_at`` and resumed from
   its checkpoint to the last step, every loss bit-equal to an
   uninterrupted run's (``torch.use_deterministic_algorithms`` on);
4l. times of 3m: the train step's ms, tokens/s and peak memory
   (``max_memory_allocated``), its device time split into F forward,
   the attention core's backward (plain PyTorch products), the other
   dense products, the optimiser and the rest, with the idle share;
3h. the full-width VAE (``VAE``: 32 px, widths 64/128, latent 64) on the
   'cuda' route, f32 and int8: ``vae_apply`` at B = 1 and 64 launches 2 B
   and 2 A (the int8 model in the int8 counters), recon, mu and logvar
   within ``2e-4·max|y_torch|`` of the 'torch' route on the same weights
   and noise, the int8 twin within 4/127 rel L∞ of the f32 model; three
   SGD steps of ``elbo_loss`` at B = 64 (finite, 6 A and 6 B launches),
   one step's gradients within ``TOL_GRAD·max|g_torch|`` per tensor and
   the loss within ``TOL_LOSS`` of the 'torch' route's; ``sample(n=16)``
   finite in [-1, 1];
4f. times: per VAE site at B = 1 and 64 kernel B or A, its plain version,
   the library call (``F.conv2d`` on the pre-padded plane; the cropped
   ``F.conv_transpose2d`` at the decoder's pad (1, 3)), the bound, device
   ms and the schedule; the same for kernel A at its other pad (1, 3)
   sites (cGAN DC1-DC2 at B = 1 and 64, the U-Net's whole-plane up sites
   at 32 px, B = 1 and 64, and at 512 px, B = 1 and 16) and at the DCGAN
   sites; the ``per_phase`` route (a kernel-B or -C launch a live phase,
   f32 and int8, int8 bit-equal to f32 on the dequantized superpack)
   beside kernel A at the DCGAN, cGAN and VAE decoder sites; the VAE
   forward per bucket with its device split and busy share; the ELBO step
   at B = 64 on 'cuda' and on 'torch';
4g. measured route autotuning (``AutotunePolicy(mode='measure')``, a route
   cache in a temporary directory) at the VAE's and the DCGAN generator's
   sites, every bucket: each candidate's min µs, the winner, whether it
   flipped the heuristic route; every tuned plan's output within the f64
   bound (a kernel winner) or ``2e-4·max|y_torch|`` (a plain winner); a
   second load in 'cache' mode measures nothing and gives the same
   routes; ``serve_dcgan --autotune cache`` re-times no bucket and
   measures no route, every served row equal to a B = 1 forward;
3i. the control plane at full width: the Table-1 DCGAN generator,
   ``SEGNET`` (f32) and llama3.2-1b (4 slots) behind one ``ControlPlane``,
   a seeded burst of both priority classes (some with SLOs: two rejected
   at admission, one shed before launch), a ``FailureInjector`` killing an
   image launch and a decode step: every request answered once, submitted
   = served + rejected + shed, every answer bit-equal to the same burst
   run fault-free, the decode graphs' tokens equal to the eager
   ``ContinuousBatcher``'s, 4 A and 10 B launches per bucket launch;
   per-class p50/p99, goodput under SLO, the fault records;
4h. times: the DCGAN generator and SegNet (f32, int8) forward per bucket
   eager against its CUDA graph's replay (CUDA events and host wall, the
   device time and busy share from ``torch.profiler``); the llama3.2-1b
   decode step at 4 slots, eager against the slot graphs;
3n. plane-parallel execution (``core.spatial``) over 4 ranks that share
   the card on a gloo group (``launch.mesh.run_spmd``; halos staged
   through host memory): JAX's three ``CONVPLANE_SITES`` at their widths
   and batch (the 385 px dilated context at (4, 1) and (2, 2), decoder_96
   at (2, 2) and (4, 1), encoder_512 at (2, 1) with data = 2), each rank's
   local route, kernel and launches and the halo widths, the assembled
   output within the f64 bound and ``TOL_PP`` of the single-device 'cuda'
   plan, the x and superpack gradients of sum(y²) within ``TOL_PP`` of the
   single-device plan's, each gate failing two planted faults (an inner
   halo delivered as zeros; the superpack gradient unsummed on rank 1);
   the 512 px U-Net at full width split (2, 1) on 2 ranks and (2, 2) on 4
   against its single-device forward (the zero-halo fault through the same
   gate), every site's verdict, per rank forward ms, device ms and peak
   memory beside the single-device forward's (the planes stay split
   between sites: each rank's activation memory within ``PP_MEM_LIMIT``
   of the single-device forward's, where gathering every site's output
   exceeds it), halo bytes a forward and the exchange's ms; the control
   plane serving the 385 px site, degraded onto (2, 2) and onto (2, 1)
   with data = 2, every answer within its f64 bound and the degraded
   rounds' planes really split; autotune under a (4, 1) mesh, every rank
   picking the same winner;
3o. the forward on a (data 2, model 2) mesh over 4 ranks that share the
   card on a gloo group (``mesh_phases``): the DCGAN generator (B = 64
   and 1), the cGAN and SegNet, f32 and int8, served DP x TP through the
   image batcher against the single-rank 'cuda' forward, each rank's
   local route and kernel a site, A/B/E launches; llama3.2-1b (every
   layer, B = 2, S = 4096), dbrx-132b (2 layers) and deepseek-v3-671b (1
   + 1 layers) at full width through ``make_prefill_step(cfg,
   make_dist(...))``: F on each rank's local heads against its plain
   version, each attention and GLU sublayer against the single-rank one
   on its own input, each MoE layer without a drop against the one-card
   MoE and at the config's capacity against JAX's EP semantics written
   out plainly in one process, dbrx's psum path, the last position's
   logits (the reference's MoE layers routed on the mesh's inputs); every
   gate read with a planted fault (a reversed channel gather, a skipped
   row-parallel all-reduce, the all-to-all's return to the rotated rank,
   the psum unsummed on rank 1);
4m. times of 3o: per rank the forward's ms and device ms beside the
   single-rank forward's, weight bytes over the single-rank model's,
   every collective kind's calls, bytes and host ms, peak memory;
3p. LM training on a (data 2, model 2) mesh over 4 ranks that share the
   card (``mesh_train_phases``): the one-rank references first, in this
   process; llama3.2-1b at full width and depth (B = 2, S = 4096, AdamW
   with ZeRO-1, remat, 3 steps of ``make_train_step(..., dist=)``): every
   step's loss and gnorm and the first step's update of every leaf
   against the one-rank steps, F twice an attention layer a step on each
   rank's local heads, three planted faults (a rank skipping the gradient
   sum over 'data', a rank-local norm, an unreduced log-sum-exp);
   dbrx-132b (1 layer) on the all-to-all path, one Adafactor step held the
   same way (planted: local row means); ``train()`` killed and resumed on
   (2, 2) against the one-rank run, its checkpoint restored on
   ``shrink_mesh(2, model=2)`` bit for bit;
4n. times of 3p: per rank the step's ms and device ms, F launches a
   step, peak memory, the optimiser state's bytes over the unsharded
   state's, every collective kind's calls, bytes and host ms;
3q. serving on a (data 2, model 2) mesh over 4 ranks that share the card
   (``mesh_serve_phases``), at full width in bf16 under ``make_dist``'s
   decode rules: llama3.2-1b at B = 8, S = 32768 and B = 1, S = 131072,
   gemma3-1b (12 layers), deepseek-v3-671b (1 + 1 layers, EP at decode),
   recurrentgemma-2b (9 layers, a prefill at (1, 4096) first) and
   seamless-m4t-large-v2 (6 + 6 layers, a prefill over 3072 source frames
   first): each cache filled from a seed, 3 greedy steps of
   ``make_serve_step(cfg, dist)``, every step's logits against the
   one-rank step, the cache blocks against the one-rank cache's slices,
   F on each rank's local heads (seamless's cross attention at every
   decode step), the MoE layers against JAX's EP semantics, planted
   faults (a 'kv_seq' rank skipping the merge, the new row written on
   every rank, the RG-LRU's gather skipped, the cross attention's
   all-reduce skipped on one rank, the EP return rotated);
4o. times of 3q: per rank the step's ms and device ms beside the one-rank
   step's, the cache bytes over the one-rank cache's, every collective
   kind's calls and bytes a step, peak memory;
3s. the dry-run's count held against the card (``dryrun_phases``): the
   DCGAN generator and discriminator at B = 64, the 512 px U-Net forward
   at B = 16, llama3.2-1b's prefill at B = 1, S = 4096 and its train step
   at B = 2, S = 4096, each counted on fake tensors
   (``launch.hlo_analysis``) and run on the card: (a) each kernel entry's
   counted launches equal its counter's delta (planted: kernel B's fake
   branch silent), (b) the counted product FLOPs equal ``FlopCounterMode``
   over the card's run and the kernel FLOPs the work formulas at the
   launched shapes, (c) the roofline's compute term at most the trace's
   device busy time (planted: x1000), the memory term printed, (d) the
   llama cells' counted activation peak within ``DRY_PEAK_BAND`` of the
   card's (planted: the tracker taking a view of an input for a new
   storage, at the prefill); (e), inside 3o: rank 0's collectives of the llama3.2-1b (2, 2)
   prefill counted on a fake world of 4 equal its ``comm.traffic()``;
3t. the last superpack splits over 4 ranks that share the card
   (``mesh_splits_phases``): the 512 px U-Net at B = 1 with 'conv_taps'
   on 'model', f32 and int8, its C and D sites on row blocks (each launch
   against its plain version, also on a block fenced by NaN rows), a C and
   a D site against the f64 oracle, output and a DSM gradient against one
   rank's; the same U-Net plane-parallel on (2, 2) with its superpack
   rows on 'sp_h', then its out-channels on 'sp_w'; the DCGAN generator
   and discriminator through the batcher's split batch on (2, 2) with one
   superpack split on the batch axis; each with a planted fault;
4q. times of 3t: per rank each case's ms and device ms beside one rank's,
   its collectives and peak memory, and each C and D row-block launch
   beside the whole superpack's launch at its site;
5. the ``kernels`` line (A, B, A-int8, B-int8, C, D, C-int8, D-int8, F;
   A's, B's, A-int8's and B-int8's B = 64 sums with their B = 1 sums
   beside), the card line, and the result line.

    python3 chip_smoke.py        # from the repository root, one GPU

``--plane-parallel`` builds the kernels and runs phase 3n alone,
``--mesh`` phases 3o/4m alone, ``--mesh-train`` phases 3p/4n alone,
``--mesh-serve`` phases 3q/4o alone, ``--mesh-rest`` 3r/4p,
``--mesh-splits`` 3t/4q, ``--dryrun`` 3s (several flags: each).  On a machine
with a card for each of its 4 ranks they meet on an NCCL group and
exchange device tensors (no host staging):

    python3 chip_smoke.py --plane-parallel --mesh --mesh-train  # 4 GPUs
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# forward tolerance of the served rows against a B = 1 forward: the kernel's
# per-element sum order does not depend on the batch, but the projection GEMM
# (cuBLAS) may pick another algorithm per batch size
TOL_ROW = 2e-4
# gradient tolerance of the 'cuda' route against the 'torch' route (both
# IEEE fp32, other summation orders through up to eight stacked layers;
# ReLU kinks turn forward rounding into whole-element gradient changes),
# relative to each tensor's own scale: max|Δ| ≤ TOL_GRAD·max|g_torch|, the
# form and value of the CPU tests' gradient check against JAX
TOL_GRAD = 1e-3
TOL_LOSS = 1e-4               # relative, on the two losses
TRAIN_STEPS = 3
TRAIN_BATCH = 16
BURST = 24
# forward tolerance of the U-Net's 'cuda' route against its 'torch' route,
# relative to max|y_torch| (the CPU tests' TOL_FWD form against JAX)
TOL_UNET = 2e-4
UNET_512_HW = 512
UNET_512_BATCHES = (1, 16)
# the VAE's forward against its 'torch' route, relative to max|y_torch|
# (the CPU tests' TOL_FWD form against JAX), and its buckets and SGD rate
# (the full config's -ELBO sums 3072 squared errors an image; the JAX
# example's 1e-3 diverges there)
TOL_VAE = 2e-4
VAE_BATCHES = (1, 64)
VAE_LR = 1e-4
UNET_32_BATCHES = (1, 64)
DENOISE_STEPS = 8
# kernel C cases beside the U-Net's: (name, b, hp, wp, c, n, r, s, stride,
# dilation, tile) on a pre-padded plane; tile None takes the card's own.
# The geometries of tests/test_tiled_kernels.py's SINGLE_CASES (ragged
# edge, strided, big halo, ragged C, 1x1, one tile = plane), then C = 3
# and N = 3 (the scalar paths), a 3x3 site at every BN (4, 32, 64, 128,
# the last over two N tiles), the stem's C = 3, a stride-2 site, a ragged
# C not divisible by 4 and a 7x7 site (the run-time tap loop)
TILED_CONV_CASES = [
    ("ctx385_d2", 1, 389, 389, 32, 32, 3, 3, 1, 2, None),
    ("ctx385_d4", 1, 393, 393, 32, 32, 3, 3, 1, 4, None),
    ("ragged_edge", 2, 13, 11, 5, 7, 3, 2, 1, 1, (4, 4)),
    ("strided", 1, 17, 17, 8, 8, 3, 3, 2, 1, (3, 5)),
    ("big_halo", 1, 21, 21, 4, 4, 3, 3, 1, 3, (8, 8)),
    ("ragged_c", 2, 14, 14, 130, 40, 2, 2, 2, 2, (2, 7)),
    ("one_by_one", 1, 9, 9, 3, 4, 1, 1, 1, 1, (4, 4)),
    ("one_tile_is_plane", 1, 16, 16, 6, 5, 3, 3, 1, 1, (16, 16)),
    ("c3_n32", 2, 34, 34, 3, 32, 3, 3, 1, 1, None),
    ("c32_n3", 2, 34, 34, 32, 3, 3, 3, 1, 1, None),
    ("bn4_n4", 2, 42, 40, 8, 4, 3, 3, 1, 1, None),
    ("bn32_n32", 2, 42, 40, 16, 32, 3, 3, 1, 1, None),
    ("bn64_n48", 1, 42, 40, 16, 48, 3, 3, 1, 1, None),
    ("bn128_n160", 1, 26, 24, 8, 160, 3, 3, 1, 1, None),
    ("stem_c3_n32", 2, 66, 66, 3, 32, 3, 3, 1, 1, None),
    ("s2_c16_n32", 2, 65, 65, 16, 32, 3, 3, 2, 1, None),
    ("ragged_c10_n32", 1, 30, 30, 10, 32, 3, 3, 1, 1, None),
    ("k7_n256", 1, 30, 29, 16, 256, 7, 7, 1, 1, None),
    ("vae_enc0_k4s2_c3", 2, 35, 35, 3, 64, 4, 4, 2, 1, None),
    ("vae_enc1_k4s2", 2, 19, 19, 64, 128, 4, 4, 2, 1, None),
]
# kernel D cases beside up0: (name, b, h, c, n, k, stride, pads, tile), the
# geometries of DECONV_CASES (square planes), then on the card's tiles
# (tile None) each path and edge: the shared-window path at k4 s2 (up0's
# widths over ragged tiles; C % 4 != 0 with N not a multiple of BN; BN 128
# over two N tiles; BN 4 with N = 3), the run-time path at k5 s2 with N
# not a multiple of BN, nine phases of one shared window (run-time)
TILED_DECONV_CASES = [
    ("dcgan_k5s2", 2, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), (3, 3)),
    ("cgan_k4s2", 1, 8, 5, 4, 4, 2, ((1, 3), (1, 3)), (8, 2)),
    ("empty_phase_k2s3", 2, 6, 5, 4, 2, 3, ((0, 0), (0, 0)), (2, 3)),
    ("stride_1", 1, 7, 4, 3, 3, 1, ((1, 1), (1, 1)), (3, 2)),
    ("dcgan_card_tile", 2, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), None),
    ("shared_k4s2_up0_widths", 2, 37, 64, 32, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_c10_n48", 1, 20, 10, 48, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_n160", 1, 12, 8, 160, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_n3", 2, 16, 8, 3, 4, 2, ((1, 3), (1, 3)), None),
    ("runtime_k5s2_c16_n40", 1, 16, 16, 40, 5, 2, ((2, 3), (2, 3)), None),
    ("runtime_k6s3_nine_phases", 1, 9, 8, 8, 6, 3, ((2, 5), (2, 5)), None),
    ("vae_dec0_k4s2", 2, 8, 128, 64, 4, 2, ((1, 3), (1, 3)), None),
    ("vae_dec1_k4s2_n3", 2, 16, 64, 3, 4, 2, ((1, 3), (1, 3)), None),
    ("dcgan_dc1_k5s2", 1, 4, 1024, 512, 5, 2, ((2, 3), (2, 3)), None),
    ("dcgan_dc4_k5s2_n3", 1, 32, 128, 3, 5, 2, ((2, 3), (2, 3)), None),
]


# kernel F cases: (name, b, sq, sk, h, kh, d, causal, window, q_offset):
# tests/test_flash_attention_kernel.py's four geometries, ragged lengths, a
# non-causal D = 128 case, a decode-style row at q_offset 300, gemma3-1b's
# local layer (window 512, D = 256), a llama3.2-1b layer at S = 4096, the
# GQA groups of qwen2-7b (28/4), glm4-9b (32/2) and qwen2-vl-2b (12/2),
# recurrentgemma-2b's local layer (10/1, D = 256, window 2048),
# gemma3-1b's global layer (4/1, D = 256, no window), deepseek-v3-671b's
# MLA geometry (128/128, D = 192; S = 1024 keeps the f64 oracle's scores
# at 1 GB), a ragged D = 192 case with GQA and a q_offset, and
# seamless-m4t-large-v2's cross attention at decode (one query row over
# the 3072 memory rows, non-causal, 16/16 heads) at B = 4 and B = 1
FLASH_CASES = [
    ("jax_mha_d64", 1, 256, 256, 4, 4, 64, True, 0, 0),
    ("jax_gqa_d32", 2, 256, 256, 8, 2, 32, True, 0, 0),
    ("jax_mqa_window", 1, 512, 512, 4, 1, 64, True, 128, 0),
    ("jax_bidirectional", 1, 256, 256, 2, 2, 64, False, 0, 0),
    ("ragged_1000", 1, 1000, 1000, 32, 8, 64, True, 0, 0),
    ("noncausal_77_d128", 2, 77, 77, 4, 2, 128, False, 0, 0),
    ("decode_q_offset_300", 1, 1, 512, 32, 8, 64, True, 0, 300),
    ("gemma3_window_512", 1, 2048, 2048, 4, 1, 256, True, 512, 0),
    ("llama_4096", 1, 4096, 4096, 32, 8, 64, True, 0, 0),
    ("qwen2_7b_gqa7", 2, 1024, 1024, 28, 4, 128, True, 0, 0),
    ("glm4_9b_gqa16", 2, 1024, 1024, 32, 2, 128, True, 0, 0),
    ("qwen2_vl_2b_gqa6", 2, 1024, 1024, 12, 2, 128, True, 0, 0),
    ("recurrentgemma_window_2048", 1, 4096, 4096, 10, 1, 256, True, 2048,
     0),
    ("gemma3_global_d256", 1, 4096, 4096, 4, 1, 256, True, 0, 0),
    ("deepseek_mla_d192", 1, 1024, 1024, 128, 128, 192, True, 0, 0),
    ("ragged_gqa_offset_d192", 2, 777, 901, 16, 4, 192, True, 0, 124),
    ("s2t_cross_decode_B4", 4, 1, 3072, 16, 16, 64, False, 0, 0),
    ("s2t_cross_decode_B1", 1, 1, 3072, 16, 16, 64, False, 0, 0),
]
# kernel F against its plain version and the f64 oracle: f32 as
# tests/test_flash_attention_kernel.py:34 (2e-4); bf16 adds one bf16
# rounding of the output, a relative 2^-7
TOL_F = 2e-4
TOL_F_BF16_REL = 2.0 ** -7
# SDPA (bf16 P) against kernel F (f32 P) on bf16 inputs: the bf16 tolerance
# of tests/test_flash_attention_kernel.py:49
TOL_F_LIBRARY = 3e-2
# the llama3.2-1b prefill's last-position logits, kernel route against the
# plain attention route on the same bf16 weights, relative to max|logits|
# (the CPU tests' bf16 tolerance)
TOL_LM = 3e-2
# the LM families' prefill on f32 copies of the same weights (F's f32
# entry against the plain route): the CPU tests' f32 logits tolerance
TOL_LM_F32 = 1e-4
# recurrentgemma-2b's bf16 model sits 5-7% of max|logits| off its f32 twin
# on either attention route, its two bf16 routes up to 3.4% apart; F's
# output scaled by F_FAULT moves its logits 4.9% (PERF.md section 6): its
# own limit between the two.  F's bf16 entry is held there, as in every
# family, layer by layer (check_f_layers)
TOL_LM_ARCH = {"recurrentgemma-2b": 4e-2}
# the planted fault the bf16 gates must see: F's output 2^-5 off (four
# bf16 steps)
F_FAULT = 1 + 2.0 ** -5
LM_PREFILL = ((1, 4096), (8, 512))
# ContinuousBatcher requests: (prompt length, new tokens), 6 over 4 slots
LM_REQUESTS = ((8, 16), (5, 8), (7, 12), (3, 6), (6, 10), (4, 16))
# phases 3j/4i: the LM families at full width, bf16, one at a time, with
# the F launches a prefill must make (one an attention layer);
# the prefill geometry; the architectures whose slot graphs are held to
# eager and lone runs (the new cache kinds: local KV, RG-LRU and SSD
# states) and their requests, 5 over 4 slots so one slot is recycled
LM_FAMILIES = (("gemma3-1b", 12), ("qwen2-7b", 10), ("glm4-9b", 10),
               ("qwen2-vl-2b", 10), ("recurrentgemma-2b", 3),
               ("mamba2-130m", 0))
# the families' depth: each published model's first layers (the smoke
# ran the published depth until its training and encoder-decoder phases
# came; the cut holds its time): gemma3-1b two of its five-local-one-
# global blocks, recurrentgemma-2b three of its rec-rec-local blocks
# (PERF.md §5 keeps the full-depth rows)
FAMILY_DEPTH = {"gemma3-1b": 12, "qwen2-7b": 10, "glm4-9b": 10,
                "qwen2-vl-2b": 10, "recurrentgemma-2b": 9,
                "mamba2-130m": 8}
FAMILY_PREFILL = (1, 4096)
FAMILY_GRAPHS = ("gemma3-1b", "recurrentgemma-2b", "mamba2-130m")
FAMILY_REQUESTS = ((6, 8), (3, 6), (5, 4), (4, 8), (7, 5))
FAMILY_MAX_LEN = 24
# phases 3k/4j: the MoE families at full width in bf16, one at a time,
# their depth cut to fit one card's 80 GB (deepseek keeps its published
# first three dense layers; dbrx runs 4 of its 40, once 8, to hold the
# smoke's time): (arch, stages, F launches a prefill); the f32
# copy's stages (one layer of each kind that fits in f32); the positions
# each MoE layer is held to the f32 all-experts combine on
MOE_FAMILIES = (("dbrx-132b", ((("moe",), 4),), 4),
                ("deepseek-v3-671b", ((("mla",), 3), (("mla_moe",), 2)), 5))
MOE_F32_STAGES = {"dbrx-132b": ((("moe",), 1),),
                  "deepseek-v3-671b": ((("mla",), 1), (("mla_moe",), 1))}
MOE_SLICE = 64
# phases 3l/4k: seamless-m4t-large-v2 at full width and depth, bf16: the
# stub source frames (the config's SRC_FRAMES) and the decoder prefill
S2T_SRC = 3072
S2T_PREFILL = (1, 512)
# phases 3m/4l: llama3.2-1b training at full width and depth, bf16, AdamW:
# (B, S) (train_4k's sequence length), the key chunk of the attention
# core's backward (S / 4, as JAX's launch/train.py), the steps on one
# batch; the
# resumed train() run: (layers, steps, B, S, checkpoint every, fail at)
TRAIN_SHAPE = (2, 4096)
TRAIN_KV_CHUNK = 1024
TRAIN_SMOKE_STEPS = 3
TRAIN_RESUME = (1, 4, 2, 256, 2, 3)
# the first train step's loss and each gradient tensor, kernel route
# against the plain attention route (F's plain version forward, the same
# backward), bf16: relative to the plain route's loss and to each
# gradient's own max|g|.  Both routes share the backward, so each limit
# sits between the sound reading and a planted fault's (chip runs of
# these phases, NVIDIA H100 80GB HBM3, 700 W): gradients worst 3.22e-2
# (layers/0/ln1/g; median 1.68e-2 over the 147 tensors: F's last-bit
# differences from its plain version, carried through 16 bf16 layers and
# back), with the backward's dV scaled by F_FAULT 0.168 (layers/0/attn/
# v/w); the loss 5.98e-6, with F's output scaled by F_FAULT (forward
# only) 5.62e-5
TOL_TRAIN_LOSS = 2e-5
TOL_TRAIN_GRAD = 6e-2
# the attention backward on one training call against autograd through
# the dense f64 oracle, max|Δ| / max|oracle| of dQ, dK and dV: readings
# 1.92e-3-2.44e-3, each scaled by F_FAULT 2.66e-2-3.06e-2 (same card)
TOL_TRAIN_BWD = 1e-2
# device kernels of the MoE's dispatch (the router's top-k, the sort by
# expert, the gathers and the scatter-add), for the prefill's split
# phase 3n: JAX's plane-parallel geometries (CONVPLANE_SITES of
# src/repro/launch/dryrun.py:172-184) at their widths and batch, per tiling:
# (name, kind, H, C, N, k, stride, padding, dilation, (D_h, D_w), data)
PP_CASES = (
    ("dilated_context_385", "dilated", 385, 32, 32, 3, 1, ((2, 2), (2, 2)),
     2, (4, 1), 1),
    ("dilated_context_385", "dilated", 385, 32, 32, 3, 1, ((2, 2), (2, 2)),
     2, (2, 2), 1),
    ("decoder_96", "transposed", 96, 64, 32, 4, 2, ((1, 3), (1, 3)), 1,
     (2, 2), 1),
    ("decoder_96", "transposed", 96, 64, 32, 4, 2, ((1, 3), (1, 3)), 1,
     (4, 1), 1),
    ("encoder_512", "conv", 512, 16, 32, 3, 1, ((1, 1), (1, 1)), 1, (2, 1),
     2),
)
PP_BATCH = 4
PP_WORLD = 4
PP_UNET_BATCH = 1
PP_UNET_TILINGS = ((2, 1), (2, 2))     # on D_h·D_w of the PP_WORLD ranks
PP_CP_REQUESTS = 3
# a split U-Net forward's activation memory on one rank, (peak - before)
# over the single-device forward's, limit per tiling: the planes stay split
# between sites, so it falls towards 1/(D_h·D_w); the planted fault
# gathers every split site's output (the planes whole on every rank) and
# is read through the same gate
PP_MEM_LIMIT = {(2, 1): 0.75, (2, 2): 0.6}
# split against single-device, relative to max|single|, on the forward and
# both gradients: set between the sound reading (the local plans' other
# tiles and split K, and a superpack gradient summed over ranks, ~1e-6
# expected) and the planted faults' (a zeroed halo, an unsummed gradient:
# ~1e-1 expected); both are printed beside it
TOL_PP = 1e-4
DISPATCH_NAMES = ("index", "gather", "scatter", "sort", "topk", "radix",
                  "histogram", "bincount")
# phase 3i: images a model, prompt lengths, new tokens, the LM's cache
# length, the launches the injector kills (2: an image launch, 5: a decode
# step; the plane steps the LM and then launches one image bucket a pump),
# and 4h's timed decode steps
CP_IMAGES = 20
CP_PROMPTS = (5, 8, 3, 6, 4, 7)
CP_MAX_NEW = 8
CP_MAX_LEN = 32
CP_FAULTS = (2, 5)
# the starvation bound reads the host's clock; at 60 s it never flips a
# class pick inside the burst, so the faulted and the fault-free pass (its
# graphs captured at first launch, hundreds of ms later) group the same
# launches, and only the same launches give the same bits (cuBLAS and the
# kernels' K split follow the bucket)
CP_STARVATION_MS = 60_000.0
PRIORITY_OF = ("interactive", "batch")
DECODE_STEPS = 16
# device kernels of the dense products (cuBLAS / CUTLASS names)
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "matmul", "gemv", "splitk",
                "nvjet")


# device kernels of the port's conv kernels A-D by symbol, for the profiler
# splits, in match order: a symbol that holds another comes first
# ("deconv_kernel" holds "conv_kernel", "deconv_split_reduce" holds
# "conv_split_reduce", "deconv_tiled_kernel" holds "conv_tiled_kernel")
CONV_KERNELS = (("deconv_tiled_kernel", "D"), ("conv_tiled_kernel", "C"),
                ("deconv_thin_kernel", "A"), ("deconv_split_reduce", "A"),
                ("deconv_kernel", "A"), ("conv_split_reduce", "B"),
                ("conv_kernel", "B"))


def kernel_part(name: str) -> str:
    """Which of the port's conv kernels (A-D) a device kernel belongs to,
    by its symbol, else "other"."""
    return next((part for sym, part in CONV_KERNELS if sym in name), "other")


def device_events(fn, min_events, with_cpu=False, tries=3):
    """``fn()`` under ``torch.profiler``: (profile, its device kernels'
    events).  CUPTI now and then hands back a trace short of the kernels
    that ran; a trace with fewer than ``min_events`` timed device events is
    taken again, up to ``tries`` times, and after that the events are None
    (the caller reports the device time as not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * with_cpu + [ProfilerActivity.CUDA]
    for _ in range(tries):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and ev.device_time_total > 0]
        if len(evs) >= min_events:
            return prof, evs
        print(f"[profiler] trace holds {len(evs)} timed device events of "
              f"at least {min_events}: taken again")
    return prof, None


def ms_text(v, fmt=".4f"):
    """A device time (or a share of it) as printed: "not measured" where
    the profiler caught no trace."""
    return "not measured" if v is None else format(v, fmt)


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each kernel instantiation
    (kernel F's, kernel A's, B's, C's and D's and the reductions), from an
    ``nvcc -Xptxas -v`` log: [{"kernel", "registers", "stack_frame",
    "spill_stores", "spill_loads"}], the kernel
    named by its symbol and template arguments (int8_t for the int8
    entries)."""
    import re
    out = []
    names = {"i": str, "b": lambda v: "true" if v == "1" else "false"}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_fwd\w*?_kernel"
                      r"|deconv_kernel|deconv_thin_kernel|deconv_split_reduce"
                      r"|deconv_tiled_kernel|conv_tiled_kernel|conv_kernel"
                      r"|conv_split_reduce)"
                      r"(?:I(\w*?)EEv|E)", line)
        if m:
            args = [names[kind](v) if kind else
                    {"f": "float", "a": "int8_t"}[typ]
                    for kind, v, typ in re.findall(r"L([ib])(\d+)E|([fa])",
                                                   m.group(2) or "")]
            out.append({"kernel": f"{m.group(1)}<{', '.join(args)}>"
                        if m.group(2) else m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            (out[-1]["stack_frame"], out[-1]["spill_stores"],
             out[-1]["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def library_args(x, kernel, strides, padding):
    """``F.conv_transpose2d`` arguments computing the port's transposed conv
    (NHWC ``x``, HWIO ``kernel``, lhs-dilated correlation padding): NCHW
    input, the kernel flipped in space and laid out (C_in, C_out, kH, kW),
    ``padding = R - 1 - pad_lo`` and ``output_padding = pad_hi - pad_lo``."""
    r, s = kernel.shape[:2]
    (plh, phh), (plw, phw) = padding
    pad = (r - 1 - plh, s - 1 - plw)
    out_pad = (phh - plh, phw - plw)
    if min(pad + out_pad) < 0 or out_pad[0] >= strides[0] \
            or out_pad[1] >= strides[1]:
        raise ValueError(f"padding {padding} has no conv_transpose2d form")
    w = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return (x.permute(0, 3, 1, 2).contiguous(), w,
            dict(stride=tuple(strides), padding=pad, output_padding=out_pad))


def cropped_library_args(x, kernel, strides, padding):
    """``F.conv_transpose2d`` arguments computing the port's transposed conv
    where ``library_args`` finds no form (the cGAN's and the U-Net's pad
    (1, 3), whose ``output_padding`` would equal the stride): the full
    transposed conv (``padding=0``) cropped to the rows and columns from
    ``R - 1 - pad_lo``, as many as the padded conv has (``pad_hi <= R -
    1``); one call and a view.  Returns (NCHW input, (C_in, C_out, kH, kW)
    kernel, keywords, (row slice, column slice))."""
    r, s = kernel.shape[:2]
    (plh, phh), (plw, phw) = padding
    if not (0 <= plh <= r - 1 and 0 <= phh <= r - 1
            and 0 <= plw <= s - 1 and 0 <= phw <= s - 1):
        raise ValueError(f"padding {padding} has no cropped form")
    oh = (x.shape[1] - 1) * strides[0] + 1 + plh + phh - r + 1
    ow = (x.shape[2] - 1) * strides[1] + 1 + plw + phw - s + 1
    crop = (slice(r - 1 - plh, r - 1 - plh + oh),
            slice(s - 1 - plw, s - 1 - plw + ow))
    w = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return (x.permute(0, 3, 1, 2).contiguous(), w,
            dict(stride=tuple(strides)), crop)


def conv_library_args(xp, kernel, strides, dilation):
    """``F.conv2d`` arguments computing kernel B's valid correlation: the
    pre-padded NCHW plane (``padding=0``), the kernel as (N, C, R, S)."""
    return (xp.permute(0, 3, 1, 2).contiguous(),
            kernel.permute(3, 2, 0, 1).contiguous(),
            dict(stride=tuple(strides), dilation=tuple(dilation)))


def time_ms(fn, iters=20, warmup=3):
    """CUDA-event ms of one call of ``fn``, over ``iters`` back-to-back
    calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_device_ms(fn, iters=20, tries=4):
    """Device time of one call of ``fn`` (after a warm-up): its kernels'
    time over ``iters`` calls under ``torch.profiler``, per call.  Beside
    the CUDA-event time, which at B = 1 is the host's pace.  CUPTI now
    and then drops device events from a trace, a kernel's symbol at times
    altogether, so the time is taken per kernel symbol (the mean event
    times the launches a call makes, its events over ``iters``, rounded,
    summed over symbols) from a trace that holds every symbol a call
    launches: every symbol seen in any of at least two traces, and each of
    the port's kernels (A-D) that the warm-up call counted in its wrapper,
    each symbol with at least ``iters - 1`` events.  Failing that after
    ``tries`` traces the time is None (not measured).  With no event
    missing this is the sum over ``iters``."""
    import torch

    def counts():
        return {k: getattr(f, a) + getattr(f, a + "_int8")
                for k, (f, a) in launch_counters().items()}
    before = counts()
    fn()
    torch.cuda.synchronize()
    parts = {k for k, v in counts().items() if v > before[k]}

    def calls():
        for _ in range(iters):
            fn()
    traces, seen = [], set()
    for i in range(tries):
        _, evs = device_events(calls, 1, tries=1)
        if evs is not None:
            by_symbol = {}
            for ev in evs:
                by_symbol.setdefault(ev.name, []).append(
                    ev.device_time_total)
            traces.append(by_symbol)
            seen |= by_symbol.keys()
        if len(traces) < 2 and i < tries - 1:
            continue
        for by_symbol in traces:
            if parts <= {kernel_part(sym) for sym in by_symbol} and all(
                    len(by_symbol.get(sym, ())) >= iters - 1
                    for sym in seen):
                return sum(sum(v) / len(v) * max(1, round(len(v) / iters))
                           for v in by_symbol.values()) / 1e3
        print(f"[profiler] no trace holds every kernel of the call "
              f"({len(seen)} symbols seen, kernels {sorted(parts)}) with "
              f"{iters - 1} of its {iters} calls' events: taken again")
    return None


def f64_bound(plan, x, kern):
    """(y64, elementwise ULP bound) of ``plan``'s conv of ``x`` with the
    HWIO ``kern``: the f64 oracle, and the bound's term count per output
    element (per phase for the transposed kind)."""
    import torch
    from repro_torch.core import reference as ref
    sp_ = plan.spec
    if sp_.kind != "transposed":
        dil = sp_.dilation if sp_.kind == "dilated" else (1, 1)
        y64, amax = ref.conv_oracle_f64(x, kern, strides=sp_.strides,
                                        dilation=dil, padding=sp_.padding)
        return y64, ref.ulp_bound(y64, amax, sp_.kernel_hw[0]
                                  * sp_.kernel_hw[1] * sp_.in_c)
    y64, amax = ref.conv_oracle_f64(ref.zero_insert(x, sp_.strides), kern,
                                    padding=sp_.padding)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=x.device)
    for ex in plan.phases:
        terms[ex.q[0]::sp_.strides[0], ex.q[1]::sp_.strides[1]] = \
            ex.taps[0] * ex.taps[1] * sp_.in_c
    return y64, ref.ulp_bound(y64, amax, terms[None, :, :, None])


def check_library(name, y_lib, y_k):
    """The library yardstick's output against the kernel's (the library
    call must compute the same function before it is timed)."""
    err = float((y_lib - y_k).abs().max())
    if err > TOL_ROW * (1 + float(y_k.abs().max())):
        raise RuntimeError(f"library yardstick disagrees on {name}: "
                           f"{err:.3e}")
    return err


def schedule_of(plan, b):
    """Kernel A's schedule for a call, as printed beside its checks and
    times: tile, slice length, slices per phase, work units."""
    from repro_torch.kernels.untangled_conv import deconv_schedule
    sch = deconv_schedule(tuple(plan.phases), b, plan.spec.in_c,
                          plan.spec.out_c)
    return {"tile": list(sch.tile), "chunk_len": sch.chunk_len,
            "slices": list(sch.slices), "units": sch.units,
            "workspace_bytes": sch.workspace_bytes}


def conv_schedule_of(b, oh, ow, k, c, n):
    """Kernel B's schedule for a call, as printed beside its checks and
    times: tile, slice length, slices, work units, workspace."""
    from repro_torch.kernels.untangled_conv import conv_schedule
    sch = conv_schedule(b * oh * ow, k * k * c, n)
    return {"tile": list(sch.tile), "chunks": sch.chunks,
            "chunk_len": sch.chunk_len, "slices": sch.slices,
            "units": sch.units, "workspace_bytes": sch.workspace_bytes}


def launch_counters() -> dict:
    """Kernel -> (wrapper, f32 counter); the int8 entry's counter is the
    same name + ``_int8``."""
    from repro_torch.kernels.untangled_conv import (
        untangled_conv2d_superpack, untangled_deconv2d)
    return {"A": (untangled_deconv2d, "launches"),
            "B": (untangled_conv2d_superpack, "launches"),
            "C": (untangled_conv2d_superpack, "launches_tiled"),
            "D": (untangled_deconv2d, "launches_tiled")}


def zero_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)
        setattr(fn, attr + "_int8", 0)


def read_counts(wdtype):
    """({kernel: launches of ``wdtype``'s entry}, launches of the other
    dtype's entries) since the last ``zero_counts``."""
    suffix = "_int8" if wdtype == "int8" else ""
    other = "" if wdtype == "int8" else "_int8"
    counters = launch_counters()
    return ({k: getattr(fn, attr + suffix)
             for k, (fn, attr) in counters.items()},
            sum(getattr(fn, attr + other) for fn, attr in
                counters.values()))


def forward_split(fn, wall_ms):
    """One forward ``fn()`` (after one untimed) under ``torch.profiler``:
    device time of kernels A-D and of everything else, summed over
    device-side events, and the busy share against ``wall_ms`` (measured
    without the profiler); the shares are None where the profiler caught
    no trace."""
    import torch
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        _, evs = device_events(fn, 1, with_cpu=True)
    out = {f"{k}_ms": 0.0 for k in ("A", "B", "C", "D", "other")}
    for ev in evs or ():
        out[f"{kernel_part(ev.name)}_ms"] += ev.device_time_total / 1e3
    busy = sum(out.values())
    out.update(device_busy_ms=busy, wall_ms=wall_ms,
               busy_share=busy / wall_ms if evs else None,
               B_share=out["B_ms"] / busy if evs else None)
    return out


def graph_checks(batcher, fn, kernel, per_forward, gen):
    """The bucket graphs ``batcher.warmup`` captured, one by one: each
    recorded ``per_forward`` launches of ``kernel`` ("A", "B" or "B_int8")
    and nothing else, and its replay on random rows is bit-equal to
    ``fn`` run eagerly on the same static input (the replays here are not
    serving launches: the graph's count does not move).  Then one replay
    of the largest bucket under ``torch.profiler``: the device kernels of
    ``kernel``'s symbols (split-K reductions apart), or None (printed "not
    measured") where the trace does not show the graph's kernels; the
    capture count is the gate.  Returns that count."""
    import torch
    part = kernel[0]
    for b, g in sorted(batcher.graphs.items()):
        if g.kernels != {kernel: per_forward}:
            raise RuntimeError(f"bucket {b}: the capture recorded "
                               f"{g.kernels}, want {{{kernel!r}: "
                               f"{per_forward}}}")
        x, = g.inputs
        with torch.no_grad():
            x.copy_((torch.rand(x.shape, generator=gen) * 2 - 1).to(x))
        g.graph.replay()
        got = g.out.clone()
        with torch.inference_mode():
            want = fn(x)
        if not torch.equal(got, want):
            raise RuntimeError(f"bucket {b}: the graph's replay differs "
                               f"from the eager forward by "
                               f"{float((got - want).abs().max()):.3e}")
    g = batcher.graphs[max(batcher.graphs)]
    _, evs = device_events(g.graph.replay, 1)
    ran = None if evs is None else sum(
        1 for ev in evs if kernel_part(ev.name) == part
        and "split_reduce" not in ev.name)
    return ran if ran == per_forward else None


def site(h, c, n, k, s, pads, backend="cuda"):
    """The plan of a square transposed site."""
    from repro_torch.core.plan import ConvSpec, plan_conv
    return plan_conv(ConvSpec(
        kind="transposed", in_hw=(h, h), in_c=c, out_c=n,
        kernel_hw=(k, k), strides=(s, s), padding=pads, backend=backend))


def kernel_call(plan, xg, packed, **scales):
    """Kernel A (its int8 entry with ``scales=``) on the padded plane."""
    from repro_torch.kernels.untangled_conv import untangled_deconv2d
    return untangled_deconv2d(xg, packed, phases=plan.phases,
                              out_hw=plan.out_hw, strides=plan.spec.strides,
                              sum_uv=plan.sum_uv, **scales)


def ref_call(plan, xg, packed, **scales):
    """Kernel A's plain version, as ``kernel_call``."""
    from repro_torch.kernels.untangled_conv import untangled_deconv2d_ref
    return untangled_deconv2d_ref(xg, packed, phases=plan.phases,
                                  out_hw=plan.out_hw,
                                  strides=plan.spec.strides,
                                  sum_uv=plan.sum_uv, **scales)


def conv_call(xp, sp, k, s, d, plain=False, **scales):
    """Kernel B (or its plain version) on the pre-padded plane."""
    from repro_torch.kernels.untangled_conv import (
        untangled_conv2d_superpack, untangled_conv2d_superpack_ref)
    fn = untangled_conv2d_superpack_ref if plain \
        else untangled_conv2d_superpack
    return fn(xp, sp, taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d),
              **scales)


def seg_sites():
    """(name, in_hw, C, N, k, stride, dilation, pads) of every site of the
    full-width SegNet (``SEGNET``, ``segnet_plans``' geometry)."""
    from repro_torch.models import segnet
    return [(f"SegNet_L{i}", l.in_hw, l.in_c, l.out_c, l.kernel, l.stride,
             l.dilation, segnet.atrous_padding(l.kernel, l.dilation))
            for i, l in enumerate(segnet.SEGNET.layers)]


def disc_sites():
    """(name, in_hw, C, N, k, stride, pads) of every discriminator site of
    the Table-1 DCGAN and cGAN (``discriminator_plans``' mirror)."""
    from repro_torch.models import gan
    sites = []
    for tag, layers in (("DCGAN", gan.DCGAN_LAYERS),
                        ("cGAN", gan.CGAN_LAYERS)):
        for i, l in enumerate(reversed(layers)):
            k = l.kernel
            sites.append((f"{tag}_D{i + 1}", l.in_hw * l.stride, l.out_c,
                          l.in_c, k, l.stride,
                          ((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2))))
    return sites


def vae_sites():
    """(name, kind, in_hw, C, N, k, stride, pads) of the four sites of the
    full-width VAE (``vae_plans``' geometry): the encoder's strided convs
    (kernel B) and the decoder's transposed convs (kernel A)."""
    from repro_torch.models import gan, vae
    sites = []
    for i, l in enumerate(vae.VAE.encoder_layers):
        k = l.kernel
        sites.append((f"VAE_enc{i}", "conv", l.in_hw, l.in_c, l.out_c, k,
                      l.stride, ((k // 2, (k - 1) // 2),) * 2))
    for i, l in enumerate(vae.VAE.decoder_layers):
        sites.append((f"VAE_dec{i}", "transposed", l.in_hw, l.in_c, l.out_c,
                      l.kernel, l.stride,
                      gan.deconv_padding(l.kernel, l.stride)))
    return sites


def cut_depth(cfg, n):
    """``cfg`` with its first ``n`` layers only (its stages unrolled, one
    stage a layer); ``cfg`` itself where it has no more."""
    from repro_torch.models import transformer as tfm
    kinds = tfm.layer_kinds(cfg)
    if n >= len(kinds):
        return cfg
    return dataclasses.replace(cfg, stages=tuple(((k,), 1)
                                                 for k in kinds[:n]),
                               num_layers=n)


def attention_layers(cfg) -> int:
    """The attention layers of ``cfg``: kernel F's launches a prefill."""
    from repro_torch.models import transformer as tfm
    return sum(kind in tfm.ATTN_KINDS for kind in tfm.layer_kinds(cfg))


def check_prefill_logits(name, logits, ref_logits, cfg, b, tol=TOL_LM):
    """The kernel route's last-position logits against the plain route's:
    shape, finite, the vocab's padding columns at -1e30 on both routes,
    within ``tol·max|logits|`` over the vocab, the same argmax on every row whose top two logits sit more
    than twice the worst error apart.  Returns the record."""
    import torch
    if logits.shape != (b, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill {name}: logits {tuple(logits.shape)}"
                           f" not finite")
    v = cfg.vocab_size
    if not (bool((logits[:, v:] == -1e30).all())
            and bool((ref_logits[:, v:] == -1e30).all())):
        raise RuntimeError(f"prefill {name}: a padding column of the vocab "
                           f"is not masked")
    logits, ref_logits = logits[:, :v], ref_logits[:, :v]
    # a tied readout returns the f32 sum: most logits lie off the bf16
    # grid, none would after a bf16 rounding (an untied head rounds to
    # bf16 first, as JAX's dense_apply does)
    off_grid = int((logits.to(torch.bfloat16).float() != logits).sum())
    if cfg.tie_embeddings and off_grid == 0:
        raise RuntimeError(f"prefill {name}: every logit is a bf16 value")
    err = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    if err > tol * scale:
        raise RuntimeError(f"prefill {name}: kernel route {err:.3e} off "
                           f"the plain route (max|logits| {scale:.3f}, tol "
                           f"{tol}·max)")
    top2 = ref_logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = logits.argmax(-1) == ref_logits.argmax(-1)
    # a row whose top two logits sit within twice the worst error of each
    # other may flip by rounding alone; every other row must agree
    clear = gap > 2 * err
    if not bool(same[clear].all()):
        raise RuntimeError(f"prefill {name}: argmax differs from the plain "
                           f"route on a clear row")
    return {"max_abs_err_vs_plain": err, "max_abs_logit": scale,
            "argmax_equal_rows": int(same.sum()), "rows": b,
            "near_tie_rows": int((~clear).sum()),
            "logits_off_bf16_grid": off_grid, "logits": logits.numel(),
            "tol": tol}


def plain_core(q, k, v, *, causal=True, window=0, q_offset=0,
               kv_chunk=1024, scale=None):
    """F's plain version with the attention layer's core signature."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale,
                                    ck=kv_chunk)


@contextlib.contextmanager
def attention_core(wrap):
    """The attention layer's core (kernel F on the card) swapped for
    ``wrap(core, q, k, v, **kw)``."""
    from repro_torch.layers import attention
    core = attention.flash_attention
    attention.flash_attention = lambda q, k, v, **kw: wrap(core, q, k, v,
                                                           **kw)
    try:
        yield
    finally:
        attention.flash_attention = core


def plain_attention():
    """The attention core on F's plain version (the card's 'plain route')."""
    return attention_core(lambda core, q, k, v, **kw: plain_core(q, k, v,
                                                                 **kw))


def captured_attention(calls):
    """Kernel F as it is, each call's (q, k, v, keywords, output) appended
    to ``calls``."""
    def capture(core, q, k, v, **kw):
        out = core(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    return attention_core(capture)


def faulty_attention(factor):
    """Kernel F with its output scaled by ``factor``: a planted fault."""
    return attention_core(lambda core, q, k, v, **kw: (
        core(q, k, v, **kw).float() * factor).to(q.dtype))


def check_f_layers(name, calls, fault):
    """Kernel F's bf16 output at each captured layer of a prefill against
    F's plain version on the same q, k, v, element by element under
    ``TOL_F + TOL_F_BF16_REL·|plain|`` (the rule of the bf16
    ``FLASH_CASES``); and the same rule's reading of that output scaled by
    ``fault``, which must fail it at every layer.  Returns the worst share
    of the bound, the planted fault's least share and the worst |Δ|."""
    import torch
    worst, fault_least, err = 0.0, float("inf"), 0.0
    for i, (q, k, v, kw, got) in enumerate(calls):
        want = plain_core(q, k, v, **kw).float()
        bound = TOL_F + TOL_F_BF16_REL * want.abs()
        share = float(((got.float() - want).abs() / bound).max())
        planted = (got.float() * fault).to(got.dtype).float()
        fault_share = float(((planted - want).abs() / bound).max())
        err = max(err, float((got.float() - want).abs().max()))
        if not (share <= 1.0 and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"{name} attention layer {i}: kernel F at "
                               f"{share:.3f} of its bf16 bound against its "
                               f"plain version on the layer's q, k, v")
        if not fault_share > 1.0:
            raise RuntimeError(f"{name} attention layer {i}: F's output "
                               f"scaled by {fault} reads {fault_share:.3f} "
                               f"of the bound: the gate cannot see it")
        worst, fault_least = max(worst, share), min(fault_least, fault_share)
        del want, bound, planted
    return {"layers": len(calls), "worst_share": worst,
            "planted_fault": fault, "planted_least_share": fault_least,
            "max_abs_err": err}


def device_split(fn, wall_ms, dispatch=False):
    """One call of ``fn`` under ``torch.profiler``: device time of kernel
    F, of the dense products (with ``dispatch``: of the MoE's dispatch
    kernels, ``DISPATCH_NAMES``) and of everything else, the number of
    device kernels, and the idle share against ``wall_ms`` (its time
    measured without the profiler); the shares are None where the
    profiler caught no trace."""
    _, evs = device_events(fn, 1, with_cpu=True)
    out = {"F_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0, "F_calls": 0,
           "device_kernels": 0, **({"dispatch_ms": 0.0} if dispatch else {})}
    for ev in evs or ():
        name = ev.name.lower()
        part = ("F" if "flash_fwd" in name
                else "matmul" if any(p in name for p in MATMUL_NAMES)
                else "dispatch" if dispatch and any(p in name for p in
                                                    DISPATCH_NAMES)
                else "other")
        out[f"{part}_ms"] += ev.device_time_total / 1e3
        out["F_calls"] += part == "F"
        out["device_kernels"] += 1
    busy = sum(out[k] for k in ("F_ms", "matmul_ms", "other_ms",
                                "dispatch_ms") if k in out)
    out.update(device_busy_ms=busy, wall_ms=wall_ms,
               idle_share=1 - busy / wall_ms if evs else None)
    return out


def lm_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 2g, 3f, 3g and 4e: kernel F against its plain version and the
    f64 oracle, the full-width llama3.2-1b prefill on F (launches, finite
    logits, kernel route against the plain attention route), greedy serving
    through ``serve`` and ``ContinuousBatcher`` (tokens equal to lone runs,
    no F launch at decode), and the times.  Returns (records for the
    results line, F's entry for the kernels line)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    # ---- 2g. kernel F vs its plain version, both vs the f64 oracle --------
    max_err_f = max_err_bf16 = gate_share_bf16 = 0.0
    for case in FLASH_CASES:
        name, b, sq, sk, h, kh, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                       for shape in ((b, sq, h, d), (b, sk, kh, d),
                                     (b, sk, kh, d)))
            torch.full((q.numel(),), float("nan"), device=dev)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            plain = fa.flash_attention_plain(q, k, v, **kw)
            oracle = flash_attention_ref(q.double(), k.double(), v.double(),
                                         **kw)
            rel = TOL_F_BF16_REL if dtype == torch.bfloat16 else 0.0
            errs, share = {}, 0.0
            for tag, want in (("plain", plain), ("f64", oracle)):
                diff = (got.double() - want.double()).abs()
                bound = TOL_F + rel * want.double().abs()
                errs[tag] = float(diff.max())
                share = max(share, float((diff / bound).max()))
                if not bool((diff <= bound).all()) or not bool(
                        torch.isfinite(got).all()):
                    raise RuntimeError(
                        f"kernel F off its {tag} reference at {name} "
                        f"{dtype}: max|Δ| {errs[tag]:.3e}")
            if dtype == torch.float32:
                max_err_f = max(max_err_f, errs["plain"], errs["f64"])
            else:
                max_err_bf16 = max(max_err_bf16, errs["plain"], errs["f64"])
                gate_share_bf16 = max(gate_share_bf16, share)
            print(f"[F] {name} {str(dtype)[6:]}: max|Δ| vs plain "
                  f"{errs['plain']:.3e}, vs f64 oracle {errs['f64']:.3e}, "
                  f"{share:.3f} of the tolerance")
            del q, k, v, got, plain, oracle
    torch.cuda.empty_cache()
    print(f"[F] kernel F within 2e-4 (f32; + 2^-7·|o| in bf16) of its plain "
          f"version and the f64 oracle at {len(FLASH_CASES)} geometries, "
          f"f32 and bf16; worst f32 error {max_err_f:.3e}, worst bf16 error "
          f"{max_err_bf16:.3e} ({gate_share_bf16:.3f} of its tolerance)")

    # ---- 3f. the llama3.2-1b prefill at full width, bf16 -------------------
    cfg = registry.get_config("llama3.2-1b")
    params = tfm.init(cfg, seed=0, device=dev)

    n_params = sum(t.numel() for t in _tensors(params))
    prefill = make_prefill_step(cfg)
    f_paths, prefill_rec, batches = {}, {}, {}
    for b, s in LM_PREFILL:
        tag = f"B{b}_S{s}"
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        batches[tag] = {"inputs": toks.to(dev)}
        fa.flash_attention.launches = 0
        logits = prefill(params, batches[tag])
        torch.cuda.synchronize()
        f_paths[f"lm_prefill_{tag}"] = fa.flash_attention.launches
        if fa.flash_attention.launches != attention_layers(cfg):
            raise RuntimeError(f"prefill {tag}: kernel F launched "
                               f"{fa.flash_attention.launches} times, not "
                               f"once for each of {attention_layers(cfg)} "
                               f"attention layers")
        with plain_attention():
            ref_logits = prefill(params, batches[tag])
        rec = check_prefill_logits(tag, logits, ref_logits, cfg, b)
        prefill_rec[tag] = {"launches": f_paths[f"lm_prefill_{tag}"], **rec}
        print(f"[lm] prefill {tag}: {prefill_rec[tag]['launches']} F "
              f"launches, logits "
              f"finite, kernel vs plain route max|Δ| "
              f"{rec['max_abs_err_vs_plain']:.3e} (max|logits| "
              f"{rec['max_abs_logit']:.3f}, tol {TOL_LM}·max), argmax equal "
              f"on {rec['argmax_equal_rows']}/{b} rows "
              f"({rec['near_tie_rows']} near ties); "
              f"{rec['logits_off_bf16_grid']}/{logits.numel()} logits off "
              f"the bf16 grid (f32 readout)")
        del logits, ref_logits

    # ---- 3g. greedy serving: serve() and ContinuousBatcher -----------------
    fa.flash_attention.launches = 0
    served, serve_s = serve("llama3.2-1b", reduced=False, batch=4,
                            prompt_len=8, gen_tokens=16, device=dev)
    if served.shape != (4, 16) or served.min() < 0 \
            or served.max() >= cfg.vocab_size:
        raise RuntimeError(f"serve: tokens {served.shape} out of range")
    f_paths["lm_serve"] = fa.flash_attention.launches
    torch.cuda.empty_cache()

    def requests():
        g = torch.Generator().manual_seed(7)
        return [Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (p,), generator=g).numpy(), max_new=n)
            for i, (p, n) in enumerate(LM_REQUESTS)]

    fa.flash_attention.launches = 0
    batcher = ContinuousBatcher(cfg, params, slots=4, max_len=32, device=dev)
    batcher.warmup()                    # the slot graphs, outside the time
    for r in requests():
        batcher.submit(r)
    t0 = time.perf_counter()
    steps = batcher.run()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    f_paths["lm_batcher"] = fa.flash_attention.launches
    if f_paths["lm_serve"] or f_paths["lm_batcher"]:
        raise RuntimeError(f"kernel F launched at decode: {f_paths}")
    got = {r.rid: r.out for r in batcher.done}
    for r in requests():
        lone = ContinuousBatcher(cfg, params, slots=1, max_len=32,
                                 device=dev)
        lone.submit(r)
        lone.run()
        if r.out != got[r.rid] or len(r.out) != r.max_new:
            raise RuntimeError(f"request {r.rid}: batched tokens "
                               f"{got[r.rid]} != lone run {r.out}")
    n_tok = sum(len(o) for o in got.values())
    st = batcher.stats()
    serve_rec = {"serve_tokens": int(served.size), "serve_s": serve_s,
                 "serve_tok_per_s": served.size / serve_s,
                 "batcher_requests": len(got), "batcher_steps": steps,
                 "batcher_tokens": n_tok, "batcher_s": batch_s,
                 "batcher_tok_per_s": n_tok / batch_s,
                 "batcher_p50_ms": st["p50_ms"],
                 "batcher_ttft_p95_ms": st["ttft_p95_ms"]}
    print(f"[lm] serve (B=4, 8-token prompts, 16 new): "
          f"{served.size / serve_s:.1f} tok/s (host clock, token-by-token "
          f"prompt); ContinuousBatcher {len(got)} requests over 4 slots: "
          f"{n_tok} tokens in {steps} steps, {n_tok / batch_s:.1f} tok/s, "
          f"each request's tokens equal to its lone run; 0 F launches at "
          f"decode")

    # ---- 4e. times: kernel F a layer, the prefill step, decode -------------
    f_times = []
    for b, s in LM_PREFILL:
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
        rec = f_layer_time(fa, F, q, k, v, 0, peak_bw, peak_bf16, time_ms)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        rec.update(site=f"B{b}_S{s}", f32_ms=time_ms(
            lambda: fa.flash_attention(q32, k32, v32)))
        f_times.append(rec)
        print(f"[time] kernel F llama layer B={b} S={s}: kernel "
              f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s; the f32 "
              f"FFMA entry on the same values {rec['f32_ms']:.4f} ms), plain "
              f"{rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel "
              f"at {rec['bound_ms'] / rec['ms']:.1%} of bound")
        del q, k, v, q32, k32, v32
    prefill_ms = {tag: time_ms(lambda: prefill(params, batch), iters=5,
                               warmup=1)
                  for tag, batch in batches.items()}
    print(f"[time] llama3.2-1b prefill step (bf16, {cfg.num_layers} layers, "
          f"last-position logits) ms: {json.dumps(prefill_ms)}")

    split = {tag: device_split(lambda: prefill(params, batch),
                               prefill_ms[tag])
             for tag, batch in batches.items()}
    print(f"[time] llama3.2-1b prefill, device time by part "
          f"(torch.profiler, one step after the timed ones): "
          f"{json.dumps(split)}")
    cache = tfm.init_cache(cfg, 4, 32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)

    def decode():
        with torch.no_grad():
            tfm.decode_step(params, cache, tok, 10, cfg)
    decode_ms = time_ms(decode)
    split["decode_B4"] = device_split(decode, decode_ms)
    print(f"[time] llama3.2-1b decode_step at B=4 (cache 32): "
          f"{decode_ms:.4f} ms a step, {4 / decode_ms * 1e3:.1f} tok/s; "
          f"one step under torch.profiler: {json.dumps(split['decode_B4'])}")

    big = f_times[0]
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::_kernel",
        "launches": sum(f_paths.values()), "launches_by_path": f_paths,
        "held_against_plain": True, "max_abs_err": max_err_f,
        "max_abs_err_bf16": max_err_bf16,
        "tolerance_share_bf16": gate_share_bf16,
        "shape": f"llama3.2-1b attention layer, B={big['batch']} "
                 f"S={big['seq']}, bf16, causal",
        **{k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "f32_ms")}}
    records = {"lm_params": n_params, "lm_prefill": prefill_rec,
               "lm_serve": serve_rec, "flash_sites": f_times,
               "lm_prefill_ms": prefill_ms, "lm_prefill_split": split,
               "lm_decode_ms_B4": decode_ms}
    return records, entry


def f_layer_time(fa, F, q, k, v, window, peak_bw, peak_bf16, time_ms,
                 causal=True):
    """Kernel F at one bf16 layer beside its plain version, the library
    call (SDPA with ``enable_gqa``; a window as an explicit boolean
    ``attn_mask``, checked against F first) and the bound, whose FLOPs
    count the pairs the mask leaves: Σ_q min(q + 1, w) a head, S(S + 1)/2
    with no window; Sq·Sk with ``causal=False`` (q and k may then differ
    in length: a cross attention)."""
    import torch
    b, s, h, d = q.shape
    sk = k.shape[1]
    y_k = fa.flash_attention(q, k, v, window=window, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)

    def library():
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float()
                     - y_k.float()).abs().max())
    if lib_err > TOL_F_LIBRARY:
        raise RuntimeError(f"library yardstick disagrees with kernel F at "
                           f"S={s} window={window}: {lib_err:.3e}")
    flops, nbytes = fa.work(q, k, v, causal=causal, window=window)
    pairs = flops // (4 * d)
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
    rec = {"batch": b, "seq": s, "keys": sk, "heads": h,
           "kv_heads": k.shape[2], "head_dim": d, "window": window,
           "causal": causal, "pairs": pairs, "flops": flops,
           "bytes": nbytes,
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, window=window,
                                                    causal=causal)),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, window=window, causal=causal)),
           "library_ms": time_ms(library),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_max_abs_err": lib_err}
    rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def lm_family_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 3j and 4i: gemma3-1b, qwen2-7b, glm4-9b, qwen2-vl-2b,
    recurrentgemma-2b and mamba2-130m at full width in bf16, each cut to
    its first ``FAMILY_DEPTH`` layers, one at a time (each freed before
    the next): a prefill step at
    ``FAMILY_PREFILL`` launching F once an attention layer, its logits
    finite and within ``TOL_LM`` (``TOL_LM_ARCH``) of the plain attention
    route, F's bf16 output at every attention layer within its bf16 bound
    of the plain version on that layer's q, k, v, and a planted fault
    (``F_FAULT``) caught by that gate; qwen2-vl-2b's prefill also on
    (B, S, D) embeddings (the ``vlm_stub`` frontend); ``serve``
    (16 greedy tokens at B = 4); for ``FAMILY_GRAPHS`` a
    ``ContinuousBatcher`` on slot graphs whose tokens equal an eager
    (``graphs=False``) run's and each request's lone run's, with no F
    launch at decode; the times (prefill ms and device split, a B = 4
    ``decode_step``) and F at gemma3-1b's local and global layers.
    Returns (records for the results line, F's launches by path, F's
    gemma3 layer times)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    b, s = FAMILY_PREFILL
    f_paths, records = {}, {}
    for arch, n_attn in LM_FAMILIES:
        t_arch = time.perf_counter()
        cfg = cut_depth(registry.get_config(arch), FAMILY_DEPTH[arch])
        if attention_layers(cfg) != n_attn:
            raise RuntimeError(f"{arch}: {attention_layers(cfg)} attention "
                               f"layers, not {n_attn}")
        params = tfm.init(cfg, seed=0, device=dev)
        n_params = sum(t.numel() for t in _tensors(params))
        prefill = make_prefill_step(cfg)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        batch = {"inputs": toks.to(dev)}
        # ---- 3j. the prefill: F once an attention layer, vs plain -------
        calls = []
        fa.flash_attention.launches = 0
        with captured_attention(calls):
            logits = prefill(params, batch)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        f_paths[f"{arch}_prefill_B{b}_S{s}"] = launches
        if launches != n_attn:
            raise RuntimeError(f"{arch} prefill: kernel F launched "
                               f"{launches} times, not once for each of "
                               f"{n_attn} attention layers")
        # F's bf16 entry layer by layer, on the activations of this run
        layers_f = check_f_layers(arch, calls, F_FAULT)
        del calls
        with plain_attention():
            ref_logits = prefill(params, batch)
        # the same weights in f32: F's f32 entry against the plain route
        # under TOL_LM_F32, and the plain route's f32 logits as the truth
        # the two bf16 routes are measured from
        p32 = _tree_map(lambda t: t.float(), params)
        logits32 = prefill(p32, batch)
        with plain_attention():
            truth = prefill(p32, batch)
        del p32
        rec32 = check_prefill_logits(f"{arch} f32", logits32, truth, cfg, b,
                                     tol=TOL_LM_F32)
        v = cfg.vocab_size
        scale = float(truth[:, :v].abs().max())
        noise = {route: float((x[:, :v] - truth[:, :v]).abs().max()) / scale
                 for route, x in (("kernel", logits), ("plain", ref_logits))}
        # the kernel's bf16 route no further from the f32 logits than the
        # plain bf16 route, within TOL_LM
        if noise["kernel"] > noise["plain"] + TOL_LM:
            raise RuntimeError(f"{arch} prefill: the bf16 kernel route sits "
                               f"{noise['kernel']:.4f}·max off the f32 "
                               f"logits, the plain route {noise['plain']:.4f}")
        # what the bf16 logit gate reads of the planted fault
        with faulty_attention(F_FAULT):
            planted = prefill(params, batch)
        planted_rel = float((planted[:, :v] - ref_logits[:, :v]).abs().max()
                            / ref_logits[:, :v].abs().max())
        tol = TOL_LM_ARCH.get(arch, TOL_LM)
        rec = {"params": n_params, "layers": cfg.num_layers,
               "attention_layers": n_attn, "prefill_launches": launches,
               **check_prefill_logits(arch, logits, ref_logits, cfg, b,
                                      tol=tol),
               "f32": rec32, "bf16_rel_err_vs_f32": noise,
               "f_layers_bf16": layers_f,
               "planted_fault_rel_err_vs_plain": planted_rel}
        del logits, ref_logits, logits32, truth, planted
        print(f"[lm3j] {arch} ({n_params / 1e9:.2f} B params, "
              f"{cfg.num_layers} layers) prefill B={b} S={s}: {launches} F "
              f"launches ({n_attn} attention layers), logits finite; bf16 "
              f"kernel vs plain route max|Δ| "
              f"{rec['max_abs_err_vs_plain']:.3e} (max|logits| "
              f"{rec['max_abs_logit']:.3f}, tol {tol}·max; F's output "
              f"{F_FAULT} times reads {planted_rel:.4f}·max); F's bf16 "
              f"entry at each of {layers_f['layers']} layers vs its plain "
              f"version on the layer's q, k, v: worst "
              f"{layers_f['worst_share']:.3f} of its bound (the planted "
              f"fault at least {layers_f['planted_least_share']:.3f}); "
              f"bf16 kernel / plain route off the f32 logits "
              f"{noise['kernel']:.4f} / {noise['plain']:.4f}·max; f32 "
              f"kernel vs plain route {rec32['max_abs_err_vs_plain']:.3e} "
              f"(tol {TOL_LM_F32}·max)")
        if arch == "qwen2-vl-2b":
            # the vlm_stub frontend: (B, S, D) embeddings for the tokens
            emb_batch = {"embeds": torch.randn(
                (b, s, cfg.d_model), generator=gen).to(dev, torch.bfloat16)}
            fa.flash_attention.launches = 0
            emb_logits = prefill(params, emb_batch)
            torch.cuda.synchronize()
            emb_launches = fa.flash_attention.launches
            f_paths[f"{arch}_prefill_embeds_B{b}_S{s}"] = emb_launches
            if emb_launches != n_attn:
                raise RuntimeError(f"{arch} prefill on embeddings: kernel F "
                                   f"launched {emb_launches} times, not "
                                   f"{n_attn}")
            with plain_attention():
                emb_ref = prefill(params, emb_batch)
            rec["embeds"] = check_prefill_logits(f"{arch} embeds",
                                                 emb_logits, emb_ref, cfg, b)
            del emb_batch, emb_logits, emb_ref
            print(f"[lm3j] {arch} prefill on (B, S, D) embeddings "
                  f"(vlm_stub): {emb_launches} F launches, logits finite; "
                  f"bf16 kernel vs plain route max|Δ| "
                  f"{rec['embeds']['max_abs_err_vs_plain']:.3e} (max|logits| "
                  f"{rec['embeds']['max_abs_logit']:.3f}, tol {TOL_LM}·max)")
        # ---- 3j. serve(): 16 greedy tokens at B = 4 -----------------------
        fa.flash_attention.launches = 0
        served, serve_s = serve(arch, reduced=False, batch=4, prompt_len=8,
                                gen_tokens=16, device=dev, params=params)
        f_paths[f"{arch}_serve"] = fa.flash_attention.launches
        if served.shape != (4, 16) or served.min() < 0 \
                or served.max() >= cfg.vocab_size:
            raise RuntimeError(f"{arch} serve: tokens {served.shape} out of "
                               f"range")
        rec.update(serve_tokens=int(served.size), serve_s=serve_s,
                   serve_tok_per_s=served.size / serve_s)
        # ---- 3j. slot graphs against eager and lone runs -----------------
        if arch in FAMILY_GRAPHS:
            def requests():
                g = torch.Generator().manual_seed(11)
                return [Request(rid=i, prompt=torch.randint(
                    0, cfg.vocab_size, (p,), generator=g).numpy(),
                    max_new=n) for i, (p, n) in enumerate(FAMILY_REQUESTS)]

            def run(slots, graphs, reqs):
                cb = ContinuousBatcher(cfg, params, slots=slots,
                                       max_len=FAMILY_MAX_LEN, device=dev,
                                       graphs=graphs)
                cb.warmup()
                for r in reqs:
                    cb.submit(r)
                t0 = time.perf_counter()
                steps = cb.run()
                torch.cuda.synchronize()
                return ({r.rid: r.out for r in cb.done}, steps,
                        time.perf_counter() - t0)
            fa.flash_attention.launches = 0
            got, steps, graph_s = run(4, True, requests())
            f_paths[f"{arch}_batcher"] = fa.flash_attention.launches
            eager, _, eager_s = run(4, False, requests())
            for r in requests():
                lone, _, _ = run(1, True, [r])
                if got[r.rid] != eager[r.rid] or got[r.rid] != lone[r.rid] \
                        or len(got[r.rid]) != r.max_new:
                    raise RuntimeError(
                        f"{arch} request {r.rid}: slot-graph tokens "
                        f"{got[r.rid]}, eager {eager[r.rid]}, lone run "
                        f"{lone[r.rid]}")
            n_tok = sum(len(o) for o in got.values())
            rec.update(batcher_requests=len(got), batcher_steps=steps,
                       batcher_tokens=n_tok, batcher_graph_s=graph_s,
                       batcher_eager_s=eager_s)
            print(f"[lm3j] {arch} ContinuousBatcher {len(got)} requests "
                  f"over 4 slots on slot graphs: {n_tok} tokens in {steps} "
                  f"steps ({graph_s:.3f} s; eager {eager_s:.3f} s), every "
                  f"request's tokens equal to the eager run's and to its "
                  f"lone run's")
        decode_launches = {k: v for k, v in f_paths.items()
                           if k.startswith(arch) and "prefill" not in k}
        if any(decode_launches.values()):
            raise RuntimeError(f"{arch}: kernel F launched at decode: "
                               f"{decode_launches}")
        # ---- 4i. times: the prefill with its split, a B = 4 decode step --
        rec["prefill_ms"] = time_ms(lambda: prefill(params, batch), iters=3,
                                    warmup=1)
        rec["prefill_split"] = device_split(lambda: prefill(params, batch),
                                            rec["prefill_ms"])
        cache = tfm.init_cache(cfg, 4, 32, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)

        def decode():
            with torch.no_grad():
                tfm.decode_step(params, cache, tok, 10, cfg)
        rec["decode_ms_B4"] = time_ms(decode, iters=10, warmup=2)
        sp = rec["prefill_split"]
        rec["arch_s"] = time.perf_counter() - t_arch
        print(f"[lm4i] {arch} prefill B={b} S={s}: {rec['prefill_ms']:.3f} "
              f"ms; device F {sp['F_ms']:.3f}, products "
              f"{sp['matmul_ms']:.3f}, other {sp['other_ms']:.3f} ms, idle "
              f"share {ms_text(sp['idle_share'], '.3f')}; decode_step B=4 "
              f"{rec['decode_ms_B4']:.3f} ms; serve "
              f"{rec['serve_tok_per_s']:.1f} tok/s; {rec['arch_s']:.1f} s "
              f"for this architecture")
        records[arch] = rec
        del params, cache, batch, prefill
        torch.cuda.empty_cache()
    # ---- 4i. F at gemma3-1b's local (window 512) and global layers -------
    cfg = registry.get_config("gemma3-1b")
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    f_times = []
    for kind, window in (("local", cfg.window), ("global", 0)):
        t = f_layer_time(fa, F, q, k, v, window, peak_bw, peak_bf16,
                         time_ms)
        t["site"] = f"gemma3-1b {kind} B={b} S={s}"
        f_times.append(t)
        print(f"[time] kernel F gemma3-1b {kind} layer (B={b} S={s} H={h}/"
              f"{kh} D={d} window {window}): kernel {t['ms']:.4f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms, "
              f"SDPA {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {t['pairs']} pairs), kernel at "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")
    del q, k, v
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[lm3j] the six LM families' phases took {phase_s:.1f} s")
    return ({"lm_families": records, "lm_families_s": phase_s,
             "flash_gemma3_sites": f_times}, f_paths, f_times)


@contextlib.contextmanager
def captured_moe(records):
    """The MoE (``layers.moe.moe_apply``) as it is, each call's params,
    first ``MOE_SLICE`` positions of input and output and its routing
    indices over every position appended to ``records``."""
    from repro_torch.layers import moe
    core = moe.moe_apply

    def capture(p, x, cfg):
        out = core(p, x, cfg)
        _, idx = moe._route(x.reshape(-1, x.shape[-1]), p, cfg)
        records.append((p, x[:, :MOE_SLICE].clone(), idx,
                        out[:, :MOE_SLICE].clone()))
        return out
    moe.moe_apply = capture
    try:
        yield
    finally:
        moe.moe_apply = core


def check_moe_layers(name, records, cfg, fault):
    """Each captured MoE layer's output (bf16) on its first ``MOE_SLICE``
    positions against ``moe_apply_dense`` (every expert on every token in
    f32, combined by the gate matrix) on the same input, element by
    element under the bf16 ``FLASH_CASES`` rule ``TOL_F +
    TOL_F_BF16_REL·|want|``; rows whose routing on the slice differs from
    the whole sequence's (a near tie read through another product shape)
    are counted and left out; the output scaled by ``fault`` must fail
    the rule at every layer.  Returns the worst share, the planted fault's
    least share, the worst |Δ| and the rows left out."""
    import torch

    from repro_torch.layers import moe
    worst, fault_least, err, skipped = 0.0, float("inf"), 0.0, 0
    for i, (p, x, idx, got) in enumerate(records):
        x2 = x.reshape(-1, x.shape[-1])
        _, idx_s = moe._route(x2, p, cfg)
        same = (idx_s.sort(-1).values
                == idx[:x2.shape[0]].sort(-1).values).all(-1)
        skipped += int((~same).sum())
        want = moe.moe_apply_dense(p, x.float(), cfg).reshape(x2.shape)
        got = got.reshape(x2.shape).float()
        bound = TOL_F + TOL_F_BF16_REL * want.abs()
        share = float(((got - want).abs() / bound)[same].max())
        planted = (got * fault).to(torch.bfloat16).float()
        fault_share = float(((planted - want).abs() / bound)[same].max())
        err = max(err, float((got - want)[same].abs().max()))
        if not (share <= 1.0 and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"{name} MoE layer {i}: {share:.3f} of its "
                               f"bf16 bound against the f32 all-experts "
                               f"combine on the layer's input")
        if not fault_share > 1.0:
            raise RuntimeError(f"{name} MoE layer {i}: the output scaled by "
                               f"{fault} reads {fault_share:.3f} of the "
                               f"bound: the gate cannot see it")
        worst, fault_least = max(worst, share), min(fault_least, fault_share)
    return {"layers": len(records), "positions": MOE_SLICE,
            "worst_share": worst, "planted_fault": fault,
            "planted_least_share": fault_least, "max_abs_err": err,
            "rows_route_differs_on_slice": skipped}


def routing_flips(a, b):
    """Tokens whose selected expert set differs, layer by layer, between
    two runs' captured MoE layers."""
    return [int((ra[2].sort(-1).values != rb[2].sort(-1).values).any(-1)
                .sum()) for ra, rb in zip(a, b)]


def logits_record(name, logits, ref_logits, cfg, b):
    """The kernel route's last-position logits beside the plain route's:
    shape, finite, the vocab's padding columns at -1e30 on both (failing
    otherwise); their max|Δ| and argmax agreement, reported."""
    import torch
    v = cfg.vocab_size
    if logits.shape != (b, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill {name}: logits {tuple(logits.shape)}"
                           f" not finite")
    if not (bool((logits[:, v:] == -1e30).all())
            and bool((ref_logits[:, v:] == -1e30).all())):
        raise RuntimeError(f"prefill {name}: a padding column of the vocab "
                           f"is not masked")
    return {"max_abs_err_vs_plain": float((logits[:, :v] - ref_logits[:, :v])
                                          .abs().max()),
            "max_abs_logit": float(ref_logits[:, :v].abs().max()),
            "argmax_equal_rows": int((logits[:, :v].argmax(-1)
                                      == ref_logits[:, :v].argmax(-1)).sum()),
            "rows": b}


def lm_moe_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 3k and 4j: dbrx-132b and deepseek-v3-671b at full width in
    bf16 with the depth of ``MOE_FAMILIES``, one at a time (every earlier
    allocation freed first): the prefill at ``FAMILY_PREFILL`` launching F
    once an attention layer, F's bf16 output at every attention layer
    against its plain version (``check_f_layers``) and each MoE layer
    against the f32 all-experts combine (``check_moe_layers``), each with
    its planted fault caught; the routing flips between the kernel and the
    plain attention route; an f32 copy at ``MOE_F32_STAGES`` (F's f32
    entry against the plain route, ``TOL_LM_F32``); ``serve`` (16 greedy
    tokens at B = 4); a ``ContinuousBatcher`` on slot graphs whose tokens
    equal an eager run's and each request's lone run's, with no F launch
    at decode; the times (prefill ms and device split, a B = 4
    ``decode_step``, one MoE layer's B = 1 decode) and F at deepseek's MLA
    layer and dbrx's attention layer.  Returns (records for the results
    line, F's launches by path, F's layer times)."""
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.layers import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    b, s = FAMILY_PREFILL
    f_paths, records = {}, {}
    for arch, stages, n_attn in MOE_FAMILIES:
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        full = registry.get_config(arch)
        cfg = dataclasses.replace(
            full, stages=stages, num_layers=sum(len(k) * r for k, r in
                                                stages))
        if attention_layers(cfg) != n_attn:
            raise RuntimeError(f"{arch}: {attention_layers(cfg)} attention "
                               f"layers, not {n_attn}")
        params = tfm.init(cfg, seed=0, device=dev)
        n_params = sum(t.numel() for t in _tensors(params))
        print(f"[lm3k] {arch}: full width, depth cut to {cfg.num_layers} of "
              f"{full.num_layers} layers ({tfm.layer_kinds(cfg)}), "
              f"{n_params / 1e9:.2f} B params in bf16, "
              f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the "
              f"card ({resident / 2 ** 30:.2f} GiB of it from earlier "
              f"phases)")
        prefill = make_prefill_step(cfg)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        batch = {"inputs": toks.to(dev)}
        # ---- 3k. the prefill: F once an attention layer, F and the MoE
        # held layer by layer ----------------------------------------------
        calls, moe_k, moe_p = [], [], []
        fa.flash_attention.launches = 0
        with captured_attention(calls), captured_moe(moe_k):
            logits = prefill(params, batch)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        f_paths[f"{arch}_prefill_B{b}_S{s}"] = launches
        if launches != n_attn:
            raise RuntimeError(f"{arch} prefill: kernel F launched "
                               f"{launches} times, not once for each of "
                               f"{n_attn} attention layers")
        layers_f = check_f_layers(arch, calls, F_FAULT)
        del calls
        layers_moe = check_moe_layers(arch, moe_k, cfg, F_FAULT)
        with plain_attention(), captured_moe(moe_p):
            ref_logits = prefill(params, batch)
        flips = routing_flips(moe_k, moe_p)
        del moe_k, moe_p
        rec = {"params": n_params, "layers": cfg.num_layers,
               "published_layers": full.num_layers,
               "layer_kinds": tfm.layer_kinds(cfg),
               "attention_layers": n_attn, "prefill_launches": launches,
               **logits_record(arch, logits, ref_logits, cfg, b),
               "f_layers_bf16": layers_f, "moe_layers_bf16": layers_moe,
               "routing_flips_kernel_vs_plain": flips,
               "routed_tokens_a_layer": b * s}
        del logits, ref_logits
        print(f"[lm3k] {arch} prefill B={b} S={s}: {launches} F launches "
              f"({n_attn} attention layers), logits finite; F's bf16 entry "
              f"at each of {layers_f['layers']} layers vs its plain version "
              f"on the layer's q, k, v: worst {layers_f['worst_share']:.3f} "
              f"of its bound (the planted fault at least "
              f"{layers_f['planted_least_share']:.3f}); each of "
              f"{layers_moe['layers']} MoE layers on its first {MOE_SLICE} "
              f"positions vs the f32 all-experts combine: worst "
              f"{layers_moe['worst_share']:.3f} of the bound (the planted "
              f"fault at least {layers_moe['planted_least_share']:.3f}; "
              f"{layers_moe['rows_route_differs_on_slice']} rows routed "
              f"otherwise on the slice, left out); routing flips kernel vs "
              f"plain attention route by MoE layer {flips} of {b * s} "
              f"tokens; last-position logits kernel vs plain route max|Δ| "
              f"{rec['max_abs_err_vs_plain']:.3e} (max|logits| "
              f"{rec['max_abs_logit']:.3f}; reported, not gated), argmax "
              f"equal on {rec['argmax_equal_rows']}/{b} rows")
        # ---- 3k. serve(): 16 greedy tokens at B = 4 -----------------------
        fa.flash_attention.launches = 0
        served, serve_s = serve(arch, batch=4, prompt_len=8, gen_tokens=16,
                                device=dev, params=params, cfg=cfg)
        f_paths[f"{arch}_serve"] = fa.flash_attention.launches
        if served.shape != (4, 16) or served.min() < 0 \
                or served.max() >= cfg.vocab_size:
            raise RuntimeError(f"{arch} serve: tokens {served.shape} out of "
                               f"range")
        rec.update(serve_tokens=int(served.size), serve_s=serve_s,
                   serve_tok_per_s=served.size / serve_s)
        torch.cuda.empty_cache()

        # ---- 3k. slot graphs against eager and lone runs -----------------
        def requests():
            g = torch.Generator().manual_seed(13)
            return [Request(rid=i, prompt=torch.randint(
                0, cfg.vocab_size, (p,), generator=g).numpy(), max_new=n)
                for i, (p, n) in enumerate(FAMILY_REQUESTS)]

        def run(slots, graphs, reqs):
            cb = ContinuousBatcher(cfg, params, slots=slots,
                                   max_len=FAMILY_MAX_LEN, device=dev,
                                   graphs=graphs)
            cb.warmup()
            for r in reqs:
                cb.submit(r)
            t0 = time.perf_counter()
            steps = cb.run()
            torch.cuda.synchronize()
            return ({r.rid: r.out for r in cb.done}, steps,
                    time.perf_counter() - t0)
        fa.flash_attention.launches = 0
        got, steps, graph_s = run(4, True, requests())
        f_paths[f"{arch}_batcher"] = fa.flash_attention.launches
        torch.cuda.empty_cache()
        eager, _, eager_s = run(4, False, requests())
        for r in requests():
            lone, _, _ = run(1, True, [r])
            if got[r.rid] != eager[r.rid] or got[r.rid] != lone[r.rid] \
                    or len(got[r.rid]) != r.max_new:
                raise RuntimeError(
                    f"{arch} request {r.rid}: slot-graph tokens "
                    f"{got[r.rid]}, eager {eager[r.rid]}, lone run "
                    f"{lone[r.rid]}")
        torch.cuda.empty_cache()
        n_tok = sum(len(o) for o in got.values())
        rec.update(batcher_requests=len(got), batcher_steps=steps,
                   batcher_tokens=n_tok, batcher_graph_s=graph_s,
                   batcher_eager_s=eager_s)
        decode_launches = {k: v for k, v in f_paths.items()
                           if k.startswith(arch) and "prefill" not in k}
        if any(decode_launches.values()):
            raise RuntimeError(f"{arch}: kernel F launched at decode: "
                               f"{decode_launches}")
        print(f"[lm3k] {arch} serve (B=4, 16 new): "
              f"{rec['serve_tok_per_s']:.1f} tok/s; ContinuousBatcher "
              f"{len(got)} requests over 4 slots on slot graphs: {n_tok} "
              f"tokens in {steps} steps ({graph_s:.3f} s; eager "
              f"{eager_s:.3f} s), every request's tokens equal to the eager "
              f"run's and to its lone run's; 0 F launches at decode")
        # ---- 4j. times: the prefill with its split, decode ----------------
        rec["prefill_ms"] = time_ms(lambda: prefill(params, batch), iters=3,
                                    warmup=1)
        rec["prefill_split"] = device_split(lambda: prefill(params, batch),
                                            rec["prefill_ms"], dispatch=True)
        cache = tfm.init_cache(cfg, 4, 32, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)

        def decode():
            with torch.no_grad():
                tfm.decode_step(params, cache, tok, 10, cfg)
        rec["decode_ms_B4"] = time_ms(decode, iters=5, warmup=1)
        # one MoE layer's B = 1 decode: the gathered form's bytes against
        # the selected experts' weight read
        layer = next(p for p, kind in zip(params["layers"],
                                          tfm.layer_kinds(cfg))
                     if kind in tfm.MOE_KINDS)
        x1 = torch.randn((1, 1, cfg.d_model), generator=gen).to(
            dev, torch.bfloat16)
        elems = cfg.top_k * cfg.d_model * cfg.d_expert
        moe_ms = time_ms(lambda: moe.moe_decode(layer["moe"], x1, cfg))
        # wi, wg: read, gathered copy written and read (2 B each); wo the
        # same, then its f32 copy written and read (4 B each)
        moved = elems * (2 * 3 * 2 + 3 * 2 + 2 * 4)
        rec["moe_decode_B1"] = {
            "ms": moe_ms, "selected_weight_bytes": 3 * elems * 2,
            "moved_bytes_estimate": moved,
            "selected_read_bound_ms": 3 * elems * 2 / peak_bw * 1e3,
            "moved_bound_ms": moved / peak_bw * 1e3}
        sp = rec["prefill_split"]
        md = rec["moe_decode_B1"]
        rec["arch_s"] = time.perf_counter() - t_arch
        print(f"[lm4j] {arch} prefill B={b} S={s}: {rec['prefill_ms']:.3f} "
              f"ms; device F {sp['F_ms']:.3f}, products "
              f"{sp['matmul_ms']:.3f}, MoE dispatch {sp['dispatch_ms']:.3f}, "
              f"other {sp['other_ms']:.3f} ms, idle share "
              f"{ms_text(sp['idle_share'], '.3f')}; decode_step B=4 "
              f"{rec['decode_ms_B4']:.3f} ms; one MoE layer's B=1 decode "
              f"{md['ms']:.3f} ms (the {cfg.top_k} selected experts' "
              f"{md['selected_weight_bytes'] / 1e9:.3f} GB read alone "
              f"{md['selected_read_bound_ms']:.3f} ms; the gathered form "
              f"moves ~{md['moved_bytes_estimate'] / 1e9:.3f} GB, "
              f"{md['moved_bound_ms']:.3f} ms); {rec['arch_s']:.1f} s for "
              f"this architecture")
        del params, cache, batch, prefill, layer
        gc.collect()
        torch.cuda.empty_cache()
        # ---- 3k. the f32 copy: F's f32 entry against the plain route ------
        f32_stages = MOE_F32_STAGES[arch]
        cfg32 = dataclasses.replace(
            full, stages=f32_stages,
            num_layers=sum(len(k) * r for k, r in f32_stages))
        p32 = tfm.init(cfg32, seed=1, device=dev, dtype=torch.float32)
        prefill32 = make_prefill_step(cfg32)
        batch = {"inputs": toks.to(dev)}
        r32_k, r32_p = [], []
        fa.flash_attention.launches = 0
        with captured_moe(r32_k):
            logits32 = prefill32(p32, batch)
        torch.cuda.synchronize()
        f_paths[f"{arch}_f32_prefill_B{b}_S{s}"] = fa.flash_attention.launches
        with plain_attention(), captured_moe(r32_p):
            truth = prefill32(p32, batch)
        rec["f32"] = {"layers": cfg32.num_layers,
                      "layer_kinds": tfm.layer_kinds(cfg32),
                      "routing_flips_kernel_vs_plain":
                          routing_flips(r32_k, r32_p),
                      **check_prefill_logits(f"{arch} f32", logits32, truth,
                                             cfg32, b, tol=TOL_LM_F32)}
        print(f"[lm3k] {arch} f32 copy at {cfg32.num_layers} layers "
              f"({tfm.layer_kinds(cfg32)}): F's f32 entry vs the plain route "
              f"max|Δ| {rec['f32']['max_abs_err_vs_plain']:.3e} (max|logits| "
              f"{rec['f32']['max_abs_logit']:.3f}, tol {TOL_LM_F32}·max); "
              f"routing flips {rec['f32']['routing_flips_kernel_vs_plain']}")
        del p32, r32_k, r32_p, logits32, truth, batch
        gc.collect()
        torch.cuda.empty_cache()
        records[arch] = rec
    # ---- 4j. F at deepseek's MLA layer and dbrx's attention layer --------
    f_times = []
    for arch in ("deepseek-v3-671b", "dbrx-132b"):
        cfg = registry.get_config(arch)
        h, kh = cfg.num_heads, cfg.num_kv_heads
        d = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla
             else cfg.head_dim)
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
        if cfg.use_mla:
            v[..., cfg.v_head_dim:] = 0     # MLA pads v to the q.k dim
        t = f_layer_time(fa, F, q, k, v, 0, peak_bw, peak_bf16, time_ms)
        t["site"] = f"{arch} B={b} S={s}"
        f_times.append(t)
        print(f"[time] kernel F {arch} layer (B={b} S={s} H={h}/{kh} D={d}"
              f"): kernel {t['ms']:.4f} ms ({t['tflops']:.1f} TFLOP/s), "
              f"plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), kernel at "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")
        del q, k, v
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[lm3k] the MoE families' phases took {phase_s:.1f} s")
    return ({"lm_moe_families": records, "lm_moe_families_s": phase_s,
             "flash_moe_sites": f_times}, f_paths, f_times)


def f_launches(cfg) -> int:
    """Kernel F's launches a prefill of ``cfg``: one a self-attention
    layer, encoder and decoder, and one more a ``dec`` layer (its cross
    attention)."""
    from repro_torch.models import transformer as tfm
    return (attention_layers(cfg)
            + sum(kind in tfm.ATTN_KINDS for kind in tfm.enc_layer_kinds(cfg))
            + tfm.layer_kinds(cfg).count("dec"))


def seamless_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 3l and 4k: seamless-m4t-large-v2 at full width and depth in
    bf16 (seeded weights): the encoder over ``S2T_SRC`` stub frames and a
    decoder prefill of ``S2T_PREFILL`` tokens through the prefill step,
    F launched once at each encoder layer and twice at each decoder layer
    (72), F held layer by layer (``check_f_layers``: the encoder's
    non-causal layers, the decoder's causal and cross layers, and the 24
    cross layers of one eager B = 4 decode step at Sq = 1) with its
    planted fault caught at each, the logits against the plain attention
    route (``TOL_LM``); ``serve`` at B = 4 over the encoded memory (16
    greedy tokens, F once a decoder layer a step); 5 requests over 4 slot
    graphs of ``ContinuousBatcher`` over one memory (24 F launches a step
    captured in each graph) equal to an eager run's and each lone run's;
    the same requests behind the control plane through
    ``LMBackend(memory=)``; the times (prefill ms with its device split,
    an eager B = 4 decode step, F at the encoder layer and at a cross
    layer beside SDPA and the bound).  Returns (records, F's launches by
    path, F's layer times)."""
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.control_plane import ControlPlane, ServeRequest

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    arch = "seamless-m4t-large-v2"
    cfg = registry.get_config(arch)
    params = tfm.init(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in _tensors(params))
    n_f = f_launches(cfg)
    b, s = S2T_PREFILL
    src = torch.randn((b, S2T_SRC, cfg.d_model), generator=gen).to(
        dev, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    batch = {"inputs": toks.to(dev), "src_embeds": src}
    prefill = make_prefill_step(cfg)
    tag = f"B{b}_S{s}_src{S2T_SRC}"
    # ---- 3l. the prefill: F at every attention, held layer by layer ------
    calls = []
    fa.flash_attention.launches = 0
    with captured_attention(calls):
        logits = prefill(params, batch)
    torch.cuda.synchronize()
    f_paths = {f"seamless_prefill_{tag}": fa.flash_attention.launches}
    if fa.flash_attention.launches != n_f:
        raise RuntimeError(f"seamless prefill: kernel F launched "
                           f"{fa.flash_attention.launches} times, not "
                           f"{n_f} (once an encoder layer, twice a decoder "
                           f"layer)")
    kinds = (["enc"] * len(tfm.enc_layer_kinds(cfg))
             + ["dec_self", "dec_cross"] * len(tfm.layer_kinds(cfg)))
    layers_f = {kind: check_f_layers(f"seamless {kind}",
                                     [c for c, k in zip(calls, kinds)
                                      if k == kind], F_FAULT)
                for kind in ("enc", "dec_self", "dec_cross")}
    del calls
    with torch.no_grad():
        memory = tfm.encode(params, src, cfg)
    # ---- 3l. F at decode: one eager decode step's cross attention --------
    # (Sq = 1 over the memory's rows), held layer by layer as above
    n_dec = len(tfm.layer_kinds(cfg))
    cache = tfm.init_cache(cfg, 4, 32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)
    mem4 = memory.expand(4, -1, -1)
    calls = []
    fa.flash_attention.launches = 0
    with captured_attention(calls), torch.no_grad():
        tfm.decode_step(params, cache, tok, 10, cfg, memory=mem4)
    torch.cuda.synchronize()
    f_paths["seamless_decode_step_B4"] = fa.flash_attention.launches
    if fa.flash_attention.launches != n_dec or len(calls) != n_dec:
        raise RuntimeError(f"seamless decode step: kernel F launched "
                           f"{fa.flash_attention.launches} times, not "
                           f"{n_dec} (once a decoder layer's cross "
                           f"attention)")
    layers_f["dec_cross_decode"] = check_f_layers("seamless decode cross",
                                                  calls, F_FAULT)
    del calls
    with plain_attention():
        ref_logits = prefill(params, batch)
    rec = {"params": n_params, "enc_layers": len(tfm.enc_layer_kinds(cfg)),
           "dec_layers": len(tfm.layer_kinds(cfg)),
           "prefill_launches": n_f, "f_layers_bf16": layers_f,
           **check_prefill_logits(f"seamless {tag}", logits, ref_logits,
                                  cfg, b)}
    del logits, ref_logits
    print(f"[s2t3l] seamless-m4t-large-v2 at full width and depth "
          f"({n_params / 1e9:.2f} B params, bf16): prefill {tag}: {n_f} F "
          f"launches; F's bf16 entry vs its plain version on each layer's "
          f"q, k, v: " + ", ".join(
              f"{k} {v['layers']} layers worst {v['worst_share']:.3f} of the "
              f"bound (planted fault >= {v['planted_least_share']:.3f})"
              for k, v in layers_f.items())
          + f"; logits kernel vs plain route max|Δ| "
          f"{rec['max_abs_err_vs_plain']:.3e} (max|logits| "
          f"{rec['max_abs_logit']:.3f}, tol {TOL_LM}·max)")
    # ---- 3l. serve(): 16 greedy tokens at B = 4 over the memory ----------
    fa.flash_attention.launches = 0
    served, serve_s = serve(arch, batch=4, prompt_len=8, gen_tokens=16,
                            device=dev, params=params, cfg=cfg, memory=mem4)
    f_paths["seamless_serve"] = fa.flash_attention.launches
    if served.shape != (4, 16) or served.min() < 0 \
            or served.max() >= cfg.vocab_size \
            or f_paths["seamless_serve"] != n_dec * (8 + 16 - 1):
        raise RuntimeError(f"seamless serve: tokens {served.shape}, "
                           f"{f_paths['seamless_serve']} F launches (not "
                           f"{n_dec} a step)")
    rec.update(serve_tokens=int(served.size), serve_s=serve_s,
               serve_tok_per_s=served.size / serve_s)
    torch.cuda.empty_cache()

    # ---- 3l. slot graphs over one memory, the control plane --------------
    def requests():
        g = torch.Generator().manual_seed(17)
        return [(i, torch.randint(0, cfg.vocab_size, (p,), generator=g)
                 .numpy(), n) for i, (p, n) in enumerate(FAMILY_REQUESTS)]

    def run(slots, graphs, reqs):
        cb = ContinuousBatcher(cfg, params, slots=slots,
                               max_len=FAMILY_MAX_LEN, memory=memory,
                               device=dev, graphs=graphs)
        cb.warmup()
        for i, p, n in reqs:
            cb.submit(Request(rid=i, prompt=p, max_new=n))
        t0 = time.perf_counter()
        steps = cb.run()
        torch.cuda.synchronize()
        return ({r.rid: r.out for r in cb.done}, steps,
                time.perf_counter() - t0, cb)
    fa.flash_attention.launches = 0
    got, steps, graph_s, cb = run(4, True, requests())
    captured = {k: v for g in cb.graphs for k, v in g.kernels.items()}
    if any(g.kernels != {"F": n_dec} for g in cb.graphs):
        raise RuntimeError(f"seamless slot graphs captured "
                           f"{[g.kernels for g in cb.graphs]}, not {n_dec} "
                           f"F launches each")
    f_paths["seamless_batcher_graphs"] = sum(
        g.launches().get("F", 0) for g in cb.graphs)
    del cb
    eager, _, eager_s, _ = run(4, False, requests())
    for i, p, n in requests():
        lone, _, _, _ = run(1, True, [(i, p, n)])
        if got[i] != eager[i] or got[i] != lone[i] or len(got[i]) != n:
            raise RuntimeError(f"seamless request {i}: slot-graph tokens "
                               f"{got[i]}, eager {eager[i]}, lone run "
                               f"{lone[i]}")
    torch.cuda.empty_cache()
    cp = ControlPlane()
    cp.register_lm_model("s2t", cfg, params, slots=4, max_len=FAMILY_MAX_LEN,
                         memory=memory, device=dev)
    cp.warmup()
    fa.flash_attention.launches = 0
    cp.run([ServeRequest(rid=i, model="s2t", payload=p, max_new=n)
            for i, p, n in requests()])
    be = cp.backends["s2t"]
    f_paths["seamless_lm_backend"] = fa.flash_attention.launches + sum(
        g.launches().get("F", 0) for g in be.cb.graphs)
    plane = {r.rid: [int(t) for t in r.out] for r in cp.done}
    if plane != got:
        raise RuntimeError(f"LMBackend(memory=) answers {plane} differ from "
                           f"the batcher's {got}")
    n_tok = sum(len(o) for o in got.values())
    rec.update(batcher_requests=len(got), batcher_steps=steps,
               batcher_tokens=n_tok, batcher_graph_s=graph_s,
               batcher_eager_s=eager_s, graph_kernels=captured,
               lm_backend_served=len(plane))
    del cp, be
    print(f"[s2t3l] seamless serve (B=4 over the encoded memory, 16 new): "
          f"{rec['serve_tok_per_s']:.1f} tok/s, {n_dec} F launches a step; "
          f"ContinuousBatcher {len(got)} requests over 4 slot graphs "
          f"({captured} captured a graph): {n_tok} tokens in {steps} steps "
          f"({graph_s:.3f} s; eager {eager_s:.3f} s), equal to the eager "
          f"run's and each lone run's; LMBackend(memory=) behind the control "
          f"plane served {len(plane)} requests with the same tokens")
    # ---- 4k. times: the prefill with its split, decode, F -----------------
    rec["prefill_ms"] = time_ms(lambda: prefill(params, batch), iters=3,
                                warmup=1)
    rec["prefill_split"] = device_split(lambda: prefill(params, batch),
                                        rec["prefill_ms"])

    def decode():
        with torch.no_grad():
            tfm.decode_step(params, cache, tok, 10, cfg, memory=mem4)
    rec["decode_ms_B4"] = time_ms(decode, iters=5, warmup=1)
    sp = rec["prefill_split"]
    print(f"[s2t4k] seamless prefill {tag}: {rec['prefill_ms']:.3f} ms; "
          f"device F {sp['F_ms']:.3f}, products {sp['matmul_ms']:.3f}, "
          f"other {sp['other_ms']:.3f} ms, idle share "
          f"{ms_text(sp['idle_share'], '.3f')}; eager decode_step B=4 over "
          f"{S2T_SRC} memory rows {rec['decode_ms_B4']:.3f} ms")
    del params, cache, batch, prefill, memory, mem4, src
    gc.collect()
    torch.cuda.empty_cache()
    f_times = []
    h, d = cfg.num_heads, cfg.head_dim
    for site, sq in (("seamless encoder layer", S2T_SRC),
                     ("seamless cross layer", s)):
        q = torch.randn((b, sq, h, d), generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn((b, S2T_SRC, h, d), generator=gen).to(
            dev, torch.bfloat16) for _ in range(2))
        t = f_layer_time(fa, F, q, k, v, 0, peak_bw, peak_bf16, time_ms,
                         causal=False)
        t["site"] = f"{site} B={b} Sq={sq} Sk={S2T_SRC}"
        f_times.append(t)
        print(f"[time] kernel F {t['site']} (H={h}, D={d}, non-causal): "
              f"kernel {t['ms']:.4f} ms ({t['tflops']:.1f} TFLOP/s), plain "
              f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), kernel at "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")
        del q, k, v
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[s2t3l] seamless phases took {rec['phase_s']:.1f} s")
    return {"seamless": rec, "flash_seamless_sites": f_times}, f_paths, \
        f_times


def _kernels_under(ev):
    """The device kernels (name, µs) launched under a CPU profiler event
    and its descendants."""
    out = [(k.name, k.duration) for k in getattr(ev, "kernels", ())]
    for c in ev.cpu_children:
        out += _kernels_under(c)
    return out


def train_split(fn, wall_ms):
    """One train step under ``torch.profiler``: device ms of kernel F's
    forward, of the attention core's backward (the kernels under the
    autograd engine's ``FlashAttentionBackward``: plain PyTorch products
    and elementwise work), of the optimiser (under the "optimizer"
    range), of the remaining dense products and of everything else, with
    the idle share against ``wall_ms``; None where the profiler caught no
    trace or no backward event."""
    prof, evs = device_events(fn, 1, with_cpu=True)
    if evs is None:
        return {"F_fwd_ms": None, "attn_bwd_ms": None, "optimizer_ms": None,
                "matmul_ms": None, "other_ms": None, "idle_share": None,
                "wall_ms": wall_ms}
    total = {"F": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in evs:
        name = ev.name.lower()
        part = ("F" if "flash_fwd" in name
                else "matmul" if any(p in name for p in MATMUL_NAMES)
                else "other")
        total[part] += ev.device_time_total / 1e3
    under = {"attn_bwd": [], "optimizer": []}
    for ev in prof.events():
        if ev.name.startswith("autograd::engine::evaluate_function: "
                              "FlashAttentionBackward"):
            under["attn_bwd"] += _kernels_under(ev)
        elif ev.name == "optimizer":
            under["optimizer"] += _kernels_under(ev)
    out = {"wall_ms": wall_ms, "device_kernels": len(evs)}
    if not under["attn_bwd"] or not under["optimizer"]:
        out.update(F_fwd_ms=total["F"], attn_bwd_ms=None,
                   optimizer_ms=None, matmul_ms=total["matmul"],
                   other_ms=total["other"])
    else:
        parts = {}
        for key, ks in under.items():
            mm = sum(d for n, d in ks if any(p in n.lower()
                                             for p in MATMUL_NAMES)) / 1e3
            parts[key] = (mm, sum(d for _, d in ks) / 1e3 - mm)
        out.update(F_fwd_ms=total["F"],
                   attn_bwd_ms=sum(parts["attn_bwd"]),
                   attn_bwd_matmul_ms=parts["attn_bwd"][0],
                   optimizer_ms=sum(parts["optimizer"]),
                   matmul_ms=total["matmul"] - parts["attn_bwd"][0]
                   - parts["optimizer"][0],
                   other_ms=total["other"] - parts["attn_bwd"][1]
                   - parts["optimizer"][1])
    busy = sum(total.values())
    out.update(device_busy_ms=busy, idle_share=1 - busy / wall_ms)
    return out


def rel_grad_errors(got, want):
    """Per-tensor max|Δ| / max|want| of two gradient trees (paths as
    ``tree_paths`` gives them)."""
    from repro_torch.train.tree import tree_paths
    out = {}
    for (k, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        scale = float(b.float().abs().max())
        out[k] = float((a.float() - b.float()).abs().max()) / max(scale,
                                                                  1e-30)
    return out


def worst_and_median(errs):
    """(the tensor of the worst reading, that reading, the median)."""
    k = max(errs, key=errs.get)
    return k, errs[k], sorted(errs.values())[len(errs) // 2]


def check_f_backward(name, call, fault, gen):
    """The attention core's backward (``flash_attention_bwd``, plain
    PyTorch products) on one captured training call at its full length:
    one kv head and its group of query heads, F's own output O, the call's
    key chunk and masks, and a seeded bf16 cotangent.  dQ, dK and dV
    against autograd through the dense f64 oracle (``flash_attention_ref``)
    on the same q, k, v and cotangent, each as max|Δ| / max|oracle| under
    ``TOL_TRAIN_BWD``; each output scaled by ``fault`` must fail that
    limit.  Returns the readings."""
    import torch

    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.layers.attention import flash_attention_bwd
    q, k, v, kw, o = call
    g = q.shape[2] // k.shape[2]
    q, o, k, v = q[:, :, :g], o[:, :, :g], k[:, :, :1], v[:, :, :1]
    opts = dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                q_offset=kw.get("q_offset", 0), scale=kw.get("scale"))
    do = torch.randn(q.shape, generator=gen).to(q.device, q.dtype)
    got = flash_attention_bwd(q, k, v, o, do, ck=kw.get("kv_chunk", 1024),
                              **opts)
    with torch.enable_grad():
        ref = [t.double().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(flash_attention_ref(*ref, **opts), ref,
                                   do.double())
    out = {"shape": list(q.shape), "kv_heads": 1, **opts,
           "kv_chunk": kw.get("kv_chunk", 1024), "tol": TOL_TRAIN_BWD,
           "planted_fault": fault}
    for tag, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        planted = (a.double() * fault).to(a.dtype)
        out[tag] = float((a.double() - w).abs().max()) / scale
        out[f"{tag}_planted"] = float((planted.double() - w).abs().max()) \
            / scale
    del ref, want, got
    print(f"[train3m] {name}: the attention backward (plain PyTorch) on "
          f"layer 0's call, {out['shape']} query rows and heads over one kv "
          f"head, vs autograd through the dense f64 oracle: max|Δ|/max "
          f"dQ {out['dq']:.3e}, dK {out['dk']:.3e}, dV {out['dv']:.3e} "
          f"(tol {TOL_TRAIN_BWD}); each scaled by {fault}: "
          f"{out['dq_planted']:.3e}, {out['dk_planted']:.3e}, "
          f"{out['dv_planted']:.3e}")
    for tag in ("dq", "dk", "dv"):
        if not out[tag] <= TOL_TRAIN_BWD < out[f"{tag}_planted"]:
            raise RuntimeError(f"{name}: the attention backward's {tag} "
                               f"reads {out[tag]:.3e} against the f64 "
                               f"oracle, its planted fault "
                               f"{out[f'{tag}_planted']:.3e}, limit "
                               f"{TOL_TRAIN_BWD}")
    return out


def lm_train_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 3m and 4l: llama3.2-1b training at full width and depth in
    bf16 (seeded weights), B, S = ``TRAIN_SHAPE``, AdamW from
    ``opt_config_for``, remat on: the first step's loss and every
    gradient on the kernel route against the plain attention route (F's
    plain version forward, the same backward) within ``TOL_TRAIN_GRAD``
    of each gradient's own scale, F held layer by layer inside that
    training forward with its planted fault caught; ``TRAIN_SMOKE_STEPS``
    steps of ``make_train_step`` on one batch (the loss falls; F twice an
    attention layer a step: forward and its recomputation); ``train()``
    at full width with its depth cut (``TRAIN_RESUME``), killed by
    ``fail_at``, resumed from its checkpoint to the last step with the
    uninterrupted run's losses bit for bit (deterministic algorithms on);
    the times (step ms, tokens/s, peak memory, the device split).
    Returns (records, F's launches by path)."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import build_state, train
    from repro_torch.layers import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.train.data import TokenPipeline

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get_config("llama3.2-1b")
    b, s = TRAIN_SHAPE
    state, opt_cfg = build_state(cfg, device=dev)
    n_params = sum(t.numel() for t in _tensors(state["params"]))
    batch = steps_lib.batch_to(TokenPipeline(cfg, b, s, seed=3).batch_at(0),
                               dev)
    kv_chunk = TRAIN_KV_CHUNK
    n_attn = attention_layers(cfg)
    # ---- 3m. one step's gradients: kernel route vs plain route -----------
    calls = []
    fa.flash_attention.launches = 0
    with captured_attention(calls):
        loss_k, grads_k = steps_lib.loss_and_grads(
            cfg, state["params"], batch, kv_chunk=kv_chunk)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    f_paths = {f"lm_train_grads_B{b}_S{s}": launches}
    if launches != 2 * n_attn or len(calls) != 2 * n_attn:
        raise RuntimeError(f"train forward and backward: kernel F launched "
                           f"{launches} times ({len(calls)} core calls), not "
                           f"2 x {n_attn} (forward and its recomputation "
                           f"under remat)")
    calls = [(q.detach(), k.detach(), v.detach(), kw, o.detach())
             for q, k, v, kw, o in calls]
    with torch.no_grad():
        layers_f = check_f_layers("llama3.2-1b train", calls, F_FAULT)
        bwd_f64 = check_f_backward("llama3.2-1b train", calls[0], F_FAULT,
                                   gen)
    del calls

    def plain_function(core, q, k, v, *, kv_chunk=1024, **kw):
        return attention.FlashAttention.apply(
            q, k, v, kw.get("causal", True), kw.get("window", 0),
            kw.get("q_offset", 0), kw.get("scale"), kv_chunk,
            lambda q, k, v, causal, window, q_offset, scale, ck:
            plain_core(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, scale=scale, kv_chunk=ck))
    with attention_core(plain_function):
        loss_p, grads_p = steps_lib.loss_and_grads(
            cfg, state["params"], batch, kv_chunk=kv_chunk)
    readings = rel_grad_errors(grads_k, grads_p)
    del grads_k
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    # the same gate's reading of a planted backward fault: the kernel
    # route with the attention backward's dV scaled by F_FAULT
    bwd = attention.flash_attention_bwd

    def faulty_bwd(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq, dk, (dv.float() * F_FAULT).to(dv.dtype)
    attention.flash_attention_bwd = faulty_bwd
    try:
        _, grads_f = steps_lib.loss_and_grads(
            cfg, state["params"], batch, kv_chunk=kv_chunk)
    finally:
        attention.flash_attention_bwd = bwd
    planted = rel_grad_errors(grads_f, grads_p)
    del grads_f, grads_p
    # ... and the loss gate's reading of a planted forward fault
    with torch.no_grad(), faulty_attention(F_FAULT):
        loss_ff = tfm.loss_fn(state["params"], batch, cfg,
                              kv_chunk=kv_chunk)
    worst_k, worst, median = worst_and_median(readings)
    planted_k, planted_worst, planted_median = worst_and_median(planted)
    rec = {"params": n_params, "batch": b, "seq": s, "kv_chunk": kv_chunk,
           "optimizer": opt_cfg.name, "f_layers_bf16": layers_f,
           "bwd_vs_f64": bwd_f64,
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_err": loss_rel, "grad_rel_err_worst": worst,
           "grad_rel_err_worst_tensor": worst_k,
           "grad_rel_err_median": median, "planted_fault": F_FAULT,
           "planted_bwd_grad_rel_err_worst": planted_worst,
           "planted_bwd_grad_rel_err_worst_tensor": planted_k,
           "planted_bwd_grad_rel_err_median": planted_median, "planted_fwd_loss_rel_err":
           abs(float(loss_ff) - float(loss_p)) / abs(float(loss_p)),
           "tol_grad": TOL_TRAIN_GRAD, "tol_loss": TOL_TRAIN_LOSS}
    print(f"[train3m] llama3.2-1b train step B={b} S={s} ({n_params / 1e9:.2f}"
          f" B params, bf16, AdamW, remat): {launches} F launches for the "
          f"loss and its gradients ({n_attn} forward + {n_attn} recomputed); "
          f"F's bf16 entry inside the training forward vs its plain version "
          f"on each call's q, k, v: worst {layers_f['worst_share']:.3f} of "
          f"the bound (planted fault >= "
          f"{layers_f['planted_least_share']:.3f}); kernel vs plain route: "
          f"loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel "
          f"{loss_rel:.3e}; F's output scaled by {F_FAULT}: "
          f"{rec['planted_fwd_loss_rel_err']:.3e}; tol {TOL_TRAIN_LOSS}), "
          f"gradients worst {worst:.3e} of their scale at {worst_k}, median "
          f"{median:.3e} (tol {TOL_TRAIN_GRAD}; with the backward's dV "
          f"scaled by {F_FAULT}: worst {planted_worst:.3e} at {planted_k}, "
          f"median {planted_median:.3e})")
    if loss_rel > TOL_TRAIN_LOSS or worst > TOL_TRAIN_GRAD:
        raise RuntimeError(f"train step: kernel route off the plain route "
                           f"(loss rel {loss_rel:.3e}, {worst_k} "
                           f"{worst:.3e})")
    if not (planted_worst > TOL_TRAIN_GRAD
            and rec["planted_fwd_loss_rel_err"] > TOL_TRAIN_LOSS):
        raise RuntimeError(f"train step: a planted fault unseen: the "
                           f"backward's gradients {planted_worst:.3e}, the "
                           f"forward's loss "
                           f"{rec['planted_fwd_loss_rel_err']:.3e}")
    # ---- 3m. steps on one batch: the loss falls ---------------------------
    step = steps_lib.make_train_step(cfg, opt_cfg, kv_chunk=kv_chunk)
    losses, per_step = [], []
    for _ in range(TRAIN_SMOKE_STEPS):
        fa.flash_attention.launches = 0
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        per_step.append(fa.flash_attention.launches)
    f_paths[f"lm_train_step_B{b}_S{s}"] = sum(per_step)
    if not all(n == 2 * n_attn for n in per_step) \
            or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"train steps: losses {losses}, F launches a "
                           f"step {per_step}")
    rec.update(steps_losses=losses, f_launches_a_step=per_step[0])
    print(f"[train3m] {TRAIN_SMOKE_STEPS} train steps on one batch: losses "
          f"{[round(x, 4) for x in losses]}, {per_step[0]} F launches a step")
    # ---- 4l. times: the step, tokens/s, peak memory, the device split -----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rec["step_ms"] = time_ms(lambda: step(state, batch), iters=3, warmup=1)
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rec["tokens_per_s"] = b * s / rec["step_ms"] * 1e3
    rec["step_split"] = train_split(lambda: step(state, batch),
                                    rec["step_ms"])
    sp = rec["step_split"]
    print(f"[train4l] train step B={b} S={s}: {rec['step_ms']:.3f} ms, "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{rec['peak_memory_gib']:.2f} GiB; device F forward "
          f"{ms_text(sp['F_fwd_ms'], '.3f')}, attention backward (plain "
          f"PyTorch) {ms_text(sp['attn_bwd_ms'], '.3f')}, dense products "
          f"{ms_text(sp['matmul_ms'], '.3f')}, optimizer "
          f"{ms_text(sp['optimizer_ms'], '.3f')}, other "
          f"{ms_text(sp['other_ms'], '.3f')} ms, idle share "
          f"{ms_text(sp['idle_share'], '.3f')}")
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 3m. train() with a checkpoint and a failure, resumed -------------
    layers, steps, tb, ts, every, fail = TRAIN_RESUME
    cut = cut_depth(cfg, layers)
    kw = dict(steps=steps, batch=tb, seq=ts, ckpt_every=every, device=dev,
              cfg=cut, log_every=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fa.flash_attention.launches = 0
        want, final_w = train("llama3.2-1b", **kw)
        f_paths["lm_train_uninterrupted"] = fa.flash_attention.launches
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            fa.flash_attention.launches = 0
            got, final = train("llama3.2-1b", ckpt_dir=os.path.join(d, "c"),
                               fail_at=(fail,), **kw)
            f_paths["lm_train_resumed"] = fa.flash_attention.launches
            resumed_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    replay = want[:fail] + want[fail // every * every:]
    if final != steps or final_w != steps or got != replay:
        raise RuntimeError(f"train() with fail_at={fail}: final step {final}"
                           f", losses {got}, want {replay}")
    rec["resume"] = {"layers": layers, "steps": steps, "batch": tb,
                     "seq": ts, "ckpt_every": every, "fail_at": fail,
                     "losses": got, "bit_equal_to_uninterrupted": True,
                     "resumed_run_s": resumed_s}
    print(f"[train3m] train() at full width, {layers} layer(s), {steps} steps"
          f" B={tb} S={ts}, a checkpoint every {every}, killed at step "
          f"{fail}: resumed from step {fail // every * every} to step "
          f"{final}, every loss bit-equal to the uninterrupted run's "
          f"(deterministic algorithms on; {resumed_s:.1f} s with the "
          f"checkpoints)")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[train3m] the training phases took {rec['phase_s']:.1f} s")
    return {"lm_train": rec}, f_paths


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, t) for t in tree]
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif isinstance(tree, list):
        for t in tree:
            yield from _tensors(t)
    else:
        yield tree


def vae_phases(dev, smi, peak_flops, peak_bw, gen):
    """Phases 3h, 4f and 4g: the full-width VAE on the 'cuda' route (2 B
    and 2 A launches a forward, f32 and int8, against the 'torch' route;
    three ELBO steps, one step's gradients against the 'torch' route's; a
    prior sample; the int8 twin's gate), the times of its sites and of
    kernel A's other pad (1, 3) sites with the library call, the
    per-phase route beside kernel A, the VAE forward and ELBO step, and
    measured route autotuning with its route cache.  Returns (records for
    the results line, {path: launch counts} for the kernels line)."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import serve_dcgan, vae_train
    from repro_torch.core import autotune as at
    from repro_torch.core.plan import plan_cache_clear, plan_conv
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels.untangled_conv import work_conv, work_deconv
    from repro_torch.models import gan, unet, vae

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def bound_of(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    # ---- 3h. the VAE at full width, f32 and int8, on the 'cuda' route ------
    vcfg = dataclasses.replace(vae.VAE, backend="cuda")
    v_cfgs = {w: dataclasses.replace(vcfg, wdtype=w)
              for w in ("float32", "int8")}
    v_params, vae_serve, vae_launches, recon = {}, {}, {}, {}
    for wdtype, c_ in v_cfgs.items():
        bad = [(p.spec.kind, p.spec.in_hw, r.batch, r.path, r.sp_tiles)
               for p in vae.vae_plans(c_) for r in p.routes
               if r.path != "cuda" or r.sp_tiles is not None]
        if bad:
            raise RuntimeError(f"VAE {wdtype} sites off kernels A and B: "
                               f"{bad}")
        v_params[wdtype] = vae.vae_init(0, c_, device=dev)
    n_sites = len(vae.vae_plans(vcfg))
    want_v = {"A": 2, "B": 2, "C": 0, "D": 0}
    for bb in VAE_BATCHES:
        g_ = torch.Generator().manual_seed(30 + bb)
        xv = torch.randn((bb, vcfg.image_hw, vcfg.image_hw, vcfg.in_c),
                         generator=g_).to(dev)
        ev = torch.randn((bb, vcfg.latent_dim), generator=g_).to(dev)
        for wdtype, c_ in v_cfgs.items():
            with torch.inference_mode():
                zero_counts()
                out_c = vae.vae_apply(v_params[wdtype], xv, None, c_, eps=ev)
                torch.cuda.synchronize()
                got, stray = read_counts(wdtype)
                out_t = vae.vae_apply(v_params[wdtype], xv, None,
                                      dataclasses.replace(c_,
                                                          backend="torch"),
                                      eps=ev)
                torch.cuda.synchronize()
            key = f"vae_{wdtype}_B{bb}"
            vae_launches[key] = got
            if got != want_v or stray:
                raise RuntimeError(f"{key}: launches {got} (+{stray} in the "
                                   f"other dtype's counters), want {want_v}")
            rels = {nm: float((a - b_).abs().max() / b_.abs().max())
                    for nm, a, b_ in zip(("recon", "mu", "logvar"), out_c,
                                         out_t)}
            if not (max(rels.values()) <= TOL_VAE
                    and out_c[0].shape == xv.shape
                    and all(bool(torch.isfinite(t).all()) for t in out_c)):
                raise RuntimeError(f"{key}: cuda vs torch max|Δ|/max|y| "
                                   f"{rels}")
            vae_serve[key] = {"cuda_vs_torch": rels, "launches": got}
            recon[wdtype] = out_c[0]
        rel8 = float((recon["int8"] - recon["float32"]).abs().max()
                     / recon["float32"].abs().max())
        vae_serve[f"vae_int8_B{bb}"]["int8_vs_f32"] = rel8
        if not rel8 <= n_sites / 127.0:
            raise RuntimeError(f"int8 VAE B={bb} off its f32 twin: "
                               f"{rel8:.4f}")
    print(f"[VAE] full width on 'cuda', per forward (recon, mu, logvar vs "
          f"the 'torch' route, tol {TOL_VAE}; int8 gate "
          f"{n_sites}/127): {json.dumps(vae_serve)}")

    # three SGD steps of the -ELBO at B = 64, one step's gradients
    xs_v = [torch.from_numpy(vae_train.batch_at(vcfg, 64, s)).to(dev)
            for s in range(TRAIN_STEPS)]
    pv = v_params["float32"]
    gen_v = torch.Generator().manual_seed(7)
    zero_counts()
    vae_losses = []
    for s in range(TRAIN_STEPS):
        pv, loss = vae_train.sgd_step(pv, xs_v[s], gen_v, vcfg, VAE_LR)
        vae_losses.append(loss)
    torch.cuda.synchronize()
    vae_train_launches, stray = read_counts("float32")
    want_t = {"A": 2 * TRAIN_STEPS, "B": 2 * TRAIN_STEPS, "C": 0, "D": 0}
    if vae_train_launches != want_t or stray:
        raise RuntimeError(f"VAE train launches {vae_train_launches} "
                           f"(+{stray}), want {want_t}")
    if not (all(np.isfinite(vae_losses))
            and all(bool(torch.isfinite(v).all()) for v in pv.values())):
        raise RuntimeError(f"non-finite VAE training state: {vae_losses}")
    eps_g = torch.randn((64, vcfg.latent_dim),
                        generator=torch.Generator().manual_seed(8)).to(dev)

    def elbo_grads(cfg_):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in v_params["float32"].items()}
        loss_ = vae.elbo_loss(leaves, xs_v[0], None, cfg_, eps=eps_g)
        return float(loss_.detach()), dict(zip(leaves, torch.autograd.grad(
            loss_, list(leaves.values()))))

    loss_c, g_c = elbo_grads(vcfg)
    loss_t, g_t = elbo_grads(dataclasses.replace(vcfg, backend="torch"))
    torch.cuda.synchronize()
    grad_rel = {k: float((g_c[k] - g_t[k]).abs().max() / g_t[k].abs().max())
                for k in g_t}
    loss_rel = abs(loss_c - loss_t) / abs(loss_t)
    if not (max(grad_rel.values()) <= TOL_GRAD and loss_rel <= TOL_LOSS
            and all(bool(torch.isfinite(g).all()) for g in g_c.values())):
        raise RuntimeError(f"VAE gradients cuda vs torch {grad_rel}, loss "
                           f"{loss_rel:.3e}")
    with torch.inference_mode():
        imgs = vae.sample(pv, torch.Generator().manual_seed(9), vcfg, n=16)
    if imgs.shape != (16, vcfg.image_hw, vcfg.image_hw, vcfg.in_c) or not (
            bool(torch.isfinite(imgs).all())
            and float(imgs.abs().max()) <= 1.0):
        raise RuntimeError(f"VAE prior samples {tuple(imgs.shape)} not "
                           f"finite in [-1, 1]")
    print(f"[VAE train] B=64, {TRAIN_STEPS} SGD steps on 'cuda' (lr "
          f"{VAE_LR}): -ELBO {vae_losses}; launches {vae_train_launches} "
          f"(= {want_t}); one step's gradients cuda vs torch max|Δ|/max|g| "
          f"per tensor {json.dumps(grad_rel)} (tol {TOL_GRAD}), loss "
          f"{loss_rel:.3e} (tol {TOL_LOSS}); sample(n=16) "
          f"{tuple(imgs.shape)} finite")

    # ---- 4f. times: the VAE's sites, A's pad (1, 3) sites, per_phase ------
    print(f"[time VAE] kernels A and B at the VAE's sites, kernel A at its "
          f"other pad (1, 3) sites with the library call, the per_phase "
          f"route beside A; CUDA events; card {smi}")

    def conv_record(name, h, c, n, k, s, pads, b):
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        sp = kern.reshape(k * k * c, n)
        xl, wl, kw = conv_library_args(xp, kern, (s, s), (1, 1))
        y_k = conv_call(xp, sp, k, s, 1)
        lib_err = check_library(f"{name} B={b}",
                                F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                                y_k)
        oh, ow = y_k.shape[1:3]
        flops, nbytes = work_conv(xp, sp, y_k)
        bound, by = bound_of(flops, nbytes)
        rec = {"site": name, "batch": b, "flops": flops, "bytes": nbytes,
               "ms": time_ms(lambda: conv_call(xp, sp, k, s, 1)),
               "device_ms": call_device_ms(lambda: conv_call(xp, sp, k, s, 1)),
               "plain_ms": time_ms(lambda: conv_call(xp, sp, k, s, 1,
                                                     plain=True)),
               "library": "F.conv2d",
               "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
               "library_device_ms": call_device_ms(
                   lambda: F.conv2d(xl, wl, **kw)),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err,
               "schedule": conv_schedule_of(b, oh, ow, k, c, n)}
        print(f"[time VAE B] {name} B={b}: kernel {rec['ms']:.4f} ms "
              f"(device {ms_text(rec['device_ms'])}), plain "
              f"{rec['plain_ms']:.4f} ms, F.conv2d {rec['library_ms']:.4f} "
              f"ms (device {ms_text(rec['library_device_ms'])}), bound "
              f"{bound:.4f} ms ({by}); schedule "
              f"{json.dumps(rec['schedule'])}")
        return rec

    def deconv_record(name, plan, b, per_phase):
        sp_ = plan.spec
        x = randn(b, *sp_.in_hw, sp_.in_c)
        kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
        packed = plan.pack(kern)
        xg = pad_or_crop(x, plan.gpad).contiguous()
        try:
            xl, wl, kw = library_args(x, kern, sp_.strides, sp_.padding)
            crop, form = (slice(None), slice(None)), "F.conv_transpose2d"
        except ValueError:
            xl, wl, kw, crop = cropped_library_args(x, kern, sp_.strides,
                                                    sp_.padding)
            form = "cropped F.conv_transpose2d"

        def library():
            return F.conv_transpose2d(xl, wl, **kw)[:, :, crop[0], crop[1]]

        y_k = kernel_call(plan, xg, packed)
        lib_err = check_library(f"{name} B={b}",
                                library().permute(0, 2, 3, 1), y_k)
        flops, nbytes = work_deconv(xg, packed, y_k, plan.phases)
        bound, by = bound_of(flops, nbytes)
        rec = {"site": name, "batch": b, "flops": flops, "bytes": nbytes,
               "ms": time_ms(lambda: kernel_call(plan, xg, packed)),
               "device_ms": call_device_ms(
                   lambda: kernel_call(plan, xg, packed)),
               "plain_ms": time_ms(lambda: ref_call(plan, xg, packed),
                                   iters=5 if y_k.numel() > 2 ** 24 else 20),
               "library": form, "library_ms": time_ms(library),
               "library_device_ms": call_device_ms(library),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err,
               "schedule": schedule_of(plan, b)}
        extra = ""
        if per_phase:
            # every live phase is one launch of B (or C where the phase's
            # plane tiles), f32 and int8; the int8 plan's per-phase output
            # is bit-equal to the f32 one on the dequantized superpack
            live = sum(1 for ex in plan.phases
                       if ex.taps[0] * ex.taps[1] and ex.out_hw[0]
                       and ex.out_hw[1])
            plan8 = plan_conv(dataclasses.replace(sp_, wdtype="int8"))
            packed8 = plan8.pack(kern)
            zero_counts()
            y_pp = plan.apply_per_phase(x, packed)
            y_pp8 = plan8.apply_per_phase(x, packed8)
            torch.cuda.synchronize()
            n32, _ = read_counts("float32")
            n8, _ = read_counts("int8")
            launched = (n32["B"] + n32["C"], n8["B"] + n8["C"])
            if launched != (live, live) or sum(n32.values()) + sum(
                    n8.values()) != 2 * live:
                raise RuntimeError(
                    f"{name} per_phase B={b}: {live} live phases launched "
                    f"f32 {n32}, int8 {n8}")
            if not torch.equal(
                    y_pp8, plan.apply_per_phase(x, packed8.dequant())):
                raise RuntimeError(f"{name} per_phase B={b}: int8 not "
                                   f"bit-equal to f32 on the dequantized "
                                   f"superpack")
            rec["per_phase_b_launches"] = n32["B"]
            rec["per_phase_c_launches"] = n32["C"]
            rec["per_phase_max_abs_err"] = check_library(
                f"{name} per_phase B={b}", y_pp, y_k)
            rec["per_phase_ms"] = time_ms(
                lambda: plan.apply_per_phase(x, packed))
            rec["per_phase_device_ms"] = call_device_ms(
                lambda: plan.apply_per_phase(x, packed))
            extra = (f", per_phase {rec['per_phase_ms']:.4f} ms (device "
                     f"{ms_text(rec['per_phase_device_ms'])}; "
                     f"{live} live phases: {rec['per_phase_b_launches']} "
                     f"on kernel B, {rec['per_phase_c_launches']} on C, "
                     f"f32 and int8; int8 bit-equal to f32 on the "
                     f"dequantized superpack)")
        print(f"[time VAE A] {name} B={b}: kernel {rec['ms']:.4f} ms "
              f"(device {ms_text(rec['device_ms'])}), plain "
              f"{rec['plain_ms']:.4f} ms, {form} {rec['library_ms']:.4f} "
              f"ms (device {ms_text(rec['library_device_ms'])}), bound "
              f"{bound:.4f} ms ({by}){extra}; schedule "
              f"{json.dumps(rec['schedule'])}")
        return rec

    vae_b_sites, vae_a_sites, pad13_sites, pp_sites = [], [], [], []
    for b in VAE_BATCHES:
        for name, kind, h, c, n, k, s, pads in vae_sites():
            if kind == "conv":
                vae_b_sites.append(conv_record(name, h, c, n, k, s, pads, b))
            else:
                vae_a_sites.append(deconv_record(
                    name, site(h, c, n, k, s, pads), b, True))
        for tag, layers in (("cGAN", gan.CGAN_LAYERS),
                            ("DCGAN", gan.DCGAN_LAYERS)):
            for i, l in enumerate(layers):
                rec = deconv_record(f"{tag}_DC{i + 1}", site(
                    l.in_hw, l.in_c, l.out_c, l.kernel, l.stride,
                    gan.deconv_padding(l.kernel, l.stride)), b, True)
                (pad13_sites if tag == "cGAN" else pp_sites).append(rec)
    u32 = dataclasses.replace(unet.UNET, backend="cuda")
    u512 = unet.UNetConfig("unet-512", image_hw=UNET_512_HW, backend="cuda")
    for ucfg, batches in ((u32, VAE_BATCHES), (u512, UNET_512_BATCHES)):
        for name, plan in unet.unet_plans(ucfg).items():
            if plan.spec.kind == "transposed" \
                    and plan.routes[0].sp_tiles is None:
                for b in batches:
                    pad13_sites.append(deconv_record(
                        f"unet{ucfg.image_hw}_{name}", plan, b, False))

    vae_ms, vae_split = {}, {}
    with torch.inference_mode():
        for wdtype, c_ in v_cfgs.items():
            for b in (1, 4, 16, 64):
                xv, ev = randn(b, 32, 32, 3), randn(b, vcfg.latent_dim)

                def fwd(p_=v_params[wdtype], x_=xv, e_=ev, c__=c_):
                    return vae.vae_apply(p_, x_, None, c__, eps=e_)
                key = f"{wdtype}_B{b}"
                vae_ms[key] = time_ms(fwd, iters=10)
                if b in VAE_BATCHES:
                    vae_split[key] = forward_split(fwd, vae_ms[key])
    print(f"[time] VAE forward ms per bucket (CUDA events): "
          f"{json.dumps(vae_ms)}; device time by kernel, busy share "
          f"(torch.profiler): {json.dumps(vae_split)}")

    def elbo_step_ms(cfg_, iters=5):
        p_, g_ = v_params["float32"], torch.Generator().manual_seed(11)
        for _ in range(2):
            p_, _ = vae_train.sgd_step(p_, xs_v[0], g_, cfg_, VAE_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            p_, _ = vae_train.sgd_step(p_, xs_v[0], g_, cfg_, VAE_LR)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    elbo_ms = {backend: elbo_step_ms(dataclasses.replace(vcfg,
                                                         backend=backend))
               for backend in ("cuda", "torch")}
    print(f"[time] VAE ELBO step at B=64 (host clock over 5 steps after 2, "
          f"synchronized) ms: {json.dumps(elbo_ms)} | {smi}")

    # ---- 4g. measured route autotuning at the VAE and DCGAN sites ---------
    autotune_recs = []
    with tempfile.TemporaryDirectory() as tmp:
        cache_file = os.path.join(tmp, "route_cache.json")
        policy = at.AutotunePolicy(mode="measure", cache_path=cache_file)
        heur = {f"VAE_{i}": p for i, p in enumerate(vae.vae_plans(vcfg))}
        heur.update({f"DCGAN_DC{i + 1}": p for i, p in enumerate(
            gan.generator_plans(gan.GANConfig("dcgan", gan.DCGAN_LAYERS,
                                              backend="cuda")))})
        before = at.measure_calls()
        t0 = time.perf_counter()
        tuned = {name: plan_conv(p.spec, autotune=policy)
                 for name, p in heur.items()}
        tune_s = time.perf_counter() - t0
        measured = at.measure_calls() - before
        cache = at.open_cache(cache_file)
        for name, p in heur.items():
            ent = cache.entries[at.spec_key(p.spec)]
            for r in tuned[name].routes:
                h_r = p.route_for_batch(r.batch)
                us = ent["routes"][str(r.batch)]["measured_us"]
                b = r.batch
                sp_ = p.spec
                x = randn(b, *sp_.in_hw, sp_.in_c)
                kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
                packed = p.pack(kern)
                with torch.inference_mode():
                    y = tuned[name].apply(x, packed)
                    y_t = plan_conv(dataclasses.replace(
                        sp_, backend="torch")).apply(x, packed)
                if r.path == "cuda":
                    y64, bound = f64_bound(p, x, kern)
                    ok = bool(((y.double() - y64).abs() <= bound).all())
                    check = "f64 bound"
                    del y64, bound
                else:
                    ok = float((y - y_t).abs().max()) \
                        <= TOL_VAE * float(y_t.abs().max())
                    check = f"{TOL_VAE}·max|y_torch|"
                rec = {"site": name, "batch": b, "candidates_us": us,
                       "winner": at.route_label(r),
                       "heuristic": at.route_label(h_r),
                       "flipped": r != h_r, "checked": check, "ok": ok}
                autotune_recs.append(rec)
                print(f"[autotune] {name} B={b}: min µs "
                      + ", ".join(f"{lab} {v:.1f}" for lab, v in
                                  sorted(us.items(), key=lambda kv: kv[1]))
                      + f"; winner {rec['winner']} (heuristic "
                      f"{rec['heuristic']}, "
                      f"{'flipped' if rec['flipped'] else 'kept'}); output "
                      f"within {check}: {ok}")
                if not ok:
                    raise RuntimeError(f"tuned {name} B={b} "
                                       f"({rec['winner']}) off its check")
        # a second load reads the cache and measures nothing
        plan_cache_clear()
        before = at.measure_calls()
        cpolicy = at.AutotunePolicy(mode="cache", cache_path=cache_file)
        again = {name: plan_conv(p.spec, autotune=cpolicy)
                 for name, p in heur.items()}
        if at.measure_calls() != before or any(
                again[n].routes != tuned[n].routes for n in heur):
            raise RuntimeError("the warm route cache measured again or "
                               "gave other routes")
        # serve_dcgan on the cache: bucket costs measured once, then a
        # restarted server re-times no bucket and measures no route
        argv = ["--requests", str(BURST), "--route-cache", cache_file,
                "--device", str(dev)]
        plan_cache_clear()
        first = serve_dcgan.main(argv + ["--autotune", "measure"])
        plan_cache_clear()
        before = at.measure_calls()
        st = serve_dcgan.main(argv + ["--autotune", "cache"])
        if st["warmup_timed"] != () or at.measure_calls() != before:
            raise RuntimeError(f"the warm serve_dcgan timed buckets "
                               f"{st['warmup_timed']} or measured routes")
        cfg_s, params_s = serve_dcgan.load_model(
            small=False, backend="cuda", device=dev, autotune=cpolicy)
        worst = 0.0
        with torch.inference_mode():
            for r in st["requests"]:
                one = gan.generator_apply(
                    params_s, torch.from_numpy(r.payload)[None].to(dev),
                    cfg_s)[0].cpu()
                diff = (one - torch.from_numpy(r.out)).abs()
                worst = max(worst, float(diff.max()))
                if not bool((diff <= TOL_ROW * (1 + one.abs())).all()):
                    raise RuntimeError(f"tuned serve_dcgan request {r.rid} "
                                       f"differs from its B=1 forward by "
                                       f"{float(diff.max()):.3e}")
        if sorted(r.rid for r in st["requests"]) != list(range(BURST)):
            raise RuntimeError("tuned serve_dcgan dropped or repeated a "
                               "request")
    flips = [(r["site"], r["batch"], r["heuristic"], r["winner"])
             for r in autotune_recs if r["flipped"]]
    print(f"[autotune] {len(heur)} sites x 4 buckets tuned in {tune_s:.1f} "
          f"s ({measured} candidate measurements); flips {flips}; a second "
          f"load in 'cache' mode measured nothing and gave the same routes; "
          f"serve_dcgan --autotune cache: {len(st['requests'])}/{BURST} "
          f"answered, warmup timed {st['warmup_timed']} (first run timed "
          f"{first['warmup_timed']}), max |row - B=1 forward| {worst:.3e}")
    records = {"vae_serve": vae_serve, "vae_train_losses": vae_losses,
               "vae_grad_rel": grad_rel, "vae_b_sites": vae_b_sites,
               "vae_a_sites": vae_a_sites, "pad13_sites": pad13_sites,
               "per_phase_dcgan_sites": pp_sites, "vae_forward_ms": vae_ms,
               "vae_device_split": vae_split, "vae_elbo_step_ms": elbo_ms,
               "autotune": autotune_recs}
    launches = {"A": {"vae": sum(v["A"] for k, v in vae_launches.items()
                                 if "_float32_" in k),
                      "train_vae": vae_train_launches["A"]},
                "B": {"vae": sum(v["B"] for k, v in vae_launches.items()
                                 if "_float32_" in k),
                      "train_vae": vae_train_launches["B"]},
                "A_int8": {"vae_int8": sum(v["A"] for k, v in
                                           vae_launches.items()
                                           if "_int8_" in k)},
                "B_int8": {"vae_int8": sum(v["B"] for k, v in
                                           vae_launches.items()
                                           if "_int8_" in k)}}
    return records, launches


def host_ms(fn, iters=20, warmup=3):
    """Host wall ms of one synchronized call of ``fn``: the mean over
    ``iters`` calls after ``warmup``, each ended by a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def control_plane_phases(dev, smi, gen):
    """Phases 3i and 4h: the control plane on the card at full width (the
    Table-1 DCGAN generator, ``SEGNET`` f32 and llama3.2-1b behind one
    ``ControlPlane``, a seeded burst of both priority classes with SLOs,
    a fault at an image launch and one at a decode step, checked against
    a fault-free pass and the eager ``ContinuousBatcher``), then each
    image model's forward per bucket eager against its CUDA graph and the
    decode step at 4 slots eager against the slot graphs.  Returns
    (records for the results line, {kernel: {path: launches}})."""
    import numpy as np
    import torch

    from repro_torch import serve_segnet
    from repro_torch.configs import registry
    from repro_torch.models import gan, segnet
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.control_plane import ControlPlane, ServeRequest
    from repro_torch.serving.image_batcher import DynamicImageBatcher

    # ---- 3i. three models behind one control plane, two faults -----------
    gcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    gparams = gan.generator_init(0, gcfg, device=dev)

    def gen_fn(z):
        return gan.generator_apply(gparams, z, gcfg)
    seg = {}
    for wdtype in ("float32", "int8"):
        scfg, sparams = serve_segnet.load_model(
            full=True, backend="cuda", wdtype=wdtype, device=dev)

        def seg_fn(x, p=sparams, c=scfg):
            return torch.argmax(segnet.segnet_apply(p, x, c), dim=-1)
        seg[wdtype] = (scfg, seg_fn)
    scfg = seg["float32"][0]
    lcfg = registry.get_config("llama3.2-1b")
    lparams = tfm.init(lcfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(22)
    z_proto = torch.zeros(gcfg.z_dim).numpy()
    x_proto = torch.zeros((scfg.in_hw, scfg.in_hw, scfg.in_c)).numpy()
    lats = torch.randn((CP_IMAGES, gcfg.z_dim), generator=g).numpy()
    imgs = (torch.rand((CP_IMAGES, scfg.in_hw, scfg.in_hw, scfg.in_c),
                       generator=g) * 2 - 1).numpy()
    prompts = [torch.randint(0, lcfg.vocab_size, (p,), generator=g).numpy()
               for p in CP_PROMPTS]
    classes = torch.randint(0, 2, (2 * CP_IMAGES + len(CP_PROMPTS),),
                            generator=g).tolist()

    def trace(mod):
        """The burst as ``ServeRequest``s: images 0.. (DCGAN) and 100..
        (SegNet), prompts 200..; every fourth image with a 60 s SLO, one
        image of each model with a 1 us SLO (rejected at admission: a
        launch costs more), one prompt arrived 10 s ago with a 1 s SLO
        (admitted: the LM has no cost yet; shed at launch)."""
        reqs = []
        for i in range(CP_IMAGES):
            for base, model, payload in ((0, "dcgan", lats[i]),
                                         (100, "segnet", imgs[i])):
                slo = 1e-3 if i == 5 else 60_000.0 if i % 4 == 0 else None
                reqs.append(mod(rid=base + i, model=model, payload=payload,
                                priority=PRIORITY_OF[classes[base // 100
                                                             * CP_IMAGES
                                                             + i]],
                                slo_ms=slo))
        for j, p in enumerate(prompts):
            reqs.append(mod(rid=200 + j, model="llama", payload=p,
                            max_new=CP_MAX_NEW, priority=PRIORITY_OF[
                                classes[2 * CP_IMAGES + j]],
                            slo_ms=60_000.0 if j % 2 else None))
        reqs.append(mod(rid=200 + len(prompts), model="llama",
                        payload=prompts[0], max_new=CP_MAX_NEW,
                        slo_ms=1_000.0,
                        t_arrival=time.perf_counter() - 10.0))
        return reqs

    def plane(injector=None, costs=None):
        cp = ControlPlane(injector=injector, starvation_ms=CP_STARVATION_MS)
        bes = {"dcgan": cp.register_image_model("dcgan", gen_fn, z_proto,
                                                device=dev),
               "segnet": cp.register_image_model(
                   "segnet", seg["float32"][1], x_proto, device=dev)}
        cp.register_lm_model("llama", lcfg, lparams, slots=4,
                             max_len=CP_MAX_LEN, device=dev)
        if costs is None:
            cp.warmup()
        else:
            for name, be in bes.items():
                be.batcher.bucket_cost_s = dict(costs[name])
        return cp, bes

    zero_counts()
    cp, bes = plane(FailureInjector(CP_FAULTS))
    t0 = time.perf_counter()
    cp.run(trace(ServeRequest))
    torch.cuda.synchronize()
    cp_s = time.perf_counter() - t0
    st = cp.stats()
    n_sub = 2 * CP_IMAGES + len(CP_PROMPTS) + 1
    answered = [r.rid for r in cp.done + cp.rejected + cp.shed]
    if st["submitted"] != n_sub or sorted(answered) != sorted(
            set(answered)) or len(answered) != n_sub \
            or st["submitted"] != st["served"] + st["rejected"] + st["shed"]:
        raise RuntimeError(f"control plane: a request was lost or answered "
                           f"twice: {st}")
    faulted = {rec["model"] for rec in st["faults"]["records"]}
    if st["faults"]["events"] != 2 or "llama" not in faulted or not \
            faulted & {"dcgan", "segnet"} or not st["replayed_requests"]:
        raise RuntimeError(f"control plane faults {st['faults']}, "
                           f"{st['replayed_requests']} replayed")
    want_rej = {5, 105}
    if {r.rid for r in cp.rejected} != want_rej or \
            [r.rid for r in cp.shed] != [200 + len(prompts)]:
        raise RuntimeError(f"rejected {[r.rid for r in cp.rejected]}, shed "
                           f"{[r.rid for r in cp.shed]}")
    # the fault-free pass on the same measured costs: the same launches,
    # so the same bits
    ref, _ = plane(costs={n: be.batcher.bucket_cost_s
                          for n, be in bes.items()})
    ref.run(trace(ServeRequest))
    got, want = cp.results(), ref.results()
    differ = sorted(rid for rid in got if rid not in want
                    or not np.array_equal(got[rid], want[rid]))
    if sorted(got) != sorted(want) or differ:
        raise RuntimeError(f"control plane: answers differ from the "
                           f"fault-free pass: rids {differ}; launches "
                           f"{ {n: b.batcher.launches for n, b in bes.items()} }")
    # the eager batcher on the same prompts gives the graphs' tokens
    eager = ContinuousBatcher(lcfg, lparams, slots=4, max_len=CP_MAX_LEN,
                              device=dev, graphs=False)
    for j, p in enumerate(prompts):
        eager.submit(Request(rid=200 + j, prompt=p, max_new=CP_MAX_NEW))
    eager.run()
    if any(list(got[r.rid]) != r.out for r in eager.done):
        raise RuntimeError("control plane: graph decode tokens differ from "
                           "the eager ContinuousBatcher's")
    launches = {name: be.batcher.graph_launches()
                for name, be in bes.items()}
    want_l = {"dcgan": {"A": 4 * len(bes["dcgan"].batcher.launches)},
              "segnet": {"B": 10 * len(bes["segnet"].batcher.launches)}}
    eager_l, _ = read_counts("float32")
    if launches != want_l or not all(v for d in want_l.values()
                                     for v in d.values()):
        raise RuntimeError(f"control plane graph launches {launches}, want "
                           f"{want_l}")
    per_class = {c: {k: v[k] for k in ("completed", "p50_ms", "p99_ms",
                                       "goodput_under_slo", "rejected",
                                       "shed", "slo_miss")}
                 for c, v in st["per_class"].items()}
    cp_rec = {"submitted": st["submitted"], "served": st["served"],
              "rejected": st["rejected"], "shed": st["shed"],
              "replayed_requests": st["replayed_requests"],
              "goodput_under_slo": st["goodput_under_slo"],
              "per_class": per_class, "faults": st["faults"]["records"],
              "per_model": st["per_model"], "wall_s": cp_s,
              "graph_launches": launches,
              "wrapper_launches_warmup_and_eager": eager_l}
    print(f"[control plane] DCGAN, SegNet and llama3.2-1b (full width) "
          f"behind one plane: {st['submitted']} submitted = "
          f"{st['served']} served + {st['rejected']} rejected + "
          f"{st['shed']} shed, each answered once; faults "
          f"{json.dumps(st['faults']['records'])}; "
          f"{st['replayed_requests']} replayed; answers bit-equal to the "
          f"fault-free pass, decode tokens equal to the eager batcher's; "
          f"graph launches {launches}; per class "
          f"{json.dumps(per_class)}; goodput under SLO "
          f"{st['goodput_under_slo']:.3f}; {cp_s:.2f} s | {smi}")

    # ---- 4h. times: eager forward against its CUDA graph, decode --------
    graph_times = []
    for name, fn, proto in (("dcgan", gen_fn, z_proto),
                            ("segnet_float32", seg["float32"][1], x_proto),
                            ("segnet_int8", seg["int8"][1], x_proto)):
        b = DynamicImageBatcher(fn, device=dev)
        b.warmup(proto, iters=1)
        for bucket, gr in sorted(b.graphs.items()):
            x, = gr.inputs
            with torch.no_grad():
                x.copy_((torch.rand(x.shape, generator=gen) * 2 - 1).to(x))

            def eager_call():
                with torch.inference_mode():
                    fn(x)
            rec = {"model": name, "batch": bucket,
                   "eager_ms": time_ms(eager_call),
                   "eager_wall_ms": host_ms(eager_call),
                   "graph_ms": time_ms(gr.graph.replay),
                   "graph_wall_ms": host_ms(gr.graph.replay)}
            for tag, call in (("eager", eager_call),
                              ("graph", gr.graph.replay)):
                _, evs = device_events(call, 1)
                busy = None if evs is None else sum(
                    ev.device_time_total for ev in evs) / 1e3
                rec[f"{tag}_device_ms"] = busy
                rec[f"{tag}_busy_share"] = (
                    None if busy is None else busy / rec[f"{tag}_wall_ms"])
            graph_times.append(rec)
            print(f"[time] {name} B={bucket}: eager {rec['eager_ms']:.4f} "
                  f"ms (events) / {rec['eager_wall_ms']:.4f} ms (host wall),"
                  f" device {ms_text(rec['eager_device_ms'])} ms, busy "
                  f"{ms_text(rec['eager_busy_share'], '.3f')}; graph "
                  f"{rec['graph_ms']:.4f} / {rec['graph_wall_ms']:.4f} ms, "
                  f"device {ms_text(rec['graph_device_ms'])} ms, busy "
                  f"{ms_text(rec['graph_busy_share'], '.3f')} | {smi}")
        del b
    decode = {}
    for graphs in (False, True):
        cb = ContinuousBatcher(lcfg, lparams, slots=4, max_len=CP_MAX_LEN,
                               device=dev, graphs=graphs)
        for j in range(4):
            cb.submit(Request(rid=j, prompt=prompts[j][:2],
                              max_new=CP_MAX_LEN))
        for _ in range(4):
            cb.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            cb.step()
        ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
        _, evs = device_events(cb.step, 1)
        busy = None if evs is None else sum(
            ev.device_time_total for ev in evs) / 1e3
        decode["graph" if graphs else "eager"] = {
            "ms_per_step": ms, "device_ms": busy,
            "busy_share": None if busy is None else busy / ms}
    print(f"[time] llama3.2-1b decode, 4 slots, a step (host wall over "
          f"{DECODE_STEPS} steps, one argmax read-back a step under "
          f"graphs): eager {decode['eager']['ms_per_step']:.3f} ms "
          f"(device {ms_text(decode['eager']['device_ms'])}), graph "
          f"{decode['graph']['ms_per_step']:.3f} ms (device "
          f"{ms_text(decode['graph']['device_ms'])}) | {smi}")
    records = {"control_plane": cp_rec, "graph_forward_ms": graph_times,
               "decode_4_slots": decode}
    return records, {"A": {"control_plane_dcgan": launches["dcgan"]["A"]},
                     "B": {"control_plane_segnet": launches["segnet"]["B"]}}


# ---------------------------------------------------------------------------
# 3n. plane-parallel execution over ranks that share the card
# ---------------------------------------------------------------------------

def _pp_rel(ref, got) -> float:
    """max|got - ref| / max|ref| (float64)."""
    ref, got = ref.detach().double(), got.detach().double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _pp_patch(obj, name, wrap):
    """Swap ``obj.name`` for ``wrap(original)``; returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


def _pp_zero_halo(rank):
    """Planted fault: the first halo rank 1 receives arrives as zeros."""
    state = {"done": False}

    def wrap(orig):
        def send_recv(sends, recvs, group):
            orig(sends, recvs, group)
            if rank == 1 and recvs and not state["done"]:
                state["done"] = True
                recvs[0][0].zero_()
        return send_recv
    return wrap


def _pp_unsummed(rank):
    """Planted fault: rank 1 keeps its own piece of the superpack
    gradient (the all-reduce still runs, so no rank waits)."""
    def wrap(orig):
        def all_reduce(t, group):
            summed = orig(t.clone(), group)
            return t if rank == 1 else summed
        return all_reduce
    return wrap


def _pp_ms(fn, dev, iters=3, warmup=1):
    """CUDA-event ms of one call on the card (the host clock around a
    synchronised call on the CPU, where the phase rehearses)."""
    if dev.type == "cuda":
        return time_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _pp_device_ms(fn, dev):
    """Device ms of one call from one trace (no retake: a rank that ran
    the call again alone would leave its peers waiting)."""
    if dev.type != "cuda":
        return None
    _, evs = device_events(fn, 1, tries=1)
    return None if evs is None else sum(e.device_time_total
                                        for e in evs) / 1e3


def _pp_peak(fn, dev):
    """(peak bytes allocated during ``fn()``, bytes allocated before)."""
    import torch
    if dev.type != "cuda":
        return None, None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), base


def _pp_gather_sites(orig):
    """Planted fault for the memory gate: each split site's output is
    gathered into the whole plane (what keeping planes whole between
    sites costs)."""
    def try_spatial(plan, x, packed):
        y = orig(plan, x, packed)
        return None if y is None else y.full()
    return try_spatial


def _pp_kernel(spec, route) -> str:
    if spec.kind == "transposed":
        return "D" if route.sp_tiles else "A"
    return "C" if route.sp_tiles else "B"


def _pp_case(rank, dev, case, batch, index):
    """One (a) case on this rank: the split plan's forward and gradients
    of sum(y²) against the single-device 'cuda' plan and the f64 bound,
    then the two planted faults through the same gates."""
    import torch
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh
    name, kind, hw, c, n, k, s, pad, dil, tiles, data = case
    spec = ConvSpec(kind=kind, in_hw=(hw, hw), in_c=c, out_c=n,
                    kernel_hw=(k, k), strides=(s, s), padding=pad,
                    dilation=(dil, dil), backend="cuda", spatial=tiles)
    plan = plan_conv(spec)
    one = plan_conv(dataclasses.replace(spec, spatial=(1, 1)))
    if plan.route_for_batch(batch).dev_tiles != tuple(tiles):
        raise RuntimeError(f"{name} {tiles}: no dev_tiles verdict at B = "
                           f"{batch}")
    sp = spatial.spatial_plan(spec)
    local = plan_conv(sp.local_spec)
    b_local = batch // data if batch % data == 0 else batch
    lroute = local.route_for_batch(b_local)
    g = torch.Generator().manual_seed(100 + index)
    x = torch.randn((batch, hw, hw, c), generator=g).to(dev)
    kern = (torch.randn((k, k, c, n), generator=g)
            * (2.0 / (k * k * c)) ** 0.5).to(dev)
    pk = one.pack(kern)
    mesh = make_spatial_mesh(*tiles, data=data)

    def run(split):
        xg = x.clone().requires_grad_(True)
        w = pk.clone().requires_grad_(True)
        with spatial.use_spatial_mesh(mesh if split else None):
            y = (plan if split else one).apply(xg, w)
            (y ** 2).sum().backward()
        return y.detach(), xg.grad, w.grad

    zero_counts()
    y, gx, gk = run(True)
    launches = read_counts("float32")[0]
    y1, gx1, gk1 = run(False)
    with torch.no_grad():
        y64, bound = f64_bound(one, x, kern)

    def ulp(yv):
        return float(((yv.double() - y64).abs() / bound).max())
    rec = {"case": f"{name}_{tiles[0]}x{tiles[1]}"
                   + (f"_data{data}" if data > 1 else ""),
           "rank": rank, "local_in_hw": list(sp.local_spec.in_hw),
           "local_route": lroute.path,
           "local_sp_tiles": lroute.sp_tiles, "kernel":
           _pp_kernel(spec, lroute), "launches": launches,
           "halos": [[d.halo_lo, d.halo_hi] for d in sp.dims],
           "blocks": [d.block for d in sp.dims],
           "sound": {"ulp": ulp(y), "ulp_single": ulp(y1),
                     "fwd": _pp_rel(y1, y), "gx": _pp_rel(gx1, gx),
                     "gk": _pp_rel(gk1, gk)}}
    undo = _pp_patch(spatial, "_send_recv", _pp_zero_halo(rank))
    try:
        yf, gxf, _ = run(True)
    finally:
        undo()
    undo = _pp_patch(spatial, "_all_reduce", _pp_unsummed(rank))
    try:
        _, _, gkf = run(True)
    finally:
        undo()
    rec["planted"] = {"ulp": ulp(yf), "fwd": _pp_rel(y1, yf),
                      "gx": _pp_rel(gx1, gxf), "gk": _pp_rel(gk1, gkf)}
    return rec


def _pp_unet(rank, dev, hw, batch, tilings):
    """(b): the 512 px U-Net at full width, its single-device forward on
    rank 0, then split at each tiling over the first D_h·D_w ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import spatial
    from repro_torch.launch.mesh import make_spatial_mesh
    from repro_torch.models import unet
    cfg = unet.UNetConfig("unet-512", image_hw=hw, backend="cuda")
    params = unet.unet_init(6, cfg, device=dev)
    g = torch.Generator().manual_seed(9)
    x = torch.randn((batch, hw, hw, cfg.in_c), generator=g).to(dev)
    t = torch.rand((batch,), generator=g).to(dev)
    out = {"single": None, "split": []}
    y1 = None
    if rank == 0:
        def single():
            with torch.inference_mode():
                return unet.unet_apply(params, x, t, cfg)
        y1 = single()
        peak, base = _pp_peak(single, dev)
        out["single"] = {"ms": _pp_ms(single, dev),
                         "device_ms": _pp_device_ms(single, dev),
                         "peak_bytes": peak, "base_bytes": base}
    dist.barrier()
    for tiles in tilings:
        n_ranks = tiles[0] * tiles[1]
        mesh = make_spatial_mesh(*tiles)
        scfg = dataclasses.replace(cfg, spatial=tuple(tiles))
        plans = unet.unet_plans(scfg)
        verdicts = {name: p.route_for_batch(batch).dev_tiles
                    for name, p in plans.items()}
        rec = {"tiles": list(tiles), "rank": rank, "verdicts": verdicts}
        if rank < n_ranks:
            def split():
                with torch.inference_mode(), spatial.use_spatial_mesh(mesh):
                    return unet.unet_apply(params, x, t, scfg)
            clock = {"exchange": 0.0, "gather": 0.0}

            def timed(key):
                def wrap(orig):
                    def f(*a):
                        t0 = time.perf_counter()
                        r = orig(*a)
                        clock[key] += time.perf_counter() - t0
                        return r
                    return f
                return wrap
            zero_counts()
            y = split()
            rec["launches"] = read_counts("float32")[0]
            undos = [_pp_patch(spatial, "_send_recv", timed("exchange")),
                     _pp_patch(spatial, "_all_gather", timed("gather"))]
            try:
                split()
            finally:
                for u in undos:
                    u()
            rec["exchange_ms"] = clock["exchange"] * 1e3
            rec["gather_ms"] = clock["gather"] * 1e3
            rec["ms"] = _pp_ms(split, dev)
            rec["device_ms"] = _pp_device_ms(split, dev)
            rec["peak_bytes"], rec["base_bytes"] = _pp_peak(split, dev)
            # planted: every split site's output gathered (whole planes)
            undo = _pp_patch(spatial, "try_spatial", _pp_gather_sites)
            try:
                rec["planted_peak_bytes"], rec["planted_base_bytes"] = \
                    _pp_peak(split, dev)
            finally:
                undo()
            rec["halo_bytes"] = sum(
                spatial.halo_bytes(spatial.spatial_plan(p.spec), batch, 4)
                for name, p in plans.items() if verdicts[name])
            undo = _pp_patch(spatial, "_send_recv", _pp_zero_halo(rank))
            try:
                yf = split()
            finally:
                undo()
            if rank == 0:
                rec["sound"] = _pp_rel(y1, y)
                rec["planted"] = _pp_rel(y1, yf)
        dist.barrier()
        out["split"].append(rec)
    return out


def _pp_control_plane(rank, dev, n_req):
    """(c): the 385 px dilated site served at (1, 1), then after
    ``degrade(4, spatial_tiles=(2, 2))`` and ``degrade(4,
    spatial_tiles=(2, 1))`` (data = 2); every answer against its f64 bound
    and the answers served before.  All ranks drive their own plane on one
    fake clock, so they take the same decisions."""
    import numpy as np
    import torch
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.serving.control_plane import ControlPlane, ServeRequest
    spec = ConvSpec(kind="dilated", in_hw=(385, 385), in_c=32, out_c=32,
                    kernel_hw=(3, 3), padding=((2, 2), (2, 2)),
                    dilation=(2, 2), backend="cuda")
    g = torch.Generator().manual_seed(23)
    kern = (torch.randn((3, 3, 32, 32), generator=g) * (2 / 288) ** 0.5)
    payloads = [torch.randn((385, 385, 32), generator=g).numpy()
                for _ in range(n_req)]
    kern = kern.to(dev)

    def serve_for(tiles):
        plan = plan_conv(dataclasses.replace(spec, spatial=tiles))
        pk = plan.pack(kern)
        return lambda x: plan.apply(x, pk)
    one = plan_conv(spec)
    bounds = []
    for z in payloads:
        with torch.no_grad():
            bounds.append(f64_bound(one, torch.from_numpy(z[None]).to(dev),
                                    kern))
    ticks = iter(range(10 ** 6))
    cp = ControlPlane(clock=lambda: next(ticks) * 1e-3)
    cp.register_image_model("ctx385", serve_for((1, 1)),
                            np.zeros((385, 385, 32), np.float32),
                            buckets=(1, 2, 4), device=dev)
    rounds = []
    for step, tiles in enumerate((None, (2, 2), (2, 1))):
        deg = None
        if tiles is not None:
            mesh = cp.degrade(4, spatial_tiles=tiles,
                              serve_fns={"ctx385": serve_for(tiles)})
            deg = {"mesh": mesh_shape(mesh), **{
                k: v for k, v in cp.degraded.items() if k != "mesh_shape"}}
            if spatial.active_spatial_mesh()[0] is not mesh:
                raise RuntimeError("degrade bound no spatial mesh")
        base = 100 * step
        zero_counts()
        split0 = spatial.SPLIT_SITES[0]
        cp.run([ServeRequest(rid=base + i, model="ctx385", payload=z)
                for i, z in enumerate(payloads)])
        launches = read_counts("float32")[0]
        split = spatial.SPLIT_SITES[0] - split0
        got = {r.rid - base: r.out for r in cp.done if r.rid >= base}
        ulps = []
        for i, (y64, bound) in enumerate(bounds):
            yv = torch.from_numpy(got[i]).to(dev).double()
            ulps.append(float(((yv - y64[0]).abs() / bound[0]).max()))
        rounds.append({"tiles": tiles, "degraded": deg, "ulp": ulps,
                       "launches": launches, "split_sites": split,
                       "answers": got})
    first = rounds[0]["answers"]
    for rnd in rounds:
        rnd["vs_first"] = max(_pp_rel(torch.from_numpy(first[i]),
                                      torch.from_numpy(rnd["answers"][i]))
                              for i in first)
        del rnd["answers"]
    return rounds


def _pp_autotune(rank, dev):
    """(e): the 385 px dilated site measured under a bound (4, 1) mesh:
    its device-tiled candidates timed beside the single-device ones, every
    rank taking the slowest rank's times (``autotune._slowest_rank``, a
    MAX all-reduce over each mesh axis), so all pick one winner."""
    from repro_torch.core import spatial
    from repro_torch.core.autotune import (AutotunePolicy, measure_bucket,
                                           route_label)
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh
    plan = plan_conv(ConvSpec(kind="dilated", in_hw=(385, 385), in_c=32,
                              out_c=32, kernel_hw=(3, 3),
                              padding=((2, 2), (2, 2)), dilation=(2, 2),
                              backend="cuda", spatial=(4, 1)))
    with spatial.use_spatial_mesh(make_spatial_mesh(4, 1)):
        best, timings = measure_bucket(plan, PP_BATCH, AutotunePolicy(
            iters=2, warmup=1, min_gain=1.0))
    return {"rank": rank, "best": route_label(best),
            "timings": timings}


def _pp_rank(rank, world, dev, conf):
    """One rank of phase 3n (all ranks share the card)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases, batch, unet_hw, unet_batch, unet_tilings, n_req = conf
    out = {"cases": [_pp_case(rank, dev, case, batch, i)
                     for i, case in enumerate(cases)]}
    out["unet"] = _pp_unet(rank, dev, unet_hw, unet_batch, unet_tilings)
    out["control_plane"] = _pp_control_plane(rank, dev, n_req)
    out["autotune"] = _pp_autotune(rank, dev)
    return out


def plane_parallel_phases(dev, smi):
    """Phase 3n: plane-parallel execution (``core.spatial``) over
    ``PP_WORLD`` ranks that share the card on a gloo group, the halos
    staged through host memory.  (a) JAX's three ``CONVPLANE_SITES`` at
    their widths and batch, per tiling: each rank's local route, kernel and
    launches, the halo widths, the assembled output against the f64
    bound and the single-device 'cuda' plan, the x and superpack
    gradients of sum(y²) against the single-device plan's, each gate read
    sound and with a planted fault (an inner halo delivered as zeros; the
    superpack gradient unsummed on rank 1).  (b) the 512 px U-Net at full
    width split (2, 1) on 2 ranks and (2, 2) on 4: every site's verdict,
    the output against the single-device forward (with the zero-halo
    fault read through the same gate), per rank its forward ms, device ms
    and peak memory beside the single-device forward's, the halo bytes a
    forward and the exchange's and the site gathers' ms.  (c) the control
    plane serving the 385 px site, then degraded onto (2, 2) and onto
    (2, 1) with data = 2, every answer within its f64 bound.  Returns
    (records, {kernel: {path: launches summed over ranks}})."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_spmd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    conf = (PP_CASES, PP_BATCH, UNET_512_HW, PP_UNET_BATCH, PP_UNET_TILINGS,
            PP_CP_REQUESTS)
    ranks = run_spmd(_pp_rank, PP_WORLD, conf, device=dev.type, timeout=900)
    wall = time.perf_counter() - t0
    paths = {k: {} for k in "ABCD"}

    def add(path, launches):
        for k, v in launches.items():
            if v:
                paths[k][path] = paths[k].get(path, 0) + v

    failed = []
    # ---- (a) ----------------------------------------------------------------
    for i, case in enumerate(PP_CASES):
        recs = [r["cases"][i] for r in ranks]
        name = recs[0]["case"]
        for rec in recs:
            add(f"plane_parallel_{name}", rec["launches"])
            s, p = rec["sound"], rec["planted"]
            print(f"[3n] {name} rank {rec['rank']}: local {rec['local_in_hw']}"
                  f" on {rec['local_route']} sp_tiles "
                  f"{rec['local_sp_tiles']} = kernel {rec['kernel']}, "
                  f"launches {rec['launches']}, halos (lo, hi) per dim "
                  f"{rec['halos']}, blocks {rec['blocks']}")
            print(f"[3n] {name} rank {rec['rank']}: f64 ULP ratio (limit 1) "
                  f"sound {s['ulp']:.3f} (single-device {s['ulp_single']:.3f})"
                  f", zero halo {p['ulp']:.3e}; vs single-device, limit "
                  f"{TOL_PP:.0e}: y sound {s['fwd']:.2e} / zero halo "
                  f"{p['fwd']:.2e}, dx sound {s['gx']:.2e} / zero halo "
                  f"{p['gx']:.2e}, dsuperpack sound {s['gk']:.2e} / unsummed"
                  f" on rank 1 {p['gk']:.2e}")
            ok = (s["ulp"] <= 1 and s["ulp_single"] <= 1
                  and max(s["fwd"], s["gx"], s["gk"]) <= TOL_PP
                  and p["ulp"] > 1 and p["fwd"] > TOL_PP
                  and p["gx"] > TOL_PP
                  and (rec["rank"] != 1 or p["gk"] > TOL_PP))
            if not ok:
                failed.append(f"{name} rank {rec['rank']}")
        if sum(sum(r["launches"].values()) for r in recs) == 0 \
                and dev.type == "cuda":
            failed.append(f"{name}: no kernel launch")
    # ---- (b) ----------------------------------------------------------------
    single = ranks[0]["unet"]["single"]
    print(f"[3n] unet512 B={PP_UNET_BATCH} single-device: "
          f"{single['ms']:.3f} ms (events), device "
          f"{ms_text(single['device_ms'])} ms, peak {single['peak_bytes']}"
          f" bytes ({single['base_bytes']} before) | {smi}")
    for j, tiles in enumerate(PP_UNET_TILINGS):
        recs = [r["unet"]["split"][j] for r in ranks]
        tag = f"unet512_{tiles[0]}x{tiles[1]}"
        print(f"[3n] {tag} verdicts: {recs[0]['verdicts']}")
        for rec in recs:
            if "ms" not in rec:
                continue
            add(f"plane_parallel_{tag}", rec["launches"])
            print(f"[3n] {tag} rank {rec['rank']}: {rec['ms']:.3f} ms "
                  f"(events), device {ms_text(rec['device_ms'])} ms, peak "
                  f"{rec['peak_bytes']} bytes ({rec['base_bytes']} before), "
                  f"launches {rec['launches']}, halo bytes a forward "
                  f"{rec['halo_bytes']} (geometry), exchange "
                  f"{rec['exchange_ms']:.3f} ms, output gather "
                  f"{rec['gather_ms']:.3f} ms (host clock) | {smi}")
            if dev.type == "cuda":
                act = single["peak_bytes"] - single["base_bytes"]
                sound = (rec["peak_bytes"] - rec["base_bytes"]) / act
                planted = (rec["planted_peak_bytes"]
                           - rec["planted_base_bytes"]) / act
                lim = PP_MEM_LIMIT[tuple(tiles)]
                print(f"[3n] {tag} rank {rec['rank']}: activation memory "
                      f"over the single-device forward's, limit {lim}: "
                      f"sound {sound:.3f} (1/(D_h·D_w) = "
                      f"{1 / (tiles[0] * tiles[1]):.3f}), every site "
                      f"gathered {planted:.3f}")
                if not sound <= lim < planted:
                    failed.append(f"{tag} rank {rec['rank']} memory")
        r0 = recs[0]
        print(f"[3n] {tag} output vs single-device, limit {TOL_UNET:.0e}: "
              f"sound {r0['sound']:.2e}, zero halo {r0['planted']:.2e}")
        if not (r0["sound"] <= TOL_UNET < r0["planted"]):
            failed.append(tag)
    # ---- (c) ----------------------------------------------------------------
    for rnd in ranks[0]["control_plane"]:
        print(f"[3n] control plane at {rnd['tiles'] or '(1, 1)'}: "
              f"{rnd['degraded']}, f64 ULP ratios (limit 1) "
              f"{[round(u, 3) for u in rnd['ulp']]}, vs the first answers "
              f"{rnd['vs_first']:.2e}, split site runs "
              f"{rnd['split_sites']}")
    for r in ranks:
        for rnd in r["control_plane"]:
            if rnd["tiles"] is not None:
                add(f"plane_parallel_degrade_{rnd['tiles'][0]}x"
                    f"{rnd['tiles'][1]}", rnd["launches"])
            if max(rnd["ulp"]) > 1:
                failed.append(f"control plane at {rnd['tiles']}")
            # the degraded rounds split their planes, the first does not
            if (rnd["split_sites"] > 0) != (rnd["tiles"] is not None):
                failed.append(f"control plane at {rnd['tiles']}: "
                              f"{rnd['split_sites']} split site runs")
    # ---- (e) ----------------------------------------------------------------
    tuned = [(r["autotune"]["best"], r["autotune"]["timings"])
             for r in ranks]
    agree = all(t == tuned[0] for t in tuned)
    print(f"[3n] autotune under a (4, 1) mesh, B={PP_BATCH}: winner "
          f"{tuned[0][0]}, the same winner and times on every rank: "
          f"{agree}; candidates (s, slowest rank's) {tuned[0][1]}")
    split_timed = any("@dev4x1" in k for k in tuned[0][1])
    if dev.type == "cuda" and not (agree and split_timed):
        failed.append("autotune under the mesh")
    print(f"[3n] plane-parallel phase: {wall:.1f} s over {PP_WORLD} ranks, "
          f"launches {json.dumps(paths)}")
    if failed:
        raise RuntimeError(f"plane-parallel gates failed: {failed}")
    return {"plane_parallel": {"cases": [r["cases"] for r in ranks],
                               "unet": [r["unet"] for r in ranks],
                               "control_plane": ranks[0]["control_plane"],
                               "seconds": wall}}, paths


# ---------------------------------------------------------------------------
# 3s. the dry-run's count (launch/hlo_analysis.py) held against the card
# ---------------------------------------------------------------------------

# the cells, at full width: the DCGAN generator and discriminator at this
# batch (A, B), the 512 px U-Net forward at this batch (B, C, D),
# llama3.2-1b's prefill at (B, S) (F) and its train step at TRAIN_SHAPE (F
# forward, the plain backward: phase 4l's shape)
DRY_GAN_B = 64
DRY_UNET_B = 16
DRY_PREFILL = (1, 4096)
# (d): the counted peak of the step's own storages over the delta of
# torch.cuda.max_memory_allocated, for the two llama cells: the band
# PERF.md predicted before the first card run (0.98-1.02 at the prefill,
# 0.95-1.05 at the train step); the planted fault (a view of an input taken
# for a new storage, which that run met) reads 1.12 at the prefill
DRY_PEAK_BAND = (0.95, 1.05)
DRY_KERNELS = ("A", "A_int8", "B", "B_int8", "C", "C_int8", "D", "D_int8",
               "F")


def dry_counters() -> dict:
    """Every kernel entry's launch counter, by the analysis's names."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import untangled_conv as uc
    d, c = uc.untangled_deconv2d, uc.untangled_conv2d_superpack
    return {"A": d.launches, "A_int8": d.launches_int8,
            "D": d.launches_tiled, "D_int8": d.launches_tiled_int8,
            "B": c.launches, "B_int8": c.launches_int8,
            "C": c.launches_tiled, "C_int8": c.launches_tiled_int8,
            "F": fa.flash_attention.launches}


@contextlib.contextmanager
def launch_works(works):
    """Each real launch of kernels A–F inside the block appended to
    ``works`` as (kernel, FLOPs, bytes), its work function at the shapes it
    launched on: the entries wrapped where the port calls them (their
    counters are the originals', the wrapper shares their attributes)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import untangled_conv as uc

    def deconv(y, xg, sp, *, phases, scales=None, sp_tiles=None, rows=None,
               **_):
        name = ("A" if sp_tiles is None else "D") + (
            "" if scales is None else "_int8")
        # a D row block walks every row: its work is the whole K's
        return (name,) + uc.work_deconv(xg, sp, y, tuple(phases), scales,
                                        rows if sp_tiles is None else None)

    def conv(y, x, sp, *, taps_hw, scales=None, sp_tiles=None, **_):
        name = ("B" if sp_tiles is None else "C") + (
            "" if scales is None else "_int8")
        return (name,) + uc.work_conv(
            x, sp, y, scales,
            None if sp_tiles is None else taps_hw[0] * taps_hw[1] * x.shape[3])

    def attn(y, q, k, v, *, causal=True, window=0, q_offset=0, **_):
        return ("F",) + fa.work(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)

    def wrap(orig, work):
        def entry(*a, **kw):
            y = orig(*a, **kw)
            if y.is_cuda and y.numel():
                works.append(work(y, *a, **kw))
            return y
        entry.__dict__ = orig.__dict__
        return entry

    undo = []
    for mods, name, work in (((uc, plan_mod), "untangled_deconv2d", deconv),
                             ((uc, plan_mod), "untangled_conv2d_superpack",
                              conv),
                             ((fa,), "flash_attention", attn)):
        orig = getattr(mods[0], name)
        w = wrap(orig, work)
        for m in mods:
            undo.append((m, name, getattr(m, name)))
            setattr(m, name, w)
    try:
        yield works
    finally:
        for m, name, orig in reversed(undo):
            setattr(m, name, orig)


def dry_cell(name, fn, real_args, fake_args, dev, measure_peak=False):
    """One cell of phase 3s: ``fn`` counted on ``fake_args``
    (``hlo_analysis.analyze_step``), then run on ``real_args`` on the card
    once to warm up, once with the launch counters zeroed under
    ``FlopCounterMode`` and ``launch_works`` (and the peak memory reset),
    and once under ``torch.profiler`` for its device busy time.  Returns
    the cell's record with gates (a)–(d) read (``failed``: the gates it
    failed)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import roofline as rl
    t0 = time.perf_counter()
    hc = ha.analyze_step(fn, *fake_args)
    count_s = time.perf_counter() - t0
    hc.pop("out")
    fn(*real_args)
    torch.cuda.synchronize()
    gc_collect()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = dry_counters()
    works = []
    with FlopCounterMode(display=False) as fc, launch_works(works):
        out = fn(*real_args)
        torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated(dev) - base
    del out
    after = dry_counters()
    real_launches = {k: after[k] - before[k] for k in DRY_KERNELS}
    counted = {k: hc["kernels"].get(k, {}).get("launches", 0)
               for k in DRY_KERNELS}
    _, evs = device_events(lambda: fn(*real_args), 1)
    busy_s = (None if evs is None
              else sum(ev.device_time_total for ev in evs) / 1e6)
    roof = rl.roofline_from({"flops": hc["flops"],
                             "bytes accessed": hc["hbm_bytes"]},
                            {"total": hc["coll_total"]}, 1, 0.0)
    k_flops = sum(v["flops"] for v in hc["kernels"].values())
    rec = {"cell": name, "count_s": count_s,
           "launches_counted": counted, "launches_real": real_launches,
           "product_flops_counted": hc["product_flops"],
           "product_flops_real": fc.get_total_flops(),
           "kernel_flops_counted": k_flops,
           "kernel_flops_real": sum(w[1] for w in works),
           "kernel_launches_real_works": len(works),
           "flops": hc["flops"], "hbm_bytes": hc["hbm_bytes"],
           "compute_s": roof.compute_s, "memory_s": roof.memory_s,
           "device_busy_s": busy_s,
           "compute_share": (None if busy_s is None
                             else roof.compute_s / busy_s),
           "compute_share_x1000": (None if busy_s is None
                                   else 1000 * roof.compute_s / busy_s),
           "memory_share": (None if busy_s is None
                            else roof.memory_s / busy_s),
           "top_bytes_op": next(iter(hc["hbm_by_op"].items()), None),
           "input_bytes": hc["input_bytes"],
           "peak_activation_counted": hc["peak_activation_bytes"],
           "peak_activation_real": measured_peak,
           "top_buffers": hc["top_buffers"][:4]}
    failed = []
    if counted != real_launches:
        failed.append("(a) launches")
    if rec["product_flops_counted"] != rec["product_flops_real"] \
            or k_flops != rec["kernel_flops_real"] \
            or len(works) != sum(real_launches.values()):
        failed.append("(b) FLOPs")
    if busy_s is None or not (rec["compute_share"] <= 1
                              < rec["compute_share_x1000"]):
        failed.append("(c) compute term")
    if measure_peak:
        rec["peak_ratio"] = (rec["peak_activation_counted"]
                             / max(measured_peak, 1))
        if not DRY_PEAK_BAND[0] <= rec["peak_ratio"] <= DRY_PEAK_BAND[1]:
            failed.append("(d) peak memory")
    rec["failed"] = failed
    return rec


def dry_planted_peak(fn, fake_args) -> int:
    """Gate (d)'s planted fault: ``fn`` counted on ``fake_args`` by a
    tracker that takes the result of a view of an input for a new storage
    (the fault the gate's first card run met); its activation peak."""
    from repro_torch.launch import hlo_analysis as ha

    class ViewsAsNew(ha._Counter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.is_view:
                for t in ha._tensors(out):
                    self._track(t, "planted view")
            return out
    orig = ha._Counter
    ha._Counter = ViewsAsNew
    try:
        return ha.analyze_step(fn, *fake_args)["peak_activation_bytes"]
    finally:
        ha._Counter = orig


def gc_collect():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phases(dev, smi):
    """Phase 3s: the dry-run's count of a step (``launch.hlo_analysis``,
    on fake tensors, in this process) held against the same step on the
    card, at full width: the DCGAN generator and discriminator at B =
    ``DRY_GAN_B`` (kernels A, B), the 512 px U-Net forward at B =
    ``DRY_UNET_B`` (B, C, D), llama3.2-1b's prefill at ``DRY_PREFILL`` and
    its train step at ``TRAIN_SHAPE`` (F).  Gates, each cell: (a) the
    counted launches of every kernel entry equal its counter's delta on
    the card, exactly (planted: the discriminator's count with kernel B's
    fake branch not reporting must fail); (b) the counted product FLOPs
    equal ``FlopCounterMode`` over the card's run, and the counted kernel
    FLOPs the work formulas at the shapes the card launched, exactly; (c)
    the roofline's compute term (every FLOP at the bf16 peak, a lower
    bound) at most the trace's device busy time (planted: the FLOPs x
    1000 must exceed it); the memory term printed beside it, not gated;
    (d) for the llama cells, the counted activation peak within
    ``DRY_PEAK_BAND`` of the delta of ``max_memory_allocated`` (planted at
    the prefill: ``dry_planted_peak`` must fall outside it).  Returns
    (records, None)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import fake
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import build_state
    from repro_torch.models import gan, unet
    from repro_torch.models import transformer as tfm
    from repro_torch.train.data import TokenPipeline

    t_phase = time.perf_counter()
    gc_collect()

    def fake_of(tree):
        return tfm._map_tree(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=ha.DEVICE), tree)

    def fake_like(*tensors):
        with ha.fake_mode():
            return tuple(fake_of(t) for t in tensors)

    recs, g = [], torch.Generator().manual_seed(3)
    # ---- the DCGAN generator and discriminator (A, B) ---------------------
    gcfg = dc.replace(gan.DCGAN, backend="cuda")
    gp = gan.generator_init(1, gcfg, device=dev)
    dp = gan.discriminator_init(2, gcfg, device=dev)
    z = torch.randn((DRY_GAN_B, gcfg.z_dim), generator=g).to(dev)

    def gen_fn(p, z):
        with torch.no_grad():
            return gan.generator_apply(p, z, gcfg)

    def disc_fn(p, x):
        with torch.no_grad():
            return gan.discriminator_apply(p, x, gcfg)
    with torch.no_grad():
        img = gen_fn(gp, z)
    recs.append(dry_cell(f"DCGAN generator B={DRY_GAN_B}", gen_fn, (gp, z),
                         fake_like(gp, z), dev))
    disc_fake = fake_like(dp, img)
    recs.append(dry_cell(f"DCGAN discriminator B={DRY_GAN_B}", disc_fn,
                         (dp, img), disc_fake, dev))
    # planted: kernel B's fake branch does not report
    orig = fake.launched
    fake.launched = (lambda kernel, work: None if kernel == "B"
                     else orig(kernel, work))
    try:
        planted = ha.analyze_step(disc_fn, *disc_fake)["kernels"]
    finally:
        fake.launched = orig
    planted_b = planted.get("B", {}).get("launches", 0)
    if planted_b == recs[-1]["launches_real"]["B"]:
        recs[-1]["failed"].append("(a) planted fault not caught")
    recs[-1]["planted_b_launches"] = planted_b
    del gp, dp, z, img, disc_fake
    # ---- the 512 px U-Net forward (B, C, D) -------------------------------
    ucfg = unet.UNetConfig("unet-512", image_hw=UNET_512_HW, backend="cuda")
    up = unet.unet_init(6, ucfg, device=dev)
    xu = torch.randn((DRY_UNET_B, ucfg.image_hw, ucfg.image_hw, ucfg.in_c),
                     generator=g).to(dev)
    tu = torch.rand((DRY_UNET_B,), generator=g).to(dev)

    def unet_fn(p, x, t):
        with torch.no_grad():
            return unet.unet_apply(p, x, t, ucfg)
    recs.append(dry_cell(f"U-Net {ucfg.image_hw}px B={DRY_UNET_B}", unet_fn,
                         (up, xu, tu), fake_like(up, xu, tu), dev))
    del up, xu, tu
    gc_collect()
    # ---- llama3.2-1b: the prefill and the train step (F) ------------------
    cfg = registry.get_config("llama3.2-1b")
    params = tfm.init(cfg, seed=0, device=dev)
    b, s = DRY_PREFILL
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=g).to(dev)}
    prefill = steps_lib.make_prefill_step(cfg, None, kv_chunk=TRAIN_KV_CHUNK)
    prefill_fake = fake_like(params, batch)
    recs.append(dry_cell(f"llama3.2-1b prefill B={b} S={s}", prefill,
                         (params, batch), prefill_fake, dev,
                         measure_peak=True))
    # planted: the tracker takes a view of an input for a new storage
    r = recs[-1]
    r["planted_peak_ratio"] = (dry_planted_peak(prefill, prefill_fake)
                               / max(r["peak_activation_real"], 1))
    if DRY_PEAK_BAND[0] <= r["planted_peak_ratio"] <= DRY_PEAK_BAND[1]:
        r["failed"].append("(d) planted fault not caught")
    del params, batch, prefill_fake
    gc_collect()
    b, s = TRAIN_SHAPE
    state, opt_cfg = build_state(cfg, device=dev)
    batch = steps_lib.batch_to(TokenPipeline(cfg, b, s, seed=3).batch_at(0),
                               dev)
    step = steps_lib.make_train_step(cfg, opt_cfg, kv_chunk=TRAIN_KV_CHUNK)
    with ha.fake_mode():
        fstate, _ = build_state(cfg, params=fake_of(tfm.param_shapes(cfg)))
        fbatch = fake_of(batch)
    recs.append(dry_cell(f"llama3.2-1b train step B={b} S={s}", step,
                         (state, batch), (fstate, fbatch), dev,
                         measure_peak=True))
    del state, batch, fstate, fbatch
    gc_collect()
    failed = []
    for r in recs:
        cs, ms_ = r["compute_share"], r["memory_share"]
        print(f"[3s] {r['cell']}: counted in {r['count_s']:.2f} s on fake "
              f"tensors; launches counted {_nonzero(r['launches_counted'])}"
              f" vs the card's counters {_nonzero(r['launches_real'])}; "
              f"product FLOPs counted {r['product_flops_counted']} vs "
              f"FlopCounterMode {r['product_flops_real']}; kernel FLOPs "
              f"counted {r['kernel_flops_counted']} vs the work formulas at "
              f"the launched shapes {r['kernel_flops_real']}")
        busy = r["device_busy_s"]
        print(f"[3s] {r['cell']}: roofline compute term "
              f"{r['compute_s'] * 1e3:.4f} ms (bf16 peak), memory term "
              f"{r['memory_s'] * 1e3:.4f} ms, device busy "
              f"{ms_text(None if busy is None else busy * 1e3)}"
              f" ms: compute share {ms_text(cs, '.4f')} (x1000 planted: "
              f"{ms_text(r['compute_share_x1000'], '.1f')}), memory share "
              f"{ms_text(ms_, '.4f')} (not gated; most bytes: "
              f"{r['top_bytes_op']}) | {smi}")
        if "peak_ratio" in r:
            print(f"[3s] {r['cell']}: activation peak counted "
                  f"{r['peak_activation_counted']} bytes, card "
                  f"(max_memory_allocated delta) "
                  f"{r['peak_activation_real']} bytes: ratio "
                  f"{r['peak_ratio']:.4f}, band {DRY_PEAK_BAND}; inputs "
                  f"{r['input_bytes']} bytes; largest live at the peak "
                  f"{r['top_buffers']}")
        if "planted_peak_ratio" in r:
            print(f"[3s] {r['cell']}: planted (the tracker takes a view of "
                  f"an input for a new storage): ratio "
                  f"{r['planted_peak_ratio']:.4f}: gate (d) fails")
        if "planted_b_launches" in r:
            print(f"[3s] {r['cell']}: planted (kernel B's fake branch not "
                  f"reporting): {r['planted_b_launches']} B launches "
                  f"counted vs {r['launches_real']['B']}: gate (a) fails")
        failed += [f"{r['cell']} {f}" for f in r["failed"]]
    phase_s = time.perf_counter() - t_phase
    print(f"[3s] dry-run phase: {phase_s:.1f} s")
    if failed:
        raise RuntimeError(f"phase 3s gates failed: {failed}")
    return {"dryrun": recs, "dryrun_s": phase_s}, None


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


# ---------------------------------------------------------------------------
# 3o / 4m. the forward on a (data, model) mesh over ranks that share the card
# ---------------------------------------------------------------------------

# (a) image serving on (data=2, model=2): (model, batch, wdtype)
MESH_IMAGES = (("dcgan", 64, "float32"), ("dcgan", 1, "float32"),
               ("dcgan", 64, "int8"), ("cgan", 16, "float32"),
               ("segnet", 16, "float32"), ("segnet", 16, "int8"))
# (b) LM prefill through make_prefill_step(cfg, make_dist(mesh, cfg, shape))
# at full width: (arch, stages (None = every layer), (B, S))
MESH_LM = (("deepseek-v3-671b", ((("mla",), 1), (("mla_moe",), 1)),
            (2, 1024)),
           ("dbrx-132b", ((("moe",), 2),), (2, 1024)),
           ("llama3.2-1b", None, (2, 4096)))
MESH_WORLD = 4
MESH_MOE_SLICE = 64           # positions the no-drop MoE gate runs on
# limits (each read sound and with a planted fault; PERF.md's 3o rows
# give both readings): relative to max|ref|
TOL_MESH_IMG = 2e-4           # f32/int8 rows vs the single-rank forward
TOL_MESH_LAYER = 3e-2         # a bf16 sublayer vs the single-rank sublayer
TOL_MESH_MOE = 3e-2           # a bf16 EP layer vs its reference
TOL_MESH_LOGITS = 3e-2        # bf16 last-position logits vs single-rank


def _mesh_rel(ref, got) -> float:
    ref, got = ref.detach().double(), got.detach().double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _mesh_world_gather(t):
    """Every rank's ``t`` (same shape), in rank order, on every rank."""
    from repro_torch.core import comm
    return comm._all_gather(t.contiguous(), None)


def _mesh_reversed_gather(n):
    """Planted fault: the channel gather's parts in reversed rank order."""
    import torch

    def wrap(orig):
        def gather(x, group, dim=-1, kind="all_gather"):
            y = orig(x, group, dim, kind)
            if kind != "channel_gather":
                return y
            return torch.cat(list(reversed(torch.chunk(y, n, dim))), dim)
        return gather
    return wrap


def _mesh_unsummed(rank, planted):
    """Planted fault: rank 1 keeps its own partial of the ``planted``
    all-reduce (the collective still runs, so no rank waits)."""
    def wrap(orig):
        def reduce_from(x, group, kind="all_reduce"):
            y = orig(x, group, kind)
            return x if rank == 1 and kind == planted else y
        return reduce_from
    return wrap


def _mesh_rotated_return():
    """Planted fault: every second all-to-all (the experts' results going
    back) sends each block to the next rank's slot."""
    import torch
    import torch.distributed as tdist
    calls = [0]

    def wrap(orig):
        def a2a(x, group, kind="all_to_all"):
            calls[0] += 1
            if calls[0] % 2 == 0:
                x = torch.roll(x, x.shape[0] // tdist.get_world_size(group),
                               dims=0)
            return orig(x, group, kind)
        return a2a
    return wrap


def _mesh_images(rank, dev, cases):
    """(a): each image model served through ``DynamicImageBatcher(dist=)``
    on (2, 2): the batch over 'data', the superpacks over 'model'."""
    import numpy as np
    import torch
    from repro_torch.core import comm
    from repro_torch.core.plan import TPSuperpack, plan_conv
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gan, segnet
    from repro_torch.serving.image_batcher import (DynamicImageBatcher,
                                                   ImageRequest)
    from repro_torch.sharding import DistContext
    dist = DistContext(make_host_mesh(2, 2))
    out = []
    for i, (model, batch, wd) in enumerate(cases):
        if model == "segnet":
            cfg = dataclasses.replace(segnet.SEGNET, backend="cuda",
                                      wdtype=wd)
            init, plans = segnet.segnet_init, segnet.segnet_plans(cfg)

            def fwd(p, x, cfg=cfg, d=None):
                return segnet.segnet_apply(p, x, cfg)
            shape = (cfg.in_hw, cfg.in_hw, cfg.in_c)
        else:
            base = gan.DCGAN if model == "dcgan" else gan.CGAN
            cfg = dataclasses.replace(base, backend="cuda", wdtype=wd)
            init, plans = gan.generator_init, gan.generator_plans(cfg)

            def fwd(p, x, cfg=cfg, d=None):
                return gan.generator_apply(p, x, cfg, dist=d)
            shape = (cfg.z_dim,)
        whole = init(40 + i, cfg, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            params = init(40 + i, cfg, device=dev, dist=dist)
        rows = np.random.RandomState(50 + i).randn(batch, *shape) \
            .astype(np.float32)

        def serve():
            b = DynamicImageBatcher(lambda x: fwd(params, x, d=dist),
                                    dist=dist, device=dev)
            done = b.run([ImageRequest(rid=j, payload=rows[j])
                          for j in range(batch)])
            return torch.from_numpy(np.stack(
                [r.out for r in sorted(done, key=lambda r: r.rid)])), b
        zero_counts()
        comm.traffic_reset()
        got, b = serve()
        counts, other = read_counts(wd)
        traffic = comm.traffic()
        with torch.no_grad():
            ref = fwd(whole, torch.from_numpy(rows).to(dev)).cpu()
        undo = _pp_patch(comm, "gather_from", _mesh_reversed_gather(2))
        try:
            bad, _ = serve()
        finally:
            undo()
        bucket = b.bucket_for(batch)
        b_local = bucket // 2 if bucket % 2 == 0 else bucket
        sites = []
        for j, plan in enumerate(plans):
            key = (f"w{j}" if model == "segnet" else f"dc{j}")
            leaf = params[key]
            if isinstance(leaf, TPSuperpack):
                local = plan_conv(dataclasses.replace(
                    plan.spec, out_c=plan.spec.out_c // leaf.n))
                route = local.route_for_batch(b_local)
                sites.append((key, local.spec.out_c, route.path,
                              _pp_kernel(local.spec, route)))
            else:
                route = plan.route_for_batch(b_local)
                sites.append((key, plan.spec.out_c, route.path + " (whole)",
                              _pp_kernel(plan.spec, route)))
        out.append({"model": model, "batch": batch, "wdtype": wd,
                    "rank": rank, "sound": _mesh_rel(ref, got),
                    "planted": _mesh_rel(ref, bad), "launches": counts,
                    "other_dtype_launches": other, "sites": sites,
                    "graphed": b.graphed, "traffic": traffic})
        del whole, params
    return out


def _mesh_capture(records):
    """The sublayers the transformer calls (attention, GLU, MoE) swapped
    for wrappers that keep each call's input and output."""
    from repro_torch.layers import attention, mlp, moe
    undos = []
    for mod, name in ((attention, "gqa_apply"), (attention, "mla_apply"),
                      (mlp, "glu_apply"), (moe, "moe_apply")):
        def wrap(orig, name=name):
            def f(p, x, *args, **kw):
                y = orig(p, x, *args, **kw)
                records.append((name, x, args, kw, y))
                return y
            return f
        undos.append(_pp_patch(mod, name, wrap))
    return undos


def _mesh_ep_ref(p, x, cfg, n_blocks):
    """JAX's EP semantics written out plainly, sharing no code with the
    port's EP functions: the (B, S) tokens padded to a multiple of
    ``n_blocks`` and cut into that many blocks in rank order (the
    all-to-all path's token split; one block is the psum path's, a data
    rank's rows), each block routed on its own with the capacity of its
    token count, every expert on its top-``cap`` tokens by gate (ties to
    the lower index, gate > 0) in JAX's ``_expert_ffn`` arithmetic, the
    gated outputs summed in f32 in expert order and cast once."""
    import torch
    from repro_torch.layers import common as cm
    from repro_torch.layers import moe
    b, s, d = x.shape
    t = b * s
    padded = -(-t // n_blocks) * n_blocks
    x2 = torch.nn.functional.pad(x.reshape(t, d), (0, 0, 0, padded - t))
    t_l = padded // n_blocks
    cap = moe._capacity(t_l, cfg)
    out = torch.zeros((padded, d), dtype=torch.float32, device=x.device)
    for j in range(n_blocks):
        xb = x2[j * t_l:(j + 1) * t_l]
        w, idx = moe._route(xb, p, cfg)
        rows = torch.arange(j * t_l, (j + 1) * t_l, device=x.device)
        w = torch.where(rows[:, None] < t, w, 0.0)
        for e in range(cfg.n_experts):
            gate = torch.where(idx == e, w, 0.0).sum(-1)
            tok = torch.sort(gate, descending=True, stable=True).indices[:cap]
            tok = tok[gate[tok] > 0]
            xe = xb[tok]
            h = cm.ACTS[cfg.act]((xe @ p["wg"][e]).float()) \
                * (xe @ p["wi"][e]).float()
            ye = (h.to(x.dtype) @ p["wo"][e]).float() * gate[tok, None]
            out.index_add_(0, j * t_l + tok, ye)
    return out[:t].to(x.dtype).reshape(b, s, d)


def _mesh_lm(rank, dev, case, psum_case):
    """``_mesh_lm_run``, then the card's cache emptied: the run's locals
    (the whole model on rank 0, every rank's blocks, the kept sublayer
    inputs) are gone once it returns."""
    import gc

    import torch
    rec = _mesh_lm_run(rank, dev, case, psum_case)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _mesh_lm_run(rank, dev, case, psum_case):
    """(b) one architecture: the sharded prefill with every sublayer's
    input and output kept, F's calls against its plain version, the
    sublayers against the single-rank ones on rank 0 (which holds the
    whole model), the MoE layers against their references, the logits
    against the single-rank prefill, the planted faults; then 4m."""
    import gc

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist, make_prefill_step
    from repro_torch.layers import attention, mlp, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    arch, stages, (b, s) = case
    full = registry.get_config(arch)
    cfg = full if stages is None else dataclasses.replace(
        full, stages=stages, num_layers=sum(len(k) * r for k, r in stages))
    dist = make_dist(make_host_mesh(2, 2), cfg,
                     ShapeConfig("prefill", "prefill", s, b))
    gc.collect()
    torch.cuda.empty_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if rank == 0:
            whole = tfm.init(cfg, seed=0, device=dev)
            # the rank's blocks cut from the whole tree: the expert and
            # vocab blocks are views of it, so rank 0 holds the model once
            params = dist.shard_params(whole, tfm.specs(cfg))
        else:
            whole = None
            params = tfm.init(cfg, seed=0, device=dev, dist=dist)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()          # the draws' f32 temporaries
    local_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(params))
    whole_bytes = (sum(t.numel() * t.element_size()
                       for t in _tensors(whole)) if whole is not None
                   else None)
    g = torch.Generator().manual_seed(60)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=g).to(dev)}
    prefill = make_prefill_step(cfg, dist)
    rec = {"arch": arch, "rank": rank, "layers": cfg.num_layers,
           "kinds": tfm.layer_kinds(cfg), "rules": {
               k: dist.rules[k] for k in ("batch", "heads", "ffn", "vocab",
                                          "expert", "expert_ffn")},
           "local_bytes": local_bytes, "whole_bytes": whole_bytes}
    # ---- the sound run: F's calls and every sublayer kept ----------------
    calls, subs = [], []
    undos = _mesh_capture(subs)
    try:
        with captured_attention(calls):
            fa.flash_attention.launches = 0
            logits = prefill(params, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec["f_launches"] = fa.flash_attention.launches
    finally:
        for u in reversed(undos):
            u()
    rec["f_gate"] = check_f_layers(f"{arch} on the mesh, rank {rank}",
                                   calls, F_FAULT)
    rec["f_heads"] = sorted({tuple(c[0].shape[2:]) for c in calls})
    del calls
    # ---- the sublayers against the single-rank ones (rank 0) -------------
    layer_errs = {"attention": 0.0, "glu": 0.0}
    moe_subs = [r for r in subs if r[0] == "moe_apply"]
    attn_subs = [r for r in subs if r[0] in ("gqa_apply", "mla_apply")]
    glu_subs = [r for r in subs if r[0] == "glu_apply"]
    if rank == 0:
        with torch.no_grad():
            for i, (name, x, args, kw, y) in enumerate(attn_subs):
                kw = dict(kw, dist=None)
                fn = getattr(attention, name)
                ref = fn(whole["layers"][i]["attn"], x, *args, **kw)
                layer_errs["attention"] = max(layer_errs["attention"],
                                              _mesh_rel(ref, y))
            glu_layers = [(i, k) for i, lp in enumerate(whole["layers"])
                          for k in ("mlp", "shared") if k in lp]
            for (i, k), (name, x, args, kw, y) in zip(glu_layers, glu_subs):
                ref = mlp.glu_apply(whole["layers"][i][k], x, args[0])
                layer_errs["glu"] = max(layer_errs["glu"], _mesh_rel(ref, y))
    rec["layer_rel"] = layer_errs
    # ---- the MoE layers ---------------------------------------------------
    moe_layers = [i for i, k in enumerate(tfm.layer_kinds(cfg))
                  if k in tfm.MOE_KINDS]
    n_ep = dist.extent(dist.rules["expert"])
    rec["moe"] = []
    moe_inputs = []
    for i, (name, x, args, kw, y) in zip(moe_layers, moe_subs):
        xs = _mesh_world_gather(x)
        if rank == 0:
            moe_inputs.append(torch.cat([xs[0], xs[2]]))
        ys = _mesh_world_gather(y)
        pm = params["layers"][i]["moe"]
        nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                     / cfg.top_k)
        xsl = x[:, :MESH_MOE_SLICE].contiguous()
        with torch.no_grad():
            y_nd = moe.moe_apply(pm, xsl, nodrop, dist)
            undo = _pp_patch(comm, "all_to_all_fn", _mesh_rotated_return())
            try:
                y_bad = moe.moe_apply(pm, x, cfg, dist)
            finally:
                undo()
        ys_bad = _mesh_world_gather(y_bad)
        m = {"layer": i, "path": "a2a" if isinstance(
            dist.rules["expert"], tuple) else "psum", "n_ep": n_ep}
        if rank == 0:
            with torch.no_grad():
                wm = whole["layers"][i]["moe"]
                m["nodrop_rel"] = _mesh_rel(moe.moe_apply(wm, xsl, cfg),
                                            y_nd)
                # the global batch: data rank 0's rows (rank 0), then data
                # rank 1's (rank 2)
                xg = torch.cat([xs[0], xs[2]])
                sim = _mesh_ep_ref(wm, xg, cfg, n_ep)
                rows = [sim[:b // 2], sim[:b // 2], sim[b // 2:],
                        sim[b // 2:]]
                m["ep_rel"] = max(_mesh_rel(r, yy) for r, yy in
                                  zip(rows, ys))
                m["planted_rel"] = min(_mesh_rel(r, yy) for r, yy in
                                       zip(rows, ys_bad))
                t_l = -(-b * s // n_ep)
                m["capacity"] = min(t_l, max(1, int(
                    t_l * cfg.top_k * cfg.capacity_factor)
                    // cfg.n_experts))
                m["tokens_a_rank"] = t_l
        rec["moe"].append(m)
        del xs, ys, ys_bad
    # ---- the psum path: one MoE layer under DEFAULT_RULES ----------------
    if psum_case and moe_subs:
        pdist = DistContext(dist.mesh, rules=dict(DEFAULT_RULES,
                                                  batch="data"))
        x = moe_subs[0][1]
        j, n = pdist.shard_of(pdist.rules["expert"], cfg.n_experts)
        keep = (j * cfg.n_experts // n, (j + 1) * cfg.n_experts // n)
        pp = moe.moe_init(torch.Generator(device=dev).manual_seed(7), cfg,
                          keep=keep)
        with torch.no_grad():
            y = moe.moe_apply(pp, x, cfg, pdist)
            undo = _pp_patch(comm, "reduce_from",
                             _mesh_unsummed(rank, "ep_psum"))
            try:
                y_bad = moe.moe_apply(pp, x, cfg, pdist)
            finally:
                undo()
        del pp
        xs = _mesh_world_gather(x)
        ys, ys_bad = _mesh_world_gather(y), _mesh_world_gather(y_bad)
        psum = {"experts_a_rank": keep[1] - keep[0]}
        if rank == 0:
            pw = moe.moe_init(torch.Generator(device=dev).manual_seed(7),
                              cfg)
            with torch.no_grad():
                sims = [_mesh_ep_ref(pw, xs[2 * d], cfg, 1)
                        for d in range(2)]
            del pw
            rows = [sims[r // 2] for r in range(MESH_WORLD)]
            psum["rel"] = max(_mesh_rel(r, yy) for r, yy in zip(rows, ys))
            psum["planted_rank1"] = _mesh_rel(rows[1], ys_bad[1])
            psum["planted_others"] = max(
                _mesh_rel(rows[r], ys_bad[r]) for r in (0, 2, 3))
        rec["psum"] = psum
        del xs, ys, ys_bad
    del subs, moe_subs, attn_subs, glu_subs
    # ---- the logits against the single-rank prefill ----------------------
    undo = _pp_patch(comm, "reduce_from",
                     _mesh_unsummed(rank, "row_parallel_all_reduce"))
    try:
        bad_logits = prefill(params, batch)
    finally:
        undo()
    if rank == 0:
        # the single-rank prefill with JAX's all-to-all EP semantics at each
        # MoE layer (the capacity drop over the whole batch's tokens), each
        # MoE layer routed on the mesh run's input there (the same routes and
        # capacity cuts as the mesh's: the gate) and on its own (a reading:
        # a last-bit difference moves tokens across the capacity cut)
        def reference(inputs):
            seen = []

            def sim(orig):
                def f(p, x, cfg_, dist_=None):
                    src = x if inputs is None else inputs[len(seen)]
                    seen.append(x)
                    return _mesh_ep_ref(p, src, cfg_, n_ep)
                return f
            undo = (_pp_patch(moe, "moe_apply", sim)
                    if moe_layers and isinstance(dist.rules["expert"], tuple)
                    else (lambda: None))
            try:
                with torch.no_grad():
                    return make_prefill_step(cfg)(whole, batch), seen
            finally:
                undo()
        ref_logits, _ = reference(moe_inputs)
        rec["logits_rel"] = _mesh_rel(ref_logits, logits)
        rec["logits_planted_rel"] = _mesh_rel(ref_logits, bad_logits)
        rec["argmax_equal"] = bool(torch.equal(ref_logits.argmax(-1),
                                               logits.argmax(-1)))
        if moe_layers:
            self_logits, ref_in = reference(None)
            rec["logits_self_routed_rel"] = _mesh_rel(self_logits, logits)
            # tokens whose expert set differs between the self-routed run's
            # MoE inputs and the mesh run's, layer by layer
            with torch.no_grad():
                rec["routing_flips"] = [int((
                    moe._route(a.reshape(-1, a.shape[-1]), whole["layers"][
                        i]["moe"], cfg)[1].sort(-1).values
                    != moe._route(g.reshape(-1, g.shape[-1]), whole[
                        "layers"][i]["moe"], cfg)[1].sort(-1).values)
                    .any(-1).sum())
                    for i, a, g in zip(moe_layers, ref_in, moe_inputs)]
            del self_logits, ref_in
    # ---- 4m: times, bytes, memory ----------------------------------------
    rec["ms"] = _pp_ms(lambda: prefill(params, batch), dev, iters=2)
    rec["device_ms"] = _pp_device_ms(lambda: prefill(params, batch), dev)
    comm.traffic_reset()
    with comm.timed(True):
        peak, base = _pp_peak(lambda: prefill(params, batch), dev)
    rec["collectives"] = comm.traffic()
    rec["peak_bytes"], rec["base_bytes"] = peak, base
    if rank == 0:
        rec["single_ms"] = _pp_ms(lambda: make_prefill_step(cfg)(
            whole, batch), dev, iters=2)
        rec["single_device_ms"] = _pp_device_ms(
            lambda: make_prefill_step(cfg)(whole, batch), dev)
    return rec


def _mesh_rank(rank, world, dev, conf):
    """One rank of phases 3o/4m (all ranks share the card)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = {"images": _mesh_images(rank, dev, conf["images"])}
    out["lm"] = [_mesh_lm(rank, dev, case, psum_case=case[0] == "dbrx-132b")
                 for case in conf["lm"]]
    return out


def mesh_phases(dev, smi):
    """Phases 3o and 4m: the forward on a (data=2, model=2) mesh over
    ``MESH_WORLD`` ranks that share the card on a gloo group (CUDA tensors
    staged through host memory).  (a) the DCGAN generator (B = 64 and 1),
    the cGAN and SegNet, f32 and int8, served through
    ``DynamicImageBatcher(dist=)``: every row against the single-rank
    'cuda' forward on the same weights, each rank's local route and kernel
    at each site, the A/B/E launches, a reversed channel gather read
    through the same gate.  (b) llama3.2-1b, dbrx-132b and
    deepseek-v3-671b at full width through ``make_prefill_step(cfg,
    make_dist(mesh, cfg, shape))``: F on each rank's local heads against
    its plain version, every attention and GLU sublayer against the
    single-rank one on the same input, every MoE layer without a drop
    against the one-card ``moe_apply`` and at the config's capacity
    against JAX's EP semantics written out plainly in one process
    (``_mesh_ep_ref``), dbrx's first MoE layer on the psum path under
    ``DEFAULT_RULES``, the last position's logits against the single-rank
    prefill whose MoE layers take the mesh run's inputs (and, as a
    reading, against the one routed on its own); planted: one rank skips the
    row-parallel all-reduce, the all-to-all's return goes to the rotated
    rank, the psum is left unsummed on rank 1.  4m: per rank the
    forward's ms and device ms beside the single-rank forward's, the
    weight bytes held, every collective kind's calls, bytes and ms, and
    the peak memory.  Returns (records, {kernel: {path: launches}})."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_spmd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the ranks' allocators grow segments in place: rank 0 holds the whole
    # deepseek slice (27.5 GB) beside three ranks' blocks on one card
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = run_spmd(_mesh_rank, MESH_WORLD,
                         {"images": MESH_IMAGES, "lm": MESH_LM},
                         device=dev.type, timeout=900)
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    wall = time.perf_counter() - t0
    paths = {k: {} for k in ("A", "B", "A_int8", "B_int8", "F")}
    failed = []
    # ---- (a) ----------------------------------------------------------------
    for i, (model, batch, wd) in enumerate(MESH_IMAGES):
        tag = f"mesh_{model}_B{batch}" + ("_int8" if wd == "int8" else "")
        for r in ranks:
            rec = r["images"][i]
            kern = "B" if model == "segnet" else "A"
            key = kern + ("_int8" if wd == "int8" else "")
            n = rec["launches"][kern]
            paths[key][tag] = paths[key].get(tag, 0) + n
            print(f"[3o] {tag} rank {rec['rank']}: sites (site, local N, "
                  f"route, kernel) {rec['sites']}; launches {rec['launches']}"
                  f" (other dtype {rec['other_dtype_launches']}), graphed "
                  f"{rec['graphed']}; vs the single-rank 'cuda' forward, "
                  f"limit {TOL_MESH_IMG:.0e}: sound {rec['sound']:.2e}, "
                  f"reversed channel gather {rec['planted']:.2e}")
            if not (rec["sound"] <= TOL_MESH_IMG < rec["planted"]) \
                    or (dev.type == "cuda" and (n == 0 or
                                                rec["other_dtype_launches"])):
                failed.append(f"{tag} rank {rec['rank']}")
        tr = ranks[0]["images"][i]["traffic"]
        print(f"[4m] {tag} rank 0 collectives a serve: "
              f"{json.dumps(tr)} | {smi}")
    # ---- (b) and 4m ---------------------------------------------------------
    for j, (arch, _, (b, s)) in enumerate(MESH_LM):
        recs = [r["lm"][j] for r in ranks]
        r0 = recs[0]
        paths["F"][f"mesh_{arch}"] = sum(r["f_launches"] for r in recs)
        n_attn = sum(k in ("attn", "local", "global", "moe", "mla",
                           "mla_moe") for k in r0["kinds"])
        print(f"[3o] {arch} B={b} S={s}, {r0['layers']} layers "
              f"{r0['kinds']}, rules {r0['rules']}")
        for rec in recs:
            fg = rec["f_gate"]
            print(f"[3o] {arch} rank {rec['rank']}: F launches "
                  f"{rec['f_launches']} (heads, head dim) {rec['f_heads']}, "
                  f"F vs plain worst share {fg['worst_share']:.3f} (planted "
                  f"x{fg['planted_fault']}: least "
                  f"{fg['planted_least_share']:.2f})"
                  f"; weights {rec['local_bytes']} bytes")
            if dev.type == "cuda" and rec["f_launches"] != n_attn:
                failed.append(f"{arch} rank {rec['rank']}: F launches")
        le = r0["layer_rel"]
        print(f"[3o] {arch} sublayers vs single-rank on the same input, "
              f"limit {TOL_MESH_LAYER:.0e}: attention {le['attention']:.2e},"
              f" GLU {le['glu']:.2e}")
        if max(le.values()) > TOL_MESH_LAYER:
            failed.append(f"{arch} sublayers")
        for m in r0["moe"]:
            print(f"[3o] {arch} MoE layer {m['layer']} ({m['path']}, "
                  f"{m['n_ep']} expert ranks, {m['tokens_a_rank']} tokens and "
                  f"capacity {m['capacity']} a rank), limit "
                  f"{TOL_MESH_MOE:.0e}: no drop vs one-card moe_apply "
                  f"{m['nodrop_rel']:.2e}; vs JAX's EP semantics written out "
                  f"{m['ep_rel']:.2e}, return to the rotated rank "
                  f"{m['planted_rel']:.2e}")
            if not (max(m["nodrop_rel"], m["ep_rel"]) <= TOL_MESH_MOE
                    < m["planted_rel"]):
                failed.append(f"{arch} MoE layer {m['layer']}")
        if "psum" in r0:
            ps = r0["psum"]
            print(f"[3o] {arch} psum path ({ps['experts_a_rank']} experts a "
                  f"rank) vs JAX's psum EP written out, limit "
                  f"{TOL_MESH_MOE:.0e}: {ps['rel']:.2e}; unsummed on rank 1:"
                  f" rank 1 {ps['planted_rank1']:.2e}, others "
                  f"{ps['planted_others']:.2e}")
            if not (ps["rel"] <= TOL_MESH_MOE < ps["planted_rank1"]):
                failed.append(f"{arch} psum path")
        routed = (" (MoE layers routed on the mesh run's inputs)"
                  if "routing_flips" in r0 else "")
        print(f"[3o] {arch} last-position logits vs the single-rank prefill"
              f"{routed}, limit {TOL_MESH_LOGITS:.0e}: sound "
              f"{r0['logits_rel']:.2e} (argmax equal: {r0['argmax_equal']})"
              f", rank 1 skips the row-parallel all-reduce "
              f"{r0['logits_planted_rel']:.2e}")
        if "routing_flips" in r0:
            print(f"[3o] {arch} logits vs the single-rank prefill routed on "
                  f"its own MoE inputs (a reading, not gated): "
                  f"{r0['logits_self_routed_rel']:.2e}; tokens routed to "
                  f"another expert set, a MoE layer, of {b * s}: "
                  f"{r0['routing_flips']}")
        if not (r0["logits_rel"] <= TOL_MESH_LOGITS
                < r0["logits_planted_rel"]):
            failed.append(f"{arch} logits")
        for rec in recs:
            single = (f", single-rank {r0['single_ms']:.3f} ms, device "
                      f"{ms_text(r0['single_device_ms'])} ms"
                      if rec["rank"] == 0 else "")
            print(f"[4m] {arch} rank {rec['rank']}: forward {rec['ms']:.3f} "
                  f"ms (events), device {ms_text(rec['device_ms'])} ms"
                  f"{single}; weights {rec['local_bytes']} bytes = "
                  f"{rec['local_bytes'] / r0['whole_bytes']:.3f} of the "
                  f"single-rank model's {r0['whole_bytes']}; peak "
                  f"{rec['peak_bytes']} bytes ({rec['base_bytes']} before) "
                  f"| {smi}")
            print(f"[4m] {arch} rank {rec['rank']} collectives a forward "
                  f"(calls, bytes, host ms with the device synchronised): "
                  + ", ".join(f"{k} {v['calls']} / {v['bytes']} / "
                              f"{v['seconds'] * 1e3:.2f}"
                              for k, v in rec["collectives"].items()))
    # ---- phase 3s (e): rank 0's collectives counted on a fake world --------
    j = [c[0] for c in MESH_LM].index("llama3.2-1b")
    arch, stages, (b, s) = MESH_LM[j]
    real = {k: (v["calls"], v["bytes"])
            for k, v in ranks[0]["lm"][j]["collectives"].items()}
    counted = mesh_prefill_count(arch, stages, b, s)
    print(f"[3s] (e) {arch} (2, 2) prefill B={b} S={s}, rank 0: collectives "
          f"(calls, bytes) counted on a fake world of {MESH_WORLD} "
          f"{json.dumps(counted)}; the card's rank 0 {json.dumps(real)}")
    if counted != real:
        failed.append(f"{arch} collectives counted on a fake world")
    print(f"[3o] mesh phase: {wall:.1f} s over {MESH_WORLD} ranks, launches "
          f"{json.dumps(paths)}")
    if failed:
        raise RuntimeError(f"mesh gates failed: {failed}")
    return {"mesh": {"images": [r["images"] for r in ranks],
                     "lm": [r["lm"] for r in ranks], "seconds": wall,
                     "collectives_counted": counted}}, paths


def mesh_prefill_count(arch, stages, b, s) -> dict:
    """Phase 3s (e): {kind: (calls, bytes)} of rank 0's ``comm.traffic()``
    in phase 3o (b)'s prefill of ``arch`` on (data 2, model 2), counted on
    fake tensors in a fake world of ``MESH_WORLD`` ranks in this process
    (``launch.hlo_analysis``)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch.mesh import make_host_mesh, one_rank_world_end
    from repro_torch.launch.steps import make_dist, make_prefill_step
    from repro_torch.models import transformer as tfm
    full = registry.get_config(arch)
    cfg = full if stages is None else dataclasses.replace(
        full, stages=stages, num_layers=sum(len(k) * r for k, r in stages))
    one_rank_world_end()
    with ha.fake_world(MESH_WORLD, rank=0):
        dist = make_dist(make_host_mesh(2, 2), cfg,
                         ShapeConfig("prefill", "prefill", s, b))
        with ha.fake_mode(), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            params = dist.shard_params(tfm._map_tree(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device=ha.DEVICE),
                tfm.param_shapes(cfg)), tfm.specs(cfg))
            batch = {"inputs": torch.empty((b, s), dtype=torch.int64,
                                           device=ha.DEVICE)}
        r = ha.analyze_step(make_prefill_step(cfg, dist), params, batch,
                            default_group=MESH_WORLD)
    return {k: (v["calls"], v["bytes"]) for k, v in r["collectives"].items()}


# ---------------------------------------------------------------------------
# 3p / 4n. LM training on a (data, model) mesh over ranks that share the card
# ---------------------------------------------------------------------------

# (a) llama3.2-1b at full width and depth, (B, S): train_4k's sequence, one
# row a rank; steps of make_train_step(..., dist=)
MT_LLAMA = (2, 4096)
MT_STEPS = 3
MT_KV_CHUNK = 1024
# AdamW with ZeRO-1; eps 1e-3 keeps the first step's update proportional to
# the gradient (at 1e-8 it is lr·sign(g), whose signs a last-bit difference
# flips where g is tiny), as the CPU tests hold it
MT_ADAMW = dict(name="adamw", lr=3e-4, eps=1e-3)
# (b) dbrx-132b at full width on the all-to-all EP path, (layers, (B, S));
# one layer: the one-rank Adafactor reference of two (15.5 GB of weights,
# their bf16 gradients and all of them clipped in f32) does not fit the card
MT_DBRX = (1, (2, 1024))
# (c) train() at llama3.2-1b cut to (layers, steps, B, S, ckpt every,
# fail at)
MT_RESUME = (1, 3, 2, 256, 2, 2)
MT_WORLD = 4
MT_CONFIGS = "full"           # "reduced": the CPU rehearsal's configs
# limits (each read sound and with a planted fault; PERF.md's 3p rows give
# both): relative to the one-rank step's value
TOL_MT_LOSS = 2e-3            # the loss (bf16 forward in another order)
TOL_MT_GNORM = 2e-2           # the global norm
TOL_MT_UPDATE = 1e-1          # a leaf's first-step update (AdamW) or second
                              # moment (Adafactor), L2 over the whole leaf


def _mt_cfg(conf, which):
    """(a), (b) or (c)'s config: full width, the depth ``conf`` says."""
    from repro_torch.configs import registry
    get = (registry.get_reduced if conf["configs"] == "reduced"
           else registry.get_config)
    if which == "llama":
        return get("llama3.2-1b")
    if which == "resume":
        return cut_depth(get("llama3.2-1b"), conf["resume"][0])
    cfg = get("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe_impl="ep", capacity_factor=(
        cfg.n_experts / cfg.top_k))
    return cut_depth(cfg, conf["dbrx"][0])


def _mt_state(cfg, dev, opt_kw, dist=None):
    """Seeded params (seed 0; each rank's blocks of the same draws on a
    mesh) and a fresh optimiser state of ``opt_kw``."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    params = tfm.init(cfg, seed=0, device=dev, dist=dist)
    ocfg = optim.OptConfig(**opt_kw)
    init, _ = optim.OPTIMIZERS[ocfg.name]
    kw = ({} if dist is None else dict(specs=tfm.specs(cfg), dist=dist,
                                        shapes=tfm.param_shapes(cfg)))
    opt = init(params, ocfg, stacks=tfm.param_stacks(cfg, params), **kw)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}, ocfg


def _mt_batch(cfg, b, s, dev):
    from repro_torch.launch.steps import batch_to
    from repro_torch.train.data import TokenPipeline
    return batch_to(TokenPipeline(cfg, b, s, seed=3).batch_at(0), dev)


def _mt_reference(dev, conf, tmp):
    """The one-rank references, run here before the ranks spawn: (a)'s
    ``MT_STEPS`` steps (losses, gnorms) and its first step's new params;
    (b)'s step; (c)'s ``train()``.  New params go to ``tmp`` (each rank
    reads its blocks), the card is freed."""
    import gc

    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import train
    ref = {}
    for which, opt_kw, (b, s), n in (
            ("llama", MT_ADAMW, conf["llama"], conf["steps"]),
            ("dbrx", None, conf["dbrx"][1], 1)):
        cfg = _mt_cfg(conf, which)
        if opt_kw is None:
            opt_kw = dataclasses.asdict(steps_lib.opt_config_for(cfg))
        state, ocfg = _mt_state(cfg, dev, opt_kw)
        batch = _mt_batch(cfg, b, s, dev)
        step = steps_lib.make_train_step(cfg, ocfg, kv_chunk=conf["kv_chunk"])
        losses, gnorms = [], []
        t0 = time.perf_counter()
        for i in range(n):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            if i == 0:
                path = os.path.join(tmp, f"{which}.pt")
                # bf16 on disk: 2.5 GB at llama, a 2^-9 rounding
                torch.save({k: t.to(torch.bfloat16).cpu() for k, t in
                            _mt_gated(state["opt"], ocfg).items()}, path)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if dev.type == "cuda" else None)
        ref[which] = {"losses": losses, "gnorms": gnorms, "path": path,
                      "opt": opt_kw, "seconds": time.perf_counter() - t0,
                      "peak_gib": peak}
        del state, batch, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    layers, steps, tb, ts, every, fail = conf["resume"]
    losses, final = train("llama3.2-1b", cfg=_mt_cfg(conf, "resume"),
                          steps=steps, batch=tb, seq=ts, log_every=100,
                          device=dev)
    # the mesh run replays from its last checkpoint before the failure
    ref["resume"] = {"losses": losses[:fail] + losses[fail // every * every:],
                     "final": final}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def _mt_skip(kinds, ranks):
    """Planted fault: the ranks in ``ranks`` leave the collectives of
    ``kinds`` unreduced (the collective still runs, so no rank waits)."""
    import torch.distributed as tdist
    from repro_torch.core import comm
    orig = comm.all_reduce

    def all_reduce(t, group, kind="all_reduce", op="sum"):
        y = orig(t, group, kind, op)
        return t if kind in kinds and tdist.get_rank() in ranks else y
    comm.all_reduce = all_reduce
    return lambda: setattr(comm, "all_reduce", orig)


def _mt_gated(opt, ocfg) -> dict:
    """What the gates read of a step's optimiser state, by leaf path:
    AdamW's first-step update m^/(sqrt(v^) + eps) before the learning
    rate, the weight decay and the bf16 rounding of the params (the
    rounded update new - old is 0 or one bf16 step for most elements at
    lr 3e-4: ill-posed); Adafactor's second moments (vr, vc or v)."""
    import torch
    from repro_torch.train.tree import tree_paths
    if ocfg.name == "adamw":
        bc1, bc2 = 1.0 - ocfg.b1, 1.0 - ocfg.b2
        return {k: (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
                for (k, m), (_, v) in zip(tree_paths(opt["m"]),
                                          tree_paths(opt["v"]))}
    return dict(tree_paths(opt["f"]))


def _mt_split_axes(dist, pl) -> tuple:
    """The mesh axes that split a placement's leaf (the stack dim's where
    a rank holds whole layers of a stack), in mesh order."""
    from repro_torch.sharding import _axes
    spec, shape = pl._leaf()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    entries = [e for e, n in zip(spec, shape) if dist.shard_of(e, n)[1] > 1]
    if pl._owner() is not None:
        entries.append(pl.spec[0])
    axes = {a for e in entries for a in _axes(e) if dist.extent(a) > 1}
    return tuple(a for a in dist.mesh.mesh_dim_names if a in axes)


def _mt_state_errors(dist, pls, opt, ocfg, ref_path, dev):
    """``_mt_gated`` of a rank's optimiser state against the one-rank
    step's, rel L2 over each whole leaf: each rank's part sums, summed
    over the axes that split the leaf (replicated: counted once)."""
    import torch
    from repro_torch.core import comm
    from repro_torch.train.checkpoint import _placement_leaves
    ref = torch.load(ref_path, mmap=True)
    got = _mt_gated(opt, ocfg)
    sub = pls["m"] if ocfg.name == "adamw" else pls["f"]
    keyed: dict = {}
    for (key, g), pl in zip(got.items(), _placement_leaves(sub)):
        r = pl.block(ref[key]).to(dev).float()
        g = g.to(dev).float()
        sums = torch.stack([torch.sum((g - r) ** 2), torch.sum(r ** 2)])
        keyed.setdefault(_mt_split_axes(dist, pl), []).append((key, sums))
    out = {}
    for axes in sorted(keyed):
        vals = comm.all_reduce(torch.stack([s for _, s in keyed[axes]]),
                               dist.group(axes), kind="gate_all_reduce")
        for (key, _), (a, b) in zip(keyed[axes], vals.tolist()):
            out[key] = (a / max(b, 1e-60)) ** 0.5
    return out


def _mt_collectives(rec):
    return {k: v for k, v in rec.items()}


def _mt_llama(rank, dev, conf, ref):
    """(a): ``MT_STEPS`` steps on (2, 2), gated against the one-rank steps;
    the planted faults; 4n's times, memory, state bytes, collectives."""
    import gc

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    from repro_torch.train.tree import tree_leaves
    cfg = _mt_cfg(conf, "llama")
    b, s = conf["llama"]
    dist = steps_lib.make_dist(make_host_mesh(2, 2), cfg,
                               ShapeConfig("train", "train", s, b))
    state0, ocfg = _mt_state(cfg, dev, MT_ADAMW, dist)
    _, pls, _ = steps_lib.train_state_specs(cfg, dist, ocfg)
    batch = _mt_batch(cfg, b, s, dev)
    step = steps_lib.make_train_step(cfg, ocfg, kv_chunk=conf["kv_chunk"],
                                     dist=dist)
    n_whole = sum(t.numel() for t in tree_leaves(tfm.param_shapes(cfg)))
    rec = {"rank": rank, "rules": {k: dist.rules[k] for k in (
        "batch", "heads", "vocab")}, "f_launches": [], "losses": [],
        "gnorms": [], "opt_bytes": sum(
            t.numel() * t.element_size() for k in ("m", "v")
            for t in tree_leaves(state0["opt"][k])),
        "opt_bytes_whole": 2 * 4 * n_whole}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["base_bytes"] = torch.cuda.memory_allocated()
    state = state0
    for i in range(conf["steps"]):
        fa.flash_attention.launches = 0
        comm.traffic_reset()
        if i == 1 and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            new, m = step(state, batch)
            end.record()
            end.synchronize()
            rec["ms"] = start.elapsed_time(end)
        elif i == 2:
            with comm.timed(True):
                out = {}

                def run():
                    out["r"] = step(state, batch)
                rec["device_ms"] = _pp_device_ms(run, dev)
                if "r" not in out:
                    run()
            new, m = out["r"]
            rec["collectives"] = comm.traffic()
        else:
            t0 = time.perf_counter()
            new, m = step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec.setdefault("ms", (time.perf_counter() - t0) * 1e3)
        rec["f_launches"].append(fa.flash_attention.launches)
        rec["losses"].append(float(m["loss"]))
        rec["gnorms"].append(float(m["gnorm"]))
        if i == 0:
            rec["update_rel"] = _mt_state_errors(dist, pls["opt"],
                                                 new["opt"], ocfg,
                                                 ref["path"], dev)
        if state is not state0:
            del state
        state = new
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, new
    gc.collect()
    # ---- planted faults, from the first step's state -------------------
    undo = _mt_skip(("lse_all_reduce",), range(MT_WORLD))
    try:
        with torch.no_grad():
            rec["planted_lse_loss"] = float(tfm.loss_fn(
                state0["params"], batch, cfg, dist,
                kv_chunk=conf["kv_chunk"]))
    finally:
        undo()
    loss, g = steps_lib.loss_and_grads(cfg, state0["params"], batch,
                                       kv_chunk=conf["kv_chunk"], dist=dist,
                                       reduce=False)
    specs = steps_lib._leaf_specs(cfg, dist)
    stacks = tfm.param_stacks(cfg, state0["params"])
    groups = optim.mesh_groups(state0["params"], ocfg, stacks,
                               tfm.specs(cfg), dist, tfm.param_shapes(cfg))
    sound = steps_lib.sum_over_batch(tree_leaves(g), specs, dist)
    undo = _mt_skip(("norm_all_reduce",), range(MT_WORLD))
    try:
        rec["planted_norm_gnorm"] = float(optim.global_norm_mesh(
            sound, groups, dist))
    finally:
        undo()
    del sound
    undo = _mt_skip(("grad_all_reduce",), (1,))
    try:
        faulty = steps_lib.sum_over_batch(tree_leaves(g), specs, dist)
    finally:
        undo()
    del g
    from repro_torch.train.tree import tree_unflatten
    with torch.no_grad():
        _, nopt, _ = optim.adamw_update(
            tree_unflatten(state0["params"], faulty), state0["opt"],
            state0["params"], ocfg, stacks=stacks, specs=tfm.specs(cfg),
            dist=dist, shapes=tfm.param_shapes(cfg))
    del faulty
    rec["planted_mean_update"] = max(_mt_state_errors(
        dist, pls["opt"], nopt, ocfg, ref["path"], dev).values())
    return rec


def _mt_dbrx(rank, dev, conf, ref):
    """(b): one Adafactor step of dbrx on the all-to-all path, gated
    against the one-rank step; Adafactor's row means left local as the
    planted fault."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    from repro_torch.train.tree import tree_leaves
    cfg = _mt_cfg(conf, "dbrx")
    b, s = conf["dbrx"][1]
    dist = steps_lib.make_dist(make_host_mesh(2, 2), cfg,
                               ShapeConfig("train", "train", s, b))
    state0, ocfg = _mt_state(cfg, dev, ref["opt"], dist)
    _, pls, _ = steps_lib.train_state_specs(cfg, dist, ocfg)
    batch = _mt_batch(cfg, b, s, dev)
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    new, m = steps_lib.make_train_step(cfg, ocfg, kv_chunk=conf["kv_chunk"],
                                       dist=dist)(state0, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec = {"rank": rank, "expert": dist.rules["expert"],
           "ms_host": (time.perf_counter() - t0) * 1e3,
           "f_launches": fa.flash_attention.launches,
           "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
           "experts_a_rank": state0["params"]["layers"][0]["moe"]["wi"]
           .shape[0]}
    rec["update_rel"] = _mt_state_errors(dist, pls["opt"], new["opt"],
                                         ocfg, ref["path"], dev)
    del new
    _, g = steps_lib.loss_and_grads(cfg, state0["params"], batch,
                                    kv_chunk=conf["kv_chunk"], dist=dist)
    undo = _mt_skip(("adafactor_all_reduce",), range(MT_WORLD))
    try:
        with torch.no_grad():
            _, nopt, _ = optim.adafactor_update(
                g, state0["opt"], state0["params"], ocfg,
                stacks=tfm.param_stacks(cfg, state0["params"]),
                specs=tfm.specs(cfg), dist=dist,
                shapes=tfm.param_shapes(cfg))
    finally:
        undo()
    rec["planted_rowmean_update"] = max(_mt_state_errors(
        dist, pls["opt"], nopt, ocfg, ref["path"], dev).values())
    rec["opt_elems"] = sum(t.numel() for t in tree_leaves(state0["opt"]))
    return rec


def _mt_resume(rank, dev, conf, ckpt_dir):
    """(c): ``train(data=2, model=2, fail_at=...)``, then its last
    checkpoint restored through ``restore_on_mesh`` on ``shrink_mesh(2,
    model=2)`` (ranks 2, 3 left out), the params gathered whole there and
    held bit for bit to the file."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import build_state, train
    from repro_torch.runtime.elastic import restore_on_mesh, shrink_mesh
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              _placement_leaves)
    from repro_torch.train.tree import tree_leaves, tree_paths
    cfg = _mt_cfg(conf, "resume")
    layers, steps, tb, ts, every, fail = conf["resume"]
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    losses, final = train("llama3.2-1b", cfg=cfg, steps=steps, batch=tb,
                          seq=ts, ckpt_every=every, fail_at=(fail,),
                          ckpt_dir=ckpt_dir, data=2, model=2, log_every=100,
                          device=dev.type)
    rec = {"rank": rank, "losses": losses, "final": final,
           "f_launches": fa.flash_attention.launches,
           "seconds": time.perf_counter() - t0}
    d12 = steps_lib.make_dist(shrink_mesh(2, model=2), cfg,
                              ShapeConfig("train", "train", ts, tb))
    rec["small_mesh"] = dict(zip(d12.mesh.mesh_dim_names, d12.mesh.shape))
    ck = CheckpointManager(ckpt_dir)
    if d12.mesh.get_coordinate() is None:
        rec["restored_bit_equal"] = None
        return rec
    ocfg = steps_lib.opt_config_for(cfg)
    pls = {"params": steps_lib.train_state_specs(cfg, d12, ocfg)[1][
        "params"]}
    tmpl = {"params": build_state(cfg, seed=1, device=dev,
                                  dist=d12)[0]["params"]}
    got = restore_on_mesh(ck, tmpl, pls, d12)
    step = ck.latest_step()
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as z:
        equal = True
        for (key, t), pl in zip(tree_paths(got), _placement_leaves(pls)):
            whole = pl.gather(t).cpu()
            want = torch.from_numpy(z[key]).to(whole.dtype)
            equal &= bool(torch.equal(whole, want))
    rec["restored_bit_equal"] = equal
    rec["restored_step"] = step
    rec["restored_leaves"] = len(tree_leaves(got))
    return rec


def _mt_rank(rank, world, dev, conf):
    """One rank of phases 3p/4n (all ranks share the card)."""
    import gc

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = {}
    for key, fn, arg in (("llama", _mt_llama, conf["ref"]["llama"]),
                         ("dbrx", _mt_dbrx, conf["ref"]["dbrx"]),
                         ("resume", _mt_resume, conf["ckpt_dir"])):
        t0 = time.perf_counter()
        out[key] = fn(rank, dev, conf, arg)
        out[key]["part_s"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_train_phases(dev, smi):
    """Phases 3p and 4n: LM training on a (data 2, model 2) mesh over
    ``MT_WORLD`` ranks that share the card on a gloo group.  The one-rank
    references run here first (their new params to a temporary directory,
    the card freed).  (a) llama3.2-1b at full width and depth, B, S =
    ``MT_LLAMA`` (one row a rank), AdamW with ZeRO-1, remat,
    ``MT_STEPS`` steps of ``make_train_step(..., dist=)``: every step's
    loss and gnorm and the first step's update of every leaf (rel L2 over
    the whole leaf) against the one-rank steps; F twice an attention layer
    a step on each rank's 16 q / 4 kv heads; planted: rank 1 skips the
    gradient sum over 'data', the norm over the rank's own blocks, the
    log-sum-exp's sum unreduced.  (b) dbrx-132b (``MT_DBRX``) on the
    all-to-all path with Adafactor, one step held the same way; planted:
    Adafactor's row means left local.  (c) ``train()`` killed by
    ``fail_at`` on (2, 2), its losses against the one-rank run's, its last
    checkpoint restored on ``shrink_mesh(2, model=2)`` bit for bit.  4n:
    per rank the step's ms (events), device ms, peak memory, optimiser
    state bytes over the unsharded state's, each collective kind's calls,
    bytes and ms.  Returns (records, {kernel: {path: launches}})."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    conf = {"llama": MT_LLAMA, "steps": MT_STEPS, "kv_chunk": MT_KV_CHUNK,
            "dbrx": MT_DBRX, "resume": MT_RESUME, "configs": MT_CONFIGS}
    tmp = tempfile.mkdtemp(prefix="smoke-mt-")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        conf["ref"] = _mt_reference(dev, conf, tmp)
        ref_s = time.perf_counter() - t0
        conf["ckpt_dir"] = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        ranks = run_spmd(_mt_rank, MT_WORLD, conf, device=dev.type,
                         timeout=900)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    ref = conf["ref"]
    failed = []
    paths = {"F": {}}

    def r(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    # ---- (a) ------------------------------------------------------------
    cfg = _mt_cfg(conf, "llama")
    n_attn = attention_layers(cfg)
    b, s = MT_LLAMA
    recs = [x["llama"] for x in ranks]
    r0 = recs[0]
    paths["F"]["mesh_train_llama"] = sum(sum(x["f_launches"]) for x in recs)
    loss_rel = [r(a, w) for a, w in zip(r0["losses"], ref["llama"]["losses"])]
    gnorm_rel = [r(a, w) for a, w in zip(r0["gnorms"],
                                         ref["llama"]["gnorms"])]
    upd = r0["update_rel"]
    worst_key = max(upd, key=upd.get)
    planted = {"skipped data mean (update)": r0["planted_mean_update"],
               "rank-local norm (gnorm)": r(r0["planted_norm_gnorm"],
                                            ref["llama"]["gnorms"][0]),
               "unreduced log-sum-exp (loss)": r(r0["planted_lse_loss"],
                                                 ref["llama"]["losses"][0])}
    limits = {"skipped data mean (update)": TOL_MT_UPDATE,
              "rank-local norm (gnorm)": TOL_MT_GNORM,
              "unreduced log-sum-exp (loss)": TOL_MT_LOSS}
    print(f"[3p] llama3.2-1b on (data 2, model 2), {cfg.num_layers} layers, "
          f"B={b} S={s}, AdamW {MT_ADAMW} with ZeRO-1, remat, rules "
          f"{r0['rules']}: one-rank reference {ref['llama']['seconds']:.1f}"
          f" s for {MT_STEPS} steps, peak {ms_text(ref['llama']['peak_gib'], '.2f')} GiB")
    print(f"[3p] llama losses {r0['losses']} vs one-rank "
          f"{ref['llama']['losses']}: rel {[f'{x:.2e}' for x in loss_rel]} "
          f"(limit {TOL_MT_LOSS:.0e}); gnorms {r0['gnorms']} vs "
          f"{ref['llama']['gnorms']}: rel {[f'{x:.2e}' for x in gnorm_rel]}"
          f" (limit {TOL_MT_GNORM:.0e}); first step's update m^/(sqrt(v^) + "
          f"eps), rel L2 a leaf:"
          f" worst {upd[worst_key]:.3e} at {worst_key}, median "
          f"{sorted(upd.values())[len(upd) // 2]:.3e} (limit "
          f"{TOL_MT_UPDATE:.0e})")
    print(f"[3p] llama planted faults (each past its limit): "
          + ", ".join(f"{k} {v:.3e} (limit {limits[k]:.0e})"
                      for k, v in planted.items()))
    if max(loss_rel) > TOL_MT_LOSS or max(gnorm_rel) > TOL_MT_GNORM \
            or upd[worst_key] > TOL_MT_UPDATE:
        failed.append("llama gates")
    if any(v <= limits[k] for k, v in planted.items()):
        failed.append("llama planted faults")
    for x in recs:
        if x["losses"] != r0["losses"] or x["gnorms"] != r0["gnorms"]:
            failed.append(f"llama rank {x['rank']} disagrees")
        if dev.type == "cuda" and any(n != 2 * n_attn
                                      for n in x["f_launches"]):
            failed.append(f"llama rank {x['rank']} F launches")
        print(f"[4n] llama rank {x['rank']}: step {ms_text(x.get('ms'), '.3f')}"
              f" ms (events), device {ms_text(x.get('device_ms'), '.3f')} ms;"
              f" F launches a step {x['f_launches']}; peak "
              f"{x.get('peak_bytes')} bytes ({x.get('base_bytes')} before); "
              f"optimiser state {x['opt_bytes']} bytes = "
              f"{x['opt_bytes'] / x['opt_bytes_whole']:.3f} of the unsharded"
              f" {x['opt_bytes_whole']} | {smi}")
        print(f"[4n] llama rank {x['rank']} collectives a step (calls, "
              f"bytes, host ms with the device synchronised): "
              + ", ".join(f"{k} {v['calls']} / {v['bytes']} / "
                          f"{v['seconds'] * 1e3:.2f}"
                          for k, v in x["collectives"].items()))
    # ---- (b) ------------------------------------------------------------
    recs = [x["dbrx"] for x in ranks]
    d0 = recs[0]
    paths["F"]["mesh_train_dbrx"] = sum(x["f_launches"] for x in recs)
    dcfg = _mt_cfg(conf, "dbrx")
    dl = r(d0["loss"], ref["dbrx"]["losses"][0])
    dg = r(d0["gnorm"], ref["dbrx"]["gnorms"][0])
    du = d0["update_rel"]
    dk = max(du, key=du.get)
    print(f"[3p] dbrx-132b {dcfg.num_layers} layer(s), B={MT_DBRX[1][0]} "
          f"S={MT_DBRX[1][1]}, Adafactor, experts over {d0['expert']} "
          f"({d0['experts_a_rank']} a rank, capacity factor "
          f"{dcfg.capacity_factor}: no drop, so the one-rank step is the "
          f"same function): loss {d0['loss']:.6f} vs "
          f"{ref['dbrx']['losses'][0]:.6f} (rel {dl:.2e}), gnorm rel "
          f"{dg:.2e}, second moments worst {du[dk]:.3e} at {dk}; planted "
          f"row means "
          f"left local: {d0['planted_rowmean_update']:.3e}; one step "
          f"{d0['ms_host']:.1f} ms (host) | {smi}")
    if dl > TOL_MT_LOSS or dg > TOL_MT_GNORM or du[dk] > TOL_MT_UPDATE \
            or d0["planted_rowmean_update"] <= TOL_MT_UPDATE:
        failed.append("dbrx gates")
    if dev.type == "cuda" and any(x["f_launches"] != 2 * attention_layers(
            dcfg) for x in recs):
        failed.append("dbrx F launches")
    # ---- (c) ------------------------------------------------------------
    recs = [x["resume"] for x in ranks]
    c0 = recs[0]
    paths["F"]["mesh_train_resume"] = sum(x["f_launches"] for x in recs)
    want = ref["resume"]["losses"]
    cl = max(r(a, w) for a, w in zip(c0["losses"], want)) \
        if len(c0["losses"]) == len(want) else float("inf")
    print(f"[3p] train() on (2, 2) at {MT_RESUME[0]} layer(s), fail_at "
          f"{MT_RESUME[5]}: final step {c0['final']}, losses "
          f"{[round(x, 5) for x in c0['losses']]} vs the uninterrupted "
          f"one-rank run's, replayed from its checkpoint, "
          f"{[round(x, 5) for x in want]} (rel worst {cl:.2e}); params "
          f"restored on "
          f"{c0['small_mesh']} bit for bit: "
          f"{[x['restored_bit_equal'] for x in recs]} "
          f"({c0.get('restored_leaves')} leaves, step "
          f"{c0.get('restored_step')}); {c0['seconds']:.1f} s")
    if any(x["final"] != MT_RESUME[1] or x["losses"] != c0["losses"]
           for x in recs) or cl > TOL_MT_LOSS \
            or [x["restored_bit_equal"] for x in recs] != [True, True, None,
                                                           None]:
        failed.append("train() on the mesh")
    wall = time.perf_counter() - t_phase
    parts = {k: [round(x[k]["part_s"], 1) for x in ranks]
             for k in ("llama", "dbrx", "resume")}
    print(f"[3p] mesh train phase: {wall:.1f} s (references {ref_s:.1f} s: "
          f"llama {ref['llama']['seconds']:.1f}, dbrx "
          f"{ref['dbrx']['seconds']:.1f}; ranks {ranks_s:.1f} s, a rank's "
          f"parts {parts}), launches {json.dumps(paths)}")
    if failed:
        raise RuntimeError(f"mesh train gates failed: {failed}")
    for x in ranks:
        for k in ("llama", "dbrx"):
            u = x[k].pop("update_rel")
            key = max(u, key=u.get)
            x[k]["update_rel_worst"] = (key, u[key])
            x[k]["update_rel_median"] = sorted(u.values())[len(u) // 2]
    return {"mesh_train": {"llama": [x["llama"] for x in ranks],
                           "dbrx": [x["dbrx"] for x in ranks],
                           "resume": [x["resume"] for x in ranks],
                           "reference": {k: {kk: vv for kk, vv in v.items()
                                             if kk != "path"}
                                         for k, v in ref.items()},
                           "seconds": wall}}, paths



# ---------------------------------------------------------------------------
# 3q / 4o. Serving on a (data, model) mesh over ranks that share the card
# ---------------------------------------------------------------------------

# (name, arch, depth, B, S, positions filled, prefill (B, S) or None,
# source frames): depth None is the published depth, an int the first
# layers (an encoder-decoder: that many encoder and decoder layers), a
# tuple the stages.  Each cache is filled from a seed up to ``fill`` and
# decoded ``MS_STEPS`` greedy steps from there: gemma3-1b's crosses its
# 'kv_seq' blocks' boundary (the second block has no live position for
# two steps), recurrentgemma-2b's local layers mask the first block (the
# window of 2048 behind position 4092)
MS_CASES = (
    ("llama_B8", "llama3.2-1b", None, 8, 32768, 32768 - 4, None, 0),
    ("llama_B1_128k", "llama3.2-1b", None, 1, 131072, 131072 - 4, None, 0),
    ("gemma3", "gemma3-1b", 12, 8, 32768, 16384 - 2, None, 0),
    ("deepseek", "deepseek-v3-671b", ((("mla",), 1), (("mla_moe",), 1)), 8,
     32768, 32768 - 4, None, 0),
    ("recurrentgemma", "recurrentgemma-2b", 9, 1, 4096, 4096 - 4, (1, 4096),
     0),
    ("seamless", "seamless-m4t-large-v2", 6, 2, 256, 256 - 4, (2, 64),
     3072),
)
MS_STEPS = 3
MS_WORLD = 4
MS_CONFIGS = "full"           # "reduced": the CPU rehearsal's configs
# limits (each read sound and with a planted fault; PERF.md's 3q rows give
# both): relative to max|ref| (logits: over the vocab's real columns).
# First chip run (NVIDIA H100 80GB HBM3, 700 W): sound logits 5.88e-3 to
# 2.08e-2 and cache blocks up to 1.99e-2 (bf16 roundings of the new rows
# against the seeded fill's max), planted 0.36 to 1.27
TOL_MS_LOGITS = 5e-2          # a bf16 step's logits vs the one-rank step's
TOL_MS_CACHE = 5e-2           # a cache leaf's block vs the one-rank slice
TOL_MS_MOE = 3e-2             # a bf16 EP layer at decode vs its reference


def _ms_logits_rel(ref, got, cfg):
    """``_mesh_rel`` over the vocab's real columns (the padded ones hold
    -1e30 in both)."""
    v = cfg.vocab_size
    return _mesh_rel(ref[..., :v], got[..., :v])


def _ms_cfg(conf, arch, depth):
    """A case's config: full width (reduced in the rehearsal), its depth
    cut; the MoE archs on the EP path."""
    from repro_torch.configs import registry
    cfg = (registry.get_reduced(arch) if conf["configs"] == "reduced"
           else registry.get_config(arch))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    if isinstance(depth, tuple):
        return dataclasses.replace(cfg, stages=depth, num_layers=sum(
            len(k) * r for k, r in depth))
    if depth is None:
        return cfg
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, stages=((("dec",), depth),),
                                   encoder_stages=((("enc",), depth),),
                                   num_layers=2 * depth)
    return cut_depth(cfg, depth)


def _ms_fill(cfg, dist, blocks, whole, b, s, fill, dev):
    """Every cache leaf drawn whole from a seed, N(0, 1) (a K/V leaf's
    positions from ``fill`` on zero, as a fresh cache holds), this rank's
    block copied out (rank 0 keeps the whole leaf too)."""
    import torch
    from repro_torch.models import transformer as tfm
    for i, kind in enumerate(tfm.layer_kinds(cfg)):
        shapes = tfm.init_cache_layer(kind, cfg, b, s, device="meta")
        specs = tfm.cache_layer_specs(kind, cfg)
        for j, (k, meta) in enumerate(sorted(shapes.items())):
            gen = torch.Generator(device=dev).manual_seed(1000 + 7 * i + j)
            t = torch.randn(meta.shape, generator=gen, device=dev)
            if k not in ("h", "conv"):
                t[:, fill:] = 0
            t = t.to(meta.dtype)
            pl = dist.placement(dist.resolve(specs[k]), meta.shape)
            blocks[i][k].copy_(pl.block(t))
            if whole is not None:
                whole[i][k].copy_(t)
            del t


def _ms_regions(cfg, whole, b, s, fill, steps, dev, dist):
    """What the steps changed in the one-rank cache, broadcast from rank
    0 to every rank: a K/V leaf's rows ``[fill, fill + steps)``, a state
    leaf whole."""
    import torch
    from repro_torch.core import comm
    from repro_torch.models import transformer as tfm
    out = []
    for i, kind in enumerate(tfm.layer_kinds(cfg)):
        layer = {}
        for k, meta in tfm.init_cache_layer(kind, cfg, b, s,
                                            device="meta").items():
            shape = ((meta.shape[0], steps) + tuple(meta.shape[2:])
                     if k not in ("h", "conv") else meta.shape)
            t = (torch.empty(shape, dtype=meta.dtype, device=dev)
                 if whole is None else
                 (whole[i][k][:, fill:fill + steps] if k not in ("h", "conv")
                  else whole[i][k]).contiguous())
            layer[k] = comm.broadcast(t, 0, dist.mesh_group(),
                                      kind="gate_broadcast")
        out.append(layer)
    return out


def _ms_cache_rel(cfg, dist, blocks, before, regions, b, s, fill, steps):
    """Each rank's cache blocks after the steps against what they must
    hold: the blocks before the steps with the one-rank cache's changed
    rows written where this block holds their positions (a state leaf:
    its block of the one-rank state).  The worst max|Δ| / max|want| over
    the leaves."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import Spec
    worst = 0.0
    for i, kind in enumerate(tfm.layer_kinds(cfg)):
        specs = tfm.cache_layer_specs(kind, cfg)
        for k, meta in tfm.init_cache_layer(kind, cfg, b, s,
                                            device="meta").items():
            r = dist.resolve(specs[k])
            reg = regions[i][k]
            if k in ("h", "conv"):
                want = dist.placement(r, meta.shape).block(reg)
            else:
                want = before[i][k].clone()
                reg = dist.placement(Spec(r[0], None, *r[2:]),
                                     reg.shape).block(reg)
                s0, s1 = dist.span(r[1], meta.shape[1])
                for j in range(steps):
                    if s0 <= fill + j < s1:
                        want[:, fill + j - s0] = reg[:, j]
            worst = max(worst, _mesh_rel(want.float(), blocks[i][k].float()))
    return worst


def _ms_write_everywhere(orig):
    """Planted fault: the new row written by every rank of the sequence's
    group, at its position clamped into the rank's block."""
    import torch

    def write(cache, rows, idx, s0, group):
        n, length = rows.shape[1], cache.shape[1]
        pos = (idx - s0 + torch.arange(n, device=cache.device)).clamp(
            0, length - 1)
        cache.index_copy_(1, pos, rows.to(cache.dtype))
    return write


def _ms_skip_merge(rank):
    """Planted fault: rank 1 keeps its own partials of the 'kv_seq'
    softmax merge (the collectives still run, so no rank waits)."""
    def wrap(orig):
        def all_reduce(t, group, kind="all_reduce", op="sum"):
            y = orig(t, group, kind, op)
            return t if rank == 1 and kind.startswith("kv_seq") else y
        return all_reduce
    return wrap


def _ms_skip_gather(orig):
    """Planted fault: the RG-LRU's channel gather before ``wa``/``wx``
    skipped, the rank's own block standing in for every rank's."""
    import torch
    import torch.distributed as tdist

    def gather(x, group, dim=-1, kind="all_gather", reduce_bwd=False):
        y = orig(x, group, dim, kind, reduce_bwd)
        if kind != "rec_gather":
            return y
        return torch.cat([x] * tdist.get_world_size(group), dim)
    return gather


def _ms_case(rank, dev, case, conf):
    """One case of 3q and its 4o times: each rank's blocks of the seeded
    params and cache, ``MS_STEPS`` greedy steps of ``make_serve_step(cfg,
    dist)`` against the one-rank ``decode_step`` on rank 0 (the whole
    params and cache, fed the mesh's tokens; its MoE layers on JAX's EP
    semantics over the mesh run's MoE inputs), the cache blocks after the
    steps, F's calls, the MoE layers, the planted faults, then the step's
    times, collectives, cache bytes and peak memory."""
    import gc

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_dist, make_prefill_step,
                                          make_serve_step)
    from repro_torch.layers import attention, moe
    from repro_torch.models import transformer as tfm
    name, arch, depth, b, s, fill, prefill, src = case
    cfg = _ms_cfg(conf, arch, depth)
    dist = make_dist(make_host_mesh(2, 2), cfg,
                     ShapeConfig("decode", "decode", s, b))
    rec = {"name": name, "arch": arch, "rank": rank,
           "kinds": tfm.layer_kinds(cfg),
           "enc_layers": len(tfm.enc_layer_kinds(cfg)), "rules": {
               k: dist.rules[k] for k in ("batch", "heads", "kv_heads",
                                          "kv_seq", "expert")}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if rank == 0:
            whole = tfm.init(cfg, seed=0, device=dev)
            params = dist.shard_params(whole, tfm.specs(cfg))
        else:
            whole = None
            params = tfm.init(cfg, seed=0, device=dev, dist=dist)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(70)
    memory = None
    # ---- the prefill on the mesh (recurrentgemma, seamless) ---------------
    if prefill is not None:
        pb, ps = prefill
        batch = {"inputs": torch.randint(0, cfg.vocab_size, (pb, ps),
                                         generator=g).to(dev)}
        if src:
            batch["src_embeds"] = torch.randn(
                (pb, src, cfg.d_model), generator=g).to(dev, torch.bfloat16)
        step = make_prefill_step(cfg, dist)
        calls = []
        with captured_attention(calls):
            fa.flash_attention.launches = 0
            logits = step(params, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec["prefill_f_launches"] = fa.flash_attention.launches
        rec["prefill_f_gate"] = check_f_layers(
            f"{name} prefill on the mesh, rank {rank}", calls, F_FAULT)
        rec["f_heads"] = sorted({tuple(c[0].shape[1:3]) for c in calls})
        del calls
        bad = None
        if cfg.lru_width:
            undo = _pp_patch(comm, "gather_from", _ms_skip_gather)
            try:
                bad = step(params, batch)
            finally:
                undo()
        if rank == 0:
            with torch.no_grad():
                ref = make_prefill_step(cfg)(whole, batch)
            rec["prefill_rel"] = _ms_logits_rel(ref, logits, cfg)
            if bad is not None:
                rec["prefill_planted_rel"] = _ms_logits_rel(ref, bad, cfg)
        if src:
            with torch.no_grad():
                memory = tfm.encode(params, batch["src_embeds"], cfg,
                                    dist=dist)
        del logits, bad
    # ---- the caches ---------------------------------------------------------
    blocks = tfm.init_cache(cfg, b, s, device=dev, dist=dist)
    wcache = tfm.init_cache(cfg, b, s, device=dev) if rank == 0 else None
    _ms_fill(cfg, dist, blocks, wcache, b, s, fill, dev)
    before = [{k: v.clone() for k, v in c.items()} for c in blocks]
    rec["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in _tensors(blocks))
    rec["whole_cache_bytes"] = sum(
        t.numel() * t.element_size() for kind in tfm.layer_kinds(cfg)
        for t in tfm.init_cache_layer(kind, cfg, b, s,
                                      device="meta").values())
    # ---- the greedy steps ---------------------------------------------------
    moe_layers = [i for i, k in enumerate(rec["kinds"]) if k in tfm.MOE_KINDS]
    n_ep = dist.extent(dist.rules["expert"]) if moe_layers else 1
    serve = make_serve_step(cfg, dist)
    kept = {}

    def keep_logits(orig):
        def f(*a, **kw):
            out = orig(*a, **kw)
            kept["logits"] = out[0]
            return out
        return f

    def keep_moe(orig):
        def f(p, x, *a, **kw):
            y = orig(p, x, *a, **kw)
            kept.setdefault("moe", []).append((p, x, y))
            return y
        return f

    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=g).to(dev)
    rec.update(steps=[], moe=[], decode_f_launches=[])
    f_calls = []
    ref_logits = None
    for j in range(MS_STEPS):
        idx = torch.tensor(fill + j, device=dev)
        kept.clear()
        undos = [_pp_patch(tfm, "decode_step", keep_logits),
                 _pp_patch(moe, "moe_apply", keep_moe)]
        try:
            with captured_attention(f_calls):
                fa.flash_attention.launches = 0
                nxt, blocks = serve(params, blocks, tok, idx, memory)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                rec["decode_f_launches"].append(fa.flash_attention.launches)
        finally:
            for u in reversed(undos):
                u()
        logits = kept["logits"]
        # the MoE layers' inputs and outputs, every rank's rows
        moe_in, moe_out = [], []
        for p, x, y in kept.get("moe", []):
            xs, ys = _mesh_world_gather(x), _mesh_world_gather(y)
            moe_in.append(torch.cat([xs[0], xs[2]]) if b > 1 else xs[0])
            moe_out.append(ys)
            if j == MS_STEPS - 1:
                # planted: the experts' results return to the rotated rank
                undo = _pp_patch(comm, "all_to_all_fn",
                                 _mesh_rotated_return())
                try:
                    with torch.no_grad():
                        bad = moe.moe_apply(p, x, cfg, dist)
                finally:
                    undo()
                moe_out.append(_mesh_world_gather(bad))
        step_rec = {"idx": fill + j,
                    "tokens": nxt[:, 0].tolist()}
        if rank == 0:
            inputs = iter(moe_in)

            def ep_ref(orig):
                def f(p, x, cfg_):
                    return _mesh_ep_ref(p, next(inputs), cfg_, n_ep)
                return f
            undo = (_pp_patch(moe, "moe_decode", ep_ref) if moe_layers
                    else (lambda: None))
            try:
                with torch.no_grad():
                    ref_logits, wcache = tfm.decode_step(
                        whole, wcache, tok, fill + j, cfg, memory=memory)
            finally:
                undo()
            step_rec["rel"] = _ms_logits_rel(ref_logits, logits, cfg)
            step_rec["argmax_equal"] = bool(torch.equal(
                ref_logits.argmax(-1), logits.argmax(-1)))
            for k, i in enumerate(moe_layers):
                wm = whole["layers"][i]["moe"]
                with torch.no_grad():
                    sim = _mesh_ep_ref(wm, moe_in[k], cfg, n_ep)
                half = b // 2 if b > 1 else b
                rows = [sim[:half], sim[:half], sim[-half:], sim[-half:]]
                ys = moe_out[2 * k if j == MS_STEPS - 1 else k]
                m = {"step": j, "layer": i,
                     "rel": max(_mesh_rel(r, y) for r, y in zip(rows, ys))}
                if j == MS_STEPS - 1:
                    m["planted_rel"] = min(_mesh_rel(r, y) for r, y in zip(
                        rows, moe_out[2 * k + 1]))
                rec["moe"].append(m)
        rec["steps"].append(step_rec)
        tok_last, tok = tok, nxt
        del kept["logits"], moe_in, moe_out
    if f_calls:
        rec["decode_f_gate"] = check_f_layers(
            f"{name} decode on the mesh, rank {rank}", f_calls, F_FAULT)
        rec["decode_f_shapes"] = sorted({(tuple(c[0].shape[1:3]),
                                          c[1].shape[1]) for c in f_calls})
    del f_calls
    # ---- the cache blocks against the one-rank cache -----------------------
    regions = _ms_regions(cfg, wcache, b, s, fill, MS_STEPS, dev, dist)
    rec["cache_rel"] = _ms_cache_rel(cfg, dist, blocks, before, regions, b,
                                     s, fill, MS_STEPS)
    idx_last = torch.tensor(fill + MS_STEPS - 1, device=dev)

    def run_last():
        # the last step again on its own inputs: with sound code it writes
        # the rows it wrote before (a recurrent state moves on)
        return serve(params, blocks, tok_last, idx_last, memory)

    def planted_logits(patches):
        undos = [_pp_patch(*p) for p in patches]
        undos.append(_pp_patch(tfm, "decode_step", keep_logits))
        try:
            run_last()
        finally:
            for u in reversed(undos):
                u()
        return (_ms_logits_rel(ref_logits, kept["logits"], cfg)
                if rank == 0 else None)
    split_seq = dist.extent(dist.resolve(("kv_seq",))[0]) > 1
    if split_seq and not cfg.lru_width:
        rec["merge_planted_rel"] = planted_logits(
            [(comm, "all_reduce", _ms_skip_merge(rank))])
    if cfg.is_encoder_decoder:
        rec["cross_planted_rel"] = planted_logits(
            [(comm, "reduce_from", _mesh_unsummed(rank, "cross_all_reduce"))])
    kept.clear()
    # ---- 4o: the step's times, collectives and memory ----------------------
    rec["ms"] = _pp_ms(run_last, dev, iters=3)
    rec["device_ms"] = _pp_device_ms(run_last, dev)
    comm.traffic_reset()
    run_last()
    rec["collectives"] = comm.traffic()
    rec["peak_bytes"], rec["base_bytes"] = _pp_peak(run_last, dev)
    if rank == 0:
        def single():
            with torch.no_grad():
                return tfm.decode_step(whole, wcache, tok_last, idx_last,
                                       cfg, memory=memory)
        rec["single_ms"] = _pp_ms(single, dev, iters=3)
        rec["single_device_ms"] = _pp_device_ms(single, dev)
    # ---- planted: the new row written on every rank (last: it stays) -------
    if split_seq and not cfg.lru_width:
        undo = _pp_patch(attention, "_write_rows", _ms_write_everywhere)
        try:
            run_last()
        finally:
            undo()
        rec["write_planted_rel"] = _ms_cache_rel(
            cfg, dist, blocks, before, regions, b, s, fill, MS_STEPS)
    return rec


def _ms_rank(rank, world, dev, conf):
    """One rank of phases 3q/4o (all ranks share the card)."""
    import gc

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = []
    for case in conf["cases"]:
        t0 = time.perf_counter()
        out.append(_ms_case(rank, dev, case, conf))
        out[-1]["case_s"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_serve_phases(dev, smi):
    """Phases 3q and 4o: serving on a (data 2, model 2) mesh over
    ``MS_WORLD`` ranks that share the card on a gloo group, each case
    under ``make_dist(mesh, cfg, ShapeConfig(.., "decode", S, B))`` at
    full width in bf16 (``MS_CASES``): llama3.2-1b at B = 8, S = 32768
    (kv heads over 'model') and B = 1, S = 131072 (the sequence over
    'data', kv heads over 'model'), gemma3-1b (one kv head: the sequence
    over 'model'), deepseek-v3-671b (MLA's cache sequence over 'model',
    EP at decode), recurrentgemma-2b (the RG-LRU on its channel block; a
    prefill at (1, 4096) with F on 5 local heads) and seamless-m4t-large-v2
    (a prefill over 3072 source frames, cross attention on 8 of 16 heads;
    F at every decode step at Sq = 1 over 3072 rows).  Gates: each step's
    logits against the one-rank step on the same weights and cache, the
    cache blocks after the steps against the one-rank cache's slices, F's
    calls on local heads (``check_f_layers``), each MoE layer at decode
    against JAX's EP semantics on the run's own inputs (``_mesh_ep_ref``),
    the cache bytes a rank (a quarter of one rank's for the first four
    cases); planted: a 'kv_seq' rank skipping the merge, the new row
    written on every rank, the RG-LRU's gather skipped, one rank skipping
    the cross attention's all-reduce, the EP return to the rotated rank.
    4o: per rank the step's ms (events) and device ms beside the one-rank
    step's, cache bytes over the one-rank cache's, each collective kind's
    calls and bytes a step, peak memory.  Returns (records, {"F": {path:
    launches}})."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_spmd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = run_spmd(_ms_rank, MS_WORLD, {"cases": MS_CASES,
                                              "configs": MS_CONFIGS},
                         device=dev.type, timeout=900)
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    wall = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    paths = {"F": {}}
    failed = []
    for c, case in enumerate(MS_CASES):
        name, b, s, fill, prefill = case[0], case[3], case[4], case[5], \
            case[6]
        recs = [r[c] for r in ranks]
        r0 = recs[0]
        kinds = r0["kinds"]
        n_dec = kinds.count("dec")
        print(f"[3q] {name} ({r0['arch']}, {len(kinds)} layers, B={b}, "
              f"S={s}, filled to {fill}, {MS_STEPS} steps): rules "
              f"{r0['rules']}; {r0['case_s']:.1f} s")
        if prefill is not None:
            n_f = sum(k in ("local", "attn", "global", "dec")
                      for k in kinds) + n_dec + r0["enc_layers"]
            paths["F"][f"mesh_serve_{name}_prefill"] = sum(
                r["prefill_f_launches"] for r in recs)
            for r in recs:
                fg = r["prefill_f_gate"]
                print(f"[3q] {name} prefill rank {r['rank']}: F launches "
                      f"{r['prefill_f_launches']} (sq, heads) "
                      f"{r['f_heads']}, F vs plain worst share "
                      f"{fg['worst_share']:.3f} (planted x{F_FAULT}: least "
                      f"{fg['planted_least_share']:.2f})")
                if cuda and r["prefill_f_launches"] != n_f:
                    failed.append(f"{name} prefill F launches")
            planted = r0.get("prefill_planted_rel")
            print(f"[3q] {name} prefill's last-position logits vs the "
                  f"one-rank prefill, limit {TOL_MS_LOGITS:.0e}: "
                  f"{r0['prefill_rel']:.2e}" + (
                      "" if planted is None else
                      f", the RG-LRU's gather skipped {planted:.2e}"))
            if r0["prefill_rel"] > TOL_MS_LOGITS or (
                    planted is not None and not planted > TOL_MS_LOGITS):
                failed.append(f"{name} prefill")
        if n_dec:
            paths["F"][f"mesh_serve_{name}_decode"] = sum(
                sum(r["decode_f_launches"]) for r in recs)
        for r in recs:
            dl = r["decode_f_launches"]
            line = f"[3q] {name} decode rank {r['rank']}: F launches a step {dl}"
            if "decode_f_gate" in r:
                fg = r["decode_f_gate"]
                line += (f" ((sq, heads), keys) {r['decode_f_shapes']}, F vs "
                         f"plain worst share {fg['worst_share']:.3f} "
                         f"(planted x{F_FAULT}: least "
                         f"{fg['planted_least_share']:.2f})")
            print(line)
            if cuda and dl != [n_dec] * MS_STEPS:
                failed.append(f"{name} rank {r['rank']} decode F launches")
        for st in r0["steps"]:
            print(f"[3q] {name} step at {st['idx']}: logits vs the one-rank "
                  f"step, limit {TOL_MS_LOGITS:.0e}: {st['rel']:.2e} "
                  f"(argmax equal: {st['argmax_equal']}), tokens "
                  f"{st['tokens']}")
            if st["rel"] > TOL_MS_LOGITS:
                failed.append(f"{name} step {st['idx']} logits")
        for key, what in (("merge_planted_rel", "rank 1 skips the 'kv_seq' "
                                                "merge"),
                          ("cross_planted_rel", "rank 1 skips the cross "
                                                "attention's all-reduce")):
            if key in r0:
                print(f"[3q] {name} last step, {what}: {r0[key]:.2e} (limit "
                      f"{TOL_MS_LOGITS:.0e})")
                if not r0[key] > TOL_MS_LOGITS:
                    failed.append(f"{name} {key}")
        cache = [r["cache_rel"] for r in recs]
        write = [r.get("write_planted_rel") for r in recs]
        print(f"[3q] {name} cache blocks after the steps vs the one-rank "
              f"cache's slices, per rank, limit {TOL_MS_CACHE:.0e}: "
              + ", ".join(f"{e:.2e}" for e in cache)
              + ("" if write[0] is None else "; the new row written on every "
                 "rank: " + ", ".join(f"{e:.2e}" for e in write)))
        if max(cache) > TOL_MS_CACHE or (write[0] is not None
                                         and not max(write) > TOL_MS_CACHE):
            failed.append(f"{name} cache")
        for m in r0["moe"]:
            planted = m.get("planted_rel")
            print(f"[3q] {name} MoE layer {m['layer']} step {m['step']} vs "
                  f"JAX's EP semantics on the run's inputs, limit "
                  f"{TOL_MS_MOE:.0e}: {m['rel']:.2e}" + (
                      "" if planted is None else
                      f", return to the rotated rank {planted:.2e}"))
            if m["rel"] > TOL_MS_MOE or (planted is not None
                                         and not planted > TOL_MS_MOE):
                failed.append(f"{name} MoE layer {m['layer']}")
        for r in recs:
            share = r["cache_bytes"] / r0["whole_cache_bytes"]
            single = (f", one rank {r0['single_ms']:.3f} ms, device "
                      f"{ms_text(r0['single_device_ms'])} ms"
                      if r["rank"] == 0 else "")
            print(f"[4o] {name} rank {r['rank']}: step {r['ms']:.3f} ms "
                  f"(events), device {ms_text(r['device_ms'])} ms{single}; "
                  f"cache {r['cache_bytes']} bytes = {share:.4f} of one "
                  f"rank's {r0['whole_cache_bytes']}; peak "
                  f"{r['peak_bytes']} bytes ({r['base_bytes']} before) | "
                  f"{smi}")
            print(f"[4o] {name} rank {r['rank']} collectives a step (calls, "
                  f"bytes): " + ", ".join(
                      f"{k} {v['calls']} / {v['bytes']}"
                      for k, v in r["collectives"].items()))
            if c < 4 and abs(share - 0.25) > 1e-9:
                failed.append(f"{name} rank {r['rank']} cache share {share}")
    print(f"[3q] mesh serve phase: {wall:.1f} s over {MS_WORLD} ranks, F "
          f"launches {json.dumps(paths['F'])}")
    if failed:
        raise RuntimeError(f"mesh serve gates failed: {failed}")
    return {"mesh_serve": {"ranks": ranks, "seconds": wall}}, paths


# ---------------------------------------------------------------------------
# phases 3r / 4p: the rest of the (data, model) mesh
# ---------------------------------------------------------------------------

MR_WORLD = 4
MR_CONFIGS = "full"           # "reduced": the CPU rehearsal's configs
MR_RG = ((1, 4096), 3, 2, (1, 1024))  # prefill, greedy steps, AdamW steps
                                      # and their batch
MR_GAN_BATCHES = (64, 1)
MR_GAN_TRAIN = 16
MR_DBRX = ((2, 1024), 3, 256)  # prefill, greedy steps (1 layer), the
                                # Adafactor step's S (B as the prefill's)
MR_LLAMA = ((2, 4096), 4)     # SP prefill at full depth; the train step's
                              # layers (at the prefill's shape)
MR_S2T = (6, 2, 256, 512)     # layers a stack, B, S, source frames
MR_MAMBA = ((1, 4096), 3)
MR_KV_CHUNK = 1024
MR_ADAMW = dict(name="adamw", lr=3e-4, eps=1e-3)
MR_ADAFACTOR = dict(name="adafactor", lr=1e-4)
TOL_MR_GRAD = 5e-2            # a bf16 gradient block vs the one-rank block
# a row-block launch of A or B vs its plain version on the same inputs,
# max|Δ| / max|ref|: two f32 orders of the same <= 6400-term partial sums
TOL_MR_ROWS = 1e-5


def _mr_cfg(conf, arch, depth=None, **kw):
    """A case's config: full width (the rehearsal's reduced one), its
    depth cut to ``depth`` layers (an encoder-decoder: a stack each)."""
    from repro_torch.configs import registry
    cfg = (registry.get_reduced(arch) if conf["configs"] == "reduced"
           else registry.get_config(arch))
    cfg = dataclasses.replace(cfg, **kw)
    if depth is None:
        return cfg
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, stages=((("dec",), depth),),
                                   encoder_stages=((("enc",), depth),),
                                   num_layers=2 * depth)
    return cut_depth(cfg, depth)


def _mr_params(cfg, dist, dev, seed=0):
    """(every rank's blocks of the seeded params, the whole params on
    rank 0 and None elsewhere)."""
    from repro_torch.models import transformer as tfm
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if dist.is_first():
            whole = tfm.init(cfg, seed=seed, device=dev)
            return dist.shard_params(whole, tfm.specs(cfg)), whole
        return tfm.init(cfg, seed=seed, device=dev, dist=dist), None


def _mr_measure(fn, dev, single=None):
    """4p: a call's events ms (one call after one), device ms (one
    trace), each collective kind's calls and bytes (the warm-up call's),
    peak memory; the one-rank call's ms and device ms on rank 0."""
    from repro_torch.core import comm
    comm.traffic_reset()
    fn()
    rec = {"collectives": comm.traffic(),
           "ms": _pp_ms(fn, dev, iters=1, warmup=0),
           "device_ms": _pp_device_ms(fn, dev)}
    rec["peak_bytes"], rec["base_bytes"] = _pp_peak(fn, dev)
    if single is not None:
        rec["single_ms"] = _pp_ms(single, dev, iters=1)
        rec["single_device_ms"] = _pp_device_ms(single, dev)
    return rec


def _mr_gather_fault(target, n=None, unsummed=False):
    """``comm.gather_from`` wrong at the kind ``target``: the rank's own
    block repeated ``n`` times (the gather skipped), or (``unsummed``) the
    right forward with the rank's own cotangent slice as its backward."""
    import torch

    def wrap(orig):
        def gather(x, group, dim=-1, kind="all_gather", reduce_bwd=False):
            if kind != target:
                return orig(x, group, dim, kind, reduce_bwd)
            if unsummed:
                return orig(x, group, dim, kind, False)
            orig(x, group, dim, kind, reduce_bwd)
            return torch.cat([x] * n, dim)
        return gather
    return wrap


def _mr_whole(tree, placements):
    """Every leaf gathered whole on every rank (a collective)."""
    from repro_torch.train.checkpoint import _placement_leaves
    from repro_torch.train.tree import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [pl.gather(t) for t, pl in zip(
        tree_leaves(tree), _placement_leaves(placements))])


def _mr_train(cfg, dist, dev, opt_kw, batch, steps, whole_ref=True,
              planted=None):
    """``steps`` train steps on the mesh (and on one rank, on rank 0):
    losses, gnorms, the first step's AdamW first moment (f32, gathered
    whole) against the one-rank step's (a bf16 param's first update is
    below its rounding step) and the mesh step's closure.  ``planted``
    (what it plants, a patch returning its undo): the first step again
    under it, its first moment against the one-rank step's."""
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.train.tree import tree_leaves
    state0, ocfg = _mt_state(cfg, dev, opt_kw, dist)
    step = steps_lib.make_train_step(cfg, ocfg, kv_chunk=MR_KV_CHUNK,
                                     dist=dist)
    _, pls, _ = steps_lib.train_state_specs(cfg, dist, ocfg)
    rec = {"losses": [], "gnorms": []}
    state, first = state0, None
    for i in range(steps):
        state, m = step(state, batch)
        rec["losses"].append(float(m["loss"]))
        rec["gnorms"].append(float(m["gnorm"]))
        if i == 0:
            first = _mr_whole(state["opt"]["m"], pls["opt"]["m"])
    del state
    bad = None
    if planted is not None:
        rec["planted"] = planted[0]
        undo = planted[1]()
        try:
            bad, _ = step(state0, batch)
        finally:
            undo()
        bad = _mr_whole(bad["opt"]["m"], pls["opt"]["m"])
    if dist.is_first() and whole_ref:
        one, _ = _mt_state(cfg, dev, opt_kw)
        step1 = steps_lib.make_train_step(cfg, ocfg, kv_chunk=MR_KV_CHUNK)
        rec["one_losses"], rec["one_gnorms"] = [], []
        for i in range(steps):
            one, m = step1(one, batch)
            rec["one_losses"].append(float(m["loss"]))
            rec["one_gnorms"].append(float(m["gnorm"]))
            if i == 0:
                rec["update_rel"] = max(
                    _mesh_rel(w.float(), g.float())
                    for g, w in zip(tree_leaves(first),
                                    tree_leaves(one["opt"]["m"])))
                if bad is not None:
                    rec["planted_update_rel"] = max(
                        _mesh_rel(w.float(), g.float())
                        for g, w in zip(tree_leaves(bad),
                                        tree_leaves(one["opt"]["m"])))
        del one
    del first, bad
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return rec, (step, state0, pls)


def _mr_rg(rank, dev, conf):
    """recurrentgemma-2b on (1, 4): q cut at 2.5 heads a rank (its local
    layer's 10 heads of 256)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_dist, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import transformer as tfm
    (pb, ps), n_dec, n_train, (tb, ts) = conf["rg"]
    cfg = _mr_cfg(conf, "recurrentgemma-2b", 3)
    mesh = make_host_mesh(1, 4)
    dist = make_dist(mesh, cfg, ShapeConfig("p", "prefill", ps, pb))
    params, whole = _mr_params(cfg, dist, dev)
    g = torch.Generator().manual_seed(71)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (pb, ps),
                                     generator=g).to(dev)}
    step = make_prefill_step(cfg, dist, kv_chunk=MR_KV_CHUNK)
    calls = []
    zero_counts()
    with captured_attention(calls):
        fa.flash_attention.launches = 0
        logits = step(params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    rec = {"rank": rank, "kinds": tfm.layer_kinds(cfg),
           "rules": {k: dist.rules[k] for k in ("batch", "heads",
                                                "kv_heads")},
           "f_launches": fa.flash_attention.launches,
           "f_heads": sorted({tuple(c[0].shape[1:3]) for c in calls}),
           "f_gate": check_f_layers(f"rg prefill rank {rank}", calls,
                                    F_FAULT)}
    del calls
    single = None
    if whole is not None:
        one = make_prefill_step(cfg, kv_chunk=MR_KV_CHUNK)
        with torch.no_grad():
            rec["prefill_rel"] = _ms_logits_rel(one(whole, batch), logits,
                                                cfg)

        def single():
            return one(whole, batch)
    rec["measure"] = _mr_measure(lambda: step(params, batch), dev, single)
    del logits
    # ---- greedy decode from an empty cache -----------------------------
    ddist = make_dist(mesh, cfg, ShapeConfig("d", "decode", 64, pb))
    dparams, _ = _mr_params(cfg, ddist, dev)
    blocks = tfm.init_cache(cfg, pb, 64, device=dev, dist=ddist)
    wcache = tfm.init_cache(cfg, pb, 64, device=dev) if whole else None
    serve = make_serve_step(cfg, ddist)
    tok = batch["inputs"][:, :1]
    rec["decode_rel"] = []
    for j in range(n_dec):
        kept = {}
        orig = tfm.decode_step

        def keep(*a, **kw):
            out = orig(*a, **kw)
            kept["logits"] = out[0]
            return out
        tfm.decode_step = keep
        try:
            nxt, blocks = serve(dparams, blocks, tok, j)
        finally:
            tfm.decode_step = orig
        if whole is not None:
            with torch.no_grad():
                ref, wcache = tfm.decode_step(whole, wcache, tok, j, cfg)
            rec["decode_rel"].append(_ms_logits_rel(ref, kept["logits"],
                                                    cfg))
        tok = nxt
    del dparams, blocks, wcache
    # ---- AdamW steps -------------------------------------------------------
    tdist = make_dist(mesh, cfg, ShapeConfig("t", "train", ts, tb))
    tbatch = _mt_batch(cfg, tb, ts, dev)
    rec["train"], (tstep, state0, pls) = _mr_train(
        cfg, tdist, dev, MR_ADAMW, tbatch, n_train)
    # the local layer's q gradient against the one-rank gradient's block:
    # sound, and (planted) the cut head's gather with the rank's own
    # cotangent slice as its backward
    from repro_torch.launch import steps as steps_lib
    li = tfm.layer_kinds(cfg).index("local")
    spec = tdist.resolve(tfm.layer_specs("local", cfg)["attn"]["q"]["w"])

    def qgrad(params):
        _, gr = steps_lib.loss_and_grads(cfg, params, tbatch,
                                         kv_chunk=MR_KV_CHUNK, dist=tdist)
        return gr["layers"][li]["attn"]["q"]["w"]
    sound = qgrad(state0["params"])
    undo = _pp_patch(comm, "gather_from", _mr_gather_fault(
        "q_head_gather", unsummed=True))
    try:
        bad = qgrad(state0["params"])
    finally:
        undo()
    if whole is not None:
        whole_t = tfm.init(cfg, seed=0, device=dev)
        _, g1 = steps_lib.loss_and_grads(cfg, whole_t, tbatch,
                                         kv_chunk=MR_KV_CHUNK)
        ref = tdist._block(g1["layers"][li]["attn"]["q"]["w"], spec)
        rec["qgrad_rel"] = _mesh_rel(ref, sound)
        rec["planted_qgrad_rel"] = _mesh_rel(ref, bad)
        del whole_t, g1
    del bad, sound, state0
    return rec


def _mr_gan_cfg(conf, model, wd):
    from repro_torch.models import gan
    from repro_torch.train_gan import SMALL_LAYERS
    base = gan.DCGAN if model == "dcgan" else gan.CGAN
    cfg = dataclasses.replace(base, backend="cuda", wdtype=wd)
    if conf["configs"] == "reduced":
        cfg = dataclasses.replace(cfg, layers=SMALL_LAYERS)
    return cfg


def _mr_row_launches(records):
    """Kernels A-D as ``core.plan`` calls them, each row-block launch
    kept as (entry, its plain version: the rows form of the whole-plane or
    the tiled plain version, arguments, output); returns the undo."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import untangled_conv as uc
    def deconv_plain(x, blk, sp_tiles=None, sum_uv=None, **kw):
        if sp_tiles is None:
            return uc.untangled_deconv2d_rows_ref(x, blk, sum_uv=sum_uv, **kw)
        return uc.untangled_deconv2d_tiled_rows_ref(x, blk, sp_tiles=sp_tiles,
                                                    **kw)

    def conv_plain(x, blk, sp_tiles=None, **kw):
        if sp_tiles is None:
            return uc.untangled_conv2d_superpack_rows_ref(x, blk, **kw)
        return uc.untangled_conv2d_superpack_tiled_rows_ref(
            x, blk, sp_tiles=sp_tiles, **kw)
    undos = []
    for name, plain in (("untangled_deconv2d", deconv_plain),
                        ("untangled_conv2d_superpack", conv_plain)):
        def wrap(orig, plain=plain):
            def launch(*a, **kw):
                y = orig(*a, **kw)
                if kw.get("rows") is not None:
                    records.append((orig, plain, a, kw, y))
                return y
            return launch
        undos.append(_pp_patch(plan_mod, name, wrap))
    return lambda: [u() for u in undos]


def _mr_row_check(records):
    """Each row-block launch of ``records`` against its plain version on
    the same card inputs (max|Δ| / max|ref|, the worst); the plain version
    on the block read one row off (planted: a wrong ``r0``; the least);
    the launch again on the block as rows [r0, r1) of a superpack whose
    other rows are NaN (NaN scales for int8 codes): the worst reading of
    that output against the plain version, NaN unless the launch read its
    block only."""
    import torch
    worst = guard = 0.0
    planted = math.inf
    for entry, plain, (x, blk), kw, y in records:
        r0, r1 = kw["rows"]
        taps = (sum(ex.taps[0] * ex.taps[1] for ex in kw["phases"])
                if "phases" in kw else kw["taps_hw"][0] * kw["taps_hw"][1])
        total = taps * x.shape[3]
        want = plain(x, blk, **kw)
        worst = max(worst, _mesh_rel(want, y))
        off = 1 if r1 < total else -1
        planted = min(planted, _mesh_rel(want, plain(
            x, blk, **dict(kw, rows=(r0 + off, r1 + off)))))
        sc = kw.get("scales")
        if sc is None:
            fence = torch.full((total, blk.shape[1]), math.nan,
                               device=blk.device)
        else:
            fence = torch.zeros((total, blk.shape[1]), dtype=blk.dtype,
                                device=blk.device)
            fenced = torch.full((total, 1), math.nan, device=sc.device)
            fenced[r0:r1] = sc
            kw = dict(kw, scales=fenced[r0:r1])
        fence[r0:r1] = blk
        got = entry(x, fence[r0:r1], **kw)
        guard = max(guard, _mesh_rel(want, got)
                    if bool(torch.isfinite(got).all()) else math.nan)
    return worst, planted, guard


def _mr_site_signs(signs):
    """``ConvPlan.apply`` as it is, each site's output signs (> 0) kept in
    call order; returns the undo."""
    from repro_torch.core import plan as plan_mod

    depth = [0]                 # a site with a bias calls itself once

    def wrap(orig):
        def apply(self, x, packed, bias=None):
            depth[0] += 1
            try:
                y = orig(self, x, packed, bias=bias)
            finally:
                depth[0] -= 1
            if not depth[0]:
                signs.append(y.detach() > 0)
            return y
        return apply
    return _pp_patch(plan_mod.ConvPlan, "apply", wrap)


def _mr_gan_f64(gw, dw, z, real, cfg, signs=None):
    """The DCGAN step's summed losses in f64, written out apart from the
    port's layers (the f64 oracle at every site on the unpacked kernels),
    and every weight's gradient: the train gate's reference.  ``signs``
    (each site's output signs in call order, from an f32 step): the
    ReLUs take those signs, so the reference shares that step's discrete
    choices (a pre-activation within its rounding bound of zero may take
    either sign, and one such flip moves a block's gradient by 5e-3);
    None: its own."""
    import torch
    from repro_torch.core import reference as ref
    from repro_torch.models import gan
    p = {k: v.detach().double().requires_grad_()
         for k, v in {**gw, **dw}.items()}
    order = iter(signs or ())

    def act(y, slope):
        pos = next(order) if signs is not None else y > 0
        return torch.where(pos, y, slope * y)
    l0 = cfg.layers[0]
    x = torch.relu(z.double() @ p["proj"]).reshape(
        z.shape[0], l0.in_hw, l0.in_hw, l0.in_c)
    plans = gan.generator_plans(cfg)
    for i, plan in enumerate(plans):
        sp_ = plan.spec
        x = ref.conv_oracle_f64(ref.zero_insert(x, sp_.strides),
                                plan.unpack(p[f"dc{i}"]),
                                padding=sp_.padding)[0] + p[f"b{i}"]
        if i == len(plans) - 1:
            next(order, None)
            x = torch.tanh(x)
        else:
            x = act(x, 0.0)

    def disc(x):
        for i, plan in enumerate(gan.discriminator_plans(cfg)):
            sp_ = plan.spec
            x = act(ref.conv_oracle_f64(
                x, plan.unpack(p[f"c{i}"]), strides=sp_.strides,
                padding=sp_.padding)[0], 0.2)
        return x.reshape(x.shape[0], -1) @ p["head"]
    d_fake, d_real = disc(x), disc(real.double())
    loss = (gan.softplus(-d_fake).mean()
            + (gan.softplus(-d_real) + gan.softplus(d_fake)).mean())
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p.items()}


def _mr_gan(rank, dev, conf):
    """DCGAN and cGAN, generator and discriminator, with every superpack
    row-parallel over 'model' (1, 4): f32 and int8 at each batch; each
    row-block launch against its plain version on the card; the sites
    against the f64 oracle; a DCGAN train step against the f64 step."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import untangled_conv as uc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gan
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    dist = DistContext(make_host_mesh(1, 4), rules=dict(
        DEFAULT_RULES, conv_taps="model", conv_out=None))
    out = []
    for model in ("dcgan", "cgan"):
        for wd in ("float32", "int8"):
            cfg = _mr_gan_cfg(conf, model, wd)
            gw = gan.generator_init(60, cfg, device=dev)
            dw = gan.discriminator_init(61, cfg, device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                gp = dist.shard_params(gw, gan.generator_specs(cfg))
                dp = dist.shard_params(dw, gan.discriminator_specs(cfg))
            for b in conf["gan_batches"]:
                z = torch.randn((b, cfg.z_dim), generator=torch.Generator(
                    ).manual_seed(62 + b)).to(dev)
                sites, launches = [], []
                orig = plan_mod._rp_apply

                def capture(plan, x, packed, bias):
                    y = orig(plan, x, packed, bias)
                    sites.append((plan, x, packed, y))
                    return y
                zero_counts()
                uc.untangled_deconv2d.launches_rows = 0
                uc.untangled_conv2d_superpack.launches_rows = 0
                plan_mod._rp_apply = capture
                undo = _mr_row_launches(launches)
                try:
                    with torch.no_grad():
                        img = gan.generator_apply(gp, z, cfg, dist=dist)
                        logit = gan.discriminator_apply(dp, img, cfg,
                                                        dist=dist)
                finally:
                    undo()
                    plan_mod._rp_apply = orig
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                counts, other = read_counts(wd)
                rec = {"model": model, "wdtype": wd, "batch": b,
                       "rank": rank, "launches": counts,
                       "other_dtype_launches": other,
                       "row_launches": len(launches),
                       "rows_counted": uc.untangled_deconv2d.launches_rows
                       + uc.untangled_conv2d_superpack.launches_rows}
                with torch.no_grad():
                    (rec["rows_rel"], rec["rows_planted"],
                     rec["rows_fenced"]) = _mr_row_check(launches)
                del launches
                worst = 0.0
                # the sites' outputs are the same on every rank (after the
                # all-reduce): the f64 oracle runs on rank 0
                for plan, x, packed, y in (sites if dist.is_first()
                                           else ()):
                    key = next(k for k, v in {**gp, **dp}.items()
                               if v is packed)
                    w = {**gw, **dw}[key]
                    kern = plan.unpack(w)
                    bias = (gp.get("b" + key[2:]) if key.startswith("dc")
                            else None)
                    y64, bound = f64_bound(plan, x, kern)
                    if bias is not None:
                        y64 = y64 + bias.double()
                    worst = max(worst, float(((y.double() - y64).abs()
                                              / bound).max()))
                    del y64, bound
                rec["ulp_share"] = worst
                with torch.no_grad():
                    ref_img = gan.generator_apply(gw, z, cfg)
                rec["rel"] = _mesh_rel(ref_img, img)
                if b == conf["gan_batches"][0] and wd == "float32":
                    undo = _pp_patch(comm, "reduce_from", _mesh_unsummed(
                        rank, "rows_all_reduce"))
                    try:
                        with torch.no_grad():
                            bad = gan.generator_apply(gp, z, cfg, dist=dist)
                    finally:
                        undo()
                    rec["planted_rel"] = _mesh_rel(ref_img, bad)
                    single = ((lambda: gan.generator_apply(gw, z, cfg))
                              if dist.is_first() else None)

                    def fwd():
                        with torch.no_grad():
                            return gan.generator_apply(gp, z, cfg,
                                                       dist=dist)
                    rec["measure"] = _mr_measure(fwd, dev, single)
                out.append(rec)
                del sites, img, logit
    # ---- a DCGAN train step: the superpack blocks' gradients ----------------
    cfg = _mr_gan_cfg(conf, "dcgan", "float32")
    gw = gan.generator_init(63, cfg, device=dev)
    dw = gan.discriminator_init(64, cfg, device=dev)
    gp = dist.shard_params(gw, gan.generator_specs(cfg))
    dp = dist.shard_params(dw, gan.discriminator_specs(cfg))
    gen = torch.Generator().manual_seed(65)
    b = conf["gan_train"]
    z = torch.randn((b, cfg.z_dim), generator=gen).to(dev)
    real = torch.rand((b, *gan.generator_plans(cfg)[-1].out_hw, 3),
                      generator=gen).to(dev) * 2 - 1

    def losses(g_, d_, dist_):
        fake = gan.generator_apply(g_, z, cfg, dist=dist_)
        d_fake = gan.discriminator_apply(d_, fake, cfg, dist=dist_)
        d_real = gan.discriminator_apply(d_, real, cfg, dist=dist_)
        return (gan.softplus(-d_fake).mean()
                + (gan.softplus(-d_real) + gan.softplus(d_fake)).mean())
    rows = {k: v for k, v in {**gp, **dp}.items()
            if isinstance(v, plan_mod.RowSuperpack)}

    def block_grads():
        """(loss, each row block's gradient) of a mesh step."""
        leaves = {k: v.block.detach().requires_grad_()
                  for k, v in rows.items()}
        g_ = {k: (dataclasses.replace(gp[k], block=leaves[k])
                  if k in leaves else v) for k, v in gp.items()}
        d_ = {k: (dataclasses.replace(dp[k], block=leaves[k])
                  if k in leaves else v) for k, v in dp.items()}
        loss_ = losses(g_, d_, dist)
        loss_.backward()
        return float(loss_), {k: t.grad for k, t in leaves.items()}
    signs, one_signs = [], []
    zero_counts()
    undo = _mr_site_signs(signs)
    try:
        loss, grads = block_grads()
    finally:
        undo()
    counts, _ = read_counts("float32")
    wl = {k: v.clone().requires_grad_() for k, v in {**gw, **dw}.items()
          if k in rows}
    undo = _mr_site_signs(one_signs)
    try:
        loss1 = losses({**gw, **{k: wl[k] for k in gw if k in wl}},
                       {**dw, **{k: wl[k] for k in dw if k in wl}}, None)
    finally:
        undo()
    loss1.backward()
    loss64, g64 = _mr_gan_f64(gw, dw, z, real, cfg, signs)
    _, g64_one = _mr_gan_f64(gw, dw, z, real, cfg, one_signs)
    _, g64_own = _mr_gan_f64(gw, dw, z, real, cfg)
    # planted: rank 1 leaves a row-parallel site's input gradient unsummed
    undo = _mr_skip_all_reduce("rows_input_bwd", rank)
    try:
        _, bad = block_grads()
    finally:
        undo()

    def worst(ref_, g_):
        return max(_mesh_rel(ref_[k][slice(*rows[k].rows)], g_[k])
                   for k in rows)
    one = {k: wl[k].grad for k in rows}
    out.append({"model": "dcgan_train", "batch": b, "rank": rank,
                "launches": counts,
                "loss_rel": abs(loss - loss64) / abs(loss64),
                "grad_rel": worst(g64, grads), "one_rank_rel": max(
                    _mesh_rel(g64_one[k], one[k]) for k in rows),
                "vs_one_rank": worst(one, grads),
                "vs_own_f64": worst(g64_own, grads),
                "one_vs_own_f64": max(_mesh_rel(g64_own[k], one[k])
                                      for k in rows),
                "sign_flips": sum(int((a != b).sum()) for a, b in
                                  zip(signs, one_signs)),
                "grad_rel_by_site": {k: _mesh_rel(
                    g64[k][slice(*rows[k].rows)], grads[k]) for k in rows},
                "planted_grad_rel": worst(g64, bad)})
    return out


def _mr_skip_all_reduce(kind, rank, ranks=(1,)):
    """The ranks ``ranks`` leave the all-reduces of ``kind`` unsummed (the
    collective still runs, so no rank waits); returns the undo."""
    from repro_torch.core import comm
    orig = comm.all_reduce

    def all_reduce(t, group, kind="all_reduce", op="sum", skip=kind):
        y = orig(t, group, kind, op)
        return t if rank in ranks and kind == skip else y
    comm.all_reduce = all_reduce
    return lambda: setattr(comm, "all_reduce", orig)


def _mr_moe_capture(records):
    """``moe.moe_apply`` as it is, each call's (x, output) kept."""
    from repro_torch.layers import moe

    def wrap(orig):
        def f(p, x, cfg, dist=None):
            y = orig(p, x, cfg, dist)
            records.append((x, y))
            return y
        return f
    return _pp_patch(moe, "moe_apply", wrap)


def _mr_dbrx(rank, dev, conf):
    """dbrx-132b, 1 layer, on its own ``moe_impl="ep"`` on (2, 2) with
    'expert' on 'model' and 'expert_ffn' on 'data' (the production mesh's
    rule for it): the MoE layer against JAX's EP semantics on its own
    inputs (``_mesh_ep_ref``: a data rank's rows, the capacity of their
    token count), the one-rank references under the same semantics."""
    import gc

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_dist, make_prefill_step,
                                          make_serve_step)
    from repro_torch.layers import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import DistContext
    (pb, ps), n_dec, ts = conf["dbrx"]
    cfg = _mr_cfg(conf, "dbrx-132b", 1, moe_impl="ep")    # the reduced
    mesh = make_host_mesh(2, 2)                           # config's dense
    n_data = mesh.shape[0]

    def ep_semantics():
        """The one-rank model's MoE as the mesh's: each data rank's rows
        routed apart with their capacity; returns the undo."""
        return _pp_patch(moe, "moe_apply", lambda orig: (
            lambda p, x, cfg_, dist=None: _mesh_ep_ref(p, x, cfg_, n_data)))

    def rules_for(shape):
        return DistContext(mesh, rules=dict(
            make_dist(mesh, cfg, shape).rules, expert="model",
            expert_ffn="data"))
    dist = rules_for(ShapeConfig("p", "prefill", ps, pb))
    params, whole = _mr_params(cfg, dist, dev)
    g = torch.Generator().manual_seed(72)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (pb, ps),
                                     generator=g).to(dev)}
    step = make_prefill_step(cfg, dist, kv_chunk=MR_KV_CHUNK)
    recs = []
    undo = _mr_moe_capture(recs)
    try:
        fa.flash_attention.launches = 0
        logits = step(params, batch)
        f_launches = fa.flash_attention.launches
    finally:
        undo()
    x, y = recs[0]
    rec = {"rank": rank, "moe_impl": cfg.moe_impl, "rules": {
        k: dist.rules[k] for k in ("batch", "expert", "expert_ffn")},
        "f_launches": f_launches, "tokens": tuple(x.shape[:2]),
        "capacity": moe._capacity(x.shape[0] * x.shape[1], cfg),
        "block_bytes": sum(params["layers"][0]["moe"][k].numel() * 2
                           for k in ("wi", "wg", "wo"))}
    bad_recs = []
    undo = _mr_moe_capture(bad_recs)
    undo2 = _pp_patch(comm, "gather_from", _mr_gather_fault(
        "expert_ffn_gather", n=2))
    try:
        step(params, batch)
    finally:
        undo2()
        undo()
    single = None
    if whole is not None:
        wm = whole["layers"][0]["moe"]
        with torch.no_grad():
            ref = _mesh_ep_ref(wm, x, cfg, 1)
        rec["moe_rel"] = _mesh_rel(ref, y)
        rec["moe_planted_rel"] = _mesh_rel(ref, bad_recs[0][1])
        one = make_prefill_step(cfg, kv_chunk=MR_KV_CHUNK)
        undo = ep_semantics()
        try:
            with torch.no_grad():
                rec["prefill_rel"] = _ms_logits_rel(one(whole, batch),
                                                    logits, cfg)
        finally:
            undo()

        def single():
            return one(whole, batch)
    del recs, bad_recs, logits
    rec["measure"] = _mr_measure(lambda: step(params, batch), dev, single)
    # ---- decode: the MoE on its mesh path at each step --------------------
    ddist = rules_for(ShapeConfig("d", "decode", 64, pb))
    dparams, _ = _mr_params(cfg, ddist, dev)
    blocks = tfm.init_cache(cfg, pb, 64, device=dev, dist=ddist)
    serve = make_serve_step(cfg, ddist)
    tok = batch["inputs"][:, :1]
    rec["decode_moe_rel"] = []
    for j in range(n_dec):
        recs = []
        undo = _mr_moe_capture(recs)
        try:
            tok, blocks = serve(dparams, blocks, tok, j)
        finally:
            undo()
        if whole is not None:
            with torch.no_grad():
                rec["decode_moe_rel"].append(_mesh_rel(
                    _mesh_ep_ref(wm, recs[0][0], cfg, 1), recs[0][1]))
    del dparams, blocks
    # ---- one Adafactor step (on the prefill's blocks: the train rules
    # are the prefill's; rank 0's whole params go first) -------------------
    from repro_torch.launch import steps as steps_lib
    from repro_torch.train import optim
    tbatch = _mt_batch(cfg, pb, ts, dev)
    one_loss = None
    if whole is not None:
        undo = ep_semantics()
        try:
            with torch.no_grad():
                one_loss = float(tfm.loss_fn(whole, tbatch, cfg,
                                             kv_chunk=MR_KV_CHUNK))
        finally:
            undo()
    # rank 0's whole params (and what holds them) go before the step
    whole = wm = single = one = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ocfg = optim.OptConfig(**MR_ADAFACTOR)
    state = {"params": params, "opt": optim.OPTIMIZERS[ocfg.name][0](
        params, ocfg, stacks=tfm.param_stacks(cfg, params),
        specs=tfm.specs(cfg), dist=dist, shapes=tfm.param_shapes(cfg)),
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    tstep = steps_lib.make_train_step(cfg, ocfg, kv_chunk=MR_KV_CHUNK,
                                      dist=dist)
    comm.traffic_reset()
    new, m = tstep(state, tbatch)
    rec["train"] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                    "reduce_scattered": "expert_ffn_gather_bwd"
                    in comm.traffic(), "one_loss": one_loss}
    del new, state
    return rec


def _mr_llama(rank, dev, conf):
    """llama3.2-1b under ``make_dist(..., seq_parallel=True)`` on (2, 2):
    the prefill at full depth, a train step at ``MR_LLAMA[1]`` layers."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist, make_prefill_step
    from repro_torch.models import transformer as tfm
    (pb, ps), layers = conf["llama"]
    cfg = _mr_cfg(conf, "llama3.2-1b")
    mesh = make_host_mesh(2, 2)
    dist = make_dist(mesh, cfg, ShapeConfig("p", "prefill", ps, pb),
                     seq_parallel=True)
    params, whole = _mr_params(cfg, dist, dev)
    g = torch.Generator().manual_seed(73)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (pb, ps),
                                     generator=g).to(dev)}
    step = make_prefill_step(cfg, dist, kv_chunk=MR_KV_CHUNK)
    seen = []
    orig = tfm.apply_layer

    def keep(p, x, *a, **kw):
        seen.append(tuple(x.shape))
        return orig(p, x, *a, **kw)
    tfm.apply_layer = keep
    try:
        fa.flash_attention.launches = 0
        logits = step(params, batch)
        f_launches = fa.flash_attention.launches
    finally:
        tfm.apply_layer = orig
    d = cfg.d_model
    rec = {"rank": rank, "rules": {k: dist.rules[k] for k in (
        "batch", "heads", "seq")}, "f_launches": f_launches,
        "stream": seen[0], "stream_share": (seen[0][0] * seen[0][1] * d)
        / (pb * ps * d)}
    undo = _pp_patch(comm, "reduce_scatter_to", _mr_slice_fault(rank))
    try:
        bad = step(params, batch)
    finally:
        undo()
    single = None
    if whole is not None:
        one = make_prefill_step(cfg, kv_chunk=MR_KV_CHUNK)
        with torch.no_grad():
            ref = one(whole, batch)
        rec["prefill_rel"] = _ms_logits_rel(ref, logits, cfg)
        rec["planted_rel"] = _ms_logits_rel(ref, bad, cfg)

        def single():
            return one(whole, batch)
    del logits, bad
    rec["measure"] = _mr_measure(lambda: step(params, batch), dev, single)
    del whole, params, single
    # ---- the train step at a cut depth -----------------------------------
    tcfg = cut_depth(cfg, layers)
    tdist = make_dist(mesh, tcfg, ShapeConfig("t", "train", ps, pb),
                      seq_parallel=True)
    tbatch = _mt_batch(tcfg, pb, ps, dev)
    # planted: every rank keeps its own S rows' part of the gradients of
    # the parameters read on them (the norm gains), unsummed
    rec["train"], (tstep, state0, _) = _mr_train(
        tcfg, tdist, dev, MR_ADAMW, tbatch, 1, planted=(
            "the norm gains' gradients unsummed over S", lambda:
            _mr_skip_all_reduce("sp_param_bwd", rank, range(MR_WORLD))))
    rec["train_measure"] = _mr_measure(lambda: tstep(state0, tbatch), dev)
    del state0
    return rec


def _mr_slice_fault(rank):
    """Rank 1 keeps its slice of its own partial where S is
    reduce-scattered (the collective still runs)."""
    import torch

    def wrap(orig):
        def rs(x, group, dim=1, kind="reduce_scatter_to"):
            y = orig(x, group, dim, kind)
            if rank != 1 or kind != "sp_reduce_scatter":
                return y
            i = torch.distributed.get_rank(group)
            return x.narrow(dim, i * y.shape[dim], y.shape[dim]).to(y.dtype)
        return rs
    return wrap


def _mr_s2t(rank, dev, conf):
    """seamless-m4t-large-v2, ``MR_S2T[0]`` + ``MR_S2T[0]`` layers: a
    train step on (2, 2) under ``make_dist``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist
    layers, b, s, src = conf["s2t"]
    cfg = _mr_cfg(conf, "seamless-m4t-large-v2", layers)
    dist = make_dist(make_host_mesh(2, 2), cfg,
                     ShapeConfig("t", "train", s, b))
    batch = _mt_batch(cfg, b, s, dev)
    batch["src_embeds"] = torch.randn(
        (b, src, cfg.d_model), generator=torch.Generator().manual_seed(74)
    ).to(dev, torch.bfloat16)
    rec = {"rank": rank, "rules": {k: dist.rules[k] for k in (
        "batch", "heads")}}
    # planted: every rank keeps its own heads' part of the gradient of the
    # encoder's memory that the cross layers read, unsummed
    rec["train"], (tstep, state0, _) = _mr_train(
        cfg, dist, dev, MR_ADAMW, batch, 1, planted=(
            "the memory's gradient unsummed over the heads", lambda:
            _mr_skip_all_reduce("cross_memory_bwd", rank, range(MR_WORLD))))
    rec["measure"] = _mr_measure(lambda: tstep(state0, batch), dev)
    del state0
    return rec


def _mr_mamba(rank, dev, conf):
    """mamba2-130m under ``DEFAULT_RULES`` on (2, 2) (the batch of one
    replicated, as ``make_dist`` does): the in-projection, conv and norm
    gathered over 'model', ``out`` row-parallel."""
    import torch
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    (pb, ps), n_dec = conf["mamba"]
    cfg = _mr_cfg(conf, "mamba2-130m")
    dist = DistContext(make_host_mesh(2, 2), rules=dict(DEFAULT_RULES,
                                                        batch=None))
    params, whole = _mr_params(cfg, dist, dev)
    g = torch.Generator().manual_seed(75)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (pb, ps),
                                     generator=g).to(dev)}
    step = make_prefill_step(cfg, dist, kv_chunk=MR_KV_CHUNK)
    logits = step(params, batch)
    undo = _pp_patch(comm, "gather_from", _mr_gather_fault(
        "ssd_in_gather", n=2))
    try:
        bad = step(params, batch)
    finally:
        undo()
    rec = {"rank": rank, "in_block": tuple(
        params["layers"][0]["ssd"]["in"].shape)}
    single = None
    if whole is not None:
        one = make_prefill_step(cfg, kv_chunk=MR_KV_CHUNK)
        with torch.no_grad():
            ref = one(whole, batch)
        rec["prefill_rel"] = _ms_logits_rel(ref, logits, cfg)
        rec["planted_rel"] = _ms_logits_rel(ref, bad, cfg)

        def single():
            return one(whole, batch)
    rec["measure"] = _mr_measure(lambda: step(params, batch), dev, single)
    blocks = tfm.init_cache(cfg, pb, 16, device=dev, dist=dist)
    wcache = tfm.init_cache(cfg, pb, 16, device=dev) if whole else None
    serve = make_serve_step(cfg, dist)
    tok = batch["inputs"][:, :1]
    rec["decode_rel"] = []
    for j in range(n_dec):
        kept = {}
        orig = tfm.decode_step

        def keep(*a, **kw):
            out = orig(*a, **kw)
            kept["logits"] = out[0]
            return out
        tfm.decode_step = keep
        try:
            nxt, blocks = serve(params, blocks, tok, j)
        finally:
            tfm.decode_step = orig
        if whole is not None:
            with torch.no_grad():
                ref, wcache = tfm.decode_step(whole, wcache, tok, j, cfg)
            rec["decode_rel"].append(_ms_logits_rel(ref, kept["logits"],
                                                    cfg))
        tok = nxt
    return rec


MR_CASES = ("dbrx", "rg", "gan", "llama", "s2t", "mamba")


def _mr_rank(rank, world, dev, conf):
    """One rank of phases 3r/4p (all ranks share the card)."""
    import gc

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    fns = {"rg": _mr_rg, "gan": _mr_gan, "dbrx": _mr_dbrx,
           "llama": _mr_llama, "s2t": _mr_s2t, "mamba": _mr_mamba}
    out = {}
    for name in conf["cases"]:
        t0 = time.perf_counter()
        out[name] = fns[name](rank, dev, conf)
        out[name + "_s"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mr_print_measure(tag, name, r, smi):
    m = r.get("measure") or r.get("train_measure")
    if m is None:
        return
    single = ("" if m.get("single_ms") is None else
              f", one rank {m['single_ms']:.3f} ms, device "
              f"{ms_text(m['single_device_ms'])} ms")
    print(f"[4p] {name} rank {r['rank']} {tag}: {m['ms']:.3f} ms (events), "
          f"device {ms_text(m['device_ms'])} ms{single}; peak "
          f"{m['peak_bytes']} bytes ({m['base_bytes']} before) | {smi}")
    print(f"[4p] {name} rank {r['rank']} {tag} collectives (calls, bytes): "
          + ", ".join(f"{k} {v['calls']} / {v['bytes']}"
                      for k, v in m["collectives"].items()))


def _mr_train_gates(name, tr, failed):
    """The mesh steps' losses, gnorms and first update against the
    one-rank steps (rank 0's record)."""
    for i, (a, b_) in enumerate(zip(tr["losses"], tr["one_losses"])):
        rel = abs(a - b_) / abs(b_)
        g = abs(tr["gnorms"][i] - tr["one_gnorms"][i]) / tr["one_gnorms"][i]
        print(f"[3r] {name} train step {i}: loss {a:.6f} vs one rank "
              f"{b_:.6f} (rel {rel:.2e}, limit {TOL_MT_LOSS:.0e}), gnorm "
              f"{tr['gnorms'][i]:.4f} vs {tr['one_gnorms'][i]:.4f} (rel "
              f"{g:.2e}, limit {TOL_MT_GNORM:.0e})")
        if rel > TOL_MT_LOSS or g > TOL_MT_GNORM:
            failed.append(f"{name} train step {i}")
    print(f"[3r] {name} first step's AdamW first moment vs the one-rank "
          f"step's, worst leaf {tr['update_rel']:.2e} (limit "
          f"{TOL_MT_UPDATE:.0e})")
    if tr["update_rel"] > TOL_MT_UPDATE:
        failed.append(f"{name} update")
    if "planted_update_rel" in tr:
        print(f"[3r] {name} planted ({tr['planted']}): the first moment's "
              f"worst leaf {tr['planted_update_rel']:.2e}")
        if not tr["planted_update_rel"] > TOL_MT_UPDATE:
            failed.append(f"{name} planted")


def mesh_rest_phases(dev, smi):
    """Phases 3r and 4p: the mesh rules of the rest of ROADMAP item 13c,
    over ``MR_WORLD`` ranks that share the card on a gloo group, at full
    width, the one-rank references on rank 0 in the same run:
    recurrentgemma-2b on (1, 4) cut to one (rec, rec, local) group, its
    q cut at 2.5 heads a rank (prefill, greedy steps, AdamW steps;
    planted: the cut head's gather without its cotangent sum); the DCGAN
    and cGAN generators and discriminators with 'conv_taps' on 'model'
    (kernels A and B, f32 and int8, on each rank's rows: each row-block
    launch against its plain version on the card, also on a block fenced
    by NaN rows, planted: the plain version one row off; the sites
    against the f64 oracle; a DCGAN train step's block gradients against
    an f64 step; planted: one rank's partial left out); dbrx-132b at one
    layer on its EP MoE with 'expert_ffn' on 'data' (the MoE layer on its
    own inputs at prefill and decode against JAX's EP semantics, an
    Adafactor step; planted: the hidden blocks' gather skipped);
    llama3.2-1b under ``seq_parallel=True`` (the prefill at full depth, a
    train step at ``MR_LLAMA[1]`` layers, the residual a rank a quarter
    of one rank's; planted: a reduce-scatter replaced by a slice, and in
    the train step the norm gains' gradients unsummed);
    seamless-m4t-large-v2 training (planted: the cross layers' memory
    gradient unsummed); mamba2-130m
    under ``DEFAULT_RULES`` (planted: the in-projection's gather
    skipped).  4p: each case's step ms and device ms beside the one-rank
    step's, its collectives, peak memory.  Returns (records, {kernel:
    {path: launches}})."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_spmd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    conf = {"configs": MR_CONFIGS, "cases": MR_CASES, "rg": MR_RG,
            "gan_batches": MR_GAN_BATCHES, "gan_train": MR_GAN_TRAIN,
            "dbrx": MR_DBRX, "llama": MR_LLAMA, "s2t": MR_S2T,
            "mamba": MR_MAMBA}
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = run_spmd(_mr_rank, MR_WORLD, conf, device=dev.type,
                         timeout=900)
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    wall = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    failed = []
    paths = {"A": {}, "B": {}, "A_int8": {}, "B_int8": {}, "F": {}}
    lim = TOL_MS_LOGITS
    # ---- recurrentgemma-2b: a cut head ------------------------------------
    if "rg" in ranks[0]:
        r0 = ranks[0]["rg"]
        print(f"[3r] recurrentgemma-2b on (1, 4) {r0['kinds']}: rules "
              f"{r0['rules']}; {ranks[0]['rg_s']:.1f} s")
        for r in (x["rg"] for x in ranks):
            fg = r["f_gate"]
            print(f"[3r] rg prefill rank {r['rank']}: F launches "
                  f"{r['f_launches']} on (sq, heads) {r['f_heads']} (a cut "
                  f"head computed whole on two ranks), F vs plain worst share "
                  f"{fg['worst_share']:.3f} (planted x{F_FAULT}: least "
                  f"{fg['planted_least_share']:.2f})")
            if cuda and r["f_launches"] != 1:
                failed.append(f"rg rank {r['rank']} F launches")
            _mr_print_measure("prefill", "rg", r, smi)
        paths["F"]["mesh_rest_rg_prefill"] = sum(x["rg"]["f_launches"]
                                                 for x in ranks)
        print(f"[3r] rg prefill logits vs one rank: {r0['prefill_rel']:.2e}; "
              f"greedy steps {', '.join(f'{e:.2e}' for e in r0['decode_rel'])} "
              f"(limit {lim:.0e})")
        if r0["prefill_rel"] > lim or max(r0["decode_rel"]) > lim:
            failed.append("rg logits")
        _mr_train_gates("rg", r0["train"], failed)
        print(f"[3r] rg local layer's q gradient (rank 0's block, a cut head "
              f"in it) vs the one-rank gradient: {r0['qgrad_rel']:.2e} (limit "
              f"{TOL_MR_GRAD:.0e}); the cut head's gather without its cotangent "
              f"sum {r0['planted_qgrad_rel']:.2e}")
        if r0["qgrad_rel"] > TOL_MR_GRAD or \
                not r0["planted_qgrad_rel"] > TOL_MR_GRAD:
            failed.append("rg q gradient")
    # ---- GANs: row-parallel superpacks on kernels A and B ---------------
    if "gan" in ranks[0]:
        for recs in zip(*(x["gan"] for x in ranks)):
            r0 = recs[0]
            if r0["model"] == "dcgan_train":
                for r in recs:
                    print(f"[3r] DCGAN train step B={r0['batch']} rank "
                          f"{r['rank']}: loss vs the f64 step "
                          f"{r['loss_rel']:.2e} (limit {TOL_LOSS:.0e}), "
                          f"block gradients vs the f64 step on the mesh "
                          f"step's ReLU signs {r['grad_rel']:.2e} (limit "
                          f"{TOL_GRAD:.0e}; by site "
                          + json.dumps({k: float(f"{v:.3e}") for k, v in
                                        r["grad_rel_by_site"].items()})
                          + f"); one rank's f32 step vs the f64 step on its "
                          f"signs {r['one_rank_rel']:.2e}; on the f64 step's "
                          f"own signs: mesh {r['vs_own_f64']:.2e}, one rank "
                          f"{r['one_vs_own_f64']:.2e}; mesh vs one rank "
                          f"{r['vs_one_rank']:.2e} ({r['sign_flips']} ReLU "
                          f"signs differ between them); launches "
                          f"{r['launches']}")
                    if r["loss_rel"] > TOL_LOSS or \
                            r["grad_rel"] > TOL_GRAD:
                        failed.append(f"DCGAN train rank {r['rank']}")
                planted = max(r["planted_grad_rel"] for r in recs)
                print(f"[3r] DCGAN train planted: rank 1's row-parallel "
                      f"input gradients unsummed: block gradients "
                      f"{planted:.2e}")
                if not planted > TOL_GRAD:
                    failed.append("DCGAN train planted")
                paths["A"]["mesh_rest_dcgan_train"] = sum(
                    r["launches"]["A"] for r in recs)
                paths["B"]["mesh_rest_dcgan_train"] = sum(
                    r["launches"]["B"] for r in recs)
                continue
            tag = f"{r0['model']} {r0['wdtype']} B={r0['batch']}"
            key = "" if r0["wdtype"] == "float32" else "_int8"
            for r in recs:
                print(f"[3r] {tag} rank {r['rank']}: launches {r['launches']}; "
                      f"{r['row_launches']} row-block launches (counted "
                      f"{r['rows_counted']}) vs their "
                      f"plain versions on the card, worst {r['rows_rel']:.2e}"
                      f" (limit {TOL_MR_ROWS:.0e}; planted, r0 one row off: "
                      f"least {r['rows_planted']:.2e}), on blocks fenced by "
                      f"NaN rows {r['rows_fenced']:.2e}; output vs one rank "
                      f"{r['rel']:.2e} (limit {TOL_MESH_IMG:.0e})"
                      + ("" if r["rank"] else f"; sites vs the f64 oracle: "
                         f"worst {r0['ulp_share']:.3f} of ulp_bound"))
                rows_ok = (r["rows_rel"] <= TOL_MR_ROWS
                           and r["rows_fenced"] <= TOL_MR_ROWS
                           and r["rows_planted"] > TOL_MR_ROWS
                           and (not cuda or r["row_launches"]
                                == r["rows_counted"] > 0))
                if not rows_ok or r["rel"] > TOL_MESH_IMG:
                    failed.append(f"{tag} rank {r['rank']}")
                if r["other_dtype_launches"]:
                    failed.append(f"{tag} rank {r['rank']} other dtype")
                _mr_print_measure("generator", tag, r, smi)
            if r0["ulp_share"] > 1.0:
                failed.append(f"{tag} ulp")
            if "planted_rel" in r0:
                planted = max(r["planted_rel"] for r in recs)
                print(f"[3r] {tag} planted: rank 1's row-block partial left "
                      f"out: {planted:.2e}")
                if not planted > TOL_MESH_IMG:
                    failed.append(f"{tag} planted")
            name = f"mesh_rest_{r0['model']}_{r0['wdtype']}_B{r0['batch']}"
            paths["A" + key][name] = sum(r["launches"]["A"] for r in recs)
            paths["B" + key][name] = sum(r["launches"]["B"] for r in recs)
    # ---- dbrx: the expert hidden dim ---------------------------------------
    if "dbrx" in ranks[0]:
        r0 = ranks[0]["dbrx"]
        print(f"[3r] dbrx-132b, 1 layer, moe_impl {r0['moe_impl']!r} on "
              f"(2, 2): rules {r0['rules']}, expert blocks "
              f"{r0['block_bytes']} bytes a rank; {r0['tokens']} tokens a "
              f"data rank at prefill, capacity {r0['capacity']} an expert; "
              f"{ranks[0]['dbrx_s']:.1f} s")
        print(f"[3r] dbrx MoE layer on its own inputs vs JAX's EP semantics "
              f"(_mesh_ep_ref): prefill "
              f"{r0['moe_rel']:.2e}, greedy steps "
              f"{', '.join(f'{e:.2e}' for e in r0['decode_moe_rel'])} (limit "
              f"{TOL_MESH_MOE:.0e}); the hidden blocks' gather skipped "
              f"{r0['moe_planted_rel']:.2e}; prefill logits vs one rank "
              f"{r0['prefill_rel']:.2e} (under the same EP semantics; "
              f"reported: bf16 rounding can flip an expert choice there)")
        if max([r0["moe_rel"]] + r0["decode_moe_rel"]) > TOL_MESH_MOE or \
                not r0["moe_planted_rel"] > TOL_MESH_MOE:
            failed.append("dbrx MoE")
        tr = r0["train"]
        rel = abs(tr["loss"] - tr["one_loss"]) / abs(tr["one_loss"])
        print(f"[3r] dbrx Adafactor step: loss {tr['loss']:.6f} vs one-rank "
              f"forward under the EP semantics {tr['one_loss']:.6f} (rel "
              f"{rel:.2e}, limit "
              f"{TOL_MT_LOSS:.0e}), gnorm {tr['gnorm']:.4f}, hidden gradients "
              f"reduce-scattered {tr['reduce_scattered']}")
        if rel > TOL_MT_LOSS or not tr["reduce_scattered"] or \
                not math.isfinite(tr["gnorm"]):
            failed.append("dbrx train")
        for r in (x["dbrx"] for x in ranks):
            _mr_print_measure("prefill", "dbrx", r, smi)
        paths["F"]["mesh_rest_dbrx_prefill"] = sum(x["dbrx"]["f_launches"]
                                                   for x in ranks)
    # ---- llama3.2-1b: sequence parallelism --------------------------------
    if "llama" in ranks[0]:
        r0 = ranks[0]["llama"]
        print(f"[3r] llama3.2-1b SP on (2, 2): rules {r0['rules']}; residual a "
              f"rank {r0['stream']} = {r0['stream_share']:.4f} of one rank's; "
              f"prefill logits vs one rank {r0['prefill_rel']:.2e} (limit "
              f"{lim:.0e}), a reduce-scatter replaced by a slice "
              f"{r0['planted_rel']:.2e}; {ranks[0]['llama_s']:.1f} s")
        if r0["prefill_rel"] > lim or not r0["planted_rel"] > lim or \
                abs(r0["stream_share"] - 0.25) > 1e-9:
            failed.append("llama SP prefill")
        for r in (x["llama"] for x in ranks):
            if cuda and r["f_launches"] != 16:
                failed.append(f"llama rank {r['rank']} F launches")
            _mr_print_measure("prefill", "llama", r, smi)
            m = r["train_measure"]
            print(f"[4p] llama SP train step rank {r['rank']}: {m['ms']:.3f} ms"
                  f" (events), device {ms_text(m['device_ms'])} ms; peak "
                  f"{m['peak_bytes']} bytes | {smi}")
        paths["F"]["mesh_rest_llama_prefill"] = sum(x["llama"]["f_launches"]
                                                    for x in ranks)
        _mr_train_gates("llama SP", r0["train"], failed)
    # ---- seamless: training the dec kind ------------------------------------
    if "s2t" in ranks[0]:
        r0 = ranks[0]["s2t"]
        print(f"[3r] seamless-m4t-large-v2 {MR_S2T[0]} + {MR_S2T[0]} layers on "
              f"(2, 2): rules {r0['rules']}; {ranks[0]['s2t_s']:.1f} s")
        _mr_train_gates("seamless", r0["train"], failed)
        for r in (x["s2t"] for x in ranks):
            _mr_print_measure("train step", "seamless", r, smi)
    # ---- mamba2: ssd tensor-parallel ----------------------------------------
    if "mamba" in ranks[0]:
        r0 = ranks[0]["mamba"]
        print(f"[3r] mamba2-130m on (2, 2) under DEFAULT_RULES: in-projection "
              f"block {r0['in_block']}; prefill logits vs one rank "
              f"{r0['prefill_rel']:.2e}, greedy steps "
              f"{', '.join(f'{e:.2e}' for e in r0['decode_rel'])} (limit "
              f"{lim:.0e}); the in-projection's gather skipped "
              f"{r0['planted_rel']:.2e}; {ranks[0]['mamba_s']:.1f} s")
        if r0["prefill_rel"] > lim or max(r0["decode_rel"]) > lim or \
                not r0["planted_rel"] > lim:
            failed.append("mamba")
        for r in (x["mamba"] for x in ranks):
            _mr_print_measure("prefill", "mamba", r, smi)
    print(f"[3r] mesh rest phase: {wall:.1f} s over {MR_WORLD} ranks, "
          f"launches {json.dumps(paths)}")
    if failed:
        raise RuntimeError(f"mesh rest gates failed: {failed}")
    return {"mesh_rest": {"ranks": ranks, "seconds": wall}}, paths


# ---------------------------------------------------------------------------
# phases 3t / 4q: the last superpack splits
# ---------------------------------------------------------------------------

MX_WORLD = 4
MX_CONFIGS = "full"           # "reduced": the CPU rehearsal's configs
MX_UNET_B = 1                 # the 512 px U-Net's batch: C and D at B = 1
MX_GAN_BATCHES = (64, 1)
# (case, its rule set): the U-Net's rows on 'model' over (1, 4), and its
# rows and out-channels together over (2, 2) with neither axis on the
# batch (the rank's row block of its column block through C and D's rows
# entries on the local plan at N/2); its superpack rows on 'sp_h' and then
# its out-channels on 'sp_w' of a bound (2, 2) spatial mesh; the DCGAN on
# (2, 2) with one split on the batch axis
MX_UNET_RULES = {
    "rows": ((1, 4), dict(conv_taps="model", conv_out=None),
             ("float32", "int8")),
    "rows_cols": ((2, 2), dict(conv_taps="data", conv_out="model",
                               batch=()), ("float32",))}
MX_GAN_RULES = {"taps_data_out_model": dict(conv_taps="data",
                                            conv_out="model"),
                "taps_model_out_data": dict(conv_taps="model",
                                            conv_out="data")}
MX_PLANE_RULES = {"rows_sp_h": dict(conv_taps="sp_h", conv_out=None),
                  "cols_sp_w": dict(conv_taps=None, conv_out="sp_w")}
MX_CASES = ("unet", "plane", "gan")
# the CPU rehearsal's cuts: the U-Net's widths, the reference's
# tiled-verdict budget and the plane-parallel floor at which a small image
# tiles and splits as the 512 px one does; none on the card
MX_UNET_KW: dict = {}
MX_REF_BUDGET = None
MX_SPATIAL_MIN = None


def _mx_unet_cfg(conf, wd, spatial=(1, 1)):
    from repro_torch.models import unet
    return unet.UNetConfig("unet-512", image_hw=conf["unet_hw"],
                           backend="cuda", wdtype=wd, spatial=spatial,
                           **conf["unet_kw"])


def _mx_tiled_sites(cfg, b):
    """The sites whose route at batch ``b`` carries ``sp_tiles`` (kernel C
    or D), by name; asserts the 512 px verdict: C at the stem, down0,
    fuse0 and the head, D at up0."""
    from repro_torch.models import unet
    out = {n: ("D" if p.spec.kind == "transposed" else "C")
           for n, p in unet.unet_plans(cfg).items()
           if p.route_for_batch(b).sp_tiles is not None}
    if out != {"stem": "C", "down0": "C", "fuse0": "C", "head": "C",
               "up0": "D"}:
        raise RuntimeError(f"the U-Net's tiled sites at B = {b}: {out}")
    return out


def _mx_dsm(p, x0, t, noise, cfg, dist=None):
    """The U-Net's DSM loss at given ``t`` and ``noise`` (``unet_loss``'s
    arithmetic) under ``dist``."""
    import torch
    from repro_torch.models import unet
    ab = unet.alpha_bar(t)[:, None, None, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise
    eps = unet.unet_apply(p, x_t, t, cfg, dist=dist)
    return torch.mean(torch.square(eps - noise))


def _mx_block_leaf(p, key):
    """``p`` with the block of ``key`` (its dense buffer or an int8
    block's scale rows) a fresh leaf that requires grad; (params, leaf)."""
    from repro_torch.core.plan import QuantizedSuperpack, map_block
    leaf = []

    def fresh(v):
        if isinstance(v, QuantizedSuperpack):
            return QuantizedSuperpack(v.q, fresh(v.scale))
        leaf.append(v.detach().clone().requires_grad_())
        return leaf[0]
    return {**p, key: map_block(p[key], fresh)}, leaf[0]


def _mx_rows_f64(sites, records):
    """Each C and D row-block launch of ``records`` (one a row-parallel
    site of ``sites``, in call order) against the f64 oracle of its
    partial (the site's conv with the block in its rows of an otherwise
    zero superpack): the worst share of ``ulp_bound``."""
    from repro_torch.core.plan import QuantizedSuperpack
    from repro_torch.kernels.untangled_conv import embed_rows
    worst = 0.0
    for (plan, x, packed, _, _), (_, _, _, kw, y) in zip(sites, records):
        if kw.get("sp_tiles") is None:
            continue
        blk = packed.block
        if isinstance(blk, QuantizedSuperpack):
            blk = blk.dequant()
        whole, _ = embed_rows(blk, None, packed.rows, packed.total)
        y64, bound = f64_bound(plan, x, plan.unpack(whole))
        worst = max(worst, float(((y.double() - y64).abs() / bound).max()))
        del y64, bound
    return worst


def _mx_row_times(records, dev):
    """4q: each C and D row-block launch of ``records`` timed beside the
    whole superpack's launch at its site (CUDA events, and device ms from
    one trace), on the same plane."""
    import torch
    out = []
    for entry, plain, (x, blk), kw, y in records:
        if kw.get("sp_tiles") is None:
            continue
        r0, r1 = kw["rows"]
        taps = (sum(ex.taps[0] * ex.taps[1] for ex in kw["phases"])
                if "phases" in kw else kw["taps_hw"][0] * kw["taps_hw"][1])
        total = taps * x.shape[3]
        whole = torch.zeros((total, blk.shape[1]), dtype=blk.dtype,
                            device=blk.device)
        whole[r0:r1] = blk
        wkw = dict(kw, rows=None)
        sc = kw.get("scales")
        if sc is not None:
            ws = torch.ones((total, 1), device=sc.device)
            ws[r0:r1] = sc
            wkw["scales"] = ws

        def row():
            return entry(x, blk, **kw)

        def full():
            return entry(x, whole, **wkw)
        out.append({"kernel": "D" if "phases" in kw else "C",
                    "int8": sc is not None, "rows": [r0, r1, total],
                    "ms": _pp_ms(row, dev, iters=10, warmup=2),
                    "whole_ms": _pp_ms(full, dev, iters=10, warmup=2),
                    "device_ms": _pp_device_ms(row, dev),
                    "whole_device_ms": _pp_device_ms(full, dev)})
    return out


def _mx_split_kind(v):
    """How a placed superpack is split: 'rows', 'cols', 'rows+cols', or
    None where it stays whole."""
    from repro_torch.core.plan import RowSuperpack, TPSuperpack
    if isinstance(v, TPSuperpack):
        return "rows+cols" if isinstance(v.block, RowSuperpack) else "cols"
    return "rows" if isinstance(v, RowSuperpack) else None


def _mx_buffer(v):
    """The tensor a placed superpack holds (an int8 block's codes), inside
    its split layers: what a site's operand shares with its param."""
    from repro_torch.core.plan import QuantizedSuperpack, map_block
    held = []
    map_block(v, held.append)
    return held[0].q if isinstance(held[0], QuantizedSuperpack) else held[0]


def _mx_unet(rank, dev, conf):
    """The 512 px U-Net at ``MX_UNET_B`` under each of ``MX_UNET_RULES``
    (its wdtypes): every row-block launch (C, D and the whole-plane
    sites' A, B) against its plain version on the card and on a block
    fenced by NaN rows; a C and a D site against the f64 oracle; the
    output and a DSM gradient against one rank's; planted: one rank's
    partial left out."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import untangled_conv as uc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import unet
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    b = conf["unet_b"]
    out = []
    for case, (shape, rules, wd) in ((c, (sh, r, w)) for c, (sh, r, ws)
                                     in conf["unet_rules"].items()
                                     for w in ws):
        dist = DistContext(make_host_mesh(*shape),
                           rules=dict(DEFAULT_RULES, **rules))
        cfg = _mx_unet_cfg(conf, wd)
        tiled = _mx_tiled_sites(cfg, b)
        whole = unet.unet_init(70, cfg, device=dev)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always", RuntimeWarning)
            p = dist.shard_params(whole, unet.unet_specs(cfg))
        split = {k: _mx_split_kind(v) for k, v in p.items()
                 if _mx_split_kind(v)}
        gen = torch.Generator().manual_seed(71)
        x = torch.randn((b, cfg.image_hw, cfg.image_hw, cfg.in_c),
                        generator=gen).to(dev)
        t = torch.rand((b,), generator=gen).to(dev)
        sites, launches = [], []
        orig = plan_mod._rp_apply

        def capture(plan, x_, packed, bias):
            y_ = orig(plan, x_, packed, bias)
            sites.append((plan, x_, packed, bias, y_))
            return y_
        zero_counts()
        uc.untangled_deconv2d.launches_tiled_rows = 0
        uc.untangled_conv2d_superpack.launches_tiled_rows = 0
        plan_mod._rp_apply = capture
        undo = _mr_row_launches(launches)
        try:
            with torch.no_grad():
                y = unet.unet_apply(p, x, t, cfg, dist=dist)
        finally:
            undo()
            plan_mod._rp_apply = orig
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts, other = read_counts(wd)
        tiled_rows = [r for r in launches if r[3].get("sp_tiles")]
        rec = {"case": case, "mesh": shape, "wdtype": wd, "batch": b,
               "rank": rank, "split_sites": split, "whole_sites": sorted(
                   k for k in unet.unet_plans(cfg) if k not in split),
               "warned": len(warned), "tiled": tiled,
               "launches": counts, "other_dtype_launches": other,
               "row_launches": len(launches),
               "tiled_row_launches": {k: sum(
                   1 for r in tiled_rows
                   if ("D" if "phases" in r[3] else "C") == k)
                   for k in ("C", "D")},
               "tiled_rows_counted":
                   uc.untangled_deconv2d.launches_tiled_rows
                   + uc.untangled_conv2d_superpack.launches_tiled_rows}
        with torch.no_grad():
            (rec["rows_rel"], rec["rows_planted"],
             rec["rows_fenced"]) = _mr_row_check(launches)
            rec["tiled_rows_rel"] = _mr_row_check(tiled_rows)
            rec["tiled_rows_ulp"] = _mx_rows_f64(sites, launches)
        if rank == 0:
            rec["row_times"] = _mx_row_times(tiled_rows, dev)
        del launches, tiled_rows
        # a C and a D site against the f64 oracle (rank 0): a row block of
        # a column block runs the local plan on the rank's columns
        worst = {}
        for plan, x_, packed, bias, y_ in (sites if rank == 0 else ()):
            key, outer = next((k, v) for k, v in p.items()
                              if _mx_buffer(v) is _mx_buffer(packed))
            if key not in ("fuse0", "up0"):
                continue
            w = whole[key]
            if isinstance(outer.block, plan_mod.RowSuperpack):
                m = plan.spec.out_c
                cols = slice(outer.index * m, (outer.index + 1) * m)
                w = (plan_mod.QuantizedSuperpack(w.q[:, cols], w.scale)
                     if isinstance(w, plan_mod.QuantizedSuperpack)
                     else w[:, cols])
            y64, bound = f64_bound(plan, x_, plan.unpack(w))
            if bias is not None:
                y64 = y64 + bias.double()
            worst[key] = float(((y_.double() - y64).abs() / bound).max())
            del y64, bound
        rec["ulp_share"] = worst
        del sites
        with torch.no_grad():
            ref = unet.unet_apply(whole, x, t, cfg)
        rec["rel"] = _mesh_rel(ref, y)
        undo = _pp_patch(comm, "reduce_from", _mesh_unsummed(
            rank, "rows_all_reduce"))
        try:
            with torch.no_grad():
                rec["planted_rel"] = _mesh_rel(
                    ref, unet.unet_apply(p, x, t, cfg, dist=dist))
        finally:
            undo()
        # a DSM gradient of a C site's block (fuse0) against one rank's
        noise = torch.randn(tuple(x.shape), generator=gen).to(dev)
        pg, leaf = _mx_block_leaf(p, "fuse0")
        _mx_dsm(pg, x, t, noise, cfg, dist).backward()
        wg, wleaf = _mx_block_leaf(whole, "fuse0")
        _mx_dsm(wg, x, t, noise, cfg).backward()
        blk = dist.sharding(unet.unet_specs(cfg)["fuse0"]).block(wleaf.grad)
        rec["grad_rel"] = _mesh_rel(blk, leaf.grad)
        undo = _mr_skip_all_reduce("rows_input_bwd", rank)
        try:
            pg, bad = _mx_block_leaf(p, "fuse0")
            _mx_dsm(pg, x, t, noise, cfg, dist).backward()
        finally:
            undo()
        rec["planted_grad_rel"] = _mesh_rel(blk, bad.grad)
        if wd == "float32":
            def fwd():
                with torch.no_grad():
                    return unet.unet_apply(p, x, t, cfg, dist=dist)
            single = ((lambda: unet.unet_apply(whole, x, t, cfg))
                      if rank == 0 else None)
            with torch.no_grad():
                rec["measure"] = _mr_measure(fwd, dev, single)
        out.append(rec)
        del p, whole, pg, wg, y, ref, blk
    return out


def _mx_plane(rank, dev, conf):
    """The 512 px U-Net (f32, B = ``MX_UNET_B``) plane-parallel on a bound
    (2, 2) spatial mesh with its superpacks split on their rows over
    'sp_h', then on their out-channels over 'sp_w': the output and a DSM
    gradient against one rank's, the activations held as blocks between
    sites; planted: the gather's backward without its sum."""
    import torch
    from repro_torch.core import comm, spatial
    from repro_torch.core import plan as plan_mod
    from repro_torch.launch import faults
    from repro_torch.launch.mesh import make_spatial_mesh
    from repro_torch.models import unet
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    mesh = make_spatial_mesh(2, 2)
    b = conf["unet_b"]
    cfg = _mx_unet_cfg(conf, "float32", spatial=(2, 2))
    whole = unet.unet_init(72, cfg, device=dev)
    gen = torch.Generator().manual_seed(73)
    x = torch.randn((b, cfg.image_hw, cfg.image_hw, cfg.in_c),
                    generator=gen).to(dev)
    t = torch.rand((b,), generator=gen).to(dev)
    noise = torch.randn(tuple(x.shape), generator=gen).to(dev)
    with torch.no_grad():
        ref = unet.unet_apply(whole, x, t, cfg)
    wg, wleaf = _mx_block_leaf(whole, "fuse0")
    _mx_dsm(wg, x, t, noise, cfg).backward()
    out = []
    for name, rules in conf["plane_rules"].items():
        dist = DistContext(mesh, rules=dict(DEFAULT_RULES, **rules))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            p = dist.shard_params(whole, unet.unet_specs(cfg))
        kinds = {k: type(v).__name__ for k, v in p.items()
                 if type(v).__name__ in ("RowSuperpack", "TPSuperpack")}
        outs = []
        orig_apply = plan_mod.ConvPlan.apply

        def keep(self, x_, packed, bias=None):
            y_ = orig_apply(self, x_, packed, bias=bias)
            outs.append(type(y_).__name__)
            return y_
        comm.traffic_reset()
        spatial.SPLIT_SITES[0] = 0
        plan_mod.ConvPlan.apply = keep
        try:
            with spatial.use_spatial_mesh(mesh), torch.no_grad():
                y = unet.unet_apply(p, x, t, cfg, dist=dist)
        finally:
            plan_mod.ConvPlan.apply = orig_apply
        rec = {"case": name, "rank": rank, "split": kinds,
               "split_sites": spatial.SPLIT_SITES[0],
               "blocks_out": outs.count("PlaneBlocks"), "sites": len(outs),
               "collectives": comm.traffic(), "rel": _mesh_rel(ref, y)}
        pg, leaf = _mx_block_leaf(p, "fuse0")
        with spatial.use_spatial_mesh(mesh):
            _mx_dsm(pg, x, t, noise, cfg, dist).backward()
        blk = dist.sharding(unet.unet_specs(cfg)["fuse0"]).block(wleaf.grad)
        rec["grad_rel"] = _mesh_rel(blk, leaf.grad)
        undo = _pp_patch(comm, "gather_from", faults.skip_gather_sum)
        try:
            pg, bad = _mx_block_leaf(p, "fuse0")
            with spatial.use_spatial_mesh(mesh):
                _mx_dsm(pg, x, t, noise, cfg, dist).backward()
        finally:
            undo()
        rec["planted_grad_rel"] = _mesh_rel(blk, bad.grad)

        def fwd():
            with spatial.use_spatial_mesh(mesh), torch.no_grad():
                return unet.unet_apply(p, x, t, cfg, dist=dist)
        single = ((lambda: unet.unet_apply(whole, x, t, cfg))
                  if rank == 0 else None)
        with torch.no_grad():
            rec["measure"] = _mr_measure(fwd, dev, single)
        out.append(rec)
        del p, pg, y
    return out


def _mx_gan(rank, dev, conf):
    """The DCGAN generator and discriminator on (2, 2) through the image
    batcher's split of each batch, f32 and int8, at each batch, with one
    of the superpack's two splits on the batch axis: each rank's images
    and logits against the one-rank forward on the same rows; planted:
    the batch-axis gather bypassed."""
    import torch
    from repro_torch import sharding
    from repro_torch.launch import faults
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gan
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    mesh = make_host_mesh(2, 2)
    out = []
    for rule, rules in conf["gan_rules"].items():
        dist = DistContext(mesh, rules=dict(DEFAULT_RULES, **rules))
        for wd in ("float32", "int8"):
            cfg = _mr_gan_cfg(conf, "dcgan", wd)
            gw = gan.generator_init(80, cfg, device=dev)
            dw = gan.discriminator_init(81, cfg, device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                gp = dist.shard_params(gw, gan.generator_specs(cfg))
                dp = dist.shard_params(dw, gan.discriminator_specs(cfg))
            for b in conf["gan_batches"]:
                z = torch.randn((b, cfg.z_dim), generator=torch.Generator(
                    ).manual_seed(82 + b)).to(dev)

                def serve(gp_, dp_, z_=z):
                    rows, group = dist.split_batch(z_)
                    img = gan.generator_apply(gp_, rows, cfg, dist=dist)
                    logit = gan.discriminator_apply(dp_, img, cfg,
                                                    dist=dist)
                    return rows, group, img, logit
                zero_counts()
                with torch.no_grad():
                    rows, group, img, logit = serve(gp, dp)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    counts, other = read_counts(wd)
                    ref_img = gan.generator_apply(gw, rows, cfg)
                    ref_logit = gan.discriminator_apply(dw, ref_img, cfg)
                rec = {"rule": rule, "wdtype": wd, "batch": b,
                       "rank": rank, "rows": int(rows.shape[0]),
                       "split": group is not None, "launches": counts,
                       "other_dtype_launches": other,
                       "rel": _mesh_rel(ref_img, img),
                       "logit_rel": _mesh_rel(ref_logit, logit)}
                if group is not None:
                    undo = _pp_patch(sharding.DistContext, "axes_of",
                                     faults.no_batch_axes)
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore", RuntimeWarning)
                            bgp = dist.shard_params(
                                gw, gan.generator_specs(cfg))
                        with torch.no_grad():
                            bad = gan.generator_apply(bgp, rows, cfg,
                                                      dist=dist)
                    finally:
                        undo()
                    rec["planted_rel"] = _mesh_rel(ref_img, bad)
                if wd == "float32":
                    def fwd():
                        with torch.no_grad():
                            return dist.join_batch(serve(gp, dp)[2], group)
                    single = ((lambda: gan.discriminator_apply(
                        dw, gan.generator_apply(gw, z, cfg), cfg))
                        if rank == 0 else None)
                    with torch.no_grad():
                        rec["measure"] = _mr_measure(fwd, dev, single)
                out.append(rec)
                del img, logit, ref_img, ref_logit
            del gp, dp, gw, dw
    return out


def _mx_rank(rank, world, dev, conf):
    """One rank of phases 3t/4q (all ranks share the card)."""
    import gc

    import torch
    from repro_torch.core import plan as plan_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if conf["ref_budget"] is not None or conf["spatial_min"] is not None:
        if conf["ref_budget"] is not None:
            plan_mod._REF_VMEM_BUDGET = conf["ref_budget"]
        if conf["spatial_min"] is not None:
            plan_mod._SPATIAL_MIN_BYTES = conf["spatial_min"]
        plan_mod.plan_cache_clear()
    fns = {"unet": _mx_unet, "plane": _mx_plane, "gan": _mx_gan}
    out = {}
    for name in conf["cases"]:
        t0 = time.perf_counter()
        out[name] = fns[name](rank, dev, conf)
        out[name + "_s"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mx_print_measure(tag, r, smi):
    m = r.get("measure")
    if m is None:
        return
    single = ("" if m.get("single_ms") is None else
              f", one rank {m['single_ms']:.3f} ms, device "
              f"{ms_text(m['single_device_ms'])} ms")
    print(f"[4q] {tag} rank {r['rank']}: {m['ms']:.3f} ms (events), device "
          f"{ms_text(m['device_ms'])} ms{single}; peak {m['peak_bytes']} "
          f"bytes ({m['base_bytes']} before) | {smi}")
    print(f"[4q] {tag} rank {r['rank']} collectives (calls, bytes): "
          + ", ".join(f"{k} {v['calls']} / {v['bytes']}"
                      for k, v in m["collectives"].items()))


def mesh_splits_phases(dev, smi):
    """Phases 3t and 4q: the last superpack splits, over ``MX_WORLD``
    ranks that share the card on a gloo group, at full width, the
    one-rank references in every rank of the same run.  (a) The 512 px
    U-Net at ``MX_UNET_B`` with 'conv_taps' on 'model' over (1, 4), f32
    and int8: row blocks inside kernels C and D (each launch against its
    plain version on the card and on a block fenced by NaN rows; planted:
    the plain version one row off), fuse0 (C) and up0 (D) against the f64
    oracle, the output and a DSM gradient of fuse0's block against one
    rank's (planted: one rank's partial left out, its input gradient
    unsummed); the stem's rows do not divide and it stays whole.  The same
    checks, f32, with its rows on 'data' and its out-channels on 'model'
    over (2, 2) and neither axis carrying the batch: the rank's row block
    of its column block through C's and D's rows entries on the local plan
    at N/2, the partials summed over 'data', the channels gathered over
    'model'.  (b) The same U-Net plane-parallel on a bound (2, 2) spatial mesh with its
    superpack rows on 'sp_h', then its out-channels on 'sp_w': output and
    gradient against one rank's, the activations held as blocks (planted:
    the split weight's gather without its cotangent sum).  (c) The DCGAN
    generator and discriminator on (2, 2) through the image batcher's
    split batch at each of ``MX_GAN_BATCHES``, f32 and int8, with
    'conv_taps' on 'data' and 'conv_out' on 'model', then the other way
    round (planted: the batch-axis gather bypassed).  4q: each case's ms
    and device ms beside one rank's, its collectives and peak memory, and
    each C and D row-block launch's ms beside the whole superpack's at its
    site.  Returns (records, {kernel: {path: launches}}, {kernel:
    row-block launches})."""
    import gc

    import torch
    from repro_torch.launch.mesh import run_spmd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    conf = {"configs": MX_CONFIGS, "cases": MX_CASES, "unet_b": MX_UNET_B,
            "unet_hw": UNET_512_HW, "unet_kw": MX_UNET_KW,
            "unet_rules": MX_UNET_RULES,
            "gan_batches": MX_GAN_BATCHES, "gan_rules": MX_GAN_RULES,
            "plane_rules": MX_PLANE_RULES, "ref_budget": MX_REF_BUDGET,
            "spatial_min": MX_SPATIAL_MIN}
    t0 = time.perf_counter()
    ranks = run_spmd(_mx_rank, MX_WORLD, conf, device=dev.type, timeout=900)
    wall = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    failed = []
    paths = {k: {} for k in ("A", "B", "C", "D", "A_int8", "B_int8",
                             "C_int8", "D_int8")}
    rows_by = {"C": 0, "D": 0, "C_int8": 0, "D_int8": 0}
    # ---- (a) the U-Net's row blocks inside C and D ------------------------
    if "unet" in ranks[0]:
        for recs in zip(*(x["unet"] for x in ranks)):
            r0 = recs[0]
            wd = r0["wdtype"]
            key = "" if wd == "float32" else "_int8"
            tag = (f"U-Net {UNET_512_HW}px {wd} B={r0['batch']} "
                   f"{tuple(r0['mesh'])} {r0['case']}")
            print(f"[3t] {tag}: split sites {r0['split_sites']}; whole "
                  f"{r0['whole_sites']} (a dim the split does not divide "
                  f"stays whole: {r0['warned']} warning(s)); tiled sites "
                  f"{r0['tiled']}; {ranks[0]['unet_s']:.1f} s")
            for r in recs:
                tr, tp_, tf = r["tiled_rows_rel"]
                tu = r["tiled_rows_ulp"]
                print(f"[3t] {tag} rank {r['rank']}: launches "
                      f"{r['launches']}; C/D row-block launches "
                      f"{r['tiled_row_launches']} (counted "
                      f"{r['tiled_rows_counted']}) vs their plain versions "
                      f"on the card, worst {tr:.2e} (limit "
                      f"{TOL_MR_ROWS:.0e}; planted, r0 one row off: least "
                      f"{tp_:.2e}), on blocks fenced by NaN rows {tf:.2e}, "
                      f"against the f64 oracle of their partials {tu:.3f} "
                      f"of ulp_bound; "
                      f"all {r['row_launches']} row blocks (A-D) worst "
                      f"{r['rows_rel']:.2e}, fenced {r['rows_fenced']:.2e}; "
                      f"output vs one rank {r['rel']:.2e} (limit "
                      f"{TOL_MESH_IMG:.0e}); fuse0 block's DSM gradient vs "
                      f"one rank {r['grad_rel']:.2e} (limit {TOL_GRAD:.0e})")
                want = {"C": 3, "D": 1}
                ok = (tr <= TOL_MR_ROWS and tf <= TOL_MR_ROWS
                      and tp_ > TOL_MR_ROWS and tu <= 1.0
                      and r["rows_rel"] <= TOL_MR_ROWS
                      and r["rows_fenced"] <= TOL_MR_ROWS
                      and r["tiled_row_launches"] == want
                      and (not cuda or r["tiled_rows_counted"] == 4))
                if not ok or r["rel"] > TOL_MESH_IMG \
                        or r["grad_rel"] > TOL_GRAD:
                    failed.append(f"{tag} rank {r['rank']}")
                if r["other_dtype_launches"]:
                    failed.append(f"{tag} rank {r['rank']} other dtype")
                _mx_print_measure(tag, r, smi)
            print(f"[3t] {tag}: fuse0 (C) and up0 (D) vs the f64 oracle: "
                  + json.dumps({k: float(f"{v:.3f}") for k, v in
                                r0["ulp_share"].items()})
                  + " of ulp_bound")
            if set(r0["ulp_share"]) != {"fuse0", "up0"} or \
                    max(r0["ulp_share"].values()) > 1.0:
                failed.append(f"{tag} ulp")
            planted = max(r["planted_rel"] for r in recs)
            pgrad = max(r["planted_grad_rel"] for r in recs)
            print(f"[3t] {tag} planted: rank 1's row-block partial left out "
                  f"{planted:.2e}; its input gradients unsummed: fuse0 "
                  f"block's gradient {pgrad:.2e}")
            if not planted > TOL_MESH_IMG or not pgrad > TOL_GRAD:
                failed.append(f"{tag} planted")
            for t in r0.get("row_times", ()):
                print(f"[4q] {tag} kernel {t['kernel']}"
                      f"{' int8' if t['int8'] else ''} rows {t['rows'][:2]} "
                      f"of {t['rows'][2]}: {t['ms']:.4f} ms (events), "
                      f"device {ms_text(t['device_ms'])} ms; the whole "
                      f"superpack at the site {t['whole_ms']:.4f} ms, "
                      f"device {ms_text(t['whole_device_ms'])} ms | {smi}")
            name = f"mesh_splits_unet_{r0['case']}_{wd}_B{r0['batch']}"
            for k in ("A", "B", "C", "D"):
                paths[k + key][name] = sum(r["launches"][k] for r in recs)
            for k in ("C", "D"):
                rows_by[k + key] += sum(r["tiled_row_launches"][k]
                                        for r in recs)
    # ---- (b) a split superpack at a plane-parallel site -------------------
    if "plane" in ranks[0]:
        for recs in zip(*(x["plane"] for x in ranks)):
            r0 = recs[0]
            tag = f"U-Net {UNET_512_HW}px plane-parallel (2, 2) {r0['case']}"
            print(f"[3t] {tag}: split superpacks {r0['split']}; "
                  f"{ranks[0]['plane_s']:.1f} s")
            for r in recs:
                print(f"[3t] {tag} rank {r['rank']}: {r['split_sites']} "
                      f"sites plane-parallel, {r['blocks_out']} of "
                      f"{r['sites']} outputs held as blocks; output vs one "
                      f"rank {r['rel']:.2e} (limit {TOL_MESH_IMG:.0e}); "
                      f"fuse0 block's DSM gradient {r['grad_rel']:.2e} "
                      f"(limit {TOL_GRAD:.0e}); the gather's backward "
                      f"without its sum {r['planted_grad_rel']:.2e}; "
                      f"collectives " + ", ".join(
                          f"{k} {v['calls']} / {v['bytes']}"
                          for k, v in r["collectives"].items()))
                if r["rel"] > TOL_MESH_IMG or r["grad_rel"] > TOL_GRAD \
                        or not r["split"] or r["split_sites"] == 0 \
                        or r["blocks_out"] == 0:
                    failed.append(f"{tag} rank {r['rank']}")
                _mx_print_measure(tag, r, smi)
            if not max(r["planted_grad_rel"] for r in recs) > TOL_GRAD:
                failed.append(f"{tag} planted")
    # ---- (c) the DCGAN through the batcher's split batch -------------------
    if "gan" in ranks[0]:
        for recs in zip(*(x["gan"] for x in ranks)):
            r0 = recs[0]
            wd = r0["wdtype"]
            key = "" if wd == "float32" else "_int8"
            tag = f"DCGAN {wd} B={r0['batch']} (2, 2) {r0['rule']}"
            for r in recs:
                print(f"[3t] {tag} rank {r['rank']}: {r['rows']} rows "
                      f"(batch split {r['split']}), launches "
                      f"{r['launches']}; images vs one rank on the same rows "
                      f"{r['rel']:.2e}, logits {r['logit_rel']:.2e} (limit "
                      f"{TOL_MESH_IMG:.0e})"
                      + ("" if "planted_rel" not in r else
                         f"; planted, the batch-axis gather bypassed: "
                         f"{r['planted_rel']:.2e}"))
                # a lone logit (B = 1) may sit near zero: its relative
                # error is printed, the gate reads the batch's; the mesh
                # forward alone launches A at the generator's four sites
                # and B at the discriminator's four, once each
                if r["rel"] > TOL_MESH_IMG or (
                        r["rows"] > 1 and r["logit_rel"] > TOL_MESH_IMG) \
                        or cuda and (r["launches"]["A"] != 4
                                     or r["launches"]["B"] != 4):
                    failed.append(f"{tag} rank {r['rank']}")
                if r["other_dtype_launches"]:
                    failed.append(f"{tag} rank {r['rank']} other dtype")
                if "planted_rel" in r and not r["planted_rel"] > TOL_MESH_IMG:
                    failed.append(f"{tag} rank {r['rank']} planted")
                _mx_print_measure(tag, r, smi)
            name = f"mesh_splits_dcgan_{r0['rule']}_{wd}_B{r0['batch']}"
            for k in ("A", "B"):
                paths[k + key][name] = sum(r["launches"][k] for r in recs)
    print(f"[3t] mesh splits phase: {wall:.1f} s over {MX_WORLD} ranks, "
          f"launches {json.dumps(paths)}, C/D row-block launches "
          f"{json.dumps(rows_by)}")
    if failed:
        raise RuntimeError(f"mesh splits gates failed: {failed}")
    return {"mesh_splits": {"ranks": ranks, "seconds": wall}}, paths, rows_by


def main(argv=()) -> int:
    import torch
    import torch.nn.functional as F

    unknown = [a for a in argv if a not in ("--plane-parallel", "--mesh",
                                            "--mesh-train", "--mesh-serve",
                                            "--mesh-rest", "--mesh-splits",
                                            "--dryrun")]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 throughout, as JAX's dots do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import reference as ref
    from repro_torch.core.plan import BATCH_BUCKETS
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels import _build
    from repro_torch import serve_segnet, train_gan
    from repro_torch.kernels.untangled_conv import work_conv, work_deconv
    from repro_torch.launch.roofline import card_peaks
    from repro_torch.kernels.untangled_conv import (
        _MIN_SLICE as MIN_SLICE, SMS, deconv_schedule,
        pick_block_tile_single,
        pick_block_tile_transposed, single_out_hw, tiled_conv_schedule,
        tiled_deconv_schedule,
        untangled_conv2d_superpack, untangled_conv2d_superpack_tiled_ref,
        untangled_deconv2d, untangled_deconv2d_tiled_ref)
    from repro_torch.models import gan, segnet, unet
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    from repro_torch.serving.image_batcher import DynamicImageBatcher
    from repro_torch.train.data import GANPipeline

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. environment + build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_bf16 = card_peaks(card)
    print(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | peaks fp32 {peak_flops / 1e12:.0f} TFLOP/s, bf16 tensor "
          f"cores {peak_bf16 / 1e12:.0f} TFLOP/s, HBM "
          f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"[build] {len(logs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    f_ptxas = ptxas_report(logs.get("flash_attention", ""))
    a_ptxas = ptxas_report(logs.get("untangled_deconv", ""))
    b_ptxas = ptxas_report(logs.get("untangled_conv", ""))
    c_ptxas = ptxas_report(logs.get("untangled_conv_tiled", ""))
    d_ptxas = ptxas_report(logs.get("untangled_deconv_tiled", ""))
    for tag, recs in (("F", f_ptxas), ("A", a_ptxas), ("B", b_ptxas),
                      ("C", c_ptxas), ("D", d_ptxas)):
        for rec in recs:
            print(f"[build] kernel {tag} {rec['kernel']}: "
                  f"{rec.get('registers')} registers, "
                  f"{rec.get('stack_frame')} bytes stack frame, "
                  f"{rec.get('spill_stores')} bytes spill stores, "
                  f"{rec.get('spill_loads')} bytes spill loads")
    for tag, recs in (("A", a_ptxas), ("B", b_ptxas), ("C", c_ptxas),
                      ("D", d_ptxas)):
        spilled = [r["kernel"] for r in recs
                   if r.get("spill_stores") or r.get("spill_loads")]
        if len(recs) < 2 or spilled:
            raise RuntimeError(f"kernel {tag} instantiations that spill: "
                               f"{spilled} (of {len(recs)} reported)")
    # kernels C and D keep their ring slots as offsets, never as pointer
    # arrays in local memory: every instantiation has no stack frame
    framed = [r["kernel"] for r in c_ptxas + d_ptxas
              if r.get("stack_frame") != 0]
    if framed:
        raise RuntimeError(f"kernel C or D instantiations with a stack "
                           f"frame (local memory): {framed}")

    if argv:
        # phase 3n, phases 3o/4m, 3p/4n and/or 3q/4o alone: with a card
        # per rank their ranks meet on NCCL
        if "--plane-parallel" in argv:
            pp_records, pp_paths = plane_parallel_phases(dev, smi)
            print(json.dumps({"card": smi, **pp_records,
                              "launches_by_path": pp_paths}))
        if "--mesh" in argv:
            mesh_records, mesh_paths = mesh_phases(dev, smi)
            print(json.dumps({"card": smi, **mesh_records,
                              "launches_by_path": mesh_paths}))
        if "--mesh-train" in argv:
            mt_records, mt_paths = mesh_train_phases(dev, smi)
            print(json.dumps({"card": smi, **mt_records,
                              "launches_by_path": mt_paths}))
        if "--mesh-serve" in argv:
            ms_records, ms_paths = mesh_serve_phases(dev, smi)
            print(json.dumps({"card": smi, **ms_records,
                              "launches_by_path": ms_paths}))
        if "--mesh-rest" in argv:
            mr_records, mr_paths = mesh_rest_phases(dev, smi)
            print(json.dumps({"card": smi, **mr_records,
                              "launches_by_path": mr_paths}))
        if "--mesh-splits" in argv:
            mx_records, mx_paths, mx_rows = mesh_splits_phases(dev, smi)
            print(json.dumps({"card": smi, **mx_records,
                              "launches_by_path": mx_paths,
                              "row_block_launches": mx_rows}))
        if "--dryrun" in argv:
            dry_records, _ = dryrun_phases(dev, smi)
            print(json.dumps({"card": smi, **dry_records}))
        print(f"[done] phase(s) {' '.join(argv)} passed in "
              f"{time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card,
            "count": torch.cuda.device_count()}}))
        return 0

    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def poison(*numels):
        # NaN-fill blocks the caching allocator will hand out next (the
        # output, then kernel A's workspace), so an element the kernel
        # leaves unwritten cannot pass as a value
        blocks = [torch.full((n,), float("nan"), device=dev)
                  for n in numels if n]
        del blocks

    def device_split(fn, wall_ms):
        """One call of ``fn`` (after the warm-up ``time_ms`` gave it) under
        ``torch.profiler``: device time of kernel B's launches and of
        everything else, summed over device-side events only, the idle
        share against ``wall_ms`` (its time measured without the profiler)
        and the host ops of most self CPU time (name, calls, ms); the idle
        share is None where the profiler caught no trace."""
        prof, evs = device_events(fn, 1, with_cpu=True)
        out = {"kernel_ms": 0.0, "other_ms": 0.0, "kernel_calls": 0,
               "other_calls": 0}
        for ev in evs or ():
            part = "kernel" if kernel_part(ev.name) == "B" else "other"
            out[f"{part}_ms"] += ev.device_time_total / 1e3
            out[f"{part}_calls"] += 1
        busy = out["kernel_ms"] + out["other_ms"]
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out.update(device_busy_ms=busy, wall_ms=wall_ms,
                   idle_share=1 - busy / wall_ms if evs else None,
                   top_host_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                                 for e in top[:8]])
        return out

    def fills_card(sch):
        """Kernel B's batch-1 rule: at least 132 work units, but for a K of
        fewer than ``_MIN_SLICE`` chunks, which the schedule keeps whole
        (a second pass costs more than it saves there)."""
        return sch["units"] >= SMS or sch["chunks"] < MIN_SLICE

    def int8_of(sp):
        """(q, scale, dequantized) of an f32 superpack whose middle row is
        zeroed first (an all-zero row: its scale floors, its codes are 0)."""
        sp = sp.clone()
        sp[sp.shape[0] // 2] = 0.0
        q, scale = quantize_int8_rows(sp)
        return q, scale, dequantize_int8(q, scale)

    # ---- 2. kernel A vs its plain version, both vs the f64 oracle ----------
    dc = gan.DCGAN_LAYERS
    pad52 = gan.deconv_padding(5, 2)
    cases = [(f"DCGAN_DC{i + 1}_B{b}", b, l.in_hw, l.in_c, l.out_c, l.kernel,
              l.stride, gan.deconv_padding(l.kernel, l.stride))
             for b in (1, 64) for i, l in enumerate(dc)]
    cases += [(f"cGAN_DC{i + 1}_B16", 16, l.in_hw, l.in_c, l.out_c,
               l.kernel, l.stride, gan.deconv_padding(l.kernel, l.stride))
              for i, l in enumerate(gan.CGAN_LAYERS)]
    cases += [(f"{name}_B{b}", b, h, c, n, k, s, pads) for b in VAE_BATCHES
              for name, kind, h, c, n, k, s, pads in vae_sites()
              if kind == "transposed"]
    cases += [("nonuniform_7_k5s2", 2, 7, 16, 8, 5, 2, ((1, 1), (1, 1))),
              ("empty_phase_4_k2s3", 2, 4, 8, 8, 2, 3, ((1, 1), (1, 1))),
              ("ragged_C5_N3", 3, 5, 5, 3, 3, 2, ((1, 1), (1, 1))),
              ("ragged_C6_N20", 2, 6, 6, 20, 5, 2, pad52),
              ("ragged_C8_N36", 2, 6, 8, 36, 5, 2, pad52)]
    max_err = 0.0
    for name, b, h, c, n, k, s, pads in cases:
        plan = site(h, c, n, k, s, pads)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        packed = plan.pack(kern)
        xg = pad_or_crop(x, plan.gpad)
        numels = (b * plan.out_hw[0] * plan.out_hw[1] * n,
                  deconv_schedule(tuple(plan.phases), b, c,
                                  n).workspace_bytes // 4)
        poison(*numels)
        y_k = kernel_call(plan, xg, packed)
        y_r = ref_call(plan, xg, packed)
        poison(*numels)
        again = torch.equal(kernel_call(plan, xg, packed), y_k)
        torch.cuda.synchronize()
        y64, bound = f64_bound(plan, x, kern)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        err = float((y_k - y_r).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] {name}: out {tuple(y_k.shape)} |kernel-plain| "
              f"{err:.3e} kernel<=ulp_bound {ok_k} plain<=ulp_bound {ok_r} "
              f"(max bound {float(bound.max()):.3e}); two launches "
              f"bit-equal {again}; {schedule_of(plan, b)}")
        if not (ok_k and ok_r and again and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel A disagrees on {name}")
        if name.startswith("empty_phase"):
            empty = [ex for ex in plan.phases if ex.taps[0] * ex.taps[1] == 0]
            if not empty or any(bool(y_k[:, ex.q[0]::s, ex.q[1]::s].ne(0).any())
                                for ex in empty):
                raise RuntimeError("empty phases are not zero")

    # ---- 2b. kernel B vs its plain version, both vs the f64 oracle --------
    conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, 1, pads)
                  for b in (1, 64)
                  for name, h, c, n, k, s, pads in disc_sites()
                  if name.startswith("DCGAN")]
    conv_cases += [(f"{name}_B16", 16, h, c, n, k, s, 1, pads)
                   for name, h, c, n, k, s, pads in disc_sites()
                   if name.startswith("cGAN")]
    vae_conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, 1, pads)
                      for b in VAE_BATCHES
                      for name, kind, h, c, n, k, s, pads in vae_sites()
                      if kind == "conv"]
    conv_cases += vae_conv_cases
    conv_cases += [("dilated_17_k3_d2", 4, 17, 16, 32, 3, 1, 2,
                    ((2, 2), (2, 2))),
                   ("dilated_17_k3_d4", 4, 17, 16, 32, 3, 1, 4,
                    ((4, 4), (4, 4))),
                   ("ragged_C5_N3", 3, 9, 5, 3, 3, 2, 1, ((1, 1), (1, 1))),
                   ("ragged_C6_N20", 2, 9, 6, 20, 5, 1, 1, ((2, 2), (2, 2))),
                   ("odd_9_k5s2", 2, 9, 8, 8, 5, 2, 1, ((2, 2), (2, 2)))]
    max_err_b = 0.0
    for name, b, h, c, n, k, s, d, pads in conv_cases:
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        sp = kern.reshape(k * k * c, n)
        oh, ow = single_out_hw(xp.shape[1], xp.shape[2], (k, k), (s, s),
                               (d, d))
        sch = conv_schedule_of(b, oh, ow, k, c, n)
        numels = (b * oh * ow * n, sch["workspace_bytes"] // 4)
        poison(*numels)
        y_k = conv_call(xp, sp, k, s, d)
        y_r = conv_call(xp, sp, k, s, d, plain=True)
        poison(*numels)
        again = torch.equal(conv_call(xp, sp, k, s, d), y_k)
        torch.cuda.synchronize()
        y64, amax = ref.conv_oracle_f64(x, kern, strides=(s, s),
                                        dilation=(d, d), padding=pads)
        bound = ref.ulp_bound(y64, amax, k * k * c)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        err = float((y_k - y_r).abs().max())
        max_err_b = max(max_err_b, err)
        print(f"[kernel B] {name}: out {tuple(y_k.shape)} |kernel-plain| "
              f"{err:.3e} kernel<=ulp_bound {ok_k} plain<=ulp_bound {ok_r} "
              f"(n_terms {k * k * c}, max bound {float(bound.max()):.3e}); "
              f"two launches bit-equal {again}; {sch}")
        if not (ok_k and ok_r and again and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel B disagrees on {name}")

    # ---- 2c. kernel B int8 (kernel E) vs plain, f64 oracle, f32 kernel ----
    i8_conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, d, pads)
                     for b in (1, 64)
                     for name, h, c, n, k, s, d, pads in seg_sites()]
    i8_conv_cases += [(f"{name}_B16", 16, h, c, n, k, s, 1, pads)
                      for name, h, c, n, k, s, pads in disc_sites()]
    i8_conv_cases += vae_conv_cases
    i8_conv_cases += [("ragged_C5_N3", 3, 9, 5, 3, 3, 2, 1, ((1, 1), (1, 1))),
                      ("ragged_C6_N20", 2, 9, 6, 20, 5, 1, 1,
                       ((2, 2), (2, 2)))]
    max_err_bi8 = 0.0
    for name, b, h, c, n, k, s, d, pads in i8_conv_cases:
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        q, scale, wd = int8_of(kern.reshape(k * k * c, n))
        oh, ow = single_out_hw(xp.shape[1], xp.shape[2], (k, k), (s, s),
                               (d, d))
        sch = conv_schedule_of(b, oh, ow, k, c, n)
        numels = (b * oh * ow * n, sch["workspace_bytes"] // 4)
        poison(*numels)
        y_k = conv_call(xp, q, k, s, d, scales=scale)
        y_r = conv_call(xp, q, k, s, d, plain=True, scales=scale)
        poison(*numels)
        y_f = conv_call(xp, wd, k, s, d)
        poison(*numels)
        again = torch.equal(conv_call(xp, q, k, s, d, scales=scale), y_k)
        torch.cuda.synchronize()
        y64, amax = ref.conv_oracle_f64(x, wd.reshape(k, k, c, n),
                                        strides=(s, s), dilation=(d, d),
                                        padding=pads)
        bound = ref.ulp_bound(y64, amax, k * k * c)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        bit = torch.equal(y_k, y_f)
        err = float((y_k - y_r).abs().max())
        max_err_bi8 = max(max_err_bi8, err)
        print(f"[kernel B int8] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| {err:.3e} kernel<=ulp_bound {ok_k} "
              f"plain<=ulp_bound {ok_r} bit-equal to f32 kernel on "
              f"dequant {bit} (n_terms {k * k * c}); two launches bit-equal "
              f"{again}; {sch}")
        if not (ok_k and ok_r and bit and again
                and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel B int8 disagrees on {name}")

    # ---- 2d. kernel A int8 (kernel E) vs plain, f64 oracle, f32 kernel ----
    max_err_ai8 = 0.0
    for name, b, h, c, n, k, s, pads in cases:
        plan = site(h, c, n, k, s, pads)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        q, scale, wd = int8_of(plan.pack(kern))
        xg = pad_or_crop(x, plan.gpad)
        numels = (b * plan.out_hw[0] * plan.out_hw[1] * n,
                  deconv_schedule(tuple(plan.phases), b, c,
                                  n).workspace_bytes // 4)
        poison(*numels)
        y_k = kernel_call(plan, xg, q, scales=scale)
        y_r = ref_call(plan, xg, q, scales=scale)
        y_f = kernel_call(plan, xg, wd)
        poison(*numels)
        again = torch.equal(kernel_call(plan, xg, q, scales=scale), y_k)
        torch.cuda.synchronize()
        y64, bound = f64_bound(plan, x, plan.unpack(wd))
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        bit = torch.equal(y_k, y_f)
        err = float((y_k - y_r).abs().max())
        max_err_ai8 = max(max_err_ai8, err)
        print(f"[kernel A int8] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| {err:.3e} kernel<=ulp_bound {ok_k} "
              f"plain<=ulp_bound {ok_r} bit-equal to f32 kernel on "
              f"dequant {bit}; two launches bit-equal {again}")
        if not (ok_k and ok_r and bit and again
                and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel A int8 disagrees on {name}")

    # ---- 2e. kernel C (tiled B) f32 and int8 vs plain, f64 oracle ---------
    unet512 = unet.UNetConfig("unet-512", image_hw=UNET_512_HW,
                              backend="cuda")
    hw512 = unet512.image_hw
    u_plans = unet.unet_plans(unet512)
    tiled_c = [(n, p) for n, p in u_plans.items()
               if p.routes[0].sp_tiles is not None
               and p.spec.kind != "transposed"]
    tiled_d = [(n, p) for n, p in u_plans.items()
               if p.routes[0].sp_tiles is not None
               and p.spec.kind == "transposed"]
    if [n for n, _ in tiled_c] != ["stem", "down0", "fuse0", "head"] or \
            [n for n, _ in tiled_d] != ["up0"]:
        raise RuntimeError(f"U-Net 512 tiled sites {tiled_c} {tiled_d}")

    def tiled_conv_call(xp, sp, r, s_, st, d, tile, plain=False, **scales):
        fn = untangled_conv2d_superpack_tiled_ref if plain \
            else untangled_conv2d_superpack
        return fn(xp, sp, taps_hw=(r, s_), strides=(st, st),
                  rhs_dilation=(d, d), sp_tiles=tile, **scales)

    def tiled_schedule_of(out_hw, r, s_, st, d, c, n, tile):
        """Kernel C's layout of one call: tile, BN, tap loop, pixel
        spacing, staged halo and row pitch, ring stages, threads, blocks an
        SM, shared memory, tiles."""
        sch = tiled_conv_schedule(tuple(out_hw), (r, s_), (st, st), (d, d),
                                  c, n, tuple(tile))
        return {"tile": sch.tile, "bn": sch.bn, "path": sch.path,
                "pd": sch.pd, "halo": sch.halo, "pitch": sch.pitch,
                "stages": sch.stages, "threads": sch.threads,
                "blocks_sm": sch.blocks_sm, "smem_bytes": sch.smem_bytes,
                "tiles": sch.tiles}

    c_cases = []
    for name, plan in tiled_c:
        sp_ = plan.spec
        c_cases.append((f"unet512_{name}_B1", 1,
                        sp_.in_hw[0] + sum(sp_.padding[0]),
                        sp_.in_hw[1] + sum(sp_.padding[1]), sp_.in_c,
                        sp_.out_c,
                        *sp_.kernel_hw, sp_.strides[0], 1,
                        plan.routes[0].sp_tiles))
    c_cases += TILED_CONV_CASES
    max_err_c = max_err_ci8 = 0.0
    for name, b, hp, wp, c, n, r, s_, st, d, tile in c_cases:
        oh, ow = single_out_hw(hp, wp, (r, s_), (st, st), (d, d))
        if tile is None:
            tile = pick_block_tile_single((oh, ow), (r, s_), (st, st),
                                          (d, d), n)
        xp, kern = randn(b, hp, wp, c), randn(r, s_, c, n)
        sp = kern.reshape(r * s_ * c, n)
        q, scale, wd = int8_of(sp)
        poison(b * oh * ow * n)
        y_k = tiled_conv_call(xp, sp, r, s_, st, d, tile)
        y_r = tiled_conv_call(xp, sp, r, s_, st, d, tile, plain=True)
        poison(b * oh * ow * n)
        again = torch.equal(tiled_conv_call(xp, sp, r, s_, st, d, tile), y_k)
        poison(b * oh * ow * n)
        y_k8 = tiled_conv_call(xp, q, r, s_, st, d, tile, scales=scale)
        y_r8 = tiled_conv_call(xp, q, r, s_, st, d, tile, plain=True,
                               scales=scale)
        y_f = tiled_conv_call(xp, wd, r, s_, st, d, tile)
        poison(b * oh * ow * n)
        again8 = torch.equal(
            tiled_conv_call(xp, q, r, s_, st, d, tile, scales=scale), y_k8)
        torch.cuda.synchronize()
        oks = []
        for yk, yr, w_ in ((y_k, y_r, kern), (y_k8, y_r8, wd)):
            y64, amax = ref.conv_oracle_f64(xp, w_.reshape(r, s_, c, n),
                                            strides=(st, st),
                                            dilation=(d, d))
            bound = ref.ulp_bound(y64, amax, r * s_ * c)
            oks += [bool(((yk.double() - y64).abs() <= bound).all()),
                    bool(((yr.double() - y64).abs() <= bound).all())]
            del y64, amax, bound
        bit = torch.equal(y_k8, y_f)
        err, err8 = (float((y_k - y_r).abs().max()),
                     float((y_k8 - y_r8).abs().max()))
        max_err_c, max_err_ci8 = max(max_err_c, err), max(max_err_ci8, err8)
        print(f"[kernel C] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| f32 {err:.3e} int8 {err8:.3e}; within "
              f"ulp_bound (f32 kernel, plain, int8 kernel, plain) {oks}; "
              f"int8 bit-equal to f32 on dequant {bit}; two launches "
              f"bit-equal f32 {again} int8 {again8} (n_terms {r * s_ * c}); "
              f"schedule "
              f"{tiled_schedule_of((oh, ow), r, s_, st, d, c, n, tile)}")
        if not (all(oks) and bit and again and again8
                and torch.isfinite(y_k).all()
                and torch.isfinite(y_k8).all()):
            raise RuntimeError(f"kernel C disagrees on {name}")

    # ---- 2f. kernel D (tiled A) f32 and int8 vs plain, f64 oracle ---------
    def tiled_deconv_call(plan, xg, packed, tile, plain=False, **scales):
        if plain:
            return untangled_deconv2d_tiled_ref(
                xg, packed, phases=plan.phases, out_hw=plan.out_hw,
                strides=plan.spec.strides, sp_tiles=tile, **scales)
        return untangled_deconv2d(xg, packed, phases=plan.phases,
                                  out_hw=plan.out_hw,
                                  strides=plan.spec.strides,
                                  sum_uv=plan.sum_uv, sp_tiles=tile,
                                  **scales)

    def tiled_deconv_schedule_of(plan, c, n, tile):
        """Kernel D's layout of one call: tap loop, BN, register split
        (pixels x phases a thread, threads a block, blocks an SM), tile,
        pixel groups a tile row and a phase, staged halo and row pitch,
        ring stages, shared memory, tiles."""
        sch = tiled_deconv_schedule(tuple(plan.phases), plan.out_hw, c, n,
                                    tuple(tile))
        return {"path": sch.path, "bn": sch.bn,
                "split": (sch.tm, sch.tp, sch.threads, sch.blocks_sm),
                "tile": sch.tile, "gpr": sch.gpr, "gpp": sch.gpp,
                "halo": sch.halo, "pitch": sch.pitch, "stages": sch.stages,
                "smem_bytes": sch.smem_bytes, "tiles": sch.tiles}

    d_cases = [(f"unet512_{name}_B1", 1, p.spec.in_hw[0], p.spec.in_c,
                p.spec.out_c, p.spec.kernel_hw[0], p.spec.strides[0],
                p.spec.padding, p.routes[0].sp_tiles) for name, p in tiled_d]
    d_cases += TILED_DECONV_CASES
    max_err_d = max_err_di8 = 0.0
    for name, b, h, c, n, k, s_, pads, tile in d_cases:
        plan = site(h, c, n, k, s_, pads)
        if tile is None:
            tile = pick_block_tile_transposed(plan.phases, n)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        packed = plan.pack(kern)
        q, scale, wd = int8_of(packed)
        xg = pad_or_crop(x, plan.gpad).contiguous()
        numel = b * plan.out_hw[0] * plan.out_hw[1] * n
        poison(numel)
        y_k = tiled_deconv_call(plan, xg, packed, tile)
        y_r = tiled_deconv_call(plan, xg, packed, tile, plain=True)
        poison(numel)
        again = torch.equal(tiled_deconv_call(plan, xg, packed, tile), y_k)
        poison(numel)
        y_k8 = tiled_deconv_call(plan, xg, q, tile, scales=scale)
        y_r8 = tiled_deconv_call(plan, xg, q, tile, plain=True, scales=scale)
        y_f = tiled_deconv_call(plan, xg, wd, tile)
        poison(numel)
        again8 = torch.equal(
            tiled_deconv_call(plan, xg, q, tile, scales=scale), y_k8)
        # the library yardstick of the U-Net's up sites (phase 4d), held to
        # the same f64 bound before it is timed there
        y_lib = None
        if name.startswith("unet512_"):
            xl, wl, kw, crop = cropped_library_args(x, kern, (s_, s_), pads)
            y_lib = F.conv_transpose2d(xl, wl, **kw)[:, :, crop[0], crop[1]]
            y_lib = y_lib.permute(0, 2, 3, 1)
            del xl
        torch.cuda.synchronize()
        oks, lib_ok = [], None
        for yk, yr, w_ in ((y_k, y_r, kern), (y_k8, y_r8, plan.unpack(wd))):
            y64, bound = f64_bound(plan, x, w_)
            oks += [bool(((yk.double() - y64).abs() <= bound).all()),
                    bool(((yr.double() - y64).abs() <= bound).all())]
            if y_lib is not None and lib_ok is None:
                lib_ok = bool(((y_lib.double() - y64).abs() <= bound).all())
            del y64, bound
        bit = torch.equal(y_k8, y_f)
        empty_ok = all(not bool(y[:, ex.q[0]::s_, ex.q[1]::s_].ne(0).any())
                       for ex in plan.phases if ex.taps[0] * ex.taps[1] == 0
                       for y in (y_k, y_k8))
        err, err8 = (float((y_k - y_r).abs().max()),
                     float((y_k8 - y_r8).abs().max()))
        max_err_d, max_err_di8 = max(max_err_d, err), max(max_err_di8, err8)
        print(f"[kernel D] {name}: out {tuple(y_k.shape)} tile {tile} "
              f"|kernel-plain| f32 {err:.3e} int8 {err8:.3e}; within "
              f"ulp_bound (f32 kernel, plain, int8 kernel, plain) {oks}; "
              f"int8 bit-equal to f32 on dequant {bit}; two launches "
              f"bit-equal f32 {again} int8 {again8}; empty phases zero "
              f"{empty_ok}"
              + ("" if lib_ok is None else f"; the cropped "
                 f"F.conv_transpose2d within ulp_bound {lib_ok}")
              + f"; schedule {tiled_deconv_schedule_of(plan, c, n, tile)}")
        if not (all(oks) and bit and again and again8 and empty_ok
                and lib_ok is not False and torch.isfinite(y_k).all()
                and torch.isfinite(y_k8).all()):
            raise RuntimeError(f"kernel D disagrees on {name}")

    # ---- 3. serving at full width on the 'cuda' route ----------------------
    cfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    plans = gan.generator_plans(cfg)
    bad = [(i, r.batch, r.path) for i, p in enumerate(plans)
           for r in p.routes if r.path != "cuda"]
    if bad:
        raise RuntimeError(f"sites off the cuda route: {bad}")
    params = gan.generator_init(0, cfg, device=dev)

    def gen_fn(z):
        return gan.generator_apply(params, z, cfg)
    batcher = DynamicImageBatcher(gen_fn, device=dev)
    proto = torch.zeros(cfg.z_dim).numpy()
    # the wrapper counts the warmup's eager runs and captures; serving
    # replays the captured launches (4 a bucket), counted by the graphs
    untangled_deconv2d.launches = 0
    batcher.warmup(proto)
    capture_launches = untangled_deconv2d.launches
    gen_graph_ran = graph_checks(batcher, gen_fn, "A", 4, gen)
    rng = torch.Generator().manual_seed(1)
    lat = torch.randn((BURST, cfg.z_dim), generator=rng).numpy()
    untangled_deconv2d.launches = 0
    done = batcher.drive_open_loop(lambda i: lat[i], BURST)
    eager = untangled_deconv2d.launches
    launches = batcher.graph_launches().get("A", 0)
    st = batcher.stats()
    if sorted(r.rid for r in done) != list(range(BURST)):
        raise RuntimeError("a request was dropped or answered twice")
    if launches != 4 * len(batcher.launches) or launches == 0 or eager \
            or capture_launches != 2 * 4 * len(batcher.buckets):
        raise RuntimeError(f"{launches} kernel launches replayed for "
                           f"{len(batcher.launches)} batcher launches, "
                           f"{eager} eager ones, {capture_launches} at "
                           f"warmup")
    worst = 0.0
    with torch.inference_mode():
        for r in done:
            if r.out.shape != (64, 64, 3) or not torch.isfinite(
                    torch.from_numpy(r.out)).all():
                raise RuntimeError(f"request {r.rid}: bad output")
            one = gan.generator_apply(
                params, torch.from_numpy(lat[r.rid][None]).to(dev), cfg)
            diff = (one[0].cpu() - torch.from_numpy(r.out)).abs()
            worst = max(worst, float(diff.max()))
            if not bool((diff <= TOL_ROW * (1 + one[0].cpu().abs())).all()):
                raise RuntimeError(f"request {r.rid} differs from its B=1 "
                                   f"forward by {float(diff.max()):.3e}")
    print(f"[serve] {st['completed']}/{BURST} answered once, batcher "
          f"launches {batcher.launches}, kernel launches {launches} "
          f"(= 4 captured x {len(batcher.launches)} graph replays; 0 "
          f"eager; warmup {capture_launches} = an eager run and a capture "
          f"a bucket), every bucket's replay bit-equal to its eager "
          f"forward, a B={max(batcher.graphs)} replay's device kernels of "
          f"A (profiler) {ms_text(gen_graph_ran, 'd')}, max |row - B=1 "
          f"forward| {worst:.3e} (tol {TOL_ROW}), p50 {st['p50_ms']:.3f} "
          f"ms, p99 {st['p99_ms']:.3f} ms")

    # ---- 3b. training at full width on the 'cuda' route --------------------
    tcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    t_plans = gan.generator_plans(tcfg) + gan.discriminator_plans(tcfg)
    bad = [(p.spec.kind, p.spec.in_hw, r.batch, r.path) for p in t_plans
           for r in p.routes if r.path != "cuda"]
    if bad:
        raise RuntimeError(f"training sites off the cuda route: {bad}")
    gp = gan.generator_init(2, tcfg, device=dev)
    dp = gan.discriminator_init(3, tcfg, device=dev)
    pipe = GANPipeline(tcfg, TRAIN_BATCH, image_hw=64)

    def batch_on_card(step):
        bt = pipe.batch_at(step)
        return (torch.from_numpy(bt["z"]).to(dev),
                torch.from_numpy(bt["real"]).to(dev))

    z0, real0 = batch_on_card(0)
    gp0, dp0 = gp, dp
    untangled_deconv2d.launches = 0
    untangled_conv2d_superpack.launches = 0
    losses = []
    for step in range(TRAIN_STEPS):
        z, real = batch_on_card(step)
        gp, dp, gl, dl = train_gan.train_step(gp, dp, z, real, tcfg, 2e-4)
        losses.append((float(gl), float(dl)))
    torch.cuda.synchronize()
    train_launches = {"A": untangled_deconv2d.launches,
                      "B": untangled_conv2d_superpack.launches}
    n_layers = len(tcfg.layers)
    # per step: two passes (d-grads, g-grads), each one generator (A at
    # every generator site) and two discriminators (B at every disc site)
    want = {"A": TRAIN_STEPS * 2 * n_layers, "B": TRAIN_STEPS * 4 * n_layers}
    if train_launches != want:
        raise RuntimeError(f"train launches {train_launches}, want {want}")
    if not all(torch.isfinite(torch.tensor(l)).all() for l in losses) or \
            not all(bool(torch.isfinite(v).all())
                    for v in list(gp.values()) + list(dp.values())):
        raise RuntimeError(f"non-finite training state: losses {losses}")
    # one step's gradients, 'cuda' against 'torch', same params and batch
    ccfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="torch")
    out_c = train_gan.step_grads(gp0, dp0, z0, real0, tcfg)
    out_t = train_gan.step_grads(gp0, dp0, z0, real0, ccfg)
    # fp32 noise floor of the comparison: the 'torch' route again with every
    # latent moved by one ulp
    out_n = train_gan.step_grads(
        gp0, dp0, torch.nextafter(z0, torch.full_like(z0, float("inf"))),
        real0, ccfg)
    torch.cuda.synchronize()
    worst_grad, leaf_lines, bad = 0.0, [], []
    for i, who in ((2, "g"), (3, "d")):
        gc_, gt_, gn_ = out_c[i], out_t[i], out_n[i]
        for k in gt_:
            scale = float(gt_[k].abs().max()) or float("nan")
            rel = float((gc_[k] - gt_[k]).abs().max()) / scale
            noise = float((gn_[k] - gt_[k]).abs().max()) / scale
            worst_grad = max(worst_grad, rel)
            leaf_lines.append(f"{who}.{k} max|g| {scale:.3e} max|Δ|/max|g| "
                              f"{rel:.3e} (1-ulp z nudge {noise:.3e})")
            if not (rel <= TOL_GRAD and bool(torch.isfinite(gc_[k]).all())):
                bad.append(leaf_lines[-1])
    print("[train] one step's gradients per tensor, cuda vs torch: "
          + "; ".join(leaf_lines))
    if bad:
        raise RuntimeError(f"gradients off by more than {TOL_GRAD} of their "
                           f"scale (or non-finite): {bad}")
    loss_rel = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(out_c[:2], out_t[:2]))
    if loss_rel > TOL_LOSS:
        raise RuntimeError(f"losses differ by {loss_rel:.3e} of their size")
    print(f"[train] DCGAN full width, B={TRAIN_BATCH}, {TRAIN_STEPS} SGD "
          f"steps on 'cuda': (g_loss, d_loss) {losses}; launches "
          f"{train_launches} (= {want}); one step's gradients cuda vs torch "
          f"max|Δ|/max|g| {worst_grad:.3e} (tol {TOL_GRAD}), losses "
          f"|Δ|/|loss| {loss_rel:.3e} (tol {TOL_LOSS})")

    # ---- 3c. SegNet serving at full width, f32 and int8, on 'cuda' --------
    seg_serve = {}
    seg_launches = {}
    for wdtype in ("float32", "int8"):
        scfg, sparams = serve_segnet.load_model(
            full=True, backend="cuda", wdtype=wdtype, device=dev)
        splans = segnet.segnet_plans(scfg)
        bad = [(i, r.batch, r.path) for i, p in enumerate(splans)
               for r in p.routes if r.path != "cuda"]
        if bad or len(splans) != 10:
            raise RuntimeError(f"SegNet sites off the cuda route: {bad}")

        def seg_fn(x, p=sparams, c=scfg):
            return torch.argmax(segnet.segnet_apply(p, x, c), dim=-1)

        sb = DynamicImageBatcher(seg_fn, device=dev)
        sb.warmup(torch.zeros((scfg.in_hw, scfg.in_hw, scfg.in_c)).numpy())
        key = "B" if wdtype == "float32" else "B_int8"
        seg_graph_ran = graph_checks(sb, seg_fn, key, 10, gen)
        imgs = (torch.rand((BURST, scfg.in_hw, scfg.in_hw, scfg.in_c),
                           generator=torch.Generator().manual_seed(4))
                * 2 - 1).numpy()
        untangled_conv2d_superpack.launches = 0
        untangled_conv2d_superpack.launches_int8 = 0
        done = sb.drive_open_loop(lambda i: imgs[i], BURST)
        eager = (untangled_conv2d_superpack.launches
                 + untangled_conv2d_superpack.launches_int8)
        replayed = sb.graph_launches()
        got = {"float32": replayed.get("B", 0),
               "int8": replayed.get("B_int8", 0)}
        st = sb.stats()
        want = {w: (10 * len(sb.launches) if w == wdtype else 0)
                for w in got}
        if sorted(r.rid for r in done) != list(range(BURST)):
            raise RuntimeError("a SegNet request was dropped or answered "
                               "twice")
        if got != want or not sb.launches or eager:
            raise RuntimeError(f"SegNet {wdtype}: kernel B launches {got} "
                               f"replayed, {eager} eager, want {want} (10 "
                               f"per batcher launch, all replayed)")
        seg_launches[wdtype] = got[wdtype]
        with torch.inference_mode():
            for r in done:
                one = seg_fn(torch.from_numpy(imgs[r.rid][None]).to(dev))
                if r.out.shape != (scfg.out_hw, scfg.out_hw) or \
                        not (one[0].cpu().numpy() == r.out).all():
                    raise RuntimeError(f"SegNet {wdtype} request {r.rid}: "
                                       f"served map differs from its B=1 "
                                       f"forward's")
        gate = None
        if wdtype == "int8":
            gate = serve_segnet.int8_gate(scfg, sparams, dev)
            if gate["int8_bytes"] > 0.5 * gate["f32_bytes"]:
                raise RuntimeError(f"int8 SegNet weights too large: {gate}")
        seg_serve[wdtype] = {
            "batcher_launches": sb.launches, "kernel_b_launches": got,
            "img_per_s": st["throughput_rps"], "p50_ms": st["p50_ms"],
            "p99_ms": st["p99_ms"], "int8_gate": gate,
            "forward_ms": {}}
        with torch.inference_mode():
            for bb in BATCH_BUCKETS:
                xb = randn(bb, scfg.in_hw, scfg.in_hw, scfg.in_c)
                seg_serve[wdtype]["forward_ms"][bb] = time_ms(
                    lambda: segnet.segnet_apply(sparams, xb, scfg), iters=10)
                if bb in (1, 64):
                    seg_serve[wdtype][f"device_split_B{bb}"] = device_split(
                        lambda: segnet.segnet_apply(sparams, xb, scfg),
                        seg_serve[wdtype]["forward_ms"][bb])
        print(f"[serve SegNet {wdtype}] {st['completed']}/{BURST} answered "
              f"once, batcher launches {sb.launches}, kernel B launches "
              f"{got} (= 10 captured x {len(sb.launches)} graph replays, 0 "
              f"eager), every bucket's replay bit-equal to its eager "
              f"forward, a B={max(sb.graphs)} replay's device kernels of B "
              f"(profiler) {ms_text(seg_graph_ran, 'd')}, every map == its "
              f"B=1 forward's; {st['throughput_rps']:.1f} img/s, p50 "
              f"{st['p50_ms']:.3f} ms; forward ms per bucket "
              f"{json.dumps(seg_serve[wdtype]['forward_ms'])}"
              + (f"; int8 gate {json.dumps(gate)}" if gate else "")
              + f" | {smi}")

    # ---- 3d. the int8 DCGAN generator served on 'cuda' --------------------
    qcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda",
                         wdtype="int8")
    qparams = gan.generator_init(0, qcfg, device=dev)
    def qgen_fn(z):
        return gan.generator_apply(qparams, z, qcfg)
    qb = DynamicImageBatcher(qgen_fn, device=dev)
    qb.warmup(proto)
    graph_checks(qb, qgen_fn, "A_int8", 4, gen)
    untangled_deconv2d.launches = 0
    untangled_deconv2d.launches_int8 = 0
    done = qb.drive_open_loop(lambda i: lat[i], BURST)
    eager = untangled_deconv2d.launches + untangled_deconv2d.launches_int8
    replayed = qb.graph_launches()
    q_launches = {"float32": replayed.get("A", 0),
                  "int8": replayed.get("A_int8", 0)}
    if sorted(r.rid for r in done) != list(range(BURST)):
        raise RuntimeError("an int8 DCGAN request was dropped or answered "
                           "twice")
    if q_launches != {"float32": 0, "int8": 4 * len(qb.launches)} \
            or not qb.launches or eager:
        raise RuntimeError(f"int8 DCGAN kernel A launches {q_launches} "
                           f"replayed, {eager} eager")
    with torch.inference_mode():
        for r in done:
            one = gan.generator_apply(
                qparams, torch.from_numpy(lat[r.rid][None]).to(dev), qcfg)
            diff = (one[0].cpu() - torch.from_numpy(r.out)).abs()
            if not bool((diff <= TOL_ROW * (1 + one[0].cpu().abs())).all()):
                raise RuntimeError(f"int8 request {r.rid} differs from its "
                                   f"B=1 forward by {float(diff.max()):.3e}")
        zb = torch.from_numpy(lat).to(dev)
        yq = gan.generator_apply(qparams, zb, qcfg)
        yf = gan.generator_apply(params, zb, cfg)
    dcgan_rel = float((yq - yf).abs().max() / yf.abs().max())
    if not dcgan_rel <= len(qcfg.layers) / 127.0:
        raise RuntimeError(f"int8 DCGAN off its f32 twin: {dcgan_rel:.4f}")
    print(f"[serve DCGAN int8] {len(done)}/{BURST} answered once, batcher "
          f"launches {qb.launches}, kernel A launches {q_launches} "
          f"(= 4 captured x {len(qb.launches)} graph replays), every "
          f"bucket's replay bit-equal to its eager forward, rows == B=1 "
          f"forwards; output rel "
          f"L-inf vs the f32 twin {dcgan_rel:.4e} (bound "
          f"{len(qcfg.layers) / 127.0:.4f})")

    # ---- 3e. the U-Net, f32 and int8, on the 'cuda' route ------------------
    unet32 = dataclasses.replace(unet.UNET, backend="cuda")
    unet_serve, unet_launches = {}, {}
    u_params = {}
    for cfg_u, batches, want in (
            (unet32, UNET_32_BATCHES, {"A": 2, "B": 8, "C": 0, "D": 0}),
            (unet512, UNET_512_BATCHES, {"A": 1, "B": 4, "C": 4, "D": 1})):
        for wdtype in ("float32", "int8"):
            ucfg = dataclasses.replace(cfg_u, wdtype=wdtype)
            tcfg_u = dataclasses.replace(ucfg, backend="torch")
            params_u = unet.unet_init(6, ucfg, device=dev)
            u_params[(cfg_u.image_hw, wdtype)] = params_u
            key = f"unet{cfg_u.image_hw}_{wdtype}"
            unet_serve[key] = {}
            for bb in batches:
                gen_u = torch.Generator().manual_seed(bb)
                xu = torch.randn((bb, ucfg.image_hw, ucfg.image_hw,
                                  ucfg.in_c), generator=gen_u).to(dev)
                tu = torch.rand((bb,), generator=gen_u).to(dev)
                with torch.inference_mode():
                    zero_counts()
                    y_c = unet.unet_apply(params_u, xu, tu, ucfg)
                    torch.cuda.synchronize()
                    got, stray = read_counts(wdtype)
                    unet_launches[f"{key}_B{bb}"] = got
                    y_t = unet.unet_apply(params_u, xu, tu, tcfg_u)
                    torch.cuda.synchronize()
                if got != want or stray:
                    raise RuntimeError(f"{key} B={bb}: launches {got} "
                                       f"(+{stray} in the other dtype's "
                                       f"counters), want {want}")
                scale = float(y_t.abs().max())
                rel = float((y_c - y_t).abs().max()) / scale
                if not (rel <= TOL_UNET and y_c.shape == xu.shape
                        and bool(torch.isfinite(y_c).all())):
                    raise RuntimeError(f"{key} B={bb}: cuda vs torch "
                                       f"max|Δ|/max|y| {rel:.3e}")
                rec = {"cuda_vs_torch": rel, "launches": got}
                if wdtype == "int8":
                    with torch.inference_mode():
                        y32 = unet.unet_apply(
                            u_params[(cfg_u.image_hw, "float32")], xu, tu,
                            cfg_u)
                    dev8 = float((y_c - y32).abs().max())
                    ref32 = float(y32.abs().max())
                    rec["int8_vs_f32"] = (dev8, ref32)
                    if not dev8 < 0.15 * ref32 + 1e-3:
                        raise RuntimeError(f"{key} B={bb}: int8 twin off by "
                                           f"{dev8:.3e} (max|y32| "
                                           f"{ref32:.3e})")
                unet_serve[key][bb] = rec
                del y_c, y_t
            print(f"[serve U-Net {cfg_u.image_hw}px {wdtype}] per bucket: "
                  f"{json.dumps(unet_serve[key])} (tol {TOL_UNET}; int8 "
                  f"gate max|y8-y32| < 0.15 max|y32| + 1e-3)")
    xd = torch.randn((1, hw512, hw512, 3), generator=torch.Generator()
                     .manual_seed(9)).to(dev)
    denoise = {}
    for wdtype in ("float32", "int8"):
        ucfg = dataclasses.replace(unet512, wdtype=wdtype)
        with torch.inference_mode():
            unet.denoise_loop(u_params[(hw512, wdtype)], xd, ucfg, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = unet.denoise_loop(u_params[(hw512, wdtype)], xd, ucfg,
                                    DENOISE_STEPS)
            torch.cuda.synchronize()
        denoise[wdtype] = (time.perf_counter() - t0) * 1e3 / DENOISE_STEPS
        if not bool(torch.isfinite(out).all()) or out.shape != xd.shape:
            raise RuntimeError(f"512px {wdtype} denoise loop not finite")
    print(f"[serve U-Net] {DENOISE_STEPS}-step denoise_loop at 512px, B=1, "
          f"finite; ms per step (host clock, synchronized) "
          f"{json.dumps(denoise)} | {smi}")

    # ---- 4. times ------------------------------------------------------------
    sites = []
    for b in (1, 64):
        for i, l in enumerate(dc):
            pads = gan.deconv_padding(l.kernel, l.stride)
            plan = site(l.in_hw, l.in_c, l.out_c, l.kernel, l.stride, pads)
            x = randn(b, l.in_hw, l.in_hw, l.in_c)
            kern = randn(l.kernel, l.kernel, l.in_c, l.out_c)
            packed = plan.pack(kern)
            xg = pad_or_crop(x, plan.gpad)
            xl, wl, kw = library_args(x, kern, plan.spec.strides, pads)
            y_k = kernel_call(plan, xg, packed)
            lib_err = check_library(
                f"DC{i + 1} B={b}",
                F.conv_transpose2d(xl, wl, **kw).permute(0, 2, 3, 1), y_k)
            flops, nbytes = work_deconv(xg, packed, y_k, plan.phases)
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rec = {
                "site": f"DC{i + 1}", "batch": b, "flops": flops,
                "bytes": nbytes,
                "ms": time_ms(lambda: kernel_call(plan, xg, packed)),
                "device_ms": call_device_ms(
                    lambda: kernel_call(plan, xg, packed)),
                "plain_ms": time_ms(lambda: ref_call(plan, xg, packed)),
                "library_ms": time_ms(
                    lambda: F.conv_transpose2d(xl, wl, **kw)),
                "library_device_ms": call_device_ms(
                    lambda: F.conv_transpose2d(xl, wl, **kw)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_max_abs_err": lib_err,
                "schedule": schedule_of(plan, b)}
            sites.append(rec)
            if b == 1 and rec["schedule"]["units"] < SMS:
                raise RuntimeError(f"DC{i + 1} B=1: {rec['schedule']} leaves "
                                   f"SMs idle")
            dev_share = (None if rec["device_ms"] is None
                         else rec["bound_ms"] / rec["device_ms"])
            print(f"[time] DC{i + 1} B={b}: kernel {rec['ms']:.4f} ms "
                  f"(device {ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, library "
                  f"{rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel at "
                  f"{rec['bound_ms'] / rec['ms']:.1%} of bound "
                  f"({ms_text(dev_share, '.1%')} of its device "
                  f"time); schedule {json.dumps(rec['schedule'])}")
    gen_ms = {}
    with torch.inference_mode():
        for b in BATCH_BUCKETS:
            z = randn(b, cfg.z_dim)
            gen_ms[b] = time_ms(lambda: gan.generator_apply(params, z, cfg),
                                iters=10)
    print(f"[time] generator forward (4 kernel launches + proj/bias/act) "
          f"ms per bucket: {json.dumps(gen_ms)}")

    # ---- 4b. kernel B times, train-step times --------------------------------
    dsites = []
    for b in (1, 64):
        for name, h, c, n, k, s, pads in disc_sites():
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            sp = kern.reshape(k * k * c, n)
            xl, wl, kw = conv_library_args(xp, kern, (s, s), (1, 1))
            y_k = conv_call(xp, sp, k, s, 1)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            oh, ow = y_k.shape[1:3]
            flops, nbytes = work_conv(xp, sp, y_k)
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rec = {
                "site": name, "batch": b, "flops": flops, "bytes": nbytes,
                "ms": time_ms(lambda: conv_call(xp, sp, k, s, 1)),
                "device_ms": call_device_ms(
                    lambda: conv_call(xp, sp, k, s, 1)),
                "plain_ms": time_ms(
                    lambda: conv_call(xp, sp, k, s, 1, plain=True)),
                "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
                "library_device_ms": call_device_ms(
                    lambda: F.conv2d(xl, wl, **kw)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_max_abs_err": lib_err,
                "schedule": conv_schedule_of(b, oh, ow, k, c, n)}
            dsites.append(rec)
            if b == 1 and name.startswith("DCGAN") \
                    and not fills_card(rec["schedule"]):
                raise RuntimeError(f"{name} B=1: {rec['schedule']} leaves "
                                   f"SMs idle")
            dev_share = (None if rec["device_ms"] is None
                         else rec["bound_ms"] / rec["device_ms"])
            print(f"[time B] {name} B={b}: kernel {rec['ms']:.4f} ms "
                  f"(device {ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, library "
                  f"{rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel at "
                  f"{ms_text(dev_share, '.1%')} of bound by "
                  f"device time; schedule {json.dumps(rec['schedule'])}")

    def step_ms(cfg, b, iters=5):
        gp_, dp_ = gan.generator_init(4, cfg, device=dev), \
            gan.discriminator_init(5, cfg, device=dev)
        bt = GANPipeline(cfg, b, image_hw=64).batch_at(0)
        z_, r_ = (torch.from_numpy(bt[k]).to(dev) for k in ("z", "real"))
        for _ in range(2):
            train_gan.train_step(gp_, dp_, z_, r_, cfg, 2e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            gp_, dp_, _, _ = train_gan.train_step(gp_, dp_, z_, r_, cfg,
                                                  2e-4)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    def step_split(b, wall_ms):
        """One 'cuda' train step under ``torch.profiler``: device time of
        kernel A, kernel B and everything else (the backward products, the
        pads, the elementwise ops), summed over the device-side events only
        (an op's own entry repeats its kernels' time), and the idle share
        against ``wall_ms``, the step's time measured without the profiler
        (which slows the host); None where the profiler caught no trace."""
        gp_ = gan.generator_init(4, tcfg, device=dev)
        dp_ = gan.discriminator_init(5, tcfg, device=dev)
        bt = GANPipeline(tcfg, b, image_hw=64).batch_at(0)
        z_, r_ = (torch.from_numpy(bt[k]).to(dev) for k in ("z", "real"))
        for _ in range(2):
            train_gan.train_step(gp_, dp_, z_, r_, tcfg, 2e-4)
        torch.cuda.synchronize()
        _, evs = device_events(
            lambda: train_gan.train_step(gp_, dp_, z_, r_, tcfg, 2e-4), 1,
            with_cpu=True)
        out = {"A_ms": 0.0, "B_ms": 0.0, "other_ms": 0.0, "A_calls": 0,
               "B_calls": 0, "other_calls": 0}
        for ev in evs or ():
            part = kernel_part(ev.name)
            part = part if part in ("A", "B") else "other"
            out[f"{part}_ms"] += ev.device_time_total / 1e3
            out[f"{part}_calls"] += 1
        busy = out["A_ms"] + out["B_ms"] + out["other_ms"]
        out.update(device_busy_ms=busy, wall_ms=wall_ms,
                   idle_share=1 - busy / wall_ms if evs else None)
        return out

    train_ms = {f"{backend}_B{b}": step_ms(
        gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend=backend), b)
        for b in (TRAIN_BATCH, 64) for backend in ("cuda", "torch")}
    print(f"[time] DCGAN train step (full width; host clock over 5 steps "
          f"after 2, synchronized) ms: {json.dumps(train_ms)}")
    split = {f"B{b}": step_split(b, train_ms[f"cuda_B{b}"])
             for b in (TRAIN_BATCH, 64)}
    print(f"[time] DCGAN 'cuda' train step, device time by kernel "
          f"(torch.profiler, one step after 2): {json.dumps(split)}")

    # ---- 4c. the int8 entries' times -----------------------------------------
    def bound_of(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    def time_int8(name, b, work, kernel, f32_kernel, plain, library,
                  lib_err, schedule=None):
        """One int8 site's record: the int8 kernel against the f32 kernel
        on the dequantized weights, the plain version and the library call
        (already checked against the kernel); the bound is the call's
        ``work`` (FLOPs, bytes: the input, 1 B per code, 4 B per scale row
        and the f32 output).  With kernel A's, B's or D's ``schedule``,
        also the three calls' device times."""
        flops, nbytes = work
        bound, by = bound_of(flops, nbytes)
        rec = {"site": name, "batch": b, "flops": flops, "bytes": nbytes,
               "ms": time_ms(kernel), "f32_ms": time_ms(f32_kernel),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err}
        extra = ""
        if schedule is not None:
            rec.update(device_ms=call_device_ms(kernel),
                       f32_device_ms=call_device_ms(f32_kernel),
                       library_device_ms=call_device_ms(library),
                       schedule=schedule)
            extra = (f"; device ms int8 {ms_text(rec['device_ms'])}, f32 "
                     f"{ms_text(rec['f32_device_ms'])}, library "
                     f"{ms_text(rec['library_device_ms'])}; schedule "
                     f"{json.dumps(schedule)}")
        print(f"[time int8] {name} B={b}: int8 kernel {rec['ms']:.4f} ms, "
              f"f32 kernel {rec['f32_ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms, bound {bound:.4f} ms ({by}), int8 kernel at "
              f"{bound / rec['ms']:.1%} of bound" + extra)
        return rec

    print(f"[time int8] kernel E inside B at the SegNet sites, inside A at "
          f"the DCGAN sites, B = 1 and 64, CUDA events; card {smi}")
    i8_bsites, i8_asites = [], []
    for b in (1, 64):
        for name, h, c, n, k, s, d, pads in seg_sites():
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            q, scale, wd = int8_of(kern.reshape(k * k * c, n))
            xl, wl, kw = conv_library_args(xp, wd.reshape(k, k, c, n),
                                           (s, s), (d, d))
            y_k = conv_call(xp, q, k, s, d, scales=scale)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            oh, ow = y_k.shape[1:3]
            i8_bsites.append(time_int8(
                name, b, work_conv(xp, q, y_k, scale),
                lambda: conv_call(xp, q, k, s, d, scales=scale),
                lambda: conv_call(xp, wd, k, s, d),
                lambda: conv_call(xp, q, k, s, d, plain=True, scales=scale),
                lambda: F.conv2d(xl, wl, **kw), lib_err,
                schedule=conv_schedule_of(b, oh, ow, k, c, n)))
            if b == 1 and name in {f"SegNet_L{i}" for i in range(1, 9)} \
                    and not fills_card(i8_bsites[-1]["schedule"]):
                raise RuntimeError(f"{name} B=1: {i8_bsites[-1]['schedule']}"
                                   f" leaves SMs idle")
        for i, l in enumerate(dc):
            pads = gan.deconv_padding(l.kernel, l.stride)
            plan = site(l.in_hw, l.in_c, l.out_c, l.kernel, l.stride, pads)
            x = randn(b, l.in_hw, l.in_hw, l.in_c)
            q, scale, wd = int8_of(plan.pack(
                randn(l.kernel, l.kernel, l.in_c, l.out_c)))
            xg = pad_or_crop(x, plan.gpad)
            xl, wl, kw = library_args(x, plan.unpack(wd), plan.spec.strides,
                                      pads)
            y_k = kernel_call(plan, xg, q, scales=scale)
            lib_err = check_library(
                f"DC{i + 1} B={b}",
                F.conv_transpose2d(xl, wl, **kw).permute(0, 2, 3, 1), y_k)
            i8_asites.append(time_int8(
                f"DC{i + 1}", b, work_deconv(xg, q, y_k, plan.phases, scale),
                lambda: kernel_call(plan, xg, q, scales=scale),
                lambda: kernel_call(plan, xg, wd),
                lambda: ref_call(plan, xg, q, scales=scale),
                lambda: F.conv_transpose2d(xl, wl, **kw), lib_err,
                schedule=schedule_of(plan, b)))
    # ---- 4d. kernels C and D (f32, int8) at the 512 px U-Net's tiled sites
    print(f"[time tiled] kernels C and D at the tiled sites of the U-Net at "
          f"a 512 px image, B = 1 and 16, CUDA events; card {smi}")
    c_sites, d_sites, ci8_sites, di8_sites = [], [], [], []
    for b in UNET_512_BATCHES:
        for name, plan in tiled_c:
            sp_ = plan.spec
            (r, s_), st, tile = sp_.kernel_hw, sp_.strides[0], \
                plan.routes[0].sp_tiles
            x = randn(b, *sp_.in_hw, sp_.in_c)
            xp = pad_or_crop(x, sp_.padding).contiguous()
            kern = randn(r, s_, sp_.in_c, sp_.out_c)
            sp = kern.reshape(-1, sp_.out_c)
            q, scale, wd = int8_of(sp)
            xl, wl, kw = conv_library_args(xp, kern, (st, st), (1, 1))
            y_k = tiled_conv_call(xp, sp, r, s_, st, 1, tile)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            flops, nbytes = work_conv(xp, sp, y_k)
            bound, by = bound_of(flops, nbytes)
            rec = {"site": name, "batch": b, "flops": flops,
                   "bytes": nbytes, "tile": tile,
                   "schedule": tiled_schedule_of(
                       y_k.shape[1:3], r, s_, st, 1, sp_.in_c, sp_.out_c,
                       tile),
                   "ms": time_ms(lambda: tiled_conv_call(
                       xp, sp, r, s_, st, 1, tile)),
                   "plain_ms": time_ms(lambda: tiled_conv_call(
                       xp, sp, r, s_, st, 1, tile, plain=True), iters=5),
                   "whole_plane_ms": time_ms(lambda: conv_call(
                       xp, sp, r, st, 1)) if r == s_ else None,
                   "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
                   "bound_ms": bound, "bound_by": by,
                   "library_max_abs_err": lib_err}
            c_sites.append(rec)
            print(f"[time C] {name} B={b} tile {tile}: kernel "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                  f"kernel B (whole plane) {rec['whole_plane_ms']:.4f} ms, "
                  f"library {rec['library_ms']:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), kernel at {bound / rec['ms']:.1%}"
                  f" of bound; schedule {rec['schedule']}")
            xl8, wl8, kw8 = conv_library_args(
                xp, wd.reshape(r, s_, sp_.in_c, sp_.out_c), (st, st),
                (1, 1))
            y_k8 = tiled_conv_call(xp, q, r, s_, st, 1, tile, scales=scale)
            lib_err8 = check_library(
                f"{name} int8 B={b}",
                F.conv2d(xl8, wl8, **kw8).permute(0, 2, 3, 1), y_k8)
            ci8_sites.append(time_int8(
                f"C {name}", b, work_conv(xp, q, y_k8, scale),
                lambda: tiled_conv_call(xp, q, r, s_, st, 1, tile,
                                        scales=scale),
                lambda: tiled_conv_call(xp, wd, r, s_, st, 1, tile),
                lambda: tiled_conv_call(xp, q, r, s_, st, 1, tile,
                                        plain=True, scales=scale),
                lambda: F.conv2d(xl8, wl8, **kw8), lib_err8))
            del xp, x, y_k, y_k8, xl, xl8
        for name, plan in tiled_d:
            sp_ = plan.spec
            tile = plan.routes[0].sp_tiles
            x = randn(b, *sp_.in_hw, sp_.in_c)
            xg = pad_or_crop(x, plan.gpad).contiguous()
            kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
            packed = plan.pack(kern)
            q, scale, wd = int8_of(packed)
            # the library: F.conv_transpose2d at padding 0, cropped (one
            # call and a view; phase 2f held it to the f64 bound)
            xl, wl, kw, crop = cropped_library_args(x, kern, sp_.strides,
                                                    sp_.padding)
            _, wl8, _, _ = cropped_library_args(x, plan.unpack(wd),
                                                sp_.strides, sp_.padding)

            def library(w_=wl):
                return F.conv_transpose2d(xl, w_, **kw)[:, :, crop[0],
                                                        crop[1]]
            y_k = tiled_deconv_call(plan, xg, packed, tile)
            lib_err = check_library(f"{name} B={b}",
                                    library().permute(0, 2, 3, 1), y_k)
            flops, nbytes = work_deconv(xg, packed, y_k, plan.phases)
            bound, by = bound_of(flops, nbytes)
            sched = tiled_deconv_schedule_of(plan, sp_.in_c, sp_.out_c,
                                             tile)
            rec = {"site": name, "batch": b, "flops": flops,
                   "bytes": nbytes, "tile": tile, "schedule": sched,
                   "ms": time_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile)),
                   "device_ms": call_device_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile)),
                   "plain_ms": time_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile, plain=True), iters=5),
                   "whole_plane_ms": time_ms(lambda: kernel_call(
                       plan, xg, packed)),
                   "library_ms": time_ms(library),
                   "library_device_ms": call_device_ms(library),
                   "bound_ms": bound, "bound_by": by,
                   "library_max_abs_err": lib_err}
            d_sites.append(rec)
            print(f"[time D] {name} B={b} tile {tile}: kernel "
                  f"{rec['ms']:.4f} ms (device "
                  f"{ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, kernel A (whole plane) "
                  f"{rec['whole_plane_ms']:.4f} ms, library (cropped "
                  f"F.conv_transpose2d) {rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{bound:.4f} ms ({by}), kernel at {bound / rec['ms']:.1%}"
                  f" of bound; schedule {sched}")
            y_k8 = tiled_deconv_call(plan, xg, q, tile, scales=scale)
            lib_err8 = check_library(f"{name} int8 B={b}",
                                     library(wl8).permute(0, 2, 3, 1), y_k8)
            di8_sites.append(time_int8(
                f"D {name}", b, work_deconv(xg, q, y_k8, plan.phases, scale),
                lambda: tiled_deconv_call(plan, xg, q, tile, scales=scale),
                lambda: tiled_deconv_call(plan, xg, wd, tile),
                lambda: tiled_deconv_call(plan, xg, q, tile, plain=True,
                                          scales=scale),
                lambda: library(wl8), lib_err8, schedule=sched))
            del x, xg, xl, y_k, y_k8
    unet_ms = {}
    with torch.inference_mode():
        for cfg_u, batches in ((unet32, BATCH_BUCKETS),
                               (unet512, UNET_512_BATCHES)):
            for wdtype in ("float32", "int8"):
                ucfg = dataclasses.replace(cfg_u, wdtype=wdtype)
                pu = u_params[(cfg_u.image_hw, wdtype)]
                for bb in batches:
                    xu = randn(bb, ucfg.image_hw, ucfg.image_hw, ucfg.in_c)
                    tu = torch.rand((bb,), device=dev)
                    unet_ms[f"unet{cfg_u.image_hw}_{wdtype}_B{bb}"] = \
                        time_ms(lambda: unet.unet_apply(pu, xu, tu, ucfg),
                                iters=5, warmup=2)
    print(f"[time] U-Net forward ms per bucket (CUDA events): "
          f"{json.dumps(unet_ms)}")

    def unet_split(pu, ucfg, b, wall_ms):
        xu = randn(b, ucfg.image_hw, ucfg.image_hw, ucfg.in_c)
        tu = torch.rand((b,), device=dev)
        return forward_split(lambda: unet.unet_apply(pu, xu, tu, ucfg),
                             wall_ms)

    unet_split_512 = {
        f"{wdtype}_B{bb}": unet_split(
            u_params[(hw512, wdtype)], dataclasses.replace(unet512,
                                                           wdtype=wdtype),
            bb, unet_ms[f"unet{hw512}_{wdtype}_B{bb}"])
        for wdtype in ("float32", "int8") for bb in UNET_512_BATCHES}
    print(f"[time] U-Net 512px forward, device time by kernel "
          f"(torch.profiler, one forward after one): "
          f"{json.dumps(unet_split_512)}")

    print(json.dumps({"card": smi, "sites": sites, "generator_ms": gen_ms,
                      "disc_sites": dsites, "train_step_ms": train_ms,
                      "train_step_device_split": split,
                      "int8_segnet_sites": i8_bsites,
                      "int8_dcgan_sites": i8_asites,
                      "segnet_serve": seg_serve,
                      "dcgan_int8_rel_err": dcgan_rel,
                      "tiled_c_sites": c_sites, "tiled_d_sites": d_sites,
                      "tiled_c_int8_sites": ci8_sites,
                      "tiled_d_int8_sites": di8_sites,
                      "unet_serve": unet_serve, "unet_forward_ms": unet_ms,
                      "unet512_device_split": unet_split_512,
                      "unet512_denoise_ms_per_step": denoise}))

    lm_records, f_entry = lm_phases(dev, peak_bw, peak_bf16, time_ms, gen)
    f_entry["ptxas"] = f_ptxas
    print(json.dumps({"card": smi, **lm_records}))

    fam_records, fam_paths, fam_times = lm_family_phases(
        dev, peak_bw, peak_bf16, time_ms, gen)
    f_entry["launches_by_path"].update(fam_paths)
    f_entry["launches"] = sum(f_entry["launches_by_path"].values())
    f_entry["gemma3_layers"] = fam_times
    print(json.dumps({"card": smi, **fam_records}))

    moe_records, moe_paths, moe_times = lm_moe_phases(
        dev, peak_bw, peak_bf16, time_ms, gen)
    f_entry["launches_by_path"].update(moe_paths)
    f_entry["launches"] = sum(f_entry["launches_by_path"].values())
    f_entry["moe_family_layers"] = moe_times
    print(json.dumps({"card": smi, **moe_records}))

    s2t_records, s2t_paths, s2t_times = seamless_phases(
        dev, peak_bw, peak_bf16, time_ms, gen)
    train_records, train_paths = lm_train_phases(dev, peak_bw, peak_bf16,
                                                 time_ms, gen)
    f_entry["launches_by_path"].update({**s2t_paths, **train_paths})
    f_entry["launches"] = sum(f_entry["launches_by_path"].values())
    f_entry["seamless_layers"] = s2t_times
    print(json.dumps({"card": smi, **s2t_records, **train_records}))

    vae_records, vae_paths = vae_phases(dev, smi, peak_flops, peak_bw, gen)
    print(json.dumps({"card": smi, **vae_records}))

    cp_records, cp_paths = control_plane_phases(dev, smi, gen)
    print(json.dumps({"card": smi, **cp_records}))

    # the image phases' weights, planes and batchers (with their CUDA
    # graphs' memory pools) are done with: the mesh phases' ranks share the
    # card beside this process
    import gc
    params = batcher = gen_fn = gp = dp = gp0 = dp0 = z0 = real0 = None
    pipe = out_c = out_t = out_n = qparams = qb = qgen_fn = None
    sb = seg_fn = sparams = u_params = params_u = xu = xd = denoise = None
    gp_ = dp_ = None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mem] before the mesh phases this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
          f"({torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB reserved)")

    dry_records, _ = dryrun_phases(dev, smi)
    print(json.dumps({"card": smi, **dry_records}))

    pp_records, pp_paths = plane_parallel_phases(dev, smi)
    print(json.dumps({"card": smi, **pp_records}))

    mesh_records, mesh_paths = mesh_phases(dev, smi)
    print(json.dumps({"card": smi, **mesh_records}))
    f_entry["launches_by_path"].update(mesh_paths["F"])

    mt_records, mt_paths = mesh_train_phases(dev, smi)
    print(json.dumps({"card": smi, **mt_records}))
    f_entry["launches_by_path"].update(mt_paths["F"])

    ms_records, ms_paths = mesh_serve_phases(dev, smi)
    print(json.dumps({"card": smi, **ms_records}))
    f_entry["launches_by_path"].update(ms_paths["F"])

    mr_records, mr_paths = mesh_rest_phases(dev, smi)
    print(json.dumps({"card": smi, **mr_records}))
    f_entry["launches_by_path"].update(mr_paths["F"])
    f_entry["launches"] = sum(f_entry["launches_by_path"].values())

    mx_records, mx_paths, mx_rows = mesh_splits_phases(dev, smi)
    print(json.dumps({"card": smi, **mx_records}))

    # ---- 5. the kernels line, the card line, the result line ---------------
    def sums(recs):
        t_ops = sum(r["flops"] for r in recs) / peak_flops * 1e3
        t_bytes = sum(r["bytes"] for r in recs) / peak_bw * 1e3
        lib = [r["library_ms"] for r in recs]
        out = {"ms": sum(r["ms"] for r in recs),
               "plain_ms": sum(r["plain_ms"] for r in recs),
               "bound_ms": sum(r["bound_ms"] for r in recs),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None if None in lib else sum(lib)}
        if all(r.get("device_ms") is not None
               and r.get("library_device_ms") is not None for r in recs):
            out.update(device_ms=sum(r["device_ms"] for r in recs),
                       library_device_ms=sum(r["library_device_ms"]
                                             for r in recs))
        return out

    def unet_paths_of(kern_, wdtype):
        return {k: v[kern_] for k, v in unet_launches.items()
                if f"_{wdtype}_" in k and v[kern_]}

    a_paths = {"serve_dcgan": launches, "train_dcgan": train_launches["A"],
               **unet_paths_of("A", "float32"), **vae_paths["A"],
               **cp_paths["A"], **pp_paths["A"], **mesh_paths["A"],
               **mr_paths["A"], **mx_paths["A"]}
    b_paths = {"train_dcgan": train_launches["B"],
               "serve_segnet": seg_launches["float32"],
               **unet_paths_of("B", "float32"), **vae_paths["B"],
               **cp_paths["B"], **pp_paths["B"], **mesh_paths["B"],
               **mr_paths["B"], **mx_paths["B"]}
    ai8_paths = {**unet_paths_of("A", "int8"), **vae_paths["A_int8"],
                 **mesh_paths["A_int8"], **mr_paths["A_int8"],
                 **mx_paths["A_int8"]}
    bi8_paths = {**unet_paths_of("B", "int8"), **vae_paths["B_int8"],
                 **mesh_paths["B_int8"], **mr_paths["B_int8"],
                 **mx_paths["B_int8"]}
    c_paths = {**unet_paths_of("C", "float32"), **pp_paths["C"],
               **mx_paths["C"]}
    d_paths = {**unet_paths_of("D", "float32"), **pp_paths["D"],
               **mx_paths["D"]}
    ci8_paths = {**unet_paths_of("C", "int8"), **mx_paths["C_int8"]}
    di8_paths = {**unet_paths_of("D", "int8"), **mx_paths["D_int8"]}
    for kern_, paths_ in (("C", unet_paths_of("C", "float32")),
                          ("D", unet_paths_of("D", "float32")),
                          ("C int8", ci8_paths), ("D int8", di8_paths)):
        if sum(paths_.values()) == 0:
            raise RuntimeError(f"kernel {kern_} never launched on the "
                               f"U-Net path")
    big = UNET_512_BATCHES[-1]
    kernels = [{
        "name": "untangled_deconv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:373",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_deconv_kernel",
        "launches": sum(a_paths.values()), "launches_by_path": a_paths,
        "held_against_plain": True, "max_abs_err": max_err,
        "shape": "DCGAN generator, 4 sites, B=64 (sums)",
        **sums([r for r in sites if r["batch"] == 64]),
        "B1": sums([r for r in sites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_superpack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:77",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_kernel",
        "launches": sum(b_paths.values()), "launches_by_path": b_paths,
        "held_against_plain": True, "max_abs_err": max_err_b,
        "shape": "DCGAN discriminator, 4 sites, B=64 (sums)",
        **sums([r for r in dsites if r["batch"] == 64
                and r["site"].startswith("DCGAN")]),
        "B1": sums([r for r in dsites if r["batch"] == 1
                    and r["site"].startswith("DCGAN")])}, {
        "name": "untangled_deconv2d_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _deconv_kernel",
        "launches": q_launches["int8"] + sum(ai8_paths.values()),
        "launches_by_path": {"serve_dcgan_int8": q_launches["int8"],
                             **ai8_paths},
        "held_against_plain": True, "max_abs_err": max_err_ai8,
        "shape": "DCGAN generator int8, 4 sites, B=64 (sums)",
        **sums([r for r in i8_asites if r["batch"] == 64]),
        "B1": sums([r for r in i8_asites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _kernel",
        "launches": seg_launches["int8"] + sum(bi8_paths.values()),
        "launches_by_path": {"serve_segnet_int8": seg_launches["int8"],
                             **bi8_paths},
        "held_against_plain": True, "max_abs_err": max_err_bi8,
        "shape": "SegNet int8, 10 sites, B=64 (sums)",
        **sums([r for r in i8_bsites if r["batch"] == 64]),
        "B1": sums([r for r in i8_bsites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_tiled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:158",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tiled_kernel "
                      "+ _halo_stream",
        "launches": sum(c_paths.values()), "launches_by_path": c_paths,
        "row_block_launches": mx_rows["C"],
        "held_against_plain": True, "max_abs_err": max_err_c,
        "shape": f"U-Net 512px tiled sites stem, down0, fuse0, head, "
                 f"B={big} (sums)",
        **sums([r for r in c_sites if r["batch"] == big])}, {
        "name": "untangled_deconv2d_tiled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:503",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::"
                      "_deconv_tiled_kernel + _halo_stream",
        "launches": sum(d_paths.values()), "launches_by_path": d_paths,
        "row_block_launches": mx_rows["D"],
        "held_against_plain": True, "max_abs_err": max_err_d,
        "shape": f"U-Net 512px up0, B={big}",
        **sums([r for r in d_sites if r["batch"] == big])}, {
        "name": "untangled_conv2d_tiled_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _tiled_kernel",
        "launches": sum(ci8_paths.values()), "launches_by_path": ci8_paths,
        "row_block_launches": mx_rows["C_int8"],
        "held_against_plain": True, "max_abs_err": max_err_ci8,
        "shape": f"U-Net 512px int8 tiled sites, B={big} (sums)",
        **sums([r for r in ci8_sites if r["batch"] == big])}, {
        "name": "untangled_deconv2d_tiled_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _deconv_tiled_kernel",
        "launches": sum(di8_paths.values()), "launches_by_path": di8_paths,
        "row_block_launches": mx_rows["D_int8"],
        "held_against_plain": True, "max_abs_err": max_err_di8,
        "shape": f"U-Net 512px int8 up0, B={big}",
        **sums([r for r in di8_sites if r["batch"] == big])}, f_entry]
    for k in kernels:
        print(f"[kernels] {k['name']} <- {k['tpu_kernel']}: {k['launches']} "
              f"launches on the main path, held against its plain version")
    print(f"[done] every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
