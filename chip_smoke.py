#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port only (inverseproblemwithdiffusionmodel_tpu_torch; no JAX) in
phases, each printing one line with its own seconds:

1. device: the card, torch and CUDA versions, nvidia-smi's name and power
   limit. Exits non-zero, printing no result, where torch sees no card.
2. build: one nvcc -c per ops/csrc/*.cu, all started together, linked into
   one library with a plain C interface, loaded with ctypes; prints
   ptxas' register and shared-memory lines for every kernel.
3. kernels: K1 (FIR 2x up) and K2 (FIR 2x down) against their plain PyTorch
   versions at the 36 shapes one FFHQ-256 NCSN++ forward gives them, at
   batch 2 (sampling) and batch 8 (training); each kernel, its plain
   version and one library call computing the same function (a depthwise
   conv, the yardstick) timed device-only (graph_ms: 20 calls captured in
   a CUDA graph, its replay timed by CUDA events), the kernel also with
   the host's gaps (CUDA events around 20 launches from the host), beside
   the least time the card could take; per shape and summed per forward
   at each batch. Then the host's µs per launch at the smallest shape,
   through the launching wrapper and through the public op.
   kernels_bwd: the K3 backward (K2 as the backward of an up pass, K1 as
   the backward of a down pass) at the 30 shapes one training step gives
   it, batch 8: the gradients of the autograd Functions against the plain
   transposes, then timed like the forward.
   kernels_bf16: the bf16 forms of K1 and K2 at the same 36 forward
   shapes (batch 2 and 8) and of the K3 backward at the same 30 shapes:
   each against its bf16 plain version at 1 bf16 ulp of the largest
   |value| (and the count of elements that differ at all), and against
   the float32 kernel's output rounded once at 2 ulps; timed as the
   float32 forms, beside the bf16 byte bound and the same depthwise conv
   in bf16.
   flr: K4 (fused bias + leaky ReLU, forward and backward) at three shapes
   in float32 and in bf16, forward, dx and db against the plain versions
   (bf16: 1 bf16 ulp of the largest |value|, counting the elements that
   differ at all), timed; no single PyTorch call computes it, so it has no
   library yardstick.
4. model: the full-width FFHQ-256 NCSN++ (65.6 M parameters, weights drawn
   from seed 0) forward on the card against the same model on the CPU, at
   batch 1 and, in the float32 mode, at batch 2, and the kernels' launch
   counts over that forward (18 each).
5. sample: scripts.pc_sampling.main with that config at num_scales 50
   (reduced from 2000), 2 samples: finite samples, 100 network evaluations
   (the nfe it prints) and the first forward, 18 launches of each kernel
   per evaluation; and a
   tiny PC run on the card against the same run on the CPU, fed the same
   noise.
6. train: training.fit with make_continuous_score_train_step on the
   full-width FFHQ-256 NCSN++ (seeded weights), seeded synthetic images,
   batch 8 (reduced from 64, the leaf's), Adam at the leaf's lr and
   grad_clip, torch defaults (TF32 on), 6 steps into a temporary log_dir:
   finite losses, step 6, parameters moved, the EMA equals its formula over
   the run, a checkpoint, and per step 18 launches of K1 and of K2 forward,
   18 of K2 and 12 of K1 as the backward (the 6 input-pyramid downs act on
   data and need no gradient). Seconds per step, images/s, peak memory.
7. train_parity: one step of the full-width net at batch 1 on the card and
   on the CPU, same weights, batch and injected t and z, TF32 off: loss
   difference and relative L2 of the gradients over all parameters.
8. sample_ckpt: scripts.pc_sampling.main --ckpt_dir on the trained run's
   checkpoint, num_scales 10: the restored step, finite samples, 20
   network evaluations and the first forward, 18 launches of each kernel
   per evaluation.
9. ncsnv2: the ACDC config's NCSNv2Deepest at full width (256 px, ngf
   128, 94.1 M parameters, weights drawn from seed 0) through
   make_score_fn on channel-last x, as the reconstruction calls it: card
   against CPU at batch 2 in the float32 mode, then the forward at batch
   32 (the reconstruction's) with torch's defaults and in bf16: device ms,
   host ms, peak memory; beside them the same forwards on the bare
   permute of x, which torch runs in NHWC, and in a channels-last net.
10. recon: samplers.ald_pair.make_stepped_pair_reconstructor at bench.py's
   geometry (16 chains, 4 coils, R = 8, the ladder cut to 8 of 2311
   levels, 3 inner steps, CG 4, lr_scaled 5.0, denoising), the net in
   float32 (torch's defaults) and in bf16: one warm-up and 2 timed runs,
   each ended by a host read; chain-steps/s from the fastest, peak memory,
   finite outputs; one level step timed and profiled (top device kernels
   and operators, launches per inner step, the device's idle share); bf16
   against float32; one chain on the card against the CPU, same noise,
   float32 mode: the score at the first and last levels, the proximal's
   correction at the step's c and at c = 1, and a whole inner step at the
   first and last levels.
10b. sense: the README's headline ACDC SENSE CLI,
   scripts.acdc_SENSE_real_img.main, at full width (NCSNv2Deepest 256 px,
   ngf 128, seed 0; 16 chains, R = 8, 4 coils, its chains in pair form
   (make_stepped_pair_reconstructor, CG 8 on the normal kernel; the
   operator built from the complex64 SENSE), lr_scaled 5.0, --override
   recons.num_classes=4: the 348 -> 0.01 ladder cut from 2311 levels to
   4), torch's defaults: chain-steps/s of the sampler alone (between CUDA
   synchronizations, the set-up apart), wall s, peak memory, the NRMSE and
   SSIM it prints (finite; the weights are random), its artifacts; the
   single-coil script with SingleCoil (the complex sampler on cuFFT) and
   the SENSE script guided
   (--seg_start_time 0.5, the seg UNet from seed 0), 4 chains each. Then,
   in the float32 mode: cuFFT's i2k / k2i against the pair DFT at 256 px;
   samplers.ald.ald_inverse_seg_proximal_real_imag against
   make_stepped_pair_reconstructor on the recon geometry (same weights,
   CG 4, the same injected noise; 4 levels), level by level, gated after
   the first level; the complex sampler card vs CPU at 32 px (ngf 8, 2 levels);
   SENSE's adjointness on the card.
10c. map_tv: the MAP and TV baselines at the ACDC geometry (NCSNv2Deepest
   256 px, ngf 128, seed 0; the ACDC loader's synthetic test slice),
   torch's defaults: acdc_SENSE_MAP.main (4 coils, R = 8, lamda 0.1, the
   config's 200 Adam iterations), acdc_MAP.main and
   acdc_MAP_keep_center.main (20 of the 200 iterations) and
   acdc_SENSE_TV.main (4 coils, R = 8, 200 iterations; its TV objective
   must fall below the one at A^H y): iterations/s of the optimizer alone
   (between CUDA synchronizations, the set-up apart), wall s, peak memory,
   NRMSE / SSIM (finite); one MAP iteration split by CUDA events (the net
   at batch 2, the data gradient, the Adam update) and profiled (launches
   per iteration, the device's idle share). In the float32 mode: the first
   ascent directions of map_optimizer, map_optimizer_pair and the stepped
   pair optimizer (and of the two TV forms) at three starts, gated at 1e-5
   from zero and at 1e-5 times the data term's cancellation factor kappa
   at and near A^H y; the forms after 200 iterations within the bounds of
   tests/test_torch_map_long.py, which a doubled-weight control must
   break; a tiny MAP direction card vs CPU.
11. serve: the serving entry point at the recon geometry (the ladder cut
   to 2 levels), for f32 and bf16: scripts.serve_recon.build_engine
   (weights from seed 0), the engine's warm-up, 3 requests over HTTP on
   127.0.0.1 (npz in and out: the default operator; a new R = 8 mask with
   lr_scaled 3.0; new coil maps) and one in-process request: shapes,
   finite values, headers, /healthz's request count, one input signature,
   chain-steps/s per request, warm-up seconds, peak memory; the f32
   engine against make_stepped_pair_reconstructor on the same problem and
   seed in the float32 mode; a guided bf16 engine (the full-width seg
   UNet, seed 0) on a disk label, one request over HTTP and one
   in-process; card against
   CPU on one chain: a guided inner step at the last level (float32
   mode), the guidance gradient in float64, and the card's float32
   gradient against the float64 one.
12. cine: the 2D+time serving path at README's cine geometry (CINE127,
   128 px, T = 24, 4 coils, per-frame R = 8 masks; spatial NCSNv2Deepest
   and temporal NCSN1D on 8 x 8 pixel tubes, ngf 128 each, seed 0; 4
   chains, the ladder cut to 2 of 1000 levels), for f32 and bf16:
   scripts.serve_recon.build_engine --workload cine, its warm-up, 3
   requests over HTTP (default operator; new per-frame masks with
   lr_scaled 3.0; new coil maps) and one in-process with lamda_T 0.5:
   shapes, finite values, headers, /healthz, one input signature,
   chain-steps/s, warm-up, peak memory, the host's seconds for a
   request's operator and (T, W, W) normal kernel; the f32 engine against
   make_stepped_2d_time_pair_reconstructor (same card, TF32); bf16
   against f32; a level step with a temporal step split by CUDA events into the
   spatial net, the temporal step and net, the proximal and the rest,
   and profiled; card against CPU: the full-width NCSN1D and one inner
   step on one chain, random shift off and on.
12b. cine_complex: the complex 2D+time CLIs at the cine geometry (CINE127
   128 px, T = 24, 4 coils, R = 8; both nets ngf 128, seed 0), torch's
   defaults: cine_SENSE_real_img_2d_time.main (4 chains, diffusion1d,
   lr_scaled 5.0, CG 8 on cuFFT, 4 of the 1000 levels): chain-steps/s of
   ald_2d_time alone, wall s, peak memory, NRMSE / SSIM (finite), and the
   ratio to Stepped2DTimePairReconstructor on the same problem and seed;
   in the float32 mode on one chain the complex form against the pair form
   level by level, gated after levels 0 and 3 at 1e-4; the modes tv, none
   and tv-only at 2 levels (finite); cine_SENSE_real_img_2d_time_MAP.main
   (1 chain, 20 of the 200 iterations): iterations/s, peak memory;
   cine_inv_sampling_keep_center_prox_real_imag.main (4 chains, 4 levels):
   chain-steps/s.
13. train_ncsn: discrete score training through scripts.train_ncsn.main
   on the loaders' synthetic stand-ins (train_ncsn_phase): ACDC
   real-imag, NCSNv2Deepest at full width (256 px, ngf 128, seed 0), at
   the recipe's batch 3 and the README's batch 8 in f32, batch 8 in bf16
   with and without --remat, --grad_accum 2 at batch 3; CINE127_1D
   real-imag, NCSN1D (ngf 128, 8 x 8 tubes of 24 frames, batch 90,
   filter_th 0.05) in f32 and bf16. s/step and images/s after the first
   step, each step timed between CUDA synchronizations; the first step's
   peak memory and the steady peak; seconds saving checkpoints; the EMA
   against its formula; the share of tube rows the filter keeps. Then
   serve_recon.build_engine --ckpt_dir on the batch-8 f32 run (the
   restored step, its EMA weights, one finite request), and one step of
   each net card against CPU in the float32 mode (loss, gradients,
   parameters, EMA) and bf16 against f32. Phases 9 to 13 launch none of
   K1, K2 or K4 (checked).
14. train_bf16: training.fit with the continuous step at compute_dtype
   bf16 (the JAX package's mixed-precision cast) on the FFHQ-256 NCSN++ at
   batch 8 (as phase 6 runs it in f32), and on the CIFAR-10 VP NCSN++
   (vp/cifar10_ncsnpp_continuous at full width: nf 128, ch_mult (1, 2, 2,
   2), 4 res blocks, FIR, positional embedding; 62,693,251 parameters) at
   the leaf's batch 128 in f32 and bf16, seeded weights and data, 6 steps
   each: finite losses, parameters moved, the EMA against its formula,
   s/step and images/s after the first step, peak memory, and per step
   exactly the bf16 K1/K2 launches of the forward and the K3 backward (no
   float32 FIR launch in a bf16 step). Then one CIFAR-10 VP step at batch
   8 card vs CPU in the float32 mode (loss, gradients) and bf16 vs f32 on
   the card (the loss, and a floor on the gradient's distance).
15. sample_vp: scripts.pc_sampling.main at full width, 16 samples,
   num_scales cut from 1000 (232 for NCSNv2) to 100, on
   vp/cifar10_ncsnpp_continuous and subvp/cifar10_ncsnpp_continuous
   (Euler-Maruyama; K1/K2), vp/cifar10_ddpmpp_continuous (naive
   resampling), vp/ddpm/cifar10 (DDPM, ancestral) and ve/ncsnv2/cifar10
   (the `ald` corrector through the channel-last adapter): finite
   samples, the printed nfe, K1/K2 launches per network evaluation,
   evaluations/s; --ckpt_dir on phase 14's bf16 CIFAR-10 VP checkpoint
   with 10 scales; a tiny VP PC run card vs CPU, same noise.
16. quickstart_3d: the README quick start's pair and the 3-D temporal
   prior at full width (weights from seed 0), torch's defaults:
   scripts.unconditioned_sampling.main --ds_name MNIST (NCSNv2Deepest 32
   px, ngf 128; 8 samples, the ladder cut from 232 to 29 levels x 5 steps,
   and the denoise): the sampler's network evaluations/s (the set-up
   apart), wall s, peak, finite (8, 32, 32, 1) samples;
   scripts.train_ncsn.main --ds_name MNIST (synthetic digits, the config's
   batch 128, 5 steps): s/step, images/s, peak; --task_name Diffusion3D on
   CINE127_1D (NCSN3DShallow, ngf 128, 8 x 8 tubes of 24 frames as
   volumes, the config's batch 90, 5 steps): s/step, peak; one step of
   each at batch 1 card vs CPU in the float32 mode (loss, gradient);
   NCSN3DShallow on tubes and volumes and NCSN3D on volumes card vs CPU at
   batch 2 (float32 mode); the NCSN3DShallow forward at the cine CLI's
   tube batch (2048: Re and Im of 4 chains x 256 tubes) through
   make_tube_score_fn_3d: device and host ms, peak, the convolutions' FLOP
   and rate, a profile's top kernels and operators; UNET1D (its own width)
   card vs CPU at batch 2 and one forward at that tube batch;
   unconditioned_sampling --task_name Diffusion3D and Diffusion1D on
   CINE127_1D, 8 samples, the 400-level ladder cut to 20;
   cine_SENSE_real_img_2d_time.main --task_name_T Diffusion3D and the same
   call with Diffusion1D at the cine_complex geometry (4 chains, 2 of 1000
   levels, CG 8 on cuFFT): chain-steps/s of the sampler alone, their
   ratio, each net's device ms by CUDA events around its calls;
   cine_SENSE_real_img_2d_time_MAP.main with Diffusion3D (1 chain, 10 of
   200 iterations): iterations/s.
17. guided: the guidance nets' training and the guided samplers at full
   width (weights from seed 0), torch's defaults: scripts.train_clf.main
   --ds_name MNIST (ResNetClf, the synthetic digits, the config's batch
   512) and scripts.train_seg.main --ds_name ACDC (the general config's
   UNet, 64-1024 channels, the synthetic 256 px slices, batch 8), 5 steps
   each: s/step, images/s, peaks; one step of each card vs CPU (float32
   mode; the seg UNet's gradient also in float64, since its float32
   gradient loses digits in the instance norms on any device); the seven
   samplers of samplers/ald_variants on MNIST's NCSNv2Deepest (32 px, ngf
   128) and the ResNetClf at 8 chains, the ladder cut from 232 to 20
   levels x 5 steps: finite outputs, evaluations/s, the score net's and
   the classifier gradient's shares by CUDA events; one level of each
   card vs CPU, the same noise, float32 mode; mnist_inv_clf_sampling
   (--lamda 0.01) and mnist_inv_clf_prox_sampling at 8 samples on the cut
   ladder and mnist_MAP (200 of 15000 iterations) through timed_cli.
18. natural: NCSN v1, the probability-flow ODE sampler and the
   natural-image discrete configs at full width (natural_phase): K1 / K2
   at the 12 calls of one vp/cifar10_ncsnpp_continuous forward at the
   ODE's batch of 16 against their plain versions, timed;
   pc_sampling.main --method ode on that leaf (16 samples, seeded
   weights): finite samples, the printed nfe (sde.N, as JAX), the score
   evaluations by a counting wrapper, odeint's accepted / rejected steps,
   K1 / K2 launches per evaluation, the sampler's evaluations/s, peak; a
   tiny NCSN++ ODEs card vs CPU (VP and VE leaves, the same steps);
   pc_sampling.main on ve/ncsn/cifar10 (NCSN v1, 16 samples, 10 levels x
   25 ALD steps, cut from the leaf's 100); the v1 forward card vs CPU;
   training.fit with the
   continuous step on discrete labels at the leaf's batch 128 (5 steps)
   and one step card vs CPU; train_ncsn.main --ds_name CELEBA (64 px, the
   config's batch 128, 5 steps on the synthetic stand-in);
   unconditioned_sampling.main --ds_name CIFAR10 (8 chains, 20 of 232
   levels). Only the ODE path launches K1 / K2 (checked).
18b. migrate (migrate_phase, after guided): the migration path at full
   width, weights from seeds, files in a temporary directory outside the
   checkout. The ACDC NCSNv2Deepest (256 px, ngf 128) written as a
   reference Lightning .ckpt (export_ncsn_state_dict; EMA and raw copies),
   scripts.import_torch_checkpoint --ds_name ACDC (and --raw_weights,
   which must take the raw copy), the imported net's forward against the
   source's on the card bit for bit, then acdc_SENSE_real_img --ckpt_dir
   on the import (16 chains, 2 levels); the CINE127_1D NCSN1D alike, its
   forward only; the FFHQ-256 NCSN++ as a reference all_modules .pth,
   import_torch_checkpoint --continuous, its forward bit for bit, then
   pc_sampling --ckpt_dir on it, whose K1 / K2 launches are counted.
   train_ncsn --ds_name ACDC (batch 8, 4 steps) on the native C++ batcher
   (its batches held to the plain version's for the seed) and with
   --no_native_loader: s/step and the host's batch-wait seconds of each.
   Whether torch.utils.tensorboard imports; if it does, the native run
   mirrors its metrics and the event file is read back against
   metrics.jsonl; if not, the mirror must warn and metrics.jsonl still be
   written.
19. int8: the int8 serving mode (ops/quant.py on K5 absmax, K6
   quantize_s8, a tiled transpose, and K7 conv_s8s8s32, a warp-specialised
   wgmma kernel fed by TMA im2col loads, of ops/csrc/int8conv.cu), run last
   (int8_phase): K5-K7 against their plain versions bit for bit (the
   elements that differ counted: amax, scale, codes, int32 sums, the
   dequantized bf16 output) at every convolution geometry of one
   full-width NCSNv2Deepest forward at batch 32 (acdc_problem's 16 chains x
   Re/Im, 113 convolutions) and of one NCSN1D forward at the cine engine's
   2,048 tubes, each timed device-only (graph_ms, 5 calls replayed twice)
   beside its bound (int8 operations at 1,979 TOP/s or bytes at 3.35
   TB/s, over the true channels C, not the codes' padding to Cp) and
   K7's plan, the plain version, cuDNN's bf16 convolution of the same shape
   and F.unfold + torch._int_mm, summed per forward; K7 launches per
   forward = the convolutions; the int8 score at the first and last level
   against f32 (float32 mode; <= INT8_VS_F32) and bf16 (not equal), one
   chain card vs CPU (the CPU side in a thread beside the card's tables),
   the batch-32 forward in int8, bf16 and f32; then, with the launch
   counts cleared, serve_recon.build_engine --dtype int8 at the serve
   phase's geometry and depth (warm-up, 3 requests over HTTP, 1
   in-process; chain-steps/s beside the serve phase's bf16 engine, peak),
   a seg-guided int8 engine (1 request), --workload cine --dtype int8 at
   the cine phase's (warm-up, 1 request over HTTP, 1 in-process; beside
   the cine phase's bf16 engine): K5-K7 launched, K1, K2 and K4 not.
   Then int8_edge_checks: K5-K7 on inputs with a NaN, a +inf, a -inf (NaN
   where the plain chain is: everywhere), K5 with a NaN or an inf at the
   largest NCSNv2Deepest input, K5 bit for bit at tiny and misaligned
   inputs, two calls in a row and in a replayed CUDA graph (K5's ticket
   back at 0), and one CUDA kernel a K5 call (torch.profiler).
   int8_ncsn3d: the int8 score of the 3-D temporal prior (CINE127_1D
   NCSN3DShallow, ngf 128, seed 0), whose rank-3 convolutions K7 does not
   take: at batch 2 every convolution the unfold path (K5, K6, unfold,
   torch._int_mm) runs, held bit for bit to int8_conv_plain on the CPU;
   then the forward at the cine CLI's 2,048 tubes, int8 against bf16, and
   the unfold path's device ms within it (CUDA events around each call),
   with the launch counts cleared before and read after; its first call
   of each geometry held bit for bit to int8_conv_plain on the card.
20. parallel: the data axis on one card, run last. An NCCL process group
   of world 1 on 127.0.0.1 (parallel.initialize_distributed), cuDNN
   deterministic for the phase. train_ncsn --use_mesh (ACDC, the deployed
   NCSNv2Deepest at full width, seeded weights, batch 3) for
   PARALLEL_STEPS steps against the same run without the mesh: every
   parameter and loss equal bit for bit (a second run without the mesh as
   the control, should they differ); s/step of each, and the gradient
   all_reduce's device ms by CUDA events (the step's one bucket, and
   dist.all_reduce alone). acdc_SENSE_real_img --use_mesh and
   serve_recon --data_shards -1 at acdc_problem's geometry (16 chains, 4
   coils, R = 8) for PARALLEL_LEVELS levels against their runs without a
   mesh: the reconstructions equal bit for bit; the engines'
   chain-steps/s. Then the sharded code itself, on a mesh of two entries
   of the card: acdc_SENSE_real_img --use_mesh
   (TWO_ENTRY_CHAINS chains, PARALLEL_LEVELS levels of one inner step)
   and the ACDC (TWO_ENTRY_CHAINS chains) and cine (CINE_CHAINS) engines
   (serve_recon's, f32, PARALLEL_LEVELS levels of one inner step) within
   rel L2 SHARDED of their runs without a mesh, with their walls and
   chain-steps/s; TF32 off and cuDNN's algorithms from its heuristics (not
   timed), so that both runs round alike. No K1-K7 launch. The group is
   destroyed at the end.
21. tp: tensor parallelism over the mesh's model axis on one card, two
   entries of it (make_mesh(n_data=1, n_model=2)). The deployed ACDC
   prior's train step (NCSNv2Deepest, 256 px, ngf 128, seed 0; the ACDC
   config in train_ncsn's default mode, real-valued; Adam at the config's
   lr and eps) at batch TP_BATCH (the config's 3 raised to 8) for
   TP_STEPS steps, the same batches and injected labels and noise: the
   plain step, then the state split by parallel.shard_tp at the default
   min_size (the convolutions whose weights hold 4,096 elements and an
   even number of output channels), both float32 with TF32 off
   (float32_exact): every loss within TP_LOSS_RTOL of the plain one, the
   EMA after TP_STEPS steps within rtol TP_RTOL, atol TP_ATOL (JAX's test
   bounds), the parameters within them or no farther past them than a
   control puts the plain step: the plain step again on a first batch one
   float32 ulp away (PERF.md §6, PR 22: at this width one ulp moves
   Adam's update past atol); then the split step in bf16
   (compute_dtype), its losses finite, the first (the same weights,
   batch and draws) within BF16_LOSS_REL of the float32 split step's, as
   train_bf16 gates a bf16 step; the later ones reported. s/step of each (the first step excluded), peak
   memory, the leaves split and whole, the state's bytes on each entry
   against the plain state's, and the device ms by CUDA events of a
   forward's gathers (each split convolution's output slices joined as
   the split layer joins them). No K1-K7 launch.
21b. int8_shards: the int8 engine's scale on a mesh, the whole batch's
   (ops/quant.ScaleGroup): serve_recon --dtype int8 (ACDC_CHAINS chains,
   PARALLEL_LEVELS levels of one inner step) on two entries of the card
   against its run without a mesh, TF32 off and cuDNN's heuristics,
   within rel L2 SHARDED, K5-K7 launched on the two-entry run (its counts
   join the int8 kernels' launches); and the first forward, the int8 net
   at batch 32 against its two 16-row shards run on two threads of one
   ScaleGroup (samplers/ald_pair.run_shards), reported bit for bit or by
   rel L2.

Every comparison with a plain or CPU version runs in the port's float32
mode (utils/precision.float32_exact: TF32 off for cuDNN and matmul, cuDNN
benchmark mode on, since its heuristics would pick an FFT convolution at
batch >= 2; PERF.md), so the card computes in float32 like the reference.
The sampling and training runs themselves use torch's defaults, as a
user's run does: cuDNN convolutions in TF32. Launch counts are cleared just
before each path (sample, train, sample_ckpt, the K4 op, ncsnv2, recon,
sense, map_tv, serve, cine, cine_complex, train_ncsn, each train_bf16
run, each sample_vp run, quickstart_3d, guided, each path of natural, and
the int8 engines, tp, the two-entry int8 engine) and read just after
it.
Each architecture's seeded weights are drawn once a process and
copied to its later builds (seeded_once: the same values).
Any failure raises and exits non-zero. Phases 9 to 19 print their numbers
as one JSON line before `total`. The last
lines are nvidia-smi's name and power limit, a JSON line of per-kernel
numbers, and
`{"ok": true, "device": {...}}`. In the JSON line `ms`, `plain_ms` and
`library_ms` are device-only; `ms_with_host` is the kernel with the host's
gaps; K1's and K2's entries (float32 and bf16) add their batch-8 forward
sums, and the float32 ones the host's µs per launch and their sums at the
CIFAR-10 VP shapes (a step at batch 128, a forward at 16, the ODE path's
forward at 16). K5-K7's entries are sums over one NCSNv2Deepest forward at
batch 32 (`per`), with the NCSN1D forward's sums beside them and, for K7,
the unfold + _int_mm yardstick; their `plain_ms` is CUDA events around
the one checking call; their `replaces` is the JAX package's XLA op, not
a TPU kernel.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = "ve/ffhq_256_ncsnpp_continuous"
NUM_SCALES = 50            # the config's 2000, reduced to keep the run short
                           # (100 before the migrate phase)
BATCH = 2
KERNEL_RTOL = 1e-5         # of the largest |value|: float32 sums reordered
MODEL_REL_L2 = 1e-4        # card vs CPU forward, float32 with TF32 off
BF16_REL_L2 = 1e-2         # bf16 net vs float32, whole reconstruction: the
                           # score's bf16 error (about 1e-2) enters scaled
                           # by the step beside the shared injected noise
ENGINE_REL_L2 = 1e-5       # serving engine vs the direct reconstructor: the
                           # same operations on the card (ACDC in the
                           # float32 mode, cine in torch's defaults)
SEG_F64_REL_L2 = 1e-10     # the seg guidance gradient card vs CPU, float64
SEG_F32_REL_L2 = 5e-3      # the card's float32 seg gradient vs float64:
                           # float32 loses up to about 3e-3 in the UNet's
                           # instance norms (PERF.md); TF32 about 3e-2
TRAIN_BATCH = 8            # the leaf's 64, reduced
TRAIN_STEPS = 6
CKPT_NUM_SCALES = 10
FLR_SHAPES = [(8 * 256 * 256, 128), (8 * 16 * 16, 256), (7 * 5 * 5, 3)]
# The ACDC SENSE ALD reconstruction at bench.py's geometry (bench.py:232-272)
ACDC_CHAINS = 16           # the net runs at batch 32: Re and Im interleaved
ACDC_COILS = 4
ACDC_R = 8
ACDC_LEVELS = 8            # of the config's 2311
SERVE_LEVELS = 2           # the serving phase's: cut from 8 to keep the
                           # smoke within its time, to 4 with `natural`,
                           # then to 2 with `migrate`
ACDC_CG_ITERS = 4
ACDC_LR_SCALED = 5.0
ACDC_REPS = 1              # timed runs after one warm-up; the fastest counts
                           # (3 before the migrate phase, then 2; cut to
                           # keep the smoke within its time)
# The headline ACDC SENSE CLI (scripts/acdc_SENSE_real_img) at full width
SENSE_SAMPLES = 16         # the headline run's chains (the net at batch 32)
SENSE_LEVELS = 4           # --override recons.num_classes: of the ladder's
                           # 2311 (348 -> 0.01); 8 before the migrate phase
SENSE_SIDE_SAMPLES = 4     # the single-coil and the guided runs
SENSE_GATE_LEVEL = 0       # complex vs pair form gated after this level
SENSE_CHECK_LEVELS = 4     # the complex vs pair form run's ladder (the
                           # recon geometry's 8 before the CPU references
                           # moved beside the card's work; cut to keep the
                           # smoke within its time)
FFT_REL_L2 = 1e-5          # cuFFT vs the pair DFT at 256 px, float32
ADJOINT_REL = 1e-5         # <A x, y> vs <x, A^H y>, sums in complex128
# The cine (2D+time) serving path: README's 128 px, T = 24, 4 coils, R = 8
CINE_FRAMES = 24
CINE_CHAINS = 4            # the CineEngineSpec default; serve_recon's is 16
CINE_LEVELS = 4            # of the config's 1000 (cine_complex; 8 before
                           # PR 16, cut to keep the smoke within its time)
CINE_SERVE_LEVELS = 2      # the cine serving phase's: cut from 8 to keep
                           # the smoke within its time with `natural`
CINE_WIN = 8               # 8 x 8 pixel tubes: the temporal net's 64 channels
CINE_LAMDA_T = 0.5         # the in-process request's temporal weight
CINE_CHECK_LEVEL = 1       # the first level with a temporal step
# The MAP and TV baselines at the ACDC geometry (map_tv) and the complex
# 2D+time cine CLIs at the cine geometry (cine_complex)
MAP_LAMDA = 0.1            # the MAP scripts' default prior weight
MAP_SIDE_ITERS = 20        # acdc_MAP, acdc_MAP_keep_center: of the 200
MAP_SPLIT_ITERS = 10       # iterations split by CUDA events and profiled
MAP_DIR_REL_L2 = 1e-5      # first ascent directions: the forms, card vs CPU
# The forms after the config's 200 iterations, float32 mode: b1 = b2 = 0.5
# makes Adam nearly sign descent, which hovers about the optimum on the
# side rounding decides. The bounds of tests/test_torch_map_long.py (read
# there at 16 px: MAP 5.95e-3 rel L2, TV 3.72e-3), which a control with
# the prior or TV weight doubled must break
MAP_LONG_REL = 3e-2        # rel L2 of two forms' iterates
MAP_LONG_FAR_SHARE = 0.25  # share of elements more than 5 lr apart
CINE_COMPLEX_CHAINS = 4    # the 2D+time CLI and the single-frame CLI
CINE_COMPLEX_GATES = (0, 3)  # complex vs pair form gated after these levels
CINE_F32_CHAINS = 1        # the float32-mode comparison: of the CLI's 4
CINE_MODE_LEVELS = 2       # the tv, none and tv-only runs
CINE_MAP_ITERS = 20        # cine_SENSE_real_img_2d_time_MAP: of the 200
# The README quick start (MNIST) and the 3-D temporal prior
QS_SAMPLES = 8             # unconditioned_sampling's chains (the net's batch)
QS_MNIST_LEVELS = 29       # of the MNIST ladder's 232 (whole before the
                           # natural phase, then 58 before the migrate
                           # phase; cut to keep the smoke within its time)
QS_TRAIN_STEPS = 5         # train_ncsn --ds_name MNIST at the config's 128
QS_3D_TRAIN_STEPS = 5      # train_ncsn Diffusion3D at the config's batch 90
QS_3D_LEVELS = 20          # unconditioned 1-D / 3-D runs: of the 400 levels
QS_CHAINS = 4              # the cine CLIs: as the cine_complex phase
# The cine CLIs with Diffusion3D and Diffusion1D: 2 of the 1000 levels (1
# with a temporal step), cut to keep the smoke within its time (the 3-D
# temporal net took 5.2 s of a 5.6 s level step; 4 levels before PR 16)
QS_CINE_LEVELS = 2
QS_MAP_ITERS = 10          # the cine MAP CLI with Diffusion3D: of the 200
# Guided sampling and the guidance nets' training: train_clf, train_seg,
# samplers/ald_variants and the MNIST guided CLIs, at full width
GUIDED_SAMPLES = 8         # the samplers' and the CLIs' chains
GUIDED_LEVELS = 20         # the 50 -> 0.01 ladder cut from 232 levels to 20
GUIDED_TRAIN_STEPS = 5     # train_clf at the config's 512, train_seg at 8
GUIDED_INTERPOLATIONS = 4  # ald_interpolation: 2 rows x 4 chains
GUIDED_MAP_ITERS = 200     # mnist_MAP: of the config's 15000 Adam iterations
# ald_inverse_clf's data gradient is not normalized: x moves by step_size x
# lamda x (A^H y - A^H A x), and the cut ladder's first step is step_lr
# (50 / 0.01)^2 = 155, so lamda 1 (the CLI's default) multiplies the kept
# rows' error by -154 a step and the chains overflow; 0.01 keeps the
# factor at -0.55 (in JAX as in the port)
GUIDED_LAMDA = 0.01
# The level held card vs CPU: level 8 of the cut ladder, sigma 1.33, its
# step 0.11, run alone as a one-level ladder at that step
GUIDED_CHECK_LEVEL = 8
GUIDED_CHECK_CHAINS = 2
GUIDED_VARIANTS = ("inpainting", "interpolation", "cls_conditioned",
                   "inverse_problem", "inverse_problem_proj", "inverse_clf",
                   "inverse_clf_proximal")
GUIDED_CLF = ("cls_conditioned", "inverse_clf", "inverse_clf_proximal")
MIGRATE_LEVELS = 2         # the imported prior's CLI run: of the 2311
MIGRATE_TUBES = 64         # the imported NCSN1D's forward batch
MIGRATE_TRAIN_BATCH = 8    # train_ncsn on each feed: the README's batch
MIGRATE_TRAIN_STEPS = 4
# Discrete score training through scripts.train_ncsn on the loaders'
# synthetic stand-ins (24 + 6 ACDC slices at 256 px; 12 + 4 cine videos
# as 8 x 8 tubes of 24 frames): run name -> (its flags, steps)
TRAIN_NCSN_RUNS = {
    "acdc_b3_f32": (["--batch_size", "3"], 5),        # the recipe's batch
    "acdc_b8_f32": (["--batch_size", "8"], 6),        # the README's batch
    "acdc_b8_bf16": (["--batch_size", "8", "--bf16"], 6),
    "acdc_b8_bf16_remat": (["--batch_size", "8", "--bf16", "--remat"], 6),
    "acdc_b3_accum2": (["--batch_size", "3", "--grad_accum", "2"], 4),
    "cine_f32": ([], 5),                              # the config's batch 90
    "cine_bf16": (["--bf16"], 5),
}
TRAIN_LOSS_REL = 1e-5      # card vs CPU train step's loss, float32 mode
BF16_LOSS_REL = 2e-2       # the bf16 step's loss vs the float32 step's
# The bf16 train step's gradient vs the float32 step's, at least: it ran in
# bf16 (read 1.26e-2 to 1.31e-2 ACDC, 3.90e-2 to 4.85e-2 NCSN1D on the
# H100 over two runs; a float32 step reads 0)
BF16_GRAD_FLOOR = 5e-3
# Card vs CPU Adam update, rel L2. The first update is about lr * sign(g)
# wherever |g| >> eps (1e-3), so it counts the gradient entries near 0
# whose sign float32 rounding decides. Read on the H100 over two runs:
# 1.11e-2 ACDC, 1.62e-5 to 2.09e-5 NCSN1D; the control (CONTROL_GRAD_REL
# of noise) 0.532 and 3.25e-2 to 3.35e-2
UPDATE_REL = {"acdc": 5e-2, "cine": 1e-3}
CONTROL_GRAD_REL = 1e-3    # the control's gradient noise, 10 x MODEL_REL_L2
RECON_CHAINS = 4           # the learn -> reconstruct request
# The VP / subVP stack and bf16 continuous training
VP_CONFIG = "vp/cifar10_ncsnpp_continuous"
# The bf16 VP step's gradient vs the float32 step's, at most (read 3.08e-2
# on the H100, 2.98e-2 on a CPU); the control, the bf16 step with the FIR
# backward halved, reads 0.135 on a CPU
VP_BF16_GRAD_CEIL = 6e-2
VP_TRAIN_BATCH = 128       # the leaf's batch
VP_PARITY_BATCH = 8        # card vs CPU and bf16 vs f32 steps
VP_SAMPLES = 16
VP_NUM_SCALES = 25         # of the leaves' 1000 (232 for ve/ncsnv2/cifar10);
                           # 100 before the migrate phase, then 50; above
                           # beta_max = 20, where the ancestral leaves'
                           # discrete beta stays below 1
VP_CKPT_NUM_SCALES = 10
VP_SAMPLE_LEAVES = ["vp/cifar10_ncsnpp_continuous",
                    "vp/cifar10_ddpmpp_continuous", "vp/ddpm/cifar10",
                    "subvp/cifar10_ncsnpp_continuous", "ve/ncsnv2/cifar10"]
# NCSN v1, the probability-flow ODE sampler and the natural-image configs
NATURAL_ODE_CONFIG = VP_CONFIG   # NCSN++ with FIR: K1 and K2 every forward
NATURAL_SAMPLES = 16             # the ODE's and NCSN v1's samples
# Card vs CPU, tiny NCSN++ ODEs in the float32 mode, samples within
# ODE_REL_L2. The adaptive steps feed float32 rounding back into the
# solve, and a step can be accepted on one device and rejected on the
# other, so the gate sits well above the spread of such runs (PERF.md).
# On the VP leaf the drift grows as 1 / std near t = eps, where the std
# loses three digits to cancellation, and the last step overshoots to
# t < 0, where the std is NaN: at the sampler's rtol 1e-5 a 1e-7
# perturbation of the score moves the solve by about 1e-2 (read with a
# control, PERF.md), so the VP gate runs at ODE_VP_CHECK_TOL
ODE_VE_CONFIG = "ve/cifar10_ncsnpp_continuous"
ODE_REL_L2 = 1e-3
ODE_VP_CHECK_TOL = 1e-6
NATURAL_V1_CONFIG = "ve/ncsn/cifar10"
NATURAL_V1_STEPS_EACH = 10       # ALD steps a level: of the leaf's 100, cut
                                 # to keep the smoke within its time (50
                                 # with the int8 phase, 25 with migrate,
                                 # then 10)
NATURAL_V1_STEPS = 5             # training.fit at the leaf's batch 128
NATURAL_TRAIN_STEPS = 5          # train_ncsn --ds_name CELEBA at 128
NATURAL_UNCOND_SAMPLES = 8
NATURAL_UNCOND_LEVELS = 20       # of CIFAR10's 232
# The int8 serving mode (ops/quant.py; K5-K7 of ops/csrc/int8conv.cu)
INT8_VS_F32 = 0.15         # int8 score vs float32: the JAX test's bound
                           # (tests/test_quant.py); also card vs CPU in
                           # int8, whose nets part by the int8 error itself
                           # (tests/test_torch_int8.py)
INT8_OPS_PER_S = 1979e12   # H100 SXM data sheet, int8 tensor cores, dense
INT8_INT_MM_MAX_BYTES = 8 * 2 ** 30   # the unfold + _int_mm yardstick's A
# K5-K7 beyond a forward's inputs (int8_edge_checks): small geometries
# (N, C, spatial, O, k, dilation, pre_pad, ndim) for non-finite inputs,
# sizes from below one 16-byte vector to several waves, byte offsets of x
INT8_EDGE_CASES = [(2, 40, (9, 9), 16, 3, 1, None, 2),
                   (9, 64, (24,), 32, 3, 1, None, 1)]
INT8_NON_FINITE = {"nan": [math.nan], "+inf": [math.inf],
                   "-inf": [-math.inf],
                   "inf_and_nan": [math.inf, math.nan, -math.inf]}
INT8_TINY = (1, 2, 3, 7, 8, 9, 15, 17, 1001, 4099, 65539, 3 * 2 ** 20 + 5)
INT8_OFFSETS = (0, 2, 4, 8)
INT8_TAGS = ("absmax", "quantize_s8", "conv_s8s8s32")
INT8_3D_TUBES = 2048       # the cine CLI's tube batch: Re and Im of 4
                           # chains x 256 tubes (quickstart_3d's)
PARALLEL_STEPS = 3         # train_ncsn runs of the parallel phase
PARALLEL_LEVELS = 2        # the mesh CLIs' and engines' levels
SHARDED = 1e-6             # rel L2, a run on two shards vs without a mesh
                           # (tests/test_torch_parallel.py's bound)
TWO_ENTRY_CHAINS = 8       # chains of the two-entry SENSE and ACDC runs
TP_BATCH = 8               # the tp phase's train step (the config's 3)
TP_STEPS = 3
TP_LOSS_RTOL = 1e-5        # the split step's loss vs the plain step's
TP_RTOL, TP_ATOL = 1e-3, 1e-5  # parameters and EMA after TP_STEPS: JAX's
QUANT = "inverseproblemwithdiffusionmodel_tpu/ops/quant.py"
INT8_REPLACES = {"absmax": f"{QUANT}:93", "quantize_s8": f"{QUANT}:93",
                 "conv_s8s8s32": f"{QUANT}:102"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, float32 outside tensor cores
PALLAS = "inverseproblemwithdiffusionmodel_tpu/ops/pallas_kernels.py"
FIR_TAGS = ["up2x", "down2x", "up2x.bwd", "down2x.bwd"]
FLR_TAGS = ["flr_fwd", "flr_bwd", "flr_fwd.bf16", "flr_bwd.bf16"]
REPLACES = {
    "up2x": f"{PALLAS}:179",
    "down2x": f"{PALLAS}:199",
    "up2x.bwd": f"{PALLAS}:291",     # fir_downsample_2x's linear_transpose
    "down2x.bwd": f"{PALLAS}:266",   # fir_upsample_2x's linear_transpose
    "flr_fwd": f"{PALLAS}:61",
    "flr_bwd": f"{PALLAS}:84",
}
CSRC = "inverseproblemwithdiffusionmodel_tpu_torch/ops/csrc"
SOURCES = {}
for _tag in FIR_TAGS:   # the float32 and bf16 forms of one Pallas kernel
    SOURCES[_tag] = SOURCES[f"{_tag}.bf16"] = f"{CSRC}/fir2x.cu"
    REPLACES[f"{_tag}.bf16"] = REPLACES[_tag]
for _tag in ("flr_fwd", "flr_bwd"):
    SOURCES[_tag] = SOURCES[f"{_tag}.bf16"] = f"{CSRC}/flr.cu"
    REPLACES[f"{_tag}.bf16"] = REPLACES[_tag]


def say(phase: str, t0: float, text: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f} s | {text}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fir_sites(cfg) -> dict:
    """(kernel, C, R) of every K1/K2 call in one NCSN++ forward, by site:
    the BigGAN down and up blocks (h and x) at every level but the last,
    the input_skip pyramid's downs and the output_skip pyramid's ups (the
    residual pyramids fuse a conv: no kernel). Nets without FIR (DDPM,
    DDPM++, NCSNv2) make none."""
    m = cfg.model
    sites = dict(biggan_down=[], pyramid_down=[], biggan_up=[], pyramid_up=[])
    if m.name != "ncsnpp" or not m.fir:
        return sites
    nf, mult, ch = m.nf, tuple(m.ch_mult), cfg.data.num_channels
    res = [cfg.data.image_size // 2 ** i for i in range(len(mult))]
    lower, upper = range(len(mult) - 1), range(1, len(mult))
    if m.resblock_type == "biggan":
        sites["biggan_down"] = [("down2x", nf * mult[i], res[i])
                                for i in lower for _ in "hx"]
        sites["biggan_up"] = [("up2x", nf * mult[i], res[i])
                              for i in upper for _ in "hx"]
    if m.progressive_input == "input_skip":
        sites["pyramid_down"] = [("down2x", ch, res[i]) for i in lower]
    if m.progressive == "output_skip":
        sites["pyramid_up"] = [("up2x", ch, res[i]) for i in upper]
    return sites


def fir_shapes(cfg):
    """(kernel, C, R) of every FIR call in one NCSN++ forward."""
    return [call for calls in fir_sites(cfg).values() for call in calls]


def bwd_shapes(cfg):
    """(kernel launched as the backward, C, R of the forward call) for every
    FIR call of one training step that needs a gradient: K2 for each up
    pass, K1 for each BigGAN down pass. The input pyramid's down passes act
    on the perturbed data, which needs no gradient."""
    sites = fir_sites(cfg)
    return ([("up2x.bwd", C, R) for _, C, R in sites["biggan_down"]]
            + [("down2x.bwd", C, R) for _, C, R in
               sites["biggan_up"] + sites["pyramid_up"]])


def fir_counts(cfg) -> tuple:
    """K1 and K2 launches of one forward (fir_shapes), and of the K3
    backward of one training step (bwd_shapes), by kernel."""
    count = lambda shapes: dict(collections.Counter(n for n, _, _ in shapes))
    return count(fir_shapes(cfg)), count(bwd_shapes(cfg))


def cuda_ms(fn, reps: int = 20, host: bool = False, warmup: int = 3):
    """Device ms per call by CUDA events, after `warmup` calls; with
    host=True also the host's ms per call to enqueue the work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    return (device_ms, host_ms) if host else device_ms


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call with the host's gaps taken out: after a warm-up
    call, `reps` calls captured into one CUDA graph (the kernels' ctypes
    launch takes torch's current stream, so it is captured too), the graph
    replayed `replays` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def library_fn(up: bool, x: torch.Tensor, taps: np.ndarray):
    """One depthwise PyTorch conv computing the up (K1) or down (K2) pass
    with these 4 taps per axis: conv_transpose2d with the outer product of
    the taps (up), conv2d with that of the reversed taps (down), in x's
    dtype. The weight is made here, so the call it returns can be captured
    in a CUDA graph."""
    C = x.shape[-1]
    t = np.asarray(taps, np.float32)
    if not up:
        t = t[::-1]
    w = torch.tensor(np.outer(t, t), device=x.device,
                     dtype=x.dtype).expand(C, 1, 4, 4)
    w = w.contiguous()
    conv = F.conv_transpose2d if up else F.conv2d
    return lambda: conv(x.permute(0, 3, 1, 2), w, stride=2, padding=1,
                        groups=C).permute(0, 2, 3, 1)


def bound(bytes_moved: float, flop: float) -> dict:
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * flop / FP32_FLOP_PER_S
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def bf16_ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp of the largest |value| of ref."""
    top = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def kernel_numbers(tag, C, R, k, fk, gen, batch):
    """Check one FIR kernel launch site against its plain version, then
    time kernel, plain version and library call. `tag` "up2x" /
    "down2x" is the forward pass of a call at (batch, R, R, C);
    "down2x.bwd" / "up2x.bwd" is K2 / K1 as the backward of an up / down
    call at that shape, checked through the autograd Functions. A tag
    ending in ".bf16" is the same call in bf16: held to the bf16 plain
    version (the kernel's own arithmetic: float32 inside, one rounding) at
    1 ulp of its largest |value|, counting the elements that differ at all,
    and to the float32 kernel's output on the same (bf16-valued) input
    rounded once, at 2 ulps; the library call runs in bf16 and the bound
    counts 2 bytes an element."""
    bf16 = tag.endswith(".bf16")
    base = tag[:-len(".bf16")] if bf16 else tag
    dtype = torch.bfloat16 if bf16 else torch.float32
    # the inputs are drawn on the card, from a seed drawn from `gen`
    card_gen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(2 ** 31, (1,), generator=gen)))
    x = torch.randn(batch, R, R, C, generator=card_gen,
                    device="cuda").to(dtype)
    up_taps, dn_taps = fk._sep_kernel_1d(k, 2.0), fk._sep_kernel_1d(k, 1.0)
    if base in ("up2x", "down2x"):
        inp, taps = x, (up_taps if base == "up2x" else dn_taps)
        fwd = fk.upsample2x if base == "up2x" else fk.downsample2x
        check = lambda v: fwd(v, k)
    else:
        fwd = fk.upsample2x if base == "down2x.bwd" else fk.downsample2x
        R_out = 2 * R if base == "down2x.bwd" else R // 2
        inp = torch.randn(batch, R_out, R_out, C, generator=card_gen,
                          device="cuda").to(dtype)
        taps = (up_taps if base == "down2x.bwd" else dn_taps)[::-1].copy()

        def check(v):
            xv = x.detach().to(v.dtype).requires_grad_()
            return torch.autograd.grad(fwd(xv, k), xv, v)[0]
    up = base.startswith("up")
    launch = fk._up if up else fk._down
    plain_fn = fk.upsample2x_plain if up else fk.downsample2x_plain
    kern = lambda: launch(inp, taps, base)
    plain = lambda: plain_fn(inp, taps)
    lib = library_fn(up, inp, taps)
    arg = x if base in ("up2x", "down2x") else inp
    out, ref, lib_out = check(arg), plain(), lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    extra = {}
    if bf16:
        tol = bf16_ulp(ref)
        lib_tol = 2 * tol
        err32 = (out.float() - check(arg.float()).to(dtype).float()
                 ).abs().max().item()
        extra = dict(n_diff=int((out != ref).sum().item()), err_f32=err32,
                     n_out=ref.numel())
        if not err32 <= 2 * tol:
            raise AssertionError(f"{tag} C={C} R={R}: {err32} from the "
                                 f"float32 kernel rounded once, > 2 ulps")
    else:
        tol = lib_tol = KERNEL_RTOL * ref.abs().max().item()
    if out.dtype != dtype or not err <= tol:
        raise AssertionError(f"{tag} C={C} R={R}: {out.dtype}, max_abs_err "
                             f"{err} > {tol}")
    if not lib_err <= lib_tol:
        raise AssertionError(f"{tag} C={C} R={R}: the library yardstick "
                             f"computes another function ({lib_err})")
    n_out = ref.numel()
    flop_per_out = 12 if up else 40   # 2x2 (up) or 4x4 (down) taps, H then W
    return dict(C=C, R=R, B=batch, err=err, ms=graph_ms(kern),
                ms_with_host=cuda_ms(kern), plain_ms=graph_ms(plain),
                library_ms=graph_ms(lib), **extra,
                **bound(dtype.itemsize * (inp.numel() + n_out),
                        n_out * flop_per_out))


def host_us(fn, reps: int = 500) -> float:
    """Host µs per call of a launch the card finishes before the host has
    the next one ready."""
    return 1e3 * cuda_ms(fn, reps=reps, host=True)[1]


def launch_paths(fk, k, shapes, name):
    """(C, R) of kernel `name`'s smallest call in `shapes` and, on a batch-2
    input of that shape, the call of the wrapper that launches the kernel
    (`_up` / `_down`) and of the public op the model calls (taps, checks
    and the autograd Function on top)."""
    C, R = min(((C, R) for n, C, R in shapes if n == name),
               key=lambda cr: cr[0] * cr[1] ** 2)
    x = torch.randn(BATCH, R, R, C, device="cuda")
    up = name == "up2x"
    taps = fk._sep_kernel_1d(k, 2.0 if up else 1.0)
    wrapper, public = ((fk._up, fk.upsample2x) if up
                       else (fk._down, fk.downsample2x))
    return C, R, dict(wrapper=lambda: wrapper(x, taps, name),
                      public=lambda: public(x, k))


def host_us_per_launch(fk, k, shapes):
    """Host µs per launch of K1 and K2 at their smallest shape of a
    forward, through the wrapper and through the public op."""
    out = {}
    for name in ("up2x", "down2x"):
        C, R, fns = launch_paths(fk, k, shapes, name)
        out[name] = dict(C=C, R=R, wrapper_us=host_us(fns["wrapper"]),
                         public_us=host_us(fns["public"]))
    return out


def summarize(rows, what: str):
    """Sums over one kernel's rows; prints the three largest and the sum.
    `ms`, `plain_ms` and `library_ms` are device-only (graph replay);
    `ms_with_host` is the kernel timed by CUDA events around a loop of
    launches from the host."""
    summary = {}
    for name, rs in rows.items():
        tot = {key: sum(r[key] for r in rs) for key in
               ("ms", "ms_with_host", "plain_ms", "library_ms", "bound_ms",
                "bytes_ms", "ops_ms")}
        summary[name] = dict(tot, err=max(r["err"] for r in rs),
                             bound_by="bytes" if tot["bytes_ms"]
                             >= tot["ops_ms"] else "operations")
        for r in sorted(rs, key=lambda r: -r["bound_ms"])[:3]:
            print(f"    {name} (C={r['C']}, R={r['R']}, B={r['B']}): "
                  f"kernel_ms device {r['ms']:.4f} with host "
                  f"{r['ms_with_host']:.4f}, plain_ms {r['plain_ms']:.4f} "
                  f"library_ms {r['library_ms']:.4f} bound_us "
                  f"{1e3 * r['bound_ms']:.2f} ({r['bound_by']}) "
                  f"max_abs_err {r['err']:.3g}", flush=True)
        print(f"    {name}, sum over its {len(rs)} calls of {what}: "
              f"kernel_ms device {tot['ms']:.4f} with host "
              f"{tot['ms_with_host']:.4f}, plain_ms {tot['plain_ms']:.4f} "
              f"library_ms {tot['library_ms']:.4f} bound_us "
              f"{1e3 * tot['bound_ms']:.2f}", flush=True)
        print(f"    {name} per call, device us: " + " ".join(
            f"C{r['C']}/R{r['R']}:{1e3 * r['ms']:.2f}" for r in rs),
            flush=True)
    return summary


def flr_numbers(shape, y, dx, db, x, b, g, fl, fused_leaky_relu):
    """Hold K4's outputs from the op's run against the plain versions, then
    time each kernel and its plain version. float32 within KERNEL_RTOL of
    the largest |value|; bf16 within 1 bf16 ulp of it (the kernel and its
    plain version both compute in float32 and round once), counting the
    elements that differ at all; the bound counts x's element size."""
    slope, scale = 0.2, 2 ** 0.5
    C, n, size = shape[-1], x.numel(), x.element_size()
    bf16 = x.dtype == torch.bfloat16
    y_ref = fused_leaky_relu(x, b, slope, scale)
    dx_ref = fl.fused_leaky_relu_bwd_plain(x, b, g, slope, scale)
    db_ref = dx_ref.reshape(-1, C).sum(0)
    errs, n_diff = {}, {}
    for name, out, ref in (("y", y, y_ref), ("dx", dx, dx_ref),
                           ("db", db, db_ref)):
        errs[name] = (out.float() - ref.float()).abs().max().item()
        n_diff[name] = int((out != ref).sum().item())
        tol = (bf16_ulp(ref) if bf16
               else KERNEL_RTOL * ref.abs().max().item())
        if out.dtype != x.dtype or not errs[name] <= tol:
            raise AssertionError(f"flr {shape} {x.dtype} {name}: "
                                 f"{out.dtype}, max_abs_err {errs[name]} > "
                                 f"{tol}")
    fwd_k = lambda: fl.flr_forward(x, b, slope, scale)
    bwd_k = lambda: fl.flr_backward(x, b, g, slope, scale)
    fwd = dict(err=errs["y"], n_diff=n_diff["y"], ms=graph_ms(fwd_k),
               ms_with_host=cuda_ms(fwd_k), plain_ms=graph_ms(
                   lambda: fused_leaky_relu(x, b, slope, scale)),
               **bound(size * (2 * n + C), 3 * n))   # read x, b; write y
    bwd = dict(err=errs["dx"], db_err=errs["db"],
               n_diff=n_diff["dx"] + n_diff["db"], ms=graph_ms(bwd_k),
               ms_with_host=cuda_ms(bwd_k), plain_ms=graph_ms(
                   lambda: fl.fused_leaky_relu_bwd_plain(x, b, g, slope,
                                                         scale)),
               **bound(size * (3 * n + C), 2 * n))   # read x, b, g; write dx
    return fwd, bwd


def flr_phase(fl, gen):
    """K4 as a user calls it (fused_leaky_relu_kernel and its gradient) at
    FLR_SHAPES in float32 and bf16, the launches counted; then each output
    held to its plain version and each kernel timed (flr_numbers). Returns
    (per-kernel sums over the shapes, the launches, the bf16 elements that
    differ from the plain versions)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.ops.fused_act import (
        fused_leaky_relu)
    flr_in = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLR_SHAPES:
            x = torch.randn(*shape, generator=gen).cuda().to(dtype)
            b = torch.randn(shape[-1], generator=gen).cuda().to(dtype)
            g = torch.randn(*shape, generator=gen).cuda().to(dtype)
            flr_in.append((shape, x, b, g))
    fl.LAUNCHES.clear()
    flr_out = []
    for shape, x, b, g in flr_in:           # the op, as a user calls it
        xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
        y = fl.fused_leaky_relu_kernel(xg, bg)
        dx, db = torch.autograd.grad(y, (xg, bg), g)
        flr_out.append((y.detach(), dx, db))
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    if launches != {name: len(FLR_SHAPES) for name in FLR_TAGS}:
        raise AssertionError(f"K4 op launched {launches}")
    flr_rows = {name: [] for name in FLR_TAGS}
    for (shape, x, b, g), (y, dx, db) in zip(flr_in, flr_out):
        fwd, bwd = flr_numbers(shape, y, dx, db, x, b, g, fl,
                               fused_leaky_relu)
        tag = ".bf16" if x.dtype == torch.bfloat16 else ""
        flr_rows["flr_fwd" + tag].append(fwd)
        flr_rows["flr_bwd" + tag].append(bwd)
        for name, r in (("flr_fwd" + tag, fwd), ("flr_bwd" + tag, bwd)):
            print(f"    {name} {shape}: kernel_ms device {r['ms']:.4f} "
                  f"with host {r['ms_with_host']:.4f}, plain_ms "
                  f"{r['plain_ms']:.4f} library_ms: no single call, bound_us "
                  f"{1e3 * r['bound_ms']:.2f} ({r['bound_by']}) max_abs_err "
                  f"{r['err']:.3g}" + (f" (db {r['db_err']:.3g})"
                                       if "db_err" in r else ""), flush=True)
    summary = {}
    for name, rs in flr_rows.items():
        tot = {key: sum(r[key] for r in rs) for key in
               ("ms", "ms_with_host", "plain_ms", "bound_ms", "bytes_ms",
                "ops_ms")}
        summary[name] = dict(tot, err=max(r["err"] for r in rs),
                             library_ms=None,
                             bound_by="bytes" if tot["bytes_ms"]
                             >= tot["ops_ms"] else "operations")
    diffs = {n: sum(r["n_diff"] for r in rs)
             for n, rs in flr_rows.items() if n.endswith(".bf16")}
    return summary, launches, diffs


def run_pc_sampling(pc_sampling, argv):
    """pc_sampling.main(argv), its output echoed indented: the samples, the
    nfe its printed line gives, and that output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = pc_sampling.main(argv)
    for line in out.getvalue().splitlines():
        print(f"    {line}", flush=True)
    found = re.search(r"\(nfe=(\d+)\)", out.getvalue())
    if found is None:
        raise AssertionError("pc_sampling printed no nfe")
    nfe = int(found.group(1))
    return samples, nfe, out.getvalue()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, summed in float64. Two float32 tensors are
    subtracted in float32 (within 2^-24 of the difference itself), which
    spares the float64 copies of a net's gradients."""
    if not a.dtype == b.dtype == torch.float32:
        a, b = a.double(), b.double()
    norm = lambda v: torch.linalg.vector_norm(v, dtype=torch.float64)
    return (norm(a - b) / norm(b)).item()


class Background:
    """fn(*args, **kwargs) on a thread of its own, for a CPU reference that
    runs beside the card's work; `result()` joins it and re-raises what it
    raised. It must make no CUDA call: the main thread may be capturing a
    CUDA graph meanwhile. `seconds` is its own run time."""

    def __init__(self, fn, *args, **kwargs):
        self._out = {}

        def run():
            t_run = time.perf_counter()
            try:
                self._out["value"] = fn(*args, **kwargs)
            except BaseException as err:     # re-raised by result()
                self._out["error"] = err
            self.seconds = time.perf_counter() - t_run

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def acdc_model(seed: int = 0):
    """The ACDC config (configs/acdc.yml in the JAX package) and its
    NCSNv2Deepest at full width, weights drawn from `seed`, on the CPU."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    cfg = load_config("ACDC", "real-imag")
    return cfg, seeded_weights(NCSNv2Deepest(cfg), seed=seed).eval()


def no_kernel_launches(fk, fl, what: str) -> None:
    """The ACDC path runs none of K1, K2 or K4."""
    counts = {**fk.LAUNCHES, **fl.LAUNCHES}
    if any(counts.values()):
        raise AssertionError(f"{what} launched FIR/FLR kernels: {counts}")


def ncsnv2_phase(fk, fl, device="cuda") -> dict:
    """NCSNv2Deepest at full width (256 px, ngf 128) through
    models/registry.make_score_fn on channel-last (B, 256, 256, 1) input,
    as the reconstruction calls it: card against CPU at batch 2 (the
    ladder's first and last levels) in the float32 mode, the CPU's forward
    on a thread of its own beside the card's timings; device ms at
    batch 32 (the reconstruction's) with torch's defaults and in bf16, and
    the peak memory of those calls. For the record, the same forwards in
    two other layouts: the bare permute of x, whose channels-last strides
    make torch run the net in NHWC against NCHW weights, and that view
    into the net converted to channels-last."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu).to(device)
    sigmas = sigma_ladder(cfg.model.sigma_begin, cfg.model.sigma_end,
                          ACDC_LEVELS, "geometric")
    size = cfg.data.image_size
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(BATCH, size, size, 1, generator=gen)
    labels = torch.tensor([0, ACDC_LEVELS - 1])

    def cpu_forward():
        with torch.inference_mode():
            return make_score_fn(model_cpu, sigmas)(x, labels)

    # the CPU's forward runs beside the card's timings
    ref = Background(cpu_forward)
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    with torch.inference_mode(), float32_exact():
        out = make_score_fn(model, sigmas)(x.to(device),
                                           labels.to(device)).cpu()
    no_kernel_launches(fk, fl, "the NCSNv2Deepest forward")
    nb = 2 * ACDC_CHAINS
    xb = torch.rand(nb, size, size, 1, generator=gen).to(device)
    lb = (torch.arange(nb) % ACDC_LEVELS).to(device)
    numbers = dict(params=sum(p.numel() for p in model.parameters()))
    with torch.inference_mode():
        for dtype, name in ((None, "f32"), (torch.bfloat16, "bf16")):
            score = make_score_fn(model, sigmas, dtype)
            net = model if dtype is None else copy.deepcopy(model).to(dtype)
            sig = torch.as_tensor(sigmas, device=device).to(
                dtype or torch.float32)[lb]
            view = xb.to(dtype or torch.float32).permute(0, 3, 1, 2)
            net_cl = copy.deepcopy(net).to(memory_format=torch.channels_last)
            for key, fn in ((name, lambda: score(xb, lb)),
                            (f"{name}_nhwc_view", lambda: net(view, sig)),
                            (f"{name}_channels_last",
                             lambda: net_cl(view, sig))):
                fn()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms, host_ms = cuda_ms(fn, reps=5, host=True)
                numbers[key] = dict(ms=ms, host_ms=host_ms,
                                    peak=torch.cuda.max_memory_allocated())
            del score, net, net_cl
    numbers["rel_l2"] = rel = rel_l2(out, ref.result())
    if not (torch.isfinite(out).all() and rel <= MODEL_REL_L2):
        raise AssertionError(f"NCSNv2Deepest card vs CPU: rel L2 {rel}")
    return numbers


def acdc_problem(cfg, device, levels: int = ACDC_LEVELS):
    """bench.py's reconstruction problem (bench.py:85-97, 232-272): the
    pair SENSE with 4 real exponential coil maps and one R = 8
    variable-density line mask (seed 0), the measurement of 16 chains of
    uniform magnitude and normal phase (a torch.Generator seeded 0), the CG
    proximal on the normal kernel, and the ladder cut to `levels` (8)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    size = cfg.data.image_size
    mask = generate_mask(1, size, seed=0, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(ACDC_COILS)])
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    sens = torch.tensor(maps[..., None], dtype=torch.float32)
    lin_tfm = PairSENSE(mask=torch.tensor(mask.reshape(1, 1, size, 1)),
                        sens_re=sens, sens_im=torch.zeros_like(sens)
                        ).to(device)
    gen = torch.Generator().manual_seed(0)
    shape = (ACDC_CHAINS, size, size, 1)
    mag = torch.rand(shape, generator=gen).to(device)
    phase = torch.randn(shape, generator=gen).to(device)
    with torch.inference_mode():
        yr, yi = lin_tfm(mag * torch.cos(phase), mag * torch.sin(phase))
    proximal = PairL2Penalty.with_normal_kernel(lin_tfm,
                                                num_iters=ACDC_CG_ITERS)
    sigmas = sigma_ladder(cfg.model.sigma_begin, cfg.model.sigma_end,
                          levels, "geometric")
    return lin_tfm, proximal, sigmas, yr, yi


def idle_share(prof, wall_us: float) -> float:
    """1 - (union of the device's kernel and copy intervals) / wall time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return 1.0 - busy / wall_us


def recon_phase(fk, fl, device="cuda") -> dict:
    """make_stepped_pair_reconstructor at bench.py's geometry, float32
    (torch's defaults) and bf16 net: one warm-up, ACDC_REPS timed runs each
    ended by a host read of |xr|.sum() + |xi|.sum() (bench.py:365-369),
    chain-steps/s from the fastest, peak memory, finite outputs; one level
    step of the float32 run under torch.profiler; the first inner step on
    the card against the CPU, 1 chain, same noise, float32 mode
    (recon_check_parts), the CPU side on a thread of its own from the
    phase's start."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    cfg, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu)
    lin_tfm, proximal, sigmas, yr, yi = acdc_problem(cfg, device)
    # the card-vs-CPU check's CPU side runs beside the timed runs
    check_in = recon_check_inputs(cfg, yr, yi)
    cpu_side = Background(recon_check_parts, model_cpu, sigmas,
                          lin_tfm.to("cpu"), proximal.to("cpu"), check_in,
                          "cpu")
    n_steps = cfg.sampling.n_steps_each
    ald_cfg = ALDConfig(n_steps_each=n_steps, step_lr=cfg.sampling.step_lr)
    chain_steps = ACDC_LEVELS * n_steps * ACDC_CHAINS
    numbers, outputs = dict(n_steps=n_steps), {}
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        recon = make_stepped_pair_reconstructor(
            model, sigmas, lin_tfm, proximal, ald_cfg,
            lr_scaled=ACDC_LR_SCALED, compute_dtype=dtype, device=device)

        def run_fetch(seed):
            xr, xi = recon(yr, yi, seed=seed)
            return float(xr.abs().sum() + xi.abs().sum()), (xr, xi)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_fetch(1)
        times = []
        for seed in range(2, 2 + ACDC_REPS):
            t_run = time.perf_counter()
            total, out = run_fetch(seed)
            times.append(time.perf_counter() - t_run)
        finite = all(bool(torch.isfinite(v).all()) for v in out)
        if not (finite and np.isfinite(total)):
            raise AssertionError(f"{name} reconstruction is not finite")
        outputs[name] = out
        numbers[name] = dict(
            seconds=times, chain_steps_per_s=chain_steps / min(times),
            peak=torch.cuda.max_memory_allocated(), finite=finite,
            abs_max=max(v.abs().max().item() for v in out))
        if name == "f32":
            numbers["profile"] = profile_level(recon, yr, yi, n_steps,
                                               device)
    no_kernel_launches(fk, fl, "the reconstruction")
    numbers["bf16_vs_f32_rel_l2"] = max(
        rel_l2(a, b) for a, b in zip(outputs["bf16"], outputs["f32"]))

    if not numbers["bf16_vs_f32_rel_l2"] <= BF16_REL_L2:
        raise AssertionError(f"bf16 reconstruction vs float32: rel L2 "
                             f"{numbers['bf16_vs_f32_rel_l2']}")

    card = recon_check_parts(model, sigmas, lin_tfm, proximal,
                             check_in, device)
    cpu = cpu_side.result()
    numbers["card_vs_cpu_rel_l2"] = checks = {
        k: max(rel_l2(a, b) for a, b in zip(card[k], cpu[k])) for k in card}
    failed = {k: v for k, v in checks.items() if not v <= MODEL_REL_L2}
    if failed:
        raise AssertionError(f"reconstruction card vs CPU: rel L2 {failed}")
    return numbers


def recon_check_inputs(cfg, yr, yi) -> dict:
    """recon_check_parts' inputs: one chain's measurement and two noise
    draws (seed 5), on the CPU."""
    gen = torch.Generator().manual_seed(5)
    shape = (1,) + tuple(yr.shape[2:])
    return dict(cfg=cfg, y1=(yr[:, :1].cpu(), yi[:, :1].cpu()),
                draws=[torch.randn(shape, generator=gen) for _ in range(2)])


def recon_check_parts(net, sigmas, lin_tfm, proximal, inp: dict,
                      dev) -> dict:
    """The reconstruction's parts on `dev` (on the card in the float32
    mode), for card against CPU on its own tensors: one chain, the same
    injected noise. Parts: the score at the chain start (the interleaved
    batch of 2, channel-last) at the first and the last level; the
    proximal's correction prox(z) - z at the step's c from z = 0 (from the
    z of a step the correction is about 1e-6 of |z|, and float32's
    rounding of z, 6e-8 of |z|, moves it by percents on either device) and
    at c = 1 from z = the start plus level 0's noise, where A^H A moves x
    by about a tenth and the normal kernel and the CG show; the whole
    inner step at the first and the last level. On the CPU it makes no
    CUDA call (it may run on a thread of its own): `lin_tfm` and
    `proximal` are then the card's, copied to the CPU."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        stack_parts)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg = inp["cfg"]
    one = ALDConfig(n_steps_each=1, step_lr=cfg.sampling.step_lr,
                    denoise=False)
    last = ACDC_LEVELS - 1
    mode = contextlib.nullcontext() if str(dev) == "cpu" else float32_exact()
    with mode:
        recon = make_stepped_pair_reconstructor(
            net, sigmas, lin_tfm, proximal, one,
            lr_scaled=ACDC_LR_SCALED, device=dev)
        n_re, n_im = (d.to(dev) for d in inp["draws"])
        s0 = float(one.step_lr * (recon.sigmas[0] / recon.sigmas[-1]) ** 2)
        got = {}
        with torch.inference_mode():
            y1 = tuple(v.to(dev) for v in inp["y1"])
            xr, xi, prox = recon.start(*y1)
            stacked = stack_parts(xr, xi)
            for c in (0, last):
                got[f"score_level{c}"] = (recon.score_fn(
                    stacked, torch.full((2,), c, device=dev)),)
                it = iter((n_re, n_im))
                got[f"step_level{c}"] = recon.level_step(
                    prox, xr, xi, *y1, c, lambda s: next(it))
            zero = torch.zeros_like(xr)
            got["prox_step_c_from_0"] = prox(
                zero, zero, *y1, one.step_lr * ACDC_LR_SCALED, 1.0)
            amp = (2 * s0) ** 0.5
            zr, zi = xr + amp * n_re, xi + amp * n_im
            pr, pi = prox(zr, zi, *y1, 1.0, 1.0)
            got["prox_c1_correction"] = (pr - zr, pi - zi)
    return {k: [v.cpu() for v in vs] for k, vs in got.items()}


def serve_argv(dtype: str) -> list:
    """scripts.serve_recon's flags for acdc_problem's geometry, weights
    drawn from seed 0 (no --ckpt_dir)."""
    return ["--ds_name", "ACDC", "--R", str(ACDC_R), "--num_sens",
            str(ACDC_COILS), "--synth_sens", "--chains", str(ACDC_CHAINS),
            "--levels", str(SERVE_LEVELS), "--lr_scaled",
            str(ACDC_LR_SCALED),
            "--prox_iters", str(ACDC_CG_ITERS), "--dtype", dtype, "--mode",
            "steps", "--seed", "0", "--device", "cuda"]


def disk_label(size: int) -> np.ndarray:
    """A (size, size) int map: 1 inside a centred disk of radius size / 4."""
    hh, ww = np.mgrid[0:size, 0:size] - (size - 1) / 2
    return (hh ** 2 + ww ** 2 <= (size / 4) ** 2).astype(np.int64)


def post_npz(url: str, **arrays):
    """POST an npz body; returns (the response's arrays, its headers, the
    client's wall seconds for the round trip)."""
    import urllib.request
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t_req = time.perf_counter()
    with urllib.request.urlopen(req) as r:
        body = r.read()
        headers = dict(r.headers)
    wall = time.perf_counter() - t_req
    with np.load(io.BytesIO(body), allow_pickle=False) as npz:
        out = {k: npz[k] for k in npz.files}
    return out, headers, wall


def serve_requests(eng, requests, chain_steps: int) -> dict:
    """Serve `eng` on 127.0.0.1 (a free port) and POST each (query,
    arrays) of `requests`: every response holds the six arrays at their
    shapes, finite, and both headers; then /healthz counts the requests.
    Per request: the engine's latency and chain-steps/s (headers) and the
    client's round trip."""
    import urllib.request
    from inverseproblemwithdiffusionmodel_tpu_torch.serving.server import (
        serve)
    s = eng.spec
    image = (s.height, s.width, s.channels)
    if hasattr(s, "frames"):                 # a cine engine: volumes
        image = (s.frames,) + image
    shapes = {"x_re": (s.chains,) + image, "x_im": (s.chains,) + image,
              "mean_re": image, "mean_im": image, "mean_mag": image,
              "std_mag": image}
    before = eng.stats()["requests"]
    httpd = serve(eng, "127.0.0.1", 0, background=True)
    rows = []
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for query, arrays in requests:
            out, headers, wall = post_npz(f"{base}/reconstruct?{query}",
                                          **arrays)
            got = {k: v.shape for k, v in out.items()}
            finite = {k: bool(np.isfinite(v).all()) for k, v in out.items()}
            if got != shapes or not all(finite.values()):
                raise AssertionError(f"response {query}: shapes {got}, "
                                     f"finite {finite}")
            if not {"X-Latency-S", "X-Chain-Steps-Per-S"} <= set(headers):
                raise AssertionError(f"response {query}: headers {headers}")
            rows.append(dict(
                query=query, latency_s=float(headers["X-Latency-S"]),
                chain_steps_per_s=float(headers["X-Chain-Steps-Per-S"]),
                client_s=wall, client_chain_steps_per_s=chain_steps / wall))
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    if health["requests"] != before + len(requests):
        raise AssertionError(f"/healthz counts {health['requests']} "
                             f"requests, expected {before + len(requests)}")
    return dict(requests=rows, healthz_requests=health["requests"])


def serve_phase(fk, fl, device="cuda") -> dict:
    """The serving entry point at acdc_problem's geometry, the ladder cut
    to SERVE_LEVELS: for f32 and bf16
    in turn, scripts.serve_recon.build_engine (weights from seed 0), its
    warm-up, 3 requests over HTTP on 127.0.0.1 (the default operator, seed
    0; a new R = 8 mask, seed 1, lr_scaled 3.0; new coil maps, seed 2) and
    one in-process request; one input signature over them; peak memory.
    The f32 engine against make_stepped_pair_reconstructor on
    acdc_problem's operator, same measurement and seed, float32 mode. A
    guided bf16 engine (the full-width seg UNet of load_general_config,
    seed 0, seg_lamda 1.0 from the first level) on a disk label: one
    request over HTTP and one in-process. Card against CPU on one chain:
    a guided inner step at the last level (float32 mode) and
    compute_seg_grad (float64; float32 against float64). None of K1, K2 or
    K4 launches."""
    import dataclasses
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        load_model, make_seg_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig, compute_seg_grad)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
        ReconstructionEngine)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        stack_parts)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg = load_config("ACDC", "real-imag")
    size = cfg.data.image_size
    lin_tfm, proximal, sigmas, yr, yi = acdc_problem(cfg, device,
                                                     SERVE_LEVELS)
    # the single-copy measurement of chain 0, as a client sends it
    y_re, y_im = (v[:, 0].cpu().numpy() for v in (yr, yi))
    mask1 = generate_mask(1, size, seed=1, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, 10 + i)
                     for i in range(ACDC_COILS)])
    maps = (maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True)))[..., None]
    requests = [("seed=0", dict(y_re=y_re, y_im=y_im)),
                ("seed=1&lr_scaled=3.0", dict(y_re=y_re, y_im=y_im,
                                              mask=mask1)),
                ("seed=2", dict(y_re=y_re, y_im=y_im, sens_re=maps))]
    n_steps = cfg.sampling.n_steps_each
    chain_steps = SERVE_LEVELS * n_steps * ACDC_CHAINS
    numbers = dict(chain_steps=chain_steps)
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name in ("f32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        eng = serve_recon.build_engine(serve_recon.parse_args(
            serve_argv(name)))
        build_s = time.perf_counter() - t_build
        warmup_s = eng.warmup()
        served = serve_requests(eng, requests, chain_steps)
        res = eng.reconstruct(y_re, y_im, seed=3)
        # host work of a request outside the engine's latency: the normal
        # kernel (a W x W einsum) before it, the npz encoding after it
        t_host = time.perf_counter()
        PairL2Penalty.with_normal_kernel(eng.default_lin_tfm,
                                         num_iters=ACDC_CG_ITERS)
        kernel_s = time.perf_counter() - t_host
        t_host = time.perf_counter()
        np.savez(io.BytesIO(), **res.to_npz_dict())
        npz_s = time.perf_counter() - t_host
        stats = eng.stats()
        if stats["input_signatures"] != 1 or stats["requests"] != 4:
            raise AssertionError(f"{name} engine stats {stats}")
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError(f"{name} in-process request not finite")
        numbers[name] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            normal_kernel_s=kernel_s, npz_encode_s=npz_s,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s),
            input_signatures=stats["input_signatures"],
            peak=torch.cuda.max_memory_allocated())
        if name == "f32":
            # the engine against the direct path on acdc_problem's
            # operator (built apart from serve_recon's), float32 mode
            ald_cfg = ALDConfig(n_steps_each=n_steps,
                                step_lr=cfg.sampling.step_lr)
            with float32_exact():
                ours = eng.reconstruct(y_re, y_im, seed=5)
                recon = make_stepped_pair_reconstructor(
                    eng.model, sigmas, lin_tfm, proximal, ald_cfg,
                    lr_scaled=ACDC_LR_SCALED, device=device)
                shape = (ACDC_COILS, ACDC_CHAINS) + tuple(yr.shape[2:])
                ref = recon(yr[:, :1].expand(shape).contiguous(),
                            yi[:, :1].expand(shape).contiguous(), seed=5)
            numbers["engine_vs_direct_rel_l2"] = max(
                rel_l2(torch.from_numpy(a), b.cpu())
                for a, b in zip((ours.x_re, ours.x_im), ref))
            if not numbers["engine_vs_direct_rel_l2"] <= ENGINE_REL_L2:
                raise AssertionError(
                    f"engine vs make_stepped_pair_reconstructor: rel L2 "
                    f"{numbers['engine_vs_direct_rel_l2']}")
            del recon, ref
            del eng
            continue
        # the guided bf16 engine: the bf16 engine's net and operator, and
        # the full-width seg UNet
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seg_cpu, _ = load_model(None, "Seg", seed=0)
        label = disk_label(size)
        spec = dataclasses.replace(eng.spec, seg_lamda=1.0,
                                   seg_start_time=0.0)
        t_build = time.perf_counter()
        guided = ReconstructionEngine(
            eng.model, eng.sigmas, spec=spec,
            mask=eng.default_lin_tfm.mask.cpu().numpy(),
            sens_re=eng.default_lin_tfm.sens_re.cpu().numpy(),
            seg_model=copy.deepcopy(seg_cpu), device=device)
        build_s = time.perf_counter() - t_build
        warmup_s = guided.warmup()
        served = serve_requests(guided, [("seed=0", dict(
            y_re=y_re, y_im=y_im, seg_label=label))], chain_steps)
        res = guided.reconstruct(y_re, y_im, seed=3, seg_label=label)
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError("guided in-process request not finite")
        numbers["guided_bf16"] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s),
            input_signatures=guided.stats()["input_signatures"],
            peak=torch.cuda.max_memory_allocated(),
            seg_params=sum(p.numel() for p in seg_cpu.parameters()))
        seg_dev = guided.seg_model
        del guided, eng
    no_kernel_launches(fk, fl, "the serving phase")
    torch.cuda.empty_cache()

    # Card against CPU, one chain. The guided inner step at the last level
    # (the ramp's weight is 0 at the first level and 1 at the last), float32
    # mode. The guidance gradient at the chain's start, on the same input
    # on both devices: in float64 (the same function), and each device's
    # float32 gradient against the CPU's float64 one. In float32 the
    # gradient loses digits in the backward through the UNet's instance
    # norms, 4e-4 to 3e-3 on the card and up to 8e-4 on the CPU at 256 px
    # (PERF.md), so the card's float32 gradient is held to the
    # float64 one at SEG_F32_REL_L2, not to the CPU's float32 result.
    _, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu).to(device)
    one = ALDConfig(n_steps_each=1, step_lr=cfg.sampling.step_lr,
                    denoise=False)
    gen = torch.Generator().manual_seed(6)
    draws = [torch.randn((1,) + tuple(yr.shape[2:]), generator=gen)
             for _ in range(2)]
    label1 = torch.from_numpy(label)[None]
    last = SERVE_LEVELS - 1
    steps = []
    with float32_exact():
        for dev, net, seg in ((device, model, seg_dev),
                              ("cpu", model_cpu, seg_cpu)):
            recon = make_stepped_pair_reconstructor(
                net, sigmas, lin_tfm, proximal, one,
                lr_scaled=ACDC_LR_SCALED, seg_fn=make_seg_fn(seg),
                seg_label=label1, seg_lamda=1.0, seg_start_time=0.0,
                device=dev)
            with torch.no_grad():
                y1 = yr[:, :1].to(dev), yi[:, :1].to(dev)
                xr, xi, prox = recon.start(*y1)
                it = iter(d.to(dev) for d in draws)
                steps.append([v.cpu() for v in recon.level_step(
                    prox, xr, xi, *y1, last, lambda s: next(it))])
        # the chain's start on the CPU (the last loop pass), both labels
        stacked = stack_parts(xr, xi)
        label2 = recon.seg_label2
        grads = {}
        for dev, seg in ((device, seg_dev), ("cpu", seg_cpu)):
            for dtype in (torch.float32, torch.float64):
                net = copy.deepcopy(seg).to(dev, dtype)
                grads[dev, dtype] = compute_seg_grad(
                    make_seg_fn(net), stacked.to(dev, dtype),
                    label2.to(dev)).cpu()
                del net
    exact = grads["cpu", torch.float64]
    checks = {
        f"guided_step_level{last}": max(rel_l2(a, b) for a, b in
                                        zip(*steps)),
        "seg_grad_f64": rel_l2(grads[device, torch.float64], exact),
        "seg_grad_f32_card_vs_f64": rel_l2(grads[device, torch.float32],
                                           exact),
        "seg_grad_f32_cpu_vs_f64": rel_l2(grads["cpu", torch.float32],
                                          exact),
        "seg_grad_f32_card_vs_cpu": rel_l2(grads[device, torch.float32],
                                           grads["cpu", torch.float32])}
    numbers["guided_card_vs_cpu_rel_l2"] = checks
    if not (checks[f"guided_step_level{last}"] <= MODEL_REL_L2
            and checks["seg_grad_f64"] <= SEG_F64_REL_L2
            and checks["seg_grad_f32_card_vs_f64"] <= SEG_F32_REL_L2):
        raise AssertionError(f"guided card vs CPU: rel L2 {checks}")
    return numbers


def cine_argv(dtype: str) -> list:
    """scripts.serve_recon's flags for the cine phase: README's cine
    geometry, spatial NCSNv2Deepest (CINE127) and temporal NCSN1D
    (CINE127_1D), weights drawn from seed 0 (no --ckpt_dir)."""
    return ["--workload", "cine", "--ds_name", "CINE127", "--ds_name_T",
            "CINE127_1D", "--mode_T", "diffusion1d", "--frames",
            str(CINE_FRAMES), "--win_size", str(CINE_WIN), "--R", "8",
            "--num_sens", "4", "--synth_sens", "--chains", str(CINE_CHAINS),
            "--levels", str(CINE_SERVE_LEVELS), "--dtype", dtype, "--mode",
            "steps",
            "--seed", "0", "--device", "cuda"]


def cine_problem(size: int, frames: int, coils: int = 4):
    """serve_recon's default cine operator for --seed 0 (per-frame R = 8
    masks, 4 synthetic coil maps) and one cine measurement of it, a
    single copy as a client sends it: frames of uniform magnitude and
    normal phase (a torch.Generator seeded 0). Returns the mask (T, 1, W,
    1), the maps (coils, H, W, 1) and y_re, y_im (coils, T, H, W)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairSENSE)
    mask = generate_mask(frames, size, seed=0, **MASK_PRESETS[8]).reshape(
        frames, 1, size, 1)
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(coils)])
    maps = (maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
            )[..., None].astype(np.float32)
    sens = torch.tensor(maps)
    lin = PairSENSE(mask=torch.tensor(mask), sens_re=sens,
                    sens_im=torch.zeros_like(sens))
    gen = torch.Generator().manual_seed(0)
    shape = (frames, size, size, 1)
    mag, phase = torch.rand(shape, generator=gen), torch.randn(
        shape, generator=gen)
    yr, yi = lin(mag * torch.cos(phase), mag * torch.sin(phase))
    return mask, maps, yr[..., 0].numpy(), yi[..., 0].numpy()


def cine_tiled(mask, maps, y_re, y_im, chains: int, device):
    """The operator, proximal and measurement of `chains` chains: the
    per-frame mask and the measurement tiled over the chains x frames
    axis, as the cine engine tiles them."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    sens = torch.tensor(maps)
    lin = PairSENSE(mask=torch.tensor(np.tile(mask, (chains, 1, 1, 1))),
                    sens_re=sens, sens_im=torch.zeros_like(sens)).to(device)
    prox = PairL2Penalty.with_normal_kernel(lin, num_iters=4)
    tile = lambda y: torch.tensor(y)[:, None, ..., None].expand(
        (y.shape[0], chains) + y.shape[1:] + (1,)).flatten(1, 2).to(device)
    return lin, prox, tile(y_re), tile(y_im)


class PhaseTimer:
    """CUDA events around each call of wrapped functions, summed per name
    after a synchronize: the device time of each part of a level step (the
    stream is busy throughout, the host enqueues ahead of it)."""

    def __init__(self):
        self.events = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}


def profile_cine_level(eng, y_re, y_im, device) -> dict:
    """One level step of the engine's chain at CINE_CHECK_LEVEL (a level
    with a temporal step), torch's defaults: its device ms split by CUDA
    events into the spatial net (make_score_fn, its NCHW view and casts),
    the temporal step (apply_in_tube_space: the tube reshapes, the roll,
    the tube Langevin updates and the temporal net), the temporal net
    alone (its (B', T, C) <-> (B', C, T) copies included), the proximal
    (CG), and the rest (the frames' Langevin updates and the Re/Im
    interleaves); then profile_level's profiler numbers for the same
    step."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        finite_diff)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald_pair
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    s = eng.spec
    yr, yi = (eng._broadcast_chains(eng._canon_measurement(v))
              for v in (y_re, y_im))
    recon = eng._reconstructor(eng.default_lin_tfm,
                               eng._build_proximal(eng.default_lin_tfm),
                               s.lr_scaled, s.lamda_T)
    timer = PhaseTimer()
    split = copy.copy(recon)
    split.inner = ald_pair._pair_2d_time_inner(
        timer.wrap("spatial_net", eng._score_S),
        timer.wrap("temporal_net", eng._score_T), finite_diff.FiniteDiff(1),
        recon.config, s.mode_T, s.win_size, recon.sigmas[-1],
        recon.sigmas_T[-1])
    noise = gaussian_noise(7, device)
    tubes = ald_pair.apply_in_tube_space
    with torch.inference_mode():
        xr, xi, prox = recon.start(yr, yi)
        split.level_step(prox, xr, xi, yr, yi, CINE_CHECK_LEVEL, noise)
        timer.events.clear()
        ald_pair.apply_in_tube_space = timer.wrap("temporal_step", tubes)
        try:
            timer.wrap("level", split.level_step)(
                timer.wrap("proximal", prox), xr, xi, yr, yi,
                CINE_CHECK_LEVEL, noise)
        finally:
            ald_pair.apply_in_tube_space = tubes
    ms = timer.ms()
    ms["tube_reshapes_and_langevin"] = ms["temporal_step"] - ms["temporal_net"]
    ms["frame_langevin_and_rest"] = ms["level"] - sum(
        ms[k] for k in ("spatial_net", "temporal_step", "proximal"))
    return dict(split_ms=ms, **profile_level(recon, yr, yi, s.n_steps_each,
                                             device, CINE_CHECK_LEVEL))


def reuse_last(forward):
    """`forward` that, called again with tensors equal bit for bit to its
    last call's, returns a copy of its last output instead of computing it
    again (`.reused` counts those calls)."""
    last = {}

    def call(*args):
        if last and len(args) == len(last["args"]) and all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(args, last["args"])):
            call.reused += 1
            return last["out"].clone()
        out = forward(*args)
        last.update(args=[a.clone() for a in args], out=out.clone())
        return out

    call.reused = 0
    return call


def cine_phase(fk, fl, device="cuda") -> dict:
    """The cine serving path at README's geometry (CINE127 frames, 128 px,
    T = 24, 4 coils, per-frame R = 8 masks; spatial NCSNv2Deepest ngf 128,
    temporal NCSN1D ngf 128 on 8 x 8 tubes; 4 chains, the ladder cut to 2
    of 1000 levels): for f32 and bf16 in turn, scripts.serve_recon.
    build_engine --workload cine (weights from seed 0), its warm-up, 3
    requests over HTTP on 127.0.0.1 (the default operator, seed 0; new
    per-frame R = 8 masks, seed 1, lr_scaled 3.0; new coil maps, seed 2)
    and one in-process request with lamda_T 0.5 (the f32 engine's against
    make_stepped_2d_time_pair_reconstructor on the same problem and seed,
    both in torch's defaults; bf16 against it); one input signature; the
    host's seconds for a request's operator and normal kernel; peak
    memory. A profiled level step of the f32 engine. The full-width
    NCSN1D forward and one inner step at a temporal level (one chain,
    shift off and on, the same injected noise and shift) card against
    CPU in the float32 mode (cine_check_parts; the CPU side on a thread
    of its own after the f32 engine's in-process request, so the bf16
    engine's numbers are read beside it). None of K1, K2 or K4
    launches."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_2d_time_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    cfg = load_config("CINE127", "real-imag")
    size, T = cfg.data.image_size, CINE_FRAMES
    mask, maps, y_re, y_im = cine_problem(size, T)
    mask1 = generate_mask(T, size, seed=1, **MASK_PRESETS[8]).reshape(
        T, 1, size, 1)
    maps2 = np.stack([_exp_sens_map(size, size, 10 + i) for i in range(4)])
    maps2 = (maps2 / np.sqrt((maps2 ** 2).sum(axis=0, keepdims=True))
             )[..., None]
    requests = [("seed=0", dict(y_re=y_re, y_im=y_im)),
                ("seed=1&lr_scaled=3.0", dict(y_re=y_re, y_im=y_im,
                                              mask=mask1)),
                ("seed=2", dict(y_re=y_re, y_im=y_im, sens_re=maps2))]
    n_steps = cfg.sampling.n_steps_each
    chain_steps = CINE_SERVE_LEVELS * n_steps * CINE_CHAINS
    numbers = dict(chain_steps=chain_steps, frames=T, chains=CINE_CHAINS,
                   levels=CINE_SERVE_LEVELS,
                   reduced=f"chains {CINE_CHAINS} (serve_recon's default "
                           f"16), {CINE_SERVE_LEVELS} of the config's 1000 "
                           f"levels")
    outputs = {}
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name in ("f32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        eng = serve_recon.build_engine(serve_recon.parse_args(
            cine_argv(name)))
        build_s = time.perf_counter() - t_build
        warmup_s = eng.warmup()
        served = serve_requests(eng, requests, chain_steps)
        # a request's host work before the chain: its operator (mask
        # tiled over the chains) and its (T, W, W) normal kernel
        t_host = time.perf_counter()
        lin = eng._build_lin_tfm(mask1, None, None)
        torch.cuda.synchronize()
        operator_s = time.perf_counter() - t_host
        t_host = time.perf_counter()
        prox = eng._build_proximal(lin)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t_host
        if tuple(prox.kernel_re.shape) != (T, size, size):
            raise AssertionError(f"normal kernel of shape "
                                 f"{tuple(prox.kernel_re.shape)}")
        res = eng.reconstruct(y_re, y_im, seed=3, lamda_T=CINE_LAMDA_T)
        outputs[name] = (res.x_re, res.x_im)
        if name == "f32":
            # the card-vs-CPU check's CPU side runs beside the rest of the
            # phase; the spatial step sees the same frames with the shift
            # off and on, so the CPU's spatial net computes them once
            check_in = cine_check_inputs(cfg, mask, maps, y_re, y_im)
            cpu_S = copy.deepcopy(eng.model_S).cpu()
            cpu_S.forward = reuse_last(cpu_S.forward)
            cpu_side = Background(
                cine_check_parts, cpu_S, copy.deepcopy(eng.model_T).cpu(),
                torch.as_tensor(eng.sigmas_S).cpu(),
                torch.as_tensor(eng.sigmas_T).cpu(), check_in, "cpu")
        stats = eng.stats()
        want = (CINE_CHAINS, T, size, size, 1)
        if (stats["input_signatures"] != 1 or stats["requests"] != 4
                or res.x_re.shape != want):
            raise AssertionError(f"{name} cine engine stats {stats}, shape "
                                 f"{res.x_re.shape}")
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError(f"{name} cine in-process request not finite")
        numbers[name] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            operator_s=operator_s, normal_kernel_s=kernel_s,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s,
                            lamda_T=CINE_LAMDA_T),
            input_signatures=stats["input_signatures"], shape=list(want),
            peak=torch.cuda.max_memory_allocated())
        if name == "bf16":
            del eng
            continue
        # the engine against the direct path on cine_problem's operator
        # (built apart from serve_recon's), the same seed and lamda_T: the
        # same operations on the same card, so torch's defaults (TF32) as
        # in the request; the float32 mode would take 4.3 times as long
        # (42.37 s a request, PERF.md)
        lin_d, prox_d, yb_re, yb_im = cine_tiled(mask, maps, y_re, y_im,
                                                 CINE_CHAINS, device)
        direct = make_stepped_2d_time_pair_reconstructor(
            eng.model_S, eng.model_T, eng.sigmas_S, eng.sigmas_T, lin_d,
            prox_d, eng.ald_config, lr_scaled=eng.spec.lr_scaled,
            lamda_T=CINE_LAMDA_T, win_size=CINE_WIN, num_frames=T,
            device=device)(yb_re, yb_im, seed=3)
        numbers["engine_vs_direct_rel_l2"] = max(
            rel_l2(torch.from_numpy(a), b.cpu())
            for a, b in zip(outputs["f32"], direct))
        if not numbers["engine_vs_direct_rel_l2"] <= ENGINE_REL_L2:
            raise AssertionError(
                f"cine engine vs make_stepped_2d_time_pair_reconstructor: "
                f"rel L2 {numbers['engine_vs_direct_rel_l2']}")
        del direct
        numbers["profile"] = profile_cine_level(eng, y_re, y_im, device)
        # the two nets alone at the chain's batches, torch's defaults
        tubes = 2 * CINE_CHAINS * (size // CINE_WIN) ** 2
        gen = torch.Generator().manual_seed(4)
        with torch.inference_mode():
            xs = torch.rand(2 * CINE_CHAINS * T, size, size, 1,
                            generator=gen).to(device)
            xt = torch.rand(tubes, T, CINE_WIN ** 2, generator=gen).to(device)
            lab = lambda n: torch.full((n,), CINE_CHECK_LEVEL, device=device)
            numbers["spatial_net_ms"] = cuda_ms(
                lambda: eng._score_S(xs, lab(len(xs))), reps=3)
            numbers["temporal_net_ms"] = cuda_ms(
                lambda: eng._score_T(xt, lab(len(xt))), reps=3)
        numbers["net_batches"] = dict(spatial=len(xs), temporal=tubes)
        model_S, model_T = eng.model_S, eng.model_T
        sigmas_S, sigmas_T = eng.sigmas_S, eng.sigmas_T
        del eng, xs, xt
    no_kernel_launches(fk, fl, "the cine phase")
    numbers["bf16_vs_f32_rel_l2"] = max(
        rel_l2(torch.from_numpy(a), torch.from_numpy(b))
        for a, b in zip(outputs["bf16"], outputs["f32"]))
    if not numbers["bf16_vs_f32_rel_l2"] <= BF16_REL_L2:
        raise AssertionError(f"cine bf16 vs f32: rel L2 "
                             f"{numbers['bf16_vs_f32_rel_l2']}")
    torch.cuda.empty_cache()

    card = cine_check_parts(model_S, model_T, sigmas_S, sigmas_T,
                            check_in, device)
    cpu = cpu_side.result()
    checks = {k: max(rel_l2(a, b) for a, b in zip(card[k], cpu[k]))
              for k in card}
    numbers["card_vs_cpu_rel_l2"] = checks
    numbers["cpu_check_s"] = cpu_side.seconds
    numbers["cpu_spatial_reused"] = cpu_S.forward.reused
    failed = {k: v for k, v in checks.items() if not v <= MODEL_REL_L2}
    if failed:
        raise AssertionError(f"cine card vs CPU: rel L2 {failed}")
    return numbers


def cine_check_inputs(cfg, mask, maps, y_re, y_im) -> dict:
    """cine_check_parts' inputs, on the CPU: 64 tubes and their levels
    (seed 8), one chain's operator, proximal and measurement, and the
    inner step's noise draws."""
    size, T = cfg.data.image_size, CINE_FRAMES
    gen = torch.Generator().manual_seed(8)
    tubes = torch.rand(64, T, CINE_WIN ** 2, generator=gen)
    lin1, prox1, y1_re, y1_im = cine_tiled(mask, maps, y_re, y_im, 1, "cpu")
    frames = (T, size, size, 1)
    tube_shape = ((size // CINE_WIN) ** 2, T, CINE_WIN ** 2)
    return dict(cfg=cfg, tubes=tubes, labels=torch.tensor([57, 342] * 32),
                lin1=lin1, prox1=prox1, y1=(y1_re, y1_im),
                draws=[torch.randn(shp, generator=gen) for shp in
                       (frames, frames, tube_shape, tube_shape)])


def cine_check_parts(model_S, model_T, sigmas_S, sigmas_T, inp: dict,
                     dev) -> dict:
    """Card against CPU, float32 mode: the full-width NCSN1D through
    make_score_fn on channel-last tubes at the first temporal level and
    the last; one inner step at CINE_CHECK_LEVEL on one chain of T frames,
    the same injected noise (the frames' Re and Im, then the tubes') and,
    with the random shift on, the same roll. On the CPU it makes no CUDA
    call (it may run on a thread of its own): the nets and ladders are then
    CPU copies."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_2d_time_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    mode = contextlib.nullcontext() if str(dev) == "cpu" else float32_exact()
    one = ALDConfig(n_steps_each=1, step_lr=inp["cfg"].sampling.step_lr)
    out = {}
    with mode:
        with torch.inference_mode():
            out["ncsn1d_forward"] = [make_score_fn(model_T, sigmas_T)(
                inp["tubes"].to(dev), inp["labels"].to(dev)).cpu()]
        for shift_on in (False, True):
            recon = make_stepped_2d_time_pair_reconstructor(
                model_S, model_T, sigmas_S, sigmas_T, inp["lin1"],
                inp["prox1"], one, lr_scaled=5.0, if_random_shift=shift_on,
                win_size=CINE_WIN, num_frames=CINE_FRAMES, device=dev)
            it = iter(d.to(dev) for d in inp["draws"])
            with torch.inference_mode():
                y1 = tuple(v.to(dev) for v in inp["y1"])
                xr, xi, prox = recon.start(*y1)
                out[f"inner_step_shift_{'on' if shift_on else 'off'}"] = [
                    v.cpu() for v in recon.level_step(
                        prox, xr, xi, *y1, CINE_CHECK_LEVEL,
                        lambda s: next(it), lambda win: (3, 5))]
    return out


def profile_level(recon, yr, yi, n_steps, device, level: int = 0) -> dict:
    """One level step (n_steps inner steps at `level`) of `recon` timed by
    CUDA events
    and by the host clock, then the same under torch.profiler
    (profile_calls)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    noise = gaussian_noise(7, device)
    with torch.inference_mode():
        xr, xi, prox = recon.start(yr, yi)
        step = lambda: recon.level_step(prox, xr, xi, yr, yi, level, noise)
        device_ms, host_ms = cuda_ms(step, reps=3, host=True)
        prof = profile_calls(step, n_steps)
    return dict(level_device_ms=device_ms, level_host_ms=host_ms,
                launches_per_inner_step=prof.pop("launches_per_unit"),
                device_events_per_inner_step=prof.pop(
                    "device_events_per_unit"), **prof)


def profile_calls(step, n_units: int) -> dict:
    """`step()` once under torch.profiler after a synchronize: the wall and
    the kernels' ms, the device's idle share of the window, launches and
    device events per unit (`step` covering n_units of them), the top 10
    device kernels and the top 10 operators by device time (with call
    counts), and the ms of cuDNN's NCHW <-> NHWC layout conversions."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_run = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t_run)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: -e.device_time_total)
    ops = sorted((e for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    device_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")))
    return dict(
        profiled_wall_ms=wall_us / 1e3, profiled_device_ms=device_us / 1e3,
        idle_share=idle_share(prof, wall_us),
        launches_per_unit=launches / n_units,
        device_events_per_unit=sum(e.count for e in kernels) / n_units,
        top_kernels=[(e.key[:90], e.count, e.device_time_total / 1e3)
                     for e in kernels[:10]],
        layout_ms=sum(e.device_time_total for e in kernels if any(
            k in e.key for k in ("nchwToNhwc", "nhwcToNchw"))) / 1e3,
        top_ops=[(e.key, e.count, e.self_device_time_total / 1e3)
                 for e in ops[:10]])


def report_cine(cine: dict, t: float) -> None:
    """The cine phase's lines: per engine, then the profiled level step,
    then the phase's summary."""
    prof = cine["profile"]
    for name in ("f32", "bf16"):
        r = cine[name]
        http = ", ".join(
            f"{q['query']}: {q['chain_steps_per_s']:.2f} (engine) / "
            f"{q['client_chain_steps_per_s']:.2f} (client, "
            f"{q['client_s']:.4f} s)" for q in r["requests"])
        print(f"    {name}: build {r['build_s']:.2f} s, warm-up "
              f"{r['warmup_s']:.2f} s; chain-steps/s over HTTP {http}; "
              f"in-process (lamda_T {CINE_LAMDA_T}) "
              f"{r['in_process']['chain_steps_per_s']:.2f} "
              f"({r['in_process']['latency_s']:.4f} s); shape {r['shape']}; "
              f"/healthz requests {r['healthz_requests']}; input signatures "
              f"{r['input_signatures']}; peak {r['peak']} bytes; host: "
              f"operator {r['operator_s']:.4f} s, (T, W, W) normal kernel "
              f"{r['normal_kernel_s']:.4f} s", flush=True)
    split = ", ".join(f"{k} {v:.2f}" for k, v in prof["split_ms"].items())
    print(f"    one level step (f32, level {CINE_CHECK_LEVEL}, "
          f"{CINE_FRAMES} frames x {CINE_CHAINS} chains): device ms by part: "
          f"{split}; profiled: wall {prof['profiled_wall_ms']:.2f} ms, "
          f"kernels {prof['profiled_device_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.4f}, launches per inner step "
          f"{prof['launches_per_inner_step']:.1f}; nets alone (torch "
          f"defaults): spatial {cine['spatial_net_ms']:.2f} ms at batch "
          f"{cine['net_batches']['spatial']}, temporal "
          f"{cine['temporal_net_ms']:.2f} ms at batch "
          f"{cine['net_batches']['temporal']}", flush=True)
    for label, rows in (("kernel", prof["top_kernels"]),
                        ("op", prof["top_ops"])):
        for key, calls, ms in rows:
            print(f"    top {label}: {ms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    say("cine", t, f"serve_recon --workload cine (CINE127 128 px spatial "
        f"NCSNv2Deepest + CINE127_1D NCSN1D, ngf 128 each, seed 0; "
        f"{CINE_FRAMES} frames, 4 coils, per-frame R = 8, {CINE_WIN}x"
        f"{CINE_WIN} tubes; reduced: {cine['reduced']}), 3 requests over "
        f"HTTP per engine and one in-process: f32 "
        f"{cine['f32']['in_process']['chain_steps_per_s']:.2f} "
        f"chain-steps/s in-process, bf16 "
        f"{cine['bf16']['in_process']['chain_steps_per_s']:.2f}; engine vs "
        f"make_stepped_2d_time_pair_reconstructor "
        f"(same card, TF32) rel L2 {cine['engine_vs_direct_rel_l2']:.3g} (<= "
        f"{ENGINE_REL_L2}); bf16 vs f32 rel L2 "
        f"{cine['bf16_vs_f32_rel_l2']:.3g} (<= {BF16_REL_L2}); card vs CPU "
        f"(float32 mode) rel L2 {json.dumps(cine['card_vs_cpu_rel_l2'])} "
        f"(each <= {MODEL_REL_L2}; the CPU side {cine['cpu_check_s']:.1f} "
        f"s, its spatial net reused {cine['cpu_spatial_reused']} times); one "
        f"input signature per engine; no K1/K2/K4 launch")


@contextlib.contextmanager
def timed_fit(train_ncsn, rec: dict, watch: str, steps=None):
    """Wrap the `fit` that a training script (scripts.train_ncsn,
    train_clf, train_seg) calls, and Checkpointer.save: every step and
    eval step is timed between CUDA synchronizations; after the first step
    its peak memory is kept and the peak reset, so the run's peak is the
    steady one; each checkpoint save is timed apart. `watch` (a
    parameter's name) is copied before the run and after each step, for
    the EMA and accumulation checks; rec["hook"], where set, sees each
    (state, batch). `steps` stops the run after that many steps."""
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        checkpoint)
    inner_fit, inner_save = train_ncsn.fit, checkpoint.Checkpointer.save
    for key in ("step_s", "eval_s", "save_s", "losses", "history"):
        rec[key] = []

    def save(self, *args, **kwargs):
        torch.cuda.synchronize()
        t_save = time.perf_counter()
        inner_save(self, *args, **kwargs)
        rec["save_s"].append(time.perf_counter() - t_save)

    def fit(state, step, train_iter_fn, cfg, eval_step=None,
            val_iter_fn=None, **kwargs):
        rec["w0"] = state.params[watch].detach().double().cpu()

        def timed_step(state, batch, generator):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            state, loss = step(state, batch, generator)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t_step)
            rec["losses"].append(float(loss))
            rec["history"].append(
                state.params[watch].detach().double().cpu())
            if len(rec["step_s"]) == 1:
                rec["first_peak"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if "hook" in rec:
                rec["hook"](state, batch)
            return state, loss

        def timed_eval(state, batch, generator):
            torch.cuda.synchronize()
            t_eval = time.perf_counter()
            loss = float(eval_step(state, batch, generator))
            rec["eval_s"].append(time.perf_counter() - t_eval)
            return loss

        if steps is not None:
            cfg = dataclasses.replace(cfg, max_steps=steps)
        return inner_fit(state, timed_step, train_iter_fn, cfg,
                         eval_step=timed_eval if eval_step else None,
                         val_iter_fn=val_iter_fn, **kwargs)

    train_ncsn.fit, checkpoint.Checkpointer.save = fit, save
    try:
        yield rec
    finally:
        train_ncsn.fit, checkpoint.Checkpointer.save = inner_fit, inner_save


def train_ncsn_phase(fk, fl, device="cuda", override=()) -> dict:
    """Discrete score training through scripts.train_ncsn.main on the
    loaders' synthetic stand-ins, torch's defaults (TF32), each run in a
    temporary --log_dir and --data_root (no data files: the stand-in):
    ACDC real-imag (NCSNv2Deepest, 256 px, ngf 128, if_centering) at the
    recipe's batch 3 and the README's batch 8 in f32, batch 8 in bf16,
    with and without --remat, and --grad_accum 2 at batch 3; CINE127_1D
    real-imag (NCSN1D, ngf 128, 8 x 8 tubes of 24 frames, the config's
    batch 90 and filter_th 0.05) in f32 and bf16. Per run: s/step and
    images/s over the steps after the first, each timed between CUDA
    synchronizations; the first step's peak memory and the steady peak
    after it; the seconds spent saving checkpoints and in the eval steps;
    finite losses; the step count; the EMA of one parameter against its
    formula over the run; for --grad_accum, the parameters moving at every
    second micro-step only. Then serve_recon.build_engine --ckpt_dir on
    the batch-8 f32 run's checkpoints: the restored step, the EMA weights
    loaded, one finite request (256 px, R = 8, 4 coils, 8 levels). Then
    `train_step_checks`: one ACDC step at batch 1 (2 rows) and one
    CINE127_1D step at batch 8 tubes, card against CPU and bf16 against
    f32, the CPU side on a thread of its own from the phase's start. None
    of K1, K2 or K4 launches. `override` adds --override flags
    to every train_ncsn run and config (a rehearsal at a tiny size)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon, train_ncsn)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
        apply_overrides)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        filter_batch)
    over = [f for kv in override for f in ("--override", kv)]
    datasets = {"acdc": ["--ds_name", "ACDC", "--task_name", "Diffusion"],
                "cine": ["--ds_name", "CINE127_1D", "--task_name",
                         "Diffusion1D", "--flatten_type", "temporal"]}
    cfgs = {"acdc": apply_overrides(load_config("ACDC", "real-imag"),
                                    override),
            "cine": apply_overrides(load_config("CINE127_1D", "real-imag"),
                                    override)}
    # train_step_checks' CPU side runs beside the training runs
    step_cpu = train_step_cpu_start(cfgs)
    watch = "end_conv.bias"
    numbers = dict(runs={})
    root = tempfile.mkdtemp(prefix="chip_smoke_train_ncsn_")
    ckpt_dir = None
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    try:
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        for name, (flags, steps) in TRAIN_NCSN_RUNS.items():
            kind = name.split("_")[0]
            cfg = cfgs[kind]
            batch_size = int(flags[flags.index("--batch_size") + 1]) \
                if "--batch_size" in flags else cfg.training.batch_size
            log_dir = os.path.join(root, name)
            kept = []
            rec = {}
            if kind == "cine":
                rec["hook"] = lambda state, batch: kept.append(float(
                    filter_batch(torch.as_tensor(2.0 * batch - 1.0),
                                 cfg.data.th).mean()))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            with timed_fit(train_ncsn, rec, watch), \
                    warnings_quiet():
                state = train_ncsn.main(
                    datasets[kind] + flags + [
                        "--mode", "real-imag", "--device", device,
                        "--log_dir", log_dir, "--data_root", data_root,
                        "--override", f"training.n_iters={steps}"] + over)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            peak = torch.cuda.max_memory_allocated()
            s_step = float(np.mean(rec["step_s"][1:]))
            decay = cfg.model.ema_rate
            ema = rec["w0"]
            for p in rec["history"]:
                ema = decay * ema + (1 - decay) * p
            ema_err = float((state.ema.params[watch].double().cpu() - ema)
                            .abs().max() / ema.abs().max())
            r = dict(batch=batch_size, rows=2 * batch_size, steps=state.step,
                     step_s=rec["step_s"], s_per_step=s_step,
                     images_per_s=batch_size / s_step,
                     first_step_s=rec["step_s"][0],
                     first_step_peak=rec["first_peak"], steady_peak=peak,
                     save_s=rec["save_s"], eval_s=sum(rec["eval_s"]),
                     eval_batches=len(rec["eval_s"]), wall_s=wall,
                     losses=rec["losses"], ema_rel_err=ema_err,
                     params=sum(p.numel() for p in
                                state.model.parameters()))
            if kept:
                r["filter_kept_share"] = float(np.mean(kept))
            if not (state.step == steps and len(rec["losses"]) == steps
                    and np.isfinite(rec["losses"]).all()):
                raise AssertionError(f"train_ncsn {name}: step "
                                     f"{state.step}, losses {rec['losses']}")
            if not ema_err <= 1e-6:
                raise AssertionError(f"train_ncsn {name}: EMA of {watch} "
                                     f"off its formula by {ema_err}")
            if "--grad_accum" in flags:
                path = [rec["w0"]] + rec["history"]
                moved = [not torch.equal(a, b) for a, b in
                         zip(path, path[1:])]
                r.update(gradient_step=state.optimizer.gradient_step,
                         mini_step=state.optimizer.mini_step, moved=moved)
                if moved != [False, True] * (steps // 2) or \
                        state.optimizer.gradient_step != steps // 2:
                    raise AssertionError(f"train_ncsn {name}: moved "
                                         f"{moved}, optimizer steps "
                                         f"{state.optimizer.gradient_step}")
            numbers["runs"][name] = r
            print(f"    {name}: {r['params']} params, batch {batch_size} "
                  f"({2 * batch_size} rows), {state.step} steps: "
                  f"{s_step:.4f} s/step (first {rec['step_s'][0]:.2f} s "
                  f"excluded), {batch_size / s_step:.2f} images/s; peak "
                  f"first step {rec['first_peak']} bytes, steady {peak}; "
                  f"saves {[round(v, 2) for v in rec['save_s']]} s; eval "
                  f"{r['eval_s']:.2f} s over {r['eval_batches']} batches; "
                  f"wall {wall:.2f} s; losses "
                  f"{[round(v, 2) for v in rec['losses']]}" + (
                      f"; filter keeps {r['filter_kept_share']:.4f} of the "
                      f"rows" if kept else "") + (
                      f"; optimizer steps {r['gradient_step']}, moved "
                      f"{r['moved']}" if "moved" in r else ""), flush=True)
            del state
            if name == "acdc_b8_f32":
                ckpt_dir = os.path.join(log_dir, "ACDC_Diffusion_real-imag",
                                        "ckpts")
            else:
                shutil.rmtree(log_dir, ignore_errors=True)
        runs = numbers["runs"]
        numbers["remat_vs_plain"] = dict(
            s_per_step=runs["acdc_b8_bf16_remat"]["s_per_step"]
            / runs["acdc_b8_bf16"]["s_per_step"],
            steady_peak=runs["acdc_b8_bf16_remat"]["steady_peak"]
            / runs["acdc_b8_bf16"]["steady_peak"])

        # learn -> reconstruct: serve what train_ncsn trained
        torch.cuda.empty_cache()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            eng = serve_recon.build_engine(serve_recon.parse_args(
                ["--ds_name", "ACDC", "--ckpt_dir", ckpt_dir, "--R",
                 str(ACDC_R), "--num_sens", str(ACDC_COILS), "--synth_sens",
                 "--chains", str(RECON_CHAINS), "--levels", str(ACDC_LEVELS),
                 "--seed", "0", "--device", device, "--no_warmup"] + over))
        print("    " + text.getvalue().strip(), flush=True)
        saved_step = TRAIN_NCSN_RUNS["acdc_b8_f32"][1]
        if f"restored step {saved_step} from" not in text.getvalue():
            raise AssertionError(f"build_engine printed no restored step "
                                 f"{saved_step}")
        ema, _ = Checkpointer(ckpt_dir, track_best=False).restore_params()
        loaded = eng.model.state_dict()
        if not all(torch.equal(loaded[k].cpu(), v) for k, v in ema.items()):
            raise AssertionError("the engine's weights are not the "
                                 "checkpoint's EMA")
        _, _, _, yr, yi = acdc_problem(cfgs["acdc"], device)
        res = eng.reconstruct(yr[:, 0].cpu().numpy(),
                              yi[:, 0].cpu().numpy(), seed=0)
        size = cfgs["acdc"].data.image_size
        if res.x_re.shape != (RECON_CHAINS, size, size, 1) or not (
                np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError(f"reconstruction from the trained prior: "
                                 f"{res.x_re.shape}, finite "
                                 f"{np.isfinite(res.x_re).all()}")
        numbers["reconstruct"] = dict(
            restored_step=saved_step, chains=RECON_CHAINS,
            levels=ACDC_LEVELS, latency_s=res.latency_s,
            chain_steps_per_s=res.chain_steps_per_s)
        del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    no_kernel_launches(fk, fl, "the train_ncsn phase")
    torch.cuda.empty_cache()

    numbers.update(train_step_checks(cfgs, device, step_cpu))
    return numbers


def train_step_inputs(cfgs: dict) -> dict:
    """train_step_checks' inputs for each net of `cfgs` ("acdc", "cine"):
    the batch, phi, labels and noise, drawn from seed 9, and the ladder."""
    import math
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    gen = torch.Generator().manual_seed(9)
    inputs = {}
    for kind, cfg in cfgs.items():
        if kind == "acdc":
            s = cfg.data.image_size
            batch = torch.rand(1, s, s, cfg.data.channels, generator=gen)
        else:
            batch = torch.rand(8, cfg.data.image_size, cfg.data.channels,
                               generator=gen)
            batch[4:] = 0.5      # background tubes: the filter drops them
        sigmas = get_sigmas(cfg)
        inputs[kind] = dict(batch=batch, sigmas=sigmas, draws=dict(
            phi=(torch.rand(len(batch), generator=gen) * 2 - 1) * math.pi,
            labels=torch.randint(0, len(sigmas), (2 * len(batch),),
                                 generator=gen),
            noise=torch.randn((2 * len(batch),) + batch.shape[1:],
                              generator=gen)))
    return inputs


def train_step_model(cfg, kind: str):
    """The net of train_step_checks' `kind`, weights from seed 0."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        load_model)
    task = "Diffusion" if kind == "acdc" else "Diffusion1D"
    return load_model(cfg, task, seed=0)[0]


def vec(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).cpu() for t in tensors])


def train_step_run(cfg, kind: str, inp: dict, dev, dtype=None,
                   model=None) -> dict:
    """One discrete train step of train_step_checks' net `kind` (`model`,
    made here where None) on `dev` in `dtype` (None: float32; on the card
    in the float32 mode): the loss, the gradients, the parameters and the
    EMA after it."""
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    model = (model or train_step_model(cfg, kind)).to(dev)
    state = TrainState.create(model, get_optimizer(cfg),
                              ema_decay=cfg.model.ema_rate)
    step = make_score_train_step(
        model, inp["sigmas"], data_mode="real-imag",
        anneal_power=cfg.training.anneal_power,
        filter_th=cfg.data.th if kind == "cine" else None,
        compute_dtype=dtype, if_centering=True)
    # the TF32 flags are the card's alone, and process-wide: a CPU step,
    # which may run on a thread of its own, leaves them alone
    mode = contextlib.nullcontext() if str(dev) == "cpu" else float32_exact()
    with mode:
        state, loss = step(state, inp["batch"].to(dev), **{
            k: v.to(dev) for k, v in inp["draws"].items()})
    return dict(loss=float(loss),
                grads=vec(p.grad for p in model.parameters()),
                params=vec(model.parameters()),
                ema=vec(state.ema.params.values()))


def train_step_cpu_start(cfgs: dict) -> tuple:
    """Start train_step_checks' CPU side on a thread of its own
    (Background): returns (the inputs, the Background). The nets are made
    here, on the calling thread: a module's default initialization draws
    from torch's global generator, which the thread leaves alone."""
    inputs = train_step_inputs(cfgs)
    models = {kind: [train_step_model(cfg, kind) for _ in range(2)]
              for kind, cfg in cfgs.items()}
    return inputs, Background(train_step_cpu, cfgs, inputs, models)


def train_step_cpu(cfgs: dict, inputs: dict, models: dict) -> dict:
    """train_step_checks' CPU side: per net, the CPU step (train_step_run,
    on the first of `models`) and the control, the CPU gradient with
    Gaussian noise of rel L2 CONTROL_GRAD_REL (seed 10) stepped by a fresh
    optimizer on the second: the noisy gradient and the parameters after
    it."""
    import math
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer)
    out = {}
    for kind, cfg in cfgs.items():
        cpu = train_step_run(cfg, kind, inputs[kind], "cpu",
                             model=models[kind][0])
        g = cpu["grads"]
        noisy = g + torch.randn(
            g.shape, generator=torch.Generator().manual_seed(10),
            dtype=g.dtype) * (CONTROL_GRAD_REL * g.norm()
                              / math.sqrt(g.numel()))
        model = models[kind][1]
        state = TrainState.create(model, get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        offset = 0
        for p in model.parameters():
            p.grad = noisy[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()
        state.apply_gradients()
        out[kind] = dict(cpu=cpu, noisy=noisy,
                         control=vec(model.parameters()))
        del state, model, models[kind]
    return out


def train_step_checks(cfgs: dict, device="cuda", cpu_ref=None) -> dict:
    """One discrete train step of each net of `cfgs` ("acdc", "cine") from
    the same weights (seed 0), batch, phi, labels and noise
    (train_step_inputs): on the card and on the CPU in float32 mode, and on
    the card in bf16. Gates: card against CPU, the loss, the gradient and
    the Adam update (the parameters and the EMA after the step are
    reported: the start weights dominate both); a control, the CPU
    gradient with Gaussian noise of rel L2 CONTROL_GRAD_REL stepped by a
    fresh optimizer, must read an update above the update's gate; bf16
    against f32 on the card, the loss within BF16_LOSS_REL and the
    gradient at least BF16_GRAD_FLOOR away (the step really ran in bf16).
    `cpu_ref`: train_step_cpu_start's, started earlier so that the CPU side
    runs beside other card work; started and waited for here where None."""
    inputs, worker = cpu_ref or train_step_cpu_start(cfgs)
    card_runs = {}
    for kind, cfg in cfgs.items():
        card_runs[kind] = dict(
            card=train_step_run(cfg, kind, inputs[kind], device),
            card_bf16=train_step_run(cfg, kind, inputs[kind], device,
                                     torch.bfloat16))
        torch.cuda.empty_cache()
    cpu_side = worker.result()
    checks = {}
    for kind, cfg in cfgs.items():
        w0 = train_step_model(cfg, kind).state_dict()
        p0 = torch.cat([v.reshape(-1) for v in w0.values()])
        card, bf16 = card_runs[kind]["card"], card_runs[kind]["card_bf16"]
        cpu, noisy = cpu_side[kind]["cpu"], cpu_side[kind]["noisy"]
        control = cpu_side[kind]["control"]
        c = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
             "grads": rel_l2(card["grads"], cpu["grads"]),
             "update": rel_l2(card["params"] - p0, cpu["params"] - p0),
             "params": rel_l2(card["params"], cpu["params"]),
             "ema": rel_l2(card["ema"], cpu["ema"]),
             "control_grads": rel_l2(noisy, cpu["grads"]),
             "control_update": rel_l2(control - p0, cpu["params"] - p0),
             "bf16_loss": abs(bf16["loss"] - card["loss"])
             / abs(card["loss"]),
             "bf16_grads": rel_l2(bf16["grads"], card["grads"])}
        checks[kind] = c
        failed = {k: c[k] for k, gate in (
            ("loss", TRAIN_LOSS_REL), ("grads", MODEL_REL_L2),
            ("update", UPDATE_REL[kind]), ("bf16_loss", BF16_LOSS_REL))
            if not c[k] <= gate}
        if not c["control_update"] > UPDATE_REL[kind]:
            failed["control_update"] = c["control_update"]
        if not c["bf16_grads"] >= BF16_GRAD_FLOOR:
            failed["bf16_grads"] = c["bf16_grads"]
        if failed:
            raise AssertionError(f"train step {kind}, card vs CPU or bf16 "
                                 f"vs f32: {failed} (all: {c})")
    return {"card_vs_cpu": checks, "cpu_check_s": worker.seconds}


@contextlib.contextmanager
def warnings_quiet():
    """The loaders warn that they use their synthetic stand-ins, as they
    must here; the run's numbers say so."""
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*SYNTHETIC stand-in")
        yield


def fit_run(fk, fl, cfg, model, compute_dtype, batch: int, steps: int,
            log_dir: str, data: np.ndarray) -> dict:
    """training.fit with the continuous step (the leaf's reduce_mean) for
    `steps` steps at `batch`, timed between CUDA synchronizations: losses,
    s/step and images/s after the first step, the steady peak, the EMA of
    conv_in.bias against its formula, whether conv_in.weight moved, the
    checkpoints, and the K1/K2 launches per step."""
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer, FitConfig, TrainState, batch_iterator, fit,
        get_optimizer, make_continuous_score_train_step)
    watch = "conv_in.bias"
    w0 = {k: model.state_dict()[k].detach().double().cpu().clone()
          for k in (watch, "conv_in.weight")}
    state = TrainState.create(model, get_optimizer(cfg),
                              ema_decay=cfg.model.ema_rate)
    step = make_continuous_score_train_step(
        model, make_sde(cfg), reduce_mean=cfg.training.reduce_mean,
        compute_dtype=compute_dtype)
    rec = dict(losses=[], step_s=[], history=[])

    def recorded_step(state, b, generator):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        state, loss = step(state, b, generator)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t_step)
        rec["losses"].append(float(loss))
        rec["history"].append(state.params[watch].detach().double().cpu())
        if len(rec["step_s"]) == 1:
            rec["first_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return state, loss

    model.train()
    torch.cuda.reset_peak_memory_stats()
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    state = fit(state, recorded_step, batch_iterator(data, batch, seed=0),
                FitConfig(n_epochs=1, max_steps=steps, log_every=1, seed=0,
                          log_dir=log_dir))
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)
    decay = cfg.model.ema_rate
    ema = w0[watch]
    for p in rec["history"]:
        ema = decay * ema + (1 - decay) * p
    ema_err = (state.ema.params[watch].double().cpu() - ema).abs().max()
    moved = (state.params["conv_in.weight"].detach().double().cpu()
             - w0["conv_in.weight"]).abs().max().item()
    fwd, bwd = fir_counts(cfg)
    tag = "" if compute_dtype is None else ".bf16"
    expect = {f"{k}{tag}": n * steps for k, n in {**fwd, **bwd}.items()}
    ckpts = Checkpointer(os.path.join(log_dir, "ckpts"),
                         track_best=False).all_steps()
    if not (len(rec["losses"]) == steps and np.isfinite(rec["losses"]).all()):
        raise AssertionError(f"losses {rec['losses']}")
    if state.step != steps or ckpts != [steps] or not moved > 0:
        raise AssertionError(f"step {state.step}, checkpoints {ckpts}, "
                             f"moved {moved}")
    if not ema_err <= 1e-6 * ema.abs().max():
        raise AssertionError(f"EMA of {watch} off its formula by {ema_err}")
    if launches != expect or sum(fl.LAUNCHES.values()):
        raise AssertionError(f"training launched {launches}, expected "
                             f"{expect} (no float32 FIR launch in a bf16 "
                             "step)")
    step_s = float(np.mean(rec["step_s"][1:]))
    return dict(losses=rec["losses"], step_s=step_s,
                first_step_s=rec["step_s"][0], images_per_s=batch / step_s,
                first_peak=rec["first_peak"],
                peak=torch.cuda.max_memory_allocated(), ema_err=float(ema_err),
                launches=launches,
                launches_per_step={k: v / steps for k, v in launches.items()},
                params=sum(p.numel() for p in model.parameters()))


def step_pair(cfg, weights, x, t, z, device, compute_dtype=None, net=None):
    """One continuous step on a fresh copy of `weights` (loaded into `net`,
    made here where None): its loss and its clipped gradients, flattened,
    on the CPU."""
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        create_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_continuous_score_train_step)
    net = net or create_model(cfg)
    net.load_state_dict(weights)
    net.to(device)
    st = TrainState.create(net, get_optimizer(cfg), ema_decay=None)
    stp = make_continuous_score_train_step(
        net, make_sde(cfg), reduce_mean=cfg.training.reduce_mean,
        compute_dtype=compute_dtype)
    _, loss = stp(st, x.to(device), t=t.to(device), z=z.to(device))
    grads = torch.cat([p.grad.reshape(-1).cpu() for p in net.parameters()
                       if p.grad is not None])
    return loss.item(), grads


@contextlib.contextmanager
def fir_backward_scaled(fk, scale: float):
    """The FIR ops' backward (the K3 launches) with its result scaled: a
    broken backward, for a control."""
    saved = fk._Up2x.backward, fk._Down2x.backward

    def scaled(backward):
        def run(ctx, g):
            dx, *rest = backward(ctx, g)
            return (dx * scale, *rest)
        return staticmethod(run)
    fk._Up2x.backward, fk._Down2x.backward = map(scaled, saved)
    try:
        yield
    finally:
        fk._Up2x.backward, fk._Down2x.backward = map(staticmethod, saved)


def train_bf16_phase(fk, fl, device="cuda") -> dict:
    """bf16 continuous training (the JAX package's mixed-precision cast)
    through training.fit on the bf16 FIR kernels: the FFHQ-256 NCSN++ at
    batch 8 in bf16 (the f32 `train` phase's run), and the CIFAR-10 VP
    NCSN++ (vp/cifar10_ncsnpp_continuous at full width) at the leaf's batch
    128 in f32 and bf16; seeded weights and data, TRAIN_STEPS steps each.
    Then one CIFAR-10 VP step at batch 8 card vs CPU in the float32 mode
    (the CPU side on a thread of its own from the phase's start), and
    bf16 vs f32 on the card (dropout 0 for both comparisons), with a
    control: the bf16 step with the FIR backward halved must read beyond
    the gradient's ceiling."""
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        create_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    out = {}
    # the VP step's CPU side runs beside the training runs (its net made
    # here: a module's default initialization draws from torch's global
    # generator, which the thread leaves alone)
    cfg = get_continuous_config(VP_CONFIG).replace(**{"model.dropout": 0.0})
    weights = seeded_weights(create_model(cfg), seed=0).state_dict()
    sde = make_sde(cfg)
    pgen = torch.Generator().manual_seed(3)
    B, size = VP_PARITY_BATCH, cfg.data.image_size
    x = torch.rand(B, size, size, 3, generator=pgen) * 2 - 1
    t = torch.rand(B, generator=pgen) * (sde.T - 1e-5) + 1e-5
    z = torch.randn(B, size, size, 3, generator=pgen)
    step_cpu = Background(step_pair, cfg, weights, x, t, z, "cpu",
                          net=create_model(cfg))
    parity_cfg = cfg
    runs = [("ffhq_bf16", CONFIG, TRAIN_BATCH, torch.bfloat16),
            ("vp_f32", VP_CONFIG, VP_TRAIN_BATCH, None),
            ("vp_bf16", VP_CONFIG, VP_TRAIN_BATCH, torch.bfloat16)]
    for name, leaf, batch, dtype in runs:
        cfg = get_continuous_config(leaf)
        size, ch = cfg.data.image_size, cfg.data.num_channels
        data = np.random.RandomState(0).rand(
            batch * TRAIN_STEPS, size, size, ch).astype(np.float32)
        if cfg.data.centered:
            data = 2 * data - 1
        model = seeded_weights(create_model(cfg), seed=0).to(device)
        log_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            out[name] = fit_run(fk, fl, cfg, model, dtype, batch,
                                TRAIN_STEPS, log_dir, data)
            if name == "vp_bf16":
                out["vp_bf16_ckpt_dir"] = log_dir     # sample_vp reads it
                log_dir = None
        finally:
            if log_dir:
                shutil.rmtree(log_dir, ignore_errors=True)
        r = out[name]
        print(f"    {name}: {leaf}, {r['params']} params, batch {batch}, "
              f"{dtype or 'float32'}: losses "
              f"{[round(v, 3) for v in r['losses']]}; {r['step_s']:.4f} s "
              f"per step (first {r['first_step_s']:.2f} s excluded), "
              f"{r['images_per_s']:.2f} images/s, peak {r['peak']} bytes "
              f"(first step {r['first_peak']}); EMA off by "
              f"{r['ema_err']:.3g}; launches per step "
              f"{r['launches_per_step']}", flush=True)
        del model
        torch.cuda.empty_cache()

    cfg = parity_cfg
    with float32_exact():
        loss_gpu, g_gpu = step_pair(cfg, weights, x, t, z, device)
    # joined before the control halves the FIR backward
    loss_cpu, g_cpu = step_cpu.result()
    loss16, g16 = step_pair(cfg, weights, x, t, z, device, torch.bfloat16)
    loss32, g32 = step_pair(cfg, weights, x, t, z, device)
    with fir_backward_scaled(fk, 0.5):
        _, g_control = step_pair(cfg, weights, x, t, z, device,
                                 torch.bfloat16)
    out["vp_card_vs_cpu"] = dict(
        loss_card=loss_gpu, loss_cpu=loss_cpu,
        loss_rel=abs(loss_gpu - loss_cpu) / abs(loss_cpu),
        grad_rel_l2=rel_l2(g_gpu, g_cpu))
    out["vp_bf16_vs_f32"] = dict(loss_rel=abs(loss16 - loss32) / abs(loss32),
                                 grad_rel_l2=rel_l2(g16, g32),
                                 control_grad_rel_l2=rel_l2(g_control, g32))
    c, b = out["vp_card_vs_cpu"], out["vp_bf16_vs_f32"]
    if not (c["loss_rel"] <= MODEL_REL_L2 and c["grad_rel_l2"] <= MODEL_REL_L2):
        raise AssertionError(f"VP train step card vs CPU: {c}")
    if not (b["loss_rel"] <= BF16_LOSS_REL
            and BF16_GRAD_FLOOR <= b["grad_rel_l2"] <= VP_BF16_GRAD_CEIL
            and b["control_grad_rel_l2"] > VP_BF16_GRAD_CEIL):
        raise AssertionError(f"VP bf16 step vs f32: {b} (the loss within "
                             f"{BF16_LOSS_REL}, the gradient {BF16_GRAD_FLOOR}"
                             f" to {VP_BF16_GRAD_CEIL} away, the control "
                             f"farther)")
    return out


@contextlib.contextmanager
def timed_sampler(pc_sampling, seconds: list):
    """pc_sampling.main with its sampler timed alone: each call of the
    sampling function get_sampling_fn returns appends its seconds, between
    CUDA synchronizations, to `seconds`."""
    get = pc_sampling.get_sampling_fn

    def timed_get(*args, **kwargs):
        sampling_fn = get(*args, **kwargs)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            out = sampling_fn(*a, **k)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_run)
            return out
        return timed
    pc_sampling.get_sampling_fn = timed_get
    try:
        yield
    finally:
        pc_sampling.get_sampling_fn = get


def sample_vp_phase(fk, fl, ckpt_dir: str, device="cuda") -> dict:
    """scripts.pc_sampling.main at full width, seeded weights, VP_SAMPLES
    samples, num_scales cut to VP_NUM_SCALES, for each of VP_SAMPLE_LEAVES
    (each leaf's own predictor and corrector): finite samples, the printed
    nfe, the network evaluations (the first forward, then each step's
    corrector steps and predictor) and K1/K2 launches per evaluation, and
    the sampler's evaluations/s (its loop alone; the set-up, from the
    config to the first forward, is reported apart). Then --ckpt_dir on
    the bf16 CIFAR-10 VP run's checkpoint (VP_CKPT_NUM_SCALES), and a tiny
    VP PC run card vs CPU, same noise, float32 mode."""
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        create_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        pc_sampling)
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
        get_pc_sampler, get_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    out = {}
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_vp_")
    try:
        runs = [(leaf, VP_NUM_SCALES, None) for leaf in VP_SAMPLE_LEAVES]
        runs.append((VP_CONFIG, VP_CKPT_NUM_SCALES, ckpt_dir))
        for leaf, N, ckpt in runs:
            cfg = get_continuous_config(leaf)
            s = cfg.sampling
            evals = 1 + N * ((s.n_steps_each if s.corrector != "none" else 0)
                             + (s.predictor != "none"))
            argv = ["--config", leaf, "--num_samples", str(VP_SAMPLES),
                    "--seed", "0", "--override", f"model.num_scales={N}",
                    "--save_dir", save_dir]
            if ckpt:
                argv += ["--ckpt_dir", os.path.join(ckpt, "ckpts")]
            if device != "cuda":
                argv += ["--device", str(device)]
            torch.cuda.reset_peak_memory_stats()
            fk.LAUNCHES.clear()
            fl.LAUNCHES.clear()
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            sampler_s = []
            with timed_sampler(pc_sampling, sampler_s):
                samples, nfe, text = run_pc_sampling(pc_sampling, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            if len(sampler_s) != 1:
                raise AssertionError(f"{leaf}: {len(sampler_s)} sampler "
                                     "runs")
            loop_evals = evals - 1      # the first forward is set-up
            launches = dict(fk.LAUNCHES)
            fwd, _ = fir_counts(cfg)
            expect = {k: n * evals for k, n in fwd.items()}
            size, ch = cfg.data.image_size, cfg.data.num_channels
            if samples.shape != (VP_SAMPLES, size, size, ch) or \
                    not np.isfinite(samples).all():
                raise AssertionError(f"{leaf}: samples {samples.shape}, "
                                     f"finite {np.isfinite(samples).all()}")
            if nfe != N * (s.n_steps_each + 1):
                raise AssertionError(f"{leaf}: nfe {nfe}")
            if launches != expect or sum(fl.LAUNCHES.values()):
                raise AssertionError(f"{leaf}: launched {launches}, expected "
                                     f"{expect}")
            if ckpt and "restored step" not in text:
                raise AssertionError("pc_sampling restored no checkpoint")
            key = f"{leaf} (ckpt)" if ckpt else leaf
            out[key] = dict(num_scales=N, reduced_from=cfg.model.num_scales,
                            predictor=s.predictor, corrector=s.corrector,
                            nfe=nfe, evals=evals, wall_s=wall,
                            sampler_s=sampler_s[0],
                            setup_s=wall - sampler_s[0],
                            evals_per_s=loop_evals / sampler_s[0],
                            peak=torch.cuda.max_memory_allocated(),
                            launches_per_eval={k: v / evals for k, v in
                                               launches.items()})
            print(f"    {key}: {s.predictor} + {s.corrector}, num_scales "
                  f"{N} (reduced from {cfg.model.num_scales}), "
                  f"{VP_SAMPLES} samples: nfe {nfe} (printed), {evals} "
                  f"evaluations, sampler {sampler_s[0]:.2f} s "
                  f"({loop_evals / sampler_s[0]:.2f} evals/s), set-up "
                  f"{wall - sampler_s[0]:.2f} s, peak "
                  f"{out[key]['peak']} bytes, K1/K2 per evaluation "
                  f"{out[key]['launches_per_eval']}", flush=True)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    tiny = get_continuous_config(VP_CONFIG).replace(**{
        "data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2, 2),
        "model.num_res_blocks": 1, "model.attn_resolutions": (8,),
        "model.num_scales": 5})
    sde = make_sde(tiny)
    finals = []
    for dev in (device, "cpu"):
        net = seeded_weights(create_model(tiny), seed=1).to(dev).eval()
        noise_gen = torch.Generator().manual_seed(2)
        s = tiny.sampling
        sampler = get_pc_sampler(sde, (BATCH, 16, 16, 3),
                                 predictor=s.predictor, corrector=s.corrector,
                                 snr=s.snr, device=dev)
        with torch.no_grad(), float32_exact():
            x, _ = sampler(get_score_fn(sde, net), noise=lambda sh: (
                torch.randn(tuple(sh), generator=noise_gen).to(dev)))
        finals.append(x.cpu())
    out["tiny_card_vs_cpu_rel_l2"] = rel_l2(finals[0], finals[1])
    if not out["tiny_card_vs_cpu_rel_l2"] <= MODEL_REL_L2:
        raise AssertionError(f"tiny VP PC run, card vs CPU: rel L2 "
                             f"{out['tiny_card_vs_cpu_rel_l2']}")
    return out


def report_train_ncsn(tn: dict, t: float) -> None:
    runs = tn["runs"]
    rec = tn["reconstruct"]
    say("train_ncsn", t, f"scripts.train_ncsn on the synthetic stand-ins, "
        f"torch defaults (TF32): ACDC NCSNv2Deepest "
        f"({runs['acdc_b8_f32']['params']} params) s/step | images/s: batch "
        f"3 f32 {runs['acdc_b3_f32']['s_per_step']:.4f} | "
        f"{runs['acdc_b3_f32']['images_per_s']:.2f}, batch 8 f32 "
        f"{runs['acdc_b8_f32']['s_per_step']:.4f} | "
        f"{runs['acdc_b8_f32']['images_per_s']:.2f}, bf16 "
        f"{runs['acdc_b8_bf16']['s_per_step']:.4f} | "
        f"{runs['acdc_b8_bf16']['images_per_s']:.2f}, bf16 remat "
        f"{runs['acdc_b8_bf16_remat']['s_per_step']:.4f} | "
        f"{runs['acdc_b8_bf16_remat']['images_per_s']:.2f} (remat/plain: "
        f"time {tn['remat_vs_plain']['s_per_step']:.3f}, steady peak "
        f"{tn['remat_vs_plain']['steady_peak']:.3f}); grad_accum 2 "
        f"{runs['acdc_b3_accum2']['steps']} micro-steps, "
        f"{runs['acdc_b3_accum2']['gradient_step']} optimizer steps; "
        f"CINE127_1D NCSN1D ({runs['cine_f32']['params']} params) batch "
        f"{runs['cine_f32']['batch']} f32 "
        f"{runs['cine_f32']['s_per_step']:.4f} s/step, bf16 "
        f"{runs['cine_bf16']['s_per_step']:.4f}, filter keeps "
        f"{runs['cine_f32']['filter_kept_share']:.4f}; serve_recon "
        f"--ckpt_dir: restored step {rec['restored_step']}, one request "
        f"({rec['chains']} chains, {rec['levels']} levels) "
        f"{rec['latency_s']:.3f} s, finite; card vs CPU (float32 mode) "
        f"{json.dumps(tn['card_vs_cpu'])} (loss <= {TRAIN_LOSS_REL}, "
        f"grads <= {MODEL_REL_L2}, update <= {json.dumps(UPDATE_REL)} < "
        f"the control's update (gradient noise {CONTROL_GRAD_REL}); bf16 "
        f"vs f32: loss <= {BF16_LOSS_REL}, grads >= {BF16_GRAD_FLOOR}; the "
        f"CPU side {tn['cpu_check_s']:.1f} s); no K1/K2/K4 launch")


def timed_cli(module, argv: list, owner=None,
              name: str = "ald_inverse_seg_proximal_real_imag",
              metrics: bool = True) -> dict:
    """`module.main(argv)` (one of the reconstruction scripts) with its
    output echoed indented: the reconstructions, the wall seconds, the
    seconds of its one call of `owner.name` alone (the sampler or
    optimizer, between CUDA synchronizations; the config, data, operator
    and net set-up apart) with that call's arguments and output, the peak
    memory and the NRMSE / SSIM it prints (`metrics`; a prior sampler
    prints none). `owner` is the module whose global `name` main calls
    (default `module`)."""
    owner = owner or module
    sampler = getattr(owner, name)
    seconds, calls = [], []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        out = sampler(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t_run)
        calls.append((args, kwargs, out))
        return out

    save_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = io.StringIO()
    setattr(owner, name, timed)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        with contextlib.redirect_stdout(out), warnings_quiet():
            recons = module.main(argv + ["--save_dir", save_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        artifacts = sorted(os.listdir(os.path.join(
            save_dir, os.listdir(save_dir)[0])))
    finally:
        setattr(owner, name, sampler)
        shutil.rmtree(save_dir, ignore_errors=True)
    for line in out.getvalue().splitlines():
        print(f"    {line}", flush=True)
    found = re.search(r"NRMSE (\S+)\s+SSIM (\S+)", out.getvalue())
    if (metrics and found is None) or len(seconds) != 1:
        raise AssertionError(f"{module.__name__}: no NRMSE / SSIM printed "
                             f"or {len(seconds)} calls of {name}")
    return dict(recons=recons, wall_s=wall, sampler_s=seconds[0],
                call=calls[0], peak=torch.cuda.max_memory_allocated(),
                nrmse=float(found.group(1)) if found else None,
                ssim=float(found.group(2)) if found else None,
                artifacts=artifacts)


def sense_phase(fk, fl, device="cuda") -> dict:
    """The README's headline CLI and the complex64 reconstruction path:
    scripts.acdc_SENSE_real_img.main at full width (the ACDC
    NCSNv2Deepest, 256 px, ngf 128, weights from seed 0; SENSE_SAMPLES
    chains, R = 8, 4 coils, CG 8, lr_scaled 5.0, the ladder cut to
    SENSE_LEVELS levels; its chains in pair form, the CG on the normal
    kernel) with torch's defaults, then the single-coil script with
    SingleCoil (the complex sampler) and the SENSE script guided (seg UNet
    from seed 0), at SENSE_SIDE_SAMPLES chains, each timed around its
    sampler call; the cuFFT pair against the pair DFT at 256
    px; the complex sampler against the pair reconstructor on
    acdc_problem's geometry (its ladder cut to SENSE_CHECK_LEVELS), same
    weights, CG iterations and noise, float32 mode, level by level; the
    complex sampler card vs CPU at 32 px (ngf 8,
    2 levels); SENSE's adjointness on the card. Launches no K1, K2 or K4."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest, make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        L2Penalty, RandomUndersamplingFourier, SENSE, make_sense)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops.fft import (
        i2k_complex, k2i_complex)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops.fft_pair import (
        i2k_pair, k2i_pair)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig, ald_inverse_seg_proximal_real_imag)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_SENSE_real_img as sense_script,
        acdc_inv_seg_sampling_keep_center_prox_real_imag as single_script)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg, model = acdc_model()
    size = cfg.data.image_size
    numbers = {}
    common = ["--override", f"recons.num_classes={SENSE_LEVELS}", "--seed",
              "0", "--device", str(device)]
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    runs = {
        "sense": (sense_script, SENSE_SAMPLES, [
            "--R", str(ACDC_R), "--num_sens", str(ACDC_COILS),
            "--lr_scaled", str(ACDC_LR_SCALED)]),
        "single_coil": (single_script, SENSE_SIDE_SAMPLES, [
            "--R", str(ACDC_R), "--proximal", "SingleCoil"]),
        "sense_guided": (sense_script, SENSE_SIDE_SAMPLES, [
            "--R", str(ACDC_R), "--num_sens", str(ACDC_COILS),
            "--lr_scaled", str(ACDC_LR_SCALED), "--seg_start_time", "0.5"]),
    }
    for name, (module, chains, flags) in runs.items():
        # the SENSE CLI's chains run in pair form (its `reconstruct`), the
        # single-coil CLI's through the complex sampler
        r = timed_cli(module, flags + common + ["--num_samples", str(chains)],
                      name=("reconstruct" if module is sense_script else
                            "ald_inverse_seg_proximal_real_imag"))
        recons = r.pop("recons")
        del r["call"]
        if not (isinstance(recons, np.ndarray)
                and recons.dtype == np.complex64
                and recons.shape == (chains, size, size, 1)
                and np.isfinite(recons).all()
                and np.isfinite([r["nrmse"], r["ssim"]]).all()):
            raise AssertionError(f"{name}: reconstructions "
                                 f"{getattr(recons, 'shape', None)} "
                                 f"{getattr(recons, 'dtype', None)}, NRMSE "
                                 f"{r['nrmse']}, SSIM {r['ssim']}")
        r["chain_steps"] = chain_steps = SENSE_LEVELS * 3 * chains
        r["chain_steps_per_s"] = chain_steps / r["sampler_s"]
        numbers[name] = r
    no_kernel_launches(fk, fl, "the complex reconstruction scripts")

    # cuFFT against the pair DFT at the net's size, the chains' batch
    gen = torch.Generator().manual_seed(0)
    xr, xi = (torch.randn(ACDC_CHAINS, size, size, 1, generator=gen)
              .to(device) for _ in range(2))
    with torch.inference_mode(), float32_exact():
        k = i2k_complex(torch.complex(xr, xi))
        kr, ki = i2k_pair(xr, xi)
        b = k2i_complex(k)
        br, bi = k2i_pair(k.real.contiguous(), k.imag.contiguous())
    numbers["fft_vs_pair_dft_rel_l2"] = fft_rel = max(
        rel_l2(torch.view_as_real(k), torch.stack([kr, ki], -1)),
        rel_l2(torch.view_as_real(b), torch.stack([br, bi], -1)))
    if not fft_rel <= FFT_REL_L2:
        raise AssertionError(f"cuFFT vs the pair DFT: rel L2 {fft_rel}")

    # The complex sampler against the pair reconstructor, level by level
    model = model.to(device)
    lin_pair, prox_pair, sigmas, yr, yi = acdc_problem(
        cfg, device, levels=SENSE_CHECK_LEVELS)
    sense = SENSE(base=RandomUndersamplingFourier(mask=lin_pair.mask),
                  sens_maps=torch.complex(lin_pair.sens_re, lin_pair.sens_im))
    prox = L2Penalty(lin_tfm=sense, num_iters=ACDC_CG_ITERS)
    snap_cfg = ALDConfig(n_steps_each=cfg.sampling.n_steps_each,
                         step_lr=cfg.sampling.step_lr, snapshot_every=1)
    levels = {"complex": [], "pair": []}

    def keep(form):
        return lambda c, sigma, a, b: levels[form].append(
            torch.complex(a, b).cpu())

    with float32_exact():
        x_complex = ald_inverse_seg_proximal_real_imag(
            make_score_fn(model, sigmas), sigmas, torch.complex(yr, yi),
            sense, prox, config=snap_cfg, lr_scaled=ACDC_LR_SCALED,
            snapshot_fn=keep("complex"), noise=gaussian_noise(0, device),
            device=device).cpu()
        x_pair = torch.complex(*make_stepped_pair_reconstructor(
            model, sigmas, lin_pair, prox_pair, snap_cfg,
            lr_scaled=ACDC_LR_SCALED, snapshot_fn=keep("pair"),
            device=device)(yr, yi, noise=gaussian_noise(0, device))).cpu()
    by_level = [rel_l2(torch.view_as_real(a), torch.view_as_real(b))
                for a, b in zip(levels["complex"], levels["pair"])]
    numbers["complex_vs_pair_rel_l2"] = dict(
        by_level=by_level, final=rel_l2(torch.view_as_real(x_complex),
                                        torch.view_as_real(x_pair)))
    if len(by_level) != SENSE_CHECK_LEVELS or not (
            by_level[SENSE_GATE_LEVEL] <= MODEL_REL_L2):
        raise AssertionError(f"complex vs pair form: rel L2 by level "
                             f"{by_level}")
    del model, levels

    # One proximal step of each form on the chains' state, torch's
    # defaults: the CLI's CG 8 on cuFFT against recon's CG 4 on the normal
    # kernel (A^H y baked in, as the pair reconstructor does)
    alpha = cfg.sampling.step_lr * ACDC_LR_SCALED
    z, y_c = torch.complex(xr, xi), torch.complex(yr, yi)
    ahy = lin_pair.conj_op(yr, yi)
    baked = prox_pair.replace(ahy_re=ahy[0], ahy_im=ahy[1])
    with torch.inference_mode():
        numbers["prox_ms"] = dict(
            complex_cg8=cuda_ms(lambda: L2Penalty(lin_tfm=sense)(
                z, y_c, alpha, 1.0), reps=10),
            complex_cg4=cuda_ms(lambda: prox(z, y_c, alpha, 1.0), reps=10),
            pair_cg4=cuda_ms(lambda: baked(xr, xi, yr, yi, alpha, 1.0),
                             reps=10))

    # The complex sampler card vs CPU at 32 px, same weights and noise
    tiny = load_config("ACDC", "real-imag",
                       **{"data.image_size": 32, "model.ngf": 8})
    net_cpu = seeded_weights(NCSNv2Deepest(tiny), seed=0).eval()
    tiny_sigmas = sigma_ladder(tiny.model.sigma_begin, tiny.model.sigma_end,
                               2, "geometric")
    op = make_sense("exp", ACDC_COILS, ACDC_R, 1 / 16, (32, 32, 1), seed=0,
                    num_frames=1)
    x_true = torch.complex(*(torch.rand(2, 32, 32, 1, generator=gen)
                             for _ in range(2)))
    y_tiny = op(x_true)
    draws = [torch.randn(2, 32, 32, 1, generator=gen) for _ in range(12)]
    tiny_cfg = ALDConfig(n_steps_each=3, step_lr=tiny.sampling.step_lr)
    finals = []
    with float32_exact():
        for dev in (device, "cpu"):
            net = copy.deepcopy(net_cpu).to(dev)
            it = iter(draws)
            finals.append(ald_inverse_seg_proximal_real_imag(
                make_score_fn(net, tiny_sigmas), tiny_sigmas, y_tiny, op,
                L2Penalty(lin_tfm=op), config=tiny_cfg,
                lr_scaled=ACDC_LR_SCALED,
                noise=lambda shape: next(it).to(dev), device=dev).cpu())
    numbers["tiny_card_vs_cpu_rel_l2"] = tiny_rel = rel_l2(
        *(torch.view_as_real(f) for f in finals))
    if not tiny_rel <= MODEL_REL_L2:
        raise AssertionError(f"complex sampler card vs CPU: rel L2 "
                             f"{tiny_rel}")

    # SENSE's adjointness on the card, on the mask's support
    sense_op = make_sense("exp", ACDC_COILS, ACDC_R, 1 / 16, (size, size, 1),
                          seed=0, num_frames=1).to(device)
    x = torch.complex(xr[:1], xi[:1])
    y = sense_op.base.mask * torch.complex(
        *(torch.randn(ACDC_COILS, 1, size, size, 1, generator=gen)
          .to(device) for _ in range(2)))
    with torch.inference_mode():
        lhs = torch.sum(sense_op(x).conj().cdouble() * y.cdouble()).item()
        rhs = torch.sum(x.conj().cdouble()
                        * sense_op.conj_op(y).cdouble()).item()
    numbers["adjoint_rel"] = adj = abs(lhs - rhs) / abs(lhs)
    if not adj <= ADJOINT_REL:
        raise AssertionError(f"SENSE adjointness on the card: {adj}")
    no_kernel_launches(fk, fl, "the complex reconstruction path")
    return numbers


def report_sense(sn: dict, t: float, recon_f32: float) -> None:
    for name in ("sense", "single_coil", "sense_guided"):
        r = sn[name]
        print(f"    {name}: wall {r['wall_s']:.2f} s, sampler "
              f"{r['sampler_s']:.4f} s for {r['chain_steps']} chain-steps, "
              f"{r['chain_steps_per_s']:.2f} chain-steps/s, peak {r['peak']} "
              f"bytes, NRMSE {r['nrmse']} SSIM {r['ssim']} (random weights: "
              f"only checked finite), artifacts {r['artifacts']}",
              flush=True)
    cp = sn["complex_vs_pair_rel_l2"]
    say("sense", t, f"acdc_SENSE_real_img.main at full width (NCSNv2Deepest "
        f"256 px, ngf 128, seed 0), {SENSE_SAMPLES} chains, R = {ACDC_R}, "
        f"{ACDC_COILS} coils, pair form, CG 8 on the normal kernel, "
        f"lr_scaled {ACDC_LR_SCALED}, "
        f"recons.num_classes={SENSE_LEVELS} (the 348 -> 0.01 ladder cut from "
        f"2311 levels to {SENSE_LEVELS}) x 3 steps, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}: "
        f"{sn['sense']['chain_steps_per_s']:.2f} chain-steps/s "
        f"({sn['sense']['chain_steps_per_s'] / recon_f32:.3f} x recon's f32 "
        f"{recon_f32:.2f}); single-coil SingleCoil "
        f"{sn['single_coil']['chain_steps_per_s']:.2f} and guided "
        f"{sn['sense_guided']['chain_steps_per_s']:.2f} at "
        f"{SENSE_SIDE_SAMPLES} chains; cuFFT vs pair DFT rel L2 "
        f"{sn['fft_vs_pair_dft_rel_l2']:.3g} (<= {FFT_REL_L2}); complex vs "
        f"pair form (float32 mode) rel L2 after level {SENSE_GATE_LEVEL} "
        f"{cp['by_level'][SENSE_GATE_LEVEL]:.3g} (<= {MODEL_REL_L2}), by "
        f"level {json.dumps([float(f'{v:.3g}') for v in cp['by_level']])}, "
        f"final {cp['final']:.3g}; one proximal step, device ms "
        f"{json.dumps({k: round(v, 4) for k, v in sn['prox_ms'].items()})}; "
        f"tiny complex sampler card vs CPU rel L2 "
        f"{sn['tiny_card_vs_cpu_rel_l2']:.3g} (<= {MODEL_REL_L2}); SENSE "
        f"adjointness {sn['adjoint_rel']:.3g} (<= {ADJOINT_REL}); no "
        f"K1/K2/K4 launch")


def map_parting(a: torch.Tensor, b: torch.Tensor, lr: float) -> dict:
    """Two iterates (complex or (re, im) stacked last): rel L2, the share
    of elements more than lr apart and more than 5 lr apart."""
    a, b = (torch.view_as_real(v) if v.is_complex() else v for v in (a, b))
    d = (a.double() - b.double()).abs()
    return dict(rel_l2=rel_l2(a, b), share_lr=float((d > lr).double().mean()),
                share_5lr=float((d > 5 * lr).double().mean()))


def map_within(p: dict) -> bool:
    return p["rel_l2"] <= MAP_LONG_REL and p["share_5lr"] <= MAP_LONG_FAR_SHARE


@contextlib.contextmanager
def first_ascent(point, into: dict, form: str):
    """Inside the block map_optimizer, map_optimizer_pair and
    tv_reconstruction(_pair) evaluate their ascent direction once at
    `point` (an (re, im) pair) into into[form] instead of running Adam."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
        map_opt, map_pair)

    def run(ascent, x0, config):
        into[form] = torch.stack(ascent(*point))
        return x0

    saved = map_opt._run_adam, map_pair._run_adam
    map_opt._run_adam = map_pair._run_adam = run
    try:
        yield
    finally:
        map_opt._run_adam, map_pair._run_adam = saved


def map_tv_phase(fk, fl, device="cuda") -> dict:
    """The MAP and TV baselines at the ACDC geometry (NCSNv2Deepest 256 px,
    ngf 128, weights from seed 0; the ACDC loader's synthetic test slice
    and phase), torch's defaults: acdc_SENSE_MAP.main (4 coils, R = 8,
    lamda 0.1, the config's 200 Adam iterations), acdc_MAP.main and
    acdc_MAP_keep_center.main at MAP_SIDE_ITERS iterations, and
    acdc_SENSE_TV.main (4 coils, R = 8, 200 iterations; gate: its TV
    objective below the one at A^H y): iterations/s of the optimizer alone,
    wall s, peak memory, NRMSE / SSIM (finite). A MAP iteration split by
    CUDA events into the net forward at batch 2, the data gradient (SENSE
    forward and adjoint on cuFFT), the Adam update and the rest; launches
    and the device's idle share under the profiler. In the float32 mode:
    the first ascent directions of map_optimizer, map_optimizer_pair and
    the stepped pair optimizer at one point, the three after 200
    iterations against the bounds and a doubled-lamda control; the same
    for tv_reconstruction and its pair form; a tiny MAP direction card vs
    CPU. Launches no K1, K2 or K4."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest, make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        make_sense)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairSENSE)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
        map_opt, map_pair)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas, sigma_ladder)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_MAP, acdc_MAP_keep_center, acdc_SENSE_MAP, acdc_SENSE_TV)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg, model = acdc_model()
    size = cfg.data.image_size
    n_iters = cfg.MAP.n_iters
    numbers = {}
    common = ["--seed", "0", "--device", str(device)]
    coils = ["--R", str(ACDC_R), "--num_sens", str(ACDC_COILS)]
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    runs = {
        "sense_map": (acdc_SENSE_MAP, acdc_MAP, "map_optimizer", coils + [
            "--lamda", str(MAP_LAMDA)], n_iters),
        "map": (acdc_MAP, acdc_MAP, "map_optimizer", [
            "--n_iters", str(MAP_SIDE_ITERS)], MAP_SIDE_ITERS),
        "map_keep_center": (acdc_MAP_keep_center, acdc_MAP, "map_optimizer",
                            ["--R", str(ACDC_R), "--n_iters",
                             str(MAP_SIDE_ITERS)], MAP_SIDE_ITERS),
        "sense_tv": (acdc_SENSE_TV, acdc_SENSE_TV, "tv_reconstruction",
                     coils, n_iters),
    }
    for name, (module, owner, fn, flags, iters) in runs.items():
        r = timed_cli(module, flags + common, owner, fn)
        recons = r.pop("recons")
        (args, kwargs, out) = r.pop("call")
        if not (isinstance(recons, np.ndarray)
                and recons.dtype == np.complex64
                and recons.shape == (1, size, size, 1)
                and np.isfinite(recons).all()
                and np.isfinite([r["nrmse"], r["ssim"]]).all()):
            raise AssertionError(f"{name}: reconstruction "
                                 f"{getattr(recons, 'shape', None)}, NRMSE "
                                 f"{r['nrmse']}, SSIM {r['ssim']}")
        r["iters"] = iters
        r["iters_per_s"] = iters / r["sampler_s"]
        if name == "sense_tv":
            y, op, weight = args[:3]
            with torch.no_grad():
                objective = lambda x: float(
                    0.5 * torch.sum(torch.abs(op(x) - y) ** 2)
                    + weight * map_opt.tv_norm_noncircular(x, (1, 2)))
                r["objective"] = dict(start=objective(op.conj_op(y)),
                                      end=objective(out))
            if not r["objective"]["end"] < r["objective"]["start"]:
                raise AssertionError(f"TV objective {r['objective']}")
        numbers[name] = r
        del args, kwargs, out
    no_kernel_launches(fk, fl, "the MAP and TV scripts")

    # One MAP iteration of the SENSE problem split by CUDA events, torch's
    # defaults, as acdc_SENSE_MAP runs it (map_optimizer's ascent and
    # _run_adam's step, written out)
    model = model.to(device)
    sigmas = get_sigmas(cfg, "recons")
    score = make_score_fn(model, sigmas)
    op = make_sense("exp", ACDC_COILS, ACDC_R, 1 / 16, (size, size, 1),
                    seed=0, num_frames=1).to(device)
    gen = torch.Generator().manual_seed(0)
    mag = torch.rand(1, size, size, 1, generator=gen)
    phase = torch.randn(1, size, size, 1, generator=gen)
    x_true = torch.polar(mag, phase).to(device)
    with torch.no_grad():
        y = op(x_true)
        x0 = op.conj_op(y)
    map_cfg = map_opt.MAPConfig(n_iters=n_iters, lr=cfg.MAP.lr)
    timer = PhaseTimer()
    net = timer.wrap("net_forward", lambda xr, xi: map_opt._score_pair(
        score, xr, xi, 1))
    data = timer.wrap("data_gradient", lambda xr, xi: op.log_lh_grad(
        torch.complex(xr, xi), y, 1.0))
    adam = timer.wrap("adam_update", map_opt.adam_step)

    def iteration(params, state):
        g = data(*params)
        s_re, s_im = net(*params)
        return adam(params, (-(g.real + MAP_LAMDA * s_re),
                             -(g.imag + MAP_LAMDA * s_im)), state, map_cfg)

    timed_iteration = timer.wrap("iteration", iteration)

    def iterations(n, params, state):
        for _ in range(n):
            params, state = timed_iteration(params, state)
        return params, state

    with torch.inference_mode():
        params, state = iteration((x0.real, x0.imag),
                                  map_opt.adam_init((x0.real, x0.imag)))
        timer.events.clear()
        params, state = iterations(MAP_SPLIT_ITERS, params, state)
        split = {k: v / MAP_SPLIT_ITERS for k, v in timer.ms().items()}
        split["rest"] = split["iteration"] - sum(
            split[k] for k in ("net_forward", "data_gradient",
                               "adam_update"))
        prof = profile_calls(lambda: iterations(MAP_SPLIT_ITERS, params,
                                                state), MAP_SPLIT_ITERS)
    numbers["iteration"] = dict(split_ms=split, **prof)
    no_kernel_launches(fk, fl, "the MAP iteration")

    # Float32 mode: the three MAP forms and the two TV forms on this
    # problem, first at one point, then after the config's 200 iterations.
    # The forms' data terms A^H (y - A x) differ by the rounding of A x
    # (cuFFT against the pair DFT, a few 1e-7 of |y|), which reaches the
    # direction scaled by kappa = |y| / |direction|; near A^H y the
    # residual cancels A x against y and kappa is 25 to 50. So the
    # directions are gated at MAP_DIR_REL_L2 from a zero start (x_init = 0,
    # kappa about 1), and at MAP_DIR_REL_L2 * kappa at A^H y (the runs'
    # start) and at a start 10 % of A^H y's rms off it; the stepped form
    # runs the pair form's operations and is gated at MAP_DIR_REL_L2
    # everywhere.
    pair_op = PairSENSE(mask=op.base.mask,
                        sens_re=op.sens_maps.real.contiguous(),
                        sens_im=op.sens_maps.imag.contiguous())
    y_pair = (y.real.contiguous(), y.imag.contiguous())
    start = (x0.real.contiguous(), x0.imag.contiguous())
    rms = torch.view_as_real(x0).pow(2).mean().sqrt()
    off = tuple(v + 0.1 * rms * torch.randn(v.shape, generator=gen).to(device)
                for v in start)
    zero = tuple(torch.zeros_like(v) for v in start)
    stepped = map_pair.make_stepped_map_pair_optimizer(
        model, sigmas, pair_op, map_cfg, device=device)
    forms = {
        "complex": lambda w: torch.view_as_real(map_opt.map_optimizer(
            score, y, op, w, map_cfg, device=device)),
        "pair": lambda w: torch.stack(map_pair.map_optimizer_pair(
            score, y_pair, pair_op, w, map_cfg, device=device), -1),
        "stepped": lambda w: torch.stack(stepped(model, *y_pair, w), -1),
        "tv_complex": lambda w: torch.view_as_real(
            map_opt.tv_reconstruction(y, op, w, map_cfg, device=device)),
        "tv_pair": lambda w: torch.stack(map_pair.tv_reconstruction_pair(
            y_pair, pair_op, w, map_cfg, device=device), -1),
    }
    tv_weight = 1e-3                    # acdc_SENSE_TV's --reg_weight
    first = {}
    with float32_exact():
        for where, point in (("zero_start", zero), ("off_start", off),
                             ("at_ahy", start)):
            dirs = {}
            for form in ("complex", "pair", "tv_complex", "tv_pair"):
                with first_ascent(point, dirs, form):
                    forms[form](tv_weight if form.startswith("tv") else
                                MAP_LAMDA)
            saved = map_pair.adam_step
            map_pair.adam_step = lambda p, g, s, c: (
                dirs.__setitem__("stepped", -torch.stack(g)), (p, s))[1]
            try:
                with torch.inference_mode():
                    _, state0 = stepped.start(*y_pair)
                    stepped.step(stepped.score_fn(model), point, state0,
                                 *y_pair, torch.tensor(MAP_LAMDA,
                                                       device=device))
            finally:
                map_pair.adam_step = saved
            y_norm = torch.view_as_real(y).norm()
            first[where] = dict(
                complex_vs_pair=rel_l2(dirs["complex"], dirs["pair"]),
                stepped_vs_pair=rel_l2(dirs["stepped"], dirs["pair"]),
                tv_complex_vs_pair=rel_l2(dirs["tv_complex"],
                                          dirs["tv_pair"]),
                kappa=float(y_norm / dirs["pair"].norm()),
                tv_kappa=float(y_norm / dirs["tv_pair"].norm()))
    numbers["first_ascent_rel_l2"] = first
    def held(where, scaled):
        f = first[where]
        k, k_tv = (f["kappa"], f["tv_kappa"]) if scaled else (1.0, 1.0)
        return (f["complex_vs_pair"] <= MAP_DIR_REL_L2 * k
                and f["tv_complex_vs_pair"] <= MAP_DIR_REL_L2 * k_tv
                and f["stepped_vs_pair"] <= MAP_DIR_REL_L2)

    if not (held("zero_start", False) and held("off_start", True)
            and held("at_ahy", True)):
        raise AssertionError(f"first ascent directions {first}")
    with float32_exact():
        ends = {form: run(tv_weight if form.startswith("tv") else MAP_LAMDA)
                for form, run in forms.items()}
        ends["control"] = forms["pair"](2 * MAP_LAMDA)
        ends["tv_control"] = forms["tv_pair"](2 * tv_weight)
    lr = map_cfg.lr
    numbers["after_200"] = long = {
        "complex_vs_pair": map_parting(ends["complex"], ends["pair"], lr),
        "stepped_vs_pair": map_parting(ends["stepped"], ends["pair"], lr),
        "control_vs_pair": map_parting(ends["control"], ends["pair"], lr),
        "tv_complex_vs_pair": map_parting(ends["tv_complex"],
                                          ends["tv_pair"], lr),
        "tv_control_vs_pair": map_parting(ends["tv_control"],
                                          ends["tv_pair"], lr)}
    passed = {k: map_within(v) for k, v in long.items()}
    if not all(ok != ("control" in k) for k, ok in passed.items()):
        raise AssertionError(f"after {n_iters} iterations: {long}")
    del ends, stepped, model
    no_kernel_launches(fk, fl, "the MAP and TV forms")

    # A tiny MAP direction card vs CPU at 32 px (ngf 8), float32 mode
    tiny = load_config("ACDC", "real-imag",
                       **{"data.image_size": 32, "model.ngf": 8})
    net_cpu = seeded_weights(NCSNv2Deepest(tiny), seed=0).eval()
    tiny_sigmas = sigma_ladder(tiny.recons.sigma_begin, tiny.recons.sigma_end,
                               4, "geometric")
    tiny_op = make_sense("exp", ACDC_COILS, ACDC_R, 1 / 16, (32, 32, 1),
                         seed=0, num_frames=1)
    tiny_y = tiny_op(torch.polar(torch.rand(1, 32, 32, 1, generator=gen),
                                 torch.randn(1, 32, 32, 1, generator=gen)))
    tiny_point = tuple(torch.rand(2, 1, 32, 32, 1, generator=gen))
    tiny_dirs = {}
    with float32_exact():
        for dev in (device, "cpu"):
            with first_ascent(tuple(v.to(dev) for v in tiny_point),
                              tiny_dirs, str(dev)):
                map_opt.map_optimizer(
                    make_score_fn(copy.deepcopy(net_cpu).to(dev),
                                  tiny_sigmas), tiny_y, tiny_op, MAP_LAMDA,
                    device=dev)
    numbers["tiny_card_vs_cpu_rel_l2"] = tiny_rel = rel_l2(
        tiny_dirs[str(device)].cpu(), tiny_dirs["cpu"])
    if not tiny_rel <= MAP_DIR_REL_L2:
        raise AssertionError(f"tiny MAP direction card vs CPU: {tiny_rel}")
    return numbers


def report_map_tv(mt: dict, t: float) -> None:
    for name in ("sense_map", "map", "map_keep_center", "sense_tv"):
        r = mt[name]
        print(f"    {name}: wall {r['wall_s']:.2f} s, optimizer "
              f"{r['sampler_s']:.4f} s for {r['iters']} iterations, "
              f"{r['iters_per_s']:.2f} iterations/s, peak {r['peak']} bytes, "
              f"NRMSE {r['nrmse']} SSIM {r['ssim']} (random weights: only "
              f"checked finite), artifacts {r['artifacts']}", flush=True)
    it = mt["iteration"]
    split = ", ".join(f"{k} {v:.3f}" for k, v in it["split_ms"].items())
    print(f"    one MAP iteration (4-coil SENSE, the net at batch 2): device "
          f"ms by part: {split}; profiled over {MAP_SPLIT_ITERS} iterations: "
          f"wall {it['profiled_wall_ms']:.2f} ms, kernels "
          f"{it['profiled_device_ms']:.2f} ms, idle share "
          f"{it['idle_share']:.4f}, launches per iteration "
          f"{it['launches_per_unit']:.1f}", flush=True)
    for label, rows in (("kernel", it["top_kernels"]),
                        ("op", it["top_ops"])):
        for key, calls, ms in rows:
            print(f"    top {label}: {ms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    say("map_tv", t, f"acdc_SENSE_MAP.main at full width (NCSNv2Deepest 256 "
        f"px, ngf 128, seed 0), {ACDC_COILS} coils, R = {ACDC_R}, lamda "
        f"{MAP_LAMDA}, {mt['sense_map']['iters']} Adam iterations: "
        f"{mt['sense_map']['iters_per_s']:.2f} iterations/s; acdc_MAP "
        f"{mt['map']['iters_per_s']:.2f} and acdc_MAP_keep_center "
        f"{mt['map_keep_center']['iters_per_s']:.2f} at {MAP_SIDE_ITERS} "
        f"iterations (of 200); acdc_SENSE_TV "
        f"{mt['sense_tv']['iters_per_s']:.2f} iterations/s, TV objective "
        f"{json.dumps(mt['sense_tv']['objective'])} (end < start); an "
        f"iteration {mt['iteration']['split_ms']['iteration']:.2f} ms, idle "
        f"share {mt['iteration']['idle_share']:.4f}; float32 mode: "
        f"first ascent rel L2 {json.dumps(mt['first_ascent_rel_l2'])} (from "
        f"zero <= {MAP_DIR_REL_L2}; at and off A^H y <= {MAP_DIR_REL_L2} x "
        f"kappa; the stepped form <= {MAP_DIR_REL_L2}); after 200 iterations "
        f"{json.dumps(mt['after_200'])} (forms within rel L2 <= "
        f"{MAP_LONG_REL} and share > 5 lr <= {MAP_LONG_FAR_SHARE}, the "
        f"doubled-weight controls outside); tiny direction card vs CPU "
        f"{mt['tiny_card_vs_cpu_rel_l2']:.3g} (<= {MAP_DIR_REL_L2}); no "
        f"K1/K2/K4 launch")


def cine_complex_phase(fk, fl, device="cuda") -> dict:
    """The complex 2D+time cine CLIs at the cine phase's geometry (CINE127
    128 px, T = 24, 4 coils, per-frame R = 8; CINE127 NCSNv2Deepest and
    CINE127_1D NCSN1D, ngf 128 each, weights from seed 0), torch's
    defaults: cine_SENSE_real_img_2d_time.main (4 chains, diffusion1d,
    lr_scaled 5.0, L2Penalty CG 8, the recons ladder cut to CINE_LEVELS of
    1000 levels): chain-steps/s of ald_2d_time alone, wall s, peak memory,
    NRMSE / SSIM (finite), and the pair reconstructor
    (Stepped2DTimePairReconstructor, the same score functions, pair SENSE,
    CG 8 on the normal kernel) on the same problem and seed for the ratio.
    In the float32 mode, on CINE_F32_CHAINS chain: the complex form
    against the pair form level by level, gated after CINE_COMPLEX_GATES.
    The modes tv, none and tv-only at CINE_MODE_LEVELS levels: finite.
    cine_SENSE_real_img_2d_time_MAP.main (1 chain, diffusion1d,
    CINE_MAP_ITERS iterations): iterations/s, peak. The single-frame
    cine_inv_sampling_keep_center_prox_real_imag.main (4 chains,
    CINE_LEVELS levels): chain-steps/s. Launches no K1, K2 or K4."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig, ald_2d_time)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        Stepped2DTimePairReconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        cine_SENSE_real_img_2d_time as cine_script,
        cine_SENSE_real_img_2d_time_MAP as cine_map_script,
        cine_inv_sampling_keep_center_prox_real_imag as frame_script)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    T, chains = CINE_FRAMES, CINE_COMPLEX_CHAINS
    size = load_config("CINE127", "real-imag").data.image_size
    common = ["--seed", "0", "--device", str(device)]
    levels = ["--override", f"recons.num_classes={CINE_LEVELS}"]
    numbers = {}
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    r = timed_cli(cine_script, common + levels + [
        "--num_samples", str(chains), "--mode_T", "diffusion1d",
        "--lr_scaled", "5.0", "--proximal_type", "L2Penalty", "--R", "8",
        "--num_sens", "4", "--num_frames", str(T), "--image_size",
        str(size), "--win_size", str(CINE_WIN)], name="ald_2d_time")
    recons = r.pop("recons")
    args, kwargs, _ = r.pop("call")
    if not (recons.dtype == np.complex64
            and recons.shape == (chains, T, size, size, 1)
            and np.isfinite(recons).all()
            and np.isfinite([r["nrmse"], r["ssim"]]).all()):
        raise AssertionError(f"cine CLI: {recons.shape} {recons.dtype}, "
                             f"NRMSE {r['nrmse']}, SSIM {r['ssim']}")
    n_steps = kwargs["config"].n_steps_each
    r["chain_steps"] = CINE_LEVELS * n_steps * chains
    r["chain_steps_per_s"] = r["chain_steps"] / r["sampler_s"]
    numbers["cli"] = r
    del recons

    # The pair reconstructor on the CLI's problem, the same score
    # functions, seed and CG iterations (CG on the normal kernel)
    score_S, score_T, sigmas_S, sigmas_T, y, op, prox = args
    maps = op.sens_maps

    def pair_problem(n_chains):
        pop = PairSENSE(mask=op.base.mask[:n_chains * T],
                        sens_re=maps.real.contiguous(),
                        sens_im=maps.imag.contiguous())
        yb = y[:, :n_chains * T]
        return (pop, PairL2Penalty.with_normal_kernel(
            pop, num_iters=prox.num_iters), yb.real.contiguous(),
            yb.imag.contiguous())

    pop, pprox, yr, yi = pair_problem(chains)
    common_kw = dict(lr_scaled=kwargs["lr_scaled"], mode_T="diffusion1d",
                     lamda_T=kwargs["lamda_T"], win_size=CINE_WIN,
                     num_frames=T, device=device)
    pair_recon = Stepped2DTimePairReconstructor(
        score_S, score_T, sigmas_S, sigmas_T, pop, pprox, kwargs["config"],
        **common_kw)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    out = pair_recon(yr, yi, seed=0)
    torch.cuda.synchronize()
    numbers["pair_chain_steps_per_s"] = r["chain_steps"] / (
        time.perf_counter() - t_run)
    numbers["complex_over_pair"] = (r["chain_steps_per_s"]
                                    / numbers["pair_chain_steps_per_s"])
    if not all(torch.isfinite(v).all() for v in out):
        raise AssertionError("cine pair reconstructor: not finite")
    del out, pair_recon

    # Float32 mode: complex vs pair form level by level on one chain
    snap = ALDConfig(n_steps_each=n_steps, step_lr=kwargs["config"].step_lr,
                     snapshot_every=1)
    by_form = {"complex": [], "pair": []}
    keep = lambda form: lambda c, sigma, a, b: by_form[form].append(
        torch.stack([a, b], -1).cpu())
    pop1, pprox1, yr1, yi1 = pair_problem(CINE_F32_CHAINS)
    op1 = op.replace(base=op.base.replace(
        mask=op.base.mask[:CINE_F32_CHAINS * T]))
    with float32_exact():
        ald_2d_time(score_S, score_T, sigmas_S, sigmas_T,
                    y[:, :CINE_F32_CHAINS * T], op1,
                    prox.replace(lin_tfm=op1), config=snap,
                    snapshot_fn=keep("complex"),
                    noise=gaussian_noise(0, device), **common_kw)
        Stepped2DTimePairReconstructor(
            score_S, score_T, sigmas_S, sigmas_T, pop1, pprox1, snap,
            snapshot_fn=keep("pair"), **common_kw)(
            yr1, yi1, noise=gaussian_noise(0, device))
    by_level = [rel_l2(a, b) for a, b in zip(by_form["complex"],
                                             by_form["pair"])]
    numbers["complex_vs_pair_rel_l2"] = by_level
    if len(by_level) != CINE_LEVELS or not all(
            by_level[c] <= MODEL_REL_L2 for c in CINE_COMPLEX_GATES):
        raise AssertionError(f"cine complex vs pair by level {by_level}")
    del by_form

    # The other temporal modes, 2 levels each, 4 chains
    short = ALDConfig(n_steps_each=n_steps, step_lr=kwargs["config"].step_lr)
    cut = lambda s: sigma_ladder(float(s[0]), float(s[-1]), CINE_MODE_LEVELS,
                                 "geometric")
    numbers["modes_finite"] = {}
    for mode in ("tv", "none", "tv-only"):
        x = ald_2d_time(score_S, None, cut(sigmas_S), cut(sigmas_T), y, op,
                        prox, seed=0, config=short,
                        **dict(common_kw, mode_T=mode))
        numbers["modes_finite"][mode] = ok = bool(
            torch.isfinite(torch.view_as_real(x)).all())
        if not (ok and tuple(x.shape) == (chains, T, size, size, 1)):
            raise AssertionError(f"mode_T {mode}: {tuple(x.shape)}, {ok}")
    del args, score_S, score_T, prox, op, y, x

    # The cine MAP CLI and the single-frame CLI
    r = timed_cli(cine_map_script, common + [
        "--num_samples", "1", "--mode_T", "diffusion1d", "--n_iters",
        str(CINE_MAP_ITERS), "--num_frames", str(T), "--image_size",
        str(size), "--win_size", str(CINE_WIN)],
        name="map_optimizer_2d_time")
    recons = r.pop("recons")
    del r["call"]
    if not (recons.shape == (1, T, size, size, 1)
            and np.isfinite(recons).all()):
        raise AssertionError(f"cine MAP CLI: {recons.shape}")
    r["iters"] = CINE_MAP_ITERS
    r["iters_per_s"] = CINE_MAP_ITERS / r["sampler_s"]
    numbers["map_cli"] = r
    r = timed_cli(frame_script, common + levels + [
        "--num_samples", str(chains), "--R", "8"])
    recons = r.pop("recons")
    del r["call"]
    if not (recons.shape == (chains, size, size, 1)
            and np.isfinite(recons).all()):
        raise AssertionError(f"single-frame cine CLI: {recons.shape}")
    r["chain_steps"] = CINE_LEVELS * n_steps * chains
    r["chain_steps_per_s"] = r["chain_steps"] / r["sampler_s"]
    numbers["frame_cli"] = r
    no_kernel_launches(fk, fl, "the complex cine CLIs")
    return numbers


def report_cine_complex(cc: dict, t: float) -> None:
    for name, unit in (("cli", "chain-steps"), ("map_cli", "iterations"),
                       ("frame_cli", "chain-steps")):
        r = cc[name]
        n = r.get("chain_steps", r.get("iters"))
        rate = r.get("chain_steps_per_s", r.get("iters_per_s"))
        print(f"    {name}: wall {r['wall_s']:.2f} s, timed call "
              f"{r['sampler_s']:.4f} s for {n} {unit}, {rate:.2f} {unit}/s, "
              f"peak {r['peak']} bytes, NRMSE {r['nrmse']} SSIM {r['ssim']} "
              f"(random weights: only checked finite), artifacts "
              f"{r['artifacts']}", flush=True)
    say("cine_complex", t, f"cine_SENSE_real_img_2d_time.main (CINE127 128 "
        f"px NCSNv2Deepest + CINE127_1D NCSN1D, ngf 128, seed 0; "
        f"{CINE_FRAMES} frames, 4 coils, R = 8, {CINE_COMPLEX_CHAINS} chains, "
        f"diffusion1d, CG 8; recons.num_classes={CINE_LEVELS} of 1000): "
        f"{cc['cli']['chain_steps_per_s']:.2f} chain-steps/s, "
        f"{cc['complex_over_pair']:.3f} x the pair reconstructor's "
        f"{cc['pair_chain_steps_per_s']:.2f} on the same problem; float32 "
        f"mode, {CINE_F32_CHAINS} chain, complex vs pair by level "
        + json.dumps([float(f"{v:.3g}") for v in
                      cc["complex_vs_pair_rel_l2"]])
        + f" (levels {list(CINE_COMPLEX_GATES)} <= {MODEL_REL_L2}); modes "
        f"finite at {CINE_MODE_LEVELS} levels "
        f"{json.dumps(cc['modes_finite'])}; cine MAP CLI (1 chain, "
        f"{CINE_MAP_ITERS} of 200 iterations) "
        f"{cc['map_cli']['iters_per_s']:.2f} iterations/s, peak "
        f"{cc['map_cli']['peak']} bytes; single-frame CLI "
        f"{cc['frame_cli']['chain_steps_per_s']:.2f} chain-steps/s at "
        f"{CINE_COMPLEX_CHAINS} chains; no K1/K2/K4 launch")


def conv_flop(model: torch.nn.Module, run) -> float:
    """FLOP of the convolutions `run()` makes `model` compute (2 per
    multiply-add), counted by forward hooks from the shapes: out.numel()
    I prod(k) for a convolution, in.numel() O prod(k) for a transposed
    one. Norms, activations, pools and resizes are left out."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        layers, ncsn3d)
    total = [0.0]

    def conv(module, inputs, out):
        total[0] += 2.0 * out.numel() * module.weight[0].numel()

    def conv_t(module, inputs, out):
        total[0] += 2.0 * inputs[0].numel() * module.weight[0].numel()

    hooks = [m.register_forward_hook(
        conv_t if isinstance(m, layers.ConvTranspose) else conv)
        for m in model.modules() if isinstance(
            m, (layers.Conv, layers.ConvTranspose, ncsn3d.TemporalDownConv))]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def step_card_vs_cpu(cfg, task: str, batch: torch.Tensor, data_mode: str,
                     gen: torch.Generator, device="cuda") -> dict:
    """One discrete train step of the task's net (weights from seed 0) on
    the card and on the CPU in the float32 mode, the same batch and
    injected draws (phi where real-imag, labels, noise): the loss and the
    gradient's rel L2, gated at TRAIN_LOSS_REL and MODEL_REL_L2, and the
    CPU's seconds."""
    import math
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        load_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    model, _ = load_model(cfg, task, seed=0)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sigmas = get_sigmas(cfg)
    rows = 2 * len(batch) if data_mode == "real-imag" else len(batch)
    draws = dict(labels=torch.randint(0, len(sigmas), (rows,), generator=gen),
                 noise=torch.randn((rows,) + batch.shape[1:], generator=gen))
    if data_mode == "real-imag":
        draws["phi"] = (torch.rand(len(batch), generator=gen) * 2 - 1
                        ) * math.pi
    out, cpu_s = {}, 0.0
    for dev in (device, "cpu"):
        model.load_state_dict(w0)
        model.to(dev)
        state = TrainState.create(model, get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        step = make_score_train_step(model, sigmas, data_mode=data_mode,
                                     anneal_power=cfg.training.anneal_power,
                                     if_centering=True)
        t_dev = time.perf_counter()
        with float32_exact():
            state, loss = step(state, batch.to(dev), **{
                k: v.to(dev) for k, v in draws.items()})
        if dev == "cpu":
            cpu_s = time.perf_counter() - t_dev
        out[dev] = (float(loss), torch.cat([p.grad.detach().reshape(-1).cpu()
                                            for p in model.parameters()]))
        del state, step
    (card_loss, card_g), (cpu_loss, cpu_g) = out[device], out["cpu"]
    c = dict(loss=abs(card_loss - cpu_loss) / abs(cpu_loss),
             grads=rel_l2(card_g, cpu_g), cpu_s=cpu_s)
    if not (c["loss"] <= TRAIN_LOSS_REL and c["grads"] <= MODEL_REL_L2):
        raise AssertionError(f"{task} train step card vs CPU: {c}")
    del model
    torch.cuda.empty_cache()
    return c


def forward_card_vs_cpu(model, x: torch.Tensor, sigmas: torch.Tensor,
                        device="cuda") -> float:
    """rel L2 of the model's output on the card against the CPU, float32
    mode, the same weights and input; the model comes back on the card."""
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    with torch.inference_mode(), float32_exact():
        card = model.to(device)(x.to(device), sigmas.to(device)).cpu()
        cpu = model.cpu()(x, sigmas)
    model.to(device)
    return rel_l2(card, cpu)


def event_timed(score, into: list):
    """`score` with each call timed by a pair of CUDA events appended to
    `into`."""
    def timed(x, labels):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = score(x, labels)
        end.record()
        into.append((start, end))
        return out

    return timed


def quickstart_3d_phase(fk, fl, device="cuda") -> dict:
    """The README quick start's pair and the 3-D temporal prior at full
    width, weights from seed 0, torch's defaults unless said:
    unconditioned_sampling.main --ds_name MNIST (NCSNv2Deepest at 32 px,
    ngf 128; QS_SAMPLES chains over the 50 -> 0.01 ladder cut from 232 to
    QS_MNIST_LEVELS levels x 5 steps, and the denoise): the sampler's
    network evaluations/s (the
    set-up apart), wall s, peak, finite (8, 32, 32, 1) samples.
    train_ncsn.main --ds_name MNIST (the synthetic digits, the config's
    batch 128, QS_TRAIN_STEPS steps): s/step, images/s, peak; one step at
    batch 1 card vs CPU in the float32 mode. NCSN3DShallow (CINE127_1D:
    ngf 128, 8 x 8 tubes of 24 frames) card vs CPU at batch 2 on tubes and
    on volumes, NCSN3D on volumes (float32 mode); the NCSN3DShallow
    forward at the cine CLI's tube batch through make_tube_score_fn_3d:
    device ms, host ms, peak, the convolutions' FLOP and rate, the top
    kernels of a profile. train_ncsn.main --task_name Diffusion3D (the
    config's batch 90, QS_3D_TRAIN_STEPS steps): s/step, peak; one step at
    batch 1 card vs CPU. unconditioned_sampling.main --task_name
    Diffusion3D and Diffusion1D on CINE127_1D, QS_SAMPLES chains, the
    400-level ladder cut to QS_3D_LEVELS. cine_SENSE_real_img_2d_time.main
    --task_name_T Diffusion3D at the cine_complex geometry (QS_CHAINS
    chains, QS_CINE_LEVELS of 1000 levels, CG 8 on cuFFT): chain-steps/s of
    the sampler alone, the ratio to the same call with Diffusion1D, the
    nets' device ms by CUDA events around every score call; the _MAP CLI
    with
    Diffusion3D at 1 chain for QS_MAP_ITERS iterations. UNET1D at its own
    width card vs CPU at batch 2 (float32 mode) and one forward at the tube
    batch. Launches none of K1, K2 or K4."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import (
        UNET1D)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn3d import (
        NCSN3D)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        cine_SENSE_real_img_2d_time as cine_script,
        cine_SENSE_real_img_2d_time_MAP as cine_map_script, train_ncsn,
        unconditioned_sampling as uncond)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    numbers = {}
    gen = torch.Generator().manual_seed(11)
    cfg_m = load_config("MNIST")
    cfg_t = load_config("CINE127_1D", "real-imag")
    common = ["--seed", "0", "--device", str(device)]
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()

    # The quick start: sample, then train
    r = timed_cli(uncond, common + ["--ds_name", "MNIST", "--num_samples",
                                    str(QS_SAMPLES), "--override",
                                    f"model.num_classes={QS_MNIST_LEVELS}"],
                  name="ald_unconditional_sampler", metrics=False)
    samples = r.pop("recons")
    del r["call"]
    s = cfg_m.data.image_size
    if not (samples.shape == (QS_SAMPLES, s, s, 1)
            and np.isfinite(samples).all()):
        raise AssertionError(f"MNIST samples: {samples.shape}")
    r["evals"] = (QS_MNIST_LEVELS * cfg_m.sampling.n_steps_each
                  + int(cfg_m.sampling.denoise))
    r["evals_per_s"] = r["evals"] / r["sampler_s"]
    numbers["mnist_sample"] = r

    root = tempfile.mkdtemp(prefix="chip_smoke_quickstart_")
    try:
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        for name, flags, steps, batch_size in (
                ("mnist_train", ["--ds_name", "MNIST"], QS_TRAIN_STEPS,
                 cfg_m.training.batch_size),
                ("train_3d", ["--ds_name", "CINE127_1D", "--task_name",
                              "Diffusion3D", "--mode", "real-imag",
                              "--flatten_type", "temporal"],
                 QS_3D_TRAIN_STEPS, cfg_t.training.batch_size)):
            rec = {}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            with timed_fit(train_ncsn, rec, "end_conv.bias"), \
                    warnings_quiet():
                state = train_ncsn.main(flags + [
                    "--device", device, "--log_dir", os.path.join(root, name),
                    "--data_root", data_root, "--override",
                    f"training.n_iters={steps}"])
            torch.cuda.synchronize()
            s_step = float(np.mean(rec["step_s"][1:]))
            numbers[name] = dict(
                net=type(state.model).__name__, batch=batch_size,
                steps=state.step, s_per_step=s_step,
                images_per_s=batch_size / s_step,
                first_step_s=rec["step_s"][0],
                first_step_peak=rec["first_peak"],
                steady_peak=torch.cuda.max_memory_allocated(),
                wall_s=time.perf_counter() - t_run, losses=rec["losses"],
                params=sum(p.numel() for p in state.model.parameters()))
            if not (state.step == steps and np.isfinite(rec["losses"]).all()):
                raise AssertionError(f"{name}: step {state.step}, losses "
                                     f"{rec['losses']}")
            del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers["mnist_step_card_vs_cpu"] = step_card_vs_cpu(
        cfg_m, "Diffusion", torch.rand(1, s, s, 1, generator=gen),
        "real-valued", gen, device)
    win, T = 8, cfg_t.data.image_size
    numbers["step_3d_card_vs_cpu"] = step_card_vs_cpu(
        cfg_t, "Diffusion3D", torch.rand(1, win, win, T, 1, generator=gen),
        "real-imag", gen, device)

    # NCSN3DShallow and NCSN3D alone
    sig = torch.tensor([40.0, 0.05])
    net, _ = registry.load_model(cfg_t, "Diffusion3D", seed=0)
    net = net.eval()
    checks = {
        "shallow_tubes": forward_card_vs_cpu(
            net, torch.rand(2, win * win, T, generator=gen), sig, device),
        "shallow_volumes": forward_card_vs_cpu(
            net, torch.rand(2, 1, win, win, T, generator=gen), sig, device)}
    deep = seeded_weights(NCSN3D(cfg_t), 0).eval()
    checks["ncsn3d_volumes"] = forward_card_vs_cpu(
        deep, torch.rand(2, 1, win, win, T, generator=gen), sig, device)
    del deep
    numbers["nets_card_vs_cpu"] = checks
    if not all(v <= MODEL_REL_L2 for v in checks.values()):
        raise AssertionError(f"3-D nets card vs CPU: {checks}")
    size = load_config("CINE127").data.image_size
    tubes_b = 2 * QS_CHAINS * (size // win) ** 2     # Re and Im of the tubes
    score = registry.make_tube_score_fn_3d(net, get_sigmas(cfg_t, "recons"),
                                           win)
    x = torch.rand(tubes_b, T, win * win, device=device)
    labels = torch.full((tubes_b,), 5, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        run = lambda: score(x, labels)
        flop = conv_flop(net, run)
        ms, host = cuda_ms(run, reps=2, host=True, warmup=1)
        prof = profile_calls(run, 1)
    numbers["forward_3d"] = dict(
        batch=tubes_b, device_ms=ms, host_ms=host,
        peak=torch.cuda.max_memory_allocated(), conv_tflop=flop / 1e12,
        conv_tflop_per_s=flop / ms / 1e9, **prof)
    # UNET1D at its own width
    unet = seeded_weights(UNET1D(cfg_t), 0).eval()
    u = forward_card_vs_cpu(unet, torch.rand(2, win * win, T, generator=gen),
                            sig, device)
    uscore = registry.make_score_fn(unet, get_sigmas(cfg_t, "recons"))
    with torch.inference_mode():
        run = lambda: uscore(x, labels)
        uflop = conv_flop(unet, run)
        ums = cuda_ms(run, reps=3)
    numbers["unet1d"] = dict(card_vs_cpu=u, batch=tubes_b, device_ms=ums,
                             conv_tflop=uflop / 1e12,
                             params=sum(p.numel() for p in unet.parameters()))
    if not u <= MODEL_REL_L2:
        raise AssertionError(f"UNET1D card vs CPU {u}")
    del net, unet, score, uscore, x
    torch.cuda.empty_cache()

    # Prior sampling from the temporal priors, the ladder cut
    for task, shape in (("Diffusion3D", (QS_SAMPLES, win, win, T, 1)),
                        ("Diffusion1D", (QS_SAMPLES, T, win * win))):
        r = timed_cli(uncond, common + [
            "--ds_name", "CINE127_1D", "--task_name", task, "--mode",
            "real-imag", "--num_samples", str(QS_SAMPLES), "--override",
            f"model.num_classes={QS_3D_LEVELS}"],
            name="ald_unconditional_sampler", metrics=False)
        out = r.pop("recons")
        del r["call"]
        if not (out.shape == shape and np.isfinite(out).all()):
            raise AssertionError(f"{task} samples: {out.shape}")
        r["evals"] = QS_3D_LEVELS * cfg_t.sampling.n_steps_each + 1
        r["evals_per_s"] = r["evals"] / r["sampler_s"]
        numbers[f"sample_{task}"] = r

    # The cine CLIs with the 3-D temporal prior, and with NCSN1D
    cli = common + ["--override", f"recons.num_classes={QS_CINE_LEVELS}",
                    "--num_samples", str(QS_CHAINS), "--mode_T",
                    "diffusion1d", "--lr_scaled", "5.0", "--proximal_type",
                    "L2Penalty", "--R", "8", "--num_sens", "4",
                    "--num_frames", str(T), "--image_size", str(size),
                    "--win_size", str(win)]
    for task in ("Diffusion3D", "Diffusion1D"):
        events = {"spatial": [], "temporal": []}
        sampler = cine_script.ald_2d_time

        def split(score_S, score_T, *rest, **kwargs):
            return sampler(event_timed(score_S, events["spatial"]),
                           event_timed(score_T, events["temporal"]), *rest,
                           **kwargs)

        cine_script.ald_2d_time = split
        try:
            r = timed_cli(cine_script, cli + ["--task_name_T", task],
                          name="ald_2d_time")
        finally:
            cine_script.ald_2d_time = sampler
        recons = r.pop("recons")
        args, kwargs, _ = r.pop("call")
        if not (recons.shape == (QS_CHAINS, T, size, size, 1)
                and np.isfinite(recons).all()):
            raise AssertionError(f"cine CLI {task}: {recons.shape}")
        n_steps = kwargs["config"].n_steps_each
        r["chain_steps"] = QS_CINE_LEVELS * n_steps * QS_CHAINS
        r["chain_steps_per_s"] = r["chain_steps"] / r["sampler_s"]
        sampler_ms = 1e3 * r["sampler_s"]
        for part, pairs in events.items():
            ms = [a.elapsed_time(b) for a, b in pairs]
            r[f"{part}_net_calls"] = len(ms)
            r[f"{part}_net_ms"] = float(np.sum(ms))
            r[f"{part}_net_share"] = float(np.sum(ms)) / sampler_ms
        r["temporal_levels"] = r["temporal_net_calls"] // n_steps
        # a level step with a temporal step: its ms, the temporal net's part
        r["level_ms"] = sampler_ms / QS_CINE_LEVELS
        r["temporal_net_ms_per_level"] = (
            r["temporal_net_ms"] / max(r["temporal_levels"], 1))
        numbers[f"cine_{task}"] = r
        del args, kwargs, recons
    numbers["cine_3d_over_1d"] = (
        numbers["cine_Diffusion3D"]["chain_steps_per_s"]
        / numbers["cine_Diffusion1D"]["chain_steps_per_s"])
    r = timed_cli(cine_map_script, common + [
        "--num_samples", "1", "--mode_T", "diffusion1d", "--task_name_T",
        "Diffusion3D", "--n_iters", str(QS_MAP_ITERS), "--num_frames",
        str(T), "--image_size", str(size), "--win_size", str(win)],
        name="map_optimizer_2d_time")
    recons = r.pop("recons")
    del r["call"]
    if not (recons.shape == (1, T, size, size, 1)
            and np.isfinite(recons).all()):
        raise AssertionError(f"cine MAP CLI Diffusion3D: {recons.shape}")
    r["iters_per_s"] = QS_MAP_ITERS / r["sampler_s"]
    numbers["cine_map_3d"] = r
    no_kernel_launches(fk, fl, "the quickstart_3d phase")
    torch.cuda.empty_cache()
    return numbers


def report_quickstart_3d(qs: dict, t: float) -> None:
    ms, tr, tr3 = qs["mnist_sample"], qs["mnist_train"], qs["train_3d"]
    f3, u1 = qs["forward_3d"], qs["unet1d"]
    print(f"    MNIST sampling: {ms['evals']} evaluations at batch "
          f"{QS_SAMPLES}, {ms['evals_per_s']:.2f} evaluations/s (sampler "
          f"{ms['sampler_s']:.4f} s), wall {ms['wall_s']:.2f} s, peak "
          f"{ms['peak']} bytes, artifacts {ms['artifacts']}", flush=True)
    for name, r in (("MNIST train_ncsn", tr), ("Diffusion3D train_ncsn", tr3)):
        print(f"    {name}: {r['net']} ({r['params']} params), batch "
              f"{r['batch']}, {r['steps']} steps: {r['s_per_step']:.4f} "
              f"s/step (first {r['first_step_s']:.2f} s excluded), "
              f"{r['images_per_s']:.2f} images/s; peak first step "
              f"{r['first_step_peak']} bytes, steady {r['steady_peak']}; "
              f"wall {r['wall_s']:.2f} s; losses "
              f"{[round(v, 2) for v in r['losses']]}", flush=True)
    print(f"    NCSN3DShallow forward at batch {f3['batch']} tubes (torch "
          f"defaults): {f3['device_ms']:.2f} device ms, {f3['host_ms']:.2f} "
          f"host ms, peak {f3['peak']} bytes, convolutions "
          f"{f3['conv_tflop']:.2f} TFLOP, {f3['conv_tflop_per_s']:.1f} "
          f"TFLOP/s; profiled: kernels {f3['profiled_device_ms']:.2f} ms "
          f"(NCDHW <-> NDHWC conversions {f3['layout_ms']:.2f}), idle share "
          f"{f3['idle_share']:.4f}, launches {f3['launches_per_unit']:.0f}",
          flush=True)
    for label, rows in (("kernel", f3["top_kernels"]),
                        ("op", f3["top_ops"])):
        for key, calls, kms in rows:
            print(f"    top {label}: {kms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    print(f"    UNET1D ({u1['params']} params) forward at batch "
          f"{u1['batch']}: {u1['device_ms']:.2f} device ms, "
          f"{u1['conv_tflop']:.3f} TFLOP", flush=True)
    for task in ("Diffusion3D", "Diffusion1D"):
        r, c = qs[f"sample_{task}"], qs[f"cine_{task}"]
        print(f"    {task}: prior sampling {r['evals']} evaluations, "
              f"{r['evals_per_s']:.2f}/s, peak {r['peak']} bytes; cine CLI "
              f"{c['chain_steps_per_s']:.2f} chain-steps/s (sampler "
              f"{c['sampler_s']:.2f} s), a level {c['level_ms']:.1f} ms, by "
              f"CUDA events spatial net {c['spatial_net_ms']:.1f} ms "
              f"({c['spatial_net_share']:.3f}), temporal net "
              f"{c['temporal_net_ms']:.1f} ms ({c['temporal_net_share']:.3f}; "
              f"{c['temporal_net_ms_per_level']:.1f} ms a level with a "
              f"temporal step, {c['temporal_levels']} such levels), peak "
              f"{c['peak']} bytes", flush=True)
    say("quickstart_3d", t, f"unconditioned_sampling --ds_name MNIST "
        f"(NCSNv2Deepest 32 px, ngf 128, seed 0; {QS_SAMPLES} samples, "
        f"{QS_MNIST_LEVELS} of 232 levels x 5 steps): "
        f"{ms['evals_per_s']:.2f} evaluations/s; "
        f"train_ncsn MNIST batch {tr['batch']} {tr['s_per_step']:.4f} s/step "
        f"({tr['images_per_s']:.2f} images/s); Diffusion3D (NCSN3DShallow, "
        f"ngf 128, 8x8 tubes of 24 frames) batch {tr3['batch']} "
        f"{tr3['s_per_step']:.4f} s/step, peak {tr3['steady_peak']} bytes; "
        f"steps card vs CPU (float32 mode) MNIST "
        f"{json.dumps(qs['mnist_step_card_vs_cpu'])}, 3-D "
        f"{json.dumps(qs['step_3d_card_vs_cpu'])}; nets card vs CPU "
        f"{json.dumps(qs['nets_card_vs_cpu'])}, UNET1D "
        f"{u1['card_vs_cpu']:.3g} (<= {MODEL_REL_L2}); 3-D forward at "
        f"{f3['batch']} tubes {f3['device_ms']:.2f} ms; cine CLI "
        f"(diffusion1d, {QS_CHAINS} chains, {QS_CINE_LEVELS} of 1000 "
        f"levels) "
        f"with Diffusion3D {qs['cine_Diffusion3D']['chain_steps_per_s']:.2f} "
        f"chain-steps/s, {qs['cine_3d_over_1d']:.3f} x Diffusion1D's "
        f"{qs['cine_Diffusion1D']['chain_steps_per_s']:.2f}; the 3-D "
        f"temporal net {qs['cine_Diffusion3D']['temporal_net_share']:.3f} of "
        f"the sampler's time; cine MAP CLI Diffusion3D (1 chain, "
        f"{QS_MAP_ITERS} of 200) {qs['cine_map_3d']['iters_per_s']:.2f} "
        f"iterations/s; unconditioned 3-D / 1-D ({QS_3D_LEVELS} of 400 "
        f"levels) {qs['sample_Diffusion3D']['evals_per_s']:.2f} / "
        f"{qs['sample_Diffusion1D']['evals_per_s']:.2f} evaluations/s; no "
        f"K1/K2/K4 launch")


def guidance_step_card_vs_cpu(kind: str, gen: torch.Generator,
                              device="cuda") -> dict:
    """One train step of a guidance net (weights from seed 0) on the card
    and on the CPU in the float32 mode, the same batch and injected draws:
    "clf" the ResNetClf on MNIST-size images (32 px, batch 8), "seg" the
    general config's UNet on ACDC-size slices (256 px, batch 2, the input
    perturbed at one shared ladder sigma). The loss's difference, gated at
    TRAIN_LOSS_REL, the gradients' rel L2 and the CPU's seconds. The
    classifier's gradient is gated at MODEL_REL_L2. The seg UNet's float32
    gradient loses digits in its instance norms' backward on any device
    (the CPU's reads about 3e-4 from float64), so, as the serve phase holds
    its guidance gradient: its float64 gradient (the step's loss on a
    float64 copy) card vs CPU at SEG_F64_REL_L2, and each float32 step's
    gradient against the CPU's float64 one at SEG_F32_REL_L2."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.losses.guidance import (
        seg_loss_with_perturbation)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        build_clf, build_seg_unet, make_seg_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_clf_train_step, make_seg_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    if kind == "clf":
        cfg, size, batch = load_config("MNIST"), 32, 8
        model = seeded_weights(build_clf(), 0)
        sigmas = get_sigmas(cfg)
        y = torch.randint(0, 10, (batch,), generator=gen)
        draws = {"labels": torch.randint(0, len(sigmas), (batch,),
                                         generator=gen)}
        make = lambda m: make_clf_train_step(m, sigmas)
    else:
        cfg, size, batch = load_config("ACDC"), 256, 2
        model = seeded_weights(build_seg_unet(), 0)
        sigmas = get_sigmas(cfg)
        y = (torch.rand(batch, size, size, generator=gen) > 0.8).long()
        shared = torch.randint(0, len(sigmas), (1,), generator=gen)
        draws = {"labels": shared.expand(batch)}
        make = lambda m: make_seg_train_step(m, sigmas, perturb=True)
    x = torch.rand(batch, size, size, 1, generator=gen)
    draws["noise"] = torch.randn(batch, size, size, 1, generator=gen)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    flat = lambda m: torch.cat([p.grad.detach().reshape(-1).cpu().double()
                                for p in m.parameters()])
    out, f64, cpu_s = {}, {}, 0.0
    for dev in (device, "cpu"):
        model.load_state_dict(w0)
        model.to(dev)
        state = TrainState.create(model, get_optimizer(cfg), ema_decay=None)
        step = make(model)
        t_dev = time.perf_counter()
        with float32_exact():
            state, loss = step(state, (x.to(dev), y.to(dev)), **{
                k: v.to(dev) for k, v in draws.items()})
        if dev == "cpu":
            cpu_s = time.perf_counter() - t_dev
        out[dev] = (float(loss), flat(model))
        del state, step
        if kind == "seg":
            m64 = copy.deepcopy(model)     # at w0: the step moved model
            m64.load_state_dict(w0)
            m64.double()
            loss64, _ = seg_loss_with_perturbation(
                make_seg_fn(m64), x.to(dev, torch.float64), y.to(dev),
                sigmas.to(dev, torch.float64), perturb=True,
                **{k: v.to(dev) if k == "labels" else v.to(dev, torch.float64)
                   for k, v in draws.items()})
            loss64.backward()
            f64[dev] = flat(m64)
            del m64, loss64
    (card_loss, card_g), (cpu_loss, cpu_g) = out[device], out["cpu"]
    c = dict(loss=abs(card_loss - cpu_loss) / abs(cpu_loss),
             grads=rel_l2(card_g, cpu_g), cpu_s=cpu_s, batch=batch,
             size=size)
    ok = c["loss"] <= TRAIN_LOSS_REL
    if kind == "clf":
        ok = ok and c["grads"] <= MODEL_REL_L2
    else:
        c.update(f64_grads=rel_l2(f64[device], f64["cpu"]),
                 card_f32_vs_f64=rel_l2(card_g, f64["cpu"]),
                 cpu_f32_vs_f64=rel_l2(cpu_g, f64["cpu"]),
                 sigma=float(sigmas[shared]))
        ok = ok and (c["f64_grads"] <= SEG_F64_REL_L2
                     and c["card_f32_vs_f64"] <= SEG_F32_REL_L2
                     and c["cpu_f32_vs_f64"] <= SEG_F32_REL_L2)
    if not ok:
        raise AssertionError(f"{kind} train step card vs CPU: {c}")
    del model
    torch.cuda.empty_cache()
    return c


def guided_problem(chains: int, device) -> dict:
    """The MNIST guided problem at full width: the test digit 0 of the
    loader (its synthetic stand-in here), SkipLines keeping every 2nd row
    (the CLIs' default) applied to the image, the measurement repeated
    over `chains`, target class 3 (the CLIs' default) and the L2Penalty
    proximal (CG 8), on `device`."""
    from inverseproblemwithdiffusionmodel_tpu_torch.data import load_data
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        L2Penalty, SkipLines)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import (
        repeat_measurement)
    with warnings_quiet():
        img = torch.as_tensor(load_data("MNIST", "test", size=32).data[:1])
    op = SkipLines(num_skip_lines=2, height=32)
    y = repeat_measurement(op(img.to(torch.complex64)), chains)
    return dict(img=img.to(device), op=op, y=y.to(device),
                cls=torch.full((chains,), 3, device=device),
                prox=L2Penalty(lin_tfm=op))


def run_variant(name: str, score, clf_fn, sigmas, prob: dict, config,
                x_init: torch.Tensor, device, noise=None,
                clf_start_time=0.0, lr_scaled=5.0):
    """One of the seven ald_variants samplers on the guided problem, from
    `x_init` where the sampler takes a start (ald_interpolation spawns
    GUIDED_INTERPOLATIONS chains from each of its rows); lr_scaled 5.0 and
    clf_start_time 0.0 are mnist_inv_clf_prox_sampling's defaults."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
        ald_variants as av)
    y, op, cls = prob["y"], prob["op"], prob["cls"]
    kw = dict(config=config, noise=noise, device=device)
    if name == "inpainting":
        refer = prob["img"].expand(y.shape[0], -1, -1, -1)
        return av.ald_inpainting(score, sigmas, refer,
                                 av.half_mask(refer.shape), x_init=x_init,
                                 **kw)
    if name == "interpolation":
        rows = x_init[:x_init.shape[0] // GUIDED_INTERPOLATIONS]
        return av.ald_interpolation(score, sigmas, rows,
                                    GUIDED_INTERPOLATIONS, **kw)
    if name == "cls_conditioned":
        return av.ald_cls_conditioned(score, clf_fn, cls, sigmas,
                                      tuple(x_init.shape), x_init=x_init,
                                      **kw)
    if name == "inverse_problem":
        return av.ald_inverse_problem(score, sigmas, y, op, 1.0,
                                      x_init=x_init, **kw)
    if name == "inverse_problem_proj":
        return av.ald_inverse_problem_proj(score, sigmas, y, op, 1.0,
                                           x_init=x_init, **kw)
    if name == "inverse_clf":
        return av.ald_inverse_clf(score, clf_fn, cls, sigmas, y, op,
                                  GUIDED_LAMDA, **kw)
    return av.ald_inverse_clf_proximal(
        score, clf_fn, cls, sigmas, y, op, prob["prox"],
        lr_scaled=lr_scaled, clf_start_time=clf_start_time, **kw)


def guided_check(sigmas, config, k: int = GUIDED_CHECK_LEVEL) -> dict:
    """The one-level check's ladder and sampler config: level k alone, a
    one-level ladder at level k's step (the proximal's alpha, step_lr x
    lr_scaled, kept at the whole run's; the guidance constant, since a
    one-level ramp is 0)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    check_cfg = ALDConfig(n_steps_each=config.n_steps_each, denoise=False,
                          step_lr=float(config.step_lr * (
                              sigmas[k] / sigmas[-1]) ** 2))
    return dict(level=sigmas[k:k + 1], config=check_cfg,
                lr_scaled=5.0 * config.step_lr / check_cfg.step_lr)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms inside the block (its
    benchmark mode too: it then times only those)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def guided_level_run(name: str, model, clf, check: dict, x0: torch.Tensor,
                     dev, noise_seed: int = 16, deterministic: bool = True
                     ) -> torch.Tensor:
    """One level of the sampler `name` (guided_check's ladder) from x0 on
    `dev`, fed the draws of a CPU generator seeded with `noise_seed`, in the
    float32 mode; the model and the classifier move to `dev`. Returns the
    output on the CPU, complex ones as their real view.

    `deterministic` restricts cuDNN to deterministic algorithms. Without
    it, benchmark mode may pick a backward of the classifier that sums with
    atomics: its input gradient then varies run to run (up to 3e-7 rel L2
    on an H100), and one run in 20 of inverse_clf_proximal read 4.46e-4
    against the CPU where the others read 2.4e-7 (guided_gate.py)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    model.to(dev)
    clf.to(dev)
    noise_gen = torch.Generator().manual_seed(noise_seed)
    level = check["level"]
    with float32_exact(), (cudnn_deterministic() if deterministic
                           else contextlib.nullcontext()):
        x_chk = (x0[:1].repeat(GUIDED_INTERPOLATIONS, 1, 1, 1)
                 if name == "interpolation" else x0)
        out = run_variant(
            name, registry.make_score_fn(model, level),
            registry.make_clf_fn(clf), level,
            guided_problem(x_chk.shape[0], dev), check["config"],
            x_chk.to(dev), dev, clf_start_time=None,
            lr_scaled=check["lr_scaled"],
            noise=lambda s: torch.randn(tuple(s),
                                        generator=noise_gen).to(dev))
    out = out.cpu()
    return torch.view_as_real(out) if out.is_complex() else out


def guided_phase(fk, fl, device="cuda") -> dict:
    """Classifier and segmentation training and the guided samplers at full
    width, weights from seed 0, torch's defaults unless said.
    train_clf.main --ds_name MNIST (ResNetClf, the synthetic digits, the
    config's batch 512) and train_seg.main --ds_name ACDC (the general
    config's UNet, channels 64-1024, on the synthetic 256 px slices, batch
    8: the config's 64 exceeds the stand-in's 24 slices),
    GUIDED_TRAIN_STEPS steps each: s/step, images/s, peak; one step of
    each card vs CPU (float32 mode; the seg UNet also in float64). The
    seven ald_variants samplers on
    MNIST's NCSNv2Deepest (32 px, ngf 128) and the ResNetClf,
    GUIDED_SAMPLES chains over GUIDED_LEVELS of the 232 levels x 5 steps:
    finite outputs, evaluations/s between CUDA synchronizations, the score
    net's and the classifier gradient's shares of the sampler's time by
    CUDA events; one level of each card vs CPU, fed the same noise, float32
    mode, cuDNN's algorithms deterministic (guided_level_run). The CLIs
    mnist_inv_clf_sampling and mnist_inv_clf_prox_sampling (the ladder cut
    alike, 8 samples) and mnist_MAP (GUIDED_MAP_ITERS of the config's 15000
    iterations) through timed_cli. Launches none of K1, K2 or K4."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
        ald_variants)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        mnist_MAP, mnist_inv_clf_prox_sampling as prox_cli,
        mnist_inv_clf_sampling as clf_cli, train_clf, train_seg)
    numbers = {"nvidia_smi": nvidia_smi()}
    gen = torch.Generator().manual_seed(15)
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()

    # Training the guidance nets
    root = tempfile.mkdtemp(prefix="chip_smoke_guided_")
    try:
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        for name, script, flags, batch, watch in (
                ("train_clf", train_clf, ["--ds_name", "MNIST"],
                 load_config("MNIST").training.clf_batch_size,
                 "resnet.fc.bias"),
                ("train_seg", train_seg, ["--ds_name", "ACDC",
                                          "--batch_size", "8"], 8,
                 "up_3.bias")):
            rec = {}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            with timed_fit(script, rec, watch, GUIDED_TRAIN_STEPS), \
                    warnings_quiet():
                state = script.main(flags + [
                    "--device", device, "--log_dir", os.path.join(root, name),
                    "--data_root", data_root, "--seed", "0"])
            torch.cuda.synchronize()
            s_step = float(np.mean(rec["step_s"][1:]))
            numbers[name] = dict(
                net=type(state.model).__name__, batch=batch,
                steps=state.step, s_per_step=s_step,
                images_per_s=batch / s_step, first_step_s=rec["step_s"][0],
                first_step_peak=rec["first_peak"],
                steady_peak=torch.cuda.max_memory_allocated(),
                wall_s=time.perf_counter() - t_run, losses=rec["losses"],
                params=sum(p.numel() for p in state.model.parameters()))
            if not (state.step == GUIDED_TRAIN_STEPS and state.ema is None
                    and np.isfinite(rec["losses"]).all()
                    and not torch.equal(rec["w0"], rec["history"][-1])):
                raise AssertionError(f"{name}: step {state.step}, losses "
                                     f"{rec['losses']}")
            del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers["steps_card_vs_cpu"] = {
        kind: guidance_step_card_vs_cpu(kind, gen, device)
        for kind in ("clf", "seg")}

    # The seven samplers at full width
    cfg = load_config("MNIST")
    model, _ = registry.load_model(cfg, "Diffusion", seed=0)
    clf, _ = registry.load_model(cfg, "Clf", seed=0)
    model = model.to(device).eval()
    clf = clf.to(device).eval().requires_grad_(False)
    sigmas = get_sigmas(cfg.replace(**{"model.num_classes": GUIDED_LEVELS}))
    n_steps = cfg.sampling.n_steps_each
    config = ALDConfig(n_steps_each=n_steps, step_lr=cfg.sampling.step_lr)
    prob = guided_problem(GUIDED_SAMPLES, device)
    x_init = torch.rand(GUIDED_SAMPLES, 32, 32, 1, generator=gen).to(device)
    samplers = {}
    for name in GUIDED_VARIANTS:
        score_ev, clf_ev = [], []
        score = event_timed(registry.make_score_fn(model, sigmas), score_ev)
        clf_fn = registry.make_clf_fn(clf)
        inner_grad = ald_variants.compute_clf_grad

        def timed_grad(fn, x, cls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner_grad(fn, x, cls)
            end.record()
            clf_ev.append((start, end))
            return out

        ald_variants.compute_clf_grad = timed_grad
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t_run = time.perf_counter()
            out = run_variant(name, score, clf_fn, sigmas, prob, config,
                              x_init, device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t_run
        finally:
            ald_variants.compute_clf_grad = inner_grad
        if not (out.shape[0] == GUIDED_SAMPLES and torch.isfinite(
                torch.view_as_real(out) if out.is_complex() else out).all()):
            raise AssertionError(f"{name}: shape {tuple(out.shape)} or not "
                                 f"finite")
        evals = len(score_ev)
        ms = 1e3 * seconds
        r = dict(evals=evals, seconds=seconds, evals_per_s=evals / seconds,
                 inner_step_ms=ms / (GUIDED_LEVELS * n_steps),
                 score_share=sum(a.elapsed_time(b) for a, b in score_ev) / ms,
                 peak=torch.cuda.max_memory_allocated(),
                 abs_max=float(out.abs().max()))
        if clf_ev:
            clf_ms = sum(a.elapsed_time(b) for a, b in clf_ev)
            r.update(clf_grad_calls=len(clf_ev), clf_grad_share=clf_ms / ms,
                     clf_grad_ms_per_inner_step=clf_ms / len(clf_ev))
        elif name in GUIDED_CLF:
            raise AssertionError(f"{name}: no classifier gradient")
        samplers[name] = r
        del out
    numbers["samplers"] = samplers

    # One level of each sampler card vs CPU, the same noise, float32 mode:
    # level k alone, a one-level ladder at level k's step (the proximal's
    # alpha, step_lr x lr_scaled, kept at the run's; the guidance
    # constant, since a one-level ramp is 0)
    k = GUIDED_CHECK_LEVEL
    check = guided_check(sigmas, config, k)
    x0 = torch.rand(GUIDED_CHECK_CHAINS, 32, 32, 1, generator=gen)
    checks, cpu_s = {}, 0.0
    for name in GUIDED_VARIANTS:
        outs = {}
        for dev in (device, "cpu"):
            t_dev = time.perf_counter()
            outs[dev] = guided_level_run(name, model, clf, check, x0, dev)
            if dev == "cpu":
                cpu_s += time.perf_counter() - t_dev
        checks[name] = rel_l2(outs[device], outs["cpu"])
    model.to(device)
    clf.to(device)
    numbers["level_card_vs_cpu"] = dict(
        level=k, sigma=float(sigmas[k]), step=check["config"].step_lr,
        rel_l2=checks, cpu_s=cpu_s)
    if not all(v <= MODEL_REL_L2 for v in checks.values()):
        raise AssertionError(f"ald_variants one level card vs CPU: {checks}")
    del model, clf
    torch.cuda.empty_cache()

    # The MNIST CLIs
    common = ["--seed", "0", "--device", str(device)]
    for name, script, sampler, flags in (
            ("mnist_inv_clf_sampling", clf_cli, "ald_inverse_clf", [
                "--num_samples", str(GUIDED_SAMPLES), "--lamda",
                str(GUIDED_LAMDA), "--override",
                f"model.num_classes={GUIDED_LEVELS}"]),
            ("mnist_inv_clf_prox_sampling", prox_cli,
             "ald_inverse_clf_proximal", [
                 "--num_samples", str(GUIDED_SAMPLES), "--override",
                 f"recons.num_classes={GUIDED_LEVELS}"]),
            ("mnist_MAP", mnist_MAP, "map_optimizer", [
                "--n_iters", str(GUIDED_MAP_ITERS)])):
        r = timed_cli(script, common + flags, name=sampler,
                      metrics=name != "mnist_MAP")
        recons = r.pop("recons")
        del r["call"]
        rows = GUIDED_SAMPLES if name != "mnist_MAP" else 1
        if not (recons.shape == (rows, 32, 32, 1)
                and np.isfinite(recons).all()):
            raise AssertionError(f"{name}: {recons.shape}, finite "
                                 f"{np.isfinite(recons).all()}")
        if name == "mnist_MAP":
            r["iters_per_s"] = GUIDED_MAP_ITERS / r["sampler_s"]
        else:
            r["evals_per_s"] = (GUIDED_LEVELS * n_steps + 1) / r["sampler_s"]
        numbers[name] = r
    no_kernel_launches(fk, fl, "the guided phase")
    torch.cuda.empty_cache()
    return numbers


def report_guided(gd: dict, t: float) -> None:
    smi = gd["nvidia_smi"]
    for name in ("train_clf", "train_seg"):
        r = gd[name]
        print(f"    {name}: {r['net']} ({r['params']} params), batch "
              f"{r['batch']}, {r['steps']} steps: {r['s_per_step']:.4f} "
              f"s/step (first {r['first_step_s']:.2f} s excluded), "
              f"{r['images_per_s']:.2f} images/s; peak first step "
              f"{r['first_step_peak']} bytes, steady {r['steady_peak']}; "
              f"wall {r['wall_s']:.2f} s; losses "
              f"{[round(v, 4) for v in r['losses']]} ({smi})", flush=True)
    for name, r in gd["samplers"].items():
        extra = (f", classifier gradient {r['clf_grad_share']:.3f} of the "
                 f"sampler ({r['clf_grad_ms_per_inner_step']:.2f} ms a call)"
                 if "clf_grad_share" in r else "")
        print(f"    ald_{name}: {r['evals']} evaluations, "
              f"{r['evals_per_s']:.2f}/s, an inner step "
              f"{r['inner_step_ms']:.2f} ms, score net "
              f"{r['score_share']:.3f} of the sampler{extra}; peak "
              f"{r['peak']} bytes, max |x| {r['abs_max']:.4g}", flush=True)
    lc = gd["level_card_vs_cpu"]
    steps = gd["steps_card_vs_cpu"]
    say("guided", t, f"train_clf MNIST (ResNetClf) batch "
        f"{gd['train_clf']['batch']} {gd['train_clf']['s_per_step']:.4f} "
        f"s/step ({gd['train_clf']['images_per_s']:.2f} images/s), "
        f"train_seg ACDC 256 px (UNet 64-1024) batch "
        f"{gd['train_seg']['batch']} {gd['train_seg']['s_per_step']:.4f} "
        f"s/step ({gd['train_seg']['images_per_s']:.2f} images/s), "
        f"{smi}; steps card vs CPU (float32 mode) "
        f"{json.dumps(steps)} (clf <= {MODEL_REL_L2}; seg float64 <= "
        f"{SEG_F64_REL_L2}, float32 vs float64 <= {SEG_F32_REL_L2}); "
        f"ald_variants at "
        f"{GUIDED_SAMPLES} samples, {GUIDED_LEVELS} of 232 levels x 5: "
        f"evaluations/s " + json.dumps(
            {n: round(r["evals_per_s"], 2)
             for n, r in gd["samplers"].items()}) + f"; one level (sigma "
        f"{lc['sigma']:.4g}) card vs CPU {json.dumps(lc['rel_l2'])} (<= "
        f"{MODEL_REL_L2}); CLIs: mnist_inv_clf_sampling "
        f"{gd['mnist_inv_clf_sampling']['evals_per_s']:.2f} evaluations/s, "
        f"mnist_inv_clf_prox_sampling "
        f"{gd['mnist_inv_clf_prox_sampling']['evals_per_s']:.2f}, mnist_MAP "
        f"({GUIDED_MAP_ITERS} of 15000) "
        f"{gd['mnist_MAP']['iters_per_s']:.2f} iterations/s; no K1/K2/K4 "
        f"launch")


# -- 18b. migrate: reference checkpoints, the native feed, TensorBoard -----

def lightning_checkpoint(path: str, ema_model, raw_model) -> int:
    """A reference-style Lightning checkpoint of two NCSNv2-family nets,
    written by the port's export_ncsn_state_dict: `model.`-prefixed keys,
    the EMA copy under callbacks.EMA.ema_state_dict, the raw copy under
    state_dict. Returns the file's bytes."""
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.torch_import import (
        export_ncsn_state_dict)
    pre = lambda m: {f"model.{k}": torch.from_numpy(v)
                     for k, v in export_ncsn_state_dict(m).items()}
    torch.save({"state_dict": pre(raw_model),
                "callbacks": {"EMA": {"ema_state_dict": pre(ema_model)}},
                "epoch": 0, "global_step": 0}, path)
    return os.path.getsize(path)


def ncsnpp_reference_state(model, cfg) -> dict:
    """The reference's state dict of the port's NCSN++: every top-level
    module at its all_modules index (the port's ncsnpp_index_map
    inverted), the fused resamplers' Conv2d_0_weight (kh, kw, I, O) as
    Conv2d_0.weight (O, I, kh, kw); everything else is torch's layout
    already."""
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.torch_import import (
        ncsnpp_index_map)
    index = ncsnpp_index_map(cfg)
    sd = {}
    for key, value in model.state_dict().items():
        top, _, rest = key.partition(".")
        module, dot, leaf = rest.rpartition(".")
        if leaf in ("Conv2d_0_weight", "Conv2d_0_bias"):
            rest = module + dot + leaf.replace("_weight", ".weight").replace(
                "_bias", ".bias")
            if leaf == "Conv2d_0_weight":
                value = value.permute(3, 2, 0, 1)
        sd[f"all_modules.{index[top]}.{rest}"] = value.contiguous().clone()
    return sd


def timed_import(argv: list) -> tuple:
    """import_torch_checkpoint.main(argv), its output echoed indented:
    (the TrainState it wrote, the wall seconds)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        import_torch_checkpoint)
    out = io.StringIO()
    t_run = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = import_torch_checkpoint.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_run
    for line in out.getvalue().splitlines():
        print(f"    {line}", flush=True)
    if "all leaves matched" not in out.getvalue():
        raise AssertionError("import_torch_checkpoint printed no match")
    return state, seconds


def restored(ckpt_dir: str, model_fn, use_ema: bool = True):
    """A fresh net from `model_fn()` with the EMA (or raw) weights of the
    latest checkpoint in `ckpt_dir`, and the step it restored."""
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer)
    params, step = Checkpointer(ckpt_dir, track_best=False).restore_params(
        use_ema=use_ema)
    model = model_fn()
    model.load_state_dict(params, strict=True)
    return model, step


def same_weights(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


def same_forward(a, b, x, c, device) -> bool:
    """Both nets' forward on `device`, the same input, cuDNN's algorithms
    deterministic: equal bit for bit."""
    outs = []
    for net in (a, b):
        net.to(device).eval()
        with torch.no_grad(), cudnn_deterministic():
            outs.append(net(x.to(device), c.to(device)).cpu())
        net.cpu()
    return torch.equal(outs[0], outs[1]) and bool(
        torch.isfinite(outs[0]).all())


@contextlib.contextmanager
def feed_probe(train_ncsn, rec: dict, tensorboard: bool = False):
    """Wrap the feed factory train_ncsn builds: rec gets the feed it took
    ("native" or "numpy"), the data, batch size and seed it was given,
    every batch handed out and the host's seconds waiting for each. With
    `tensorboard`, the run's FitConfig mirrors the metrics (log_every 1)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.training import FitConfig
    inner, inner_cfg = train_ncsn.make_train_iterator, train_ncsn.FitConfig

    def make_train_iterator(data, batch_size, **kw):
        make = inner(data, batch_size, **kw)
        rec.update(feed=make.feed, data=data, batch_size=batch_size,
                   seed=kw["seed"], batches=[], wait_s=[])

        def timed():
            it = iter(make())
            while True:
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                rec["wait_s"].append(time.perf_counter() - t_wait)
                rec["batches"].append(batch)
                yield batch

        timed.feed = make.feed
        return timed

    train_ncsn.make_train_iterator = make_train_iterator
    if tensorboard:
        train_ncsn.FitConfig = lambda **kw: FitConfig(
            **dict(kw, log_every=1, tensorboard=True))
    try:
        yield rec
    finally:
        train_ncsn.make_train_iterator = inner
        train_ncsn.FitConfig = inner_cfg


def tensorboard_importable() -> tuple:
    """(whether torch.utils.tensorboard imports here, the error if not)."""
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception as e:
        return False, repr(e)
    return True, None


def migrate_phase(fk, fl, device="cuda") -> dict:
    """The migration path at full width, weights from seeds, files in a
    temporary directory outside the checkout. Discrete: the ACDC
    NCSNv2Deepest (256 px, ngf 128) as a Lightning .ckpt (EMA from seed 0,
    raw from seed 1), import_torch_checkpoint --ds_name ACDC (and again
    with --raw_weights), the imported net's forward against the source's
    on the card (bit for bit), then acdc_SENSE_real_img --ckpt_dir at
    SENSE_SAMPLES chains and MIGRATE_LEVELS levels; the CINE127_1D NCSN1D
    alike (--task_name Diffusion1D), its forward only. Continuous: the
    FFHQ-256 NCSN++ (CONFIG) as a reference all_modules .pth,
    import_torch_checkpoint --continuous, the forward bit for bit, then
    pc_sampling --ckpt_dir (K1/K2 counted). The feed: train_ncsn --ds_name
    ACDC, MIGRATE_TRAIN_STEPS steps at batch MIGRATE_TRAIN_BATCH, on the
    native batcher (its batches held to the plain version's for the seed)
    and with --no_native_loader; the first run mirrors its metrics to
    TensorBoard where torch.utils.tensorboard imports (the event file read
    back against metrics.jsonl), else the mirror must warn and
    metrics.jsonl still be written."""
    import warnings
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config)
    from inverseproblemwithdiffusionmodel_tpu_torch.data.native_loader import (
        reference_batches)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        create_model, load_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_SENSE_real_img, pc_sampling, train_ncsn)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.tb_export import (
        read_scalars)
    numbers = {"nvidia_smi": nvidia_smi()}
    gen = torch.Generator().manual_seed(19)
    root = tempfile.mkdtemp(prefix="chip_smoke_migrate_")
    try:
        # Discrete: NCSNv2Deepest (ACDC) and NCSN1D (CINE127_1D)
        for name, ds, task, sens in (
                ("acdc", "ACDC", "Diffusion", True),
                ("cine_1d", "CINE127_1D", "Diffusion1D", False)):
            t_part = time.perf_counter()
            cfg = load_config(ds, "real-imag")
            d = cfg.data
            x = (torch.rand(2, d.channels, d.image_size, d.image_size,
                            generator=gen) if sens else
                 torch.rand(MIGRATE_TUBES, d.channels, d.image_size,
                            generator=gen))
            ema, _ = load_model(cfg, task, seed=0)
            raw, _ = load_model(cfg, task, seed=1)
            ckpt = os.path.join(root, f"{name}.ckpt")
            t_save = time.perf_counter()
            size = lightning_checkpoint(ckpt, ema, raw)
            save_s = time.perf_counter() - t_save
            runs = {}
            for flag in ([], ["--raw_weights"]):
                out = os.path.join(root, f"{name}{''.join(flag)}_ckpts")
                _, runs[bool(flag)] = timed_import(
                    ["--ckpt_path", ckpt, "--ds_name", ds, "--task_name",
                     task, "--mode", "real-imag", "--out_dir", out,
                     "--device", device] + flag)
                got, step = restored(out, lambda: load_model(cfg, task)[0])
                want = raw if flag else ema
                if not (step == 0 and same_weights(got, want)
                        and not same_weights(got, ema if flag else raw)):
                    raise AssertionError(f"{name} import {flag}: step {step}"
                                         f", weights not the source's")
            c = torch.tensor([348.0, 0.37]).repeat(x.shape[0] // 2)
            got, _ = restored(os.path.join(root, f"{name}_ckpts"),
                              lambda: load_model(cfg, task)[0])
            if not same_forward(got, ema, x, c, device):
                raise AssertionError(f"{name}: the imported net's forward "
                                     f"differs from the source's")
            r = dict(net={"Diffusion": "NCSNv2Deepest",
                          "Diffusion1D": "NCSN1D"}[task], ckpt_bytes=size,
                     ckpt_save_s=save_s, import_s=runs[False],
                     import_raw_s=runs[True], forward_equal=True,
                     params=sum(p.numel() for p in ema.parameters()))
            del ema, raw, got
            if sens:
                cli = timed_cli(acdc_SENSE_real_img, [
                    "--ckpt_dir", os.path.join(root, f"{name}_ckpts"),
                    "--R", str(ACDC_R), "--num_sens", str(ACDC_COILS),
                    "--lr_scaled", str(ACDC_LR_SCALED), "--override",
                    f"recons.num_classes={MIGRATE_LEVELS}", "--seed", "0",
                    "--device", str(device), "--num_samples",
                    str(SENSE_SAMPLES)], name="reconstruct")
                recons = cli.pop("recons")
                del cli["call"]
                if not (recons.shape == (SENSE_SAMPLES, d.image_size,
                                         d.image_size, 1)
                        and np.isfinite(recons).all()):
                    raise AssertionError(f"imported CLI: {recons.shape}, "
                                         f"finite {np.isfinite(recons).all()}")
                cli["chain_steps"] = MIGRATE_LEVELS * 3 * SENSE_SAMPLES
                cli["chain_steps_per_s"] = cli["chain_steps"] / cli[
                    "sampler_s"]
                r["sense_cli"] = cli
            for path in os.listdir(root):
                if path.startswith(name):
                    full = os.path.join(root, path)
                    (shutil.rmtree if os.path.isdir(full) else os.remove)(
                        full)
            r["wall_s"] = time.perf_counter() - t_part
            numbers[name] = r

        # Continuous: NCSN++ FFHQ-256
        t_part = time.perf_counter()
        cfg = get_continuous_config(CONFIG)
        src = seeded_weights(create_model(cfg), seed=0)
        pth = os.path.join(root, "ncsnpp.pth")
        torch.save(ncsnpp_reference_state(src, cfg), pth)
        out = os.path.join(root, "ncsnpp_ckpts")
        _, import_s = timed_import(["--ckpt_path", pth, "--continuous",
                                    CONFIG, "--out_dir", out, "--device",
                                    device])
        got, step = restored(out, lambda: create_model(cfg))
        size = cfg.data.image_size
        x = torch.rand(1, size, size, cfg.data.num_channels, generator=gen)
        if not (step == 0 and same_weights(got, src) and same_forward(
                got, src, x, torch.tensor([0.5]), device)):
            raise AssertionError("NCSN++: the imported net differs from the "
                                 "source")
        del got
        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        t_sample = time.perf_counter()
        samples, nfe, text = run_pc_sampling(pc_sampling, [
            "--config", CONFIG, "--num_samples", str(BATCH), "--seed", "0",
            "--ckpt_dir", out, "--device", str(device), "--override",
            f"model.num_scales={CKPT_NUM_SCALES}", "--save_dir",
            os.path.join(root, "samples")])
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t_sample
        launches = {**fk.LAUNCHES, **fl.LAUNCHES}
        per_forward, _ = fir_counts(cfg)
        expect = {k: n * (CKPT_NUM_SCALES * 2 + 1)
                  for k, n in per_forward.items()}
        if not ("restored step 0 from" in text and dict(fk.LAUNCHES) ==
                expect and nfe == CKPT_NUM_SCALES * 2
                and np.isfinite(samples).all()):
            raise AssertionError(f"pc_sampling on the import: launches "
                                 f"{launches} (expected {expect}), nfe {nfe}")
        numbers["ncsnpp"] = dict(
            params=sum(p.numel() for p in src.parameters()),
            pth_bytes=os.path.getsize(pth), import_s=import_s,
            forward_equal=True, launches=launches, nfe=nfe,
            sample_s=sample_s, wall_s=time.perf_counter() - t_part)
        del src
        shutil.rmtree(out, ignore_errors=True)
        os.remove(pth)

        # The feed: native, then --no_native_loader; TensorBoard
        tb_ok, tb_error = tensorboard_importable()
        numbers["tensorboard_importable"] = tb_ok
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        for name, flag in (("native", []), ("numpy", ["--no_native_loader"])):
            rec, feed = {}, {}
            log_root = os.path.join(root, f"train_{name}")
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            with timed_fit(train_ncsn, rec, "end_conv.bias"), \
                    feed_probe(train_ncsn, feed, tensorboard=not flag), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state = train_ncsn.main([
                    "--ds_name", "ACDC", "--mode", "real-imag", "--device",
                    device, "--batch_size", str(MIGRATE_TRAIN_BATCH),
                    "--log_dir", log_root, "--data_root", data_root,
                    "--override",
                    f"training.n_iters={MIGRATE_TRAIN_STEPS}"] + flag)
            torch.cuda.synchronize()
            r = dict(feed=feed["feed"], steps=state.step,
                     s_per_step=float(np.mean(rec["step_s"][1:])),
                     first_step_s=rec["step_s"][0],
                     batch_wait_s=sum(feed["wait_s"]),
                     batch_wait_max_s=max(feed["wait_s"]),
                     batches=len(feed["batches"]), save_s=rec["save_s"],
                     wall_s=time.perf_counter() - t_run,
                     losses=rec["losses"])
            del state
            if r["feed"] != name or r["steps"] != MIGRATE_TRAIN_STEPS or \
                    not np.isfinite(r["losses"]).all():
                raise AssertionError(f"train_ncsn {flag}: {r}")
            if name == "native":
                data = feed["data"]
                plain = reference_batches(
                    data.shape[0], feed["batch_size"], shuffle=True,
                    seed=feed["seed"], drop_last=True)
                r["batches_equal_plain"] = all(
                    np.array_equal(b, data[next(plain)])
                    for b in feed["batches"])
                if not r["batches_equal_plain"]:
                    raise AssertionError("the native feed's batches differ "
                                         "from the plain version's")
                run_dir = os.path.join(log_root, "ACDC_Diffusion_real-imag")
                with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                    records = [json.loads(line) for line in f]
                want = {}
                for rec_line in records:
                    for k, v in rec_line.items():
                        if k not in ("ts", "step"):
                            want.setdefault(k, []).append(
                                (rec_line["step"], np.float32(v)))
                warned = [str(w.message) for w in caught
                          if "TensorBoard export unavailable"
                          in str(w.message)]
                if tb_ok:
                    events = read_scalars(os.path.join(run_dir, "tb"))
                    got = {k: [(s, np.float32(v)) for s, v, _ in rows]
                           for k, rows in events.items()}
                    if not (got == want and want.get("train_loss")):
                        raise AssertionError(f"TensorBoard events {got} vs "
                                             f"metrics.jsonl {want}")
                    r["tensorboard"] = dict(
                        tags=sorted(got), scalars=sum(map(len, got.values())),
                        equal_to_jsonl=True)
                else:
                    if not (len(warned) == 1 and want.get("train_loss") and
                            not os.path.exists(os.path.join(run_dir, "tb"))):
                        raise AssertionError(f"no TensorBoard: warnings "
                                             f"{warned}, jsonl {want}")
                    r["tensorboard"] = dict(error=tb_error, warned=warned[0],
                                            jsonl_records=len(records))
            numbers[f"train_{name}"] = r
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return numbers


def report_migrate(mg: dict, t: float, sense_cps: float) -> None:
    smi = mg["nvidia_smi"]
    for name in ("acdc", "cine_1d"):
        r = mg[name]
        print(f"    {name}: {r['net']} ({r['params']} params): .ckpt "
              f"{r['ckpt_bytes']} bytes written in {r['ckpt_save_s']:.2f} s; "
              f"import_torch_checkpoint {r['import_s']:.2f} s (EMA), "
              f"{r['import_raw_s']:.2f} s (--raw_weights, the raw copy); "
              f"forward equal bit for bit; wall {r['wall_s']:.2f} s ({smi})",
              flush=True)
    cli = mg["acdc"]["sense_cli"]
    pp = mg["ncsnpp"]
    print(f"    acdc_SENSE_real_img --ckpt_dir (the import): "
          f"{SENSE_SAMPLES} chains, {MIGRATE_LEVELS} levels x 3: sampler "
          f"{cli['sampler_s']:.4f} s, {cli['chain_steps_per_s']:.2f} "
          f"chain-steps/s (the sense phase's {sense_cps:.2f}), wall "
          f"{cli['wall_s']:.2f} s", flush=True)
    print(f"    ncsnpp: {pp['params']} params, .pth {pp['pth_bytes']} bytes, "
          f"import {pp['import_s']:.2f} s, forward equal bit for bit; "
          f"pc_sampling --ckpt_dir nfe {pp['nfe']} in {pp['sample_s']:.2f} s,"
          f" launches {json.dumps(pp['launches'])}", flush=True)
    for name in ("native", "numpy"):
        r = mg[f"train_{name}"]
        print(f"    train_ncsn ACDC batch {MIGRATE_TRAIN_BATCH}, {name} feed: "
              f"{r['s_per_step']:.4f} s/step (first {r['first_step_s']:.2f} "
              f"s excluded), batch wait {r['batch_wait_s']:.6f} s over "
              f"{r['batches']} batches (max {r['batch_wait_max_s']:.6f}); "
              f"wall {r['wall_s']:.2f} s" + (
                  f"; batches equal the plain version's "
                  f"{r['batches_equal_plain']}; TensorBoard "
                  f"{json.dumps(r['tensorboard'])}"
                  if name == "native" else ""), flush=True)
    nat, npy = mg["train_native"], mg["train_numpy"]
    say("migrate", t, f"import_torch_checkpoint at full width: ACDC "
        f"NCSNv2Deepest {mg['acdc']['import_s']:.2f} s, CINE127_1D NCSN1D "
        f"{mg['cine_1d']['import_s']:.2f} s, FFHQ-256 NCSN++ "
        f"{pp['import_s']:.2f} s; each imported net's forward equals its "
        f"source's bit for bit on the card, --raw_weights takes the raw "
        f"copy; acdc_SENSE_real_img on the import "
        f"{cli['chain_steps_per_s']:.2f} chain-steps/s (sense phase "
        f"{sense_cps:.2f}); pc_sampling on the NCSN++ import: K1/K2 "
        f"launches {json.dumps(pp['launches'])}; train_ncsn feed native "
        f"{nat['s_per_step']:.4f} s/step (wait {nat['batch_wait_s']:.6f} s), "
        f"numpy {npy['s_per_step']:.4f} (wait {npy['batch_wait_s']:.6f} s); "
        f"torch.utils.tensorboard imports: {mg['tensorboard_importable']}; "
        f"{smi}")


def tiny_ode_setup(cfg, gen) -> dict:
    """A tiny NCSN++ of the leaf `cfg` (nf 16, FIR, 16 px, weights from
    seed 1, on the CPU), its SDE and one x_init of 2 samples drawn from
    `gen`, for tiny_ode_solve."""
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        create_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    tiny = cfg.replace(**{"data.image_size": 16, "model.nf": 16,
                          "model.ch_mult": (1, 2, 2),
                          "model.num_res_blocks": 1,
                          "model.attn_resolutions": (8,)})
    sde = make_sde(tiny)
    shape = (2, 16, 16, 3)
    x_init = sde.prior_sampling(
        lambda s: torch.randn(tuple(s), generator=gen), shape)
    return dict(sde=sde, shape=shape, x_init=x_init,
                net=seeded_weights(create_model(tiny), seed=1).eval())


def tiny_ode_solve(setup: dict, net, tol: float, dev) -> tuple:
    """The probability-flow ODE sampler (denoise on, rtol = atol = `tol`)
    on tiny_ode_setup's problem with `net` on `dev` (on the card in the
    float32 mode; on the CPU no CUDA call, so it may run on a thread of
    its own): the samples on the CPU and odeint's counts."""
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
        get_ode_sampler, get_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    sde = setup["sde"]
    net.to(dev)
    st = {}
    mode = contextlib.nullcontext() if str(dev) == "cpu" else float32_exact()
    with torch.no_grad(), mode:
        x, _ = get_ode_sampler(sde, setup["shape"], denoise=True, rtol=tol,
                               atol=tol, device=dev)(
            get_score_fn(sde, net), x_init=setup["x_init"].to(dev),
            stats=st)
    return x.cpu(), st


def tiny_ode_check(name: str, card: tuple, cpu: tuple, gate: float) -> dict:
    """tiny_ode_solve's card and CPU runs of one problem: both evaluation
    counts, the card's rejected steps, the samples' rel L2, gated at
    `gate`; where the counts part, the first step the two decide
    differently and both error ratios there."""
    (card, c_st), (cpu, p_st) = card, cpu
    check = dict(card_nfe=c_st["nfe"], cpu_nfe=p_st["nfe"],
                 rejected=c_st["rejected"], rel_l2=rel_l2(card, cpu),
                 gate=gate)
    if not (torch.isfinite(card).all() and torch.isfinite(cpu).all()):
        raise AssertionError(f"tiny ODE {name}: not finite")
    if c_st["nfe"] != p_st["nfe"]:
        part = next(i for i, (a, b) in enumerate(zip(
            c_st["ratios"] + [None], p_st["ratios"] + [None]))
            if a is None or b is None or (a <= 1) != (b <= 1))
        check.update(parted_at_step=part, ratios_there=[
            r[part] if part < len(r) else None
            for r in (c_st["ratios"], p_st["ratios"])])
    if not check["rel_l2"] <= gate:
        raise AssertionError(f"tiny ODE card vs CPU, {name}: {check}")
    return check


def natural_phase(fk, fl, device="cuda") -> dict:
    """NCSN v1, the probability-flow ODE sampler and the natural-image
    discrete configs at full width, weights from seeds, torch's defaults
    unless said.

    The ODE path: K1 and K2 at every shape one forward of NATURAL_ODE_CONFIG
    gives them at the path's batch (its NATURAL_SAMPLES samples), held to
    their plain versions (KERNEL_RTOL, float32 mode) and timed as the
    kernels phase times them; then pc_sampling.main --method ode on that
    config: finite samples, the nfe it prints (sde.N, as the JAX sampler
    returns), the true score evaluations (a counting wrapper on the score
    function) and accepted / rejected steps (odeint's counts), K1 / K2
    launches equal to the per-forward count times (evaluations + the
    first forward), the sampler's evaluations/s alone, wall s, peak. A
    tiny NCSN++ ODE (nf 16, FIR, 16 px, 2 samples) from one x_init on the
    card and on the CPU, float32 mode (tiny_ode_solve, tiny_ode_check):
    the VP leaf at ODE_VP_CHECK_TOL and a VE leaf at 1e-5, each gated at
    ODE_REL_L2.

    NCSN v1 (NATURAL_V1_CONFIG, ngf 128, 32 px): pc_sampling.main at
    NATURAL_SAMPLES samples over the leaf's 10 levels x NATURAL_V1_STEPS_EACH
    ALD steps (of its 100); the forward at batch 2 card vs CPU (float32 mode); training.fit
    with make_continuous_score_train_step(continuous=False) at the leaf's
    batch 128 for NATURAL_V1_STEPS steps on seeded images, and one step at
    batch 2 card vs CPU (float32 mode: loss and gradients at
    MODEL_REL_L2). The natural-image discrete configs: train_ncsn.main
    --ds_name CELEBA (64 px, the Diffusion task's NCSNv2Deepest, 3
    channels, the config's batch 128, NATURAL_TRAIN_STEPS steps on the
    synthetic_rgb stand-in of an empty --data_root) and
    unconditioned_sampling.main --ds_name CIFAR10 (NATURAL_UNCOND_SAMPLES
    chains, the 232-level ladder cut to NATURAL_UNCOND_LEVELS x 5 steps).
    These launch none of K1, K2 or K4 (checked)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        create_model)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        pc_sampling, train_ncsn, unconditioned_sampling as uncond)
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import sampling
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        FitConfig, TrainState, batch_iterator, fit, get_optimizer,
        make_continuous_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    out = {}
    gen = torch.Generator().manual_seed(13)
    dev_flag = [] if device == "cuda" else ["--device", str(device)]
    root = tempfile.mkdtemp(prefix="chip_smoke_natural_")
    try:
        # -- the ODE path: its kernels, then the sampler --------------------
        cfg = get_continuous_config(NATURAL_ODE_CONFIG)
        k = tuple(cfg.model.fir_kernel)
        rows = {}
        with float32_exact():
            for name, C, R in fir_shapes(cfg):
                rows.setdefault(name, []).append(kernel_numbers(
                    name, C, R, k, fk, gen, NATURAL_SAMPLES))
        out["ode_kernels"] = summarize(
            rows, f"one {NATURAL_ODE_CONFIG} forward at batch "
                  f"{NATURAL_SAMPLES} (the ODE path)")
        out["ode_kernel_calls"] = {name: len(rs) for name, rs in rows.items()}
        fwd, _ = fir_counts(cfg)
        stats, evals = {}, [0]
        real_odeint, real_score = sampling.odeint, pc_sampling.get_score_fn

        def odeint_counted(*args, **kwargs):
            return real_odeint(*args, **dict(kwargs, stats=stats))

        def score_counted(*args, **kwargs):
            score = real_score(*args, **kwargs)

            def counted(x, t):
                evals[0] += 1
                return score(x, t)
            return counted

        sampling.odeint, pc_sampling.get_score_fn = (odeint_counted,
                                                     score_counted)
        try:
            torch.cuda.reset_peak_memory_stats()
            fk.LAUNCHES.clear()
            fl.LAUNCHES.clear()
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            sampler_s = []
            with timed_sampler(pc_sampling, sampler_s):
                samples, nfe, _ = run_pc_sampling(pc_sampling, [
                    "--config", NATURAL_ODE_CONFIG, "--method", "ode",
                    "--num_samples", str(NATURAL_SAMPLES), "--seed", "0",
                    "--save_dir", os.path.join(root, "ode")] + dev_flag)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            launches = dict(fk.LAUNCHES)
        finally:
            sampling.odeint, pc_sampling.get_score_fn = real_odeint, \
                real_score
        denoise = int(cfg.sampling.noise_removal)
        expect = {name: n * (evals[0] + 1) for name, n in fwd.items()}
        size, ch = cfg.data.image_size, cfg.data.num_channels
        if samples.shape != (NATURAL_SAMPLES, size, size, ch) or \
                not np.isfinite(samples).all():
            raise AssertionError(f"ODE samples {samples.shape}, finite "
                                 f"{np.isfinite(samples).all()}")
        if nfe != cfg.model.num_scales or \
                evals[0] != stats["nfe"] + denoise or \
                stats["nfe"] != 2 + 6 * stats["steps"]:
            raise AssertionError(f"ODE counts: printed nfe {nfe}, score "
                                 f"evaluations {evals[0]}, odeint {stats}")
        if launches != expect or sum(fl.LAUNCHES.values()):
            raise AssertionError(f"the ODE path launched {launches}, "
                                 f"expected {expect}")
        out["ode"] = dict(
            printed_nfe=nfe, evals=evals[0], odeint_nfe=stats["nfe"],
            steps=stats["steps"], accepted=stats["accepted"],
            rejected=stats["rejected"], host_reads=stats["steps"],
            sampler_s=sampler_s[0], evals_per_s=evals[0] / sampler_s[0],
            wall_s=wall, setup_s=wall - sampler_s[0],
            peak=torch.cuda.max_memory_allocated(), launches=launches,
            launches_per_eval={n: v / (evals[0] + 1)
                               for n, v in launches.items()})

        # where an evaluation's time goes: the net's forward at the path's
        # batch on the card and on the host (enqueue), and the integrator's
        # own ms per attempted step on a linear field of the same state
        net = seeded_weights(create_model(cfg), seed=0).to(device).eval()
        xs = torch.randn((NATURAL_SAMPLES, size, size, ch), generator=gen
                         ).to(device)
        ts = torch.full((NATURAL_SAMPLES,), 0.5 * 999, device=device)
        with torch.no_grad():
            fwd_ms, fwd_host_ms = cuda_ms(lambda: net(xs, ts), reps=10,
                                          host=True)
        del net
        lin = {}
        torch.cuda.synchronize()
        t_lin = time.perf_counter()
        real_odeint(lambda y, s_: -y, xs, torch.tensor([0.0, 1.0]),
                    rtol=1e-5, atol=1e-5, stats=lin)
        torch.cuda.synchronize()
        out["ode"].update(
            forward_device_ms=fwd_ms, forward_host_ms=fwd_host_ms,
            integrator_ms_per_step=1e3 * (time.perf_counter() - t_lin)
            / lin["steps"])

        # the tiny ODEs, card then CPU (a solve is host-bound: on a thread
        # of its own it would hold the interpreter from the card's work)
        out["ode_tiny_card_vs_cpu"] = tiny = {}
        for leaf, tol in ((NATURAL_ODE_CONFIG, ODE_VP_CHECK_TOL),
                          (ODE_VE_CONFIG, 1e-5)):
            setup = tiny_ode_setup(get_continuous_config(leaf), gen)
            name = f"{leaf} rtol {tol:g}"
            tiny[name] = tiny_ode_check(
                name, tiny_ode_solve(setup, copy.deepcopy(setup["net"]),
                                     tol, device),
                tiny_ode_solve(setup, setup["net"], tol, "cpu"), ODE_REL_L2)

        # -- NCSN v1: sampling, the forward, training -------------------------
        v1 = get_continuous_config(NATURAL_V1_CONFIG).replace(
            **{"sampling.n_steps_each": NATURAL_V1_STEPS_EACH})
        s = v1.sampling
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        sampler_s = []
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        with timed_sampler(pc_sampling, sampler_s):
            samples, nfe, _ = run_pc_sampling(pc_sampling, [
                "--config", NATURAL_V1_CONFIG, "--num_samples",
                str(NATURAL_SAMPLES), "--seed", "0", "--override",
                f"sampling.n_steps_each={NATURAL_V1_STEPS_EACH}",
                "--save_dir", os.path.join(root, "v1")] + dev_flag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        no_kernel_launches(fk, fl, "NCSN v1 sampling")
        v1_evals = v1.model.num_scales * s.n_steps_each
        if samples.shape != (NATURAL_SAMPLES, 32, 32, 3) or \
                not np.isfinite(samples).all() or \
                nfe != v1.model.num_scales * (s.n_steps_each + 1):
            raise AssertionError(f"NCSN v1 samples {samples.shape}, finite "
                                 f"{np.isfinite(samples).all()}, nfe {nfe}")
        out["v1_sample"] = dict(printed_nfe=nfe, evals=v1_evals,
                                sampler_s=sampler_s[0],
                                evals_per_s=v1_evals / sampler_s[0],
                                wall_s=wall, setup_s=wall - sampler_s[0],
                                peak=torch.cuda.max_memory_allocated())

        model = seeded_weights(create_model(v1), seed=0).eval()
        out["v1_params"] = sum(p.numel() for p in model.parameters())
        xs = torch.rand(NATURAL_SAMPLES, 3, 32, 32, generator=gen).to(device)
        ys = torch.zeros(NATURAL_SAMPLES, dtype=torch.long, device=device)
        with torch.no_grad():
            model.to(device)
            out["v1_sample"]["forward_device_ms"], \
                out["v1_sample"]["forward_host_ms"] = cuda_ms(
                    lambda: model(xs, ys), reps=10, host=True)
        model.cpu()
        out["v1_forward_card_vs_cpu"] = forward_card_vs_cpu(
            model, torch.rand(2, 3, 32, 32, generator=gen),
            torch.tensor([0, v1.model.num_classes - 1]), device)
        if not out["v1_forward_card_vs_cpu"] <= MODEL_REL_L2:
            raise AssertionError(f"NCSN v1 forward card vs CPU: rel L2 "
                                 f"{out['v1_forward_card_vs_cpu']}")

        sde = make_sde(v1)
        w0 = {n: v.detach().cpu().clone()
              for n, v in model.state_dict().items()}
        model.to(device).train()
        state = TrainState.create(model, get_optimizer(v1),
                                  ema_decay=v1.model.ema_rate)
        step = make_continuous_score_train_step(
            model, sde, continuous=False,
            reduce_mean=v1.training.reduce_mean)
        B = v1.training.batch_size
        data = np.random.RandomState(0).rand(
            B * NATURAL_V1_STEPS, 32, 32, 3).astype(np.float32)
        seconds, losses = [], []

        def recorded_step(state, batch, generator):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            state, loss = step(state, batch, generator)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_step)
            losses.append(float(loss))
            return state, loss

        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, recorded_step, batch_iterator(data, B, seed=0),
                    FitConfig(n_epochs=1, max_steps=NATURAL_V1_STEPS,
                              log_every=1, seed=0,
                              log_dir=os.path.join(root, "v1_train")))
        torch.cuda.synchronize()
        no_kernel_launches(fk, fl, "NCSN v1 training")
        if state.step != NATURAL_V1_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"NCSN v1 training: step {state.step}, "
                                 f"losses {losses}")
        s_step = float(np.mean(seconds[1:]))
        out["v1_train"] = dict(batch=B, steps=state.step, losses=losses,
                               s_per_step=s_step, images_per_s=B / s_step,
                               first_step_s=seconds[0],
                               peak=torch.cuda.max_memory_allocated())
        del state, step, model
        torch.cuda.empty_cache()

        x1 = torch.rand(2, 32, 32, 3, generator=gen)
        t1 = torch.rand(2, generator=gen) * (sde.T - 1e-5) + 1e-5
        z1 = torch.randn(2, 32, 32, 3, generator=gen)
        results = []
        with float32_exact():
            for dev in (device, "cpu"):
                net = create_model(v1)
                net.load_state_dict(w0)
                net.to(dev)
                st = TrainState.create(net, get_optimizer(v1),
                                       ema_decay=None)
                stp = make_continuous_score_train_step(
                    net, sde, continuous=False,
                    reduce_mean=v1.training.reduce_mean)
                _, loss = stp(st, x1, t=t1.to(dev), z=z1.to(dev))
                results.append((loss.item(), torch.cat([
                    p.grad.reshape(-1).cpu() for p in net.parameters()
                    if p.grad is not None])))
                del net, st, stp
        (loss_card, g_card), (loss_cpu, g_cpu) = results
        step_check = dict(loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu),
                          grad_rel_l2=rel_l2(g_card, g_cpu))
        if not (step_check["loss_rel"] <= MODEL_REL_L2
                and step_check["grad_rel_l2"] <= MODEL_REL_L2):
            raise AssertionError(f"NCSN v1 train step card vs CPU: "
                                 f"{step_check}")
        out["v1_step_card_vs_cpu"] = step_check

        # -- the natural-image discrete configs -------------------------------
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        celeba = load_config("CELEBA")
        rec = {}
        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        with timed_fit(train_ncsn, rec, "end_conv.bias"), warnings_quiet():
            state = train_ncsn.main([
                "--ds_name", "CELEBA", "--device", str(device), "--log_dir",
                os.path.join(root, "celeba"), "--data_root", data_root,
                "--seed", "0", "--override",
                f"training.n_iters={NATURAL_TRAIN_STEPS}"])
        torch.cuda.synchronize()
        no_kernel_launches(fk, fl, "train_ncsn CELEBA")
        if state.step != NATURAL_TRAIN_STEPS or \
                not np.isfinite(rec["losses"]).all():
            raise AssertionError(f"CELEBA training: step {state.step}, "
                                 f"losses {rec['losses']}")
        s_step = float(np.mean(rec["step_s"][1:]))
        B = celeba.training.batch_size
        out["celeba_train"] = dict(
            net=type(state.model).__name__, batch=B, steps=state.step,
            image_size=celeba.data.image_size, s_per_step=s_step,
            images_per_s=B / s_step, first_step_s=rec["step_s"][0],
            first_step_peak=rec["first_peak"],
            steady_peak=torch.cuda.max_memory_allocated(),
            wall_s=time.perf_counter() - t_run, losses=rec["losses"],
            params=sum(p.numel() for p in state.model.parameters()))
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    cifar = load_config("CIFAR10")
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    r = timed_cli(uncond, [
        "--seed", "0", "--device", str(device), "--ds_name", "CIFAR10",
        "--num_samples", str(NATURAL_UNCOND_SAMPLES), "--override",
        f"model.num_classes={NATURAL_UNCOND_LEVELS}"],
        name="ald_unconditional_sampler", metrics=False)
    no_kernel_launches(fk, fl, "unconditioned_sampling CIFAR10")
    samples = r.pop("recons")
    del r["call"]
    if samples.shape != (NATURAL_UNCOND_SAMPLES, 32, 32, 3) or \
            not np.isfinite(samples).all():
        raise AssertionError(f"CIFAR10 samples {samples.shape}")
    r["evals"] = (NATURAL_UNCOND_LEVELS * cifar.sampling.n_steps_each
                  + int(cifar.sampling.denoise))
    r["evals_per_s"] = r["evals"] / r["sampler_s"]
    out["cifar10_sample"] = r
    return out


def report_natural(nt: dict, t: float) -> None:
    ode, tiny = nt["ode"], nt["ode_tiny_card_vs_cpu"]
    v1s, v1t = nt["v1_sample"], nt["v1_train"]
    ce, cs = nt["celeba_train"], nt["cifar10_sample"]
    say("natural", t, f"ODE: pc_sampling --method ode {NATURAL_ODE_CONFIG} "
        f"(full width, seeded), {NATURAL_SAMPLES} samples: printed nfe "
        f"{ode['printed_nfe']} (sde.N), {ode['evals']} score evaluations, "
        f"{ode['steps']} steps ({ode['accepted']} accepted, "
        f"{ode['rejected']} rejected; one host read each), "
        f"{ode['evals_per_s']:.2f} evaluations/s (sampler "
        f"{ode['sampler_s']:.2f} s, wall {ode['wall_s']:.2f} s), peak "
        f"{ode['peak']} bytes, launches {ode['launches']} (per evaluation "
        f"{ode['launches_per_eval']}); a forward at batch "
        f"{NATURAL_SAMPLES} {ode['forward_device_ms']:.2f} ms on the card, "
        f"{ode['forward_host_ms']:.2f} ms to enqueue; the integrator alone "
        f"{ode['integrator_ms_per_step']:.2f} ms a step; K1/K2 at every "
        f"call of a forward "
        f"{nt['ode_kernel_calls']} within {KERNEL_RTOL} rtol (max_abs_err "
        f"{ {n: s['err'] for n, s in nt['ode_kernels'].items()} }); tiny "
        f"ODE card vs CPU {json.dumps(tiny)}. NCSN v1 "
        f"({nt['v1_params']} params): {NATURAL_V1_CONFIG} sampling "
        f"{v1s['evals']} evaluations at {v1s['evals_per_s']:.2f}/s, peak "
        f"{v1s['peak']}, a forward at batch {NATURAL_SAMPLES} "
        f"{v1s['forward_device_ms']:.2f} ms on the card, "
        f"{v1s['forward_host_ms']:.2f} ms to enqueue; forward card vs CPU "
        f"{nt['v1_forward_card_vs_cpu']:.3g}; training batch {v1t['batch']} "
        f"{v1t['s_per_step']:.4f} s/step ({v1t['images_per_s']:.2f} "
        f"images/s), peak {v1t['peak']}, losses "
        f"{[round(v, 2) for v in v1t['losses']]}; step card vs CPU "
        f"{json.dumps(nt['v1_step_card_vs_cpu'])}. train_ncsn CELEBA "
        f"({ce['net']}, {ce['image_size']} px, batch {ce['batch']}) "
        f"{ce['s_per_step']:.4f} s/step ({ce['images_per_s']:.2f} images/s),"
        f" peaks {ce['first_step_peak']} / {ce['steady_peak']}; "
        f"unconditioned_sampling CIFAR10 ({NATURAL_UNCOND_SAMPLES} chains, "
        f"{NATURAL_UNCOND_LEVELS} levels) {cs['evals_per_s']:.2f} "
        f"evaluations/s, peak {cs['peak']}; no K1/K2/K4 launch but the ODE "
        f"path's")


# -- 19. int8: the int8 serving mode on K5-K7 --------------------------------

def bound_int8(bytes_moved: float, ops: float) -> dict:
    """bound() with the operations at the int8 tensor cores' dense rate."""
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT8_OPS_PER_S
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def int8_sites(net, run) -> tuple:
    """Run `run()` once with a pre-hook on every int8 layers.Conv of
    `net`: per distinct geometry (input shape, weight shape, padding,
    dilation, pre-pad, rank) the first input seen, its conv and the number
    of calls; and the number of conv calls in all."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.layers import Conv
    sites, calls = {}, [0]

    def hook(m, args):
        x = args[0]
        key = (tuple(x.shape), tuple(m.quant.codes.shape), m.padding,
               m.dilation, m.pre_pad, m.ndim)
        calls[0] += 1
        if key in sites:
            sites[key]["count"] += 1
        else:
            sites[key] = dict(conv=m, x=x, count=1)

    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, Conv) and m.quant is not None]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in handles:
            h.remove()
    return sites, calls[0]


def int_mm_fns(codes4, qw, g):
    """The yardstick F.unfold + torch._int_mm (cuBLASLt int8) at K7's
    geometry: (unfold and GEMM, the GEMM alone on a prepared A, its int32
    sums (N, O, Ho, Wo)), or None where A would exceed
    INT8_INT_MM_MAX_BYTES or the padding is not symmetric."""
    K = g.KH * g.KW * g.Cp
    M = g.N * g.Ho * g.Wo
    if M * K > INT8_INT_MM_MAX_BYTES or (g.pad_h, g.pad_w) != (
            g.pad_h_hi, g.pad_w_hi):
        return None
    xf = codes4.permute(0, 3, 1, 2).to(torch.bfloat16)   # codes are exact
    o8 = -(-g.O // 8) * 8
    b = torch.zeros(o8, K, dtype=torch.int8, device=codes4.device)
    b[:g.O] = qw.kernel.permute(0, 3, 1, 2).reshape(g.O, K)
    bt = b.t()

    def a_of():
        cols = F.unfold(xf, (g.KH, g.KW), dilation=g.dil,
                        padding=(g.pad_h, g.pad_w))
        return cols.transpose(1, 2).reshape(M, K).to(torch.int8)

    a = a_of()
    sums = torch._int_mm(a, bt)[:, :g.O].reshape(
        g.N, g.Ho * g.Wo, g.O).permute(0, 2, 1).reshape(
            g.N, g.O, g.Ho, g.Wo)
    return (lambda: torch._int_mm(a_of(), bt),
            lambda: torch._int_mm(a, bt), sums)


def int8_site_numbers(ik, quant, site) -> dict:
    """K5, K6 and K7 at one convolution of a forward, on its real input:
    each against its plain version bit for bit (the elements that differ
    counted: amax, scale, codes, int32 sums, dequantized output), K7's
    plan (int8_kernels.conv_plan: instance, channel block, ring, K stages,
    epilogue run) beside it, timed
    device-only (graph_ms) beside the plain version (CUDA events around
    the checking call) and the yardsticks: max |x| by
    torch.linalg.vector_norm (K5), cuDNN's bf16 convolution of the same
    shape and F.unfold + torch._int_mm (K7). Device-only times are
    graph_ms of 5 calls replayed twice (the phase times 29 geometries of
    ms-scale calls: 20 x 5 would cost half a minute more)."""
    m, x = site["conv"], site["x"]
    qw = m.quant
    g = quant.geometry(x, qw, m.padding, m.dilation, m.ndim, m.pre_pad)
    ev = lambda: (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def events_ms(fn):
        s, e = ev()
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        return out, s.elapsed_time(e)

    amax = ik.absmax(x)
    amax_p, k5_plain_ms = events_ms(lambda: ik.absmax_plain(x))
    codes, sx = ik.quantize_s8(x, amax, g.Cp)
    (codes_p, sx_p), k6_plain_ms = events_ms(
        lambda: ik.quantize_s8_plain(x, amax_p, g.Cp))
    codes4 = codes.reshape(g.N, g.H, g.W, g.Cp)
    out, sums = ik.conv_s8s8s32(codes4, sx, qw.kernel, qw.scale, g, x.dtype,
                                with_sums=True)
    (out_p, sums_p), k7_plain_ms = events_ms(
        lambda: ik.conv_s8s8s32_plain(codes_p.reshape(codes4.shape), sx_p,
                                      qw.kernel, qw.scale, g, x.dtype,
                                      with_sums=True))
    errs = dict(k5=(amax - amax_p).abs().max().item(),
                k6=(codes.int() - codes_p.int()).abs().max().item(),
                k7=(out.float() - out_p.float()).abs().max().item())
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    differ = dict(
        absmax=int((amax != amax_p).sum()), scale=int((sx != sx_p).sum()),
        codes=int((codes != codes_p).sum()),
        sums=int((sums != sums_p).sum()),
        out=int((out.view(bits) != out_p.view(bits)).sum()))
    w = m.weight
    pad = (lambda v: F.pad(v, tuple(m.pre_pad) * m.ndim)) if m.pre_pad \
        else (lambda v: v)
    conv = F.conv1d if m.ndim == 1 else F.conv2d
    cudnn = lambda: conv(pad(x), w, None, 1, m.padding, m.dilation)
    dev_ms = lambda fn: graph_ms(fn, reps=5, replays=2)
    int_mm = int_mm_fns(codes4, qw, g)
    plan = ik.conv_plan(g)
    row = dict(
        N=g.N, C=g.C, H=g.H, W=g.W, O=g.O, k=g.KW, dil=g.dil, ndim=m.ndim,
        count=site["count"], differ=differ, err=errs,
        plan=dict(bn=plan.bn, cb=plan.cb, stages=plan.stages,
                  k_iters=plan.k_iters, run=plan.run),
        k5=dict(ms=dev_ms(lambda: ik.absmax(x)), plain_ms=k5_plain_ms,
                library_ms=dev_ms(lambda: torch.linalg.vector_norm(
                    x, float("inf"))),
                **bound(x.numel() * x.element_size(), x.numel())),
        k6=dict(ms=dev_ms(lambda: ik.quantize_s8(x, amax, g.Cp)),
                plain_ms=k6_plain_ms, library_ms=None,
                **bound(x.numel() * (x.element_size() + 1), 3 * x.numel())),
        k7=dict(ms=dev_ms(lambda: ik.conv_s8s8s32(
            codes4, sx, qw.kernel, qw.scale, g, x.dtype)),
            plain_ms=k7_plain_ms, library_ms=dev_ms(cudnn),
            int_mm_ms=None, int_mm_gemm_ms=None, ops=g.ops(),
            **bound_int8(g.N * g.H * g.W * g.C + g.O * g.C * g.KH * g.KW
                         + g.N * g.O * g.Ho * g.Wo * x.element_size(),
                         g.ops())))
    if int_mm is not None:
        full, gemm, mm_sums = int_mm
        if not torch.equal(mm_sums, sums):
            raise AssertionError(f"int8 yardstick _int_mm at {row}: other "
                                 "sums than K7's")
        row["k7"]["int_mm_ms"] = events_ms(full)[1]   # warmed in int_mm_fns
        row["k7"]["int_mm_gemm_ms"] = dev_ms(gemm)
    if any(differ.values()):
        raise AssertionError(f"int8 kernels differ from their plain versions "
                             f"at C={g.C} H={g.H} W={g.W} O={g.O} k={g.KW} "
                             f"dil={g.dil} ndim={m.ndim}: {differ}")
    return row


def int8_forward_table(ik, quant, net, run, what: str) -> dict:
    """Every convolution geometry of one forward `run()` of the int8 `net`:
    the rows of int8_site_numbers and their sums per forward (each row
    times its calls)."""
    sites, calls = int8_sites(net, run)
    with torch.inference_mode():
        rows = [int8_site_numbers(ik, quant, s) for s in sites.values()]
    per = {}
    for tag in ("k5", "k6", "k7"):
        tot = {key: sum(r["count"] * (r[tag][key] or 0.0) for r in rows)
               for key in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                           "ops_ms")}
        lib = [r[tag]["library_ms"] for r in rows]
        tot["library_ms"] = (None if None in lib else sum(
            r["count"] * r[tag]["library_ms"] for r in rows))
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        tot["err"] = max(r["err"][tag] for r in rows)
        per[tag] = tot
    mm = [r["k7"]["int_mm_ms"] for r in rows]
    per["k7"]["int_mm_ms"] = (None if None in mm else sum(
        r["count"] * r["k7"]["int_mm_ms"] for r in rows))
    per["k7"]["int_mm_gemm_ms"] = (None if None in mm else sum(
        r["count"] * r["k7"]["int_mm_gemm_ms"] for r in rows))
    per["k7"]["ops"] = sum(r["count"] * r["k7"]["ops"] for r in rows)
    for r in rows:
        print(f"    {what} C={r['C']} {r['H']}x{r['W']} O={r['O']} k={r['k']} "
              f"dil={r['dil']} x{r['count']} (plan {r['plan']}): K7 "
              f"{r['k7']['ms']:.4f} ms "
              f"(bound {r['k7']['bound_ms']:.4f}, {r['k7']['bound_by']}), "
              f"cuDNN bf16 {r['k7']['library_ms']:.4f}, unfold+_int_mm "
              f"{r['k7']['int_mm_ms']}, _int_mm alone "
              f"{r['k7']['int_mm_gemm_ms']}, plain {r['k7']['plain_ms']:.2f}; "
              f"K5 {r['k5']['ms']:.4f} (bound {r['k5']['bound_ms']:.4f}); "
              f"K6 {r['k6']['ms']:.4f} (bound {r['k6']['bound_ms']:.4f}); "
              f"differ {r['differ']}", flush=True)
    return dict(convs_per_forward=calls, geometries=len(rows), rows=rows,
                per_forward=per)


def same_float(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, or both NaN (whose bits may differ: the card's NaN is
    not torch's CPU one)."""
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def int8_edge_checks(ik, quant, device="cuda", k5_profile=None) -> dict:
    """K5-K7 on inputs a forward does not give them, each against the
    plain versions on the same input: raises on the first that differs.
    - Non-finite: a NaN, a +inf, a -inf, or all three in x, at
      INT8_EDGE_CASES in float32 and bf16: amax and scale equal (NaN to
      NaN), the codes equal, K7's output and the whole quant.int8_conv NaN
      and non-finite where the plain chain's is (everywhere); K5 alone at
      the largest NCSNv2Deepest input (batch 32, 128 x 256 x 256, bf16)
      with a NaN in the last block, then an inf.
    - Tiny and misaligned: K5 at INT8_TINY elements, x starting
      INT8_OFFSETS bytes past a 16-byte boundary, with the largest value
      and then a NaN in the head and in the tail, bit for bit.
    - Repeated: two calls in a row on different tensors, each right, and
      the ticket back at 0 after each; the same two captured in a CUDA
      graph and replayed twice.
    - One kernel a call: torch.profiler's device events of one call, in a
      process of its own (k5_kernels_of_one_call; `k5_profile`, where
      given, is that process, started earlier)."""
    gen = torch.Generator().manual_seed(0)
    f32, bf = torch.float32, torch.bfloat16
    rows, checked = [], 0
    for case in INT8_EDGE_CASES:
        N, C, spatial, O, k, dil, pre, ndim = case
        for dtype in (f32, bf):
            for kind, values in INT8_NON_FINITE.items():
                x = torch.randn((N, C) + spatial, generator=gen) * 3
                w = torch.randn((O, C) + (k,) * ndim, generator=gen)
                at = torch.randperm(x.numel(), generator=gen)[:len(values)]
                x.view(-1)[at] = torch.tensor(values)
                x, w = x.to(device, dtype), w.to(device, dtype)
                qw = quant.QuantWeight.of(w)
                g = quant.geometry(x, qw, (k // 2) * dil, dil, ndim, pre)
                amax = ik.absmax(x)
                codes, sx = ik.quantize_s8(x, amax, g.Cp)
                codes = codes.reshape(g.N, g.H, g.W, g.Cp)
                y = ik.conv_s8s8s32(codes, sx, qw.kernel, qw.scale, g, dtype)
                amax_p = ik.absmax_plain(x)
                codes_p, sx_p = ik.quantize_s8_plain(x, amax_p, g.Cp)
                y_p = ik.conv_s8s8s32_plain(codes_p.reshape(codes.shape),
                                            sx_p, qw.kernel, qw.scale, g,
                                            dtype)
                whole = quant.int8_conv(x, qw, padding=(k // 2) * dil,
                                        dilation=dil, ndim=ndim, pre_pad=pre)
                row = dict(
                    geometry=f"{N}x{C}x{spatial} O={O} k={k}",
                    dtype=str(dtype), kind=kind, amax=amax.item(),
                    amax_plain=amax_p.item(), scale=sx.item(),
                    codes_differ=int((codes != codes_p.reshape(
                        codes.shape)).sum()),
                    nan_differ=int((y.isnan() != y_p.isnan()).sum()),
                    finite_differ=int((y.isfinite() != y_p.isfinite())
                                      .sum()),
                    whole_nan_differ=int((whole.isnan() != y_p.reshape(
                        whole.shape).isnan()).sum()),
                    all_nan=bool(y.isnan().all()))
                rows.append(row)
                if not (same_float(amax, amax_p) and same_float(sx, sx_p)
                        and row["codes_differ"] == row["nan_differ"]
                        == row["finite_differ"] == row["whole_nan_differ"]
                        == 0 and row["all_nan"]):
                    raise AssertionError(f"int8 chain on non-finite input "
                                         f"differs from the plain chain: "
                                         f"{row}")
    big = torch.randn(32 * 128 * 256 * 256, device=device, dtype=bf)
    for value in (math.nan, math.inf):
        big[-3] = value
        got = ik.absmax(big)
        if not same_float(got, ik.absmax_plain(big)):
            raise AssertionError(f"K5 at {big.numel()} elements with "
                                 f"{value} in the last block: {got.item()}")
        rows.append(dict(kind=f"{value} at {big.numel()} bf16 elements",
                         amax=got.item()))
    del big
    for dtype in (f32, bf):
        size = torch.finfo(dtype).bits // 8
        for n in INT8_TINY:
            buf = torch.randn(n + 16, generator=gen).to(device, dtype)
            for off in INT8_OFFSETS:
                if off % size:
                    continue
                x = buf[off // size:off // size + n]
                if x.data_ptr() % 16 != off:
                    raise AssertionError(f"offset {off}: {x.data_ptr()}")
                for at, value in ((0, None), (0, 1e4), (n - 1, -1e4),
                                  (0, math.nan), (n - 1, math.nan)):
                    saved = x[at].clone()
                    if value is not None:
                        x[at] = value
                    got, ref = ik.absmax(x), ik.absmax_plain(x)
                    if not same_float(got, ref):
                        raise AssertionError(
                            f"K5 at {n} {dtype} elements, offset {off}, "
                            f"{value} at {at}: {got.item()} vs {ref.item()}")
                    x[at] = saved
                    checked += 1
    # two calls in a row; the ticket back at 0; in a graph, replayed
    a = torch.randn(40 * 2 ** 20, generator=gen).to(device, bf)
    b = torch.randn(3 * 2 ** 20 + 7, generator=gen).to(device, f32) * 0.5
    scratch = ik._ABSMAX_DEVICE[a.get_device()][1]
    tickets = []
    for t in (a, b, a):
        got = ik.absmax(t)
        tickets.append(int(scratch[0].item()))
        if not same_float(got, ik.absmax_plain(t)):
            raise AssertionError(f"K5 repeated: {got.item()} vs "
                                 f"{ik.absmax_plain(t).item()}")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ga, gb = ik.absmax(a), ik.absmax(b)
    for _ in range(2):
        ga.zero_()
        gb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not (same_float(ga, ik.absmax_plain(a))
                and same_float(gb, ik.absmax_plain(b))):
            raise AssertionError(f"K5 in a replayed graph: {ga.item()}, "
                                 f"{gb.item()}")
    tickets.append(int(scratch[0].item()))
    if any(tickets):
        raise AssertionError(f"K5 left its ticket at {tickets}")
    kernels = k5_kernels_of_one_call(k5_profile)
    if len(kernels) != 1 or "absmax" not in kernels[0]:
        raise AssertionError(f"one K5 call ran {kernels} on the card")
    return dict(non_finite=rows, tiny_checks=checked, tickets=tickets,
                kernels_per_call=len(kernels), kernel=kernels[0])


K5_PROFILED = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from inverseproblemwithdiffusionmodel_tpu_torch.ops import int8_kernels as ik
x = torch.randn(40 * 2 ** 20, device="cuda", dtype=torch.bfloat16)
ik.absmax(x)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    ik.absmax(x)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in p.events() if e.device_type.name == "CUDA"]))
"""


def k5_profile_start() -> subprocess.Popen:
    """Start the process that profiles one K5 call (K5_PROFILED): a
    process of its own, since in a process that has run profiler sessions
    before, a new session can record no device events at all (read in the
    whole smoke, where the recon and cine phases profile first). main()
    starts it after the build, so that it runs beside the early phases;
    it is killed at exit if still running."""
    proc = subprocess.Popen([sys.executable, "-c", K5_PROFILED],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    atexit.register(proc.kill)
    return proc


def k5_kernels_of_one_call(proc=None) -> list:
    """The names of the CUDA kernels one K5 call runs, read from the
    profiling process `proc` (started here where None)."""
    proc = proc or k5_profile_start()
    out, err = proc.communicate()
    if proc.returncode:
        raise AssertionError(f"the K5 profiling process exited "
                             f"{proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def int8_sigmas(cfg) -> torch.Tensor:
    """The int8 phase's ladder: ACDC_LEVELS of the config's, geometric."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    return torch.as_tensor(np.asarray(sigma_ladder(
        cfg.model.sigma_begin, cfg.model.sigma_end, ACDC_LEVELS,
        "geometric")), dtype=torch.float32)


def int8_cpu_reference() -> tuple:
    """The CPU's int8 score (the plain K5-K7) of one chain (Re, Im) at the
    first and the last level, on a thread of its own (Background): main()
    starts it before the guided phase, so that it runs beside the card's
    work of two phases; int8_phase holds the card's int8 score to it.
    Returns the input x2, its levels l2 and the Background."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        make_score_fn)
    cfg, model_cpu = acdc_model()
    sigmas = int8_sigmas(cfg)
    size = cfg.data.image_size
    x2 = torch.rand(2, size, size, 1,
                    generator=torch.Generator().manual_seed(1))
    l2 = torch.tensor([0, ACDC_LEVELS - 1])

    def score():
        with torch.inference_mode():
            return make_score_fn(model_cpu, sigmas, "int8")(x2, l2)

    return x2, l2, Background(score)


def int8_phase(fk, fl, ik, serve_bf16, cine_bf16, device="cuda",
               cpu_ref=None, k5_profile=None) -> dict:
    """The int8 serving mode at full width (ops/quant.py, K5-K7 of
    ops/csrc/int8conv.cu). K5/K6/K7 against their plain versions bit for
    bit at every convolution geometry of one NCSNv2Deepest forward (256
    px, ngf 128, seed 0) at batch 32 (acdc_problem's 16 chains x (Re, Im))
    and of one NCSN1D forward (CINE127_1D, ngf 128) at the cine engine's
    tube batch, each timed device-only beside its bound and yardsticks,
    and summed per forward. The int8 score at the first and last level
    against float32 (float32 mode) and bf16 on the same weights and input
    (gate INT8_VS_F32; not equal to bf16); its launches per forward; the
    batch-32 forward's device ms in int8, bf16 and f32; one chain (batch
    2) card against CPU, the CPU side `cpu_ref` (int8_cpu_reference, made
    here where None; main() starts it two phases ahead). Then the main
    path:
    serve_recon.build_engine --dtype int8 at acdc_problem's geometry,
    SERVE_LEVELS levels (warm-up, 3 requests over HTTP, 1 in-process),
    beside the serve phase's bf16 engine of the same geometry and depth
    in this run (`serve_bf16`, its numbers), a seg-guided int8 engine (1
    request), --workload cine --dtype int8 at the cine phase's geometry
    (warm-up, 1 request over HTTP, 1 in-process; beside the cine phase's
    bf16 chain-steps/s, `cine_bf16`), with the launch counts cleared
    before and read after: K5-K7 launched, K1, K2 and K4 not. Last
    int8_edge_checks, `k5_profile` its profiling process (started where
    None)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import NCSN1D
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        load_model, make_score_fn, to_nchw)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import quant
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
        ReconstructionEngine)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.profiling import (
        timed)
    numbers = {}
    # one chain (Re, Im) at the first and last level: the CPU's int8 score
    # on a thread of its own while the card works
    x2, l2, worker = cpu_ref or int8_cpu_reference()
    cfg, model = acdc_model()
    model = model.to(device)
    sigmas = int8_sigmas(cfg)
    size = cfg.data.image_size
    gen = torch.Generator().manual_seed(0)
    nb = 2 * ACDC_CHAINS
    xb = torch.rand(nb, size, size, 1, generator=gen).to(device)
    lb = (torch.arange(nb) % ACDC_LEVELS).to(device)
    bf = torch.bfloat16

    # K5-K7 at every geometry of one full-width forward of each net
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    net = quant.enable_int8(copy.deepcopy(model).to(bf))
    sig_bf = sigmas.to(device, bf)
    numbers["ncsnv2"] = int8_forward_table(
        ik, quant, net, lambda: net(to_nchw(xb).to(bf), sig_bf[lb]),
        "ncsnv2 b32")
    ik.LAUNCHES.clear()
    with torch.inference_mode():
        net(to_nchw(xb).to(bf), sig_bf[lb])
    torch.cuda.synchronize()
    n = numbers["ncsnv2"]
    n["launches_per_forward"] = dict(ik.LAUNCHES)
    if n["launches_per_forward"] != {tag: n["convs_per_forward"]
                                     for tag in INT8_TAGS}:
        raise AssertionError(f"int8 forward launched "
                             f"{n['launches_per_forward']}, expected "
                             f"{n['convs_per_forward']} of each")
    del net
    cfg_t = load_config("CINE127_1D", "real-imag")
    net_t = quant.enable_int8(
        seeded_weights(NCSN1D(cfg_t), seed=0).to(device, bf))
    tubes = 2 * CINE_CHAINS * (128 // CINE_WIN) ** 2
    xt = torch.randn(tubes, cfg_t.data.channels, cfg_t.data.image_size,
                     generator=gen).to(device, bf)
    st = torch.full((tubes,), 0.5, device=device, dtype=bf)
    numbers["ncsn1d"] = int8_forward_table(ik, quant, net_t,
                                           lambda: net_t(xt, st),
                                           f"ncsn1d b{tubes}")
    del net_t
    torch.cuda.empty_cache()

    # the net: int8 vs f32 and bf16 at the first and last level, batch 2
    with torch.inference_mode():
        with float32_exact():
            f32 = make_score_fn(model, sigmas)(x2.to(device), l2.to(device))
        b16 = make_score_fn(model, sigmas, bf)(x2.to(device), l2.to(device))
        q8 = make_score_fn(model, sigmas, "int8")(x2.to(device),
                                                   l2.to(device))
        torch.cuda.synchronize()
    q8_cpu, cpu_s = worker.result(), worker.seconds
    net_checks = dict(
        int8_vs_f32=rel_l2(q8.cpu(), f32.cpu()),
        bf16_vs_f32=rel_l2(b16.cpu(), f32.cpu()),
        int8_vs_bf16=rel_l2(q8.cpu(), b16.cpu()),
        int8_card_vs_cpu=rel_l2(q8.cpu(), q8_cpu),
        cpu_int8_vs_f32=rel_l2(q8_cpu, f32.cpu()),
        cpu_s=cpu_s)
    numbers["net"] = net_checks
    if not (torch.isfinite(q8).all() and q8.dtype == torch.float32
            and net_checks["int8_vs_f32"] <= INT8_VS_F32
            and not torch.equal(q8, b16)
            and net_checks["int8_card_vs_cpu"] <= INT8_VS_F32):
        raise AssertionError(f"int8 score: {net_checks}")
    # the batch-32 forward in each mode, device ms
    fwd = {}
    with torch.inference_mode():
        for name, dtype in (("f32", None), ("bf16", bf), ("int8", "int8")):
            score = make_score_fn(model, sigmas, dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = timed(score, xb, lb, warmup=1, iters=3)
            fwd[name] = dict(ms=1e3 * t["mean_s"], best_ms=1e3 * t["best_s"],
                             peak=torch.cuda.max_memory_allocated())
            del score, t
    numbers["forward_b32"] = fwd
    del model
    torch.cuda.empty_cache()

    # the main path: the int8 engines, counts cleared just before
    lin_tfm, proximal, sig_s, yr, yi = acdc_problem(cfg, device,
                                                    SERVE_LEVELS)
    y_re, y_im = (v[:, 0].cpu().numpy() for v in (yr, yi))
    mask1 = generate_mask(1, size, seed=1, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, 10 + i)
                     for i in range(ACDC_COILS)])
    maps = (maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True)))[..., None]
    requests = [("seed=0", dict(y_re=y_re, y_im=y_im)),
                ("seed=1&lr_scaled=3.0", dict(y_re=y_re, y_im=y_im,
                                              mask=mask1)),
                ("seed=2", dict(y_re=y_re, y_im=y_im, sens_re=maps))]
    chain_steps = SERVE_LEVELS * cfg.sampling.n_steps_each * ACDC_CHAINS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in (ik.LAUNCHES, fk.LAUNCHES, fl.LAUNCHES):
        counter.clear()
    t_build = time.perf_counter()
    eng = serve_recon.build_engine(serve_recon.parse_args(serve_argv("int8")))
    build_s = time.perf_counter() - t_build
    warmup_s = eng.warmup()
    served = serve_requests(eng, requests, chain_steps)
    res = eng.reconstruct(y_re, y_im, seed=3)
    if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
        raise AssertionError("int8 engine: in-process request not finite")
    engines = dict(
        bf16=serve_bf16,
        int8=dict(build_s=build_s, warmup_s=warmup_s, **served,
                  in_process=dict(latency_s=res.latency_s,
                                  chain_steps_per_s=res.chain_steps_per_s),
                  peak=torch.cuda.max_memory_allocated()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seg_cpu, _ = load_model(None, "Seg", seed=0)
    spec = dataclasses.replace(eng.spec, seg_lamda=1.0, seg_start_time=0.0)
    guided = ReconstructionEngine(
        eng.model, eng.sigmas, spec=spec,
        mask=eng.default_lin_tfm.mask.cpu().numpy(),
        sens_re=eng.default_lin_tfm.sens_re.cpu().numpy(),
        seg_model=seg_cpu, device=device)
    res = guided.reconstruct(y_re, y_im, seed=3, seg_label=disk_label(size))
    if not np.isfinite(res.x_re).all():
        raise AssertionError("guided int8 engine: not finite")
    engines["guided_int8"] = dict(
        in_process=dict(latency_s=res.latency_s,
                        chain_steps_per_s=res.chain_steps_per_s),
        peak=torch.cuda.max_memory_allocated())
    del guided, seg_cpu, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cine_cfg = load_config("CINE127", "real-imag")
    _, _, yc_re, yc_im = cine_problem(cine_cfg.data.image_size, CINE_FRAMES)
    eng = serve_recon.build_engine(serve_recon.parse_args(cine_argv("int8")))
    warmup_s = eng.warmup()
    cine_steps = CINE_SERVE_LEVELS * cine_cfg.sampling.n_steps_each \
        * CINE_CHAINS
    served = serve_requests(eng, [("seed=0", dict(y_re=yc_re, y_im=yc_im))],
                            cine_steps)
    res = eng.reconstruct(yc_re, yc_im, seed=3, lamda_T=CINE_LAMDA_T)
    torch.cuda.synchronize()
    if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
        raise AssertionError("cine int8 engine: in-process request not "
                             "finite")
    engines["cine_int8"] = dict(
        warmup_s=warmup_s, **served,
        in_process=dict(latency_s=res.latency_s,
                        chain_steps_per_s=res.chain_steps_per_s),
        peak=torch.cuda.max_memory_allocated(),
        bf16_chain_steps_per_s=cine_bf16)
    del eng
    launches = dict(ik.LAUNCHES)
    fir = {**fk.LAUNCHES, **fl.LAUNCHES}
    numbers["engines"] = engines
    numbers["launches"] = launches
    per_fwd = numbers["ncsnv2"]["convs_per_forward"]
    if (any(fir.values()) or sorted(launches) != sorted(INT8_TAGS)
            or min(launches.values()) <= 0):
        raise AssertionError(f"int8 engines launched {launches} of K5-K7 "
                             f"and {fir} of K1/K2/K4")
    # K5-K7 on inputs a forward does not give them, after the counts
    numbers["edges"] = int8_edge_checks(ik, quant, device, k5_profile)
    numbers["reduced"] = (f"ACDC {SERVE_LEVELS} of 2311 levels; cine "
                          f"{CINE_SERVE_LEVELS} of 1000 levels, "
                          f"{CINE_CHAINS} chains")
    numbers["ncsnv2_convs_per_forward"] = per_fwd
    torch.cuda.empty_cache()
    return numbers


def report_int8(q: dict, t: float) -> None:
    for name in ("ncsnv2", "ncsn1d"):
        n = q[name]
        for tag, label in (("k5", "K5 absmax"), ("k6", "K6 quantize_s8"),
                           ("k7", "K7 conv_s8s8s32")):
            p = n["per_forward"][tag]
            extra = (f", cuDNN bf16 {p['library_ms']:.4f}, unfold+_int_mm "
                     f"{p['int_mm_ms']}, _int_mm alone {p['int_mm_gemm_ms']}"
                     f", {p['ops'] / p['ms'] / 1e9:.1f} TOP/s"
                     if tag == "k7" else
                     f", library {p['library_ms']}")
            print(f"    {name}: {label} per forward ({n['convs_per_forward']} "
                  f"convolutions, {n['geometries']} geometries): "
                  f"{p['ms']:.4f} ms, bound {p['bound_ms']:.4f} "
                  f"({p['bound_by']}, {p['bound_ms'] / p['ms']:.3f} of it), "
                  f"plain {p['plain_ms']:.2f}{extra}", flush=True)
    e = q["engines"]
    for name in ("bf16", "int8"):
        r = e[name]
        http = ", ".join(f"{x['query']}: {x['chain_steps_per_s']:.2f}"
                         for x in r["requests"])
        print(f"    engine {name}{' (the serve phase)' * (name == 'bf16')}: "
              f"build {r['build_s']:.2f} s, warm-up {r['warmup_s']:.2f} s; "
              f"chain-steps/s over HTTP {http}; in-process "
              f"{r['in_process']['chain_steps_per_s']:.2f}; peak {r['peak']} "
              f"bytes", flush=True)
    fw = q["forward_b32"]
    say("int8", t, f"K5-K7 equal their plain versions bit for bit at all "
        f"{q['ncsnv2']['geometries']} NCSNv2Deepest geometries (batch 32) "
        f"and {q['ncsn1d']['geometries']} NCSN1D ones; K7 launches per "
        f"forward {q['ncsnv2']['launches_per_forward']} = the "
        f"{q['ncsnv2']['convs_per_forward']} convolutions; forward at batch "
        f"32: int8 {fw['int8']['ms']:.2f} ms, bf16 {fw['bf16']['ms']:.2f}, "
        f"f32 {fw['f32']['ms']:.2f}; the net (batch 2, first and last level) "
        f"{json.dumps(q['net'])} (int8 vs f32 <= {INT8_VS_F32}); engines "
        f"in-process chain-steps/s: bf16 "
        f"{e['bf16']['in_process']['chain_steps_per_s']:.2f}, int8 "
        f"{e['int8']['in_process']['chain_steps_per_s']:.2f}, guided int8 "
        f"{e['guided_int8']['in_process']['chain_steps_per_s']:.2f}, cine "
        f"int8 {e['cine_int8']['in_process']['chain_steps_per_s']:.2f} "
        f"(cine bf16 {e['cine_int8']['bf16_chain_steps_per_s']:.2f}); "
        f"reduced: {q['reduced']}; launches {q['launches']}; no K1/K2/K4 "
        f"launch; K5-K7 on non-finite inputs as the plain chain "
        f"({len(q['edges']['non_finite'])} cases), K5 bit for bit at "
        f"{q['edges']['tiny_checks']} tiny or misaligned inputs, tickets "
        f"{q['edges']['tickets']}, {q['edges']['kernels_per_call']} kernel "
        f"a call ({q['edges']['kernel']})")


def int8_ncsn3d_numbers(ik, device="cuda") -> dict:
    """The int8 score of the 3-D temporal prior (Diffusion3D's
    NCSN3DShallow on CINE127_1D, ngf 128, seed 0), whose rank-3
    convolutions K7 does not take. At batch 2 (tubes) every call of the
    unfold path (ops/quant.int8_conv_unfold: K5, K6, unfold,
    torch._int_mm) is held bit for bit to int8_conv_plain on the CPU. At
    the cine CLI's INT8_3D_TUBES tubes: the first call of each geometry
    held bit for bit to int8_conv_plain on the card (its float64
    convolution, cuDNN off: exact), which covers the block split of the
    unfold rows (UNFOLD_BYTES) and _int_mm's padding at the sizes the
    forward gives them; the launches of one forward (the counts cleared
    before it), the unfold path's device ms within one forward (CUDA
    events around each call), the int8 and bf16 forwards' device ms, and
    int8 against bf16 (a reading)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import quant
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    cfg = load_config("CINE127_1D", "real-imag")
    net, _ = registry.load_model(cfg, "Diffusion3D", seed=0)
    net = net.to(device).eval()
    T, kk = cfg.data.image_size, cfg.data.channels
    sigmas = get_sigmas(cfg, "recons")
    score8 = registry.make_score_fn(net, sigmas, "int8")
    score16 = registry.make_score_fn(net, sigmas, torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    inner = quant.int8_conv_unfold
    calls, events, big = [], [], {}

    def key(x, qw, kw):
        return (tuple(x.shape[1:]), tuple(qw.codes.shape), kw["stride"],
                kw["dilation"], kw["padding"], kw["pre_pad"])

    def recorded(x, qw, **kw):
        out = inner(x, qw, **kw)
        calls.append((x.detach().cpu(), qw.to("cpu"), kw,
                      out.detach().cpu()))
        return out

    def sampled(x, qw, **kw):
        out = inner(x, qw, **kw)
        big.setdefault(key(x, qw, kw), (x.detach().clone(), qw, kw,
                                        out.detach().clone()))
        return out

    def timed(x, qw, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(x, qw, **kw)
        b.record()
        events.append((a, b))
        return out

    x2 = torch.rand(2, T, kk, generator=gen).to(device)
    xb = torch.rand(INT8_3D_TUBES, T, kk, generator=gen).to(device)
    lab2 = torch.tensor([0, 5], device=device)
    labb = torch.full((INT8_3D_TUBES,), 5, device=device)
    try:
        quant.int8_conv_unfold = recorded
        with torch.inference_mode():
            score8(x2, lab2)
        quant.int8_conv_unfold = sampled
        ik.LAUNCHES.clear()
        with torch.inference_mode():
            out8 = score8(xb, labb)
            torch.cuda.synchronize()
            launches = dict(ik.LAUNCHES)
            quant.int8_conv_unfold = timed
            score8(xb, labb)
            torch.cuda.synchronize()
            quant.int8_conv_unfold = inner
            unfold_ms = sum(a.elapsed_time(b) for a, b in events)
            ms8 = cuda_ms(lambda: score8(xb, labb), reps=2, warmup=0)
            out16 = score16(xb, labb)
            ms16 = cuda_ms(lambda: score16(xb, labb), reps=2, warmup=0)
    finally:
        quant.int8_conv_unfold = inner
    geometries, differ = set(), 0
    for x, qw, kw, out in calls:
        geometries.add(key(x, qw, kw))
        want = quant.int8_conv_plain(x, qw, **kw)
        differ += int((out.float().view(torch.int32)
                       != want.float().view(torch.int32)).sum())
    convs = len(events)
    if differ or not calls:
        raise AssertionError(f"int8 NCSN3D: the unfold path differs from "
                             f"int8_conv_plain in {differ} elements over "
                             f"{len(calls)} calls")
    # the INT8_3D_TUBES calls, one a geometry, on the card
    t_big, differ_big, rows = time.perf_counter(), 0, {}
    with torch.inference_mode():
        for g, (x, qw, kw, out) in big.items():
            want = quant.int8_conv_plain(x, qw, **kw)
            differ_big += int((out.float().view(torch.int32)
                               != want.float().view(torch.int32)).sum())
            # the unfold path's im2col bytes and its blocks of samples
            lo, hi = quant._pads(kw["padding"], kw["pre_pad"])
            k = qw.codes.shape[2:]
            per = math.prod(k) * -(-x.shape[1] // ik.CHANNEL_ALIGN) * (
                ik.CHANNEL_ALIGN) * math.prod(
                (n + lo + hi - kw["dilation"] * (kk - 1) - 1)
                // kw["stride"] + 1 for n, kk in zip(x.shape[2:], k))
            rows[str(g)] = [x.shape[0] * per, -(-x.shape[0] // max(
                1, quant.UNFOLD_BYTES // per))]
            del want
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t_big
    if differ_big or set(big) != geometries:
        raise AssertionError(f"int8 NCSN3D at {INT8_3D_TUBES} tubes: the "
                             f"unfold path differs from int8_conv_plain in "
                             f"{differ_big} elements over {len(big)} "
                             f"geometries (batch 2 had {len(geometries)})")
    big.clear()
    if launches != {"absmax": convs, "quantize_s8": convs} or not \
            torch.isfinite(out8).all():
        raise AssertionError(f"int8 NCSN3D forward: launches {launches} "
                             f"for {convs} unfold convolutions, finite "
                             f"{bool(torch.isfinite(out8).all())}")
    return dict(calls_checked=len(calls), geometries=len(geometries),
                differ=differ, tubes=INT8_3D_TUBES, convs_per_forward=convs,
                tubes_checked=len(rows), tubes_differ=differ_big,
                tubes_check_s=big_s, unfold_bytes=quant.UNFOLD_BYTES,
                im2col_bytes=rows,
                launches_per_forward=launches, int8_ms=ms8, bf16_ms=ms16,
                unfold_ms=unfold_ms, unfold_share=unfold_ms / ms8,
                int8_vs_bf16_rel_l2=rel_l2(out8.float(), out16.float()),
                params=sum(p.numel() for p in net.parameters()))


def report_int8_ncsn3d(n: dict, t: float) -> None:
    say("int8_ncsn3d", t, f"NCSN3DShallow ({n['params']} params) in int8: "
        f"the unfold path (K5, K6, unfold, torch._int_mm) bit for bit "
        f"int8_conv_plain at all {n['geometries']} geometries K7 refuses "
        f"({n['calls_checked']} calls at batch 2, {n['differ']} elements "
        f"differ) and at {n['tubes']} tubes ({n['tubes_checked']} calls, one "
        f"a geometry, {n['tubes_differ']} elements differ, checked on the "
        f"card in {n['tubes_check_s']:.2f} s; [im2col bytes, blocks] a "
        f"call {json.dumps(n['im2col_bytes'])}, UNFOLD_BYTES "
        f"{n['unfold_bytes']}); at {n['tubes']} tubes: int8 forward "
        f"{n['int8_ms']:.2f} ms "
        f"(bf16 {n['bf16_ms']:.2f}), the unfold path {n['unfold_ms']:.2f} ms "
        f"of it ({n['unfold_share']:.3f}) over {n['convs_per_forward']} "
        f"convolutions; launches {n['launches_per_forward']}; int8 vs bf16 "
        f"rel L2 {n['int8_vs_bf16_rel_l2']:.3g}")


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, benchmark mode off, for runs that
    are compared bit for bit."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def parallel_phase(fk, fl, ik, device="cuda", override=()) -> dict:
    """The data axis on one card (docstring item 20): an NCCL group of
    world 1; train_ncsn, acdc_SENSE_real_img and serve_recon with and
    without the mesh, compared bit for bit; s/step, the gradient
    all_reduce's ms and the engines' chain-steps/s. Then the sharded code
    itself (samplers/ald_pair.ShardedReconstructor, the CG's dot products
    summed over shards, the scattered noise and rolls): acdc_SENSE_real_img
    --use_mesh and both engines (ACDC, cine) on a mesh of two entries of
    the card, TF32 off, held to their runs without a mesh at SHARDED, with
    their walls and chain-steps/s. `override` adds
    --override flags to the ACDC CLIs (a rehearsal at a tiny size)."""
    import torch.distributed as dist
    from unittest import mock
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import (
        initialize_distributed, make_mesh)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel.distributed \
        import all_reduce_sum_
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_matmul)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_SENSE_real_img, serve_recon, train_ncsn)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
        apply_overrides)
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    numbers = {}
    over = [f for kv in override for f in ("--override", kv)]
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=device,
                           timeout=300)
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    ik.LAUNCHES.clear()
    try:
        numbers["group"] = dict(backend=dist.get_backend(),
                                world=dist.get_world_size())
        data_root = os.path.join(root, "no_data")
        os.makedirs(data_root)
        watch = "end_conv.bias"

        def train(name, flags):
            rec = {}
            torch.cuda.synchronize()
            with timed_fit(train_ncsn, rec, watch), warnings_quiet():
                state = train_ncsn.main([
                    "--ds_name", "ACDC", "--task_name", "Diffusion",
                    "--mode", "real-imag", "--device", device,
                    "--batch_size", "3", "--log_dir",
                    os.path.join(root, name), "--data_root", data_root,
                    "--override", f"training.n_iters={PARALLEL_STEPS}"]
                    + flags + over)
            if state.step != PARALLEL_STEPS or not np.isfinite(
                    rec["losses"]).all():
                raise AssertionError(f"train_ncsn {name}: step "
                                     f"{state.step}, losses {rec['losses']}")
            return state, rec

        def differ(a, b) -> dict:
            n = sum(int((a.params[k] != b.params[k]).sum()) for k in
                    a.params)
            return dict(params_differ=n, rel_l2=rel_l2(
                torch.cat([v.detach().reshape(-1) for v in a.params.values()]),
                torch.cat([v.detach().reshape(-1) for v in b.params.values()])))

        with cudnn_deterministic():
            plain, rec_p = train("plain", [])
            meshed, rec_m = train("mesh", ["--use_mesh"])
            same = differ(meshed, plain)
            same["losses_equal"] = rec_m["losses"] == rec_p["losses"]
            control = None
            if same["params_differ"] or not same["losses_equal"]:
                again, _ = train("plain_again", [])
                control = differ(again, plain)
                del again
            grads = [p.grad for p in meshed.model.parameters()
                     if p.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads])
            bucket_ms = cuda_ms(lambda: all_reduce_sum_(grads), reps=10)
            nccl_ms = cuda_ms(lambda: dist.all_reduce(flat), reps=10)
            numbers["train_ncsn"] = dict(
                steps=PARALLEL_STEPS, batch=3, mesh_vs_plain=same,
                control=control, losses=rec_m["losses"],
                s_per_step=dict(plain=float(np.mean(rec_p["step_s"][1:])),
                                mesh=float(np.mean(rec_m["step_s"][1:]))),
                step_s=dict(plain=rec_p["step_s"], mesh=rec_m["step_s"]),
                all_reduce=dict(bytes=flat.numel() * 4,
                                bucket_ms=bucket_ms, nccl_ms=nccl_ms))
            del plain, meshed, grads, flat
            torch.cuda.empty_cache()
            ok = (same["params_differ"] == 0 and same["losses_equal"]) or (
                control is not None and same["rel_l2"]
                <= 3 * control["rel_l2"] and control["rel_l2"] > 0)
            if not ok:
                raise AssertionError(f"train_ncsn --use_mesh vs without: "
                                     f"{same}, control {control}")

            # acdc_SENSE_real_img: 16 chains, PARALLEL_LEVELS levels
            argv = ["--device", device, "--num_samples", str(ACDC_CHAINS),
                    "--R", str(ACDC_R), "--num_sens", str(ACDC_COILS),
                    "--override", f"recons.num_classes={PARALLEL_LEVELS}",
                    "--data_root", data_root] + over
            # two entries of the card: the sharded code on it (Mesh allows
            # a repeated device), TF32 off and cuDNN's algorithms chosen by
            # its heuristics, not timed (benchmark mode times them afresh
            # in every process and may pick another summation order for a
            # shard's half batch), so that both runs round alike
            card = torch.device(device)
            if card.type == "cuda" and card.index is None:
                card = torch.device("cuda", torch.cuda.current_device())
            two = make_mesh(devices=[card, card])

            @contextlib.contextmanager
            def exact():
                with torch.backends.cudnn.flags(
                        enabled=True, benchmark=False, deterministic=True,
                        allow_tf32=False), float32_matmul():
                    yield
            sense = {}
            # the two-entry comparison at TWO_ENTRY_CHAINS chains and one
            # inner step a level: its cost is cuDNN's benchmark search
            cut = ["--num_samples", str(TWO_ENTRY_CHAINS),
                   "--num_steps_each", "1"]
            for name, flags, mode, mesh in (
                    ("plain", [], contextlib.nullcontext, None),
                    ("mesh", ["--use_mesh"], contextlib.nullcontext, None),
                    ("f32", cut, exact, None),
                    ("two", ["--use_mesh"] + cut, exact, two)):
                torch.cuda.synchronize()
                t_run = time.perf_counter()
                patch = (mock.patch.object(acdc_SENSE_real_img,
                                           "script_mesh", lambda _: mesh)
                         if mesh is not None else contextlib.nullcontext())
                with contextlib.redirect_stdout(io.StringIO()), \
                        warnings_quiet(), patch, mode():
                    sense[name] = acdc_SENSE_real_img.main(argv + flags + [
                        "--save_dir", os.path.join(root, f"sense_{name}")])
                torch.cuda.synchronize()
                sense[f"{name}_wall_s"] = time.perf_counter() - t_run
            sense_equal = bool(np.array_equal(sense["plain"], sense["mesh"]))
            sense_two = rel_l2(*(torch.view_as_real(torch.from_numpy(
                sense[k])) for k in ("two", "f32")))
            if (not sense_equal or sense_two > SHARDED
                    or not np.isfinite(sense["two"]).all()):
                raise AssertionError(
                    f"acdc_SENSE_real_img --use_mesh vs without: equal "
                    f"{sense_equal} on one entry, rel L2 {sense_two} on two "
                    f"(<= {SHARDED})")
            numbers["sense"] = dict(
                equal=sense_equal, shape=list(sense["mesh"].shape),
                two_entries_rel_l2=sense_two,
                two_entries_shape=list(sense["two"].shape),
                wall_s={k: sense[f"{k}_wall_s"] for k in
                        ("plain", "mesh", "f32", "two")})

            # serve_recon --data_shards -1
            cfg = apply_overrides(load_config("ACDC", "real-imag"), override)
            _, _, _, yr, yi = acdc_problem(cfg, device, PARALLEL_LEVELS)
            y_re, y_im = (v[:, 0, ..., 0].cpu().numpy() for v in (yr, yi))
            engines = {}
            for name, flags in (("plain", []),
                                ("mesh", ["--data_shards", "-1"])):
                argv = serve_argv("bf16")
                argv[argv.index("--levels") + 1] = str(PARALLEL_LEVELS)
                argv[argv.index("--device") + 1] = device
                eng = serve_recon.build_engine(serve_recon.parse_args(
                    argv + ["--no_warmup"] + flags + over))
                eng.warmup()
                runs = [eng.reconstruct(y_re, y_im, seed=0) for _ in
                        range(2)]
                engines[name] = dict(
                    x_re=runs[0].x_re, mesh=eng.stats()["mesh"],
                    chain_steps_per_s=max(r.chain_steps_per_s for r in runs))
                del eng
            engines_equal = bool(np.array_equal(engines["plain"]["x_re"],
                                                engines["mesh"]["x_re"]))
            if not engines_equal or engines["mesh"]["mesh"] != {
                    "data": 1, "model": 1}:
                raise AssertionError(f"serve_recon --data_shards -1: equal "
                                     f"{engines_equal}, mesh "
                                     f"{engines['mesh']['mesh']}")
            numbers["serve"] = dict(
                equal=engines_equal, levels=PARALLEL_LEVELS,
                chains=ACDC_CHAINS, mesh=engines["mesh"]["mesh"],
                chain_steps_per_s={k: v["chain_steps_per_s"]
                                   for k, v in engines.items()})

            # both engines, f32, without a mesh and on the two entries, at
            # PARALLEL_LEVELS levels of one inner step (the ACDC engine at
            # TWO_ENTRY_CHAINS chains, the cine engine at CINE_CHAINS). A
            # ladder of one level would end on the denoising step at sigma
            # 348, which scales the score's rounding by sigma^2.
            ccfg = load_config("CINE127", "real-imag")
            _, _, c_re, c_im = cine_problem(ccfg.data.image_size,
                                            CINE_FRAMES)
            numbers["engines_two"] = {}
            for workload, argv, ys, chains in (
                    ("acdc", serve_argv("f32") + over, (y_re, y_im),
                     TWO_ENTRY_CHAINS),
                    ("cine", cine_argv("f32"), (c_re, c_im), CINE_CHAINS)):
                argv[argv.index("--levels") + 1] = str(PARALLEL_LEVELS)
                argv[argv.index("--chains") + 1] = str(chains)
                argv[argv.index("--device") + 1] = device
                argv += ["--num_steps_each", "1", "--no_warmup"]
                runs = {}
                for name, mesh in (("plain", None), ("two", two)):
                    t_run = time.perf_counter()
                    with mock.patch.object(serve_recon, "_serving_mesh",
                                           lambda _: mesh), exact():
                        eng = serve_recon.build_engine(
                            serve_recon.parse_args(argv))
                        eng.warmup()
                        res = eng.reconstruct(*ys, seed=0)
                    runs[name] = dict(
                        x=np.concatenate([res.x_re.ravel(),
                                          res.x_im.ravel()]),
                        mesh=eng.stats()["mesh"],
                        chain_steps_per_s=res.chain_steps_per_s,
                        wall_s=time.perf_counter() - t_run)
                    del eng
                    torch.cuda.empty_cache()
                err = rel_l2(torch.from_numpy(runs["two"]["x"]),
                             torch.from_numpy(runs["plain"]["x"]))
                if (err > SHARDED or not np.isfinite(runs["two"]["x"]).all()
                        or runs["two"]["mesh"] != {"data": 2, "model": 1}):
                    raise AssertionError(
                        f"{workload} engine on two entries vs without a "
                        f"mesh: rel L2 {err} (<= {SHARDED}), mesh "
                        f"{runs['two']['mesh']}")
                numbers["engines_two"][workload] = dict(
                    rel_l2=err, chains=chains, levels=PARALLEL_LEVELS,
                    steps_each=1,
                    chain_steps_per_s={k: v["chain_steps_per_s"]
                                       for k, v in runs.items()},
                    wall_s={k: v["wall_s"] for k, v in runs.items()})
        launches = {**fk.LAUNCHES, **fl.LAUNCHES, **ik.LAUNCHES}
        if any(launches.values()):
            raise AssertionError(f"the parallel paths launched {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    return numbers


def report_parallel(p: dict, t: float) -> None:
    tn = p["train_ncsn"]
    say("parallel", t, f"{p['group']['backend']} group of world "
        f"{p['group']['world']}; train_ncsn --use_mesh (ACDC, full "
        f"width, batch {tn['batch']}, {tn['steps']} steps, cuDNN "
        f"deterministic) vs without: {json.dumps(tn['mesh_vs_plain'])} "
        f"(control {json.dumps(tn['control'])}); s/step "
        f"{json.dumps(tn['s_per_step'])}; gradient all_reduce "
        f"{tn['all_reduce']['bytes']} bytes: the step's bucket "
        f"{tn['all_reduce']['bucket_ms']:.3f} ms, dist.all_reduce alone "
        f"{tn['all_reduce']['nccl_ms']:.3f} ms; acdc_SENSE_real_img "
        f"--use_mesh equal {p['sense']['equal']} (walls "
        f"{json.dumps(p['sense']['wall_s'])}); serve_recon --data_shards -1 "
        f"equal {p['serve']['equal']}, mesh {p['serve']['mesh']}, "
        f"chain-steps/s {json.dumps(p['serve']['chain_steps_per_s'])} "
        f"({p['serve']['chains']} chains, {p['serve']['levels']} levels); on "
        f"two entries of the card (TF32 off, cuDNN heuristics) vs without "
        f"a mesh: "
        f"acdc_SENSE_real_img --use_mesh ({TWO_ENTRY_CHAINS} chains, "
        f"{PARALLEL_LEVELS} levels x 1 step) rel L2 "
        f"{p['sense']['two_entries_rel_l2']:.3g}, engines "
        f"{json.dumps(p['engines_two'])} (<= {SHARDED}); no K1-K7 launch")


def state_bytes(state, tp) -> list:
    """Bytes of the train state each model-axis entry holds: a parameter
    or slice, its optimizer state and its EMA shadow; a whole parameter on
    entry 0 (the lead), slice j on entry j. One entry for a plain state."""
    opt = state.optimizer.opt.state
    ema = state.ema.params
    n = max([len(ts) for _, split, ts in tp.entries(state.model)
             if split is not None] + [1])
    held = [0] * n
    for name, split, ts in tp.entries(state.model):
        for j, t in enumerate(ts):
            key = name if split is None else f"{name}[{j}]"
            parts = [t, ema[key]] + [v for v in opt.get(t, {}).values()
                                     if torch.is_tensor(v) and v.ndim]
            held[j] += sum(v.numel() * v.element_size() for v in parts)
    return held


def tp_phase(fk, fl, ik, device="cuda") -> dict:
    """Tensor parallelism over the model axis on one card (docstring item
    21): the deployed ACDC prior's train step, TP_STEPS steps at batch
    TP_BATCH, plain and split over two entries of the card, float32 with
    TF32 off, then split in bf16; the same weights, batch and draws."""
    from inverseproblemwithdiffusionmodel_tpu_torch import parallel
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        get_network)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import tp
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg = load_config("ACDC", "real-valued")    # train_ncsn's default mode
    net0 = seeded_weights(get_network(cfg), seed=0)
    size, ch = cfg.data.image_size, cfg.data.channels
    rs = np.random.RandomState(5)
    batches = [torch.from_numpy(rs.rand(TP_BATCH, size, size, ch).astype(
        np.float32)) for _ in range(TP_STEPS)]
    draws = [dict(labels=torch.from_numpy(rs.randint(
        0, cfg.model.num_classes, TP_BATCH)).to(device),
        noise=torch.from_numpy(rs.randn(TP_BATCH, size, size, ch).astype(
            np.float32)).to(device)) for _ in range(TP_STEPS)]
    card = torch.device(device)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh(n_data=1, n_model=2, devices=[card, card])
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    ik.LAUNCHES.clear()

    def run(split: bool, compute_dtype=None, feed=batches):
        state = TrainState.create(copy.deepcopy(net0).to(card),
                                  get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        if split:
            state = parallel.shard_tp(state, mesh)
        step = make_score_train_step(state.model, get_sigmas(cfg),
                                     mesh=mesh if split else None, tp=split,
                                     compute_dtype=compute_dtype)
        losses, seconds = [], []
        torch.cuda.reset_peak_memory_stats()
        for batch, d in zip(feed, draws):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            state, loss = step(state, batch, **d)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t_step)
        return state, dict(losses=losses, step_s=seconds,
                           s_per_step=float(np.mean(seconds[1:])),
                           peak=torch.cuda.max_memory_allocated())

    numbers = {"config": dict(image_size=size, ngf=cfg.model.ngf,
                              params=sum(p.numel() for p in
                                         net0.parameters()))}
    def against_plain(state, record) -> dict:
        """The losses' rel differences from the plain step's, and how far
        the parameters and the EMA lie past JAX's rtol (the largest
        |a - b| - rtol |b|, held to atol)."""
        worst = dict(params=0.0, ema=0.0)
        for what, got, ref in (("params", state.params, want),
                               ("ema", state.eval_params, want_ema)):
            for name, w in ref.items():
                g = got[name].detach()
                excess = ((g - w).abs() - TP_RTOL * w.abs()).max().item()
                worst[what] = max(worst[what], excess)
        return dict(loss_rel=[abs(a - b) / abs(b) for a, b in zip(
            record["losses"], numbers["plain"]["losses"])],
            max_excess_over_rtol=worst,
            max_abs=max((state.params[k].detach() - w).abs().max().item()
                        for k, w in want.items()))

    with float32_exact():
        plain, numbers["plain"] = run(False)
        want = {k: v.detach().clone() for k, v in plain.params.items()}
        want_ema = {k: v.clone() for k, v in plain.eval_params.items()}
        numbers["plain"]["state_bytes"] = state_bytes(plain, tp)
        del plain
        torch.cuda.empty_cache()
        # the control: the plain step on a first batch one float32 ulp up
        ulp = [torch.nextafter(batches[0], torch.full_like(batches[0], 2.0))]
        control, record = run(False, feed=ulp + batches[1:])
        numbers["ulp_control_vs_plain"] = against_plain(control, record)
        del control
        torch.cuda.empty_cache()
        split, numbers["tp"] = run(True)
        entries = tp.entries(split.model)
        numbers["tp"]["state_bytes"] = state_bytes(split, tp)
        numbers["leaves"] = dict(
            split=sum(s is not None for _, s, _ in entries),
            replicated=sum(s is None for _, s, _ in entries))
        numbers["tp_vs_plain"] = against_plain(split, numbers["tp"])
        numbers["gathers"] = tp_gather_ms(split, batches[0].to(card), cfg)
        del split
        torch.cuda.empty_cache()
    half, numbers["tp_bf16"] = run(True, torch.bfloat16)
    del half
    torch.cuda.empty_cache()
    numbers["launches"] = {**fk.LAUNCHES, **fl.LAUNCHES, **ik.LAUNCHES}
    cmp = numbers["tp_vs_plain"]
    bf16_rel = [abs(a - b) / abs(b) for a, b in zip(
        numbers["tp_bf16"]["losses"], numbers["tp"]["losses"])]
    numbers["tp_bf16"]["loss_rel_to_f32"] = bf16_rel
    # JAX's parameter bound cannot hold at this width in float32: one
    # float32 ulp of the batch moves the plain step's parameters past it
    # (PERF.md §6, PR 22). The split step's parameters are held within
    # atol of JAX's bound or within the control's reach, whichever is
    # larger; its losses and EMA to JAX's bounds.
    reach = numbers["ulp_control_vs_plain"]["max_excess_over_rtol"]["params"]
    excess = cmp["max_excess_over_rtol"]
    if not (numbers["leaves"]["split"] > 0
            and max(cmp["loss_rel"]) <= TP_LOSS_RTOL
            and excess["ema"] <= TP_ATOL
            and excess["params"] <= max(TP_ATOL, reach)
            and np.isfinite(numbers["tp"]["losses"]).all()):
        raise AssertionError(f"the split step vs the plain step: {cmp}; "
                             f"one ulp of the batch: "
                             f"{numbers['ulp_control_vs_plain']}")
    # the bf16 gate of train_bf16: one step from the same weights, batch
    # and draws (later steps start from states that have parted)
    if not (np.isfinite(numbers["tp_bf16"]["losses"]).all()
            and bf16_rel[0] <= BF16_LOSS_REL):
        raise AssertionError(f"the split bf16 step: losses "
                             f"{numbers['tp_bf16']['losses']}, rel to f32 "
                             f"{bf16_rel} (<= {BF16_LOSS_REL})")
    if any(numbers["launches"].values()):
        raise AssertionError(f"the tp phase launched {numbers['launches']}")
    return numbers


def tp_gather_ms(state, x: torch.Tensor, cfg) -> dict:
    """The gathers of one forward of a split state's net on x: each split
    convolution's output slices, recorded by forward hooks, joined again
    as Split.forward joins them (torch.cat on the lead, the slices there
    already on one card); device ms by CUDA events over the net's
    gathers, and the bytes they write."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        to_nchw)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import tp
    shapes, hooks = [], []
    for _, module in state.model.named_modules():
        if isinstance(getattr(module, "tp", None), tp.Split) and \
                module.weight is None:
            hooks.append(module.register_forward_hook(
                lambda m, args, out: shapes.append(tuple(out.shape))))
    sigmas = torch.ones(x.shape[0], device=x.device)
    with torch.no_grad():
        state.model(to_nchw(x), sigmas)
    for h in hooks:
        h.remove()
    slices = [[torch.empty((s[0], s[1] // 2) + s[2:], device=x.device)
               for _ in range(2)] for s in shapes]

    def gathers():
        for a, b in slices:
            torch.cat([a, b], 1)

    ms = cuda_ms(gathers, reps=5)
    written = sum(4 * math.prod(s) for s in shapes)
    return dict(calls=len(shapes), ms=ms, bytes_written=written,
                bound_ms=1e3 * 2 * written / HBM_BYTES_PER_S)


def int8_two_entries(ik, device="cuda") -> dict:
    """The int8 scale of the whole batch on a mesh (docstring item 21b):
    the ACDC int8 engine (serve_recon --dtype int8, ACDC_CHAINS chains,
    PARALLEL_LEVELS levels of one inner step) on two entries of the card
    against its run without a mesh, TF32 off and cuDNN's heuristics; and
    its first forward, the int8 net on the 32-row batch against the same
    net on two 16-row shards, each on a thread of one ScaleGroup on the
    one stream, bit for bit. K5-K7 launch counts over the two-entry run."""
    from unittest import mock
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import make_mesh
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        run_shards)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_matmul)
    card = torch.device(device)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    two = make_mesh(devices=[card, card])
    cfg = load_config("ACDC", "real-imag")
    _, _, _, yr, yi = acdc_problem(cfg, device, PARALLEL_LEVELS)
    ys = tuple(v[:, 0, ..., 0].cpu().numpy() for v in (yr, yi))
    argv = serve_argv("int8")
    argv[argv.index("--levels") + 1] = str(PARALLEL_LEVELS)
    argv[argv.index("--device") + 1] = device
    argv += ["--num_steps_each", "1", "--no_warmup"]

    @contextlib.contextmanager
    def exact():
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False), float32_matmul():
            yield

    runs, numbers = {}, {}
    for name, mesh in (("plain", None), ("two", two)):
        t_run = time.perf_counter()
        with mock.patch.object(serve_recon, "_serving_mesh",
                               lambda _: mesh), exact():
            eng = serve_recon.build_engine(serve_recon.parse_args(argv))
            eng.warmup()
            ik.LAUNCHES.clear()
            res = eng.reconstruct(*ys, seed=0)
            torch.cuda.synchronize()
            launches = dict(ik.LAUNCHES)
        runs[name] = dict(x=np.concatenate([res.x_re.ravel(),
                                            res.x_im.ravel()]),
                          mesh=eng.stats()["mesh"], launches=launches,
                          chain_steps_per_s=res.chain_steps_per_s,
                          wall_s=time.perf_counter() - t_run)
        if name == "plain":
            score = eng._score_fns[0]
        del eng
        torch.cuda.empty_cache()
    err = rel_l2(torch.from_numpy(runs["two"]["x"]),
                 torch.from_numpy(runs["plain"]["x"]))
    # the first forward: the whole batch against its two shards
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2 * ACDC_CHAINS, cfg.data.image_size,
                    cfg.data.image_size, 1, generator=gen).to(card)
    labels = torch.zeros(x.shape[0], dtype=torch.long, device=card)
    with torch.inference_mode():
        whole = score(x, labels)
        out = torch.cat(run_shards(score, list(zip(x.chunk(2),
                                                   labels.chunk(2))),
                                   [card, card], torch.inference_mode))
    numbers.update(
        chains=ACDC_CHAINS, levels=PARALLEL_LEVELS, steps_each=1,
        level_end_rel_l2=err, first_forward_equal=torch.equal(out, whole),
        first_forward_rel_l2=rel_l2(out.float(), whole.float()),
        launches=runs["two"]["launches"],
        launches_plain=runs["plain"]["launches"],
        mesh=runs["two"]["mesh"],
        chain_steps_per_s={k: v["chain_steps_per_s"] for k, v in
                           runs.items()},
        wall_s={k: v["wall_s"] for k, v in runs.items()})
    if (err > SHARDED or not np.isfinite(runs["two"]["x"]).all()
            or runs["two"]["mesh"] != {"data": 2, "model": 1}
            or not all(runs["two"]["launches"].get(t) for t in INT8_TAGS)):
        raise AssertionError(f"int8 engine on two entries: {numbers}")
    return numbers


def report_tp(p: dict, q: dict, t: float) -> None:
    tp_, pl = p["tp"], p["plain"]
    c = p["config"]
    say("tp", t, f"ACDC NCSNv2Deepest ({c['image_size']} px, ngf "
        f"{c['ngf']}, {c['params']} params, seed 0) train step "
        f"at batch {TP_BATCH}, {TP_STEPS} steps, split over two entries of "
        f"the card ({p['leaves']['split']} leaves split, "
        f"{p['leaves']['replicated']} whole) vs plain, float32 TF32 off: "
        f"loss rel {json.dumps(p['tp_vs_plain']['loss_rel'])} (<= "
        f"{TP_LOSS_RTOL}), parameters and EMA past rtol "
        f"{TP_RTOL} by at most "
        f"{json.dumps(p['tp_vs_plain']['max_excess_over_rtol'])} (EMA <= "
        f"{TP_ATOL}; parameters <= atol or the plain step's on a batch one "
        f"ulp away: "
        f"{json.dumps(p['ulp_control_vs_plain']['max_excess_over_rtol'])},"
        f" loss rel {json.dumps(p['ulp_control_vs_plain']['loss_rel'])}; "
        f"max |diff| {p['tp_vs_plain']['max_abs']:.3g}); s/step "
        f"plain {pl['s_per_step']:.4f}, split {tp_['s_per_step']:.4f}, "
        f"split bf16 {p['tp_bf16']['s_per_step']:.4f} (loss rel to f32 "
        f"{json.dumps(p['tp_bf16']['loss_rel_to_f32'])}, the first <= "
        f"{BF16_LOSS_REL}); state bytes by entry plain "
        f"{pl['state_bytes']}, split {tp_['state_bytes']}; peak plain "
        f"{pl['peak']}, split {tp_['peak']}; a forward's "
        f"{p['gathers']['calls']} gathers {p['gathers']['ms']:.3f} ms "
        f"({p['gathers']['bytes_written']} bytes written); no K1-K7 launch")
    say("int8_shards", t, f"ACDC int8 engine ({q['chains']} chains, "
        f"{q['levels']} levels x 1 step) on two entries of the card vs "
        f"without a mesh: rel L2 {q['level_end_rel_l2']:.3g} (<= "
        f"{SHARDED}); the first forward on two shards bit for bit "
        f"{q['first_forward_equal']} (rel L2 "
        f"{q['first_forward_rel_l2']:.3g});"
        f" chain-steps/s {json.dumps(q['chain_steps_per_s'])}; launches "
        f"{json.dumps(q['launches'])}")


def seeded_once(seeded_weights):
    """utils/convert.seeded_weights drawing each architecture's weights for
    a seed once per process: a later net with the same modules, parameter
    names and shapes, seed and scale gets a copy of the first draw. The
    values are the same (the draws depend on those alone, on the CPU's
    generator); the smoke builds its full-width nets tens of times, and a
    draw of 94 M parameters takes seconds of one CPU core."""
    drawn = {}

    def seeded(model, seed, std_scale=1.0):
        key = (seed, std_scale,
               tuple((n, type(m).__name__) for n, m in model.named_modules()),
               tuple((n, tuple(p.shape)) for n, p in model.named_parameters()))
        if key not in drawn:
            seeded_weights(model, seed, std_scale)
            drawn[key] = {n: p.detach().cpu().clone()
                          for n, p in model.named_parameters()}
        else:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(drawn[key][n])
        return model

    return seeded


def parity_net(cfg, w0: dict):
    """The NCSN++ of `cfg` holding the weights w0, on the CPU."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
    net = create_model(cfg)
    net.load_state_dict(w0)
    return net


def parity_step(net, cfg, sde, inp: tuple, device) -> tuple:
    """train_parity's one continuous train step of `net` (NCSN++, the leaf
    `cfg`) on inp = (x, t, z), moved to `device` (the card in the float32
    mode; on the CPU no CUDA call, so it may run on a thread of its own):
    the loss and the clipped gradients."""
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_continuous_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    x1, t1, z1 = inp
    net.to(device)
    st = TrainState.create(net, get_optimizer(cfg), ema_decay=None)
    stp = make_continuous_score_train_step(
        net, sde, reduce_mean=cfg.training.reduce_mean)
    mode = contextlib.nullcontext() if device == "cpu" else float32_exact()
    with mode:
        _, loss = stp(st, x1, t=t1.to(device), z=z1.to(device))
    return loss.item(), torch.cat([p.grad.reshape(-1).cpu() for p in
                                   net.parameters() if p.grad is not None])


def main() -> None:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this smoke "
                         "runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from inverseproblemwithdiffusionmodel_tpu_torch.utils import convert
    convert.seeded_weights = seeded_once(convert.seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import _build
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
        fir_kernels as fk, flr_kernels as fl, int8_kernels as ik)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        pc_sampling)
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
        get_pc_sampler, get_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer, FitConfig, TrainState, batch_iterator, fit,
        get_optimizer, make_continuous_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)

    torch.set_num_threads(os.cpu_count() or 1)
    launches = {}     # per path: kernel launches counted during that path

    # 1. device ---------------------------------------------------------------
    t = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", t, f"{kind} x{count}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvidia-smi: {smi}")
    print(smi, flush=True)

    # 2. build ----------------------------------------------------------------
    t = time.perf_counter()
    build = _build.build()
    ptxas = [line.strip() for line in build.log.splitlines()
             if "registers" in line or "Compiling entry" in line
             or "spill" in line]
    say("build", t, f"nvcc {build.seconds:.2f} s "
        f"({'reused' if build.seconds == 0.0 else 'built'}) -> {build.path}")
    for line in ptxas:
        print(f"    {line}", flush=True)
    # the int8 phase's one-kernel check: its profiling process runs now,
    # beside the early phases
    k5_profile = k5_profile_start()

    # 3. kernels --------------------------------------------------------------
    t = time.perf_counter()
    cfg = get_continuous_config(CONFIG)
    k = tuple(cfg.model.fir_kernel)
    gen = torch.Generator().manual_seed(0)
    rows = {"up2x": [], "down2x": []}
    rows8 = {"up2x": [], "down2x": []}
    with float32_exact():
        for name, C, R in fir_shapes(cfg):
            rows[name].append(kernel_numbers(name, C, R, k, fk, gen, BATCH))
        for name, C, R in fir_shapes(cfg):
            rows8[name].append(kernel_numbers(name, C, R, k, fk, gen,
                                              TRAIN_BATCH))
    summary = summarize(rows, f"one forward at batch {BATCH}")
    summary8 = summarize(rows8, f"one forward at batch {TRAIN_BATCH}")
    for name in rows:
        summary[name]["err"] = max(summary[name]["err"],
                                   summary8[name]["err"])
    host_us = host_us_per_launch(fk, k, fir_shapes(cfg))
    say("kernels", t, f"K1/K2 match their plain versions at all "
        f"{sum(len(r) for r in rows.values())} shapes of a forward, at batch "
        f"{BATCH} and at batch {TRAIN_BATCH} (max_abs_err at batch "
        f"{TRAIN_BATCH} { {n: s['err'] for n, s in summary8.items()} }; rtol "
        f"{KERNEL_RTOL}); host us per launch at the smallest shape "
        f"{json.dumps(host_us)}")

    t = time.perf_counter()
    bwd_rows = {"up2x.bwd": [], "down2x.bwd": []}
    with float32_exact():
        for name, C, R in bwd_shapes(cfg):
            bwd_rows[name].append(kernel_numbers(name, C, R, k, fk, gen,
                                                 TRAIN_BATCH))
    summary.update(summarize(bwd_rows, "one training step's backward"))
    per_step_bwd = {name: len(rs) for name, rs in bwd_rows.items()}
    say("kernels_bwd", t, f"K3 backward (K2 for up, K1 for down) matches "
        f"the plain transposes at all {sum(per_step_bwd.values())} shapes "
        f"of a training step, batch {TRAIN_BATCH} (rtol {KERNEL_RTOL}): "
        f"{per_step_bwd}")

    t = time.perf_counter()
    rows16 = {f"{n}.bf16": [] for n in rows}
    rows16_8 = {f"{n}.bf16": [] for n in rows}
    bwd16 = {f"{n}.bf16": [] for n in bwd_rows}
    for name, C, R in fir_shapes(cfg):
        rows16[f"{name}.bf16"].append(kernel_numbers(
            f"{name}.bf16", C, R, k, fk, gen, BATCH))
        rows16_8[f"{name}.bf16"].append(kernel_numbers(
            f"{name}.bf16", C, R, k, fk, gen, TRAIN_BATCH))
    for name, C, R in bwd_shapes(cfg):
        bwd16[f"{name}.bf16"].append(kernel_numbers(
            f"{name}.bf16", C, R, k, fk, gen, TRAIN_BATCH))
    summary.update(summarize(rows16, f"one bf16 forward at batch {BATCH}"))
    summary8.update(summarize(rows16_8, f"one bf16 forward at batch "
                                        f"{TRAIN_BATCH}"))
    summary.update(summarize(bwd16, "one bf16 training step's backward"))
    diffs = {}
    for table in (rows16, rows16_8, bwd16):
        for name, rs in table.items():
            summary[name]["err"] = max(summary[name]["err"],
                                       max(r["err"] for r in rs))
            d = diffs.setdefault(name, dict(differ=0, of=0, f32_err=0.0))
            d["differ"] += sum(r["n_diff"] for r in rs)
            d["of"] += sum(r["n_out"] for r in rs)
            d["f32_err"] = max(d["f32_err"], max(r["err_f32"] for r in rs))
    say("kernels_bf16", t, f"bf16 K1/K2 match their bf16 plain versions at "
        f"all {sum(len(r) for r in rows16.values())} forward shapes at batch "
        f"{BATCH} and {TRAIN_BATCH} and the K3 backward at all "
        f"{sum(len(r) for r in bwd16.values())} step shapes (1 bf16 ulp of "
        f"the largest |value|), and the float32 kernels rounded once (2 "
        f"ulps); elements that differ from the plain versions "
        f"{json.dumps(diffs)}")

    # The CIFAR-10 VP NCSN++ (train_bf16, sample_vp) calls the same kernels
    # at its own shapes: a step at batch VP_TRAIN_BATCH in f32 and bf16,
    # forward and backward, and the sampler's forward at VP_SAMPLES.
    t = time.perf_counter()
    vp_cfg = get_continuous_config(VP_CONFIG)
    k_vp = tuple(vp_cfg.model.fir_kernel)
    vp_rows, vp_rows16 = {}, {}
    for tag in ("", ".bf16"):
        with float32_exact() if not tag else contextlib.nullcontext():
            for name, C, R in fir_shapes(vp_cfg) + bwd_shapes(vp_cfg):
                vp_rows.setdefault(name + tag, []).append(kernel_numbers(
                    name + tag, C, R, k_vp, fk, gen, VP_TRAIN_BATCH))
    with float32_exact():
        for name, C, R in fir_shapes(vp_cfg):
            vp_rows16.setdefault(name, []).append(kernel_numbers(
                name, C, R, k_vp, fk, gen, VP_SAMPLES))
    summary_vp = summarize(vp_rows, f"one {VP_CONFIG} step at batch "
                                    f"{VP_TRAIN_BATCH}")
    summary_vp16 = summarize(vp_rows16, f"one {VP_CONFIG} forward at batch "
                                        f"{VP_SAMPLES}")
    for table in (vp_rows, vp_rows16):
        for name, rs in table.items():
            summary[name]["err"] = max(summary[name]["err"],
                                       max(r["err"] for r in rs))
            if name.endswith(".bf16"):
                d = diffs[name]
                d["differ"] += sum(r["n_diff"] for r in rs)
                d["of"] += sum(r["n_out"] for r in rs)
                d["f32_err"] = max(d["f32_err"],
                                   max(r["err_f32"] for r in rs))
    say("kernels_vp", t, f"K1/K2 and the K3 backward match their plain "
        f"versions at the {VP_CONFIG} shapes: "
        f"{sum(len(r) for r in vp_rows.values())} step calls at batch "
        f"{VP_TRAIN_BATCH} in f32 and bf16 and "
        f"{sum(len(r) for r in vp_rows16.values())} forward calls at batch "
        f"{VP_SAMPLES} in f32 (f32 rtol {KERNEL_RTOL}; bf16 1 ulp of the "
        f"plain version, 2 of the f32 kernel rounded once); max_abs_err "
        + json.dumps({n: max(r["err"] for r in rs)
                      for n, rs in vp_rows.items()}))

    t = time.perf_counter()
    flr_summary, launches["flr_op"], flr_diff = flr_phase(fl, gen)
    summary.update(flr_summary)
    say("flr", t, f"K4 forward, dx and db match the plain versions at "
        f"{len(FLR_SHAPES)} shapes in float32 (rtol {KERNEL_RTOL}) and bf16 "
        f"(1 bf16 ulp of the largest |value|; elements that differ at all "
        f"{json.dumps(flr_diff)}); launches {launches['flr_op']}")

    # 18. natural (run here, before any profiler session: PERF.md §7) ------
    t = time.perf_counter()
    nt = natural_phase(fk, fl)
    launches["natural ode"] = nt["ode"]["launches"]
    for path in ("v1_sample", "v1_train", "celeba_train", "cifar10_sample"):
        launches[f"natural {path}"] = {}
    report_natural(nt, t)

    # 4. model ----------------------------------------------------------------
    t = time.perf_counter()
    model_cpu = seeded_weights(create_model(cfg), seed=0).eval()
    model = copy.deepcopy(model_cpu).cuda().eval()
    n_params = sum(p.numel() for p in model.parameters())
    size, ch = cfg.data.image_size, cfg.data.num_channels
    x = torch.rand(1, size, size, ch, generator=gen)
    sigma = torch.tensor([5.0])
    xc, sc = x.cuda(), sigma.cuda()
    # Batch 2 in the float32 mode, where cuDNN's heuristics alone would
    # pick the FFT convolution: card vs CPU, and the forward's time. The
    # CPU's forwards run on a thread of their own beside the card's.
    xe = torch.rand(BATCH, size, size, ch, generator=gen)
    se = torch.tensor([5.0, 0.5])

    def cpu_forwards():
        with torch.no_grad():
            return model_cpu(x, sigma), model_cpu(xe, se)

    refs = Background(cpu_forwards)
    with torch.no_grad(), float32_exact():
        fk.LAUNCHES.clear()
        out = model(xc, sc)
        torch.cuda.synchronize()
        fwd_launches = dict(fk.LAUNCHES)
        fwd_ms = cuda_ms(lambda: model(xc, sc), reps=5)
    with torch.no_grad(), float32_exact():
        out_e = model(xe.cuda(), se.cuda())
        exact_b_ms = cuda_ms(lambda: model(xe.cuda(), se.cuda()), reps=5)
    xb, sb = x.repeat(BATCH, 1, 1, 1).cuda(), sigma.repeat(BATCH).cuda()
    with torch.no_grad():
        fwd_b_ms, fwd_b_host_ms = cuda_ms(lambda: model(xb, sb), reps=5,
                                          host=True)
    ref, ref_e = refs.result()
    rel = ((out.cpu() - ref).norm() / ref.norm()).item()
    rel_e = rel_l2(out_e.cpu(), ref_e)
    per_forward = {name: len(rs) for name, rs in rows.items()}
    if fwd_launches != per_forward:
        raise AssertionError(f"one forward launched {fwd_launches}, "
                             f"expected {per_forward} (18 each at FFHQ-256)")
    if not (torch.isfinite(out).all() and rel <= MODEL_REL_L2
            and rel_e <= MODEL_REL_L2):
        raise AssertionError(f"card vs CPU forward: rel L2 {rel} (batch 1),"
                             f" {rel_e} (batch {BATCH})")
    w0 = {name: v.detach().clone() for name, v in model_cpu.state_dict()
          .items()}
    del model_cpu, ref
    # train_parity's CPU step runs beside the sample and train phases
    sde = make_sde(cfg)
    pgen = torch.Generator().manual_seed(3)
    x1 = torch.rand(1, size, size, ch, generator=pgen)
    t1 = torch.rand(1, generator=pgen) * (sde.T - 1e-5) + 1e-5
    z1 = torch.randn(1, size, size, ch, generator=pgen)
    parity_cpu = Background(parity_step, parity_net(cfg, w0), cfg, sde,
                            (x1, t1, z1), "cpu")
    say("model", t, f"{CONFIG} NCSN++ {n_params} params, batch 1: card vs "
        f"CPU rel L2 {rel:.3g} (<= {MODEL_REL_L2}); forward {fwd_ms:.2f} ms "
        f"on the card, TF32 off; launches {fwd_launches}. Batch {BATCH}, "
        f"float32 mode (cuDNN benchmark on): card vs CPU rel L2 {rel_e:.3g},"
        f" forward {exact_b_ms:.2f} ms. Batch {BATCH}, torch defaults: "
        f"forward {fwd_b_ms:.2f} ms on the card, {fwd_b_host_ms:.2f} ms on "
        f"the host to enqueue it")

    # 5. sample ---------------------------------------------------------------
    t = time.perf_counter()
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        fk.LAUNCHES.clear()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        samples, nfe, _ = run_pc_sampling(pc_sampling, [
            "--config", CONFIG, "--num_samples", str(BATCH), "--seed", "0",
            "--override", f"model.num_scales={NUM_SCALES}",
            "--save_dir", save_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches["sample"] = dict(fk.LAUNCHES)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    # Each evaluation launches each kernel per_forward times: the counts
    # hold the printed nfe to 2 per step (reverse diffusion + Langevin),
    # plus pc_sampling's first forward on one zero image.
    expect = {name: n * (NUM_SCALES * 2 + 1)
              for name, n in per_forward.items()}
    if nfe != NUM_SCALES * 2:
        raise AssertionError(f"nfe {nfe} != {NUM_SCALES * 2}")
    if launches["sample"] != expect:
        raise AssertionError(f"sampling launched {launches['sample']}, "
                             f"expected {expect}: each kernel's calls per "
                             "forward times nfe")
    if samples.shape != (BATCH, size, size, ch) or not np.isfinite(
            samples).all():
        raise AssertionError(f"samples {samples.shape}, finite "
                             f"{np.isfinite(samples).all()}")
    say("sample", t, f"pc_sampling.main {CONFIG} num_scales {NUM_SCALES} "
        f"(reduced from 2000), {BATCH} samples, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}: nfe {nfe}, wall {wall:.2f} s "
        f"(model set-up included), {nfe / wall:.2f} net evals/s, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {launches['sample']}")

    t = time.perf_counter()
    tiny = cfg.replace(**{"data.image_size": 16, "model.nf": 16,
                          "model.ch_mult": (1, 2, 2),
                          "model.num_res_blocks": 1,
                          "model.attn_resolutions": (8,),
                          "model.num_scales": 5})
    sde = make_sde(tiny)
    finals = []
    for device in ("cuda", "cpu"):
        net = seeded_weights(create_model(tiny), seed=1).to(device).eval()
        noise_gen = torch.Generator().manual_seed(2)
        sampler = get_pc_sampler(sde, (BATCH, 16, 16, 3),
                                 snr=tiny.sampling.snr, device=device)
        with torch.no_grad(), float32_exact():
            x, _ = sampler(get_score_fn(sde, net), noise=lambda s: torch.randn(
                tuple(s), generator=noise_gen).to(device))
        finals.append(x.cpu())
    rel = ((finals[0] - finals[1]).norm() / finals[1].norm()).item()
    if not rel <= MODEL_REL_L2:
        raise AssertionError(f"tiny PC run, card vs CPU: rel L2 {rel}")
    say("sample_ref", t, f"tiny PC run (16x16, N 5) card vs CPU, same noise: "
        f"rel L2 {rel:.3g} (<= {MODEL_REL_L2})")

    # 6. train ----------------------------------------------------------------
    t = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        model.train()
        state = TrainState.create(model, get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        step = make_continuous_score_train_step(
            model, sde, reduce_mean=cfg.training.reduce_mean)
        data = np.random.RandomState(0).rand(
            TRAIN_BATCH * TRAIN_STEPS, size, size, ch).astype(np.float32)
        watch = "conv_in.bias"
        losses, seconds, history = [], [], []

        def recorded_step(state, batch, generator):
            t_step = time.perf_counter()
            state, loss = step(state, batch, generator)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_step)
            losses.append(float(loss))
            history.append(state.params[watch].detach().double().cpu())
            return state, loss

        torch.cuda.reset_peak_memory_stats()
        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        state = fit(state, recorded_step,
                    batch_iterator(data, TRAIN_BATCH, seed=0),
                    FitConfig(n_epochs=1, max_steps=TRAIN_STEPS, log_every=1,
                              seed=0, log_dir=log_dir))
        torch.cuda.synchronize()
        launches["train"] = dict(fk.LAUNCHES)
        train_peak = torch.cuda.max_memory_allocated()
        ckpt_dir = os.path.join(log_dir, "ckpts")
        ckpt_steps = Checkpointer(ckpt_dir, track_best=False).all_steps()

        decay = cfg.model.ema_rate
        ema = w0[watch].double()
        for p in history:
            ema = decay * ema + (1 - decay) * p
        ema_err = (state.ema.params[watch].double().cpu() - ema).abs().max()
        moved = (state.params["conv_in.weight"].detach().cpu()
                 - w0["conv_in.weight"]).abs().max().item()
        expect = {name: n * TRAIN_STEPS for name, n in
                  {**per_forward, **per_step_bwd}.items()}
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"losses {losses}")
        if state.step != TRAIN_STEPS or ckpt_steps != [TRAIN_STEPS]:
            raise AssertionError(f"step {state.step}, checkpoints "
                                 f"{ckpt_steps}")
        if not moved > 0:
            raise AssertionError("training left conv_in.weight unchanged")
        if not ema_err <= 1e-6 * ema.abs().max():
            raise AssertionError(f"EMA of {watch} off its formula by "
                                 f"{ema_err}")
        if launches["train"] != expect or sum(fl.LAUNCHES.values()):
            raise AssertionError(f"training launched {launches['train']}, "
                                 f"expected {expect}")
        step_s = train_step_s = float(np.mean(seconds[1:]))
        say("train", t, f"fit, {CONFIG} full width, batch {TRAIN_BATCH} "
            f"(reduced from 64, the leaf's batch), Adam lr {cfg.optim.lr} "
            f"grad_clip {cfg.optim.grad_clip}, ema {decay}, reduce_mean "
            f"{cfg.training.reduce_mean}, cuDNN TF32 "
            f"{torch.backends.cudnn.allow_tf32}: {TRAIN_STEPS} steps, losses "
            f"{[round(v, 2) for v in losses]}; {step_s:.4f} s per step (first "
            f"step {seconds[0]:.2f} s excluded), {TRAIN_BATCH / step_s:.2f} "
            f"images/s, peak memory {train_peak / 2**30:.2f} GiB; EMA of "
            f"{watch} off its formula by {ema_err:.3g}; checkpoint "
            f"{ckpt_steps}; launches {launches['train']} ({TRAIN_STEPS} "
            f"steps)")
        del state, step, model
        torch.cuda.empty_cache()

        # 7. train_parity ---------------------------------------------------
        t = time.perf_counter()
        loss_gpu, g_gpu = parity_step(parity_net(cfg, w0), cfg, sde,
                                      (x1, t1, z1), "cuda")
        loss_cpu, g_cpu = parity_cpu.result()
        loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        grad_rel = rel_l2(g_gpu, g_cpu)
        if not (loss_rel <= MODEL_REL_L2 and grad_rel <= MODEL_REL_L2):
            raise AssertionError(f"train step card vs CPU: loss rel "
                                 f"{loss_rel}, gradient rel L2 {grad_rel}")
        say("train_parity", t, f"one train step, full width, batch 1, TF32 "
            f"off, same weights, batch, t and z: loss card {loss_gpu:.6f} "
            f"CPU {loss_cpu:.6f} (rel {loss_rel:.3g}); gradients (clipped, "
            f"{g_cpu.numel()} entries) rel L2 {grad_rel:.3g} (<= "
            f"{MODEL_REL_L2})")

        # 8. sample_ckpt ----------------------------------------------------
        t = time.perf_counter()
        save_dir = os.path.join(log_dir, "samples")
        fk.LAUNCHES.clear()
        samples, nfe, text = run_pc_sampling(pc_sampling, [
            "--config", CONFIG, "--num_samples", str(BATCH), "--seed", "0",
            "--ckpt_dir", ckpt_dir, "--override",
            f"model.num_scales={CKPT_NUM_SCALES}", "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches["sample_ckpt"] = dict(fk.LAUNCHES)
        expect = {name: n * (CKPT_NUM_SCALES * 2 + 1)
                  for name, n in per_forward.items()}
        if f"restored step {TRAIN_STEPS} from" not in text:
            raise AssertionError("pc_sampling printed no restored step "
                                 f"{TRAIN_STEPS}")
        if samples.shape != (BATCH, size, size, ch) or not np.isfinite(
                samples).all() or launches["sample_ckpt"] != expect or \
                nfe != CKPT_NUM_SCALES * 2:
            raise AssertionError(f"samples {samples.shape}, finite "
                                 f"{np.isfinite(samples).all()}, launches "
                                 f"{launches['sample_ckpt']}, nfe {nfe}")
        say("sample_ckpt", t, f"pc_sampling.main --ckpt_dir (the train "
            f"phase's checkpoint, EMA weights) num_scales {CKPT_NUM_SCALES}: "
            f"restored step {TRAIN_STEPS}, nfe {nfe}, finite samples "
            f"{samples.shape}, launches {launches['sample_ckpt']}")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # 9. ncsnv2 ---------------------------------------------------------------
    t = time.perf_counter()
    nv2 = ncsnv2_phase(fk, fl)
    say("ncsnv2", t, f"ACDC NCSNv2Deepest, 256 px, ngf 128, {nv2['params']} "
        f"params (seed 0), through make_score_fn on channel-last x: card vs "
        f"CPU at batch {BATCH}, float32 mode, rel L2 {nv2['rel_l2']:.3g} (<= "
        f"{MODEL_REL_L2}); forward at batch {2 * ACDC_CHAINS}: torch "
        f"defaults (cuDNN TF32 {torch.backends.cudnn.allow_tf32}) "
        f"{nv2['f32']['ms']:.2f} ms on the card ({nv2['f32']['host_ms']:.2f} "
        f"ms host), peak {nv2['f32']['peak']} bytes; bf16 "
        f"{nv2['bf16']['ms']:.2f} ms ({nv2['bf16']['host_ms']:.2f} ms host), "
        f"peak {nv2['bf16']['peak']} bytes; on the bare permute (NHWC run): "
        f"f32 {nv2['f32_nhwc_view']['ms']:.2f} ms, bf16 "
        f"{nv2['bf16_nhwc_view']['ms']:.2f} ms; channels-last net: f32 "
        f"{nv2['f32_channels_last']['ms']:.2f} ms, bf16 "
        f"{nv2['bf16_channels_last']['ms']:.2f} ms; no K1/K2/K4 launch")

    # 10. recon ---------------------------------------------------------------
    t = time.perf_counter()
    rec = recon_phase(fk, fl)
    launches["recon"] = {}
    prof = rec["profile"]
    for name in ("f32", "bf16"):
        r = rec[name]
        print(f"    {name}: runs {[round(v, 4) for v in r['seconds']]} s, "
              f"{r['chain_steps_per_s']:.2f} chain-steps/s, peak "
              f"{r['peak']} bytes, finite {r['finite']}, max |x| "
              f"{r['abs_max']:.4g}", flush=True)
    print(f"    one level step (f32, {rec['n_steps']} inner steps): "
          f"{prof['level_device_ms']:.2f} ms on the card by CUDA events, "
          f"{prof['level_host_ms']:.2f} ms host to enqueue; profiled: "
          f"wall {prof['profiled_wall_ms']:.2f} ms, kernels "
          f"{prof['profiled_device_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.4f}, launches per inner step "
          f"{prof['launches_per_inner_step']:.1f} (device events "
          f"{prof['device_events_per_inner_step']:.1f})", flush=True)
    for label, rows in (("kernel", prof["top_kernels"]),
                        ("op", prof["top_ops"])):
        for key, calls, ms in rows:
            print(f"    top {label}: {ms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    say("recon", t, f"make_stepped_pair_reconstructor, bench.py geometry "
        f"(256 px, ngf 128, {ACDC_CHAINS} chains, {ACDC_COILS} coils, R = "
        f"{ACDC_R}, {ACDC_LEVELS} levels (of 2311) x 3 steps, CG "
        f"{ACDC_CG_ITERS}, lr_scaled {ACDC_LR_SCALED}, denoise on): f32 "
        f"{rec['f32']['chain_steps_per_s']:.2f} chain-steps/s, bf16 "
        f"{rec['bf16']['chain_steps_per_s']:.2f}; bf16 vs f32 rel L2 "
        f"{rec['bf16_vs_f32_rel_l2']:.3g} (<= {BF16_REL_L2}); card vs CPU "
        f"(1 chain, float32 mode) rel L2 "
        f"{json.dumps(rec['card_vs_cpu_rel_l2'])} (each <= {MODEL_REL_L2}); "
        f"no K1/K2/K4 launch")

    # 10b. sense --------------------------------------------------------------
    t = time.perf_counter()
    sn = sense_phase(fk, fl)
    launches["sense"] = {}
    report_sense(sn, t, rec["f32"]["chain_steps_per_s"])

    # 10c. map_tv -------------------------------------------------------------
    t = time.perf_counter()
    mt = map_tv_phase(fk, fl)
    launches["map_tv"] = {}
    report_map_tv(mt, t)

    # 11. serve ---------------------------------------------------------------
    t = time.perf_counter()
    srv = serve_phase(fk, fl)
    launches["serve"] = {}
    for name in ("f32", "bf16", "guided_bf16"):
        r = srv[name]
        http = ", ".join(
            f"{q['query']}: {q['chain_steps_per_s']:.2f} (engine) / "
            f"{q['client_chain_steps_per_s']:.2f} (client, "
            f"{q['client_s']:.4f} s)" for q in r["requests"])
        print(f"    {name}: build {r['build_s']:.2f} s, warm-up "
              f"{r['warmup_s']:.2f} s; chain-steps/s over HTTP {http}; "
              f"in-process {r['in_process']['chain_steps_per_s']:.2f} "
              f"({r['in_process']['latency_s']:.4f} s); /healthz requests "
              f"{r['healthz_requests']}; input signatures "
              f"{r['input_signatures']}; peak {r['peak']} bytes" + (
                  f"; host: normal kernel {r['normal_kernel_s']:.4f} s, "
                  f"npz encoding {r['npz_encode_s']:.4f} s"
                  if "normal_kernel_s" in r else ""), flush=True)
    say("serve", t, f"serve_recon.build_engine + serving.server at the recon "
        f"geometry ({SERVE_LEVELS} of 2311 levels), 3 requests over HTTP per "
        f"engine (default operator; new "
        f"R = {ACDC_R} mask, lr_scaled 3.0; new coil maps) and one "
        f"in-process: f32 "
        f"{srv['f32']['in_process']['chain_steps_per_s']:.2f} chain-steps/s "
        f"in-process, bf16 "
        f"{srv['bf16']['in_process']['chain_steps_per_s']:.2f}, guided bf16 "
        f"(seg UNet {srv['guided_bf16']['seg_params']} params) "
        f"{srv['guided_bf16']['in_process']['chain_steps_per_s']:.2f}; "
        f"engine vs make_stepped_pair_reconstructor (float32 mode) rel L2 "
        f"{srv['engine_vs_direct_rel_l2']:.3g} (<= {ENGINE_REL_L2}); guided "
        f"card vs CPU (1 chain) rel L2 "
        f"{json.dumps(srv['guided_card_vs_cpu_rel_l2'])} (the step <= "
        f"{MODEL_REL_L2} in the float32 mode, the float64 gradient <= "
        f"{SEG_F64_REL_L2}, the card's float32 gradient vs float64 <= "
        f"{SEG_F32_REL_L2}); one input signature per engine; no K1/K2/K4 "
        f"launch")

    # 12. cine ----------------------------------------------------------------
    t = time.perf_counter()
    cine = cine_phase(fk, fl)
    launches["cine"] = {}
    report_cine(cine, t)

    # 12b. cine_complex -------------------------------------------------------
    t = time.perf_counter()
    cc = cine_complex_phase(fk, fl)
    launches["cine_complex"] = {}
    report_cine_complex(cc, t)

    # 13. train_ncsn ----------------------------------------------------------
    t = time.perf_counter()
    tn = train_ncsn_phase(fk, fl)
    launches["train_ncsn"] = {}
    report_train_ncsn(tn, t)

    # 14. train_bf16 ----------------------------------------------------------
    t = time.perf_counter()
    tb = train_bf16_phase(fk, fl)
    ckpt_dir = tb.pop("vp_bf16_ckpt_dir")
    for name in ("ffhq_bf16", "vp_f32", "vp_bf16"):
        launches[f"train_bf16 {name}"] = tb[name]["launches"]
    ffhq16, vp32, vp16 = tb["ffhq_bf16"], tb["vp_f32"], tb["vp_bf16"]
    say("train_bf16", t, f"fit, continuous step in bf16 on the bf16 FIR "
        f"kernels: {CONFIG} batch {TRAIN_BATCH} {ffhq16['step_s']:.4f} s/step "
        f"({ffhq16['images_per_s']:.2f} images/s, peak {ffhq16['peak']} "
        f"bytes) against f32's {train_step_s:.4f} s ({train_peak} bytes); "
        f"{VP_CONFIG} (full width, {vp32['params']} params) batch "
        f"{VP_TRAIN_BATCH}: f32 {vp32['step_s']:.4f} s/step "
        f"({vp32['images_per_s']:.2f} images/s, peak {vp32['peak']}), bf16 "
        f"{vp16['step_s']:.4f} ({vp16['images_per_s']:.2f}, peak "
        f"{vp16['peak']}); bf16 launches per step: FFHQ "
        f"{ffhq16['launches_per_step']}, VP {vp16['launches_per_step']} "
        f"(no float32 FIR launch); VP step card vs CPU, float32 mode, batch "
        f"{VP_PARITY_BATCH}: {json.dumps(tb['vp_card_vs_cpu'])} (<= "
        f"{MODEL_REL_L2}); bf16 vs f32 {json.dumps(tb['vp_bf16_vs_f32'])} "
        f"(loss <= {BF16_LOSS_REL}, gradient {BF16_GRAD_FLOOR} to "
        f"{VP_BF16_GRAD_CEIL}; the control, FIR backward halved, above)")

    # 15. sample_vp -----------------------------------------------------------
    t = time.perf_counter()
    try:
        sv = sample_vp_phase(fk, fl, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches["sample_vp"] = {}
    for name, r in sv.items():
        if isinstance(r, dict):
            for tag, per in r["launches_per_eval"].items():
                launches["sample_vp"][tag] = launches["sample_vp"].get(
                    tag, 0) + int(round(per * r["evals"]))
    say("sample_vp", t, f"pc_sampling.main at full width, {VP_SAMPLES} "
        f"samples, num_scales {VP_NUM_SCALES} (reduced from 1000; 232 for "
        f"ve/ncsnv2/cifar10): the sampler's evals/s " + json.dumps(
            {n: round(r["evals_per_s"], 2) for n, r in sv.items()
             if isinstance(r, dict)}) + f"; every sample finite; tiny VP PC "
        f"run card vs CPU rel L2 {sv['tiny_card_vs_cpu_rel_l2']:.3g} (<= "
        f"{MODEL_REL_L2})")

    # 16. quickstart_3d -------------------------------------------------------
    t = time.perf_counter()
    qs = quickstart_3d_phase(fk, fl)
    launches["quickstart_3d"] = {}
    report_quickstart_3d(qs, t)

    # 17. guided --------------------------------------------------------------
    # the int8 phase's CPU reference runs beside the guided and migrate
    # phases' card work
    int8_cpu = int8_cpu_reference()
    t = time.perf_counter()
    gd = guided_phase(fk, fl)
    launches["guided"] = {}
    report_guided(gd, t)

    # 18b. migrate ------------------------------------------------------------
    t = time.perf_counter()
    mg = migrate_phase(fk, fl)
    launches["migrate"] = mg["ncsnpp"]["launches"]
    report_migrate(mg, t, sn["sense"]["chain_steps_per_s"])

    # 19. int8 ----------------------------------------------------------------
    t = time.perf_counter()
    q8 = int8_phase(fk, fl, ik, srv["bf16"],
                    cine["bf16"]["in_process"]["chain_steps_per_s"],
                    cpu_ref=int8_cpu, k5_profile=k5_profile)
    report_int8(q8, t)
    t = time.perf_counter()
    q3 = int8_ncsn3d_numbers(ik)
    report_int8_ncsn3d(q3, t)
    launches["int8_ncsn3d"] = q3["launches_per_forward"]

    # 20. parallel -------------------------------------------------------------
    t = time.perf_counter()
    par = parallel_phase(fk, fl, ik)
    launches["parallel"] = {}
    report_parallel(par, t)

    # 21. tp, 21b. int8_shards ------------------------------------------------
    t = time.perf_counter()
    tpn = tp_phase(fk, fl, ik)
    launches["tp"] = {}
    q2 = int8_two_entries(ik)
    launches["int8_shards"] = q2["launches"]
    report_tp(tpn, q2, t)

    print(json.dumps({"ncsnv2": nv2, "recon": rec, "sense": sn,
                      "map_tv": mt, "serve": srv, "cine": cine,
                      "cine_complex": cc, "train_ncsn": tn,
                      "train_bf16": tb, "sample_vp": sv,
                      "quickstart_3d": qs, "guided": gd, "natural": nt,
                      "migrate": mg, "int8": q8, "int8_ncsn3d": q3,
                      "parallel": par, "tp": tpn, "int8_shards": q2},
                     default=str), flush=True)

    for name, row in nt["ode_kernels"].items():
        summary[name]["err"] = max(summary[name]["err"], row["err"])
    kernels = []
    for name in FIR_TAGS + [f"{n}.bf16" for n in FIR_TAGS] + FLR_TAGS:
        s = summary[name]
        by_path = {path: counts[name] for path, counts in launches.items()
                   if counts.get(name)}
        kernels.append({
            "name": name if name.startswith("flr") else f"fir_{name}",
            "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
            "ms_with_host": s["ms_with_host"]})
        if name in summary8:
            s8 = summary8[name]
            kernels[-1][f"batch{TRAIN_BATCH}"] = {
                key: s8[key] for key in ("ms", "ms_with_host", "plain_ms",
                                         "library_ms", "bound_ms")}
        for key, table in ((f"vp_batch{VP_TRAIN_BATCH}", summary_vp),
                           (f"vp_batch{VP_SAMPLES}", summary_vp16),
                           (f"ode_batch{NATURAL_SAMPLES}",
                            nt["ode_kernels"])):
            if name in table:
                kernels[-1][key] = {k: table[name][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "err")}
        if name in host_us:
            kernels[-1]["host_us_per_launch"] = host_us[name]
    for tag, key in zip(INT8_TAGS, ("k5", "k6", "k7")):
        p, p1d = (q8[net]["per_forward"][key] for net in ("ncsnv2", "ncsn1d"))
        by_path = {"int8": q8["launches"][tag]}
        if q3["launches_per_forward"].get(tag):
            by_path["int8_ncsn3d"] = q3["launches_per_forward"][tag]
        by_path["int8_shards"] = q2["launches"][tag]
        kernels.append({
            "name": f"int8_{tag}", "route": "cuda",
            "source": f"{CSRC}/int8conv.cu", "replaces": INT8_REPLACES[tag],
            "replaces_note": "an XLA op in the JAX package, not a TPU kernel",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(p["err"], p1d["err"]), "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": p["library_ms"],
            "per": "one NCSNv2Deepest forward at batch 32",
            "ncsn1d_forward": {k: p1d[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "err")}})
        if key == "k5":
            kernels[-1]["kernels_per_call"] = q8["edges"]["kernels_per_call"]
        if key == "k7":
            kernels[-1].update(int_mm_ms=p["int_mm_ms"],
                               int_mm_gemm_ms=p["int_mm_gemm_ms"])
    say("total", t0, "all phases passed")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
