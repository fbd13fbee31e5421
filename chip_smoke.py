#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``v2e2v_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every CUDA source by its own ``nvcc``, all at once, and one link
   (seconds, and ``-Xptxas -v``'s registers, shared memory and spills per
   kernel); ``cuobjdump --dump-sass`` of the library counts the ``HGMMA``
   (wgmma) and ``HMMA`` instructions of each kernel: every bfloat16 conv
   kernel of K1 and K2 (``*_conv3x3_tc_kernel``) must have ``HGMMA`` and
   spill nothing, every float32 conv kernel (``*_conv3x3_kernel``, FFMA on
   CUDA cores: float32 products and sums) must have neither and spill
   nothing; the float32 conv's tile at the flagship and CLI shapes;
3. kernel K1 (``ista_loop``) against its plain version at the flagship shape
   (B = 8, 90x120, C = 64, depth 5), in float32 with TF32 off and in bfloat16;
4. the slice: a ``StreamPool`` of CISTA-LSTC at 180x240, 64 channels, depth 5,
   5 bins, capacity 8, serving 7 streams (6 at a time, one detached and one
   attached mid-run) whose requests are packets of ~15,000 synthetic events
   voxelised and normalised on the card; the launch counter must rise by
   2 x depth per pool step, and the same voxel grids through the plain ISTA
   must give the same reconstructions. Run in float32 (TF32 off) and bfloat16;
4b. kernel K2 (``cista_core``, the half-res core) against its plain version at
   the flagship pool's shape (B = 8, 90x120, C = 64, depth 5) on the model's
   init weights, all five outputs, in float32 with TF32 off (1e-4) and in
   bfloat16 (3e-2 + 3e-2 |ref|);
4c. the K2 slice: the same ``StreamPool`` with ``core_impl="cuda"``, serving
   the same schedule and voxel grids, with every count set to 0 just before
   it: K2's counter must rise by 7 + 2 x depth per pool step and K1's by 0
   (K2 runs its ISTA convs itself); its reconstructions must equal the pool's
   with ``core_impl="plain"`` (within 1e-4 / 3e-2) and lie within 3e-2 of the
   layers pool of phase 4, finite and in [0, 1];
5. times with CUDA events after warm-up: K1, its plain version, the nearest
   library call (cuDNN convs), its bound; K2, its plain version, the layers
   core it replaces (ConvLSTC, K1, Dg conv, ConvLSTM) and the same with the
   plain ISTA (cuDNN convs only), its bound; each of K1, K2, cuDNN's convs and
   the layers core both per call as the host issues them (``ms``) and as
   device time (``device_ms``: launches back to back after the card spins),
   and for K1 and K2 the host's time to issue a call (``host_ms``); K1
   float32 also at the CLIs' batch 1 (B = 1, 90x120), with its bound and
   cuDNN's D + P at that shape;
   the pool's step time with
   ``core_impl`` "layers" and "cuda" in turns, reconstructions per second and
   peak memory;
6. kernel K3 (``emulator_iters``) against its plain version at the V2E2V
   shape (B = 8, 180x240, 32 iterations, 5 bins): explicit uniforms in the four
   shot x gate cases and internal Philox uniforms, all exact; internal uniforms
   repeat with their seed, and with no threshold events the shot-event total
   is within 5 sigma of Binomial(n, p) for the kernel and for the plain
   version with torch's uniforms;
7. the V2E2V slice: ``v2e2v_forward`` pack by pack (6 packs of 10 frames, a
   new sequence after pack 3, batch 8, CISTA-LSTC 180x240, 64 channels,
   depth 5, 5 bins, the emulator of ``bench.py:170-176``) on synthetic frames
   from ``--seed``. Run A through K3 and K1 with explicit draws; run B through
   the plain versions with the same card generator seed (equal event counts,
   voxel grids and reconstructions within 1e-4, TF32 off); run C on the
   default path (``V2E2VConfig.from_flags``, internal randoms), the main path
   of the slice, with every count set to 0 just before it: finite
   reconstructions in [0, 1], event counts within 1% of run A's; run D through
   the plain versions with run C's seed, its Philox made by the plain
   version (equal event counts, voxel grids and reconstructions within 1e-4).
   K3's counter must rise by 9 and K1's by 10 per pack;
8. times with CUDA events after warm-up: K3 in both modes on the main path's
   inputs, its plain version and its bound; ``emulate_pack`` per pack;
   ``v2e2v_forward`` per pack (host clock), reconstructions per second, peak
   memory;
9. the E2V evaluation CLI (``v2e2v_tpu_torch.cli.test_e2v``): a dataset of
   two sequences of 30 PNG frames at 180x240 (written by the port's
   ``data/synthetic.py``) with one ``.npz`` of 15,000-30,000 events per interval
   from ``--seed``, and a ``.pth.tar`` of ``init_cista_lstc`` weights (64
   channels, depth 5, 5 bins), through the CLI's ``Reconstructor`` with the
   reference CLI's defaults (``--num_events 15000``, ``--test_data_mode
   real``) in float32 (TF32 off) and bfloat16. The same run with
   ``ista_impl="plain"`` first; then the main path, with every count set to
   0 just before it: K1's counter must rise by 2 x depth per reconstruction,
   the native runtime must have built and voxelised every window, the PNGs
   and ``result.csv`` rows must be written and the reconstructions finite, in
   [0, 1] and within 1e-4 (float32) or 3e-2 + 3e-2 |ref| (bfloat16) of the
   plain run's. Then the main path once more, untimed, its reconstructions
   identical to the timed run's: at every call K1's output is held against
   its plain version on the same inputs (B = 1), and at every step the
   state (z, which K1 makes, the cell and the Dg ConvLSTM's h and c) against
   the plain run's, both with the same tolerances; random-init
   reconstructions are nearly constant, so these, not the images, show K1
   right on the CLI's shapes. Times (timed run; the reader and the work after
   the model wrapped from outside): reconstructions per second over
   ``run()`` (host clock), the host's reader + voxelise time per
   reconstruction, the model step per reconstruction (CUDA events),
   normalise + metrics + PNG write per frame, peak memory; then the host
   path alone, part by part (PNG decode, event load, voxelise, each norm,
   the metrics, PNG write);
10. the V2E2V CLI (``v2e2v_tpu_torch.cli.test``): two sequences of 37 HFR
   PNG frames at 180x240, 250 fps (``data/synthetic.write_hfr_dataset``, from
   ``--seed``), a ``.pth.tar`` of ``e2v_net.``-prefixed ``init_cista_lstc``
   weights (64 channels, depth 5, 5 bins) whose ``v2e_params`` (those of
   ``bench.py:170-176``) override other flags; 3 packs of 10 frames per
   sequence. Run 1 through the plain versions and run 2 through K3 and K1
   with the same explicit draws (equal event counts, reconstructions within
   1e-4); run 3, the default path (internal Philox), with every count set to
   0 just before it: K3 launches once per frame pair (9 on a sequence's first
   pack, 8 on the others, whose reader returns 9 new frames), K1 2 x depth
   per pack, the PNGs and event previews written, reconstructions finite in
   [0, 1], event counts within 1% of run 2's. Times of run 3 (packs per
   second, reader, emulate + reconstruct, writes, peak memory);
11. raw-event generation: ``cli.generate_events`` over phase 10's dataset
   (one ``.npz`` per frame interval, every event in one of them: their total
   equals the printed one; no K3 launch); one pack with the same explicit
   draws through ``emulate_pack_raw`` and through ``emulate_pack`` with K3
   (equal counts, binned raw events within 1e-4 of K3's voxel grid), and
   each one's time;
12. CISTA-TC (``init_cista_tc``, 64 channels, depth 5): a ``StreamPool``
   with ``model_mode="cista-tc"`` on phase 4's schedule and voxel grids in
   float32 (TF32 off) and bfloat16 with every count set to 0 just before
   (K1, K2 and K3 stay at 0); stream 0's first 3 steps against the CPU
   (1e-4), bfloat16 within 3e-2 + 3e-2 |ref| of float32, finite in [0, 1];
   the pool's step time; the E2V CLI with ``--model_mode cista-tc`` over
   phase 9's first sequence (frames and the ``result.csv`` row written);
13. training at full width (CISTA-LSTC 180x240, 64 channels, depth 5, 5
   bins, windows of 10, float32 with TF32 off, the training config
   ``ista_impl="plain"``, ``core_impl="layers"``): (a) one E2V train step
   (B = 2) on the card against the same step on the CPU from the same weights
   and batch (loss within 1e-4 relative, each gradient within 1e-3 of its
   largest entry; K1 and K2 at 0 launches), two controls from the same
   weights (the card's step with TF32 on, whose gradients must read above
   that bound, and with cuDNN off), and ``ista_loop`` on CUDA tensors that
   require grad refusing; (b) E2V train steps at B = 1 and 8
   (ms per step by CUDA events, split into forward + loss, backward and
   optimizer, peak memory with and without remat; the loss finite and
   falling over 20 steps on one batch at B = 8; counts at 0 just before the
   timed steps); (c) ``cli.train_e2v`` for 2 epochs over a synthetic dataset
   (``data/synthetic.write_dataset``, manifest by ``make_train_e2v_txt``; no
   K1, K2 or K3 launch), ``cli.test_e2v`` on its epoch-2 checkpoint with K1
   held against its plain version at every call, and a resume from epoch 1
   to epoch 3 (the Adam moments survive); (d) V2E2V train steps at B = 8
   through K3 (its Philox) against ``iters_impl="plain"`` on the same noise
   seed (equal event counts, loss within 1e-5; K3 9 x 10 launches per step,
   K1 and K2 0), ms per step and peak memory; (e) ``cli.train`` for 1 epoch
   warm-started from (c)'s checkpoint, then ``cli.test`` on its checkpoint,
   the emulator rebuilt from its ``v2e_params``. Each part prints its
   seconds;
15. the full-resolution path in the parity domain (``fullres_impl="fused"``,
   ``ops/fused.py``), run after phase 13 and before the kernels line: (a)
   phase 4's schedule and voxel grids through ``StreamPool`` fused, in
   float32 (TF32 off) and bfloat16, with ``core_impl="layers"`` (K1's counter
   rising by 2 x depth per step) and ``"cuda"`` (K2's by 7 + 2 x depth, K1's
   by 0), every count at 0 just before each run; reconstructions and all
   four state tensors within 1e-4 (float32) or 3e-2 + 3e-2 |ref| (bfloat16)
   of the ref pool's on the same weights, finite, reconstructions in [0, 1];
   (b) ``cista_sequence`` with ``io_layout="parity"`` from the parity voxel
   producer (``events_to_voxel_grid(layout="parity")``, ``input_packed``)
   against ``io_layout="full"``, B = 8, T = 6, float32, 1e-4; (c) phase 7's
   run C fused: equal event counts, K3 9 and K1 10 launches per pack,
   reconstructions within 1e-4 of run C's; (d) CUDA-event times of the pool
   step fused against ref per dtype and core, in turns, with peak memory;
   the E2V CLI's model step (``cli.test_e2v.make_step``) at B = 1 fused
   against ref; the default rule's two conditions; ``torch.profiler`` traces
   (``scripts/profile_torch_pool.py``'s ``trace``) of the bfloat16 K2 and
   float32 layers pools, ref and fused, by kind of kernel;
16. int8 inference (``CistaConfig.quant="int8"``, ``ops/qconv.py``), after
   phase 15: (a) K4's build (``csrc/qconv3x3.cu``): its 12 kernels (int8,
   float32 and bfloat16 in x float32 and bfloat16 out x 64 or 128 output
   channels a block) hold ``IGMMA`` (``wgmma`` on the integer tensor cores)
   and no ``IMMA`` or ``HGMMA``, and they and the scale kernel's two
   (``csrc/qscale.cu``) spill nothing; (b) at every conv site shape of a step
   (gates 192->256, P0/P 64->128, out_gates 256->128, D/dg 128->64, lstm
   128->256) at B = 8 and B = 1, 90x120, for float32 and bfloat16 inputs on
   the ties of a static ``s_x = 2^-4``, past +-127 and at a few extremes: K4
   against its plain version on the float input (static and dynamic scale)
   and on its int8 codes, out float32 and bfloat16 (outputs an ulp apart at
   a count the line prints), the codes K4 stages read back through identity
   centre taps, the scale kernel bit for bit against its plain version (and
   1 on zeros); times as issued and on the device of K4 (float and int8
   entries), of the route it replaces (eager ``quantize_with``, then the int8
   entry) and of the dynamic site (the scale kernel + K4 against the eager
   scale passes + ``quantize_with`` + the int8 entry), its bound (bytes at
   3.35 TB/s or int8 operations at 1,979 TOPS, the float input read once),
   ``torch._int_mm`` on the int8 im2col and cuDNN's bfloat16 conv of the
   same shape; the scale kernel's times against its eager passes and
   ``torch.linalg.vector_norm(x, inf)``, and its bound; (c) a CISTA-LSTC int8
   ``StreamPool`` on phase 4's schedule and voxel grids in float32 (TF32 off)
   and bfloat16, with every count set to 0 just before: K4 15 launches per
   step and the scale kernel 15 (dynamic) or 0 (calibrated), K1, K2 and K3
   0; reconstructions and all four states within 1e-4 / 3e-2 + 3e-2 |ref| of
   the same pool through the plain versions (``qconv_impl="plain"``),
   finite, in [0, 1], and within JAX's own bound of phase 4's float pool
   (mean |diff| < 0.03, last step < 0.05); then pools calibrated
   (``calibrate()`` on 24 of the served grids as 3 steps of 8: the SSIM
   delta, whether the static scales were adopted, each site's ``s_x``) and
   held the same way; (d) the same for CISTA-TC (13 K4 launches per step);
   (e) the E2V CLI with ``--quant int8`` and ``int8-static`` on phase 9's
   first sequence (recon/s, the model step at B = 1 by CUDA events, K4 and
   the scale kernel 15 launches per reconstruction, K4 30 more and the scale
   kernel 15 to calibrate, K1 10 for the drift gate's float step, the
   calibration line); (f) the int8 pool step against the float pool step of
   the same dtype (``fullres_impl="ref"``) by CUDA events, in turns, with
   peak memory, each K4 call's input strides over one step, and a
   ``torch.profiler`` trace of the dynamic int8 step by kind of kernel (K4,
   the scale kernel, eager quantize passes, which must be none, clamps and
   relus, cuDNN, the rest);
17. Super-SloMo upsampling (``models/superslomo.py``; no kernel of the port:
   cuDNN's float32 convs and eager torch), after phase 16, at 180x240
   padded to 192x256, float32, TF32 off: (a) the flow and interpolation
   UNets on the card against the CPU on the same weights (within 1e-4 of the
   largest entry; the same comparison with TF32 on must read above it) and
   ``backwarp`` (flows reaching outside the frame; 1e-5); (b)
   ``Upsampler.upsampling`` over one sequence of 8 LFR frames, the flow
   net's output conv scaled so that each pair's count is at most 8 and
   every flow magnitude 0.15 or more from an integer (the checkpoint
   written here): counts and stamps equal to the CPU's, frames within one
   code (the count that differs printed); ms per ``flow_pair`` and
   ``interp_at_t`` call as issued in that run and on the device, their FLOP
   and bound (operations at 67 TFLOP/s or bytes at 3.35 TB/s), ms per pair,
   peak memory, and a trace of each call by kind of kernel; (c) the V2E2V
   CLI and the E2V CLI (``--test_data_mode upsampled``) with
   ``--reader_type upsampling`` over two sequences of 8 LFR frames, the
   checkpoint through ``V2E2V_SUPERSLOMO_CKPT``, every count at 0 just
   before each: K3 one launch per frame pair and K1 2 x depth per pack or
   reconstruction, K2 0; reconstructions finite and in [0, 1]; one PNG (and
   event preview) per pack or reconstruction;
18. profiling and the data axis (``utils/profiling.py``, ``parallel/``),
   after phase 17, over the datasets and outputs of phases 9, 10 and 13:
   (a) ``cli.train_e2v`` for one epoch over phase 13c's dataset with the
   ``--dist_*`` flags of a world of one (NCCL), against the same run without
   them before and after it (cuDNN deterministic): the group made and torn
   down, its all-reduce the identity on the loss and every gradient at each
   step, the first step's loss equal in all three runs, the checkpoints'
   distances shown (the card's E2V backward is not reproducible run to run),
   the step time with and without the group; (b) two ranks over gloo on the
   one card (NCCL refuses two ranks on one device), this script started
   once per rank (``--gloo_rank``): a V2E2V train step at full width (global
   B = 8, 10 packs of 10 frames, K3's Philox, each rank handed its rows as
   ``cli.train`` does, the draws for the global batch cut to them) and an
   E2V device-data step (global B = 8, T = 10, 5 real samples, the padding
   all on rank 1, ``--add_noise``'s draw) against the same steps in this
   process: events equal, the loss within 1e-5 relative, each rank's
   gradient before the reduction within 1e-5 of its largest entry of this
   process's step on the same 4 rows, the reduction exactly the ranks' mean
   (sum for the weighted loss), the reduced gradient within 1e-5 of this
   process's two 4-row steps combined and within 1e-2 of its 8-row step
   (the card's weight gradients differ at B = 8 and 2 x 4 by up to 9e-4),
   two planted faults beyond 1e-2, K3 9 x 10 a rank a step (0 in E2V), K1
   and K2 0; each rank's ms per step (gloo on one card: not a scaling
   figure); (c) ``StreamPool`` over ``make_mesh(2)`` (two groups of
   4 slots on the one card), float32, TF32 off, phase 4's schedule and
   voxel grids: within 1e-5 of phase 4's pool, K1 2 x 10 a step; (d)
   ``cli.train --profile_dir`` for one epoch over phase 13e's frames: one
   trace that names K3's kernel at each of its launches; ``cli.train_e2v
   --debug_nans`` on voxel grids holding a NaN: ``FloatingPointError`` at
   the first step, no checkpoint; (e) ``cli.test_e2v`` and ``cli.test``
   with the ``--dist_*`` flags of a world of one (NCCL): the same PNG and
   ``result.csv`` bytes as phase 9's float32 main path and phase 10's run
   3, and their K1 (and K3) counts;
19. the spatial axis (``parallel/spatial.py``, the E2V steps on
   ``make_mesh(n_data, n_spatial)``): (a) the per-batch E2V step (global
   B = 8, T = 10) and the device-data step (5 real samples,
   ``--add_noise``) at 180x240, C = 64, depth 5, float32, TF32 off, on
   ``(1, 2)`` and ``(2, 2)`` as 2 and 4 gloo ranks on the one card (this
   script started once per rank with ``--spatial n_data n_spatial``),
   against the same steps in this process: the ranks' blocks of the last
   reconstruction joined within 1e-4, the loss within 1e-5 relative, the
   loss's gradient with respect to the voxel input per column within 1e-1
   of its largest entry (ill-conditioned: one process with cuDNN off
   against on, printed beside, reads ~3e-2), the reduced weight gradients within 1e-2 of their largest entry,
   the updated weights equal on every rank, K1-K4 and the scale kernel 0;
   two planted faults (the inner cut reflect-padded; the halo gradients
   dropped), patched inside the ranks, must each break a bound; (b)
   ``cli.train_e2v --mesh_spatial 2`` through its own ``main`` in two gloo
   ranks (their group made over gloo) for one epoch over phase 13c's
   dataset: the first step's loss within 1e-5 relative of one process's,
   only rank 0 writes, the checkpoint's distance shown; (c) ms per step of
   each layout's ranks (time-sharing the card: no scaling figure) and rank
   0's halo exchanges and gathers per step (count, bytes, ms);
20. JPEG frames (``utils/jpeg.py`` behind ``utils/image_io.read_gray``,
   ROADMAP item 4): (a) every fixture under ``tests/data/jpeg``
   (``scripts/make_jpeg_fixtures.py``: the five sampling factors, gray,
   restart intervals, optimised tables, quality 100 and 5, progressive,
   181x243, Exif orientations 3, 6, 8, and a 12-frame 180x240 colour
   sequence) decoded by the port, its shape and sha256 against
   ``manifest.json``'s of ``cv2.imread(path, 0)``; the ms per full-width
   frame of ``read_gray`` on the JPEG frames and on their PNG twin (written
   by ``write_gray``) on the card's host; (b) the V2E2V CLI (image reader,
   ``--num_pack_frames 4``, phase 10's checkpoint) over the JPEG sequence,
   the main path with every count set to 0 just before it (K3 once per frame
   pair, K1 2 x depth per pack), then over the PNG twin with K3 and K1 held
   against their plain versions at every call: the output files byte for
   byte and the printed averages equal; (c) the E2V CLI (phase 9's
   checkpoint, float32) with the JPEG frames as ground truth and random
   events between them as phase 9 writes them, against the same dataset
   with the PNG twin: the ``result.csv`` rows and every output file equal,
   K1 2 x depth per reconstruction in the JPEG run; the reader's time per
   frame and the model step's per reconstruction of each;
21. video files (``utils/avi.py``, ``utils/jpeg.py::decode_mjpeg_frame``,
   ``utils/yuv.py``, ``utils/video.py``, ROADMAP item 4): (a) every MJPEG
   AVI under ``tests/data/video`` (``scripts/make_video_fixtures.py``: the
   12-frame 960x720 flagship clip, portrait, 30000/1001 fps, no DHT, odd
   width, restart markers and a dropped frame, OpenDML, odd height, 4:1:1,
   4:2:2, 4:4:0, 4:4:4, gray and progressive frames), and the MJPEG clips
   under ``tests/data/mpeg4`` (interlaced frames of both polarities, woven;
   7x12 4:2:0, 8x24 4:1:1 and 5x8 4:4:0 frames, whose chroma filter
   swscale cuts), read by the port's
   ``VideoReader`` and ``VideoSequence``, their frames, stamps and sha256
   against the JAX readers' records (``reader_frames.npz``,
   ``manifest.json``): exact share and max difference per clip; the host ms
   per 960x720 frame of each stage (demux, entropy decode, IDCT, conversion,
   resize) of the flagship clip and of each sampling's ``hd_*`` clip; (b) the V2E2V CLI with
   ``--reader_type video`` (``--num_pack_frames 4``, phase 10's checkpoint)
   over the flagship clip read as 180x240, the main path with every count set
   to 0 just before it (K3 once per frame pair, K1 2 x depth per pack), then
   over a PNG folder of the port's decoded frames with ``timestamps.txt`` at
   ``i / fps``, K3 and K1 held against their plain versions at every call:
   the output files byte for byte and the printed averages equal; the
   reader's time for the clip against the model steps';
22. still frames of every format of the manifests (``utils/image_io.py``,
   ``bmp.py``, ``pnm.py``, ``tiff.py``, ``webp.py``, ``vp8.py``): (a) the
   fixtures under ``tests/data/images`` against cv2's sha256 and the host ms
   per 180x240 frame of each format (``fixtures_against_manifest``, shared
   with phase 20); (b) the V2E2V CLI and (c) the E2V CLI over the mixed
   folder against the twin of the PNG frames they list
   (``cli_against_twin``, ``e2v_against_twin``), K3 and K1 counted on the
   main path and held per call; (d) ``cli.train`` over all twelve frames
   against the twin: equal samples and first loss, K3 once per frame pair;
23. LPIPS (``training/lpips.py``, a random VGG16 written by the phase in
   the ``{'vgg', 'lin'}`` layout, ``V2E2V_LPIPS_WEIGHTS`` set for (b)-(d)):
   (a) the distance at 180x240, B = 1 and 8, card against CPU (float32, TF32
   off, 1e-4 relative), with its ms per call; (b) the E2V CLI over phase
   9's first sequence with and without the variable: every frame's LPIPS
   against the CPU port's on the same frames (1e-4 relative), the PNGs byte
   for byte and the other metrics equal, K1 2 x depth per reconstruction;
   (c) the E2V train step with LPIPS at B = 8, T = 10, card against CPU under
   phase 13a's rule, a tensor past it held to 1.5x the card-CPU spread of
   the same step without LPIPS on the same batch, and ms per step and peak
   memory with and without LPIPS;
   (d) ``cli.train`` for one step with LPIPS: K3 once per frame pair, the
   loss finite;
24. MPEG-4 Part 2 video (``utils/mp4.py``, ``utils/mpeg4.py``,
   ``yuv.yuv420p_to_bgr``, ROADMAP item 4.2): (a) every MPEG-4 clip under
   ``tests/data/mpeg4`` (``scripts/make_mpeg4_fixtures.py``: the 12-frame
   960x720 flagship in MP4, MOV, M4V and XVID and FMP4 AVI, 25 frames with
   a second GOP, portrait, 30000/1001 fps, 75x49, noise and flat content)
   read by the port's ``VideoReader`` and ``VideoSequence`` against the JAX
   readers' records, as phase 21 (a); the host ms per 960x720 frame of
   each stage (demux, VLC decode, dequantisation + IDCT + motion
   compensation, conversion, resize) of the flagship MP4, I-VOPs and P-VOPs
   apart; (b) the V2E2V CLI with ``--reader_type video`` over the flagship
   MP4 read as 180x240 against its PNG twin, as phase 21 (b): every count
   set to 0 just before the video run (K3 once per frame pair, K1 2 x depth
   per pack), K3 and K1 held against their plain versions at every call of
   the twin run, output files and printed averages equal;
25. Matroska and WebM video (``utils/mkv.py``, ``utils/vp8dec.py``, ROADMAP
   item 4.2): (a) every clip under ``tests/data/mkv``
   (``scripts/make_mkv_fixtures.py``: the 12-frame 960x720 VP8 flagship in
   WebM and Matroska, a second key frame and golden refreshes, noise, flat
   content, 75x49, portrait, 30000/1001 and 23 fps, a live layout, MJPEG
   progressive and interlaced and MPEG-4 Part 2 in Matroska; a clip
   without ``DefaultDuration`` must be refused) read by the port's
   ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
   as phases 21 (a) and 24 (a), the flagship's frames decoded once for its
   four reads; the host ms per 960x720 frame of each stage of that decode
   (demux, boolean and token decode, prediction + IDCT, loop filter,
   conversion, resize), key and inter frames apart; (b) the V2E2V CLI with
   ``--reader_type video`` over the flagship WebM read as 180x240 against
   its PNG twin, as phase 21 (b): every count set to 0 just before the
   video run (K3 once per frame pair, K1 2 x depth per pack), K3 and K1
   held against their plain versions at every call of the twin run, output
   files and printed averages equal;
26. VP9 video in WebM and Matroska (``utils/vp9*.py``, ROADMAP item 4.2):
   (a) every clip under ``tests/data/vp9`` (``scripts/make_vp9_fixtures.py``:
   the 12-frame 960x720 VP9 flagship in WebM and Matroska, two tile
   columns and a golden refresh, a second key frame, noise, flat content,
   75x49, portrait, 30000/1001 fps, four tile columns) read by the port's
   ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
   the flagship's frames decoded once for its four reads, with the host ms
   per 960x720 frame of each stage (demux, headers and boolean / token
   decode, prediction + inverse transforms, loop filter, conversion,
   resize), key and inter frames apart; (b) the V2E2V CLI with
   ``--reader_type video`` over the flagship WebM against its PNG twin, as
   phase 25 (b);
27. MPEG-1 and MPEG-2 video (``utils/mpeg12*.py``, ``mpegps.py``,
   ``mpegts.py``, ROADMAP item 4.2): (a) every clip under
   ``tests/data/mpeg12`` (``scripts/make_mpeg12_fixtures.py``: the 12-frame
   960x720 MPEG-2 flagship in a program stream, one clip in VOB, TS, M2TS,
   AVI, MKV, MP4, MOV and MPG, MPEG-1 in MPG, AVI and MP4, open GOPs, noise,
   flat content, portrait, 30000/1001 fps, 74x48, and the clips whose
   estimated count is under their frames) read by the port's
   ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
   the flagship decoded once, with the host ms per 960x720 frame of each
   stage (demux and split, headers and macroblock symbols, dequantisation +
   IDCT + motion compensation, conversion, resize), I-, P- and B-pictures
   apart; (b) the V2E2V CLI with ``--reader_type video`` over the flagship
   ``.mpg`` against its PNG twin, as phase 21 (b);
28. raw and PNG video, and the decoders under cv2's other tags and
   containers (``utils/rawvideo.py``, the tag tables of ``avi.py``,
   ``mp4.py`` and ``mkv.py``, ROADMAP item 4.2 a-c): (a) every clip under
   ``tests/data/rawvideo`` and ``tests/data/pngvideo``
   (``scripts/make_rawvideo_fixtures.py``: MJPEG, MPEG-4, VP8 and VP9 under
   CJPG, LJPG, JPGL, mjpa, MP4S, M4S2, VP80, VP90, ``jpeg``, ``XVID``,
   ``DIVX``, object type 0x6C and ``vp09``; raw I420, IYUV, YV12, Y800,
   GREY and RGBA in AVI, MOV and Matroska, odd sizes, each Y800 width mod
   4, short, long and empty packets; PNG video in AVI, MOV, MP4 and
   Matroska, every colour type, the 12-frame 960x720 flagship) read by the
   port's ``VideoReader`` and ``VideoSequence`` against the JAX readers'
   records; (b) the host ms per 960x720 frame of each stage (demux, decode
   with inflate apart, to BGR, to gray, resize) of the PNG flagship and of
   12-frame raw I420 and Y800 clips written at run time; (c) the V2E2V CLI
   with ``--reader_type video`` over the PNG flagship against its PNG twin,
   as phase 21 (b);
29. H.263 and Sorenson H.263 video (``utils/h263.py``, ``utils/flv.py``,
   the H.263 tags of ``avi.py``, ``mp4.py`` and ``mkv.py``, ROADMAP item 4.2
   d, first half): (a) every clip under ``tests/data/h263``
   (``scripts/make_h263_fixtures.py``: the 12-frame 960x720 Sorenson
   flagship FLV, Sorenson H.263 in AVI, MOV and Matroska, H.263 at its
   three small sizes under every AVI tag cv2 writes, in MOV and Matroska,
   second I pictures, noise, flat content, a portrait and an odd-sized FLV,
   FLVs at 23, 24, 25 and 30000/1001 fps, disposable pictures, crafted GOB
   headers at 1 and 2 rows a GOB and every escape form) read by the port's
   ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
   the flagship decoded once; (b) the host ms per frame of each stage
   (demux, header and macroblock symbols, dequantisation + IDCT + motion
   compensation, conversion, resize), I- and P-pictures apart, of the
   flagship FLV and of a 704x576 H.263 AVI of random macroblocks written at
   run time, over three passes of a fresh decoder (the median and range of
   every picture's times, and the I-pictures' symbol ms pass by pass with
   the full garbage collections and the ms of collections that ran in
   each); (c) the V2E2V CLI with
   ``--reader_type video`` over the flagship FLV against its PNG twin, as
   phase 21 (b);
30. ASF files and the MS-MPEG-4 family (``utils/asf.py``,
   ``utils/msmpeg4.py``, ``utils/wmv2.py``, the family's tags in
   ``avi.py``, ``mkv.py`` and ``mp4.py``, ROADMAP item 4.2 d, second half):
   (a) every clip under ``tests/data/wmv`` (``scripts/make_wmv_fixtures.py``:
   the 12-frame 960x720 WMV2 flagship ``.wmv``, WMV1, WMV2, MS-MPEG-4 v2
   and v3 under every tag cv2 writes in ASF, AVI, Matroska and MOV, MPEG-4
   Part 2, Sorenson H.263 and MJPEG in ASF, the ASF rate and count sweep,
   second I-pictures, noise, flat content, 4CIF, odd sizes, and cv2's
   streams re-coded under the tables, slices, skip maps, vector predictors
   and mspel its writer never uses) read by the port's ``VideoReader`` and
   ``VideoSequence`` against the JAX readers' records, the flagship decoded
   once; (b) the host ms per 960x720 frame of each stage (as phase 29 (b),
   three passes), I- and P-pictures apart, of the WMV2 flagship and of the
   fixtures' 6-frame MS-MPEG-4 v3 AVI at that size; (c) the V2E2V CLI with
   ``--reader_type video`` over the flagship ``.wmv`` against its PNG twin,
   as phase 21 (b);
31. interlaced MPEG-2 (``utils/mpeg12*.py``: field pictures, field, 16x8
   and dual-prime motion, field DCT; ``utils/mpegrate.py``: cv2's rates and
   counts of soft-telecined and interlaced program and transport streams,
   ROADMAP item 4.2 e): (a) every clip under ``tests/data/mpeg2i``
   (``scripts/make_mpeg2i_fixtures.py``: the 12-frame 720x576 PAL flagship
   ``.vob`` of field pictures, field pictures of both orders and every motion
   type, interlaced frame pictures, a mix with concealment vectors, a
   DVD-like 3:2 soft-telecined stream, and cv2's clips with 3:2 patched in,
   in program streams, VOBs, transport streams, M2TS, AVI and Matroska) read
   by the port's ``VideoReader`` and ``VideoSequence`` against the JAX
   readers' records, the flagship decoded once; (b) the host ms per 720x576
   frame of each stage (demux and split, headers and macroblock symbols,
   dequantisation + IDCT + motion compensation, conversion, resize), I-, P-
   and B-frames apart, over three passes of a fresh decoder with the
   garbage collections in each, of the flagship (field pictures) and of a
   720x576 stream of interlaced frame pictures (frame, field and dual-prime
   motion, field DCT) the fixture script's writer codes here from the
   flagship's sequence header; (c) the V2E2V CLI with ``--reader_type
   video`` over the flagship's bytes as an ``.mpg`` (the CLIs list ``.mpg``,
   not ``.vob``) against its PNG twin, as phase 21 (b);
14. a ``{"kernels": [...]}`` JSON line (each row's launches on the paths of
   phases 10-13 and 15-31, every count set to 0 just before each path: K1,
   K2, K4 and the scale kernel counted by dtype, K3 by shot mode; the rows
   of K4 and the scale kernel hold their times per pool step, the 15 calls
   of one step summed), then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``v2e2v_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H, W, C, DEPTH, NB = 180, 240, 64, 5, 5
CAPACITY = 8
NUM_EVENTS = 15000  # events per request packet, the CLI's --num_events
EVENT_CAPACITY = 16384
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # atol and rtol
K1_SOURCE = "v2e2v_tpu_torch/csrc/ista.cu"
K1_REPLACES = "v2e2v_tpu/ops/pallas/ista.py:88"
K2_SOURCE = "v2e2v_tpu_torch/csrc/core.cu"
K2_REPLACES = "v2e2v_tpu/ops/pallas/core.py:194"
K2_VS_LAYERS_TOL = 3e-2  # the layers path casts every conv output to the dtype
K3_SOURCE = "v2e2v_tpu_torch/csrc/emulator_iters.cu"
K3_REPLACES = "v2e2v_tpu/ops/pallas/emulator_iters.py:93"
N_FRAMES, PACKS, RESET_AT, MAX_ITERS = 10, 6, 3, 32
V2E2V_TOL = 1e-4  # atol and rtol, float32 with TF32 off
CLI_FRAMES, CLI_SEQUENCES, CLI_EVENTS = 30, 2, (15000, 30000)
HFR_FRAMES, HFR_SEQUENCES = 37, 2  # the V2E2V CLI's dataset: 3 packs of 10 per sequence
# the checkpoint's emulator parameters (bench.py:170-176), and flags that differ
V2E_PARAMS = dict(C=0.6, ps=0.5, pl=1.5, cutoff_hz=200.0, qs=0.0, ql=1.0,
                  refractory_period_s=0.001)
V2E_FLAGS = ["--C", "0.3", "--pl", "1.0", "--ps", "1.0", "--cutoff_hz", "0", "--qs", "1",
             "--ql", "1", "--refractory_period_s", "0"]
# the emulator of bench.py:170-176, as the V2E2V CLI's flags give it
FLAGS = dict(image_dim=[H, W], base_channels=C, depth=DEPTH, num_bins=NB,
             event_mode="voxel_grid", pl=1.5, ps=0.5, ql=1.0, qs=0.0, C=0.6,
             threshold_sigma=0.03, cutoff_hz=200.0, refractory_period_s=0.001)
DNAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
EPILOGUES = ("D conv", "P conv", "pre-activation", "relu", "out gate")
# what runs the convs of K1 and K2 in each dtype
DESIGN = {torch.float32: "FFMA direct conv on CUDA cores (csrc/conv3x3.cuh): 8x32-pixel x "
                         "64-channel tiles (8x16 or 8x8 where the grid would not fill the "
                         "card), 64 float32 accumulators a thread, the next input row "
                         "prefetched into registers, 16-channel chunks staged by cp.async "
                         "(inputs) and one cp.async.bulk (taps laid out once) through a "
                         "2-stage ring, float32 products and sums",
          torch.bfloat16: "wgmma implicit GEMM on tensor cores (csrc/conv3x3_tc.cuh): 16x8-pixel "
                          "tiles staged once per 64-channel chunk for all 9 taps, taps laid out "
                          "once and streamed by cp.async.bulk through a 4-slot ring"}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, bool]:
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.all(diff <= tol + tol * want.float().abs()))
    return float(diff.max()), ok


def short_name(mangled: str) -> str:
    """K1's and K2's conv instances as <kernel><dtype, epilogue>, K2's cell
    kernels and the scale kernel's as <kernel><dtype>, K4's as <kernel><in,
    out, NB>, K3's as emulator_iters_kernel<shot mode>; others as given."""
    m = re.search(r"emulator_iters_kernelILi([012])E", mangled)
    if m:
        return f"emulator_iters_kernel<{('no shot', 'explicit', 'internal')[int(m.group(1))]}>"
    m = re.search(r"((?:ista|core)_conv3x3_tc_kernel)ILi([0-4])ELi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<bfloat16, {EPILOGUES[int(m.group(2))]}, NB={m.group(3)}>"
    m = re.search(r"((?:ista|core)_conv3x3_kernel)ILi([0-4])ELi([124])E", mangled)
    if m:
        return (f"{m.group(1)}<float32, {EPILOGUES[int(m.group(2))]}, "
                f"8x{8 * int(m.group(3))} tile>")
    types = {"a": "int8", "f": "float32", "13__nv_bfloat16": "bfloat16"}
    m = re.search(r"qconv3x3_kernelI(a|f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Li(\d+)E",
                  mangled)
    if m:  # S<n>_ repeats an earlier type of the name: the input's
        out = types.get(m.group(2), types[m.group(1)])
        return f"qconv3x3_kernel<in {types[m.group(1)]}, out {out}, NB={m.group(3)}>"
    m = re.search(r"qscale_kernelI(f|13__nv_bfloat16)E", mangled)
    if m:
        return f"qscale_kernel<{types[m.group(1)]}>"
    m = re.search(r"(core_lst[cm]_cell_kernel)I(\w+?)EEv", mangled)
    if m:
        return f"{m.group(1)}<{'bfloat16' if 'bfloat16' in m.group(2) else 'float32'}>"
    return mangled[:80]


def sass_counts(lib_path, opcode: str) -> dict[str, int]:
    """Instructions of ``opcode`` in each kernel of the built library, from
    ``cuobjdump --dump-sass``."""
    tool = shutil.which("cuobjdump") or str(Path("/usr/local/cuda/bin/cuobjdump"))
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
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


def issue_ms(fn, warmup: int = 3, iters: int = 20) -> tuple[float, float]:
    """``(device, host)`` ms per call of a launch-bound ``fn``: the card first
    spins (``torch.cuda._sleep``) for three times as long as the host takes
    to enqueue all calls, so the events time the launches back to back,
    without the host's gaps, and the host's clock times its enqueueing alone,
    without waits on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * 2e9 * iters * host_s) + 10_000_000)  # ~2 GHz clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host_s / iters


def device_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time per call of a launch-bound ``fn`` (``issue_ms``)."""
    return issue_ms(fn, warmup, iters)[0]


def ista_inputs(gen: torch.Generator, dtype: torch.dtype, weights: dict, b: int = CAPACITY):
    """K1's inputs at the pool's shape (batch ``b``): x1 and z ~ N(0, 0.5^2)
    in ``dtype``, and the ISTA block (HWIO D and P, biases, Lambda) of the
    model's weights."""
    h, w, c = H // 2, W // 2, C
    act = [(0.5 * torch.randn(b, h, w, k, generator=gen)).cuda().to(dtype) for k in (c, 2 * c)]
    blk = "lista_blocks.0."
    return (*act, weights[blk + "D.conv2d.weight"].permute(2, 3, 1, 0),
            weights[blk + "D.conv2d.bias"], weights[blk + "P.conv2d.weight"].permute(2, 3, 1, 0),
            weights[blk + "P.conv2d.bias"], weights[blk + "Lambda"].reshape(-1))


def ista_bound_ms(args, depth: int) -> tuple[float, str]:
    x1, z, dw, db, pw, pb, lam = args
    b, h, w, c = x1.shape
    flops = 2 * 9 * b * h * w * (2 * c * c + c * 2 * c) * depth
    elem = x1.element_size()
    n_bytes = elem * (x1.numel() + 2 * z.numel() + dw.numel() + db.numel() + pw.numel()
                      + pb.numel() + lam.numel())
    t_ops, t_bytes = flops / PEAK_FLOPS[x1.dtype], n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def core_inputs(gen: torch.Generator, dtype: torch.dtype, weights: dict):
    """K2's inputs at the pool's shape: the taps of the model's weights in
    ``dtype``, x1 ~ N(0, 0.5^2) and the recurrent state (z, cell, dg_h, dg_c)
    ~ N(0, 0.3^2)."""
    from v2e2v_tpu_torch.ops.cuda.core import core_taps

    b, h, w, c = CAPACITY, H // 2, W // 2, C
    x1 = (0.5 * torch.randn(b, h, w, c, generator=gen)).cuda().to(dtype)
    state = [(0.3 * torch.randn(b, h, w, k, generator=gen)).cuda().to(dtype)
             for k in (2 * c, 2 * c, c, c)]
    return (core_taps(weights, dtype), x1, *state)


def core_bound_ms(args, depth: int) -> tuple[float, str]:
    """Least time for K2's work: 2 * 9 * B*H*W * (32 + 4 depth) * C^2 FLOPs
    (52 C^2 multiply-adds per tap and pixel at depth 5) at the dtype's peak;
    x1 and the four state tensors read once, the four new state tensors
    written once (rec_h is dg_h), the taps and biases read once."""
    taps, x1, z, cell, dg_h, dg_c = args
    b, h, w, c = x1.shape
    flops = 2 * 9 * b * h * w * (32 + 4 * depth) * c * c
    n_bytes = x1.element_size() * (x1.numel() + 2 * (z.numel() + cell.numel() + dg_h.numel()
                                                     + dg_c.numel()))
    n_bytes += sum(t.numel() * t.element_size() for t in taps.values())
    t_ops, t_bytes = flops / PEAK_FLOPS[x1.dtype], n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def synthetic_packets(rng: np.random.Generator, n_packets: int, device):
    """Packets of ~15,000 events (the CLI's --num_events) over a 30 ms window,
    padded to a static capacity; returns (t, x, y, p, n_valid) on the card."""
    packets = []
    t0 = 0.0
    for _ in range(n_packets):
        n = int(rng.integers(NUM_EVENTS - 1000, NUM_EVENTS + 1))
        t = np.zeros(EVENT_CAPACITY)
        t[:n] = np.sort(t0 + rng.uniform(0.0, 0.03, n))
        t0 += 0.03
        x = np.zeros(EVENT_CAPACITY, np.int32)
        y = np.zeros(EVENT_CAPACITY, np.int32)
        p = np.zeros(EVENT_CAPACITY, np.int8)
        x[:n] = rng.integers(0, W, n)
        y[:n] = rng.integers(0, H, n)
        p[:n] = rng.integers(0, 2, n)
        packets.append(tuple(torch.from_numpy(a).to(device) for a in (t, x, y, p)) + (n,))
    return packets


def hfr_video(seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``PACKS`` packs of ``N_FRAMES`` HFR frames ``[B, N, H, W]`` in 0-255 and
    their ``[B, N]`` times (250 fps), consecutive packs sharing their boundary
    frame as the V2E2V CLI reads them (``test.py``). Each pixel flickers as
    ``base * exp(a * sin(2 pi f t + phase))`` with base in [30, 200], a in
    [0.2, 1], f in [2, 8] Hz, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    shape = (CAPACITY, 1, H, W)
    base = rng.uniform(30, 200, shape).astype(np.float32)
    amp = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    freq = rng.uniform(2.0, 8.0, shape).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    t = np.arange(PACKS * (N_FRAMES - 1) + 1, dtype=np.float32) * 0.004
    arg = 2 * np.pi * freq * t[None, :, None, None] + phase
    frames = np.clip(base * np.exp(amp * np.sin(arg)), 0, 255).astype(np.float32)
    packs = []
    for p in range(PACKS):
        sl = slice(p * (N_FRAMES - 1), p * (N_FRAMES - 1) + N_FRAMES)
        ts = np.tile(t[sl], (CAPACITY, 1))
        packs.append((torch.from_numpy(frames[:, sl].copy()).to(device),
                      torch.from_numpy(ts).to(device)))
    return packs


def k3_inputs(seed: int, shot: bool, gate_on: bool, internal: bool = False):
    """One frame pair's K3 inputs at the V2E2V shape: counts in [0, 40) (so all
    ``MAX_ITERS`` iterations run and some counts are clipped), polarity in
    {-1, 0, 1}, refractory 0.7 bins, shot probabilities up to 5%."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = CAPACITY, H, W
    counts = torch.randint(0, 40, (b, h, w), generator=g, dtype=torch.int32)
    num_iters = counts.amax(dim=(1, 2)).clamp(1, MAX_ITERS)
    x = dict(
        event_counts=counts, pol=torch.randint(-1, 2, (b, h, w), generator=g).float(),
        timestamp_mem=-torch.rand(b, h, w, generator=g), tr_frames=torch.full((b, h, w), 0.7),
        one_minus_on_prob=1.0 - 0.05 * torch.rand(b, h, w, generator=g),
        off_prob=0.05 * torch.rand(b, h, w, generator=g),
        rand01=torch.rand(MAX_ITERS, b, h, w, generator=g) if shot and not internal else None,
        seed=torch.randint(0, 2**62, (b,), generator=g) if internal else None,
        ts_step=torch.full((b,), 4.0) / num_iters.float(), num_iters=num_iters,
        gate=torch.full((b,), gate_on), tf_base=1.0,
    )
    x = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in x.items()}
    return x, dict(num_bins=NB, max_iters=MAX_ITERS, shot=shot, internal_rng=internal)


def k3_bound_ms(x: dict, kw: dict) -> tuple[float, str]:
    """Least time for K3's work on these inputs: 6 input planes read and
    num_bins + 2 output planes written once, plus the rand01 entries of the
    active iterations in explicit mode; 8 + 2 * num_bins float32 operations
    per pixel and iteration the data needs (to max(count, num_iters) with
    shot noise, to count without), on CUDA cores. Philox's integer operations
    are not counted."""
    b, h, w = x["event_counts"].shape
    nit = x["num_iters"].clamp(max=kw["max_iters"]).long()
    n_bytes = 4 * b * h * w * (6 + kw["num_bins"] + 2)
    if kw["shot"] and not kw["internal_rng"]:
        n_bytes += 4 * h * w * int(nit.sum())
    last = x["event_counts"].long()
    if kw["shot"]:
        last = torch.maximum(last, nit[:, None, None])
    flops = (8 + 2 * kw["num_bins"]) * int(last.clamp(max=kw["max_iters"]).sum())
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_k3(emulator_iters, emulator_iters_plain, seed: int) -> dict:
    """K3 against its plain version at the V2E2V shape, and its random modes."""
    errs = {"explicit": 0.0, "internal": 0.0}
    cases = [(shot, gate) for shot in (True, False) for gate in (True, False)]
    for i, (shot, gate) in enumerate(cases + [(True, True)]):
        internal = i == len(cases)
        x, kw = k3_inputs(seed + i, shot, gate, internal)
        got = emulator_iters(**x, **kw)
        want = emulator_iters_plain(**x, **kw)
        torch.cuda.synchronize()
        exact = torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        err = float((got[0] - want[0]).abs().max())
        ok = exact and err <= 1e-5
        mode = "internal" if internal else "explicit" if shot else "no shot"
        key = "internal" if internal else "explicit"
        errs[key] = max(errs[key], err)
        say(f"[k3] emulator_iters {mode}, gate {'on' if gate else 'off'}, B={CAPACITY} {H}x{W} "
            f"I={MAX_ITERS} nb={NB}: final and mem equal={exact}, voxel max_abs_err={err:.3e} "
            f"(tol 1e-5) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"K3 disagrees with its plain version ({mode}, gate {gate})")

    # internal uniforms: repeatable, and binomial with no threshold events
    p = 0.01
    x, kw = k3_inputs(seed + 10, True, False, internal=True)
    x |= dict(event_counts=torch.zeros_like(x["event_counts"]),
              pol=torch.where(x["pol"] >= 0, 1.0, -1.0),
              one_minus_on_prob=torch.full_like(x["pol"], 1.0 - p),
              off_prob=torch.full_like(x["pol"], p),
              num_iters=torch.full_like(x["num_iters"], MAX_ITERS),
              ts_step=torch.full_like(x["ts_step"], 4.0 / MAX_ITERS))
    n = CAPACITY * H * W * MAX_ITERS
    mean, sigma = n * p, (n * p * (1 - p)) ** 0.5
    first, again = emulator_iters(**x, **kw), emulator_iters(**x, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    total = int(first[2].sum())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_plain = dict(x, seed=None, rand01=torch.rand(MAX_ITERS, CAPACITY, H, W, device="cuda",
                                                   generator=gen))
    total_plain = int(emulator_iters_plain(**x_plain, **dict(kw, internal_rng=False))[2].sum())
    ok = same and abs(total - mean) < 5 * sigma and abs(total_plain - mean) < 5 * sigma
    say(f"[k3] internal Philox: same seed twice identical={same}; shot events with p={p} on "
        f"{n} pixel-iterations: kernel {total}, plain with torch uniforms {total_plain}, "
        f"expected {mean:.0f} +- {sigma:.0f} (5 sigma) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("K3's internal random numbers failed the repeat or binomial check")
    return errs


def run_v2e2v(cfg, weights, video, noise_seed: int, counters, state_before=None,
              explicit_shot: bool = False):
    """Pack by pack through ``v2e2v_forward``, a new sequence at ``RESET_AT``,
    the shot uniforms drawn from the card generator (``explicit_shot``) or made
    by Philox. Returns the outputs, the launches of each counter per pack, and
    (in ``state_before``) the state before the last pack."""
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import v2e2v_forward

    noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(noise_seed), explicit_shot)
    state, outs, launches = None, [], []
    for p, (frames, ts) in enumerate(video):
        if p == RESET_AT:
            state = None  # a new sequence, as test.py starts one
        if state_before is not None and p == len(video) - 1:
            state_before["state"] = state
        before = [c.launches for c in counters]
        out, state = v2e2v_forward(weights, cfg, frames, ts, state, noise)
        launches.append([c.launches - b for c, b in zip(counters, before)])
        outs.append(out)
    torch.cuda.synchronize()
    return outs, launches


def timed(fn, parts: dict, key: str):
    """``fn``, adding its host-clock seconds and one call to ``parts[key]``
    (a ``[seconds, calls]`` pair)."""
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            parts[key][0] += time.perf_counter() - t0
            parts[key][1] += 1
    return wrapper


@contextlib.contextmanager
def swapped(*patches):
    """Set each ``(obj, name, value)`` for the block, then restore them."""
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def cli_reconstructor(root: Path, model: Path, dtype: torch.dtype, out: str, ista_impl: str,
                      extra: tuple = ()):
    """The CLI's ``Reconstructor`` over the dataset at ``root`` with the
    reference CLI's defaults at full width and the flags ``extra``, its ISTA
    loop as ``ista_impl``."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(root),
        "--image_dim", str(H), str(W), "-c", str(C),
        "-d", str(DEPTH), "-b", str(NB), "--num_events", str(NUM_EVENTS), "--test_data_mode",
        "real", "--precision", DNAME[dtype], "-o", str(root.parent / out), *extra])
    rec = cli.Reconstructor(cfgs, "cuda")
    if ista_impl != rec.cfg.ista_impl:
        rec.cfg = dataclasses.replace(rec.cfg, ista_impl=ista_impl)
        rec.step = cli.make_step(rec.cfg, cli.DTYPES[cfgs.precision])
    return rec


def record_steps(rec, keep_state: bool, events: list | None = None) -> list:
    """Wrap ``rec.step``: each step appends ``(reconstruction, state or
    None)`` to the returned list and, given ``events``, its CUDA event pair
    around the step."""
    step, steps = rec.step, []

    def recorded(*a):
        if events is not None:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out_, st = step(*a)
        if events is not None:
            ev[1].record()
            events.append(ev)
        steps.append((out_, st if keep_state else None))
        return out_, st

    rec.step = recorded
    return steps


def cli_phase(seed: int, cfg, smi: str, tmp: Path) -> dict:
    """Phase 9: the E2V evaluation CLI at full width: the plain ISTA first,
    then the main path (K1) with every count set to 0 just before it, then
    the main path again with K1 held against its plain version at every call
    and the state against the plain run's at every step. Its dataset, model
    and outputs stay under ``tmp`` (phase 18e reads them). Returns K1's
    launches on the main path and its largest error per dtype."""
    from v2e2v_tpu_torch import runtime
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch.models.cista import init_cista_lstc
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
    from v2e2v_tpu_torch.ops.voxel import voxelize_and_preprocess_np
    from v2e2v_tpu_torch.utils import data_io

    t_phase = time.perf_counter()
    tmp.mkdir(parents=True)
    cli_k1 = {}
    data, model = tmp / "data", tmp / "model.pth.tar"
    t0 = time.perf_counter()
    write_dataset(data, seed, CLI_SEQUENCES, CLI_FRAMES, H, W, CLI_EVENTS)
    sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    torch.save({"epoch": 0, "state_dict": sd, "v2e_params": None}, model)
    say(f"[cli] dataset: {CLI_SEQUENCES} sequences of {CLI_FRAMES} PNG frames {H}x{W}, "
        f"{CLI_EVENTS[0]}-{CLI_EVENTS[1]} events per interval (.npz), written in "
        f"{time.perf_counter() - t0:.1f} s; native runtime built={runtime.available()} "
        f"({runtime.library_path().name})")
    if not runtime.available():
        fail("the native runtime (g++) did not build on this machine")
    for dtype in (torch.float32, torch.bfloat16):
        name, tol = DNAME[dtype], TOL[dtype]
        plain = cli_reconstructor(data, model, dtype, f"plain_{name}", "plain")
        plain_steps = record_steps(plain, keep_state=True)
        plain.run()

        # the main path, timed: the reader (frames, events, host voxelise)
        # and the work after the model (norms, metrics, PNG write) by
        # wrapping them, the step by CUDA events
        rec = cli_reconstructor(data, model, dtype, f"cuda_{name}", "cuda")
        step_ev = []
        steps = record_steps(rec, keep_state=False, events=step_ev)
        parts = {k: [0.0, 0] for k in ("read", "post", "evaluate")}
        reader = rec.video_renderer
        post = (
            (image, "normalize_image_minmax_u8",
             timed(image.normalize_image_minmax_u8, parts, "post")),
            (image, "normalize_image_percentile",
             timed(image.normalize_image_percentile, parts, "post")),
            (data_io.ImageWriter, "__call__",
             timed(data_io.ImageWriter.__call__, parts, "post")))
        reader.update_event_frame_pack = timed(reader.update_event_frame_pack, parts, "read")
        rec.evaluate = timed(rec.evaluate, parts, "evaluate")
        ista_loop.launches = cista_core.launches = emulator_iters.launches = 0
        served = voxelize_and_preprocess_np.served
        served.update(native=0, numpy=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with swapped(*post):
            t0 = time.perf_counter()
            rec.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        k1_n, other_n = ista_loop.launches, cista_core.launches + emulator_iters.launches
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        n_rec, n_frames = len(steps), parts["evaluate"][1]
        out_dir = tmp / f"cuda_{name}" / "model.pth"
        pngs = sorted(out_dir.glob("*/frame_*.png"))
        rows = [(out_dir / d.name / "result.csv").read_text().splitlines()
                for d in sorted(out_dir.iterdir())]
        stacked = torch.stack([r for r, _ in steps])
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        ok = (finite and in_range and k1_n == 2 * DEPTH * n_rec and other_n == 0
              and len(pngs) == n_frames == CLI_SEQUENCES * (CLI_FRAMES - 1)
              and len(rows) == CLI_SEQUENCES and all(len(r) == 2 for r in rows)
              and served["native"] == n_rec and served["numpy"] == 0)
        say(f"[cli] {name}: {n_frames} frames, {n_rec} reconstructions of {H}x{W} "
            f"(C={C}, depth {DEPTH}, --num_events {NUM_EVENTS}, real); K1 launches {k1_n} "
            f"(want 2 x depth x {n_rec} = {2 * DEPTH * n_rec}), K2 and K3 {other_n}; host "
            f"voxeliser served native {served['native']}, numpy {served['numpy']}; "
            f"{len(pngs)} PNGs, result.csv rows {[r[1] for r in rows]}; finite={finite} "
            f"in[0,1]={in_range} {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the CLI's main path in {name} did not run as it should")
        if len(plain_steps) != n_rec:
            fail(f"the plain run made {len(plain_steps)} reconstructions, not {n_rec}")
        err, ok = within(stacked, torch.stack([r for r, _ in plain_steps]), tol)
        say(f"[cli] {name}: reconstructions through K1 vs the plain ISTA, {n_rec} recurrent "
            f"steps: max_abs_err={err:.3e} (tol {tol} + {tol} |ref|) "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the CLI through K1 disagrees with the plain ISTA in {name}")

        # the main path again, untimed: K1 held against its plain version
        # on each call's own inputs (B = 1), the state against the plain
        # run's at each step; launches here are not the main path's
        chk = cli_reconstructor(data, model, dtype, f"check_{name}", "cuda")
        chk_steps, k1_errs = record_steps(chk, keep_state=True), []

        def k1_checked(*a, **k):
            got = ista_loop(*a, **k)
            k1_errs.append(within(got, ista_loop_plain(*a, **k), tol))
            return got

        with swapped((cista_mod, "ista_loop", k1_checked)):
            chk.run()
        same = len(chk_steps) == n_rec and all(
            torch.equal(a, b) for (a, _), (b, _) in zip(chk_steps, steps))
        k1_err = max(e for e, _ in k1_errs)
        ok = same and len(k1_errs) == n_rec and all(o for _, o in k1_errs)
        say(f"[cli] {name}: K1 against its plain version on each of the {len(k1_errs)} "
            f"calls of the CLI path (B=1, {H // 2}x{W // 2}, C={C}, depth {DEPTH}): "
            f"max_abs_err={k1_err:.3e} (tol {tol} + {tol} |ref|); reconstructions "
            f"identical to the timed run's: {same} {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 disagrees with its plain version on the CLI path in {name}")
        state_err = {}
        for field in ("z", "cell", "dg h", "dg c"):
            errs = [within(pick(a, field), pick(b, field), tol)
                    for (_, a), (_, b) in zip(chk_steps, plain_steps)]
            state_err[field] = (max(e for e, _ in errs), all(o for _, o in errs))
        ok = all(o for _, o in state_err.values())
        say(f"[cli] {name}: state through K1 vs the plain run at each of {n_rec} steps, "
            f"max_abs_err " + ", ".join(f"{f} {e:.3e}" for f, (e, _) in state_err.items())
            + f" (tol {tol} + {tol} |ref|) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the CLI's state through K1 disagrees with the plain run's in {name}")
        cli_k1[dtype] = {"cli_launches": k1_n, "cli_max_abs_err": k1_err}
        del plain_steps, chk_steps

        step_ms = sum(a.elapsed_time(b) for a, b in step_ev) / n_rec
        read_ms = 1e3 * parts["read"][0] / n_rec
        post_ms = 1e3 * (parts["post"][0] + parts["evaluate"][0]) / n_frames
        rest_ms = 1e3 * run_s - read_ms * n_rec - post_ms * n_frames - step_ms * n_rec
        say(f"[time] CLI {name} ({smi}): run() {run_s:.3f} s host clock, "
            f"{n_rec / run_s:.1f} reconstructions/s, {n_frames / run_s:.1f} frames/s; per "
            f"reconstruction: reader + voxelise {read_ms:.3f} ms (host), model step "
            f"{step_ms:.3f} ms (CUDA events); per frame: normalise + metrics + PNG write "
            f"{post_ms:.3f} ms (host); the rest of run() (transfers, syncs, Python) "
            f"{rest_ms / n_rec:.3f} ms per reconstruction; max_memory_allocated "
            f"{peak:.1f} MiB above what earlier phases hold ({base / 2**20:.1f} MiB)")
    host_breakdown(data, smi)
    say(f"[phase] CLI runs {time.perf_counter() - t_phase:.1f} s")
    return cli_k1


def pick(state, field: str) -> torch.Tensor:
    """One tensor of a ``CistaState``: z, cell, or the Dg ConvLSTM's h or c."""
    return {"z": state.z, "cell": state.cell, "dg h": state.dg[0], "dg c": state.dg[1]}[field]


def host_breakdown(data: Path, smi: str) -> None:
    """Where the CLI's host time goes, part by part, on the first sequence
    (host clock, no model): PNG decode, event window load, host voxelise (per
    reconstruction) and each of the per-frame steps after the model."""
    from v2e2v_tpu_torch.data import event_readers, video_readers
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.utils import evaluate, image_io

    parts = {k: [0.0, 0] for k in ("png decode", "events load", "voxelise", "minmax norm",
                                   "gt percentile norm", "mse+psnr", "ssim", "png write")}
    n_rec = n_frames = 0
    with swapped(
            (video_readers, "read_gray", timed(video_readers.read_gray, parts, "png decode")),
            (video_readers, "voxelize_and_preprocess_np",
             timed(video_readers.voxelize_and_preprocess_np, parts, "voxelise")),
            (event_readers.NpzEventReader, "__next__",
             timed(event_readers.NpzEventReader.__next__, parts, "events load"))):
        reader = video_readers.ImageReader([H, W], num_bins=NB, is_with_events=True)
        reader.initialize(str(sorted(data.iterdir())[0]), -1)
        out = data.parent / "breakdown.png"
        while not reader.ending:
            grids, gt = reader.update_event_frame_pack(NUM_EVENTS, "real")
            n_rec += len(grids)
            n_frames += 1
            pred = np.ascontiguousarray(grids[-1][0] * 0.1 + 0.5, dtype=np.float32)
            u8 = timed(image.normalize_image_minmax_u8, parts, "minmax norm")(pred)
            gt_n = timed(image.normalize_image_percentile, parts, "gt percentile norm")(
                gt.astype(np.float32))
            pred_f = u8 / 255.0
            timed(lambda a, b: (evaluate.mse(a, b), evaluate.psnr(a, b)), parts,
                  "mse+psnr")(pred_f, gt_n)
            timed(evaluate.ssim, parts, "ssim")(pred_f, gt_n)
            timed(image_io.write_gray, parts, "png write")(str(out), u8)
    per = {k: 1e3 * s / (n_rec if k == "voxelise" else n_frames) for k, (s, _) in parts.items()}
    say(f"[time] CLI host path by part ({smi}; {n_frames} frames, {n_rec} reconstructions, "
        f"host clock): per frame read: png decode {per['png decode']:.3f} ms, events load "
        f"{per['events load']:.3f} ms; per reconstruction: voxelise (native) "
        f"{per['voxelise']:.3f} ms; per frame after the model: minmax norm "
        f"{per['minmax norm']:.3f} ms, gt percentile norm {per['gt percentile norm']:.3f} ms, "
        f"mse+psnr {per['mse+psnr']:.3f} ms, ssim {per['ssim']:.3f} ms, png write "
        f"{per['png write']:.3f} ms")


def v2e2v_cli(data: Path, model: Path, out: Path, seed: int, noise_for_sequence=None,
              plain: bool = False, extra: tuple = ()):
    """The V2E2V CLI's ``V2E2V`` over ``data`` at full width with the flags
    ``extra``, the flags' emulator parameters overridden by the checkpoint's,
    writing event previews; with ``plain``, through the plain versions of K3
    and K1."""
    from v2e2v_tpu_torch.cli import test as cli
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(data), "--image_dim",
        str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB), "--seed", str(seed),
        "--is_write_event", "-o", str(out), *V2E_FLAGS, *extra])
    run = cli.V2E2V(cfgs, "cuda", noise_for_sequence)
    if plain:
        run.cfg = V2E2VConfig(dataclasses.replace(run.cfg.cista, ista_impl="plain"),
                              dataclasses.replace(run.cfg.emulator, iters_impl="plain"))
    return run


def recorded_forward(records: list, events: list | None = None):
    """Patch ``models.v2e2v.v2e2v_forward`` (the CLI imports it when it runs)
    to append ``(output, [K3, K1] launches, frame pairs)`` per pack and, given
    ``events``, a CUDA event pair around each call."""
    from v2e2v_tpu_torch.models import v2e2v as v2e2v_mod
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop

    forward = v2e2v_mod.v2e2v_forward

    def recorded(params, cfg, frames, *a, **k):
        before = (emulator_iters.launches, ista_loop.launches)
        if events is not None:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out, state = forward(params, cfg, frames, *a, **k)
        if events is not None:
            ev[1].record()
            events.append(ev)
        records.append((out, [emulator_iters.launches - before[0],
                              ista_loop.launches - before[1]], frames.shape[1] - 1))
        return out, state

    return swapped((v2e2v_mod, "v2e2v_forward", recorded))


def v2e2v_cli_phase(seed: int, smi: str, root: Path) -> dict:
    """Phase 10: the V2E2V CLI at full width over two sequences of 37 HFR
    frames: run 1 through the plain versions and run 2 through K3 and K1,
    both with the same explicit draws from card generators; then run 3, the
    default path (internal Philox), with every count set to 0 just before it.
    Returns run 3's launches by row of the kernels line and the dataset."""
    from v2e2v_tpu_torch.cli import test as cli_test
    from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset
    from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.utils import data_io

    t_phase = time.perf_counter()
    data, model = root / "hfr", root / "v2e2v.pth.tar"
    write_hfr_dataset(data, seed, HFR_SEQUENCES, HFR_FRAMES, H, W)
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    torch.save({"epoch": 0, "v2e_params": V2E_PARAMS,
                "state_dict": {f"e2v_net.{k}": v for k, v in sd.items()}}, model)

    def explicit(i):
        # the default path's generator seed (run 3), the shot uniforms drawn from it
        return GeneratorNoise(torch.Generator(device="cuda").manual_seed(
            cli_test.sequence_seed(seed, i)), explicit_shot=True)

    runs = {}
    for name, plain in (("run 1 (plain)", True), ("run 2 (K3, K1)", False)):
        run = v2e2v_cli(data, model, root / f"v2e2v_{len(runs)}", seed, explicit, plain)
        records = []
        with recorded_forward(records), contextlib.redirect_stdout(None):
            run.run()
        torch.cuda.synchronize()
        runs[name] = records
    want_emu = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS)).emulator
    if run.cfg.emulator != want_emu:
        fail(f"the checkpoint's v2e_params did not override the flags: {run.cfg.emulator}")
    (r1, r2) = runs.values()
    ev1, ev2 = [int(o.num_events) for o, _, _ in r1], [int(o.num_events) for o, _, _ in r2]
    launches2 = [n for _, n, _ in r2]
    pairs = [p for _, _, p in r2]
    rec2 = torch.stack([o.reconstruction for o, _, _ in r2])
    err, ok = within(rec2, torch.stack([o.reconstruction for o, _, _ in r1]), V2E2V_TOL)
    ok = ok and ev1 == ev2 and len(r2) == 3 * HFR_SEQUENCES and min(ev2) > 0
    ok = ok and [n for _, n, _ in r1] == [[0, 0]] * len(r1)
    ok = ok and launches2 == [[p, 2 * DEPTH] for p in pairs]
    say(f"[v2e2v-cli] {HFR_SEQUENCES} sequences of {HFR_FRAMES} PNG frames {H}x{W} (250 fps), "
        f"{len(r2)} packs of 10 frames; checkpoint v2e_params override "
        f"the flags {' '.join(V2E_FLAGS)}: emulator == bench.py's: True; run 1 (plain) vs run "
        f"2 (K3, K1), same explicit draws: num_events {ev1} vs {ev2} equal={ev1 == ev2}; K3, K1 "
        f"launches per pack in run 2 {launches2} (want frame pairs {pairs}, 2 x depth); "
        f"reconstructions max_abs_err={err:.3e} (tol atol=rtol={V2E2V_TOL}) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI through K3 and K1 disagrees with its plain versions")

    # run 3: the main path, timed from outside (the CLI carries no timers)
    run = v2e2v_cli(data, model, root / "v2e2v_main", seed)
    parts = {k: [0.0, 0] for k in ("read", "write")}
    run.video_renderer.update_frame_pack = timed(run.video_renderer.update_frame_pack, parts,
                                                 "read")
    writes = ((image, "normalize_image_minmax_u8",
               timed(image.normalize_image_minmax_u8, parts, "write")),
              (data_io, "make_event_preview", timed(data_io.make_event_preview, parts, "write")),
              (data_io.ImageWriter, "__call__", timed(data_io.ImageWriter.__call__, parts,
                                                      "write")),
              (data_io.EventWriter, "__call__", timed(data_io.EventWriter.__call__, parts,
                                                      "write")))
    records, step_ev = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts_zero(*kernel_counters())
    with recorded_forward(records, step_ev), swapped(*writes):
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    k3_n, k1_n, k2_n = emulator_iters.launches, ista_loop.launches, cista_core.launches
    k3_internal = emulator_iters.launches_by_shot["internal"]
    rows = row_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    n_packs = len(records)
    ev3 = [int(o.num_events) for o, _, _ in records]
    rec3 = torch.stack([o.reconstruction for o, _, _ in records])
    finite = bool(torch.isfinite(rec3).all())
    in_range = bool(((rec3 >= 0) & (rec3 <= 1)).all())
    out_dir = root / "v2e2v_main" / "v2e2v.pth"
    pngs = sorted(out_dir.glob("*/frame_*.png"))
    previews = sorted(out_dir.glob("*/events/events_*.png"))
    close = len(ev3) == len(ev2) and all(abs(a - b) <= 0.01 * b for a, b in zip(ev3, ev2))
    ok = (finite and in_range and close and k2_n == 0 and n_packs == len(r2)
          and k3_n == k3_internal == sum(pairs) and k1_n == 2 * DEPTH * n_packs
          and [n for _, n, _ in records] == [[p, 2 * DEPTH] for p in pairs]
          and len(pngs) == len(previews) == n_packs)
    say(f"[v2e2v-cli] run 3 (default path, internal Philox; counts set to 0 just before): "
        f"{n_packs} packs, K3 launches {k3_n} (internal {k3_internal}; want {sum(pairs)}, one "
        f"per frame pair), K1 {k1_n} (want {2 * DEPTH * n_packs}), K2 {k2_n}; num_events {ev3} "
        f"within 1% of run 2's={close}; {len(pngs)} reconstruction PNGs, {len(previews)} event "
        f"previews; finite={finite} in[0,1]={in_range} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI's main path did not run as it should")
    step_ms = sum(a.elapsed_time(b) for a, b in step_ev) / n_packs
    read_ms = 1e3 * parts["read"][0] / n_packs
    write_ms = 1e3 * parts["write"][0] / n_packs
    say(f"[time] V2E2V CLI ({smi}), batch 1, {H}x{W}, float32: run() {run_s:.3f} s host clock, "
        f"{n_packs / run_s:.2f} packs/s; per pack: reader {read_ms:.3f} ms (host), emulate + "
        f"reconstruct {step_ms:.3f} ms (CUDA events around v2e2v_forward), minmax norm + "
        f"preview + PNG writes {write_ms:.3f} ms (host), the rest of run() "
        f"{1e3 * run_s / n_packs - read_ms - step_ms - write_ms:.3f} ms; max_memory_allocated "
        f"{peak:.1f} MiB above what earlier phases hold ({base / 2**20:.1f} MiB)")
    say(f"[phase] V2E2V CLI runs {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "data": data, "model": model, "out": out_dir}


def raw_phase(seed: int, smi: str, root: Path, data: Path) -> dict[str, int]:
    """Phase 11: the generation tool over phase 10's dataset, then one pack
    with the same explicit draws through raw mode and through voxel mode.
    Returns the tool's launches by row of the kernels line."""
    from v2e2v_tpu_torch.cli import generate_events as gen
    from v2e2v_tpu_torch.data.video_readers import ImageReader
    from v2e2v_tpu_torch.models.emulator import (
        GeneratorNoise,
        bin_raw_events,
        emulate_pack,
        emulate_pack_raw,
    )
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.voxel import event_preprocess
    from v2e2v_tpu_torch.utils.configs import set_configs

    t_phase = time.perf_counter()
    parser = argparse.ArgumentParser()
    set_configs(parser)
    out = root / "generated"
    cfgs = parser.parse_args(["--path_to_test_data", str(data), "--image_dim", str(H), str(W),
                              "-b", str(NB), "--seed", str(seed), "-o", str(out),
                              *[a for k, v in V2E_PARAMS.items() for a in (f"--{k}", str(v))]])
    counts_zero(*kernel_counters())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        total = gen.generate(cfgs, torch.device("cuda"))
    gen_s = time.perf_counter() - t0
    rows = row_counts()
    files = sorted(out.glob("*/events/events_*.npz"))
    in_files = sum(len(np.load(f)["t"]) for f in files)
    # per sequence: 9 intervals in the first pack, 8 in each later one
    want_files = HFR_SEQUENCES * (9 + 8 * (HFR_FRAMES // 9 - 2))
    ok = len(files) == want_files and in_files == total > 0 and not any(rows.values())
    say(f"[raw] generate_events over phase 10's dataset: {len(files)} .npz files (want "
        f"{want_files}, one per frame interval), {in_files} events in them, printed total "
        f"{total}, launches {rows} (raw mode records events "
        f"with the plain loop); {gen_s:.3f} s host clock {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the event generation tool did not write every event once")

    reader = ImageReader([H, W])
    reader.initialize(str(sorted(data.iterdir())[0]), -1)
    frames, _, ts = reader.update_frame_pack(10)
    frames = torch.from_numpy(frames.astype(np.float32))[None].cuda()
    ts = torch.from_numpy(ts.astype(np.float32))[None].cuda()
    emu = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS)).emulator
    emu_raw = dataclasses.replace(emu, output_mode="raw")

    def noise():
        return GeneratorNoise(torch.Generator(device="cuda").manual_seed(seed + 7),
                              explicit_shot=True)

    before = emulator_iters.launches
    events, n_raw, _ = emulate_pack_raw(emu_raw, None, frames, ts, noise(), device="cuda")
    raw_k3 = emulator_iters.launches - before
    voxel, n_vox, _ = emulate_pack(emu, None, frames, ts, noise(), device="cuda")
    vox_k3 = emulator_iters.launches - before - raw_k3
    binned = bin_raw_events(events, 1, H, W, NB, device="cuda")
    normed = event_preprocess(binned.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err, close = within(normed, voxel, V2E2V_TOL)
    ok = close and n_raw == int(n_vox) == len(events) > 0 and raw_k3 == 0 and vox_k3 == 9
    say(f"[raw] one pack of 10 frames {H}x{W}, the same explicit draws: emulate_pack_raw "
        f"{n_raw} events (K3 launches {raw_k3}), emulate_pack {int(n_vox)} (K3 {vox_k3}); raw "
        f"events binned in time and normalised vs K3's voxel grid: max_abs_err={err:.3e} (tol "
        f"atol=rtol={V2E2V_TOL}) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("raw mode and voxel mode disagree on the card")
    raw_ms = time_ms(lambda: emulate_pack_raw(emu_raw, None, frames, ts, noise(), device="cuda"),
                     1, 3)
    vox_ms = time_ms(lambda: emulate_pack(emu, None, frames, ts, noise(), device="cuda"), 1, 3)
    say(f"[time] one pack, batch 1, {H}x{W} ({smi}): emulate_pack_raw {raw_ms:.3f} ms (plain "
        f"loop, masks to the host, extraction and sorts), emulate_pack {vox_ms:.3f} ms (K3), "
        f"both as the host issues them (CUDA events, explicit draws)")
    say(f"[phase] raw-event generation {time.perf_counter() - t_phase:.1f} s")
    return rows


def tc_phase(seed: int, smi: str, root: Path, serve, served: dict) -> dict:
    """Phase 12: CISTA-TC at full width: a StreamPool on phase 4's schedule
    and voxel grids in float32 and bfloat16 (counts set to 0 just before;
    K1 and K2 stay at 0), one stream's first 3 steps against the CPU, then the
    E2V CLI with --model_mode cista-tc over one sequence. Returns the pool
    runs' launches by row of the kernels line."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models.cista import (
        CistaConfig,
        cista_tc_step,
        cista_zero_state,
        init_cista_tc,
    )
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.serving import StreamPool
    from v2e2v_tpu_torch.utils.configs import set_configs

    t_phase = time.perf_counter()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      model_mode="cista-tc")
    sd = init_cista_tc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    recs, launches, pool_rows = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        pool = StreamPool(cfg, sd, CAPACITY, dtype, device="cuda")
        snaps, step = [], pool.step

        def stepped(*a, pool=pool, step=step, snaps=snaps, **k):
            out = step(*a, **k)
            st = pool._states
            snaps.append([t[0].float().clone() for t in (pool._prev, st.z, st.cell, *st.dg)])
            return out

        pool.step = stepped
        counts_zero(ista_loop, cista_core, emulator_iters)
        recs[dtype], _, _ = serve(pool, served[dtype])
        launches[dtype] = ista_loop.launches + cista_core.launches + emulator_iters.launches
        pool_rows = add_counts(pool_rows, row_counts())
        stacked = torch.stack(list(recs[dtype].values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        ok = finite and in_range and launches[dtype] == 0
        say(f"[tc] pool {DNAME[dtype]}: {len(recs[dtype])} reconstructions of {H}x{W} "
            f"(CISTA-TC, C={C}, depth {DEPTH}); K1, K2, K3 launches {launches[dtype]} (want 0: "
            f"no kernel of the port computes CISTA-TC); finite={finite} in[0,1]={in_range} "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the CISTA-TC pool in {DNAME[dtype]} did not run as it should")
        if dtype == torch.float32:
            state = cista_zero_state(cfg, 1, torch.float32, "cpu")
            prev = torch.zeros((1, H, W, 1))
            errs = []
            for r in range(3):
                prev, state = cista_tc_step(sd, cfg, served[dtype][(0, r)].float().cpu()[None],
                                            prev, state)
                want = [prev[0], state.z[0], state.cell[0], state.dg[0][0], state.dg[1][0]]
                errs += [within(g.cpu(), w_, TOL[dtype]) for g, w_ in zip(snaps[r], want)]
            ok = all(o for _, o in errs)
            say(f"[tc] float32 stream 0, first 3 steps, card vs CPU (same weights and voxel "
                f"grids): reconstruction and state (z, cell, Dg h, c) max_abs_err="
                f"{max(e for e, _ in errs):.3e} (tol {TOL[dtype]} + {TOL[dtype]} |ref|) "
                f"{'pass' if ok else 'FAIL'}")
            if not ok:
                fail("CISTA-TC on the card disagrees with the CPU")
    err, ok = within(torch.stack(list(recs[torch.bfloat16].values())),
                     torch.stack(list(recs[torch.float32].values())), TOL[torch.bfloat16])
    say(f"[tc] bfloat16 vs float32 pool: max_abs_err={err:.3e} (tol 3e-2 + 3e-2 |ref|) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the bfloat16 CISTA-TC pool disagrees with float32")

    vox = [served[torch.float32][k] for k in sorted(served[torch.float32])[:CAPACITY]]
    for dtype in (torch.float32, torch.bfloat16):
        pool = StreamPool(cfg, sd, CAPACITY, dtype, device="cuda")
        sids = [pool.attach() for _ in range(CAPACITY)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.step({sid: vox[j] for j, sid in enumerate(sids)}, fetch=False)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        step_ms = float(np.median(times))
        say(f"[time] CISTA-TC pool {DNAME[dtype]} capacity {CAPACITY}, all active ({smi}): step "
            f"{step_ms:.3f} ms (median of {len(times)}, host clock, min {min(times):.3f}), "
            f"{CAPACITY * 1e3 / step_ms:.1f} reconstructions/s; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        del pool

    data, model = root / "tc_data", root / "tc_model.pth.tar"
    write_dataset(data, seed, 1, CLI_FRAMES, H, W, CLI_EVENTS)  # phase 9's first sequence
    torch.save({"epoch": 0, "state_dict": sd}, model)
    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(data), "--image_dim",
        str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB), "--model_mode",
        "cista-tc", "-o", str(root / "tc_cli")])
    ista_loop.launches = cista_core.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        cli.Reconstructor(cfgs, "cuda").run()
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    out_dir = root / "tc_cli" / "tc_model.pth"
    pngs = sorted(out_dir.glob("*/frame_*.png"))
    rows = [f.read_text().splitlines() for f in sorted(out_dir.glob("*/result.csv"))]
    k_n = ista_loop.launches + cista_core.launches
    ok = len(pngs) == CLI_FRAMES - 1 and len(rows) == 1 and len(rows[0]) == 2 and k_n == 0
    say(f"[tc] E2V CLI --model_mode cista-tc, float32, one sequence of {CLI_FRAMES} frames: "
        f"{len(pngs)} PNGs, result.csv row {rows[0][1] if rows else None!r}, K1 and K2 "
        f"launches {k_n}; run() {cli_s:.3f} s host clock {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V CLI with cista-tc did not run as it should")
    say(f"[phase] CISTA-TC {time.perf_counter() - t_phase:.1f} s")
    return pool_rows


TRAIN_T, TRAIN_LR = 10, 1e-4  # --len_sequence and --lr defaults
TRAIN_CPU_B = 2  # the CPU's side of the card-vs-CPU step (phase 13a)
GRAD_TOL = 1e-3  # of each gradient tensor's largest entry
TRAIN_SEQ_FRAMES = TRAIN_T * (N_FRAMES - 1) + 1  # one V2E2V video: TRAIN_T pack lines


def train_batch(seed: int, b: int, t: int = TRAIN_T):
    """A training batch at full width: voxel grids ``[t, b, H, W, NB]`` ~ N(0, 1)
    (as the std-normalised grids are) and a smooth target ``[b, H, W, 1]``
    in [0, 1] (frames of ``data/synthetic.hfr_frames`` / 255)."""
    from v2e2v_tpu_torch.data.synthetic import hfr_frames

    seq = torch.randn(t, b, H, W, NB, generator=torch.Generator().manual_seed(seed))
    frames, _ = hfr_frames(seed, 1, H, W, batch=b)
    return seq, torch.from_numpy(frames[:, 0, :, :, None] / 255.0)


def train_weights(cfg, seed: int, device):
    """CISTA-LSTC init weights from ``seed`` with the ISTA block tied."""
    from v2e2v_tpu_torch.models.cista import init_cista_lstc, tie_weights

    return tie_weights(init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device), cfg)


def counts_zero(*counters) -> None:
    for c in counters:
        c.launches = 0
        for split in ("launches_by_dtype", "launches_by_shot", "launches_by_input"):
            if hasattr(c, split):
                getattr(c, split).update(dict.fromkeys(getattr(c, split), 0))


def kernel_counters() -> tuple:
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3
    from v2e2v_tpu_torch.ops.cuda.qscale import act_scale

    return ista_loop, cista_core, emulator_iters, qconv3x3, act_scale


def row_counts() -> dict[str, int]:
    """The launches of each row of the kernels line since the counts were set
    to 0: K1, K2, K4 and the scale kernel by dtype (K4's out dtype, the scale
    kernel's input dtype), K3 by shot mode, as the wrappers count them."""
    k1, k2, k3, k4, k5 = kernel_counters()
    rows = {f"{k.__name__} ({d})": n for k in (k1, k2, k4, k5)
            for d, n in k.launches_by_dtype.items()}
    return rows | {f"emulator_iters ({m} rng)": k3.launches_by_shot[m]
                   for m in ("internal", "explicit")}


def add_counts(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    return {k: a.get(k, 0) + n for k, n in b.items()}


def split_step(sd, cfg, opt, seq, gt, remat: bool = True) -> tuple[float, float, float, float]:
    """One E2V step by its parts, each between CUDA events: the forward and
    loss, the backward, the optimizer. Returns ``(loss, ms, ms, ms)``."""
    from v2e2v_tpu_torch._device import float32_math
    from v2e2v_tpu_torch.training.steps import e2v_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with float32_math():
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = e2v_loss(sd, cfg, seq, gt, remat=remat)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
    ev[3].synchronize()
    return (float(loss.detach()), ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
            ev[2].elapsed_time(ev[3]))


@contextlib.contextmanager
def tf32_math():
    """TF32 on in cuDNN's convs and in matmuls for the block (13a's control)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def cudnn_off():
    """PyTorch's own convs in place of cuDNN's for the block (13a's control)."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def e2v_step_vs_cpu(cfg, seed: int, counters) -> None:
    """13a: one E2V train step at full width on the card and on the CPU from
    the same weights and batch; K1 and K2 stay at 0 launches; K1 on CUDA
    tensors that require grad refuses. Two controls from the same weights:
    the card's step with TF32 let into every conv and matmul of the step
    (forward, recompute, backward, SSIM), which the gradient bound must
    reject, and the step with cuDNN off (PyTorch's own float32 convs)."""
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.training import losses as losses_mod
    from v2e2v_tpu_torch.training import steps as steps_mod
    from v2e2v_tpu_torch.training.steps import make_adam, make_e2v_train_step
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    seq, gt = train_batch(seed, TRAIN_CPU_B)
    runs = {
        "cpu": ("cpu", contextlib.nullcontext),
        "card": ("cuda", contextlib.nullcontext),
        "card, TF32 on": ("cuda", lambda: swapped((steps_mod, "float32_math", tf32_math),
                                                  (losses_mod, "float32_math", tf32_math))),
        "card, cuDNN off": ("cuda", cudnn_off),
    }
    res = {}
    for run, (device, context) in runs.items():
        sd = train_weights(cfg, seed, device)
        step = make_e2v_train_step(cfg, make_adam(sd, cfg, TRAIN_LR))
        s, g = seq.to(device), gt.to(device)
        counts_zero(*counters)
        t0 = time.perf_counter()
        with context():
            loss = float(step(sd, s, g))
        torch.cuda.synchronize()
        res[run] = (loss, {k: sd[k].grad.cpu() for k in STEP_KEYS[cfg.model_mode]},
                    time.perf_counter() - t0, [c.launches for c in counters])
    want, want_g, cpu_s, _ = res["cpu"]
    errs, rels = {}, {}
    for run, (got, got_g, run_s, launches) in res.items():
        if run == "cpu":
            continue
        rels[run] = abs(got - want) / abs(want)
        errs[run] = {k: float((got_g[k] - w).abs().max()) / float(w.abs().max())
                     for k, w in want_g.items()}
        worst = max(errs[run], key=errs[run].get)
        say(f"[train] E2V step {run} vs CPU (CISTA-LSTC {H}x{W}, C={C}, depth {DEPTH}, "
            f"T={TRAIN_T}, B={TRAIN_CPU_B}, remat; the same weights and batch): loss {got:.7f} "
            f"vs {want:.7f}, relative error {rels[run]:.3e}; gradients: largest max|diff| / "
            f"max|g| {errs[run][worst]:.3e} ({worst}); per tensor "
            f"{ {k: float(f'{v:.2e}') for k, v in errs[run].items()} }; K1, K2, K3 launches "
            f"{launches}; step {run_s:.1f} s (CPU {cpu_s:.1f} s)")
    card, tf32 = max(errs["card"].values()), max(errs["card, TF32 on"].values())
    ok = (rels["card"] <= 1e-4 and card <= GRAD_TOL < tf32
          and not any(res["card"][3]))
    say(f"[train] E2V step card vs CPU: loss relative error {rels['card']:.3e} (tol 1e-4), "
        f"gradients {card:.3e} of their largest entry (tol {GRAD_TOL}); the TF32 control "
        f"reads {tf32:.3e} (must exceed the tolerance), cuDNN off "
        f"{max(errs['card, cuDNN off'].values()):.3e}; K1, K2 launches {res['card'][3][:2]} "
        f"(want 0) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V train step on the card disagrees with the CPU, launched K1 or K2, or "
             "the gradient bound does not see TF32")
    args = [a.detach().clone() for a in ista_inputs(torch.Generator().manual_seed(seed),
                                                     torch.float32, train_weights(cfg, seed,
                                                                                  "cuda"), b=1)]
    args[2].requires_grad_(True)
    try:
        ista_loop(*args, depth=DEPTH)
    except RuntimeError as e:
        say(f"[train] ista_loop on CUDA tensors that require grad refuses: {e} pass")
    else:
        fail("ista_loop ran on CUDA tensors that require grad under autograd")


def e2v_step_times(cfg, seed: int, smi: str, counters) -> dict:
    """13b: E2V train steps at B = 1 and 8 on a fixed batch: ms per step on
    the main path (``make_e2v_train_step``, CUDA events after warm-up), its
    split, peak memory with and without remat; the loss falls over the B = 8
    steps. Returns the launches over the timed steps by row of the kernels
    line."""
    from v2e2v_tpu_torch.training.steps import make_adam, make_e2v_train_step

    launches, rows = [0] * len(counters), {}
    for b, n_steps in ((1, 8), (8, 20)):
        seq, gt = (x.cuda() for x in train_batch(seed + b, b))
        sd = train_weights(cfg, seed, "cuda")
        opt = make_adam(sd, cfg, TRAIN_LR)
        step = make_e2v_train_step(cfg, opt)
        losses = [float(step(sd, seq, gt)) for _ in range(2)]  # warm-up
        counts_zero(*counters)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        losses += [step(sd, seq, gt) for _ in range(n_steps - 2)]
        ev[1].record()
        ev[1].synchronize()
        launches = [n + c.launches for n, c in zip(launches, counters)]
        rows = add_counts(rows, row_counts())
        step_ms = ev[0].elapsed_time(ev[1]) / (n_steps - 2)
        losses = [float(x) for x in losses]
        parts = [split_step(sd, cfg, opt, seq, gt) for _ in range(2)][-1]
        peaks = {}
        for remat in (True, False):
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            split_step(sd, cfg, opt, seq, gt, remat=remat)
            peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
        finite = all(np.isfinite(losses))
        falls = losses[-1] < losses[0]
        ok = finite and (falls or b == 1) and not any(launches)
        say(f"[time] E2V train step B={b} ({smi}; CISTA-LSTC {H}x{W}, C={C}, depth {DEPTH}, "
            f"T={TRAIN_T}, remat, float32, TF32 off, Adam lr {TRAIN_LR}): {step_ms:.3f} ms per "
            f"step (CUDA events, {n_steps - 2} steps after 2 of warm-up), "
            f"{b * TRAIN_T * 1e3 / step_ms:.1f} reconstructions trained per s; split: forward + "
            f"loss {parts[1]:.3f} ms, backward (with the remat recompute) {parts[2]:.3f} ms, "
            f"optimizer {parts[3]:.3f} ms; max_memory_allocated above the weights and batch "
            f"with remat {peaks[True]:.1f} MiB, without {peaks[False]:.1f} MiB; loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f} over {n_steps} steps on one batch "
            f"(finite={finite}, falls={falls}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"E2V training at B={b} did not run as it should")
        del sd, opt, step, seq, gt
    return rows


def train_argv(data: Path, models: Path, *extra) -> list[str]:
    return ["--path_to_train_data", str(data), "--path_to_model", str(models), "--image_dim",
            str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB), "--num_events",
            str(NUM_EVENTS), "--len_sequence", str(TRAIN_T), "--seed", "0", *extra]


def e2v_train_cli(seed: int, smi: str, root: Path, counters) -> Path:
    """13c: ``cli.train_e2v`` for 2 epochs over a synthetic dataset (counts at
    0 just before: no K1, K2 or K3 launch), its epoch-2 checkpoint through
    ``cli.test_e2v`` with K1 held against its plain version at every call,
    then a resume from epoch 1 for a third epoch. Returns the epoch-2
    checkpoint."""
    from v2e2v_tpu_torch.cli import train_e2v
    from v2e2v_tpu_torch.data.manifests import make_train_e2v_txt
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
    from v2e2v_tpu_torch.training import steps as steps_mod
    from v2e2v_tpu_torch.utils.checkpoint import load_torch_checkpoint

    data, models = root / "train_e2v_data", root / "train_e2v_models"
    write_dataset(data, seed, CLI_SEQUENCES, CLI_FRAMES, H, W, CLI_EVENTS)
    n_lines = make_train_e2v_txt(str(data))
    name = f"_cista-lstc_b{NB}_d{DEPTH}_c{C}"
    folder = models / name
    # each step of the CLI between host-clock marks (it syncs on the loss):
    # the time between two steps of an epoch is the loop's wait for its data
    marks = []
    build = steps_mod.make_e2v_train_step

    def timed_build(*a, **k):
        step = build(*a, **k)

        def timed(*sa):
            t0 = time.perf_counter()
            loss = step(*sa)
            torch.cuda.synchronize()
            marks.append((t0, time.perf_counter()))
            return loss

        return timed

    counts_zero(*counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), swapped((steps_mod, "make_e2v_train_step", timed_build)):
        train_e2v.main(train_argv(data, models, "--epochs", "2"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    log = out.getvalue()
    last = marks[len(marks) // 2:]  # epoch 2
    step_ms = 1e3 * sum(b - a for a, b in last) / len(last)
    wait_ms = 1e3 * sum(n[0] - p[1] for p, n in zip(last, last[1:])) / max(len(last) - 1, 1)
    ckpt = folder / f"{name}_2.pth.tar"
    sd, epoch, _ = load_torch_checkpoint(str(ckpt))
    finite = all(bool(torch.isfinite(v).all()) for v in sd.values())
    samples = int(log.split("training sequences: ")[1].split()[0])
    ok = (finite and epoch == 1 and not any(launches) and log.count("epoch ") >= 2
          and (folder / f"{name}_1.pth.tar").exists() and samples > 0
          and len(marks) == 2 * samples)
    say(f"[train] cli.train_e2v: {n_lines} manifest lines (make_train_e2v_txt) over "
        f"{CLI_SEQUENCES} synthetic sequences of {CLI_FRAMES} frames {H}x{W}, {samples} "
        f"training sequences of {TRAIN_T} reconstructions, 2 epochs at batch 1 in "
        f"{train_s:.3f} s host clock ({smi}); epoch means: "
        f"{[ln.split('mean loss ')[1] for ln in log.splitlines() if 'mean loss' in ln]}; "
        f"K1, K2, K3 launches {launches} (want 0); checkpoint {ckpt.name} epoch {epoch}, "
        f"finite={finite} {'pass' if ok else 'FAIL'}")
    say(f"[time] cli.train_e2v epoch 2, batch 1 ({smi}): {step_ms:.3f} ms per step (host "
        f"clock from the call to the loss, the data thread running beside it), {wait_ms:.3f} "
        f"ms between steps over {len(last)} steps: the loop's wait for its next batch, not "
        f"what the data thread costs the steps (scripts/time_torch_train_loop.py times the "
        f"loop over an epoch of hundreds of steps, with and without the thread)")
    if not ok:
        fail("cli.train_e2v did not run as it should")

    rec = cli_reconstructor(data, ckpt, torch.float32, "trained_cli", "cuda")
    steps_ = record_steps(rec, keep_state=False)
    k1_errs = []

    def k1_checked(*a, **k):
        got = ista_loop(*a, **k)
        k1_errs.append(within(got, ista_loop_plain(*a, **k), TOL[torch.float32]))
        return got

    counts_zero(*counters)
    with swapped((cista_mod, "ista_loop", k1_checked)), contextlib.redirect_stdout(None):
        rec.run()
    torch.cuda.synchronize()
    k1_n = counters[0].launches
    stacked = torch.stack([r for r, _ in steps_])
    finite = bool(torch.isfinite(stacked).all())
    in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
    k1_err = max(e for e, _ in k1_errs)
    pngs = list((root / "trained_cli").rglob("frame_*.png"))
    ok = (finite and in_range and len(k1_errs) == len(steps_) > 0
          and all(o for _, o in k1_errs) and k1_n == 2 * DEPTH * len(steps_) and pngs)
    say(f"[train] cli.test_e2v on the epoch-2 checkpoint: {len(steps_)} reconstructions, "
        f"{len(pngs)} PNGs; K1 launches {k1_n} (want 2 x depth x {len(steps_)}), held against "
        f"its plain version at each of {len(k1_errs)} calls: max_abs_err={k1_err:.3e} "
        f"(tol 1e-4 + 1e-4 |ref|); finite={finite} in[0,1]={in_range} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the trained checkpoint did not serve through K1 as it should")

    resumed = root / "train_e2v_resumed"
    (resumed / name).mkdir(parents=True)
    shutil.copy(folder / f"{name}_1.pth.tar", resumed / name / f"{name}_1.pth.tar")
    with contextlib.redirect_stdout(io.StringIO()):
        train_e2v.main(train_argv(data, resumed, "--epochs", "3", "--load_epoch_for_train", "1"))
    third = torch.load(resumed / name / f"{name}_3.pth.tar", map_location="cpu",
                       weights_only=False)
    again, _, _ = load_torch_checkpoint(str(resumed / name / f"{name}_2.pth.tar"))
    diff = max(float((again[k] - v).abs().max()) for k, v in sd.items())
    adam_steps = {int(s["step"]) for s in third["optimizer"]["state"].values()}
    finite = all(bool(torch.isfinite(v).all()) for v in third["state_dict"].values())
    ok = third["epoch"] == 2 and adam_steps == {3 * samples} and finite
    say(f"[train] resume from epoch 1 (--load_epoch_for_train 1 --epochs 3): epochs 2 and 3 "
        f"written; Adam step counts {sorted(adam_steps)} (want {3 * samples}: the moments "
        f"survive); its epoch-2 weights within {diff:.3e} of the straight run's (cuDNN's "
        f"backward is not bit-reproducible); finite={finite} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("resuming E2V training did not run as it should")
    return ckpt


def v2e2v_train_steps(seed: int, smi: str, counters) -> dict:
    """13d: V2E2V train steps at B = 8, T packs of 10 frames, through K3 (the
    default path, internal Philox) against ``iters_impl="plain"`` on the same
    noise seed; counts at 0 before the step through K3. Returns its launches
    by row of the kernels line."""
    from v2e2v_tpu_torch.data.synthetic import hfr_frames
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.training.steps import make_adam, make_v2e2v_train_step

    cfg = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS))
    cfg = dataclasses.replace(cfg, cista=dataclasses.replace(cfg.cista, ista_impl="plain"))
    plain = dataclasses.replace(cfg, emulator=dataclasses.replace(cfg.emulator,
                                                                  iters_impl="plain"))
    b, n = CAPACITY, N_FRAMES
    video, t = hfr_frames(seed, TRAIN_T * (n - 1) + 1, H, W, batch=b)
    frames = torch.stack([torch.from_numpy(video[:, p * (n - 1):p * (n - 1) + n])
                          for p in range(TRAIN_T)]).cuda()
    ts = torch.stack([torch.from_numpy(np.tile(t[p * (n - 1):p * (n - 1) + n], (b, 1)))
                      for p in range(TRAIN_T)]).cuda()
    gt = frames[-1][:, -1, :, :, None] / 255.0

    def run(c, n_steps):
        sd = train_weights(c.cista, seed, "cuda")
        step = make_v2e2v_train_step(c, make_adam(sd, c.cista, TRAIN_LR))
        out = []
        for i in range(n_steps):
            noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(seed + i))
            loss, stats = step(sd, frames, ts, gt, noise)
            out.append((float(loss), int(stats["num_events"]), int(stats["clipped_pixels"])))
        return out

    want = run(plain, 1)[0]
    counts_zero(*counters)
    got = run(cfg, 1)[0]
    per_step = [c.launches for c in counters]
    rows = row_counts()
    ok = (got[1] == want[1] > 0 and abs(got[0] - want[0]) <= 1e-5
          and per_step == [9 * TRAIN_T, 0, 0]
          and rows["emulator_iters (internal rng)"] == 9 * TRAIN_T)
    say(f"[train] V2E2V step B={b}, {TRAIN_T} packs of {n} frames {H}x{W} (the emulator of "
        f"bench.py:170-176), K3 with its Philox vs iters_impl='plain' on the same noise seed: "
        f"events {got[1]} vs {want[1]}, loss {got[0]:.7f} vs {want[0]:.7f} (|diff| "
        f"{abs(got[0] - want[0]):.2e}, tol 1e-5); launches K3, K1, K2 per step {per_step} (want "
        f"[{9 * TRAIN_T}, 0, 0], K3's internal Philox {rows['emulator_iters (internal rng)']}) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V train step through K3 disagrees with the plain loop")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n_steps = 4
    sd = train_weights(cfg.cista, seed, "cuda")
    step = make_v2e2v_train_step(cfg, make_adam(sd, cfg.cista, TRAIN_LR))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses = []
    for i in range(n_steps):
        if i == 1:
            ev[0].record()
        noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(seed + i))
        losses.append(step(sd, frames, ts, gt, noise)[0])
    ev[1].record()
    ev[1].synchronize()
    host_s = time.perf_counter() - t0
    step_ms = ev[0].elapsed_time(ev[1]) / (n_steps - 1)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    losses = [float(x) for x in losses]
    ok = all(np.isfinite(losses))
    say(f"[time] V2E2V train step B={b} ({smi}; {TRAIN_T} packs of {n} frames {H}x{W}, K3 for "
        f"the emulator, CISTA-LSTC C={C} depth {DEPTH} with remat, float32, TF32 off): "
        f"{step_ms:.3f} ms per step (CUDA events, {n_steps - 1} steps after 1 of warm-up; "
        f"{n_steps} steps {host_s:.1f} s host clock), {b * TRAIN_T * 1e3 / step_ms:.1f} "
        f"reconstructions trained per s; max_memory_allocated {peak:.1f} MiB above what "
        f"earlier phases hold; losses {[round(x, 5) for x in losses]} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("V2E2V training produced a loss that is not finite")
    return rows


def v2e2v_train_cli(seed: int, smi: str, root: Path, e2v_ckpt: Path, counters) -> None:
    """13e: ``cli.train`` for 1 epoch over synthetic HFR frames, warm-started
    from 13c's checkpoint; ``cli.test`` rebuilds the emulator from its
    checkpoint's ``v2e_params`` and runs through K3 and K1."""
    from v2e2v_tpu_torch.cli import test as cli_test
    from v2e2v_tpu_torch.cli import train
    from v2e2v_tpu_torch.data.manifests import make_train_txt_wo_events
    from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset
    from v2e2v_tpu_torch.utils.configs import set_configs

    data, models = root / "train_v2e2v_data", root / "train_v2e2v_models"
    write_hfr_dataset(data, seed, 1, TRAIN_SEQ_FRAMES, H, W)
    n_lines = make_train_txt_wo_events(str(data), "train_v2e2v.txt", N_FRAMES, N_FRAMES - 1)
    v2e = [f"--{k}={v}" for k, v in V2E_PARAMS.items()]
    counts_zero(*counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train.main(train_argv(data, models, "--epochs", "1", "--path_to_e2v", str(e2v_ckpt),
                              *v2e))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    log = out.getvalue()
    ckpts = sorted(models.rglob("*_1.pth.tar"))
    raw = torch.load(ckpts[0], map_location="cpu", weights_only=False) if ckpts else {}
    samples = int(log.split("training sequences: ")[1].split()[0])
    ok = (len(ckpts) == 1 and raw.get("v2e_params") == V2E_PARAMS and launches[1:] == [0, 0]
          and launches[0] > 0 and all(k.startswith("e2v_net.") for k in raw["state_dict"]))
    say(f"[train] cli.train: {n_lines} pack lines (make_train_txt_wo_events) over 1 synthetic "
        f"HFR sequence of {TRAIN_SEQ_FRAMES} frames {H}x{W}, {samples} training sequences, 1 "
        f"epoch at batch 1 from --path_to_e2v {e2v_ckpt.name} in {train_s:.1f} s ({smi}); "
        f"{[ln for ln in log.splitlines() if 'mean loss' in ln]}; K3, K1, K2 launches "
        f"{launches} (K3 once per frame pair, K1 and K2 0); checkpoint "
        f"{ckpts[0].name if ckpts else None} with v2e_params {raw.get('v2e_params')} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("cli.train did not run as it should")

    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args(["--path_to_test_model", str(ckpts[0]), "--path_to_test_data",
                              str(data), "--image_dim", str(H), str(W), "-c", str(C), "-d",
                              str(DEPTH), "-b", str(NB), "-o", str(root / "trained_v2e2v_cli"),
                              *V2E_FLAGS])
    runner = cli_test.V2E2V(cfgs, "cuda")
    emu = runner.cfg.emulator
    rebuilt = (emu.pos_thres == V2E_PARAMS["C"] and emu.pl == V2E_PARAMS["pl"]
               and emu.ps == V2E_PARAMS["ps"] and emu.cutoff_hz == V2E_PARAMS["cutoff_hz"]
               and emu.refractory_period_s == V2E_PARAMS["refractory_period_s"])
    counts_zero(*counters)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        runner.run()
    torch.cuda.synchronize()
    pngs = list((root / "trained_v2e2v_cli").rglob("frame_*.png"))
    k3_n, k1_n = counters[0].launches, counters[1].launches
    ok = rebuilt and pngs and k3_n > 0 and k1_n == 2 * DEPTH * len(pngs)
    say(f"[train] cli.test on the V2E2V checkpoint (flags {' '.join(V2E_FLAGS)} overridden by "
        f"its v2e_params: {rebuilt}): {len(pngs)} reconstructions written, K3 launches {k3_n}, "
        f"K1 {k1_n} (want 2 x depth per pack); "
        f"{[ln for ln in printed.getvalue().splitlines() if 'Avg' in ln]} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("cli.test did not serve the trained V2E2V checkpoint as it should")


def train_phase(seed: int, smi: str, root: Path) -> dict:
    """Phase 13: training at full width (13a-e). Returns the launches on the
    E2V and V2E2V training steps by row of the kernels line, and 13c's E2V
    checkpoint (phase 22 warm-starts the V2E2V trainer from it)."""
    from v2e2v_tpu_torch.models.cista import CistaConfig
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop

    t_phase = time.perf_counter()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      ista_impl="plain", core_impl="layers")
    kernels = (ista_loop, cista_core, emulator_iters)
    t0 = time.perf_counter()
    e2v_step_vs_cpu(cfg, seed, kernels)
    say(f"[phase] 13a E2V step card vs CPU {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2v = e2v_step_times(cfg, seed, smi, kernels)
    say(f"[phase] 13b E2V train steps {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ckpt = e2v_train_cli(seed, smi, root, kernels)
    say(f"[phase] 13c E2V training CLI {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    v2e2v = v2e2v_train_steps(seed, smi, (emulator_iters, ista_loop, cista_core))
    say(f"[phase] 13d V2E2V train steps {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    v2e2v_train_cli(seed, smi, root, ckpt, (emulator_iters, ista_loop, cista_core))
    say(f"[phase] 13e V2E2V training CLI {time.perf_counter() - t0:.1f} s")
    say(f"[phase] training {time.perf_counter() - t_phase:.1f} s")
    return {"e2v": e2v, "v2e2v": v2e2v, "e2v_ckpt": ckpt}


FUSED_PACKETS_SEED = 15  # phase 15b's packets: --seed + this


def cuda_ms(fn) -> float:
    """One call of ``fn`` between CUDA events, ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def fused_phase(seed: int, smi: str, cfg, weights, serve, served: dict, video, cfg_c,
                outs_c) -> dict:
    """Phase 15: the full-resolution path in the parity domain
    (``fullres_impl="fused"``, ``ops/fused.py``): (a) phase 4's pool schedule
    and voxel grids, float32 and bfloat16, the core as layers (K1) and as K2,
    against the ref pool on the same weights, reconstructions and all four
    state tensors; (b) parity IO from the parity voxel producer against the
    full layout (B = 8, T = 6, float32); (c) phase 7's run C fused; (d) times
    (pool step fused against ref with CUDA events, the E2V CLI's model step at
    B = 1, peak memory, traces by kind of kernel). Every count is set to 0
    just before each checked path. Returns each path's launches by row."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.models.cista import cista_sequence, cista_zero_state, with_derived
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops.cuda.core import launches_per_call
    from v2e2v_tpu_torch.ops.voxel import event_preprocess, events_to_voxel_grid
    from v2e2v_tpu_torch.serving import StreamPool

    k1, k2, k3, _, _ = kernel_counters()
    t_phase = time.perf_counter()
    dev = weights["We.conv2d.weight"].device
    fused = dataclasses.replace(cfg, fullres_impl="fused")
    rows = {"fused_pool_launches": {}}

    # (a) the fused pool against the ref pool, per dtype and core
    for dtype in (torch.float32, torch.bfloat16):
        for impl in ("layers", "cuda"):
            counter, other = (k1, k2) if impl == "layers" else (k2, k1)
            want_n = 2 * DEPTH if impl == "layers" else launches_per_call(DEPTH)
            ref_pool = StreamPool(dataclasses.replace(cfg, core_impl=impl), weights, CAPACITY,
                                  dtype)
            ref, _, _ = serve(ref_pool, served[dtype], counter=counter)
            pool = StreamPool(dataclasses.replace(fused, core_impl=impl), weights, CAPACITY, dtype)
            counts_zero(k1, k2, k3)
            recs, _, per_step = serve(pool, served[dtype], counter=counter)
            rows["fused_pool_launches"] = add_counts(rows["fused_pool_launches"], row_counts())
            stray = other.launches + k3.launches
            stacked = torch.stack(list(recs.values()))
            finite = bool(torch.isfinite(stacked).all()) and all(
                bool(torch.isfinite(s.float()).all()) for s in
                (pool._states.cell, pool._states.z, *pool._states.dg))
            in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
            err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
            state_errs = [within(g, w_, TOL[dtype]) for g, w_ in zip(
                (pool._states.cell, pool._states.z, *pool._states.dg),
                (ref_pool._states.cell, ref_pool._states.z, *ref_pool._states.dg))]
            ok = ok and all(o for _, o in state_errs)
            say(f"[fused-pool] {DNAME[dtype]} core_impl={impl}: {len(recs)} reconstructions, "
                f"finite={finite} in[0,1]={in_range}; {counter.__name__} launches per step "
                f"{per_step} (want {want_n} each), others {stray} (want 0); fused vs ref pool: "
                f"reconstructions max_abs_err={err:.3e}, states (cell, z, dg h, dg c) "
                f"{', '.join(f'{e:.3e}' for e, _ in state_errs)} (tol {TOL[dtype]} + "
                f"{TOL[dtype]} |ref|) {'pass' if ok else 'FAIL'}")
            if not (finite and in_range):
                fail(f"fused pool reconstructions in {DNAME[dtype]} ({impl}) are not finite "
                     "values in [0, 1]")
            if any(n != want_n for n in per_step) or stray:
                fail(f"the fused {impl} pool did not launch {counter.__name__} {want_n} times "
                     "per step alone")
            if not ok:
                fail(f"the fused pool ({DNAME[dtype]}, {impl}) disagrees with the ref pool")

    # (b) parity IO from the parity voxel producer against the full layout
    t_steps, b = 6, CAPACITY
    pk = synthetic_packets(np.random.default_rng(seed + FUSED_PACKETS_SEED), t_steps * b, dev)
    full = torch.stack([event_preprocess(events_to_voxel_grid(
        *q[:4], q[4], num_bins=NB, width=W, height=H)).permute(1, 2, 0) for q in pk])
    packed = torch.stack([event_preprocess(events_to_voxel_grid(
        *q[:4], q[4], num_bins=NB, width=W, height=H, layout="parity")) for q in pk])
    full = full.reshape(t_steps, b, H, W, NB)
    packed = packed.reshape(t_steps, b, H // 2, W // 2, 4 * NB)
    want, want_st = cista_sequence(weights, fused, full)
    counts_zero(k1, k2, k3)
    got, got_st = cista_sequence(weights, dataclasses.replace(fused, io_layout="parity"), packed,
                                 input_packed=True)
    torch.cuda.synchronize()
    rows["parity_io_launches"] = row_counts()
    n_k1 = k1.launches
    errs = [within(g, w_, TOL[torch.float32]) for g, w_ in zip(
        (got, got_st.cell, got_st.z, *got_st.dg), (want, want_st.cell, want_st.z, *want_st.dg))]
    ok = all(o for _, o in errs) and bool(torch.isfinite(got).all()) and n_k1 == 2 * DEPTH * t_steps
    say(f"[parity-io] cista_sequence io_layout=parity, input_packed (events_to_voxel_grid "
        f"layout=parity) vs io_layout=full, B={b} T={t_steps} float32: reconstructions, cell, z, "
        f"dg h, dg c max_abs_err {', '.join(f'{e:.3e}' for e, _ in errs)} (tol "
        f"{TOL[torch.float32]}); K1 launches {n_k1} (want {2 * DEPTH * t_steps}) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("parity IO disagrees with the full layout or did not run K1")

    # (c) phase 7's run C on the fused path
    cfg_f = V2E2VConfig(dataclasses.replace(cfg_c.cista, fullres_impl="fused"), cfg_c.emulator)
    counts_zero(k1, k2, k3)
    outs_f, per_pack = run_v2e2v(cfg_f, with_derived(weights, cfg_f.cista, torch.float32), video,
                                 seed + 1, (k3, k1))
    rows["fused_v2e2v_launches"] = row_counts()
    ev_c, ev_f = [int(o.num_events) for o in outs_c], [int(o.num_events) for o in outs_f]
    err, rec_ok = within(torch.stack([o.reconstruction for o in outs_f]),
                         torch.stack([o.reconstruction for o in outs_c]), V2E2V_TOL)
    ok = ev_f == ev_c and rec_ok and all(n == [N_FRAMES - 1, 2 * DEPTH] for n in per_pack)
    say(f"[fused-v2e2v] run C with fullres_impl=fused: num_events {ev_f} equal to run C's="
        f"{ev_f == ev_c}; K3, K1 launches per pack {per_pack} (want {[N_FRAMES - 1, 2 * DEPTH]} "
        f"each); reconstructions vs run C max_abs_err={err:.3e} (tol atol=rtol={V2E2V_TOL}) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the fused V2E2V composite disagrees with run C")

    # (d) times: the pool step, fused against ref, in turns, CUDA events
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        vox = list(served[dtype].values())[:CAPACITY]
        for impl in ("layers", "cuda"):
            ms, peak = {"ref": [], "fused": []}, {}
            for fr in ("ref", "fused", "fused", "ref"):
                pool = StreamPool(dataclasses.replace(cfg, core_impl=impl, fullres_impl=fr),
                                  weights, CAPACITY, dtype)
                batch = {pool.attach(): v for v in vox}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for i in range(8):
                    t = cuda_ms(lambda: pool.step(batch, fetch=False))
                    if i >= 2:
                        ms[fr].append(t)
                peak[fr] = max(peak.get(fr, 0.0), torch.cuda.max_memory_allocated() / 2**20)
                del pool
            med = {fr: float(np.median(v)) for fr, v in ms.items()}
            times[(DNAME[dtype], impl)] = med
            say(f"[fused-time] pool {DNAME[dtype]} core_impl={impl} capacity {CAPACITY}: step "
                f"ref {med['ref']:.3f} ms, fused {med['fused']:.3f} ms (median of "
                f"{len(ms['ref'])} each, in turns, CUDA events; min {min(ms['ref']):.3f} / "
                f"{min(ms['fused']):.3f}); fused/ref {med['fused'] / med['ref']:.3f}; "
                f"{CAPACITY * 1e3 / med['fused']:.1f} reconstructions/s fused; "
                f"max_memory_allocated ref {peak['ref']:.1f} / fused {peak['fused']:.1f} MiB")

    # the E2V CLI's model step at B = 1 (its make_step, K1, as the CLI builds it)
    one = list(served[torch.float32].values())[0][None]
    for dtype in (torch.float32, torch.bfloat16):
        ms = {"ref": [], "fused": []}
        for fr in ("ref", "fused", "fused", "ref"):
            c = dataclasses.replace(cfg, core_impl="layers", fullres_impl=fr)
            params = with_derived({k: v.to(dtype) for k, v in weights.items()}, c, dtype)
            step = cli.make_step(c, dtype)
            prev = torch.zeros(1, H, W, 1, device=dev)
            st = cista_zero_state(c, 1, torch.float32, dev)
            ms[fr].append(time_ms(lambda: step(params, one, prev, st), warmup=3, iters=20))
        med = {fr: float(np.mean(v)) for fr, v in ms.items()}
        times[(DNAME[dtype], "cli_b1")] = med
        say(f"[fused-time] E2V CLI model step B=1 {H}x{W} {DNAME[dtype]} (make_step, K1): ref "
            f"{med['ref']:.4f} ms, fused {med['fused']:.4f} ms (mean of 2 x 20 calls each, in "
            f"turns, CUDA events as issued); fused/ref {med['fused'] / med['ref']:.3f}")

    # the full-resolution stages alone, per call: heads, then upsample + final
    from torch.profiler import ProfilerActivity, profile

    from v2e2v_tpu_torch.models import cista as cista_mod

    def kernels_per_call(fn) -> int:
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA)

    for dtype in (torch.float32, torch.bfloat16):
        for b in (CAPACITY, 1):
            vox = torch.stack(list(served[dtype].values())[:b]).to(dtype)
            img = torch.rand(b, H, W, 1, device=dev, generator=torch.Generator(dev).manual_seed(
                seed)).to(dtype)
            rec_h = torch.rand(b, H // 2, W // 2, C, device=dev).to(dtype)
            parts = []
            for fr in ("ref", "fused"):
                c = dataclasses.replace(cfg, fullres_impl=fr)
                p = with_derived({k: v.to(dtype) for k, v in weights.items()}, c, dtype)
                for stage, fn in (
                        ("heads", lambda: cista_mod._heads(p, c, vox, img)),
                        ("upsample+final",
                         lambda: cista_mod._upsample_final(p, c, rec_h, upsamp_activation="relu"))):
                    parts.append(f"{stage} {fr} {time_ms(fn, iters=20):.4f} / "
                                 f"{device_ms(fn):.4f} ms in {kernels_per_call(fn)} kernels")
            say(f"[fused-stage] {DNAME[dtype]} B={b} {H}x{W}, per call as issued / on the "
                f"device (CUDA events): {'; '.join(parts)}")

    faster = all(times[(d, i)]["fused"] < times[(d, i)]["ref"]
                 for d in ("float32", "bfloat16") for i in ("layers", "cuda"))
    b1_ok = all(times[(d, "cli_b1")]["fused"] <= times[(d, "cli_b1")]["ref"]
                for d in ("float32", "bfloat16"))
    say(f"[fused-time] the default rule: fused pool step faster in all four cells={faster}; "
        f"B = 1 CLI step not slower={b1_ok} ({smi})")

    # traces by kind of kernel: the bf16 K2 and the f32 layers pools, ref and fused
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_torch_pool", Path(__file__).resolve().parent / "scripts" / "profile_torch_pool.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    for dtype, impl in ((torch.bfloat16, "cuda"), (torch.float32, "layers")):
        for fr in ("ref", "fused"):
            c = dataclasses.replace(cfg, core_impl=impl, fullres_impl=fr)
            prof.trace(prof.pool_steps(c, weights, dtype, seed), 5,
                       f"{DNAME[dtype]} core_impl={impl} fullres_impl={fr} capacity 8 step")
    say(f"[phase] fused full-resolution path {time.perf_counter() - t_phase:.1f} s")
    return rows


K4_SOURCE = "v2e2v_tpu_torch/csrc/qconv3x3.cu"
K4_REPLACES = "v2e2v_tpu/ops/qconv.py:110"
QSCALE_SOURCE = "v2e2v_tpu_torch/csrc/qscale.cu"
QSCALE_REPLACES = "v2e2v_tpu/ops/qconv.py:74"
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor cores
# K4's conv sites at C = 64 (cin_a, cin_b, cout) and how many a CISTA-LSTC
# step runs: gates, P0 (and P), out_gates, D (and dg), lstm
K4_SHAPES = {"gates 192->256": ((C, 2 * C, 4 * C), 1), "P0/P 64->128": ((C, 0, 2 * C), 1 + DEPTH),
             "out_gates 256->128": ((2 * C, 2 * C, 2 * C), 1),
             "D/dg 128->64": ((2 * C, 0, C), DEPTH + 1), "lstm 128->256": ((C, C, 4 * C), 1)}
K4_PER_STEP = {"cista-lstc": 3 + 2 * DEPTH + 2, "cista-tc": 1 + 2 * DEPTH + 2}
INT8_VS_FLOAT = (0.03, 0.05)  # JAX's own bound: mean |int8 - float|, over all and the last step
K4_STATIC_SX = 0.0625  # 2^-4: x = (k + 1/2) 2^-4 lies exactly on a tie of x / s_x
K4_DESIGN = ("implicit GEMM on wgmma.mma_async m64nNk32 s32.s8.s8 (IGMMA): 16x8-pixel x 64/128-"
             "channel tiles, two consumer warpgroups, two blocks an SM; the haloed input tile "
             "staged once per 32-channel chunk for all 9 taps through registers (float32/bfloat16 "
             "quantized with s_x while staged, div.rn's result by two FMA corrections: the codes "
             "never reach device memory), a chunk's taps laid out once K-major and loaded by one "
             "cp.async.bulk a chunk ahead, double-buffered; int32 sums in registers, fused "
             "float32 dequant")
# the kinds of device kernel phase 16f's traces sort the int8 step into,
# ahead of scripts/profile_torch_pool.py's own
INT8_KINDS = (
    ("K4", ("qconv3x3_kernel",)),
    ("K4 scale", ("qscale_kernel",)),
    ("quantize passes", ("AbsFunctor", "abs_kernel", "MaxNanFunctor", "maximum_kernel",
                         "DivFunctor", "div_true", "round_kernel")),
    ("clamp and relu", ("clamp_",)),
)


def k4_inputs(b, site, dtype, seed: int):
    """K4's arguments at a site's shape on the card (90x120): a float input in
    ``dtype`` on the .5 ties of the static ``s_x = 2^-4`` and past +-127
    (saturating) with a few extremes (whose dynamic scale, past 2^60, sends
    every row down the kernel's div.rn path), full-range int8 weights, real
    weight scales and a bias."""
    (cin_a, cin_b, cout) = site
    g = torch.Generator(device="cuda").manual_seed(seed)
    s_x = torch.tensor(K4_STATIC_SX, device="cuda")
    x = torch.randint(-300, 301, (b, H // 2, W // 2, cin_a + cin_b), generator=g,
                      device="cuda").float() / 2 * s_x
    # values past 2^64, subnormals and zeros: the other path of K4's division
    x.view(-1)[:8] = torch.tensor([1e30, -3e38, 1e-40, -1e-30, 0.0, -0.0, 2e19, -7e-20],
                                  device="cuda")
    x = x.to(dtype)
    wq = torch.randint(-127, 128, (cout, cin_a + cin_b, 3, 3), generator=g, device="cuda",
                       dtype=torch.int8)
    s_w = torch.rand(cout, generator=g, device="cuda") * 1e-3
    bias = torch.randn(cout, generator=g, device="cuda")
    xa, xb = x[..., :cin_a].contiguous(), x[..., cin_a:].contiguous() if cin_b else None
    return xa, s_x, wq, s_w, bias, xb


def k4_bound_ms(b, site, in_dtype, out_dtype) -> tuple[float, str, float, float]:
    """K4's least time at a site: the larger of its bytes (the input in
    ``in_dtype`` and the weights read once, the output written once, scales
    and bias) at 3.35 TB/s and its 2 x 9 x B*H*W x cin x cout integer
    operations at 1,979 TOPS."""
    cin_a, cin_b, cout = site
    px = b * (H // 2) * (W // 2)
    nbytes = px * (cin_a + cin_b) * in_dtype.itemsize + 9 * cout * (cin_a + cin_b) + \
        8 * cout + 4 + px * cout * out_dtype.itemsize
    ops = 2 * 9 * px * (cin_a + cin_b) * cout
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


def ulp_count(got, want) -> tuple[int, int]:
    """(outputs that differ, the largest difference) in units in the last place."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    d = (got.view(bits).int() - want.view(bits).int()).abs()
    return int((d > 0).sum()), int(d.max())


def k4_library(codes, wq):
    """The nearest library calls at a site: ``torch._int_mm`` on the int8
    im2col of the codes (built outside the timed call) and cuDNN's bfloat16
    conv of the same shape (channels_last)."""
    x = torch.cat(codes, -1)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1),
                                 mode="reflect").to(torch.int8).permute(0, 2, 3, 1)
    b, h, w, cin = x.shape
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                     -1).reshape(b * h * w, 9 * cin).contiguous()
    wmat = wq.permute(2, 3, 1, 0).reshape(9 * cin, -1).contiguous()
    xbf = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # a channels_last view
    wbf = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return (lambda: torch._int_mm(cols, wmat)), \
        (lambda: torch.nn.functional.conv2d(xbf, wbf, padding=1))


def k4_site(b, label, site, dtype, seed: int, smi: str) -> tuple[dict, dict, float, bool]:
    """Phase 16b at one site shape, batch and float dtype: K4 against its
    plain version on the float input (static and dynamic ``s_x``) and on the
    int8 codes, out float32 and bfloat16; its codes read back through
    identity centre-tap weights; the scale kernel against its plain version;
    then the times of the main path's combination (out = in = ``dtype``).
    Returns (K4's times, the scale kernel's, the largest |kernel - plain|
    with the static scale and on the codes, pass). The dynamic scale of the
    extremes lies past 2^60, so the plain version's float64 dequant of
    outputs near 1e35 may round twice and land an ulp from the fused
    multiply-add, as its docstring says; the ulp counts show it."""
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3, qconv3x3_plain, quantize_with
    from v2e2v_tpu_torch.ops.cuda.qscale import act_scale, act_scale_plain

    xa, s_x, wq, s_w, bias, xb = k4_inputs(b, site, dtype, seed)
    parts = (xa,) if xb is None else (xa, xb)
    codes = tuple(quantize_with(p, s_x) for p in parts)
    s_dyn, s_plain = act_scale(parts), act_scale_plain(parts)
    scale_ok = bool(s_dyn.view(torch.int32) == s_plain.view(torch.int32)) and \
        float(act_scale([torch.zeros_like(p) for p in parts])) == 1.0
    err, diffs = 0.0, {}
    for out in (torch.float32, torch.bfloat16):
        for kind, (xa_, xb_), s in (("float", (xa, xb), s_x), ("float dynamic", (xa, xb), s_dyn),
                                    ("int8", (codes[0], codes[1] if xb is not None else None),
                                     s_x)):
            args = (xa_, s, wq, s_w, bias, xb_)
            got, want = qconv3x3(*args, out_dtype=out), qconv3x3_plain(*args, out_dtype=out)
            torch.cuda.synchronize()
            diffs[(kind, DNAME[out])] = ulp_count(got, want)
            if kind != "float dynamic":  # its outputs reach 1e35, where an ulp is ~1e28
                err = max(err, float((got.float() - want.float()).abs().max()))
    # the codes K4 staged: identity centre taps, unit weight scales, no bias
    n = min(wq.shape[:2])
    eye = torch.zeros_like(wq)
    eye[torch.arange(n), torch.arange(n), 1, 1] = 1
    back = qconv3x3(xa, s_x, eye, torch.ones(wq.shape[0], device="cuda"), None, xb) / s_x
    cat = torch.cat(codes, -1)
    codes_equal = torch.equal(back[..., :n], cat[..., :n].float())
    ties = int(((torch.cat(parts, -1).float() / s_x).frac().abs() == 0.5).sum())
    ok = codes_equal and scale_ok and all(
        d[1] <= 1 and d[0] <= 1e-5 * cat[..., :1].numel() * wq.shape[0] for d in diffs.values())

    # times: the main path's combination, float input with out = in = dtype
    kw = {"out_dtype": dtype}
    fwd = (xa, s_x, wq, s_w, bias, xb)
    int8_args = (codes[0], s_x, wq, s_w, bias, codes[1] if xb is not None else None)

    def pr13_route():  # eager quantize_with of each part, then the int8 entry
        return qconv3x3(*(quantize_with(xa, s_x), s_x, wq, s_w, bias,
                          None if xb is None else quantize_with(xb, s_x)), **kw)

    def pr13_dynamic():  # eager scale passes, eager quantize, the int8 entry
        s = act_scale_plain(parts)
        return qconv3x3(*(quantize_with(xa, s), s, wq, s_w, bias,
                          None if xb is None else quantize_with(xb, s)), **kw)

    def dynamic():  # the scale kernel, then K4 on the float input
        return qconv3x3(xa, act_scale(parts), wq, s_w, bias, xb, **kw)

    t = {"ms": time_ms(lambda: qconv3x3(*fwd, **kw), iters=20),
         "device_ms": device_ms(lambda: qconv3x3(*fwd, **kw)),
         "int8_entry_device_ms": device_ms(lambda: qconv3x3(*int8_args, **kw)),
         "pr13_route_ms": time_ms(pr13_route, iters=20),
         "pr13_route_device_ms": device_ms(pr13_route),
         "dynamic_device_ms": device_ms(dynamic),
         "pr13_dynamic_device_ms": device_ms(pr13_dynamic),
         "plain_ms": time_ms(lambda: qconv3x3_plain(*fwd, **kw), warmup=1, iters=3)}
    t["bound_ms"], t["bound_by"], nbytes, ops = k4_bound_ms(b, site, dtype, dtype)
    int_mm, cudnn = k4_library(codes, wq)
    t["int_mm_ms"], t["cudnn_bf16_ms"] = time_ms(int_mm, iters=20), time_ms(cudnn, iters=20)
    sc = {"ms": time_ms(lambda: act_scale(parts), iters=20),
          "device_ms": device_ms(lambda: act_scale(parts)),
          "plain_device_ms": device_ms(lambda: act_scale_plain(parts)),
          "plain_ms": time_ms(lambda: act_scale_plain(parts), iters=20),
          "vector_norm_device_ms": device_ms(
              lambda: [torch.linalg.vector_norm(p, float("inf")) for p in parts]),
          "bound_ms": 1e3 * (sum(p.numel() for p in parts) * dtype.itemsize + 4) / PEAK_BYTES}
    sc["vector_norm_ms"] = time_ms(
        lambda: [torch.linalg.vector_norm(p, float("inf")) for p in parts], iters=20)
    say(f"[k4] {label} B={b} {H // 2}x{W // 2} in {DNAME[dtype]}: vs plain (outputs 1 ulp apart, "
        f"max ulp) {', '.join(f'{k} out {o} {d[0]}/{d[1]}' for (k, o), d in diffs.items())} of "
        f"{got.numel()}; codes through identity taps {'equal' if codes_equal else 'DIFFER'} "
        f"({n} channels, {ties} inputs on .5 ties, max |code| {int(cat.abs().max())}); scale "
        f"kernel {'equal' if scale_ok else 'DIFFERS'} (s_x {float(s_dyn):.8g}); kernel "
        f"{t['ms']:.4f} ms as issued, {t['device_ms']:.4f} ms on the device (int8 entry "
        f"{t['int8_entry_device_ms']:.4f}); the PR-13 route (eager quantize + int8 entry) "
        f"{t['pr13_route_ms']:.4f} / {t['pr13_route_device_ms']:.4f} ms; dynamic scale kernel + "
        f"K4 {t['dynamic_device_ms']:.4f} ms against eager scale + quantize + int8 entry "
        f"{t['pr13_dynamic_device_ms']:.4f} ms on the device; plain {t['plain_ms']:.4f} ms; "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G "
        f"int8 ops) = {100 * t['bound_ms'] / t['device_ms']:.1f}% on the device; torch._int_mm "
        f"on the im2col {t['int_mm_ms']:.4f} ms; cuDNN bfloat16 conv {t['cudnn_bf16_ms']:.4f} ms "
        f"({smi}) {'pass' if ok else 'FAIL'}")
    say(f"[qscale] {label} B={b} in {DNAME[dtype]} ({len(parts)} part(s), "
        f"{sum(p.numel() for p in parts)} values): kernel {sc['ms']:.4f} ms as issued, "
        f"{sc['device_ms']:.4f} ms on the device; plain (eager passes) {sc['plain_ms']:.4f} / "
        f"{sc['plain_device_ms']:.4f} ms; vector_norm(inf) per part {sc['vector_norm_ms']:.4f} / "
        f"{sc['vector_norm_device_ms']:.4f} ms; bound {sc['bound_ms']:.4f} ms (bytes) = "
        f"{100 * sc['bound_ms'] / sc['device_ms']:.1f}% on the device ({smi}) "
        f"{'pass' if scale_ok else 'FAIL'}")
    return t, sc, err, ok


def site_scale(qp: dict, site: str) -> torch.Tensor:
    """The static ``s_x`` of a conv site named as ``ops/qconv._SITE_ORDERS``
    names it (``lstc.gates``, ``D``, ...)."""
    for k in site.split("."):
        qp = qp[k]
    return qp["s_x"]


def k4_build() -> None:
    """Phase 16a: K4's kernels hold the integer wgmma (IGMMA) and no IMMA or
    HGMMA, and they and the scale kernels spill nothing."""
    from v2e2v_tpu_torch.ops.cuda import _lib

    lib = _lib.load()
    igmma = {k: v for k, v in sass_counts(lib.path, "IGMMA").items() if "qconv3x3_kernel" in k}
    imma, hgmma = sass_counts(lib.path, "IMMA"), sass_counts(lib.path, "HGMMA")
    scale = [k for k in hgmma if "qscale_kernel" in k]
    spills, name = {}, None
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name in igmma or name in scale:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                say(f"[int8-build] {short_name(name)}: {m.group(1)} registers")
    say(f"[int8-build] K4 (csrc/qconv3x3.cu): IGMMA per kernel "
        f"{ {short_name(k): v for k, v in igmma.items()} }, IMMA "
        f"{sum(imma.get(k, 0) for k in igmma)}, HGMMA {sum(hgmma.get(k, 0) for k in igmma)}, "
        f"spilled bytes {sum(spills.get(k, 1) for k in igmma)}; dynamic shared memory per block "
        f"cout={C} {lib.lib.v2e_qconv3x3_smem_bytes(C)} B, cout={2 * C} "
        f"{lib.lib.v2e_qconv3x3_smem_bytes(2 * C)} B (want 12 kernels: int8, float32 and bfloat16 "
        f"in x float32 and bfloat16 out x NB 64 and 128, IGMMA in each, no IMMA or HGMMA, 0 "
        f"spills); the scale kernel (csrc/qscale.cu) {[short_name(k) for k in scale]}, spilled "
        f"bytes {sum(spills.get(k, 1) for k in scale)} (want 2 kernels, 0 spills)")
    if len(igmma) != 12 or any(v == 0 or imma.get(k, 0) or hgmma.get(k, 0) or spills.get(k, 1)
                               for k, v in igmma.items()):
        fail("a K4 kernel is missing, has no IGMMA instruction, has IMMA or HGMMA, or spills")
    if len(scale) != 2 or any(spills.get(k, 1) for k in scale):
        fail("a scale kernel is missing or spills")


def int8_phase(seed: int, smi: str, root: Path, serve, served: dict, layers_recs: dict,
               weights) -> dict:
    """Phase 16: int8 inference at full width: (a) K4's build; (b) K4 and the
    scale kernel against their plain versions at every site shape and their
    times; (c) the CISTA-LSTC int8 pool on phase 4's schedule and voxel
    grids, dynamic and calibrated; (d) the CISTA-TC int8 pool; (e) the E2V
    CLI with --quant int8 and int8-static; (f) int8 against float pool steps,
    each site's input strides and a trace by kind of kernel. Every count is
    set to 0 just before each checked path. Returns the rows of K4 and the
    scale kernel in the kernels line and each path's launches by row."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_tc
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch import serving
    from v2e2v_tpu_torch.ops import qconv as qconv_mod
    from v2e2v_tpu_torch.ops.qconv import _SITE_ORDERS
    from v2e2v_tpu_torch.serving import StreamPool
    from v2e2v_tpu_torch.utils.configs import set_configs

    t_phase = time.perf_counter()
    k1, k2, k3, k4, k5 = kernel_counters()
    rows = {}

    # (a) the build
    k4_build()

    # (b) K4 and the scale kernel against their plain versions at every site
    # shape, and their times
    k4_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per_shape = {DNAME[d]: {} for d in k4_err}
    per_scale = {DNAME[d]: {} for d in k4_err}
    for b in (CAPACITY, 1):
        for label, (site, n) in K4_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                t, sc, err, ok = k4_site(b, label, site, dtype, seed, smi)
                k4_err[dtype] = max(k4_err[dtype], err)
                per_shape[DNAME[dtype]][f"{label} B={b}"] = {**t, "calls_per_step": n}
                per_scale[DNAME[dtype]][f"{label} B={b}"] = {**sc, "calls_per_step": n}
                if not ok:
                    fail(f"K4 or the scale kernel disagrees with its plain version at {label} "
                         f"B={b} {DNAME[dtype]}")

    # (c) and (d) the int8 pools against their plain versions, dynamic, then calibrated
    cfgs = {"cista-lstc": CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                                      quant="int8"),
            "cista-tc": CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                                    model_mode="cista-tc", quant="int8")}
    sds = {"cista-lstc": weights,
           "cista-tc": init_cista_tc(torch.Generator().manual_seed(seed), cfgs["cista-tc"],
                                     device="cuda")}
    calib_lines = []

    def drift_recorded(*a, **k):
        out = cista_mod.int8_static_drift_check(*a, **k)
        calib_lines.append(out)
        return out

    main_k4, main_scale = {}, {}
    for mode, cfg in cfgs.items():
        want_n = K4_PER_STEP[mode]
        for dtype in (torch.float32, torch.bfloat16):
            float_recs = layers_recs[dtype] if mode == "cista-lstc" else serve(StreamPool(
                dataclasses.replace(cfg, quant="none"), sds[mode], CAPACITY, dtype),
                served[dtype])[0]
            vals = list(served[dtype].values())
            calib = torch.stack(vals[:3 * CAPACITY]).reshape(3, CAPACITY, H, W, NB)
            for scales in ("dynamic", "calibrated"):
                pools = {}
                for impl in ("plain", "cuda"):
                    pool = StreamPool(dataclasses.replace(cfg, qconv_impl=impl), sds[mode],
                                      CAPACITY, dtype)
                    if scales == "calibrated":
                        calib_lines.clear()
                        with swapped((serving, "int8_static_drift_check", drift_recorded)):
                            adopted = pool.calibrate(calib)
                        delta = calib_lines[-1][0]
                        sites = {s: round(float(site_scale(pool.params["_quant"], s)), 8)
                                 for s in dict.fromkeys(_SITE_ORDERS[mode](DEPTH))}
                        say(f"[int8-pool] {mode} {DNAME[dtype]} {impl}: calibrate() on 3 steps "
                            f"of {CAPACITY} grids: SSIM delta {delta:.6f}, static scales adopted="
                            f"{adopted}, requant_chain={pool.cfg.requant_chain}; s_x {sites}")
                    if impl == "cuda":
                        counts_zero(k1, k2, k3, k4, k5)
                    pools[impl] = (pool, *serve(pool, served[dtype], counter=k4))
                    if impl == "cuda":
                        key = f"int8_{mode.replace('-', '_')}_{scales}_pool_launches"
                        rows[key] = add_counts(rows.get(key, {}), row_counts())
                        other = k1.launches + k2.launches + k3.launches
                        n_scale, by_input = k5.launches, dict(k4.launches_by_input)
                pool, recs, _, per_step = pools["cuda"]
                ref_pool, ref, _, _ = pools["plain"]
                want_scale = (want_n if scales == "dynamic" else 0) * len(per_step)
                stacked = torch.stack(list(recs.values()))
                states = (pool._states.cell, pool._states.z, *pool._states.dg)
                finite = bool(torch.isfinite(stacked).all()) and all(
                    bool(torch.isfinite(s.float()).all()) for s in states)
                in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
                err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
                state_errs = [within(g, w_, TOL[dtype]) for g, w_ in zip(
                    states, (ref_pool._states.cell, ref_pool._states.z, *ref_pool._states.dg))]
                ok = ok and all(o for _, o in state_errs)
                # JAX's bound of int8 against float: over all reconstructions,
                # and over the last step's (the schedule's last entry: stream 6)
                mean_all = float((stacked - torch.stack([float_recs[k] for k in recs])).abs().mean())
                k_last = list(recs)[-1]
                mean_last = float((recs[k_last] - float_recs[k_last]).abs().mean())
                near = mean_all < INT8_VS_FLOAT[0] and mean_last < INT8_VS_FLOAT[1]
                say(f"[int8-pool] {mode} {DNAME[dtype]} {scales}: {len(recs)} reconstructions, "
                    f"finite={finite} in[0,1]={in_range}; K4 launches per step {per_step} (want "
                    f"{want_n} each; by input {by_input}), scale kernel {n_scale} in "
                    f"{len(per_step)} steps (want {want_scale}), K1 + K2 + K3 {other} (want 0); "
                    f"K4 vs its plain version: reconstructions max_abs_err={err:.3e}, states "
                    f"(cell, z, dg h, dg c) {', '.join(f'{e:.3e}' for e, _ in state_errs)} (tol "
                    f"{TOL[dtype]} + {TOL[dtype]} |ref|); vs the float pool mean |diff| "
                    f"{mean_all:.4f} (< {INT8_VS_FLOAT[0]}), last step {mean_last:.4f} (< "
                    f"{INT8_VS_FLOAT[1]}) {'pass' if ok and finite and in_range and near else 'FAIL'}")
                if not (finite and in_range) or any(n != want_n for n in per_step) or other or \
                        n_scale != want_scale:
                    fail(f"the int8 {mode} pool ({DNAME[dtype]}, {scales}) did not run K4 "
                         f"{want_n} times and the scale kernel {want_scale} times alone, or gave "
                         "bad reconstructions")
                if not (ok and near):
                    fail(f"the int8 {mode} pool ({DNAME[dtype]}, {scales}) disagrees with its "
                         "plain version or strays from the float pool")
                if mode == "cista-lstc" and scales == "dynamic":
                    main_k4[dtype] = k4.launches_by_dtype[DNAME[dtype]]
                    main_scale[dtype] = k5.launches_by_dtype[DNAME[dtype]]
    # (e) the E2V CLI with --quant int8 and int8-static (phase 9's first sequence, B = 1)
    data, model = root / "int8_data", root / "int8_model.pth.tar"
    write_dataset(data, seed, 1, CLI_FRAMES, H, W, CLI_EVENTS)
    torch.save({"epoch": 0, "state_dict": {k: v.cpu() for k, v in weights.items()}}, model)
    parser = argparse.ArgumentParser()
    set_configs(parser)
    for quant in ("int8", "int8-static"):
        opts = parser.parse_args([
            "--path_to_test_model", str(model), "--path_to_test_data", str(data),
            "--image_dim", str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB),
            "--quant", quant, "-o", str(root / f"int8_cli_{quant}")])
        calls = [0]
        make = cli.make_step

        def counted(cfg, dtype, make=make, calls=calls):
            step = make(cfg, dtype)

            def run(*a):
                calls[0] += 1
                return step(*a)
            return run

        with swapped((cli, "make_step", counted)):
            rec = cli.Reconstructor(opts, "cuda")
            counts_zero(k1, k2, k3, k4, k5)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rec.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        rows[f"int8_cli_{quant.replace('-', '_')}_launches"] = row_counts()
        n_k4, n_k12, n_scale = k4.launches, k1.launches + k2.launches, k5.launches
        line = [ln for ln in out.getvalue().splitlines() if ln.startswith("[int8-static]")]
        # calibrating runs the int8 step twice (the dynamic scales, then the
        # drift gate's static step) and the float step once (K1, 2 x depth)
        static = quant == "int8-static"
        extra, want_k1 = (2 * K4_PER_STEP["cista-lstc"], 2 * DEPTH) if static else (0, 0)
        n = calls[0]
        want_scale = K4_PER_STEP["cista-lstc"] * (1 if static else n)
        prev = torch.zeros(1, H, W, 1, device="cuda")
        st = cista_mod.cista_zero_state(rec.cfg, 1, torch.float32, "cuda")
        one = served[torch.float32][(0, 0)][None]
        step_ms = time_ms(lambda: rec.step(rec.params, one, prev, st), iters=20)
        ok = n > 0 and n_k4 == K4_PER_STEP["cista-lstc"] * n + extra and n_k12 == want_k1 and \
            n_scale == want_scale and (not static or len(line) == 1)
        say(f"[int8-cli] E2V CLI --quant {quant} float32, one sequence of {CLI_FRAMES} frames: "
            f"{n} reconstructions, {n / run_s:.1f} recon/s (run(), host clock); model step "
            f"{step_ms:.4f} ms (B = 1, CUDA events); K4 launches {n_k4} (want "
            f"{K4_PER_STEP['cista-lstc']} x {n}{f' + {extra} calibrating' if extra else ''}), "
            f"scale kernel {n_scale} (want {want_scale}{': the calibrating step' if static else ''}"
            f"), K1 + K2 {n_k12} (want {want_k1}{': the drift gate' if static else ''}); "
            f"{line[0] if line else 'no calibration line'}"
            f" ({smi}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the E2V CLI with --quant {quant} did not run as it should")

    # (f) the int8 pool step against the float pool step, in turns; each
    # site's input strides; traces by kind of kernel
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_torch_pool", Path(__file__).resolve().parent / "scripts" / "profile_torch_pool.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    prof.CATEGORIES = INT8_KINDS + tuple(c for c in prof.CATEGORIES
                                         if c[0] not in ("K4", "quantize passes and relu"))
    times, traces = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        vox = list(served[dtype].values())[:CAPACITY]
        ms, peak = {"none": [], "int8": []}, {}
        for quant in ("none", "int8", "int8", "none"):
            pool = StreamPool(dataclasses.replace(cfgs["cista-lstc"], quant=quant), weights,
                              CAPACITY, dtype)
            batch = {pool.attach(): v for v in vox}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i in range(8):
                t = cuda_ms(lambda: pool.step(batch, fetch=False))
                if i >= 2:
                    ms[quant].append(t)
            peak[quant] = max(peak.get(quant, 0.0), torch.cuda.max_memory_allocated() / 2**20)
            if quant == "int8" and len(ms[quant]) == 6:  # each site's input, one step
                seen, conv = [], qconv_mod._IMPLS["cuda"]

                def record(xa, *a, **k):
                    xb = a[4] if len(a) > 4 else k.get("xb")
                    seen.append(f"{str(xa.dtype).split('.')[1]} {xa.stride()}"
                                f"{'' if xb is None else f' + {xb.stride()}'}")
                    return conv(xa, *a, **k)

                qconv_mod._IMPLS["cuda"] = record
                try:
                    pool.step(batch, fetch=False)
                finally:
                    qconv_mod._IMPLS["cuda"] = conv
                say(f"[int8-strides] {DNAME[dtype]} step, each K4 call's input (dtype, strides; "
                    f"every one contiguous NHWC): "
                    f"{'; '.join(f'{s}: {v}' for s, v in zip(_SITE_ORDERS['cista-lstc'](DEPTH), seen))}")
            del pool
        med = {q: float(np.median(v)) for q, v in ms.items()}
        times[DNAME[dtype]] = med
        say(f"[int8-time] pool {DNAME[dtype]} capacity {CAPACITY} (fullres ref, float core K1): "
            f"step float {med['none']:.3f} ms, int8 {med['int8']:.3f} ms (median of "
            f"{len(ms['none'])} each, in turns, CUDA events; min {min(ms['none']):.3f} / "
            f"{min(ms['int8']):.3f}); int8/float {med['int8'] / med['none']:.3f}; "
            f"max_memory_allocated float {peak['none']:.1f} / int8 {peak['int8']:.1f} MiB ({smi})")
        # every step launches K4, the scale kernel and any quantize pass the
        # same number of times (the counters above), so a count per step of
        # theirs that is not whole means the profiler dropped events (seen
        # on the card: 72 of the 75 K4 launches the counters saw): trace again
        for attempt in range(3):
            traces[DNAME[dtype]] = prof.trace(
                prof.pool_steps(cfgs["cista-lstc"], weights, dtype, seed), 5,
                f"{DNAME[dtype]} quant=int8 capacity 8 step")
            kinds = traces[DNAME[dtype]]["kinds"]
            partial = {k: kinds[k][1] for k in ("K4", "K4 scale", "quantize passes")
                       if not float(kinds[k][1]).is_integer()}
            if not partial:
                break
            say(f"[int8-trace] {DNAME[dtype]} trace {attempt + 1} dropped kernel events "
                f"(launches per step {partial}); traced again")
        say(f"[int8-trace] {DNAME[dtype]} dynamic int8 step: K4 {kinds['K4'][1]:g} and the scale "
            f"kernel {kinds['K4 scale'][1]:g} launches per step (want {K4_PER_STEP['cista-lstc']} "
            f"each), eager quantize passes {kinds['quantize passes'][1]:g} (want 0)")
        if kinds["quantize passes"][1] or kinds["K4 scale"][1] != K4_PER_STEP["cista-lstc"]:
            fail("the dynamic int8 step still runs eager quantize passes, or not one scale "
                 "kernel per site")

    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        shapes, scales = per_shape[DNAME[dtype]], per_scale[DNAME[dtype]]

        def per_step(table, key):  # the step's 15 calls at B = 8, summed
            return sum(v[key] * v["calls_per_step"] for k, v in table.items()
                       if k.endswith(f"B={CAPACITY}"))

        # the step's 15 calls as one function: the larger of all their bytes
        # at 3.35 TB/s and all their operations at 1,979 TOPS
        t_bytes = 1e3 * sum(k4_bound_ms(CAPACITY, s, dtype, dtype)[2] * n
                            for s, n in K4_SHAPES.values()) / PEAK_BYTES
        t_ops = 1e3 * sum(k4_bound_ms(CAPACITY, s, dtype, dtype)[3] * n
                          for s, n in K4_SHAPES.values()) / PEAK_INT8_OPS
        entries.append({
            "name": f"qconv3x3 ({DNAME[dtype]})", "route": "cuda", "source": K4_SOURCE,
            "replaces": K4_REPLACES, "launches": main_k4[dtype],
            "max_abs_err": k4_err[dtype], "ms": per_step(shapes, "ms"),
            "device_ms": per_step(shapes, "device_ms"), "plain_ms": per_step(shapes, "plain_ms"),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "library_ms": per_step(shapes, "int_mm_ms"),
            "cudnn_bf16_ms": per_step(shapes, "cudnn_bf16_ms"),
            "int8_entry_device_ms": per_step(shapes, "int8_entry_device_ms"),
            "pr13_route_ms": per_step(shapes, "pr13_route_ms"),
            "pr13_route_device_ms": per_step(shapes, "pr13_route_device_ms"),
            "dynamic_device_ms": per_step(shapes, "dynamic_device_ms"),
            "pr13_dynamic_device_ms": per_step(shapes, "pr13_dynamic_device_ms"),
            "per_shape": shapes, "pool_step_ms": times[DNAME[dtype]],
            "trace_per_step": traces[DNAME[dtype]]["kinds"], "tensor_cores": True,
            "design": K4_DESIGN,
            "note": "times are per pool step at B = 8 (the 15 calls of one CISTA-LSTC step "
                    "summed over the site shapes), float input and output in the row's dtype, "
                    "static s_x; the bound counts the float input read once; library_ms is "
                    "torch._int_mm on the int8 im2col (built outside the timed call), which "
                    "computes the integer core only; pr13_route_* is eager quantize_with of each "
                    "part and the kernel's int8 entry; no Pallas kernel: it replaces XLA's "
                    "int8 conv and the quantize before it",
        })
        entries.append({
            "name": f"act_scale ({DNAME[dtype]})", "route": "cuda", "source": QSCALE_SOURCE,
            "replaces": QSCALE_REPLACES, "launches": main_scale[dtype], "max_abs_err": 0.0,
            "ms": per_step(scales, "ms"), "device_ms": per_step(scales, "device_ms"),
            "plain_ms": per_step(scales, "plain_ms"),
            "plain_device_ms": per_step(scales, "plain_device_ms"),
            "bound_ms": per_step(scales, "bound_ms"), "bound_by": "bytes",
            "library_ms": per_step(scales, "vector_norm_ms"),
            "library_device_ms": per_step(scales, "vector_norm_device_ms"),
            "per_shape": scales,
            "note": "times per pool step at B = 8 (the 15 dynamic sites of one CISTA-LSTC step "
                    "summed); library_ms is torch.linalg.vector_norm(x, inf) once per part; "
                    "bit-equal to its plain version (the eager passes it replaces); no Pallas "
                    "kernel: it replaces XLA's max |x| / 127 of quantize_activation",
        })
    say(f"[phase] int8 inference {time.perf_counter() - t_phase:.1f} s")
    return {"entries": entries, "rows": rows}


SLOMO_FRAMES, SLOMO_SEQUENCES = 8, 2  # LFR frames per sequence of phase 17's dataset
SLOMO_TOL = 1e-4  # UNets card vs CPU, of the largest entry, TF32 off
BACKWARP_TOL = 1e-5  # card vs CPU, absolute
SLOMO_GAP = 0.15  # least distance of a flow magnitude from an integer (the counts' margin)
# the kinds of device kernel phase 17b's traces sort a Super-SloMo call into
SLOMO_KINDS = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "ToNhwc", "ToNchw")),
    ("cuDNN convs", ("fprop", "implicit", "conv", "cudnn", "fft", "sm90_xmma", "gemm")),
    ("gathers (backwarp)", ("gather",)),
    ("bilinear 2x", ("upsample_bilinear",)),
    ("average pools", ("avg_pool",)),
    ("leaky relus", ("leaky",)),
    ("copies and concats", ("copy", "CatArray", "cat_")),
)


def unet_cost(net, x) -> tuple[float, float]:
    """``(flops, bytes)`` of the UNet ``net``'s convs on ``x``: two per
    multiply-add of every conv at its output size, and its float32 weights
    read once."""
    flops = []

    def count(m, _, out):
        flops.append(2 * m.weight.numel() * out.shape[0] * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return float(sum(flops)), 4.0 * sum(p.numel() for p in net.parameters())


def bound_of(flops: float, nbytes: float) -> tuple[float, str]:
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FLOPS[torch.float32], 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flow_scale(mags: np.ndarray) -> float:
    """The largest scale of the flows (a quarter step) that keeps every
    pair's count at 8 or less and every magnitude ``SLOMO_GAP`` or more from
    an integer, so that the card's and the CPU's counts cannot differ."""
    best = None
    for s in np.arange(0.25, 1e4, 0.25):
        x = s * mags
        if x.max() > 8 - SLOMO_GAP:
            break
        if np.abs(x - np.round(x)).min() >= SLOMO_GAP:
            best = float(s)
    if best is None:
        fail(f"no flow scale keeps the magnitudes {mags} off the integers")
    return best


def upsampling_phase(seed: int, smi: str, root: Path) -> dict:
    """Phase 17: Super-SloMo upsampling at full width (180x240, padded to
    192x256, float32, TF32 off): (a) both UNets and ``backwarp`` on the card
    against the CPU on the same weights, with the UNets' TF32 control; (b)
    ``Upsampler.upsampling`` over one sequence of LFR frames with the flow
    net scaled (a checkpoint written here) on the card against the CPU, and
    its times; (c) both CLIs with ``--reader_type upsampling`` reading that
    checkpoint through ``V2E2V_SUPERSLOMO_CKPT``, every count set to 0 just
    before each. Returns each CLI's launches by row of the kernels line."""
    import os

    from v2e2v_tpu_torch._device import float32_math
    from v2e2v_tpu_torch.data import interpolating_reader as reader_mod
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models import superslomo as slomo
    from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.utils.image_io import read_gray

    t_phase = time.perf_counter()
    data, ckpt = root / "lfr", root / "SuperSloMo.ckpt"
    write_dataset(data, seed, SLOMO_SEQUENCES, SLOMO_FRAMES, H, W, CLI_EVENTS)
    seq = sorted(data.iterdir())[0] / "frames"
    frames = [read_gray(str(p)) for p in sorted(seq.glob("*.png"))]
    stamps = [float(ln.split()[1]) for ln in (seq / "timestamps.txt").read_text().splitlines()]
    gen = torch.Generator().manual_seed(seed)
    flow_net, intrp_net = slomo.UNet(6, 4, gen), slomo.UNet(20, 5, gen)
    torch.save({"state_dictFC": flow_net.state_dict(), "state_dictAT": intrp_net.state_dict()},
               ckpt)
    probe = slomo.Upsampler([H, W], ckpt_path=str(ckpt), device="cpu")
    net_in = [probe.crop.pad(torch.from_numpy(probe._to_net(f))[None]) for f in frames]
    hp, wp = net_in[0].shape[1:3]

    # (a) the UNets and backwarp on the card against the CPU
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    inputs = {"flow": (probe.flow_net, torch.cat(net_in[:2], -1)),
              "interp": (probe.intrp_net, 0.5 * torch.randn(1, hp, wp, 20, generator=cpu_gen))}
    for name, (net, x) in inputs.items():
        card = copy.deepcopy(net).to("cuda")
        with torch.no_grad():
            want = net(x)
            with float32_math():
                got = card(x.cuda()).cpu()
            with tf32_math():
                got_tf32 = card(x.cuda()).cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        err_tf32 = float((got_tf32 - want).abs().max()) / scale
        ok = bool(torch.isfinite(got).all()) and err <= SLOMO_TOL < err_tf32
        say(f"[slomo] {name} UNet {tuple(x.shape)} card vs CPU, same weights, float32 TF32 "
            f"off: max |diff| {err:.3e} of the largest entry ({scale:.4e}; tol {SLOMO_TOL}); "
            f"the TF32 control reads {err_tf32:.3e} (must exceed the tolerance) "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the {name} UNet on the card disagrees with the CPU, or the bound does not "
                 "see TF32")
    img = torch.randn(1, hp, wp, 3, generator=cpu_gen)
    flow = 3 * torch.randn(1, hp, wp, 2, generator=cpu_gen)
    want = slomo.backwarp(img, flow)
    got = slomo.backwarp(img.cuda(), flow.cuda()).cpu()
    err = float((got - want).abs().max())
    outside = float(((torch.arange(wp) + flow[..., 0] < 0)
                     | (torch.arange(wp) + flow[..., 0] > wp - 1)).float().mean())
    say(f"[slomo] backwarp {tuple(img.shape)}, flows N(0, 3^2) ({100 * outside:.1f}% of the x "
        f"sample points outside): card vs CPU max |diff| {err:.3e} (tol {BACKWARP_TOL}) "
        f"{'pass' if err <= BACKWARP_TOL else 'FAIL'}")
    if not err <= BACKWARP_TOL:
        fail("backwarp on the card disagrees with the CPU")

    # (b) the upsampler with the flow net scaled, card against CPU, and times
    with torch.no_grad():
        mags = np.array([max(float(f.square().sum(-1).sqrt().max())
                             for f in slomo.flow_pair(probe.flow_net, a, b))
                         for a, b in zip(net_in[:-1], net_in[1:])])
    s = flow_scale(mags)
    with torch.no_grad():
        flow_net.conv3.weight.mul_(s)
        flow_net.conv3.bias.mul_(s)
    torch.save({"state_dictFC": flow_net.state_dict(), "state_dictAT": intrp_net.state_dict()},
               ckpt)
    up = slomo.Upsampler([H, W], ckpt_path=str(ckpt), device="cuda")
    up_cpu = slomo.Upsampler([H, W], ckpt_path=str(ckpt), device="cpu")
    counts = [int(np.ceil(m)) for m in s * mags]
    gaps = np.abs(s * mags - np.round(s * mags))
    up.upsampling(frames[:2], stamps[:2])  # the first cuDNN calls
    calls = {"flow": [], "interp": []}

    def recorded(fn, key):
        def call(*a):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            calls[key].append(ev)
            return out
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with swapped((slomo, "flow_pair", recorded(slomo.flow_pair, "flow")),
                 (slomo, "interp_at_t", recorded(slomo.interp_at_t, "interp"))):
        t0 = time.perf_counter()
        got_frames, got_ts = up.upsampling(frames, stamps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    t0 = time.perf_counter()
    want_frames, want_ts = up_cpu.upsampling(frames, stamps)
    cpu_s = time.perf_counter() - t0
    got_counts = [int(((got_ts > a) & (got_ts < b)).sum()) + 1 for a, b in zip(stamps, stamps[1:])]
    diff = got_frames.astype(int) - want_frames.astype(int) if got_frames.shape == \
        want_frames.shape else np.full(1, 255)
    ok = (got_counts == counts and np.array_equal(got_ts, want_ts)
          and got_frames.shape == (sum(counts) + 1, H, W) and np.abs(diff).max() <= 1
          and min(counts) >= 2)
    say(f"[slomo] Upsampler.upsampling, {len(frames)} LFR frames {H}x{W} (padded {hp}x{wp}), "
        f"flow net's conv3 scaled by {s} (unscaled max |flow| per pair "
        f"{np.round(mags, 5).tolist()}): counts card {got_counts}, want {counts} (each "
        f"magnitude >= {gaps.min():.3f} from an integer; tol {SLOMO_GAP}); {len(got_ts)} frames; "
        f"timestamps equal to the CPU's={np.array_equal(got_ts, want_ts)}; frames within one "
        f"code: max |diff| {int(np.abs(diff).max())}, {np.count_nonzero(diff)} of {diff.size} "
        f"codes differ; CPU run {cpu_s:.2f} s {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the upsampler on the card disagrees with the CPU")
    i0, i1 = (f.cuda() for f in net_in[:2])
    with torch.no_grad(), float32_math():
        f01, f10 = slomo.flow_pair(up.flow_net, i0, i1)
        # each function's own inputs read and output written once: the two
        # frames in and the flows out; the frames and flows in and a frame out
        for key, fn, net, x, planes in (
                ("flow", lambda: slomo.flow_pair(up.flow_net, i0, i1), up.flow_net,
                 torch.cat([i0, i1], -1), 3 + 3 + 4),
                ("interp", lambda: slomo.interp_at_t(up.intrp_net, i0, i1, f01, f10, 0.5),
                 up.intrp_net, torch.zeros(1, hp, wp, 20, device="cuda"), 3 + 3 + 2 + 2 + 3)):
            issued = float(np.mean([a.elapsed_time(b) for a, b in calls[key]]))
            dev = device_ms(fn, iters=10)
            flops, nbytes = unet_cost(net, x)
            bound_ms, bound_by = bound_of(flops, nbytes + 4 * hp * wp * planes)
            say(f"[time] Super-SloMo {key} call ({'flow_pair' if key == 'flow' else 'interp_at_t'}"
                f", {hp}x{wp}, float32, TF32 off; {smi}): {issued:.4f} ms as issued in the "
                f"upsampling run (mean of {len(calls[key])} calls, CUDA events), {dev:.4f} ms on "
                f"the device (back to back); {flops / 1e9:.2f} GFLOP in its UNet's convs, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s, "
                f"{PEAK_BYTES / 1e12:.2f} TB/s) = {100 * bound_ms / issued:.1f}% of bound as "
                f"issued, {100 * bound_ms / dev:.1f}% on the device")
        # where a call's device time goes, by kind of kernel
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "profile_torch_pool",
            Path(__file__).resolve().parent / "scripts" / "profile_torch_pool.py")
        prof = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(prof)
        prof.CATEGORIES = SLOMO_KINDS
        prof.trace(lambda: slomo.flow_pair(up.flow_net, i0, i1), 5, "Super-SloMo flow_pair")
        prof.trace(lambda: slomo.interp_at_t(up.intrp_net, i0, i1, f01, f10, 0.5), 5,
                   "Super-SloMo interp_at_t")
    pairs = len(frames) - 1
    say(f"[time] Super-SloMo upsampling ({smi}): {1e3 * run_s / pairs:.3f} ms per pair (host "
        f"clock, {pairs} pairs, {sum(counts) - pairs} interpolated frames, {run_s:.3f} s), "
        f"{len(got_ts) / run_s:.1f} output frames/s; max_memory_allocated {peak:.1f} MiB above "
        f"what earlier phases hold ({base / 2**20:.1f} MiB)")

    # (c) both CLIs with --reader_type upsampling, the checkpoint through the
    # environment variable, every count at 0 just before each
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    e2v_model, v2e2v_model = root / "e2v.pth.tar", root / "v2e2v.pth.tar"
    torch.save({"epoch": 0, "state_dict": sd, "v2e_params": None}, e2v_model)
    torch.save({"epoch": 0, "v2e_params": V2E_PARAMS,
                "state_dict": {f"e2v_net.{k}": v for k, v in sd.items()}}, v2e2v_model)
    rows = {}
    saved_env = os.environ.get(slomo.CKPT_ENV_VAR)
    os.environ[slomo.CKPT_ENV_VAR] = str(ckpt)
    upsample = {"s": [0.0, 0]}
    reader_init = timed(reader_mod.InterpolatingReader.initialize, upsample, "s")
    try:
        with swapped((reader_mod.InterpolatingReader, "initialize", reader_init)):
            # the V2E2V CLI: LFR -> Super-SloMo -> emulator (K3) -> CISTA-LSTC (K1)
            run = v2e2v_cli(data, v2e2v_model, root / "slomo_v2e2v", seed,
                            extra=("--reader_type", "upsampling"))
            records = []
            counts_zero(*kernel_counters())
            with recorded_forward(records), contextlib.redirect_stdout(None):
                t0 = time.perf_counter()
                run.run()
                torch.cuda.synchronize()
                v2e2v_s = time.perf_counter() - t0
            rows["upsampling_v2e2v_cli_launches"] = row_counts()
            k3_n, k1_n, k2_n = emulator_iters.launches, ista_loop.launches, cista_core.launches
            pairs = [p for _, _, p in records]
            recs = torch.stack([o.reconstruction for o, _, _ in records])
            ev = [int(o.num_events) for o, _, _ in records]
            out_dir = root / "slomo_v2e2v" / "v2e2v.pth"
            pngs = sorted(out_dir.glob("*/frame_*.png"))
            previews = sorted(out_dir.glob("*/events/events_*.png"))
            ok = (len(records) >= 2 * SLOMO_SEQUENCES and bool(torch.isfinite(recs).all())
                  and bool(((recs >= 0) & (recs <= 1)).all()) and min(ev) > 0
                  and k3_n == sum(pairs) and k1_n == 2 * DEPTH * len(records) and k2_n == 0
                  and len(pngs) == len(previews) == len(records)
                  and [n for _, n, _ in records] == [[p, 2 * DEPTH] for p in pairs])
            seq_s = upsample["s"][0] / max(upsample["s"][1], 1)
            say(f"[slomo-cli] V2E2V CLI --reader_type upsampling, {SLOMO_SEQUENCES} sequences "
                f"of {SLOMO_FRAMES} LFR frames {H}x{W}: {len(records)} packs of 10 upsampled "
                f"frames, num_events {ev}; K3 launches {k3_n} (want {sum(pairs)}, one per frame "
                f"pair), K1 {k1_n} (want {2 * DEPTH * len(records)}), K2 {k2_n}; "
                f"{len(pngs)} reconstruction PNGs, {len(previews)} event previews; "
                f"reconstructions finite and in [0, 1]; run() {v2e2v_s:.3f} s, of which the "
                f"reader's upsampling {seq_s:.3f} s a sequence {'pass' if ok else 'FAIL'}")
            if not ok:
                fail("the V2E2V CLI with --reader_type upsampling did not run as it should")

            # the E2V CLI: upsampled frames as the ground truth beside the events
            upsample["s"] = [0.0, 0]
            rec = cli_reconstructor(data, e2v_model, torch.float32, "slomo_e2v", "cuda",
                                    extra=("--reader_type", "upsampling", "--test_data_mode",
                                           "upsampled"))
            steps = record_steps(rec, keep_state=False)
            counts_zero(*kernel_counters())
            with contextlib.redirect_stdout(None):
                t0 = time.perf_counter()
                rec.run()
                torch.cuda.synchronize()
                e2v_s = time.perf_counter() - t0
            rows["upsampling_e2v_cli_launches"] = row_counts()
            k1_n, k2_n, k3_n = ista_loop.launches, cista_core.launches, emulator_iters.launches
            recs = torch.stack([r for r, _ in steps])
            out_dir = root / "slomo_e2v" / "e2v.pth"
            pngs = sorted(out_dir.glob("*/*.png"))
            results = sorted(out_dir.glob("*/result.csv"))
            ok = (len(steps) >= SLOMO_SEQUENCES and bool(torch.isfinite(recs).all())
                  and bool(((recs >= 0) & (recs <= 1)).all()) and k1_n == 2 * DEPTH * len(steps)
                  and k2_n == k3_n == 0 and len(pngs) == len(steps)
                  and len(results) == SLOMO_SEQUENCES)
            say(f"[slomo-cli] E2V CLI --reader_type upsampling --test_data_mode upsampled, "
                f"float32: {len(steps)} reconstructions; K1 launches {k1_n} (want "
                f"{2 * DEPTH * len(steps)}), K2 {k2_n}, K3 {k3_n}; {len(pngs)} PNGs, "
                f"{len(results)} result.csv; reconstructions finite and in [0, 1]; run() "
                f"{e2v_s:.3f} s, of which the reader's upsampling "
                f"{upsample['s'][0] / max(upsample['s'][1], 1):.3f} s a sequence "
                f"{'pass' if ok else 'FAIL'}")
            if not ok:
                fail("the E2V CLI with --reader_type upsampling did not run as it should")
    finally:
        if saved_env is None:
            os.environ.pop(slomo.CKPT_ENV_VAR, None)
        else:
            os.environ[slomo.CKPT_ENV_VAR] = saved_env
    say(f"[phase] Super-SloMo upsampling {time.perf_counter() - t_phase:.1f} s")
    return rows


DIST_LOSS_TOL = 1e-5  # relative: two ranks against one process (phase 18b)
# of each gradient tensor's largest entry (phase 18b): a rank's gradient before
# the reduction against one process's step on the same rows, and the reduced
# gradient against one process's two half-batch steps combined. Readings on an
# H100 80GB HBM3 at 700 W: 3.3e-07-1.05e-06, as one process against itself
# (5.4e-07-1.07e-06, cuDNN's nondeterministic weight gradients); the planted
# faults 7.3e-02 and 7.2e-01
DIST_GRAD_TOL = 1e-5
# the same against one process's whole-batch step: the card's weight gradients
# at B = 8 and as two steps at B = 4 differ by 1.1e-04 (V2E2V) and 9.0e-04
# (device data) of We's largest entry in one process, group or not (same card)
DIST_BATCH_TOL = 1e-2
MESH_POOL_TOL = 1e-5  # float32, TF32 off: the pool over two groups against one (phase 18c)
DD_REAL = 5  # phase 18b's device-data batch: 5 samples padded to 8, the padding all on rank 1
K3_KERNEL = "emulator_iters_kernel"  # K3's CUDA symbol, as a trace names it


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_flags(port: int) -> list[str]:
    """A world of one: the ``--dist_*`` flags of process 0 of 1."""
    return ["--dist_coordinator", f"localhost:{port}", "--dist_num_processes", "1",
            "--dist_process_id", "0"]


def gloo_steps(seed: int, mesh) -> dict:
    """Phase 18b's two train steps on ``mesh`` (None: one process), each
    twice from the same weights: the first is compared, the second timed
    (host clock to a synchronize). A V2E2V step at full width (global B = 8,
    TRAIN_T packs of 10 frames, K3 with its Philox, noise seeded by
    ``seed``) and an E2V device-data step (global B = 8, T = TRAIN_T, 5 real
    samples and 3 of padding, --add_noise's draw). On a mesh each rank hands
    the V2E2V step its rows (``Mesh.rows``), as ``cli.train`` does, and the
    device-data step the whole batch's ``idx`` and ``w``. Returns per step the
    first call's loss, gradients (on the CPU), events and on a mesh the
    gradients the rank handed the reduction (``local``), each call's launches
    of K3, K1 and K2, the second call's gradients (the card's run-to-run
    spread) and ms. In one process also each rank's share computed alone
    (``shares``: the step's loss on those rows, the draws and weights the
    global batch's) and two planted faults (``faults``): a rank's emulator
    drawing for its own rows instead of the global batch (V2E2V), and the
    padding's weight dropped (device data)."""
    from v2e2v_tpu_torch._device import float32_math
    from v2e2v_tpu_torch.data.synthetic import hfr_frames
    from v2e2v_tpu_torch.models.cista import CistaConfig
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops.voxel import add_noise_to_voxel
    from v2e2v_tpu_torch.parallel.mesh import RowsNoise
    from v2e2v_tpu_torch.training import steps as steps_mod
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    keys = STEP_KEYS["cista-lstc"]
    k1, k2, k3, _, _ = kernel_counters()
    cfg = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS))
    cfg = dataclasses.replace(cfg, cista=dataclasses.replace(cfg.cista, ista_impl="plain"))
    b, n = CAPACITY, N_FRAMES
    video, t = hfr_frames(seed, TRAIN_T * (n - 1) + 1, H, W, batch=b)
    frames = torch.stack([torch.from_numpy(video[:, p * (n - 1):p * (n - 1) + n])
                          for p in range(TRAIN_T)]).cuda()
    ts = torch.stack([torch.from_numpy(np.tile(t[p * (n - 1):p * (n - 1) + n], (b, 1)))
                      for p in range(TRAIN_T)]).cuda()
    gt = frames[-1][:, -1, :, :, None] / 255.0
    e2v_cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                          ista_impl="plain", core_impl="layers")
    data, gt_all = train_batch(seed + 1, DD_REAL, TRAIN_T)
    data, gt_all = data.movedim(1, 0).contiguous().cuda(), gt_all.float().cuda()  # [N, T, ...]
    idx = torch.tensor(list(range(DD_REAL)) + [DD_REAL - 1] * (b - DD_REAL), device="cuda")
    w = torch.tensor([1.0] * DD_REAL + [0.0] * (b - DD_REAL), device="cuda")
    noise = lambda: GeneratorNoise(torch.Generator(device="cuda").manual_seed(seed))  # noqa: E731
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    rows = mesh.rows if mesh is not None else (lambda x, dim=0: x)

    local = []
    reduce_ = steps_mod._reduce_loss_and_grads

    def keep_local(optimizer, loss, axis, summed):
        local.append({k: p.grad.detach().cpu().clone() for k, p in
                      zip(keys, steps_mod._weights(optimizer))})
        return reduce_(optimizer, loss, axis, summed)

    def run(name, net_cfg, make_step, call):
        out = {"launches": [], "ms": None}
        for i in range(2):
            sd = train_weights(net_cfg, seed, "cuda")
            step = make_step(sd)
            local.clear()
            counts_zero(k1, k2, k3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with swapped((steps_mod, "_reduce_loss_and_grads", keep_local)):
                loss, stats = call(step, sd)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            out["launches"].append([k3.launches_by_shot["internal"], k3.launches, k1.launches,
                                    k2.launches])
            grads = {k: sd[k].grad.detach().cpu() for k in keys}
            if i == 0:
                out.update(loss=float(loss), events=int(stats["num_events"]) if stats else None,
                           grads=grads, local=local[0] if local else None)
            else:
                out.update(ms=ms, grads_again=grads)
        return name, out

    results = dict([
        run("v2e2v", cfg.cista, lambda sd: steps_mod.make_v2e2v_train_step(
                cfg, steps_mod.make_adam(sd, cfg.cista, TRAIN_LR), mesh=mesh),
            lambda step, sd: step(sd, rows(frames, 1), rows(ts, 1), rows(gt, 0), noise())),
        run("device_data", e2v_cfg, lambda sd: steps_mod.make_e2v_train_step_device_data(
                e2v_cfg, steps_mod.make_adam(sd, e2v_cfg, TRAIN_LR), noise_std=0.1, mesh=mesh),
            lambda step, sd: (step(sd, data, gt_all, idx, gen(), w), None)),
    ])
    if mesh is not None:
        return results

    def grads_of(net_cfg, loss_fn):
        """The gradients of ``loss_fn(weights)`` at the seed's weights, TF32 off."""
        sd = train_weights(net_cfg, seed, "cuda")
        steps_mod.trainable_params(sd, net_cfg)
        with float32_math():
            loss_fn(sd).backward()
        return {k: sd[k].grad.detach().cpu() for k in keys}

    def v2e2v_share(s, own_draws=False):
        draws = noise() if own_draws else RowsNoise(noise(), s, b)
        return grads_of(cfg.cista, lambda sd: steps_mod.v2e2v_loss(
            sd, cfg, frames[:, s], ts[:, s], gt[s], draws)[0])

    def device_data_share(s):
        vs = data.index_select(0, idx[s]).movedim(1, 0).float()
        vs = add_noise_to_voxel(gen(), vs, 0.1, noise_fraction=1.0, rows=(1, s, b))
        return grads_of(e2v_cfg, lambda sd: steps_mod.e2v_loss(
            sd, e2v_cfg, vs, gt_all.index_select(0, idx[s]).float(), w[s],
            batch_weights=w))

    shares = [slice(0, b // 2), slice(b // 2, b)]
    results["v2e2v"]["shares"] = [v2e2v_share(s) for s in shares]
    results["device_data"]["shares"] = [device_data_share(s) for s in shares]
    # the planted faults, each as the reduction would give it
    own = v2e2v_share(shares[1], own_draws=True)
    results["v2e2v"]["faults"] = {
        "rank 1 draws its own rows": {k: (g + own[k]) / 2 for k, g in
                                      results["v2e2v"]["shares"][0].items()}}
    sd = train_weights(e2v_cfg, seed, "cuda")
    steps_mod.make_e2v_train_step_device_data(
        e2v_cfg, steps_mod.make_adam(sd, e2v_cfg, TRAIN_LR), noise_std=0.1)(
        sd, data, gt_all, idx, gen(), torch.ones_like(w))
    results["device_data"]["faults"] = {
        "padding weight dropped": {k: sd[k].grad.detach().cpu() for k in keys}}
    return results


def gloo_rank(rank: int, port: int, workdir: Path, seed: int) -> None:
    """One of phase 18b's two ranks: a process group over ``gloo`` on the
    one card, ``gloo_steps`` on its data axis, the results to
    ``workdir/rank<rank>.pt``."""
    from v2e2v_tpu_torch.parallel import distributed
    from v2e2v_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flags = argparse.Namespace(dist_coordinator=f"localhost:{port}", dist_num_processes=2,
                               dist_process_id=rank)
    distributed.initialize_from_flags(flags, backend="gloo")
    try:
        mesh = make_mesh(2)
        torch.save(gloo_steps(seed, mesh), workdir / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def grad_error(got: dict, want: dict) -> tuple[float, str]:
    """The largest of each gradient's max |diff| / max |g|, and its tensor."""
    return max((float((got[k] - g).abs().max()) / float(g.abs().max()), k)
               for k, g in want.items())


def start_self(workdir: Path, world: int, *extra) -> list[str]:
    """This script once per rank of ``world`` with ``--gloo_rank r --port p
    --dir workdir`` and ``extra``; waits for all, kills any left over, and
    returns their outputs (failing the run if one failed)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--gloo_rank",
                               str(r), "--port", str(port), "--dir", str(workdir), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        for r, o in enumerate(outs):
            say(f"[dist] rank {r} output:\n{o[-4000:]}")
        fail(f"a gloo rank ({' '.join(extra)}) failed")
    return outs


def gloo_verdict(single: dict, ranks: list) -> bool:
    """Phase 18b's checks of ``gloo_steps``' results, one process's
    (``single``) against each rank's, printed; whether all hold."""
    all_ok = True
    for step_name, want_k3 in (("v2e2v", 9 * TRAIN_T), ("device_data", 0)):
        want = single[step_name]
        # the ranks' reduction: the mean of their gradients, their sum where
        # the loss is weighted (each share divides by the whole batch's weight)
        combine = ((lambda a, b: (a + b) / 2) if step_name == "v2e2v" else
                   (lambda a, b: a + b))
        halves = {k: combine(want["shares"][0][k], want["shares"][1][k])
                  for k in want["grads"]}
        spread = grad_error(want["grads_again"], want["grads"])[0]
        split = grad_error(halves, want["grads"])[0]
        faults = {f: (grad_error(g, halves)[0], grad_error(g, want["grads"])[0])
                  for f, g in want["faults"].items()}
        ok = all(min(e) > DIST_BATCH_TOL for e in faults.values())
        errs = []
        for r, got in enumerate(ranks):
            got = got[step_name]
            loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            local_err = grad_error(got["local"], want["shares"][r])[0]
            mine = {k: combine(ranks[0][step_name]["local"][k], ranks[1][step_name]["local"][k])
                    for k in halves}
            exact = all(torch.equal(got["grads"][k], mine[k]) for k in mine)
            halves_err = grad_error(got["grads"], halves)[0]
            batch_err, worst = grad_error(got["grads"], want["grads"])
            errs.append((loss_err, local_err, exact, halves_err, batch_err))
            ok = ok and loss_err <= DIST_LOSS_TOL and exact and got["events"] == want["events"]
            ok = ok and max(local_err, halves_err) <= DIST_GRAD_TOL
            ok = ok and batch_err <= DIST_BATCH_TOL
            ok = ok and all(n == [want_k3, want_k3, 0, 0] for n in got["launches"])
        ok = ok and all(n == [want_k3, want_k3, 0, 0] for n in want["launches"])
        all_ok = all_ok and ok
        say(f"[dist] (b) {step_name} step, two ranks over gloo on one card against one process "
            f"(global B={CAPACITY}, {TRAIN_T} packs or windows, {H}x{W}, C={C}, depth {DEPTH}"
            f"{'' if step_name == 'v2e2v' else f'; {DD_REAL} real samples, the padding all on rank 1'}"
            f"): events {[g[step_name]['events'] for g in ranks]} vs {want['events']}; loss "
            f"relative error {[f'{e[0]:.2e}' for e in errs]} (tol {DIST_LOSS_TOL}); gradients, "
            f"of each tensor's largest entry: each rank's before the reduction against one "
            f"process's step on its {CAPACITY // 2} rows {[f'{e[1]:.2e}' for e in errs]}, the "
            f"reduction equal to the ranks' {'mean' if step_name == 'v2e2v' else 'sum'} "
            f"{[e[2] for e in errs]}, the reduced against one process's two half-batch steps "
            f"{[f'{e[3]:.2e}' for e in errs]} (tol {DIST_GRAD_TOL}; one process against itself "
            f"{spread:.2e}), against one process's whole-batch step "
            f"{[f'{e[4]:.2e}' for e in errs]} ({worst}; tol {DIST_BATCH_TOL}; one process's "
            f"half-batch steps against its whole-batch step {split:.2e}); planted faults, "
            f"against the half-batch and the whole-batch reference: "
            f"{ {f: f'{e[0]:.2e}, {e[1]:.2e}' for f, e in faults.items()} } (each must exceed "
            f"{DIST_BATCH_TOL}); K3 (internal), K3, K1, K2 launches per rank per step "
            f"{[g[step_name]['launches'] for g in ranks]} (want {want_k3}, {want_k3}, 0, 0) "
            f"{'pass' if ok else 'FAIL'}")
    return all_ok


def same_files(a: Path, b: Path, pattern: str) -> tuple[int, bool]:
    """How many files under ``a`` match ``pattern``, and whether ``b`` holds
    the same names with the same bytes."""
    fa = sorted(p.relative_to(a) for p in a.rglob(pattern))
    fb = sorted(p.relative_to(b) for p in b.rglob(pattern))
    return len(fa), fa == fb and all((a / f).read_bytes() == (b / f).read_bytes() for f in fa)


def distributed_phase(seed: int, smi: str, root: Path, serve, served: dict, layers_recs: dict,
                      weights, cfg, cli_k1: dict, hfr: dict) -> dict:
    """Phase 18: profiling and the data axis (ROADMAP items 10 and 9). (a) one
    rank over NCCL through ``cli.train_e2v``; (b) two ranks over gloo on the
    one card against one process; (c) a pool over two device groups; (d)
    ``--profile_dir`` and ``--debug_nans`` in the trainers; (e) the
    evaluation CLIs in a world of one. Returns each path's launches by row of
    the kernels line."""
    from v2e2v_tpu_torch.cli import test as cli_test
    from v2e2v_tpu_torch.cli import test_e2v as cli_e2v
    from v2e2v_tpu_torch.cli import train, train_e2v
    from v2e2v_tpu_torch.data.datasets import TrainFixNEventData
    from v2e2v_tpu_torch.parallel.mesh import make_mesh
    from v2e2v_tpu_torch.serving import StreamPool
    from v2e2v_tpu_torch.training import steps as steps_mod

    t_phase = time.perf_counter()
    counters = kernel_counters()
    k1, k2, k3 = counters[:3]
    rows = {}
    e2v_data, v2e2v_data = root / "train_e2v_data", root / "train_v2e2v_data"
    name = f"_cista-lstc_b{NB}_d{DEPTH}_c{C}"

    # (a) one rank over NCCL through the E2V trainer, against no group. The
    # card's E2V backward is not reproducible run to run (the reflect pad's
    # and the bilinear upsample's backward add with atomics; torch lists both
    # as nondeterministic), so the exact checks are the ones the card allows:
    # the first step's loss, and the group's reduction at every step
    step_ms, losses, reduced, reduce_ms = [], [], [], []
    build = steps_mod.make_e2v_train_step
    reduce_ = steps_mod._reduce_loss_and_grads

    def timed_build(*a, **k):
        step = build(*a, **k)

        def timed_step(*sa):
            t0 = time.perf_counter()
            loss = step(*sa)
            torch.cuda.synchronize()
            step_ms[-1].append(1e3 * (time.perf_counter() - t0))
            losses[-1].append(loss.clone())
            return loss

        return timed_step

    def checked_reduce(optimizer, loss, axis, summed):
        before = [p.grad.clone() for g in optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = reduce_(optimizer, loss, axis, summed)
        ev[1].record()
        ev[1].synchronize()
        reduce_ms.append(ev[0].elapsed_time(ev[1]))
        after = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        reduced.append((bool(torch.equal(out, loss)) and len(after) == len(before)
                        and all(torch.equal(a, b) for a, b in zip(after, before)),
                        sum(b.numel() for b in before)))
        return out

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ckpts, logs = {}, {}
    try:
        for run_name, extra in (("none", []), ("nccl", dist_flags(free_port())),
                                ("none again", [])):
            step_ms.append([])
            losses.append([])
            models = root / f"dist_a_{len(ckpts)}"
            out = io.StringIO()
            with contextlib.redirect_stdout(out), swapped(
                    (steps_mod, "make_e2v_train_step", timed_build),
                    (steps_mod, "_reduce_loss_and_grads", checked_reduce)):
                train_e2v.main(train_argv(e2v_data, models, "--epochs", "1", *extra))
            logs[run_name] = out.getvalue()
            ckpts[run_name] = torch.load(models / name / f"{name}_1.pth.tar", map_location="cpu",
                                         weights_only=False)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    def ckpt_diff(a, b) -> float:
        sa, sb = a["state_dict"], b["state_dict"]
        return max(float((sa[k] - sb[k]).abs().max()) for k in sa)

    n_steps = len(step_ms[0])
    # the checkpoints' distances are shown, not checked: Adam moves each weight
    # by about lr a step whatever its gradient, so any two runs from the same
    # weights end within 2 x lr x steps, and the card's backward is not
    # reproducible run to run, so neither pair is equal
    d_group = ckpt_diff(ckpts["nccl"], ckpts["none"])
    d_again = ckpt_diff(ckpts["none again"], ckpts["none"])
    first_equal = all(torch.equal(run[0], losses[0][0]) for run in losses)
    joined = "distributed: process 0/1, 1 local / 1 global devices (nccl)" in logs["nccl"]
    med = [float(np.median(m[1:])) for m in step_ms]
    ok = (joined and not torch.distributed.is_initialized() and first_equal
          and len(reduced) == n_steps and all(r for r, _ in reduced))
    say(f"[dist] (a) cli.train_e2v, 1 epoch over phase 13c's dataset ({n_steps} steps at "
        f"batch 1, cuDNN deterministic), a world of one over NCCL (--dist_* flags) against no "
        f"group: group made={joined}, torn down={not torch.distributed.is_initialized()}; the "
        f"group's all-reduce left the loss and every gradient bit for bit at "
        f"{sum(r for r, _ in reduced)} of {len(reduced)} steps; first step's loss equal in all "
        f"three runs: "
        f"{first_equal} ({float(losses[0][0]):.9f}) {'pass' if ok else 'FAIL'}; shown, not "
        f"checked: checkpoints max|diff| {d_group:.3e} against the run without the group, "
        f"{d_again:.3e} between the two runs without it")
    say(f"[time] (a) E2V train step at batch 1 ({smi}), median of {n_steps - 1} after the "
        f"first, host clock to the loss: no group {med[0]:.3f} ms, world of one over NCCL "
        f"{med[1]:.3f} ms, no group again {med[2]:.3f} ms; the group's share "
        f"{100 * (med[1] - (med[0] + med[2]) / 2) / ((med[0] + med[2]) / 2):+.2f}%; the group's "
        f"reduction alone (one all-reduce of the loss and "
        f"{reduced[0][1]} float32 gradients, the concatenation and the "
        f"copy back; CUDA events): {float(np.mean(reduce_ms)):.4f} ms a step, "
        f"{100 * float(np.mean(reduce_ms)) / med[1]:.2f}% of the step")
    if not ok:
        fail("a world of one over NCCL changed what the E2V trainer computes")

    # (b) two ranks over gloo on the one card against one process
    t0 = time.perf_counter()
    single = gloo_steps(seed, None)
    single_s = time.perf_counter() - t0
    workdir = root / "gloo"
    workdir.mkdir()
    t0 = time.perf_counter()
    start_self(workdir, 2, "--seed", str(seed))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    all_ok = gloo_verdict(single, ranks)
    say(f"[time] (b) gloo, two ranks on ONE card ({smi}; not a scaling figure): ms per step, "
        f"second call, host clock: v2e2v {[round(g['v2e2v']['ms'], 3) for g in ranks]} (one "
        f"process at B={CAPACITY}: {single['v2e2v']['ms']:.3f}), device_data "
        f"{[round(g['device_data']['ms'], 3) for g in ranks]} (one process "
        f"{single['device_data']['ms']:.3f}); the ranks' run {ranks_s:.1f} s with start-up, "
        f"one process {single_s:.1f} s")
    if not all_ok:
        fail("two ranks over gloo disagree with one process")
    rows["dist_v2e2v_step_launches_per_rank"] = {
        "emulator_iters (internal rng)": ranks[0]["v2e2v"]["launches"][0][0]}

    # (c) a pool over two device groups against the pool of phase 4
    mesh = make_mesh(2, devices=["cuda", "cuda"])
    counts_zero(*counters)
    recs, _, per_step = serve(StreamPool(cfg, weights, CAPACITY, torch.float32, mesh=mesh),
                              served[torch.float32])
    rows["mesh_pool_launches"] = row_counts()
    stacked = torch.stack(list(recs.values()))
    err, close = within(stacked, torch.stack([layers_recs[torch.float32][k] for k in recs]),
                        MESH_POOL_TOL)
    ok = close and all(n == 2 * 2 * DEPTH for n in per_step)
    say(f"[dist] (c) StreamPool over make_mesh(2) (two groups of {CAPACITY // 2} slots on the "
        f"one card), float32, TF32 off, phase 4's schedule and voxel grids: K1 launches per "
        f"step {per_step} (want 2 x {2 * DEPTH}); against phase 4's pool max_abs_err={err:.3e} "
        f"(tol {MESH_POOL_TOL} + {MESH_POOL_TOL} |ref|) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the pool over two device groups disagrees with the pool of phase 4")

    # (d) --profile_dir in cli.train; --debug_nans in cli.train_e2v
    trace_dir = root / "trace"
    v2e = [f"--{k}={v}" for k, v in V2E_PARAMS.items()]
    counts_zero(*counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(train_argv(v2e2v_data, root / "dist_d", "--epochs", "1", "--profile_dir",
                              str(trace_dir), *v2e))
    prof_s = time.perf_counter() - t0
    rows["profiled_v2e2v_train_launches"] = row_counts()
    traces = sorted(trace_dir.glob("rank0.*.pt.trace.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3_in_trace = sum(K3_KERNEL in e.get("name", "") for e in kernels)
    k3_n = k3.launches_by_shot["internal"]
    ok = len(traces) == 1 and k3_in_trace == k3_n > 0
    say(f"[dist] (d) cli.train --profile_dir, 1 epoch over phase 13e's frames: {len(traces)} "
        f"trace ({traces[0].stat().st_size / 2**20 if traces else 0:.1f} MiB, "
        f"{len(events)} events, {len(kernels)} kernels on the card); {K3_KERNEL} in it "
        f"{k3_in_trace} times, K3 launches {k3_n}; run {prof_s:.1f} s with the trace "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the trace of cli.train does not name K3's kernel at each launch")
    emit = TrainFixNEventData._emit
    calls = []

    def nan_emit(self, index, sample):
        seq, img, gt_ = emit(self, index, sample)
        seq = np.array(seq, np.float32)
        seq.flat[-1] = np.nan
        calls.append(index)
        return seq, img, gt_

    raised = None
    with swapped((TrainFixNEventData, "_emit", nan_emit)), \
            contextlib.redirect_stdout(io.StringIO()) as log:
        try:
            train_e2v.main(train_argv(e2v_data, root / "dist_nan", "--epochs", "1",
                                      "--debug_nans"))
        except FloatingPointError as e:
            raised = str(e)
    written = sorted((root / "dist_nan").rglob("*.pth.tar"))
    ok = (raised is not None and "NaN in the loss" in raised and not written
          and "Train Epoch" not in log.getvalue() and not torch.is_anomaly_enabled())
    say(f"[dist] (d) cli.train_e2v --debug_nans, a NaN in every voxel grid: raised "
        f"FloatingPointError({raised!r}) at the first step (no step printed: "
        f"{'Train Epoch' not in log.getvalue()}); checkpoints written {len(written)}; anomaly "
        f"mode off after: {not torch.is_anomaly_enabled()} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("--debug_nans did not stop the E2V trainer at its first NaN")

    # (e) the evaluation CLIs in a world of one against phases 9 and 10
    e2v_root = root / "cli"
    argv = ["--path_to_test_model", str(e2v_root / "model.pth.tar"), "--path_to_test_data",
            str(e2v_root / "data"), "--image_dim", str(H), str(W), "-c", str(C), "-d",
            str(DEPTH), "-b", str(NB), "--num_events", str(NUM_EVENTS), "--test_data_mode",
            "real", "--precision", "float32", "-o", str(root / "dist_e2v")]
    counts_zero(*counters)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        cli_e2v.main(argv + dist_flags(free_port()))
    rows["dist_e2v_cli_launches"] = row_counts()
    got_k1 = rows["dist_e2v_cli_launches"]["ista_loop (float32)"]
    want_dir = e2v_root / "cuda_float32" / "model.pth"
    n_png, same_png = same_files(want_dir, root / "dist_e2v" / "model.pth", "*.png")
    n_csv, same_csv = same_files(want_dir, root / "dist_e2v" / "model.pth", "result.csv")
    joined = "process 0/1, 1 local / 1 global devices (nccl)" in log.getvalue()
    ok = (joined and same_png and same_csv and n_png > 0
          and got_k1 == cli_k1[torch.float32]["cli_launches"])
    say(f"[dist] (e) cli.test_e2v in a world of one over NCCL: {n_png} PNGs and {n_csv} "
        f"result.csv equal to phase 9's float32 main path: {same_png and same_csv}; K1 launches "
        f"{got_k1} (phase 9: {cli_k1[torch.float32]['cli_launches']}); group made {joined} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V CLI in a world of one did not give phase 9's outputs")
    argv = ["--path_to_test_model", str(hfr["model"]), "--path_to_test_data", str(hfr["data"]),
            "--image_dim", str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB),
            "--seed", str(seed), "--is_write_event", "-o", str(root / "dist_v2e2v"), *V2E_FLAGS]
    counts_zero(*counters)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        cli_test.main(argv + dist_flags(free_port()))
    rows["dist_v2e2v_cli_launches"] = row_counts()
    got = {k: rows["dist_v2e2v_cli_launches"][k]
           for k in ("emulator_iters (internal rng)", "ista_loop (float32)")}
    want = {k: hfr["rows"][k] for k in got}
    n_png, same_png = same_files(hfr["out"], root / "dist_v2e2v" / hfr["out"].name, "*.png")
    joined = "process 0/1, 1 local / 1 global devices (nccl)" in log.getvalue()
    ok = joined and same_png and n_png > 0 and got == want
    say(f"[dist] (e) cli.test in a world of one over NCCL: {n_png} PNGs (frames and event "
        f"previews) equal to phase 10's run 3: {same_png}; K3, K1 launches {got} (phase 10: "
        f"{want}); group made {joined} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI in a world of one did not give phase 10's outputs")
    say(f"[phase] profiling and the data axis {time.perf_counter() - t_phase:.1f} s")
    return rows


# phase 19: the spatial axis. Bounds against one process's step on the same
# global batch (float32, TF32 off): the joined last reconstruction (absolute),
# the loss (relative), the reduced weight gradients (of each tensor's largest
# entry; phase 18b's bound against a step at another batch size: a rank of
# (2, 2) runs 4 rows, and the card's weight gradients move with the batch)
SPATIAL_LAYOUTS = ((1, 2), (2, 2))
SPATIAL_REC_TOL = 1e-4
SPATIAL_LOSS_TOL = 1e-5
SPATIAL_WEIGHT_TOL = DIST_BATCH_TOL
# the gradient of the loss with respect to the voxel input, per column, of its
# largest entry. It is ill-conditioned: SSIM on the random-init, nearly
# constant reconstructions amplifies the 1e-7 forward differences of another
# conv algorithm. Readings on an H100 80GB HBM3 at 700 W (T = 10, B = 8): one
# process with cuDNN off against on 3.14e-02 at its worst column (the same
# process against itself 6.7e-07), the ranks 1.6e-02-3.1e-02, the planted
# faults 5.9e-01-6.1e-01; phase 19a prints the cuDNN-off reading beside
SPATIAL_INPUT_TOL = 1e-1
SPATIAL_FAULTS = ("inner cut reflect-padded", "halo gradients dropped")


def planted(fault: str | None):
    """A context that plants ``fault`` in the halo exchange of this process
    (``SPATIAL_FAULTS``); each keeps its collective, so the ranks stay in
    step."""
    from v2e2v_tpu_torch.parallel import spatial

    if fault is None:
        return contextlib.nullcontext()
    if fault == SPATIAL_FAULTS[0]:
        forward = spatial._HaloPad.forward

        def reflect_forward(ctx, x, p, mode, dim, shard):
            forward(ctx, x, p, mode, dim, shard)
            return torch.cat([spatial._edge(x, p, mode, dim, True), x,
                              spatial._edge(x, p, mode, dim, False)], dim)

        return swapped((spatial._HaloPad, "forward", staticmethod(reflect_forward)))
    backward = spatial._HaloPad.backward

    class Dropping(spatial.Shard):
        def all_reduce(self, buf):
            super().all_reduce(buf)
            buf.zero_()

    def dropping_backward(ctx, g):
        ctx.shard = Dropping(ctx.shard.group, ctx.shard.index, ctx.shard.count)
        return backward(ctx, g)

    return swapped((spatial._HaloPad, "backward", staticmethod(dropping_backward)))


def spatial_steps(seed: int, mesh) -> dict:
    """Phase 19a's two E2V steps on ``mesh`` (None: one process), at full
    width: the per-batch step (global B = 8, T = TRAIN_T; on a mesh each rank
    hands it its rows and columns, as ``cli.train_e2v`` does) and the
    device-data step (global B = 8, 5 real samples, ``--add_noise``'s draw;
    every rank gathers its rows and cuts its columns). Each from the seed's
    weights; the first call with the voxel input requiring grad. Returns per
    step the first call's loss, last reconstruction (this rank's block),
    input gradient, reduced weight gradients, updated weights and K1-K4
    launches; the second call's weight gradients (the card's run-to-run
    spread) and ms (host clock to a synchronize). In one process also the
    input gradient of a third call and of a fourth with cuDNN off. On a mesh also a
    third call with every collective of the spatial axis timed between
    synchronizes (halo exchanges and the loss's gathers apart: count, bytes,
    ms) and, on ``(1, 2)``, the per-batch step with each planted fault."""
    from v2e2v_tpu_torch.models.cista import CistaConfig
    from v2e2v_tpu_torch.parallel import spatial
    from v2e2v_tpu_torch.training import steps as steps_mod
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    keys = STEP_KEYS["cista-lstc"]
    counters = kernel_counters()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      ista_impl="plain", core_impl="layers")
    b = CAPACITY
    seq, gt = (x.float().cuda() for x in train_batch(seed + 2, b))
    data, gt_all = train_batch(seed + 1, DD_REAL)
    data, gt_all = data.movedim(1, 0).contiguous().cuda(), gt_all.float().cuda()
    idx = torch.tensor(list(range(DD_REAL)) + [DD_REAL - 1] * (b - DD_REAL), device="cuda")
    w = torch.tensor([1.0] * DD_REAL + [0.0] * (b - DD_REAL), device="cuda")
    rows = mesh.rows if mesh is not None else (lambda x, dim=0: x)
    cols = mesh.cols if mesh is not None else (lambda x, dim: x)
    recs = []
    loss_fn = steps_mod.many_to_one_loss

    def keep_rec(final_rec, *a, **k):
        recs.append(final_rec.detach().cpu())
        return loss_fn(final_rec, *a, **k)

    def per_batch(step, sd, grad):
        x = cols(rows(seq, 1), 3).clone(memory_format=torch.contiguous_format)
        x.requires_grad_(grad)
        loss = step(sd, x, cols(rows(gt, 0), 2).contiguous())
        return loss, x.grad

    def device_data(step, sd, grad):
        x = data.detach().clone().requires_grad_(grad)
        loss = step(sd, x, gt_all, idx, torch.Generator(device="cuda").manual_seed(seed), w)
        return loss, x.grad

    def make(name):
        def build(sd):
            opt = steps_mod.make_adam(sd, cfg, TRAIN_LR)
            if name == "e2v":
                return steps_mod.make_e2v_train_step(cfg, opt, mesh=mesh)
            return steps_mod.make_e2v_train_step_device_data(cfg, opt, noise_std=0.1, mesh=mesh)
        return build

    def call(name, grad=True, fault=None):
        sd = train_weights(cfg, seed, "cuda")
        step = make(name)(sd)
        recs.clear()
        counts_zero(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with planted(fault), swapped((steps_mod, "many_to_one_loss", keep_rec)):
            loss, x_grad = (per_batch if name == "e2v" else device_data)(step, sd, grad)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return {"loss": float(loss), "rec": recs[0], "ms": ms,
                "input_grad": None if x_grad is None else x_grad.cpu(),
                "grads": {k: sd[k].grad.detach().cpu() for k in keys},
                "weights": {k: sd[k].detach().cpu() for k in keys},
                "launches": row_counts()}

    out = {}
    for name in ("e2v", "device_data"):
        first, again = call(name), call(name, grad=False)
        out[name] = {**first, "ms": again["ms"], "grads_again": again["grads"],
                     "launches": add_counts(first["launches"], again["launches"])}
        if mesh is None:  # the input gradient's spread: against itself, and with cuDNN off
            out[name]["input_grad_again"] = call(name)["input_grad"]
            with cudnn_off():
                out[name]["input_grad_native"] = call(name)["input_grad"]
            continue
        # the third call: each collective of the spatial axis between synchronizes
        timing = {"halo": [0, 0, 0.0], "gather": [0, 0, 0.0]}
        reduce_ = spatial.Shard.all_reduce

        def timed_reduce(self, buf):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduce_(self, buf)
            torch.cuda.synchronize()
            kind = timing["halo" if buf.dim() == 6 else "gather"]
            kind[0] += 1
            kind[1] += buf.numel() * buf.element_size()
            kind[2] += 1e3 * (time.perf_counter() - t0)

        with swapped((spatial.Shard, "all_reduce", timed_reduce)):
            out[name]["collectives"] = {"ms_instrumented": call(name, grad=False)["ms"],
                                        **timing}
    if mesh is not None and (mesh.n_data, mesh.n_spatial) == SPATIAL_LAYOUTS[0]:
        out["faults"] = {f: call("e2v", fault=f) for f in SPATIAL_FAULTS}
    return out


def spatial_rank(rank: int, port: int, workdir: Path, seed: int, layout) -> None:
    """One rank of phase 19a: a process group over ``gloo`` of ``n_data x
    n_spatial`` ranks on the one card, ``spatial_steps`` on its mesh, the
    results to ``workdir/spatial_<n_data>x<n_spatial>_<rank>.pt``."""
    from v2e2v_tpu_torch.parallel import distributed
    from v2e2v_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nd, ns = layout
    flags = argparse.Namespace(dist_coordinator=f"localhost:{port}",
                               dist_num_processes=nd * ns, dist_process_id=rank)
    distributed.initialize_from_flags(flags, backend="gloo")
    try:
        out = spatial_steps(seed, make_mesh(nd, ns))
        torch.save(out, workdir / f"spatial_{nd}x{ns}_{rank}.pt")
    finally:
        distributed.shutdown()


def spatial_cli_rank(rank: int, port: int, workdir: Path) -> None:
    """One rank of phase 19b: ``cli.train_e2v.main`` with the argv of
    ``workdir/argv.json`` and the ``--dist_*`` flags of rank ``rank`` of 2,
    its process group made over gloo (two ranks share the card, which NCCL
    refuses), the step's losses to ``workdir/cli_losses_<rank>.json``."""
    from v2e2v_tpu_torch.cli import train_e2v
    from v2e2v_tpu_torch.parallel import distributed

    argv = json.loads((workdir / "argv.json").read_text())
    init = distributed.initialize_from_flags
    with swapped((distributed, "initialize_from_flags",
                  lambda cfgs: init(cfgs, backend="gloo"))):
        losses = cli_losses(train_e2v.main, argv + [
            "--dist_coordinator", f"localhost:{port}", "--dist_num_processes", "2",
            "--dist_process_id", str(rank), "--path_to_model", str(workdir / f"models{rank}")])
    (workdir / f"cli_losses_{rank}.json").write_text(json.dumps(losses))


def cli_losses(main, argv) -> list[float]:
    """``main(argv)`` with every E2V train step's loss recorded."""
    from v2e2v_tpu_torch.training import steps as steps_mod

    losses = []
    build = steps_mod.make_e2v_train_step

    def recording_build(*a, **k):
        step = build(*a, **k)

        def recording_step(*sa):
            loss = step(*sa)
            losses.append(float(loss))
            return loss

        return recording_step

    with swapped((steps_mod, "make_e2v_train_step", recording_build)):
        main(argv)
    return losses


def joined(blocks: list, layout, dim_rows: int, dim_cols: int) -> torch.Tensor:
    """The ranks' blocks (rank order) joined: columns within a data index,
    then rows."""
    nd, ns = layout
    return torch.cat([torch.cat(blocks[d * ns:(d + 1) * ns], dim_cols) for d in range(nd)],
                     dim_rows)


def column_errors(got: torch.Tensor, want: torch.Tensor, col_dim: int) -> torch.Tensor:
    """Per column: max |got - want| over the other dimensions, over max |want|."""
    diff = (got - want).abs().movedim(col_dim, 0).reshape(got.shape[col_dim], -1)
    return diff.amax(1) / float(want.abs().max())


def spatial_verdict(single: dict, ranks: list, layout) -> tuple[bool, dict]:
    """Phase 19a's checks of one layout's ranks against one process, printed;
    whether all hold, and the numbers the faults are read by."""
    nd, ns = layout
    cuts = [i * (W // ns) for i in range(1, ns)]
    all_ok, found = True, {}

    def errors(name, got_ranks):
        want = single[name]
        rec = joined([g["rec"] for g in got_ranks], layout, 0, 2)
        rec_err = float((rec - want["rec"]).abs().max())
        if name == "e2v":  # a rank's loss is the mean over its rows: nd x one process's
            x_grad = joined([g["input_grad"] for g in got_ranks], layout, 1, 3) / nd
            col_dim = 3
        else:  # each rank's gradient reaches its rows and columns of the dataset
            x_grad = sum(g["input_grad"] for g in got_ranks)
            col_dim = 3
        cols = column_errors(x_grad, want["input_grad"], col_dim)
        near = max(float(cols[c + d]) for c in cuts for d in (-2, -1, 0, 1))
        w_err, worst = grad_error(got_ranks[0]["grads"], want["grads"])
        loss_err = abs(got_ranks[0]["loss"] - want["loss"]) / abs(want["loss"])
        return rec_err, loss_err, float(cols.max()), near, w_err, worst

    for name in ("e2v", "device_data"):
        want = single[name]
        got = [r[name] for r in ranks]
        rec_err, loss_err, in_err, near, w_err, worst = errors(name, got)
        spread_in = float(column_errors(want["input_grad_again"], want["input_grad"], 3).max())
        native_in = float(column_errors(want["input_grad_native"], want["input_grad"], 3).max())
        spread_w = grad_error(want["grads_again"], want["grads"])[0]
        same = all(torch.equal(g["weights"][k], got[0]["weights"][k]) for g in got
                   for k in got[0]["weights"])
        same_loss = all(g["loss"] == got[0]["loss"] for g in got)
        launches = [sum(g["launches"].values()) for g in got]
        ok = (rec_err <= SPATIAL_REC_TOL and loss_err <= SPATIAL_LOSS_TOL
              and in_err <= SPATIAL_INPUT_TOL and w_err <= SPATIAL_WEIGHT_TOL and same
              and same_loss and not any(launches) and not any(want["launches"].values()))
        all_ok = all_ok and ok
        say(f"[spatial] (a) {name} step on ({nd}, {ns}): {nd * ns} gloo ranks on one card "
            f"against one process (global B={CAPACITY}, T={TRAIN_T}, {H}x{W}, C={C}, depth "
            f"{DEPTH}, float32, TF32 off{'' if name == 'e2v' else f'; {DD_REAL} real samples, --add_noise'}"
            f"): last reconstruction joined max|diff| {rec_err:.3e} (tol {SPATIAL_REC_TOL}); "
            f"loss relative error {loss_err:.3e} (tol {SPATIAL_LOSS_TOL}); the loss's gradient "
            f"w.r.t. the voxel input, worst column {in_err:.3e} of its largest entry, columns "
            f"beside the cuts {cuts} {near:.3e} (tol {SPATIAL_INPUT_TOL}; one process against "
            f"itself {spread_in:.3e}, with cuDNN off {native_in:.3e}); reduced weight gradients {w_err:.3e} of their largest "
            f"entry ({worst}; tol {SPATIAL_WEIGHT_TOL}; one process against itself "
            f"{spread_w:.3e}); updated weights equal on every rank {same}, loss equal "
            f"{same_loss}; launches of K1-K4 and the scale kernel per rank {launches}, one "
            f"process {sum(want['launches'].values())} (want 0) {'pass' if ok else 'FAIL'}")
    for fault, got in ranks[0].get("faults", {}).items():
        rec_err, _, in_err, near, w_err, worst = errors("e2v", [r["faults"][fault]
                                                                for r in ranks])
        found[fault] = (rec_err, in_err, w_err)
        caught = (rec_err > SPATIAL_REC_TOL or in_err > SPATIAL_INPUT_TOL
                  or w_err > SPATIAL_WEIGHT_TOL)
        all_ok = all_ok and caught
        say(f"[spatial] (a) planted fault on ({nd}, {ns}), {fault}: last reconstruction "
            f"{rec_err:.3e}, input gradient {in_err:.3e} (beside the cuts {near:.3e}), weight "
            f"gradients {w_err:.3e} ({worst}) -> {'caught' if caught else 'NOT CAUGHT'}")
    return all_ok, found


def spatial_phase(seed: int, smi: str, root: Path) -> dict:
    """Phase 19: the spatial axis (ROADMAP item 9). (a) the E2V steps on
    ``(1, 2)`` and ``(2, 2)`` as gloo ranks on the one card against one
    process, with two planted faults; (b) ``cli.train_e2v --mesh_spatial 2``
    over two ranks against one process; (c) times. Returns the launches of
    (a)'s steps, every rank's summed, by row of the kernels line."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    single = spatial_steps(seed, None)
    single_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    all_ok, times, launches = True, {}, {}
    for layout in SPATIAL_LAYOUTS:
        nd, ns = layout
        workdir = root / f"spatial_{nd}x{ns}"
        workdir.mkdir()
        t0 = time.perf_counter()
        start_self(workdir, nd * ns, "--seed", str(seed), "--spatial", str(nd), str(ns))
        times[layout] = time.perf_counter() - t0
        ranks = [torch.load(workdir / f"spatial_{nd}x{ns}_{r}.pt", weights_only=False)
                 for r in range(nd * ns)]
        ok, _ = spatial_verdict(single, ranks, layout)
        all_ok = all_ok and ok
        for r in ranks:
            for name in ("e2v", "device_data"):
                launches = add_counts(launches, r[name]["launches"])
        for name in ("e2v", "device_data"):
            col = ranks[0][name]["collectives"]
            say(f"[time] (c) {name} step on ({nd}, {ns}), {nd * ns} gloo ranks time-sharing "
                f"ONE card ({smi}; no scaling figure): ms per step, second call, host clock "
                f"{[round(r[name]['ms'], 3) for r in ranks]} (one process at B={CAPACITY}: "
                f"{single[name]['ms']:.3f}); rank 0's collectives of the spatial axis, a third "
                f"call with a synchronize around each (its step {col['ms_instrumented']:.3f} "
                f"ms): halo exchanges {col['halo'][0]} ({col['halo'][1] / 2**20:.3f} MiB of "
                f"buffers, {col['halo'][2]:.3f} ms), the loss's gathers {col['gather'][0]} "
                f"({col['gather'][1] / 2**20:.3f} MiB, {col['gather'][2]:.3f} ms)")
        say(f"[time] (c) ({nd}, {ns}): the ranks' run {times[layout]:.1f} s with start-up")
    if not all_ok:
        fail("the spatial axis disagrees with one process, or a planted fault was not caught")

    # (b) cli.train_e2v --mesh_spatial 2 over two gloo ranks against one process
    from v2e2v_tpu_torch.cli import train_e2v

    name = f"_cista-lstc_b{NB}_d{DEPTH}_c{C}"
    workdir = root / "spatial_cli"
    workdir.mkdir()
    data = root / "train_e2v_data"
    (workdir / "argv.json").write_text(json.dumps(train_argv(
        data, workdir, "--epochs", "1", "--mesh_spatial", "2")))
    with contextlib.redirect_stdout(io.StringIO()):
        one = cli_losses(train_e2v.main, train_argv(data, workdir / "one", "--epochs", "1"))
    outs = start_self(workdir, 2, "--spatial_cli")
    got = [json.loads((workdir / f"cli_losses_{r}.json").read_text()) for r in range(2)]
    ckpts = {k: torch.load(workdir / k / name / f"{name}_1.pth.tar", map_location="cpu",
                           weights_only=False)["state_dict"] for k in ("one", "models0")}
    rank1 = sorted((workdir / "models1").rglob("*.pth.tar"))
    dist = max(float((ckpts["models0"][k] - v).abs().max()) for k, v in ckpts["one"].items())
    first_err = abs(got[0][0] - one[0]) / abs(one[0])
    joined_ok = "distributed: process 0/2, 1 local / 2 global devices (gloo)" in outs[0]
    ok = (joined_ok and first_err <= SPATIAL_LOSS_TOL and got[0] == got[1]
          and len(got[0]) == len(one) and not rank1)
    say(f"[spatial] (b) cli.train_e2v --mesh_spatial 2, two gloo ranks on one card "
        f"(the CLI's own main, its group over gloo), 1 epoch over phase 13c's dataset "
        f"({len(one)} steps at batch 1) against one process: group made {joined_ok}; first "
        f"step's loss {got[0][0]:.9f} vs {one[0]:.9f}, relative error {first_err:.3e} (tol "
        f"{SPATIAL_LOSS_TOL}); the ranks' losses equal {got[0] == got[1]}; rank 1 wrote "
        f"{len(rank1)} checkpoints (want 0) {'pass' if ok else 'FAIL'}; shown, not checked: "
        f"the checkpoint's max|diff| to one process's {dist:.3e}")
    if not ok:
        fail("cli.train_e2v --mesh_spatial 2 disagrees with one process")
    say(f"[phase] the spatial axis {time.perf_counter() - t_phase:.1f} s (one process's "
        f"steps {single_s:.1f} s)")
    return {"spatial_train_launches": launches}


JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
JPEG_SEQUENCE = "sequence_0000000001"
JPEG_PACK = 4  # the V2E2V CLI's --num_pack_frames over the 12 fixture frames: 3 packs
JPEG_EVENTS_SEED = 20  # phase 20c's events: --seed + this


def output_files(folder: Path) -> dict[str, bytes]:
    """Every file under ``folder`` by its path relative to it."""
    return {p.relative_to(folder).as_posix(): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def cli_against_twin(seed: int, model: Path, root: Path, runs) -> dict:
    """The V2E2V CLI at full width (``model``) twice, ``runs`` naming each
    run's (tag, data, flags): the first is the main path, every count set to
    0 just before it, its reader's calls and its model steps timed; the
    second, its PNG twin, holds K3 and K1 against their plain versions at
    every call. Both write under ``root / f"v2e2v_{tag}"``. Returns the first
    run's launches by row and counts, the packs' frame pairs and events, the
    comparison, the per-call errors, and the times."""
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch.models import emulator as emulator_mod
    from v2e2v_tpu_torch.ops.cuda import emulator_iters as k3_mod
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters, emulator_iters_plain
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain

    k3_errs, k1_errs = [], []

    def k1_checked(*a, **k):
        got = ista_loop(*a, **k)
        k1_errs.append(within(got, ista_loop_plain(*a, **k), TOL[torch.float32]))
        return got

    def k3_checked(*a, **k):
        got = emulator_iters(*a, **k)
        want = emulator_iters_plain(*a, **k)
        exact = torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        err = float((got[0] - want[0]).abs().max())
        k3_errs.append((err, exact and err <= 1e-5))
        return got

    # models/emulator.py calls k3.emulator_iters: a copy of the module's
    # names with the checked call in its place (the counters stay the module's)
    k3_view = type(k3_mod)(k3_mod.__name__)
    k3_view.__dict__.update(vars(k3_mod))
    k3_view.emulator_iters = k3_checked
    out, step_ev = {}, []
    parts = {"initialize": [0.0, 0], "update_frame_pack": [0.0, 0]}
    for i, (tag, data, extra) in enumerate(runs):
        run = v2e2v_cli(data, model, root / f"v2e2v_{tag}", seed, extra=extra)
        records, printed = [], io.StringIO()
        checks = ((cista_mod, "ista_loop", k1_checked), (emulator_mod, "k3", k3_view))
        if i == 0:
            for name in parts:
                setattr(run.video_renderer, name,
                        timed(getattr(run.video_renderer, name), parts, name))
            counts_zero(*kernel_counters())
        with (recorded_forward(records, step_ev if i == 0 else None),
              contextlib.redirect_stdout(printed), swapped(*(checks if i else ()))):
            run.run()
        torch.cuda.synchronize()
        if i == 0:
            rows = row_counts()
            k3_n, k1_n, k2_n = emulator_iters.launches, ista_loop.launches, cista_core.launches
        out[i] = {"records": records, "printed": [
            line for line in printed.getvalue().splitlines() if line.startswith("Avg")],
            "files": output_files(root / f"v2e2v_{tag}")}
    main, twin = out[0], out[1]
    pairs = [p for _, _, p in main["records"]]
    events = [int(o.num_events) for o, _, _ in main["records"]]
    same = (main["files"] == twin["files"] and main["printed"] == twin["printed"]
            and events == [int(o.num_events) for o, _, _ in twin["records"]])
    launches_ok = (k3_n == rows["emulator_iters (internal rng)"] == sum(pairs)
                   and k1_n == 2 * DEPTH * len(pairs) and k2_n == 0
                   and [n for _, n, _ in main["records"]] == [[p, 2 * DEPTH] for p in pairs])
    k3_ok = len(k3_errs) == sum(pairs) and all(o for _, o in k3_errs)
    k1_ok = len(k1_errs) == len(pairs) and all(o for _, o in k1_errs)
    return {"rows": rows, "k3": k3_n, "k1": k1_n, "k2": k2_n, "pairs": pairs, "events": events,
            "same": same, "files": len(main["files"]), "printed": main["printed"],
            "k3_errs": k3_errs, "k1_errs": k1_errs,
            "ok": same and launches_ok and k3_ok and k1_ok and min(events) > 0,
            "step_ms": [a.elapsed_time(b) for a, b in step_ev],
            "reader_s": {k: v[0] for k, v in parts.items()}}


def fixtures_against_manifest(folder: Path, min_files: int):
    """Every fixture under ``folder`` decoded by the port against its
    ``manifest.json``: the shape and the sha256 of ``cv2.imread(path, 0)``.
    Returns the manifest, the files that disagree or raise, and whether none
    does and there are at least ``min_files``."""
    import hashlib

    from v2e2v_tpu_torch.utils.image_io import read_gray

    manifest = json.loads((folder / "manifest.json").read_text())["files"]
    bad = []
    for rel, want in sorted(manifest.items()):
        try:
            img = read_gray(str(folder / rel))
        except ValueError as e:
            bad.append(f"{rel}: {e}")
            continue
        if (list(img.shape) != want["shape"]
                or hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]):
            bad.append(rel)
    return manifest, bad, not bad and len(manifest) >= min_files


def e2v_against_twin(seed: int, model: Path, root: Path, runs, stamps_txt: str,
                     events_seed: int) -> dict:
    """The E2V CLI at full width (``model``) twice, ``runs`` naming each
    run's (tag, frames): each reads a dataset under ``root / f"e2v_{tag}"``
    of its frames as ground truth, the stamps of ``stamps_txt``, and the same
    events between them, made from ``seed + events_seed`` as phase 9 makes
    them. The first run is the main path, every count set to 0 just before
    it. Returns the first run's launches by row, its K1 and its K2 + K3
    launches, each run's reconstructions, output files, result.csv, model
    step (CUDA events) and reader per frame (host clock), and whether the two
    runs agree with each other and the first with its launch counts."""
    from v2e2v_tpu_torch.data.synthetic import write_random_events
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop

    stamps = [float(line.split()[1]) for line in stamps_txt.splitlines() if line.strip()]
    for tag, frames in runs:
        seq = root / f"e2v_{tag}" / "data" / JPEG_SEQUENCE
        (seq / "frames").mkdir(parents=True)
        (seq / "events").mkdir()
        (seq / "frames" / "timestamps.txt").write_text(stamps_txt)
        for f in frames:
            shutil.copyfile(f, seq / "frames" / f.name)
        write_random_events(seq / "events", np.random.default_rng(seed + events_seed),
                            stamps, H, W, CLI_EVENTS)
    out = []
    for i, (tag, _) in enumerate(runs):
        rec = cli_reconstructor(root / f"e2v_{tag}" / "data", model, torch.float32, "out",
                                "cuda")
        step_ev = []
        steps = record_steps(rec, keep_state=False, events=step_ev)
        parts = {"read": [0.0, 0]}
        rec.video_renderer.update_event_frame_pack = timed(
            rec.video_renderer.update_event_frame_pack, parts, "read")
        if i == 0:
            counts_zero(*kernel_counters())
        rec.run()
        torch.cuda.synchronize()
        if i == 0:
            rows = row_counts()
            k1, others = ista_loop.launches, cista_core.launches + emulator_iters.launches
        folder = root / f"e2v_{tag}" / "out"
        out.append({"n": len(steps), "files": output_files(folder),
                    "csv": [p.read_text() for p in sorted(folder.rglob("result.csv"))],
                    "step_ms": sum(a.elapsed_time(b) for a, b in step_ev) / len(steps),
                    "read_ms": 1e3 * parts["read"][0] / parts["read"][1]})
    main, twin = out
    ok = (main["csv"] == twin["csv"] and len(main["csv"]) == 1 and main["files"] == twin["files"]
          and main["n"] == twin["n"] > 0 and k1 == 2 * DEPTH * main["n"] and others == 0)
    return {"main": main, "twin": twin, "rows": rows, "k1": k1, "others": others, "ok": ok}


def jpeg_phase(seed: int, smi: str, root: Path, e2v_model: Path, v2e2v_model: Path) -> dict:
    """Phase 20: JPEG frames (ROADMAP item 4). (a) every fixture under
    ``tests/data/jpeg`` decoded by the port against ``manifest.json``'s sha256
    of ``cv2.imread(path, 0)``, and the decode time per full-width frame of
    JPEG and of PNG; (b) the V2E2V CLI over the fixture sequence and its PNG
    twin; (c) the E2V CLI with the JPEG frames as ground truth against the
    twin. Returns (b) and (c)'s launches by row of the kernels line."""
    from v2e2v_tpu_torch.utils.image_io import read_gray, write_gray

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    # (a) the fixtures against cv2's hashes, and the decode times
    manifest, bad, ok = fixtures_against_manifest(JPEG_FIXTURES, 27)
    say(f"[jpeg] {len(manifest)} fixtures (tests/data/jpeg: sampling factors, gray, restart "
        f"intervals, optimised tables, quality 100 and 5, progressive, 181x243, Exif "
        f"orientations, the 12-frame {H}x{W} sequence) decoded by the port against the sha256 "
        f"of cv2.imread(path, 0): mismatches {bad} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the port's JPEG decoder disagrees with cv2's hashes")
    src = JPEG_FIXTURES / "sequence" / JPEG_SEQUENCE / "frames"
    jpgs = sorted(src.glob("frame_*.jpg"))
    timestamps_txt = (src / "timestamps.txt").read_text()
    twin = root / "png" / JPEG_SEQUENCE / "frames"
    twin.mkdir(parents=True)
    (twin / "timestamps.txt").write_text(timestamps_txt)
    for jpg in jpgs:
        write_gray(str(twin / f"{jpg.stem}.png"), read_gray(str(jpg)))
    pngs = sorted(twin.glob("frame_*.png"))
    decode = {}
    for kind, files in (("jpeg", jpgs), ("png", pngs)):
        times = []
        for _ in range(3):
            for f in files:
                t0 = time.perf_counter()
                read_gray(str(f))
                times.append(1e3 * (time.perf_counter() - t0))
        decode[kind] = (float(np.median(times)), min(times), max(times))
    jpeg_bytes = sum(f.stat().st_size for f in jpgs) / len(jpgs)
    say(f"[time] frame decode on the card's host ({smi}), read_gray per {H}x{W} frame, median "
        f"(min-max) of {3 * len(jpgs)}, host clock: JPEG (colour, 4:2:0, quality 95, "
        f"{jpeg_bytes:.0f} bytes) {decode['jpeg'][0]:.3f} ms ({decode['jpeg'][1]:.3f}-"
        f"{decode['jpeg'][2]:.3f}); PNG twin (the port's writer) {decode['png'][0]:.3f} ms "
        f"({decode['png'][1]:.3f}-{decode['png'][2]:.3f})")

    # (b) the V2E2V CLI over the JPEG sequence (the main path, counts at 0)
    # and over its PNG twin with K3 and K1 held against their plain versions
    extra = ("--num_pack_frames", str(JPEG_PACK))
    b = cli_against_twin(seed, v2e2v_model, root, (
        ("jpeg", JPEG_FIXTURES / "sequence", extra), ("png", root / "png", extra)))
    pairs, k3_errs, k1_errs = b["pairs"], b["k3_errs"], b["k1_errs"]
    ok = b["ok"] and len(pairs) == 3
    say(f"[jpeg] V2E2V CLI over the JPEG sequence ({len(jpgs)} frames, --num_pack_frames "
        f"{JPEG_PACK}) and its PNG twin: {len(pairs)} packs, num_events {b['events']}; "
        f"{b['files']} output files byte for byte equal, printed averages "
        f"{b['printed']} equal: {b['same']}; main path (counts at 0 before the JPEG run): K3 "
        f"{b['k3']} (want one per frame pair, {sum(pairs)}), K1 {b['k1']} (want "
        f"{2 * DEPTH * len(pairs)}), K2 {b['k2']}; in the twin run K3 against its plain version at "
        f"each of {len(k3_errs)} calls: final and mem equal, voxel max_abs_err "
        f"{max(e for e, _ in k3_errs):.3e} (tol 1e-5), K1 at each of {len(k1_errs)} calls: "
        f"max_abs_err {max(e for e, _ in k1_errs):.3e} (tol {TOL[torch.float32]} + "
        f"{TOL[torch.float32]} |ref|) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI over JPEG frames did not run as over their PNG twin")
    v2e2v_rows = b["rows"]

    # (c) the E2V CLI with the JPEG frames as ground truth, events between
    # them as phase 9 writes them, against the same dataset with the twin
    c = e2v_against_twin(seed, e2v_model, root, (("jpeg", jpgs), ("png", pngs)),
                         timestamps_txt, JPEG_EVENTS_SEED)
    ej, ep, k1_e, others, ok = c["main"], c["twin"], c["k1"], c["others"], c["ok"]
    say(f"[jpeg] E2V CLI with the JPEG frames as ground truth and {CLI_EVENTS[0]}-"
        f"{CLI_EVENTS[1]} events an interval, against the PNG twin: {ej['n']} reconstructions, "
        f"result.csv rows equal: {ej['csv'] == ep['csv']} ({ej['csv'][0].splitlines()[-1]!r}), "
        f"{len(ej['files'])} output files byte for byte equal: {ej['files'] == ep['files']}; K1 "
        f"{k1_e} (want 2 x depth x {ej['n']}), K2 and K3 {others} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V CLI with JPEG frames disagrees with its PNG twin")
    say(f"[time] E2V CLI at B = 1 ({smi}): the reader per frame (decode, events, voxelise) "
        f"JPEG {ej['read_ms']:.3f} ms, PNG {ep['read_ms']:.3f} ms (host clock); the model step "
        f"per reconstruction {ej['step_ms']:.3f} / {ep['step_ms']:.3f} ms (CUDA events); a JPEG "
        f"frame's decode {decode['jpeg'][0]:.3f} ms is "
        f"{decode['jpeg'][0] / ej['step_ms']:.2f}x the model step")
    say(f"[phase] JPEG frames {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_jpeg_launches": v2e2v_rows, "e2v_cli_jpeg_launches": c["rows"]}


VIDEO_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "video"
VIDEO_PACK = 4  # the V2E2V CLI's --num_pack_frames over the flagship clip's 12 frames: 3 packs


def video_stages(path: Path, reps: int = 2) -> dict[str, list[float]]:
    """Host ms per frame of each stage of a video's read, over every frame
    of ``path`` ``reps`` times: demux (the file's headers and chunks, per
    frame), entropy decode, dequantize + IDCT, YUV -> gray, the reader's
    resize to a quarter."""
    from v2e2v_tpu_torch.utils import jpeg, yuv
    from v2e2v_tpu_torch.utils.avi import AviFile
    from v2e2v_tpu_torch.utils.image_io import resize_linear_u8

    ms = {k: [] for k in ("demux", "entropy", "idct", "convert", "resize")}
    for _ in range(reps):
        t0 = time.perf_counter()
        datas = list(AviFile(str(path)).frames())
        ms["demux"].append(1e3 * (time.perf_counter() - t0) / len(datas))
        tables = None
        for data in datas:
            t = [time.perf_counter()]
            dec = jpeg.read_mjpeg_frame(data, str(path), tables)
            t.append(time.perf_counter())
            frame = jpeg.mjpeg_planes(dec)
            t.append(time.perf_counter())
            gray = yuv.mjpeg_to_gray(frame.planes, frame.factors)
            t.append(time.perf_counter())
            resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
            t.append(time.perf_counter())
            tables = frame.tables
            for k, a, b in zip(("entropy", "idct", "convert", "resize"), t, t[1:]):
                ms[k].append(1e3 * (b - a))
    return ms


def clips_against_records(folder: Path, names, tag: str):
    """The clips ``names`` under ``folder`` read by the port's
    ``VideoReader`` (180x240, the reader's quarter) and ``VideoSequence``
    against the JAX readers' records in the folder's ``manifest.json`` and
    ``reader_frames.npz`` (frames, stamps, hashes), a line each. A clip the
    manifest marks not ported must raise naming item 4. Returns the clips
    that disagree and each read clip's reader."""
    import hashlib

    from v2e2v_tpu_torch.data.manifests import VideoSequence
    from v2e2v_tpu_torch.data.video_readers import VideoReader

    manifest = json.loads((folder / "manifest.json").read_text())["clips"]
    recorded = np.load(folder / "reader_frames.npz")

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    bad, readers = [], {}
    for name in names:
        want = manifest[name]
        path = str(folder / name)
        reader = VideoReader((H, W))
        if not want.get("ported", True):
            try:
                reader.initialize(path)
                bad.append(name)
                verdict = "read: FAIL"
            except ValueError as e:
                verdict = f"refused ({'pass' if 'item 4' in str(e) else 'FAIL'}): {e}"
                if "item 4" not in str(e):
                    bad.append(name)
            say(f"[{tag}] {name}: {verdict}")
            continue
        t0 = time.perf_counter()
        reader.initialize(path)
        read_s = time.perf_counter() - t0
        got, ref = np.stack(reader.frames), recorded[want.get("frames", name[:-4])]
        pairs = list(VideoSequence(path))
        full = [pairs[0][0]] + [p[1] for p in pairs]
        shape_ok = got.shape == ref.shape
        exact = float((got == ref).mean()) if shape_ok else 0.0
        worst = int(np.abs(got.astype(int) - ref).max()) if shape_ok else -1
        ok = (shape_ok and exact == 1.0 and reader.timestamps == want["timestamps"]
              and [sha(f) for f in reader.frames] == want["reader_sha256"]
              and [sha(f) for f in full] == want["sequence_sha256"])
        if not ok:
            bad.append(name)
        readers[name] = reader
        say(f"[{tag}] {name}: fps {want['fps']}, count {want['frame_count']:.0f}, "
            f"{reader.num_frames} frames read at {list(full[0].shape)} -> {list(got.shape[1:])} "
            f"in {read_s:.3f} s; VideoReader against the JAX reader's frames: exact share "
            f"{exact}, max |diff| {worst}; stamps, reader and VideoSequence hashes equal: "
            f"{ok} {'pass' if ok else 'FAIL'}")
    return bad, readers


def video_cli_against_twin(seed: int, smi: str, root: Path, v2e2v_model: Path, source: Path,
                           reader, fps: float, tag: str, extra: tuple = ()) -> dict:
    """The V2E2V CLI with ``--reader_type video`` over the clip ``source``
    (``--num_pack_frames 4``, and the flags ``extra``), the main path with
    every count set to 0 just before it, against the same CLI over a PNG
    folder of the port's frames (``reader``'s) with ``timestamps.txt`` at
    ``i / fps``, K3 and K1 held against their plain versions at every call of
    that run (``cli_against_twin``); fails unless the output files and
    printed averages are equal. Returns the video run's launches by row."""
    from v2e2v_tpu_torch.utils.image_io import write_gray

    clip = root / "video"
    clip.mkdir()
    shutil.copyfile(source, clip / source.name)
    twin = root / "png" / source.stem / "frames"
    twin.mkdir(parents=True)
    (twin / "timestamps.txt").write_text(
        "".join(f"{i} {t!r}\n" for i, t in enumerate(reader.timestamps)))
    if reader.timestamps != [i / fps for i in range(reader.num_frames)]:
        fail(f"the {source.name} clip's stamps are not i / fps")
    for i, frame in enumerate(reader.frames):
        write_gray(str(twin / f"frame_{i:010d}.png"), frame)
    pack = ("--num_pack_frames", str(VIDEO_PACK))
    b = cli_against_twin(seed, v2e2v_model, root, (
        ("video", clip, ("--reader_type", "video", *pack, *extra)),
        ("png", root / "png", (*pack, *extra))))
    pairs, k3_errs, k1_errs = b["pairs"], b["k3_errs"], b["k1_errs"]
    ok = b["ok"] and len(pairs) == 3
    h, w = reader.frames[0].shape
    say(f"[{tag}] V2E2V CLI --reader_type video over {source.name} (read as {h}x{w}, "
        f"{reader.num_frames} frames, --num_pack_frames {VIDEO_PACK}) and its PNG twin (the "
        f"port's frames, timestamps.txt at i/fps): {len(pairs)} packs, num_events "
        f"{b['events']}; {b['files']} output files byte for byte equal, printed averages "
        f"{b['printed']} equal: {b['same']}; main path (counts at 0 before the video run): K3 "
        f"{b['k3']} (want one per frame pair, {sum(pairs)}), K1 {b['k1']} (want "
        f"{2 * DEPTH * len(pairs)}), K2 {b['k2']}; in the twin run K3 against its plain version "
        f"at each of {len(k3_errs)} calls: final and mem equal, voxel max_abs_err "
        f"{max(e for e, _ in k3_errs):.3e} (tol 1e-5), K1 at each of {len(k1_errs)} calls: "
        f"max_abs_err {max(e for e, _ in k1_errs):.3e} (tol {TOL[torch.float32]} + "
        f"{TOL[torch.float32]} |ref|) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail(f"the V2E2V CLI over {source.name} did not run as over its PNG twin")
    read_ms = 1e3 * b["reader_s"]["initialize"]
    step_ms = sum(b["step_ms"])
    say(f"[time] V2E2V CLI over {source.name} ({smi}): the reader {read_ms:.3f} ms for the "
        f"clip (host clock; {read_ms / reader.num_frames:.3f} ms a frame, decode and resize), "
        f"the model step {step_ms:.3f} ms for its {len(pairs)} packs (CUDA events, "
        f"{step_ms / len(pairs):.3f} ms a pack): the reader is "
        f"{read_ms / (read_ms + step_ms):.1%} of the two, {read_ms / step_ms:.2f}x the steps")
    return b["rows"]


def video_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 21: video files (ROADMAP item 4, MJPEG AVI). (a) every fixture
    clip under ``tests/data/video`` (every sampling, gray, progressive, odd
    sizes), and the MJPEG clips under ``tests/data/mpeg4`` (interlaced
    frames of both polarities, frames so small that swscale cuts its chroma
    filter), read by the port's ``VideoReader`` and ``VideoSequence``
    against the JAX readers' records (frames, stamps, hashes), and the host
    ms of each stage per 960x720 frame of the flagship clip and of each
    sampling's ``hd_*`` clip; (b) the V2E2V CLI with ``--reader_type video``
    over the flagship clip (960x720 read as 180x240), the main path with
    every count set to 0 just before it, against the same CLI over a PNG
    folder of the port's decoded frames, K3 and K1 held against their plain
    versions at every call of that run. Returns (b)'s launches by row."""
    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    manifest = json.loads((VIDEO_FIXTURES / "manifest.json").read_text())["clips"]

    # (a) the fixtures against the JAX readers' records
    bad, readers = clips_against_records(VIDEO_FIXTURES, sorted(manifest), "video")
    mjpeg = json.loads((MPEG4_FIXTURES / "manifest.json").read_text())["clips"]
    more, _ = clips_against_records(
        MPEG4_FIXTURES, sorted(n for n, e in mjpeg.items() if e["codec"] == "mjpeg"), "video")
    flagship = readers.get("flagship.avi")
    if bad or more or flagship is None:
        fail(f"the port's video readers disagree with the JAX readers' records: {bad + more}")
    stages = video_stages(VIDEO_FIXTURES / "flagship.avi")
    per = {k: (float(np.median(v)), min(v), max(v)) for k, v in stages.items()}
    total = sum(m for m, _, _ in per.values())
    say(f"[time] video read on the card's host ({smi}), host ms per 960x720 MJPEG frame of "
        f"the flagship clip, median (min-max) of {len(stages['entropy'])}: "
        + ", ".join(f"{k} {m:.3f} ({lo:.3f}-{hi:.3f})" for k, (m, lo, hi) in per.items())
        + f"; sum of medians {total:.3f} ms")
    for clip in sorted(VIDEO_FIXTURES.glob("hd_*.avi")):
        stages = video_stages(clip, reps=3)
        per = {k: float(np.median(v)) for k, v in stages.items()}
        say(f"[time] {clip.stem[3:]} ({smi}): host ms per 960x720 MJPEG frame, median of "
            f"{len(stages['entropy'])}: " + ", ".join(f"{k} {m:.3f}" for k, m in per.items())
            + f"; sum {sum(per.values()):.3f} ms")

    # (b) the V2E2V CLI over the flagship clip and over its PNG twin
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, VIDEO_FIXTURES / "flagship.avi",
                                  flagship, manifest["flagship.avi"]["fps"], "video")
    say(f"[phase] video files {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_video_launches": rows}


MPEG4_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "mpeg4"


def mpeg4_stages(path: Path, reps: int = 2) -> dict[str, dict[str, list[float]]]:
    """Host ms per frame of each stage of an MPEG-4 clip's read, I-VOPs and
    P-VOPs apart, over every frame of ``path`` ``reps`` times: demux (the
    container's headers and packets, per frame), VLC decode (headers and
    macroblock syntax), dequantisation + IDCT + motion compensation,
    YUV -> gray, the reader's resize to a quarter."""
    from v2e2v_tpu_torch.utils import yuv
    from v2e2v_tpu_torch.utils.image_io import resize_linear_u8
    from v2e2v_tpu_torch.utils.mpeg4 import I_VOP, Mpeg4Decoder
    from v2e2v_tpu_torch.utils.video import VideoFile

    keys = ("demux", "vlc", "dequant_idct_mc", "convert", "resize")
    ms = {kind: {k: [] for k in keys} for kind in ("I", "P")}
    for _ in range(reps):
        t0 = time.perf_counter()
        video = VideoFile(str(path))
        datas = list(video.packets())
        demux = 1e3 * (time.perf_counter() - t0) / len(datas)
        dec = Mpeg4Decoder(video.mp4.config if video.mp4 is not None else b"", str(path))
        for data in datas:
            t = [time.perf_counter()]
            vop = dec.parse(data)
            t.append(time.perf_counter())
            y, cb, cr = dec.reconstruct(vop)
            t.append(time.perf_counter())
            gray = yuv.bgr_to_gray(yuv.yuv420p_to_bgr(y, cb, cr))
            t.append(time.perf_counter())
            resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
            t.append(time.perf_counter())
            kind = ms["I" if vop.hdr["kind"] == I_VOP else "P"]
            kind["demux"].append(demux)
            for k, a, b in zip(keys[1:], t, t[1:]):
                kind[k].append(1e3 * (b - a))
    return ms


def mpeg4_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 24: MPEG-4 Part 2 video (ROADMAP item 4.2). (a) every MPEG-4
    clip under ``tests/data/mpeg4`` (``scripts/make_mpeg4_fixtures.py``:
    the 12-frame 960x720 flagship in MP4, MOV, M4V and XVID and FMP4 AVI, a
    second GOP, portrait, 30000/1001 fps, 75x49, noise and flat content)
    read by the port's ``VideoReader`` and ``VideoSequence`` against the
    JAX readers' records, and the host ms per 960x720 frame of each stage
    of the flagship MP4, I-VOPs and P-VOPs apart; (b) the V2E2V CLI with
    ``--reader_type video`` over the flagship MP4 (read as 180x240) against
    its PNG twin, as phase 21 (b). Returns (b)'s launches by row."""
    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    manifest = json.loads((MPEG4_FIXTURES / "manifest.json").read_text())["clips"]
    names = sorted(n for n, e in manifest.items() if e["codec"] == "mpeg4")
    bad, readers = clips_against_records(MPEG4_FIXTURES, names, "mpeg4")
    flagship = readers.get("flagship.mp4")
    if bad or flagship is None or len(names) < 11:
        fail(f"the port's MPEG-4 reads disagree with the JAX readers' records: {bad}")
    stages = mpeg4_stages(MPEG4_FIXTURES / "flagship.mp4")
    for kind, st in stages.items():
        per = {k: (float(np.median(v)), min(v), max(v)) for k, v in st.items()}
        total = sum(m for m, _, _ in per.values())
        say(f"[time] MPEG-4 read on the card's host ({smi}), host ms per 960x720 {kind}-VOP of "
            f"the flagship MP4, median (min-max) of {len(st['vlc'])}: "
            + ", ".join(f"{k} {m:.3f} ({lo:.3f}-{hi:.3f})" for k, (m, lo, hi) in per.items())
            + f"; sum of medians {total:.3f} ms")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, MPEG4_FIXTURES / "flagship.mp4",
                                  flagship, manifest["flagship.mp4"]["fps"], "mpeg4")
    say(f"[phase] MPEG-4 video {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_mpeg4_launches": rows}


MKV_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "mkv"
VP9_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "vp9"
WEBM_STAGES = ("demux", "tokens", "predict_idct", "loop_filter", "convert", "resize")


def webm_stages(path: Path, decoder) -> tuple[dict[str, dict[str, list[float]]], list]:
    """Host ms per frame of each stage of a VP8 or VP9 clip's read (by
    ``decoder``, ``Vp8Decoder`` or ``Vp9Decoder``), key and inter frames
    apart, over one pass of ``path``: demux (the container's headers and
    blocks, per frame), boolean and token decode (the headers, modes, vectors
    and coefficients), prediction + inverse transforms, the loop filter,
    YUV -> gray, the reader's resize to a quarter. Returns them and the BGR
    frames."""
    from v2e2v_tpu_torch.utils import yuv
    from v2e2v_tpu_torch.utils.image_io import resize_linear_u8
    from v2e2v_tpu_torch.utils.video import VideoFile

    ms = {kind: {k: [] for k in WEBM_STAGES} for kind in ("key", "inter")}
    t0 = time.perf_counter()
    video = VideoFile(str(path))
    datas = list(video.packets())
    demux = 1e3 * (time.perf_counter() - t0) / len(datas)
    dec, frames = decoder(str(path)), []
    for data in datas:
        stats = {}
        planes = list(dec.decode(data, stats))
        name = "key" if stats.get("frames_key") else "inter"
        kind = ms[name]
        kind["demux"].append(demux)
        for k, key in (("tokens", "tokens"), ("predict_idct", "predict"),
                       ("loop_filter", "filter")):
            kind[k].append(1e3 * stats[f"{key}_{name}"])
        t = [time.perf_counter()]
        bgr = yuv.yuv420p_to_bgr(*planes[0], str(path), yuv.VP8_H_POS, dec.full_range)
        gray = yuv.bgr_to_gray(bgr)
        t.append(time.perf_counter())
        resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
        t.append(time.perf_counter())
        kind["convert"].append(1e3 * (t[1] - t[0]))
        kind["resize"].append(1e3 * (t[2] - t[1]))
        frames.append(bgr)
    return ms, frames


def webm_phase(seed: int, smi: str, root: Path, v2e2v_model: Path, fixtures: Path, decoder,
               label: str, tag: str, min_clips: int) -> dict:
    """Phase 25 (Matroska and WebM, VP8's flagship: ``tests/data/mkv``,
    ``scripts/make_mkv_fixtures.py``) and phase 26 (VP9 in WebM and
    Matroska: ``tests/data/vp9``, ``scripts/make_vp9_fixtures.py``), ROADMAP
    item 4.2. (a) every clip under ``fixtures`` (at least ``min_clips``)
    read by the port's ``VideoReader`` and ``VideoSequence`` against the JAX
    readers' records, a refused one refused; the flagship decoded once by
    ``decoder``, with the host ms of each stage per 960x720 key and inter
    frame, and those frames handed to its four reads (WebM and Matroska,
    each reader), whose containers, sizes, stamps and resizes are read anew;
    (b) the V2E2V CLI with ``--reader_type video`` over the flagship WebM
    (read as 180x240, decoded anew) against its PNG twin, as phase 21 (b).
    Returns (b)'s launches by row, under ``v2e2v_cli_{tag}_launches``."""
    import hashlib

    from v2e2v_tpu_torch.utils.video import VideoFile

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    manifest = json.loads((fixtures / "manifest.json").read_text())["clips"]
    flagship = fixtures / "flagship.webm"
    stages, frames = webm_stages(flagship, decoder)
    for kind, st in stages.items():
        per = {k: (float(np.median(v)), min(v), max(v)) for k, v in st.items()}
        total = sum(m for m, _, _ in per.values())
        say(f"[time] {label} read on the card's host ({smi}), host ms per 960x720 {kind} frame "
            f"of the flagship WebM, median (min-max) of {len(st['tokens'])}: "
            + ", ".join(f"{k} {m:.3f} ({lo:.3f}-{hi:.3f})" for k, (m, lo, hi) in per.items())
            + f"; sum of medians {total:.3f} ms")
    digest = hashlib.sha256(b"".join(VideoFile(str(flagship)).packets())).hexdigest()
    decode = VideoFile.bgr

    def bgr(self):
        if hashlib.sha256(b"".join(self.packets())).hexdigest() == digest:
            return iter(frames)
        return decode(self)

    with swapped((VideoFile, "bgr", bgr)):
        bad, readers = clips_against_records(fixtures, sorted(manifest), tag)
    if bad or "flagship.webm" not in readers or len(manifest) < min_clips:
        fail(f"the port's {label} reads disagree with the JAX readers' records: {bad}")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, flagship,
                                  readers["flagship.webm"], manifest["flagship.webm"]["fps"],
                                  tag)
    say(f"[phase] {label} video {time.perf_counter() - t_phase:.1f} s")
    return {f"v2e2v_cli_{tag}_launches": rows}


MPEG12_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "mpeg12"
MPEG12_STAGES = ("demux_split", "syntax", "dequant_idct_mc", "convert", "resize")


def mpeg12_stages(path: Path, passes: int = 1):
    """Host ms per frame of each stage of an MPEG-1/2 program stream's read
    (``MPEG12_STAGES``), I-, P- and B-frames apart (a field pair by its
    first field's type), over ``passes`` passes of a fresh demuxer and
    decoder: the demux and the split at the start codes, the headers and
    macroblock symbols, dequantisation + IDCT + motion compensation (the
    decoder's ``stats``, per frame), YUV -> BGR -> gray, the reader's resize
    to a quarter. Returns the stages (every pass's samples), each pass's
    (ms of symbols of its I-frames, full garbage collections, ms in
    collections of any generation) and the first pass's BGR frames."""
    from v2e2v_tpu_torch.utils import yuv
    from v2e2v_tpu_torch.utils.image_io import resize_linear_u8
    from v2e2v_tpu_torch.utils.mpeg12dec import Mpeg12Decoder
    from v2e2v_tpu_torch.utils.mpeg12mb import tables
    from v2e2v_tpu_torch.utils.mpegps import ProgramStream

    ms = {kind: {k: [] for k in MPEG12_STAGES} for kind in ("I", "P", "B")}
    by_pass, frames = [], []
    t0 = time.perf_counter()
    tables()  # the lookups are built once per process, before the first picture
    say(f"[time] MPEG-1/2 lookup tables built in {1e3 * (time.perf_counter() - t0):.3f} ms "
        "(once per process)")
    with gc_watch() as gcs:
        for n in range(passes):
            before = dict(gcs)
            t0 = time.perf_counter()
            stream = ProgramStream(str(path))
            demux = time.perf_counter() - t0
            dec = Mpeg12Decoder(str(path))
            dec.stats = {}
            t0 = time.perf_counter()
            planes = []
            for data in stream.frames():
                planes += dec.decode(data)
            planes += dec.flush()
            decode = time.perf_counter() - t0
            spent = sum(st["syntax"] + st["reconstruct"] for st in dec.stats.values())
            split = 1e3 * (demux + decode - spent) / len(planes)  # the demux and the split
            for kind, st in dec.stats.items():
                ms[kind]["syntax"] += [1e3 * st["syntax"] / st["frames"]] * st["frames"]
                ms[kind]["dequant_idct_mc"] += [1e3 * st["reconstruct"] / st["frames"]] * \
                    st["frames"]
                ms[kind]["demux_split"] += [split] * st["frames"]
            for kind, (y, cb, cr) in zip(dec.shown, planes):
                t = [time.perf_counter()]
                bgr = yuv.yuv420p_to_bgr(y, cb, cr, str(path))
                gray = yuv.bgr_to_gray(bgr)
                t.append(time.perf_counter())
                resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
                t.append(time.perf_counter())
                ms[kind]["convert"].append(1e3 * (t[1] - t[0]))
                ms[kind]["resize"].append(1e3 * (t[2] - t[1]))
                if n == 0:
                    frames.append(bgr)
            by_pass.append((n, 1e3 * dec.stats["I"]["syntax"], gcs["full"] - before["full"],
                            gcs["ms"] - before["ms"]))
    return ms, by_pass, frames


def mpeg12_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 27: MPEG-1 and MPEG-2 video (ROADMAP item 4.2). (a) every clip
    under ``tests/data/mpeg12`` read by the port's ``VideoReader`` and
    ``VideoSequence`` against the JAX readers' records; the flagship
    program stream decoded once, with the host ms of each stage per 960x720
    frame, I-, P- and B-pictures apart, and those frames handed to its
    reads; (b) the V2E2V CLI with ``--reader_type video`` over the flagship
    ``.mpg`` (read as 180x240, decoded anew) against its PNG twin, as phase
    21 (b). Returns (b)'s launches by row."""
    from v2e2v_tpu_torch.utils.video import VideoFile

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    manifest = json.loads((MPEG12_FIXTURES / "manifest.json").read_text())["clips"]
    flagship = MPEG12_FIXTURES / "flagship.mpg"
    stages, by_pass, frames = mpeg12_stages(flagship)
    report_stages("MPEG-2 flagship .mpg", smi, stages, by_pass, "960x720", passes=1)
    decode = VideoFile.bgr

    def bgr(self):
        if Path(self.path) == flagship:
            return iter(frames)
        return decode(self)

    with swapped((VideoFile, "bgr", bgr)):
        bad, readers = clips_against_records(MPEG12_FIXTURES, sorted(manifest), "mpeg12")
    if bad or "flagship.mpg" not in readers or len(manifest) < 20:
        fail(f"the port's MPEG-1/2 reads disagree with the JAX readers' records: {bad}")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, flagship,
                                  readers["flagship.mpg"], manifest["flagship.mpg"]["fps"],
                                  "mpeg12")
    say(f"[phase] MPEG-1/2 video {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_mpeg12_launches": rows}


RAWVIDEO_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "rawvideo"
PNGVIDEO_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "pngvideo"
RAW_STAGES = ("demux", "decode", "to_bgr", "to_gray", "resize")


def fixture_script(name: str = "make_rawvideo_fixtures"):
    """``scripts/<name>.py``: ``make_rawvideo_fixtures`` (its ``write_avi``
    needs no cv2), ``make_h263_fixtures`` or ``make_mpeg2i_fixtures`` (their
    writers need none)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rawvideo_stages(path: Path) -> tuple[dict[str, list[float]], list]:
    """Host ms per frame of each stage of a raw or PNG AVI's read, over one
    pass of ``path``: demux (the file's headers and chunks, per frame),
    decode (PNG: ``image_io.decode_png``, the chunk walk, inflate and the
    row filters, its inflate also timed alone as ``inflate``; raw: none,
    the planes are views of the packet), to BGR (raw: the unpack and
    swscale's conversion; PNG: the byte swap), to gray, the reader's resize
    to a quarter. Returns them and the BGR frames."""
    import zlib

    from v2e2v_tpu_torch.utils import image_io, rawvideo, yuv
    from v2e2v_tpu_torch.utils.avi import AviFile

    ms = {k: [] for k in (*RAW_STAGES, "inflate")}
    t0 = time.perf_counter()
    avi = AviFile(str(path))
    packets = list(avi.frames())
    ms["demux"] = [1e3 * (time.perf_counter() - t0) / len(packets)] * len(packets)
    frames = []
    for data in packets:
        t = [time.perf_counter()]
        if avi.codec == "png":
            zlib.decompress(b"".join(b for k, b in image_io._chunks(data, str(path))
                                     if k == b"IDAT"))
            t.append(time.perf_counter())
            img = image_io.decode_png(data, str(path))
            t.append(time.perf_counter())
            bgr = rawvideo.png_image_bgr(img, str(path))
        else:
            t += [t[0], t[0]]
            bgr = rawvideo.raw_to_bgr(data, avi.raw_format, avi.width, avi.height, str(path))
        t.append(time.perf_counter())
        gray = yuv.bgr_to_gray(bgr)
        t.append(time.perf_counter())
        image_io.resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
        t.append(time.perf_counter())
        ms["inflate"].append(1e3 * (t[1] - t[0]))
        ms["decode"].append(1e3 * (t[2] - t[1]))
        for k, a, b in zip(("to_bgr", "to_gray", "resize"), t[2:], t[3:]):
            ms[k].append(1e3 * (b - a))
        frames.append(bgr)
    return ms, frames


def rawvideo_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 28: raw and PNG video, and the port's decoders under cv2's other
    tags and containers (ROADMAP item 4.2 a-c). (a) every clip under
    ``tests/data/rawvideo`` and ``tests/data/pngvideo`` read by the port's
    ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
    the PNG flagship decoded once; (b) the host ms per 960x720 frame of each
    stage of the PNG flagship and of raw I420 and Y800 clips written here
    (12 frames of noise each; timed only); (c) the V2E2V CLI with
    ``--reader_type video`` over the PNG flagship (read as 180x240, decoded
    anew) against its PNG twin, as phase 21 (b). Returns (c)'s launches by
    row."""
    from v2e2v_tpu_torch.utils.video import VideoFile

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    fx = fixture_script()
    flagship = PNGVIDEO_FIXTURES / "flagship.avi"
    h, w, n, fps = fx.FLAGSHIP
    rng = np.random.default_rng(seed)
    clips = {"PNG (MPNG)": flagship}
    for fourcc, bits in ((b"I420", 12), (b"Y800", 8)):
        clips[f"raw {fourcc.decode()}"] = root / f"{fourcc.decode().lower()}.avi"
        fx.write_avi(clips[f"raw {fourcc.decode()}"], [fx.yuv420_packet(rng, w, h)
                                                      for _ in range(n)], w, h, int(fps),
                     fourcc, bits)
    frames = None
    for label, path in clips.items():
        stages, bgr = rawvideo_stages(path)
        frames = bgr if path == flagship else frames
        per = {k: (float(np.median(v)), min(v), max(v)) for k, v in stages.items()}
        total = sum(per[k][0] for k in RAW_STAGES)
        say(f"[time] {label} read on the card's host ({smi}), host ms per {w}x{h} frame, median "
            f"(min-max) of {len(stages['resize'])}: "
            + ", ".join(f"{k} {m:.3f} ({lo:.3f}-{hi:.3f})" for k, (m, lo, hi) in per.items())
            + f"; sum of medians {total:.3f} ms (inflate is part of decode)")
    decode = VideoFile.bgr

    def bgr(self):
        if Path(self.path) == flagship:
            return iter(frames)
        return decode(self)

    bad = []
    with swapped((VideoFile, "bgr", bgr)):
        for folder, tag in ((RAWVIDEO_FIXTURES, "rawvideo"), (PNGVIDEO_FIXTURES, "pngvideo")):
            manifest = json.loads((folder / "manifest.json").read_text())["clips"]
            more, readers = clips_against_records(folder, sorted(manifest), tag)
            bad += more
            say(f"[{tag}] {len(manifest) - len(more)} of {len(manifest)} clips equal the JAX "
                f"readers' records")
    pngs = json.loads((PNGVIDEO_FIXTURES / "manifest.json").read_text())["clips"]
    if bad or "flagship.avi" not in readers or len(pngs) < 7:
        fail(f"the port's raw and PNG video reads disagree with the JAX readers' records: {bad}")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, flagship,
                                  readers["flagship.avi"], pngs["flagship.avi"]["fps"],
                                  "pngvideo")
    say(f"[phase] raw and PNG video {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_pngvideo_launches": rows}


H263_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "h263"
H263_STAGES = ("demux", "syntax", "dequant_idct_mc", "convert", "resize")
H263_TIMING = (576, 704, 12)  # phase 29 (b)'s H.263 clip: height, width, pictures
STAGE_PASSES = 3  # phases 29 (b) and 30 (b): passes of a fresh decoder over each clip


def decode_stages(path: Path, make_decoder, passes: int = STAGE_PASSES):
    """Host ms per frame of each stage of a clip's read (``H263_STAGES``),
    I- and P-pictures apart, over ``passes`` passes, each with the container
    opened anew and a fresh decoder from ``make_decoder(video)``: demux (the
    container's headers and packets, per frame), the picture header and
    macroblock symbols (the decoder's ``parse``), dequantisation + IDCT +
    motion compensation (``reconstruct``), YUV -> BGR -> gray, the reader's
    resize to a quarter. Returns the stages (every pass's samples), each
    I-picture's symbol ms as (pass, ms, full garbage collections during it,
    ms spent in collections of any generation during it), and the first
    pass's BGR frames."""
    from v2e2v_tpu_torch.utils import yuv
    from v2e2v_tpu_torch.utils.image_io import resize_linear_u8
    from v2e2v_tpu_torch.utils.video import VideoFile

    ms = {kind: {k: [] for k in H263_STAGES} for kind in ("I", "P")}
    by_pass, frames = [], []
    with gc_watch() as gc_state:
        for n in range(passes):
            t0 = time.perf_counter()
            video = VideoFile(str(path))
            packets = list(video.packets())
            demux = 1e3 * (time.perf_counter() - t0) / len(packets)
            dec = make_decoder(video)
            for data in packets:
                before = dict(gc_state)
                t = [time.perf_counter()]
                pic = dec.parse(data)
                t.append(time.perf_counter())
                if pic is None:  # a picture that gives no frame
                    continue
                planes = dec.reconstruct(pic)
                t.append(time.perf_counter())
                bgr = yuv.yuv420p_to_bgr(*planes, str(path), yuv.VP8_H_POS)
                gray = yuv.bgr_to_gray(bgr)
                t.append(time.perf_counter())
                resize_linear_u8(gray, (gray.shape[1] // 4, gray.shape[0] // 4))
                t.append(time.perf_counter())
                kind = "I" if pic.hdr.kind == 0 else "P"
                ms[kind]["demux"].append(demux)
                for k, a, b in zip(H263_STAGES[1:], t, t[1:]):
                    ms[kind][k].append(1e3 * (b - a))
                if kind == "I":
                    by_pass.append((n, 1e3 * (t[1] - t[0]), gc_state["full"] - before["full"],
                                    gc_state["ms"] - before["ms"]))
                if n == 0:
                    frames.append(bgr)
    return ms, by_pass, frames


@contextlib.contextmanager
def gc_watch():
    """While open, counts the process's full garbage collections and the ms
    it spends in collections of any generation: yields the running
    ``{"full": n, "ms": ms}``."""
    import gc

    state = {"full": 0, "ms": 0.0, "t": 0.0}

    def count(phase, info):
        if phase == "start":
            state["full"] += info["generation"] == 2
            state["t"] = time.perf_counter()
        else:
            state["ms"] += 1e3 * (time.perf_counter() - state["t"])

    gc.callbacks.append(count)
    try:
        yield state
    finally:
        gc.callbacks.remove(count)


def report_stages(label: str, smi: str, stages, by_pass, size: str, noun: str = "picture",
                  passes: int = STAGE_PASSES) -> None:
    """The lines of ``decode_stages``' or ``mpeg12_stages``' times: per
    picture kind the median (min-max) of every pass's samples, then the
    I-pictures' symbol ms, as each pass (or I-picture) gave them."""
    for kind, st in stages.items():
        if not st["syntax"]:
            fail(f"the {label} holds no {kind}-{noun}")
        per = {k: (float(np.median(v)), min(v), max(v)) for k, v in st.items()}
        total = sum(m for m, _, _ in per.values())
        say(f"[time] {label} read on the card's host ({smi}), host ms per {size} "
            f"{kind}-{noun}, median (min-max) of {len(st['syntax'])} over {passes} "
            "passes: "
            + ", ".join(f"{k} {m:.3f} ({lo:.3f}-{hi:.3f})" for k, (m, lo, hi) in per.items())
            + f"; sum of medians {total:.3f} ms")
    say(f"[time] {label}: I-{noun} symbols by pass, ms (full garbage collections during "
        "them; ms in collections of any generation): "
        + ", ".join(f"pass {n + 1} {v:.3f} ({c}; {g:.3f})" for n, v, c, g in by_pass))


def h263_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 29: H.263 and Sorenson H.263 video (ROADMAP item 4.2 d, first
    half). (a) every clip under ``tests/data/h263`` read by the port's
    ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
    the flagship FLV decoded once; (b) the host ms per frame of each stage,
    I- and P-pictures apart, over three passes of a fresh decoder, of the
    960x720 flagship FLV and of a 704x576
    H.263 AVI of random macroblocks written here with the fixture script's
    ``random_picture`` (12 pictures, GOB headers every other GOB; timed
    only); (c) the V2E2V CLI with ``--reader_type video`` over the flagship
    FLV (read as 180x240, decoded anew) against its PNG twin, as phase 21
    (b). Returns (c)'s launches by row."""
    from v2e2v_tpu_torch.utils.h263 import H263Decoder
    from v2e2v_tpu_torch.utils.video import VideoFile

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    flagship = H263_FIXTURES / "flagship.flv"
    h, w, n = H263_TIMING
    fx, raw = fixture_script("make_h263_fixtures"), fixture_script()
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    pictures = [fx.random_picture(rng, "h263", int(i > 0), w, h, gobs=range(0, h // 16, 4),
                                  coded=0.3 if i == 0 else 0.1, skip=0.3, intra=0.05, big=60)
                for i in range(n)]
    timing = root / "h263_704x576.avi"
    raw.write_avi(timing, pictures, w, h, 10, b"H263")
    say(f"[h263] {timing.name}: {n} pictures of random macroblocks, "
        f"{sum(map(len, pictures))} bytes, written in {time.perf_counter() - t0:.3f} s")
    frames = None
    for label, path in (("Sorenson H.263 flagship FLV", flagship), ("H.263 AVI", timing)):
        stages, by_pass, bgr = decode_stages(path, lambda v: H263Decoder(v.codec, v.path))
        frames = bgr if path == flagship else frames
        report_stages(label, smi, stages, by_pass, f"{bgr[0].shape[1]}x{bgr[0].shape[0]}")
    decode = VideoFile.bgr

    def bgr(self):
        if Path(self.path) == flagship:
            return iter(frames)
        return decode(self)

    manifest = json.loads((H263_FIXTURES / "manifest.json").read_text())["clips"]
    with swapped((VideoFile, "bgr", bgr)):
        bad, readers = clips_against_records(H263_FIXTURES, sorted(manifest), "h263")
    say(f"[h263] {len(manifest) - len(bad)} of {len(manifest)} clips equal the JAX readers' "
        "records")
    if bad or "flagship.flv" not in readers or len(manifest) < 30:
        fail(f"the port's H.263 and Sorenson H.263 reads disagree with the JAX readers' "
             f"records: {bad}")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, flagship,
                                  readers["flagship.flv"], manifest["flagship.flv"]["fps"],
                                  "h263")
    say(f"[phase] H.263 and Sorenson H.263 video {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_h263_launches": rows}


WMV_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "wmv"
WMV_TIMING = WMV_FIXTURES / "timing" / "mp43_960x720.avi"  # phase 30 (b)'s v3 clip


def wmv_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 30: ASF files and the MS-MPEG-4 family (ROADMAP item 4.2 d,
    second half). (a) every clip under ``tests/data/wmv`` read by the port's
    ``VideoReader`` and ``VideoSequence`` against the JAX readers' records,
    the flagship ``.wmv`` decoded once; (b) the host ms per frame of each
    stage, I- and P-pictures apart, over three passes of a fresh decoder, of
    the 960x720 WMV2 flagship and the fixtures' 960x720 MS-MPEG-4 v3 AVI;
    (c) the V2E2V CLI with ``--reader_type video`` over the flagship (read
    as 180x240, decoded anew) against its PNG twin, as phase 21 (b). Returns
    (c)'s launches by row."""
    from v2e2v_tpu_torch.utils.msmpeg4 import MsMpeg4Decoder
    from v2e2v_tpu_torch.utils.video import VideoFile
    from v2e2v_tpu_torch.utils.wmv2 import Wmv2Decoder

    def decoder(video):
        c = video.container
        if video.codec == "wmv2":
            return Wmv2Decoder(c.width, c.height, c.extradata, video.path)
        return MsMpeg4Decoder(video.codec, c.width, c.height, c.extradata, video.path)

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    flagship = WMV_FIXTURES / "flagship.wmv"
    frames = None
    for label, path in (("WMV2 flagship ASF", flagship), ("MS-MPEG-4 v3 AVI", WMV_TIMING)):
        stages, by_pass, bgr = decode_stages(path, decoder)
        frames = bgr if path == flagship else frames
        report_stages(label, smi, stages, by_pass, f"{bgr[0].shape[1]}x{bgr[0].shape[0]}")
    decode = VideoFile.bgr

    def bgr(self):
        if Path(self.path) == flagship:
            return iter(frames)
        return decode(self)

    manifest = json.loads((WMV_FIXTURES / "manifest.json").read_text())["clips"]
    with swapped((VideoFile, "bgr", bgr)):
        bad, readers = clips_against_records(WMV_FIXTURES, sorted(manifest), "wmv")
    say(f"[wmv] {len(manifest) - len(bad)} of {len(manifest)} clips equal the JAX readers' "
        "records")
    if bad or "flagship.wmv" not in readers or len(manifest) < 70:
        fail(f"the port's ASF and MS-MPEG-4 reads disagree with the JAX readers' records: {bad}")
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, flagship,
                                  readers["flagship.wmv"], manifest["flagship.wmv"]["fps"], "wmv")
    say(f"[phase] ASF and MS-MPEG-4 video {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_wmv_launches": rows}


MPEG2I_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "mpeg2i"
MPEG2I_TIMING = 12  # phase 31 (b)'s frame-picture stream: frames


def mpeg2i_frame_stream(seed: int, root: Path) -> Path:
    """A 720x576 program stream of interlaced frame pictures (GOP I-P-P-B-B-P-
    B-B-P-B-B-P: frame, field and dual-prime motion, field DCT, skips),
    coded by ``scripts/make_mpeg2i_fixtures.py``'s writer from the flagship's
    sequence header and a seeded smooth scene (the card's machine has no
    cv2 to write either)."""
    from v2e2v_tpu_torch.utils.mpegps import ProgramStream

    mi = fixture_script("make_mpeg2i_fixtures")
    es = ProgramStream(str(MPEG2I_FIXTURES / "flagship.vob")).es
    units = mi.mf.units(es)
    rng = np.random.default_rng(seed)
    h, w = 576, 720
    coder = mi.Coder(w, h, rng, (units[0], units[1]), residual=0.15)
    plan = [mi.gop_plan("IPPBBPBBPBBP", lambda i: mi.FRAME, rng)]
    yy, xx = np.mgrid[0:h, 0:w]
    scene = np.stack([np.stack([(96 + 60 * np.sin((xx + 7 * t) / 37.0)
                                 + 50 * np.cos((yy - 3 * t) / 23.0) + 20 * c) % 256
                                for c in range(3)], -1).astype(np.uint8)
                      for t in range(MPEG2I_TIMING)])
    t0 = time.perf_counter()
    stream = coder.stream(plan, scene)
    path = root / "frames_720x576.vob"
    mi.program_stream(path, stream, mi.timestamps(mi.frames_of(stream), mi.fields_of(plan),
                                                  (25, 1)))
    say(f"[mpeg2i] {path.name}: {MPEG2I_TIMING} interlaced frame pictures, "
        f"{path.stat().st_size} bytes, coded in {time.perf_counter() - t0:.3f} s; modes "
        f"{sorted(coder.used)}")
    return path


LONG_MINUTES = (1, 10)  # phase 31 (b): the program streams whose open is timed


def long_stream_opens(smi: str, root: Path, clip: Path) -> None:
    """Phase 31 (b): the host seconds ``VideoFile`` takes to open program
    streams of ``LONG_MINUTES`` minutes, ``clip``'s frames written over and
    over with running stamps (``make_mpeg2i_fixtures.long_program_stream``),
    the median (min-max) of three opens: the demux of every pack, cv2's
    rate from FFmpeg's analysis of the first seconds, the count from the
    tail's stamps. Fails where the count is not the clip's plus its frames
    for each further copy, or the open grows faster than the file."""
    from v2e2v_tpu_torch.utils.mpegps import ProgramStream
    from v2e2v_tpu_torch.utils.video import VideoFile

    mi = fixture_script("make_mpeg2i_fixtures")
    es = ProgramStream(str(clip)).es
    frames = len(mi.frames_of(es))
    once = root / "long_once.vob"  # the clip once: each copy adds its frames to the count
    mi.long_program_stream(once, es, 1)
    short = VideoFile(str(once)).frame_count
    per_mb = []
    for minutes in LONG_MINUTES:
        copies = round(minutes * 60 * 25 / frames)
        path = root / f"long_{minutes}min.vob"
        mi.long_program_stream(path, es, copies)
        took = []
        for _ in range(3):
            t0 = time.perf_counter()
            video = VideoFile(str(path))
            took.append(time.perf_counter() - t0)
        size = path.stat().st_size
        want = short + (copies - 1) * frames
        if (video.fps, video.frame_count) != (25.0, want):
            fail(f"a {minutes}-minute program stream opens at {video.fps} fps, "
                 f"{video.frame_count} frames, not 25 and {want}")
        say(f"[time] interlaced MPEG-2 on the card's host ({smi}): a {minutes}-minute 720x576 "
            f"program stream ({copies * frames} frames, {size} bytes) opens in "
            f"{float(np.median(took)):.3f} s ({min(took):.3f}-{max(took):.3f}) over 3 opens")
        per_mb.append(min(took) / size)
        path.unlink()
    if per_mb[-1] > 3 * per_mb[0]:
        fail(f"a program stream's open grows faster than its length: {per_mb} s a byte")


def mpeg2i_phase(seed: int, smi: str, root: Path, v2e2v_model: Path) -> dict:
    """Phase 31: interlaced MPEG-2 (ROADMAP item 4.2 e). (a) every clip
    under ``tests/data/mpeg2i`` read by the port's ``VideoReader`` and
    ``VideoSequence`` against the JAX readers' records, the flagship decoded
    once; (b) the host ms per 720x576 frame of each stage, I-, P- and
    B-frames apart, over three passes of a fresh decoder, of the flagship
    (field pictures) and of a stream of interlaced frame pictures coded here,
    and the open of 1- and 10-minute program streams of the flagship's frames;
    (c) the V2E2V CLI with ``--reader_type video`` over the flagship's bytes
    as an ``.mpg`` (read as 144x180, decoded anew) against its PNG twin, as
    phase 21 (b). Returns (c)'s launches by row."""
    from v2e2v_tpu_torch.utils.video import VideoFile

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    flagship = MPEG2I_FIXTURES / "flagship.vob"
    frames = None
    for label, path in (("interlaced MPEG-2 flagship .vob (field pictures)", flagship),
                        ("interlaced MPEG-2 .vob of frame pictures",
                         mpeg2i_frame_stream(seed, root))):
        stages, by_pass, bgr = mpeg12_stages(path, STAGE_PASSES)
        frames = bgr if path == flagship else frames
        report_stages(label, smi, stages, by_pass, "720x576", noun="frame")
    long_stream_opens(smi, root, flagship)
    decode = VideoFile.bgr

    def bgr(self):
        if Path(self.path) == flagship:
            return iter(frames)
        return decode(self)

    manifest = json.loads((MPEG2I_FIXTURES / "manifest.json").read_text())["clips"]
    with swapped((VideoFile, "bgr", bgr)):
        bad, readers = clips_against_records(MPEG2I_FIXTURES, sorted(manifest), "mpeg2i")
    say(f"[mpeg2i] {len(manifest) - len(bad)} of {len(manifest)} clips equal the JAX readers' "
        "records (FFmpeg's decode, converted as cv2 converts a progressive frame, where cv2 "
        "returns interlaced frames unconverted)")
    if bad or "flagship.vob" not in readers or len(manifest) < 20:
        fail(f"the port's interlaced MPEG-2 reads disagree with the records: {bad}")
    # the CLIs list .mpg, not .vob, in both packages (manifests.VIDEO_FORMATS): the
    # program stream's bytes as an .mpg
    as_mpg = root / "flagship.mpg"
    shutil.copyfile(flagship, as_mpg)
    # read as 144x180 (576 / 4 x 720 / 4): the CLIs' --image_dim so
    h, w = readers["flagship.vob"].frames[0].shape
    rows = video_cli_against_twin(seed, smi, root, v2e2v_model, as_mpg, readers["flagship.vob"],
                                  manifest["flagship.vob"]["fps"], "mpeg2i",
                                  ("--image_dim", str(h), str(w)))
    say(f"[phase] interlaced MPEG-2 {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_mpeg2i_launches": rows}


IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "images"
IMAGE_PACK = 3  # --num_pack_frames over the six PNG frames the CLIs list in the mixed folder
IMAGE_EVENTS_SEED = 22  # phase 22c's events: --seed + this
IMAGE_TRAIN_PACKS, IMAGE_TRAIN_FRAMES = 3, 4  # 22d: packs of 4 frames, 3 packs a sample
IMAGE_TRAIN = ("--num_pack_frames", str(IMAGE_TRAIN_FRAMES), "--len_sequence",
               str(IMAGE_TRAIN_PACKS))


def image_phase(seed: int, smi: str, root: Path, e2v_model: Path, v2e2v_model: Path,
                e2v_ckpt: Path) -> dict:
    """Phase 22: every still-frame format of the JAX manifests (ROADMAP item
    4). (a) every fixture under ``tests/data/images`` decoded by the port
    against ``manifest.json``'s sha256 of ``cv2.imread(path, 0)``, and the
    host ms per 180x240 frame of each format of the mixed folder; (b) the
    V2E2V CLI over the mixed folder and (c) the E2V CLI with it as ground
    truth, each against the PNG twin of the frames it lists (the CLIs, JAX's
    and the port's, list ``.jpg`` and ``.png`` frames only: the six PNGs of
    the kinds read now), K3 and K1 held per call as in phase 20; (d) the
    V2E2V trainer over the whole mixed folder (BMP, PGM, TIFF, WebP and the
    PNGs, read through the manifests) against the same over the twin: the
    samples equal on the host, K3 counted, the first loss equal. Returns the
    launches by row of (b), (c) and (d)."""
    from v2e2v_tpu_torch.cli import train
    from v2e2v_tpu_torch.data.datasets import TrainSeqData
    from v2e2v_tpu_torch.data.manifests import make_train_txt_wo_events
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.utils.image_io import read_gray

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    # (a) the fixtures against cv2's hashes, and the decode times
    manifest, bad, ok = fixtures_against_manifest(IMAGE_FIXTURES, 80)
    kinds = sorted({rel.split("/")[1].split("_")[0] for rel in manifest if rel.startswith("cases")})
    say(f"[image] {len(manifest)} fixtures (tests/data/images: {', '.join(kinds)} cases, the "
        f"12-frame {H}x{W} mixed folder and its PNG twin) decoded by the port against the sha256 "
        f"of cv2.imread(path, 0): mismatches {bad} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the port's still-frame decoders disagree with cv2's hashes")
    seq = IMAGE_FIXTURES / "sequence" / JPEG_SEQUENCE
    twin = IMAGE_FIXTURES / "sequence_png" / JPEG_SEQUENCE
    frames = sorted((seq / "frames").glob("frame_*"))
    labels = ["BMP 8-bit", "PNG 16-bit gray", "PGM", "PNG Adam7 colour", "TIFF LZW colour",
              "PNG 16-bit colour", "WebP lossy", "PNG colour + gAMA", "TIFF 16-bit Deflate",
              "PNG Adam7 16-bit gray", "WebP lossless", "PNG palette + sRGB"]
    timing = {}
    for label, f in [*zip(labels, frames), *(("PNG 8-bit gray (twin)", t) for t in
                                             sorted((twin / "frames").glob("frame_*.png")))]:
        for _ in range(3):
            t0 = time.perf_counter()
            read_gray(str(f))
            timing.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
    say(f"[time] frame decode on the card's host ({smi}), read_gray per {H}x{W} frame, median "
        f"(min-max) of 3 reads of the mixed folder's frame (host clock): "
        + "; ".join(f"{k} ({next(f for lab, f in zip(labels, frames) if lab == k).stat().st_size}"
                    f" bytes) {np.median(v):.3f} ms ({min(v):.3f}-{max(v):.3f})"
                    if k in labels else f"{k} {np.median(v):.3f} ms ({min(v):.3f}-{max(v):.3f}, "
                    f"{len(v)} reads)" for k, v in timing.items()))

    # the twin of the frames the CLIs list, with the mixed folder's stamps
    stamps_txt = (seq / "frames" / "timestamps.txt").read_text()
    listed = [f for f in frames if f.suffix in (".jpg", ".png")]
    sub = root / "png" / JPEG_SEQUENCE / "frames"
    sub.mkdir(parents=True)
    (sub / "timestamps.txt").write_text(stamps_txt)
    for f in listed:
        shutil.copyfile(twin / "frames" / f"{f.stem}.png", sub / f"{f.stem}.png")

    # (b) the V2E2V CLI over the mixed folder (the main path, counts at 0)
    # and over the twin of its PNG frames with K3 and K1 held per call
    extra = ("--num_pack_frames", str(IMAGE_PACK))
    b = cli_against_twin(seed, v2e2v_model, root, (
        ("mixed", IMAGE_FIXTURES / "sequence", extra), ("png", root / "png", extra)))
    pairs, k3_errs, k1_errs = b["pairs"], b["k3_errs"], b["k1_errs"]
    ok = b["ok"] and len(listed) == 6 and len(pairs) >= 2
    say(f"[image] V2E2V CLI over the mixed folder ({len(frames)} frames; it lists the "
        f"{len(listed)} PNGs: {', '.join(lab for lab, f in zip(labels, frames) if f in listed)}; "
        f"--num_pack_frames {IMAGE_PACK}) and their 8-bit twin: {len(pairs)} packs, num_events "
        f"{b['events']}; {b['files']} output files byte for byte equal, printed averages "
        f"{b['printed']} equal: {b['same']}; main path (counts at 0 before the mixed run): K3 "
        f"{b['k3']} (want one per frame pair, {sum(pairs)}), K1 {b['k1']} (want "
        f"{2 * DEPTH * len(pairs)}), K2 {b['k2']}; in the twin run K3 against its plain version at "
        f"each of {len(k3_errs)} calls: final and mem equal, voxel max_abs_err "
        f"{max(e for e, _ in k3_errs):.3e} (tol 1e-5), K1 at each of {len(k1_errs)} calls: "
        f"max_abs_err {max(e for e, _ in k1_errs):.3e} (tol {TOL[torch.float32]} + "
        f"{TOL[torch.float32]} |ref|) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI over the mixed folder did not run as over its PNG twin")

    # (c) the E2V CLI with the mixed folder's frames as ground truth, against
    # the twin of its PNG frames, the same events in both
    c = e2v_against_twin(seed, e2v_model, root, (("mixed", frames),
                                                 ("png", sorted(sub.glob("frame_*.png")))),
                         stamps_txt, IMAGE_EVENTS_SEED)
    em, ep, k1_e, others, ok = c["main"], c["twin"], c["k1"], c["others"], c["ok"]
    say(f"[image] E2V CLI with the mixed folder as ground truth and {CLI_EVENTS[0]}-"
        f"{CLI_EVENTS[1]} events an interval, against the twin of its PNG frames: {em['n']} "
        f"reconstructions, result.csv rows equal: {em['csv'] == ep['csv']}, "
        f"{len(em['files'])} output files byte for byte equal: {em['files'] == ep['files']}; K1 "
        f"{k1_e} (want 2 x depth x {em['n']}), K2 and K3 {others} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V CLI over the mixed folder disagrees with its PNG twin")

    # (d) the V2E2V trainer over every frame of the mixed folder and of the twin
    runs = {}
    for kind, src in (("mixed", seq), ("png", twin)):
        data = root / f"train_{kind}"
        shutil.copytree(src, data / JPEG_SEQUENCE)
        n_lines = make_train_txt_wo_events(str(data), "train_v2e2v.txt", IMAGE_TRAIN_FRAMES,
                                           IMAGE_TRAIN_FRAMES - 1)
        samples = TrainSeqData(str(data / "train_v2e2v.txt"), str(data), IMAGE_TRAIN_PACKS,
                               IMAGE_TRAIN_FRAMES)
        printed = io.StringIO()
        if kind == "mixed":
            counts_zero(*kernel_counters())
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train.main(train_argv(data, root / f"train_{kind}_models", "--epochs", "1",
                                  "--path_to_e2v", str(e2v_ckpt), *IMAGE_TRAIN))
        torch.cuda.synchronize()
        if kind == "mixed":
            train_rows = row_counts()
            k3_t, k1_t = emulator_iters.launches, ista_loop.launches + cista_core.launches
        runs[kind] = {"lines": n_lines, "samples": [samples[i] for i in range(len(samples))],
                      "loss": [ln for ln in printed.getvalue().splitlines() if "loss:" in ln],
                      "s": time.perf_counter() - t0}
    tm, tp = runs["mixed"], runs["png"]
    same = len(tm["samples"]) == len(tp["samples"]) > 0 and all(
        np.array_equal(a, b) for sm, sp in zip(tm["samples"], tp["samples"])
        for a, b in zip(sm, sp))
    k3_want = len(tm["samples"]) * IMAGE_TRAIN_PACKS * (IMAGE_TRAIN_FRAMES - 1)  # one a pair
    ok = (same and tm["loss"] == tp["loss"] and len(tm["loss"]) == 1 and k3_t == k3_want
          and k1_t == 0)
    say(f"[image] cli.train (V2E2V) over the mixed folder's 12 frames ({tm['lines']} pack lines "
        f"of 4, {len(tm['samples'])} sample of 3 packs, read through the manifests) and over "
        f"its twin: samples equal on the host {same}, first loss {tm['loss']} / {tp['loss']}, "
        f"K3 {k3_t} (main path, counts at 0 before the mixed run; want one per frame pair, "
        f"{k3_want}), K1 and K2 {k1_t}; "
        f"{tm['s']:.1f} s / {tp['s']:.1f} s {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V trainer over the mixed folder disagrees with its PNG twin")
    say(f"[phase] still-frame formats {time.perf_counter() - t_phase:.1f} s")
    return {"v2e2v_cli_image_launches": b["rows"], "e2v_cli_image_launches": c["rows"],
            "v2e2v_train_image_launches": train_rows}


VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]  # VGG16's convs per block
VGG_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]  # their features.N indices
LPIPS_TOL = 1e-4  # relative, card against CPU
LPIPS_FRAMES = 9  # 23b: --test_img_num, 10 frames of phase 9's first sequence


def write_vgg(path: Path, seed: int) -> Path:
    """Random He-scaled VGG16 weights and non-negative LPIPS heads in the
    LPIPS file's layout (``{'vgg': features, 'lin': heads}``)."""
    rng = np.random.default_rng(seed)
    feats, cin, idx = {}, 3, iter(VGG_CONVS)
    for cout, n in VGG_BLOCKS:
        for _ in range(n):
            i = next(idx)
            feats[f"{i}.weight"] = torch.from_numpy(
                rng.normal(0, 1 / np.sqrt(9 * cin), (cout, cin, 3, 3)).astype(np.float32))
            feats[f"{i}.bias"] = torch.from_numpy(rng.normal(0, 0.05, cout).astype(np.float32))
            cin = cout
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        (0.1 * rng.random((1, c, 1, 1))).astype(np.float32)) for i, (c, _) in enumerate(VGG_BLOCKS)}
    torch.save({"vgg": feats, "lin": lins}, path)
    return path


def lpips_flops(b: int) -> float:
    """Multiply-adds x 2 of the VGG16 trunk over ``b`` pairs at H x W (both
    images of each pair), the convs only."""
    flops, cin, h, w = 0.0, 3, H, W
    for block, (cout, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            flops += 2 * 9 * cin * cout * h * w
            cin = cout
        h, w = h // 2, w // 2
    return 2 * b * flops


def lpips_phase(seed: int, smi: str, root: Path, cli_root: Path, e2v_ckpt: Path, cfg) -> dict:
    """Phase 23: LPIPS (ROADMAP item 12). (a) the distance at 180x240, B = 1
    and 8, card against CPU, and its ms; (b) the E2V CLI over phase 9's first
    sequence with ``V2E2V_LPIPS_WEIGHTS`` set (the main path, every count at
    0 just before it) and without: each frame's LPIPS against the CPU port's
    on the same frames, PNGs and the other metrics equal, K1 2 x depth per
    reconstruction; (c) the E2V train step with LPIPS at B = 8, T = 10, card
    against CPU (phase 13a's rule, or 1.5x the same step's spread without
    LPIPS), ms and peak memory with and without LPIPS; (d) ``cli.train`` for one step with LPIPS. Returns the launches of
    (b), (c) and (d) by row."""
    from v2e2v_tpu_torch.cli import train
    from v2e2v_tpu_torch.data.manifests import make_train_txt_wo_events
    from v2e2v_tpu_torch.data.synthetic import hfr_frames, write_hfr_dataset
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.training import lpips
    from v2e2v_tpu_torch.training.steps import make_adam, make_e2v_train_step
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    weights = write_vgg(root / "vgg.pth", seed)
    card, cpu = (lpips.make_lpips_fn(str(weights), device=d) for d in ("cuda", "cpu"))
    saved_env = os.environ.get("V2E2V_LPIPS_WEIGHTS")
    try:
        # (a) the distance, card against CPU
        for b in (1, 8):
            frames, _ = hfr_frames(seed + 23, 2, H, W, batch=b)
            pred = torch.from_numpy(frames[:, 0, :, :, None] / 255.0).float()
            target = torch.from_numpy(frames[:, 1, :, :, None] / 255.0).float()
            want = float(cpu(pred, target))
            pc, tc = pred.cuda(), target.cuda()
            with torch.no_grad():
                got = float(card(pc, tc))
                ms = time_ms(lambda: card(pc, tc), warmup=2, iters=10)
            rel = abs(got - want) / abs(want)
            flops = lpips_flops(b)
            bound = max(flops / PEAK_FLOPS[torch.float32], 2 * pc.numel() * 4 / PEAK_BYTES) * 1e3
            ok = np.isfinite(got) and rel <= LPIPS_TOL and got > 0
            say(f"[lpips] distance B={b} at {H}x{W} (gray tiled to 3 channels; VGG16 trunk "
                f"{flops / 1e9:.1f} GFLOP a call, cuDNN float32, TF32 off): card {got:.7f}, CPU "
                f"{want:.7f}, relative error {rel:.3e} (tol {LPIPS_TOL}); {ms:.3f} ms per call "
                f"({ms / b:.3f} ms a pair; CUDA events, {smi}), bound {bound:.3f} ms (float32 "
                f"peak) {'pass' if ok else 'FAIL'}")
            if not ok:
                fail("LPIPS on the card disagrees with the CPU")

        # (b) the E2V CLI over phase 9's first sequence, with and without LPIPS
        data, model = cli_root / "data", cli_root / "model.pth.tar"
        first = sorted(p.name for p in data.iterdir() if p.is_dir())[0].split(".")[0]
        extra = ("--test_data_name", first, "--test_img_num", str(LPIPS_FRAMES))
        runs = {}
        for tag in ("lpips", "plain"):
            if tag == "lpips":
                os.environ["V2E2V_LPIPS_WEIGHTS"] = str(weights)
            else:
                os.environ.pop("V2E2V_LPIPS_WEIGHTS", None)
            rec = cli_reconstructor(data, model, torch.float32, f"lpips_cli_{tag}", "cuda", extra)
            steps = record_steps(rec, keep_state=False)
            seen, evaluate = [], rec.evaluate

            def recorded(pred_u8, gt, _evaluate=evaluate, _seen=seen):
                row = _evaluate(pred_u8, gt)
                _seen.append((pred_u8.copy(), np.array(gt, np.float32), row))
                return row

            rec.evaluate = recorded
            if tag == "lpips":
                counts_zero(*kernel_counters())
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rec.run()
            torch.cuda.synchronize()
            if tag == "lpips":
                cli_rows = row_counts()
                k1, others = ista_loop.launches, cista_core.launches + emulator_iters.launches
            folder = data.parent / f"lpips_cli_{tag}"
            runs[tag] = {"n": len(steps), "seen": seen, "s": time.perf_counter() - t0,
                         "files": {k: v for k, v in output_files(folder).items()
                                   if not k.endswith("result.csv")},
                         "csv": [p.read_text().splitlines() for p in folder.rglob("result.csv")]}
        lp, plain = runs["lpips"], runs["plain"]
        cpu_vals = [float(cpu(torch.from_numpy((p / 255.0).astype(np.float32))[None, ..., None],
                              torch.from_numpy(g)[None, ..., None])) for p, g, _ in lp["seen"]]
        card_vals = [row[3] for _, _, row in lp["seen"]]
        rels = [abs(a - b) / abs(b) for a, b in zip(card_vals, cpu_vals)]
        header, row = lp["csv"][0]
        col = header.split("	").index("LPIPS")
        csv_lpips = float(row.split("	")[col])
        others_equal = [r.split("	")[:col] + r.split("	")[col + 1:] for r in lp["csv"][0]] == [
            r.split("	")[:col] + r.split("	")[col + 1:] for r in plain["csv"][0]]
        ok = (len(lp["csv"]) == len(plain["csv"]) == 1 and lp["files"] == plain["files"]
              and others_equal and np.isfinite(card_vals).all() and max(rels) <= LPIPS_TOL
              and csv_lpips == round(float(np.mean(card_vals)), 4)
              and plain["csv"][0][1].split("	")[col] == "nan"
              and k1 == 2 * DEPTH * lp["n"] and others == 0 and lp["n"] == plain["n"] > 0)
        say(f"[lpips] E2V CLI over phase 9's first sequence ({first}, {len(card_vals)} frames, "
            f"{lp['n']} reconstructions, float32) with V2E2V_LPIPS_WEIGHTS set: result.csv LPIPS "
            f"{csv_lpips} (mean of the frames' {np.mean(card_vals):.6f}), each frame's against "
            f"the CPU port's on the same frames: largest relative error {max(rels):.3e} (tol "
            f"{LPIPS_TOL}); without the variable: LPIPS nan, {len(lp['files'])} PNG files byte for "
            f"byte equal and the other metrics equal: {lp['files'] == plain['files']} "
            f"{others_equal}; main path (counts at 0 before the LPIPS run): K1 {k1} (want "
            f"{2 * DEPTH * lp['n']}), K2 and K3 {others}; {lp['s']:.1f} s with LPIPS, "
            f"{plain['s']:.1f} s without ({smi}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail("the E2V CLI with LPIPS did not run as it should")

        # (c) the E2V train step with LPIPS, card against CPU, then times
        cfg = dataclasses.replace(cfg, ista_impl="plain", core_impl="layers")  # trainable
        counters = kernel_counters()
        # 13a's rule per tensor; a tensor past it must be within 1.5x of the
        # card-CPU spread of the same step without LPIPS on the same batch,
        # the float32 spread the step has anyway (We's reads 1.1-1.3e-3 on
        # this batch without LPIPS on an H100 80GB HBM3, 700 W)
        seq, gt = train_batch(seed + 23, CAPACITY)
        res = {}
        for run, device, fn in (("cpu", "cpu", cpu), ("card", "cuda", card),
                                ("cpu, no LPIPS", "cpu", None),
                                ("card, no LPIPS", "cuda", None)):
            sd = train_weights(cfg, seed, device)
            step = make_e2v_train_step(cfg, make_adam(sd, cfg, TRAIN_LR), lpips_fn=fn)
            counts_zero(*counters)
            t0 = time.perf_counter()
            loss = float(step(sd, seq.to(device), gt.to(device)))
            torch.cuda.synchronize()
            res[run] = (loss, {k: sd[k].grad.cpu() for k in STEP_KEYS[cfg.model_mode]},
                        time.perf_counter() - t0, [c.launches for c in counters])
            if run == "card":
                train_rows = row_counts()
            del sd, step

        def spread(a: str, b: str):
            (la, ga, _, _), (lb, gb, _, _) = res[a], res[b]
            return abs(la - lb) / abs(lb), {k: float((ga[k] - g).abs().max()) /
                                            float(g.abs().max()) for k, g in gb.items()}

        rel, errs = spread("card", "cpu")
        rel0, errs0 = spread("card, no LPIPS", "cpu, no LPIPS")
        worst = max(errs, key=errs.get)
        past = {k: (float(f"{errs[k]:.2e}"), float(f"{errs0[k]:.2e}")) for k in errs
                if errs[k] > GRAD_TOL}
        launches = res["card"][3]
        ok = (rel <= 1e-4 and rel0 <= 1e-4 and all(errs[k] <= 1.5 * errs0[k] for k in past)
              and not any(launches))
        say(f"[lpips] E2V train step with LPIPS card vs CPU (CISTA-LSTC {H}x{W}, C={C}, depth "
            f"{DEPTH}, T={TRAIN_T}, B={CAPACITY}, remat; the same weights and batch): loss "
            f"{res['card'][0]:.7f} vs {res['cpu'][0]:.7f}, relative error {rel:.3e} (tol 1e-4); "
            f"gradients: largest max|diff| / max|g| {errs[worst]:.3e} ({worst}; tol {GRAD_TOL}); "
            f"per tensor { {k: float(f'{v:.2e}') for k, v in errs.items()} }; the same step "
            f"without LPIPS: loss {rel0:.3e}, largest {max(errs0.values()):.3e}; past {GRAD_TOL} "
            f"(with, without LPIPS; want with <= 1.5 without): {past}; launches {launches}; "
            f"step {res['card'][2]:.1f} s (CPU {res['cpu'][2]:.1f} s, {res['cpu, no LPIPS'][2]:.1f}"
            f" s without LPIPS) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail("the E2V train step with LPIPS on the card disagrees with the CPU")
        seq, gt = seq.cuda(), gt.cuda()
        timing = {}
        for tag, fn in (("without", None), ("with", card)):
            sd = train_weights(cfg, seed, "cuda")
            step = make_e2v_train_step(cfg, make_adam(sd, cfg, TRAIN_LR), lpips_fn=fn)
            losses = [float(step(sd, seq, gt))]  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            losses += [step(sd, seq, gt) for _ in range(3)]
            ev[1].record()
            ev[1].synchronize()
            timing[tag] = (ev[0].elapsed_time(ev[1]) / 3,
                           (torch.cuda.max_memory_allocated() - base) / 2**20,
                           [float(x) for x in losses])
            del sd, step
        (ms0, mib0, l0), (ms1, mib1, l1) = timing["without"], timing["with"]
        ok = all(np.isfinite(l0 + l1)) and l1[0] > l0[0]
        say(f"[time] E2V train step B={CAPACITY}, T={TRAIN_T} ({smi}; float32, TF32 off, remat): "
            f"{ms0:.3f} ms without LPIPS, {ms1:.3f} ms with ({ms1 - ms0:.3f} ms, "
            f"{(ms1 - ms0) / ms0:.1%} more; CUDA events, 3 steps after 1 of warm-up); "
            f"max_memory_allocated above the weights and batch {mib0:.1f} MiB without, "
            f"{mib1:.1f} MiB with; losses {[round(x, 5) for x in l0]} / "
            f"{[round(x, 5) for x in l1]} {'pass' if ok else 'FAIL'}")
        if not ok:
            fail("the E2V train steps with and without LPIPS did not run as they should")

        # (d) cli.train for one step with LPIPS
        os.environ["V2E2V_LPIPS_WEIGHTS"] = str(weights)
        tdata = root / "train_data"
        write_hfr_dataset(tdata, seed + 23, 1, TRAIN_SEQ_FRAMES, H, W)
        make_train_txt_wo_events(str(tdata), "train_v2e2v.txt", N_FRAMES, N_FRAMES - 1)
        counts_zero(*counters)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train.main(train_argv(tdata, root / "train_models", "--epochs", "1",
                                  "--path_to_e2v", str(e2v_ckpt), "--drop_seq_tails"))
        torch.cuda.synchronize()
        v2e2v_rows = row_counts()
        k3_t, k1_t = emulator_iters.launches, ista_loop.launches + cista_core.launches
        log = printed.getvalue()
        loss_lines = [ln for ln in log.splitlines() if "loss:" in ln]
        loss = float(loss_lines[0].split("loss:")[1]) if loss_lines else float("nan")
        ok = (np.isfinite(loss) and "LPIPS weights unavailable" not in log
              and k3_t == TRAIN_T * (N_FRAMES - 1) and k1_t == 0)
        say(f"[lpips] cli.train (V2E2V) with V2E2V_LPIPS_WEIGHTS set, one step over one sample "
            f"of {TRAIN_T} packs of {N_FRAMES} frames at {H}x{W} (--drop_seq_tails: no tail "
            f"sample): loss {loss:.6f}; K3 {k3_t} "
            f"(want {N_FRAMES - 1} a pack, {TRAIN_T * (N_FRAMES - 1)}), K1 and K2 {k1_t}; "
            f"{time.perf_counter() - t0:.1f} s {'pass' if ok else 'FAIL'}")
        if not ok:
            fail("cli.train with LPIPS did not run as it should")
    finally:
        if saved_env is None:
            os.environ.pop("V2E2V_LPIPS_WEIGHTS", None)
        else:
            os.environ["V2E2V_LPIPS_WEIGHTS"] = saved_env
    say(f"[phase] LPIPS {time.perf_counter() - t_phase:.1f} s")
    return {"e2v_cli_lpips_launches": cli_rows, "e2v_train_lpips_launches": train_rows,
            "v2e2v_train_lpips_launches": v2e2v_rows}


def main_path_k3_inputs(cfg, state, frames, ts, internal: bool):
    """The K3 inputs of the first frame pair of a pack on the main path: the
    emulator's own front end, stopped where it calls K3."""
    from v2e2v_tpu_torch.models import emulator as emu

    got = {}

    def record(*args, **kw):
        got["args"], got["kw"] = args, kw
        return emu.k3.emulator_iters(*args, **kw)

    noise = emu.GeneratorNoise(torch.Generator(device="cuda").manual_seed(1))
    st, pack = emu._prepare_pack(cfg, state, frames, ts, noise)
    emu._pair_step(cfg, st, pack, st.base_log_frame, st.timestamp_mem, st.t_previous, 0, noise,
                   record, internal)
    names = ("event_counts", "pol", "timestamp_mem", "tr_frames", "one_minus_on_prob",
             "off_prob", "rand01", "seed", "ts_step", "num_iters", "gate", "tf_base")
    return dict(zip(names, got["args"])), got["kw"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 18b starts this script once per rank with these
    ap.add_argument("--gloo_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", type=Path, default=None, help=argparse.SUPPRESS)
    # and phase 19 with these
    ap.add_argument("--spatial", type=int, nargs=2, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spatial_cli", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")
    if args.gloo_rank is not None:
        if args.spatial_cli:
            spatial_cli_rank(args.gloo_rank, args.port, args.dir)
        elif args.spatial:
            spatial_rank(args.gloo_rank, args.port, args.dir, args.seed, tuple(args.spatial))
        else:
            gloo_rank(args.gloo_rank, args.port, args.dir, args.seed)
        return

    from v2e2v_tpu_torch.models.cista import CistaConfig, CistaState, half_res_core, init_cista_lstc
    from v2e2v_tpu_torch.ops.cuda import _lib
    from v2e2v_tpu_torch.ops.cuda.core import cista_core, cista_core_plain, launches_per_call
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
    from v2e2v_tpu_torch.ops.voxel import event_preprocess, events_to_voxel_grid
    from v2e2v_tpu_torch.serving import StreamPool
    from v2e2v_tpu_torch.utils.vp8dec import Vp8Decoder
    from v2e2v_tpu_torch.utils.vp9dec import Vp9Decoder

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"[device] torch: {kind}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    lib = _lib.load()
    say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s")
    name, spills = None, {}
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            say(f"[build]   {short_name(name)}: {line.split('ptxas info    :')[-1].strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = int(m.group(1)) + int(m.group(2))
    hgmma = sass_counts(lib.path, "HGMMA")
    hmma = sass_counts(lib.path, "HMMA")
    tc_kernels = [k for k in hgmma if "conv3x3_tc_kernel" in k]
    f32_kernels = [k for k in hgmma if re.search(r"(ista|core)_conv3x3_kernelI", k)]
    say(f"[build] HGMMA (wgmma) instructions per kernel, cuobjdump --dump-sass: "
        f"{ {short_name(k): v for k, v in hgmma.items()} }")
    if not any("ista_conv3x3_tc" in k for k in tc_kernels) or not any(
            "core_conv3x3_tc" in k for k in tc_kernels):
        fail("the library has no bfloat16 tensor-core conv kernel for K1 or K2")
    if any(hgmma[k] == 0 or spills.get(k, 1) for k in tc_kernels):
        fail("a bfloat16 conv kernel of K1 or K2 has no HGMMA instruction, or spills")
    # 2 ISTA epilogues + 5 core epilogues, each in 3 tile widths
    say(f"[build] float32 conv kernels of K1 and K2: {len(f32_kernels)} (want 21); HGMMA + "
        f"HMMA {sum(hgmma[k] + hmma.get(k, 0) for k in f32_kernels)}, spilled bytes "
        f"{sum(spills.get(k, 1) for k in f32_kernels)} (want 0 and 0: FFMA only)")
    if len(f32_kernels) != 21 or any(hgmma[k] or hmma.get(k, 0) or spills.get(k, 1)
                                     for k in f32_kernels):
        fail("a float32 conv kernel of K1 or K2 is missing, holds a tensor-core instruction, "
             "or spills")
    tiles = {(b, cout): lib.lib.v2e_conv3x3_tile_w(b, H // 2, W // 2, cout)
             for b in (1, CAPACITY) for cout in (C, 2 * C, 4 * C)}
    say(f"[build] K1/K2 float32 conv: tile width (8 rows) by (B, cout) at {H // 2}x{W // 2}: "
        f"{tiles}; dynamic shared memory per block "
        f"{ {tw: lib.lib.v2e_conv3x3_smem_bytes(tw) for tw in (8, 16, 32)} } B by tile width")
    smem = {cout: lib.lib.v2e_conv3x3_tc_smem_bytes(cout) for cout in (C, 2 * C, 4 * C)}
    say(f"[build] K1/K2 bfloat16 (tensor cores) conv dynamic shared memory per block: "
        f"cout={C} {smem[C]} B, cout={2 * C} {smem[2 * C]} B, cout={4 * C} {smem[4 * C]} B "
        f"(chunks of at most 128 output channels)")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[tf32] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      ista_impl="cuda")
    weights = init_cista_lstc(torch.Generator().manual_seed(args.seed), cfg, device="cuda")

    # 3. K1 against its plain version at the flagship shape
    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = ista_inputs(torch.Generator().manual_seed(args.seed), dtype, weights)
        got = ista_loop(*inputs, depth=DEPTH)
        want = ista_loop_plain(*inputs, depth=DEPTH)
        torch.cuda.synchronize()
        err, ok = within(got, want, TOL[dtype])
        say(f"[k1] ista_loop {DNAME[dtype]} B={CAPACITY} {H // 2}x{W // 2} C={C} depth={DEPTH}: "
            f"max_abs_err={err:.3e} "
            f"(tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got.float()).all()):
            fail(f"K1 disagrees with its plain version in {DNAME[dtype]}")
        k1[dtype] = {"inputs": inputs, "max_abs_err": err}

    # 4. the slice on the card
    cfg_plain = dataclasses.replace(cfg, ista_impl="plain")
    packets = synthetic_packets(np.random.default_rng(args.seed), 7 * 4, "cuda")

    def voxelize(packet):
        t, x, y, p, n = packet
        grid = events_to_voxel_grid(t, x, y, p, n, num_bins=NB, width=W, height=H)
        return event_preprocess(grid).permute(1, 2, 0)  # [H, W, num_bins]

    # per step: (stream -> request index); "swap" detaches stream 5, attaches 6
    schedule = [{s: 0 for s in range(6)}, {s: 1 for s in range(6)}, "swap",
                {**{s: 2 for s in range(5)}, 6: 0}, {**{s: 3 for s in range(5)}, 6: 1},
                {6: 2}, {6: 3}]

    def serve(pool, voxels=None, counter=ista_loop):
        """Run the schedule; returns {(stream, req): rec [H, W]}, the voxel
        grids served and the launches of ``counter`` in each pool step."""
        sid = {s: pool.attach() for s in range(6)}
        recs, voxels, launches = {}, dict(voxels or {}), []
        for entry in schedule:
            if entry == "swap":
                pool.detach(sid.pop(5))
                sid[6] = pool.attach()
                continue
            for s, r in entry.items():
                if (s, r) not in voxels:
                    voxels[(s, r)] = voxelize(packets[4 * s + r])
            before = counter.launches
            out = pool.step({sid[s]: voxels[(s, r)] for s, r in entry.items()}, fetch=False)
            launches.append(counter.launches - before)
            for s, r in entry.items():
                recs[(s, r)] = out[sid[s]].float().clone()
        torch.cuda.synchronize()
        return recs, voxels, launches

    main_launches, layers_recs, served = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        ista_loop.launches = 0
        recs, voxels, per_step = serve(StreamPool(cfg, weights, CAPACITY, dtype))
        main_launches[dtype] = ista_loop.launches
        layers_recs[dtype], served[dtype] = recs, voxels
        stacked = torch.stack(list(recs.values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        say(f"[pool] {DNAME[dtype]}: {len(recs)} reconstructions of {H}x{W} from 7 streams in "
            f"{len(per_step)} pool steps; finite={finite} in[0,1]={in_range}; K1 launches "
            f"per step {per_step} (want {2 * DEPTH} each), total {main_launches[dtype]}")
        if not (finite and in_range):
            fail(f"pool reconstructions in {DNAME[dtype]} are not finite values in [0, 1]")
        if any(n != 2 * DEPTH for n in per_step):
            fail("K1's launch counter did not rise by 2 x depth per pool step")
        ref, _, _ = serve(StreamPool(cfg_plain, weights, CAPACITY, dtype), voxels)
        err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
        say(f"[pool] {DNAME[dtype]}: kernel vs plain ISTA on the same voxel grids: "
            f"max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K1 disagrees with the plain ISTA in {DNAME[dtype]}")

    # 4b. K2 against its plain version at the flagship shape
    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        core_args = core_inputs(torch.Generator().manual_seed(args.seed), dtype, weights)
        got = cista_core(*core_args, depth=DEPTH)
        want = cista_core_plain(*core_args, depth=DEPTH)
        torch.cuda.synchronize()
        errs = {name: within(g, w_, TOL[dtype])
                for name, g, w_ in zip(("rec_h", "z", "cell", "dg_h", "dg_c"), got, want)}
        ok = (all(o for _, o in errs.values()) and got[0] is got[3]
              and all(bool(torch.isfinite(g.float()).all()) for g in got))
        err = max(e for e, _ in errs.values())
        say(f"[k2] cista_core {DNAME[dtype]} B={CAPACITY} {H // 2}x{W // 2} C={C} depth={DEPTH}: "
            f"max_abs_err {', '.join(f'{n} {e:.3e}' for n, (e, _) in errs.items())} "
            f"(tol {TOL[dtype]} + {TOL[dtype]} |ref|) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"K2 disagrees with its plain version in {DNAME[dtype]}")
        k2[dtype] = {"inputs": core_args, "max_abs_err": err}

    # 4c. the K2 slice: the pool with core_impl="cuda" on the same voxel grids
    cfg_k2 = dataclasses.replace(cfg, core_impl="cuda")
    k2_launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        cista_core.launches = ista_loop.launches = 0
        recs, _, per_step = serve(StreamPool(cfg_k2, weights, CAPACITY, dtype), served[dtype],
                                  counter=cista_core)
        k2_launches[dtype], k1_in_k2 = cista_core.launches, ista_loop.launches
        stacked = torch.stack(list(recs.values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        say(f"[pool-k2] {DNAME[dtype]}: {len(recs)} reconstructions, core_impl=cuda; "
            f"finite={finite} in[0,1]={in_range}; K2 launches per step {per_step} (want "
            f"{launches_per_call(DEPTH)} each), total {k2_launches[dtype]}; K1 launches {k1_in_k2} "
            f"(want 0: K2 launches its ISTA convs itself)")
        if not (finite and in_range):
            fail(f"K2 pool reconstructions in {DNAME[dtype]} are not finite values in [0, 1]")
        if any(n != launches_per_call(DEPTH) for n in per_step) or k1_in_k2:
            fail("K2's launch counter did not rise by 7 + 2 x depth per pool step, or K1 ran")
        ref, _, _ = serve(StreamPool(dataclasses.replace(cfg, core_impl="plain"), weights,
                                     CAPACITY, dtype), served[dtype])
        err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
        say(f"[pool-k2] {DNAME[dtype]}: K2 vs its plain version (core_impl=plain) on the same "
            f"voxel grids: max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K2 disagrees with the plain K2 in {DNAME[dtype]}")
        err, ok = within(stacked, torch.stack([layers_recs[dtype][k] for k in recs]),
                         K2_VS_LAYERS_TOL)
        say(f"[pool-k2] {DNAME[dtype]}: K2 vs the layers pool (K1 and cuDNN, phase 4): "
            f"max_abs_err={err:.3e} (tol atol=rtol={K2_VS_LAYERS_TOL}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K2 disagrees with the layers pool in {DNAME[dtype]}")

    # 6. K3 against its plain version
    from v2e2v_tpu_torch.models.emulator import emulate_pack
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig, v2e2v_forward
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters, emulator_iters_plain

    t_phase = time.perf_counter()
    k3_errs = check_k3(emulator_iters, emulator_iters_plain, args.seed)
    say(f"[phase] K3 checks {time.perf_counter() - t_phase:.1f} s")

    # 7. the V2E2V slice: runs A (kernels, explicit draws), B (plain), C (the
    # default path, internal randoms), D (plain, internal randoms)
    t_phase = time.perf_counter()
    counters = (emulator_iters, ista_loop)
    cfg_c = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS))
    if (cfg_c.emulator.iters_impl, cfg_c.cista.ista_impl) != ("cuda", "cuda"):
        fail(f"from_flags does not take the kernels: {cfg_c}")
    cfg_b = V2E2VConfig(dataclasses.replace(cfg_c.cista, ista_impl="plain"),
                        dataclasses.replace(cfg_c.emulator, iters_impl="plain"))
    video = hfr_video(args.seed, "cuda")
    want_launches = [N_FRAMES - 1, 2 * DEPTH]
    outs_a, per_pack_a = run_v2e2v(cfg_c, weights, video, args.seed, counters,
                                   explicit_shot=True)
    outs_b, per_pack_b = run_v2e2v(cfg_b, weights, video, args.seed, counters,
                                   explicit_shot=True)
    last = {}
    for c in counters:
        c.launches = 0
    emulator_iters.launches_by_shot = dict.fromkeys(emulator_iters.launches_by_shot, 0)
    outs_c, per_pack_c = run_v2e2v(cfg_c, weights, video, args.seed + 1, counters, last)
    main_k3, main_k1 = dict(emulator_iters.launches_by_shot), ista_loop.launches
    outs_d, per_pack_d = run_v2e2v(cfg_b, weights, video, args.seed + 1, counters)
    say(f"[v2e2v] {PACKS} packs of {N_FRAMES} frames, batch {CAPACITY}, {H}x{W}, new sequence "
        f"at pack {RESET_AT}; K3, K1 launches per pack: run A {per_pack_a}, run B (plain) "
        f"{per_pack_b}, run C (default path) {per_pack_c} (want {want_launches} each), "
        f"run D (plain) {per_pack_d}")
    if any(n != want_launches for n in per_pack_a + per_pack_c) or any(
            n != [0, 0] for n in per_pack_b + per_pack_d):
        fail("K3's counter did not rise by N - 1 and K1's by 2 x depth per pack")
    ev_a = [int(o.num_events) for o in outs_a]
    ev_b = [int(o.num_events) for o in outs_b]
    ev_c = [int(o.num_events) for o in outs_c]
    vox_err, vox_ok = within(torch.stack([o.event_voxel_grids for o in outs_a]),
                             torch.stack([o.event_voxel_grids for o in outs_b]), V2E2V_TOL)
    rec_a = torch.stack([o.reconstruction for o in outs_a])
    rec_err, rec_ok = within(rec_a, torch.stack([o.reconstruction for o in outs_b]), V2E2V_TOL)
    say(f"[v2e2v] run A vs run B: num_events {ev_a} vs {ev_b} equal={ev_a == ev_b}; voxel "
        f"max_abs_err={vox_err:.3e}, reconstruction max_abs_err={rec_err:.3e} "
        f"(tol atol=rtol={V2E2V_TOL}) {'pass' if ev_a == ev_b and vox_ok and rec_ok else 'FAIL'}")
    if not (ev_a == ev_b and vox_ok and rec_ok):
        fail("V2E2V through K3 and K1 disagrees with the plain versions")
    rec_c = torch.stack([o.reconstruction for o in outs_c])
    finite = bool(torch.isfinite(rec_c).all())
    in_range = bool(((rec_c >= 0) & (rec_c <= 1)).all())
    close = all(abs(c - a) <= 0.01 * a for a, c in zip(ev_a, ev_c))
    say(f"[v2e2v] run C (from_flags, internal randoms): num_events {ev_c}, within 1% of run "
        f"A's={close}; reconstructions finite={finite} in[0,1]={in_range} "
        f"{'pass' if close and finite and in_range else 'FAIL'}")
    if not (close and finite and in_range and min(ev_a) > 0):
        fail("the default V2E2V path gave bad reconstructions or event counts")
    ev_d = [int(o.num_events) for o in outs_d]
    vox_err, vox_ok = within(torch.stack([o.event_voxel_grids for o in outs_c]),
                             torch.stack([o.event_voxel_grids for o in outs_d]), V2E2V_TOL)
    rec_err, rec_ok = within(rec_c, torch.stack([o.reconstruction for o in outs_d]), V2E2V_TOL)
    ok = ev_c == ev_d and vox_ok and rec_ok
    say(f"[v2e2v] run C vs run D (plain, internal randoms): num_events {ev_c} vs {ev_d} "
        f"equal={ev_c == ev_d}; voxel max_abs_err={vox_err:.3e}, reconstruction "
        f"max_abs_err={rec_err:.3e} (tol atol=rtol={V2E2V_TOL}) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the default V2E2V path disagrees with the plain versions")
    say(f"[phase] V2E2V runs {time.perf_counter() - t_phase:.1f} s")

    # 5. times
    def k1_times(inputs, dtype, label):
        """K1 per call as issued and on the device, the host's time to issue
        it, its plain version, cuDNN's D + P convs x depth and its bound."""
        # ms: per call as the host issues them (the wrapper's host work
        # included); device_ms: the launches back to back on the card. In
        # bfloat16 K1's launches take about as long on the card as the host
        # takes to issue them, so the two differ
        ms = time_ms(lambda: ista_loop(*inputs, depth=DEPTH))
        dev_ms, host_ms = issue_ms(lambda: ista_loop(*inputs, depth=DEPTH))
        plain_ms = time_ms(lambda: ista_loop_plain(*inputs, depth=DEPTH))
        x1, z, dw, db, pw, pb, _ = inputs
        x1c, zc = x1.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2)  # channels_last views
        dwc = dw.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        pwc = pw.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        dbc, pbc = db.to(dtype), pb.to(dtype)

        def library():
            torch.nn.functional.conv2d(zc, dwc, dbc, padding=1)
            torch.nn.functional.conv2d(x1c, pwc, pbc, padding=1)

        library_ms = DEPTH * time_ms(library)
        library_dev_ms = DEPTH * device_ms(library)
        bound_ms, bound_by = ista_bound_ms(inputs, DEPTH)
        say(f"[time] K1 {DNAME[dtype]}{label}: kernel {ms:.4f} ms/call as issued, {dev_ms:.4f} "
            f"ms on the device, {host_ms:.4f} ms of the host's to issue it; plain "
            f"{plain_ms:.4f} ms; library (F.conv2d D + P, zero padding, channels_last) x depth "
            f"{library_ms:.4f} ms as issued, {library_dev_ms:.4f} ms on the device; bound "
            f"{bound_ms:.4f} ms ({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
            f"{PEAK_BYTES / 1e12} TB/s) = {100 * bound_ms / ms:.1f}% of bound as issued, "
            f"{100 * bound_ms / dev_ms:.1f}% on the device")
        return {"ms": ms, "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "library_device_ms": library_dev_ms}

    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        inputs = k1[dtype]["inputs"]
        times = k1_times(inputs, dtype, "")
        ms = times["ms"]
        entries.append({
            "name": f"ista_loop ({DNAME[dtype]})", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": main_launches[dtype],
            "max_abs_err": k1[dtype]["max_abs_err"], **times,
            "tensor_cores": dtype == torch.bfloat16, "design": DESIGN[dtype],
        })
        if dtype == torch.float32:  # the CLIs' batch 1, on the 8x8 and 8x16 tiles
            one = ista_inputs(torch.Generator().manual_seed(args.seed + 1), dtype, weights, b=1)
            err, ok = within(ista_loop(*one, depth=DEPTH), ista_loop_plain(*one, depth=DEPTH),
                             TOL[dtype])
            say(f"[k1] ista_loop float32 B=1 {H // 2}x{W // 2} C={C} depth={DEPTH}: "
                f"max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
            if not ok:
                fail("K1 disagrees with its plain version in float32 at B = 1")
            entries[-1]["batch1"] = {"max_abs_err": err, **k1_times(one, dtype, " B=1")}

        core_args = k2[dtype]["inputs"]
        k2_ms = time_ms(lambda: cista_core(*core_args, depth=DEPTH))
        k2_dev_ms, k2_host_ms = issue_ms(lambda: cista_core(*core_args, depth=DEPTH))
        k2_plain_ms = time_ms(lambda: cista_core_plain(*core_args, depth=DEPTH))
        _, x1, z, cell, dg_h, dg_c = core_args
        state = CistaState(cell=cell, z=z, dg=(dg_h, dg_c))
        params_dt = {k: v.to(dtype) for k, v in weights.items()}
        layers_ms = time_ms(lambda: half_res_core(params_dt, cfg, x1, state))
        layers_dev_ms = device_ms(lambda: half_res_core(params_dt, cfg, x1, state))
        cudnn_ms = time_ms(lambda: half_res_core(params_dt, cfg_plain, x1, state))
        cudnn_dev_ms = device_ms(lambda: half_res_core(params_dt, cfg_plain, x1, state))
        bound_ms, bound_by = core_bound_ms(core_args, DEPTH)
        say(f"[time] K2 {DNAME[dtype]}: kernel {k2_ms:.4f} ms/call as issued, {k2_dev_ms:.4f} "
            f"ms on the device, {k2_host_ms:.4f} ms of the host's to issue it "
            f"({launches_per_call(DEPTH)} launches); plain {k2_plain_ms:.4f} "
            f"ms; the layers core it replaces (ConvLSTC, K1, Dg conv, ConvLSTM) "
            f"{layers_ms:.4f} ms as issued, {layers_dev_ms:.4f} ms on the device; the same "
            f"with the plain ISTA (cuDNN convs only) {cudnn_ms:.4f} / {cudnn_dev_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} "
            f"TFLOP/s) = {100 * bound_ms / k2_ms:.1f}% of bound as issued, "
            f"{100 * bound_ms / k2_dev_ms:.1f}% on the device")
        entries.append({
            "name": f"cista_core ({DNAME[dtype]})", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": k2_launches[dtype],
            "max_abs_err": k2[dtype]["max_abs_err"], "ms": k2_ms, "device_ms": k2_dev_ms,
            "host_ms": k2_host_ms, "plain_ms": k2_plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None, "layers_core_ms": layers_ms,
            "layers_core_device_ms": layers_dev_ms, "cudnn_core_ms": cudnn_ms,
            "cudnn_core_device_ms": cudnn_dev_ms,
            "tensor_cores": dtype == torch.bfloat16, "design": DESIGN[dtype],
            "note": "no single PyTorch call computes the core; layers_core_ms is the path "
                    "it replaces (cuDNN convs and K1), cudnn_core_ms that path with cuDNN "
                    "convs only",
        })

        vox = {i: voxelize(packets[i]) for i in range(CAPACITY)}
        step_times = {"layers": [], "cuda": []}
        peak = {}
        for impl in ("layers", "cuda", "cuda", "layers"):  # in turns
            pool = StreamPool(dataclasses.replace(cfg, core_impl=impl), weights, CAPACITY, dtype)
            sids = [pool.attach() for _ in range(CAPACITY)]
            torch.cuda.reset_peak_memory_stats()
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pool.step({sid: vox[i] for i, sid in enumerate(sids)}, fetch=False)
                torch.cuda.synchronize()
                if i >= 2:
                    step_times[impl].append(1e3 * (time.perf_counter() - t0))
            peak[impl] = max(peak.get(impl, 0.0), torch.cuda.max_memory_allocated() / 2**20)
            del pool
        front_ms = time_ms(lambda: voxelize(packets[0]))
        step_ms = {k: float(np.median(v)) for k, v in step_times.items()}
        say(f"[time] pool {DNAME[dtype]} capacity {CAPACITY}, all active, core_impl layers / "
            f"cuda in turns: step {step_ms['layers']:.3f} / {step_ms['cuda']:.3f} ms (median "
            f"of {len(step_times['cuda'])} each, host clock, min "
            f"{min(step_times['layers']):.3f} / {min(step_times['cuda']):.3f}), "
            f"{CAPACITY * 1e3 / step_ms['layers']:.1f} / {CAPACITY * 1e3 / step_ms['cuda']:.1f} "
            f"reconstructions/s; K1 share of the layers step {100 * ms / step_ms['layers']:.1f}%, "
            f"K2 share of the cuda step {100 * k2_ms / step_ms['cuda']:.1f}%; front end "
            f"(voxelise + normalise one packet) {front_ms:.4f} ms; max_memory_allocated "
            f"{peak['layers']:.1f} / {peak['cuda']:.1f} MiB")

    # 8. K3 and V2E2V times, on the main path's inputs
    t_phase = time.perf_counter()
    frames5, ts5 = video[-1]
    for internal in (True, False):
        x, kw = main_path_k3_inputs(cfg_c.emulator, last["state"].emulator, frames5, ts5, internal)
        ms = device_ms(lambda: emulator_iters(**x, **kw))
        wrapper_ms = time_ms(lambda: emulator_iters(**x, **kw), warmup=3, iters=20)
        plain_ms = time_ms(lambda: emulator_iters_plain(**x, **kw), warmup=1, iters=3)
        bound_ms, bound_by = k3_bound_ms(x, kw)
        mode = "internal" if internal else "explicit"
        say(f"[time] K3 {mode} (main-path inputs, num_iters {x['num_iters'].tolist()}): kernel "
            f"{ms:.4f} ms/call on the device (launches back to back), {wrapper_ms:.4f} ms/call "
            f"through the wrapper as the host issues them; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}) = {100 * bound_ms / ms:.1f}% of bound; library: "
            f"none (no PyTorch call computes the loop)")
        entries.append({
            "name": f"emulator_iters ({mode} rng)", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": main_k3[mode],
            "max_abs_err": k3_errs[mode], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            **({} if internal else {"note": "explicit-draw instance, not on the main path: "
                                    "launched by the exact checks and run A"}),
        })
    noise = torch.Generator(device="cuda").manual_seed(args.seed)
    state4 = last["state"].emulator
    emu_ms = time_ms(lambda: emulate_pack(cfg_c.emulator, state4, frames5, ts5, noise),
                     warmup=2, iters=10)
    torch.cuda.reset_peak_memory_stats()
    step_times = []
    for rep in range(3):
        state = None
        for p, (frames, ts) in enumerate(video):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state = v2e2v_forward(weights, cfg_c, frames, ts, None if p == RESET_AT else state,
                                       noise)
            torch.cuda.synchronize()
            if rep:
                step_times.append(1e3 * (time.perf_counter() - t0))
    fwd_ms = float(np.median(step_times))
    say(f"[time] V2E2V default path, batch {CAPACITY}: emulate_pack {emu_ms:.3f} ms/pack "
        f"as the host issues it (CUDA events); v2e2v_forward {fwd_ms:.3f} ms/pack (median of {len(step_times)}, host "
        f"clock, min {min(step_times):.3f}), {CAPACITY * 1e3 / fwd_ms:.1f} reconstructions/s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    main_launches_line = {"K3 (run C)": main_k3, "K1 (run C)": main_k1}
    say(f"[v2e2v] main path launches, counts set to 0 before run C: {main_launches_line}")
    if main_k3["internal"] == 0 or main_k1 == 0:
        fail("the main path did not launch K3 and K1")
    say(f"[phase] K3 and V2E2V times {time.perf_counter() - t_phase:.1f} s")

    # 9-13: the E2V CLI at full width, the V2E2V CLI, raw-event generation,
    # CISTA-TC, training; their datasets and outputs stay for phase 18
    shared = Path(tempfile.mkdtemp(prefix="v2e2v_slice5_"))
    try:
        cli_k1 = cli_phase(args.seed, cfg, smi, shared / "cli")
        hfr = v2e2v_cli_phase(args.seed, smi, shared)
        raw_rows = raw_phase(args.seed, smi, shared, hfr["data"])
        tc_rows = tc_phase(args.seed, smi, shared, serve, served)
        trained = train_phase(args.seed, smi, shared)

        # 15. the fused full-resolution path, parity IO, the fused V2E2V run C
        fused_rows = fused_phase(args.seed, smi, cfg, weights, serve, served, video, cfg_c,
                                 outs_c)

        # 16. int8 inference: K4, the int8 pools, the E2V CLI with --quant
        tmp = Path(tempfile.mkdtemp(prefix="v2e2v_int8_"))
        try:
            int8 = int8_phase(args.seed, smi, tmp, serve, served, layers_recs, weights)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        entries += int8["entries"]

        # 17. Super-SloMo upsampling: the UNets and backwarp, the upsampler, both CLIs
        tmp = Path(tempfile.mkdtemp(prefix="v2e2v_slomo_"))
        try:
            slomo_rows = upsampling_phase(args.seed, smi, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # 18. profiling and the data axis: one rank over NCCL, two over gloo,
        # the pool over two groups, the trainers' trace and NaN stop, the
        # evaluation CLIs in a world of one
        dist_rows = distributed_phase(args.seed, smi, shared, serve, served, layers_recs,
                                      weights, cfg, cli_k1, hfr)

        # 19. the spatial axis: the E2V steps on (1, 2) and (2, 2), the trainer
        # with --mesh_spatial 2, against one process
        spatial_rows = spatial_phase(args.seed, smi, shared)

        # 20. JPEG frames: the fixtures against cv2's hashes, both evaluation
        # CLIs over JPEG frames against their PNG twin
        jpeg_rows = jpeg_phase(args.seed, smi, shared / "jpeg", shared / "cli" / "model.pth.tar",
                               hfr["model"])

        # 21. video files: the fixture clips against the JAX readers' records,
        # the V2E2V CLI with --reader_type video against its PNG twin
        video_rows = video_phase(args.seed, smi, shared / "video", hfr["model"])

        # 22. every still-frame format: the fixtures against cv2's hashes, both
        # evaluation CLIs and the V2E2V trainer over the mixed folder against
        # its PNG twin
        image_rows = image_phase(args.seed, smi, shared / "image", shared / "cli" /
                                 "model.pth.tar", hfr["model"], trained["e2v_ckpt"])

        # 23. LPIPS: the distance card against CPU, the E2V CLI and both
        # trainers with V2E2V_LPIPS_WEIGHTS set
        lpips_rows = lpips_phase(args.seed, smi, shared / "lpips", shared / "cli",
                                 trained["e2v_ckpt"], cfg)

        # 24. MPEG-4 Part 2: the fixture clips against the JAX readers' records,
        # the V2E2V CLI with --reader_type video over the flagship MP4 against
        # its PNG twin
        mpeg4_rows = mpeg4_phase(args.seed, smi, shared / "mpeg4", hfr["model"])

        # 25. Matroska and WebM: the fixture clips against the JAX readers'
        # records, the V2E2V CLI with --reader_type video over the flagship
        # WebM against its PNG twin
        mkv_rows = webm_phase(args.seed, smi, shared / "mkv", hfr["model"], MKV_FIXTURES,
                              Vp8Decoder, "Matroska/WebM (VP8)", "mkv", 14)

        # 26. VP9 in WebM and Matroska: the fixture clips against the JAX
        # readers' records, the V2E2V CLI with --reader_type video over the
        # flagship VP9 WebM against its PNG twin
        vp9_rows = webm_phase(args.seed, smi, shared / "vp9", hfr["model"], VP9_FIXTURES,
                              Vp9Decoder, "VP9", "vp9", 9)

        # 27. MPEG-1 and MPEG-2: the fixture clips against the JAX readers'
        # records, the V2E2V CLI with --reader_type video over the flagship
        # .mpg against its PNG twin
        mpeg12_rows = mpeg12_phase(args.seed, smi, shared / "mpeg12", hfr["model"])

        # 28. raw and PNG video, and the decoders under cv2's other tags and
        # containers: the fixture clips against the JAX readers' records, the
        # stages of a 960x720 PNG, I420 and Y800 frame, the V2E2V CLI with
        # --reader_type video over the PNG flagship against its PNG twin
        png_rows = rawvideo_phase(args.seed, smi, shared / "rawvideo", hfr["model"])

        # 29. H.263 and Sorenson H.263: the fixture clips against the JAX
        # readers' records, the stages of a 960x720 FLV and a 704x576 H.263
        # picture, the V2E2V CLI with --reader_type video over the flagship
        # FLV against its PNG twin
        h263_rows = h263_phase(args.seed, smi, shared / "h263", hfr["model"])

        # 30. ASF and the MS-MPEG-4 family: the fixture clips against the JAX
        # readers' records, the stages of a 960x720 WMV2 and MS-MPEG-4 v3
        # picture, the V2E2V CLI with --reader_type video over the flagship
        # .wmv against its PNG twin
        wmv_rows = wmv_phase(args.seed, smi, shared / "wmv", hfr["model"])

        # 31. interlaced MPEG-2: the fixture clips against the records, the
        # stages of a 720x576 field-picture and frame-picture frame, the V2E2V
        # CLI with --reader_type video over the flagship .vob against its PNG twin
        mpeg2i_rows = mpeg2i_phase(args.seed, smi, shared / "mpeg2i", hfr["model"])
    finally:
        shutil.rmtree(shared, ignore_errors=True)

    # 14. kernels, then the result line
    # each path's launches by row, every count set to 0 just before the path
    paths = {"v2e2v_cli_launches": hfr["rows"], "raw_launches": raw_rows,
             "tc_pool_launches": tc_rows, "e2v_train_launches": trained["e2v"],
             "v2e2v_train_launches_per_step": trained["v2e2v"], **fused_rows, **int8["rows"],
             **slomo_rows, **dist_rows, **spatial_rows, **jpeg_rows, **video_rows, **image_rows,
             **lpips_rows, **mpeg4_rows, **mkv_rows, **vp9_rows, **mpeg12_rows, **png_rows,
             **h263_rows, **wmv_rows, **mpeg2i_rows}
    for e in entries:
        if e["name"].startswith("ista_loop"):
            e.update(cli_k1[torch.float32 if "float32" in e["name"] else torch.bfloat16])
        e.update({key: rows.get(e["name"], 0) for key, rows in paths.items()})
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
