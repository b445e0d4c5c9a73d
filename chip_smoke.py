#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Run from the repository root. Phases, each printing a line (`[n/28]`, and
`[29/29]`, `[30/30]` for the last two):
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
     for matmuls and cuDNN convolutions.
  2. build: compiles the hand-written kernels from csrc/, one nvcc process
     per source, all started together (seconds printed).
  3. eval kernels (K1) vs plain: full-width 8x256 NeRF weights from a numpy seed,
     through convert.py and the kernel pack; each kernel against its plain
     PyTorch version at N = 1,000,003 points in the Blender box (|x| <= 4),
     max |delta| <= 2e-3 + 1e-2 |ref| (bf16 operands and float32
     accumulation on both sides, only the summation order differs); then
     the same check and each kernel's time beside the plain version's at the
     eval path's shapes (32768 rays x 64 sigma points; 32768 x 192 full
     points, one direction per ray): TFLOP/s and share of the bound, the
     registers, spill bytes and stack of both instantiations from the
     build's `-Xptxas -v` log with their dynamic shared memory, the earlier
     kernel's times (EARLIER_K1_MS, another call), and as a reading only (never
     on the path) the same layer products as a chain of bf16 `torch.matmul`
     calls at the same shapes.
  4. eval path: 3 Blender-lego 800x800 frames (64 + 128 samples, chunk
     32768, white background) through the port eval's `make_renderer` with
     the fused renderer; checks finite outputs, rgb in [0, 1 + 1e-3], each
     K1 kernel launched at least chunks x frames times, and 2048 rays of the
     first frame against a CPU re-render on the plain field (atol 5e-3).
  5. training kernels (K2) vs plain, at the training step's shapes (1024
     random rays of a lego frame x 64 coarse points, and x 192 fine points,
     one direction per ray): the forward within the K1 tolerance; every
     gradient tensor of the backward within relative L2 1e-2 and every
     element within 5e-2 of the tensor's largest magnitude (bf16 operands
     and cotangents on both sides; a ReLU mask that flips with a
     neighbouring bf16 value moves single elements). Each kernel timed
     beside its plain version, coarse + fine shapes (one step's work); the
     forward also: its kernel's own device ms (`torch.profiler`) beside its
     time before the redesign (EARLIER_K2_MS, another call), its registers,
     spill bytes and dynamic shared memory from the build's `-Xptxas -v`
     log, and as a reading only (never on the path) its products as a chain
     of bf16 `torch.matmul` calls; the
     backward also: each of its three kernels' own device ms (tile, wgrad,
     reduce; `torch.profiler`) beside their times before the redesign
     (EARLIER_K2_MS, another call), their registers, spill bytes and
     dynamic shared memory from the build's `-Xptxas -v` log, the stash's
     bytes a point (written by the tile kernel, read by the weight
     gradients) and the byte floor they imply beside the operations bound
     (a reading), and as a reading only (never on the path) the backward's
     products (recompute, dgrad, weight gradients, both shapes) as a chain
     of bf16 `torch.matmul` calls.
  6. training path: (a) one `NeRFSystem.train_step` on each backend
     (`fused`, `jnp`) from the same numpy-seeded weights and batch at
     perturb 0, noise 0: losses within a relative 2e-2; (b) 60 steps of the
     `fused` backend at opt.py's defaults (1024 rays, 64 + 128 samples,
     perturb 1, noise_std 1, Adam 5e-4) from another seed, on rays of the
     lego cameras with phase 4's renders of the seed-0 field as targets:
     every loss finite, the mean of the last 10 below the mean of the first
     10, each K2 kernel launched at least twice per step; ms per step, and
     the `jnp` backend's ms per step on the same batches; (c) grouped steps
     (`train_scan_batches`, one captured CUDA graph of GROUP_STEPS = 10
     steps) on `fused` and on `jnp`, from (b)'s weights and batches, against
     as many eager `train_step`s from the same weights, seed and batches:
     each step's loss within a relative GROUP_LOSS_RTOL and each
     parameter's change from the start within GROUP_CHANGE_GAP of the
     eager steps' (`change_gap`: the norm of the difference of the two
     changes over the norm of the eager change), after the first group and
     again after four replays on the next batches, the largest differences
     printed. Both run the same device-scalar update and the same kernels,
     and read bit-equal on an H100; the bars leave room for a last bit
     that a reduction might order otherwise, and sit three orders below
     the control, which must fail them (the eager run without its last
     update reads 0.26-0.28); K2's wrappers called 2 GROUP_STEPS + 2 times (twice a step at
     capture, twice in the warm-up step before it) and not at all by a
     replay; the capture's seconds and the first group's (warm-up,
     capture, replay), the peak device memory of the eager steps, of a
     group of 1 and of GROUP_STEPS steps, and ms per step grouped and eager
     in turns (eager, grouped, grouped, eager, twice). K2's launches in the
     kernels line count (b): a call at capture records its kernels into the
     graph and launches nothing, and a replay calls no wrapper.
  7. a field with empty space: an 8x256 pair whose weights draw a ball
     (density 15 (1 - |x| / 0.6) inside radius 0.6, about one colour; every weight
     with Gaussian noise from a numpy seed, `ball_nerf_params`). Its exact
     frames (the fused renderer, 64 + 128) must hold rays of opacity
     < 0.01. Then the eval
     CLI's `setup_fast_proxy` at its defaults: the proxy distilled (500
     steps, batch 65,536, hidden 96) and the scene box, written to the
     `<ckpt>.proxy.msgpack` cache and read back (seconds of each printed).
  8. fast-path kernels vs plain at the path's shapes: K3 over the 640,000
     rays of a frame clipped to the box (select at C 32, K 16: depths within
     median |d| < 0.005 and 99th percentile < 0.05 of far - near; opacity
     prepass at C 16: median < 2e-3, max < 0.05); K3's own scores read back
     (`proxy_march_scores`) at both C, each within `proxy_score_bar` of the
     plain scores (the share that differ and the largest |d| printed), the
     plain scores with b1 rounded to bf16 beyond that bar (a control: the
     bar must reject such a kernel), and the plain march on the kernel's
     scores bit-equal to both kernels' outputs; K3 select at one 32,768-ray
     chunk of the frame (the path's shape: the JSON line's time) bit-equal
     to the same rays in the frame's launch, timed beside that launch over
     the whole frame, each beside the
     CUDA-core kernel's earlier times (EARLIER_K3_MS, another call; the
     chunk's time queued behind a device-side sleep, as K5's, and
     unqueued: it is about as long as its wrapper's host time); both
     K3 kernels' registers, spills, stack (`-Xptxas -v`) and dynamic shared
     memory; the SASS digests of K3's select and opacity instantiations at
     width 96 beside the tree's before K6 joined their source
     (K3_SASS_DIGESTS, a reading that K3's code did not move); K4 at N =
     1,000,003 and
     at one chunk's survivors (32768 rays x 16, one direction per ray) and
     coarse points (x 64): rgb atol 2e-2, sigma atol 5e-2 + rtol 2e-2, and
     the int8 layer inputs that round apart counted; K6 (the TOPK epilogue
     of csrc/proxy_march.cu) at 65,536 rays of the frame, C 64, K 16: its
     scores read back (`proxy_select_scores`) within `proxy_score_bar` of
     the plain scores (the share that differ and the largest |d| / bar
     printed), the plain selection on them equal to its depths bit for bit
     and in order, and where a ray keeps another set than the plain
     version every candidate swapped across the cut a near tie within the
     two bars' sum (`cut_swaps`; the share of such rays printed); its
     registers, spills, stack and dynamic shared memory at C 64, and the
     CUDA-core kernel's time (EARLIER_K6_MS, another call). Each timed
     beside its plain version. K4 also: TOP/s and share of the bound, its earlier
     kernel's times (EARLIER_K4_MS, another call), K1 on the bf16 pack of
     the same field at the same points in turns with it, the registers,
     spills, stack and dynamic shared memory of both instantiations, the
     SASS instructions of a hidden layer's epilogue (cuobjdump), and as a
     reading only (never on the path) the same trunk products as
     `torch._int_mm` calls.
  9. fast frames: 3 frames through the CLI's fast renderer at its defaults
     (C 32, K 16, pdf, mid, delta): finite, rgb in [0, 1 + 1e-3], K3 select
     and K1 full launched at least once per chunk per frame; 2048 rays of
     frame 0 against a CPU re-render on the plain versions (per output
     median |d| < 2e-3 and 99th percentile < 0.05 of max(1, max |ref|));
     latency, rays/s and the PSNR agreement with the exact frames (a
     reading, not a bar).
 10. `--fast_cull auto`: 5 frames; every ray equals the fast frame's value
     (atol 1e-6: the same kernels on the same rays) or is background (a
     culled block); the active fraction, the bypass and eps per frame.
 11. `--fast_field_dtype int8` on the fast and the fused renderer, two
     frames each: finite, K4 launched, rgb within 0.15 of the bf16 frame;
     their latencies beside the bf16 frames' (phases 7 and 9).
 12. `--fast_edge_refine 0.04`: one frame, finite; the refined-ray count.
 13. K6, which has no CLI caller: `proxy_select` over one frame's rays at C
     64, K 16 with the distilled proxy, every depth finite and in its ray's
     [near, far]; its time beside the tree's before the redesign
     (EARLIER_K6_FRAME_S, another call).
  Phases 14-17 drive EG3D exact eval (`eval_eg3d.py`'s defaults: planes 3 x
  32 x 256² from a 512-wide StyleGAN2, 64 + 64 samples, ray 0.1 -> 10,
  box_warp 15, chunk 4096) on the triplane gather kernel K5:
 14. weights: a full-width `eg3d_renderer` tree from a numpy seed
     (`numpy_eg3d_params`, `init_eg3d_renderer`'s shapes and distributions),
     saved as a msgpack checkpoint and read back by the CLI's `load_model`
     (`convert.eg3d_from_jax`); mapping + synthesis ms per frame.
 15. K5 vs plain on the frame's bf16 table: the 262,144 coarse points of one
     chunk of a 128² lego frame, all 2,097,152 points that frame samples
     (coarse and fine), and 262,144 random points within 1.05 x box_warp / 2
     (edges and beyond): 0 elements may differ; all three within 1e-5 of
     the table's largest magnitude of `F.grid_sample` on its float32 copy;
     at the chunk's shape the plain version's ms, and K5 and `F.grid_sample`
     (float32, and bf16 where it takes it) in turns over K5_ROUNDS rounds
     (library, kernel, kernel, library; each timing K5_REPS launches queued
     behind a device-side sleep, so that host launch time is not counted:
     K5 takes less time on the card than its wrapper on the host): each
     round with its kernel / float32 ratio, the medians, whether the
     kernel's median is below the float32 library's in every round
     (printed, not a gate), the route the table took (`launch_plan`: load
     width, threads per point, blocks), the route's registers and spill
     bytes from the build log, TB/s of the counted bytes (coordinates, the
     table's texels that the points read, each once, and the output) and
     the share of the bound; and K5 timed unqueued, as the other phases
     time their kernels.
 16. frames through the CLI's `make_renderer` with `--plane_sampler kernel`:
     3 of 128² (latency, rays/s, finite outputs, mean opacity_fine, K5
     launched twice per chunk), the same 3 through `gather` (every output
     within 1e-6 of the kernel frames: the same math on the same table),
     and one of 800² (157 chunks, 314 launches).
 17. 2048 rays of the first 128² frame against a CPU re-render on the
     card's table (atol 5e-3, as phase 4), and the card's float32 planes
     against a CPU float32 synthesis from the same weights (max |d| within
     1e-3 of the planes' largest magnitude; cuDNN TF32 is off, phase 1).
  Phases 18-20 drive the SIREN field and the semantic stack (`--mode d3`)
  at the published widths, weights from numpy seeds:
 18. SIREN steps: the 8x256 FiLM field with its mapping network (100 ->
     256 -> 256 -> 9 x 256 x 2) and learnable z, coarse + fine, 1024 rays
     of the lego cameras at 64 + 128 samples, perturb 1, noise 1, Adam 5e-4
     (`NeRFSystem(field_type='siren')`, the jnp backend): GROUP_STEPS eager
     `train_step`s and one group of as many on a captured graph from the
     same start, read as phase 6(c) (loss within GROUP_LOSS_RTOL, change
     gap within GROUP_CHANGE_GAP), with a control group whose last row of
     the scalar table has lr 0 (must exceed the gap); K2 never called; ms
     per step of eager steps and replays in turns; a replay under
     `torch.cuda.set_sync_debug_mode("error")`, where a host sync raises.
 19. d3 steps: NeRF 8x256 coarse + fine and PointNet (k 6, capacity
     8192), msenll, no_grad_on_nerf (`NeRF3DSystem`), the same reading,
     control and replay as phase 18; the NeRF parameters bit-unchanged and
     at least half of PointNet's tensors moved in both runs; then 3 eager
     steps with `--semantic_network conv3d` (the voxel UNet, res 32).
 20. d3 frames: the ball field of phase 7 with a numpy-seeded PointNet. One
     800² frame through `eval.py::make_semantic_renderer` on the fast
     renderer at the `--fast_*` defaults and `--cls_threshold 0` (after a
     warm-up frame): latency, this phase's own K3 select and K1 full
     launches (at least one per chunk), peak memory; the same frame with
     K3 select and K1 replaced by their plain versions on the card: class
     ids equal at every pixel whose plain top-two margin exceeds
     CLS_MARGIN, rgb, depth and opacity within phase 9's bars; a control,
     PointNet's conv4 columns rolled by one, must fail the class gate. One
     200² d3 exact frame (`render_rays_3d`, bf16 field operands) with its
     latency.
  Phases 21-22 drive EG3D training and the fast EG3D renderer:
 21. EG3D steps at the train CLI's `--mode eg3d` defaults (z = w = 512,
     StyleGAN2 4² -> 256², channel_base 32768, channel_max 512, 3 x 32
     planes, decoder 32 -> 64 -> 4; 1024 rays, 64 + 128 samples, ray 0.1 ->
     10, box_warp 15, Adam 5e-4 steplr; `train.py::build_system`), weights
     `numpy_eg3d_params` of another seed, on phase 16's rays with its
     renders as targets: EG3D_TRAIN_STEPS eager steps (every loss finite,
     the mean of the last EG3D_WINDOW below the first's), then GROUP_STEPS
     grouped steps on a captured graph against as many eager steps, read as
     phase 18 under `torch.use_deterministic_algorithms(True)` (loss within
     GROUP_LOSS_RTOL, change gap and `w_avg`'s own within GROUP_CHANGE_GAP,
     the lr-0 control), and again with the default algorithms, whose
     atomics (cuDNN weight gradients, the plain gather's scatter-add) make
     two eager runs differ: that reading is printed beside the spread of
     two eager runs, ungated; ms per step in turns, the capture's seconds,
     peak memory and a replay under sync debug mode for both.
 22. fast EG3D frames (`eval_eg3d.py::setup_fast_renderer` at the eval
     CLI's defaults: C 32, K 16, mid, delta, 500 x 32,768 distillation) of
     a scene with empty space (`eg3d_ball_params`: weights shaped so the
     planes carry a disk and the decoder a ball at the origin): the
     distillation's seconds; 3 frames of 128² and one of 800² in 4096-ray
     chunks (latency, rays/s, K3 select launches: one per chunk), the
     agreement of a 128² frame with the exact frame of the same scene; the
     same frames with K3 replaced by its plain versions on the card (rgb,
     depth, opacity within FAST_BARS, DEPTH_BARS, OPACITY_BARS), a control
     with the proxy's first-layer columns rolled by one (must fail); 5
     `--fast_cull auto` frames of one 800² pose (K3 opacity once per culled
     frame, the active fraction below 1 after the first frame, rays within
     the bars of the plain fast frame, depth where its opacity > 0.5).
  Phase 23 drives culled training (`--train_backend culled_fused`), 24-25
  the two mesh CLIs:
 23. culled training at opt.py's defaults (8x256, 1024 rays, C 32, n_sel 16
     + n_uni 8, perturb 1, noise 1, Adam 5e-4, the online proxy of hidden
     64) on phase 6's targets, from phase 6(b)'s trained fields and a fresh
     proxy: (a) K2 against its plain version at the culled step's shapes
     (1024 rays x 24 = 24,576 points, samples_per_dir 24, the coarse and
     the fine field; phase 5's bars), each timed over both launches beside
     its plain version and its bound at this shape;
     (b) one `culled_fused` and one `culled` step from the same weights and
     batch at perturb 0, noise 0: losses within TRAIN_LOSS_RTOL; (c)
     TRAIN_STEPS eager `culled_fused` steps: every loss finite, the
     photometric and the proxy loss each with the mean of its last 10 below
     its first 10, each K2 wrapper called exactly twice a step; ms per step
     beside the `fused` step's in turns; (d) GROUP_STEPS grouped steps
     against as many eager ones (`group_vs_eager`, phase 6(c)'s bars, the
     proxy in `change_gap`, the lr-0 control, K2 called twice a step at each
     capture), the capture's seconds, peak memory and ms per step in turns,
     and the grouped step against phase 6(c)'s grouped `fused` step.
 24. the NeRF mesh CLI's stages (`extract_color_mesh.py`: `load_fine`,
     `predict_sigma_grid`, marching tetrahedra, `fuse_colors`, the PLY) on
     phase 7's ball field at N_grid 256 and sigma threshold 5 (the ball
     peaks at 15; the CLI's default 20 gives no surface): the grid's
     seconds, MESH_CHECK grid points against the CPU's float32 plain field
     (atol 1e-3), marching's seconds, fusion colours from phase 7's three
     exact frames held in memory with their lego poses; the PLY written
     and read back: vertices and faces as written, more than 0, colours
     finite and in [0, 1].
 25. the EG3D mesh CLI's stages (`extract_color_mesh_eg3d.py`: `load_model`
     from a checkpoint of phase 22's ball scene, the planes synthesised
     once, `sigma_grid` at N_grid 256, the default threshold 10, marching
     tetrahedra, `--colorize`): each stage's seconds, MESH_CHECK interior
     grid points against the card's planes sampled and decoded on the CPU,
     and phase 24's PLY checks.
 26. data-parallel training on a one-rank NCCL group (file store):
     DP_STEPS `fused` and `culled_fused` steps (K2), DP_STEPS d3 msenll
     steps with a third of the labels ignored (the masked mean's count
     all-reduced, `DataParallel.mean_count`; a refused group fails here)
     and DP_EG3D_STEPS EG3D
     steps (deterministic algorithms), each eager and as one group on a
     CUDA graph (its all-reduce captured), through `DataParallel` against
     the non-distributed path from the same weights, seed and batches: bit
     for bit (a card that refuses the collective's capture refuses the
     grouped steps with an error, printed as such); the replica hash; ms
     per step of both paths, eager and grouped, in turns, beside phase 6's
     and 23's.
 27. sharded rendering on a mesh of the card twice (two slabs, a host
     thread and stream each: the route of every mesh) against one device:
     the 800² exact frame (fused, K1; the slab boundary falls on a chunk),
     the fast frame (K3 select, K1), 128² EG3D `render_sharded` (K5), each
     bit for bit, with both times in turns; the 800² exact frame on the
     plain fields (`--renderer exact`) under no_grad, within 1e-4 of one
     device, no slab recording an autograd graph, both peak memories;
     N_AUTO auto-cull frames in mesh mode (K3 opacity; per-shard budgets),
     every ray the fast frame's or background.
 28. tools and examples on the card: (a) the datasets' rays
     (`datasets/ray_utils.py`) of N_LEGO_CAMERAS Blender cameras at 800²
     through the C++ helper (`native/`, built with g++ here; the phase
     fails if it does not build) and through numpy, within the bars of the
     JAX package's tests/test_native.py, host seconds of each; (b)
     `utils/save_weights_only` on a full-resume checkpoint of phase 6(b)'s
     trained state and (c) those fields through a reference-format
     Lightning checkpoint and `tools/import_torch_ckpt`: fresh fields
     loaded from each file give the trained fields' K1 slice (SLICE_RAYS
     rays of a lego frame) bit for bit; (d) `tools/psnr_parity` at
     PARITY_ARGS (full 8x256 width, 4096-ray steps in groups on a CUDA
     graph): K1 launched at least once a chunk, plain float32 agreement
     with the torch oracle >= PARITY_F32_DB and K1's >= PARITY_K1_DB dB,
     every delta printed; (e) `examples/export_unity_vol` (its sigma grid
     at MESH_GRID^3 equal to phase 24's, the .vol written) and
     `examples/mesh_threshold_sweep` at SWEEP_THRESHOLDS (its faces at
     phase 24's threshold equal phase 24's mesh); (f)
     `examples/render_single_image.render_view` on one 400² lego camera of
     the ball field: seconds, PSNR against the K1 frame, and seconds in
     turns with the same plain render in float32.
 29. the last narrowings: (a) K1 and K4, both passes, at widths 128, 384
     and 512 (8 layers, skip at 4, numpy-seeded weights) against their plain
     versions at WIDTH_POINTS points (one direction per FAST_K), phase 3's
     and phase 8's bars, each timed in turns with its plain version beside
     its bound; every K1 and K4 instantiation's registers, spills and stack;
     (b) a NeRFConfig(depth=5, width=128) field through `render_rays_fused`
     (64 + 128) and `render_rays_fast` (C 32, K 16, a seeded proxy) on one
     chunk of the lego frame, on its bf16 pack (K1) and its int8 pack (K4),
     each kernel launched at width 128, 2048 rays of each
     against CPU re-renders on the plain versions (phase 9's bars per output:
     a random field's depth is no smoother than its weights, so phase 4's
     absolute bar does not apply);
     (c) the eval CLI's fast frame at `--fast_candidates 512` (K3 select)
     and auto-cull frame at `--fast_prepass 512` (K3 opacity) on phase 7's
     ball field and cached proxy, each against the same renderer on K3's
     and K1's plain versions on the card (`plain_fast_kernels`, FAST_BARS
     per output); (d) K3 opacity at C
     4096 over OPACITY_4096_RAYS rays (the plain march on its own scores
     bit for bit), K3 select at C 512 over one chunk and K6 at C 512 over
     K6_RAYS rays (its scores within proxy_score_bar, the plain selection
     on them bit for bit), each timed beside its plain version and bound.
  30. the last caps (~80 s): (a) K1 and K4, both passes, on the wide kernel
     (csrc/fused_mlp_wide.cu) at 8-layer widths 640, 768 and 1024 over
     524,288 points and 2048 over 131,072, against their plain versions
     (KERNEL_TOL; K4's phase 8 bars, its int8 layer inputs that round apart
     counted), timed in turns beside their bounds, with the wide kernel's
     registers and spills; (b) the same at depths 2 (the resident kernels)
     and 24 (the wide kernel) at widths 128 and 256; (c) an 8 x 1024 field
     pair's exact render of 8,192 rays through `render_rays_fused` on its
     bf16 and int8 packs against the same render on the plain versions on
     the card (`plain_field_kernels`, FAST_BARS); (d) on a one-rank NCCL
     group, `train_step_accum` (n_micro 2) and a `train_scan_importance`
     group on a CUDA graph (its all-gather of the rays' errors captured),
     data-parallel against non-distributed, bit for bit (parameters,
     losses, error buffers); (e) the eval CLI's auto-cull frame at
     `--fast_prepass 60000` and fast frame at `--fast_candidates 60000` on
     a 32² frame of the ball (K3 above MAX_CANDIDATES, its rows in a device
     scratch) against the plain versions, then K3 opacity and select and K6
     at C 65,536 over 300 rays: the plain march and selection on each
     kernel's own scores bit for bit, K6's kept sets and their order
     included, each timed beside its plain version (one run) and bound.
  With `--profile`, one more exact frame, one more training step, one
  more fast frame, one more int8 fast and int8 exact frame and one more
  128² and 800² EG3D frame under `torch.profiler`:
  device time per kernel, the device's idle share and the peak device
  memory; it also profiles one group of phase 6(c)'s grouped `fused` steps
  and phase 28(f)'s render_view in bf16 and float32.
Then one JSON line of kernels (launches counted over the path that runs
each: K1 phase 4, K2 phases 6(b), 23(c) and 26 (`launches_by_path`; its
readings at the culled shape under `culled_shape`), K3 select phase 9,
K3 opacity phase 10, K4 phase 11, K6 phase 13, K5 the 128² frames of
phase 16, and K1, K3 and K5 again over phase 27's two-slab frames, K1
over phase 28's round trips and psnr_parity, and phase 29's library renders of the width-128
field and CLI frames at C 512 (their `launches_by_path`; phase 29's readings of the other
widths and candidate counts under `widths` and `candidates_<C>`); the wide kernels
(`*_wide`) over phase 30's 8 x 1024 renders and the scratch paths (`*_scratch`) over its CLI
frames and K6 pass, their headline the width-1024 or C 65,536 reading, every phase 30 reading
under `shapes` and `candidates_<C>`; `timing` says how `ms` was
taken: "queued" for K5
and K3 select, "unqueued" for the rest), the nvidia-smi line, and the JSON
result as the last line. Any failure exits non-zero before the result is
printed.
Bounds: the larger of the operations over the dense tensor-core peak of
their type (bf16 989 TFLOP/s, int8 1,979 TOP/s) and the bytes (inputs read
once, outputs written once) over the memory rate of an H100 SXM (3.35 TB/s).
"""
import argparse
import concurrent.futures
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
H = W = 800
FOCAL = 0.5 * 800 / math.tan(0.5 * 0.6911112)   # Blender lego camera_angle_x
RADIUS, NEAR, FAR = 4.0, 2.0, 6.0
N_FRAMES, N_SAMPLES, N_IMPORTANCE, CHUNK = 3, 64, 128, 32768
N_CHECK = 1_000_003
KERNEL_TOL = (2e-3, 1e-2)    # atol, rtol
RENDER_ATOL = 5e-3
CHECK_RAYS = slice(400 * W, 400 * W + 2048)   # rays through the image centre rows
TRAIN_RAYS, TRAIN_STEPS, TRAIN_WARMUP, JNP_STEPS, LR = 1024, 60, 10, 12, 5e-4
TRAIN_LOSS_RTOL = 2e-2
GROUP_STEPS, GROUP_LOSS_RTOL, GROUP_CHANGE_GAP = 10, 1e-6, 1e-4
DP_STEPS, DP_EG3D_STEPS = 10, 3   # phase 26: steps a run (eager, and one group of as many)
GRAD_REL_L2, GRAD_ELEM = 1e-2, 5e-2
FIELD_SEED, FIELD_NOISE = SEED + 20, 0.05
BALL_R, BALL_SIGMA, BALL_RGB = 0.6, 15.0, (0.8, 0.35, 0.2)
FAST_C, FAST_K, PREPASS_C, N_AUTO, EDGE_CAP = 32, 16, 16, 5, 0.04
K6_RAYS, K6_C, K6_K = 65_536, 64, 16
DEPTH_BARS = (5e-3, 5e-2)    # median, 99th percentile of |dz| / (far - near)
OPACITY_BARS = (2e-3, 5e-2)  # median, max
FAST_BARS = (2e-3, 5e-2)     # median, 99th percentile of |d| / max(1, max|ref|)
INT8_RGB_ATOL, INT8_SIGMA_TOL, INT8_VS_BF16 = 2e-2, (5e-2, 2e-2), 0.15
PEAK_FLOPS, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12   # H100 SXM dense; HBM3
EG3D_SEED, EG3D_WH, EG3D_BIG, N_EG3D = SEED + 30, 128, 800, 3
EG3D_CHECK = slice(64 * 128, 64 * 128 + 2048)   # rays through the 128² frame's centre rows
SEM_CLASSES, SEM_CAPACITY, D3_EXACT_WH = 6, 8192, 200
# class ids must agree where the plain top-two margin exceeds CLS_MARGIN: on an H100 80GB
# HBM3 (700 W) the d3 fast frame's ids differed from the plain versions' at 13 of 640,000
# pixels, the largest margin among them 0.042 (a near tie at a cloud's capacity cut moves
# PointNet's max-pool and so every ray of the tile a little)
CLS_MARGIN = 0.1
EG3D_TRAIN_STEPS, EG3D_WINDOW = 30, 5   # phase 21's eager steps; the loss means compared
EG3D_BALL_SIGMA = 20.0  # phase 22's ball: marcher density per unit depth inside it
CULLED_K = 24           # phase 23: samples a ray of the culled step (n_sel 16 + n_uni 8)
MESH_GRID, MESH_SIGMA = 256, 5.0   # phases 24-25: the grid; phase 24's threshold (< 15)
MESH_CHECK, MESH_ATOL = 2048, 1e-3  # grid points held against the CPU, float32 both sides
N_LEGO_CAMERAS = 100    # phase 28(a): a Blender scene's training cameras, 800² each
NATIVE_RAY_TOL = dict(rtol=1e-5, atol=1e-6)   # world directions, tests/test_native.py's bars
SLICE_RAYS = 32768      # phase 28(b, c): the K1 slice of the round-tripped fields
PARITY_ARGS = ["--steps", "200", "--train_hw", "64", "--hw", "64", "--poses", "1"]
PARITY_F32_DB, PARITY_K1_DB = 40.0, 30.0   # phase 28(d): agreement with the oracle
SWEEP_THRESHOLDS = (MESH_SIGMA, 10.0)      # phase 28(e): phase 24's threshold first
VIEW_WH, VIEW_SAMPLES, VIEW_IMPORTANCE = 400, 64, 64   # phase 28(f): the example's defaults
K5_RANDOM = 262_144
K5_LIB_TOL = 1e-5       # of the table's largest magnitude, vs F.grid_sample
K5_ROUNDS = 4           # rounds of K5 and F.grid_sample timed in turns
K5_REPS = 20            # launches per timing, queued behind ~11 ms of device sleep
K5_UNQUEUED = 4         # timings of K5 unqueued, as every other kernel is timed
K3_QUEUED = 3           # queued timings of K3 select at one chunk (K5_REPS launches each)
SAME_FRAME_ATOL = 1e-6  # kernel vs gather frames
PLANES_RTOL = 1e-3      # card vs CPU float32 synthesis, of the planes' largest magnitude
NARROW_WIDTHS = (128, 384, 512)   # phase 29: K1's and K4's widths beside 256
WIDTH_POINTS = 524_288  # phase 29(a): points of each width's check (a fast chunk's survivors)
WIDE_C = 512            # phase 29(c, d): candidates a ray above the 256 K3 once took
OPACITY_4096_RAYS = 8192   # phase 29(d): rays of K3 opacity at C 4096
WIDE_WIDTHS = (640, 768, 1024)   # phase 30(a): widths above 512 (8 layers, WIDTH_POINTS)
W2048_POINTS = 131_072  # phase 30(a): width 2048's points (its scratch leaves L2)
DEEP_FIELDS = ((128, 2), (128, 24), (256, 2), (256, 24))   # phase 30(b): (width, depth)
WIDE_RENDER_RAYS = 8192  # phase 30(c): rays of the 8 x 1024 field's exact render
ACCUM_STEPS, IMPORTANCE_STEPS = 3, 5   # phase 30(d): accumulated steps; one importance group
HUGE_C, HUGE_RAYS = 65_536, 300   # phase 30(e): candidates above MAX_CANDIDATES; rays
CLI_HUGE_C, CLI_WH = 60_000, 32   # phase 30(e): the eval CLI's candidates; its frame
SOURCES = ("fused_mlp", "fused_mlp_train", "proxy_march", "fused_mlp_int8", "triplane_gather",
           "fused_mlp_wide")
PALLAS = "nerf_siren_tpu/ops/pallas"
# K1's times before its redesign (the wmma kernel, at these shapes on an H100 80GB HBM3, 700 W)
EARLIER_K1_MS = {"fused_nerf_sigma": 20.673, "fused_nerf_full": 68.704}
# K4's times before its redesign (the mma.sync kernel, at phase 8's shapes on an H100 80GB
# HBM3, 700 W)
EARLIER_K4_MS = {"fused_nerf_sigma_int8": 42.806, "fused_nerf_full_int8": 11.652}
# K2 before its redesigns (the wmma tile kernel, the wmma weight-gradient kernel and the
# whole backward; the wmma forward; ms per step of 2 launches, at phase 5's shapes; other
# calls on an H100 80GB HBM3, 700 W)
EARLIER_K2_MS = {"tile": 10.595, "wgrad": 6.679, "fused_train_bwd": 17.440,
                 "fused_train_fwd": 2.822}
# K3's times before its redesign (the CUDA-core kernel on an H100 80GB HBM3, 700 W: one
# 32,768-ray chunk at C 32, K 16 from the fast frame's profile, 9.363 ms / 20; one launch
# over a frame's 640,000 rays; the opacity prepass at 640,000 rays, C 16)
EARLIER_K3_MS = {"chunk": 0.468, "one launch": 5.537, "opacity": 2.662}
# K6 before its redesign (a warp per ray on the CUDA cores, on an H100 80GB HBM3, 700 W): at
# phase 8's shape, and phase 13's one call over a frame (0.0112 and 0.0111 s in two runs of
# that tree's smoke in one call)
EARLIER_K6_MS = 1.230
EARLIER_K6_FRAME_S = 0.0111
# `sass_digest("proxy_march", symbol)` of K3's instantiations at width 96 in the tree before K6
# joined csrc/proxy_march.cu, built with nvcc 12.8 on the H100 machine: K3's code must not move
K3_SASS_DIGESTS = {"proxy_march_kernelILi96ELi1ELb0E": "cc3a61b2d5fd3d46",   # select
                   "proxy_march_kernelILi96ELi0ELb0E": "8c7db8f61114441f"}   # opacity
TOPK_SYMBOL = "proxy_march_kernelILi96ELi2ELb0E"   # mangled <96, TOPK, false>
K2_BWD_SYMBOLS = {"tile": "nerf_train_bwd_tile_kernel", "wgrad": "nerf_train_wgrad_kernel",
                  "reduce": "nerf_train_reduce_kernel"}
K2_FWD_SYMBOL = "nerf_train_fwd_tile_kernel"
K4_SYMBOLS = {"fused_nerf_sigma_int8": "nerf_field_int8_kernelILi256ELb0E",
              "fused_nerf_full_int8": "nerf_field_int8_kernelILi256ELb1E"}
# mangled <256, false> / <256, true>: the field's width, 256
K1_SYMBOLS = {"fused_nerf_sigma": "nerf_field_kernelILi256ELb0E",
              "fused_nerf_full": "nerf_field_kernelILi256ELb1E"}
KERNELS = {   # wrapper -> (module and source name, launch counter key, TPU kernel it replaces)
    "fused_nerf_sigma": ("fused_mlp", "sigma", f"{PALLAS}/fused_mlp.py:262"),
    "fused_nerf_full": ("fused_mlp", "full", f"{PALLAS}/fused_mlp.py:272"),
    "fused_train_fwd": ("fused_mlp_train", "fwd", f"{PALLAS}/fused_mlp_train.py:255"),
    "fused_train_bwd": ("fused_mlp_train", "bwd", f"{PALLAS}/fused_mlp_train.py:266"),
    "proxy_opacity": ("proxy_march", "opacity", f"{PALLAS}/proxy_march.py:161"),
    "proxy_march_select": ("proxy_march", "select", f"{PALLAS}/proxy_march.py:172"),
    "fused_nerf_full_int8": ("fused_mlp_int8", "full", f"{PALLAS}/fused_mlp_int8.py:253"),
    "fused_nerf_sigma_int8": ("fused_mlp_int8", "sigma", f"{PALLAS}/fused_mlp_int8.py:279"),
    "proxy_select": ("proxy_select", "select", f"{PALLAS}/proxy_select.py:55"),
    "triplane_gather": ("triplane_gather", "gather", f"{PALLAS}/triplane_gather.py:76"),
    # phase 30: the same wrappers on the kernels of the shapes their first kernels refuse
    "fused_nerf_sigma_wide": ("fused_mlp", "sigma_wide", f"{PALLAS}/fused_mlp.py:262"),
    "fused_nerf_full_wide": ("fused_mlp", "full_wide", f"{PALLAS}/fused_mlp.py:272"),
    "fused_nerf_sigma_int8_wide": ("fused_mlp_int8", "sigma_wide",
                                   f"{PALLAS}/fused_mlp_int8.py:279"),
    "fused_nerf_full_int8_wide": ("fused_mlp_int8", "full_wide",
                                  f"{PALLAS}/fused_mlp_int8.py:253"),
    "proxy_opacity_scratch": ("proxy_march", "opacity_scratch", f"{PALLAS}/proxy_march.py:161"),
    "proxy_march_select_scratch": ("proxy_march", "select_scratch",
                                   f"{PALLAS}/proxy_march.py:172"),
    "proxy_select_scratch": ("proxy_select", "select_scratch", f"{PALLAS}/proxy_select.py:55"),
}
# the wrappers whose kernel is in another source than their module's name
SOURCE_OF = {"proxy_select": "proxy_march", "proxy_select_scratch": "proxy_march",
             "fused_nerf_sigma_wide": "fused_mlp_wide", "fused_nerf_full_wide": "fused_mlp_wide",
             "fused_nerf_sigma_int8_wide": "fused_mlp_wide",
             "fused_nerf_full_int8_wide": "fused_mlp_wide"}
# the path whose launches a kernel's `launches` counted before phase 27 added its slabs
MAIN_PATH = {"fused_nerf_sigma": "exact (phase 4)", "fused_nerf_full": "exact (phase 4)",
             "proxy_march_select": "fast (phase 9)", "proxy_opacity": "auto-cull (phase 10)",
             "triplane_gather": "EG3D (phase 16)"}


STEP_MS = {}   # label -> (eager, grouped) ms per step, medians of turns (phases 6, 23)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def numpy_nerf_params(rng, cfg):
    """A JAX-layout NeRF tree (kernel (in, out)) with the torch-default
    U(-1/sqrt(in), 1/sqrt(in)) init, as `init_nerf` builds it."""
    def lin(i, o):
        b = 1.0 / math.sqrt(i)
        return {"kernel": rng.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": rng.uniform(-b, b, (o,)).astype(np.float32)}

    layers = []
    for i in range(cfg.depth):
        in_dim = (cfg.in_channels_xyz if i == 0 else
                  cfg.width + cfg.in_channels_xyz if i in cfg.skips else cfg.width)
        layers.append(lin(in_dim, cfg.width))
    return {"xyz_layers": layers, "xyz_final": lin(cfg.width, cfg.width),
            "sigma": lin(cfg.width, 1),
            "dir_layer": lin(cfg.width + cfg.in_channels_dir, cfg.width // 2),
            "rgb": lin(cfg.width // 2, 3)}


def lego_pose(k, n=N_FRAMES, elevation=30.0):
    """(3, 4) camera-to-world matrix [R | eye] of camera k of n on the
    radius-4 sphere at `elevation` degrees, looking at the origin (OpenGL
    camera, -z forward)."""
    theta, phi = 2 * math.pi * k / n, math.radians(elevation)
    eye = RADIUS * np.array([math.cos(phi) * math.cos(theta),
                             math.cos(phi) * math.sin(theta), math.sin(phi)])
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.concatenate([np.stack([x, np.cross(z, x), z], 1), eye[:, None]], 1)


def lego_rays(k, device, h=H, w=W):
    """(h*w, 8) rays of camera k (`lego_pose`), near 2, far 6."""
    import torch

    pose = lego_pose(k)
    eye = pose[:, 3]
    c2w = torch.tensor(pose[:, :3], dtype=torch.float32, device=device)
    f = FOCAL * w / 800
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - w / 2) / f, -(j - h / 2) / f, -torch.ones_like(i)], -1)
    dirs = dirs.reshape(-1, 3) @ c2w.T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    n = dirs.shape[0]
    origin = torch.tensor(eye, dtype=torch.float32, device=device).expand(n, 3)
    return torch.cat([origin, dirs, torch.full((n, 1), NEAR, device=device),
                      torch.full((n, 1), FAR, device=device)], -1).contiguous()


def cuda_ms(fn, reps, queued=False):
    """ms per call of fn over reps calls (`card_bench.device_ms`)."""
    from nerf_siren_tpu_torch.card_bench import device_ms

    return device_ms(fn, reps, queued)


def compare(name, got, ref, where, phase="3/28"):
    """Max |got - ref|; fails on a shape mismatch, a non-finite value or any
    element outside KERNEL_TOL."""
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name} {where}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
             f"or non-finite output")
    atol, rtol = KERNEL_TOL
    delta = (got - ref).abs()
    bad = int((delta > atol + rtol * ref.abs()).sum())
    err = float(delta.max())
    print(f"[{phase}] {name} vs plain {where}: max|d| {err:.3e} "
          f"(per column {[f'{v:.2e}' for v in delta.amax(0).tolist()]}), "
          f"{bad} outside {atol} + {rtol}|ref|", flush=True)
    if bad:
        fail(f"{name} disagrees with its plain version {where}")
    return err


def bound(flops, n_bytes, int8_ops=0.0):
    """(bound_ms, bound_by): the least time the card could take for the work:
    bf16 `flops` and `int8_ops` each at their peak, or `n_bytes` moved."""
    t_ops = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_pair(kern, plain, reps=5, plain_reps=3):
    """(kernel ms, plain ms, the four runs), in turns: plain, kernel, kernel,
    plain. `kern` and `plain` are lists of callables run back to back."""
    def run_all(fns):
        return lambda: [f() for f in fns]

    p1, k1, k2, p2 = (cuda_ms(run_all(plain), plain_reps), cuda_ms(run_all(kern), reps),
                      cuda_ms(run_all(kern), reps), cuda_ms(run_all(plain), plain_reps))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def check_kernels(packed, device, card):
    """Phase 3: each K1 kernel against its plain version at N_CHECK points
    and at the eval path's shapes, then both timed at the latter."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import _build
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

    rng = np.random.default_rng(SEED + 1)
    xyz = torch.tensor(rng.uniform(-4.0, 4.0, (N_CHECK, 3)), dtype=torch.float32, device=device)
    d = torch.tensor(rng.normal(size=(N_CHECK, 3)), dtype=torch.float32, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    where = f"at N={N_CHECK}"
    errs = {"fused_nerf_sigma": compare("fused_nerf_sigma", fm.fused_nerf_sigma(packed, xyz),
                                        fm.fused_sigma_ref(packed, xyz), where),
            "fused_nerf_full": compare("fused_nerf_full", fm.fused_nerf_full(packed, xyz, d),
                                       fm.fused_full_ref(packed, xyz, d), where)}
    del xyz, d

    # the eval path's shapes: one chunk of rays drawn at random from a whole
    # frame (so neighbouring rays differ in direction), 64 sigma points and
    # 192 full points per ray, one direction per ray
    pick = torch.as_tensor(rng.permutation(H * W)[:CHUNK], device=device)
    rays = lego_rays(0, device)[pick]
    s_all = N_SAMPLES + N_IMPORTANCE
    zc = torch.linspace(NEAR, FAR, N_SAMPLES, device=device)
    zf = torch.linspace(NEAR, FAR, s_all, device=device)
    pts_c = (rays[:, None, :3] + rays[:, None, 3:6] * zc[:, None]).reshape(-1, 3)
    pts_f = (rays[:, None, :3] + rays[:, None, 3:6] * zf[:, None]).reshape(-1, 3)
    dirs = rays[:, 3:6].contiguous()
    lib = _build.load("fused_mlp")
    report = ptxas_report("fused_mlp")
    for name, symbol in K1_SYMBOLS.items():
        regs, spills, stack = next(v for k, v in report.items() if symbol in k)
        print(f"[3/28] {name} build (-Xptxas -v): {regs} registers at entry, {spills} spill bytes "
              f"(stores + loads), {stack} bytes stack frame; "
              f"{lib.nerf_field_smem_bytes(256, int(name == 'fused_nerf_full'))} bytes dynamic "
              f"shared memory", flush=True)
    results = {}
    for name, kern, plain, n_pts, n_bytes, where in (
            ("fused_nerf_sigma", lambda: fm.fused_nerf_sigma(packed, pts_c),
             lambda: fm.fused_sigma_ref(packed, pts_c), pts_c.shape[0],
             pts_c.shape[0] * (12 + 4), f"at {CHUNK} rays x {N_SAMPLES}"),
            ("fused_nerf_full", lambda: fm.fused_nerf_full(packed, pts_f, dirs, s_all),
             lambda: fm.fused_full_ref(packed, pts_f, dirs, s_all), pts_f.shape[0],
             pts_f.shape[0] * (12 + 16) + dirs.numel() * 4,
             f"at {CHUNK} rays x {s_all}, samples_per_dir {s_all}")):
        full = name == "fused_nerf_full"
        err = max(errs[name], compare(name, kern(), plain(), where))
        ms, plain_ms, (p1, k1, k2, p2) = timed_pair([kern], [plain])
        flops = n_pts * _flop_per_point(packed, full)
        n_bytes += k1_weight_bytes(packed)
        bound_ms, bound_by = bound(flops, n_bytes)
        chain_ms = matmul_chain_ms(packed, n_pts, full)
        print(f"[3/28] {name} at {n_pts} points: kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}; "
              f"{flops * 1e-12 / (ms * 1e-3):.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
              f"bound), plain {plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}); bound {bound_ms:.3f} ms "
              f"({bound_by}); earlier wmma kernel {EARLIER_K1_MS[name]} ms (another call); bf16 "
              f"torch.matmul chain of the same products {chain_ms:.3f} ms "
              f"({flops * 1e-12 / (chain_ms * 1e-3):.1f} TFLOP/s; a reading); {card}", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return results


def k1_weight_bytes(packed):
    """Bytes of the pack that K1 reads: the weight stream (W_comb and W_dir
    included), the biases and the heads."""
    return sum(t.numel() * t.element_size() for k, t in packed.items()
               if k in ("k1_stream", "w_sigma", "w_rgb") or k[0] == "b")


def ptxas_report(name):
    """{mangled kernel name: (registers, spill store + load bytes, stack
    frame bytes)} from the `-Xptxas -v` log the build keeps beside
    csrc/<name>.cu's library."""
    from pathlib import Path
    from nerf_siren_tpu_torch.card_bench import ptxas_props
    from nerf_siren_tpu_torch.ops.kernels import _build

    return ptxas_props(Path(str(_build.build(name)) + ".log").read_text())


def matmul_chain_ms(packed, n, full):
    """A reading only, never on the path: the field's layer products at n
    points as a chain of bf16 `torch.matmul` calls at K1's shapes (random
    inputs; no embedding, bias, ReLU or head nonlinearity), ms per chain
    over 3 runs."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

    dev, bf = packed["w_sigma"].device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e = torch.rand((n, fm.EMB_X), generator=gen, device=dev).to(bf)
    d = torch.rand((n, fm.EMB_D), generator=gen, device=dev).to(bf) if full else None

    def chain():
        h = e @ packed["w0e"].t()
        for i in range(1, fm._depth(packed)):
            y = h @ packed[f"w{i}"].t()
            h = torch.addmm(y, e, packed[f"w{i}e"].t()) if f"w{i}e" in packed else y
        sigma = h @ packed["w_sigma"][:, None]
        if not full:
            return sigma
        hd = torch.addmm(h @ packed["w_comb"].t(), d, packed["w_dir"].t())
        return sigma, hd @ packed["w_rgb"].t()

    ms = cuda_ms(chain, 3)
    del e, d
    torch.cuda.empty_cache()
    return ms


def _flop_per_point(packed, full):
    """Multiply-adds x 2 of the field's products, counted from the pack."""
    macs = sum(t.numel() for k, t in packed.items() if k[0] == "w" and k[1:2].isdigit())
    macs += packed["w_sigma"].numel()
    if full:
        macs += packed["w_comb"].numel() + packed["w_dir"].numel() + packed["w_rgb"].numel()
    return 2 * macs


def train_macs_per_point(model):
    """Multiply-adds per point of K2's forward and backward, from the field's
    own weight shapes (no padding). The forward is one product per weight;
    the backward recomputes it, then takes every weight gradient (one
    product per weight) and every cotangent of a hidden input (the
    embedding columns need none)."""
    cfg = model.cfg
    fwd = sum(p.numel() for n, p in model.named_parameters() if n.endswith("weight"))
    emb_cols = cfg.width * cfg.in_channels_xyz * 2 + (cfg.width // 2) * cfg.in_channels_dir
    dgrad = fwd - emb_cols
    return fwd, fwd + fwd + dgrad


def grad_errors(got, ref):
    """(worst relative L2, max |delta|, worst |delta| over its tensor's
    largest magnitude, name of the worst L2) over gradient tensors; fails a
    tensor past GRAD_REL_L2 or an element past GRAD_ELEM of that scale."""
    import torch

    worst, max_abs, max_elem, worst_key = 0.0, 0.0, 0.0, ""
    for k, b in ref.items():
        a = got[k]
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"gradient {k}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        delta = (a - b).abs()
        rel = float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))
        elem = float(delta.max()) / max(float(b.abs().max()), 1e-30)
        if rel >= GRAD_REL_L2 or elem > GRAD_ELEM:
            fail(f"gradient {k}: relative L2 {rel:.3e}, max element {elem:.3e} of its scale")
        if rel >= worst:
            worst, worst_key = rel, k
        max_abs, max_elem = max(max_abs, float(delta.max())), max(max_elem, elem)
    return worst, max_abs, max_elem, worst_key


def check_train_kernels(model, frame_rays, device, card):
    """Phase 5: K2's forward and backward against their plain versions at
    the training step's shapes, then each timed (coarse + fine shapes)."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    rng = np.random.default_rng(SEED + 2)
    packed = k2.pack_train_params(model.state_dict())
    pick = torch.as_tensor(rng.permutation(frame_rays.shape[0])[:TRAIN_RAYS], device=device)
    rays = frame_rays[pick]
    dirs = rays[:, 3:6].contiguous()
    shapes = []
    for s in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        z = torch.linspace(NEAR, FAR, s, device=device)
        pts = (rays[:, None, :3] + rays[:, None, 3:6] * z[:, None]).reshape(-1, 3).contiguous()
        # cotangents of mixed sign around a positive mean, as a loss gives
        # them (a zero-mean dy makes every bias gradient a cancelling sum)
        dy = torch.tensor(rng.uniform(-0.5, 1.5, (pts.shape[0], 4)), dtype=torch.float32,
                          device=device)
        shapes.append((s, pts, dy))

    fwd_err = bwd_err = worst_rel = 0.0
    for s, pts, dy in shapes:
        where = f"at {TRAIN_RAYS} rays x {s}, samples_per_dir {s}"
        fwd_err = max(fwd_err, compare("fused_train_fwd", k2.fused_train_fwd(packed, pts, dirs, s),
                                       k2.fused_train_fwd_ref(packed, pts, dirs, s), where,
                                       "5/28"))
        got = k2.fused_train_bwd(packed, pts, dirs, dy, s)
        torch.cuda.synchronize()
        rel, max_abs, elem, key = grad_errors(got,
                                              k2.fused_train_bwd_ref(packed, pts, dirs, dy, s))
        print(f"[5/28] fused_train_bwd vs plain {where}: worst relative L2 {rel:.3e} ({key}), "
              f"max|d| {max_abs:.3e}, worst element {elem:.3e} of its tensor's scale, over "
              f"{len(got)} gradient tensors", flush=True)
        bwd_err, worst_rel = max(bwd_err, max_abs), max(worst_rel, rel)

    results, kerns = time_train_kernels(
        "5/28", "one step's shapes", model, [(packed, p, d, s) for s, p, d in shapes], dirs,
        fwd_err, bwd_err, card)
    n_pts = sum(pts.shape[0] for _, pts, _ in shapes)
    forward_readings(packed, kerns["fused_train_fwd"], shapes, results["fused_train_fwd"]["ms"],
                     results["fused_train_fwd"]["bound_ms"], kerns["fwd_flops"], card)
    backward_readings(packed, kerns["fused_train_bwd"], shapes, results["fused_train_bwd"]["ms"],
                      results["fused_train_bwd"]["bound_ms"], kerns["bwd_flops"], n_pts, card)
    return results


def time_train_kernels(phase, what, model, calls, dirs, fwd_err, bwd_err, card):
    """K2's forward and backward over `calls` ((pack, points, cotangents,
    samples_per_dir), each one launch), timed against their plain versions
    in turns, with the bound of that work: the operations from the field's
    weight shapes, the bytes of the points, directions and each distinct
    pack read and of the outputs (and, backward, the cotangents read and
    the gradients written). Returns ({wrapper: readings}, {wrapper: the
    kernel callables, and the FLOP counts})."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    n_pts = sum(pts.shape[0] for _, pts, _, _ in calls)
    fwd_macs, bwd_macs = train_macs_per_point(model)
    packs = list({id(p): p for p, _, _, _ in calls}.values())
    w_bytes = sum(t.numel() * t.element_size() for p in packs for k, t in p.items()
                  if k != "k2_stream")
    g_bytes = sum(p.numel() * 4 for p in model.parameters())
    in_bytes = n_pts * 12 + len(calls) * dirs.numel() * 4 + w_bytes
    results, kerns = {}, {}
    for name, kern, plain, flops, n_bytes, err in (
            ("fused_train_fwd",
             [lambda p=p, x=x, s=s: k2.fused_train_fwd(p, x, dirs, s) for p, x, _, s in calls],
             [lambda p=p, x=x, s=s: k2.fused_train_fwd_ref(p, x, dirs, s)
              for p, x, _, s in calls],
             2 * fwd_macs * n_pts, in_bytes + n_pts * 16, fwd_err),
            ("fused_train_bwd",
             [lambda p=p, x=x, d=d, s=s: k2.fused_train_bwd(p, x, dirs, d, s)
              for p, x, d, s in calls],
             [lambda p=p, x=x, d=d, s=s: k2.fused_train_bwd_ref(p, x, dirs, d, s)
              for p, x, d, s in calls],
             2 * bwd_macs * n_pts, in_bytes + n_pts * 16 + len(calls) * g_bytes, bwd_err)):
        ms, plain_ms, (p1, k1, k2_, p2) = timed_pair(kern, plain)
        bound_ms, bound_by = bound(flops, n_bytes)
        print(f"[{phase}] {name}, {what} ({n_pts} points in {len(calls)} launches): kernel "
              f"{ms:.3f} ms ({k1:.3f}, {k2_:.3f}; {flops * 1e-12 / (ms * 1e-3):.1f} TFLOP/s, "
              f"{100 * bound_ms / ms:.1f}% of the bound), plain {plain_ms:.3f} ms ({p1:.3f}, "
              f"{p2:.3f}); bound {bound_ms:.4f} ms ({bound_by}, {flops * 1e-12:.4f} TFLOP, "
              f"{n_bytes / 1e6:.2f} MB); {card}", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        kerns[name], kerns[name[-3:] + "_flops"] = kern, flops
    return results, kerns


def forward_readings(packed, kern, shapes, ms, bound_ms, flops, card):
    """Phase 5's readings of K2's forward at one step's shapes: its kernel's
    own device ms, its build report and the matmul chain of its products."""
    from nerf_siren_tpu_torch.card_bench import kernel_ms
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    regs, spills, stack = next(v for k, v in ptxas_report("fused_mlp_train").items()
                               if K2_FWD_SYMBOL in k)
    own = sum(v for k, v in kernel_ms(lambda: [f() for f in kern], 3).items()
              if K2_FWD_SYMBOL in k)
    chain_ms = train_matmul_chain_ms(packed, [pts.shape[0] for _, pts, _ in shapes],
                                     backward=False)
    earlier = EARLIER_K2_MS["fused_train_fwd"]
    print(f"[5/28] fused_train_fwd per step: {ms:.3f} ms, its kernel {own:.3f} ms (device time, "
          f"profiler, mean of 3; before the redesign {earlier} ms, another call; "
          f"{earlier / own:.2f}x); operations bound {bound_ms:.3f} ms ({100 * bound_ms / own:.1f}% "
          f"of it); build (-Xptxas -v): {regs} registers at entry, {spills} spill bytes (stores + "
          f"loads), {stack} bytes stack frame; {k2._lib().nerf_train_smem_bytes(2)} bytes dynamic "
          f"shared memory; bf16 torch.matmul chain of the same products {chain_ms:.3f} ms "
          f"({flops * 1e-12 / (chain_ms * 1e-3):.1f} TFLOP/s; a reading); {card}", flush=True)


def backward_readings(packed, kern, shapes, ms, bound_ms, flops, n_pts, card):
    """Phase 5's readings of K2's backward at one step's shapes: its three
    kernels' own device ms, their build report, the stash's byte floor and
    the matmul chain of its products."""
    from nerf_siren_tpu_torch.card_bench import kernel_ms
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    lib = k2._lib()
    report = ptxas_report("fused_mlp_train")
    own = kernel_ms(lambda: [f() for f in kern], 3)
    smem = {"tile": lib.nerf_train_smem_bytes(0), "wgrad": lib.nerf_train_smem_bytes(1)}
    for label, symbol in K2_BWD_SYMBOLS.items():
        regs, spills, stack = next(v for k, v in report.items() if symbol in k)
        k_ms = sum(v for k, v in own.items() if symbol in k)
        earlier = (f"; before the redesign {EARLIER_K2_MS[label]} ms (another call)"
                   if label in EARLIER_K2_MS else "")
        print(f"[5/28] fused_train_bwd {label} kernel: {k_ms:.3f} ms per step (device time, "
              f"profiler, mean of 3){earlier}; build (-Xptxas -v): {regs} registers at entry, "
              f"{spills} spill bytes (stores + loads), {stack} bytes stack frame; "
              f"{smem.get(label, 0)} bytes dynamic shared memory", flush=True)
    written, read = k2.stash_bytes_per_point()
    floor_ms = n_pts * (written + read) / PEAK_BYTES * 1e3
    chain_ms = train_matmul_chain_ms(packed, [pts.shape[0] for _, pts, _ in shapes])
    earlier = EARLIER_K2_MS["fused_train_bwd"]
    print(f"[5/28] fused_train_bwd per step: {ms:.3f} ms (before the redesign {earlier} ms, "
          f"another call; {earlier / ms:.2f}x); operations bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / ms:.1f}% of it); the stash {written} bytes a point written + "
          f"{read} read = {n_pts * (written + read) / 1e9:.3f} GB, "
          f"a byte floor of {floor_ms:.3f} ms at 3.35 TB/s (a reading); bf16 torch.matmul chain of "
          f"the same products {chain_ms:.3f} ms ({flops * 1e-12 / (chain_ms * 1e-3):.1f} TFLOP/s; "
          f"a reading); {card}", flush=True)


def train_matmul_chain_ms(packed, sizes, backward=True):
    """A reading only, never on the path: K2's backward products at each of
    `sizes` points as bf16 `torch.matmul` calls (random inputs; no
    embedding, bias, ReLU, mask or head nonlinearity): the recompute's
    layer products, the dgrad chain's (dz W), and the 14 weight gradients
    (dz^T a); ms per chain over 3 runs. With `backward` False, the
    forward's: the recompute's layer products and the two heads'."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    dev, bf = packed["w_sigma"].device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = {k: v for k, v in packed.items() if v.dtype == bf and v.dim() == 2}
    ins = [(torch.rand((n, k2.EMB_X), generator=gen, device=dev).to(bf),
            torch.rand((n, k2.EMB_D), generator=gen, device=dev).to(bf),
            torch.rand((n, k2.HEAD), generator=gen, device=dev).to(bf)) for n in sizes]

    def chain():
        for e, dd, dhead in ins:
            hs = [e @ w["w0e"].t()]
            for i in range(1, k2.DEPTH):
                y = hs[-1] @ w[f"w{i}"].t()
                hs.append(torch.addmm(y, e, w[f"w{i}e"].t()) if i == k2.SKIP else y)
            feat = hs[-1] @ w["w_feat"].t()
            hd = torch.addmm(feat @ w["w_dfeat"].t(), dd, w["w_ddir"].t())
            if not backward:
                hs[-1] @ packed["w_sigma"][:, None], hd @ w["w_rgb"].t()
                continue
            dfeat = hd @ w["w_dfeat"]
            dz = [dfeat @ w["w_feat"]]                     # dz_7, then dz_6 .. dz_0
            for i in range(k2.DEPTH - 1, 0, -1):
                dz.append(dz[-1] @ w[f"w{i}"])
            dz = dz[::-1]
            for i in range(1, k2.DEPTH):
                dz[i].t() @ hs[i - 1]
            dfeat.t() @ hs[-1], hd.t() @ feat, dz[0].t() @ e, dz[k2.SKIP].t() @ e, hd.t() @ dd
            hs[-1].t() @ dhead, hd.t() @ dhead

    ms = cuda_ms(chain, 3)
    del ins
    torch.cuda.empty_cache()
    return ms


def numpy_models(seed, device, params_fn=numpy_nerf_params):
    """Coarse and fine full-width `NeRF`s with weights from a numpy seed."""
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF

    rng = np.random.default_rng(seed)
    models = {}
    for name in ("coarse", "fine"):
        model = NeRF(NeRFConfig())
        model.load_state_dict(nerf_from_jax(params_fn(rng, model.cfg)))
        models[name] = model.to(device)
    return models


def train_system(backend, perturb, noise_std, steps_per_epoch, device, data_parallel=None):
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    render_cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=perturb,
                              noise_std=noise_std, white_back=True)
    # opt.py's defaults: Adam, lr 5e-4, steplr at epoch 20 by 0.1
    train_cfg = TrainConfig(lr=LR, decay_step=(20,), decay_gamma=0.1, batch_size=TRAIN_RAYS)
    return NeRFSystem(render_cfg, train_cfg, NeRFConfig(), steps_per_epoch,
                      train_backend=backend, device=device, data_parallel=data_parallel)


def train_phase(pool_rays, pool_rgbs, device, card):
    """Phase 6: one step on each backend, TRAIN_STEPS fused steps, then the
    grouped steps. Returns (K2 launches over (b), (b)'s ms per step,
    (b)'s system, state and last batch, and (c)'s fused system, state and
    batches of a group)."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    steps_per_epoch = pool_rays.shape[0] // TRAIN_RAYS

    def batch():
        idx = torch.randint(0, pool_rays.shape[0], (TRAIN_RAYS,), generator=gen, device=device)
        return {"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]}

    # (a) the two backends from the same weights and batch, deterministic
    student = numpy_models(SEED + 10, device)
    first, losses = batch(), {}
    for backend in ("fused", "jnp"):
        system = train_system(backend, 0.0, 0.0, steps_per_epoch, device)
        state = system.state_for(copy.deepcopy(student))
        _, metrics = system.train_step(state, first, seed=SEED)
        losses[backend] = float(metrics["train/loss"])
    rel = abs(losses["fused"] - losses["jnp"]) / abs(losses["jnp"])
    print(f"[6/28] first step, same weights and batch: loss fused {losses['fused']:.6f}, "
          f"jnp {losses['jnp']:.6f}, relative {rel:.3e} (bar {TRAIN_LOSS_RTOL})", flush=True)
    if not rel < TRAIN_LOSS_RTOL:
        fail("the fused and jnp backends disagree on the first step's loss")

    # (b) the fused backend at opt.py's defaults
    system = train_system("fused", 1.0, 1.0, steps_per_epoch, device)
    state = system.state_for(student)
    batches = [batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    k2.LAUNCHES.update(fwd=0, bwd=0)
    loss_t, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = system.train_step(state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss_t.append(metrics["train/loss"])
    launches = dict(k2.LAUNCHES)
    loss = [float(v) for v in loss_t]
    ms = 1e3 * float(np.median(step_s[TRAIN_WARMUP:]))
    head, tail = float(np.mean(loss[:10])), float(np.mean(loss[-10:]))
    print(f"[6/28] fused training, {TRAIN_STEPS} steps of {TRAIN_RAYS} rays at "
          f"{N_SAMPLES}+{N_IMPORTANCE} samples: loss first 10 mean {head:.5f}, last 10 mean "
          f"{tail:.5f}; loss every 10th step {[round(v, 5) for v in loss[::10]]}; "
          f"{ms:.3f} ms per step (median after {TRAIN_WARMUP}); "
          f"{1e3 * TRAIN_RAYS / ms:.0f} rays/s ({card}); launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in loss):
        fail("a training loss is not finite")
    if not tail < head:
        fail("the fused training loss did not fall")
    for key in ("fwd", "bwd"):
        if launches[key] < 2 * TRAIN_STEPS:
            fail(f"K2 {key} launched {launches[key]} times, expected >= {2 * TRAIN_STEPS}")

    # the plain backend's step on the same batches, for comparison
    plain = train_system("jnp", 1.0, 1.0, steps_per_epoch, device)
    plain_state, plain_s = plain.state_for(copy.deepcopy(state.models)), []
    for b in batches[:JNP_STEPS]:
        t0 = time.perf_counter()
        plain_state, _ = plain.train_step(plain_state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    plain_ms = 1e3 * float(np.median(plain_s[2:]))
    print(f"[6/28] jnp backend on the same batches: {plain_ms:.3f} ms per step (median of "
          f"{JNP_STEPS - 2} after 2; {card}); fused / jnp step time {ms / plain_ms:.3f}",
          flush=True)

    # (c) grouped steps on a captured graph against eager steps
    group = grouped_phase("fused", state.models, batches, steps_per_epoch, device, card)
    grouped_phase("jnp", state.models, batches, steps_per_epoch, device, card)
    return launches, ms, (system, state, batches[-1]), group


def stacked(batches):
    import torch

    return (torch.stack([b["rays"] for b in batches]), torch.stack([b["rgbs"] for b in batches]))


def k2_calls_since(before):
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    return {k: k2.LAUNCHES[k] - before[k] for k in before}


def param_list(state):
    from nerf_siren_tpu_torch.training.system import parameters

    return [p.detach().clone() for _, _, p in parameters(state.models)]


def change_gap(start, got, want):
    """The largest, over the parameters, of ||(got - start) - (want - start)||
    / ||want - start||: how far the change a run made from `start` lies
    from the change the reference run made, relative to that change."""
    return max(float((g - w).norm() / (w - s).norm().clamp_min(1e-30))
               for s, g, w in zip(start, got, want))


def grouped_phase(backend, models, batches, steps_per_epoch, device, card):
    """Phase 6(c) on one backend: GROUP_STEPS steps as one captured graph
    against as many eager steps, from the same weights, seed and batches."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    n, seed = GROUP_STEPS, SEED + 2
    system = train_system(backend, 1.0, 1.0, steps_per_epoch, device)
    eager = system.state_for(copy.deepcopy(models))
    grouped = system.state_for(copy.deepcopy(models))
    start = param_list(eager)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_losses = []
    for i, b in enumerate(batches[:n]):
        if i == n - 1:
            short = param_list(eager)   # the control: without the last update
        eager, metrics = system.train_step(eager, b, seed=seed)
        eager_losses.append(metrics["train/loss"])
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    before = dict(k2.LAUNCHES)
    t0 = time.perf_counter()
    grouped, _ = system.train_scan_batches(grouped, *stacked(batches[:n]), seed=seed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    group_peak = torch.cuda.max_memory_allocated()
    capture_s = system.last_group.capture_s
    capture_launches = k2_calls_since(before)
    got = system.last_group.steps[:, 0].tolist()
    want = [float(v) for v in eager_losses]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    eager_params = param_list(eager)
    gap = change_gap(start, param_list(grouped), eager_params)
    control = change_gap(start, short, eager_params)
    print(f"[6/28] (c) {backend}: {n} grouped steps on a captured graph vs {n} eager steps, "
          f"same weights, seed and batches: max relative loss difference {loss_rel:.3e} "
          f"(bar {GROUP_LOSS_RTOL}), change gap {gap:.3e} (bar {GROUP_CHANGE_GAP}; the "
          f"control without the last update {control:.3e}, must exceed it); losses eager "
          f"{[f'{v:.6e}' for v in want]}, grouped {[f'{v:.6e}' for v in got]}", flush=True)
    if not loss_rel <= GROUP_LOSS_RTOL or not gap <= GROUP_CHANGE_GAP:
        fail(f"{backend}: grouped steps disagree with eager steps")
    if not control > GROUP_CHANGE_GAP:
        fail(f"{backend}: the change gap does not see a missing last update")
    expect = 2 * n + 2 if backend == "fused" else 0
    if capture_launches != {"fwd": expect, "bwd": expect}:
        fail(f"{backend}: K2 wrappers called {capture_launches} times at the first group, "
             f"expected {expect} each (2 a step at capture, 2 in the warm-up step)")

    # the peak of a one-step group beside the GROUP_STEPS one (its own graph)
    one = system.state_for(copy.deepcopy(models))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system.train_scan_batches(one, *stacked(batches[:1]), seed=seed)
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated()

    # ms per step, eager and grouped in turns, on the next group's batches
    rays_b, rgbs_b = stacked(batches[n:2 * n])
    before = dict(k2.LAUNCHES)
    times = {"eager": [], "grouped": []}
    for _ in range(2):
        for mode in ("eager", "grouped", "grouped", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                eager_losses = []
                for b in batches[n:2 * n]:
                    eager, metrics = system.train_step(eager, b, seed=seed)
                    eager_losses.append(metrics["train/loss"])
            else:
                grouped, _ = system.train_scan_batches(grouped, rays_b, rgbs_b, seed=seed)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0) / n)
    calls = k2_calls_since(before)
    expect = 4 * 2 * n if backend == "fused" else 0
    if calls != {"fwd": expect, "bwd": expect}:
        fail(f"K2's wrappers called {calls} times over 4 eager groups and 4 replays: a "
             f"replay must call them not at all")
    # both runs took the same 5 groups of steps: the replays against the eager steps
    got = system.last_group.steps[:, 0].tolist()
    want = [float(v) for v in eager_losses]
    replay_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    replay_gap = change_gap(start, param_list(grouped), param_list(eager))
    print(f"[6/28] (c) {backend}: after 4 replays and 4 eager groups on the next batches: max "
          f"relative loss difference of the last group {replay_rel:.3e} (bar "
          f"{GROUP_LOSS_RTOL}), change gap over the {5 * n} steps {replay_gap:.3e} (bar "
          f"{GROUP_CHANGE_GAP})", flush=True)
    if not replay_rel <= GROUP_LOSS_RTOL or not replay_gap <= GROUP_CHANGE_GAP:
        fail(f"{backend}: replayed groups disagree with eager steps")
    replay_ms = float(np.median(times["grouped"])) * n
    STEP_MS[backend] = (float(np.median(times["eager"])), float(np.median(times["grouped"])))
    print(f"[6/28] (c) {backend}: ms per step grouped {[round(v, 3) for v in times['grouped']]} "
          f"(median {np.median(times['grouped']):.3f}), eager "
          f"{[round(v, 3) for v in times['eager']]} (median {np.median(times['eager']):.3f}), "
          f"in turns; the capture of {n} steps {capture_s:.3f} s (the first group with its "
          f"warm-up step and a replay {first_s:.3f} s; a replay of the group "
          f"{replay_ms:.1f} ms); K2 wrapper calls at the "
          f"first group {capture_launches}; peak device memory: eager steps "
          f"{eager_peak / 2**30:.3f} GiB, a group of {n} {group_peak / 2**30:.3f} GiB, a group "
          f"of 1 {one_peak / 2**30:.3f} GiB; {card}", flush=True)
    return system, grouped, (rays_b, rgbs_b)


# ---- the fast path (phases 7-13) --------------------------------------------

def kernel_module(name):
    import importlib

    return importlib.import_module(f"nerf_siren_tpu_torch.ops.kernels.{KERNELS[name][0]}")


def reset_counts(names):
    for name in names:
        kernel_module(name).LAUNCHES[KERNELS[name][1]] = 0


def read_counts(names):
    return {name: kernel_module(name).LAUNCHES[KERNELS[name][1]] for name in names}


def percentile(x, q):
    """The q-quantile of a tensor's values (the lower of the two nearest)."""
    v = x.flatten().float().sort().values
    return float(v[int(q * (v.numel() - 1))])


def ball_nerf_params(rng, cfg):
    """A JAX-layout NeRF tree whose density is a ball: sigma = BALL_SIGMA
    (1 - |x| / BALL_R), zero outside it, colour about BALL_RGB. Layer 0
    holds relu(+-n_j . x) for half-width quasi-uniform unit directions n_j
    (the sum of |n_j . x| over them is ~ width |x| / 4), the other trunk
    layers pass it on (identity; the skip layer's embedding columns zero),
    the sigma head subtracts the sum from BALL_SIGMA; every weight carries
    Gaussian noise of std FIELD_NOISE / sqrt(fan-in), so no product is
    trivial."""
    w, emb, half = cfg.width, cfg.in_channels_xyz, cfg.width // 2

    def noisy(i, o):
        return rng.normal(0.0, FIELD_NOISE / math.sqrt(i), (i, o))

    def lin(kernel, bias):
        return {"kernel": kernel.astype(np.float32), "bias": np.asarray(bias, np.float32)}

    j = np.arange(half) + 0.5                      # a Fibonacci sphere
    polar, azim = np.arccos(1 - 2 * j / half), math.pi * (1 + 5 ** 0.5) * j
    n = np.stack([np.cos(azim) * np.sin(polar), np.sin(azim) * np.sin(polar), np.cos(polar)])
    k0 = noisy(emb, w)
    k0[:3, :half] += n
    k0[:3, half:] -= n
    layers = [lin(k0, np.zeros(w))]
    for i in range(1, cfg.depth):
        k = noisy(w + emb if i in cfg.skips else w, w)
        k[-w:] += np.eye(w)
        layers.append(lin(k, np.zeros(w)))
    rgb = np.asarray(BALL_RGB)
    return {"xyz_layers": layers,
            "xyz_final": lin(noisy(w, w), np.zeros(w)),
            "sigma": lin(noisy(w, 1) - BALL_SIGMA / (BALL_R * w / 4), [BALL_SIGMA]),
            "dir_layer": lin(noisy(w + cfg.in_channels_dir, half), np.ones(half)),
            "rgb": lin(noisy(half, 3), np.log(rgb / (1 - rgb)))}


def check_outputs(outs, what, n_rays=H * W):
    """Every output of a whole frame (of `n_rays` rays) finite, rgb in [0, 1 + 1e-3]."""
    import torch

    for out in outs:
        for k, v in out.items():
            if v.shape[0] != n_rays or not torch.isfinite(v).all():
                fail(f"{what} {k}: shape {tuple(v.shape)} or non-finite values")
        rgb = out["rgb_fine"]
        if rgb.min() < 0 or rgb.max() > 1 + 1e-3:
            fail(f"{what} rgb_fine outside [0, 1+1e-3]: {float(rgb.min())}..{float(rgb.max())}")


def psnr_vs(out, ref):
    """PSNR of one frame's rgb against another's (agreement, in dB)."""
    mse = float(((out["rgb_fine"] - ref["rgb_fine"]) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-20))


def render_frames(render, frames_rays):
    """(outputs, host seconds per frame), each frame ending in a sync."""
    import torch

    outs, lat = [], []
    with torch.no_grad():
        for rays in frames_rays:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(render(rays))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    return outs, lat


def clipped_rays(rays, aabb):
    """(R, 8) rays with [near, far] tightened to the scene box, as the fast
    renderer hands them to K3."""
    import torch
    from nerf_siren_tpu_torch.render.fast import _clip_to_aabb

    near, far = _clip_to_aabb(rays[:, :3], rays[:, 3:6], rays[:, 6:7], rays[:, 7:8], aabb)
    return torch.cat([rays[:, :6], near, far], 1).contiguous()


def proxy_flop_per_candidate(packed_proxy):
    """Multiply-adds x 2 of the proxy at one point, from its pack."""
    return 2 * (packed_proxy["w1"].numel() + packed_proxy["w2"].numel())


def int8_work_per_point(packed, full):
    """(bf16 FLOP, int8 operations) of the int8 field at one point: the
    trunk's real int8 columns (no padding) and the bf16 heads."""
    trunk = sum(t.numel() for k, t in packed.items() if k[0] == "q")
    trunk -= sum(t.shape[0] * (t.shape[1] - 60) for k, t in packed.items()
                 if k[0] == "q" and k.endswith("s"))
    heads = packed["w_sigma"].numel()
    if full:
        heads += packed["w_comb"].numel() + packed["w_dir"].numel() + packed["w_rgb"].numel()
    return 2 * heads, 2 * trunk


def k4_weight_bytes(p8):
    """Bytes of the int8 pack that K4 reads: the weight stream (W_comb and
    W_dir included), the row scales, the coordinate columns, the biases and
    the heads."""
    return sum(t.numel() * t.element_size() for k, t in p8.items()
               if k in ("k4_stream", "w_sigma", "w_rgb") or k[0] in "bf" or k.endswith("x"))


def cuobjdump_sass(name):
    """The SASS of csrc/<name>.cu's library (cuobjdump of the build), or None
    where the toolkit has no cuobjdump."""
    import shutil
    from nerf_siren_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        return subprocess.run([tool, "-sass", str(_build.build(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None


def sass_epilogue(name, symbol):
    """(convert, quantise) instructions of a hidden layer's epilogue in the
    SASS of csrc/<name>.cu's `symbol` instantiation (cuobjdump of the build):
    the straight-line block that converts the 128 accumulators (128 exact
    int-to-float additions of 0x4b400000, no dp4a, no wgmma) and the one
    that quantises them without the dump (64 two-byte shared stores, no
    global store), up to its last store. None where the toolkit has no
    cuobjdump or the blocks are not found."""
    import re

    sass = cuobjdump_sass(name)
    if sass is None:
        return None
    funcs = sass.split("Function : ")
    body = next((f for f in funcs if f.startswith("_") and symbol in f.split()[0]), "")
    code = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    targets = set(re.findall(r"BRA(?:\s+\S+,)?\s+0x([0-9a-f]+)", body))
    blocks, cur = [], []
    for addr, text in code:
        if addr.lstrip("0") in {t.lstrip("0") for t in targets} and cur:
            blocks.append(cur)
            cur = []
        cur.append(text)
        if "BRA" in text or "EXIT" in text:
            blocks.append(cur)
            cur = []
    blocks.append(cur)

    def count(b, op):
        return sum(op in t for t in b)

    conv = [b for b in blocks if sum("IADD3" in t and "0x4b400000" in t for t in b) == 128
            and not count(b, "IDP.4A") and not count(b, "GMMA")]
    quant = [b for b in blocks if count(b, "STS.U16") == 64 and not count(b, "STG")]
    if not conv or not quant:
        return None
    last = max(i for i, t in enumerate(quant[0]) if "STS.U16" in t)
    return len(conv[0]), last + 1


def k3_scores_reading(pp, rays8, c, control=False):
    """K3's scores read back at C candidates of every ray, against the plain
    scores: the share that differ, the largest |d| and its ratio to
    `proxy_score_bar`; fails past the bar. With `control`, also the plain
    scores with b1 rounded to bf16 (as a kernel folding b1 into its bf16
    product would give them): fails unless some lie past the bar. Returns
    the kernel's scores."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    got = k3.proxy_march_scores(pp, rays8, c)
    pts = k3.candidate_points(rays8, c)
    ref, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)

    def over(scores):
        d = (scores - ref).abs()
        return d, torch.where(d > 0, d / bar, torch.zeros((), device=d.device))

    d, ratio = over(got)
    n_diff = int((d > 0).sum())
    print(f"[8/28] K3 scores vs plain at {rays8.shape[0]} rays x C {c}: {n_diff} of {d.numel()} "
          f"differ ({100 * n_diff / d.numel():.3f}%), max|d| {float(d.max()):.3e}, max |d| / "
          f"bar {float(ratio.max()):.3e}, median over those that differ "
          f"{float(ratio[d > 0].median()) if n_diff else 0.0:.3e} (bar: proxy_score_bar)",
          flush=True)
    if not torch.isfinite(got).all() or float(ratio.max()) > 1.0:
        fail("K3's scores lie beyond proxy_score_bar of the plain scores")
    if control:
        _, ratio = over(k3.proxy_scores_ref({**pp, "b1": pp["b1"].bfloat16().float()}, pts))
        n_over = int((ratio > 1.0).sum())
        print(f"[8/28] control, the plain scores with b1 rounded to bf16: {n_over} of "
              f"{ratio.numel()} ({100 * n_over / ratio.numel():.3f}%) beyond proxy_score_bar, max "
              f"|d| / bar {float(ratio.max()):.3e}", flush=True)
        if n_over == 0:
            fail("proxy_score_bar does not reject the scores with b1 rounded to bf16")
    return got


def sass_digest(name, symbol):
    """sha256 (16 hex digits) of the SASS instructions of the kernel whose
    mangled name holds `symbol` in csrc/<name>.cu's library (cuobjdump of
    the build; addresses, encodings and the anonymous-namespace ids that
    name the source's path dropped), 'not taken' where the toolkit has no
    cuobjdump, 'not found' where no kernel holds `symbol`."""
    import hashlib
    import re

    sass = cuobjdump_sass(name)
    if sass is None:
        return "not taken"
    body = next((f for f in sass.split("Function : ")[1:] if symbol in f.split()[0]), None)
    if body is None:
        return "not found"
    lines = [re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N_", body.split()[0])]
    lines += re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def timed_result(label, name, kern, plain, flops, n_bytes, err, card, int8_ops=0.0,
                 plain_reps=3):
    ms, plain_ms, (p1, k1, k2, p2) = timed_pair([kern], [plain], plain_reps=plain_reps)
    bound_ms, bound_by = bound(flops, n_bytes, int8_ops)
    print(f"[8/28] {name} {label}: kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
          f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}); bound {bound_ms:.4f} ms ({bound_by}; "
          f"{flops * 1e-12:.4f} TFLOP bf16, {int8_ops * 1e-12:.4f} TOP int8, "
          f"{n_bytes / 1e6:.1f} MB); {card}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def int_mm_chain_ms(p8, n):
    """A reading only, never on the path: the int8 trunk's products at n
    points as `torch._int_mm` calls at K4's shapes (random int8 inputs; no
    scales, quantisation or heads): ms and TOP/s per chain over 3 runs, or
    why the build does not take them."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

    dev = p8["w_sigma"].device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randint(-127, 128, (n, p8["w_sigma"].shape[0]), generator=gen,
                      device=dev).to(torch.int8)
    e = torch.randint(-127, 128, (n, 64), generator=gen, device=dev).to(torch.int8)
    prods = [(h, p8[f"q{i}"].t()) for i in range(1, fm._depth(p8))]
    prods += [(e, p8[f"q{i}s"].t()) for i in range(fm._depth(p8)) if f"q{i}s" in p8]
    ops = 2 * n * sum(b.numel() for _, b in prods)

    def chain():
        for a, b in prods:
            torch._int_mm(a, b)

    try:
        ms = cuda_ms(chain, 3)
    except (RuntimeError, AttributeError) as err:
        return f"not taken ({str(err).splitlines()[0][:80]})"
    finally:
        del h, e
    torch.cuda.empty_cache()
    return f"{ms:.3f} ms ({ops * 1e-12 / (ms * 1e-3):.1f} TOP/s)"


def check_fast_kernels(fast, p8, p16, frame_rays, device, card):
    """Phase 8: K3 (both wrappers), K4 (both) and K6 against their plain
    versions at the fast path's shapes, each timed beside its plain version;
    K4 also beside K1 (the bf16 pack `p16` of the same field) at its shapes."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import _build
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    pp = fast.packed_proxy
    k3_bytes = sum(pp[k].numel() * pp[k].element_size() for k in ("k3_w1t", "b1", "w2", "b2"))
    rays8 = clipped_rays(frame_rays, fast.aabb)
    r = rays8.shape[0]
    span = (rays8[:, 7] - rays8[:, 6]).clamp_min(1e-12)
    results = {}

    # K3 select: C 32, K 16 over a whole frame
    z, xyz = k3.proxy_march_select(pp, rays8, FAST_C, FAST_K, midpoint=True)
    rz, rxyz = k3.proxy_march_select_ref(pp, rays8, FAST_C, FAST_K, midpoint=True)
    torch.cuda.synchronize()
    if not (torch.isfinite(z).all() and torch.isfinite(xyz).all()):
        fail("proxy_march_select: non-finite output")
    dz = (z - rz).abs() / span[:, None]
    med, p99 = float(dz.median()), percentile(dz, 0.99)
    err = float(torch.maximum((z - rz).abs().amax(), (xyz - rxyz).abs().amax()))
    print(f"[8/28] proxy_march_select vs plain at {r} rays, C {FAST_C}, K {FAST_K}: depth "
          f"|d|/(far-near) median {med:.3e}, 99th pct {p99:.3e} (bars {DEPTH_BARS}); "
          f"{int((z != rz).sum())} of {z.numel()} depths differ; max|d| {err:.3e}", flush=True)
    if not (med < DEPTH_BARS[0] and p99 < DEPTH_BARS[1]):
        fail("proxy_march_select disagrees with its plain version")
    del rz, rxyz, dz

    # K3's own scores: within proxy_score_bar of the plain ones, and the plain
    # march on them equal to both kernels' outputs bit for bit
    scores = k3_scores_reading(pp, rays8, FAST_C)
    oz, oxyz = k3.proxy_march_select_ref(pp, rays8, FAST_C, FAST_K, midpoint=True, scores=scores)
    same_sel = torch.equal(oz, z) and torch.equal(oxyz, xyz)
    del scores, oz, oxyz
    op = k3.proxy_opacity(pp, rays8, PREPASS_C)
    scores = k3_scores_reading(pp, rays8, PREPASS_C)
    same_op = torch.equal(k3.proxy_opacity_ref(pp, rays8, PREPASS_C, scores=scores), op)
    del scores
    print(f"[8/28] the plain march on K3's own scores vs the kernels at {r} rays: select (C "
          f"{FAST_C}, K {FAST_K}) {'bit-equal' if same_sel else 'DIFFERENT'}, opacity (C "
          f"{PREPASS_C}) {'bit-equal' if same_op else 'DIFFERENT'}", flush=True)
    if not (same_sel and same_op):
        fail("the plain march on K3's own scores differs from the kernel")

    # K3 select at the path's shape: one chunk of the frame's rays, bit-equal
    # to the same rays in the frame's launch (a ray's outputs do not depend on
    # its batch), so it is held to the frame's bars; the plain scores with b1
    # rounded to bf16 on its candidates must lie past proxy_score_bar
    pick = torch.as_tensor(np.random.default_rng(SEED + 3).permutation(r)[:CHUNK], device=device)
    chunk = rays8[pick]
    cz, cxyz = k3.proxy_march_select(pp, chunk, FAST_C, FAST_K, midpoint=True)
    crz, crxyz = k3.proxy_march_select_ref(pp, chunk, FAST_C, FAST_K, midpoint=True)
    err = float(torch.maximum((cz - crz).abs().amax(), (cxyz - crxyz).abs().amax()))
    same_chunk = torch.equal(cz, z[pick]) and torch.equal(cxyz, xyz[pick])
    print(f"[8/28] proxy_march_select at one chunk of {CHUNK} rays vs the same rays in the "
          f"frame's launch: {'bit-equal' if same_chunk else 'DIFFERENT'}; max|d| vs plain "
          f"{err:.3e}", flush=True)
    if not same_chunk:
        fail("proxy_march_select's chunk differs from the same rays in the frame's launch")
    del cz, cxyz, crz, crxyz, z, xyz
    k3_scores_reading(pp, chunk, FAST_C, control=True)
    res = timed_result(
        f"at one chunk of {CHUNK} rays", "proxy_march_select",
        lambda: k3.proxy_march_select(pp, chunk, FAST_C, FAST_K, midpoint=True),
        lambda: k3.proxy_march_select_ref(pp, chunk, FAST_C, FAST_K, midpoint=True),
        CHUNK * FAST_C * proxy_flop_per_candidate(pp), CHUNK * (32 + 16 * FAST_K) + k3_bytes, err,
        card, plain_reps=1)
    # a chunk takes the card about as long as its wrapper takes the host: the
    # JSON line's time is queued behind a device-side sleep, as K5's
    queued = [cuda_ms(lambda: k3.proxy_march_select(pp, chunk, FAST_C, FAST_K, midpoint=True),
                      K5_REPS, queued=True) for _ in range(K3_QUEUED)]
    unqueued = res["ms"]
    res.update(ms=float(np.median(queued)), timing="queued")
    results["proxy_march_select"] = res
    one_ms = cuda_ms(lambda: k3.proxy_march_select(pp, rays8, FAST_C, FAST_K, midpoint=True), 5)
    n_chunks = -(-r // CHUNK)
    print(f"[8/28] proxy_march_select: {res['ms']:.4f} ms a chunk of {CHUNK} rays queued "
          f"(median of {[round(t, 4) for t in queued]}; unqueued {unqueued:.4f}), "
          f"{100 * res['bound_ms'] / res['ms']:.1f}% of its bound; x {n_chunks} = "
          f"{n_chunks * res['ms']:.3f} ms a frame in chunks; beside one launch over all {r} "
          f"rays {one_ms:.3f} ms ({one_ms * CHUNK / r:.4f} ms per {CHUNK} rays); earlier "
          f"CUDA-core kernel {EARLIER_K3_MS['chunk']} ms a chunk, {EARLIER_K3_MS['one launch']} "
          f"ms in one launch (another call); {card}", flush=True)

    # K3 opacity prepass: C 16 over a whole frame
    rop = k3.proxy_opacity_ref(pp, rays8, PREPASS_C)
    torch.cuda.synchronize()
    d = (op - rop).abs()
    err = float(d.max())
    print(f"[8/28] proxy_opacity vs plain at {r} rays, C {PREPASS_C}: median |d| "
          f"{float(d.median()):.3e}, max {err:.3e} (bars {OPACITY_BARS}); "
          f"{int((op != rop).sum())} of {r} differ", flush=True)
    if not torch.isfinite(op).all() or not (float(d.median()) < OPACITY_BARS[0]
                                            and err < OPACITY_BARS[1]):
        fail("proxy_opacity disagrees with its plain version")
    results["proxy_opacity"] = timed_result(
        f"at {r} rays", "proxy_opacity", lambda: k3.proxy_opacity(pp, rays8, PREPASS_C),
        lambda: k3.proxy_opacity_ref(pp, rays8, PREPASS_C),
        r * PREPASS_C * proxy_flop_per_candidate(pp), r * (32 + 4) + k3_bytes, err, card,
        plain_reps=1)
    res = results["proxy_opacity"]
    print(f"[8/28] proxy_opacity: {100 * res['bound_ms'] / res['ms']:.1f}% of its bound; "
          f"earlier CUDA-core kernel {EARLIER_K3_MS['opacity']} ms (another call)", flush=True)
    hidden = pp["w1"].shape[0]
    report = ptxas_report("proxy_march")
    for name, epi, c in (("proxy_march_select", 1, FAST_C), ("proxy_opacity", 0, PREPASS_C)):
        sym = f"proxy_march_kernelILi{k3.k3_width(hidden)}ELi{epi}ELb0E"
        regs, spills, stack = next(v for k, v in report.items() if sym in k)
        print(f"[8/28] {name} build (-Xptxas -v, hidden {hidden} -> wgmma width "
              f"{k3.k3_width(hidden)}): {regs} registers, {spills} spill bytes, {stack} bytes "
              f"stack frame; {k3.shared_bytes(hidden, c)} bytes dynamic shared memory at C "
              f"{c}", flush=True)
    for sym, before in K3_SASS_DIGESTS.items():
        digest = sass_digest("proxy_march", sym)
        print(f"[8/28] {sym} SASS digest {digest}: "
              f"{'unchanged from' if digest == before else 'DIFFERS from'} the build of the tree "
              f"before K6 joined csrc/proxy_march.cu, {before} (nvcc 12.8; a reading)", flush=True)

    # K4 at N_CHECK random points, then at one chunk's survivors and coarse points
    rng = np.random.default_rng(SEED + 4)
    pts = torch.tensor(rng.uniform(-4.0, 4.0, (N_CHECK, 3)), dtype=torch.float32, device=device)
    dirs = torch.tensor(rng.normal(size=(N_CHECK, 3)), dtype=torch.float32, device=device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pick = torch.as_tensor(rng.permutation(r)[:CHUNK], device=device)
    sel = rays8[pick]
    zs = k3.proxy_march_select(pp, sel, FAST_C, FAST_K, midpoint=True)[0]
    surv = (sel[:, None, :3] + sel[:, None, 3:6] * zs[..., None]).reshape(-1, 3).contiguous()
    sel_dirs = sel[:, 3:6].contiguous()
    zc = torch.linspace(NEAR, FAR, N_SAMPLES, device=device)
    coarse = (frame_rays[pick][:, None, :3] + frame_rays[pick][:, None, 3:6] * zc[:, None]
              ).reshape(-1, 3).contiguous()
    def full_surv():
        return k4.fused_nerf_full_int8(p8, surv, sel_dirs, FAST_K)

    def full_surv_ref():
        return k4.fused_full_int8_ref(p8, surv, sel_dirs, FAST_K)

    def sigma_coarse():
        return k4.fused_nerf_sigma_int8(p8, coarse)

    def sigma_coarse_ref():
        return k4.fused_sigma_int8_ref(p8, coarse)

    errs = {"fused_nerf_full_int8": 0.0, "fused_nerf_sigma_int8": 0.0}
    for name, where, kern, plain in (
            ("fused_nerf_full_int8", f"at N={N_CHECK}",
             lambda: k4.fused_nerf_full_int8(p8, pts, dirs),
             lambda: k4.fused_full_int8_ref(p8, pts, dirs)),
            ("fused_nerf_sigma_int8", f"at N={N_CHECK}",
             lambda: k4.fused_nerf_sigma_int8(p8, pts), lambda: k4.fused_sigma_int8_ref(p8, pts)),
            ("fused_nerf_full_int8", f"at {CHUNK} rays x {FAST_K} survivors, samples_per_dir "
             f"{FAST_K}", full_surv, full_surv_ref),
            ("fused_nerf_sigma_int8", f"at {CHUNK} rays x {N_SAMPLES} coarse points",
             sigma_coarse, sigma_coarse_ref)):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name} {where}: shape {tuple(got.shape)} or non-finite output")
        d = (got - ref).abs()
        sig_bad = int((d[:, -1] > INT8_SIGMA_TOL[0] + INT8_SIGMA_TOL[1] * ref[:, -1].abs()).sum())
        rgb_bad = int((d[:, :-1] > INT8_RGB_ATOL).sum())
        errs[name] = max(errs[name], float(d.max()))
        print(f"[8/28] {name} vs plain {where}: max|d| per column "
              f"{[f'{v:.2e}' for v in d.amax(0).tolist()]}; {rgb_bad} rgb outside atol "
              f"{INT8_RGB_ATOL}, {sig_bad} sigma outside {INT8_SIGMA_TOL[0]} + "
              f"{INT8_SIGMA_TOL[1]}|ref|", flush=True)
        if sig_bad or rgb_bad:
            fail(f"{name} disagrees with its plain version {where}")
    n_flip = 65536
    flips = (k4.int8_trunk_inputs(p8, surv[:n_flip]) != k4.int8_trunk_inputs_ref(p8, surv[:n_flip]))
    print(f"[8/28] int8 layer inputs rounded apart, kernel vs plain, at {n_flip} survivors: "
          f"{flips.sum(dim=(1, 2)).tolist()} per layer of {n_flip * 256}", flush=True)
    del pts, dirs, flips
    lib = _build.load("fused_mlp_int8")
    report = ptxas_report("fused_mlp_int8")
    n_emb = sum(1 for k in p8 if k[0] == "q" and k.endswith("x"))
    epi = sass_epilogue("fused_mlp_int8", K4_SYMBOLS["fused_nerf_sigma_int8"])
    print("[8/28] fused_nerf_sigma_int8 SASS, one hidden layer's epilogue per thread: " +
          (f"{epi[0]} instructions converting its 128 accumulators, {epi[1]} adding the bias, "
           f"ReLU and absmax and quantising them: {sum(epi) / 128:.2f} per element"
           if epi else "not found"), flush=True)
    for name, n, full, kern, plain, bf16_kern in (
            ("fused_nerf_full_int8", surv.shape[0], True, full_surv, full_surv_ref,
             lambda: fm.fused_nerf_full(p16, surv, sel_dirs, FAST_K)),
            ("fused_nerf_sigma_int8", coarse.shape[0], False, sigma_coarse, sigma_coarse_ref,
             lambda: fm.fused_nerf_sigma(p16, coarse))):
        f_bf16, i8 = int8_work_per_point(p8, full)
        n_bytes = (n * (12 + (16 if full else 4)) + (sel_dirs.numel() * 4 if full else 0)
                   + k4_weight_bytes(p8))
        res = timed_result(f"at {n} points", name, kern, plain, n * f_bf16, n_bytes, errs[name],
                           card, int8_ops=n * i8)
        ms4, ms1, (a1, b1, b2, a2) = timed_pair([kern], [bf16_kern])   # K1, K4, K4, K1
        regs, spills, stack = next(v for k, v in report.items() if K4_SYMBOLS[name] in k)
        print(f"[8/28] {name} at {n} points: {n * i8 * 1e-12 / (res['ms'] * 1e-3):.1f} TOP/s "
              f"int8 + {n * f_bf16 * 1e-12 / (res['ms'] * 1e-3):.1f} TFLOP/s bf16, "
              f"{100 * res['bound_ms'] / res['ms']:.1f}% of the bound; earlier mma.sync kernel "
              f"{EARLIER_K4_MS[name]} ms (another call; {EARLIER_K4_MS[name] / res['ms']:.1f}x); "
              f"K1 on the bf16 pack of the same field at the same points {ms1:.3f} ms ({a1:.3f}, "
              f"{a2:.3f}) in turns with K4 {ms4:.3f} ms ({b1:.3f}, {b2:.3f}): int8 / bf16 time "
              f"{ms4 / ms1:.3f}; build (-Xptxas -v): {regs} registers at entry, {spills} spill "
              f"bytes, {stack} bytes stack frame; "
              f"{lib.nerf_field_int8_smem_bytes(256, int(full), fm._depth(p8), n_emb)} bytes "
              f"dynamic shared memory; torch._int_mm over the same trunk products "
              f"{int_mm_chain_ms(p8, n)} (a reading); {card}", flush=True)
        results[name] = res

    # K6: 65,536 rays of the frame, C 64, K 16; its own scores within the bar,
    # the plain selection on them its depths bit for bit, and every set that
    # differs from the plain one a near tie within the bars
    rays6 = rays8[torch.as_tensor(rng.permutation(r)[:K6_RAYS], device=device)]
    got = k6.proxy_select(pp, rays6, K6_C, K6_K)
    scores, z_read = k6.proxy_select_scores(pp, rays6, K6_C, K6_K)
    zc = k6.candidate_depths(rays6, K6_C)
    pts = rays6[:, None, 0:3] + rays6[:, None, 3:6] * zc[..., None]
    ref, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)
    torch.cuda.synchronize()
    d = (scores - ref).abs()
    ratio = torch.where(d > 0, d / bar, torch.zeros((), device=device))
    n_diff = int((d > 0).sum())
    same = torch.equal(got, z_read) and torch.equal(
        got, k6.proxy_select_ref(pp, rays6, K6_C, K6_K, scores=scores))
    n_sets, worst = k6.cut_swaps(ref, bar, scores, K6_K)
    err = float((got - k6.proxy_select_ref(pp, rays6, K6_C, K6_K)).abs().max())
    print(f"[8/28] proxy_select at {K6_RAYS} rays, C {K6_C}, K {K6_K}: scores vs plain {n_diff} "
          f"of {d.numel()} differ ({100 * n_diff / d.numel():.3f}%), max |d| / bar "
          f"{float(ratio.max()):.3e} (bar: proxy_score_bar); the plain selection on the kernel's "
          f"scores {'bit-equal, in order' if same else 'DIFFERENT'}; {n_sets} of {K6_RAYS} rays "
          f"({100 * n_sets / K6_RAYS:.3f}%) keep another set than the plain version, worst swap "
          f"/ its bars {worst:.3e}; depths max|d| vs plain {err:.3e}", flush=True)
    if not torch.isfinite(scores).all() or float(ratio.max()) > 1.0:
        fail("proxy_select's scores lie beyond proxy_score_bar of the plain scores")
    if not same:
        fail("the plain selection on proxy_select's own scores differs from the kernel")
    if worst > 1.0:
        fail("proxy_select keeps a set that differs from the plain one beyond a near tie")
    del scores, z_read, zc, pts, ref, bar, d, ratio
    res = timed_result(
        f"at {K6_RAYS} rays", "proxy_select", lambda: k6.proxy_select(pp, rays6, K6_C, K6_K),
        lambda: k6.proxy_select_ref(pp, rays6, K6_C, K6_K),
        K6_RAYS * K6_C * proxy_flop_per_candidate(pp), K6_RAYS * (32 + 4 * K6_K) + k3_bytes, err,
        card)
    results["proxy_select"] = res
    regs, spills, stack = next(v for k, v in ptxas_report("proxy_march").items()
                               if TOPK_SYMBOL in k)
    print(f"[8/28] proxy_select: {100 * res['bound_ms'] / res['ms']:.1f}% of its bound; the "
          f"CUDA-core kernel {EARLIER_K6_MS} ms (another call; {EARLIER_K6_MS / res['ms']:.2f}x); "
          f"build (-Xptxas -v, {TOPK_SYMBOL}): {regs} registers, {spills} spill bytes, {stack} "
          f"bytes stack frame; {k3.shared_bytes(hidden, K6_C)} bytes dynamic shared memory at C "
          f"{K6_C}; {card}", flush=True)
    return results


def fast_phases(frames_rays, device, card, args):
    """Phases 7-13. Returns (results, launches) of K3, K4 and K6, and the
    ball field's checkpoint and exact rgb frames (H, W, 3) of the lego
    cameras (phase 24's views)."""
    import os
    from pathlib import Path

    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import (field_sigma_fn, get_opts, make_renderer,
                                           setup_fast_proxy)
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6
    from nerf_siren_tpu_torch.ops.kernels.fused_mlp_int8 import pack_model_params_int8
    from nerf_siren_tpu_torch.render.fast import estimate_scene_aabb, render_rays_fast
    from nerf_siren_tpu_torch.convert import nerf_to_jax
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint

    # ---- 7. a field with empty space, its exact frames, the proxy and box ----
    models = numpy_models(FIELD_SEED, device, ball_nerf_params)
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    exact, exact_lat = render_frames(make_renderer(models, cfg, renderer="fused"), frames_rays)
    check_outputs(exact, "exact frame")
    empty = [float((o["opacity_fine"] < 0.01).float().mean()) for o in exact]
    print(f"[7/28] exact frames of the ball field (density {BALL_SIGMA} (1 - |x|/{BALL_R}), "
          f"weight noise {FIELD_NOISE}; {N_SAMPLES}+{N_IMPORTANCE}): latency s "
          f"{[round(t, 4) for t in exact_lat]} ({card}); share of rays with opacity < 0.01 "
          f"per frame {[round(e, 4) for e in empty]}", flush=True)
    if min(empty) <= 0.0:
        fail("the ball field has no empty rays: nothing could be culled")

    ckpt_dir = Path("ckpts") / "chip_smoke"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt = str(ckpt_dir / "ball.msgpack")
    save_checkpoint(ckpt, {"params": {f"nerf_{k}": nerf_to_jax(m.state_dict())
                                      for k, m in models.items()}})
    if os.path.exists(ckpt + ".proxy.msgpack"):
        os.remove(ckpt + ".proxy.msgpack")      # distil afresh every run

    def opts(*extra):
        return get_opts(["--root_dir", str(ckpt_dir), "--ckpt_path", ckpt, "--renderer", "fast",
                         "--chunk", str(CHUNK), *extra])

    bounds = np.array([NEAR, FAR], np.float32)
    hp = opts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = setup_fast_proxy(models, hp, bounds)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    half = float(np.max(np.abs(bounds))) * 0.5
    t0 = time.perf_counter()
    box = estimate_scene_aabb(field_sigma_fn(models)[1], [-half] * 3, [half] * 3)
    t_box = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = setup_fast_proxy(models, hp, bounds)
    t_cached = time.perf_counter() - t0
    print(f"[7/28] proxy distilled ({hp.fast_distill_steps} steps, batch "
          f"{hp.fast_distill_batch}, hidden {fast.proxy.l1.weight.shape[0]}) and box estimated "
          f"in {t_setup:.2f} s, the box alone {t_box:.3f} s ({card}); box "
          f"{np.round(fast.aabb[0], 3).tolist()}..{np.round(fast.aabb[1], 3).tolist()}; read "
          f"back from the cache in {t_cached:.3f} s", flush=True)
    if not all(np.array_equal(a, b) for a, b in zip(box, fast.aabb)) or not all(
            np.array_equal(a, b) for a, b in zip(cached.aabb, fast.aabb)):
        fail("the scene box differs between its estimate, the setup and the cache")
    if not all(torch.equal(cached.packed_proxy[k], fast.packed_proxy[k])
               for k in fast.packed_proxy):
        fail("the cached proxy differs from the distilled one")
    results = check_fast_kernels(fast, pack_model_params_int8(models)[fast.model_key],
                                 fm.pack_model_params(models)[fast.model_key], frames_rays[0],
                                 device, card)
    launches = {}

    # ---- 9. fast frames through the CLI's renderer ----------------------------
    render = make_renderer(models, cfg, renderer="fast", fast=fast, hparams=hp, img_hw=(H, W))
    names = ["proxy_march_select", "fused_nerf_full"]
    reset_counts(names)
    outs, lat = render_frames(render, frames_rays)
    counts = read_counts(names)
    launches["proxy_march_select"] = counts["proxy_march_select"]
    n_chunks = -(-H * W // CHUNK)
    print(f"[9/28] {N_FRAMES} fast frames of {H}x{W} (C {hp.fast_candidates}, K "
          f"{hp.fast_keep}, {hp.fast_select}, {hp.fast_placement}, {hp.fast_quadrature}): "
          f"latency s {[round(t, 4) for t in lat]}, {H * W / np.median(lat):.0f} rays/s at the "
          f"median frame ({card}); launches {counts}; PSNR vs the exact frames "
          f"{[round(psnr_vs(o, e), 2) for o, e in zip(outs, exact)]} dB", flush=True)
    for name in names:
        if counts[name] < n_chunks * N_FRAMES:
            fail(f"{name} launched {counts[name]} times, expected >= {n_chunks * N_FRAMES}")
    check_outputs(outs, "fast frame")
    cpu_pack = fm.pack_model_params({k: copy.deepcopy(m).cpu() for k, m in models.items()},
                                    "cpu")
    with torch.no_grad():
        ref = render_rays_fast(None, None, frames_rays[0][CHECK_RAYS].cpu(),
                               n_candidates=FAST_C, n_keep=FAST_K, model=fast.model_key,
                               white_back=True, scene_aabb=fast.aabb, select="pdf",
                               packed_params=cpu_pack,
                               packed_proxy={k: v.cpu() for k, v in fast.packed_proxy.items()})
    errs = {}
    for k, v in ref.items():
        d = (outs[0][k][CHECK_RAYS].cpu() - v).abs() / max(1.0, float(v.abs().max()))
        errs[k] = (float(d.median()), percentile(d, 0.99))
    print(f"[9/28] {CHECK_RAYS.stop - CHECK_RAYS.start} rays of frame 0 vs a CPU re-render on "
          f"the plain versions: (median, 99th pct) of |d| / scale {errs} (bars {FAST_BARS})",
          flush=True)
    if any(m >= FAST_BARS[0] or p >= FAST_BARS[1] for m, p in errs.values()):
        fail("the fast frame disagrees with its plain re-render")
    if args.profile:
        with torch.no_grad():
            profile("fast frame", lambda: render(frames_rays[1]), card)

    # ---- 10. --fast_cull auto -------------------------------------------------
    auto = make_renderer(models, cfg, renderer="fast", fast=fast,
                         hparams=opts("--fast_cull", "auto"), img_hw=(H, W))
    reset_counts(["proxy_opacity"])
    key = fast.model_key
    with torch.no_grad():
        for i in range(N_AUTO):
            k = i % N_FRAMES
            (out,), (sec,) = render_frames(auto, [frames_rays[k]])
            ref = outs[k]
            same = ((out[f"rgb_{key}"] - ref[f"rgb_{key}"]).abs().amax(-1) <= 1e-6)
            for name in ("depth", "opacity"):
                same &= (out[f"{name}_{key}"] - ref[f"{name}_{key}"]).abs() <= 1e-6
            bg = ((out[f"rgb_{key}"] == 1.0).all(-1) & (out[f"depth_{key}"] == 0)
                  & (out[f"opacity_{key}"] == 0))
            lost = int((bg & ~same & (ref[f"opacity_{key}"] > 0.01)).sum())
            print(f"[10/28] auto-cull frame {i} (camera {k}): {sec:.4f} s ({card}); active "
                  f"fraction {auto.last_active_frac:.4f}, bypass {auto.last_plain}, eps "
                  f"{float(auto.last_eps):.5f}; {int((same & ~bg).sum())} rays rendered, "
                  f"{int((bg & ~same).sum())} culled to background ({lost} of them visible "
                  f"in the fast frame); PSNR vs the exact frame {psnr_vs(out, exact[k]):.2f} dB",
                  flush=True)
            check_outputs([out], "auto-cull frame")
            if not bool((same | bg).all()):
                fail("an auto-cull ray is neither the fast frame's value nor background")
    launches.update(read_counts(["proxy_opacity"]))
    if launches["proxy_opacity"] < 1:
        fail("the auto-cull run never launched the opacity prepass")

    # ---- 11. int8 field on the fast and the fused renderer ----------------------
    hp8 = opts("--fast_field_dtype", "int8")
    fast8 = setup_fast_proxy(models, hp8, bounds)
    names = ["fused_nerf_full_int8", "fused_nerf_sigma_int8"]
    reset_counts(names)
    fast_int8 = make_renderer(models, cfg, renderer="fast", fast=fast8, hparams=hp8,
                              img_hw=(H, W))
    exact_int8 = make_renderer(models, cfg, renderer="fused", field_dtype="int8")
    (out_f8, _), sec_f8 = render_frames(fast_int8, frames_rays[:2])
    (out_x8, _), sec_x8 = render_frames(exact_int8, frames_rays[:2])
    launches.update(read_counts(names))
    check_outputs([out_f8, out_x8], "int8 frame")
    d_fast = float((out_f8["rgb_fine"] - outs[0]["rgb_fine"]).abs().max())
    d_fused = float((out_x8["rgb_fine"] - exact[0]["rgb_fine"]).abs().max())
    print(f"[11/28] int8 frames (cameras 0 and 1): fast latency s {[round(t, 4) for t in sec_f8]} "
          f"against the bf16 fast frames' {[round(t, 4) for t in lat]} (rgb max|d| vs the bf16 "
          f"fast frame {d_fast:.4f}, PSNR vs exact {psnr_vs(out_f8, exact[0]):.2f} dB), fused "
          f"{[round(t, 4) for t in sec_x8]} against the bf16 exact frames' "
          f"{[round(t, 4) for t in exact_lat]} (rgb max|d| vs the bf16 exact frame "
          f"{d_fused:.4f}, PSNR {psnr_vs(out_x8, exact[0]):.2f} dB); bar {INT8_VS_BF16}; "
          f"launches {read_counts(names)} ({card})", flush=True)
    if min(launches[n] for n in names) < 1 or max(d_fast, d_fused) >= INT8_VS_BF16:
        fail("the int8 frames did not run on K4 or moved from the bf16 frames")
    if args.profile:
        with torch.no_grad():
            profile("int8 fast frame", lambda: fast_int8(frames_rays[1]), card)
            profile("int8 exact frame", lambda: exact_int8(frames_rays[1]), card)

    # ---- 12. edge refinement ------------------------------------------------------
    edge = make_renderer(models, cfg, renderer="fast", fast=fast,
                         hparams=opts("--fast_edge_refine", str(EDGE_CAP)), img_hw=(H, W))
    (out_e,), (sec_e,) = render_frames(edge, [frames_rays[0]])
    check_outputs([out_e], "edge-refined frame")
    print(f"[12/28] edge-refined frame (cap {EDGE_CAP}, {edge.n_edge} slots): {sec_e:.4f} s "
          f"({card}); "
          f"{int(edge.last_refined)} rays refined; PSNR vs exact {psnr_vs(out_e, exact[0]):.2f} "
          f"dB (fast frame {psnr_vs(outs[0], exact[0]):.2f} dB)", flush=True)

    # ---- 13. K6 over one frame -------------------------------------------------------
    rays8 = clipped_rays(frames_rays[0], fast.aabb)
    reset_counts(["proxy_select"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z6 = k6.proxy_select(fast.packed_proxy, rays8, K6_C, K6_K)
    torch.cuda.synchronize()
    sec6 = time.perf_counter() - t0
    launches.update(read_counts(["proxy_select"]))
    inside = ((z6 >= rays8[:, 6:7] - 1e-5) & (z6 <= rays8[:, 7:8] + 1e-5)).all()
    print(f"[13/28] proxy_select over {rays8.shape[0]} rays (C {K6_C}, K {K6_K}): {sec6:.4f} s "
          f"({card}); the tree before the redesign {EARLIER_K6_FRAME_S} s (another call); "
          f"launches {launches['proxy_select']}", flush=True)
    if z6.shape != (H * W, K6_K) or not torch.isfinite(z6).all() or not bool(inside):
        fail("proxy_select's depths are not finite or leave their rays' [near, far]")
    return results, launches, (ckpt, [o["rgb_fine"].reshape(H, W, 3) for o in exact])


# ---- EG3D exact eval on K5 (phases 14-17) ---------------------------------------

def numpy_eg3d_params(rng, cfg):
    """A JAX-layout `eg3d_renderer` tree at `cfg` with `init_eg3d_renderer`'s
    shapes and distributions: FC weights N(0, 1) / lr_multiplier (0.01 in
    the mapping), affine biases 1, other biases 0, convolution weights,
    consts, noise_const and z N(0, 1), noise strengths and w_avg 0."""
    g = cfg.backbone
    syn = g.synthesis

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def fc(i, o, lr=1.0, bias_init=0.0):
        return {"weight": normal(o, i) / np.float32(lr), "bias": np.full(o, bias_init, np.float32)}

    def layer(i, o, res):
        return {"affine": fc(g.w_dim, i, bias_init=1.0), "weight": normal(o, i, 3, 3),
                "bias": np.zeros(o, np.float32), "noise_const": normal(res, res),
                "noise_strength": np.zeros((), np.float32)}

    feats = [g.z_dim] + [g.w_dim] * g.mapping_layers
    synthesis = {}
    for res in syn.block_resolutions:
        out = syn.channels(res)
        block = ({"const": normal(out, res, res)} if res == 4
                 else {"conv0": layer(syn.channels(res // 2), out, res)})
        block["conv1"] = layer(out, out, res)
        block["torgb"] = {"affine": fc(g.w_dim, out, bias_init=1.0),
                          "weight": normal(syn.img_channels, out, 1, 1),
                          "bias": np.zeros(syn.img_channels, np.float32)}
        synthesis[f"b{res}"] = block
    return {"backbone": {"mapping": {"fcs": [fc(i, o, lr=0.01) for i, o in
                                             zip(feats[:-1], feats[1:])],
                                     "w_avg": np.zeros(g.w_dim, np.float32)},
                         "synthesis": synthesis},
            "decoder": {"fc1": fc(cfg.plane_channels, 64), "fc2": fc(64, 4)},
            "z": normal(1, g.z_dim)}


def synced_s(fn):
    """(result, host seconds) of fn(), ending in a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eg3d_setup(device, card):
    """Phase 14: the weights through a msgpack checkpoint and the CLI's load
    path; mapping + synthesis timed. Returns (hparams, model, seconds per
    synthesis)."""
    from pathlib import Path

    from nerf_siren_tpu_torch.eval_eg3d import get_opts, load_model, triplane_config
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    ckpt_dir = Path("ckpts") / "chip_smoke"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt = str(ckpt_dir / "eg3d.msgpack")
    hp = get_opts(["--root_dir", str(ckpt_dir), "--ckpt_path", ckpt, "--plane_sampler", "kernel"])
    cfg = triplane_config(hp, white_back=True)     # the Blender loader's white background
    t0 = time.perf_counter()
    save_checkpoint(ckpt, {"eg3d_renderer": numpy_eg3d_params(np.random.default_rng(EG3D_SEED),
                                                              cfg)})
    t_save = time.perf_counter() - t0
    system = EG3DSystem(cfg, hp.plane_sampler)
    model, t_load = synced_s(lambda: load_model(system, ckpt, device))
    n_params = sum(p.numel() for p in model.parameters())
    synth = [synced_s(lambda: system.frame_planes(model))[1] for _ in range(4)]
    print(f"[14/28] EG3D renderer ({n_params} parameters; planes {cfg.n_planes} x "
          f"{cfg.plane_channels} x {cfg.plane_resolution}², channel_base {cfg.channel_base}, "
          f"channel_max {cfg.channel_max}): checkpoint written in {t_save:.2f} s, read by the "
          f"CLI's load_model in {t_load:.2f} s; mapping + synthesis + bf16 packing ms "
          f"{[round(1e3 * t, 3) for t in synth]} ({card})", flush=True)
    return hp, system, model, float(np.median(synth[1:]))


def frame_points(system, model, packed, rays, chunk):
    """Every point the importance renderer samples for these rays (coarse,
    then fine, chunk by chunk), recorded at the sampler."""
    import torch
    from nerf_siren_tpu_torch.render.triplane import (importance_render,
                                                      make_kernel_plane_sampler)

    sampler = make_kernel_plane_sampler(packed, system.cfg.rendering.box_warp)
    pts = []

    def record(coords):
        pts.append(coords[0])
        return sampler(coords)

    with torch.no_grad():
        for i in range(0, rays.shape[0], chunk):
            t = rays[i: i + chunk]
            importance_render(packed, model.decoder, t[None, :, :3], t[None, :, 3:6],
                              system.cfg.rendering, packed=True, sampler=record)
    return torch.cat(pts).contiguous()


def check_triplane_gather(system, model, frame_rays, chunk, device, card):
    """Phase 15: K5 against its plain version and F.grid_sample on the
    frame's table at the path's shapes; each timed."""
    import torch
    import torch.nn.functional as F
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5
    from nerf_siren_tpu_torch.render.triplane import sample_stratified

    rendering = system.cfg.rendering
    scale = 2.0 / rendering.box_warp
    packed = system.frame_planes(model)
    table = packed[0]
    n_planes, _, _, c = table.shape
    first = frame_rays[:chunk]
    z = sample_stratified(first[None, :, :3], rendering.ray_start, rendering.ray_end,
                          rendering.depth_resolution)[0]
    coarse = (first[:, None, :3] + z * first[:, None, 3:6]).reshape(-1, 3).contiguous()
    rng = np.random.default_rng(EG3D_SEED + 1)
    random = torch.tensor(rng.uniform(-1.05, 1.05, (K5_RANDOM, 3)) * rendering.box_warp / 2,
                          dtype=torch.float32, device=device)
    planes32 = table[:, 1:-1, 1:-1, :].float().permute(0, 3, 1, 2).contiguous()   # (3, C, H, W)
    planes16 = planes32.to(torch.bfloat16)
    t_scale = float(table.float().abs().max())

    def grid(xyz):
        return k5.project_to_planes(xyz * scale)[:, None].contiguous()             # (3, 1, M, 2)

    def library(planes, g):
        return F.grid_sample(planes, g.to(planes.dtype), mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    err = 0.0
    for label, xyz in (("one chunk's coarse points", coarse),
                       ("all points of the frame", frame_points(system, model, packed,
                                                                frame_rays, chunk)),
                       ("random points within 1.05 x box_warp / 2", random)):
        got, ref = k5.triplane_gather(table, xyz, scale), k5.triplane_gather_ref(table, xyz, scale)
        torch.cuda.synchronize()
        if got.shape != (n_planes, xyz.shape[0], c) or not torch.isfinite(got).all():
            fail(f"triplane_gather {label}: shape {tuple(got.shape)} or non-finite values")
        n_diff = int((got != ref).sum())
        lib = library(planes32, grid(xyz))[:, :, 0].permute(0, 2, 1)
        lib_err = float((got - lib).abs().max())
        err = max(err, float((got - ref).abs().max()))
        print(f"[15/28] triplane_gather vs plain, {label} ({xyz.shape[0]} points x 3 planes x "
              f"{c}): {n_diff} of {got.numel()} elements differ; max|d| vs F.grid_sample on the "
              f"float32 planes {lib_err:.3e} (bar {K5_LIB_TOL} x {t_scale:.3f})", flush=True)
        if n_diff or lib_err > K5_LIB_TOL * t_scale:
            fail(f"triplane_gather disagrees with its plain version or F.grid_sample ({label})")
        del got, ref, lib

    g32 = grid(coarse)
    _, plain_ms, (p1, _, _, p2) = timed_pair([lambda: k5.triplane_gather(table, coarse, scale)],
                                             [lambda: k5.triplane_gather_ref(table, coarse,
                                                                             scale)])
    try:   # a capability probe, not a phase: does F.grid_sample take bf16 on this build?
        library(planes16, g32[:, :, :8])
        lib16 = True
    except RuntimeError as e:
        lib16 = f"not taken ({str(e).splitlines()[0][:80]})"
    # the kernel and its library call in turns, K5_ROUNDS rounds of: float32
    # library, bf16 library, kernel, kernel, bf16 library, float32 library
    runs = {"kernel": [], "f32": [], "bf16": []}
    ratios = []   # per round: the kernel's median over the float32 library's
    for rnd in range(K5_ROUNDS):
        order = ["f32", "bf16", "kernel", "kernel", "bf16", "f32"]
        got = {"kernel": [], "f32": [], "bf16": []}
        for which in order:
            if which == "bf16" and lib16 is not True:
                continue
            fn = {"kernel": lambda: k5.triplane_gather(table, coarse, scale),
                  "f32": lambda: library(planes32, g32),
                  "bf16": lambda: library(planes16, g32)}[which]
            got[which].append(cuda_ms(fn, K5_REPS, queued=True))
        for k, v in got.items():
            runs[k] += v
        ratios.append(float(np.median(got["kernel"]) / np.median(got["f32"])))
        print(f"[15/28] triplane_gather round {rnd} in turns (ms): kernel "
              f"{[round(t, 4) for t in got['kernel']]}, F.grid_sample float32 "
              f"{[round(t, 4) for t in got['f32']]}, bf16 "
              f"{[round(t, 4) for t in got['bf16']] if lib16 is True else lib16}; kernel / "
              f"float32 {ratios[-1]:.3f}", flush=True)
    ms, lib_ms = float(np.median(runs["kernel"])), float(np.median(runs["f32"]))
    lib16_txt = f"{float(np.median(runs['bf16'])):.4f} ms" if lib16 is True else lib16
    # the kernel timed as the other phases time theirs: K5_UNQUEUED timings of
    # 5 launches back to back, their host time included
    unqueued = [cuda_ms(lambda: k5.triplane_gather(table, coarse, scale), 5)
                for _ in range(K5_UNQUEUED)]
    n = coarse.shape[0]
    table_bytes = touched_table_bytes(table, coarse, scale)
    n_bytes = n * 12 + table_bytes + n_planes * n * c * 4
    bound_ms, bound_by = bound(0.0, n_bytes)
    plan = k5.launch_plan(c, table.dtype, n, table.data_ptr())
    elem = "13__nv_bfloat16" if table.dtype == torch.bfloat16 else "f"
    symbol = f"triplane_gather_kernelI{elem}Li{plan.vec}E"
    regs, spills, stack = next(v for k, v in ptxas_report("triplane_gather").items() if symbol in k)
    print(f"[15/28] triplane_gather route: {plan.load_bytes}-byte corner loads ({plan.vec} "
          f"channels of {table.dtype}), {plan.groups} threads per point, {plan.blocks} blocks of "
          f"{plan.threads}; {regs} registers, {spills} spill bytes, {stack} bytes of stack",
          flush=True)
    print(f"[15/28] triplane_gather at {n} points (one chunk's coarse pass), medians of "
          f"{K5_ROUNDS} rounds: kernel {ms:.4f} ms ({n_bytes / (ms * 1e-3) / 1e12:.2f} TB/s of "
          f"counted bytes, {100 * bound_ms / ms:.1f}% of the bound), F.grid_sample float32 "
          f"{lib_ms:.4f} ms, bf16 {lib16_txt} (grid precomputed): kernel / float32 library "
          f"{ms / lib_ms:.3f}; plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB: coordinates, the "
          f"{table_bytes / 1e6:.2f} MB of the table's texels the points read, output); "
          f"kernel unqueued {float(np.median(unqueued)):.4f} ms (median of "
          f"{[round(t, 4) for t in unqueued]}); {card}", flush=True)
    print(f"[15/28] triplane_gather below F.grid_sample float32 in every round: "
          f"{'yes' if max(ratios) < 1 else 'no'} (kernel / float32 per round "
          f"{[round(r, 3) for r in ratios]})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "timing": "queued"}


def touched_table_bytes(table, xyz, scale):
    """Bytes of the (3, H+2, W+2, C) table that K5 must read for the points
    xyz: each texel of the 2x2 corner blocks of the (plane, point) pairs that
    sample their plane, counted once (the plain version's indices)."""
    import torch
    from nerf_siren_tpu_torch.ops.grid_sample import packed_corner_block
    from nerf_siren_tpu_torch.ops.kernels.triplane_gather import project_to_planes

    n_planes, hp, wp, c = table.shape
    r0, c0, _, _, valid = packed_corner_block(project_to_planes(scale * xyz), hp - 2, wp - 2)
    plane = torch.arange(n_planes, device=xyz.device)[:, None]
    first = ((plane * hp + r0) * wp + c0)[valid]
    texels = torch.unique(torch.cat([first, first + 1, first + wp, first + wp + 1]))
    return int(texels.numel()) * c * table.element_size()


def eg3d_phases(device, card, args):
    """Phases 14-17. Returns (result, launches) of K5 and phase 16's frames
    as (rays, rgb) training targets."""
    import torch
    from nerf_siren_tpu_torch.eval_eg3d import make_renderer
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    hp, system, model, synth_s = eg3d_setup(device, card)
    frames_rays = [lego_rays(k, device, EG3D_WH, EG3D_WH) for k in range(N_EG3D)]
    result = check_triplane_gather(system, model, frames_rays[0], hp.chunk, device, card)
    torch.cuda.empty_cache()

    # ---- 16. frames through the CLI's renderer ---------------------------------
    render = make_renderer(system, model, hp.chunk)
    reset_counts(["triplane_gather"])
    outs, lat = render_frames(render, frames_rays)
    launches = read_counts(["triplane_gather"])["triplane_gather"]
    n_chunks = -(-EG3D_WH * EG3D_WH // hp.chunk)
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != EG3D_WH * EG3D_WH or not torch.isfinite(v).all():
                fail(f"EG3D frame {k}: shape {tuple(v.shape)} or non-finite values")
    print(f"[16/28] {N_EG3D} EG3D frames of {EG3D_WH}x{EG3D_WH} ({hp.N_samples}+"
          f"{hp.N_importance} samples, chunk {hp.chunk}, --plane_sampler kernel): latency s "
          f"{[round(t, 4) for t in lat]}, {EG3D_WH ** 2 / np.median(lat):.0f} rays/s at the "
          f"median frame, of which mapping + synthesis {1e3 * synth_s:.3f} ms ({card}); K5 "
          f"launches {launches}; outputs finite; opacity_fine mean per frame "
          f"{[round(float(o['opacity_fine'].mean()), 4) for o in outs]}", flush=True)
    if launches != 2 * n_chunks * N_EG3D:
        fail(f"K5 launched {launches} times, expected {2 * n_chunks * N_EG3D}")
    gather = make_renderer(EG3DSystem(system.cfg, "gather"), model, hp.chunk)
    g_outs, g_lat = render_frames(gather, frames_rays)
    worst = {k: max(float((o[k] - g[k]).abs().max()) for o, g in zip(outs, g_outs))
             for k in outs[0]}
    n_diff = sum(int((o[k] != g[k]).sum()) for o, g in zip(outs, g_outs) for k in o)
    print(f"[16/28] the same frames through --plane_sampler gather: latency s "
          f"{[round(t, 4) for t in g_lat]}; {n_diff} output elements differ from the kernel "
          f"frames, max|d| {worst} (bar {SAME_FRAME_ATOL})", flush=True)
    if max(worst.values()) > SAME_FRAME_ATOL:
        fail("the kernel and gather EG3D frames disagree")
    big = lego_rays(0, device, EG3D_BIG, EG3D_BIG)
    reset_counts(["triplane_gather"])
    (out_big,), (sec_big,) = render_frames(render, [big])
    big_launches = read_counts(["triplane_gather"])["triplane_gather"]
    big_chunks = -(-EG3D_BIG * EG3D_BIG // hp.chunk)
    if big_launches != 2 * big_chunks or not all(torch.isfinite(v).all()
                                                 for v in out_big.values()):
        fail(f"the {EG3D_BIG}² frame: {big_launches} K5 launches (expected {2 * big_chunks}) "
             f"or non-finite outputs")
    print(f"[16/28] one EG3D frame of {EG3D_BIG}x{EG3D_BIG}: {sec_big:.4f} s, "
          f"{EG3D_BIG ** 2 / sec_big:.0f} rays/s, of which mapping + synthesis "
          f"{1e3 * synth_s:.3f} ms ({card}); K5 launches {big_launches}; outputs finite; "
          f"opacity_fine mean {float(out_big['opacity_fine'].mean()):.4f}", flush=True)
    del out_big, g_outs
    if args.profile:
        profile(f"EG3D frame {EG3D_BIG}²", lambda: render(big), card)
    del big

    # ---- 17. the card's frame and planes against the CPU ---------------------------
    cpu_model = copy.deepcopy(model).cpu()
    packed = system.frame_planes(model)
    with torch.no_grad():
        ref = EG3DSystem(system.cfg, "gather").render_packed(
            cpu_model, packed.cpu(), frames_rays[0][EG3D_CHECK].cpu(), hp.chunk)
        planes = model.planes(model.mapping(model.z)).cpu()
        cpu_planes = cpu_model.planes(cpu_model.mapping(cpu_model.z))
    worst = {k: float((outs[0][k][EG3D_CHECK].cpu() - v).abs().max()) for k, v in ref.items()}
    p_err, p_scale = float((planes - cpu_planes).abs().max()), float(cpu_planes.abs().max())
    print(f"[17/28] {EG3D_CHECK.stop - EG3D_CHECK.start} rays of the first {EG3D_WH}² frame vs "
          f"a CPU re-render on the card's table: max|d| {worst} (atol {RENDER_ATOL}); the card's "
          f"float32 planes vs a CPU float32 synthesis (cuDNN TF32 "
          f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}): max|d| {p_err:.3e}, largest "
          f"|plane| {p_scale:.3f} (bar {PLANES_RTOL} of it)", flush=True)
    if max(worst.values()) > RENDER_ATOL or p_err > PLANES_RTOL * p_scale:
        fail("the EG3D frame or planes disagree with the CPU")
    if args.profile:
        profile("EG3D frame", lambda: render(frames_rays[1]), card)
    targets = (torch.cat(frames_rays), torch.cat([o["rgb_fine"] for o in outs]))
    return result, launches, targets


# ---- the SIREN field and the semantic stack (phases 18-20) --------------------

def numpy_siren_params(rng, hidden=256, n_layers=8, z_dim=100):
    """A JAX-layout SIREN tree (`init_siren_nerf`'s shapes and
    distributions) from a numpy generator."""
    def lin(i, o, bound=None):
        b = 1.0 / math.sqrt(i)
        return {"kernel": rng.uniform(-(bound or b), bound or b, (i, o)).astype(np.float32),
                "bias": rng.uniform(-b, b, (o,)).astype(np.float32)}

    def film(i, o, first=False):
        return lin(i, o, 1.0 / i if first else math.sqrt(6.0 / i) / 25.0)

    return {"network": [film(3, hidden, True)] + [film(hidden, hidden)
                                                  for _ in range(1, n_layers)],
            "final_layer": film(hidden, 1), "color_layer_sine": film(hidden + 3, hidden),
            "color_layer_linear": film(hidden, 3),
            "mapping": [lin(z_dim, 256), lin(256, 256), lin(256, (n_layers + 1) * hidden * 2)],
            "z": rng.normal(size=(1, z_dim)).astype(np.float32)}


def numpy_points_params(rng, k=SEM_CLASSES):
    """A JAX-layout PointNet tree (`init_pointnet_dense_cls(k, inc=6)`'s
    shapes; linears with the torch-default init, BN scale 1 and bias 0)."""
    def lin(i, o):
        b = 1.0 / math.sqrt(i)
        return {"kernel": rng.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": rng.uniform(-b, b, (o,)).astype(np.float32)}

    def bn(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    stn = {"conv1": lin(3, 64), "conv2": lin(64, 128), "conv3": lin(128, 1024),
           "fc1": lin(1024, 512), "fc2": lin(512, 256), "fc3": lin(256, 9)}
    feat = {"stn": stn, "conv1": lin(6, 64), "conv2": lin(64, 128), "conv3": lin(128, 1024),
            "bn1": bn(64), "bn2": bn(128), "bn3": bn(1024)}
    return {"feat": feat, "conv1": lin(1088, 512), "conv2": lin(512, 256),
            "conv3": lin(256, 128), "conv4": lin(128, k),
            "bn1": bn(512), "bn2": bn(256), "bn3": bn(128)}


def numpy_points(seed, device):
    from nerf_siren_tpu_torch.convert import points_from_jax
    from nerf_siren_tpu_torch.models.pointnet import PointNetDenseCls

    net = PointNetDenseCls(k=SEM_CLASSES, inc=6)
    net.load_state_dict(points_from_jax(numpy_points_params(np.random.default_rng(seed))))
    return net.to(device)


def state_copy(system, models):
    return system.state_for({k: copy.deepcopy(m) for k, m in models.items()})


def lr0_last_row(optimizer):
    """Swap in a scalar table whose last row has lr 0 (the control group);
    returns the original."""
    table = optimizer.scalar_table

    def last_lr_zero(state, k):
        rows = table(state, k)
        rows[-1, 0] = 0.0
        return rows

    optimizer.scalar_table = last_lr_zero
    return table


def gap_by_tensor(system, state, start, got, want):
    """(name, gap) of the tensor whose change lies farthest from the
    reference run's (`change_gap`'s argmax)."""
    from nerf_siren_tpu_torch.training.system import parameters

    gaps = [float((g - w).norm() / (w - s).norm().clamp_min(1e-30))
            for s, g, w in zip(start, got, want)]
    i = int(np.argmax(gaps))
    return parameters(state.models)[i][1], gaps[i]


def group_vs_eager(phase, label, system, models, batches, seed, card, gated=True, watch=(),
                   floor=False, k2_per_step=0):
    """GROUP_STEPS eager `train_step`s against one grouped group
    (`train_scan_batches`, a captured CUDA graph) from the same weights,
    seed and batches, read as phase 6(c) reads them (losses within
    GROUP_LOSS_RTOL, the change gap within GROUP_CHANGE_GAP; the tensors
    whose names end with one of `watch` printed and held to it on their
    own), with a control group whose last row has lr 0 (must fail the
    change gap); `gated=False` prints the reading without the bars and the
    control; with `floor`, a second eager run from the same start read the
    same way against the first (the spread of two eager runs); then ms per
    step of eager steps and of replays in turns (their medians kept in
    STEP_MS[label]), and a replay under `torch.cuda.set_sync_debug_mode(
    "error")` (any host sync raises). K2's wrappers must be called
    `k2_per_step` times a step at each capture (and as often in its warm-up
    step), 0 on the plain field. Returns (start, eager state, grouped
    state)."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2
    from nerf_siren_tpu_torch.training.system import parameters

    n = len(batches)
    extra = {"cls_b": torch.stack([b["cls"] for b in batches])} if "cls" in batches[0] else {}
    rays_b, rgbs_b = stacked(batches)
    eager, grouped, control = (state_copy(system, models) for _ in range(3))
    start = param_list(eager)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want, eager_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        eager, metrics = system.train_step(eager, b, seed=seed)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
        want.append(float(metrics[system.LOSS_KEY]))
    eager_peak = torch.cuda.max_memory_allocated()
    if floor:
        again = state_copy(system, models)
        twice = []
        for b in batches:
            again, metrics = system.train_step(again, b, seed=seed)
            twice.append(float(metrics[system.LOSS_KEY]))
        floor_rel = max(abs(a - b) / abs(b) for a, b in zip(twice, want))
        floor_name, floor_gap = gap_by_tensor(system, again, start, param_list(again),
                                              param_list(eager))
        print(f"[{phase}] {label}: a second eager run from the same start against the first "
              f"(the spread of eager runs): max relative loss difference {floor_rel:.3e}, "
              f"change gap {floor_gap:.3e} (largest at {floor_name})", flush=True)
        del again
    torch.cuda.reset_peak_memory_stats()
    k2_before = dict(k2.LAUNCHES)
    t0 = time.perf_counter()
    grouped, _ = system.train_scan_batches(grouped, rays_b, rgbs_b, seed=seed, **extra)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    group_peak = torch.cuda.max_memory_allocated()
    capture_s = system.last_group.capture_s
    got = system.last_group.steps[:, 0].tolist()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    gap = change_gap(start, param_list(grouped), param_list(eager))
    gap_name = gap_by_tensor(system, grouped, start, param_list(grouped), param_list(eager))[0]
    watched = [i for i, (_, name, _) in enumerate(parameters(eager.models))
               if name.endswith(tuple(watch))] if watch else []
    watch_gap = (change_gap(*([v[i] for i in watched] for v in (start, param_list(grouped),
                                                                param_list(eager))))
                 if watched else 0.0)
    control_gap = None
    if gated:
        table = lr0_last_row(system.optimizer)
        try:
            system.train_scan_batches(control, rays_b, rgbs_b, seed=seed, **extra)
        finally:
            system.optimizer.scalar_table = table
        control_gap = change_gap(start, param_list(control), param_list(eager))
    k2_calls = k2_calls_since(k2_before)
    bars = (f" (bar {GROUP_LOSS_RTOL})", f"; bar {GROUP_CHANGE_GAP}; the control with the last "
            f"row's lr 0 {control_gap:.3e}, must exceed it") if gated else ("", "; a reading")
    print(f"[{phase}] {label}: {n} grouped steps on a captured graph vs {n} eager steps, same "
          f"weights, seed and batches: max relative loss difference {loss_rel:.3e}{bars[0]}, "
          f"change gap {gap:.3e} (largest at {gap_name}{bars[1]})"
          f"{f', of {watch} alone {watch_gap:.3e}' if watched else ''}; losses eager "
          f"{[f'{v:.6e}' for v in want]}, grouped {[f'{v:.6e}' for v in got]}; K2 wrapper "
          f"calls {k2_calls}", flush=True)
    if watch and not watched:
        fail(f"{label}: no tensor named {watch}")
    if gated and not (loss_rel <= GROUP_LOSS_RTOL and gap <= GROUP_CHANGE_GAP
                      and watch_gap <= GROUP_CHANGE_GAP):
        fail(f"{label}: grouped steps disagree with eager steps")
    if gated and not control_gap > GROUP_CHANGE_GAP:
        fail(f"{label}: the change gap does not see a last update with lr 0")
    k2_expect = k2_per_step * (n + 1) * (2 if gated else 1)   # the group's and the control's
    if k2_calls != {"fwd": k2_expect, "bwd": k2_expect}:
        fail(f"{label}: K2's wrappers called {k2_calls} times at the captures, expected "
             f"{k2_expect} each")
    del control

    # ms per step: eager steps and replays on the same batches, in turns
    times = {"eager": [], "grouped": []}
    for mode in ("eager", "grouped", "grouped", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "eager":
            for b in batches:
                eager, _ = system.train_step(eager, b, seed=seed)
        else:
            grouped, _ = system.train_scan_batches(grouped, rays_b, rgbs_b, seed=seed, **extra)
        torch.cuda.synchronize()
        times[mode].append(1e3 * (time.perf_counter() - t0) / n)
    inputs = system.group_inputs(grouped, "batches", {"rays": rays_b, "rgbs": rgbs_b,
                                                      **({"cls": extra["cls_b"]} if extra
                                                         else {})}, seed, n, rays_b.shape[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        system.last_group.run(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    system.optimizer.advance(grouped.opt_state, n)   # the counts `_grouped` would advance
    grouped.step += n
    torch.cuda.synchronize()
    STEP_MS[label] = (float(np.median(times["eager"])), float(np.median(times["grouped"])))
    print(f"[{phase}] {label}: ms per step eager {[round(v, 3) for v in times['eager']]}, "
          f"grouped {[round(v, 3) for v in times['grouped']]} (in turns; eager steps of the "
          f"check {[round(1e3 * v, 3) for v in eager_s]}); the capture of {n} steps "
          f"{capture_s:.3f} s (the first group {first_s:.3f} s); a replay under sync debug "
          f"mode 'error' ran without a host sync; peak device memory eager "
          f"{eager_peak / 2**30:.3f} GiB, a group of {n} {group_peak / 2**30:.3f} GiB; {card}",
          flush=True)
    return start, eager, grouped


def siren_phase(device, card, args):
    """Phase 18: the full SIREN field's steps, eager and grouped."""
    import torch
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.convert import siren_from_jax
    from nerf_siren_tpu_torch.models.siren import SirenNeRF
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    rng = np.random.default_rng(SEED + 50)
    models = {}
    for name in ("coarse", "fine"):
        models[name] = SirenNeRF()
        models[name].load_state_dict(siren_from_jax(numpy_siren_params(rng)))
        models[name].to(device)
    system = NeRFSystem(RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                                     perturb=1.0, noise_std=1.0, white_back=True),
                        TrainConfig(lr=LR, decay_step=(20,), decay_gamma=0.1,
                                    batch_size=TRAIN_RAYS),
                        NeRFConfig(), 1000, device=device, field_type="siren")
    batches = sem_batches(device, SEED + 51)
    n_params = sum(p.numel() for m in models.values() for p in m.parameters())
    print(f"[18/28] SIREN field: 8 FiLM layers of 256, mapping 100 -> 256 -> 256 -> "
          f"{9 * 256 * 2}, learnable z, box 51; coarse + fine {n_params} parameters; "
          f"{TRAIN_RAYS} rays at {N_SAMPLES}+{N_IMPORTANCE} samples, perturb 1, noise 1, "
          f"Adam {LR}", flush=True)
    _, eager, _ = group_vs_eager("18/28", "SIREN", system, models, batches, SEED + 52, card)
    if args.profile:
        profile("SIREN train step", lambda: system.train_step(eager, batches[0], seed=1), card)


def sem_batches(device, seed, classes=False):
    """GROUP_STEPS batches of TRAIN_RAYS rays of the lego cameras with
    uniform rgb targets (and class targets in [0, SEM_CLASSES))."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.cat([lego_rays(k, device, 200, 200) for k in range(N_FRAMES)])
    out = []
    for _ in range(GROUP_STEPS):
        idx = torch.randint(0, pool.shape[0], (TRAIN_RAYS,), generator=gen, device=device)
        b = {"rays": pool[idx],
             "rgbs": torch.rand(TRAIN_RAYS, 3, generator=gen, device=device)}
        if classes:
            b["cls"] = torch.randint(0, SEM_CLASSES, (TRAIN_RAYS,), generator=gen, device=device)
        out.append(b)
    return out


def d3_system(device, network, data_parallel=None):
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem

    return NeRF3DSystem(RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                                     perturb=1.0, noise_std=1.0, white_back=True),
                        TrainConfig(lr=LR, decay_step=(20,), decay_gamma=0.1,
                                    batch_size=TRAIN_RAYS, loss_type="msenll"),
                        NeRFConfig(), 1000, semantic_network=network, n_classes=SEM_CLASSES,
                        point_capacity=SEM_CAPACITY, device=device,
                        data_parallel=data_parallel)


def d3_steps_phase(device, card, args):
    """Phase 19: d3 steps (NeRF 8x256 + PointNet), eager and grouped; the
    voxel UNet's eager step."""
    import torch
    from nerf_siren_tpu_torch.training.semantic_system import make_points_network

    models = numpy_models(SEED + 60, device)
    models["points"] = numpy_points(SEED + 61, device)
    system = d3_system(device, "pointnet")
    batches = sem_batches(device, SEED + 62, classes=True)
    print(f"[19/28] d3: NeRF 8x256 coarse + fine and PointNet k {SEM_CLASSES} (1088-wide "
          f"point feature) at capacity {SEM_CAPACITY}, msenll, no_grad_on_nerf; "
          f"{TRAIN_RAYS} rays at {N_SAMPLES}+{N_IMPORTANCE} samples", flush=True)
    start, eager, grouped = group_vs_eager("19/28", "d3 pointnet", system, models, batches,
                                           SEED + 63, card)
    names = [(k, n) for k in sorted(eager.models) for n, _ in eager.models[k].named_parameters()]
    for label, state in (("eager", eager), ("grouped", grouped)):
        now = param_list(state)
        nerf_same = all(torch.equal(a, b) for (k, _), a, b in zip(names, start, now)
                        if k != "points")
        moved = sum(not torch.equal(a, b) for (k, _), a, b in zip(names, start, now)
                    if k == "points")
        total = sum(k == "points" for k, _ in names)
        print(f"[19/28] d3 {label} state after its {state.step} steps: NeRF parameters "
              f"bit-unchanged {nerf_same}; PointNet tensors moved {moved} of {total}",
              flush=True)
        if not nerf_same or moved < total // 2:
            fail(f"d3 {label}: the frozen NeRF moved or PointNet did not train")
    if args.profile:
        profile("d3 train step", lambda: system.train_step(eager, batches[0], seed=1), card)

    unet = d3_system(device, "conv3d")
    models = {k: v for k, v in models.items() if k != "points"}
    models["points"] = make_points_network("conv3d", SEM_CLASSES,
                                           torch.Generator().manual_seed(SEED + 64)).to(device)
    state = state_copy(unet, models)
    losses, step_s = [], []
    for b in batches[:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = unet.train_step(state, b, seed=SEED + 63)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["train/total_loss"]))
    print(f"[19/28] d3 conv3d (voxel UNet, res 32, channels (16, 32, 64)): 3 eager steps, "
          f"losses {[f'{v:.6e}' for v in losses]}, ms per step "
          f"{[round(1e3 * v, 3) for v in step_s]}; {card}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("d3 conv3d: a loss is not finite")


class plain_fast_kernels:
    """Within: the fast renderer runs K3's (select and opacity) and the
    field kernels' plain versions on the card in place of the kernels."""

    def __enter__(self):
        from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
        from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
        from nerf_siren_tpu_torch.render import fast as fast_mod

        self.saved = (fast_mod.proxy_march_select, fast_mod.proxy_opacity,
                      fast_mod.field_kernels)
        fast_mod.proxy_march_select = k3.proxy_march_select_ref
        fast_mod.proxy_opacity = k3.proxy_opacity_ref
        fast_mod.field_kernels = lambda packed: (fm.fused_sigma_ref, fm.fused_full_ref)
        return self

    def __exit__(self, *exc):
        from nerf_siren_tpu_torch.render import fast as fast_mod

        (fast_mod.proxy_march_select, fast_mod.proxy_opacity,
         fast_mod.field_kernels) = self.saved


def class_margin(cls):
    """Top-1 minus top-2 of each row of composited class log-probabilities."""
    top = cls.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def d3_frames_phase(device, card, args):
    """Phase 20: d3 frames of the ball field with a numpy-seeded PointNet."""
    from pathlib import Path

    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import get_opts, make_semantic_renderer, setup_fast_proxy

    models = numpy_models(FIELD_SEED, device, ball_nerf_params)
    models["points"] = numpy_points(SEED + 70, device)
    ckpt_dir = Path("ckpts") / "chip_smoke"
    ckpt = str(ckpt_dir / "ball.msgpack")          # phase 7's checkpoint and proxy cache
    hp = get_opts(["--root_dir", str(ckpt_dir), "--ckpt_path", ckpt, "--renderer", "fast",
                   "--mode", "d3", "--cls_threshold", "0", "--chunk", str(CHUNK)])
    fast = setup_fast_proxy({k: v for k, v in models.items() if k != "points"}, hp,
                            np.array([NEAR, FAR], np.float32))
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    sem = dict(n_classes=SEM_CLASSES, point_capacity=hp.point_capacity,
               point_norm=hp.point_norm, cls_threshold=hp.cls_threshold)
    render = make_semantic_renderer(models, cfg, renderer="fast", fast=fast, hparams=hp, **sem)
    rays = lego_rays(0, device)
    names = ["proxy_march_select", "fused_nerf_full"]
    render_frames(render, [rays])                  # warm-up
    reset_counts(names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (out,), (lat,) = render_frames(render, [rays])
    counts = read_counts(names)
    peak = torch.cuda.max_memory_allocated()
    key = fast.model_key
    n_chunks = -(-H * W // CHUNK)
    print(f"[20/28] d3 fast frame {H}x{W} (C {hp.fast_candidates}, K {hp.fast_keep}, "
          f"capacity {hp.point_capacity}, cls_threshold 0, PointNet k {SEM_CLASSES}): latency "
          f"{lat:.4f} s; launches {counts} (this phase's own); peak device memory "
          f"{peak / 2**30:.3f} GiB; {card}", flush=True)
    for name in names:
        if counts[name] < n_chunks:
            fail(f"d3 fast frame: {name} launched {counts[name]} times, expected >= {n_chunks}")
    for k, v in out.items():
        if v.shape[0] != H * W or not torch.isfinite(v).all():
            fail(f"d3 fast frame {k}: shape {tuple(v.shape)} or non-finite values")
    with plain_fast_kernels():
        reset_counts(names)
        (ref,), (ref_lat,) = render_frames(render, [rays])
        if any(read_counts(names).values()):
            fail("the plain versions launched a kernel")

    def disagree(got):
        """(pixels whose classes differ above the bar, the largest plain
        margin among all pixels whose classes differ)."""
        margin = class_margin(ref[f"cls_{key}"])
        diff = got[f"cls_{key}"].argmax(-1) != ref[f"cls_{key}"].argmax(-1)
        worst = float(margin[diff].max()) if bool(diff.any()) else 0.0
        return int((diff & (margin > CLS_MARGIN)).sum()), int(diff.sum()), worst

    above, n_diff, worst = disagree(out)
    errs = {}
    for k in (f"rgb_{key}", f"opacity_{key}", f"depth_{key}"):
        d = (out[k] - ref[k]).abs() / max(1.0, float(ref[k].abs().max()))
        errs[k] = (float(d.median()), percentile(d, 0.99))
    margin = class_margin(ref[f"cls_{key}"])
    print(f"[20/28] the same frame on the plain versions of K3 select and K1 on the card "
          f"({ref_lat:.4f} s): class ids differ at {n_diff} of {H * W} pixels, the largest "
          f"plain top-two margin among them {worst:.4e}; {above} differ above the bar "
          f"{CLS_MARGIN} (pixels above it {int((margin > CLS_MARGIN).sum())}); (median, 99th "
          f"pct) of |d| / scale {errs} (bars {FAST_BARS})", flush=True)
    if above:
        fail("d3 fast frame: class ids differ from the plain versions' above the margin bar")
    if any(m >= FAST_BARS[0] or p >= FAST_BARS[1] for m, p in errs.values()):
        fail("d3 fast frame: rgb, depth or opacity disagree with the plain versions")

    # the control: PointNet's conv4 columns permuted must fail the class gate
    conv4 = models["points"].conv4
    with torch.no_grad():
        perm = torch.roll(torch.arange(SEM_CLASSES, device=device), 1)
        conv4.weight.copy_(conv4.weight[perm])
        conv4.bias.copy_(conv4.bias[perm])
    (ctl,), _ = render_frames(render, [rays])
    above_ctl, n_ctl, _ = disagree(ctl)
    print(f"[20/28] control (PointNet's conv4 columns rolled by one): class ids differ at "
          f"{n_ctl} pixels, {above_ctl} above the bar (must be > 0)", flush=True)
    if not above_ctl:
        fail("the class gate does not see a permuted class head")
    if args.profile:
        with torch.no_grad():
            profile("d3 fast frame", lambda: render(rays), card)
    with torch.no_grad():   # undo the roll
        inv = torch.roll(torch.arange(SEM_CLASSES, device=device), -1)
        conv4.weight.copy_(conv4.weight[inv])
        conv4.bias.copy_(conv4.bias[inv])
    del out, ref, ctl

    exact = make_semantic_renderer(models, cfg, renderer="exact", compute_dtype=torch.bfloat16,
                                   **sem)
    small = lego_rays(0, device, D3_EXACT_WH, D3_EXACT_WH)
    render_frames(exact, [small])                  # warm-up
    (out,), (lat,) = render_frames(exact, [small])
    for k, v in out.items():
        if v.shape[0] != D3_EXACT_WH ** 2 or not torch.isfinite(v).all():
            fail(f"d3 exact frame {k}: shape {tuple(v.shape)} or non-finite values")
    classes = torch.bincount(out["cls_fine"].argmax(-1), minlength=SEM_CLASSES).tolist()
    print(f"[20/28] d3 exact frame {D3_EXACT_WH}x{D3_EXACT_WH} ({N_SAMPLES}+{N_IMPORTANCE}, "
          f"bf16 field operands): latency {lat:.4f} s; pixels per class {classes}; {card}",
          flush=True)


# ---- EG3D training and the fast EG3D renderer (phases 21-22) ------------------

def eg3d_ball_params(rng, cfg):
    """`numpy_eg3d_params` shaped into a scene with empty space: every
    synthesis block but the last adds nothing to the planes (its ToRGB
    weights 0), the last block's conv1 has weight 0 and a disk of radius
    BALL_R (in the plane's [-box_warp/2, box_warp/2] coordinates) as its
    noise_const at strength 1, and its ToRGB (styles 1) copies that disk
    into all channels: the three planes carry the disk, their mean q(x) is
    1 inside the ball of radius BALL_R at the origin and at most 2/3 outside
    it. The decoder maps q to a marcher density softplus(sigma - 1) of
    EG3D_BALL_SIGMA per unit inside and ~1e-4 outside, and to BALL_RGB."""
    params = numpy_eg3d_params(rng, cfg)
    syn = params["backbone"]["synthesis"]
    top = cfg.plane_resolution
    for res in cfg.backbone.synthesis.block_resolutions[:-1]:
        syn[f"b{res}"]["torgb"]["weight"][:] = 0.0
    last = syn[f"b{top}"]
    uv = (np.arange(top, dtype=np.float32) + 0.5) / top * 2 - 1
    r = np.sqrt(uv[:, None] ** 2 + uv[None, :] ** 2) * cfg.rendering.box_warp / 2
    last["conv1"]["weight"][:] = 0.0
    last["conv1"]["noise_const"] = (r <= BALL_R).astype(np.float32)
    last["conv1"]["noise_strength"] = np.float32(1.0)
    torgb = last["torgb"]
    c = torgb["weight"].shape[1]
    torgb["affine"]["weight"][:] = 0.0
    torgb["affine"]["bias"][:] = 1.0
    torgb["weight"][:] = 1.0 / math.sqrt(2 * c)          # x 1/sqrt(c) x sqrt(2): the disk
    alpha, threshold = 20.0, 0.8                          # h = softplus(alpha (q - 0.8))
    inside, outside = EG3D_BALL_SIGMA + 1.0, -8.0         # sigma at q = 1 and at q = 2/3
    h_in = math.log1p(math.exp(alpha * (1 - threshold)))
    h_out = math.log1p(math.exp(alpha * (2 / 3 - threshold)))
    beta = (inside - outside) / (h_in - h_out)
    dec = params["decoder"]
    n_in, hidden = dec["fc1"]["weight"].shape[1], dec["fc1"]["weight"].shape[0]
    dec["fc1"]["weight"][:] = alpha / math.sqrt(n_in)     # FullyConnected's 1/sqrt(fan_in)
    dec["fc1"]["bias"][:] = -alpha * threshold
    dec["fc2"]["weight"][:] = 0.0
    dec["fc2"]["weight"][0] = beta * math.sqrt(hidden) / hidden
    rgb = (np.asarray(BALL_RGB, np.float32) + 0.001) / 1.002
    dec["fc2"]["bias"][:] = np.concatenate([[outside - beta * h_out], np.log(rgb / (1 - rgb))])
    return params


def eg3d_steps_phase(device, card, args, targets):
    """Phase 21: EG3D training at the train CLI's EG3D defaults, eager and
    grouped, on phase 16's frames as targets."""
    import torch
    from nerf_siren_tpu_torch.convert import eg3d_from_jax
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import build_system
    from nerf_siren_tpu_torch.training.eg3d_system import MODEL

    pool_rays, pool_rgbs = targets
    hp = get_opts(["--root_dir", ".", "--mode", "eg3d"])
    system = build_system(hp, white_back=True, steps_per_epoch=1000, device=device)
    cfg = system.cfg
    model = system.init_model()
    model.load_state_dict(eg3d_from_jax(numpy_eg3d_params(np.random.default_rng(EG3D_SEED + 40),
                                                          cfg)))
    state = system.state_for({MODEL: model.to(device)})
    gen = torch.Generator(device=device).manual_seed(EG3D_SEED + 41)

    def batch():
        idx = torch.randint(0, pool_rays.shape[0], (hp.batch_size,), generator=gen,
                            device=device)
        return {"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]}

    n_tensors = sum(p.numel() for p in model.state_dict().values())
    print(f"[21/28] EG3D training (--mode eg3d defaults): z/w {cfg.z_dim}, planes "
          f"{cfg.n_planes} x {cfg.plane_channels} x {cfg.plane_resolution}², channel_base "
          f"{cfg.channel_base}, channel_max {cfg.channel_max}, decoder {cfg.plane_channels} -> 64 "
          f"-> 4; {hp.batch_size} rays at {cfg.rendering.depth_resolution}+"
          f"{cfg.rendering.depth_resolution_importance} samples, ray {cfg.rendering.ray_start} -> "
          f"{cfg.rendering.ray_end}, box_warp {cfg.rendering.box_warp}; {hp.optimizer} {hp.lr} "
          f"{hp.lr_scheduler}; {n_tensors} optimized elements (w_avg and noise_const included); "
          f"targets: phase 16's {pool_rays.shape[0]} rays", flush=True)
    losses, step_s = [], []
    for _ in range(EG3D_TRAIN_STEPS):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = system.train_step(state, b, seed=EG3D_SEED + 42)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["train/loss"]))
    first = float(np.mean(losses[:EG3D_WINDOW]))
    last = float(np.mean(losses[-EG3D_WINDOW:]))
    print(f"[21/28] {EG3D_TRAIN_STEPS} eager EG3D steps: losses "
          f"{[f'{v:.5f}' for v in losses]}; mean of the first {EG3D_WINDOW} {first:.6f}, of the "
          f"last {last:.6f}; ms per step (after the first) "
          f"{float(np.median(step_s[1:])) * 1e3:.3f} median; {card}", flush=True)
    if not all(math.isfinite(v) for v in losses) or not last < first:
        fail("EG3D steps: a loss is not finite or the loss does not fall")
    batches = [batch() for _ in range(GROUP_STEPS)]
    # the gate: under deterministic algorithms the graph must equal the eager
    # steps as phase 6(c)'s do; the default algorithms' atomics (cuDNN weight
    # gradients, the plain gather's scatter-add) make even two eager runs
    # differ, so their reading is printed with that spread, ungated
    torch.use_deterministic_algorithms(True)
    try:
        group_vs_eager("21/28", "EG3D, deterministic algorithms", system, state.models, batches,
                       EG3D_SEED + 43, card, watch=("w_avg",))
    finally:
        torch.use_deterministic_algorithms(False)
    _, eager, _ = group_vs_eager("21/28", "EG3D, default algorithms", system, state.models,
                                 batches, EG3D_SEED + 43, card, gated=False, watch=("w_avg",),
                                 floor=True)
    if args.profile:
        profile("EG3D train step", lambda: system.train_step(eager, batches[0], seed=1), card)


class plain_k3_eg3d:
    """Within: the fast EG3D renderer runs K3's plain versions on the card."""

    def __enter__(self):
        from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
        from nerf_siren_tpu_torch.render import triplane_fast as tf

        self.saved = tf.proxy_march_select, tf.proxy_opacity
        tf.proxy_march_select, tf.proxy_opacity = k3.proxy_march_select_ref, k3.proxy_opacity_ref
        return self

    def __exit__(self, *exc):
        from nerf_siren_tpu_torch.render import triplane_fast as tf

        tf.proxy_march_select, tf.proxy_opacity = self.saved


def fast_frame_errors(got, ref, rays, opts, depth_mask=None):
    """(median, 99th pct / max) of an EG3D fast frame's rgb, depth and
    opacity against a reference frame: rgb over max(1, max|ref|), depth over
    each ray's far - near (optionally only where `depth_mask`), opacity
    absolute (median, max)."""
    from nerf_siren_tpu_torch.render.triplane_fast import fast_rays8

    r8 = fast_rays8(rays, opts)
    d_rgb = (got["rgb_fine"] - ref["rgb_fine"]).abs() / max(1.0, float(ref["rgb_fine"].abs().max()))
    d_z = (got["depth_fine"] - ref["depth_fine"]).abs() / (r8[:, 7] - r8[:, 6]).clamp_min(1e-6)
    if depth_mask is not None:
        d_z = d_z[depth_mask]
    d_o = (got["opacity_fine"] - ref["opacity_fine"]).abs()
    return {"rgb": (float(d_rgb.median()), percentile(d_rgb, 0.99)),
            "depth": (float(d_z.median()), percentile(d_z, 0.99)) if d_z.numel() else (0.0, 0.0),
            "opacity": (float(d_o.median()), float(d_o.max()))}


def within_fast_bars(errs):
    bars = {"rgb": FAST_BARS, "depth": DEPTH_BARS, "opacity": OPACITY_BARS}
    return all(m < bars[k][0] and p < bars[k][1] for k, (m, p) in errs.items())


def eg3d_fast_phase(device, card, args):
    """Phase 22: fast EG3D frames of a scene with empty space through
    eval_eg3d's fast renderer: plain frames, K3 against its plain version,
    the control, agreement with the exact frame and the auto-cull frames."""
    import torch
    from nerf_siren_tpu_torch.convert import eg3d_from_jax
    from nerf_siren_tpu_torch.eval_eg3d import (get_opts, make_renderer, setup_fast_renderer,
                                                triplane_config)
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    hp = get_opts(["--root_dir", ".", "--ckpt_path", "unused", "--renderer", "fast",
                   "--plane_sampler", "kernel"])
    cfg = triplane_config(hp, white_back=True)
    system = EG3DSystem(cfg, hp.plane_sampler)
    model = system.init_model()
    model.load_state_dict(eg3d_from_jax(eg3d_ball_params(np.random.default_rng(EG3D_SEED + 50),
                                                         cfg)))
    model = model.to(device)
    fast, distill_s = synced_s(lambda: setup_fast_renderer(system, model, hp))
    print(f"[22/28] scene with empty space (eg3d_ball_params: the planes carry a disk, the "
          f"decoder a ball of radius {BALL_R} with density {EG3D_BALL_SIGMA} per unit); the "
          f"fast renderer at the eval CLI's defaults (C {hp.fast_candidates}, K {hp.fast_keep}, "
          f"{hp.fast_placement}, {hp.fast_quadrature}, chunk {hp.chunk}): planes synthesised "
          f"and the proxy distilled ({hp.fast_distill_steps} steps x {hp.fast_distill_batch} "
          f"points) in {distill_s:.3f} s ({card})", flush=True)
    render = make_renderer(system, model, hp.chunk, fast)
    small = [lego_rays(k, device, EG3D_WH, EG3D_WH) for k in range(N_EG3D)]
    big = lego_rays(0, device, EG3D_BIG, EG3D_BIG)
    n_chunks = {EG3D_WH: -(-EG3D_WH ** 2 // hp.chunk), EG3D_BIG: -(-EG3D_BIG ** 2 // hp.chunk)}
    reset_counts(["proxy_march_select"])
    outs, lat = render_frames(render, small)
    small_launches = read_counts(["proxy_march_select"])["proxy_march_select"]
    reset_counts(["proxy_march_select"])
    (out_big,), (lat_big,) = render_frames(render, [big])
    big_launches = read_counts(["proxy_march_select"])["proxy_march_select"]
    for out, n in zip(outs + [out_big], [EG3D_WH ** 2] * N_EG3D + [EG3D_BIG ** 2]):
        for k, v in out.items():
            if v.shape[0] != n or not torch.isfinite(v).all():
                fail(f"fast EG3D frame {k}: shape {tuple(v.shape)} or non-finite values")
    exact, exact_lat = render_frames(make_renderer(system, model, hp.chunk), small)
    print(f"[22/28] {N_EG3D} fast EG3D frames of {EG3D_WH}²: latency s "
          f"{[round(t, 4) for t in lat]}, {EG3D_WH ** 2 / np.median(lat):.0f} rays/s at the median "
          f"frame; K3 select launches {small_launches} ({n_chunks[EG3D_WH]} chunks a frame); one "
          f"of {EG3D_BIG}²: {lat_big:.4f} s, {EG3D_BIG ** 2 / lat_big:.0f} rays/s, K3 select "
          f"launches {big_launches} ({n_chunks[EG3D_BIG]} chunks); opacity_fine mean "
          f"{[round(float(o['opacity_fine'].mean()), 4) for o in outs + [out_big]]}; the exact "
          f"{EG3D_WH}² frames of this scene (phase 16's renderer): latency s "
          f"{[round(t, 4) for t in exact_lat]}, the median exact over the median fast frame "
          f"{np.median(exact_lat) / np.median(lat):.2f}x; agreement (PSNR) of the fast frames "
          f"with them {[round(psnr_vs(o, e), 2) for o, e in zip(outs, exact)]} dB; {card}",
          flush=True)
    if (small_launches != n_chunks[EG3D_WH] * N_EG3D or big_launches != n_chunks[EG3D_BIG]):
        fail("the fast EG3D frames did not launch K3 select once per chunk")
    del exact

    with plain_k3_eg3d():
        reset_counts(["proxy_march_select", "proxy_opacity"])
        refs, ref_lat = render_frames(render, small + [big])
        if any(read_counts(["proxy_march_select", "proxy_opacity"]).values()):
            fail("the plain versions launched a kernel")
    for i, (out, ref, rays) in enumerate(zip(outs + [out_big], refs, small + [big])):
        errs = fast_frame_errors(out, ref, rays, cfg.rendering)
        print(f"[22/28] frame {i} on K3 vs K3's plain version on the card ({ref_lat[i]:.4f} s): "
              f"(median, 99th pct | max) {errs} (bars rgb {FAST_BARS}, depth {DEPTH_BARS}, "
              f"opacity {OPACITY_BARS})", flush=True)
        if not within_fast_bars(errs):
            fail("a fast EG3D frame on K3 disagrees with K3's plain version")
    proxy = fast.proxy
    rolled = copy.deepcopy(proxy)
    with torch.no_grad():
        rolled.l1.weight.copy_(torch.roll(rolled.l1.weight, 1, dims=1))
    control = make_renderer(system, model, hp.chunk, setup_fast_renderer(system, model, hp,
                                                                       proxy=rolled))
    (ctl,), _ = render_frames(control, small[:1])
    ctl_errs = fast_frame_errors(ctl, refs[0], small[0], cfg.rendering)
    print(f"[22/28] control (the proxy's first-layer columns rolled by one): {ctl_errs} (must "
          f"fail the bars)", flush=True)
    if within_fast_bars(ctl_errs):
        fail("the fast EG3D bars do not see a rolled proxy")
    del refs, ctl

    auto = make_renderer(system, model, hp.chunk,
                         setup_fast_renderer(system, model, get_opts(
                             ["--root_dir", ".", "--ckpt_path", "unused", "--renderer", "fast",
                              "--fast_cull", "auto"]), proxy=proxy), whole_frame=True)
    visible = out_big["opacity_fine"] > 0.5
    fracs = []
    for i in range(N_AUTO):
        reset_counts(["proxy_opacity", "proxy_march_select"])
        (out,), (sec,) = render_frames(auto, [big])
        counts = read_counts(["proxy_opacity", "proxy_march_select"])
        fracs.append(auto.last_active_frac)
        bg = ((out["rgb_fine"] == 1.0).all(-1) & (out["depth_fine"] == 0)
              & (out["opacity_fine"] == 0))
        lost = int((bg & (out_big["opacity_fine"] > 0.01)).sum())
        errs = fast_frame_errors(out, out_big, big, cfg.rendering, depth_mask=visible)
        print(f"[22/28] auto-cull frame {i} ({EG3D_BIG}², the same pose): {sec:.4f} s "
              f"({EG3D_BIG ** 2 / sec:.0f} rays/s); active fraction {auto.last_active_frac:.4f}, "
              f"bypass {auto.last_plain}, eps {float(auto.last_eps):.5f}; launches {counts}; "
              f"{int(bg.sum())} rays culled to background ({lost} of them with opacity > 0.01 "
              f"in the plain fast frame); vs the plain fast frame (depth where its opacity > "
              f"0.5): {errs}; {card}", flush=True)
        if counts["proxy_opacity"] != (0 if auto.last_plain else 1):
            fail("K3 opacity was not launched once per culled frame")
        if not within_fast_bars(errs):
            fail("an auto-cull EG3D frame disagrees with the plain fast frame")
    if not max(fracs[1:]) < 1.0:
        fail(f"the auto-cull frames culled nothing after the first (fractions {fracs})")


def profile(label, fn, card):
    """Device time per kernel over one call of `fn`, the device's idle
    share of its host wall time, and the peak device memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device kernel")
    per_name = {}
    for e in kernels:
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms, end = 0.0, -math.inf   # union of the kernels' intervals
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        end = max(end, e.time_range.end)
        busy_ms += max(0.0, e.time_range.end - start) / 1e3
    total = sum(ms for ms, _ in per_name.values())
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"[profile {label}] {ms:10.3f} ms {100 * ms / total:5.1f}% x{n:<4d} {name[:90]}",
              flush=True)
    print(f"[profile {label}] device kernels {total:.3f} ms (busy {busy_ms:.3f} ms) in "
          f"{wall_ms:.3f} ms of host time: idle {100 * (1 - busy_ms / wall_ms):.2f}%; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {card}",
          flush=True)



# ---- culled training and mesh extraction (phases 23-25) --------------------------

def check_culled_kernels(models, pool_rays, device, card):
    """Phase 23(a): K2's forward and backward against their plain versions
    at the culled step's shapes: TRAIN_RAYS rays x CULLED_K sorted depths
    (samples_per_dir CULLED_K), the coarse and the fine field; then each
    timed over both (one step's work) beside its plain version and bound.
    Returns {wrapper: its readings at this shape}."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    gen = torch.Generator(device=device).manual_seed(SEED + 63)
    pick = torch.randint(0, pool_rays.shape[0], (TRAIN_RAYS,), generator=gen, device=device)
    rays = pool_rays[pick]
    dirs = rays[:, 3:6].contiguous()
    z = torch.sort(rays[:, 6:7] + (rays[:, 7:8] - rays[:, 6:7])
                   * torch.rand((TRAIN_RAYS, CULLED_K), generator=gen, device=device), -1)[0]
    pts = (rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3).contiguous()
    n_pts, s = pts.shape[0], CULLED_K
    dy = torch.rand((n_pts, 4), generator=gen, device=device) * 2.0 - 0.5
    packs = [k2.pack_train_params(models[k].state_dict()) for k in ("coarse", "fine")]
    where = f"at {TRAIN_RAYS} rays x {s} = {n_pts} points, samples_per_dir {s}"
    fwd_err = bwd_err = 0.0
    for key, packed in zip(("coarse", "fine"), packs):
        fwd_err = max(fwd_err, compare("fused_train_fwd", k2.fused_train_fwd(packed, pts, dirs, s),
                                       k2.fused_train_fwd_ref(packed, pts, dirs, s),
                                       f"{where} ({key})", "23/28"))
        got = k2.fused_train_bwd(packed, pts, dirs, dy, s)
        torch.cuda.synchronize()
        rel, max_abs, elem, worst = grad_errors(got, k2.fused_train_bwd_ref(packed, pts, dirs,
                                                                            dy, s))
        print(f"[23/28] fused_train_bwd vs plain {where} ({key}): worst relative L2 {rel:.3e} "
              f"({worst}), max|d| {max_abs:.3e}, worst element {elem:.3e} of its tensor's "
              f"scale (bars {GRAD_REL_L2}, {GRAD_ELEM})", flush=True)
        bwd_err = max(bwd_err, max_abs)
    results, _ = time_train_kernels("23/28", "one culled step's shapes", models["fine"],
                                    [(p, pts, dy, s) for p in packs], dirs, fwd_err, bwd_err,
                                    card)
    for r in results.values():
        r.update(points_per_launch=n_pts, samples_per_dir=s)
    return results


def culled_phase(pool_rays, pool_rgbs, student, device, card):
    """Phase 23: culled training on K2, from phase 6(b)'s trained fields
    (`student`) and a fresh proxy. Returns (K2 readings at the culled
    shape, K2 launches over (c))."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2
    from nerf_siren_tpu_torch.render.culled_train import PROXY_HIDDEN
    from nerf_siren_tpu_torch.render.fast import init_proxy

    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    steps_per_epoch = pool_rays.shape[0] // TRAIN_RAYS

    def batch():
        idx = torch.randint(0, pool_rays.shape[0], (TRAIN_RAYS,), generator=gen, device=device)
        return {"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]}

    # fields trained on these targets (a random field's density rises fast
    # in its first steps under noise_std 1, and the proxy's targets with it,
    # faster than a fresh proxy follows at lr 5e-4), and a fresh proxy
    models = {k: copy.deepcopy(m) for k, m in student.items()}
    models["proxy"] = init_proxy(PROXY_HIDDEN, generator=torch.Generator().manual_seed(
        SEED + 62)).to(device)
    # (a) K2 against its plain version at the culled shapes
    results = check_culled_kernels(models, pool_rays, device, card)
    torch.cuda.empty_cache()

    # (b) culled_fused against culled from the same weights and batch, deterministic
    first, losses = batch(), {}
    for backend in ("culled_fused", "culled"):
        system = train_system(backend, 0.0, 0.0, steps_per_epoch, device)
        _, metrics = system.train_step(state_copy(system, models), first, seed=SEED)
        losses[backend] = (float(metrics["train/loss"]), float(metrics["train/proxy_loss"]))
    rel = abs(losses["culled_fused"][0] - losses["culled"][0]) / abs(losses["culled"][0])
    print(f"[23/28] (b) first culled step, same weights and batch: loss (with the proxy's) "
          f"culled_fused {losses['culled_fused']}, culled {losses['culled']}, relative "
          f"{rel:.3e} (bar {TRAIN_LOSS_RTOL})", flush=True)
    if not rel < TRAIN_LOSS_RTOL:
        fail("the culled_fused and culled backends disagree on the first step's loss")

    # (c) the culled_fused backend at opt.py's defaults: the path
    system = train_system("culled_fused", 1.0, 1.0, steps_per_epoch, device)
    state = state_copy(system, models)
    batches = [batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    k2.LAUNCHES.update(fwd=0, bwd=0)
    metrics_t, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = system.train_step(state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics_t.append((metrics["train/loss"], metrics["train/rgb_loss"],
                          metrics["train/proxy_loss"]))
    launches = dict(k2.LAUNCHES)
    loss, rgb, proxy = ([float(m[i]) for m in metrics_t] for i in range(3))
    ms = 1e3 * float(np.median(step_s[TRAIN_WARMUP:]))
    print(f"[23/28] (c) culled_fused training, {TRAIN_STEPS} steps of {TRAIN_RAYS} rays (C "
          f"{system.culled['n_candidates']}, {system.culled['n_sel']} + "
          f"{system.culled['n_uni']} samples): photometric loss first 10 mean "
          f"{np.mean(rgb[:10]):.5f}, last 10 {np.mean(rgb[-10:]):.5f}; proxy loss first 10 "
          f"{np.mean(proxy[:10]):.5f}, last 10 {np.mean(proxy[-10:]):.5f}; loss every 10th step "
          f"{[round(v, 5) for v in loss[::10]]}; {ms:.3f} ms per step (median after "
          f"{TRAIN_WARMUP}; {card}); launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in loss + rgb + proxy):
        fail("a culled training loss is not finite")
    if not (np.mean(rgb[-10:]) < np.mean(rgb[:10]) and np.mean(proxy[-10:]) < np.mean(proxy[:10])):
        fail("the culled photometric or proxy loss did not fall")
    if launches != {"fwd": 2 * TRAIN_STEPS, "bwd": 2 * TRAIN_STEPS}:
        fail(f"K2 launched {launches} times over {TRAIN_STEPS} culled steps, expected "
             f"{2 * TRAIN_STEPS} each (twice a step)")

    # eager ms per step beside the fused backend's on the same batches, in turns
    fused = train_system("fused", 1.0, 1.0, steps_per_epoch, device)
    fused_state = fused.state_for({k: copy.deepcopy(m) for k, m in state.models.items()
                                   if k != "proxy"})
    turns = {"fused": [], "culled_fused": []}
    for mode in ("fused", "culled_fused", "culled_fused", "fused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:GROUP_STEPS]:
            if mode == "fused":
                fused_state, _ = fused.train_step(fused_state, b, seed=SEED + 1)
            else:
                state, _ = system.train_step(state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        turns[mode].append(1e3 * (time.perf_counter() - t0) / GROUP_STEPS)
    print(f"[23/28] (c) eager ms per step in turns over {GROUP_STEPS} steps: fused "
          f"{[round(v, 3) for v in turns['fused']]}, culled_fused "
          f"{[round(v, 3) for v in turns['culled_fused']]}; fused / culled_fused "
          f"{np.median(turns['fused']) / np.median(turns['culled_fused']):.3f}; {card}",
          flush=True)
    del fused, fused_state

    # (d) grouped steps on a captured graph against eager steps
    group_vs_eager("23/28", "culled_fused", system, state.models, batches[:GROUP_STEPS],
                   SEED + 2, card, k2_per_step=2)
    eager_ms, grouped_ms = STEP_MS["culled_fused"]
    f_eager, f_grouped = STEP_MS["fused"]
    print(f"[23/28] (d) ms per step (medians of turns): grouped culled_fused {grouped_ms:.3f} "
          f"against phase 6(c)'s grouped fused {f_grouped:.3f}: {f_grouped / grouped_ms:.3f}x "
          f"(predicted >= 1.5x); eager {eager_ms:.3f} against {f_eager:.3f}; {card}", flush=True)
    return results, launches


def timed_s(fn):
    """(fn(), seconds), the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_ply(path, verts, faces, what):
    """The PLY read back: vertices and faces as written, vertex count > 0,
    colours finite and in [0, 1]."""
    from nerf_siren_tpu_torch.mesh.ply import read_ply

    v, f, c = read_ply(path)
    if len(v) == 0 or not np.array_equal(v, verts) or not np.array_equal(f, faces):
        fail(f"{what}: the PLY does not hold the {len(verts)} vertices and faces written")
    c = None if c is None else c.astype(np.float32) / 255.0
    if c is None or c.shape != v.shape or not np.isfinite(c).all() or c.min() < 0 or c.max() > 1:
        fail(f"{what}: vertex colours missing, non-finite or outside [0, 1]")
    return c


def nerf_mesh_phase(ball, device, card):
    """Phase 24: the NeRF mesh CLI's stages on phase 7's ball field. Returns
    the sigma grid, its spacing and origin, and the mesh's face count."""
    import torch
    from nerf_siren_tpu_torch import extract_color_mesh as ecm
    from nerf_siren_tpu_torch.mesh.marching import marching_tetrahedra
    from nerf_siren_tpu_torch.mesh.ply import write_ply

    ckpt, frames = ball
    hp = ecm.get_opts(["--root_dir", ".", "--ckpt_path", ckpt, "--N_grid", str(MESH_GRID),
                       "--sigma_threshold", str(MESH_SIGMA), "--out_dir", "ckpts/chip_smoke",
                       "--scene_name", "ball"])
    model = ecm.load_fine(ckpt, device)
    (sigma, spacing, origin), grid_s = timed_s(lambda: ecm.predict_sigma_grid(model, hp, device))
    xyz = ecm.grid_points(hp)[0]
    pick = np.random.default_rng(SEED + 64).choice(xyz.shape[0], MESH_CHECK, replace=False)
    cpu = copy.deepcopy(model).cpu()
    ref = ecm.field_sigma(cpu, torch.from_numpy(xyz[pick])).numpy()
    err = float(np.abs(sigma.reshape(-1)[pick] - ref).max())
    print(f"[24/28] NeRF mesh of the ball field: sigma grid {MESH_GRID}^3 (float32 plain field, "
          f"chunk {hp.chunk}) in {grid_s:.3f} s ({card}); max sigma {float(sigma.max()):.3f}; "
          f"{MESH_CHECK} grid points vs the CPU: max|d| {err:.3e} (atol {MESH_ATOL})", flush=True)
    if not np.isfinite(sigma).all() or err > MESH_ATOL:
        fail("the card's sigma grid disagrees with the CPU's")
    (verts, faces), march_s = timed_s(lambda: marching_tetrahedra(
        sigma, hp.sigma_threshold, spacing=spacing, origin=origin))
    r = np.linalg.norm(verts, axis=-1)
    images = [(f * 255.0).cpu().numpy() for f in frames]
    poses = np.stack([lego_pose(k) for k in range(len(images))])
    colors, fuse_s = timed_s(lambda: ecm.fuse_colors({"coarse": model}, images, poses, FOCAL,
                                                      NEAR, verts, hp, device))
    path = os.path.join(hp.out_dir, "ball.ply")
    write_ply(path, verts, faces, colors)
    c = check_ply(path, verts, faces, "NeRF mesh")
    print(f"[24/28] marching tetrahedra at sigma {hp.sigma_threshold}: {len(verts)} vertices, "
          f"{len(faces)} faces in {march_s:.3f} s (host); vertex radius median "
          f"{np.median(r):.4f} (the ball's sigma {MESH_SIGMA} shell lies at "
          f"{BALL_R * (1 - MESH_SIGMA / BALL_SIGMA):.4f}); fusion colours from {len(images)} "
          f"exact {H}x{W} frames ({hp.N_samples} opacity samples) in {fuse_s:.3f} s; median "
          f"colour {np.round(np.median(c, 0), 4).tolist()} (the ball's {list(BALL_RGB)}); "
          f"PLY written and read back; {card}", flush=True)
    return sigma, spacing, origin, len(faces)


def eg3d_mesh_phase(device, card):
    """Phase 25: the EG3D mesh CLI's stages on phase 22's ball scene."""
    import torch
    from nerf_siren_tpu_torch import extract_color_mesh_eg3d as ecm
    from nerf_siren_tpu_torch.eval_eg3d import get_opts as eval_opts, triplane_config
    from nerf_siren_tpu_torch.mesh.marching import marching_tetrahedra
    from nerf_siren_tpu_torch.mesh.ply import write_ply
    from nerf_siren_tpu_torch.render.triplane import run_model
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint

    cfg = triplane_config(eval_opts(["--root_dir", ".", "--ckpt_path", "unused"]), True)
    ckpt = os.path.join("ckpts", "chip_smoke", "eg3d_ball.msgpack")
    save_checkpoint(ckpt, {"eg3d_renderer": eg3d_ball_params(
        np.random.default_rng(EG3D_SEED + 50), cfg)})
    hp = ecm.get_opts(["--ckpt_path", ckpt, "--N_grid", str(MESH_GRID), "--colorize",
                       "--out_dir", "ckpts/chip_smoke", "--scene_name", "eg3d_ball"])
    model, load_s = timed_s(lambda: ecm.load_model(hp, device))
    sample, planes_s = timed_s(lambda: ecm.scene_sampler(model))
    sigma, grid_s = timed_s(lambda: ecm.sigma_grid(sample, hp, device))
    n, half = hp.N_grid, hp.cube_length / 2
    lin = np.linspace(-half, half, n, dtype=np.float32)
    pick = np.random.default_rng(SEED + 65).integers(1, n - 1, (MESH_CHECK, 3))
    pts = lin[pick]
    with torch.no_grad():   # the card's planes, sampled and decoded on the CPU
        ref = run_model(sample.planes.cpu(), copy.deepcopy(model.decoder).cpu(),
                        torch.from_numpy(pts)[None], model.cfg.rendering)["sigma"][0, :, 0]
    ref = ref.numpy()
    err = float(np.abs(sigma[pick[:, 0], pick[:, 1], pick[:, 2]] - ref).max())
    print(f"[25/28] EG3D mesh of the ball scene (eg3d_ball_params at eval_eg3d's defaults): "
          f"checkpoint loaded in {load_s:.3f} s, planes synthesised once in {planes_s:.3f} s, "
          f"sigma grid {n}^3 (chunk {hp.chunk}) in {grid_s:.3f} s ({card}); sigma range "
          f"{float(sigma[1:-1, 1:-1, 1:-1].min()):.3f}..{float(sigma.max()):.3f}; {MESH_CHECK} "
          f"interior grid points vs the card's planes sampled and decoded on the CPU: max|d| "
          f"{err:.3e} (atol "
          f"{MESH_ATOL} + 1e-3 |ref|)", flush=True)
    if not np.isfinite(sigma).all() or err > MESH_ATOL + 1e-3 * float(np.abs(ref).max()):
        fail("the card's EG3D sigma grid disagrees with the CPU's")
    (verts, faces), march_s = timed_s(lambda: marching_tetrahedra(
        sigma, hp.sigma_threshold, spacing=(hp.cube_length / (n - 1),) * 3,
        origin=(-half,) * 3))
    colors, color_s = timed_s(lambda: ecm.vertex_colors(sample, verts, hp.chunk, device))
    path = os.path.join(hp.out_dir, "eg3d_ball.ply")
    write_ply(path, verts, faces, colors)
    c = check_ply(path, verts, faces, "EG3D mesh")
    print(f"[25/28] marching tetrahedra at sigma {hp.sigma_threshold}: {len(verts)} vertices, "
          f"{len(faces)} faces in {march_s:.3f} s (host); vertex radius median "
          f"{np.median(np.linalg.norm(verts, axis=-1)):.4f} (the ball's radius {BALL_R}); "
          f"decoder colours in {color_s:.3f} s, median {np.round(np.median(c, 0), 4).tolist()} "
          f"(the ball's {list(BALL_RGB)}); PLY written and read back; {card}", flush=True)


# ---- multi-GPU (phases 26-27) ----------------------------------------------------------

def n_unequal(a, b):
    """Tensors of two states' parameter lists that are not bit-equal."""
    import torch

    return sum(not torch.equal(x, y) for x, y in zip(param_list(a), param_list(b)))


def dp_runs(label, make_system, models, batches, seed, card, k2_launches):
    """Phase 26 on one system: DP_STEPS eager steps and one group of as many
    through the data-parallel path (a `DataParallel` of the one-rank group)
    against the non-distributed path, from the same weights, seed and
    batches, bit for bit; then ms per step of both, eager and grouped, in
    turns. K2's launches on the data-parallel path go to `k2_launches`."""
    import torch
    from nerf_siren_tpu_torch.parallel.mesh import cross_replica_param_hash

    n = DP_STEPS
    eager, group = {}, {}
    for mode in ("plain", "dp"):
        system = make_system(mode == "dp")
        state = state_copy(system, models)
        before = dict(k2_launches_now())
        losses = []
        for b in batches[:n]:
            state, metrics = system.train_step(state, b, seed=seed)
            losses.append(metrics["train/loss"])
        eager[mode] = (system, state, torch.stack(losses))
        gstate = state_copy(system, models)
        refused = None
        try:
            gstate, _ = system.train_scan_batches(gstate, *stacked(batches[:n]), seed=seed)
        except RuntimeError as e:
            if mode != "dp" or "refused" not in str(e):
                raise
            refused = str(e)
        group[mode] = (gstate, None if refused else system.last_group.steps[:, 0].clone(),
                       refused)
        if mode == "dp":
            for k, v in k2_calls_since(before).items():
                k2_launches[k] += v
    torch.cuda.synchronize()
    e_diff = n_unequal(eager["plain"][1], eager["dp"][1])
    e_loss = torch.equal(eager["plain"][2], eager["dp"][2])
    refused = group["dp"][2]
    if refused:
        g_diff, g_loss = None, None
    else:
        g_diff = n_unequal(group["plain"][0], group["dp"][0])
        g_loss = torch.equal(group["plain"][1], group["dp"][1])
    h = float(cross_replica_param_hash(eager["dp"][1].models))
    print(f"[26/28] {label}: {n} eager steps, data-parallel (NCCL, world 1) vs "
          f"non-distributed: {e_diff} parameter tensors differ, losses bit-equal {e_loss}; "
          f"one group of {n} on a CUDA graph: "
          + (f"REFUSED: {refused}" if refused else
             f"{g_diff} tensors differ, losses bit-equal {g_loss}")
          + f"; replica hash {h!r}", flush=True)
    if e_diff or not e_loss:
        fail(f"{label}: data-parallel eager steps are not bit-equal to the non-distributed ones")
    if not refused and (g_diff or not g_loss):
        fail(f"{label}: data-parallel grouped steps are not bit-equal to the non-distributed "
             f"ones")
    # ms per step in turns, eager and grouped, on the next batches
    times = {f"{k} {m}": [] for k in ("eager", "grouped") for m in ("plain", "dp")}
    rest = batches[n:2 * n]
    for _ in range(2):
        for m in ("plain", "dp", "dp", "plain"):
            system, state, _ = eager[m]
            _, dt = synced_s(lambda: [system.train_step(state, b, seed=seed) for b in rest])
            times[f"eager {m}"].append(1e3 * dt / n)
            if group[m][2] is None:
                _, dt = synced_s(lambda: system.train_scan_batches(group[m][0], *stacked(rest),
                                                                   seed=seed))
                times[f"grouped {m}"].append(1e3 * dt / n)
    med = {k: float(np.median(v)) if v else float("nan") for k, v in times.items()}
    print(f"[26/28] {label}: ms per step in turns (plain, dp, dp, plain, twice): "
          + "; ".join(f"{k} {[round(x, 3) for x in v]} (median {med[k]:.3f})"
                      for k, v in times.items() if v)
          + f"; grouped dp / plain {med['grouped dp'] / med['grouped plain']:.4f}, eager dp / "
          f"plain {med['eager dp'] / med['eager plain']:.4f}; {card}", flush=True)
    if not refused:
        g_diff = n_unequal(group["plain"][0], group["dp"][0])
        if g_diff:
            fail(f"{label}: after the replays {g_diff} tensors differ between the paths")
    return med


def k2_launches_now():
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    return dict(k2.LAUNCHES)


def data_parallel_phase(pool_rays, pool_rgbs, device, card):
    """Phase 26: the data-parallel training path on a one-rank NCCL group.
    Returns K2's launches on that path."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from nerf_siren_tpu_torch.convert import eg3d_from_jax
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel
    from nerf_siren_tpu_torch.render.culled_train import PROXY_HIDDEN
    from nerf_siren_tpu_torch.render.fast import init_proxy
    from nerf_siren_tpu_torch.train import build_system

    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        dp = DataParallel()
        gen = torch.Generator(device=device).manual_seed(SEED + 70)
        steps_per_epoch = pool_rays.shape[0] // TRAIN_RAYS

        def batch():
            idx = torch.randint(0, pool_rays.shape[0], (TRAIN_RAYS,), generator=gen,
                                device=device)
            return {"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]}

        batches = [batch() for _ in range(2 * DP_STEPS)]
        print(f"[26/28] data parallel: a one-rank NCCL group (file store), "
              f"{dist.get_backend()} world {dp.world}; {DP_STEPS} steps of {TRAIN_RAYS} rays "
              f"per run ({N_SAMPLES}+{N_IMPORTANCE}, perturb 1, noise 1, Adam {LR})", flush=True)
        launches = {"fwd": 0, "bwd": 0}
        base = numpy_models(SEED + 71, device)
        meds = {}
        for backend in ("fused", "culled_fused"):
            models = {k: copy.deepcopy(m) for k, m in base.items()}
            if backend == "culled_fused":
                models["proxy"] = init_proxy(PROXY_HIDDEN, generator=torch.Generator().manual_seed(
                    SEED + 72)).to(device)
            meds[backend] = dp_runs(
                backend, lambda with_dp, b=backend: train_system(
                    b, 1.0, 1.0, steps_per_epoch, device, data_parallel=dp if with_dp else None),
                models, batches, SEED + 73, card, launches)
        for backend, (eager_ms, grouped_ms) in STEP_MS.items():
            if backend in meds:
                print(f"[26/28] {backend}: phase {6 if backend == 'fused' else 23}'s "
                      f"non-distributed steps read eager {eager_ms:.3f}, grouped "
                      f"{grouped_ms:.3f} ms; here non-distributed "
                      f"{meds[backend]['eager plain']:.3f} / {meds[backend]['grouped plain']:.3f}"
                      f", data-parallel {meds[backend]['eager dp']:.3f} / "
                      f"{meds[backend]['grouped dp']:.3f} (predicted within 5% grouped); "
                      f"{card}", flush=True)
        if launches["fwd"] < 2 * DP_STEPS or launches["bwd"] < 2 * DP_STEPS:
            fail(f"K2 launched {launches} times on the data-parallel path, expected >= "
                 f"{2 * DP_STEPS} each")
        dp_runs_d3(dp, device, card)
        # EG3D at the train CLI's defaults, under deterministic algorithms (its
        # atomics make even two eager runs differ otherwise, phase 21)
        hp = get_opts(["--root_dir", ".", "--mode", "eg3d"])
        plain = build_system(hp, white_back=True, steps_per_epoch=1000, device=device)
        model = plain.init_model()
        model.load_state_dict(eg3d_from_jax(numpy_eg3d_params(
            np.random.default_rng(EG3D_SEED + 40), plain.cfg)))
        eg3d_batches = [{"rays": b["rays"], "rgbs": b["rgbs"]} for b in batches]
        torch.use_deterministic_algorithms(True)
        try:
            dp_runs_eg3d(hp, dp, model.to(device), eg3d_batches, device, card)
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"[26/28] K2 launches on the data-parallel path {launches}", flush=True)
        return launches
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def dp_runs_d3(dp, device, card):
    """Phase 26's d3 msenll steps with ignored labels (-100 on a third of
    each batch's rows): DP_STEPS eager steps and one group of as many,
    data-parallel against non-distributed, bit for bit. The class loss's
    valid count goes through `DataParallel.mean_count`: one NCCL all-reduce
    in each eager step, and in the captured graph of the group."""
    import torch

    n = DP_STEPS
    batches = sem_batches(device, SEED + 75, classes=True)[:n]
    rows = torch.arange(TRAIN_RAYS, device=device)
    for k, b in enumerate(batches):
        b["cls"] = torch.where(rows % 3 == k % 3, -100, b["cls"])
    ignored = [int((b["cls"] == -100).sum()) for b in batches]
    models = numpy_models(SEED + 76, device)
    models["points"] = numpy_points(SEED + 77, device)
    runs = {}
    for mode in ("plain", "dp"):
        system = d3_system(device, "pointnet", data_parallel=dp if mode == "dp" else None)
        state = state_copy(system, models)
        losses = []
        for b in batches:
            state, metrics = system.train_step(state, b, seed=SEED + 78)
            losses.append(metrics[system.LOSS_KEY])
        gstate = state_copy(system, models)
        refused = None
        try:
            gstate, _ = system.train_scan_batches(
                gstate, *stacked(batches), seed=SEED + 78,
                cls_b=torch.stack([b["cls"] for b in batches]))
        except RuntimeError as e:
            if mode != "dp" or "refused" not in str(e):
                raise
            refused = str(e)
        runs[mode] = (state, torch.stack(losses), gstate, refused,
                      None if refused else system.last_group.steps[:, 0].clone())
    torch.cuda.synchronize()
    e_diff = n_unequal(runs["plain"][0], runs["dp"][0])
    e_loss = torch.equal(runs["plain"][1], runs["dp"][1])
    refused = runs["dp"][3]
    g_diff = None if refused else n_unequal(runs["plain"][2], runs["dp"][2])
    g_loss = None if refused else torch.equal(runs["plain"][4], runs["dp"][4])
    print(f"[26/28] d3 pointnet msenll, {ignored} of {TRAIN_RAYS} labels ignored a step: "
          f"{n} eager steps data-parallel (the masked mean's count all-reduced) vs "
          f"non-distributed: {e_diff} tensors differ, losses bit-equal {e_loss}; one group of "
          f"{n} on a CUDA graph: "
          + (f"REFUSED: {refused}" if refused else
             f"{g_diff} tensors differ, losses bit-equal {g_loss}")
          + f"; {card}", flush=True)
    if e_diff or not e_loss or refused or g_diff or not g_loss:
        fail("d3 msenll: data-parallel steps over ignored labels are not bit-equal to the "
             "non-distributed ones, or their group was refused")


def dp_runs_eg3d(hp, dp, model, batches, device, card):
    """Phase 26's EG3D steps: DP_EG3D_STEPS eager steps and one group of as
    many, data-parallel against non-distributed, bit for bit."""
    import torch
    from nerf_siren_tpu_torch.parallel.mesh import cross_replica_param_hash
    from nerf_siren_tpu_torch.train import build_system
    from nerf_siren_tpu_torch.training.eg3d_system import MODEL

    n = DP_EG3D_STEPS
    runs = {}
    for mode in ("plain", "dp"):
        system = build_system(hp, white_back=True, steps_per_epoch=1000, device=device,
                              data_parallel=dp if mode == "dp" else None)
        state = state_copy(system, {MODEL: model})
        losses = []
        t = []
        for b in batches[:n]:
            (state, metrics), dt = synced_s(lambda: system.train_step(state, b, seed=SEED + 74))
            losses.append(metrics["train/loss"])
            t.append(1e3 * dt)
        gstate = state_copy(system, {MODEL: model})
        refused = None
        try:
            (gstate, _), gs = synced_s(lambda: system.train_scan_batches(
                gstate, *stacked(batches[:n]), seed=SEED + 74))
        except RuntimeError as e:
            if mode != "dp" or "refused" not in str(e):
                raise
            refused, gs = str(e), float("nan")
        w_avg = state.models[MODEL].backbone.mapping.w_avg
        runs[mode] = (state, torch.stack(losses), gstate, refused, t, gs, w_avg)
    e_diff = n_unequal(runs["plain"][0], runs["dp"][0])
    e_loss = torch.equal(runs["plain"][1], runs["dp"][1])
    refused = runs["dp"][3]
    g_diff = None if refused else n_unequal(runs["plain"][2], runs["dp"][2])
    w_eq = torch.equal(runs["plain"][6], runs["dp"][6])
    h = float(cross_replica_param_hash(runs["dp"][0].models[MODEL]))
    print(f"[26/28] EG3D (--mode eg3d defaults, deterministic algorithms): {n} eager steps "
          f"data-parallel vs non-distributed: {e_diff} tensors differ, losses bit-equal "
          f"{e_loss}, w_avg bit-equal {w_eq}; one group of {n}: "
          + (f"REFUSED: {refused}" if refused else f"{g_diff} tensors differ")
          + f"; eager ms per step plain {[round(v, 3) for v in runs['plain'][4]]}, dp "
          f"{[round(v, 3) for v in runs['dp'][4]]}; the first group (with its capture) s plain "
          f"{runs['plain'][5]:.3f}, dp {runs['dp'][5]:.3f}; replica hash {h!r}; {card}",
          flush=True)
    if e_diff or not e_loss or not w_eq or (not refused and g_diff):
        fail("EG3D: data-parallel steps are not bit-equal to the non-distributed ones")


def sharded_render_phase(ball_ckpt, device, card):
    """Phase 27: frames on a mesh of the card twice (two slabs, two host
    threads and streams: the route of every mesh) against one-device frames.
    Returns the launches of K1, K3 and K5 on the sharded frames."""
    from pathlib import Path

    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import get_opts, make_renderer, setup_fast_proxy
    from nerf_siren_tpu_torch.eval_eg3d import get_opts as eg3d_opts
    from nerf_siren_tpu_torch.eval_eg3d import load_model, triplane_config
    from nerf_siren_tpu_torch.parallel.mesh import make_mesh
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    mesh = make_mesh(devices=[device, device])
    launches = {}

    def turns(one, two, rays):
        """Outputs and seconds in turns (one, two, two, one; twice)."""
        secs = {"one": [], "two": []}
        outs = {}
        with torch.no_grad():
            for _ in range(2):
                for m in ("one", "two", "two", "one"):
                    outs[m], dt = synced_s(lambda: (one if m == "one" else two)(rays))
                    secs[m].append(dt)
        return outs, secs

    def report(label, outs, secs, names):
        diff = sum(int((outs["one"][k] != outs["two"][k]).sum()) for k in outs["one"])
        print(f"[27/28] {label}: {diff} output elements differ between the two slabs and one "
              f"device; s " + ", ".join(f"{k} {[round(v, 4) for v in t]}" for k, t in secs.items())
              + f" (two / one {np.median(secs['two']) / np.median(secs['one']):.4f}, medians); "
              f"launches of the two-slab frame {names}; {card}", flush=True)
        if diff:
            fail(f"{label}: the two-slab frame is not bit-equal to the one-device frame")

    print(f"[27/28] sharded rendering: mesh {mesh}", flush=True)
    # (a) the 800² exact frame on K1 (slab boundary 327,680 = 10 chunks)
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    models = numpy_models(SEED, device)
    rays = lego_rays(0, device)
    k1 = ["fused_nerf_sigma", "fused_nerf_full"]
    two = make_renderer(models, cfg, renderer="fused", mesh=mesh)
    reset_counts(k1)
    with torch.no_grad():
        two(rays)
    torch.cuda.synchronize()
    launches["exact"] = read_counts(k1)
    outs, secs = turns(make_renderer(models, cfg, renderer="fused"), two, rays)
    check_outputs([outs["two"]], "two-slab exact frame")
    report(f"exact {H}x{W} frame (fused, K1)", outs, secs, launches["exact"])
    del outs, two

    # (a') the same frame on the plain fields, float32 (`--renderer exact`):
    # the slabs' threads must take the caller's no_grad (a slab recording
    # the fields' graph holds every chunk's activations to the frame's end);
    # the slab boundary (320,000 rays) splits a chunk, so within 1e-4; in
    # chunks of CHUNK / 4 rays, since the two slabs' float32 chunks share
    # one card's memory at once
    pcfg = cfg.replace(chunk=CHUNK // 4)
    graphs = []
    hooks = [m.register_forward_hook(lambda m, i, o: graphs.append(o.requires_grad))
             for m in models.values()]
    plain = {}
    with torch.no_grad():
        for m, route in (("one", None), ("two", mesh)):
            render = make_renderer(models, pcfg, renderer="exact", mesh=route)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out, dt = synced_s(lambda: render(rays))
            plain[m] = (out, dt, (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    for h in hooks:
        h.remove()
    gap = max(float((plain["one"][0][k] - plain["two"][0][k]).abs().max()) for k in plain["one"][0])
    held = any(v.grad_fn is not None for v in plain["two"][0].values())
    print(f"[27/28] exact {H}x{W} frame on the plain fields (float32, no kernel, chunk "
          f"{pcfg.chunk}), under no_grad: "
          f"one device {plain['one'][1]:.3f} s, peak {plain['one'][2]:.2f} GiB above the frame's "
          f"inputs; two slabs {plain['two'][1]:.3f} s, peak {plain['two'][2]:.2f} GiB; max |diff| "
          f"{gap:.3e} (bar 1e-4); {len(graphs)} field forwards, {sum(graphs)} recording a graph; "
          f"{card}", flush=True)
    check_outputs([plain["two"][0]], "two-slab plain exact frame")
    if any(graphs) or held:
        fail("a slab of the plain exact frame recorded an autograd graph under no_grad")
    if gap > 1e-4:
        fail(f"the two-slab plain exact frame differs from one device by {gap:.3e}")
    del models, plain, rays

    # (b) the fast frame (K3 select, K1) and (c) auto-cull in mesh mode (K3 opacity)
    ball = numpy_models(FIELD_SEED, device, ball_nerf_params)
    ckpt_dir = Path(ball_ckpt).parent

    def opts(*extra):
        return get_opts(["--root_dir", str(ckpt_dir), "--ckpt_path", ball_ckpt, "--renderer",
                         "fast", "--chunk", str(CHUNK), *extra])

    bounds = np.array([NEAR, FAR], np.float32)
    hp = opts()
    fast = setup_fast_proxy(ball, hp, bounds)   # phase 7's cache
    k3s = ["proxy_march_select", "fused_nerf_full"]
    one_fast = make_renderer(ball, cfg, renderer="fast", fast=fast, hparams=hp, img_hw=(H, W))
    two_fast = make_renderer(ball, cfg, renderer="fast", fast=fast, hparams=hp, img_hw=(H, W),
                             mesh=mesh)
    frames = [lego_rays(k, device) for k in range(N_FRAMES)]
    reset_counts(k3s)
    with torch.no_grad():
        two_fast(frames[0])
    torch.cuda.synchronize()
    launches["fast"] = read_counts(k3s)
    outs, secs = turns(one_fast, two_fast, frames[0])
    check_outputs([outs["two"]], "two-slab fast frame")
    report(f"fast {H}x{W} frame (K3 select, K1)", outs, secs, launches["fast"])
    with torch.no_grad():
        fast_frames = [outs["one"]] + [one_fast(r) for r in frames[1:]]

    auto = make_renderer(ball, cfg, renderer="fast", fast=fast,
                         hparams=opts("--fast_cull", "auto"), img_hw=(H, W), mesh=mesh)
    auto_one = make_renderer(ball, cfg, renderer="fast", fast=fast,
                             hparams=opts("--fast_cull", "auto"), img_hw=(H, W))
    key = fast.model_key
    reset_counts(["proxy_opacity"])
    auto_s, one_s = [], []
    with torch.no_grad():
        for i in range(N_AUTO):
            k = i % N_FRAMES
            (out,), (sec,) = render_frames(auto, [frames[k]])
            auto_s.append(sec)
            ref = fast_frames[k]
            same = (out[f"rgb_{key}"] - ref[f"rgb_{key}"]).abs().amax(-1) <= 1e-6
            for name in ("depth", "opacity"):
                same &= (out[f"{name}_{key}"] - ref[f"{name}_{key}"]).abs() <= 1e-6
            bg = ((out[f"rgb_{key}"] == 1.0).all(-1) & (out[f"depth_{key}"] == 0)
                  & (out[f"opacity_{key}"] == 0))
            print(f"[27/28] auto-cull frame {i} in mesh mode (camera {k}): {sec:.4f} s; active "
                  f"fraction {auto.last_active_frac:.4f}, bypass {auto.last_plain}, eps per "
                  f"shard {[round(float(e), 5) for e in auto.last_eps]}; "
                  f"{int((same & ~bg).sum())} rays rendered, {int((bg & ~same).sum())} culled "
                  f"to background; {card}", flush=True)
            check_outputs([out], "mesh-mode auto-cull frame")
            if not bool((same | bg).all()):
                fail("a mesh-mode auto-cull ray is neither the fast frame's value nor "
                     "background")
        launches["auto"] = read_counts(["proxy_opacity"])
        for i in range(N_AUTO):
            one_s.append(render_frames(auto_one, [frames[i % N_FRAMES]])[1][0])
    print(f"[27/28] auto-cull frames s: mesh mode {[round(v, 4) for v in auto_s]}, one device "
          f"{[round(v, 4) for v in one_s]} (the same cameras, after); medians of the last "
          f"{N_AUTO - 1}: {np.median(auto_s[1:]):.4f} / {np.median(one_s[1:]):.4f}; {card}",
          flush=True)
    if launches["auto"]["proxy_opacity"] < 1:
        fail("the mesh-mode auto-cull frames never launched the opacity prepass")
    del ball, fast, fast_frames, frames, outs

    # (d) a 128² EG3D frame on K5 through render_sharded (two slabs of 2 chunks)
    ckpt = str(Path("ckpts") / "chip_smoke" / "eg3d.msgpack")
    hpe = eg3d_opts(["--root_dir", ".", "--ckpt_path", ckpt, "--plane_sampler", "kernel"])
    system = EG3DSystem(triplane_config(hpe, white_back=True), hpe.plane_sampler)
    model = load_model(system, ckpt, device)
    rays = lego_rays(0, device, EG3D_WH, EG3D_WH)
    reset_counts(["triplane_gather"])
    with torch.no_grad():
        system.render_sharded(model, rays, mesh, chunk=hpe.chunk)
    torch.cuda.synchronize()
    launches["eg3d"] = read_counts(["triplane_gather"])
    outs, secs = turns(lambda r: system.render(model, r, chunk=hpe.chunk),
                       lambda r: system.render_sharded(model, r, mesh, chunk=hpe.chunk), rays)
    report(f"EG3D {EG3D_WH}x{EG3D_WH} frame (K5)", outs, secs, launches["eg3d"])
    for name, counts in launches.items():
        if min(counts.values()) < 1:
            fail(f"the two-slab {name} frame did not launch {counts}")
    return launches


# ---- tools and examples (phase 28) ------------------------------------------------------

def lego_cameras(n):
    """`lego_pose`s of n cameras at elevations of 15-60 degrees in turn, the
    layout of a Blender scene's training set, as float32."""
    return [lego_pose(k, n, 15.0 + 15.0 * (k % 4)).astype(np.float32) for k in range(n)]


def native_rays_check(card):
    """Phase 28(a): the datasets' rays of N_LEGO_CAMERAS cameras at 800² through
    the C++ helper and through numpy: within the bars of the JAX package's
    tests/test_native.py; host seconds of each route."""
    from nerf_siren_tpu_torch import native
    from nerf_siren_tpu_torch.datasets import ray_utils

    if not native.available():
        fail(f"the native ray helper did not build: {native.build_error()}")
    poses = lego_cameras(N_LEGO_CAMERAS)
    rays, secs = {}, {}
    for route, on in (("native", True), ("numpy", False)):
        ray_utils._USE_NATIVE = on
        t0 = time.perf_counter()
        dirs = ray_utils.get_ray_directions(H, W, FOCAL)
        rays[route] = (dirs, [ray_utils.get_rays(dirs, c2w) for c2w in poses])
        secs[route] = time.perf_counter() - t0
    ray_utils._USE_NATIVE = True
    (nd, nr), (pd, pr) = rays["native"], rays["numpy"]
    d_dir = float(np.abs(nd - pd).max())
    d_o = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(nr, pr))
    d_d = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(nr, pr))
    ok = (np.allclose(nd, pd, rtol=1e-6, atol=0)
          and all(np.allclose(a[0], b[0], rtol=1e-6, atol=0)
                  and np.allclose(a[1], b[1], **NATIVE_RAY_TOL) for a, b in zip(nr, pr)))
    print(f"[28/28] (a) dataset rays of {N_LEGO_CAMERAS} cameras at {H}x{W} "
          f"({N_LEGO_CAMERAS * H * W} rays): native helper {secs['native']:.3f} s, numpy "
          f"{secs['numpy']:.3f} s (host; {secs['numpy'] / secs['native']:.2f}x); max|d| "
          f"directions {d_dir:.3e}, origins {d_o:.3e}, world directions {d_d:.3e} (bars: "
          f"rtol 1e-6; rtol 1e-6; rtol {NATIVE_RAY_TOL['rtol']} + atol "
          f"{NATIVE_RAY_TOL['atol']}); {card}", flush=True)
    if not ok:
        fail("the native rays disagree with numpy beyond the bars")
    return secs


def k1_slice(models, rays, cfg=None):
    """The K1 frame of `models` (both fields packed) on `rays` at `cfg`
    (phase 4's config by default)."""
    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.ops.kernels.fused_mlp import pack_model_params
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    cfg = cfg or RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                              noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    with torch.no_grad():
        out = render_rays_fused(pack_model_params(models), rays, cfg)
    torch.cuda.synchronize()
    return out


def fields_from(trees, device):
    """Full-width coarse and fine fields from {key: state_dict} on the CPU."""
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.models.nerf import NeRF

    out = {}
    for k, sd in trees.items():
        m = NeRF(NeRFConfig())
        m.load_state_dict(sd)
        out[k] = m.to(device)
    return out


def round_trips(trained, full_ckpt, device, card):
    """Phase 28(b, c): fresh fields from `save_weights_only`'s file and from a
    reference-format checkpoint through `import_torch_ckpt` give phase 6's
    trained fields' K1 slice bit for bit. Returns K1's launches over both."""
    import torch
    from nerf_siren_tpu_torch.convert import nerf_to_jax
    from nerf_siren_tpu_torch.tools.import_torch_ckpt import import_torch_ckpt
    from nerf_siren_tpu_torch.tools.psnr_parity import export_torch_ckpt
    from nerf_siren_tpu_torch.training.checkpoints import load_nerf_fields
    from nerf_siren_tpu_torch.utils.save_weights_only import save_weights_only

    from pathlib import Path

    rays = lego_rays(0, device)[CHECK_RAYS.start: CHECK_RAYS.start + SLICE_RAYS]
    want = k1_slice(fields_from(trained, device), rays)
    k1 = ["fused_nerf_sigma", "fused_nerf_full"]
    reset_counts(k1)
    weights, w_s = timed_s(lambda: save_weights_only(full_ckpt))
    got_w = k1_slice(load_nerf_fields(weights, device), rays)
    ref = str(Path(full_ckpt).with_name("reference_format.ckpt"))
    imported = str(Path(full_ckpt).with_name("imported.msgpack"))
    export_torch_ckpt({k: nerf_to_jax(sd) for k, sd in trained.items()}, ref)
    _, i_s = timed_s(lambda: import_torch_ckpt(ref, imported))
    got_i = k1_slice(load_nerf_fields(imported, device), rays)
    launches = read_counts(k1)
    for label, path, sec, got in (("(b) save_weights_only", weights, w_s, got_w),
                                  ("(c) import_torch_ckpt", imported, i_s, got_i)):
        diff = sum(int((got[k] != want[k]).sum()) for k in want)
        print(f"[28/28] {label}: fresh fields from {Path(path).name} ({sec:.3f} s to write) "
              f"vs phase 6's trained fields, a K1 slice of {SLICE_RAYS} rays: {diff} output "
              f"elements differ; {card}", flush=True)
        if diff or not all(torch.isfinite(v).all() for v in got.values()):
            fail(f"{label}: the round-tripped fields' K1 slice is not the trained fields'")
    return launches


def parity_phase(device, card):
    """Phase 28(d): `tools/psnr_parity` at PARITY_ARGS (full 8x256 width): K1
    launched at least once a chunk, plain float32 agreement with the oracle
    >= PARITY_F32_DB and K1's >= PARITY_K1_DB; every delta printed."""
    from nerf_siren_tpu_torch.tools import psnr_parity

    k1 = ["fused_nerf_sigma", "fused_nerf_full"]
    args = psnr_parity.get_opts(PARITY_ARGS + ["--out", "ckpts/chip_smoke/parity/parity.json"])
    reset_counts(k1)
    res, sec = timed_s(lambda: psnr_parity.run(args))
    launches = read_counts(k1)
    chunks = args.poses   # the tool renders a pose as one chunk
    for r in res["rows"]:
        print(f"[28/28] (d) psnr_parity {' '.join(PARITY_ARGS)}: pose {r['pose']}: oracle "
              f"{r['torch_oracle_psnr']:.3f} dB vs the scene; " + "; ".join(
                  f"{n} delta {r[f'{n}_delta_db']:+.4f} dB, agreement "
                  f"{r[f'{n}_agreement_db']:.2f} dB, {r[f'{n}_s']:.4f} s"
                  for n in psnr_parity.BACKENDS) + f" (oracle {r['torch_oracle_s']:.4f} s); "
              f"{card}", flush=True)
    print(f"[28/28] (d) trained {args.steps} steps in {res['train_s']:.3f} s (train PSNR "
          f"{res['train_psnr']:.2f} dB), the whole tool {sec:.3f} s; K1 launches {launches} "
          f"(>= {chunks} each); {card}", flush=True)
    if min(launches.values()) < chunks:
        fail("psnr_parity's fused backend did not launch K1 once a chunk")
    for r in res["rows"]:
        if not (r["jnp_f32_agreement_db"] >= PARITY_F32_DB
                and r["fused_agreement_db"] >= PARITY_K1_DB):
            fail(f"psnr_parity pose {r['pose']}: agreement below {PARITY_F32_DB} / "
                 f"{PARITY_K1_DB} dB")
    return launches


def examples_phase(ball_ckpt, ball_grid, device, card, args):
    """Phase 28(e, f): `export_unity_vol` and `mesh_threshold_sweep` on the ball
    field's sigma grid at MESH_GRID^3 (equal to phase 24's), `render_view` on
    one 400² lego camera against the K1 frame, timed in turns with the same
    plain render in float32."""
    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.render.rendering import render_rays_chunked
    from nerf_siren_tpu_torch.examples import export_unity_vol as euv
    from nerf_siren_tpu_torch.examples import render_single_image as rsi
    from nerf_siren_tpu_torch.examples.mesh_threshold_sweep import sweep
    from nerf_siren_tpu_torch.extract_color_mesh import load_fine, predict_sigma_grid
    from nerf_siren_tpu_torch.training.checkpoints import load_nerf_fields

    sigma24, spacing24, origin24, n_faces24 = ball_grid
    out = "ckpts/chip_smoke/ball.vol"
    hp = euv.get_opts(["--ckpt_path", ball_ckpt, "--N_grid", str(MESH_GRID), "--chunk",
                       str(CHUNK), "--out", out])
    fine = load_fine(ball_ckpt, device)
    (sigma, spacing, origin), grid_s = timed_s(lambda: predict_sigma_grid(fine, hp, device))
    _, vol_s = timed_s(lambda: euv.write_vol(out, sigma, spacing, origin, hp.sigma_max))
    same = np.array_equal(sigma, sigma24) and spacing == spacing24 and origin == origin24
    rows, sweep_s = timed_s(lambda: sweep(sigma, SWEEP_THRESHOLDS, spacing, origin))
    print(f"[28/28] (e) export_unity_vol: sigma grid {MESH_GRID}^3 in {grid_s:.3f} s, equal to "
          f"phase 24's: {same}; {os.path.getsize(out)} bytes written in {vol_s:.3f} s; "
          f"mesh_threshold_sweep at {list(SWEEP_THRESHOLDS)}: (threshold, vertices, faces, "
          f"largest component's share) {[(t, v, f, round(c, 4)) for t, v, f, c in rows]} in "
          f"{sweep_s:.3f} s (host); {card}", flush=True)
    if not same:
        fail("the example's sigma grid differs from phase 24's")
    if rows[0][2] != n_faces24:
        fail(f"the sweep's faces at sigma {SWEEP_THRESHOLDS[0]} differ from phase 24's mesh")

    models = load_nerf_fields(ball_ckpt, device, VIEW_IMPORTANCE)
    cfg = RenderConfig(n_samples=VIEW_SAMPLES, n_importance=VIEW_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    rays = lego_rays(0, device, VIEW_WH, VIEW_WH)
    renders = {"bf16": lambda: rsi.render_view(models, rays, cfg),
               "f32": lambda: render_rays_chunked(models, rays, cfg, None)}
    with torch.no_grad():
        for fn in renders.values():   # warm-up
            fn()
        view, view_s = timed_s(renders["bf16"])
        turns = {k: [] for k in renders}
        for k in ("bf16", "f32", "f32", "bf16"):
            turns[k].append(timed_s(renders[k])[1])
    k1_frame = k1_slice(models, rays, cfg)
    if not all(torch.isfinite(v).all() for v in view.values()) or not (
            0 <= float(view["rgb_fine"].min()) and float(view["rgb_fine"].max()) <= 1 + 1e-3):
        fail("render_view: non-finite outputs or rgb outside [0, 1+1e-3]")
    agree = psnr_vs(view, k1_frame)
    print(f"[28/28] (f) render_single_image.render_view, one {VIEW_WH}x{VIEW_WH} lego camera of "
          f"the ball field ({VIEW_SAMPLES}+{VIEW_IMPORTANCE}, bf16 plain field): {view_s:.4f} s, "
          f"{VIEW_WH * VIEW_WH / view_s:.0f} rays/s; PSNR against the K1 frame {agree:.2f} dB; "
          f"then in turns (bf16, f32, f32, bf16) s bf16 {[round(v, 4) for v in turns['bf16']]}, "
          f"the same plain render in float32 {[round(v, 4) for v in turns['f32']]}; {card}",
          flush=True)
    if args.profile:
        with torch.no_grad():
            for k, fn in renders.items():
                profile(f"render_view {VIEW_WH}² plain field {k}", fn, card)
    return grid_s, view_s


# ---- the last narrowings (phase 29) ------------------------------------------------------

def frame_errors(got, ref, key="fine"):
    """(median, 99th pct) of |d| / max(1, max |ref|) per output of a frame."""
    errs = {}
    for name in ("rgb", "depth", "opacity"):
        a, b = got[f"{name}_{key}"], ref[f"{name}_{key}"]
        d = (a - b).abs() / max(1.0, float(b.abs().max()))
        errs[name] = (float(d.median()), percentile(d, 0.99))
    return errs


def check_widths(device, card):
    """Phase 29(a): K1 and K4, both passes, at every width beside 256 against
    their plain versions at WIDTH_POINTS points (one direction per
    FAST_K points), timed in turns with them, each beside its bound.
    Returns {kernel: {width: reading}}; these comparison launches are not
    counted."""
    import torch
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    rng = np.random.default_rng(SEED + 29)
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    n = WIDTH_POINTS
    xyz = (torch.rand((n, 3), generator=gen, device=device) - 0.5) * 8
    dirs = torch.nn.functional.normalize(
        torch.randn((-(-n // FAST_K), 3), generator=gen, device=device), dim=-1)
    readings = {name: {} for name in ("fused_nerf_sigma", "fused_nerf_full",
                                      "fused_nerf_sigma_int8", "fused_nerf_full_int8")}
    for width in NARROW_WIDTHS:   # 8-layer fields, weights from a numpy seed
        model = NeRF(NeRFConfig(width=width))
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        model = model.to(device)
        p16, p8 = fm.pack_nerf_params(model), k4.pack_nerf_params_int8(model)
        cases = (
            ("fused_nerf_sigma", lambda: fm.fused_nerf_sigma(p16, xyz),
             lambda: fm.fused_sigma_ref(p16, xyz), False, False),
            ("fused_nerf_full", lambda: fm.fused_nerf_full(p16, xyz, dirs, FAST_K),
             lambda: fm.fused_full_ref(p16, xyz, dirs, FAST_K), True, False),
            ("fused_nerf_sigma_int8", lambda: k4.fused_nerf_sigma_int8(p8, xyz),
             lambda: k4.fused_sigma_int8_ref(p8, xyz), False, True),
            ("fused_nerf_full_int8", lambda: k4.fused_nerf_full_int8(p8, xyz, dirs, FAST_K),
             lambda: k4.fused_full_int8_ref(p8, xyz, dirs, FAST_K), True, True))
        for name, kern, plain, full, int8 in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{name} at width {width}: shape {tuple(got.shape)} or non-finite output")
            d = (got - ref).abs()
            if int8:   # K4's bars (phase 8): rgb atol 2e-2, sigma 5e-2 + 2e-2 |ref|
                bad = int((d[:, :3] > INT8_RGB_ATOL).sum()) if full else 0
                bad += int((d[:, -1:] > INT8_SIGMA_TOL[0] + INT8_SIGMA_TOL[1]
                            * ref[:, -1:].abs()).sum())
                bars = f"rgb {INT8_RGB_ATOL}, sigma {INT8_SIGMA_TOL[0]} + {INT8_SIGMA_TOL[1]}|ref|"
                f_bf16, i8 = int8_work_per_point(p8, full)
                n_bytes = k4_weight_bytes(p8)
            else:
                atol, rtol = KERNEL_TOL
                bad = int((d > atol + rtol * ref.abs()).sum())
                bars = f"{atol} + {rtol}|ref|"
                f_bf16, i8 = _flop_per_point(p16, full), 0
                n_bytes = k1_weight_bytes(p16)
            n_bytes += n * (12 + (16 if full else 4)) + (dirs.numel() * 4 if full else 0)
            ms, plain_ms, (p1, k1, k2, p2) = timed_pair([kern], [plain], plain_reps=2)
            bound_ms, bound_by = bound(n * f_bf16, n_bytes, n * i8)
            err = float(d.max())
            print(f"[29/29] {name} at width {width}, {n} points: max|d| vs plain {err:.3e}, "
                  f"{bad} outside {bars}; kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
                  f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}); bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.1f}% of it; {card}", flush=True)
            if bad:
                fail(f"{name} at width {width} disagrees with its plain version")
            readings[name][str(width)] = {
                "points": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del model, p16, p8
    report = {**ptxas_report("fused_mlp"), **ptxas_report("fused_mlp_int8")}
    for sym in sorted(k for k in report if "nerf_field_kernel" in k or "int8_kernel" in k):
        regs, spills, stack = report[sym]
        tag = sym[sym.index("nerf_field"):].split("EEEv")[0]
        print(f"[29/29] build (-Xptxas -v) {tag}: {regs} registers, {spills} spill bytes, "
              f"{stack} bytes stack frame", flush=True)
    return readings


def narrow_field_paths(device, card):
    """Phase 29(b): a NeRFConfig(depth=5, width=128) field through the
    library's renderers, on its bf16 pack (K1) and its int8 pack (K4): an
    exact slice (`render_rays_fused`, coarse and fine) and a fast slice
    (`render_rays_fast`, K3 select + the field's full pass) each, against
    CPU re-renders on the plain versions. Returns the field kernels'
    launches of those calls."""
    import torch
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.render.fast import init_proxy, render_rays_fast
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    rng = np.random.default_rng(SEED + 30)
    models = {}
    for key in ("coarse", "fine"):
        model = NeRF(NeRFConfig(depth=5, width=128))
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        models[key] = model
    on_card = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    packs = {"bf16": (fm.pack_model_params(on_card), fm.pack_model_params(models, "cpu")),
             "int8": (k4.pack_model_params_int8(on_card),
                      k4.pack_model_params_int8(models, "cpu"))}
    proxy = init_proxy(96, generator=torch.Generator().manual_seed(SEED + 30))
    pp, pp_cpu = k3.pack_proxy_params(proxy, device), k3.pack_proxy_params(proxy, "cpu")
    rays = lego_rays(0, device)[CHECK_RAYS.start - CHUNK // 2: CHECK_RAYS.start + CHUNK // 2]
    check = slice(CHUNK // 2, CHUNK // 2 + 2048)
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    names = ["fused_nerf_sigma", "fused_nerf_full", "fused_nerf_sigma_int8",
             "fused_nerf_full_int8", "proxy_march_select"]
    kw = dict(n_candidates=FAST_C, n_keep=FAST_K, select="pdf", white_back=True,
              scene_aabb=([-1.5] * 3, [1.5] * 3))
    reset_counts(names)
    errs, secs = {}, {}
    for dtype, (packed, cpu_packed) in packs.items():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exact = render_rays_fused(packed, rays, cfg)
            fast = render_rays_fast(None, None, rays, packed_params=packed, packed_proxy=pp, **kw)
            torch.cuda.synchronize()
            secs[dtype] = round(time.perf_counter() - t0, 4)
            exact_ref = render_rays_fused(cpu_packed, rays[check].cpu(), cfg)
            fast_ref = render_rays_fast(None, None, rays[check].cpu(), packed_params=cpu_packed,
                                        packed_proxy=pp_cpu, **kw)
        for label, got, want in (("exact", exact, exact_ref), ("fast", fast, fast_ref)):
            for k, v in want.items():
                d = (got[k][check].cpu() - v).abs() / max(1.0, float(v.abs().max()))
                errs[f"{dtype} {label} {k}"] = (float(d.median()), percentile(d, 0.99))
    counts = read_counts(names)
    print(f"[29/29] a NeRFConfig(depth=5, width=128) field, {rays.shape[0]} rays through "
          f"render_rays_fused ({N_SAMPLES}+{N_IMPORTANCE}) and render_rays_fast (C {FAST_C}, K "
          f"{FAST_K}) on its bf16 and int8 packs in {secs} s ({card}); launches {counts}; 2048 "
          f"rays vs CPU re-renders on the plain versions, (median, 99th pct) of |d| / scale "
          f"{errs} (bars {FAST_BARS})", flush=True)
    if min(counts[k] for k in names[:4]) < 1:
        fail("the width-128 field's renders did not run on K1 and K4")
    if any(m >= FAST_BARS[0] or p >= FAST_BARS[1] for m, p in errs.values()):
        fail("the width-128 field's renders disagree with their plain re-renders")
    return {k: counts[k] for k in names[:4]}


def wide_candidates(ball_ckpt, device, card):
    """Phase 29(c, d): the eval CLI above 256 candidates on the ball field: a
    fast frame at `--fast_candidates 512` (K3 select) and an auto-cull frame
    at `--fast_prepass 512` (K3 opacity), each against the same renderer on
    K3's and K1's plain versions (the fast bars); K3 opacity at C 4096 and K6 at C 512
    against their plain versions (K6's scores within proxy_score_bar, the
    plain selection on them its depths bit for bit). Returns (K3 and K6
    launches of the CLI frames and of K6's pass, readings)."""
    from pathlib import Path

    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import get_opts, make_renderer, setup_fast_proxy
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    models = numpy_models(FIELD_SEED, device, ball_nerf_params)
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)

    def opts(*extra):   # on cuda, the parser refuses C above MAX_CANDIDATES
        return get_opts(["--root_dir", str(Path(ball_ckpt).parent), "--ckpt_path", ball_ckpt,
                         "--renderer", "fast", "--chunk", str(CHUNK), *extra])

    bounds = np.array([NEAR, FAR], np.float32)
    frame = lego_rays(1, device)
    launches, readings = {}, {}
    for label, name, extra in (
            ("fast frame", "proxy_march_select", ("--fast_candidates", str(WIDE_C))),
            ("auto-cull frame", "proxy_opacity", ("--fast_cull", "auto", "--fast_prepass",
                                                  str(WIDE_C)))):
        hp = opts(*extra)
        fast = setup_fast_proxy(models, hp, bounds)   # phase 7's cached proxy
        render = make_renderer(models, cfg, renderer="fast", fast=fast, hparams=hp, img_hw=(H, W))
        reset_counts([name])
        (out,), (sec,) = render_frames(render, [frame])
        launches[name] = read_counts([name])[name]
        with plain_fast_kernels():
            (ref,), (ref_sec,) = render_frames(render, [frame])
        check_outputs([out, ref], label)
        errs = frame_errors(out, ref)
        print(f"[29/29] CLI {label} at {' '.join(extra)}: {sec:.4f} s ({card}; on the plain "
              f"versions {ref_sec:.3f} s); {name} launches {launches[name]}; (median, 99th pct) "
              f"of |d| / scale vs the plain versions of K3 and K1 {errs} (bars {FAST_BARS})",
              flush=True)
        if launches[name] < 1 or any(m >= FAST_BARS[0] or p >= FAST_BARS[1]
                                     for m, p in errs.values()):
            fail(f"the CLI's {label} at C {WIDE_C} did not run on K3 or left its plain version")
        pp = fast.packed_proxy
    rays8 = clipped_rays(frame, fast.aabb)
    k3_bytes = sum(t.numel() * t.element_size() for t in pp.values())
    flop = proxy_flop_per_candidate(pp)

    # K3 opacity at C 4096, its own scores marched plainly bit-equal to it
    rays_op = rays8[torch.as_tensor(np.random.default_rng(SEED + 31).permutation(
        rays8.shape[0])[:OPACITY_4096_RAYS], device=device)]
    op = k3.proxy_opacity(pp, rays_op, 4096)
    scores = k3.proxy_march_scores(pp, rays_op, 4096)
    same = torch.equal(op, k3.proxy_opacity_ref(pp, rays_op, 4096, scores=scores))
    d = (op - k3.proxy_opacity_ref(pp, rays_op, 4096)).abs()
    del scores
    err = float(d.max())
    ms, plain_ms, _ = timed_pair([lambda: k3.proxy_opacity(pp, rays_op, 4096)],
                                 [lambda: k3.proxy_opacity_ref(pp, rays_op, 4096)], plain_reps=1)
    r = rays_op.shape[0]
    bound_ms, bound_by = bound(r * 4096 * flop, r * (32 + 4) + k3_bytes)
    readings["proxy_opacity"] = {"candidates": 4096, "rays": r, "max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": None}
    print(f"[29/29] proxy_opacity at {r} rays, C 4096 (one ray a block, "
          f"{k3.shared_bytes(pp['w1'].shape[0], 4096)} bytes of shared memory a CTA): median "
          f"|d| vs plain {float(d.median()):.3e}, max {err:.3e} (bars {OPACITY_BARS}); the plain "
          f"march on its own scores {'bit-equal' if same else 'DIFFERENT'}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of it; {card}", flush=True)
    if not same or not (float(d.median()) < OPACITY_BARS[0] and err < OPACITY_BARS[1]):
        fail("proxy_opacity at C 4096 disagrees with its plain version")

    # K3 select at C 512 over one chunk, timed beside its plain version
    chunk = rays8[:CHUNK]
    z = k3.proxy_march_select(pp, chunk, WIDE_C, FAST_K, midpoint=True)[0]
    rz = k3.proxy_march_select_ref(pp, chunk, WIDE_C, FAST_K, midpoint=True)[0]
    dz = (z - rz).abs() / (chunk[:, 7:8] - chunk[:, 6:7]).clamp_min(1e-6)
    ms, plain_ms, _ = timed_pair(
        [lambda: k3.proxy_march_select(pp, chunk, WIDE_C, FAST_K, midpoint=True)],
        [lambda: k3.proxy_march_select_ref(pp, chunk, WIDE_C, FAST_K, midpoint=True)],
        plain_reps=1)
    bound_ms, bound_by = bound(CHUNK * WIDE_C * flop, CHUNK * (32 + 16 * FAST_K) + k3_bytes)
    readings["proxy_march_select"] = {
        "candidates": WIDE_C, "rays": CHUNK, "max_abs_err": float((z - rz).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}
    print(f"[29/29] proxy_march_select at one chunk of {CHUNK} rays, C {WIDE_C}, K {FAST_K}: "
          f"depth |d|/(far-near) median {float(dz.median()):.3e}, 99th pct "
          f"{percentile(dz, 0.99):.3e} (bars {DEPTH_BARS}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% "
          f"of it; {card}", flush=True)
    if not (float(dz.median()) < DEPTH_BARS[0] and percentile(dz, 0.99) < DEPTH_BARS[1]):
        fail("proxy_march_select at C 512 disagrees with its plain version")

    # K6 at C 512: its scores within the bar, the plain selection on them its depths
    rays6 = rays8[:K6_RAYS]
    reset_counts(["proxy_select"])
    got = k6.proxy_select(pp, rays6, WIDE_C, K6_K)
    launches["proxy_select"] = read_counts(["proxy_select"])["proxy_select"]
    scores, z_read = k6.proxy_select_scores(pp, rays6, WIDE_C, K6_K)
    zc = k6.candidate_depths(rays6, WIDE_C)
    pts = rays6[:, None, 0:3] + rays6[:, None, 3:6] * zc[..., None]
    ref, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)
    within = bool(((scores - ref).abs() <= bar).all())
    same = torch.equal(got, z_read) and torch.equal(
        got, k6.proxy_select_ref(pp, rays6, WIDE_C, K6_K, scores=scores))
    n_sets, worst = k6.cut_swaps(ref, bar, scores, K6_K)
    err = float((got - k6.proxy_select_ref(pp, rays6, WIDE_C, K6_K)).abs().max())
    del scores, z_read, zc, pts, ref, bar
    ms, plain_ms, _ = timed_pair([lambda: k6.proxy_select(pp, rays6, WIDE_C, K6_K)],
                                 [lambda: k6.proxy_select_ref(pp, rays6, WIDE_C, K6_K)],
                                 plain_reps=1)
    bound_ms, bound_by = bound(K6_RAYS * WIDE_C * flop, K6_RAYS * (32 + 4 * K6_K) + k3_bytes)
    readings["proxy_select"] = {"candidates": WIDE_C, "rays": K6_RAYS, "max_abs_err": err,
                                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None}
    print(f"[29/29] proxy_select at {K6_RAYS} rays, C {WIDE_C}, K {K6_K}: scores "
          f"{'within' if within else 'BEYOND'} proxy_score_bar; the plain selection on them "
          f"{'bit-equal, in order' if same else 'DIFFERENT'}; {n_sets} rays keep another set, "
          f"worst swap / bars {worst:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it; launches "
          f"{launches['proxy_select']}; {card}", flush=True)
    if not (within and same and worst <= 1.0):
        fail("proxy_select at C 512 disagrees with its plain version")
    return launches, readings


def narrowings_phase(ball_ckpt, device, card):
    """Phase 29. Returns ({kernel: {path: launches}}, {kernel: readings})."""
    import torch

    t0 = time.perf_counter()
    readings = {name: {"widths": r} for name, r in check_widths(device, card).items()}
    torch.cuda.empty_cache()
    launches = {name: {"width 128 field, library renders (phase 29)": n}
                for name, n in narrow_field_paths(device, card).items()}
    wide_launches, wide = wide_candidates(ball_ckpt, device, card)
    for name, n in wide_launches.items():
        launches[name] = {f"C {WIDE_C} (phase 29)": n}
        readings[name] = {f"candidates_{wide[name]['candidates']}": wide[name]}
    torch.cuda.empty_cache()
    print(f"[29/29] phase 29 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, readings


def wide_field_readings(device, card):
    """Phase 30(a, b): K1 and K4, both passes, on the shapes their resident
    kernels refuse (the wide kernel, csrc/fused_mlp_wide.cu): 8-layer fields
    of widths WIDE_WIDTHS at WIDTH_POINTS points and of width 2048 at
    W2048_POINTS; then DEEP_FIELDS (depth 2 on the resident kernels, depth
    24 on the wide one) at WIDTH_POINTS. Each against its plain version on
    the same points (K1 within KERNEL_TOL, K4 within its phase 8 bars and
    with at most 1e-3 of its int8 layer inputs rounding apart on 4,096
    points),
    timed in turns with it, beside its bound. Returns {kernel name:
    {shape: reading}} (these comparison launches are not a path's)."""
    import torch
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    rng = np.random.default_rng(SEED + 80)
    readings = {}
    shapes = ([(w, 8, WIDTH_POINTS) for w in WIDE_WIDTHS] + [(2048, 8, W2048_POINTS)]
              + [(w, d, WIDTH_POINTS) for w, d in DEEP_FIELDS])
    for width, depth, n in shapes:
        xyz = torch.tensor(rng.uniform(-4.0, 4.0, (n, 3)), dtype=torch.float32, device=device)
        dirs = torch.tensor(rng.normal(size=(n // FAST_K, 3)), dtype=torch.float32,
                            device=device)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        model = NeRF(NeRFConfig(width=width, depth=depth))
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        model = model.to(device)
        p16, p8 = fm.pack_nerf_params(model), k4.pack_nerf_params_int8(model)
        del model
        wide16, wide8 = not fm.resident(width, depth), not k4.resident(p8, False)
        q_in = k4.int8_trunk_inputs(p8, xyz[:4096])
        apart, n_in = int((q_in != k4.int8_trunk_inputs_ref(p8, xyz[:4096])).sum()), q_in.numel()
        del q_in
        if apart > 1e-3 * n_in + 1:   # the card tests' bar (tests/test_torch_kernels.py)
            fail(f"K4 at width {width}, depth {depth}: {apart} of {n_in} int8 layer inputs "
                 f"round apart from the plain version's (bar 1e-3 of them)")
        cases = (
            ("fused_nerf_sigma", wide16, lambda: fm.fused_nerf_sigma(p16, xyz),
             lambda: fm.fused_sigma_ref(p16, xyz), False, False),
            ("fused_nerf_full", wide16, lambda: fm.fused_nerf_full(p16, xyz, dirs, FAST_K),
             lambda: fm.fused_full_ref(p16, xyz, dirs, FAST_K), True, False),
            ("fused_nerf_sigma_int8", wide8, lambda: k4.fused_nerf_sigma_int8(p8, xyz),
             lambda: k4.fused_sigma_int8_ref(p8, xyz), False, True),
            ("fused_nerf_full_int8", wide8,
             lambda: k4.fused_nerf_full_int8(p8, xyz, dirs, FAST_K),
             lambda: k4.fused_full_int8_ref(p8, xyz, dirs, FAST_K), True, True))
        for name, wide, kern, plain, full, int8 in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{name} at width {width}, depth {depth}: shape {tuple(got.shape)} or "
                     f"non-finite output")
            d = (got - ref).abs()
            if int8:   # K4's bars (phase 8): rgb atol 2e-2, sigma 5e-2 + 2e-2 |ref|
                bad = int((d[:, :3] > INT8_RGB_ATOL).sum()) if full else 0
                bad += int((d[:, -1:] > INT8_SIGMA_TOL[0] + INT8_SIGMA_TOL[1]
                            * ref[:, -1:].abs()).sum())
                bars = f"rgb {INT8_RGB_ATOL}, sigma {INT8_SIGMA_TOL[0]} + {INT8_SIGMA_TOL[1]}|ref|"
                f_bf16, i8 = int8_work_per_point(p8, full)
                n_bytes = k4_weight_bytes(p8)
            else:
                atol, rtol = KERNEL_TOL
                bad = int((d > atol + rtol * ref.abs()).sum())
                bars = f"{atol} + {rtol}|ref|"
                f_bf16, i8 = _flop_per_point(p16, full), 0
                n_bytes = k1_weight_bytes(p16)
            del got, ref
            n_bytes += n * (12 + (16 if full else 4)) + (dirs.numel() * 4 if full else 0)
            ms, plain_ms, (p1, k1, k2, p2) = timed_pair([kern], [plain], reps=3, plain_reps=1)
            bound_ms, bound_by = bound(n * f_bf16, n_bytes, n * i8)
            err = float(d.max())
            route = "wide kernel" if wide else "resident kernel"
            print(f"[30/30] {name} at width {width}, depth {depth}, {n} points ({route}): max|d| "
                  f"vs plain {err:.3e}, {bad} outside {bars}"
                  + (f", int8 layer inputs rounding apart {apart} of {n_in}"
                     if int8 else "")
                  + f"; kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain {plain_ms:.3f} ms "
                  f"({p1:.3f}, {p2:.3f}); bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it; {card}", flush=True)
            if bad:
                fail(f"{name} at width {width}, depth {depth} disagrees with its plain version")
            key = name + ("_wide" if wide else "")
            readings.setdefault(key, {})[f"width {width}, depth {depth}"] = {
                "points": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                **({"int8_inputs_apart": apart} if int8 else {})}
        del p16, p8, xyz, dirs, d
        torch.cuda.empty_cache()
    report = ptxas_report("fused_mlp_wide")
    for sym in sorted(k for k in report if "wide_kernel" in k):
        regs, spills, stack = report[sym]
        tag = sym[sym.index("nerf_field"):].split("EEEv")[0]
        print(f"[30/30] build (-Xptxas -v) {tag}: {regs} registers, {spills} spill bytes, "
              f"{stack} bytes stack frame", flush=True)
    return readings


class plain_field_kernels:
    """Within: `render_rays_fused` runs K1's and K4's plain versions on the
    card in place of the kernels."""

    def __enter__(self):
        from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
        from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
        from nerf_siren_tpu_torch.render import fused as fused_mod

        self.saved = fused_mod.field_kernels
        fused_mod.field_kernels = lambda packed: (
            (k4.fused_sigma_int8_ref, k4.fused_full_int8_ref) if "q0x" in packed
            else (fm.fused_sigma_ref, fm.fused_full_ref))
        return self

    def __exit__(self, *exc):
        from nerf_siren_tpu_torch.render import fused as fused_mod

        fused_mod.field_kernels = self.saved


def wide_render(device, card):
    """Phase 30(c): an 8 x 1024 field pair (numpy-seeded weights) renders
    WIDE_RENDER_RAYS rays of a lego frame through `render_rays_fused` on its
    bf16 pack (K1) and its int8 pack (K4): the wide kernel's path. Each
    render against the same renderer on the plain versions on the card
    (FAST_BARS per output). Returns the wide kernels' launches of those
    renders."""
    import torch
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    rng = np.random.default_rng(SEED + 81)
    models = {}
    for key in ("coarse", "fine"):
        model = NeRF(NeRFConfig(width=1024))
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        models[key] = model.to(device)
    packs = {"bf16": fm.pack_model_params(models), "int8": k4.pack_model_params_int8(models)}
    del models
    mid = H * W // 2
    rays = lego_rays(0, device)[mid - WIDE_RENDER_RAYS // 2: mid + WIDE_RENDER_RAYS // 2]
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    names = ["fused_nerf_sigma_wide", "fused_nerf_full_wide", "fused_nerf_sigma_int8_wide",
             "fused_nerf_full_int8_wide"]
    errs, secs = {}, {}
    reset_counts(names)
    outs = {}
    with torch.no_grad():
        for dtype, packed in packs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[dtype] = render_rays_fused(packed, rays, cfg)
            torch.cuda.synchronize()
            secs[dtype] = round(time.perf_counter() - t0, 4)
    counts = read_counts(names)
    with torch.no_grad(), plain_field_kernels():
        for dtype, packed in packs.items():
            ref = render_rays_fused(packed, rays, cfg)
            check_outputs([outs[dtype], ref], f"8 x 1024 {dtype} render", rays.shape[0])
            for k, v in ref.items():
                d = (outs[dtype][k] - v).abs() / max(1.0, float(v.abs().max()))
                errs[f"{dtype} {k}"] = (float(d.median()), percentile(d, 0.99))
    print(f"[30/30] an 8 x 1024 field pair, {rays.shape[0]} rays through render_rays_fused "
          f"({N_SAMPLES}+{N_IMPORTANCE}) on its bf16 and int8 packs in {secs} s ({card}); "
          f"launches {counts}; vs the plain versions' render on the card, (median, 99th pct) "
          f"of |d| / scale {errs} (bars {FAST_BARS})", flush=True)
    if min(counts.values()) < 1:
        fail("the 8 x 1024 field's renders did not run on the wide kernels")
    if any(m >= FAST_BARS[0] or p >= FAST_BARS[1] for m, p in errs.values()):
        fail("the 8 x 1024 field's renders disagree with their plain re-renders")
    return counts


def dp_caps_phase(pool_rays, pool_rgbs, device, card):
    """Phase 30(d): on a one-rank NCCL group, ACCUM_STEPS `train_step_accum`
    steps (n_micro 2, `fused` backend, perturb 1, noise 1) and one group of
    IMPORTANCE_STEPS `train_scan_importance` steps (a CUDA graph, its
    all-gather of the rays' errors captured with the all-reduce), each
    data-parallel against non-distributed from the same weights, seed and
    rays: every parameter, loss and (importance) the error buffer bit for
    bit. The group's K2 launches are its capture's."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel

    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        dp = DataParallel()
        gen = torch.Generator(device=device).manual_seed(SEED + 82)
        steps_per_epoch = pool_rays.shape[0] // TRAIN_RAYS
        batches = []
        for _ in range(ACCUM_STEPS):
            idx = torch.randint(0, pool_rays.shape[0], (2 * TRAIN_RAYS,), generator=gen,
                                device=device)
            batches.append({"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]})
        base = numpy_models(SEED + 83, device)
        runs = {}
        for mode in ("plain", "dp"):
            system = train_system("fused", 1.0, 1.0, steps_per_epoch, device,
                                  data_parallel=dp if mode == "dp" else None)
            state = state_copy(system, base)
            losses = []
            for b in batches:
                state, m = system.train_step_accum(state, b, seed=SEED + 84, n_micro=2)
                losses.append(torch.stack([m["train/loss"], m["train/psnr"]]))
            gstate = state_copy(system, base)
            refused = None
            try:
                t0 = time.perf_counter()
                gstate, _ = system.train_scan_importance(
                    gstate, pool_rays, pool_rgbs, seed=SEED + 85, n_steps=IMPORTANCE_STEPS,
                    batch_size=TRAIN_RAYS, alpha=1.0, uniform_frac=0.2)
                torch.cuda.synchronize()
                group_s = time.perf_counter() - t0
            except RuntimeError as e:
                if mode != "dp" or "refused" not in str(e):
                    raise
                refused, group_s = str(e), float("nan")
            group = system.last_group
            runs[mode] = (state, torch.stack(losses), gstate, refused,
                          None if refused else group.steps.clone(),
                          None if refused else group.buf.clone(), group_s,
                          None if refused else group.graph is not None)
        torch.cuda.synchronize()
        plain, par = runs["plain"], runs["dp"]
        a_diff, a_loss = n_unequal(plain[0], par[0]), torch.equal(plain[1], par[1])
        refused = par[3]
        g_diff = None if refused else n_unequal(plain[2], par[2])
        g_loss = None if refused else torch.equal(plain[4], par[4])
        g_buf = None if refused else torch.equal(plain[5], par[5])
        touched = None if refused else int((par[5] != 1.0).sum())
        print(f"[30/30] data parallel on a one-rank NCCL group: {ACCUM_STEPS} train_step_accum "
              f"steps (n_micro 2, {2 * TRAIN_RAYS} rays, fused) vs non-distributed: {a_diff} "
              f"tensors differ, loss and PSNR bit-equal {a_loss}; one train_scan_importance "
              f"group of {IMPORTANCE_STEPS} steps on a CUDA graph "
              + (f"REFUSED: {refused}" if refused else
                 f"(captured: {par[7]}; the all-gather of its errors inside it): {g_diff} "
                 f"tensors differ, losses bit-equal {g_loss}, error buffers bit-equal {g_buf} "
                 f"({touched} of {pool_rays.shape[0]} rays written); first group with its "
                 f"capture {par[6]:.3f} s (non-distributed {plain[6]:.3f})")
              + f"; {card}", flush=True)
        if a_diff or not a_loss or refused or g_diff or not g_loss or not g_buf or not par[7]:
            fail("data-parallel accumulated or importance steps are not bit-equal to the "
                 "non-distributed ones, or the importance group was refused")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def huge_candidates(ball_ckpt, device, card):
    """Phase 30(e): K3 and K6 above MAX_CANDIDATES (their rows of scores in a
    device scratch): the eval CLI's auto-cull frame at `--fast_prepass
    CLI_HUGE_C` and fast frame at `--fast_candidates CLI_HUGE_C` on a
    CLI_WH² frame of the ball field, each against the same renderer on the
    plain versions (FAST_BARS); then K3 opacity and select and K6 at C
    HUGE_C over HUGE_RAYS of its rays, the plain march and selection on
    each kernel's own scores bit for bit (K6's kept sets and their order),
    each timed beside its plain version and bound. Returns (launches of the
    CLI frames and of K6's pass, readings)."""
    from pathlib import Path

    import torch
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import get_opts, make_renderer, setup_fast_proxy
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    if HUGE_C <= k3.MAX_CANDIDATES or CLI_HUGE_C <= k3.MAX_CANDIDATES:
        fail("phase 30(e)'s candidate counts must lie above MAX_CANDIDATES")
    models = numpy_models(FIELD_SEED, device, ball_nerf_params)
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    bounds = np.array([NEAR, FAR], np.float32)
    frame = lego_rays(1, device, h=CLI_WH, w=CLI_WH)
    launches, readings = {}, {}
    for label, name, extra in (
            ("auto-cull frame", "proxy_opacity_scratch",
             ("--fast_cull", "auto", "--fast_prepass", str(CLI_HUGE_C))),
            ("fast frame", "proxy_march_select_scratch",
             ("--fast_candidates", str(CLI_HUGE_C)))):
        hp = get_opts(["--root_dir", str(Path(ball_ckpt).parent), "--ckpt_path", ball_ckpt,
                       "--renderer", "fast", "--chunk", str(CHUNK), *extra])
        fast = setup_fast_proxy(models, hp, bounds)   # phase 7's cached proxy

        def renderer():   # a fresh one: an auto-cull renderer's first frame runs the prepass
            return make_renderer(models, cfg, renderer="fast", fast=fast, hparams=hp,
                                 img_hw=(CLI_WH, CLI_WH))

        reset_counts([name])
        (out,), (sec,) = render_frames(renderer(), [frame])
        launches[name] = read_counts([name])[name]
        with plain_fast_kernels():
            (ref,), (ref_sec,) = render_frames(renderer(), [frame])
        check_outputs([out, ref], label, CLI_WH * CLI_WH)
        errs = frame_errors(out, ref)
        print(f"[30/30] CLI {label} at {' '.join(extra)}, {CLI_WH}² ({card}): {sec:.4f} s (on "
              f"the plain versions {ref_sec:.3f} s); {name} launches {launches[name]}; "
              f"(median, 99th pct) of |d| / scale vs the plain versions {errs} (bars "
              f"{FAST_BARS})", flush=True)
        if launches[name] < 1 or any(m >= FAST_BARS[0] or p >= FAST_BARS[1]
                                     for m, p in errs.values()):
            fail(f"the CLI's {label} at C {CLI_HUGE_C} did not run on K3's scratch path or "
                 f"left its plain version")
    pp = fast.packed_proxy
    rays8 = clipped_rays(lego_rays(1, device), fast.aabb)
    rays = rays8[torch.as_tensor(np.random.default_rng(SEED + 86).permutation(
        rays8.shape[0])[:HUGE_RAYS], device=device)].contiguous()
    k3_bytes = sum(t.numel() * t.element_size() for t in pp.values())
    flop = proxy_flop_per_candidate(pp)
    r, c = rays.shape[0], HUGE_C
    bound_ms, bound_by = bound(r * c * flop, r * (32 + 4) + k3_bytes)

    def plain_run(fn):   # one synced run (the plain march is c launches a step), and its ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    plain_ms = {}
    scores = k3.proxy_march_scores(pp, rays, c)
    op = k3.proxy_opacity(pp, rays, c)
    same_op = torch.equal(op, k3.proxy_opacity_ref(pp, rays, c, scores=scores))
    op_ref, plain_ms["proxy_opacity_scratch"] = plain_run(
        lambda: k3.proxy_opacity_ref(pp, rays, c))
    d_op = float((op - op_ref).abs().max())
    sel = k3.proxy_march_select(pp, rays, c, FAST_K, midpoint=True, return_density=True)
    same_sel = all(torch.equal(a, b) for a, b in zip(sel, k3.proxy_march_select_ref(
        pp, rays, c, FAST_K, midpoint=True, return_density=True, scores=scores)))
    (rz, _), plain_ms["proxy_march_select_scratch"] = plain_run(
        lambda: k3.proxy_march_select_ref(pp, rays, c, FAST_K, midpoint=True))
    dz = (sel[0] - rz).abs() / (rays[:, 7:8] - rays[:, 6:7]).clamp_min(1e-6)
    del scores
    reset_counts(["proxy_select_scratch"])
    z6 = k6.proxy_select(pp, rays, c, K6_K)
    launches["proxy_select_scratch"] = read_counts(["proxy_select_scratch"])[
        "proxy_select_scratch"]
    s6, z6_read = k6.proxy_select_scores(pp, rays, c, K6_K)
    order = k6.select_order(s6, K6_K)
    same6 = (torch.equal(z6, z6_read) and torch.equal(
        z6, k6.proxy_select_ref(pp, rays, c, K6_K, scores=s6))
        and torch.equal(z6, k6.candidate_depths(rays, c).gather(1, order)))
    zc = k6.candidate_depths(rays, c)
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * zc[..., None]
    ref_s, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)
    within = bool(((s6 - ref_s).abs() <= bar).all())
    n_sets, worst = k6.cut_swaps(ref_s, bar, s6, K6_K)
    z6_ref, plain_ms["proxy_select_scratch"] = plain_run(
        lambda: k6.proxy_select_ref(pp, rays, c, K6_K))
    d6 = float((z6 - z6_ref).abs().max())
    del s6, zc, pts, ref_s, bar
    for name, kern, err, ok, what in (
            ("proxy_opacity_scratch", lambda: k3.proxy_opacity(pp, rays, c), d_op, same_op,
             "the plain march on its own scores"),
            ("proxy_march_select_scratch",
             lambda: k3.proxy_march_select(pp, rays, c, FAST_K, midpoint=True),
             float((sel[0] - rz).abs().max()), same_sel,
             "the plain march and inverse CDF on its own scores (depths, survivors, "
             "densities, mass)"),
            ("proxy_select_scratch", lambda: k6.proxy_select(pp, rays, c, K6_K), d6,
             same6 and within,
             "its scores within proxy_score_bar and the plain selection on them (kept sets "
             "and order)")):
        ms = cuda_ms(kern, 3)
        p_ms = plain_ms[name]
        extra = (f"; depth |d|/(far-near) median {float(dz.median()):.3e}, 99th pct "
                 f"{percentile(dz, 0.99):.3e} (bars {DEPTH_BARS})"
                 if name == "proxy_march_select_scratch" else
                 f"; {n_sets} rays keep another set than the plain scores', worst swap / bars "
                 f"{worst:.3e}" if name == "proxy_select_scratch" else "")
        print(f"[30/30] {name} at {r} rays, C {c} ({k3.shared_bytes(pp['w1'].shape[0], c)} "
              f"bytes of shared memory a CTA, a row of {c | 1} floats of device scratch): {what} "
              f"{'bit-equal' if ok else 'DIFFERENT'}; max|d| vs plain {err:.3e}{extra}; kernel "
              f"{ms:.3f} ms, plain {p_ms:.1f} ms (one run); bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.2f}% of it; {card}", flush=True)
        if not ok:
            fail(f"{name} at C {c} disagrees with its plain version")
        readings[name] = {f"candidates_{c}": {
            "candidates": c, "rays": r, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}}
    if not (float(dz.median()) < DEPTH_BARS[0] and percentile(dz, 0.99) < DEPTH_BARS[1]
            and worst <= 1.0):
        fail(f"K3 select or K6 at C {c} leave their plain versions' bars")
    return launches, readings


def last_caps_phase(pool_rays, pool_rgbs, ball_ckpt, device, card):
    """Phase 30. Returns ({kernel: {path: launches}}, {kernel: readings})."""
    import torch

    t0 = time.perf_counter()
    readings = {name: {"shapes": r} for name, r in wide_field_readings(device, card).items()}
    launches = {name: {"8 x 1024 field, render_rays_fused (phase 30)": n}
                for name, n in wide_render(device, card).items()}
    torch.cuda.empty_cache()
    dp_caps_phase(pool_rays, pool_rgbs, device, card)
    torch.cuda.empty_cache()
    huge_launches, huge = huge_candidates(ball_ckpt, device, card)
    for name, n in huge_launches.items():
        launches[name] = {f"C above MAX_CANDIDATES (phase 30)": n}
    for name, reading in huge.items():
        readings.setdefault(name, {}).update(reading)
    torch.cuda.empty_cache()
    print(f"[30/30] phase 30 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, readings


def main():
    import os

    # cuBLAS's deterministic workspace, which phase 21's check under
    # torch.use_deterministic_algorithms needs; set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one more exact frame, training step, fast frame, "
                             "int8 fast and exact frame, EG3D frame of 128² and 800², "
                             "SIREN, d3 and EG3D training step, d3 fast frame and "
                             "phase 28(f)'s render_view in bf16 and float32")
    args = parser.parse_args()

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on the card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[1/28] device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import make_renderer
    from nerf_siren_tpu_torch.ops.kernels import _build
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    # ---- 2. build: one nvcc per source, all at once --------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    print(f"[2/28] built {', '.join(f'csrc/{n}.cu' for n in SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. K1 vs plain ------------------------------------------------------
    models = numpy_models(SEED, device)
    packed = fm.pack_model_params(models)
    results = check_kernels(packed["fine"], device, smi)
    torch.cuda.empty_cache()

    # ---- 4. eval path: 3 frames through the eval renderer --------------------
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    render = make_renderer(models, cfg, renderer="fused")
    frames_rays = [lego_rays(k, device) for k in range(N_FRAMES)]
    torch.cuda.synchronize()
    k1_names = ["fused_nerf_sigma", "fused_nerf_full"]
    reset_counts(k1_names)
    outs, lat = [], []
    with torch.no_grad():
        for rays in frames_rays:
            t0 = time.perf_counter()
            outs.append(render(rays))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    launches = read_counts(k1_names)
    n_chunks = -(-H * W // CHUNK)
    print(f"[4/28] rendered {N_FRAMES} frames of {H}x{W} at {N_SAMPLES}+{N_IMPORTANCE} "
          f"samples: latency s {[round(t, 4) for t in lat]}, "
          f"{H * W / np.median(lat):.0f} rays/s at the median frame ({kind}, {smi}); "
          f"launches {launches}", flush=True)
    for name in k1_names:
        if launches[name] < n_chunks * N_FRAMES:
            fail(f"{name} launched {launches[name]} times, expected >= {n_chunks * N_FRAMES}")
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != H * W or not torch.isfinite(v).all():
                fail(f"{k}: shape {tuple(v.shape)} or non-finite values")
        rgb = out["rgb_fine"]
        if rgb.min() < 0 or rgb.max() > 1 + 1e-3:
            fail(f"rgb_fine outside [0, 1+1e-3]: {float(rgb.min())}..{float(rgb.max())}")
    print(f"[4/28] outputs finite; opacity_fine mean per frame "
          f"{[round(float(o['opacity_fine'].mean()), 4) for o in outs]}", flush=True)

    # the same rays re-rendered on the CPU, where the wrappers run the plain field
    cpu_packed = fm.pack_model_params({k: copy.deepcopy(m).cpu() for k, m in models.items()},
                                      "cpu")
    with torch.no_grad():
        ref = render_rays_fused(cpu_packed, frames_rays[0][CHECK_RAYS].cpu(), cfg)
    worst = {k: float((outs[0][k][CHECK_RAYS].cpu() - v).abs().max()) for k, v in ref.items()}
    print(f"[4/28] {CHECK_RAYS.stop - CHECK_RAYS.start} rays vs plain-field CPU render: "
          f"max|d| {worst} (atol {RENDER_ATOL})", flush=True)
    if max(worst.values()) > RENDER_ATOL:
        fail("main-path render disagrees with the plain-field render")
    if args.profile:
        with torch.no_grad():
            profile("eval frame", lambda: render(frames_rays[1]), smi)

    # ---- 5. K2 vs plain at the training shapes -------------------------------
    results.update(check_train_kernels(models["fine"], frames_rays[0], device, smi))
    torch.cuda.empty_cache()

    # ---- 6. training path: the teacher's frames are the targets ---------------
    pool_rays = torch.cat(frames_rays)
    pool_rgbs = torch.cat([o["rgb_fine"] for o in outs])
    del outs
    train_launches, step_ms, (system, state, last), group = train_phase(pool_rays, pool_rgbs,
                                                                        device, smi)
    launches.update(fused_train_fwd=train_launches["fwd"], fused_train_bwd=train_launches["bwd"])
    if args.profile:
        profile("train step", lambda: system.train_step(state, last, seed=SEED + 1), smi)
        g_system, g_state, g_batches = group
        profile(f"grouped train steps ({GROUP_STEPS} steps, one graph)",
                lambda: g_system.train_scan_batches(g_state, *g_batches, seed=SEED + 2), smi)
        del g_system, g_state, g_batches

    student = {k: copy.deepcopy(m) for k, m in state.models.items()}   # phase 23's start
    # phase 28's start: (b)'s trained fields and their full-resume checkpoint
    from nerf_siren_tpu_torch.training.checkpoints import save_train_state
    full_ckpt = os.path.join("ckpts", "chip_smoke", "trained_full.msgpack")
    save_train_state(full_ckpt, state, epoch=0, optimizer=system.train_cfg.optimizer)
    trained = {k: {n: t.detach().cpu().clone() for n, t in m.state_dict().items()}
               for k, m in state.models.items()}
    del system, state, last, group
    torch.cuda.empty_cache()

    # ---- 7-13. the fast renderer's path ---------------------------------------
    fast_results, fast_launches, ball = fast_phases(frames_rays, device, smi, args)
    results.update(fast_results)
    launches.update(fast_launches)
    del frames_rays
    torch.cuda.empty_cache()

    # ---- 14-17. EG3D exact eval on K5 ---------------------------------------------
    results["triplane_gather"], launches["triplane_gather"], eg3d_targets = eg3d_phases(
        device, smi, args)
    torch.cuda.empty_cache()

    # ---- 18-20. the SIREN field and the semantic stack ------------------------------
    siren_phase(device, smi, args)
    d3_steps_phase(device, smi, args)
    torch.cuda.empty_cache()
    d3_frames_phase(device, smi, args)
    torch.cuda.empty_cache()

    # ---- 21-22. EG3D training and the fast EG3D renderer ------------------------------
    eg3d_steps_phase(device, smi, args, eg3d_targets)
    del eg3d_targets
    torch.cuda.empty_cache()
    eg3d_fast_phase(device, smi, args)
    torch.cuda.empty_cache()

    # ---- 23. culled training on K2 ------------------------------------------------------
    culled_results, culled_launches = culled_phase(pool_rays, pool_rgbs, student, device, smi)
    del student
    torch.cuda.empty_cache()

    # ---- 26. data-parallel training on a one-rank NCCL group ------------------------
    dp_launches = data_parallel_phase(pool_rays, pool_rgbs, device, smi)
    torch.cuda.empty_cache()
    for name, key in (("fused_train_fwd", "fwd"), ("fused_train_bwd", "bwd")):
        results[name]["launches_by_path"] = {"fused (phase 6)": launches[name],
                                             "culled_fused (phase 23)": culled_launches[key],
                                             "data parallel (phase 26)": dp_launches[key]}
        results[name]["culled_shape"] = culled_results[name]
        launches[name] += culled_launches[key] + dp_launches[key]

    # ---- 24-25. mesh extraction ------------------------------------------------------------
    ball_grid = nerf_mesh_phase(ball, device, smi)
    ball_ckpt = ball[0]
    del ball
    torch.cuda.empty_cache()
    eg3d_mesh_phase(device, smi)
    torch.cuda.empty_cache()

    # ---- 27. sharded rendering on two slabs of the card ------------------------------
    mesh_launches = sharded_render_phase(ball_ckpt, device, smi)
    for path, counts in mesh_launches.items():
        for name, n in counts.items():
            by = results[name].setdefault("launches_by_path",
                                          {MAIN_PATH[name]: launches[name]})
            by[f"{path}, two slabs (phase 27)"] = n
            launches[name] += n
    torch.cuda.empty_cache()

    # ---- 28. tools and examples on the card ---------------------------------------------
    native_rays_check(smi)
    trip_launches = round_trips(trained, full_ckpt, device, smi)
    parity_launches = parity_phase(device, smi)
    examples_phase(ball_ckpt, ball_grid, device, smi, args)
    del ball_grid
    for name in k1_names:
        by = results[name]["launches_by_path"]
        by["weights round trips (phase 28)"] = trip_launches[name]
        by["psnr_parity (phase 28)"] = parity_launches[name]
        launches[name] += trip_launches[name] + parity_launches[name]

    # ---- 29. the last narrowings: K1 / K4 widths, K3 / K6 above 256 candidates ---------------
    narrow_launches, narrow = narrowings_phase(ball_ckpt, device, smi)
    for name, by_path in narrow_launches.items():
        by = results[name].setdefault("launches_by_path",
                                      {MAIN_PATH.get(name, "phases 4-28"): launches[name]})
        by.update(by_path)
        launches[name] += sum(by_path.values())
    for name, reading in narrow.items():
        results[name].update(reading)

    # ---- 30. the last caps: K1 / K4 at any width and depth, K3 / K6 at any C, and
    # accumulated and importance steps under data parallelism ---------------------------
    cap_launches, caps = last_caps_phase(pool_rays, pool_rgbs, ball_ckpt, device, smi)
    del pool_rays, pool_rgbs
    for name, by_path in cap_launches.items():
        results.setdefault(name, {})["launches_by_path"] = by_path
        launches[name] = sum(by_path.values())
    for name, reading in caps.items():
        if name in launches and name.endswith(("_wide", "_scratch")):   # the kernel's headline
            shapes = reading.get("shapes", reading)
            head = shapes.get("width 1024, depth 8", shapes.get(f"candidates_{HUGE_C}"))
            results[name].update(head)
        results.setdefault(name, {}).update(reading)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nerf_siren_tpu_torch/csrc/{SOURCE_OF.get(name, src)}.cu",
         "replaces": replaces, "launches": launches[name], "timing": "unqueued",
         **results[name]}
        for name, (src, _, replaces) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
