#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mitsuba_customization_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises (non-zero exit):
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA kernels from csrc/ (seconds printed);
  3. K1 (MERL trilinear eval) against its plain PyTorch version on the card
     at 4,194,304 lanes, as two halves that share wi and the slot (the
     main path's call): flagship table, 3-material stack, lane masks;
  4. K2 (conditional-CDF inversion) against its plain version at 2,097,152
     lanes with the flagship's conditional CDFs, int64 indices, a strided
     u column (u at 0 and 1 - 1e-7 too) and a bool mask, as the main path
     hands them: the sampled cell equal on every lane, the values within
     tolerance, and the lanes not bit-equal counted;
  5. the flagship frame (512x512, 64 spp, depth 4) through load_dict ->
     render: one warm-up, one timed render; launch counters > 0, finite;
  6. the entry-size frame (64x64, 4 spp, depth 4) on the card and on the
     CPU (plain kernels): per-channel means within 2 %;
  7. K3 (cluster closest hit) against its plain version on the matpreview
     camera wavefront, 2,097,152 lanes (a 262,144-lane slice if the plain
     version takes over 30 s): hit/miss equal, prims equal on >= 99.9 % of
     hits, and t, u, v and fields bit-equal where they agree;
  8. K4 (cluster any hit) against its plain version on NEE shadow rays from
     those hits toward the area light, maxt = 0 on a quarter of the lanes:
     equal;
  9. the matpreview frame (512x512, 8 spp, depth 8, 20,484 prims, 10 MERL
     materials, area light) through load_dict -> probe_compact_schedule ->
     render: one warm-up, one timed render; K1-K4 launched, finite;
 10. per-bounce wavefronts: one more render of the matpreview frame with
     recording wrappers on that Scene's ray_intersect / ray_test and on the
     K1 / K2 module functions keeps the inputs of every K1-K4 call; each
     recorded call is checked against its plain version (K3: hit/miss, t,
     prim, u, v and fields; K4: occlusion on every lane; K1, K2 as in
     phases 3-4) and timed, one line per bounce (lanes, live lanes, kernel
     ms and bound ms of each kernel; K2's lanes not bit-equal); then one
     more render with a recording wrapper on models/bsdf.bounce_shade
     keeps every call's inputs (phase_bsdf_stage): on each, every present
     kernel must take the fused route (bsdf_shade_pre, K2, bsdf_shade_post,
     K1: one launch of each new kernel), which is held to the plain route
     (_bounce_shade_plain) on the same tensors (is_delta and each output's
     zero pattern equal, values within BSDF_RTOL on all but BSDF_RARE of
     the lanes, BSDF_REL_L1 summed) and timed against it, one line per
     bounce (lanes, the two kernels' device ms and bound ms, both routes'
     call ms and device ms and ops); the recorded calls must number the
     frame's bsdf_shade_pre launches; then one more render with recording
     wrappers on render/emitters' hit_term, sample_nee and nee_term
     (phase_emitter_stage): on each call, which must take the fused route
     (one launch of emitter_hit, emitter_sample or emitter_nee), the
     kernel's outputs are held to the plain route's same quantities
     (masks, zero and infinity patterns equal, values within the BSDF_*
     tolerances), an independent sampler's draws in the kernel to its
     next_1d's bit for bit, and the call is timed on both routes, one line
     per call (the kernel's device ms and bound ms, both routes' call ms
     and device ms and ops); the recorded calls must number the frame's
     launches of each kernel;
 11. the matpreview frame at 64x64, 4 spp, depth 4 with that schedule, on
     the card and on the CPU (plain kernels): per-channel means within 2 %;
 12. K1's backward (scatter-add of K1's cotangent into the table's
     gradient) against K1 and its plain version at 4,194,304 lanes as two
     halves, on the flagship table and the matpreview's 10-material stack,
     lane masks and a seeded cotangent, without and with K1's output for
     its clamp test: the linearity identity <K1-bwd(g), d> = <g, K1(d)>
     within K1_BWD_ID_RTOL, and the relative L2 error against the plain
     version within K1_BWD_L2_RTOL; timed as the main path calls it, and
     torch's index_add_ of the same updates as a yardstick;
 13. one AD step (grad_render's eager step, render/ad._eager_loss_and_grad,
     whose kernel calls the wrappers count; MSE against a zero image) of the
     matpreview scene at 256x256, 4 spp, depth 6 with the probed schedule,
     gradients of the 10-table stack and the floor's alpha: one warm-up,
     one timed step (seconds, loss, nonzero share of table-gradient bins,
     alpha gradients, peak memory, launches of K1-K4 and K1-bwd, table-
     gradient buffers); finite, table gradient nonzero, K1-bwd launched,
     one buffer; one more step records every K1-bwd call, each checked as
     in phase 12 and timed into one buffer, and holds the step's table
     gradient to the sum of the calls' own gradients;
 14. the AD step (grad_render: captured on the card) at 64x64, 4 spp,
     depth 3 on the card and on the CPU
     (plain kernels): losses within 2 %, table gradients at cosine >= 0.98,
     alpha gradients within 5 %; then, on the card, the floor alpha's
     gradient by AD against a central difference of the same render
     (64 spp, loss linear in the image): the means over 10 seeds within
     5 % or 4 standard errors;
 15. compaction under AD at 256x256, 16 spp, depth 6: table gradients with
     the probed schedule against compaction off, their correlation and
     per-material sums, which agree within 10 % (or, for a material, 3x
     the spread of its sums over two seeds without compaction, if larger);
 16. five Adam steps of render/ad.optimize on the phase 13 scene (target
     the scene at 16 spp, alpha starting at 0.4), on the table and floor
     alpha, then on the alpha alone, each through grad_render's captured
     step (as optimize runs) and through its eager step: each step's
     seconds, loss and alpha, the median of steps 1-4 of each; finite
     throughout, the table >= 0, the first step's loss equal;
 17. BASELINE configs[0]: a sphere with the flagship MERL table under a
     constant emitter, the `direct` integrator, 512x512, 64 spp (eight
     passes of 2,097,152 lanes): seconds, rays/s, K1 and K2 launched;
     card against CPU means at 64x64;
 18. the materials frame: matpreview_dict(512, 8, 8, n_materials=12) with
     material_bands (merl, conductor, dielectric, thindielectric,
     roughdielectric, plastic, roughplastic, principled, twosided merl; a
     Beckmann floor) and the probed schedule: seconds, rays/s, K1-K4
     launched; every K1-K4 call of one more render recorded, checked
     against its plain version and timed (as phase 10); card against CPU
     means at 64x64;
 19. the blend frame: the materials scene at 256x256, 4 spp, depth 6 with
     null, mask and blendbsdf bands: K1 launched with one half, as often
     as the JAX package's sample / eval / pdf composition calls it (5 a
     shading bounce), K2 not at all, K4 on the shadow cluster set (null
     prims degenerate); every recorded call checked and timed; one eager
     AD step of its table stack (one table-gradient buffer, K1-bwd
     launched) and, at 64x64, card against CPU losses within 2 % and
     table gradients at cosine >= 0.98;
 20. the image frame: matpreview_dict(512, 8, 8, n_materials=12) with
     image_bands (spherical uvs; bands 0-5 MERL, 6 a diffuse textured by a
     2048x2048 EXR bitmap, 7 a checkerboard, 8 a mesh_attribute on vertex
     colors, 9 a normalmap (1024x1024 EXR) over MERL, 10 a bumpmap (1024x1024
     PFM, scale 0.02) over roughplastic, 11 a 64^3 RGB volume texture), a
     2048x1024 EXR envmap (a sky with a sun ~1e3 brighter, rotated) beside
     the area light and a spot, every image made from a seed with numpy
     and read back through utils/io.read_image (no PNG: no Pillow needed),
     the probed schedule: seconds, rays/s, K1-K4 launched; every K1-K4
     call of one more render recorded, checked against its plain version
     and timed (the envmap's shadow rays run with maxt = _SHADOW_INF);
     card against CPU means at 64x64;
 21. the emitters frame (emitters_dict: point, spot, directional, a
     directionalarea rectangle and a projector of an 8x8 two-colour image
     over a diffuse floor and a MERL sphere) at 512x512, 16 spp, depth 4:
     seconds, K1 and K2 launched; card against CPU means at 64x64; the
     JAX tests' expectations as numbers on the card (the point light's
     inverse square, the directionalarea footprint, the projector's
     left-red / right-blue pattern);
 22. one eager AD step of the image frame at 256x256, 4 spp, depth 6
     with its probed schedule, on the table stack, the texture images and
     the envmap's image: one warm-up, one timed step (seconds, peak memory,
     one table-gradient buffer, K1-bwd launched, the nonzero share of each
     gradient); at 64x64 card against CPU losses within 2 % and each
     gradient at cosine >= 0.98;
 23. the camera frame (scenes.camera_dict: the matpreview scene through a
     thin lens of aperture 0.05 focused on the blob, the multijitter
     sampler, the gaussian filter; 512x512, 8 spp, depth 8, 2,097,152
     lanes in one pass, the probed schedule): seconds, rays/s, K1-K4
     launched; every K1-K4 call of one more render recorded, checked and
     timed (as phase 10); card against CPU means at 64x64; one eager AD
     step of its table stack at 256x256, 4 spp, depth 6 (one
     buffer, K1-bwd launched, seconds, peak memory) and at 64x64 card
     against CPU losses within 2 % and gradients at cosine >= 0.98;
 24. the shapes frame (scenes.shapes_dict on the meshes scenes.shape_files
     writes from a seed under build/chip_smoke_shapes: a 327,680-triangle
     binary PLY, an 81,920-triangle OBJ, a serialized pair, a shapegroup
     instanced 4 times, a cube, a disk, three cylinders and a sphere,
     about 532,500 prims; 512x512, 8 spp, depth 8, the probed schedule):
     file, load and frame seconds, rays/s, K1-K4 launched; every K3 / K4
     call of one more render checked against its plain version on its
     first 262,144 lanes, sphere and cylinder hits among them, and
     timed; card against CPU means at
     64x64; the same frame with a 128^3 SDF sphere in place of the PLY
     blob (seconds, S1's launches and the march's steps, no host check;
     every S1 call of one more render against march_plain: the hit flag
     and steps on >= 99.9 % of lanes, t within 1e-4 where they agree, the
     lanes not bit-equal printed; each timed beside its bound from its
     own steps; card against CPU at 64x64) and the JAX SDF test's
     expectation (SDF sphere against analytic sphere) on the card;
 25. at 64x64 card against CPU means within 2 %: each of the six samplers
     (orthogonal at 9 spp), each of the five splat filters, and the
     orthographic, distant and a two-child batch sensor; the JAX tests'
     expectations on the card: radiancemeter 0.5 within 5 %,
     irradiancemeter pi within 2 %, batch strips against two half-width
     renders within 0.05;
 26. the volpath frame (scenes.volpath_dict: the matpreview scene under
     the volumetric tracer with the production scene's homogeneous fog
     ball and a null cube of a heterogeneous medium whose density is a
     seeded 256^3 float32 grid; 512x512, 8 spp, depth 8, one 2,097,152-
     lane pass, no compaction): load and frame seconds, rays/s, K1-K4, T1
     and T2 launched, each tracking loop's tracked lanes and steps (read
     from T1 / T2's step counts after the frame) and host checks (0);
     every K1-K4 call of one more render recorded, checked against its
     plain version and timed (K3 twice a bounce: the shadow ray's first
     boundary); every T1 / T2 call of one more checked against its plain
     version (flags and steps on >= 99.9 % of lanes, values within rtol
     1e-4, atol 1e-6 where they agree, the lanes not bit-equal printed)
     and timed beside its bound (each lane's ray read once, the grid
     cells the lookups read, operations from the kernel's step counts),
     and at ad_mode's 48 steps against medium._scan, bit for bit on every
     lane; T1-bwd / T2-bwd on the T1 / T2 call of the most lane steps
     (2,097,152 lanes, seeded cotangents) against track_bwd_plain and
     autograd through _scan (every gradient within relative L2 1e-4),
     timed beside the plain version, its bound (the replayed steps' bytes
     and operations, the atomic adds' bytes) and an index_add_ of the
     same grid updates; card against CPU means at 64x64; the JAX tests'
     Beer-Lambert and emissive-medium expectations on the card;
 27. one eager AD step (ad._eager_loss_and_grad, the captured step's
     eager counterpart) of the volpath scene at 256x256, 4 spp, depth 6 on
     the table stack and medium.sigma_t, albedo, phase_g and density:
     seconds, peak memory, K1-bwd, T1 / T2 and T1-bwd / T2-bwd launched,
     one table-gradient buffer and one grid-sized gradient buffer, the
     tracking loops' steps with no host check; one step at 512x512, 8
     spp, depth 6 (its peak memory); at 64x64 card
     against CPU losses within 2 % and each
     gradient at cosine >= 0.98; the homogeneous extinction's gradient
     against a central difference on the JAX test's absorbing fog ball
     (means over 10 seeds within 5 % or 4 standard errors);
 28. ptracer on the matpreview scene without its sky and bdpt on the whole
     of it (512x512, 8 spp, depth 8): seconds, rays/s, launches; every
     K1-K4 call recorded, checked on its first 262,144 lanes and timed;
     the light pass's splat of every row timed beside the splat of its
     nonzero rows alone; card against CPU means at 64x64; on the card the
     JAX tests' comparisons with the path tracer (means within 5 % / 7 %,
     normalised cross-correlation > 0.95);
 29. the matpreview scene written as a Mitsuba XML file under
     build/chip_smoke_xml (binary PLY bands, MERL .binary tables,
     <default>s for spp, res and depth) rendered by cli.main in this
     process at 512x512, 8 spp, depth 8 (-o frame.npy, --seed 1): the
     CLI's load and render seconds, K1-K4 launched; the written image
     equal bit for bit to render(load_file(xml), 8, 1) (timed: seconds,
     rays/s), and its means within 2 % of the dict scene's (the largest
     pixel difference printed);
 30. chi-square tests on the card (utils/chi2, the JAX suite's harness and
     settings): bounce_shade's sampled directions (K2, K1) on the
     flagship table against tabulated.pdf, and the GGX roughconductor at
     alpha 0.1; p-values printed, both pass;
 31. parallel/mesh on a process group of one rank over NCCL: render_sharded
     of the matpreview frame against render (equal bit for bit, means
     within 2 %, largest pixel difference printed; seconds, launches),
     render_sharded_jit against render_sharded (bit for bit at two seeds), and loss_and_grad_sharded
     of phase 13's setup against ad.grad_render (losses within 1e-5
     relative, gradient cosines >= 0.9999, K1-bwd launched into one
     table-gradient buffer). A check of the exchange between ranks needs
     more than one card (tests/test_torch_parallel.py holds it over gloo);
 32. the big shapes scene: scenes.shapes_dict on the files
     scenes.shape_files(n_sub=(8, 6, 5)) writes from seed SHAPES_SEED under
     build/chip_smoke_big_shapes (a 1,310,720-triangle binary PLY, the OBJ,
     the serialized pair, the instanced group and the analytic prims:
     about 1.52M prims, past clusters.MAX_PRIMS) through load_dict ->
     probe_compact_schedule -> render at 512x512, 8 spp, depth 8: file,
     load and bvh.build seconds, peak device memory and host RSS, the
     capacity warning, intersector "bvh"; frame seconds and rays/s after
     one warm-up, launches (K1, K2, B1, B2 launched, K3 and K4 not); B1 on
     the camera wavefront (2,097,152 rays) and B2 on NEE shadow rays from
     its hits against their plain walks and timed (kernel, plain walk,
     bound from render/bvh.walk_work); every B1 / B2 call of one more
     render recorded and checked on its first 262,144 lanes (B1: hit/miss
     equal, prims equal on >= 99.9 % of hits, t, u, v bit-equal where
     they agree, the lanes not bit-equal printed; B2: equal) and timed on
     those lanes and on all; card against CPU means at 64x64, 4 spp,
     depth 3 (the CPU walks 1.52M prims lock-step);
 33. the captured frames (render/integrator.render_jit, a CUDA graph of the
     whole frame replayed with the seed in a buffer) of the flagship frame
     (phase 5's scene: K1, K2), the matpreview frame (phase 9's scene and
     schedule: K1-K4), the big shapes frame (phase 32's scene: K1, K2,
     B1, B2) and the matpreview scene under the orthogonal sampler at
     256x256, 9 spp, depth 4 (its own probed schedule; Kensler's walk over a range
     of 3, every round in the graph): each replay equal bit for bit to render at
     seeds 1 and 2; a replay's launches of every kernel, counted by name
     in its trace (a replay calls no wrapper), equal to a traced render's
     and to the wrappers' counts in a render (and > 0); the first call's
     and the capture's seconds, the graph's nodes (libcuda's
     cuGraphGetNodes) and the device memory the frame keeps (reserved
     after its first call against before); the replay and render timed
     in JIT_TURNS turns (medians, spread); one profiled replay and render
     (device seconds, kernels, busy share); the same for the frames whose
     loops run to a condition per lane: phase 26's volpath frame (T1 /
     T2), its scene under the path integrator at 256x256, phase 24's SDF
     frame (S1), bit for bit, and phase 28's ptracer and bdpt frames,
     whose camera connections splat with atomic adds, in means within 2 %;
     the camera frame (512x512, 8
     spp, depth JIT_CUT_DEPTH (4), probed schedule) through render_jit,
     its means within 2 % of render's (a gaussian splat adds atomically:
     not bit-equal); the orthogonal and camera frames run at that depth,
     and the blend AD step of phase 34 at depth
     JIT_STEP_DEPTH (3), to keep the script inside its time limit;
 34. the captured AD steps (render/ad._loss_and_grad behind grad_render:
     one CUDA graph of the forward, the checkpointed bounces' replay and
     K1-bwd, replayed with the seed, parameters and target copied into its
     buffers) of phase 13's matpreview setup (on the clusters, and switched
     to the BVH: B1 / B2), the blend (at depth 3), image and camera AD
     scenes of phases 19, 22 and 23, phase 27's volpath step (T1 / T2 at
     48 steps and T1-bwd / T2-bwd in the graph) and phase 24's SDF
     scene at 256x256, depth 6 (S1 in the forward and the replay): each
     replay against JIT_TURNS (5) eager
     steps at one seed (the loss equal bit for bit under the box filter,
     within three times the eager losses' largest difference under the
     camera's gaussian splat; each gradient's relative L2 error within
     three times their largest); a
     replay's launches of K1-K4, B1 / B2, T1 / T2, S1, K1-bwd and T1-bwd /
     T2-bwd, counted by name in
     its trace, equal to a traced eager step's and the wrappers' counts in
     one (those of the path > 0); the first call's and the capture's
     seconds, the graph's nodes and the device memory the step keeps; the
     replay and the eager step timed in those turns; one profiled replay and
     eager step (device seconds, busy share); on a process group of one
     rank over NCCL, loss_and_grad_sharded_jit of the matpreview (one
     graph) and camera scenes (the split step: forward and backward graphs
     around the eager halo exchange) against grad_render's replay.
Each phase prints its wall seconds (`phase ...` lines and a `phase
seconds` summary). Each phase's counts are set to 0 just before its
render (or AD step) and read just after. It then prints a JSON line describing each kernel
(launches per matpreview frame, for K1's backward per AD step; `ms`,
`plain_ms`, `bound_ms` and `share` (bound over time) of the phase 3, 4, 7,
8 and 12 call; `frame_ms`, `frame_bound_ms` and `frame_share` summed over
the recorded calls of phase 10, for K1's backward of phase 13 with the
step's one buffer zeroing; K1's backward's `library_ms` is the index_add_
yardstick of phase 12, the scatter part only, as its `library_note` says,
to hold against its `ms_into`; the other kernels' null) and, last, the device
JSON line. emitter_hit / emitter_sample / emitter_nee (the emitter stage)
carry phase 10's numbers as the BSDF stage's kernels do, with the frame's
calls' device ms on both routes (`frame_call_device_ms`,
`frame_plain_device_ms`). bsdf_shade_pre / bsdf_shade_post (the BSDF stage) carry phase
10's numbers: `ms` / `device_ms` the profiler's device time of the
kernel on the first recorded call (bounce 0), `bound_ms` its logical
bytes (bsdf_bytes) at 3.35 TB/s, `call_ms` / `plain_ms` the CUDA-event
time of that call on the fused and the plain route, `call_device_ms` /
`plain_device_ms` and `*_device_ops` their device time and operations,
`frame_ms` / `frame_bound_ms` summed over the frame's calls; launches of
the matpreview frame, of phase 13's AD step and of every later phase
and replay (the blend scenes' must be 0: plain route). A kernel's bound is
the larger of the bytes it must move (each input read once, each output
written once) at 3.35 TB/s and the operations it must do at 67 TFLOP/s
float32 (published H100 SXM peaks; the cluster kernels round every step
without FMA, so at most half of that rate is reachable for them). K1's
bytes count a call as the main path makes it: wi and the slot once for
both halves, wo only for live lanes, the masks and output of every lane,
and the table bins of the lanes that evaluate. K2's count the indices and
u of live lanes, the mask and outputs of every lane, and a CDF row a live
lane. K1's backward counts K1's lane inputs, the cotangent of the live
lanes, K1's output and the clamp test's bins as k1_bwd_bound says, and
the dense gradient written once, or, into a given buffer, each bin it
adds to read and written once (an AD step zeroes its one buffer). For K3
and K4 both come from ops/clusters.min_work: the box and slot tests an
exact walk must do, and of the structure only the boxes and slabs some
lane must enter; dead lanes (maxt <= 0) count their maxt and output. No
single PyTorch call computes any of K1-K4, so their `library_ms` is null.
T1 (medium_delta_track), T2 (medium_ratio_track) and S1 (sdf_march),
which replace the JAX package's XLA while_loops (no Pallas kernel),
carry phases 26's and 24's numbers: `ms`, `plain_ms` (one run of the
plain version, host checks and all), `bound_ms` and `max_abs_err` of the
recorded call of the most lane steps, `frame_ms` / `frame_bound_ms`
summed over the frame's recorded calls, launches of the volpath (T1, T2)
and SDF (S1) frames and of the replays. T1-bwd / T2-bwd
(medium_delta_track_bwd, medium_ratio_track_bwd), which replace the XLA
VJP of the JAX scan, carry phase 26's numbers (`ms`, `plain_ms`,
`bound_ms`, `library_ms`: an index_add_ of the same grid updates, the
scatter part only; `call_device_ms`, every device operation of the
call, and `device_ops`, their count in one call's trace; `ad_step_shape`:
the same on every 8th lane, the volpath AD step's 262,144) and the
launches of phase 27's AD step and of the replays of
phase 34. Every kernel's entry carries `device_ms` beside `ms`: the
profiler's device time of the kernel alone (mean of 5 runs, traced in a
child process handed the same call: _device_trace), where `ms` (CUDA
events) holds its wrapper's host time too; T1, T2 and S1 also
`frame_device_ms`, summed over the frame's recorded calls (a trace that
holds no such kernel fails the phase). B1 (bvh_closest) and B2
(bvh_any), which replace the JAX package's XLA while_loop walks (no
Pallas kernel), carry phase 32's numbers: `ms`, `plain_ms` (one run
of the plain walk) and `bound_ms` of the camera wavefront's call (B1)
and its NEE rays (B2), `frame_ms` summed over the
recorded calls on all lanes, and `checked_frame_ms` /
`checked_frame_bound_ms` / `frame_share` over their checked lanes; a
bound counts each lane's maxt and outputs, o and d of live lanes, each
node some lane visited and each prim some lane tested (44 bytes each),
and a box test a visit and a slot test a prim test as K3 counts them.
Every entry also carries `launches_by_phase` (phases 17-33: the blend,
image, camera and volpath AD steps, the shapes frame with and without
the SDF, the volpath, ptracer and bdpt frames, the XML frame through the
CLI, the sharded frame and the sharded AD step, the big shapes frame
(B1 and B2: that frame and its replay only; T1 / T2 the volpath frame,
S1 the SDF frame, and their replays), the replays of phase
33 as `render_jit_<frame>` and those of phase 34 as `grad_jit_<step>`,
counted in each replay's trace; for K1's backward its
AD steps) and, for K1-K4, the recorded calls' sums of phases 18,
19, 20, 23, 24, 26 and 28 (`materials_frame_ms`, `blend_frame_ms`,
`image_frame_ms`, `camera_frame_ms`, `shapes_frame_ms`,
`volpath_frame_ms`, `ptracer_frame_ms`, `bdpt_frame_ms` and their
bounds).
Before it, a `captured frames:` line holds phase 33's numbers by frame
(first call, capture, nodes, pool MB, replay and render medians and
spread, device seconds and busy share of the profiled replay and render),
a `captured AD steps:` line phase 34's by step (the same, and the
gradients' errors and limits) and an `optimize` line phase 16's medians.
Imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-6, 1e-7
# K3: both sides round every product and sum on its own and send ties to
# the lowest (cluster, slot), so t, prim, u, v and fields agree exactly;
# the prim (and t, to rounding) may differ only where the kernel's
# running-best pruning drops a box whose entry rounds above a hit inside it
K3_T_RTOL = 1e-6
K3_PRIM_AGREE = 0.999
PLAIN_SLICE_S = 30.0
# the shapes frame's K3 / K4 calls (15 a frame, 24,640 clusters: the plain
# version takes seconds for each 262,144 lanes) are checked on their first
# PLAIN_SLICE lanes
PLAIN_SLICE = 1 << 18
FRAME_MEAN_RTOL = 0.02
# K1's backward. Against K1 itself, by linearity: <K1-bwd(g), d> equals
# <g, K1(d)> for any table d >= 0 (where K1's clamp passes g), since both
# kernels take each lane's bins and fractions from merl_lane.cuh; the two
# sides differ only by float32 rounding (atomic sums of up to ~1e5 terms a
# bin, K1's own), held within K1_BWD_ID_RTOL of sum |g| K1(d) (measured at
# most 4e-6, every lane in one cell). Against the plain version, in norm:
# the kernels contract into FMAs where torch rounds each step, and a
# fraction an ulp apart moves a sliver of a lane's share between bins
# (near theta_h = 0, where acos and the sqrt warp magnify an ulp of cos,
# much more), so the gradient is held within K1_BWD_L2_RTOL relative L2
# error of the plain one (measured at most 7.0e-4, on an AD step's call)
K1_BWD_ID_RTOL = 1e-4
K1_BWD_L2_RTOL = 5e-3
# the AD slice: what it differentiates, and its gates
AD_KEYS = ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u",
           "bsdf.roughconductor.alpha_v")
AD_LOSS_RTOL, AD_TABLE_COS, AD_ALPHA_RTOL = 0.02, 0.98, 0.05
AD_COMPACT_RTOL = 0.10
# the floor alpha's gradient by AD against a central difference (step
# AD_FD_STEP) of the same render, at phase 16's start, over AD_FD_SEEDS
# seeds: the central difference moves with each sample that crosses an
# edge (about 10 % a seed at 64x64, 64 spp), the AD estimate hardly, so
# the means are compared, within AD_FD_RTOL or 4 standard errors of the
# mean paired difference (|t| > 4 on 9 degrees of freedom: 0.3 %)
AD_FD_RTOL, AD_FD_STEP, AD_FD_ALPHA, AD_FD_SEEDS = 0.05, 0.05, 0.4, 10
OPT_LR = 0.01

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per evaluated lane of K1 (half-vector map with acos/atan2,
# cell indices, 8-corner trilinear over 3 channels) and per live lane of
# K2 (inverting one 64-float row, three cell masses), counted generously:
# both kernels are bound by bytes. K3 and K4 count box and slot tests with
# ops/clusters.min_work.
K1_OPS = 170
K2_OPS = 220
K1_CELL_BYTES = 96   # 4 corner rows x 2 phi_d bins x 3 floats per lane
K1_BIN_BYTES = 12    # one phi_d bin: 3 floats
# K1's backward: K1's operations plus 3 products for each of 24 corner
# channels
K1_BWD_OPS = K1_OPS + 72
K2_ROW_BYTES = 256   # one 64-float CDF row per lane
K1_OUT_BYTES, K2_OUT_BYTES = 12, 16
# K3 / K4 bytes: a box row (8 floats); what a slot test reads of a slot
# row (type, p0, e1, e2: 10 floats) and the rest of a winner's 32-float
# row; per lane maxt, o and d (live lanes only), and the outputs (K3: t,
# u, v and the 32-float field row; K4: one byte)
BOX_BYTES = 32
SLOT_TEST_BYTES = 40
WINNER_REST_BYTES = 88
MAXT_BYTES, RAY_BYTES = 4, 24
K3_OUT_BYTES, K4_OUT_BYTES = 140, 1


def material_bands(d, blend=False):
    """The materials frame's bands on a matpreview_dict(..., n_materials=12)
    dict d, in place: 0-3 merl (the synthetic tables), 4 conductor, 5
    dielectric, 6 thindielectric, 7 roughdielectric (alpha 0.2), 8 plastic,
    9 roughplastic, 10 principled (metallic 0.5, clearcoat 0.5), 11
    twosided over merl; the floor roughconductor with the Beckmann
    distribution, alpha 0.25. blend=True gives the blend frame's bands
    instead at 9 null, 10 mask over merl (opacity 0.6), 11 blendbsdf of
    merl and roughplastic (weight 0.3). Returns d."""
    merl = [d[f"blob_{i}"]["bsdf"] for i in range(12)]
    bands = {
        4: {"type": "conductor"},
        5: {"type": "dielectric"},
        6: {"type": "thindielectric"},
        7: {"type": "roughdielectric", "alpha": 0.2},
        8: {"type": "plastic"},
        9: {"type": "roughplastic"},
        10: {"type": "principled", "metallic": 0.5, "clearcoat": 0.5},
        11: {"type": "twosided", "bsdf": merl[11]},
    }
    if blend:
        bands.update({
            9: {"type": "null"},
            10: {"type": "mask", "opacity": 0.6, "bsdf": merl[10]},
            11: {"type": "blendbsdf", "weight": 0.3, "a": merl[11],
                 "b": {"type": "roughplastic"}},
        })
    for i, b in bands.items():
        d[f"blob_{i}"]["bsdf"] = b
    d["floor"]["bsdf"] = {"type": "roughconductor", "distribution": "beckmann",
                          "alpha": 0.25}
    return d


def _time_ms(fn, reps=5):
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _unit_hemi(gen, n, dev):
    v = torch.randn((n, 3), generator=gen, device=dev)
    v[:, 2] = v[:, 2].abs() + 1e-3
    return v / v.norm(dim=-1, keepdim=True)


def _phi_table(shape, dev):
    """A table that varies along all three axes, smoothly. Its phi_d term
    scales with sin(theta_h) sin(theta_d), as for an isotropic BRDF: phi_d
    is undefined at those poles, where any two implementations may pick
    different angles."""
    n_th, n_td, n_pd, _ = shape
    th = ((torch.arange(n_th, device=dev) + 0.5) / n_th) ** 2 * (torch.pi / 2)
    td = (torch.arange(n_td, device=dev) + 0.5) / n_td * (torch.pi / 2)
    pd = (torch.arange(n_pd, device=dev) + 0.5) / n_pd * torch.pi
    rgb = torch.tensor([1.0, 0.7, 0.4], device=dev)
    return (0.3 + 0.2 * torch.cos(3 * th)[:, None, None, None]
            * torch.cos(2 * td)[None, :, None, None]
            + 0.25 * torch.sin(th)[:, None, None, None]
            * torch.sin(td)[None, :, None, None]
            * torch.cos(2 * pd)[None, None, :, None]) * rgb


def _check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} lanes outside rtol {rtol} atol {atol}; "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def check_k2(got, want, w):
    """K2's gate: the sampled cell (x's column of W) equal on every lane,
    x and the three masses within K2_RTOL / K2_ATOL. Returns (max abs
    error, lanes on which any output is not bit-equal)."""
    idx_got = torch.clamp((got[0] * w).floor(), max=w - 1)
    idx_want = torch.clamp((want[0] * w).floor(), max=w - 1)
    if not torch.equal(idx_got, idx_want):
        raise AssertionError(f"K2: sampled cell differs on "
                             f"{int((idx_got != idx_want).sum())} lanes")
    err = max(_check_close(f"K2[{i}]", g, r, K2_RTOL, K2_ATOL)
              for i, (g, r) in enumerate(zip(got, want)))
    differ = torch.zeros_like(got[0], dtype=torch.bool)
    for g, r in zip(got, want):
        differ |= g.view(torch.int32) != r.view(torch.int32)
    return err, int(differ.sum())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _k1_work(table, wi, wo, slot, mask, wo_b, mask_b):
    """(bytes, live lanes, lanes that evaluate) of the lane inputs of one K1
    or K1-backward call, its arguments as eval_trilinear takes them: wi
    and the slot once for the lanes where either half is live, wo of the
    live lanes and the masks of every lane; the lanes that evaluate (live,
    both cosines > 0) as a bool over the joined lanes."""
    halves = [(wo, mask)] + ([] if wo_b is None else [(wo_b, mask_b)])
    every = torch.ones(wi.shape[0], dtype=torch.bool, device=wi.device)
    live = [every if m is None else m for _, m in halves]
    either = int(torch.stack(live).any(0).sum())
    n_live = sum(int(m.sum()) for m in live)
    evaluates = torch.cat([m & (wi[:, 2] > 0) & (o[:, 2] > 0)
                           for (o, _), m in zip(halves, live)])
    nbytes = (either * (3 * wi.element_size() + (0 if slot is None else slot.element_size()))
              + n_live * 3 * wo.element_size()
              + sum(_nbytes(m) for _, m in halves))
    return nbytes, n_live, evaluates


def k1_bound(table, wi, wo, slot=None, mask=None, wo_b=None, mask_b=None):
    """K1's bound on one call: _k1_work's inputs, the bins of the lanes
    that evaluate (at most the table) and the output of every lane; the
    lanes that evaluate set the operations."""
    nbytes, _, evaluates = _k1_work(table, wi, wo, slot, mask, wo_b, mask_b)
    evaluated = int(evaluates.sum())
    halves = 1 if wo_b is None else 2
    return _bound(nbytes + min(_nbytes(table), evaluated * K1_CELL_BYTES)
                  + halves * wi.shape[0] * K1_OUT_BYTES, evaluated * K1_OPS)


def k1_bwd_bound(table, g, wi, wo, slot=None, mask=None, wo_b=None, mask_b=None, *,
                 value=None, out=None):
    """K1-backward's bound on one call as made (eval_trilinear_bwd's
    arguments): _k1_work's inputs and the cotangent g of the live lanes;
    of the lanes that evaluate with a nonzero cotangent, K1's output
    (`value`) and the bins of the clamp test, 96 B a lane at most the
    table: with `value`, only on lanes where it is 0 in a channel whose
    cotangent is not; without, on every such lane. Into a new gradient
    (out None): the dense gradient written once; into `out`: each
    gradient bin the call adds to (merl_sorted.scatter_pairs) read and
    written once. A backward pass zeroes its one buffer besides (phase
    13)."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    nbytes, n_live, evaluates = _k1_work(table, wi, wo, slot, mask, wo_b, mask_b)
    nonzero = g != 0
    adds = evaluates & nonzero.any(-1)
    reads = adds
    if value is not None:
        nbytes += int(adds.sum()) * K1_OUT_BYTES
        reads = adds & (~(value > 0) & nonzero).any(-1)
    nbytes += n_live * 3 * g.element_size() + min(_nbytes(table),
                                                  int(reads.sum()) * K1_CELL_BYTES)
    if out is None:
        nbytes += _nbytes(table)
    else:
        idx = k1.scatter_pairs(table, g, *k1.concat_halves(wi, wo, slot, mask, wo_b, mask_b),
                               value=value)[0]
        nbytes += 2 * K1_BIN_BYTES * torch.unique(idx // 3).numel()
    return _bound(nbytes, int(evaluates.sum()) * K1_BWD_OPS)


def k2_bound(cdf, *lanes):
    """K2's bound on one call, its arguments as cond_sample_pdf takes them:
    the indices and u of the live lanes, the mask and the four outputs of
    every lane, and a CDF row a live lane (at most the stack)."""
    valid = lanes[-1]
    live = int(valid.sum())
    nbytes = (min(_nbytes(cdf), live * K2_ROW_BYTES)
              + live * sum(a.element_size() for a in lanes[:-1])
              + valid.shape[0] * (valid.element_size() + K2_OUT_BYTES))
    return _bound(nbytes, live * K2_OPS)


def _cluster_work(cs, ray, out_bytes, **final):
    """(bytes, operations) that K3 or K4 must move and do on rays `ray`:
    per lane maxt and the outputs, o and d of live lanes; once per launch
    the root and supercluster boxes (if a lane is live), the cluster boxes
    of the superclusters and the cl_meta entry and filled slots of the
    clusters that ops/clusters.min_work says some lane must enter."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    w = cl.min_work(cs, ray, **final)
    n = ray.o.shape[0]
    live = int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())
    filled = (cs.slabs[:, :, cl.F_TYPE] >= 0).sum(1)
    nbytes = (n * (MAXT_BYTES + out_bytes) + live * RAY_BYTES
              + (live > 0) * (1 + cs.n_super) * BOX_BYTES
              + int(w.supers.sum()) * cl.GROUP * BOX_BYTES
              + int(w.clusters.sum()) * 4
              + int(filled[w.clusters].sum()) * SLOT_TEST_BYTES)
    ops = int(w.box.sum()) * cl.BOX_OPS + int(w.slot.sum()) * cl.SLOT_OPS
    return nbytes, ops


def k3_bound(cs, ray, t, prim):
    nbytes, ops = _cluster_work(cs, ray, K3_OUT_BYTES, t_hit=t)
    winners = torch.unique(prim[prim >= 0]).numel()
    return _bound(nbytes + winners * WINNER_REST_BYTES, ops)


def k4_bound(cs, ray, occ):
    return _bound(*_cluster_work(cs, ray, K4_OUT_BYTES, occluded=occ))


def phase_k1(table, dev):
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    n = 1 << 21  # one 2,097,152-lane pass; K1 evaluates two halves of it
    gen = torch.Generator(device=dev).manual_seed(1)
    wi, wo, wo_b = (_unit_hemi(gen, n, dev) for _ in range(3))
    # border lanes: wi == wo (theta_d = 0), normal incidence, grazing,
    # phi_d at the wrap (wo mirrored through the plane of incidence)
    wo[:4096] = wi[:4096]
    wi[4096:8192] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    wo[8192:12288, 2] = 1e-4
    wo[12288:16384] = wi[12288:16384] * torch.tensor([-1.0, -1.0, 1.0], device=dev)
    wo = wo / wo.norm(dim=-1, keepdim=True)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))

    stack = torch.stack([table, table.flip(0) * 0.7, _phi_table(table.shape, dev)])
    slot = torch.randint(0, 3, (n,), generator=gen, device=dev)
    slot[:16384] %= 2  # the pole lanes above stay on phi_d-free tables
    err = 0.0
    for tbl, sl in ((table, None), (stack, slot)):
        for lanes in ((wi, wo, sl, mask), (wi, wo, sl, mask, wo_b, mask_b)):
            got = k1.eval_trilinear(tbl, *lanes)
            want = k1.eval_trilinear_plain(tbl, *k1.concat_halves(*lanes))
            torch.cuda.synchronize()
            err = max(err, _check_close("K1", got, want, K1_RTOL, K1_ATOL))
    lanes = (wi, wo, None, mask, wo_b, mask_b)
    joined = k1.concat_halves(*lanes)
    ms = _time_ms(lambda: k1.eval_trilinear(table, *lanes))
    plain_ms = _time_ms(lambda: k1.eval_trilinear_plain(table, *joined))
    bound_ms, bound_by = k1_bound(table, *lanes)
    print(f"K1 merl_eval: {2 * n} lanes (two halves), max abs err {err:.3e} "
          f"(rtol {K1_RTOL}, atol {K1_ATOL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                device_ms=_device_ms("merl_eval_kernel", k1.eval_trilinear, table, *lanes))


def phase_k2(cdf_cond, dev):
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2

    n = 1 << 21  # one 2,097,152-lane pass of the main path
    n_sl, h, w = cdf_cond.shape
    gen = torch.Generator(device=dev).manual_seed(2)

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    # u is the second column of the (N, 2) sample, as bounce_shade passes it
    u = torch.rand((n, 2), generator=gen, device=dev)[:, 1]
    u[: n // 8] = 0.0
    u[n // 8: n // 4] = 1.0 - 1e-7
    args = (ints(n_sl), u, ints(h), ints(h), ints(w), ints(h), ints(w))
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    got = k2.cond_sample_pdf(cdf_cond, *args, valid)
    want = k2.cond_sample_pdf_plain(cdf_cond, *args, valid)
    torch.cuda.synchronize()
    err, differ = check_k2(got, want, w)
    ms = _time_ms(lambda: k2.cond_sample_pdf(cdf_cond, *args, valid))
    plain_ms = _time_ms(lambda: k2.cond_sample_pdf_plain(cdf_cond, *args, valid))
    bound_ms, bound_by = k2_bound(cdf_cond, *args, valid)
    print(f"K2 cond_sample: {n} lanes, cells equal, {differ} lanes not bit-equal, "
          f"max abs err {err:.3e} (rtol {K2_RTOL}, atol {K2_ATOL}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, lanes_not_bit_equal=differ,
                device_ms=_device_ms("cond_sample_kernel", k2.cond_sample_pdf, cdf_cond, *args,
                                     valid))


def camera_wavefront(scene, spp, seed=0):
    """The camera rays of the first render pass of `scene` (all pixels x
    spp lanes, 16x16 pixel blocks, as integrator.render orders them)."""
    import numpy as np

    from mitsuba_customization_tpu_torch.render.sensors import sample_ray

    h, w = scene.config.height, scene.config.width
    order = np.arange(h * w).reshape(h // 16, 16, w // 16, 16)
    order = order.transpose(0, 2, 1, 3).reshape(-1)
    pixel = torch.as_tensor(order, device=scene.device).repeat_interleave(spp)
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    jitter = torch.rand((pixel.shape[0], 2), generator=gen, device=scene.device)
    film_xy = torch.stack([pixel % w, pixel // w], -1).to(torch.float32) + jitter
    film_uv = film_xy / torch.tensor([w, h], dtype=torch.float32, device=scene.device)
    aperture = torch.rand((pixel.shape[0], 2), generator=gen, device=scene.device)
    return sample_ray(scene.sensor, film_uv, aperture, w / h)


def _plain_span(fn, n):
    """Lanes the plain version is compared and timed on: all n, or the
    first 262,144 if one plain call over all n would take over 30 s
    (extrapolated from a call on that slice)."""
    k = min(n, 1 << 18)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(k)
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) * n / k
    return (n if est <= PLAIN_SLICE_S else k), est


def check_k3(cs, r):
    """K3 against its plain version on rays r: hit/miss equal, prims equal
    on >= K3_PRIM_AGREE of hits, t bit-equal where they agree (within
    K3_T_RTOL where not), u, v and fields equal where they agree. Returns
    (max abs t err, prim agreement, hit share, the kernel's outputs)."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    t, prim, u, v, g = cl.intersect(cs, r)
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, r)
    torch.cuda.synchronize()
    prim_p = fld_p[:, cl.F_PRIM].long()
    hit, hit_p = prim >= 0, prim_p >= 0
    if not torch.equal(hit, hit_p):
        raise AssertionError(f"K3: hit/miss differs on {int((hit != hit_p).sum())} lanes")
    same = hit & (prim == prim_p)
    n_hit = int(hit.sum())
    prim_agree = int(same.sum()) / n_hit if n_hit else 1.0
    if not prim_agree >= K3_PRIM_AGREE:
        raise AssertionError(f"K3: prims agree on {prim_agree:.5f} of hits")
    if not torch.equal(t[same], t_p[same]):
        raise AssertionError("K3: t differs from the plain version's on a lane with the same prim")
    rel = ((t - t_p).abs() / t_p.abs())[hit & ~same]
    if rel.numel() and not float(rel.max()) <= K3_T_RTOL:
        raise AssertionError(f"K3: max rel t error {float(rel.max()):.3e} > {K3_T_RTOL}")
    g_p = cl._unpack(t_p, u_p, v_p, fld_p)[4]
    if not (torch.equal(u[same], u_p[same]) and torch.equal(v[same], v_p[same])
            and all(torch.equal(a[same], b[same]) for a, b in zip(g, g_p))):
        raise AssertionError("K3: u, v or winner fields differ from the plain version's")
    abs_err = float((t - t_p).abs()[hit].max()) if n_hit else 0.0
    return abs_err, prim_agree, n_hit / max(1, t.shape[0]), (t, prim, u, v, g)


def check_k4(cs, r):
    """K4 against its plain version on rays r: equal on every lane."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    occ = cl.occluded(cs, r)
    occ_p = cl.occluded_plain(cs, r)
    torch.cuda.synchronize()
    if not torch.equal(occ, occ_p):
        raise AssertionError(f"K4: occlusion differs on {int((occ != occ_p).sum())} lanes")
    return occ


def _sub(ray, k):
    from mitsuba_customization_tpu_torch.render.records import Ray

    return Ray(ray.o[:k], ray.d[:k], ray.maxt[:k])


def phase_k3(scene, ray):
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    cs = scene.clusters
    n_all = ray.o.shape[0]
    n, plain_s = _plain_span(lambda k: cl.intersect_plain(cs, _sub(ray, k)), n_all)
    r = _sub(ray, n)
    abs_err, prim_agree, hits, out = check_k3(cs, r)
    ms = _time_ms(lambda: cl.intersect(cs, r))
    plain_ms = _time_ms(lambda: cl.intersect_plain(cs, r))
    bound_ms, bound_by = k3_bound(cs, r, out[0], out[1])
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K3 cluster_closest: {n} lanes ({which} of {n_all}), hits {hits:.4f}, "
          f"hit/miss equal, max t err {abs_err:.3e}, prim agreement "
          f"{prim_agree:.6f}, u/v/fields equal on agreeing prims; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    stats = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by,
                 device_ms=_device_ms("cluster_closest_kernel", cl.intersect, cs, r))
    return stats, out + (r,)


def nee_shadow_rays(scene, si, seed=4):
    """Shadow rays from the hits `si` toward a light sampled by
    emitters.sample_direction (seeded draws), maxt just short of the
    light; maxt = 0 on every fourth lane and where there is no hit or no
    sample."""
    from mitsuba_customization_tpu_torch.render import emitters as em
    from mitsuba_customization_tpu_torch.render import geometry as geo
    from mitsuba_customization_tpu_torch.render.records import Ray

    n_all = si.t.shape[0]
    gen = torch.Generator(device=si.t.device).manual_seed(seed)
    u3 = torch.rand((n_all, 3), generator=gen, device=si.t.device)
    ds = em.sample_direction(scene.emitters, scene.geometry, si.p, u3)
    shadow = geo.spawn_ray(si, ds.d)
    lane = torch.arange(n_all, device=si.t.device)
    maxt = torch.where(si.valid & (ds.pdf > 0.0) & (lane % 4 != 0),
                       ds.dist * (1.0 - 1e-3), 0.0)
    return Ray(shadow.o, shadow.d, maxt)


def phase_k4(scene, hits):
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render import geometry as geo

    t, prim, u, v, g, r = hits
    ray = nee_shadow_rays(scene, geo.interaction_from_g(g, r, t, prim, u, v))
    n_all = t.shape[0]
    lane = torch.arange(n_all, device=t.device)
    cs = scene.clusters
    n, plain_s = _plain_span(lambda k: cl.occluded_plain(cs, _sub(ray, k)), n_all)
    rs = _sub(ray, n)
    occ = check_k4(cs, rs)
    if bool(occ[(lane[:n] % 4) == 0].any()):
        raise AssertionError("K4: a lane with maxt = 0 is occluded")
    ms = _time_ms(lambda: cl.occluded(cs, rs))
    plain_ms = _time_ms(lambda: cl.occluded_plain(cs, rs))
    bound_ms, bound_by = k4_bound(cs, rs, occ)
    live = float((rs.maxt > 0).float().mean())
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"K4 cluster_shadow: {n} lanes ({which} of {n_all}), live "
          f"{live:.4f}, occluded {float(occ.float().mean()):.4f}, equal on every "
          f"lane; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                device_ms=_device_ms("cluster_shadow_kernel", cl.occluded, cs, rs))


def record_calls(fn, targets):
    """Run fn() once with a recording wrapper on each target and keep the
    inputs of every call, in call order: {key: [kept inputs]}. targets:
    {key: (obj, name, keep)}: obj.name is wrapped for the run (a module
    function, or a method set on that one object) and keep(args, kwargs)
    makes what is kept of a call."""
    rec = {key: [] for key in targets}
    saved = []
    for key, (obj, name, keep) in targets.items():
        orig = getattr(obj, name)
        saved.append((obj, name, orig, name in vars(obj)))

        def wrapper(*args, _orig=orig, _kept=rec[key], _keep=keep, **kwargs):
            _kept.append(_keep(args, kwargs))
            return _orig(*args, **kwargs)

        setattr(obj, name, wrapper)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for obj, name, orig, own in saved:
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
    return rec


def _keep_args(args, kwargs=None):
    """A call's positional arguments, the first (a table or CDF stack) not
    copied; keyword arguments (K1's sink) are not kept."""
    return args[:1] + tuple(a.clone() if torch.is_tensor(a) else a for a in args[1:])


def _keep_bwd(args, kwargs):
    """A K1-backward call: (its positional arguments as _keep_args keeps
    them, a copy of K1's output `value`); `out`, the pass's buffer, is not
    kept."""
    value = kwargs.get("value")
    return _keep_args(args), None if value is None else value.clone()


def record_wavefronts(scene, spp, seed):
    """Render `scene` once and keep the inputs of every K1-K4 call, in call
    order: {"K1": [args], "K2": [args], "K3": [Ray], "K4": [Ray]}. The K3
    and K4 calls are recorded by wrappers set on this Scene object, the K1
    and K2 calls by wrapping their module functions for this render."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render.records import Ray

    def keep_ray(args, kwargs):
        return Ray(*(t.clone() for t in cl._rays(args[0])))

    return record_calls(lambda: mt.render(scene, spp=spp, seed=seed), {
        "K1": (k1, "eval_trilinear", _keep_args),
        "K2": (k2, "cond_sample_pdf", _keep_args),
        "K3": (scene, "ray_intersect", keep_ray),
        "K4": (scene, "ray_test", keep_ray),
    })


def phase_bounces(scene, rec, k1_per_bounce=1, hit_types=None, k3_per_bounce=1,
                  label="bounce"):
    """Check and time every recorded K1-K4 call of one render, one line per
    bounce (k1_per_bounce K1 calls a bounce: 1 in the fused bounce, more
    where blends take the public eval / pdf / sample; k3_per_bounce K3
    calls: 2 in the volumetric tracer, whose shadow ray finds its first
    boundary by K3; `label` names a line's group of calls where they are
    not a bounce's, as in the light tracers); K4 runs on the scene's
    shadow cluster set where it has one. With hit_types (a dict)
    each K3 / K4 call is checked on its first PLAIN_SLICE lanes and timed
    on all, and hit_types counts the checked K3 hits by prim type.
    Returns {kernel: (frame ms, frame bound ms)}."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    cs = scene.clusters
    cs_shadow = cs if scene.shadow_clusters is None else scene.shadow_clusters
    total = {k: [0.0, 0.0] for k in ("K1", "K2", "K3", "K4")}
    n_bounces = max(-(-len(rec["K3"]) // k3_per_bounce), len(rec["K4"]), len(rec["K2"]),
                    -(-len(rec["K1"]) // k1_per_bounce))
    for b in range(n_bounces):
        parts = []
        for r in rec["K3"][b * k3_per_bounce:(b + 1) * k3_per_bounce]:
            checked = ""
            if hit_types is None:
                out = check_k3(cs, r)[3]
            else:
                n = min(r.o.shape[0], PLAIN_SLICE)
                out = check_k3(cs, _sub(r, n))[3]
                for ty, c in zip(*torch.unique(out[4].prim_type[out[1] >= 0],
                                               return_counts=True)):
                    hit_types[int(ty)] = hit_types.get(int(ty), 0) + int(c)
                checked = f" ({n} checked)"
                out = cl.intersect(cs, r)
            ms = _time_ms(lambda: cl.intersect(cs, r))
            bound, by = k3_bound(cs, r, out[0], out[1])
            parts.append(f"K3 {r.o.shape[0]} lanes{checked}, {int((r.maxt > 0).sum())} live, "
                         f"{ms:.4f} ms (bound {bound:.5f}, {by})")
            total["K3"][0] += ms
            total["K3"][1] += bound
        if b < len(rec["K4"]):
            r = rec["K4"][b]
            checked = "" if hit_types is None else f" ({min(r.o.shape[0], PLAIN_SLICE)} checked)"
            if hit_types is None:
                occ = check_k4(cs_shadow, r)
            else:
                check_k4(cs_shadow, _sub(r, PLAIN_SLICE))
                occ = cl.occluded(cs_shadow, r)
            ms = _time_ms(lambda: cl.occluded(cs_shadow, r))
            bound, by = k4_bound(cs_shadow, r, occ)
            parts.append(f"K4 {r.o.shape[0]} lanes{checked}, {int((r.maxt > 0).sum())} live, "
                         f"{int(occ.sum())} occluded, {ms:.4f} ms (bound {bound:.5f}, {by})")
            total["K4"][0] += ms
            total["K4"][1] += bound
        for args in rec["K1"][b * k1_per_bounce:(b + 1) * k1_per_bounce]:
            wi, _, _, mask = lanes = k1.concat_halves(*args[1:])
            got = k1.eval_trilinear(*args)
            want = k1.eval_trilinear_plain(args[0], *lanes)
            torch.cuda.synchronize()
            _check_close("K1", got, want, K1_RTOL, K1_ATOL)
            ms = _time_ms(lambda: k1.eval_trilinear(*args))
            bound = k1_bound(*args)[0]
            live = wi.shape[0] if mask is None else int(mask.sum())
            halves = "one half" if len(args) < 6 or args[5] is None else "two halves"
            parts.append(f"K1 {wi.shape[0]} lanes ({halves}), {live} live, {ms:.4f} ms "
                         f"(bound {bound:.4f})")
            del lanes, wi, mask
            total["K1"][0] += ms
            total["K1"][1] += bound
        if b < len(rec["K2"]):
            args = rec["K2"][b]
            got = k2.cond_sample_pdf(*args)
            want = k2.cond_sample_pdf_plain(*args)
            torch.cuda.synchronize()
            differ = check_k2(got, want, args[0].shape[-1])[1]
            ms = _time_ms(lambda: k2.cond_sample_pdf(*args))
            bound = k2_bound(*args)[0]
            parts.append(f"K2 {args[-1].shape[0]} lanes, {int(args[-1].sum())} live, "
                         f"{differ} not bit-equal, {ms:.4f} ms (bound {bound:.4f})")
            total["K2"][0] += ms
            total["K2"][1] += bound
        print(f"{label} {b}: " + "; ".join(parts))
    print("frame sums over the recorded calls: " + ", ".join(
        f"{k} {ms:.4f} ms (bound {bound:.4f})" for k, (ms, bound) in total.items()))
    return {k: tuple(v) for k, v in total.items()}


# the BSDF stage's fused route (bsdf_shade_pre / post around K2 and K1)
# against its plain route (models/bsdf._bounce_shade_plain) on the same
# tensors (check_bsdf_stage; phase 10 and tests/test_torch_cuda_bsdf.py):
# is_delta and each output's zero pattern equal, the values within
# BSDF_RTOL on all but a BSDF_RARE share of lanes and within BSDF_REL_L1
# summed over the plain sum. The kernels round as torch's CUDA ops do
# (csrc/bsdf_shade.cu), so the routes agree bit for bit on every output but
# the tabulated weight, which the fused route takes as f * (cos / pdf) and
# the plain one as (f * cos) / pdf: an ulp or two (measured at 2,097,152
# lanes on an H100: f_nee, pdf_nee, wo and pdf_s equal on every lane, the
# weight on 58-90 %). The tolerances leave room for torch versions that
# reduce or contract otherwise: a lane whose half vector moves across a
# cell edge of the sampling grid takes the neighbouring cell's mass (a pdf
# off by the cells' ratio), and a cosine-lobe direction near the horizon
# loses digits to cancellation in z = sqrt(1 - x^2 - y^2); both were seen
# on a few lanes in 10^5 while the kernels still summed in another order.
BSDF_RTOL, BSDF_RARE, BSDF_REL_L1 = 1e-4, 1e-4, 1e-5
BSDF_OUTPUTS = ("f_nee", "pdf_nee", "wo", "pdf_s", "weight", "is_delta")
SH_TRACE_NAMES = {"SH-pre": "bsdf_shade_pre_kernel", "SH-post": "bsdf_shade_post_kernel"}


def _check_outputs(stage, names, got, want, infinite_ok=False):
    """A fused route's outputs `got` against the plain route's `want`
    (BSDF_* above): a bool output equal, each other output 0 on the same
    lanes (and, with infinite_ok, infinite on the same lanes, else finite),
    its values within BSDF_RTOL on all but BSDF_RARE of the lanes and
    BSDF_REL_L1 summed. Returns {output: (lanes past BSDF_RTOL, relative
    L1 gap, lanes not equal)}; raises where an output fails."""
    out = {}
    for name, g, w in zip(names, got, want):
        what = f"{stage}: {name}"
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} is {tuple(g.shape)} {g.dtype}, the plain route's "
                                 f"{tuple(w.shape)} {w.dtype}")
        n = g.shape[0]
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                raise AssertionError(f"{what} differs on {int((g != w).sum())} lanes")
            out[name] = (0, 0.0, 0)
            continue
        g, w = g.reshape(n, -1).double(), w.reshape(n, -1).double()
        if not torch.equal((g == 0).all(-1), (w == 0).all(-1)):
            raise AssertionError(f"{what} is 0 on other lanes than the plain route's")
        if infinite_ok and torch.equal(torch.isinf(g), torch.isinf(w)):
            g, w = (torch.where(torch.isinf(w), 0.0, x) for x in (g, w))
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
            raise AssertionError(f"{what} is not finite"
                                 + (" where the plain route's is" if infinite_ok else ""))
        gap = (g - w).abs()
        off = int((gap.amax(-1) > BSDF_RTOL * w.abs().amax(-1) + 1e-7).sum())
        rel_l1 = float(gap.sum() / w.abs().sum().clamp(min=1e-30))
        if off > BSDF_RARE * n or rel_l1 > BSDF_REL_L1:
            raise AssertionError(f"{what} off on {off} of {n} lanes (at most "
                                 f"{BSDF_RARE * n:.0f}), relative L1 gap {rel_l1:.3e} (limit "
                                 f"{BSDF_REL_L1})")
        out[name] = (off, rel_l1, int((g != w).any(-1).sum()))
    return out


def check_bsdf_stage(got, want):
    """The fused route's six outputs `got` against the plain route's `want`
    (_check_outputs)."""
    return _check_outputs("BSDF stage", BSDF_OUTPUTS, got, want)


def bsdf_bytes(table, mat_id, active):
    """Logical bytes of bsdf_shade_pre and bsdf_shade_post on a call: every
    lane's id and masks (10 B) and outputs (45 B; with tabulated lanes
    present 12 B more: K2's mask, the flags, K1's masks, the scales); a
    live lane of a fused kernel's directions and samples (44 B); a
    tabulated lane's K2 indices, K1 slot and state (92 B) out of pre and
    into post with K2's outputs and the row (60 B), post's outputs (25 B);
    every lane's flags into post (1 B). Tables and stacks, which stay in
    L2, are not counted."""
    from mitsuba_customization_tpu_torch.models import bsdf

    n = mat_id.shape[0]
    t = table.mat_type[mat_id]
    act = torch.ones_like(t, dtype=torch.bool) if active is None else active
    live = int((act & sum(t == k for k in bsdf.FUSED_KERNELS).bool()).sum())
    tab = int((act & (t == bsdf.TABULATED)).sum())
    pre = n * (10 + 45 + (12 if tab else 0)) + live * 44 + tab * 92
    post = n * 1 + tab * (60 + 25)
    return {"lanes": n, "live": live, "tabulated": tab, "pre_bytes": pre, "post_bytes": post,
            "pre_bound_ms": pre / HBM_BYTES_PER_S * 1e3,
            "post_bound_ms": post / HBM_BYTES_PER_S * 1e3}


def _keep_shade(args, kwargs):
    """A bounce_shade call: (its positional arguments, the table not
    copied; its keyword arguments), every tensor copied."""
    def keep(a):
        return a.clone() if torch.is_tensor(a) else a

    return args[:1] + tuple(keep(a) for a in args[1:]), {k: keep(v) for k, v in kwargs.items()}


def phase_bsdf_stage(scene, spp, seed=1, reps=5):
    """Phase 10's BSDF stage: one more render of `scene` with a recording
    wrapper on models/bsdf.bounce_shade keeps every call's inputs; each
    call, whose present kernels must all take the fused route, runs on
    the fused route (bounce_shade: bsdf_shade_pre, K2, bsdf_shade_post,
    K1; one launch of each new kernel) and on the plain route
    (_bounce_shade_plain) on the same tensors, held together
    (check_bsdf_stage), timed (CUDA events, a call of each route) and
    traced (_device_trace: device ms of bsdf_shade_pre / post and of the
    whole call of each route), one line per bounce, beside the kernels'
    bound by bsdf_bytes. Returns ({"SH-pre" / "SH-post": the first
    call's numbers}, {"SH-pre" / "SH-post": (frame ms, frame bound ms)}):
    `ms` and `device_ms` are the profiler's device time of the kernel,
    `call_ms` / `plain_ms` the CUDA-event time of the two routes' calls,
    `call_device_ms` / `plain_device_ms` their device time."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.models import bsdf
    from mitsuba_customization_tpu_torch.ops import bsdf_shade

    rec = record_calls(lambda: mt.render(scene, spp=spp, seed=seed),
                       {"SH": (bsdf, "bounce_shade", _keep_shade)})["SH"]
    if not rec:
        raise AssertionError("BSDF stage: the render made no bounce_shade call")
    first, frame = None, {k: [0.0, 0.0] for k in SH_TRACE_NAMES}
    for b, (args, kw) in enumerate(rec):
        table, mat_id, wi = args[:3]
        routes = bsdf.route(table.present_kernels, wi.device.type, table.blend_a is not None,
                            torch.is_grad_enabled(), frozenset(), False)
        if set(routes.values()) != {bsdf.FUSED}:
            raise AssertionError(f"BSDF stage: bounce {b} routes {routes}")
        before = dict(bsdf_shade.LAUNCHES)
        got = bsdf.bounce_shade(*args, **kw)
        want = bsdf._bounce_shade_plain(*args, **kw)
        torch.cuda.synchronize()
        launched = {k: bsdf_shade.LAUNCHES[k] - before[k] for k in before}
        want_launched = {"pre": 1, "post": int(bsdf.TABULATED in table.present_kernels)}
        if launched != want_launched:
            raise AssertionError(f"BSDF stage: bounce {b} launched {launched}")
        agree = check_bsdf_stage(got, want)
        del got, want
        work = bsdf_bytes(table, mat_id, kw.get("active"))
        call_ms = _time_ms(lambda: bsdf.bounce_shade(*args, **kw))
        plain_ms = _time_ms(lambda: bsdf._bounce_shade_plain(*args, **kw))
        dev_ms, dev_ops = {}, {}
        for route, fn in (("fused", bsdf.bounce_shade), ("plain", bsdf._bounce_shade_plain)):
            events = _device_trace(reps, fn, *args, **kw)
            dev_ops[route] = round(len(events) / reps)
            dev_ms[route] = _per_call_ms(events, reps)
        fused_dev = dev_ms["fused"]
        ms = {k: sum(v for op, v in fused_dev.items() if name in op)
              for k, name in SH_TRACE_NAMES.items()}
        if ms["SH-pre"] <= 0 or (want_launched["post"] and ms["SH-post"] <= 0):
            raise AssertionError(f"BSDF stage: bounce {b}'s trace holds no new kernel "
                                 f"({sorted(fused_dev)[:20]})")
        bound = {"SH-pre": work["pre_bound_ms"], "SH-post": work["post_bound_ms"]}
        for k in SH_TRACE_NAMES:
            frame[k][0] += ms[k]
            frame[k][1] += bound[k]
        if first is None:
            first = {k: dict(ms=ms[k], device_ms=ms[k], bound_ms=bound[k], bound_by="bytes",
                             bytes=work[k[3:] + "_bytes"], calls=len(rec), lanes=work["lanes"],
                             live=work["live"], tabulated=work["tabulated"],
                             call_ms=call_ms, plain_ms=plain_ms,
                             call_device_ms=sum(fused_dev.values()),
                             call_device_ops=dev_ops["fused"],
                             plain_device_ms=sum(dev_ms["plain"].values()),
                             plain_device_ops=dev_ops["plain"],
                             max_rel_l1=max(a[1] for a in agree.values()),
                             lanes_off=max(a[0] for a in agree.values()))
                     for k in SH_TRACE_NAMES}
        print(f"BSDF stage bounce {b}: {work['lanes']} lanes, {work['live']} live on fused "
              f"kernels, {work['tabulated']} tabulated; fused against plain: "
              + ", ".join(f"{n} {a[0]} past rtol, rel L1 {a[1]:.2e}, {a[2]} not equal"
                          for n, a in agree.items() if n != "is_delta")
              + f", is_delta equal; pre {ms['SH-pre']:.4f} ms (bound {bound['SH-pre']:.4f}), "
              f"post {ms['SH-post']:.4f} ms (bound {bound['SH-post']:.4f}); the call "
              f"{call_ms:.4f} ms fused against {plain_ms:.4f} plain (CUDA events), device "
              f"{sum(fused_dev.values()):.4f} ms in {dev_ops['fused']} device ops against "
              f"{sum(dev_ms['plain'].values()):.4f} in {dev_ops['plain']}")
    print("BSDF stage frame sums over the recorded calls: " + ", ".join(
        f"{k} {v[0]:.4f} ms (bound {v[1]:.4f})" for k, v in frame.items()))
    return first, {k: tuple(v) for k, v in frame.items()}


# the emitter stage's fused route (ops/emitter_shade: emitter_hit,
# emitter_sample, emitter_nee) against its plain route (render/emitters.py's
# functions) on the same tensors (check_emitter_stage; phase 10 and
# tests/test_torch_cuda_emitter.py): each kernel's outputs against the plain
# route's same quantities (emitter_terms), the masks equal, each output's
# zero and infinity patterns equal and its values within the BSDF stage's
# tolerances (BSDF_*: the kernels round as torch's CUDA ops do, as the BSDF
# stage's do); an independent sampler's draws made in the kernel equal to
# its next_1d's (check_emitter_draws)
EM_TRACE_NAMES = {"EM-hit": "emitter_hit_kernel", "EM-sample": "emitter_sample_kernel",
                  "EM-nee": "emitter_nee_kernel"}
EM_PARTS = {"EM-hit": "hit", "EM-sample": "sample", "EM-nee": "nee"}
EM_FUNCTIONS = {"hit": "hit_term", "sample": "sample_nee", "nee": "nee_term"}
EM_OUTPUTS = {"hit": ("e",), "nee": ("e",),
              "sample": ("d", "dist", "pdf", "radiance", "delta", "p_area", "wo_local",
                         "nee_ok")}


def emitter_terms(part, args, fused, draws=None):
    """What the kernel of the emitter stage's part ("hit", "sample" or
    "nee") computes on one call of the part's function (render/emitters
    hit_term, sample_nee, nee_term; `args` its positional arguments): the
    kernel's outputs (fused) or the plain route's same quantities. hit: (rad
    * w_mis where the mask holds,); sample: the DirectionSample's six
    fields, wo_local, nee_ok; nee: (radiance * w_nee / pdf where vis,).
    draws: "u3" hands the fused sample the sampler's own three draws in
    place of its lane keys."""
    from mitsuba_customization_tpu_torch.core import math as m
    from mitsuba_customization_tpu_torch.core.sampler import IndependentSampler
    from mitsuba_customization_tpu_torch.ops import emitter_shade
    from mitsuba_customization_tpu_torch.render import emitters as em

    if part == "hit":
        table, geom, si, ray, _, _, prev_pdf, prev_delta, mask = args
        if fused:
            return (emitter_shade.hit(table, geom, si, ray.o, prev_pdf, prev_delta, mask),)
        rad = torch.where(si.valid[..., None], em.eval_hit(table, si),
                          em.eval_background(table, ray.d))
        em_pdf = torch.where(si.valid, em.pdf_hit_direction(table, geom, si, ray.o),
                             em.pdf_miss_direction(table, ray.d))
        w = torch.where(prev_delta, 1.0, em.mis_weight(prev_pdf, em_pdf))
        return (torch.where(mask[..., None], rad * w[..., None], 0.0),)
    if part == "sample":
        table, geom, si, p_ref, sampler, mask, depth_ok, refl_only = args
        sampler = sampler.clone()
        if not fused:
            ds, wo, ok = em._sample_nee_plain(table, geom, si, p_ref, sampler, mask, depth_ok,
                                              refl_only)
            return (*ds, wo, ok)
        if type(sampler) is IndependentSampler and draws != "u3":
            kw = dict(lane_key=sampler._lane_key, dim=sampler.base_dim + sampler.dim)
        else:
            kw = dict(u3=torch.stack([sampler.next_1d() for _ in range(3)], -1))
        ds, wo, ok = emitter_shade.sample(table, geom, si.frame, p_ref, mask, depth_ok,
                                          refl_only, **kw)
        return (*ds, wo, ok)
    table, ds, pdf_nee, vis, _, _ = args
    if fused:
        return (emitter_shade.nee(ds.radiance, ds.pdf, ds.delta, pdf_nee, vis),)
    w = torch.where(ds.delta, 1.0, em.mis_weight(ds.pdf, pdf_nee))
    return (torch.where(vis[..., None], ds.radiance * m.safe_div(w, ds.pdf)[..., None], 0.0),)


def check_emitter_stage(part, got, want):
    """A part's kernel outputs `got` against the plain route's `want`
    (emitter_terms; _check_outputs, sample's dist infinite on the same
    lanes)."""
    return _check_outputs(f"emitter stage {part}", EM_OUTPUTS[part], got, want,
                          infinite_ok=True)


def check_emitter_draws(args):
    """emitter_sample with an independent sampler's lane keys (the kernel
    draws) against the same kernel handed the sampler's own three next_1d
    draws: every output bit-equal. Returns the lanes."""
    keyed = emitter_terms("sample", args, True)
    drawn = emitter_terms("sample", args, True, draws="u3")
    for name, a, b in zip(EM_OUTPUTS["sample"], keyed, drawn):
        if not torch.equal(a, b):
            raise AssertionError(f"emitter stage sample: {name} from the kernel's draws differs "
                                 "from the sampler's draws")
    return keyed[0].shape[0]


def emitter_bytes(part, args):
    """Logical bytes of a part's kernel on a call: hit, every lane's mask
    and output (13 B), a lane under the mask its hit flag, prev_delta and
    prev_pdf (6 B) and, where it hit, its hit record and origin (100 B);
    sample, every lane's point, frame, mask and draws in (8 B of lane key,
    or 12 of draws) and its 50 B out; nee, every lane's vis and output (13
    B), a visible lane's radiance, pdfs and delta (21 B). The tables stay in
    L2 and are not counted."""
    if part == "hit":
        si, mask = args[2], args[8]
        n = mask.shape[0]
        b = n * 13 + int(mask.sum()) * 6 + int((mask & si.valid).sum()) * 100
    elif part == "sample":
        n = args[3].shape[0]
        b = n * (12 + 36 + 1 + 50 + (8 if hasattr(args[4], "_lane_key") else 12))
    else:
        vis = args[3]
        n = vis.shape[0]
        b = n * 13 + int(vis.sum()) * 21
    return {"lanes": n, "bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3}


def _keep_emitter(args, kwargs):
    """An emitter-stage call's positional arguments, the emitter table and
    the geometry not copied, every lane tensor copied (a hit record, ray or
    DirectionSample field by field, a sampler's lane arrays)."""
    def keep(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(keep(x) for x in a))
        if hasattr(a, "ARRAYS"):
            return a.with_lanes(**{k: getattr(a, k).clone() for k in a.ARRAYS})
        return a

    n_tables = 1 if len(args) == 6 else 2  # nee_term's table; hit_term's, sample_nee's and geometry
    return args[:n_tables] + tuple(keep(a) for a in args[n_tables:])


def phase_emitter_stage(scene, spp, seed=1, reps=5):
    """Phase 10's emitter stage: one more render of `scene` with recording
    wrappers on render/emitters' hit_term, sample_nee and nee_term keeps
    every call's inputs; on each call, which must take the fused route
    (one launch of its kernel), the kernel's outputs are held to the plain
    route's (emitter_terms, check_emitter_stage), an independent sampler's
    draws to its next_1d's (check_emitter_draws), and the whole call is
    timed on both routes (CUDA events; the route's function and the plain
    route's _*_plain) and traced (_device_trace: the kernel's device ms and
    the call's), one line per call, beside the kernel's bound
    (emitter_bytes). Returns ({"EM-hit" / "EM-sample" / "EM-nee": the first
    call's numbers, with `calls`}, {the same keys: (frame ms of the
    kernel, frame bound ms, frame device ms of the fused calls, of the
    plain calls)})."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import emitter_shade
    from mitsuba_customization_tpu_torch.render import emitters as em

    rec = record_calls(lambda: mt.render(scene, spp=spp, seed=seed),
                       {part: (em, fn, _keep_emitter) for part, fn in EM_FUNCTIONS.items()})
    if not all(rec.values()):
        raise AssertionError(f"emitter stage: calls {({k: len(v) for k, v in rec.items()})}")
    first, frame = {}, {k: [0.0, 0.0, 0.0, 0.0] for k in EM_TRACE_NAMES}
    for key, part in EM_PARTS.items():
        fn = getattr(em, EM_FUNCTIONS[part])
        plain_fn = getattr(em, f"_{EM_FUNCTIONS[part]}_plain")
        for i, args in enumerate(rec[part]):
            table = args[0]
            if em.route(table.present, "cuda", torch.is_grad_enabled(), False) != em.FUSED:
                raise AssertionError(f"emitter stage: {part} call {i} takes the plain route")
            before = dict(emitter_shade.LAUNCHES)
            got = emitter_terms(part, args, True)
            want = emitter_terms(part, args, False)
            torch.cuda.synchronize()
            launched = {k: emitter_shade.LAUNCHES[k] - before[k] for k in before}
            if launched != {k: int(k == part) for k in before}:
                raise AssertionError(f"emitter stage: {part} call {i} launched {launched}")
            agree = check_emitter_stage(part, got, want)
            del got, want
            drawn = check_emitter_draws(args) if part == "sample" else None
            work = emitter_bytes(part, args)
            # the plain sample draws with its sampler's next_1d: a fresh
            # clone each call
            def fresh(f, args=args):
                return lambda: f(*(a.clone() if hasattr(a, "ARRAYS") else a for a in args))

            call_ms = _time_ms(fresh(fn))
            plain_ms = _time_ms(fresh(plain_fn))
            dev_ms, dev_ops = {}, {}
            for route, f in (("fused", fn), ("plain", plain_fn)):
                events = _device_trace(reps, f, *args)
                dev_ops[route] = round(len(events) / reps)
                dev_ms[route] = _per_call_ms(events, reps)
            ms = sum(v for op, v in dev_ms["fused"].items() if EM_TRACE_NAMES[key] in op)
            if ms <= 0:
                raise AssertionError(f"emitter stage: {part} call {i}'s trace holds no "
                                     f"{EM_TRACE_NAMES[key]} ({sorted(dev_ms['fused'])[:20]})")
            fused_dev, plain_dev = sum(dev_ms["fused"].values()), sum(dev_ms["plain"].values())
            for j, v in enumerate((ms, work["bound_ms"], fused_dev, plain_dev)):
                frame[key][j] += v
            if i == 0:
                first[key] = dict(ms=ms, device_ms=ms, bound_ms=work["bound_ms"],
                                  bound_by="bytes", bytes=work["bytes"], calls=len(rec[part]),
                                  lanes=work["lanes"], call_ms=call_ms, plain_ms=plain_ms,
                                  call_device_ms=fused_dev, call_device_ops=dev_ops["fused"],
                                  plain_device_ms=plain_dev, plain_device_ops=dev_ops["plain"],
                                  max_rel_l1=max(a[1] for a in agree.values()),
                                  lanes_off=max(a[0] for a in agree.values()))
            print(f"emitter stage {part} call {i}: {work['lanes']} lanes; fused against plain: "
                  + ", ".join(f"{n} {a[0]} past rtol, rel L1 {a[1]:.2e}, {a[2]} not equal"
                              for n, a in agree.items())
                  + ("" if drawn is None else f"; the kernel's draws equal on {drawn} lanes")
                  + f"; kernel {ms:.4f} ms (bound {work['bound_ms']:.4f}); the call "
                  f"{call_ms:.4f} ms fused against {plain_ms:.4f} plain (CUDA events), device "
                  f"{fused_dev:.4f} ms in {dev_ops['fused']} device ops against "
                  f"{plain_dev:.4f} in {dev_ops['plain']}")
    print("emitter stage frame sums over the recorded calls: " + ", ".join(
        f"{k} {v[0]:.4f} ms (bound {v[1]:.4f}), calls' device ms {v[2]:.4f} fused against "
        f"{v[3]:.4f} plain" for k, v in frame.items()))
    return first, {k: tuple(v) for k, v in frame.items()}


def k1_bwd_identity_err(table, g, *lanes, value=None):
    """K1-backward against K1 by linearity: the relative error of
    <K1-bwd(g), d> = <g, K1(d)> on a seeded table d >= 0, over sum |g|
    K1(d). K1's clamp passes g where the value is >= 0: on a table with
    negative entries, a channel where K1 returns 0 is left out of both
    sides. value: K1's output on the lanes, handed to K1-bwd (or None)."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    if bool((table < 0).any()):
        k1_out = k1.eval_trilinear(table, *lanes) if value is None else value
        g = torch.where(k1_out == 0, 0.0, g)
    got = k1.eval_trilinear_bwd(table, g, *lanes, value=value).double()
    gen = torch.Generator(device=table.device).manual_seed(7)
    d = torch.rand(table.shape, generator=gen, device=table.device)
    kd = k1.eval_trilinear(d, *lanes).double()
    lhs = float((got * d.double()).sum())
    rhs = float((g.double() * kd).sum())
    return abs(lhs - rhs) / float((g.double().abs() * kd).sum())


def rel_l2(got, want):
    return float((got - want).double().norm() / want.double().norm())


def check_k1_bwd(table, g, *lanes, value=None):
    """K1-backward's gate on one call (see K1_BWD_ID_RTOL): the linearity
    identity against K1, and the relative L2 error against the plain
    version on the joined lanes, both handed K1's output `value` (or
    None). Returns (identity error, relative L2 error)."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    got = k1.eval_trilinear_bwd(table, g, *lanes, value=value)
    want = k1.eval_trilinear_bwd_plain(table, g, *k1.concat_halves(*lanes), value=value)
    l2 = rel_l2(got, want)
    id_err = k1_bwd_identity_err(table, g, *lanes, value=value)
    if not (id_err <= K1_BWD_ID_RTOL and l2 <= K1_BWD_L2_RTOL
            and bool(torch.isfinite(got).all())):
        raise AssertionError(
            f"K1-bwd: identity error {id_err:.3e} (limit {K1_BWD_ID_RTOL}), relative "
            f"L2 error against plain {l2:.3e} (limit {K1_BWD_L2_RTOL})")
    return id_err, l2


# host time asleep on each side of a traced burst, inside the trace (s):
# the profiler keeps only the device events stamped inside its capture
# window, and the card's timestamps land up to a few ms off the host's
# clock, so a burst of a few short kernels traced edge to edge could lose
# every one of them (PERF.md q7; scripts/profiler_window_probe.py: 20 ms
# held the kernels of each of 1,472 traces, 36 of which came back empty
# without it)
TRACE_PAD_S = 0.05


def _device_events(fn):
    """fn() and a synchronize under torch.profiler, the host asleep
    TRACE_PAD_S before and after them inside the trace: (the trace's device
    events as the profiler recorded them (kineto_results), not parsed into
    a tree of torch's FunctionEvents, which takes tens of seconds for an
    eager AD step's ~100,000 kernels and their host operators; the wall s
    of fn() and the synchronize)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(TRACE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_PAD_S)
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA], wall


def _timer_child(requests, answers):
    """The device timer's child process: for each request (fn, args,
    kwargs, reps), fn(*args, **kwargs) once, then `reps` times in one
    trace (_device_events); answers the trace's device events as (name,
    ns) pairs, or the error's text. None ends it."""
    while (req := requests.get()) is not None:
        fn, args, kwargs, reps = req
        try:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            kernels = _device_events(lambda: [fn(*args, **kwargs) for _ in range(reps)])[0]
            answers.put([(e.name(), e.duration_ns()) for e in kernels])
        except Exception as e:  # the parent raises it
            answers.put(f"{type(e).__name__}: {e}")
        del req, fn, args, kwargs
        torch.cuda.empty_cache()


_TIMER = []  # the device timer's child process and its two queues, once started


def _device_trace(reps, fn, *args, **kwargs):
    """The device events (name, ns) of `reps` calls fn(*args, **kwargs) in
    one trace, taken in a child process handed the call (the port's
    function and its arguments, CUDA tensors shared through CUDA IPC),
    started at the phase's first read and ended by lap(). Once the first
    AD step is captured into a CUDA graph, every other trace holds no
    device event in this process and in any process whose profiler had
    started before, but not in one started after (PERF.md q7;
    scripts/profiler_window_probe.py --smoke). The child's failure
    raises."""
    if not _TIMER:
        ctx = torch.multiprocessing.get_context("spawn")
        requests, answers = ctx.Queue(), ctx.Queue()
        child = ctx.Process(target=_timer_child, args=(requests, answers), daemon=True)
        child.start()
        _TIMER.extend((child, requests, answers))
    child, requests, answers = _TIMER
    torch.cuda.synchronize()
    requests.put((fn, args, kwargs, reps))
    got = answers.get(timeout=600)
    torch.cuda.ipc_collect()
    if isinstance(got, str):
        raise AssertionError(f"device time in the timer's process: {got}")
    return got


def _stop_timer():
    """End the device timer's child process, if it was started."""
    if _TIMER:
        child, requests, _ = _TIMER
        requests.put(None)
        child.join(timeout=60)
        _TIMER.clear()


def _per_call_ms(events, reps):
    """{kernel name: device ms a call} from a trace of `reps` calls: each
    kernel's mean launch times its launches a call. A trace can lose
    single launches (PERF.md q7: K4 4 of 5, every time), so a sum over
    the trace divided by `reps` would read low."""
    launches = {}
    for name, ns in events:
        launches.setdefault(name, []).append(ns)
    return {name: sum(v) / len(v) * max(round(len(v) / reps), 1) / 1e6
            for name, v in launches.items()}


def _device_ms(name, fn, *args, reps=5, **kwargs):
    """Device time (ms) of the kernels whose name holds `name` in one call
    fn(*args, **kwargs), from `reps` calls in one trace after a warm-up
    (_device_trace, _per_call_ms): the kernel alone, without the wrapper's
    host time that CUDA events around the call hold. A trace without
    such a kernel raises, naming the device events it holds."""
    events = _device_trace(reps, fn, *args, **kwargs)
    found = [ms for n, ms in _per_call_ms(events, reps).items() if name in n]
    if not found:
        raise AssertionError(f"device time: no kernel named {name!r} in the trace (device "
                             f"events: {sorted({n[:80] for n, _ in events})})")
    return sum(found)


def phase_k1_bwd(table, stack, dev, n=1 << 21):
    """Phase 12: K1's backward against K1 and its plain version
    (check_k1_bwd) at 4,194,304 lanes as two halves, on the flagship table
    and on the matpreview's 10-material stack, with lane masks and a
    seeded cotangent, without and with K1's output for the clamp test.
    Times the flagship-table call as the main path makes it (with K1's
    output) into a new gradient; into a given buffer (CUDA events; and the
    kernel's device time); without K1's
    output; the plain version; and the yardstick, torch's index_add_ of
    the same updates into a flat buffer (the scatter part alone: the 24
    (index, addend) pairs a lane, merl_sorted.scatter_pairs, made
    beforehand)."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    gen = torch.Generator(device=dev).manual_seed(12)
    wi, wo, wo_b = (_unit_hemi(gen, n, dev) for _ in range(3))
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    g = torch.randn((2 * n, 3), generator=gen, device=dev)
    slot = torch.randint(0, stack.shape[0], (n,), generator=gen, device=dev)
    errs = []
    for tbl, sl in ((table, None), (stack, slot)):
        lanes = (wi, wo, sl, mask, wo_b, mask_b)
        errs.append(check_k1_bwd(tbl, g, *lanes))
        errs.append(check_k1_bwd(tbl, g, *lanes, value=k1.eval_trilinear(tbl, *lanes)))
    id_err, l2 = (max(e) for e in zip(*errs))
    lanes = (wi, wo, None, mask, wo_b, mask_b)
    value = k1.eval_trilinear(table, *lanes)
    joined = k1.concat_halves(*lanes)
    buf = torch.zeros_like(table)

    def call():
        return k1.eval_trilinear_bwd(table, g, *lanes, value=value)

    def into():
        return k1.eval_trilinear_bwd(table, g, *lanes, value=value, out=buf)

    times = dict(ms=_time_ms(call), ms_into=_time_ms(into),
                 device_ms=_device_ms("merl_eval_bwd", k1.eval_trilinear_bwd, table, g, *lanes,
                                      value=value, out=buf),
                 ms_reading_bins=_time_ms(lambda: k1.eval_trilinear_bwd(table, g, *lanes)),
                 plain_ms=_time_ms(lambda: k1.eval_trilinear_bwd_plain(
                     table, g, *joined, value=value)))
    idx, add = k1.scatter_pairs(table, g, *joined, value=value)
    flat = torch.zeros(table.numel(), device=dev)
    library_ms = _time_ms(lambda: flat.index_add_(0, idx, add))
    bound_ms, bound_by = k1_bwd_bound(table, g, *lanes, value=value)
    into_bound = k1_bwd_bound(table, g, *lanes, value=value, out=buf)[0]
    err = float((call() - k1.eval_trilinear_bwd_plain(table, g, *joined, value=value))
                .abs().max())
    print(f"K1-bwd merl_eval_bwd: {2 * n} lanes (two halves), identity error "
          f"{id_err:.3e} (limit {K1_BWD_ID_RTOL}), relative L2 error against plain "
          f"{l2:.3e} (limit {K1_BWD_L2_RTOL}), max abs err {err:.3e}; with K1's output: "
          f"kernel {times['ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); into a given "
          f"buffer {times['ms_into']:.3f} ms (kernel device time {times['device_ms']:.4f} "
          f"ms), bound {into_bound:.4f} ms; reading the bins {times['ms_reading_bins']:.3f} ms; "
          f"plain {times['plain_ms']:.3f} ms; index_add_ of the {idx.numel()} updates "
          f"{library_ms:.3f} ms")
    return dict(max_abs_err=err, identity_err=id_err, rel_l2_err=l2, bound_ms=bound_ms,
                bound_by=bound_by, into_bound_ms=into_bound, library_ms=library_ms, **times)


def ad_setup(dev, res=256, spp=4, depth=6):
    """The AD slice's scene: matpreview_dict(res, spp, depth) at n_sub 5
    with its 10 MERL tables, the probed compaction schedule, and the
    parameters it differentiates (the table stack and the floor's
    alpha)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import (
        matpreview_dict,
        probe_compact_schedule,
    )

    scene = mt.load_dict(matpreview_dict(res, spp, depth), dev)
    scene, fracs = probe_compact_schedule(scene, spp=4)
    full = traverse(scene)
    return scene, fracs, {k: full[k] for k in AD_KEYS}


def phase_ad_step(setup):
    """Phase 13: one loss-and-gradient step (grad_render's eager step,
    ad._eager_loss_and_grad, whose kernel calls go through the wrappers;
    MSE against a zero image) of the matpreview scene at 256x256, 4 spp, depth 6 with
    the probed schedule, on the table stack and the floor's alpha: one
    warm-up, one timed step with the counts set to 0 just before it (one
    table-gradient buffer allocated), then one recorded step whose K1-bwd
    calls are each checked against the plain version and timed as made
    (into one buffer: CUDA events, and the kernel's device time), and
    whose accumulated table gradient is held to the sum of the calls'
    standalone gradients (relative L2 within K1_BWD_L2_RTOL). Returns
    (launches, (K1-bwd ms, bound ms) of the step: the calls and the one
    buffer's zeroing)."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import ad

    scene, fracs, params = setup
    res = scene.config.width
    dev = scene.device
    target = torch.zeros((res, res, 3), device=dev)
    ad._eager_loss_and_grad(scene, params, target, 4, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, params, target, 4, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
    buffers = k1.GRAD_BUFFERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gt = grads[AD_KEYS[0]]
    nz = float((gt != 0).any(-1).float().mean())
    alpha = [float(grads[k][0]) for k in AD_KEYS[1:]]
    print(f"AD step matpreview {res}x{res} 4spp depth 6 (table {tuple(gt.shape)}, "
          f"floor alpha): {secs:.3f} s, loss {float(loss):.6e}, nonzero table-gradient "
          f"bins {nz:.6f}, d loss / d alpha_u, alpha_v {alpha}, peak memory "
          f"{peak_gb:.2f} GB; launches {launches}; table-gradient buffers {buffers}")
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v).all())
                                                for v in grads.values())
    if not finite or nz <= 0 or launches["K1-bwd"] <= 0 or buffers != 1:
        raise AssertionError(f"AD step: finite {finite}, nonzero share {nz}, launches "
                             f"{launches}, table-gradient buffers {buffers}")
    step = {}
    rec = record_calls(
        lambda: step.update(grads=ad._eager_loss_and_grad(scene, params, target, 4, 2)[1]),
        {"K1-bwd": (k1, "eval_trilinear_bwd", _keep_bwd)})["K1-bwd"]
    if len(rec) != launches["K1-bwd"]:
        raise AssertionError(f"recorded {len(rec)} K1-bwd calls != launches {launches}")
    table = rec[0][0][0]
    buf = torch.zeros_like(table)
    summed = torch.zeros_like(table)
    total = dict(ms=0.0, bound=0.0, device=0.0)
    for i, (args, value) in enumerate(rec):
        id_err, l2 = check_k1_bwd(*args, value=value)
        summed += k1.eval_trilinear_bwd(*args, value=value)

        def into(args=args, value=value):
            return k1.eval_trilinear_bwd(*args, value=value, out=buf)

        ms = _time_ms(into)
        device = _device_ms("merl_eval_bwd", k1.eval_trilinear_bwd, *args, value=value,
                            out=buf)
        bound = k1_bwd_bound(*args, value=value, out=buf)[0]
        live = sum(int(m.sum()) for m in (args[5], args[7]) if m is not None)
        print(f"AD K1-bwd call {i}: {args[2].shape[0]} lanes x 2 halves, {live} live, "
              f"{ms:.4f} ms into the buffer (bound {bound:.4f}); kernel device time "
              f"{device:.4f} ms; identity error {id_err:.2e}, relative L2 error "
              f"against plain {l2:.2e}")
        total["ms"] += ms
        total["bound"] += bound
        total["device"] += device
    zero_ms = _time_ms(lambda: torch.zeros(table.shape, device=dev))
    zero_bound = _nbytes(table) / HBM_BYTES_PER_S * 1e3
    l2 = rel_l2(step["grads"][AD_KEYS[0]], summed)
    print(f"AD step K1-bwd: {len(rec)} calls into one buffer {total['ms']:.4f} ms "
          f"(bound {total['bound']:.4f}; kernel device time {total['device']:.4f} ms), "
          f"its zeroing {zero_ms:.4f} ms (bound {zero_bound:.4f}): {total['ms'] + zero_ms:.4f} "
          f"ms (bound {total['bound'] + zero_bound:.4f}); the step's table gradient "
          f"against the sum of the calls' own gradients: relative L2 error {l2:.2e} "
          f"(limit {K1_BWD_L2_RTOL})")
    if not l2 <= K1_BWD_L2_RTOL:
        raise AssertionError("the step's accumulated table gradient disagrees with its calls' sum")
    return launches, (total["ms"] + zero_ms, total["bound"] + zero_bound)


def phase_ad_cpu(dev, fracs, res=64):
    """Phase 14: the gradient of the matpreview scene at 64x64, 4 spp,
    depth 3 with the probed schedule, on the card and on the CPU (plain
    kernels): losses within AD_LOSS_RTOL, table gradients at cosine
    similarity >= AD_TABLE_COS, alpha gradients within AD_ALPHA_RTOL."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(res, 4, 3, compact=fracs)
    out = {}
    for where in (dev, "cpu"):
        scene = mt.load_dict(d, where)
        full = traverse(scene)
        target = torch.zeros((res, res, 3), device=where)
        loss, grads = ad.grad_render(scene, {k: full[k] for k in AD_KEYS}, target, spp=4)
        out[str(where)] = (float(loss), {k: v.cpu() for k, v in grads.items()})
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    a, b = gg[AD_KEYS[0]].flatten().double(), gc[AD_KEYS[0]].flatten().double()
    cos = float(a @ b / (a.norm() * b.norm()))
    loss_rel = abs(lg - lc) / abs(lc)
    alpha_rel = max(abs(float(gg[k][0]) - float(gc[k][0])) / abs(float(gc[k][0]))
                    for k in AD_KEYS[1:])
    print(f"AD matpreview {res}x{res} 4spp depth 3: loss gpu {lg:.6e} cpu {lc:.6e} (rel {loss_rel:.2e}, "
          f"limit {AD_LOSS_RTOL}); table-gradient cosine {cos:.6f} (limit {AD_TABLE_COS}); "
          f"alpha gradients gpu {[float(gg[k][0]) for k in AD_KEYS[1:]]} cpu "
          f"{[float(gc[k][0]) for k in AD_KEYS[1:]]} (max rel {alpha_rel:.2e}, limit {AD_ALPHA_RTOL})")
    if not (loss_rel <= AD_LOSS_RTOL and cos >= AD_TABLE_COS and alpha_rel <= AD_ALPHA_RTOL):
        raise AssertionError("GPU and CPU gradients disagree")


def phase_alpha_fd(dev, fracs, res=64, spp=64, depth=3, n_seeds=AD_FD_SEEDS, **scene_kw):
    """Phase 14, second part: the floor alpha's gradient by AD against a
    central difference (step AD_FD_STEP) of the same render, on the
    matpreview scene at res x res, spp, depth with the schedule `fracs`,
    at alpha AD_FD_ALPHA (alpha_u and alpha_v moved together), on n_seeds
    seeds. The loss is mean(img * W), W the scene's own image (alpha 0.25,
    64 spp): linear in the image, so a same-sample estimate of its
    gradient carries no variance term, and W weighs the highlight. The
    means within AD_FD_RTOL, or 4 standard errors of the mean paired
    difference. Returns (mean AD, mean central difference, standard
    error)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    scene = mt.load_dict(matpreview_dict(res, spp, depth, compact=fracs, **scene_kw), dev)
    w = mt.render(scene, spp=64, seed=0)
    x0 = torch.full_like(traverse(scene)[AD_KEYS[1]], AD_FD_ALPHA)

    def loss(x, seed):
        img = ad.render_ad(scene, {k: x for k in AD_KEYS[1:]}, spp=spp, seed=seed)
        return (img * w).mean()

    g_ad, g_fd = [], []
    for seed in range(1, n_seeds + 1):
        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x, seed), x)
        with torch.no_grad():
            fd = (loss(x0 + AD_FD_STEP, seed) - loss(x0 - AD_FD_STEP, seed)) / (2 * AD_FD_STEP)
        g_ad.append(float(g.sum()))
        g_fd.append(float(fd))
    m_ad, m_fd = statistics.mean(g_ad), statistics.mean(g_fd)
    se = statistics.stdev(a - f for a, f in zip(g_ad, g_fd)) / n_seeds ** 0.5
    print(f"AD floor alpha {res}x{res} {spp}spp depth {depth} at alpha {AD_FD_ALPHA}, loss "
          f"mean(img * W), {n_seeds} seeds: AD {[f'{x:.6e}' for x in g_ad]}, central "
          f"difference (step {AD_FD_STEP}) {[f'{x:.6e}' for x in g_fd]}; means {m_ad:.6e} "
          f"and {m_fd:.6e} (rel diff {abs(m_ad - m_fd) / abs(m_fd):.3e}, limit {AD_FD_RTOL} "
          f"or 4 x the standard error {se:.3e})")
    if not abs(m_ad - m_fd) <= max(AD_FD_RTOL * abs(m_fd), 4 * se):
        raise AssertionError("the floor alpha's AD gradient disagrees with the central difference")
    return m_ad, m_fd, se


def _material_sums(g):
    return g.sum(dim=tuple(range(1, g.dim()))).double()


def phase_ad_compaction(setup):
    """Phase 15: table gradients at 256x256, 16 spp, depth 6 with the
    probed schedule against compaction off (seed 1), and a second seed
    without compaction for the spread: their correlation, each material's
    summed gradient, and the gate: each material's sums within
    max(AD_COMPACT_RTOL, 3 x that material's two-seed spread)."""
    from mitsuba_customization_tpu_torch.render import ad

    scene, _, params = setup
    res = scene.config.width
    off = dataclasses.replace(scene, config=dataclasses.replace(scene.config, compact=None))
    target = torch.zeros((res, res, 3), device=scene.device)
    table = {AD_KEYS[0]: params[AD_KEYS[0]]}
    g_on = ad.grad_render(scene, table, target, spp=16, seed=1)[1][AD_KEYS[0]]
    g_off = ad.grad_render(off, table, target, spp=16, seed=1)[1][AD_KEYS[0]]
    g_off2 = ad.grad_render(off, table, target, spp=16, seed=2)[1][AD_KEYS[0]]
    nz = (g_on != 0) | (g_off != 0)
    corr = float(torch.corrcoef(torch.stack([g_on[nz], g_off[nz]]).double())[0, 1])
    s_on, s_off, s_off2 = (_material_sums(x) for x in (g_on, g_off, g_off2))
    rel = (s_on - s_off).abs() / s_off.abs()
    spread = (s_off2 - s_off).abs() / s_off.abs()
    limit = torch.clamp(3 * spread, min=AD_COMPACT_RTOL)
    print(f"AD compaction {res}x{res} 16spp depth 6: table-gradient correlation on vs off "
          f"{corr:.6f}; per-material sums on {s_on.tolist()} off {s_off.tolist()}; rel "
          f"diff {rel.tolist()}; two-seed spread off {spread.tolist()}; limits "
          f"{limit.tolist()}")
    if not (bool((rel <= limit).all())
            and all(bool(torch.isfinite(x).all()) for x in (g_on, g_off))):
        raise AssertionError("compacted and uncompacted table gradients disagree")


def phase_optimize(setup, steps=5):
    """Phase 16: `optimize` for five Adam steps on the AD slice's scene
    (256x256, 4 spp, depth 6, the probed schedule), on the table stack and
    the floor's alpha, then on the alpha alone: the target is the scene
    itself (floor alpha 0.25) at 16 spp; the optimiser starts from the
    table as loaded and alpha 0.4. Each key set runs twice: through
    grad_render's captured step, as `optimize` runs (the first step plans,
    warms up and captures it, the others replay), and with grad_render's
    eager step in its place. Each step's seconds, loss and alpha, the
    median of steps 1-4 of each; finite throughout, the table >= 0, the
    first step's loss the eager one's bit for bit (the same parameters,
    the box filter; later steps differ by K1-bwd's atomic order). Returns
    {key set: (captured median s, eager median s)}."""
    from unittest import mock

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render import frame_graph as fg
    from mitsuba_customization_tpu_torch.render.params import update

    def eager(scene, params, target, spp=16, seed=0):
        return ad._eager_loss_and_grad(scene, params, target, spp, seed)

    scene, _, params = setup
    target = mt.render(scene, spp=16, seed=0)
    start = update(scene, {k: torch.full_like(params[k], 0.4) for k in AD_KEYS[1:]})
    out = {}
    for keys, what in ((AD_KEYS, "table and alpha"), (AD_KEYS[1:], "alpha alone")):
        runs = {}
        for how in ("captured", "eager"):
            times = [time.perf_counter()]
            rows = []

            def step_done(it, loss, p):
                torch.cuda.synchronize()
                times.append(time.perf_counter())
                rows.append((it, times[-1] - times[-2], loss, float(p[AD_KEYS[1]][0].detach())))

            with mock.patch.object(ad, "grad_render", eager) if how == "eager" \
                    else contextlib.nullcontext():
                p, losses = ad.optimize(start, target, list(keys), n_steps=steps, lr=OPT_LR,
                                        spp=4, callback=step_done)
            for it, secs, loss, alpha in rows:
                print(f"optimize ({what}, {how} step) step {it}: {secs:.3f} s, loss "
                      f"{loss:.6e}, floor alpha_u {alpha:.5f}")
            ok = (all(torch.isfinite(torch.tensor(losses)))
                  and all(bool(torch.isfinite(v).all()) for v in p.values())
                  and bool((p.get(AD_KEYS[0], torch.zeros(1)) >= 0).all()))
            if not ok:
                raise AssertionError(f"optimize ({what}, {how} step): a loss or parameter is "
                                     "not finite, or the table < 0")
            runs[how] = (losses, statistics.median(r[1] for r in rows[1:]))
        (lc, tc), (le, te) = runs["captured"], runs["eager"]
        rel = [abs(a - b) / abs(b) for a, b in zip(lc, le)]
        print(f"optimize ({what}): steps 1-{steps - 1} median {tc:.4f} s captured against "
              f"{te:.4f} s eager ({te / tc:.2f}x); losses' relative differences {rel}")
        if lc[0] != le[0]:
            raise AssertionError(f"optimize ({what}): the captured step's first loss {lc[0]} "
                                 f"is not the eager step's {le[0]}")
        out[what] = (tc, te)
    fg.clear()
    return out


def _launch_counts():
    from mitsuba_customization_tpu_torch.ops import bsdf_shade, emitter_shade
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    return {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES,
            "K3": cl.LAUNCHES["closest"], "K4": cl.LAUNCHES["shadow"],
            "SH-pre": bsdf_shade.LAUNCHES["pre"], "SH-post": bsdf_shade.LAUNCHES["post"],
            **{k: emitter_shade.LAUNCHES[part] for k, part in EM_PARTS.items()}}


def _reset_counts():
    from mitsuba_customization_tpu_torch.ops import bsdf_shade, emitter_shade
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    from mitsuba_customization_tpu_torch.render import bvh, medium, sdf

    k1.LAUNCHES = 0
    k1.LAUNCHES_BWD = 0
    k1.GRAD_BUFFERS = 0
    k2.LAUNCHES = 0
    cl.LAUNCHES["closest"] = 0
    cl.LAUNCHES["shadow"] = 0
    bsdf_shade.LAUNCHES["pre"] = 0
    bsdf_shade.LAUNCHES["post"] = 0
    for part in emitter_shade.LAUNCHES:
        emitter_shade.LAUNCHES[part] = 0
    bvh.LAUNCHES["closest"] = 0
    bvh.LAUNCHES["any"] = 0
    medium.LAUNCHES["delta"] = 0
    medium.LAUNCHES["ratio"] = 0
    medium.LAUNCHES_BWD["delta"] = 0
    medium.LAUNCHES_BWD["ratio"] = 0
    sdf.LAUNCHES = 0
    medium.LOOPS = sdf.MARCHES = None  # the loops' steps: recorded where a phase asks
    medium.GRID_BUFFERS = 0


def _loop_launches():
    from mitsuba_customization_tpu_torch.render import medium, sdf

    return {"T1": medium.LAUNCHES["delta"], "T2": medium.LAUNCHES["ratio"], "S1": sdf.LAUNCHES}


def _track_bwd_launches():
    from mitsuba_customization_tpu_torch.render import medium

    return {"T1-bwd": medium.LAUNCHES_BWD["delta"], "T2-bwd": medium.LAUNCHES_BWD["ratio"]}


def _record_loops():
    """Record the tracking loops' and the SDF march's steps from here on
    (medium.LOOPS, sdf.MARCHES)."""
    from mitsuba_customization_tpu_torch.render import medium, sdf

    medium.LOOPS, sdf.MARCHES = [], []


def phase_matpreview(dev, res=512, spp=8, depth=8):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import (
        matpreview_dict,
        probe_compact_schedule,
    )

    t0 = time.perf_counter()
    scene = mt.load_dict(matpreview_dict(res, spp, depth), dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    scene, fracs = probe_compact_schedule(scene, spp=4)
    mt.render(scene, spp=spp, seed=0)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=spp, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    rays = stats["rays_traced"]
    print(f"matpreview {res}x{res} {spp}spp depth {depth} ({scene.geometry.p0.shape[0]} "
          f"prims, {scene.clusters.cl_box.shape[0]} clusters, load "
          f"{load_s:.1f} s): {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; schedule "
          f"{[round(f, 4) for f in fracs]}; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the matpreview path: {launches}")
    if img.shape != (res, res, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"matpreview frame is not a finite {res}x{res}x3 image")
    return scene, fracs, launches


def phase_matpreview_cpu(dev, fracs):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(64, 4, 4, compact=fracs)
    gpu = mt.render(mt.load_dict(d, dev), spp=4, seed=0).mean((0, 1)).cpu()
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0).mean((0, 1))
    rel = ((gpu - cpu).abs() / cpu.abs()).max().item()
    print(f"matpreview 64x64 4spp depth 4: gpu means {gpu.tolist()}, cpu means "
          f"{cpu.tolist()}, max rel diff {rel:.2e} (limit {FRAME_MEAN_RTOL})")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError("GPU and CPU matpreview means disagree")


def _gpu_cpu_means(what, d, dev, spp=4, scenes=None):
    """Card against CPU (plain kernels): the per-channel means of d (or of
    `scenes`, the same scene loaded on the card and on the CPU) rendered at
    seed 0 within FRAME_MEAN_RTOL."""
    import mitsuba_customization_tpu_torch as mt

    if scenes is None:
        scenes = (mt.load_dict(d, dev), mt.load_dict(d, "cpu"))
    gpu = mt.render(scenes[0], spp=spp, seed=0).mean((0, 1)).cpu()
    cpu = mt.render(scenes[1], spp=spp, seed=0).mean((0, 1))
    rel = ((gpu - cpu).abs() / cpu.abs()).max().item()
    print(f"{what}: gpu means {gpu.tolist()}, cpu means {cpu.tolist()}, max rel diff "
          f"{rel:.2e} (limit {FRAME_MEAN_RTOL})")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError(f"GPU and CPU {what} means disagree")


def _timed_frame(what, scene, spp, need, loops=False):
    """One warm-up render, then one timed render with the counts set to 0
    just before it (and with `loops` the loops' steps recorded): prints
    seconds, rays/s and launches; `need` names the kernels that must have
    run. Returns the launches of K1-K4 (those of T1, T2 and S1 stay in
    their counts until the next reset)."""
    import mitsuba_customization_tpu_torch as mt

    cfg = scene.config
    mt.render(scene, spp=spp, seed=0)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    if loops:
        _record_loops()
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=spp, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    rays = stats["rays_traced"]
    print(f"{what} {cfg.width}x{cfg.height} {spp}spp depth {cfg.max_depth} "
          f"({cfg.integrator}, {scene.geometry.p0.shape[0]} prims): {secs:.3f} s, "
          f"{rays:.0f} rays, {rays / secs / 1e6:.2f} Mrays/s; launches {launches}, "
          f"{_loop_launches()}")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"a kernel was not launched on the {what} path: {launches}")
    if img.shape != (cfg.height, cfg.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what} frame is not a finite image")
    return launches


def phase_config0(dev, res=512, spp=64):
    """Phase 17: BASELINE configs[0], a sphere with the flagship MERL table
    under a constant emitter, direct illumination (tests/test_golden.py's
    scene) at res x res, spp (eight passes of 2,097,152 lanes at 512, 64):
    seconds, rays/s, K1 and K2 launched; card against CPU means at 64x64."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import config0_dict, flagship_table

    bsdf = {"type": "merl", "table": flagship_table()}
    scene = mt.load_dict(config0_dict(bsdf, res, spp), dev)
    launches = _timed_frame("configs[0]", scene, spp, ("K1", "K2"))
    _gpu_cpu_means("configs[0] 64x64 4spp", config0_dict(bsdf, 64, 4), dev)
    return launches


def phase_materials(dev, res=512, spp=8, depth=8):
    """Phase 18: the materials frame, matpreview_dict(res, spp, depth,
    n_materials=12) with material_bands (merl, conductor, dielectric,
    thindielectric, roughdielectric, plastic, roughplastic, principled,
    twosided merl; a Beckmann floor), the probed schedule: one timed
    render with K1-K4 launched, then a recorded render whose every K1-K4
    call is checked against its plain version and timed (as phase 10);
    card against CPU means at 64x64, 4 spp, depth 4. Returns (launches,
    frame sums)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, probe_compact_schedule

    scene = mt.load_dict(material_bands(matpreview_dict(res, spp, depth, n_materials=12)),
                         dev)
    scene, fracs = probe_compact_schedule(scene, spp=4)
    launches = _timed_frame("materials", scene, spp, ("K1", "K2", "K3", "K4"))
    rec = record_wavefronts(scene, spp, seed=1)
    if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
        raise AssertionError(f"recorded calls {[len(v) for v in rec.values()]} != {launches}")
    frame = phase_bounces(scene, rec)
    del rec
    _gpu_cpu_means("materials 64x64 4spp depth 4", material_bands(
        matpreview_dict(64, 4, 4, n_materials=12, compact=fracs)), dev)
    return launches, frame


# a blended bounce's K1 calls in the JAX package's composition: the child's
# tabulated sample (1 eval), the balance weight's mixture eval (2), and
# eval_pdf toward the NEE direction (2); under AD the attached eval at the
# sampled direction adds 2
K1_PER_BLENDED_BOUNCE = 5
K1_PER_BLENDED_BOUNCE_AD = 7


def phase_blend(dev, res=256, spp=4, depth=6):
    """Phase 19: the blend frame, the materials scene at res x res, spp,
    depth with null, mask (over merl) and blendbsdf (merl, roughplastic)
    bands and the probed schedule: K1 launched with one half, the count
    of the JAX composition (K1_PER_BLENDED_BOUNCE a shading bounce), K2
    not at all (blends take the plain Marginal2D path), K4 on the shadow
    cluster set; every recorded call checked against its plain version and
    timed. Then one eager AD step (ad._eager_loss_and_grad) of the table
    stack: one table-gradient
    buffer, K1-bwd launched; and at 64x64, 4 spp, depth 3 on the card and
    on the CPU: losses within AD_LOSS_RTOL, table gradients at cosine >=
    AD_TABLE_COS (grad_render, captured on the card). Returns (launches of
    the frame, of the AD step, frame sums, (the AD scene, its parameters)
    for phase 34)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, probe_compact_schedule

    def blend_dict(r, s, dep, **kw):
        return material_bands(matpreview_dict(r, s, dep, n_materials=12, **kw), blend=True)

    scene = mt.load_dict(blend_dict(res, spp, depth), dev)
    if scene.shadow_clusters is None or scene.bsdfs.blend_a is None:
        raise AssertionError("the blend scene has no shadow cluster set or no blends")
    scene, fracs = probe_compact_schedule(scene, spp=4)
    launches = _timed_frame("blend", scene, spp, ("K1", "K3", "K4"))
    want_k1 = K1_PER_BLENDED_BOUNCE * (depth - 1)
    print(f"blend frame: K1 launches {launches['K1']}, the JAX composition "
          f"{K1_PER_BLENDED_BOUNCE} a shading bounce x {depth - 1} = {want_k1}; "
          f"K2 launches {launches['K2']}")
    # a scene with blends takes the BSDF stage's plain route (models/bsdf.route)
    if (launches["K1"] != want_k1 or launches["K2"] != 0 or launches["SH-pre"] != 0
            or launches["SH-post"] != 0):
        raise AssertionError(f"blend frame launches {launches}")
    rec = record_wavefronts(scene, spp, seed=1)
    if any(len(args) > 5 and args[5] is not None for args in rec["K1"]):
        raise AssertionError("a blend-frame K1 call has two halves")
    frame = phase_bounces(scene, rec, k1_per_bounce=K1_PER_BLENDED_BOUNCE)
    del rec

    key = AD_KEYS[0]
    target = torch.zeros((res, res, 3), device=dev)
    table = {key: traverse(scene)[key]}
    ad._eager_loss_and_grad(scene, table, target, spp, 1)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, table, target, spp, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ad_launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
    buffers = k1.GRAD_BUFFERS
    g = grads[key]
    print(f"blend AD step {res}x{res} {spp}spp depth {depth} (table {tuple(g.shape)}): "
          f"{secs:.3f} s, loss {float(loss):.6e}, nonzero table-gradient bins "
          f"{float((g != 0).any(-1).float().mean()):.6f}; launches {ad_launches} (K1 "
          f"{K1_PER_BLENDED_BOUNCE_AD} a shading bounce in the forward and again in the "
          f"replay); table-gradient buffers {buffers}")
    if (buffers != 1 or ad_launches["K1-bwd"] <= 0 or not bool(torch.isfinite(loss))
            or not bool(torch.isfinite(g).all()) or not bool((g != 0).any())):
        raise AssertionError(f"blend AD step: launches {ad_launches}, buffers {buffers}")

    d = blend_dict(64, 4, 3, compact=fracs)
    out = {}
    for where in (dev, "cpu"):
        s = mt.load_dict(d, where)
        lo, gr = ad.grad_render(s, {key: traverse(s)[key]},
                                torch.zeros((64, 64, 3), device=where), spp=4)
        out[str(where)] = (float(lo), gr[key].cpu().flatten().double())
    (lg, a), (lc, b) = out[str(dev)], out["cpu"]
    cos = float(a @ b / (a.norm() * b.norm()))
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"blend AD 64x64 4spp depth 3: loss gpu {lg:.6e} cpu {lc:.6e} (rel {loss_rel:.2e}, "
          f"limit {AD_LOSS_RTOL}); table-gradient cosine {cos:.6f} (limit {AD_TABLE_COS})")
    if not (loss_rel <= AD_LOSS_RTOL and cos >= AD_TABLE_COS):
        raise AssertionError("GPU and CPU blend gradients disagree")
    return launches, ad_launches, frame, (scene, table)


# ---------------------------------------------------------------------------
# Phases 20-22: the scene inputs read from images, and the other emitters
# ---------------------------------------------------------------------------

IMAGE_SEED = 8
# under the checkout's ignored build/ directory
IMAGE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_images")
# the image frame's image sizes: the textured band's bitmap, the normal and
# height maps, the volume grid's edge, the envmap (H, W)
BITMAP_RES, NORMAL_RES, VOLUME_RES, ENV_SHAPE = 2048, 1024, 64, (1024, 2048)
IMAGE_AD_KEYS = ("bsdf.tabulated.table", "bsdf.textured_diffuse.images",
                 "emitter.env_image")


def _smooth_field(rng, h, w, waves=6):
    """A smooth seeded field on an (h, w) grid, scaled to [0, 1]: a sum of
    products of sines."""
    import numpy as np

    y = (np.arange(h, dtype=np.float32) + 0.5)[:, None] / h
    x = (np.arange(w, dtype=np.float32) + 0.5)[None, :] / w
    f = np.zeros((h, w), np.float32)
    for _ in range(waves):
        (kx, ky), (px, py) = rng.integers(1, 9, 2), rng.uniform(0, 2 * np.pi, 2)
        f += np.sin(2 * np.pi * kx * x + px) * np.cos(2 * np.pi * ky * y + py)
    return (f - f.min()) / (f.max() - f.min())


def sky_image(rng, h, w):
    """A procedural HDR lat-long sky (h, w, 3): a gradient from a bright
    horizon to a deeper zenith, a little seeded noise, and a sun disc about
    1e3 times brighter than the sky."""
    import numpy as np

    y = (np.arange(h, dtype=np.float32) + 0.5) / h
    zen = np.clip(1.0 - y, 0.0, 1.0)[:, None, None]
    img = 0.05 + 0.25 * zen * np.float32([0.45, 0.6, 1.0]) + 0.08 * (1 - zen) * np.float32(
        [1.0, 0.9, 0.7])
    img = np.broadcast_to(img, (h, w, 3)) + 0.01 * rng.random((h, w, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.where(((yy - 0.28 * h) ** 2 + (xx - 0.35 * w) ** 2 < (0.012 * h) ** 2 + 2)[..., None],
                   np.float32([220.0, 210.0, 190.0]), img)
    return img.astype(np.float32)


def image_files(root):
    """Write the image frame's images, made from IMAGE_SEED with numpy, into
    root: the textured band's BITMAP_RES^2 bitmap and the envmap as EXR, the
    normal map as EXR, the height map as PFM. Returns {name: path}."""
    import os

    import numpy as np

    from mitsuba_customization_tpu_torch.utils import exr

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(IMAGE_SEED)
    paths = {k: os.path.join(root, f) for k, f in (
        ("bitmap", "albedo.exr"), ("normal", "normal.exr"), ("height", "height.pfm"),
        ("env", "sky.exr"))}
    fields = [_smooth_field(rng, BITMAP_RES, BITMAP_RES) for _ in range(3)]
    albedo = 0.1 + 0.8 * np.stack(fields, -1) ** 1.5
    exr.write_exr(paths["bitmap"], albedo + 0.02 * rng.random(albedo.shape, np.float32))
    tilt = [_smooth_field(rng, NORMAL_RES, NORMAL_RES) * 2 - 1 for _ in range(2)]
    n = np.stack([0.35 * tilt[0], 0.35 * tilt[1], np.ones_like(tilt[0])], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    exr.write_exr(paths["normal"], n * 0.5 + 0.5)
    exr.write_pfm(paths["height"], _smooth_field(rng, NORMAL_RES, NORMAL_RES, waves=12))
    exr.write_exr(paths["env"], sky_image(rng, *ENV_SHAPE))
    return paths


def image_bands(d, paths):
    """The image frame's bands on a matpreview_dict(..., n_materials=12)
    dict d, in place, with the images of image_files(): spherical uvs
    (from the vertex directions) on every band; 0-5 MERL (the synthetic
    tables); 6 a diffuse textured by the EXR bitmap, by filename; 7 a
    checkerboard diffuse (uv_scale 8); 8 a mesh_attribute diffuse on seeded
    vertex_colors; 9 a normalmap (the EXR normal map) over MERL; 10 a
    bumpmap (the PFM height map, scale 0.02) over roughplastic; 11 a
    volume-textured diffuse on a seeded VOLUME_RES^3 RGB grid over the
    blob's box. The constant sky becomes the EXR envmap under a to_world
    rotation; the area light stays and a spot joins it. Returns d."""
    import numpy as np

    from mitsuba_customization_tpu_torch.render.sensors import look_at

    v = np.asarray(d["blob_0"]["vertices"], np.float32)
    r = np.linalg.norm(v, axis=-1)
    uv = np.stack([np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 1] / r, -1.0, 1.0)) / np.pi], -1).astype(np.float32)
    rng = np.random.default_rng(IMAGE_SEED + 1)
    for i in range(12):
        d[f"blob_{i}"]["uvs"] = uv
    d["blob_8"]["vertex_colors"] = (0.1 + 0.8 * rng.random((len(v), 3))).astype(np.float32)
    grid = (0.1 + 0.8 * rng.random((VOLUME_RES,) * 3 + (3,))).astype(np.float32)
    bands = {
        6: {"type": "diffuse", "reflectance": {"type": "bitmap", "filename": paths["bitmap"]}},
        7: {"type": "diffuse", "reflectance": {"type": "checkerboard", "uv_scale": [8, 8],
                                               "color0": [0.8, 0.75, 0.7],
                                               "color1": [0.15, 0.2, 0.3]}},
        8: {"type": "diffuse", "reflectance": {"type": "mesh_attribute",
                                               "name": "vertex_color"}},
        9: {"type": "normalmap", "normalmap": {"filename": paths["normal"]},
            "bsdf": d["blob_9"]["bsdf"]},
        10: {"type": "bumpmap", "bumpmap": {"filename": paths["height"]}, "scale": 0.02,
             "bsdf": {"type": "roughplastic", "alpha": 0.2}},
        11: {"type": "diffuse", "reflectance": {
            "type": "volume", "grid": grid,
            "to_world": {"scale": 2.6, "translate": [-1.3, -1.3, -1.3]}}},
    }
    for i, b in bands.items():
        d[f"blob_{i}"]["bsdf"] = b
    d["sky"] = {"type": "envmap", "filename": paths["env"], "scale": 1.0,
                "to_world": {"rotate": {"axis": [0, 1, 0], "angle": 60}}}
    d["spot"] = {"type": "spot", "intensity": [40.0, 38.0, 34.0], "cutoff_angle": 25,
                 "beam_width": 18, "to_world": look_at([-2.5, 3.0, -2.0], [0, 0, 0], [0, 1, 0])}
    return d


def projector_bitmap():
    """The emitters frame's projector image: 8x8, left half red, right half
    blue (the JAX package's tests/test_plugins4.py pattern)."""
    import numpy as np

    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0
    tex[:, 4:, 2] = 1.0
    return tex


def emitters_dict(res=512, spp=16, depth=4):
    """The emitters frame: a diffuse floor and one MERL sphere lit by one
    emitter of each delta type: point, spot, directional, a
    directionalarea rectangle and a projector of projector_bitmap()."""
    from mitsuba_customization_tpu_torch.render.sensors import look_at
    from mitsuba_customization_tpu_torch.scenes import synthetic_merl_table

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": look_at([0, 2.5, -5], [0, 0.5, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.7] * 3},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 6.0}},
        "ball": {"type": "sphere", "center": [0, 0.8, 0], "radius": 0.8,
                 "bsdf": {"type": "merl", "table": synthetic_merl_table(0.1, [0.9, 0.6, 0.3])}},
        "point": {"type": "point", "position": [1.5, 3.0, -1.0], "intensity": [15.0] * 3},
        "spot": {"type": "spot", "intensity": [30.0, 28.0, 25.0], "cutoff_angle": 30,
                 "beam_width": 20, "to_world": look_at([-2.0, 3.0, -1.0], [0, 0, 0], [0, 1, 0])},
        "sun": {"type": "directional", "direction": [0.3, -1.0, 0.4], "irradiance": [0.5] * 3},
        "panel": {"type": "rectangle", "to_world": {
            "rotate": {"axis": [1, 0, 0], "angle": 90}, "scale": 0.6,
            "translate": [2.0, 3.5, 2.0]},
            "emitter": {"type": "directionalarea", "radiance": [2.0] * 3}},
        "beam": {"type": "projector", "fov": 30, "bitmap": projector_bitmap(), "scale": 30.0,
                 "to_world": look_at([0, 4.0, -2.0], [0, 0, 0.5], [0, 0, 1])},
    }


def _image_scene(dev, paths, res, spp, depth, **kw):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    return mt.load_dict(image_bands(matpreview_dict(res, spp, depth, n_materials=12, **kw),
                                    paths), dev)


def phase_image(dev, paths, res=512, spp=8, depth=8):
    """Phase 20: the image frame, matpreview_dict(res, spp, depth,
    n_materials=12) with image_bands (textures, normal and bump maps, the
    envmap, a spot) and the probed schedule: load seconds (the EXR and PFM
    reads included), one timed render with K1-K4 launched, then a recorded
    render whose every K1-K4 call is checked against its plain version and
    timed (as phase 10; the envmap's shadow rays run with maxt =
    _SHADOW_INF); card against CPU means at 64x64, 4 spp, depth 4.
    Returns (launches, frame sums)."""
    from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
    from mitsuba_customization_tpu_torch.scenes import probe_compact_schedule

    t0 = time.perf_counter()
    scene = _image_scene(dev, paths, res, spp, depth)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    st = scene.bsdfs.stacks[bsdf_mod.TEXTURED_DIFFUSE]
    em = scene.emitters
    print(f"image frame load: {load_s:.1f} s; texture stack {tuple(st.images.shape)}, "
          f"volume {tuple(st.vol_grid.shape)}, mesh attributes {tuple(st.attr.shape)}, normal "
          f"maps {tuple(scene.bsdfs.normal_tex.images.shape)}, envmap "
          f"{tuple(em.env_image.shape)}, emitter types {sorted(em.present)}")
    if em.env_index < 0 or st.attr is None or st.vol_grid is None:
        raise AssertionError("the image frame lacks its envmap or a texture type")
    scene, fracs = probe_compact_schedule(scene, spp=4)
    launches = _timed_frame("image", scene, spp, ("K1", "K2", "K3", "K4"))
    rec = record_wavefronts(scene, spp, seed=1)
    if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
        raise AssertionError(f"recorded calls {[len(v) for v in rec.values()]} != {launches}")
    inf_rays = sum(int((r.maxt >= 1e29).sum()) for r in rec["K4"])
    print(f"image frame: {inf_rays} recorded shadow rays with maxt = _SHADOW_INF (envmap)")
    if inf_rays <= 0:
        raise AssertionError("no shadow ray toward the envmap was recorded")
    frame = phase_bounces(scene, rec)
    del rec, scene
    _gpu_cpu_means("image 64x64 4spp depth 4", None, dev, scenes=[
        _image_scene(where, paths, 64, 4, 4, compact=fracs) for where in (dev, "cpu")])
    return launches, frame


def _check_expectations(dev):
    """The JAX package's emitter tests' expectations, as numbers on the
    card: the point light's inverse square under it
    (tests/test_render.py::test_point_light_inverse_square), the
    directionalarea footprint and the projector's left-red / right-blue
    pattern (tests/test_plugins4.py)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.sensors import look_at

    def floor_scene(emitters, res, cam, fov, scale, refl):
        return mt.load_dict({
            "type": "scene", "integrator": {"type": "path", "max_depth": 2},
            "sensor": {"type": "perspective", "fov": fov, "to_world": cam,
                       "film": {"width": res, "height": res},
                       "sampler": {"type": "independent", "sample_count": 16}},
            "floor": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": refl},
                      "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90},
                                   "scale": scale}},
            **emitters}, dev)

    side = look_at([0, 3.9, -2.6], [0, 0, 0], [0, 1, 0])
    img = mt.render(floor_scene(
        {"light": {"type": "point", "position": [0, 3, 0], "intensity": [10, 10, 10]}}, 32,
        look_at([0, 2, -4], [0, 0, 0], [0, 1, 0]), 40, 10.0, [1.0] * 3), 16, 0).cpu()
    point, point_want = float(img[16:20, 14:18].mean()), 10 / (torch.pi * 9)
    img = mt.render(floor_scene({"panel": {
        "type": "rectangle", "emitter": {"type": "directionalarea", "radiance": [4.0] * 3},
        "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90}, "translate": [0, 2.0, 0]}}},
        24, side, 60, 6.0, [0.8] * 3), 32, 0).cpu()
    da, da_corner, da_want = float(img[12, 12, 0]), float(img[1, 1, 0]), 0.8 / torch.pi * 4.0
    img = mt.render(floor_scene({"beam": {
        "type": "projector", "fov": 30, "bitmap": projector_bitmap(), "scale": 40.0,
        "to_world": look_at([0, 3.0, 0], [0, 0, 0], [0, 0, 1])}}, 24, side, 60, 6.0,
        [0.8] * 3), 32, 0).cpu()
    left, right, corner = img[12, 10], img[12, 14], float(img[1, 1].max())
    print(f"emitter expectations on the card: point light under it {point:.5f} (JAX test "
          f"{point_want:.5f}, 10 %); directionalarea footprint {da:.5f} (JAX test "
          f"{da_want:.5f}, 15 %), outside {da_corner:.2e}; projector left {left.tolist()}, "
          f"right {right.tolist()}, corner {corner:.2e}")
    if not (abs(point - point_want) < 0.1 * point_want and abs(da - da_want) < 0.15 * da_want
            and da_corner < 0.02 * da_want and left[0] > 5 * max(float(left[2]), 1e-6)
            and right[2] > 5 * max(float(right[0]), 1e-6)
            and corner < 0.05 * max(float(left[0]), float(right[2]))):
        raise AssertionError("an emitter expectation of the JAX tests fails on the card")


def phase_emitters(dev, res=512, spp=16, depth=4):
    """Phase 21: the emitters frame (emitters_dict: point, spot,
    directional, directionalarea and projector over a MERL sphere) at res
    x res, spp, depth: seconds, K1 and K2 launched (brute-force
    intersection, no K3 / K4); card against CPU means at 64x64; and the
    JAX tests' expectations on the card. Returns the launches."""
    import mitsuba_customization_tpu_torch as mt

    scene = mt.load_dict(emitters_dict(res, spp, depth), dev)
    if scene.emitters.present != {3, 4, 5, 6, 7}:
        raise AssertionError(f"emitter types {scene.emitters.present}")
    launches = _timed_frame("emitters", scene, spp, ("K1", "K2"))
    _gpu_cpu_means("emitters 64x64 4spp depth 4", emitters_dict(64, 4, depth), dev)
    _check_expectations(dev)
    return launches


def phase_image_ad(dev, paths, res=256, spp=4, depth=6):
    """Phase 22: one eager AD step (ad._eager_loss_and_grad, grad_render's
    eager form, whose kernel calls the wrappers count; MSE against a zero
    image) of the image
    frame at res x res, spp, depth with its probed schedule, on the table
    stack, the texture stack's images and the envmap's image: one warm-up,
    one timed step (seconds, peak memory, table-gradient buffers, K1-bwd
    launched, the nonzero share of each gradient); then at 64x64, 4 spp,
    depth 3 card against CPU: losses within AD_LOSS_RTOL, each gradient at
    cosine >= AD_TABLE_COS (grad_render, captured on the card). Returns
    the step's launches and (the scene, its parameters) for phase 34."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import probe_compact_schedule

    scene, fracs = probe_compact_schedule(_image_scene(dev, paths, res, spp, depth), spp=4)
    full = traverse(scene)
    params = {k: full[k] for k in IMAGE_AD_KEYS}
    target = torch.zeros((res, res, 3), device=dev)
    ad._eager_loss_and_grad(scene, params, target, spp, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, params, target, spp, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
    buffers = k1.GRAD_BUFFERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nonzero = {k: float((g != 0).any(-1).float().mean()) for k, g in grads.items()}
    print(f"image AD step {res}x{res} {spp}spp depth {depth}: {secs:.3f} s, loss "
          f"{float(loss):.6e}, peak memory {peak_gb:.2f} GB, table-gradient buffers "
          f"{buffers}, launches {launches}; nonzero share of each gradient {nonzero}")
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values())
    if (not finite or buffers != 1 or launches["K1-bwd"] <= 0
            or min(nonzero.values()) <= 0):
        raise AssertionError(f"image AD step: finite {finite}, buffers {buffers}, "
                             f"launches {launches}, nonzero {nonzero}")
    out = {}
    for where in (dev, "cpu"):
        s = _image_scene(where, paths, 64, 4, 3, compact=fracs)
        full = traverse(s)
        lo, gr = ad.grad_render(s, {k: full[k] for k in IMAGE_AD_KEYS},
                                torch.zeros((64, 64, 3), device=where), spp=4)
        out[str(where)] = (float(lo), {k: g.cpu().flatten().double() for k, g in gr.items()})
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    cos = {k: float(gg[k] @ gc[k] / (gg[k].norm() * gc[k].norm())) for k in IMAGE_AD_KEYS}
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"image AD 64x64 4spp depth 3: loss gpu {lg:.6e} cpu {lc:.6e} (rel {loss_rel:.2e}, "
          f"limit {AD_LOSS_RTOL}); gradient cosines {cos} (limit {AD_TABLE_COS})")
    if not (loss_rel <= AD_LOSS_RTOL and min(cos.values()) >= AD_TABLE_COS):
        raise AssertionError("GPU and CPU image-frame gradients disagree")
    return launches, (scene, params)


# ---------------------------------------------------------------------------
# Phases 23-25: sensors, samplers, film filters and the shapes from files
# ---------------------------------------------------------------------------

SHAPES_SEED = 9
# under the checkout's ignored build/ directory
SHAPES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_shapes")
# the shapes frame's mesh sizes (icosphere subdivisions: 327,680, 81,920
# and 20,480 triangles) and its SDF grid's edge
SHAPES_N_SUB, SDF_RES = (7, 6, 5), 128
# the expectations of the JAX package's sensor and SDF tests
METER_RTOL = {"radiancemeter": (0.5, 0.05), "irradiancemeter": (torch.pi, 0.02)}
BATCH_STRIP_ATOL, SDF_MEAN_ATOL, SDF_MAE = 0.05, 0.02, 0.03


def _ad_step(what, scene, res, spp, depth, key=AD_KEYS[0]):
    """One warm-up and one timed eager AD step (ad._eager_loss_and_grad,
    grad_render's eager form, whose kernel calls the wrappers count; MSE
    against a zero image)
    of `scene` on the parameter `key`, the counts set to 0 just before
    it: prints seconds, loss, peak memory, table-gradient buffers and
    launches; one buffer, K1-bwd launched, finite and nonzero. Returns the
    launches."""
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse

    params = {key: traverse(scene)[key]}
    target = torch.zeros((res, res, 3), device=scene.device)
    ad._eager_loss_and_grad(scene, params, target, spp, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, params, target, spp, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
    buffers = k1.GRAD_BUFFERS
    g = grads[key]
    print(f"{what} AD step {res}x{res} {spp}spp depth {depth}: {secs:.3f} s, loss "
          f"{float(loss):.6e}, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"nonzero table-gradient bins {float((g != 0).any(-1).float().mean()):.6f}, "
          f"table-gradient buffers {buffers}, launches {launches}")
    if (buffers != 1 or launches["K1-bwd"] <= 0 or not bool(torch.isfinite(loss))
            or not bool(torch.isfinite(g).all()) or not bool((g != 0).any())):
        raise AssertionError(f"{what} AD step: launches {launches}, buffers {buffers}")
    return launches


def _ad_gpu_cpu(what, d, dev, res=64, key=AD_KEYS[0]):
    """ad.grad_render of d (res x res, 4 spp) on the card and on the CPU:
    losses within AD_LOSS_RTOL, gradients at cosine >= AD_TABLE_COS."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse

    out = {}
    for where in (dev, "cpu"):
        sc = mt.load_dict(d, where)
        lo, gr = ad.grad_render(sc, {key: traverse(sc)[key]},
                                torch.zeros((res, res, 3), device=where), spp=4)
        out[str(where)] = (float(lo), gr[key].cpu().flatten().double())
    (lg, a), (lc, b) = out[str(dev)], out["cpu"]
    cos = float(a @ b / (a.norm() * b.norm()))
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"{what}: loss gpu {lg:.6e} cpu {lc:.6e} (rel {loss_rel:.2e}, limit "
          f"{AD_LOSS_RTOL}); gradient cosine {cos:.6f} (limit {AD_TABLE_COS})")
    if not (loss_rel <= AD_LOSS_RTOL and cos >= AD_TABLE_COS):
        raise AssertionError(f"GPU and CPU {what} gradients disagree")


def phase_camera(dev, res=512, spp=8, depth=8, ad_res=256, cmp_res=64):
    """Phase 23: the camera frame, scenes.camera_dict(res, spp, depth): the
    matpreview scene through a thin lens (aperture 0.05, focused on the
    blob's centre), multijitter (a 2x4 grid at 8 spp) and the gaussian
    filter, res x res x spp lanes in one pass, the probed schedule:
    seconds, rays/s, K1-K4 launched; every K1-K4 call of one more render
    recorded, checked against its plain version and timed (as phase 10);
    card against CPU means at 64x64, 4 spp, depth 4. Then one eager AD
    step (_ad_step) of the table stack at 256x256, 4 spp, depth 6 (one
    buffer, K1-bwd launched, seconds and peak memory) and at 64x64, 4 spp,
    depth 3 card against CPU losses and gradients (grad_render, captured
    on the card). Returns (launches of the frame, of the AD step, frame
    sums, (the AD scene, its parameters) for phase 34)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import sensors
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import camera_dict, probe_compact_schedule

    scene = mt.load_dict(camera_dict(res, spp, depth), dev)
    cfg = scene.config
    if (int(scene.sensor.sensor_type) != sensors.THINLENS or cfg.sampler != "multijitter"
            or cfg.rfilter != "gaussian"):
        raise AssertionError(f"camera frame: sensor {int(scene.sensor.sensor_type)}, "
                             f"sampler {cfg.sampler}, filter {cfg.rfilter}")
    scene, fracs = probe_compact_schedule(scene, spp=4)
    launches = _timed_frame("camera", scene, spp, ("K1", "K2", "K3", "K4"))
    rec = record_wavefronts(scene, spp, seed=1)
    if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
        raise AssertionError(f"recorded calls {[len(v) for v in rec.values()]} != {launches}")
    frame = phase_bounces(scene, rec)
    del rec, scene
    _gpu_cpu_means(f"camera {cmp_res}x{cmp_res} 4spp depth 4",
                   camera_dict(cmp_res, 4, 4, compact=fracs), dev)

    ad_scene, ad_fracs = probe_compact_schedule(
        mt.load_dict(camera_dict(ad_res, 4, 6), dev), spp=4)
    ad_launches = _ad_step("camera", ad_scene, ad_res, 4, 6)
    _ad_gpu_cpu(f"camera AD {cmp_res}x{cmp_res} 4spp depth 3",
                camera_dict(cmp_res, 4, 3, compact=ad_fracs), dev, cmp_res)
    key = AD_KEYS[0]
    return launches, ad_launches, frame, (ad_scene, {key: traverse(ad_scene)[key]})


def phase_shapes(dev, res=512, spp=8, depth=8, cmp_res=64, n_sub=SHAPES_N_SUB,
                 sdf_res=SDF_RES):
    """Phase 24: the shapes frame, scenes.shapes_dict on the files
    scenes.shape_files writes from seed SHAPES_SEED (a 327,680-triangle
    binary PLY, an 81,920-triangle OBJ, a serialized pair of 20,480-
    triangle meshes, a 20,480-triangle shapegroup instanced 4 times, a
    cube, a disk, three cylinders and a sphere: about 532,500 prims in one
    cluster set) at res x res, spp, depth with the probed schedule: file,
    load (reads and cluster build) and frame seconds, rays/s, K1-K4
    launched; every K3 / K4 call of one more render recorded and checked
    against its plain version on its first 262,144 lanes (the plain
    version takes seconds for that many), with sphere and cylinder hits
    among the checked lanes, and timed; card against CPU means at 64x64. Then the same frame
    with a SDF_RES^3 SDF sphere in place of the PLY blob: seconds, S1's
    launches and the march's steps (no host check); every S1 call of one
    more render checked against march_plain and timed (phase_loop_calls);
    card against CPU means at 64x64, and the JAX SDF test's expectation on
    the card. Returns (launches, frame sums, launches with the SDF (S1
    too), (S1's first call's stats, its frame sums), the SDF scene)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import geometry as geo
    from mitsuba_customization_tpu_torch.render import sdf
    from mitsuba_customization_tpu_torch.scenes import (
        probe_compact_schedule,
        sdf_and_analytic_spheres,
        shape_files,
        shapes_dict,
    )

    t0 = time.perf_counter()
    paths = shape_files(SHAPES_DIR, SHAPES_SEED, n_sub)
    files_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = mt.load_dict(shapes_dict(paths, res, spp, depth), dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_prims = scene.geometry.p0.shape[0]
    types = torch.bincount(scene.geometry.prim_type, minlength=3).tolist()
    print(f"shapes frame: files written in {files_s:.1f} s ({sorted(paths)}), loaded in "
          f"{load_s:.1f} s (reads and cluster build): {n_prims} prims (triangles, spheres, "
          f"cylinders {types}), {scene.clusters.cl_box.shape[0]} clusters, intersector "
          f"{scene.config.intersector}")
    if scene.config.intersector != "cluster" or types[1] < 1 or types[2] < 3:
        raise AssertionError("the shapes frame lacks its cluster set, sphere or cylinders")
    scene, fracs = probe_compact_schedule(scene, spp=4)
    launches = _timed_frame("shapes", scene, spp, ("K1", "K2", "K3", "K4"))
    rec = record_wavefronts(scene, spp, seed=1)
    if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
        raise AssertionError(f"recorded calls {[len(v) for v in rec.values()]} != {launches}")
    hit_types = {}
    frame = phase_bounces(scene, rec, hit_types=hit_types)
    del rec, scene
    sph, cyl = hit_types.get(geo.SPHERE, 0), hit_types.get(geo.CYLINDER, 0)
    print(f"shapes frame: checked K3 hits by type {hit_types} (sphere {sph}, cylinder {cyl})")
    if sph <= 0 or cyl <= 0:
        raise AssertionError("no checked K3 lane hit a sphere or a cylinder")
    _gpu_cpu_means(f"shapes {cmp_res}x{cmp_res} 4spp depth 4",
                   shapes_dict(paths, cmp_res, 4, 4, compact=fracs), dev)

    sdf_scene, sdf_fracs = probe_compact_schedule(
        mt.load_dict(shapes_dict(paths, res, spp, depth, sdf_res=sdf_res), dev), spp=4)
    sdf_launches = _timed_frame("shapes with SDF", sdf_scene, spp, ("K1", "K2", "K3", "K4"),
                                loops=True)
    s1 = _loop_launches()["S1"]
    marches = sdf.MARCHES
    checks = sum(c for _, c in marches)
    print(f"shapes with SDF: {sdf_scene.geometry.p0.shape[0]} prims and a "
          f"{tuple(sdf_scene.sdf.values.shape)} grid ({sdf_scene.sdf.values.numel() * 4 / 1e6:.1f}"
          f" MB, S1's corner layout {sdf_scene.sdf.corners.numel() * 4 / 1e6:.1f} MB more); the "
          f"timed frame marched {len(marches)} times ({s1} S1 launches): the slowest "
          f"lanes {sum(int(st.max()) for st, _ in marches)} steps in all (at most "
          f"{sdf.MAX_STEPS} a march), every lane {sum(int(st.sum()) for st, _ in marches)}; "
          f"{checks} host checks")
    if s1 <= 0 or s1 != len(marches) or (checks and torch.device(dev).type == "cuda"):
        raise AssertionError(f"the SDF frame's march: {s1} S1 launches, {len(marches)} "
                             f"marches, {checks} host checks")
    sdf_launches = dict(sdf_launches, S1=s1)
    rec = record_calls(lambda: mt.render(sdf_scene, spp=spp, seed=1),
                       {"S1": (sdf, "march", lambda args, kwargs: _keep_args(args))})
    if len(rec["S1"]) != s1:
        raise AssertionError(f"recorded S1 calls {len(rec['S1'])} != launches {s1}")
    s1_first, s1_frame = phase_loop_calls(rec, "SDF march")
    del rec
    _gpu_cpu_means(f"shapes with SDF {cmp_res}x{cmp_res} 4spp depth 4",
                   shapes_dict(paths, cmp_res, 4, 4, compact=sdf_fracs, sdf_res=sdf_res), dev)
    img_sdf, img_ref = (x.cpu() for x in sdf_and_analytic_spheres(dev))
    mean_d = abs(float(img_sdf.mean()) - float(img_ref.mean()))
    mae = float((img_sdf - img_ref).abs().mean())
    print(f"SDF sphere against the analytic sphere on the card (tests/test_sdf.py): means "
          f"{float(img_sdf.mean()):.5f} / {float(img_ref.mean()):.5f} (diff {mean_d:.5f}, "
          f"limit {SDF_MEAN_ATOL}), mean abs diff {mae:.5f} (limit {SDF_MAE})")
    if not (bool(torch.isfinite(img_sdf).all()) and mean_d < SDF_MEAN_ATOL and mae < SDF_MAE):
        raise AssertionError("the SDF sphere does not render like the analytic sphere")
    return launches, frame, sdf_launches, (s1_first["S1"], s1_frame["S1"]), sdf_scene


def phase_variants(dev):
    """Phase 25: the flagship frame at 64x64, 4 spp, depth 4
    (scenes.variant_dict) with each of the six samplers (orthogonal at 9
    spp, a 3x3 array), each of the five splat filters, and the
    orthographic, distant and a two-child batch sensor: card against CPU
    means within FRAME_MEAN_RTOL; then the JAX tests' expectations on the
    card: the radiancemeter's 0.5 and the irradiancemeter's pi
    (METER_RTOL) and the batch strips against two half-width renders
    (BATCH_STRIP_ATOL)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.core.sampler import SAMPLERS
    from mitsuba_customization_tpu_torch.render.film import FILTER_NAMES
    from mitsuba_customization_tpu_torch.render.sensors import look_at
    from mitsuba_customization_tpu_torch.scenes import batch_strip_means, meter_dict, variant_dict

    for name in SAMPLERS:
        spp = 9 if name == "orthogonal" else 4
        _gpu_cpu_means(f"sampler {name} 64x64 {spp}spp", variant_dict(64, spp, sampler=name),
                       dev, spp=spp)
    for name in FILTER_NAMES:
        if name != "box":
            _gpu_cpu_means(f"filter {name} 64x64 4spp", variant_dict(rfilter=name), dev)
    cam = look_at([0, 1.5, -4], [0, 0, 0], [0, 1, 0])
    for name, sensor in (
            ("orthographic", {"type": "orthographic", "ortho_scale": 2.5}),
            ("distant", {"type": "distant", "ortho_scale": 2.5}),
            ("batch", {"type": "batch",
                       "a": {"type": "perspective", "fov": 45, "to_world": cam},
                       "b": {"type": "thinlens", "fov": 40, "aperture_radius": 0.05,
                             "focus_distance": 4.0,
                             "to_world": look_at([-1, 1.2, -4], [0, 0, 0], [0, 1, 0])}})):
        _gpu_cpu_means(f"sensor {name} 64x64 4spp", variant_dict(sensor=sensor), dev)
    got = {}
    for kind, (want, rtol) in METER_RTOL.items():
        scene = mt.load_dict(meter_dict(kind), dev)
        got[kind] = mt.render(scene, spp=scene.config.spp, seed=0)[0, 0].cpu()
        if not bool(((got[kind] - want).abs() <= rtol * want).all()):
            raise AssertionError(f"{kind} reads {got[kind].tolist()}, not {want} within {rtol}")
    strips, halves = batch_strip_means(dev)
    print(f"sensor expectations on the card: radiancemeter {got['radiancemeter'].tolist()} "
          f"(0.5, 5 %), irradiancemeter {got['irradiancemeter'].tolist()} (pi, 2 %); batch "
          f"strips {strips} against half-width renders {halves} (within {BATCH_STRIP_ATOL})")
    if max(abs(a - b) for a, b in zip(strips, halves)) >= BATCH_STRIP_ATOL:
        raise AssertionError("the batch sensor's strips differ from the half-width renders")


# ---------------------------------------------------------------------------
# Phases 26-28: participating media, the light and bidirectional tracers
# ---------------------------------------------------------------------------

VOLPATH_SEED, VOLPATH_GRID = 10, 256
MEDIUM_KEYS = ("medium.sigma_t", "medium.albedo", "medium.phase_g", "medium.density")
# the homogeneous extinction's AD gradient against a central difference
# (step SIGMA_FD_STEP on its scale) of the same render over SIGMA_FD_SEEDS
# seeds: the JAX test's absorbing fog ball, loss its centre's 2x2 mean
SIGMA_FD_STEP, SIGMA_FD_SEEDS, SIGMA_FD_RTOL = 0.05, 10, 0.05


# T1 / T2 / S1, the per-lane loops (no Pallas kernel: the JAX package's
# tracking loops and SDF march are XLA while_loops). Their operations a
# step, counted from the kernels' source: T1 two lowbias32 draws (13
# integer operations and 2 for the float each), the free flight (the
# clamp, log1pf at ~20, a division and an addition), the point (6), the
# world-to-grid affine (18), the cell (floors, clamps, fractions and the
# index: ~30), seven lerps (28), the extinction, the mean and p_real (9)
# and the weight update (9); T2 one draw, no mean, three ratio factors
# (12); S1 the point (6), the cell (~24), seven lerps (28) and the step
# (4).
T1_STEP_OPS, T2_STEP_OPS, S1_STEP_OPS = 150, 130, 60
# their bytes: every lane's medium id (T1 / T2) or active flag and t_start
# (S1) and outputs (T1 t, weight, flag, steps: 21; T2 weight, steps: 16;
# S1 t, hit, steps: 9); a tracked or active lane's o and d (24) and its
# segment end and key (T1 / T2: 12) or t_end and d_norm (S1: 8); each grid
# cell some lane's lookup read (4), once
LOOP_OUT_BYTES = {"T1": 21, "T2": 16, "S1": 9}
# T1-bwd / T2-bwd: a replayed step's operations are the forward step's;
# the reverse sweep's a step: the factor again, its cotangent and the
# extinction's and density's gradients (~25), the eight corner weights
# and their atomic adds (~24), the trilinear gradient in the point (~45)
T_BWD_SWEEP_OPS = 95
# T1-bwd / T2-bwd against track_bwd_plain and autograd through _scan on
# the card: each gradient within this relative L2 error (atomic order)
TRACK_BWD_RTOL = 1e-4
# the standing gate (ROADMAP §3) for a loop against its plain version on
# the card: flags and steps equal on >= LOOP_AGREE of lanes, values within
# LOOP_RTOL / LOOP_ATOL where they agree (tests/test_torch_cuda.py holds
# them bit for bit)
LOOP_AGREE, LOOP_RTOL, LOOP_ATOL = 0.999, 1e-4, 1e-6


def _marking(mod, name, mark):
    """A context that wraps mod.name so that each call first runs
    mark(*args)."""
    orig = getattr(mod, name)

    def wrapped(*args):
        mark(*args)
        return orig(*args)

    @contextlib.contextmanager
    def ctx():
        setattr(mod, name, wrapped)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    return ctx()


def _check_loop(kind, got, want, flags):
    """A loop's outputs `got` against its plain version's `want` (tuples of
    tensors, the steps last; `flags`: the indices of the bool outputs):
    steps and flags equal on >= LOOP_AGREE of lanes, the values within
    LOOP_RTOL / LOOP_ATOL where all of those agree. Returns (max abs error
    of the values where they agree, lanes not bit-equal)."""
    n = got[0].shape[0]
    agree = torch.ones(n, dtype=torch.bool, device=got[0].device)
    differ = torch.zeros_like(agree)
    for i, (a, b) in enumerate(zip(got, want)):
        same = (a == b).reshape(n, -1).all(-1)
        differ |= ~same
        if i in flags or i == len(got) - 1:
            agree &= same
    share = float(agree.float().mean())
    if share < LOOP_AGREE:
        raise AssertionError(f"{kind}: flags and steps agree with the plain version on {share:.5f}"
                             " of lanes")
    err = 0.0
    for i, (a, b) in enumerate(zip(got[:-1], want[:-1])):
        if i not in flags:
            err = max(err, _check_close(f"{kind}[{i}]", a[agree], b[agree], LOOP_RTOL, LOOP_ATOL))
    return err, int(differ.sum())


def loop_bound(kind, lanes, steps, cells, lane_in_bytes):
    """A T1 / T2 / S1 call's bound: `lanes` every lane's inputs and outputs,
    the tracked (steps > 0) lanes' rays, `cells` grid cells read once;
    operations a step from its own step count."""
    n = steps.shape[0]
    live = int((steps > 0).sum())
    nbytes = n * (lanes + LOOP_OUT_BYTES[kind]) + live * lane_in_bytes + cells * 4
    ops = int(steps.sum()) * {"T1": T1_STEP_OPS, "T2": T2_STEP_OPS, "S1": S1_STEP_OPS}[kind]
    return _bound(nbytes, ops)


def check_tracking(kind, args):
    """T1 (kind "T1", args delta_track's) or T2 against its plain version
    on the card (_check_loop), the grid cells the plain version's lookups
    read counted. Returns (the kernel's outputs, max abs error, lanes not
    bit-equal, cells read)."""
    from mitsuba_customization_tpu_torch.render import medium

    fn, plain = ((medium.delta_track, medium.delta_track_plain) if kind == "T1"
                 else (medium.ratio_track, medium.ratio_track_plain))
    got = fn(*args)
    seen = torch.zeros(args[0].grid.numel(), dtype=torch.bool, device=args[2].device)

    def mark(grid, look, p):
        seen[medium._corners(grid, look, p)[0]] = True

    with _marking(medium, "_density_at", mark):
        want = plain(*args)
    torch.cuda.synchronize()
    err, differ = _check_loop(kind, got, want, (2,) if kind == "T1" else ())
    return got, err, differ, int(seen.sum())


def check_march(args):
    """S1 on march's args against march_plain on the card (_check_loop: the
    hit flag and steps; t), the grid cells the plain version's samples
    read counted. Returns (the kernel's outputs, max abs error, lanes not
    bit-equal, cells read)."""
    from mitsuba_customization_tpu_torch.render import sdf

    got = sdf.march(*args)
    g = args[0]
    _, ny, nz = g.values.shape
    seen = torch.zeros(g.values.numel(), dtype=torch.bool, device=g.values.device)

    def mark(grid, p):
        base = sdf.cell(grid, p)[0].reshape(-1)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    seen[base + (dx * ny + dy) * nz + dz] = True

    with _marking(sdf, "sample", mark):
        want = sdf.march_plain(*args)
    torch.cuda.synchronize()
    err, differ = _check_loop("S1", got, want, (1,))
    return got, err, differ, int(seen.sum())


def check_tracking_ad(kind, args):
    """T1 (kind "T1") or T2 at ad_mode's AD_TRACKING_STEPS steps on one
    call's args against medium._scan (no grad) on the card: t, weight,
    flag and steps bit for bit on every lane (a lane cut at 48 steps keeps
    its partial t and weight in both). Returns the lanes not bit-equal (0,
    or it raises)."""
    from mitsuba_customization_tpu_torch.render import medium

    name = "delta" if kind == "T1" else "ratio"
    loops, medium.LOOPS = medium.LOOPS, None
    try:
        got = medium._launch(name, *args, medium.AD_TRACKING_STEPS)
        medium.LOOPS = []
        with torch.no_grad():
            want = medium._scan(name, *args)
    finally:
        medium.LOOPS = loops
    if kind == "T2":
        want = want[1:]
    n = got[0].shape[0]
    differ = torch.zeros(n, dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, want):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ |= (a != b).reshape(n, -1).any(-1)
    torch.cuda.synchronize()
    if int(differ.sum()):
        raise AssertionError(f"{kind} at {medium.AD_TRACKING_STEPS} steps: {int(differ.sum())} "
                             "lanes not bit-equal to _scan")
    return 0


def _track_bwd_grads(kind, args, g_w, g_t, fn):
    """fn's (track_bwd's or track_bwd_plain's) gradients of T1 / T2's call
    `args` for cotangents g_w, g_t: [sigma_t, grid, ray_o, ray_d, t_max]."""
    out = torch.zeros_like(args[0].grid)
    g_s, g_o, g_d, g_tm = fn("delta" if kind == "T1" else "ratio", *args, g_w, g_t,
                             grid_out=out, need_rays=True, need_t_max=True)
    return [g_s, out, g_o, g_d, g_tm]


def _track_bwd_autograd(kind, args, g_w, g_t):
    """The same gradients by torch.autograd through medium._scan."""
    from mitsuba_customization_tpu_torch.render import medium

    table, mid, o, d, tm, key, base = args
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (table.sigma_t, table.grid, o, d, tm)]
    out = medium._scan("delta" if kind == "T1" else "ratio",
                       table._replace(sigma_t=leaves[0], grid=leaves[1]), mid, *leaves[2:],
                       key, base)
    loss = (g_w * out[1]).sum() + ((g_t * out[0]).sum() if kind == "T1" else 0.0)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def _rel_or_zero(got, want):
    """Relative L2 error, or where `want` is 0 the norm of `got`."""
    norm = float(want.double().norm())
    return rel_l2(got, want) if norm > 0 else float(got.double().norm())


def phase_tracking_bwd(kind, args):
    """T1-bwd (kind "T1") or T2-bwd on the call `args` of T1 / T2 (phase
    26's recorded call of the most lane steps: the volpath frame's 2,097,152
    lanes) with seeded cotangents (the weight's, and T1's t's): every
    gradient (sigma_t, the grid, ray_o, ray_d, t_max) within TRACK_BWD_RTOL
    relative L2 error of track_bwd_plain's and of autograd's through
    medium._scan (48 masked steps over every lane). Timed: the kernel into
    one buffer (CUDA events, median of 5), the plain version once, and the
    yardstick: one index_add_ of the same grid updates (the plain version's
    nonzero (index, addend) pairs: the scatter part only); the device
    operations of one call counted in a trace. Bound: each lane's mid, and
    the outputs (ray and t_max gradients) of every lane; a
    tracked lane's ray, t_max, key and cotangents; each grid cell the
    replay reads, once, and each atomic add's 4 bytes; operations the
    replayed steps' (T1_STEP_OPS / T2_STEP_OPS) and the sweep's
    (T_BWD_SWEEP_OPS) over the moved steps. Returns (its line's stats)."""
    from mitsuba_customization_tpu_torch.render import medium

    name = "delta" if kind == "T1" else "ratio"
    table, mid, o = args[0], args[1], args[2]
    n, dev = o.shape[0], o.device
    gen = torch.Generator(device=dev).manual_seed(17)
    g_w = torch.rand((n, 3), generator=gen, device=dev)
    g_t = torch.rand(n, generator=gen, device=dev) if kind == "T1" else None
    got = _track_bwd_grads(kind, args, g_w, g_t, medium.track_bwd)
    pairs, seen = [], torch.zeros(table.grid.numel(), dtype=torch.bool, device=dev)

    def mark_scatter(out, idx, add):
        keep = add != 0
        pairs.append((idx[keep], add[keep]))

    def mark_read(grid, look, p):
        seen[medium._corners(grid, look, p)[0]] = True

    with _marking(medium, "_scatter_grid", mark_scatter), \
            _marking(medium, "_density_at", mark_read):
        plain = _track_bwd_grads(kind, args, g_w, g_t, medium.track_bwd_plain)
    auto = _track_bwd_autograd(kind, args, g_w, g_t)
    torch.cuda.synchronize()
    names = ("sigma_t", "grid", "ray_o", "ray_d", "t_max")
    err_plain = {k: _rel_or_zero(a, b) for k, a, b in zip(names, got, plain)}
    err_auto = {k: _rel_or_zero(a, b) for k, a, b in zip(names, got, auto)}
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    if not finite or max(list(err_plain.values()) + list(err_auto.values())) > TRACK_BWD_RTOL:
        raise AssertionError(f"{kind}-bwd: finite {finite}, relative L2 error against the plain "
                             f"version {err_plain}, against autograd through _scan {err_auto} "
                             f"(limit {TRACK_BWD_RTOL})")
    idx = torch.cat([i for i, _ in pairs])
    add = torch.cat([a for _, a in pairs])
    buf = torch.zeros_like(table.grid)

    call = (medium.track_bwd, name, *args, g_w, g_t)
    outs = dict(grid_out=buf, need_rays=True, need_t_max=True)
    ms = _time_ms(lambda: medium.track_bwd(*call[1:], **outs))
    device_ms = _device_ms(AD_TRACE_NAMES[kind + "-bwd"], *call, **outs)
    call_device_ms = _device_ms("", *call, **outs)
    ops = [n for n, _ in _device_trace(1, *call, **outs)]
    plain_ms = _once_ms(lambda: medium.track_bwd_plain(name, *args, g_w, g_t, grid_out=buf,
                                                        need_rays=True, need_t_max=True))
    library_ms = _time_ms(lambda: buf.view(-1).index_add_(0, idx, add))
    steps = medium._launch(name, *args, medium.AD_TRACKING_STEPS)[-1]
    live = int((steps > 0).sum())
    lane_steps = int(steps.sum())
    cells = int(seen.sum())
    per_lane = 8 + 24 + 4
    tracked = 24 + 4 + 8 + 12 + (4 if kind == "T1" else 0)
    nbytes = n * per_lane + live * tracked + cells * 4 + idx.numel() * 4
    step_ops = (T1_STEP_OPS if kind == "T1" else T2_STEP_OPS) + T_BWD_SWEEP_OPS
    bound_ms, bound_by = _bound(nbytes, lane_steps * step_ops)
    print(f"{kind}-bwd {n} lanes, {live} tracked, {lane_steps} replayed steps (at most "
          f"{medium.AD_TRACKING_STEPS}), {cells} grid cells read, {idx.numel()} grid updates: "
          f"relative L2 error against the plain version {err_plain}, against autograd through "
          f"_scan {err_auto} (limit {TRACK_BWD_RTOL}); {ms:.4f} ms (device: kernel "
          f"{device_ms:.4f}, every device operation of the call "
          f"{call_device_ms:.4f}; {len(ops)} device operations a call: "
          f"{[x[:48] for x in ops]}; bound "
          f"{bound_ms:.5f}, {bound_by}; plain {plain_ms:.2f}; index_add_ of the grid updates "
          f"{library_ms:.4f})")
    return dict(max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, plain)),
                rel_l2_plain=err_plain, rel_l2_autograd=err_auto, ms=ms, device_ms=device_ms,
                call_device_ms=call_device_ms, device_ops=len(ops), plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, lanes=n, live=live,
                steps=lane_steps, grid_updates=idx.numel())


def _every(args, k):
    """A T1 / T2 call's arguments on every k-th lane (the table and
    dim_base kept)."""
    return (args[0],) + tuple(x[::k].contiguous() for x in args[1:-1]) + (args[-1],)


def _loop_call(kind, args):
    """Check one recorded T1 / T2 / S1 call and time it: (its line, its
    stats)."""
    from mitsuba_customization_tpu_torch.render import medium, sdf

    if kind == "S1":
        got, err, differ, cells = check_march(args)
        kernel, plain = sdf.march, sdf.march_plain
        lanes, lane_in = 5, 32
    else:
        got, err, differ, cells = check_tracking(kind, args)
        kernel, plain = ((medium.delta_track, medium.delta_track_plain) if kind == "T1"
                         else (medium.ratio_track, medium.ratio_track_plain))
        lanes, lane_in = 8, 36
    steps = got[-1]
    ms, plain_ms = _time_ms(lambda: kernel(*args)), _once_ms(lambda: plain(*args))
    device_ms = _device_ms(TRACE_NAMES[kind], kernel, *args)
    bound_ms, bound_by = loop_bound(kind, lanes, steps, cells, lane_in)
    live = int((steps > 0).sum())
    ad = "" if kind == "S1" else (f"; at {medium.AD_TRACKING_STEPS} steps "
                                  f"{check_tracking_ad(kind, args)} lanes not bit-equal to _scan")
    line = (f"{kind} {steps.shape[0]} lanes, {live} {'active' if kind == 'S1' else 'tracked'}, "
            f"steps max {int(steps.max())} mean {float(steps.sum()) / max(live, 1):.1f} "
            f"({int(steps.sum())} in all), {cells} grid cells read, {differ} lanes not "
            f"bit-equal, {ms:.4f} ms (device {device_ms:.4f}; bound {bound_ms:.5f}, "
            f"{bound_by}; "
            f"plain {plain_ms:.2f}){ad}")
    return line, dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, lanes=steps.shape[0], live=live,
                      steps=int(steps.sum()), max_steps=int(steps.max()),
                      lanes_not_bit_equal=differ)


def phase_loop_calls(rec, label):
    """Check and time every recorded call of rec ({kernel: [args]}, the
    kernels of one frame in call order: T1 and T2 a bounce each, or S1),
    one line per group (a bounce's T1 and T2, or one S1 march). Returns
    ({kernel: the stats of its call of the most lane steps (the camera
    bounce's rays start in vacuum: the volpath frame's first tracking call
    tracks no lane)}, {kernel: (frame ms, frame bound ms, frame device ms)}
    summed over the calls)."""
    first, total = {}, {k: [0.0, 0.0, 0.0] for k in rec}
    for i in range(max(len(v) for v in rec.values())):
        parts = []
        for kind, calls in rec.items():
            if i < len(calls):
                line, st = _loop_call(kind, calls[i])
                if kind not in first or st["steps"] > first[kind]["steps"]:
                    first[kind] = dict(st, call=i)
                total[kind][0] += st["ms"]
                total[kind][1] += st["bound_ms"]
                total[kind][2] += st["device_ms"]
                parts.append(line)
        print(f"{label} {i}: " + "; ".join(parts))
    print(f"{label} sums over the recorded calls: " + ", ".join(
        f"{k} {ms:.4f} ms (device {dev:.4f}; bound {bound:.5f})"
        for k, (ms, bound, dev) in total.items()))
    return first, {k: tuple(v) for k, v in total.items()}


def _tracking_summary(loops):
    """The tracking loops of a frame (medium.LOOPS) as per-bounce lines:
    each bounce runs delta tracking (the free flight) and ratio tracking
    (the shadow ray), each a launch over every lane (T1 / T2), or in
    ad_mode the 48-step scan. Returns (lines, the slowest lanes' steps
    summed over the loops, all lanes' steps, host checks)."""
    lines, steps, lane_steps, checks = [], 0, 0, 0
    for kind, lanes, n_steps, n_checks in loops:
        live = int((n_steps > 0).sum())
        lines.append(f"{kind} {live} of {lanes} lanes tracked, {int(n_steps.max())} steps at "
                     f"most, {int(n_steps.sum())} in all, {n_checks} host checks")
        steps += int(n_steps.max())
        lane_steps += int(n_steps.sum())
        checks += n_checks
    return lines, steps, lane_steps, checks


def _volpath_expectations(dev):
    """The JAX package's analytic media tests on the card: Beer-Lambert
    through an absorbing fog ball (tests/test_media.py::
    test_volpath_absorbing_sphere_beer_lambert: centre within 3 standard
    errors + 0.01, corner 2.0 within 0.05) and the emissive ball's
    L = Le (1 - exp(-2 sigma r)) (test_emissive_medium_analytic: rtol
    0.15, corner below 0.05)."""
    import math

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import fog_dict

    sigma, radius, spp = 1.2, 0.8, 512
    img = mt.render(mt.load_dict(fog_dict([sigma] * 3, [0.0] * 3, radius), dev), spp=spp,
                    seed=3).cpu()
    centre, corner = float(img[11:13, 11:13].mean()), float(img[1, 1].mean())
    p = math.exp(-sigma * 2.0 * radius)
    stderr = 2.0 * math.sqrt(p * (1 - p) / (4 * spp * 3))
    le = torch.tensor([2.0, 1.5, 1.0])
    em = mt.render(mt.load_dict(fog_dict([0.8] * 3, [0.0] * 3, 1.0, 0.0, 16, 12, 64,
                                         radiance=le.tolist()), dev), spp=64, seed=5).cpu()
    want = le * (1.0 - math.exp(-0.8 * 2.0))
    print(f"media expectations on the card: absorbing ball centre {centre:.5f} (Beer-Lambert "
          f"{2.0 * p:.5f}, 3 x stderr {3 * stderr:.5f} + 0.01), corner {corner:.5f} (2.0); "
          f"emissive ball centre {em[6, 6].tolist()} (analytic {want.tolist()}, rtol 0.15), "
          f"corner {float(em[0, 0].max()):.2e}")
    if not (abs(corner - 2.0) < 0.05 and abs(centre - 2.0 * p) < 3.0 * stderr + 0.01
            and bool(((em[6, 6] - want).abs() <= 0.15 * want).all())
            and float(em[0, 0].max()) < 0.05):
        raise AssertionError("a media expectation of the JAX tests fails on the card")


def phase_volpath(dev, res=512, spp=8, depth=8, grid_res=VOLPATH_GRID, cmp_res=64):
    """Phase 26: the volpath frame, scenes.volpath_dict(res, spp, depth,
    grid_res, VOLPATH_SEED): the matpreview scene with the production
    scene's homogeneous fog ball and a heterogeneous smoke cube of a
    grid_res^3 density grid, res x res x spp lanes in one pass (the
    volumetric tracer has no compaction): load and frame seconds, rays/s,
    K1-K4, T1 and T2 launched, and the tracking loops' steps (read from
    the kernels' step counts after the frame) and host checks (none),
    bounce by bounce; every K1-K4 call of one more render recorded,
    checked against its plain version and timed (K3 twice a bounce: the
    shadow ray's first boundary), and every T1 / T2 call of one more
    (phase_loop_calls); card against CPU means at 64x64; the JAX tests'
    analytic media expectations on the card. Each T1 / T2 call is also
    held at ad_mode's 48 steps to medium._scan bit for bit
    (check_tracking_ad), and T1-bwd / T2-bwd are checked and timed on the
    T1 / T2 call of the most lane steps (phase_tracking_bwd), and again on
    its every 8th lane (262,144 lanes: the volpath AD step's shape). Returns
    (launches (T1 and T2 too), frame sums, the slowest lanes' steps, host
    checks, T1 / T2's first calls' stats, their frame sums, T1-bwd /
    T2-bwd's stats, the scene)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import medium
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    t0 = time.perf_counter()
    d = volpath_dict(res, spp, depth, grid_res, VOLPATH_SEED)
    dict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = mt.load_dict(d, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del d
    media = scene.media
    print(f"volpath frame: density grid {tuple(media.grid.shape)} "
          f"({media.grid.numel() * 4 / 2 ** 20:.0f} MiB) made in {dict_s:.1f} s, scene loaded "
          f"in {load_s:.1f} s: {scene.geometry.p0.shape[0]} prims, "
          f"{scene.clusters.cl_box.shape[0]} clusters, {media.n_media} media (types "
          f"{media.m_type.tolist()}, majorants {media.majorant.tolist()})")
    if (media.n_media != 2 or not media.has_het or scene.config.integrator != "volpath"
            or scene.shadow_clusters is None):
        raise AssertionError("the volpath scene lacks its media or its shadow cluster set")
    launches = _timed_frame("volpath", scene, spp, ("K1", "K2", "K3", "K4"), loops=True)
    loops = _loop_launches()
    lines, steps, lane_steps, checks = _tracking_summary(medium.LOOPS)
    print(f"volpath tracking loops of the timed frame: {len(lines)} loops ({loops['T1']} T1 and "
          f"{loops['T2']} T2 launches), the slowest lanes {steps} steps in all (at most "
          f"{medium.MAX_TRACKING_STEPS + 1} a loop), every lane {lane_steps}, {checks} host "
          f"checks: " + "; ".join(lines))
    if min(loops["T1"], loops["T2"]) <= 0 or (checks and torch.device(dev).type == "cuda"):
        raise AssertionError(f"the volpath frame's tracking: launches {loops}, {checks} host "
                             "checks")
    rec = record_wavefronts(scene, spp, seed=1)
    if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
        raise AssertionError(f"recorded calls {[len(v) for v in rec.values()]} != {launches}")
    frame = phase_bounces(scene, rec, k3_per_bounce=2)
    del rec
    rec = record_calls(lambda: mt.render(scene, spp=spp, seed=1), {
        "T1": (medium, "delta_track", lambda args, kwargs: _keep_args(args)),
        "T2": (medium, "ratio_track", lambda args, kwargs: _keep_args(args))})
    if {k: len(v) for k, v in rec.items()} != {k: loops[k] for k in rec}:
        raise AssertionError(f"recorded T1 / T2 calls {[len(v) for v in rec.values()]} != "
                             f"{loops}")
    t_first, t_frame = phase_loop_calls(rec, "tracking, bounce")
    t_bwd = {}
    for k in ("T1", "T2"):
        args = rec[k][t_first[k]["call"]]
        t_bwd[k + "-bwd"] = phase_tracking_bwd(k, args)
        # the volpath AD step's shape (256x256, 4 spp): every 8th lane
        t_bwd[k + "-bwd"]["ad_step_shape"] = phase_tracking_bwd(k, _every(args, 8))
    del rec
    _gpu_cpu_means(f"volpath {cmp_res}x{cmp_res} 4spp depth 4",
                   volpath_dict(cmp_res, 4, 4, 64, VOLPATH_SEED), dev)
    _volpath_expectations(dev)
    return dict(launches, **loops), frame, steps, checks, t_first, t_frame, t_bwd, scene


def phase_volpath_ad(dev, res=256, spp=4, depth=6, grid_res=VOLPATH_GRID, cmp_res=64):
    """Phase 27: one eager AD step (ad._eager_loss_and_grad, the captured
    step's eager counterpart; MSE against a zero image) of the
    volpath scene at res x res, spp, depth on the table stack and the four
    medium keys: one warm-up, one timed step (seconds, peak memory, K1-bwd,
    T1 / T2 and T1-bwd / T2-bwd launches, all > 0, one table-sized and one
    grid-sized gradient buffer, the tracking loops' steps with no host
    check, each gradient finite and nonzero); one step at 512x512, 8 spp
    (_volpath_ad_big: its peak memory); at cmp_res x cmp_res (64x64), 4
    spp, depth 3 card against CPU losses within AD_LOSS_RTOL and each
    gradient at cosine >= AD_TABLE_COS; the homogeneous extinction's AD
    gradient against a central difference on the JAX test's absorbing fog
    ball. Returns (the step's launches, its grid-sized buffers, (its
    scene, its parameters))."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import ad, medium
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    keys = (AD_KEYS[0],) + MEDIUM_KEYS
    scene = mt.load_dict(volpath_dict(res, spp, depth, grid_res, VOLPATH_SEED), dev)
    params = {k: traverse(scene)[k] for k in keys}
    target = torch.zeros((res, res, 3), device=dev)
    ad._eager_loss_and_grad(scene, params, target, spp, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _record_loops()
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, params, target, spp, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD}, **_loop_launches(),
                    **_track_bwd_launches())
    buffers, grid_buffers = k1.GRAD_BUFFERS, medium.GRID_BUFFERS
    lines, steps, _, checks = _tracking_summary(medium.LOOPS)
    medium.LOOPS = None
    grid_mb = scene.media.grid.numel() * 4 / 2 ** 20
    nonzero = {k: float((g != 0).float().mean()) for k, g in grads.items()}
    print(f"volpath AD step {res}x{res} {spp}spp depth {depth} (keys {list(keys)}): "
          f"{secs:.3f} s, loss {float(loss):.6e}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, table-gradient buffers "
          f"{buffers}, grid-sized gradient buffers {grid_buffers} ({grid_mb:.0f} MiB each, one "
          f"a backward pass: T1-bwd / T2-bwd add into it), tracking loops {len(lines)} (T1 / T2 "
          f"at {medium.AD_TRACKING_STEPS} steps: {steps} steps of the slowest lanes, {checks} "
          f"host checks, forward and replay); nonzero shares {nonzero}; launches {launches}; "
          f"sigma_t gradient {grads['medium.sigma_t'].tolist()}, phase_g "
          f"{grads['medium.phase_g'].tolist()}")
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values())
    tracking = min(launches[k] for k in ("T1", "T2", "T1-bwd", "T2-bwd"))
    if (not finite or buffers != 1 or grid_buffers != 1 or launches["K1-bwd"] <= 0
            or tracking <= 0 or min(nonzero.values()) <= 0 or checks):
        raise AssertionError(f"volpath AD step: finite {finite}, buffers {buffers}, grid "
                             f"buffers {grid_buffers}, launches {launches}, nonzero {nonzero}, "
                             f"host checks {checks}")
    ad_scene = (scene, params)
    del scene, grads, params
    _volpath_ad_big(dev, keys, grid_res)

    d = volpath_dict(cmp_res, 4, 3, 64, VOLPATH_SEED)
    out = {}
    for where in (dev, "cpu"):
        sc = mt.load_dict(d, where)
        full = traverse(sc)
        lo, gr = ad.grad_render(sc, {k: full[k] for k in keys},
                                torch.zeros((cmp_res, cmp_res, 3), device=where), spp=4)
        out[str(where)] = (float(lo), {k: g.cpu().flatten().double() for k, g in gr.items()})
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    cos = {k: float(gg[k] @ gc[k] / (gg[k].norm() * gc[k].norm())) for k in keys}
    print(f"volpath AD {cmp_res}x{cmp_res} 4spp depth 3: loss gpu {lg:.6e} cpu {lc:.6e} (rel "
          f"{loss_rel:.2e}, limit {AD_LOSS_RTOL}); gradient cosines {cos} (limit "
          f"{AD_TABLE_COS})")
    if not (loss_rel <= AD_LOSS_RTOL and min(cos.values()) >= AD_TABLE_COS):
        raise AssertionError("GPU and CPU volpath gradients disagree")
    _sigma_fd(dev)
    return launches, grid_buffers, ad_scene


def _volpath_ad_big(dev, keys, grid_res, res=512, spp=8, depth=6):
    """One eager volpath AD step at res x res, spp (2,097,152 lanes, one
    pass), depth 6, not warmed up: its seconds and peak memory (one line;
    loss and gradients finite)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad, medium
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    scene = mt.load_dict(volpath_dict(res, spp, depth, grid_res, VOLPATH_SEED), dev)
    params = {k: traverse(scene)[k] for k in keys}
    target = torch.zeros((res, res, 3), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    medium.GRID_BUFFERS = 0
    t0 = time.perf_counter()
    loss, grads = ad._eager_loss_and_grad(scene, params, target, spp, 2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values())
    print(f"volpath AD step {res}x{res} {spp}spp depth {depth}: {secs:.3f} s (first call), peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, grid-sized gradient "
          f"buffers {medium.GRID_BUFFERS}, loss {float(loss):.6e}, finite {finite}")
    if not finite:
        raise AssertionError("the 512x512 volpath AD step is not finite")


def _sigma_fd(dev, spp=256):
    """The homogeneous extinction's gradient by AD against a central
    difference of the same render (its scale moved by +-SIGMA_FD_STEP) on
    tests/test_media.py's absorbing fog ball (sigma 1, radius 0.8, a
    constant emitter of 2, depth 4, 24x24), the loss the centre's 2x2
    mean, over SIGMA_FD_SEEDS seeds: the means within SIGMA_FD_RTOL or 4
    standard errors of the mean paired difference; the Beer-Lambert
    derivative -sigma chord exp(-sigma chord) L printed beside them."""
    import math

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import fog_dict

    scene = mt.load_dict(fog_dict([1.0] * 3, [0.0] * 3, 0.8, 2.0, depth=4), dev)
    sig = traverse(scene)["medium.sigma_t"]

    def loss(scale, seed):
        img = ad.render_ad(scene, {"medium.sigma_t": sig * scale}, spp=spp, seed=seed)
        return img[11:13, 11:13].mean()

    g_ad, g_fd = [], []
    for seed in range(1, SIGMA_FD_SEEDS + 1):
        x = torch.ones((), device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(loss(x, seed), x)
        with torch.no_grad():
            fd = (loss(1.0 + SIGMA_FD_STEP, seed) - loss(1.0 - SIGMA_FD_STEP, seed)) / (
                2 * SIGMA_FD_STEP)
        g_ad.append(float(g))
        g_fd.append(float(fd))
    m_ad, m_fd = statistics.mean(g_ad), statistics.mean(g_fd)
    se = statistics.stdev(a - f for a, f in zip(g_ad, g_fd)) / SIGMA_FD_SEEDS ** 0.5
    analytic = -1.6 * math.exp(-1.6) * 2.0
    print(f"AD fog sigma_t scale (24x24 {spp}spp depth 4, loss the centre's 2x2 mean, "
          f"{SIGMA_FD_SEEDS} seeds): AD {[f'{x:.5f}' for x in g_ad]}, central difference "
          f"(step {SIGMA_FD_STEP}) {[f'{x:.5f}' for x in g_fd]}; means {m_ad:.6f} and "
          f"{m_fd:.6f} (rel diff {abs(m_ad - m_fd) / abs(m_fd):.3e}, limit {SIGMA_FD_RTOL} or "
          f"4 x the standard error {se:.3e}); Beer-Lambert {analytic:.6f}")
    if not abs(m_ad - m_fd) <= max(SIGMA_FD_RTOL * abs(m_fd), 4 * se):
        raise AssertionError("the extinction's AD gradient disagrees with the central difference")


def _splat_span(kind, scene, spp):
    """The light pass's splats of one render of `scene` (kind ptracer or
    bdpt), recorded: each timed (median of 5) as the frame runs it, every
    row (ptracer.splat_rows), beside the splat of its nonzero rows alone
    as the eager frame ran it before (the rows found by nonzero, a host
    sync, then index_select and film.splat), and the most device memory
    one splat_rows call of the frame holds above what was allocated
    before it (its temporaries, ptracer.SPLAT_CHUNK rows at a time): one
    line."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import bdpt, film, ptracer

    mod = ptracer if kind == "ptracer" else bdpt
    rec = record_calls(lambda: mt.render(scene, spp=spp, seed=1), {
        "splat": (mod, "splat_rows", lambda args, kwargs: tuple(
            a.clone() if torch.is_tensor(a) else a for a in args))})
    rows = nonzero = peak = 0
    ms = ms_nonzero = 0.0
    for values, xy, h, w, ft in rec["splat"]:
        ms += _time_ms(lambda: ptracer.splat_rows(values, xy, h, w, ft))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ptracer.splat_rows(values, xy, h, w, ft)
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() - before)

        def nonzero_only():
            keep = (values != 0.0).any(-1).nonzero().squeeze(1)
            return film.splat(values.index_select(0, keep), xy.index_select(0, keep), h, w,
                              ft)[0]

        ms_nonzero += _time_ms(nonzero_only)
        rows += values.shape[0]
        nonzero += int((values != 0.0).any(-1).sum())
    print(f"{kind} splat: {len(rec['splat'])} calls, {rows} rows ({nonzero} not zero, 9 "
          f"neighbours each): every row {ms:.3f} ms, the nonzero rows alone (nonzero, "
          f"index_select, splat) {ms_nonzero:.3f} ms; one call's temporaries at most "
          f"{peak / 1e6:.1f} MB ({ptracer.SPLAT_CHUNK} rows a chunk)")


def phase_light_tracers(dev, res=512, spp=8, depth=8, cmp_res=64):
    """Phase 28: ptracer on matpreview_dict(res, spp, depth) without its
    sky (ptracer takes area, point and spot emitters) and bdpt on the
    whole scene (its roulette is off: every lane runs depth bounces):
    seconds, rays/s, launches; every K1-K4 call of one more render of
    each recorded and checked against its plain version on its first
    PLAIN_SLICE lanes, and timed; card against CPU means at 64x64; and on
    the card the JAX tests' comparisons with the path tracer (image means
    within 5 % / 7 %, normalised cross-correlation > 0.95); the light
    pass's splat of every row timed beside the splat of its nonzero rows
    (_splat_span). Returns (ptracer launches, bdpt launches, their frame
    sums, {kind: its scene})."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import (
        aggregate_agreement,
        light_paths_vs_path,
        matpreview_dict,
    )

    def light_dict(kind, r, s, dep):
        d = matpreview_dict(r, s, dep)
        d["integrator"] = {"type": kind, "max_depth": dep}
        if kind == "ptracer":
            del d["sky"]
        return d

    out = {}
    for kind, need in (("ptracer", ("K1", "K3", "K4")), ("bdpt", ("K1", "K2", "K3", "K4"))):
        scene = mt.load_dict(light_dict(kind, res, spp, depth), dev)
        launches = _timed_frame(kind, scene, spp, need)
        rec = record_wavefronts(scene, spp, seed=1)
        if {k: len(v) for k, v in rec.items()} != {k: launches[k] for k in rec}:
            raise AssertionError(f"{kind}: recorded calls {[len(v) for v in rec.values()]} "
                                 f"!= {launches}")
        frame = phase_bounces(scene, rec, hit_types={}, label=f"{kind} call group")
        del rec
        _splat_span(kind, scene, spp)
        _gpu_cpu_means(f"{kind} {cmp_res}x{cmp_res} 4spp depth 4",
                       light_dict(kind, cmp_res, 4, 4), dev)
        out[kind] = (launches, frame, scene)
    for kind, (path_img, img, tol) in light_paths_vs_path(dev).items():
        ok, diff, ncc = aggregate_agreement(path_img, img, tol)
        print(f"{kind} against path on the card (the JAX test's scene, 32x32): means "
              f"{float(path_img.mean()):.5f} / {float(img.mean()):.5f} (diff {diff:.5f}, limit "
              f"{tol} x the path mean + 1e-3), correlation {ncc:.4f} (limit 0.95)")
        if not ok:
            raise AssertionError(f"{kind} disagrees with the path tracer on the card")
    return out["ptracer"][0], out["bdpt"][0], out["ptracer"][1], out["bdpt"][1], {
        kind: v[2] for kind, v in out.items()}


XML_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_xml")
# the JAX suite's test_merl_chi2 / test_roughconductor_chi2 settings
CHI2_WI = (0.35, 0.2, 0.916)
CHI2 = dict(res=25, ires=16, seed=0)
CHI2_TESTS = 8
SHARDED_LOSS_RTOL = 1e-5
SHARDED_GRAD_COS = 0.9999


def phase_xml_cli(dev, res=512, spp=8, depth=8, n_sub=5):
    """Phase 29: the matpreview scene as a Mitsuba XML file
    (scenes.matpreview_xml: binary PLY bands, MERL .binary tables, the
    floor, the area light and the sky, <default>s for spp, res and depth)
    rendered by the command line in this process: cli.main(xml, -D spp -D
    res -D depth, -o frame.npy, --seed 1), the counts set to 0 just before
    and read just after (K1-K4 > 0); the CLI's own log lines (load and
    render seconds, primary rays/s) go to stdout. The written image must
    equal render(load_file(xml), spp, 1) bit for bit (that render timed:
    seconds, rays/s), and its per-channel means agree with the dict scene's
    within FRAME_MEAN_RTOL (the largest pixel difference printed). Returns
    the launches."""
    import logging
    import sys

    import numpy as np

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch import cli
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import xml as xml_mod
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, matpreview_xml

    t0 = time.perf_counter()
    path = matpreview_xml(XML_DIR, n_sub=n_sub)
    write_s = time.perf_counter() - t0
    out = os.path.join(XML_DIR, "frame.npy")
    if os.path.exists(out):
        os.remove(out)
    defines = dict(spp=spp, res=res, depth=depth)
    argv = [path, *(a for k, v in defines.items() for a in ("-D", f"{k}={v}")),
            "-o", out, "--seed", "1", "--device", str(dev)]
    log = logging.getLogger("mitsuba_customization_tpu_torch")
    to_stdout = logging.StreamHandler(sys.stdout)
    log.addHandler(to_stdout)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
    finally:
        log.removeHandler(to_stdout)
    got = torch.as_tensor(np.load(out))
    scene = xml_mod.load_file(path, device=dev, **defines)
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp, 1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rays = stats["rays_traced"]
    want = mt.render(mt.load_dict(matpreview_dict(res, spp, depth, n_sub=n_sub), dev), spp, 1)
    gm, wm = got.mean((0, 1)), want.mean((0, 1)).cpu()
    rel = ((gm - wm).abs() / wm.abs()).max().item()
    diff = (got - want.cpu()).abs().max().item()
    print(f"XML via CLI matpreview {res}x{res} {spp}spp depth {depth} ({scene.geometry.n_prims} "
          f"prims; files written in {write_s:.1f} s): cli.main {cli_s:.2f} s in all; "
          f"launches {launches}; render(load_file) again {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; CLI image equal to it bit for bit: "
          f"{torch.equal(got, img.cpu())}; means {gm.tolist()} against the dict scene's "
          f"{wm.tolist()}, max rel diff {rel:.2e} (limit {FRAME_MEAN_RTOL}), largest pixel "
          f"difference {diff:.3e}")
    if min(launches[key] for key in ("K1", "K2", "K3", "K4")) <= 0:
        raise AssertionError(f"a kernel was not launched on the XML / CLI path: {launches}")
    if got.shape != (res, res, 3) or not bool(torch.isfinite(got).all()):
        raise AssertionError("the CLI's image is not a finite frame")
    if not torch.equal(got, img.cpu()):
        raise AssertionError("the CLI's image differs from render(load_file(xml))")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError("the XML scene's means disagree with the dict scene's")
    return launches


def phase_chi2(dev):
    """Phase 30: chi-square tests on the card (utils/chi2, the JAX
    suite's harness): the directions sampled by tabulated.bounce_shade (K2,
    then K1 over both halves) on the flagship table at a fixed wi against
    tabulated.pdf, and roughconductor.sample at alpha 0.1 against its pdf,
    at test_merl_chi2's and test_roughconductor_chi2's settings (200,000 /
    150,000 samples, res 25, ires 16, Sidak over 8 tests). Both must pass;
    prints the p-values and the kernels' launches."""
    from mitsuba_customization_tpu_torch.models import roughconductor, tabulated
    from mitsuba_customization_tpu_torch.scenes import flagship_table
    from mitsuba_customization_tpu_torch.utils.chi2 import ChiSquareTest, SphericalDomain

    wi0 = torch.nn.functional.normalize(torch.tensor(CHI2_WI, device=dev), dim=0)
    brdf = tabulated.TabulatedBRDF.build(torch.as_tensor(flagship_table(), device=dev))
    rc = roughconductor.RoughConductorParams(
        alpha_u=torch.tensor(0.1, device=dev), alpha_v=torch.tensor(0.1, device=dev),
        eta=torch.tensor([0.2, 0.9, 1.4], device=dev), k=torch.tensor([3.9, 2.5, 2.1], device=dev),
        specular_reflectance=torch.ones(3, device=dev))

    def merl_sample(wi, u):
        wo_nee = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(wi)
        _, _, wo, pdf_s, _, _ = tabulated.bounce_shade(brdf, wi, wo_nee, u)
        return wo, pdf_s

    cases = [("MERL bounce_shade (K2, K1)", merl_sample,
              lambda wi, wo: tabulated.pdf(brdf, wi, wo), 200_000),
             ("GGX roughconductor alpha 0.1", lambda wi, u: roughconductor.sample(rc, wi, u)[:2],
              lambda wi, wo: roughconductor.pdf(rc, wi, wo), 150_000)]
    for what, sample, pdf, n in cases:
        def s(u, sample=sample):
            wi = wi0.expand(len(u), 3)
            wo, p = sample(wi, torch.as_tensor(u, device=dev))
            return wo.cpu().numpy(), (p > 0).double().cpu().numpy()

        def pf(d, pdf=pdf):
            return pdf(wi0.expand(len(d), 3), torch.as_tensor(d, device=dev)).cpu().numpy()

        _reset_counts()
        test = ChiSquareTest(SphericalDomain(), s, pf, sample_count=n, **CHI2)
        ok = test.run(test_count=CHI2_TESTS)
        print(f"chi-square on the card, {what}: {n} samples, p-value "
              f"{getattr(test, 'p_value', float('nan')):.4g} "
              f"({test.messages[-1]}); launches {_launch_counts()}")
        if not ok:
            raise AssertionError(f"chi-square test failed for {what}: {test.messages}")


def phase_sharded(dev, res=512, spp=8, depth=8):
    """Phase 31: parallel/mesh on a process group of one rank over NCCL
    (initialize_distributed with a localhost coordinator). render_sharded
    of the matpreview frame (one warm-up, then timed with the counts set to
    0 just before) against render: equal bit for bit (a world of one
    renders render's own passes), means within FRAME_MEAN_RTOL, largest
    pixel difference printed; render_sharded_jit (the rank's passes
    captured) against render_sharded at two seeds, bit for bit;
    loss_and_grad_sharded on phase 13's setup
    (256x256, 4 spp, depth 6, the 10 tables and the floor's alpha) against
    ad.grad_render: losses within SHARDED_LOSS_RTOL, each gradient at
    cosine >= SHARDED_GRAD_COS, K1-bwd launched into one table-gradient
    buffer. Exchanges between ranks need more than one card; the gloo
    tests (tests/test_torch_parallel.py) hold them on the CPU. Returns the
    launches of the sharded frame and of the sharded AD step."""
    import socket

    import torch.distributed as dist

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pm.initialize_distributed(f"tcp://localhost:{port}", 1, 0, device=str(dev), timeout=300)
    try:
        mesh = pm.make_mesh()
        scene = mt.load_dict(matpreview_dict(res, spp, depth), dev)
        pm.render_sharded(scene, mesh, spp, 0)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        img = pm.render_sharded(scene, mesh, spp, 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
        want = mt.render(scene, spp, 1)
        gm, wm = img.mean((0, 1)), want.mean((0, 1))
        rel = ((gm - wm).abs() / wm.abs()).max().item()
        print(f"sharded matpreview {res}x{res} {spp}spp depth {depth} on {dist.get_world_size()} "
              f"rank ({dist.get_backend()}): {secs:.3f} s; launches {launches}; means "
              f"{gm.tolist()} against render's {wm.tolist()}, max rel diff {rel:.2e} (limit "
              f"{FRAME_MEAN_RTOL}), largest pixel difference "
              f"{(img - want).abs().max().item():.3e}")
        if min(launches[key] for key in ("K1", "K2", "K3", "K4")) <= 0:
            raise AssertionError(f"a kernel was not launched on the sharded path: {launches}")
        if not rel <= FRAME_MEAN_RTOL:
            raise AssertionError("the sharded frame's means disagree with render's")
        if not torch.equal(img, want):
            raise AssertionError("one rank's sharded frame differs from render's")
        # the captured slab (render_sharded_jit) against render_sharded at
        # two seeds: the first call captures, the second replays
        jit_equal = all(torch.equal(pm.render_sharded_jit(scene, mesh, spp, sd),
                                    pm.render_sharded(scene, mesh, spp, sd)) for sd in (1, 2))
        print(f"sharded matpreview render_sharded_jit on {dist.get_world_size()} rank: "
              f"bit-equal to render_sharded at seeds 1, 2: {jit_equal}")
        if not jit_equal:
            raise AssertionError("one rank's render_sharded_jit differs from render_sharded")
        from mitsuba_customization_tpu_torch.render import frame_graph

        frame_graph.clear()
        del scene, img, want

        ad_scene, _, params = ad_setup(dev)
        target = torch.zeros((ad_scene.config.height, ad_scene.config.width, 3), device=dev)
        pm.loss_and_grad_sharded(ad_scene, params, target, mesh, 4, 1)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        loss, grads = pm.loss_and_grad_sharded(ad_scene, params, target, mesh, 4, 2)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ad_launches = dict(_launch_counts(), **{"K1-bwd": k1.LAUNCHES_BWD})
        buffers = k1.GRAD_BUFFERS
        loss1, grads1 = ad.grad_render(ad_scene, params, target, spp=4, seed=2)
        lrel = abs(float(loss) - float(loss1)) / abs(float(loss1))
        cos = {key: float(torch.nn.functional.cosine_similarity(
            grads[key].flatten().double(), grads1[key].flatten().double(), dim=0))
            for key in grads}
        print(f"sharded AD step {ad_scene.config.width}x{ad_scene.config.height} 4spp depth "
              f"{ad_scene.config.max_depth}: {secs:.3f} s, loss {float(loss):.6e} against "
              f"grad_render's {float(loss1):.6e} (rel {lrel:.2e}, limit {SHARDED_LOSS_RTOL}); "
              f"gradient cosines {cos} (limit {SHARDED_GRAD_COS}); launches {ad_launches}; "
              f"table-gradient buffers {buffers}")
        if not lrel <= SHARDED_LOSS_RTOL or min(cos.values()) < SHARDED_GRAD_COS:
            raise AssertionError("the sharded AD step disagrees with grad_render")
        if ad_launches["K1-bwd"] <= 0 or buffers != 1:
            raise AssertionError(f"sharded AD step: launches {ad_launches}, buffers {buffers}")
    finally:
        dist.destroy_process_group()
    return launches, ad_launches


# phase 32: the big shapes scene past clusters.MAX_PRIMS, on the BVH
BIG_SHAPES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "chip_smoke_big_shapes")
# icosphere subdivisions: a 1,310,720-triangle PLY, an 81,920-triangle OBJ
# and 20,480-triangle meshes, about 1.52M prims in all
BIG_N_SUB = (8, 6, 5)
# the card-against-CPU frame's depth: the CPU walks 1.52M prims lock-step
BIG_CMP_DEPTH = 3
# B1 / B2 bytes: a node's bounds, skip link and slots; what a prim test
# reads (type, p0, e1, e2); the outputs (B1: t, u, v, prim; B2: a byte)
NODE_BYTES = 44
PRIM_TEST_BYTES = 44
B1_OUT_BYTES, B2_OUT_BYTES = 16, 1
# B1 against its plain walk: both round every product and sum on its own
# and walk the same nodes in the same order, so the prim agrees and t, u,
# v are bit-equal where it does; a prim may differ only where an
# arithmetic of the card rounds apart from torch's
B_PRIM_AGREE = 0.999


def _bvh_launches():
    from mitsuba_customization_tpu_torch.render import bvh

    return {"B1": bvh.LAUNCHES["closest"], "B2": bvh.LAUNCHES["any"]}


def bvh_bound(ray, work, out_bytes):
    """B1's or B2's bound on rays `ray` from the walk's own work
    (render/bvh.walk_work): per lane maxt and the outputs, o and d of the
    live lanes; each node some lane visited and each prim some lane
    tested, read once; a box test (cl.BOX_OPS) a visit and a prim test
    (cl.SLOT_OPS, the shortest triangle test) a test."""
    from mitsuba_customization_tpu_torch.ops import clusters as cl

    n = ray.o.shape[0]
    live = int((torch.broadcast_to(ray.maxt, (n,)) > 0).sum())
    nbytes = (n * (MAXT_BYTES + out_bytes) + live * RAY_BYTES
              + int(work.nodes.sum()) * NODE_BYTES + int(work.prims.sum()) * PRIM_TEST_BYTES)
    ops = int(work.visits.sum()) * cl.BOX_OPS + int(work.tests.sum()) * cl.SLOT_OPS
    return _bound(nbytes, ops)


def check_b1(scene, r):
    """B1 against its plain walk on rays r: hit/miss equal, prims equal on
    >= B_PRIM_AGREE of hits, t, u, v bit-equal where they agree. Returns
    (the kernel's (t, prim, u, v), the walk's work, prim agreement, lanes
    not bit-equal in t, prim, u or v, hit share, largest |t error| over
    hits)."""
    from mitsuba_customization_tpu_torch.render import bvh

    cyl = scene.has_cylinders
    got = bvh.intersect(scene.bvh, scene.geometry, r, cyl)
    want, work = bvh.walk_work(scene.bvh, scene.geometry, r, cyl)
    torch.cuda.synchronize()
    (t, prim, u, v), (t_p, prim_p, u_p, v_p) = got, want
    hit = prim >= 0
    if not torch.equal(hit, prim_p >= 0):
        raise AssertionError(f"B1: hit/miss differs on {int((hit != (prim_p >= 0)).sum())} "
                             "lanes")
    same = prim == prim_p
    n_hit = int(hit.sum())
    agree = int((hit & same).sum()) / n_hit if n_hit else 1.0
    if not agree >= B_PRIM_AGREE:
        raise AssertionError(f"B1: prims agree on {agree:.5f} of hits")
    bits = same.clone()
    for a, b in ((t, t_p), (u, u_p), (v, v_p)):
        bits &= a.view(torch.int32) == b.view(torch.int32)
    if not torch.equal(bits[same], same[same]):
        raise AssertionError(f"B1: t, u or v differ from the plain walk's on "
                             f"{int((same & ~bits).sum())} lanes with the same prim")
    err = float((t - t_p)[hit].abs().max()) if n_hit else 0.0
    return got, work, agree, int((~bits).sum()), n_hit / max(1, t.shape[0]), err


def check_b2(scene, r):
    """B2 against its plain walk on rays r over the scene's shadow
    geometry: equal on every lane. Returns (occluded, the walk's work)."""
    from mitsuba_customization_tpu_torch.render import bvh

    g = scene.geometry if scene.shadow_geometry is None else scene.shadow_geometry
    occ = bvh.occluded(scene.bvh, g, r, scene.has_cylinders)
    occ_p, work = bvh.walk_work(scene.bvh, g, r, scene.has_cylinders, any_hit=True)
    torch.cuda.synchronize()
    if not torch.equal(occ, occ_p):
        raise AssertionError(f"B2: occlusion differs on {int((occ != occ_p).sum())} lanes")
    return occ, work


def _once_ms(fn):
    """CUDA-event time of one fn() (a plain walk of seconds, already warm)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_b1_b2(scene, ray):
    """B1 on the camera wavefront `ray` and B2 on NEE shadow rays from its
    hits (maxt 0 on a quarter of the lanes), each against its plain walk
    on all lanes (the first 262,144 if a plain walk over all would take
    over 30 s) and timed there: kernel (median of 5), plain walk (once),
    bound from the walk's work. Returns (B1 stats, B2 stats)."""
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.render import geometry as geo

    tree, cyl = scene.bvh, scene.has_cylinders
    n_all = ray.o.shape[0]
    n, plain_s = _plain_span(
        lambda k: bvh.intersect_plain(tree, scene.geometry, _sub(ray, k), cyl), n_all)
    r = _sub(ray, n)
    (t, prim, u, v), work, agree, differ, hits, err = check_b1(scene, r)
    ms = _time_ms(lambda: bvh.intersect(tree, scene.geometry, r, cyl))
    plain_ms = _once_ms(lambda: bvh.intersect_plain(tree, scene.geometry, r, cyl))
    bound_ms, bound_by = bvh_bound(r, work, B1_OUT_BYTES)
    which = "all" if n == n_all else f"a slice (plain est. {plain_s:.1f} s on all)"
    print(f"B1 bvh_closest: {n} lanes ({which} of {n_all}), hits {hits:.4f}, hit/miss "
          f"equal, prim agreement {agree:.6f}, {differ} lanes not bit-equal; node visits "
          f"{float(work.visits.float().mean()):.1f} a lane (max {int(work.visits.max())}), "
          f"prim tests {float(work.tests.float().mean()):.1f}, nodes read "
          f"{int(work.nodes.sum())} of {tree.n_nodes}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    b1 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, lanes=n, lanes_not_bit_equal=differ,
              device_ms=_device_ms("bvh_closest_kernel", bvh.intersect, tree, scene.geometry, r,
                                   cyl))

    shadow = nee_shadow_rays(scene, geo.compute_interaction(scene.geometry, r, t, prim, u, v,
                                                            cyl))
    lane = torch.arange(n, device=t.device)
    occ, work = check_b2(scene, shadow)
    if bool(occ[lane % 4 == 0].any()):
        raise AssertionError("B2: a lane with maxt = 0 is occluded")
    g = scene.geometry if scene.shadow_geometry is None else scene.shadow_geometry
    ms = _time_ms(lambda: bvh.occluded(tree, g, shadow, cyl))
    plain_ms = _once_ms(lambda: bvh.occluded_plain(tree, g, shadow, cyl))
    bound_ms, bound_by = bvh_bound(shadow, work, B2_OUT_BYTES)
    print(f"B2 bvh_any: {n} NEE shadow rays, live {float((shadow.maxt > 0).float().mean()):.4f}"
          f", occluded {float(occ.float().mean()):.4f}, equal on every lane; node visits "
          f"{float(work.visits.float().mean()):.1f} a lane (max {int(work.visits.max())}); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    print("B1 / B2 launch: a plain grid of 128-thread blocks, one thread a ray, no shared "
          "memory (the tree's top in shared memory with persistent blocks was measured and "
          "dropped: PERF.md §6)")
    b2 = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, lanes=n,
              device_ms=_device_ms("bvh_any_kernel", bvh.occluded, tree, g, shadow, cyl))
    return b1, b2


def phase_bvh_calls(scene, rec):
    """Check every recorded B1 / B2 call of one render against its plain
    walk on its first PLAIN_SLICE lanes, and time it (median of 5) on
    those lanes (beside the bound from the walk's work) and on all: one
    line a call. Returns {kernel: (ms on all lanes, ms on the checked
    lanes, bound ms of the checked lanes)} summed over the calls."""
    from mitsuba_customization_tpu_torch.render import bvh

    total = {"B1": [0.0, 0.0, 0.0], "B2": [0.0, 0.0, 0.0]}
    tree, cyl = scene.bvh, scene.has_cylinders
    g2 = scene.geometry if scene.shadow_geometry is None else scene.shadow_geometry
    for key in ("B1", "B2"):
        for i, r in enumerate(rec[key]):
            k = min(r.o.shape[0], PLAIN_SLICE)
            rs = _sub(r, k)
            if key == "B1":
                _, work, agree, differ, _, _ = check_b1(scene, rs)
                fn = lambda x: bvh.intersect(tree, scene.geometry, x, cyl)  # noqa: E731
                what = f"prim agreement {agree:.6f}, {differ} not bit-equal"
            else:
                occ, work = check_b2(scene, rs)
                fn = lambda x: bvh.occluded(tree, g2, x, cyl)  # noqa: E731
                what = f"{int(occ.sum())} occluded, equal"
            ms_all = _time_ms(lambda: fn(r))
            ms = _time_ms(lambda: fn(rs))
            bound, by = bvh_bound(rs, work, B1_OUT_BYTES if key == "B1" else B2_OUT_BYTES)
            print(f"{key} call {i}: {r.o.shape[0]} lanes, {int((r.maxt > 0).sum())} live, "
                  f"{k} checked ({what}); {ms_all:.4f} ms on all, {ms:.4f} ms on the checked "
                  f"(bound {bound:.5f}, {by}); node visits {int(work.visits.sum())}")
            for j, x in enumerate((ms_all, ms, bound)):
                total[key][j] += x
    print("frame sums over the recorded calls: " + ", ".join(
        f"{k} {a:.4f} ms on all lanes, {b:.4f} ms on the checked (bound {c:.4f})"
        for k, (a, b, c) in total.items()))
    return {k: tuple(v) for k, v in total.items()}


def phase_big_shapes(dev, res=512, spp=8, depth=8, cmp_res=64, cmp_depth=BIG_CMP_DEPTH,
                     n_sub=BIG_N_SUB):
    """Phase 32: scenes.shapes_dict on scenes.shape_files(n_sub=BIG_N_SUB)
    from seed SHAPES_SEED (about 1.52M prims, past clusters.MAX_PRIMS)
    through load_dict -> probe_compact_schedule -> render at res x res,
    spp, depth: file, load and bvh.build seconds, peak memory (device and
    host), the capacity warning, intersector "bvh"; the frame's seconds,
    rays/s and launches (K1, K2, B1, B2 launched, K3 and K4 not); B1 on
    the camera wavefront and B2 on NEE shadow rays (phase_b1_b2); every
    B1 / B2 call of one more render recorded, checked and timed
    (phase_bvh_calls); card against CPU means at cmp_res x cmp_res, 4 spp,
    depth cmp_depth. Returns (launches, B1 stats, B2 stats, frame sums, the
    scene with its probed schedule)."""
    import logging
    import resource

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.render.records import Ray
    from mitsuba_customization_tpu_torch.scenes import (
        probe_compact_schedule,
        shape_files,
        shapes_dict,
    )
    from mitsuba_customization_tpu_torch.utils.log import logger

    t0 = time.perf_counter()
    paths = shape_files(BIG_SHAPES_DIR, SHAPES_SEED, n_sub)
    files_s = time.perf_counter() - t0
    build_s = []
    build = bvh.build

    def timed_build(*args, **kwargs):
        t1 = time.perf_counter()
        out = build(*args, **kwargs)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t1)
        return out

    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger.addHandler(handler)
    bvh.build = timed_build
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        scene = mt.load_dict(shapes_dict(paths, res, spp, depth), dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        bvh.build = build
        logger.removeHandler(handler)
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    n_prims = scene.geometry.p0.shape[0]
    tree = scene.bvh
    tree_mb = sum(x.numel() * x.element_size() for x in tree) / 1e6
    node_pack, prim_pack = bvh.packed(tree, scene.geometry)
    pack_mb = sum(x.numel() * x.element_size() for x in (node_pack.nodes, prim_pack)) / 1e6
    print(f"big shapes: files written in {files_s:.1f} s, loaded in {load_s:.1f} s (reads, "
          f"bvh.build {sum(build_s):.2f} s in {len(build_s)} call, the kernels' packs): "
          f"{n_prims} prims, {tree.n_nodes} nodes ({tree_mb:.1f} MB; packed nodes and prims "
          f"{pack_mb:.1f} MB), intersector {scene.config.intersector}; "
          f"peak device memory {load_peak:.2f} GB, host max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB; warning: "
          f"{warnings}")
    if (n_prims <= cl.MAX_PRIMS or scene.config.intersector != "bvh" or not scene.config.use_bvh
            or scene.clusters is not None or len(build_s) != 1
            or not any("capacity contract" in w for w in warnings)):
        raise AssertionError("the big shapes scene is not on the BVH past the cap, or no "
                             "capacity warning")
    scene, fracs = probe_compact_schedule(scene, spp=4)
    torch.cuda.reset_peak_memory_stats()
    launches = _timed_frame("big shapes", scene, spp, ("K1", "K2"))
    launches.update(_bvh_launches())
    print(f"big shapes: launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, schedule "
          f"{[round(f, 4) for f in fracs]}")
    if launches["K3"] or launches["K4"] or min(launches["B1"], launches["B2"]) <= 0:
        raise AssertionError(f"big shapes: K3 / K4 launched or B1 / B2 not: {launches}")

    b1, b2 = phase_b1_b2(scene, camera_wavefront(scene, spp))

    def keep_ray(args, kwargs):
        return Ray(*(x.clone() for x in cl._rays(args[0])))

    rec = record_calls(lambda: mt.render(scene, spp=spp, seed=1), {
        "B1": (scene, "ray_intersect", keep_ray), "B2": (scene, "ray_test", keep_ray)})
    n_calls = {k: len(v) for k, v in rec.items()}
    if n_calls != {k: launches[k] for k in n_calls}:
        raise AssertionError(f"recorded calls {n_calls} != launches {launches}")
    frame = phase_bvh_calls(scene, rec)
    del rec
    _gpu_cpu_means(f"big shapes {cmp_res}x{cmp_res} 4spp depth {cmp_depth}",
                   shapes_dict(paths, cmp_res, 4, cmp_depth, compact=fracs), dev)
    return launches, b1, b2, frame, scene


# phase 33: the captured frames (render/integrator.render_jit) against render
JIT_TURNS = 5
# the depths at which phases 33 and 34 run the earlier orthogonal and
# camera frames and the blend and volpath AD steps: the script's time limit
JIT_CUT_DEPTH, JIT_STEP_DEPTH = 4, 3


def _all_launches():
    return dict(_launch_counts(), **_bvh_launches(), **_loop_launches())


# each kernel of a frame's path by the name its trace gives it
TRACE_NAMES = {"K1": "merl_eval_kernel", "K2": "cond_sample_kernel",
               "K3": "cluster_closest_kernel", "K4": "cluster_shadow_kernel",
               "B1": "bvh_closest_kernel", "B2": "bvh_any_kernel",
               "T1": "medium_delta_track_kernel", "T2": "medium_ratio_track_kernel",
               "S1": "sdf_march_kernel", **SH_TRACE_NAMES, **EM_TRACE_NAMES}


def _profiled(fn, names=TRACE_NAMES):
    """One fn() under torch.profiler (_device_events): (wall s, device s,
    kernels traced, busy share = device over wall, {kernel of `names`:
    launches of it in the trace}); device and busy None where the trace
    holds no kernel."""
    kernels, wall = _device_events(fn)
    dev_s = sum(e.duration_ns() for e in kernels) / 1e9 if kernels else None
    traced = {k: sum(name in e.name() for e in kernels) for k, name in names.items()}
    return wall, dev_s, len(kernels), None if dev_s is None else dev_s / wall, traced


def _frame_seconds(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _graph_nodes(frame):
    """The node counts of a frame's captured graphs, the forward's first:
    frame_graph.Frame.tables, read from libcuda at the capture; None where
    nothing was captured."""
    return None if frame.tables is None else [t.nodes for t in frame.tables]


def phase_jit_frame(what, scene, spp, need, card, exact=True):
    """Phase 33 for one scene: render_jit's first call (plan, warm-up,
    capture, replay) at seed 1, with the device memory it keeps (reserved
    after against before, the allocator's cache emptied at both: the
    graph's pool, the plan's inputs and the static output); then replays
    at seeds 2 and 1, each against render at the same seed: equal bit for
    bit (exact) or in per-channel means within FRAME_MEAN_RTOL (a splat's
    atomic adds). Then the graph's nodes; the replay and render in
    JIT_TURNS turns (medians and spread); one profiled replay and render
    (device seconds, kernels, busy share). A replay calls no wrapper, so
    its launches of each kernel are counted in its trace by name: they
    must equal the profiled render's, and those the wrappers counted in
    a render, those of `need` > 0. Returns a dict of these numbers."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph as fg
    from mitsuba_customization_tpu_torch.render.integrator import render_jit

    cfg = scene.config
    fg.clear()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    first_s = _frame_seconds(lambda: render_jit(scene, spp, 1))
    torch.cuda.empty_cache()
    frame_mb = (torch.cuda.memory_reserved() - reserved) / 1e6
    frame = fg.latest()
    nodes = frame.nodes
    got = {s: render_jit(scene, spp, s) for s in (2, 1)}
    _reset_counts()
    want = {2: mt.render(scene, spp, 2)}
    torch.cuda.synchronize()
    eager_launches = _all_launches()
    want[1] = mt.render(scene, spp, 1)
    if exact:
        agree = all(torch.equal(got[s], want[s]) for s in (1, 2))
        how = "bit-equal to render at seeds 1, 2"
    else:
        gm, wm = got[1].mean((0, 1)), want[1].mean((0, 1))
        rel = ((gm - wm).abs() / wm.abs()).max().item()
        agree = rel <= FRAME_MEAN_RTOL
        how = (f"means {gm.tolist()} against render's {wm.tolist()}, max rel diff {rel:.2e} "
               f"(limit {FRAME_MEAN_RTOL})")
    again = render_jit(scene, spp, 1)
    if (exact and not torch.equal(got[1], again)) or torch.equal(got[1], got[2]):
        raise AssertionError(f"render_jit {what}: a seed's replay is not its own frame")
    replay_s, eager_s = [], []
    for _ in range(JIT_TURNS):
        replay_s.append(_frame_seconds(lambda: render_jit(scene, spp, 3)))
        eager_s.append(_frame_seconds(lambda: mt.render(scene, spp, 3)))
    p_replay = _profiled(lambda: render_jit(scene, spp, 4))
    p_eager = _profiled(lambda: mt.render(scene, spp, 4))
    launches, eager_traced = p_replay[4], p_eager[4]

    def busy(p):
        if p[1] is None:
            return f"wall {p[0]:.4f} s, device not measured (no kernel traced)"
        return f"wall {p[0]:.4f} s, device {p[1]:.4f} s, {p[2]} kernels, busy {p[3]:.3f}"

    out = dict(launches=launches, first_s=first_s, capture_s=frame.capture_s, nodes=nodes,
               frame_mb=frame_mb,
               replay_s=statistics.median(replay_s), replay_spread=max(replay_s) - min(replay_s),
               eager_s=statistics.median(eager_s), eager_spread=max(eager_s) - min(eager_s),
               replay_device_s=p_replay[1], replay_busy=p_replay[3],
               eager_device_s=p_eager[1], eager_busy=p_eager[3])
    print(f"render_jit {what} {cfg.width}x{cfg.height} {spp}spp depth {cfg.max_depth} "
          f"({cfg.integrator}, {cfg.sampler}, {cfg.intersector}; card {card}): {how}; "
          f"launches traced in a replay {launches}, in a render {eager_traced}, counted by "
          f"the wrappers in a render {eager_launches}; first call {first_s:.3f} s, capture "
          f"{frame.capture_s:.3f} s, {nodes} graph nodes, frame memory {frame_mb:.1f} MB; "
          f"replay median {out['replay_s']:.4f} s (spread {out['replay_spread']:.4f}, "
          f"{', '.join(f'{x:.4f}' for x in replay_s)}) against render {out['eager_s']:.4f} s "
          f"(spread {out['eager_spread']:.4f}, {', '.join(f'{x:.4f}' for x in eager_s)}) "
          f"in {JIT_TURNS} turns; profiled replay: {busy(p_replay)}; profiled render: "
          f"{busy(p_eager)}")
    if not agree:
        raise AssertionError(f"render_jit {what} disagrees with render")
    if (launches != eager_traced or eager_traced != eager_launches
            or min(launches[k] for k in need) <= 0):
        raise AssertionError(f"render_jit {what}: replay launches {launches}, render's "
                             f"traced {eager_traced}, counted {eager_launches}")
    return out


def _at_depth(scene, depth):
    """`scene` (its tensors shared) with its path depth set to `depth`."""
    return dataclasses.replace(scene, config=dataclasses.replace(scene.config,
                                                                 max_depth=depth))


def phase_jit(dev, card, flagship, matpreview, big_shapes, looped, res=512, spp=8, depth=8,
              ortho_res=256):
    """Phase 33: render_jit against render on the flagship frame (K1 / K2),
    the matpreview frame with its probed schedule (K1-K4) and phase 32's
    big shapes frame (K1, K2, B1 / B2), bit for bit at two seeds
    (phase_jit_frame); on the frames of `looped` ({name: (scene, spp,
    kernels that must launch, bit for bit or in means)}: the volpath
    frame (T1 / T2), its scene under the path integrator, the SDF frame
    (S1) bit for bit, ptracer and bdpt, whose camera connections splat
    with atomic adds, in means); on the matpreview scene under the orthogonal
    sampler at ortho_res^2 and 9 spp (Kensler's walk over a range of 3,
    which a captured frame runs for every round), bit for bit too; and on
    the camera frame
    (thin lens, multijitter, gaussian splat; the probed schedule) in
    means. Returns {frame: its numbers}."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph as fg
    from mitsuba_customization_tpu_torch.scenes import (
        camera_dict,
        matpreview_dict,
        probe_compact_schedule,
    )

    out = {
        "flagship": phase_jit_frame("flagship", flagship, 64, ("K1", "K2"), card),
        "matpreview": phase_jit_frame("matpreview", matpreview, spp, ("K1", "K2", "K3", "K4"),
                                      card),
        "big_shapes": phase_jit_frame("big shapes", big_shapes, spp, ("K1", "K2", "B1", "B2"),
                                      card),
    }
    for name, (scene, n_spp, need, exact) in looped.items():
        out[name] = phase_jit_frame(name, scene, n_spp, need, card, exact)
        fg.clear()
    d = matpreview_dict(ortho_res, 9, depth)
    d["sensor"]["sampler"]["type"] = "orthogonal"
    ortho, _ = probe_compact_schedule(mt.load_dict(d, dev), spp=4)
    out["orthogonal"] = phase_jit_frame("orthogonal", ortho, 9, ("K1", "K2", "K3", "K4"),
                                        card)
    del ortho
    camera, _ = probe_compact_schedule(mt.load_dict(camera_dict(res, spp, depth), dev), spp=4)
    out["camera"] = phase_jit_frame("camera", camera, spp, ("K1", "K2", "K3", "K4"), card,
                                    exact=False)
    fg.clear()
    return out


# phase 34: the captured AD steps (render/ad._loss_and_grad behind grad_render)
AD_TRACE_NAMES = dict(TRACE_NAMES, **{"K1-bwd": "merl_eval_bwd_kernel",
                                       "T1-bwd": "medium_delta_track_bwd_kernel",
                                       "T2-bwd": "medium_ratio_track_bwd_kernel"})
# floor of a gradient's tolerance against the eager step: float32 rounding
STEP_GRAD_FLOOR = 1e-6


def _ad_launches():
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

    return dict(_all_launches(), **{"K1-bwd": k1.LAUNCHES_BWD}, **_track_bwd_launches())


def _spread_check(got, eager):
    """(relative L2 error of each gradient of `got` against the first of
    `eager`, eager steps' gradients at one seed; its limit:
    three times the largest relative L2 difference of two of them, which
    K1-bwd's, autograd's and a splat's atomic adds set; STEP_GRAD_FLOOR at
    least)."""
    want = eager[0]
    return ({k: rel_l2(got[k], want[k]) for k in want},
            {k: max(3 * max(float((a[k] - b[k]).double().norm() / want[k].double().norm())
                            for i, a in enumerate(eager) for b in eager[:i]),
                    STEP_GRAD_FLOOR) for k in want})


def phase_jit_step(what, scene, params, spp, need, card, mesh=None):
    """Phase 34 for one scene: grad_render's first call (plan, warm-up
    with a whole backward, capture of the forward and the backward, replay)
    at seed 1, with the device memory the step keeps (reserved after
    against before, the allocator's cache emptied at both: the graph's
    pool, the plan's inputs and buffers, the static outputs) and the
    graph's nodes; at seed 2 a replay and an eager step
    (ad._eager_loss_and_grad) in JIT_TURNS turns, timed (medians,
    spread): the last replay's loss the first eager one's bit for bit
    (the box filter) or within three times the eager losses' largest
    difference (SHARDED_LOSS_RTOL at least), each gradient within three
    times the eager steps' largest relative L2 difference (_spread_check).
    Then one profiled replay and eager step (device seconds, kernels, busy
    share). A replay calls no wrapper: its launches of each kernel (K1-bwd
    too) are counted in its trace by name and must equal the profiled
    eager step's and those the wrappers counted in it (the counts set to
    0 just before it), those of `need` > 0.
    With `mesh` (a process group of one rank), loss_and_grad_sharded_jit
    at seed 2 too (first call and a replay timed) against the replay:
    loss within SHARDED_LOSS_RTOL, gradients as above. Returns a dict of
    these numbers."""
    import torch.distributed as dist

    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render import frame_graph as fg

    t_start = time.perf_counter()
    cfg = scene.config
    exact = cfg.rfilter == "box"
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    fg.clear()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    first_s = _frame_seconds(lambda: ad.grad_render(scene, params, target, spp, 1))
    torch.cuda.empty_cache()
    step_mb = (torch.cuda.memory_reserved() - reserved) / 1e6
    step = fg.latest()
    nodes = step.nodes
    replay_s, eager_s, eager = [], [], []
    for _ in range(JIT_TURNS):
        t0 = time.perf_counter()
        got = ad.grad_render(scene, params, target, spp, 2)
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eager.append(ad._eager_loss_and_grad(scene, params, target, spp, 2))
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    want = eager[0]
    err, limit = _spread_check(got[1], [e[1] for e in eager])
    loss_diff = abs(float(got[0]) - float(want[0]))
    losses = [float(e[0]) for e in eager]
    loss_limit = max(3 * (max(losses) - min(losses)), SHARDED_LOSS_RTOL * abs(losses[0]))
    loss_ok = torch.equal(got[0], want[0]) if exact else loss_diff <= loss_limit
    if torch.equal(got[0], ad.grad_render(scene, params, target, spp, 3)[0]):
        raise AssertionError(f"captured step {what}: a seed's replay is not its own step")
    p_replay = _profiled(lambda: ad.grad_render(scene, params, target, spp, 4), AD_TRACE_NAMES)
    _reset_counts()
    p_eager = _profiled(lambda: ad._eager_loss_and_grad(scene, params, target, spp, 4),
                        AD_TRACE_NAMES)
    eager_launches = _ad_launches()
    launches, eager_traced = p_replay[4], p_eager[4]

    def busy(p):
        if p[1] is None:
            return f"wall {p[0]:.4f} s, device not measured (no kernel traced)"
        return f"wall {p[0]:.4f} s, device {p[1]:.4f} s, {p[2]} kernels, busy {p[3]:.3f}"

    out = dict(launches=launches, first_s=first_s, capture_s=step.capture_s, nodes=nodes,
               step_mb=step_mb, loss_diff=loss_diff, grad_err=err, grad_limit=limit,
               replay_s=statistics.median(replay_s), replay_spread=max(replay_s) - min(replay_s),
               eager_s=statistics.median(eager_s), eager_spread=max(eager_s) - min(eager_s),
               replay_device_s=p_replay[1], replay_busy=p_replay[3],
               eager_device_s=p_eager[1], eager_busy=p_eager[3])
    print(f"captured AD step {what} {cfg.width}x{cfg.height} {spp}spp depth {cfg.max_depth} "
          f"({cfg.rfilter}, {cfg.intersector}; keys {list(params)}; card {card}): loss "
          f"{float(got[0]):.9e} against the eager step's {float(want[0]):.9e} (difference "
          f"{loss_diff:.3e}, {'equal bit for bit required' if exact else f'limit {loss_limit:.3e}'}"
          f"); gradients' relative L2 error against the eager step {err}, limits {limit} "
          f"(three times {JIT_TURNS} eager steps' spread); launches traced in a replay "
          f"{launches}, in an eager step {eager_traced}, counted by the wrappers in an eager step "
          f"{eager_launches}; first call {first_s:.3f} s, capture {step.capture_s:.3f} s, "
          f"{nodes} graph nodes, step memory {step_mb:.1f} MB; replay median "
          f"{out['replay_s']:.4f} s (spread {out['replay_spread']:.4f}, "
          f"{', '.join(f'{x:.4f}' for x in replay_s)}) against the eager step "
          f"{out['eager_s']:.4f} s (spread {out['eager_spread']:.4f}, "
          f"{', '.join(f'{x:.4f}' for x in eager_s)}) in {JIT_TURNS} turns; profiled replay: "
          f"{busy(p_replay)}; profiled eager step: {busy(p_eager)}")
    if not loss_ok or any(err[k] > limit[k] for k in err):
        raise AssertionError(f"captured AD step {what} disagrees with the eager step")
    if (launches != eager_traced or eager_traced != eager_launches
            or min(launches[k] for k in need) <= 0):
        raise AssertionError(f"captured AD step {what}: replay launches {launches}, the eager "
                             f"step's traced {eager_traced}, counted {eager_launches}")
    if mesh is not None:
        fg.clear()
        sh_first = _frame_seconds(
            lambda: pm.loss_and_grad_sharded_jit(scene, params, target, mesh, spp, 1))
        sh_nodes = _graph_nodes(fg.latest())
        t0 = time.perf_counter()
        sh = pm.loss_and_grad_sharded_jit(scene, params, target, mesh, spp, 2)
        torch.cuda.synchronize()
        sh_s = time.perf_counter() - t0
        sh_err, sh_limit = _spread_check(sh[1], [got[1]] + [e[1] for e in eager[1:]])
        lrel = abs(float(sh[0]) - float(got[0])) / abs(float(got[0]))
        out.update(sharded_first_s=sh_first, sharded_replay_s=sh_s, sharded_nodes=sh_nodes)
        print(f"loss_and_grad_sharded_jit {what} on 1 rank ({dist.get_backend()}; "
              f"{'one graph' if cfg.rfilter == 'box' else 'split: forward and backward graphs'}"
              f", {sh_nodes} nodes): loss {float(sh[0]):.9e} against grad_render's replay "
              f"{float(got[0]):.9e} (rel {lrel:.2e}, limit {SHARDED_LOSS_RTOL}); gradients' "
              f"relative L2 error {sh_err}, limits {sh_limit}; first call {sh_first:.3f} s, "
              f"replay {sh_s:.4f} s")
        if lrel > SHARDED_LOSS_RTOL or any(sh_err[k] > sh_limit[k] for k in sh_err):
            raise AssertionError(f"loss_and_grad_sharded_jit {what} disagrees with grad_render")
    fg.clear()
    out["seconds"] = time.perf_counter() - t_start
    print(f"captured AD step {what}: {out['seconds']:.1f} s in phase 34")
    return out


def phase_jit_ad(dev, card, steps):
    """Phase 34: the captured AD steps (phase_jit_step) of `steps`, {name:
    (scene, params, spp, kernels that must launch, sharded too)}: phase
    13's matpreview setup, on the clusters and switched to the BVH (B1 /
    B2 in the forward and the backward's replay), the blend (main cuts it
    to JIT_STEP_DEPTH), image and camera scenes of phases 19, 22 and 23,
    phase 27's volpath scene (depth 6) and phase 24's SDF scene
    at 256x256, depth 6; those marked sharded
    also through loss_and_grad_sharded_jit on a process group of one rank
    over NCCL (the box filter's one graph, the gaussian's split step).
    Returns {step: its numbers}."""
    import socket

    import torch.distributed as dist

    from mitsuba_customization_tpu_torch.parallel import mesh as pm

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pm.initialize_distributed(f"tcp://localhost:{port}", 1, 0, device=str(dev), timeout=300)
    try:
        mesh = pm.make_mesh()
        return {name: phase_jit_step(name, scene, params, spp, need, card,
                                     mesh if sharded else None)
                for name, (scene, params, spp, need, sharded) in steps.items()}
    finally:
        dist.destroy_process_group()


T_START = time.perf_counter()
PHASE_SECONDS = {}
_LAP = [T_START]


def lap(label):
    """Print and keep the wall seconds since the previous lap (the first:
    since the script started) under `label`; end the device timer's
    process (the next phase's reads start their own)."""
    _stop_timer()
    torch.cuda.synchronize()
    now = time.perf_counter()
    PHASE_SECONDS[label] = round(now - _LAP[0], 1)
    _LAP[0] = now
    print(f"phase {label}: {PHASE_SECONDS[label]} s")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.models import bsdf as bsdf_mod
    from mitsuba_customization_tpu_torch.ops import bsdf_shade, build
    from mitsuba_customization_tpu_torch.ops import clusters as cl
    from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
    from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
    from mitsuba_customization_tpu_torch.render import bvh as bvh_mod
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    how = "cached" if build.build_seconds is None else "compiled with nvcc"
    print(f"build: {time.perf_counter() - t0:.1f} s ({how})")
    lap("1-2 card, build")

    scene = mt.load_dict(flagship_dict(512, 64, 4), dev)
    tab = scene.bsdfs.stacks[bsdf_mod.TABULATED]
    k1_stats = phase_k1(tab.table[0].contiguous(), dev)
    k2_stats = phase_k2(tab.sampling.cdf_cond.reshape(-1, 32, 64).contiguous(), dev)
    lap("3-4 K1, K2")

    mt.render(scene, spp=64, seed=0)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    img, stats = mt.render(scene, spp=64, seed=1, return_stats=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    rays = stats["rays_traced"]
    print(f"frame 512x512 64spp depth 4: {secs:.3f} s, {rays:.0f} rays, "
          f"{rays / secs / 1e6:.2f} Mrays/s; launches {launches}")
    if min(launches["K1"], launches["K2"]) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if img.shape != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("flagship frame is not a finite 512x512x3 image")

    small = flagship_dict(64, 4, 4)
    gpu = mt.render(mt.load_dict(small, dev), spp=4, seed=0).mean((0, 1)).cpu()
    cpu = mt.render(mt.load_dict(small, "cpu"), spp=4, seed=0).mean((0, 1))
    rel = ((gpu - cpu).abs() / cpu.abs()).max().item()
    print(f"entry frame 64x64 4spp: gpu means {gpu.tolist()}, cpu means "
          f"{cpu.tolist()}, max rel diff {rel:.2e} (limit {FRAME_MEAN_RTOL})")
    if not rel <= FRAME_MEAN_RTOL:
        raise AssertionError("GPU and CPU frame means disagree")
    lap("5-6 flagship")

    mp_scene, fracs, mp_launches = phase_matpreview(dev)
    k3_stats, hits = phase_k3(mp_scene, camera_wavefront(mp_scene, 8))
    k4_stats = phase_k4(mp_scene, hits)
    del hits
    rec = record_wavefronts(mp_scene, 8, seed=1)
    n_calls = {k: len(v) for k, v in rec.items()}
    if n_calls != {k: mp_launches[k] for k in n_calls}:
        raise AssertionError(f"recorded calls {n_calls} != launches {mp_launches}")
    frame = phase_bounces(mp_scene, rec)
    del rec
    sh_stats, sh_frame = phase_bsdf_stage(mp_scene, 8)
    if sh_stats["SH-pre"]["calls"] != mp_launches["SH-pre"]:
        raise AssertionError(f"recorded bounce_shade calls {sh_stats['SH-pre']['calls']} != "
                             f"launches {mp_launches}")
    em_stats, em_frame = phase_emitter_stage(mp_scene, 8)
    if any(em_stats[k]["calls"] != mp_launches[k] for k in EM_TRACE_NAMES):
        raise AssertionError(f"recorded emitter-stage calls "
                             f"{({k: v['calls'] for k, v in em_stats.items()})} != launches "
                             f"{mp_launches}")
    phase_matpreview_cpu(dev, fracs)
    lap("7-11 matpreview")

    bwd_stats = phase_k1_bwd(tab.table[0].contiguous(),
                             mp_scene.bsdfs.stacks[bsdf_mod.TABULATED].table, dev)
    lap("12 K1-bwd")
    setup = ad_setup(dev)
    ad_launches, ad_frame = phase_ad_step(setup)
    phase_ad_cpu(dev, setup[1])
    phase_alpha_fd(dev, setup[1])
    phase_ad_compaction(setup)
    opt_seconds = phase_optimize(setup)
    lap("13-16 AD")

    cfg0_launches = phase_config0(dev)
    lap("17 configs[0]")
    mat_launches, mat_frame = phase_materials(dev)
    lap("18 materials")
    blend_launches, blend_ad_launches, blend_frame, blend_ad = phase_blend(dev)
    lap("19 blend")
    paths = image_files(IMAGE_DIR)
    lap("20 image files")
    image_launches, image_frame = phase_image(dev, paths)
    lap("20 image frame")
    emitter_launches = phase_emitters(dev)
    lap("21 emitters")
    image_ad_launches, image_ad = phase_image_ad(dev, paths)
    lap("22 image AD step")
    cam_launches, cam_ad_launches, cam_frame, cam_ad = phase_camera(dev)
    lap("23 camera")
    shapes_launches, shapes_frame, sdf_launches, s1_stats, sdf_scene = phase_shapes(dev)
    lap("24 shapes")
    phase_variants(dev)
    lap("25 sensors, samplers, filters")
    (vol_launches, vol_frame, vol_steps, vol_checks, t_stats, t_frame, t_bwd,
     vol_scene) = phase_volpath(dev)
    lap("26 volpath")
    vol_ad_launches, vol_grid_buffers, vol_ad = phase_volpath_ad(dev)
    lap("27 volpath AD step")
    pt_launches, bd_launches, pt_frame, bd_frame, light_scenes = phase_light_tracers(dev)
    lap("28 ptracer, bdpt")
    xml_launches = phase_xml_cli(dev)
    lap("29 XML scene through the CLI")
    phase_chi2(dev)
    lap("30 chi-square on the card")
    sh_launches, sh_ad_launches = phase_sharded(dev)
    lap("31 sharded render and AD step")
    big_launches, b1_stats, b2_stats, big_frame, big_scene = phase_big_shapes(dev)
    lap("32 big shapes")
    cfg = vol_scene.config
    media_scene = dataclasses.replace(vol_scene, config=dataclasses.replace(
        cfg, integrator="path", width=cfg.width // 2, height=cfg.height // 2))
    vol_need = ("K1", "K2", "K3", "K4", "T1", "T2")
    jit = phase_jit(dev, card, scene, mp_scene, big_scene, depth=JIT_CUT_DEPTH, looped={
        "volpath": (vol_scene, 8, vol_need, True),
        "media": (media_scene, 8, vol_need, True),
        "sdf": (sdf_scene, 8, ("K1", "K2", "K3", "K4", "S1"), True),
        "ptracer": (light_scenes["ptracer"], 8, ("K1", "K3", "K4"), False),
        "bdpt": (light_scenes["bdpt"], 8, ("K1", "K2", "K3", "K4"), False)})
    del big_scene, mp_scene, vol_scene, media_scene, light_scenes
    lap("33 captured frames")
    cfg = sdf_scene.config
    sdf_ad = dataclasses.replace(sdf_scene, config=dataclasses.replace(
        cfg, width=cfg.width // 2, height=cfg.height // 2, max_depth=6))
    del sdf_scene
    ad_scene, _, ad_params = setup
    ad_bvh = dataclasses.replace(ad_scene, config=dataclasses.replace(ad_scene.config,
                                                                      intersector="bvh"))
    mp_need, bvh_need = ("K1", "K2", "K3", "K4", "K1-bwd"), ("K1", "K2", "B1", "B2", "K1-bwd")
    blend_ad = (_at_depth(blend_ad[0], JIT_STEP_DEPTH), blend_ad[1])
    jit_ad = phase_jit_ad(dev, card, {
        "matpreview": (ad_scene, ad_params, 4, mp_need, True),
        "matpreview_bvh": (ad_bvh, ad_params, 4, bvh_need, False),
        "blend": (*blend_ad, 4, ("K1", "K3", "K4", "K1-bwd"), False),
        "image": (*image_ad, 4, mp_need, False),
        "camera": (*cam_ad, 4, mp_need, True),
        "volpath": (*vol_ad, 4, mp_need + ("T1", "T2", "T1-bwd", "T2-bwd"), False),
        "sdf": (sdf_ad, {AD_KEYS[0]: mt.traverse(sdf_ad)[AD_KEYS[0]]}, 4,
                ("K1", "K3", "K4", "S1", "K1-bwd"), False)})
    del setup, ad_scene, ad_bvh, blend_ad, image_ad, cam_ad, vol_ad, sdf_ad
    lap("34 captured AD steps")

    kernels = [
        dict(name="merl_eval", route="cuda", source=k1.SOURCE,
             replaces="mitsuba_customization_tpu/ops/merl_sorted.py:182",
             launches=mp_launches["K1"], **k1_stats),
        dict(name="cond_sample", route="cuda", source=k2.SOURCE,
             replaces="mitsuba_customization_tpu/ops/marginal_sorted.py:93",
             launches=mp_launches["K2"], **k2_stats),
        dict(name="cluster_closest", route="cuda", source=cl.SOURCES["closest"],
             replaces="mitsuba_customization_tpu/ops/clusters.py:441",
             launches=mp_launches["K3"], **k3_stats),
        dict(name="cluster_shadow", route="cuda", source=cl.SOURCES["shadow"],
             replaces="mitsuba_customization_tpu/ops/clusters.py:659",
             launches=mp_launches["K4"], **k4_stats),
    ]
    # phases 17-32: launches of each render (or AD step), counted by the
    # wrappers; phases 33-34: those of each captured frame's and AD step's
    # replay, counted in its trace
    phase_launches = {
        "configs0": cfg0_launches, "materials": mat_launches, "blend": blend_launches,
        "blend_ad_step": blend_ad_launches, "image": image_launches,
        "emitters": emitter_launches, "image_ad_step": image_ad_launches,
        "camera": cam_launches, "camera_ad_step": cam_ad_launches, "shapes": shapes_launches,
        "shapes_sdf": sdf_launches, "volpath": vol_launches, "volpath_ad_step": vol_ad_launches,
        "ptracer": pt_launches, "bdpt": bd_launches, "xml_cli": xml_launches,
        "sharded": sh_launches, "sharded_ad_step": sh_ad_launches, "big_shapes": big_launches}

    def by_phase(key):
        return {**{p: launches[key] for p, launches in phase_launches.items()},
                **{"render_jit_" + f: jit[f]["launches"][key] for f in jit},
                **{"grad_jit_" + f: jit_ad[f]["launches"][key] for f in jit_ad}}

    for k, key in zip(kernels, ("K1", "K2", "K3", "K4")):
        k.update(share=k["bound_ms"] / k["ms"], frame_ms=frame[key][0],
                 frame_bound_ms=frame[key][1],
                 frame_share=frame[key][1] / frame[key][0], library_ms=None)
        # and the recorded calls' kernel ms and bound ms per frame
        k.update(launches_by_phase=by_phase(key),
                 materials_frame_ms=mat_frame[key][0], materials_frame_bound_ms=mat_frame[key][1],
                 blend_frame_ms=blend_frame[key][0], blend_frame_bound_ms=blend_frame[key][1],
                 image_frame_ms=image_frame[key][0], image_frame_bound_ms=image_frame[key][1],
                 camera_frame_ms=cam_frame[key][0], camera_frame_bound_ms=cam_frame[key][1],
                 shapes_frame_ms=shapes_frame[key][0], shapes_frame_bound_ms=shapes_frame[key][1],
                 volpath_frame_ms=vol_frame[key][0], volpath_frame_bound_ms=vol_frame[key][1],
                 ptracer_frame_ms=pt_frame[key][0], ptracer_frame_bound_ms=pt_frame[key][1],
                 bdpt_frame_ms=bd_frame[key][0], bdpt_frame_bound_ms=bd_frame[key][1])
    # bsdf_shade_pre / post (the BSDF stage around K2 and K1; no Pallas
    # kernel: the JAX package leaves the stage to XLA): phase 10's first
    # recorded bounce_shade call (bounce 0, 2,097,152 lanes) and the
    # frame's recorded calls, launches of the matpreview frame, phase 13's
    # AD step and every phase
    for name, key in (("bsdf_shade_pre", "SH-pre"), ("bsdf_shade_post", "SH-post")):
        stats = sh_stats[key]
        kernels.append(dict(
            name=name, route="cuda", source=bsdf_shade.SOURCE,
            replaces="none: mitsuba_customization_tpu/models/bsdf.py:327 (bounce_shade) and "
                     "models/tabulated.py:604 (bounce_shade), XLA fusions, no Pallas kernel",
            launches=mp_launches[key], **stats, share=stats["bound_ms"] / stats["ms"],
            library_ms=None, frame_ms=sh_frame[key][0], frame_bound_ms=sh_frame[key][1],
            frame_share=sh_frame[key][1] / sh_frame[key][0],
            launches_by_phase=dict(matpreview=mp_launches[key], ad_step=ad_launches[key],
                                   **by_phase(key))))
    # emitter_hit / _sample / _nee (the emitter stage; no Pallas kernel:
    # the JAX package leaves the stage to XLA): phase 10's first recorded
    # call of each (bounce 0) and the frame's recorded calls, launches of
    # the matpreview frame, phase 13's AD step and every phase
    from mitsuba_customization_tpu_torch.ops import emitter_shade

    for key, part in EM_PARTS.items():
        stats, sums = em_stats[key], em_frame[key]
        kernels.append(dict(
            name=EM_TRACE_NAMES[key][:-len("_kernel")], route="cuda",
            source=emitter_shade.SOURCE,
            replaces="none: mitsuba_customization_tpu/render/emitters.py and the bounce bodies "
                     "of render/integrator.py, XLA fusions, no Pallas kernel",
            launches=mp_launches[key], **stats, share=stats["bound_ms"] / stats["ms"],
            library_ms=None, frame_ms=sums[0], frame_bound_ms=sums[1],
            frame_share=sums[1] / sums[0], frame_call_device_ms=sums[2],
            frame_plain_device_ms=sums[3],
            launches_by_phase=dict(matpreview=mp_launches[key], ad_step=ad_launches[key],
                                   **by_phase(key))))
    # K1's backward: launches and in-frame times per AD step (phase 13)
    kernels.append(dict(
        name="merl_eval_bwd", route="cuda", source=k1.SOURCE_BWD,
        replaces="mitsuba_customization_tpu/ops/merl_sorted.py:439 "
                 "(_eval_bwd, XLA VJP, no Pallas kernel)",
        launches=ad_launches["K1-bwd"], **bwd_stats,
        library_note="index_add_ of precomputed (index, addend) pairs: the scatter part "
                     "only, no cell, clamp test or zeroing; compare with ms_into",
        share=bwd_stats["bound_ms"] / bwd_stats["ms"], frame_ms=ad_frame[0],
        frame_bound_ms=ad_frame[1], frame_share=ad_frame[1] / ad_frame[0],
        launches_by_phase={"ad_step": ad_launches["K1-bwd"],
                           "blend_ad_step": blend_ad_launches["K1-bwd"],
                           "image_ad_step": image_ad_launches["K1-bwd"],
                           "camera_ad_step": cam_ad_launches["K1-bwd"],
                           "volpath_ad_step": vol_ad_launches["K1-bwd"],
                           "xml_cli": xml_launches["K1-bwd"],
                           "sharded": sh_launches["K1-bwd"],
                           "sharded_ad_step": sh_ad_launches["K1-bwd"],
                           **{"grad_jit_" + f: jit_ad[f]["launches"]["K1-bwd"]
                              for f in jit_ad}}))
    # B1 / B2 (no Pallas kernel: the JAX BVH walk is an XLA while_loop):
    # phase 32's camera wavefront and NEE rays, its frame's launches and
    # recorded calls
    for name, key, stats, line in (("bvh_closest", "B1", b1_stats, 238),
                                   ("bvh_any", "B2", b2_stats, 290)):
        what = "intersect" if key == "B1" else "occluded"
        kernels.append(dict(
            name=name, route="cuda", source=bvh_mod.SOURCE,
            replaces=f"mitsuba_customization_tpu/render/bvh.py:{line} ({what}, XLA "
                     "while_loop, no Pallas kernel)",
            launches=big_launches[key], **stats, share=stats["bound_ms"] / stats["ms"],
            library_ms=None, frame_ms=big_frame[key][0], checked_frame_ms=big_frame[key][1],
            checked_frame_bound_ms=big_frame[key][2],
            frame_share=big_frame[key][2] / big_frame[key][1],
            launches_by_phase={"big_shapes": big_launches[key],
                               **{"render_jit_" + f: jit[f]["launches"][key] for f in jit},
                               **{"grad_jit_" + f: jit_ad[f]["launches"][key]
                                  for f in jit_ad}}))
    # T1, T2 (the tracking loops) and S1 (the SDF march), which replace the
    # JAX package's XLA while_loops (no Pallas kernel): phase 26's and 24's
    # first recorded call (the camera's wavefront), their frames' launches
    # and recorded calls
    from mitsuba_customization_tpu_torch.render import medium as medium_mod
    from mitsuba_customization_tpu_torch.render import sdf as sdf_mod

    for name, key, source, replaces, stats, sums, where, launches in (
            ("medium_delta_track", "T1", medium_mod.SOURCE,
             "mitsuba_customization_tpu/render/medium.py:55 (_tracking_loop over dt_body :293, "
             "XLA while_loop, no Pallas kernel)", t_stats["T1"], t_frame["T1"], "volpath",
             vol_launches["T1"]),
            ("medium_ratio_track", "T2", medium_mod.SOURCE,
             "mitsuba_customization_tpu/render/medium.py:55 (_tracking_loop over rt_body :386, "
             "XLA while_loop, no Pallas kernel)", t_stats["T2"], t_frame["T2"], "volpath",
             vol_launches["T2"]),
            ("sdf_march", "S1", sdf_mod.SOURCE,
             "mitsuba_customization_tpu/render/sdf.py:153 (_bounded_trace, XLA while_loop, no "
             "Pallas kernel)", s1_stats[0], s1_stats[1], "shapes_sdf", sdf_launches["S1"])):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches,
            **stats, share=stats["bound_ms"] / stats["ms"], library_ms=None,
            frame_ms=sums[0], frame_bound_ms=sums[1], frame_share=sums[1] / sums[0],
            frame_device_ms=sums[2],
            launches_by_phase={where: launches,
                               **{"render_jit_" + f: jit[f]["launches"][key] for f in jit},
                               **{"grad_jit_" + f: jit_ad[f]["launches"][key] for f in jit_ad}}))
    # T1-bwd / T2-bwd (the tracking's backward by replay), which replace the
    # XLA VJP of the JAX package's 48-step scan: phase 26's check on the
    # T1 / T2 call of the most lane steps, the launches of phase 27's AD
    # step (the main path's run) and of phase 34's replays
    for name, key, body in (("medium_delta_track_bwd", "T1-bwd", "dt_body :293"),
                            ("medium_ratio_track_bwd", "T2-bwd", "rt_body :386")):
        stats = t_bwd[key]
        kernels.append(dict(
            name=name, route="cuda", source=medium_mod.SOURCE,
            replaces="mitsuba_customization_tpu/render/medium.py:55 (_tracking_loop's lax.scan "
                     f"over {body} in ad_mode, its XLA VJP; no Pallas kernel)",
            launches=vol_ad_launches[key], **stats, share=stats["bound_ms"] / stats["ms"],
            library_note="index_add_ of the plain version's nonzero grid updates: the "
                         "scatter part only, no replay",
            launches_by_phase={"volpath_ad_step": vol_ad_launches[key],
                               **{"grad_jit_" + f: jit_ad[f]["launches"][key]
                                  for f in jit_ad}}))
    print("captured frames: " + json.dumps({f: {k: v for k, v in jit[f].items()
                                                   if k != "launches"} for f in jit}))
    print("captured AD steps: " + json.dumps({f: {k: v for k, v in jit_ad[f].items()
                                                     if k != "launches"} for f in jit_ad}))
    print("optimize, median step s (captured, eager): " + json.dumps(opt_seconds))
    print(f"volpath frame tracking loops: {vol_steps} steps of the slowest lanes, {vol_checks} "
          f"host checks; volpath AD step: {vol_grid_buffers} grid-sized gradient buffers")
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}; total "
          f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
