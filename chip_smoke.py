#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supereight_tpu_torch``) on one NVIDIA
GPU.

1. Requires a CUDA device and prints its name and power limit, then builds
   every kernel from ``supereight_tpu_torch/csrc`` (one nvcc per source,
   all started together).
2. Holds the ICP kernels (``csrc/icp.cu``) against their twins on the
   operands of the headline frame ICP_FRAME (the system warmed on the
   frames before it): kernel A ``icp_track_reduce`` at the level shapes
   80x60, 160x120 and the decimated 160x120, and on rank 1's row strip of
   it of 2 ranks, in each of the 18 knob groups (nearest / bilinear x
   symmetric off / on / the device gate x no / Huber / Tukey weights), the
   status image bit for bit and the sums within ICP_SUM_RTOL +
   ICP_SUM_MAG x their terms' absolute sum; kernel B ``icp_update`` on
   kernel A's sums, the twist and pose within ICP_UPDATE_ATOL + the
   float32 solve's error bound (each beside its distance from the float64
   solve); kernel A with those sums pending (the sharded trip: the
   previous trip's update inside its launch), its carry kernel B's bit
   for bit, its status image and sums kernel A's from that carry; kernel
   A with an update inside timed at every shape, kernel B alone, beside
   the launch floor and their bounds, and both kernels' ``-Xptxas -v``
   lines with the frustum selection's (``select_trip_registers``); a whole
   ``track`` on the kernels against one on CPU copies of its operands (the
   twins; ICP_TRACK_ATOL, ICP_TRACK_FLIPS); and ``track_levels`` under
   ``torch.cuda.set_sync_debug_mode("error")``: the level loops must not
   synchronise, and on one device launch ``icp_track_levels`` once and the
   pair never.  ``icp_track_levels`` (every trip of every level in one
   cooperative launch with no grid barrier, the view formed inside it; its
   CTAs, threads and registers printed, its ``-Xptxas -v`` line held to
   LOOK_BACK_AND_TRIP) is held against its twin at the headline's level
   set and with the whole 320x240 finest level (ICP_LEVEL_SETS) in every
   knob group: one trip at the finest level (status image bit for bit,
   sums within the tolerances above), the headline's pyramid (pose within
   ICP_TRACK_ATOL, flipped statuses counted); two launches give the same
   bits; its device time a headline frame is printed beside its bound, its
   twin's, the pair's for the same trips, the launch floor and the card.
   Then the frame's glue, each kernel against its twin bit for bit and
   timed beside the launch floor and its bound: ``build_pyramid``
   (``csrc/pyramid.cu``, every level in one launch) on headline frames
   PYRAMID_FRAMES at both ``neg_y``, then on a headline frame and on the
   random PYRAMID_ODD depth with holes at every level count it takes,
   against the twin on the card and on the CPU, one launch a call, and
   raising above its largest count; ``pose_inv`` (``csrc/numerics.cu``,
   one thread, a template on n in registers: its ``-Xptxas -v`` line for
   n = 4 printed, no stack frame, no spills, no local loads or stores in
   its SASS) on every pose of the three cached sequences, on K and on
   ``pivot_matrices`` (every pivot pattern at n = 1, 2 and 4, the sizes
   where its steps are XLA's; every other n must raise), against the host
   twin and timed beside ``torch.linalg.inv``; ``frustum_select``
   (``csrc/integrate.cu``, one launch: the pose's inverse in each CTA, a
   look-back over its tiles; its T_cw pose_inv's bit for bit, its scratch
   zero after each launch) on the headline map after 12 frames at its
   budget, 3072, and at one its candidates overflow, and on maps of a
   frame's blocks at SELECT_CAPACITIES, each timed (each preset's run
   holds it again on its own map: 6144, 24576 and 196608 slots);
   ``update_nodes`` (``csrc/integrate.cu``: inside the fusion's
   launch, alone a fusion launch with no rows) on random node
   tables at 256^3 and 1024^3 for both fields, alone and inside the
   fusion's launch at 3072 slots of a map of the frame's blocks, timed
   beside the two launches apart (each preset's run holds it again on its
   own map inside its fusion).
   Then the raycast (``csrc/raycast.cu``), each kernel against its twin
   bit for bit on the same operands and the whole ``raycast`` against
   ``raycast_twin`` on the card and against ``raycast`` on CPU copies:
   R1 ``splat_bounds`` (one launch with the view's inverse inside it,
   twice in a row on the same operands, and on a 640x480 grid above
   kPoolSmemCells), R2 ``ray_scan`` alone, the merged launch of R2 with R3
   (``ray_scan_second``: the second window and the midsolve, ranked by a
   look-back on the card) and R4 ``ray_refine_normals`` (in 2-D tiles;
   R1's, the merged scan's and R4's ``-Xptxas -v`` lines: no stack
   frame, no spills) on the
   headline map after RAYCAST_FRAMES frames in every knob group of
   RAYCAST_MODES (every normals and refine mode of the presets and of
   phase F, the second window cut by a budget of RAYCAST_BUDGET, rank 1's
   row strip of 2) and
   on the ofusion map in those of RAYCAST_OF_MODES, timed at the
   headline's knobs beside the launch floor and their bounds; each
   preset's and phase-F run holds them again on its final map from its
   last pose.
3. Holds the SDF and the OFusion fusion kernel, each updating a map's
   block table in place and the node pyramid in the same launch, against
   their plain PyTorch twins (then ``update_nodes_twin``) on clones of the
   same table at main-path shapes (3072 distinct slots of a real map, a
   320x240 depth): whole tables, ``active`` and the node tables compared,
   with the median device time of each, of the rows and the nodes apart,
   the kernel's bound and its ``-Xptxas -v`` line (at most 40 registers,
   no more spill stores than before the node update went in).
4. Holds the gather-probe kernels (K2 ``lane_shuffle_sum``, K3
   ``slab_row_sum``) against their twins at the probe's shapes and at a
   second shape each (K2 at 65536 rows, K3 at 8192 slabs), bit for bit,
   timed beside the launch floor (an empty kernel) and their bounds, then
   runs the probe (``probes/gather_probe.py``), the kernels' own path, and
   prints its four measurements.
5. Runs the slice's entry points as users run them, each with the fusion
   and ICP kernels' counts set to 0 just before and read just after (every
   integrated frame must launch a fusion kernel; every frame on which ICP
   runs must launch ``icp_track_levels`` exactly once and the pair never
   on the one-device paths, B, D, the presets, F and G3's one-device
   frame; on G's ranks kernel A once a trip of every level (the previous
   trip's update inside it), kernel B once a level and
   ``icp_track_levels`` never; on the presets and F,
   ``build_pyramid`` at least once a frame with ICP (one launch a call),
   ``pose_inv`` at least once an integrated frame of the whole-table
   branch (the budget branch's inverse is inside the selection's launch,
   the tracking view's inside ``icp_track_levels``'), the view formed
   inside ``icp_track_levels`` equal to the card's ``camera_matrix(k) @
   inv(raycast_pose)`` bit for bit at every raycast pose of the run (the
   presets), ``update_nodes`` once an integrated frame
   and once inside each fusion launch, and ``frustum_select`` once an
   integrated frame on the budget branch; on every path R1, R2
   and R4 once a raycast that fires, R3 (its count: the launches of R2
   that ran the second window or the midsolve) too where one of those is
   on; on G's ranks the four as often as each other):
   A. ``apps.benchmark`` in ground-truth mode (``-g``) at the headline
      preset on the cached base sequence, written as a .raw stream and a
      TUM trajectory with the port's ``io``: 96/96 frames, ATE < 1e-4 m,
      overflow 0, blocks within 0.5 % of the JAX package's on the CPU;
   B. the same in ICP mode (``-p 0.5,0.5,0.23``) with the renderers every
      4th frame: >= 88 tracked, ATE <= the JAX CPU run's + 1 cm, 96 TSV
      rows, the last ``renderVolume`` shading half the pixels;
   C. ``DenseSLAMSystem.step(gt_pose=)`` at the configuration of the TPU
      record ``bench_data/ate_icp_256_gt.json``: blocks within 0.5 % of
      the JAX CPU run's;
   D. ``apps.runner.run("synthetic-room", resolution=256)``, its 120 frames
      sphere-traced on the card (the trace timed alone first): tracked
      share >= 0.92, ATE <= the JAX CPU run's + 1.5 cm;
   E. the map outputs: A's command line with ``-d E.npz --dump-mesh
      E.vtk``: the mesh's triangles within 0.5 % of the JAX package's on
      the CPU, the triangles of the first 2048 live blocks meshed on the
      card and on the CPU from the same map equal in count, order and bits,
      ``serialise.load_map`` of the checkpoint equal to the live map's
      tables bit for bit, and ``save_se`` -> ``load_se`` on the card giving
      back the same blocks, slots and voxel tables; the mesh is timed
      (CUDA events and the host clock) beside the VTK write.
6. Runs the nine presets of ``supereight_tpu_torch/config.py``
   (``headline``: SDF, 256^3 over 4.8 m, 320x240, capacity 6144, fusion
   budget 3072; ``ofusion``; then the seven others), each at the size of
   its JAX record over the 96 frames of its cached sequence in
   ``bench_data/``, and checks tracked frames, ATE, blocks and overflow
   (the ATE gate is the JAX package's own CPU run + 0.5 cm, 1 cm for
   ``trans`` and 2.5 cm for ``noise``, `jax_cpu_reference.py`; overflow is
   gated only where the TPU record's is 0), that the frames went through
   the kernel, and that ``headline`` and ``ofusion`` repeat the earlier
   runs' counts.  After each run the fusion kernel is held against its
   twin on clones of the run's map with the slots its fusion takes (every
   live slot, or the budget's frustum candidates): whole tables,
   ``active`` and the held SDF view compared, the slots not fused
   unchanged; the device time of that in-place launch is the fusion
   step's.  Where the candidates are fewer than the budget, it is held
   again at the budget's shape: a table of that many distinct slots
   repeating the candidates' blocks.  The held SDF view of
   ``demo512-sdf`` is held against a full rebuild; each run prints its
   peak device memory.  After ``1024-quality`` its whole map is meshed on
   the card: blocks, triangles, device and host time, peak memory.

7. Phase F: the ``headline`` preset over the base sequence with one knob
   group over it each run (``F_RUNS``): F1 stored normals, F2 stored
   normals with the plane refine, F3 the midsolve, F4 Huber weights with
   bilinear association and symmetric ICP, F5 the per-frame symmetric gate
   (``"auto"``), F6 the frame-to-frame bootstrap and fallback.  Each holds
   the presets' gates (tracked >= 88, ATE <= the JAX package's CPU run +
   0.5 cm, overflow 0, a fusion launch every integrated frame, the last
   raycast hitting half the pixels); with stored normals the held gradient
   table equals ``gradmap.build_table`` of the final map on the card and
   the CPU's table of the same map, bit for bit.
8. Phase G: the multi-device map (``supereight_tpu_torch/parallel``)
   through ``multihost.launch_jobs``, 2 ranks (nccl with one card a rank
   where the host has two, else gloo on CUDA tensors with the ranks
   sharing the card; the choice is printed), each rank a process that
   reads the cached frames itself and holds a 3072-slot range of the map
   (``G_RUNS``): G1 ``headline`` and G2 ``ofusion`` at full size with
   ``map_partitions=2`` over the 96 frames, held to the JAX package's
   sharded frame on a 2-device CPU mesh (``JAX_CPU_G``: tracked >= 88,
   ATE <= its + 0.5 cm, blocks within 0.5 %, the same overflow, part
   counts summing to the blocks); G3 the first 4 frames of ``headline``
   held to the one-device partitioned frame on the card
   (``multihost.compare``).  Each rank's fusion counts are set to 0 just
   before its frames and read just after (every rank launches on every
   integrated frame), and the fusion kernel each of G1 / G2 ran is held
   against its twin on rank 0's operands.  Rank 0 prints its median ms
   per frame and per stage after frame 16, its time in collectives (host
   clock around each call, the device synchronised) and the exchange's
   rows and bytes per refresh.

The app phases (A, B, E) check that the app read the ``.raw`` stream
through the native reader (``io.native``, built from
``supereight_tpu_torch/csrc/io_native.cpp`` with the host compiler beside
the kernels).  Every preset is built with ``config.apply_preset``.  Each run prints its
wall time, the median ms per frame and the median of each stage (from a
second run through ``step_staged``).

Run from the repository root:  python3 chip_smoke.py
It exits non-zero, printing no result line, if there is no CUDA device or
any check fails.  The last line of its output is one JSON object; the line
before it lists every kernel with its launches summed over the runs that
took it (the app phases, the presets and phase G's ranks), its largest
difference from its twin, the median device times of both at the 3072-row
shapes (the probe's for K2 and K3, the decimated 160x120 level for the
pair, a headline frame's pyramid for ``icp_track_levels``, the headline
map's raycast at 12 frames for R1-R4), the least time
the card could take for that work (``bound_ms``: the bytes the call must
move at 3.35 TB/s or its float32 operations at 67 TFLOP/s, the larger;
for a fusion kernel, the bytes of the voxels this data updates) and,
where one PyTorch call computes the same function, that call's time.
Each fusion hold, and each K2 / K3 hold, also prints the least time its
warps take to issue their instructions, from the compiled code
(`probes/sass_count.py`); K2's and K3's entries carry it (``issue_ms``),
K2's its shared-memory bound (``smem_ms``), K3's the time its distinct
slabs take at the rate one PyTorch reduction reads its L2-resident table
(``resident_ms``, beside that rate), both the launch floor and their times
at the second shape (``at_scale``: the kernel's, the twin's and the one
PyTorch call's).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DATA = os.path.join(HERE, "bench_data")
FRAMES = os.path.join(BENCH_DATA, "synthetic_256_frames.npz")
K = np.array([240.6, 240.0, 160.0, 120.0], np.float32)   # 320x240 frames
#: the size every preset runs on unless it sets its own (its JAX record's)
BASE = dict(volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
            block_capacity=6144)

#: the JAX package's own run of each preset on the CPU at its record's size
#: over the same 96 frames (ATE cm, blocks; `jax_cpu_reference.py`): the
#: JAX records in bench_data/ were taken on a TPU, whose rounding the CPU
#: does not share
JAX_CPU = {"headline": (0.97, 2767), "ofusion": (0.92, 3674),
           "quality": (1.07, 2951), "trans": (3.13, 3141),
           "noise": (5.66, 6144), "demo512-sdf": (1.36, 17961),
           "demo512-ofusion": (1.74, 22116),
           "ofusion-fidelity": (0.92, 2050), "1024-quality": (0.99, 128318)}
#: the ATE gate over JAX_CPU, in cm: the port parts from the JAX package by
#: rounding, which ICP amplifies (up to 0.44 cm on trans in the port's CPU
#: run); noise is chaotic in the JAX package itself (a one-ulp nudge of the
#: depth moves its pose by 6 mm, and rounding-only changes of the port moved
#: its ATE on the card between 6.1 and 7.6 cm)
ATE_MARGIN_CM = {"trans": 1.0, "noise": 2.5}
ATE_MARGIN_DEFAULT_CM = 0.5


def jax_cpu(name: str):
    """(ATE cm, blocks) of the JAX package's CPU run of a preset or a
    phase-F run."""
    return JAX_CPU[name] if name in JAX_CPU else JAX_CPU_F[name]


def ate_gate(name: str) -> float:
    """A preset's or a phase-F run's ATE gate in metres."""
    return 0.01 * (jax_cpu(name)[0]
                   + ATE_MARGIN_CM.get(name, ATE_MARGIN_DEFAULT_CM))


#: preset: (cached sequence, the JAX package's record in bench_data/, ATE
#: gate in m)
RUNS = {name: (sequence, record, ate_gate(name))
        for name, sequence, record in (
    ("headline", "synthetic_256_frames",
     "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_gd2.json"),
    ("ofusion", "synthetic_256_frames",
     "ate_icp_ofusion_256_hybrid_id2_ib3072_ss1_iv_nr_z4.json"),
    ("quality", "synthetic_256_frames", "ate_icp_256_sy_nr.json"),
    ("trans", "synthetic_256_frames_trans",
     "ate_icp_ofusion_256_trans_nr_z4.json"),
    ("noise", "synthetic_256_frames_noisy",
     "ate_icp_ofusion_256_bf_noisy_nr_z4.json"),
    ("demo512-sdf", "synthetic_256_frames",
     "ate_icp_512_hybrid_id2_ib24576_ss1_sy_gd2_iv_fr.json"),
    ("demo512-ofusion", "synthetic_256_frames",
     "ate_icp_ofusion_512_hybrid_id2_ib6144_ss1_aod0.01_iv_nr_z4.json"),
    ("ofusion-fidelity", "synthetic_256_frames",
     "ate_icp_ofusion_256_exact_pl_nr_z4_mu0.008.json"),
    ("1024-quality", "synthetic_256_frames",
     "ate_icp_ofusion_1024_id2_ib98304_ss1_aad16x0.3_iv_nr_z4.json"))}
#: phase F: the headline preset on BASE over the cached base sequence, one
#: knob group over it each run: {run: (knobs, the JAX package's record in
#: bench_data/, a TPU run: a reference point, not a gate)}
F_RUNS = {
    "F1": (dict(raycast_normals="stored"), "ate_icp_256_stored.json"),
    "F2": (dict(raycast_normals="stored", raycast_refine="plane"),
           "ate_icp_256_stored_pl.json"),
    "F3": (dict(raycast_midsolve=True),
           "ate_icp_256_hybrid_id2_ib3072_ss1m.json"),
    "F4": (dict(icp_robust="huber", icp_robust_delta=0.01,
                icp_assoc="bilinear", icp_symmetric=True),
           "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_rbh0.01_bl_sy_"
           "gd2.json"),
    "F5": (dict(icp_symmetric="auto"),
           "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_sya_gd2.json"),
    "F6": (dict(bootstrap_f2f=True, f2f_fallback=True),
           "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_f2f_gd2.json"),
}
#: the JAX package's own run of each phase-F run on the CPU (ATE cm,
#: blocks; `jax_cpu_reference.py --parts phase_f`)
JAX_CPU_F = {"F1": (0.97, 2775), "F2": (1.11, 2745), "F3": (0.90, 2802),
             "F4": (0.97, 2782), "F5": (0.95, 2767), "F6": (0.82, 2733)}
#: phase G: the multi-device map (`supereight_tpu_torch/parallel`) through
#: ``multihost.launch_jobs``: {run: (preset on BASE with map_partitions =
#: ranks, ranks, exchange rows a rank, frames of the base sequence)}; G3
#: is held against the one-device partitioned frame on the card
G_RUNS = {"G1": ("headline", 2, 3072, 96), "G2": ("ofusion", 2, 3072, 96),
          "G3": ("headline", 2, 3072, 4)}
#: the app phases: the README's command line on the cached base sequence
#: (the headline preset; -g gives ground-truth poses, -p the ICP start)
APP_ARGS = ["-s", "4.8", "-v", "256", "-k", "240.6,240,160,120",
            "--preset", "headline"]
APP_ICP_START = ["-p", "0.5,0.5,0.23"]
#: the JAX package's results on the CPU for the app phases
#: (`jax_cpu_reference.py`): blocks of the app in ground-truth mode, ATE
#: (cm) and blocks of the app in ICP mode, blocks of the facade in
#: ground-truth mode at the configuration of bench_data/ate_icp_256_gt.json
#: (whose TPU run allocated 2686), the runner's ATE (cm) and tracked
#: share on its synthetic room, and the triangles of the mesh the app in
#: ground-truth mode dumps (phase E)
JAX_CPU_APP = dict(gt_blocks=2607, icp_ate_cm=4.03, icp_blocks=2914,
                   facade_gt_blocks=2658, runner_ate_cm=2.98,
                   runner_tracked=0.967, gt_triangles=606182)
TPU_GT_BLOCKS = 2686
BLOCKS_RTOL = 0.005          # blocks within 0.5 % of the JAX run's
GT_MAX_ATE_M = 1e-4          # ground-truth poses come back unchanged
APP_ICP_ATE_MARGIN_CM = 1.0
RUNNER_MIN_TRACKED = 0.92
RUNNER_ATE_MARGIN_CM = 1.5
#: least share of the last volume rendering's pixels that are shaded
MIN_SHADED = 0.5
#: runs of the sphere trace timed by CUDA events
TRACE_RUNS = 5
#: phase E meshes this many live blocks on the card and on the CPU and
#: holds the triangles equal
MESH_HOLD_BLOCKS = 2048
#: the preset whose whole map is meshed on the card after its run
MESH_AT_SCALE = "1024-quality"

#: the counts the earlier runs of this code gave on the card; the path is
#: deterministic, so they repeat exactly (taken again whenever the order of
#: a sum changes: when JTJ became a reduction instead of a GEMM, when
#: icp_track_reduce took the sums over, in its fixed order, when the
#: hybrid normal's dot product became numerics.dot3's (x + y) + z, as on
#: the CPU, and when icp_track_levels took its warps' sums by a butterfly
#: and its CTAs' partials over the CTAs that own pixels: two runs in one
#: call gave these counts)
REPEAT = {"headline": dict(tracked=92, ate_cm=0.97, blocks=2767, overflow=0),
          "ofusion": dict(tracked=92, ate_cm=0.91, blocks=3673, overflow=0)}
MIN_TRACKED = 88
#: least share of the last raycast's pixels that hit the map; ``noise``
#: fills its table (its record overflows by 1891 blocks), so surface past
#: the capacity is never allocated and cannot be hit
MIN_HIT = dict(noise=0.4)
OF_RTOL, OF_ATOL = 1e-5, 1e-6   # occupancy: the last bits of logf; the
#                                 SDF, visible and timestamp bit for bit
TIMED_RUNS = 25
#: the H100 SXM's device memory rate and float32 rate outside the tensor
#: cores (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: float operations (an fma counts two) of a voxel's projection and patch
#: test, and of a fused voxel's update, counted in csrc/integrate.cu
PROJECT_FLOPS = 34
UPDATE_FLOPS = {"fuse_sdf": 19, "fuse_ofusion": 50}


#: the kernels of the JSON line, in its order
KERNEL_ORDER = ("fuse_sdf", "fuse_ofusion", "lane_shuffle_sum",
                "slab_row_sum", "icp_track_reduce", "icp_update",
                "icp_track_levels", "build_pyramid", "pose_inv",
                "frustum_select", "update_nodes", "splat_bounds",
                "ray_scan", "ray_scan_second", "ray_refine_normals")
#: the frame's glue on the card: the tracking pyramid (one launch a call),
#: the 4x4 inverse, the fusion's frustum selection and the node pyramid's
#: update, each held bit for bit to its twin
GLUE = ("build_pyramid", "pose_inv", "frustum_select", "update_nodes")
#: entries of the kernels line whose launches run inside another entry's
#: kernel (marked ``launches_counted_in``): R2 is the merged scan's kernel
#: (timed with both knobs off), the node update runs in the fusions'
#: launches (timed alone, a fusion launch with no rows)
LAUNCHES_COUNTED_IN = {"ray_scan": "ray_scan_second",
                       "update_nodes": ["fuse_sdf", "fuse_ofusion"]}
#: the cached sequences whose every pose pose_inv is held on
SEQUENCES = ("synthetic_256_frames", "synthetic_256_frames_trans",
             "synthetic_256_frames_noisy")
#: the headline frames the pyramid is held on
PYRAMID_FRAMES = (0, 30, 60, 95)
#: the shape of ``random_depth`` (odd at every level), on which the
#: pyramid is also held at every level count the kernel takes
PYRAMID_ODD = (61, 83)
#: float operations (an fma counts two) the glue needs: a pyramid pixel
#: (its half sample 13, its vertex 6, its normal 24), an inverse (the 4x4
#: LU and the four solves), a frustum test of a live slot (centre 3, the
#: projection 22, the footprint and bounds 10) and a node cell (its
#: corner and projection 25, the test 5, the field's update: SDF 19,
#: OFusion 50), counted in csrc/pyramid.cu, numerics.cu and integrate.cu
PYRAMID_FLOPS = 43
INV_FLOPS = 200
SELECT_FLOPS = 35
#: the larger capacities the selection is held and timed at beside the
#: headline's 6144 slots: (map size, capacity, budget) of
#: demo512-ofusion's and 1024-quality's
SELECT_CAPACITIES = ((512, 24576, 6144), (1024, 196608, 98304))
NODE_FLOPS = {"sdf": 49, "ofusion": 80}
#: a node cell's bytes: its two channels and flag read, its two new
#: channels written (the depth image is counted once, beside the cells)
NODE_CELL_BYTES = 4 + 4 + 1 + 4 + 4
FUSION = ("fuse_sdf", "fuse_ofusion")
#: the sharded frame's ICP kernels (a trip: kernel A with the previous
#: trip's update inside, then the all_reduce; a level's last update:
#: kernel B), and the one-device frame's (every trip in one launch)
ICP_PAIR = ("icp_track_reduce", "icp_update")
ICP = ICP_PAIR + ("icp_track_levels",)
#: icp_track_levels is held at the headline's level set (its finest level
#: strided by its icp_finest_decimate, 2) and with the whole 320x240
#: finest level, by the finest level's stride
ICP_LEVEL_SETS = {"headline": 2, "320x240": 1}
#: the ICP holds: the headline frame whose operands they take (after the
#: frames before it), its level shapes by (level, stride, (rank, ranks)
#: strip or None): levels 2 and 1, the finest level strided by the
#: preset's icp_finest_decimate, and rank 1's strip of it of 2 ranks
ICP_FRAME = 50
ICP_SHAPES = {"80x60": (2, 1, None), "160x120": (1, 1, None),
              "160x120 decimated": (0, 2, None),
              "160x120 decimated, rank 1 of 2": (0, 2, (1, 2))}
#: the shape the kernels are timed at (the headline's level 0)
ICP_MAIN = "160x120 decimated"
#: the knob groups every shape is held in: association x symmetric residual
#: (off, on, the per-frame gate on the device) x IRLS weights
ICP_KNOBS = tuple(dict(assoc=a, symmetric=y, robust=r,
                       robust_delta=0.02 if r == "tukey" else 0.01)
                  for a in ("nearest", "bilinear")
                  for y in ("off", "on", "gate")
                  for r in ("none", "huber", "tukey"))
#: tolerances: kernel A's sums within ICP_SUM_RTOL of the twin's plus
#: ICP_SUM_MAG times the sum of their terms' absolute values (another
#: summation order), its status image bit for bit; kernel B's twist within
#: ICP_UPDATE_ATOL of the twin's plus the forward-error bound of a float32
#: Cholesky solve of the same system, 2 eps cond(JTJ) |x| (a float32
#: Cholesky in another order than torch.linalg's: on the 80x60 level with
#: Tukey weights, cond 6450, the twin lies 2.2e-6 from the float64 solve
#: and the kernel 2.3e-7), its pose within ICP_UPDATE_ATOL plus that bound
#: times the pose's largest column sum; a whole ``track`` on the kernels
#: within ICP_TRACK_ATOL of one on the twins, ICP_TRACK_FLIPS of its status
#: pixels flipped: the tolerance the multi-device frame holds for the same
#: ICP with its sums added in another order (``multihost.compare``, the
#: JAX package's 1-vs-N pose tolerance), since ICP amplifies the sums' last
#: bits from trip to trip (1.6e-5 m at headline frame 50 in the first run)
ICP_SUM_RTOL, ICP_SUM_MAG = 1e-5, 1e-6
ICP_UPDATE_ATOL = 1e-6
FP32_EPS = 2.0 ** -23
ICP_TRACK_ATOL, ICP_TRACK_FLIPS = 1e-4, 1e-3
#: float operations (an fma counts two) of kernel A a pixel (nearest, no
#: symmetric residual, no weights: projection 40, rotation 15, residuals
#: 28, the 29 terms 51 and their sums 29) and of kernel B a trip (the 6x6
#: Cholesky and its two solves 220, the exponential 100, the 4x4 product
#: 112), counted in csrc/icp.cu
ICP_PIXEL_FLOPS = 163
ICP_UPDATE_FLOPS = 432


def pivot_matrices() -> dict:
    """Matrices that drive every pivot pattern of the inverse's LU
    (float32, from a seed): the 24 row orders of a diagonally dominant 4x4,
    each a pivot sequence of its own, and for each n = 1..8 a random
    matrix, a zero pivot in the first column (and in the second), a NaN
    pivot and a singular matrix (row 1 twice row 0); and at 1, 2 and 4
    rows, where the inverse is XLA's, a subnormal, an infinite and a huge
    first pivot (its reciprocal subnormal), subnormal products in the
    second column, every entry subnormal, an infinite last diagonal entry,
    a zero that an underflowed product leaves in the LU's triangular solve
    (XLA's CPU code flushes subnormals to zero: numerics.inv_twin), and a
    NaN below the first row, alone and with a +inf or -inf, in columns 0-2
    (OpenBLAS's isamax: numerics._isamax)."""
    rng = np.random.default_rng(11)
    base = np.diag([8.0, 4.0, 2.0, 1.0]) + rng.uniform(-0.3, 0.3, (4, 4))
    out = {"rows " + "".join(map(str, p)): base[list(p)]
           for p in itertools.permutations(range(4))}
    for n in range(1, 9):
        def m():
            return rng.normal(size=(n, n)).astype(np.float32)
        out[f"random {n}"] = m()
        out[f"zero pivot {n}"] = z = m()
        z[:, 0] = 0.0
        out[f"nan pivot {n}"] = z = m()
        z[0, 0] = np.nan
        if n > 1:
            out[f"zero second pivot {n}"] = z = m()
            z[:, 1] = 0.0
            out[f"singular {n}"] = z = m()
            z[1] = 2.0 * z[0]
    rng = np.random.default_rng(12)
    for n in (1, 2, 4):
        def m():
            return rng.normal(size=(n, n)).astype(np.float32)
        for tag, v in (("subnormal", 1e-39), ("infinite", np.inf),
                       ("huge", -3e38)):
            out[f"{tag} pivot {n}"] = z = m()
            z[:, 0] = 0.0
            z[0, 0] = v
        if n > 1:
            out[f"subnormal products {n}"] = z = m()
            z[:, 1] = 0.0
            z[1, 1] = 2e-38
            out[f"all subnormal {n}"] = m() * np.float32(1e-39)
            out[f"infinite diagonal {n}"] = z = m()
            z[n - 1, n - 1] = -np.inf
    # a NaN below the first row, where OpenBLAS's isamax can pick the NaN
    # or an entry after it (numerics._isamax)
    out["nan below the first row 4"] = np.array(
        [[1, 2, 0, 0], [np.nan, 3, 0, 0], [0, 0, 1, 0], [np.inf, 0, 0, 1]])
    rng = np.random.default_rng(13)
    for n in (2, 4):
        for c in range(min(n, 3)):
            last = n - 1
            out[f"nan in column {c} {n}"] = z = rng.normal(size=(n, n))
            z[min(c + 1, last), c] = np.nan
            z[last, c] = 4.0 if c + 1 < last else z[last, c]
            for sign in (1, -1):
                out[f"nan and {sign:+d}inf in column {c} {n}"] = z = \
                    rng.normal(size=(n, n))
                z[min(c + 1, last), c] = np.nan
                z[last if c + 1 < last else max(c - 1, 0), c] = sign * np.inf
    out["flushed zero 4"] = np.array(
        [[9.9999997e-21, 1.0e+20, 1.2687483e-37, 1.3059919e+22],
         [6.1610434e-13, 9.9999997e-20, 5.4581766e+14, -8.0940120e-40],
         [1.2616628e+20, -1.5375848e-13, 2.0702150e-07, 1.5e-38],
         [-2.4650041e-12, 4.6421881e+30, -0.0, 1.9351799e-23]])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def random_depth(shape=PYRAMID_ODD):
    """A random depth image (m) with 15 % holes, and intrinsics (fx, fy,
    cx, cy) with a negative fy, from a seed."""
    rng = np.random.default_rng(7)
    d = rng.uniform(0.3, 4.0, shape).astype(np.float32)
    d[rng.random(d.shape) < 0.15] = 0.0
    return d, np.array([70.1, -68.0, 41.5, 30.2], np.float32)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ate_rmse(est, gt) -> float:
    """RMSE of the estimated positions of the poses ``est`` [n,4,4] after
    the least-squares rigid alignment to the ground truth ``gt`` (Horn):
    the port's ``apps.evaluate.ate``."""
    from supereight_tpu_torch.apps import evaluate
    return evaluate.ate(list(est), list(gt))["rmse"]


def preset_config(name: str):
    """The named preset of the port's config on BASE."""
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    return apply_preset(name, SlamConfig(**BASE))


def load_sequence(name: str):
    z = np.load(os.path.join(BENCH_DATA, name + ".npz"))
    return z["depths"], z["poses"]


def load_record(file: str) -> dict:
    with open(os.path.join(BENCH_DATA, file)) as f:
        r = json.load(f)
    # the older records carry no tracked count
    return dict(tracked=r.get("tracked_frames"),
                ate_cm=100 * r["ate_rmse_m"], blocks=r["blocks"],
                overflow=r["overflow"])


def median_ms(fn, setup=None) -> float:
    """Median device time (ms) of ``fn`` over TIMED_RUNS runs, each after
    an untimed ``setup``."""
    from supereight_tpu_torch.probes.timing import device_times_ms
    return statistics.median(device_times_ms(fn, TIMED_RUNS, setup))


def times(fn, plain):
    """Median device times (ms) of a kernel call and of its twin."""
    return median_ms(fn), median_ms(plain)


def build_kernels():
    """Every kernel source (one nvcc each) and the native reader (the host
    compiler), started together."""
    from supereight_tpu_torch.ops import _build
    t0 = time.perf_counter()
    names = _build.SOURCES + _build.HOST_SOURCES
    _build.build_all(names)
    print(f"# kernels and the native reader built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in names:
        lib_path = _build.library_path(name)
        print(f"#   {os.path.relpath(lib_path, HERE)}")
        log = lib_path.with_name(lib_path.name + ".log")
        for line in log.read_text().splitlines():
            if "entry function" in line:
                print(f"#   ptxas: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                print(f"#   ptxas: {line.strip()}")


def bound(nbytes: float, flops: float):
    """(bound ms, what binds): the larger of the bytes at the memory rate
    and the float32 operations at the float32 rate."""
    b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    o_ms = 1e3 * flops / FP32_FLOPS_PER_S
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


@functools.lru_cache(maxsize=None)
def issue_model():
    """The fusion kernels' compiled main bodies (``cuobjdump -sass``) and
    the card's warp-instruction issue rate, for the issue lower bound."""
    from supereight_tpu_torch.probes import sass_count
    return sass_count.kernel_bodies(), sass_count.card_issue_rate()[4]


def clone_tables(m):
    """``m`` with its own copy of the tables a fusion updates."""
    return m.replace(voxels={k: v.clone() for k, v in m.voxels.items()},
                     active=m.active.clone())


def hold_kernel(torch, label, kernel, m, field, frame, now, slots=None,
                view=None):
    """The in-place fusion kernel with the node pyramid's update in its
    launch (``nodes=True``, as the main path runs it) and its twin (the
    fusion's, then ``update_nodes_twin``) on clones of ``m``'s tables (and
    of ``view``) with ``slots`` (None: every live slot).  Whole tables and
    ``active`` must agree (the SDF and its view, visible and timestamp bit
    for bit, occupancy within OF_RTOL / OF_ATOL), every node level's new
    tables bit for bit, the slots not fused must keep their rows and
    flags, and some voxel must fuse.  Then both are timed, launching again
    on their clones, and the kernel also without the nodes (``rows_ms``)
    and with the nodes alone (``nodes_ms``: ``update_nodes``, a launch with
    no rows).  Returns dict(rows, max_abs_err, ms, plain_ms, rows_ms,
    nodes_ms, bound_ms, bound_by, issue_ms)."""
    from supereight_tpu_torch.core import morton, octree
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.probes import sass_count

    if kernel == "fuse_ofusion":
        names, params = ik.OFUSION_CHANNELS, (field.mu, field.sigma_lo, now)
    else:
        names, params = ik.SDF_CHANNELS, (field.mu, field.max_weight)
    fn, plain = getattr(ik, kernel), getattr(ik, kernel + "_twin")
    km, tm = clone_tables(m), clone_tables(m)
    kw = [{}, {}] if view is None else [dict(view=view.clone()),
                                         dict(view=view.clone())]
    run = lambda: fn(km, *frame, *params, slots=slots, nodes=True, **kw[0])
    run_plain = lambda: plain(tm, *frame, *params, slots=slots, nodes=True,
                              **kw[1])
    got_nodes = run()
    want_nodes = run_plain()
    torch.cuda.synchronize()
    node_err = hold_node_tables(torch, label, kernel, m, got_nodes,
                                want_nodes)

    rows = (torch.nonzero(octree.slot_mask(m) & m.active)[:, 0]
            if slots is None else slots[slots >= 0].long())
    kept = torch.ones(m.capacity, dtype=torch.bool, device=m.device)
    kept[rows] = False
    err = [(km.voxels[k] - tm.voxels[k]).abs() for k in names]
    max_err = max(float(e.max()) for e in err)
    if kernel == "fuse_ofusion":
        beyond = int((err[0] > OF_ATOL + OF_RTOL
                      * tm.voxels[names[0]].abs()).sum()) \
            + int((err[1] != 0).sum())
    else:
        beyond = sum(int((e != 0).sum()) for e in err)
    vis_mismatch = int((km.active != tm.active).sum())
    changed_kept = sum(int((km.voxels[k][kept] != m.voxels[k][kept]).sum())
                       for k in names) \
        + int((km.active[kept] != m.active[kept]).sum())
    changed = [tm.voxels[k] != m.voxels[k] for k in names]
    updated = changed[0] | changed[1]
    fused = int(updated.sum())
    view_mismatch, view_note, view_sectors = 0, "", 0
    if view is not None:
        kv, tv = kw[0]["view"], kw[1]["view"]
        view_mismatch = int((torch.isnan(kv) != torch.isnan(tv)).sum()) \
            + int((torch.nan_to_num(kv) != torch.nan_to_num(tv)).sum())
        view_note = f", held view {view_mismatch}"
        same = (tv == view) | (torch.isnan(tv) & torch.isnan(view))
        view_sectors = int((~same).view(-1, 16).any(-1).sum())
    print(f"# {label}: {kernel} vs twin in place on {rows.numel()} of "
          f"{m.capacity} slots ({'live' if slots is None else 'listed'}): "
          f"{fused} voxels updated, {int(tm.active[rows].sum())} rows "
          f"visible; mismatches active {vis_mismatch}, {beyond} voxels "
          f"beyond the tolerance{view_note}; slots not fused changed "
          f"{changed_kept}; max abs err {max_err:.3g}")
    if fused == 0:
        fail(f"{label}: the {kernel} comparison fused no voxel")
    if vis_mismatch or beyond or view_mismatch or changed_kept:
        fail(f"{label}: {kernel} and twin disagree")

    # every timed launch fuses the same rows: on the whole-table branch the
    # live set depends on `active`, which each launch rewrites
    ms = median_ms(run, lambda: km.active.copy_(m.active))
    plain_ms = median_ms(run_plain, lambda: tm.active.copy_(m.active))
    rows_ms = median_ms(lambda: fn(km, *frame, *params, slots=slots,
                                   **kw[0]),
                        lambda: km.active.copy_(m.active))
    nodes_ms = median_ms(lambda: ik.update_nodes(km, field, *frame, now))

    # What the function needs to move: whether a voxel updates depends on
    # the pose, the depth and the field, never on the stored values, so
    # only the 32-byte sectors (8 voxels) holding updated voxels are read
    # (both channels) and written (where a channel changed), and the
    # view's changed sectors (16 voxels) written; besides, each row's key
    # and `active`, the slots (or every slot's `active` and n_blocks), the
    # depth image, T_cw and K.
    depth, T_cw, Km = frame
    n = rows.numel()
    sectors = lambda x: int(x.view(-1, 8).any(-1).sum())
    nbytes = 32 * (2 * sectors(updated) + sum(sectors(c) for c in changed)
                   + view_sectors) \
        + n * (8 + 1) + (m.capacity + 4 if slots is None
                         else 4 * slots.numel()) \
        + depth.numel() * 4 + 2 * 64
    cells = sum(a.numel() for a in m.node_alloc[1:])
    nbytes += cells * NODE_CELL_BYTES
    b_ms, b_by = bound(nbytes, n * 512 * PROJECT_FLOPS
                       + fused * UPDATE_FLOPS[kernel]
                       + cells * NODE_FLOPS[field.name])
    # the fewest instructions the launch's warps can issue, from the
    # compiled code and which voxels of each warp this data updates
    bc = torch.stack(morton.block_key_decode(m.keys[rows]), -1)
    _, ds, _, _ = ik._sample_rows(bc, torch.ones_like(rows, dtype=torch.bool),
                                  depth, T_cw, Km, m.voxel_size, ik.PATCH)
    bodies, issue_per_s = issue_model()
    dead_warps = sass_count.WARPS * (m.capacity - n) if slots is None else 0
    issue_ms = sass_count.issue_lower_bound_ms(
        bodies[kernel][0], sass_count.warp_classes(ds > 0, updated[rows]),
        dead_warps, issue_per_s)
    del ds
    print(f"# {label}: {kernel} with the node update in its launch, "
          f"median device time over {TIMED_RUNS} runs at {n} rows and "
          f"{cells} node cells: {ms:.4f} ms (the rows alone {rows_ms:.4f}, "
          f"the nodes alone {nodes_ms:.4f}, the two launches apart "
          f"{rows_ms + nodes_ms:.4f}), plain twins {plain_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB of "
          f"{fused} updated voxels and the node tables), "
          f"{100 * b_ms / ms:.0f} % of it; the rows' issue lower bound "
          f"{issue_ms:.4f} ms, {100 * issue_ms / ms:.0f} % of it")
    return dict(rows=n, max_abs_err=max(max_err, node_err), ms=ms,
                plain_ms=plain_ms, rows_ms=rows_ms, nodes_ms=nodes_ms,
                bound_ms=b_ms, bound_by=b_by, issue_ms=issue_ms)


def hold_node_tables(torch, label, kernel, m, got, want) -> float:
    """Every node level's new tables of a fusion with ``nodes`` (``got``)
    against the twin's (``want``), bit for bit, and the map's own node
    tables untouched.  Returns the max abs err (0)."""
    err = 0.0
    for level in range(1, m.block_level + 1):
        for name in want[level]:
            e, same = bits_err(torch, got[level][name], want[level][name])
            err = max(err, e)
            if not same:
                fail(f"{label}: {kernel}'s node update, level {level} "
                     f"{name}, differs from update_nodes_twin by {e:.3g}")
            if got[level][name] is m.node_values[level][name]:
                fail(f"{label}: {kernel} wrote the map's node tables")
    return err


def synthetic_table(torch, m, n_rows: int, rows=None):
    """A table of ``n_rows`` distinct slots holding the blocks of ``m``'s
    slots ``rows`` (default: its live slots), repeated with their voxels to
    fill it, all live, and the slots int32[n_rows] that list them."""
    if rows is None:
        rows = torch.nonzero(m.active[:int(m.n_blocks)])[:, 0]
    rows = rows.long()
    idx = rows[torch.arange(n_rows, device=rows.device) % rows.numel()]
    table = m.replace(
        capacity=n_rows, keys=m.keys[idx].contiguous(),
        active=torch.ones(n_rows, dtype=torch.bool, device=idx.device),
        n_blocks=torch.tensor(n_rows, dtype=torch.int32, device=idx.device),
        voxels={k: v[idx].contiguous() for k, v in m.voxels.items()})
    return table, torch.arange(n_rows, dtype=torch.int32, device=idx.device)


def warm_map(cfg, depths, poses, dev, frames: int):
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    for f in range(frames):
        slam.step(depths[f], K, f)
    return slam


def check_fusion_kernel(torch, kernel, preset, frames, depths, poses, dev):
    """A fusion kernel against its twin on 3072 distinct slots holding the
    live blocks of ``preset``'s map after its first ``frames`` frames,
    fused with the next frame (the budget branch at the headline's
    budget)."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing
    slam = warm_map(preset_config(preset), depths, poses, dev, frames)
    m, slots = synthetic_table(torch, slam.state.map, 3072)
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[frames].astype(np.int32)).to(dev), (240, 320))
    frame = (depth, numerics.inv(slam.state.pose),
             camera.camera_matrix(torch.from_numpy(K).to(dev)).contiguous())
    now = float(np.float32(1.0 / 30.0) * np.float32(frames))
    label = f"3072 slots of the {preset} map after {frames} frames " \
        f"({int(slam.state.map.n_blocks)} blocks)"
    r = hold_kernel(torch, label, kernel, m, slam.field, frame, now, slots)
    regs = fusion_registers()[kernel]
    replaces = ("supereight_tpu/ops/integrate_kernel.py:38"
                if kernel == "fuse_sdf"
                else "supereight_tpu/pipeline/integration.py:396")
    return dict(name=kernel, route="cuda",
                source="supereight_tpu_torch/csrc/integrate.cu",
                replaces=replaces, launches=0, max_abs_err=r["max_abs_err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None,
                rows_ms=r["rows_ms"], nodes_ms=r["nodes_ms"],
                registers=regs.get("registers"))


#: the fusion kernels' register budget: __launch_bounds__(128, 12)
FUSION_MAX_REGISTERS = 40
#: the fusion kernels' spill stores (bytes, -Xptxas -v): fuse_sdf's as
#: before the node update went into its launch, fuse_ofusion's 28 then and
#: 48 with the node path, whose spills cost the rows less than operands
#: read in place (__grid_constant__) that avoided them
FUSION_MAX_SPILL_STORES = {"fuse_sdf": 20, "fuse_ofusion": 48}


@functools.lru_cache(maxsize=None)
def fusion_registers():
    """The fusion kernels as built (each with the node pyramid's CTAs):
    their ``-Xptxas -v`` registers, stack frame and spills; fails on more
    than FUSION_MAX_REGISTERS registers or more spill stores than
    FUSION_MAX_SPILL_STORES.  {kernel: its properties}."""
    from supereight_tpu_torch.probes import sass_count
    props = {sass_count.kernel_name(f): p for f, p in
             sass_count.ptxas_properties(
                 sass_count.ptxas_log("integrate")).items() if "stack" in p}
    for name in FUSION:
        if name not in props:
            fail(f"integrate: no -Xptxas -v line for {name}")
        p = props[name]
        print(f"# {name} (-Xptxas -v, the node update inside): "
              f"{p.get('registers')} registers, {p['stack']} bytes stack "
              f"frame, {p['spill_stores']} bytes spill stores, "
              f"{p['spill_loads']} bytes spill loads")
        if p["spill_stores"] > FUSION_MAX_SPILL_STORES[name] or \
                p.get("registers", 0) > FUSION_MAX_REGISTERS:
            fail(f"{name}: spills more than {FUSION_MAX_SPILL_STORES[name]}"
                 f" bytes or uses more than {FUSION_MAX_REGISTERS} "
                 "registers")
    return props


#: the one-launch frustum selection, the sharded ICP trip and the
#: one-device ICP frame (sass_count.kernel_name) by source, each with the
#: most bytes of stack frame and of spill stores its -Xptxas -v line may
#: show (as built on an H100 with CUDA 12.8): the selection none; the trip
#: and the frame the 32-byte frame that icp_update has too (sinf's and
#: cosf's slow argument reduction in the solve), no spills
LOOK_BACK_AND_TRIP = {"integrate": {"frustum_select": (0, 0)},
                      "icp": {"icp_track_reduce": (32, 0),
                              "icp_track_levels": (32, 0)}}


def select_trip_registers():
    """The frustum selection's and the sharded ICP trip's kernels as built:
    their ``-Xptxas -v`` registers, stack frame and spills; fails where one
    has more stack frame or spill stores than LOOK_BACK_AND_TRIP names.
    {kernel: its properties}."""
    from supereight_tpu_torch.probes import sass_count
    props = {}
    for source, names in LOOK_BACK_AND_TRIP.items():
        found = {sass_count.kernel_name(f): p for f, p in
                 sass_count.ptxas_properties(
                     sass_count.ptxas_log(source)).items() if "stack" in p}
        for name, (stack, spills) in names.items():
            if name not in found:
                fail(f"{source}: no -Xptxas -v line for {name}")
            p = props[name] = found[name]
            print(f"# {name} (-Xptxas -v): {p.get('registers')} registers, "
                  f"{p['stack']} bytes stack frame, {p['spill_stores']} "
                  f"bytes spill stores, {p['spill_loads']} bytes spill "
                  f"loads (at most {stack} and {spills})")
            if p["stack"] > stack or p["spill_stores"] > spills:
                fail(f"{name}: more stack frame or spill stores than "
                     f"{stack} and {spills} bytes")
    return props


def bits_err(torch, got, want) -> float:
    """The largest |got - want| of two float32 tensors (NaN where NaN
    counts 0), and whether they are equal bit for bit: (err, same)."""
    got, want = got.contiguous(), want.to(got.device).contiguous()
    both_nan = torch.isnan(got) & torch.isnan(want)
    same = bool(((got.view(torch.int32) == want.view(torch.int32))
                 | both_nan).all())
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    err = float(torch.nan_to_num(diff, nan=float("inf")).max()) \
        if diff.numel() else 0.0
    return err, same


def glue_entry(name, source, replaces, err, ms, plain_ms, b, library_ms,
               floor, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b[0], bound_by=b[1], library_ms=library_ms,
                launch_floor_ms=floor, **extra)


def hold_pyramid(torch, depths, dev, floor):
    """``build_pyramid`` (csrc/pyramid.cu, every level in one launch)
    against its twin on the card and on the CPU: at the headline's three
    levels on PYRAMID_FRAMES of the headline sequence at both ``neg_y``,
    then at every level count the kernel takes on the last of those frames
    and on the random PYRAMID_ODD depth with holes; every level's depth,
    vertices and normals bit for bit, one launch a call.  Above its
    largest count it must raise without a launch.  Timed on the headline's
    three levels."""
    from supereight_tpu_torch.ops import pyramid_kernel
    from supereight_tpu_torch.pipeline import preprocessing
    k = torch.from_numpy(K).to(dev)
    err, n_held = 0.0, 0

    def hold(label, d, k, levels, neg_y):
        nonlocal err, n_held
        before = pyramid_kernel.LAUNCHES["build_pyramid"]
        got = preprocessing.build_pyramid(d, k, levels, neg_y)
        if pyramid_kernel.LAUNCHES["build_pyramid"] != before + 1:
            fail("build_pyramid: not one launch a call")
        card = preprocessing.build_pyramid_twin(d, k, levels, neg_y)
        cpu = preprocessing.build_pyramid(d.cpu(), k.cpu(), levels, neg_y)
        for g, a, b in zip(got, card, cpu):
            if not len(g) == len(a) == len(b) == levels:
                fail(f"build_pyramid {label}: {len(g)} levels, not {levels}")
            for x, y, z in zip(g, a, b):
                e1, s1 = bits_err(torch, x, y)
                e2, s2 = bits_err(torch, x, z)
                err = max(err, e1, e2)
                n_held += 1
                if not (s1 and s2):
                    fail(f"build_pyramid {label} levels {levels} neg_y "
                         f"{neg_y}: the kernel differs from its twin "
                         f"({e1:.3g} on the card, {e2:.3g} on the CPU)")

    for f in PYRAMID_FRAMES:
        d = preprocessing.mm_to_meters(
            torch.from_numpy(depths[f].astype(np.int32)).to(dev), (240, 320))
        for neg_y in (False, True):
            hold(f"headline frame {f}", d, k, 3, neg_y)
    odd, k_odd = (torch.from_numpy(x).to(dev) for x in random_depth())
    for levels in range(1, pyramid_kernel.MAX_LEVELS + 1):
        hold(f"headline frame {PYRAMID_FRAMES[-1]}", d, k, levels, False)
        hold(f"random {PYRAMID_ODD[0]}x{PYRAMID_ODD[1]}", odd, k_odd, levels,
             levels % 2 == 0)
    before = pyramid_kernel.LAUNCHES["build_pyramid"]
    try:
        preprocessing.build_pyramid(d, k, pyramid_kernel.MAX_LEVELS + 1,
                                    False)
        fail(f"build_pyramid: {pyramid_kernel.MAX_LEVELS + 1} levels did "
             "not raise")
    except ValueError:
        pass
    if pyramid_kernel.LAUNCHES["build_pyramid"] != before:
        fail("build_pyramid: launched above its largest level count")

    run = lambda: preprocessing.build_pyramid(d, k, 3, False)
    ms = median_ms(run)
    plain_ms = median_ms(lambda: preprocessing.build_pyramid_twin(
        d, k, 3, False))
    host = host_ms(torch, run)
    px = [(240 >> l) * (320 >> l) for l in range(3)]
    nbytes = 4 * (px[0] + 6 * px[0] + 7 * (px[1] + px[2]) + 4)
    b = bound(nbytes, PYRAMID_FLOPS * sum(px))
    print(f"# build_pyramid: {n_held} level images equal the twin's on the "
          f"card and on the CPU bit for bit ({len(PYRAMID_FRAMES)} headline "
          f"frames x both neg_y at 3 levels; 1 to "
          f"{pyramid_kernel.MAX_LEVELS} levels of a headline frame and of "
          f"the random {PYRAMID_ODD[0]}x{PYRAMID_ODD[1]} depth), one launch "
          f"a call, {pyramid_kernel.MAX_LEVELS + 1} levels raise; median "
          f"device time of a 3-level call over {TIMED_RUNS} runs {ms:.4f} "
          f"ms (host clock, synchronised, {host:.4f} ms), plain twin "
          f"{plain_ms:.4f} ms; bound {b[0]:.6f} ms ({b[1]}: "
          f"{nbytes / 1e6:.2f} MB); launch floor {floor:.4f} ms (1 launch)")
    return glue_entry("build_pyramid", "supereight_tpu_torch/csrc/pyramid.cu",
                      "supereight_tpu/pipeline/preprocessing.py:136", err,
                      ms, plain_ms, b, None, floor, host_ms=host)


def inverse_registers():
    """``pose_inv``'s instantiation for n = 4 as built: its ``-Xptxas -v``
    line (stack frame, spills, registers) and its local-memory loads and
    stores in the SASS; fails unless all are 0 (the LU in registers)."""
    from supereight_tpu_torch.probes import sass_count
    props = [(f, p) for f, p in sass_count.ptxas_properties(
        sass_count.ptxas_log("numerics")).items()
        if sass_count.kernel_name(f) == "inverse<4>" and "stack" in p]
    if len(props) != 1:
        fail("pose_inv: no -Xptxas -v line for the n = 4 kernel")
    p = props[0][1]
    local = sass_count.local_memory_ops(
        sass_count.kernel_bodies("numerics"))["inverse<4>"]
    print(f"# pose_inv n = 4 (-Xptxas -v): {p['stack']} bytes stack frame, "
          f"{p['spill_stores']} bytes spill stores, {p['spill_loads']} "
          f"bytes spill loads, {p.get('registers')} registers; "
          f"{local} LDL/STL in its SASS")
    if p["stack"] or p["spill_stores"] or p["spill_loads"] or local:
        fail("pose_inv: the n = 4 kernel goes through local memory")
    return p


def hold_inverse(torch, dev, floor):
    """``numerics.inv`` on the card (``pose_inv``, csrc/numerics.cu) on
    every pose of SEQUENCES, on K and on the ``pivot_matrices`` of 1, 2
    and 4 rows (the sizes where its steps are XLA's) against its host
    twin, bit for bit, one launch a call; at every other size of
    ``pivot_matrices`` (3, 5, 6, 7, 8 rows) it must raise without a
    launch; its n = 4 kernel in registers (:func:`inverse_registers`);
    timed beside ``torch.linalg.inv``."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.ops import numerics_kernel
    from supereight_tpu_torch.pipeline import camera
    regs = inverse_registers()
    mats = [camera.camera_matrix(torch.from_numpy(K))]
    for seq in SEQUENCES:
        mats += list(torch.from_numpy(load_sequence(seq)[1]))
    pivots = pivot_matrices()
    held = {n: m for n, m in pivots.items()
            if m.shape[0] in numerics.INV_SIZES}
    mats += [torch.from_numpy(m) for m in held.values()]
    before = numerics_kernel.LAUNCHES["pose_inv"]
    got = [numerics.inv(m.to(dev)) for m in mats]
    torch.cuda.synchronize()
    if numerics_kernel.LAUNCHES["pose_inv"] != before + len(mats):
        fail("pose_inv: not one launch a call")
    err = 0.0
    for g, m in zip(got, mats):
        e, same = bits_err(torch, g, numerics.inv_twin(m))
        if not same:
            fail(f"pose_inv: differs from the host twin by {e:.3g} on a "
                 f"{m.shape[0]}x{m.shape[0]} matrix")
        if torch.isfinite(g).all():
            err = max(err, e)
    refused = [m for m in pivots.values()
               if m.shape[0] not in numerics.INV_SIZES]
    before = numerics_kernel.LAUNCHES["pose_inv"]
    for m in refused:
        try:
            numerics.inv(torch.from_numpy(m).to(dev))
            fail(f"pose_inv: a {m.shape[0]}x{m.shape[0]} matrix did not "
                 "raise")
        except ValueError:
            pass
    if numerics_kernel.LAUNCHES["pose_inv"] != before:
        fail("pose_inv: launched outside its sizes")
    M = mats[1].to(dev)
    ms = median_ms(lambda: numerics.inv(M))
    plain_ms = median_ms(lambda: numerics.inv_twin(M))
    lib_ms = median_ms(lambda: torch.linalg.inv(M))
    host = host_ms(torch, lambda: numerics.inv(M))
    b = bound(2 * 64, INV_FLOPS)
    print(f"# pose_inv: {len(mats)} matrices (every pose of "
          f"{', '.join(SEQUENCES)}, K and {len(held)} pivot patterns of "
          f"1, 2 and 4 rows) equal the host twin bit for bit, "
          f"{len(refused)} of other sizes raise without a launch; median "
          f"device time "
          f"{ms:.4f} ms (host clock, synchronised, {host:.4f} ms), the host "
          f"twin {plain_ms:.4f} ms, torch.linalg.inv {lib_ms:.4f} ms; bound "
          f"{b[0]:.8f} ms ({b[1]}); launch floor {floor:.4f} ms")
    return glue_entry("pose_inv", "supereight_tpu_torch/csrc/numerics.cu",
                      "supereight_tpu/pipeline/integration.py:503", err, ms,
                      plain_ms, b, lib_ms, floor, host_ms=host,
                      registers=regs.get("registers"),
                      stack_bytes=regs["stack"])


def hold_select(torch, label, m, pose, Km, hw, budget, timed=False):
    """``frustum_select`` (one launch, the pose's inverse inside it)
    against its twin on the card and on the CPU at ``budget``: slots,
    overflow and ``T_cw`` equal, ``T_cw`` also ``numerics.inv``'s
    (``pose_inv``) bit for bit; one launch a call, and the look-back's
    status words and tickets zero after it.  Returns (the candidates'
    count, (ms, plain ms, bound) when ``timed``)."""
    from supereight_tpu_torch.core import numerics, octree
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.ops import look_back
    before = ik.LAUNCHES["frustum_select"]
    slots, ovf, T_cw = ik.frustum_select(m, pose, Km, hw, budget)
    if m.device.type == "cuda":
        if ik.LAUNCHES["frustum_select"] != before + 1:
            fail(f"{label}: frustum_select not one launch a call")
        sc = look_back.scratch(m.device)
        torch.cuda.synchronize()
        if bool(sc.status.any()) or bool(sc.ctl.any()):
            fail(f"{label}: frustum_select left its look-back's scratch "
                 "dirty")
    cand = int(ik.frustum_candidates(m, T_cw, Km, hw).sum())
    cpu = m.replace(voxels={}, node_values=[], node_alloc=[], **{
        f: getattr(m, f).cpu() for f in ("block_index", "keys", "active",
                                         "n_blocks", "overflow",
                                         "part_counts")})
    if not torch.equal(T_cw, numerics.inv(pose)):
        fail(f"{label}: frustum_select's T_cw is not pose_inv's")
    for where, (w_slots, w_ovf, w_T) in (
            ("the card", ik.frustum_select_twin(m, pose, Km, hw, budget)),
            ("the CPU", ik.frustum_select_twin(cpu, pose.cpu(), Km.cpu(),
                                               hw, budget))):
        if not torch.equal(slots.cpu(), w_slots.cpu()) or \
                int(ovf) != int(w_ovf) or not torch.equal(T_cw.cpu(),
                                                          w_T.cpu()):
            fail(f"{label}: frustum_select at budget {budget} differs from "
                 f"its twin on {where}")
    dropped = int(ovf) - int(m.overflow)
    print(f"# {label}: frustum_select at budget {budget} of {m.capacity} "
          f"slots ({cand} candidates, {dropped} dropped) equals its twin on "
          f"the card and on the CPU, T_cw pose_inv's; scratch zero")
    if dropped != max(cand - budget, 0):
        fail(f"{label}: frustum_select dropped {dropped}, not "
             f"{max(cand - budget, 0)}")
    if not timed:
        return cand, None
    live = int((octree.slot_mask(m) & m.active).sum())
    b = bound(select_bytes(m.capacity, m.partitions, live, budget),
              SELECT_FLOPS * live + INV_FLOPS)
    return cand, (median_ms(lambda: ik.frustum_select(m, pose, Km, hw,
                                                      budget)),
                  median_ms(lambda: ik.frustum_select_twin(m, pose, Km, hw,
                                                           budget)), b)


def select_bytes(capacity, partitions, live, budget) -> int:
    """Bytes ``frustum_select`` must move: ``active`` and the live slots'
    keys, the partitions' counts, the pose and K read; the slots, T_cw and
    the overflow written (and the overflow read)."""
    return capacity + 8 * live + 4 * partitions + 2 * 64 + 4 * budget \
        + 64 + 8


def select_map(torch, size, capacity, dev, depth, pose, Km):
    """A ``size``^3 SDF map of ``capacity`` slots holding the blocks the
    allocation takes for the frame (``depth``, camera-to-world ``pose``):
    the selection's operands at a preset's capacity."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.fields import SDFField
    from supereight_tpu_torch.pipeline import integration
    field = SDFField(mu=0.1)
    m = octree.init(size, 4.8, field.channels, dev, capacity=capacity)
    return integration.allocate_sdf(m, depth, pose, Km, field.alloc_band())


def node_map(torch, size, field, dev, seed):
    """A ``size``^3 map whose node levels hold random values of the
    field's range, half of their cells allocated."""
    from supereight_tpu_torch.core import octree
    rng = np.random.default_rng(seed)
    m = octree.init(size, 4.8, field.channels, dev, capacity=64)
    values, alloc = list(m.node_values), list(m.node_alloc)
    for level in range(1, m.block_level + 1):
        s = (1 << level,) * 3
        if field.name == "sdf":
            vals = (rng.uniform(-1, 1, s), rng.integers(0, 12, s))
        else:
            vals = (rng.uniform(-20, 20, s), rng.uniform(0, 3.2, s))
        values[level] = {c.name: torch.from_numpy(v.astype(np.float32))
                         .to(dev) for c, v in zip(field.channels, vals)}
        alloc[level] = torch.from_numpy(rng.random(s) < 0.5).to(dev)
    return m.replace(node_values=values, node_alloc=alloc)


def fusion_map(torch, size, field, dev, seed, depth, pose, Km):
    """A ``size``^3 map for a fusion with the node update: the blocks the
    field's allocation takes for the frame (``depth``, camera-to-world
    ``pose``, ``Km``), every row's voxels random in the field's range, and
    :func:`node_map`'s random node levels."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.pipeline import integration
    rng = np.random.default_rng(seed)
    m = octree.init(size, 4.8, field.channels, dev,
                    capacity=6144 if size <= 256 else 32768)
    if field.name == "sdf":
        m = integration.allocate_sdf(m, depth, pose, Km, field.alloc_band())
        vals = (rng.uniform(-1, 1, (m.capacity, 512)),
                rng.integers(0, 12, (m.capacity, 512)))
    else:
        m = integration.allocate_ofusion(m, depth, pose, Km,
                                         field.alloc_band())
        vals = (rng.uniform(-20, 20, (m.capacity, 512)),
                rng.uniform(0, 0.9, (m.capacity, 512)))
    nm = node_map(torch, size, field, dev, seed)
    return m.replace(
        voxels={c.name: torch.from_numpy(v.astype(np.float32)).to(dev)
                for c, v in zip(field.channels, vals)},
        node_values=nm.node_values, node_alloc=nm.node_alloc)


def hold_nodes(torch, label, m, field, frame, now, timed=False):
    """``update_nodes`` (on the card the fusion kernel's launch with no
    rows) against its twin: every node level's tables bit for bit.
    Returns (max abs err, (ms, plain ms, bound) when ``timed``)."""
    from supereight_tpu_torch.ops import integrate_kernel as ik
    got = ik.update_nodes(m, field, *frame, now)
    want = ik.update_nodes_twin(m, field, *frame, now)
    err, changed, cells = 0.0, 0, 0
    for level in range(1, m.block_level + 1):
        for name in want[level]:
            e, same = bits_err(torch, got[level][name], want[level][name])
            err = max(err, e)
            if not same:
                fail(f"{label}: update_nodes level {level} {name} differs "
                     f"from its twin by {e:.3g}")
            changed += int((want[level][name]
                            != m.node_values[level][name]).sum())
        cells += m.node_alloc[level].numel()
    print(f"# {label}: update_nodes on {cells} node cells ({m.size}^3, "
          f"{field.name}) equals its twin bit for bit; {changed} values "
          f"changed")
    if not timed:
        return err, None
    nbytes = cells * NODE_CELL_BYTES + min(cells, frame[0].numel()) * 4 \
        + 2 * 64
    b = bound(nbytes, cells * NODE_FLOPS[field.name])
    return err, (median_ms(lambda: ik.update_nodes(m, field, *frame, now)),
                 median_ms(lambda: ik.update_nodes_twin(m, field, *frame,
                                                        now)), b)


def check_glue_kernels(torch, depths, poses, dev):
    """The frame's glue kernels against their twins, each timed (median
    of TIMED_RUNS launches, CUDA events) beside the launch floor and its
    bound: the pyramid and the inverse (above), ``frustum_select`` on the
    headline map after 12 frames at its budget and at one its candidates
    overflow (the presets' runs hold it again on their own maps),
    ``update_nodes`` on random node tables at 256^3 and 1024^3 for both
    fields with the headline's frame 30, alone (a fusion launch with no
    rows) and inside the fusion's launch at the budget's 3072 slots of a
    map the frame allocated (``fusion_map``), beside the two launches
    apart.  Returns their JSON entries."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.fields import OFusionField, SDFField
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.pipeline import camera, preprocessing
    floor = median_ms(lambda: gp.empty_launch(dev))
    out = {"build_pyramid": hold_pyramid(torch, depths, dev, floor),
           "pose_inv": hold_inverse(torch, dev, floor)}

    Km = camera.camera_matrix(torch.from_numpy(K).to(dev)).contiguous()
    slam = warm_map(preset_config("headline"), depths, poses, dev, 12)
    m = slam.state.map
    pose = slam.state.pose
    cand, timed = hold_select(torch, "headline map after 12 frames", m, pose,
                              Km, (240, 320), 3072, timed=True)
    hold_select(torch, "headline map after 12 frames", m, pose, Km,
                (240, 320), max(cand // 2, 1))
    ms, plain_ms, b = timed
    print(f"# frustum_select at 3072 of 6144 slots (one launch, the inverse "
          f"inside): median device time {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms; bound {b[0]:.6f} ms ({b[1]}); launch floor "
          f"{floor:.4f} ms")
    del slam, m

    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[30].astype(np.int32)).to(dev), (240, 320))
    pose = torch.from_numpy(poses[30]).to(dev)
    # the selection at the larger presets' capacities (demo512-ofusion's
    # and 1024-quality's), on maps of the frame's blocks, at their budgets
    # and at one above the candidates
    at_capacity = {6144: ms}
    for size, cap, budget in SELECT_CAPACITIES:
        sm = select_map(torch, size, cap, dev, depth, pose, Km)
        label = f"{size}^3 map of the frame's {int(sm.n_blocks)} blocks"
        c, t = hold_select(torch, label, sm, pose, Km, (240, 320), budget,
                           timed=True)
        hold_select(torch, label, sm, pose, Km, (240, 320), c + 7)
        at_capacity[cap] = t[0]
        print(f"# frustum_select at {budget} of {cap} slots: median device "
              f"time {t[0]:.4f} ms, plain twin {t[1]:.4f} ms; bound "
              f"{t[2][0]:.6f} ms ({t[2][1]})")
        del sm
    regs = select_trip_registers()
    out["frustum_select"] = glue_entry(
        "frustum_select", "supereight_tpu_torch/csrc/integrate.cu",
        "supereight_tpu/pipeline/integration.py:512", 0.0, ms, plain_ms, b,
        None, floor, ms_at_capacity=at_capacity,
        registers=regs["frustum_select"].get("registers"),
        stack_bytes=regs["frustum_select"]["stack"])
    frame = (depth, numerics.inv(pose), Km)
    now = float(np.float32(1.0 / 30.0) * np.float32(30))
    err, entry, merged = 0.0, None, {}
    for size in (256, 1024):
        for fname in ("sdf", "ofusion"):
            field = SDFField(mu=0.1) if fname == "sdf" else \
                OFusionField(mu=0.008, voxel_size=4.8 / size)
            nm = node_map(torch, size, field, dev, size)
            e, t = hold_nodes(torch, f"random node tables {size}^3", nm,
                              field, frame, now, timed=True)
            err = max(err, e)
            print(f"# update_nodes {size}^3 {fname}: median device time "
                  f"{t[0]:.4f} ms, plain twin {t[1]:.4f} ms; bound "
                  f"{t[2][0]:.6f} ms ({t[2][1]}); launch floor {floor:.4f} "
                  "ms")
            if size == 256 and fname == "sdf":
                entry = t
            del nm
            fm = fusion_map(torch, size, field, dev, size, depth, pose, Km)
            slots, _, _ = ik.frustum_select(fm, pose, Km, (240, 320), 3072)
            kernel = "fuse_ofusion" if fname == "ofusion" else "fuse_sdf"
            r = hold_kernel(torch, f"{size}^3 {fname} map of the frame's "
                            f"{int(fm.n_blocks)} blocks, random node tables",
                            kernel, fm, field, frame, now, slots)
            err = max(err, r["max_abs_err"])
            merged[f"{kernel}_{size}"] = dict(
                ms=r["ms"], rows_ms=r["rows_ms"], nodes_ms=r["nodes_ms"])
            del fm, slots
    out["update_nodes"] = glue_entry(
        "update_nodes", "supereight_tpu_torch/csrc/integrate.cu",
        "supereight_tpu/pipeline/integration.py:581", err, entry[0],
        entry[1], entry[2], None, floor, inside_fusion=merged,
        launches_counted_in=LAUNCHES_COUNTED_IN["update_nodes"])
    torch.cuda.empty_cache()
    return out


def check_glue_launched(label, counts, cfg, icp_frames, integrated):
    """The glue kernels on a one-device path: the pyramid once every frame
    on which ICP runs (one launch builds every level; the frame-to-frame
    publications add theirs), the inverse on each integrated frame of the
    whole-table branch (the budget branch's is inside the selection's
    launch, the tracking view's inside icp_track_levels'), the node update
    once an integrated frame and inside each fusion launch (one count
    each), the frustum selection once an integrated frame on the budget
    branch."""
    budget = 0 < cfg.integrate_budget < cfg.block_capacity
    want = dict(build_pyramid=icp_frames,
                pose_inv=0 if budget else integrated,
                update_nodes=integrated,
                frustum_select=integrated if budget else 0)
    got = {k: counts.get(k, 0) for k in GLUE}
    print(f"# {label}: glue LAUNCHES {got} ({icp_frames} ICP frames, "
          f"{integrated} integrated)")
    fusions = sum(counts.get(k, 0) for k in FUSION)
    if got["update_nodes"] != fusions:
        fail(f"{label}: {got['update_nodes']} node updates, not one inside "
             f"each of the {fusions} fusion launches")
    for k, n in want.items():
        if got[k] < n or (k in ("update_nodes", "frustum_select")
                          and got[k] != n):
            fail(f"{label}: {k} launched {got[k]} times, not "
                 f"{'at least ' if k in ('build_pyramid', 'pose_inv') else ''}"
                 f"{n}")


#: the raycast on the card (csrc/raycast.cu), each held bit for bit to its
#: twin: R1 the splat bounds (one launch, the view's inverse inside it), R2
#: the first window's scan, R3 the second window with the midsolve (in R2's
#: launch: its entry is the merged launch, counted where a raycast ran
#: that phase), R4 the full-resolution re-solve with its vertices and
#: normals.  R2 and R3 are one kernel: R2's entry counts every launch of it
#: but times it with both knobs off; every path the smoke drives runs the
#: merged launch, so R2's entry is marked ``launches_counted_in:
#: ray_scan_second``, and launches times their time are summed once
RAYCAST = ("splat_bounds", "ray_scan", "ray_scan_second",
           "ray_refine_normals")
#: the CUDA kernel (sass_count.kernel_name) each entry times
RAYCAST_KERNEL = {"splat_bounds": "splat_bounds", "ray_scan": "ray_scan",
                  "ray_scan_second": "ray_scan",
                  "ray_refine_normals": "ray_refine_normals"}
#: the TPU-side code each replaces (XLA fused it; not a Pallas kernel)
RAYCAST_REPLACES = {
    "splat_bounds": "supereight_tpu/pipeline/raycast.py:254",
    "ray_scan": "supereight_tpu/pipeline/raycast.py:358",
    "ray_scan_second": "supereight_tpu/pipeline/raycast.py:545",
    "ray_refine_normals": "supereight_tpu/pipeline/raycast.py:376"}
#: float operations (an fma counts two), counted in csrc/raycast.cu: a
#: live slot's centre, projection and tests; a footprint cell's radius,
#: cell and two atomics; a pooled cell (the 3x3 pools; with near_rescue
#: the 25x25 pool and the fallback); a scan ray's direction and bounds
#: (half resolution: four directions and their mean); a sample (its point,
#: voxel, bounds, index and test); a pixel's direction, vertex, ray norm
#: and normal; a view tap of the re-solve or the gradient
SPLAT_SLOT_FLOPS = 34
SPLAT_CELL_FLOPS = 12
POOL_FLOPS = {False: 12, True: 64}
RAY_FLOPS = {False: 14, True: 50}
SAMPLE_FLOPS = 30
PIXEL_FLOPS = 45
TAP_FLOPS = 22
#: the raycast phase's knob groups on the headline map after
#: RAYCAST_FRAMES frames: every normals and refine mode of the presets
#: and of phase F, the second window cut by a budget of RAYCAST_BUDGET,
#: and rank 1's row strip of 2 ranks (with the slots' inside flags given,
#: as the sharded frame gives them)
RAYCAST_FRAMES = 12
RAYCAST_BUDGET = 64
RAYCAST_MODES = {
    "hybrid gd2 near_rescue (headline)": dict(
        normals="hybrid", grad_decim=2, scan_stride=1.0),
    "volume (quality)": dict(normals="volume", near_rescue=False),
    "stored (F1)": dict(normals="stored", grad_decim=2, scan_stride=1.0),
    "stored plane (F2)": dict(normals="stored", refine="plane",
                              grad_decim=2, scan_stride=1.0),
    "hybrid midsolve (F3)": dict(normals="hybrid", grad_decim=2,
                                 scan_stride=1.0, midsolve=True),
    "exact interp": dict(normals="exact", refine="interp",
                         near_rescue=False),
    "volume interp": dict(normals="volume", refine="interp"),
    "full-res scan hybrid (demo512-sdf)": dict(
        normals="hybrid", grad_decim=2, scan_stride=1.0, full_res_scan=True),
    "midsolve without the second window": dict(
        normals="hybrid", second_window=False, midsolve=True),
    "no second window": dict(normals="volume", second_window=False),
    f"w2_budget {RAYCAST_BUDGET}": dict(
        normals="hybrid", grad_decim=2, scan_stride=1.0,
        w2_budget=RAYCAST_BUDGET),
    "rank 1's strip of 2, hybrid gd2": dict(
        normals="hybrid", grad_decim=2, scan_stride=1.0,
        row_range=(120, 120), inside=True),
}
#: the OFusion map's knob groups (the ofusion preset's map after
#: RAYCAST_FRAMES frames and its held bf16 view)
RAYCAST_OF_MODES = {
    "hybrid (ofusion)": dict(normals="hybrid", scan_stride=1.0,
                             near_rescue=False),
    "volume (trans, noise, 1024-quality)": dict(normals="volume",
                                                near_rescue=False),
    "exact interp (ofusion-fidelity)": dict(normals="exact",
                                            refine="interp",
                                            near_rescue=False),
    "rank 1's strip of 2, hybrid": dict(
        normals="hybrid", scan_stride=1.0, near_rescue=False,
        row_range=(120, 120), inside=True),
}


def raycast_knobs(cfg) -> dict:
    """The raycast keywords ``system.raycasting_stage`` passes for
    ``cfg``."""
    return dict(normals=cfg.raycast_normals,
                second_window=cfg.raycast_second_window,
                span_factor=cfg.raycast_span_factor,
                w2_budget=cfg.raycast_w2_budget,
                scan_stride=cfg.raycast_scan_stride,
                near_rescue=cfg.raycast_near_rescue,
                grad_decim=cfg.raycast_grad_decim, refine=cfg.raycast_refine,
                full_res_scan=cfg.raycast_full_res_scan,
                midsolve=cfg.raycast_midsolve)


def _full_knobs(knobs) -> dict:
    """``raycast.raycast``'s keywords: its defaults under ``knobs``."""
    import inspect
    from supereight_tpu_torch.pipeline import raycast
    out = {n: p.default for n, p in
           inspect.signature(raycast.raycast).parameters.items()
           if p.kind == p.KEYWORD_ONLY}
    out.update(knobs)
    return out


def same_bits(torch, label, got, want) -> float:
    """``got`` and ``want`` (tensors or None) equal bit for bit (floats
    by their bits, NaN where both are NaN); fails otherwise.  Returns the
    largest |got - want|."""
    if got is None and want is None:
        return 0.0
    same = got.shape == want.shape and got.dtype == want.dtype
    err = 0.0
    if same and got.dtype.is_floating_point:
        g, w = got.contiguous(), want.to(got.device).contiguous()
        equal = (g.view(torch.int32) == w.view(torch.int32)) \
            | (torch.isnan(g) & torch.isnan(w))
        same = bool(equal.all())
        if not same:
            err = float(torch.nan_to_num((g - w).abs()[~equal],
                                         nan=float("inf")).max())
    elif same:
        same = torch.equal(got, want.to(got.device))
    if not same:
        fail(f"{label}: the kernel differs from its twin ({err:.3g})")
    return err


def window_samples(torch, m, dense, field, origin, dirs, z0, plan, active):
    """The view samples a window's scan reads on each ray (``dirs``
    [..., 3], start depths ``z0``): up to its first valid outside ->
    inside crossing, the whole window on a miss, none where not
    ``active``."""
    from supereight_tpu_torch.pipeline import raycast as rc
    nF = plan.n_fine + 1
    steps = torch.arange(nF, device=z0.device).reshape(
        (nF,) + (1,) * z0.ndim)
    z = z0[None] + (plan.fine_span / plan.n_fine) * steps.float()
    f, _ = rc._sample_volume(dense["F"], (origin + dirs[None] * z[..., None])
                             * m.inverse_voxel_size, m.size, float("nan"))
    ok = ~torch.isnan(f)
    inside = field.is_inside(f)
    # the last valid sample's outside bit before each sample (-1: none)
    enc = torch.where(ok, steps * 2 + (~inside).long(), -1)
    prev = torch.cat([torch.full_like(enc[:1], -1),
                      torch.cummax(enc, 0).values[:-1]])
    crossing = ok & inside & (prev >= 0) & ((prev & 1) == 1)
    first = torch.where(crossing.any(0),
                        crossing.to(torch.uint8).argmax(0) + 1, nF)
    return int((first * active).sum())


def raycast_work(torch, m, dense, field, view, plan, k, scan1, scan, tmin,
                 g, fin, on_view):
    """The bytes and float operations each raycast kernel's function needs
    on this data (what its bound counts): R1 the live slots' keys, the
    in-view slots' voxels (or inside flags), the view, its inverse's
    operations once, the grids; R2 alone (``ray_scan``: the first window)
    the samples its rays read (window_samples), the grids and its rays'
    hit and depth; the merged launch (``ray_scan_second``: R2 with R3)
    those, the ranked rays' second-window samples, the midsolve's two taps
    a hit and each tile's status word; R4 the parents' hits and depths,
    the re-solve's taps of each pixel whose parent hit, the gradient's 6
    taps at each vertex (volume) or at each decimated parent that hit
    (hybrid), and its outputs.  ``scan1`` is the first window's twin scan
    (its flags and start depths).  {kernel: (bytes, flops)}."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.pipeline import raycast as rc
    esize = dense["F"].element_size()
    live = int(octree.slot_mask(m).sum())
    cells = tmin.numel()
    voxel_bytes = 1 if k["inside_any"] is not None else 4 * 512
    r1 = (8 * live + on_view * voxel_bytes + 4 * 16 + 8 * cells,
          INV_FLOPS + SPLAT_SLOT_FLOPS * live + 512 * on_view
          + 9 * SPLAT_CELL_FLOPS * on_view
          + POOL_FLOPS[bool(k["near_rescue"])] * cells)
    origin, _, fd = rc._scan_dirs(view, plan)
    rep = g // 2 if plan.half_res else g
    f = 2 if plan.half_res else 1
    t0 = tmin.repeat_interleave(rep, 0).repeat_interleave(rep, 1)[
        plan.r0 // f:(plan.r0 + plan.rows) // f, :fd.shape[1]]
    active = torch.isfinite(t0)
    rays = active.numel()
    tiles = -(-rays // 256)
    n1 = window_samples(torch, m, dense, field, origin, fd, scan1.z_start,
                        plan, active)
    r2 = (esize * n1 + 4 * 2 * cells + rays * (1 + 4),
          RAY_FLOPS[plan.half_res] * rays + SAMPLE_FLOPS * n1)
    n2 = 0
    if k["second_window"]:
        idx = torch.nonzero(scan1.need2.reshape(-1))[:, 0][
            :min(k["w2_budget"], rays)]
        n2 = window_samples(
            torch, m, dense, field, origin, fd.reshape(-1, 3)[idx],
            (scan1.z_start + plan.fine_span).reshape(-1)[idx], plan,
            torch.ones_like(idx, dtype=torch.bool))
    mid = 2 * int(scan.hit.sum()) if k["midsolve"] else 0
    r3 = (r2[0] + esize * (n2 + mid) + 8 * tiles * k["second_window"],
          r2[1] + SAMPLE_FLOPS * (n2 + mid))
    pixels = fin.hit.numel()
    resolve = plan.half_res and not (k["normals"] == "stored"
                                     and k["refine"] == "plane")
    taps = 0
    if resolve:
        parent_hits = int(scan.hit.repeat_interleave(2, 0)
                          .repeat_interleave(2, 1).sum())
        taps = 2 * (8 if k["refine"] == "interp" else 1) * parent_hits
    hybrid = k["normals"] == "hybrid" and resolve
    if hybrid:
        gd = int(k["grad_decim"])
        h, w = scan.hit.shape
        points = scan.hit[::gd, ::gd] if gd > 1 and h % gd == 0 and \
            w % gd == 0 else scan.hit
        taps += 6 * int(points.sum())
    elif fin.normal is not None:
        taps += 6 * int(fin.hit.sum())
    out_bytes = 12 + 4 + 1 + (12 if fin.normal is not None else 0)
    r4 = (esize * taps + pixels * out_bytes + scan.hit.numel() * 5,
          PIXEL_FLOPS * pixels + TAP_FLOPS * taps)
    return dict(splat_bounds=r1, ray_scan=r2, ray_scan_second=r3,
                ray_refine_normals=r4)


def hold_raycast(torch, label, m, field, view, dense, knobs,
                 grad_table=None, cpu=False, timed=False, floor=None):
    """The raycast kernels (csrc/raycast.cu) against their twins on the
    card, each on the same operands (the kernels' own outputs before it),
    bit for bit: R1 the grids, twice in a row on the same operands (its
    scratch cleans itself); the scan alone (R2: both knobs off) its hit
    and depth against ``ray_scan_twin``'s; the merged launch (R2 with R3,
    where the second window or the midsolve is on) its hit and depth
    against ``ray_scan_second_twin(ray_scan_twin(...))``'s, and R1's and
    the scan's scratch left zero; R4 the vertex,
    normal, ray distance and hit maps; then the whole ``raycast`` (R1, the
    scan and R4 each launched once, no ``pose_inv``) against
    ``raycast_twin`` on the card, and with ``cpu`` R1 and the whole
    ``raycast`` against the CPU's on copies of its operands, bit for bit.
    ``knobs`` are ``raycast``'s; ``inside=True`` gives R1 the slots'
    inside flags (as the sharded frame does).  Returns {kernel: entry
    fields} (max_abs_err; with ``timed`` the median device times of the
    kernel and its twin over TIMED_RUNS, the host time, bound and launch
    floor: ``ray_scan`` is the scan alone, ``ray_scan_second`` the merged
    launch at ``knobs``)."""
    from supereight_tpu_torch.ops import look_back, numerics_kernel
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import raycast as rc
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    knobs = dict(knobs)
    if knobs.pop("inside", False):
        knobs["inside_any"] = field.is_inside(
            m.voxels[field.select_channel].to(torch.float32)).any(1)
    k = _full_knobs(knobs)
    if k["normals"] == "stored" and grad_table is None:
        from supereight_tpu_torch.pipeline import gradmap
        grad_table = gradmap.build_table(m, field)
    H, W = 240, 320
    near, far = NEAR_PLANE, FAR_PLANE
    plan = rc.scan_plan(m, field, H, W, near, far, k["span_factor"],
                        k["scan_stride"], k["full_res_scan"], k["row_range"])
    second = k["second_window"] or k["midsolve"]
    err = dict.fromkeys(RAYCAST, 0.0)

    sb = dict(near_rescue=k["near_rescue"], inside_any=k["inside_any"])
    run1 = lambda: rk.splat_bounds(m, field, view, H, W, near, far, **sb)
    twin1 = lambda: rc._splat_bounds_twin(m, field, view, H, W, near, far,
                                          **sb)
    want = twin1()
    for _ in range(2):
        tmin, tmax, g = run1()
        for a, b in zip((tmin, tmax), want[:2]):
            err["splat_bounds"] = max(err["splat_bounds"], same_bits(
                torch, f"{label}: splat_bounds", a, b))
    if cpu:
        mc = to_device(m, "cpu")
        want = rc._splat_bounds_twin(
            mc, field, view.cpu(), H, W, near, far, near_rescue=k[
                "near_rescue"], inside_any=None if k["inside_any"] is None
            else k["inside_any"].cpu())
        for a, b in zip((tmin, tmax), want[:2]):
            same_bits(torch, f"{label}: splat_bounds on the CPU", a, b)

    grids = (m, dense, field, view, plan, tmin, tmax, g)
    scan_knobs = (k["second_window"], k["w2_budget"], k["midsolve"])
    run2 = lambda: rk.ray_scan(*grids)
    twin2 = lambda: rc.ray_scan_twin(*grids)
    s1, w1 = run2(), twin2()
    for a, b in zip(s1[:2], w1[:2]):
        err["ray_scan"] = max(err["ray_scan"], same_bits(
            torch, f"{label}: ray_scan", a, b))
    need2 = int(w1.need2.sum())

    scan = s1
    run3 = twin3 = None
    if second:
        run3 = lambda: rk.ray_scan(*grids, *scan_knobs)
        twin3 = lambda: rc.ray_scan_windows_twin(*grids, *scan_knobs)
        w2 = rc.ray_scan_second_twin(m, dense, field, view, plan, w1,
                                     *scan_knobs)
        scan = run3()
        for a, b in zip(scan[:2], w2[:2]):
            err["ray_scan_second"] = max(err["ray_scan_second"], same_bits(
                torch, f"{label}: ray_scan_second (the merged launch)", a,
                b))
    lb = look_back.scratch(view.device)
    if any(bool(t.any()) for t in (rk.scratch(view.device).enc, lb.status,
                                   lb.ctl)):
        fail(f"{label}: R1 or the scan left its scratch not zero")

    fk = dict(normals=k["normals"], refine=k["refine"],
              grad_decim=k["grad_decim"], grad_table=grad_table)
    run4 = lambda: rc.ray_finish(m, dense, field, view, plan, scan, **fk,
                                 refine_normals=rk.ray_refine_normals)
    twin4 = lambda: rc.ray_finish(m, dense, field, view, plan, scan, **fk,
                                  refine_normals=rc.ray_refine_normals_twin)
    fin, wfin = run4(), twin4()
    for a, b in zip(fin, wfin):
        err["ray_refine_normals"] = max(err["ray_refine_normals"], same_bits(
            torch, f"{label}: ray_refine_normals", a, b))

    before = dict(rk.LAUNCHES)
    inv_before = numerics_kernel.LAUNCHES["pose_inv"]
    whole = rc.raycast(m, field, view, H, W, near, far, dense, **knobs,
                       grad_table=grad_table)
    ran = {n: rk.LAUNCHES[n] - before[n] for n in RAYCAST}
    want_ran = dict(splat_bounds=1, ray_scan=1,
                    ray_scan_second=int(second), ray_refine_normals=1)
    if ran != want_ran:
        fail(f"{label}: the raycast launched {ran}, not {want_ran}")
    if numerics_kernel.LAUNCHES["pose_inv"] != inv_before:
        fail(f"{label}: the raycast launched pose_inv")
    twin_whole = rc.raycast_twin(m, field, view, H, W, near, far, dense,
                                 **knobs, grad_table=grad_table)
    for a, b in zip(whole, twin_whole):
        same_bits(torch, f"{label}: the whole raycast", a, b)
    note = ""
    if cpu:
        cpu_whole = rc.raycast(
            to_device(m, "cpu"), field, view.cpu(), H, W, near, far,
            {"F": dense["F"].cpu()}, **to_device(knobs, "cpu"),
            grad_table=None if grad_table is None else grad_table.cpu())
        for a, b in zip(whole, cpu_whole):
            same_bits(torch, f"{label}: the whole raycast vs the CPU", a, b)
        note = " and on the CPU"
    hit = float(fin.hit.float().mean())
    budget = min(k["w2_budget"], s1.hit.numel())
    print(f"# {label}: R1 (twice), the scan alone, the merged scan and R4 "
          f"equal their twins bit for bit, each on the same operands, and "
          f"the whole raycast raycast_twin's on the card{note}; launches "
          f"{ran}, no pose_inv; {need2} rays flagged for the second window "
          f"(budget {budget}{', cut' if need2 > budget else ''}), "
          f"{hit:.3f} of {tuple(fin.hit.shape)} pixels hit")
    if hit < 0.3:
        fail(f"{label}: the raycast hit only {hit:.3f} of the pixels")
    out = {n: dict(max_abs_err=e) for n, e in err.items()}
    if not timed:
        return out, need2
    work = raycast_work(torch, m, dense, field, view, plan, k, w1, scan,
                        tmin, g, fin,
                        _on_view(torch, m, field, view, H, W, k))
    for name, run, twin in (("splat_bounds", run1, twin1),
                            ("ray_scan", run2, twin2),
                            ("ray_scan_second", run3, twin3),
                            ("ray_refine_normals", run4, twin4)):
        if run is None:
            continue
        b = bound(*work[name])
        out[name].update(ms=median_ms(run), plain_ms=median_ms(twin),
                         host_ms=host_ms(torch, run), bound_ms=b[0],
                         bound_by=b[1], nbytes=work[name][0])
        t = out[name]
        print(f"# {label}: {name} median device time over {TIMED_RUNS} "
              f"runs {t['ms']:.4f} ms (host clock, synchronised, "
              f"{t['host_ms']:.4f} ms), plain twin {t['plain_ms']:.4f} ms; "
              f"bound {b[0]:.6f} ms ({b[1]}: {work[name][0] / 1e6:.3f} MB, "
              f"{work[name][1] / 1e6:.2f} MFLOP); launch floor "
              f"{floor:.4f} ms")
    return out, need2


def _on_view(torch, m, field, view, H, W, k) -> int:
    """R1's slots that read their inside flags: live, in front of the
    camera and projecting into the frame's margin."""
    from supereight_tpu_torch.core import numerics, octree
    from supereight_tpu_torch.pipeline import camera
    from supereight_tpu_torch.pipeline.raycast import splat_cell
    g = splat_cell(H, W)
    bc = octree.block_coords_table(m).to(torch.float32)
    hom = camera.transform_points(numerics.inv(view),
                                  (bc + 0.5) * (8 * m.voxel_size))
    z = hom[:, 2]
    zs = torch.where(z == 0, 1.0, z)
    px, py = hom[:, 0] / zs, hom[:, 1] / zs
    marg = 2.0 * g
    ok = (octree.slot_mask(m) & (z > 1e-3) & (px >= -marg)
          & (px <= W - 1 + marg) & (py >= -marg) & (py <= H - 1 + marg))
    return int(ok.sum())


def hold_splat_scratch(torch, label, m, field, pose, dev):
    """R1 on a 640x480 frame of the same pose (K doubled), whose 60x80
    splat grid is above kPoolSmemCells, so that it pools in the scratch:
    with and without near_rescue, twice in a row on the same operands,
    bit for bit with its twin.  Returns the largest error."""
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import camera
    from supereight_tpu_torch.pipeline import raycast as rc
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    H, W = 480, 640
    g = rc.splat_cell(H, W)
    if (H // g) * (W // g) <= rk.POOL_SMEM_CELLS:
        fail("splat_bounds: the scratch grid is not above kPoolSmemCells")
    view = pose @ camera.inverse_camera_matrix(
        torch.from_numpy(2 * K).to(dev))
    err = 0.0
    for near_rescue in (True, False):
        want = rc._splat_bounds_twin(m, field, view, H, W, NEAR_PLANE,
                                     FAR_PLANE, near_rescue)
        for _ in range(2):
            got = rk.splat_bounds(m, field, view, H, W, NEAR_PLANE,
                                  FAR_PLANE, near_rescue)
            for a, b in zip(got[:2], want[:2]):
                err = max(err, same_bits(
                    torch, f"{label}: splat_bounds at {W}x{H}", a, b))
    print(f"# {label}: splat_bounds at {W}x{H} ({H // g}x{W // g} cells, "
          f"above {rk.POOL_SMEM_CELLS}: the scratch pool) equals its twin "
          "bit for bit with and without near_rescue, twice in a row")
    return err


def raycast_registers():
    """The raycast kernels as built: each one's ``-Xptxas -v`` registers,
    stack frame and spills; fails if R1, the merged scan or R4 has a stack
    frame or spills.  {kernel: its properties}."""
    from supereight_tpu_torch.probes import sass_count
    props = {}
    for f, p in sass_count.ptxas_properties(
            sass_count.ptxas_log("raycast")).items():
        if "stack" not in p:
            continue
        # R4 is built for each view type: keep the heavier instantiation
        name = sass_count.kernel_name(f)
        if name not in props or (p["stack"], p["spill_stores"],
                                 p.get("registers", 0)) > (
                props[name]["stack"], props[name]["spill_stores"],
                props[name].get("registers", 0)):
            props[name] = p
    for name in ("splat_bounds", "ray_scan", "ray_refine_normals"):
        if name not in props:
            fail(f"raycast: no -Xptxas -v line for {name}")
        p = props[name]
        print(f"# {name} (-Xptxas -v): {p.get('registers')} registers, "
              f"{p['stack']} bytes stack frame, {p['spill_stores']} bytes "
              f"spill stores, {p['spill_loads']} bytes spill loads")
        if p["stack"] or p["spill_stores"] or p["spill_loads"]:
            fail(f"{name}: goes through local memory")
    return props


def check_raycast_kernels(torch, depths, poses, dev):
    """The raycast phase: R1, the scan (alone, and merged with the second
    window and the midsolve) and R4 held against their twins
    (hold_raycast) on the headline map after RAYCAST_FRAMES frames in
    every knob group of RAYCAST_MODES and on the ofusion map (its held
    view) in those of RAYCAST_OF_MODES, each also against the raycast on
    CPU copies; the budget group must cut the second window; R1 on a grid
    above kPoolSmemCells (hold_splat_scratch); the kernels' registers
    (raycast_registers).  Timed at the headline's own knobs.  Returns
    their JSON entries."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.pipeline import camera, raycast
    floor = median_ms(lambda: gp.empty_launch(dev))
    regs = raycast_registers()
    out = {}
    for preset, modes in (("headline", RAYCAST_MODES),
                          ("ofusion", RAYCAST_OF_MODES)):
        slam = warm_map(preset_config(preset), depths, poses, dev,
                        RAYCAST_FRAMES)
        st = slam.state
        view = st.pose @ camera.inverse_camera_matrix(
            torch.from_numpy(K).to(dev))
        dense = {"F": st.view} if st.view is not None else \
            raycast.pack_view(st.map, slam.field)
        for i, (mode, knobs) in enumerate(modes.items()):
            timed = not out
            r, need2 = hold_raycast(
                torch, f"{preset} map after {RAYCAST_FRAMES} frames, {mode}",
                st.map, slam.field, view, dense, knobs, cpu=True,
                timed=timed, floor=floor)
            if knobs.get("w2_budget") == RAYCAST_BUDGET and \
                    need2 <= RAYCAST_BUDGET:
                fail(f"{mode}: {need2} flagged rays do not exceed the "
                     "budget")
            if timed:
                out = {n: glue_entry(
                    n, "supereight_tpu_torch/csrc/raycast.cu",
                    RAYCAST_REPLACES[n], 0.0, t["ms"], t["plain_ms"],
                    (t["bound_ms"], t["bound_by"]), None, floor,
                    host_ms=t["host_ms"],
                    registers=regs[RAYCAST_KERNEL[n]].get("registers"))
                    for n, t in r.items()}
                out["ray_scan"]["launches_counted_in"] = \
                    LAUNCHES_COUNTED_IN["ray_scan"]
            for n, t in r.items():
                out[n]["max_abs_err"] = max(out[n]["max_abs_err"],
                                            t["max_abs_err"])
        e = hold_splat_scratch(torch, f"{preset} map", st.map, slam.field,
                               st.pose, dev)
        out["splat_bounds"]["max_abs_err"] = max(
            out["splat_bounds"]["max_abs_err"], e)
        del slam, st, dense
    torch.cuda.empty_cache()
    return out


def check_path_raycast(torch, name, slam, cfg, kernels):
    """The run's reference raycast from its last pose on its final map
    (its held view and gradient table): R1-R4 against their twins
    (hold_raycast; on the CPU too at 256^3)."""
    from supereight_tpu_torch.pipeline import camera, raycast
    st = slam.state
    view = st.pose @ camera.inverse_camera_matrix(
        torch.from_numpy(K).to(st.pose.device))
    dense = {"F": st.view} if st.view is not None else \
        raycast.pack_view(st.map, slam.field)
    r, _ = hold_raycast(torch, f"{name}: its last pose's raycast", st.map,
                        slam.field, view, dense, raycast_knobs(cfg),
                        grad_table=st.grad, cpu=st.map.size <= 256)
    for n, t in r.items():
        kernels[n]["max_abs_err"] = max(kernels[n]["max_abs_err"],
                                        t["max_abs_err"])


@contextlib.contextmanager
def counting_raycasts():
    """Counts the raycasts that ran while the block runs: the calls of
    ``raycast.raycast`` (the stage's and the renderers'), less those that
    a CUDA graph captured (a capture runs nothing), plus the stage's graph
    replays (``raycast_graph.COUNTS``).  Yields a list whose one entry is
    the count once the block has ended."""
    from supereight_tpu_torch.pipeline import raycast, raycast_graph
    calls = [0]
    inner = raycast.raycast
    graphs = dict(raycast_graph.COUNTS)

    @functools.wraps(inner)
    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    raycast.raycast = counted
    try:
        yield calls
    finally:
        raycast.raycast = inner
        calls[0] += (raycast_graph.COUNTS["replays"] - graphs["replays"]) \
            - (raycast_graph.COUNTS["captures"] - graphs["captures"])


def check_raycast_launched(label, counts, raycasts, second=True):
    """Every raycast went through the kernels: R1, R2 and R4 once each,
    R3 once where the second window or the midsolve is on."""
    got = {k: counts.get(k, 0) for k in RAYCAST}
    want = dict(splat_bounds=raycasts, ray_scan=raycasts,
                ray_scan_second=raycasts if second else 0,
                ray_refine_normals=raycasts)
    print(f"# {label}: raycast LAUNCHES {got} ({raycasts} raycasts)")
    if raycasts == 0 or got != want:
        fail(f"{label}: raycast kernels launched {got} for {raycasts} "
             f"raycasts, not {want}")


def smem_bound_ms(gathers: int, sms: int, mhz: float) -> float:
    """Least time ``gathers`` 4-byte shared-memory loads take at 32 banks x
    4 bytes a clock on each of ``sms`` SMs at ``mhz``."""
    return 1e3 * 4 * gathers / (sms * 32 * 4 * mhz * 1e6)


#: passes over the resident table of the reduction that times its read rate
RESIDENT_PASSES = 64


def resident_read_rate(torch, table) -> float:
    """Bytes a second at which one PyTorch reduction reads ``table`` while
    it sits in the L2 (K3's 6 MB table; the card's L2 holds 50 MB): an
    int64 max over RESIDENT_PASSES passes of it, in one launch.  A rate
    some code reaches, so a time at it is not a lower bound, only a
    tighter reference than the memory's rate for data that never leaves
    the L2."""
    passes = table.view(torch.int64).view(1, -1) \
        .expand(RESIDENT_PASSES, -1)
    ms = median_ms(lambda: passes.amax())
    return RESIDENT_PASSES * table.nbytes / (1e-3 * ms)


def probe_cases(torch, dev):
    """K2 and K3 at the probe's shapes and at their second shapes: {name:
    (replaces, [(shape label, kernel call, twin call, (byte bound ms, what
    binds), warp-trips of the main loop, shared-memory gathers or None,
    bytes read from the resident table or None), ...], the one PyTorch
    call at the probe's shape or None, the table or None)}."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.probes import gather_probe as probe

    k2, table, k3 = probe.kernel_inputs(dev)
    slabs = table.view(-1, gp.SLAB_ROWS * table.shape[1])

    def k2_case(src, idx):
        # bytes each input read once and the output written once
        nbytes = src.nbytes + idx.nbytes + src.nbytes
        S = src.shape[0]
        return (f"{S}x{gp.LANES}x{probe.KREP}",
                lambda: gp.lane_shuffle_sum(src, idx, probe.KREP),
                lambda: gp.lane_shuffle_sum_reference(src, idx, probe.KREP),
                bound(nbytes, src.numel() * probe.KREP),
                gp.shuffle_warp_trips(S), src.numel() * probe.KREP, None)

    def k3_case(rows):
        # K3 reads the distinct slabs its rows name, not the whole table
        n_slabs = int(torch.unique(rows).numel())
        resident = n_slabs * slabs.shape[1] * 2
        nbytes = rows.nbytes + resident + gp.SLAB_ROWS * table.shape[1] * 4
        return (f"{rows.numel()} slabs ({n_slabs} distinct)",
                lambda: gp.slab_row_sum(rows, table),
                lambda: gp.slab_row_sum_reference(rows, table),
                bound(nbytes, rows.numel() * slabs.shape[1]),
                gp.slab_warp_trips(rows.numel(), table.shape[1]), None,
                resident)

    def bag_sum(rows):
        bags = (rows // gp.SLAB_ROWS).long()[None]
        return lambda: torch.nn.functional.embedding_bag(bags, slabs,
                                                         mode="sum")

    return {
        "lane_shuffle_sum": ("scripts/pallas_gather_probe.py:105",
                             [k2_case(*x) for x in k2], None, None),
        # one call that gathers and sums the same slabs, at each shape:
        # embedding_bag (it sums in its own order and returns bf16)
        "slab_row_sum": ("scripts/pallas_gather_probe.py:146",
                         [k3_case(x) for x in k3],
                         [bag_sum(x) for x in k3], table),
    }


def check_probe_kernels(torch, dev):
    """K2 and K3 vs their twins at the probe's shapes and at their second
    shapes (bit for bit), timed beside the launch floor (an empty kernel),
    the byte bound, the issue lower bound of the main loop (compiled code,
    `probes/sass_count.py`) and, for K2, the shared-memory bound; then the
    probe itself, the kernels' main path, with their counts set to 0 just
    before it."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.probes import gather_probe as probe
    from supereight_tpu_torch.probes import sass_count

    _, _, mhz, sms, issue_per_s = sass_count.card_issue_rate()
    trips = sass_count.gather_trips()
    floor = median_ms(lambda: gp.empty_launch(dev))
    print(f"# launch floor (an empty kernel, timed as the kernels are): "
          f"{floor:.4f} ms; loop trips (SASS instructions): {trips}")
    kernels = {}
    for name, (replaces, shapes, library, table) in \
            probe_cases(torch, dev).items():
        rate = None if table is None else resident_read_rate(torch, table)
        if rate is not None:
            print(f"# {name}: one reduction reads its resident table at "
                  f"{rate / 1e12:.3f} TB/s ({RESIDENT_PASSES} passes of "
                  f"{table.nbytes / 1e6:.2f} MB in one launch)")
        held = []
        for label, fn, plain, (b_ms, b_by), warp_trips, gathers, resident \
                in shapes:
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            mismatch = int((out != ref).sum())
            max_err = float((out - ref).abs().max())
            print(f"# {name} vs twin at {label}: {mismatch} of {out.numel()} "
                  f"differ, max abs err {max_err:.3g}")
            if mismatch:
                fail(f"{name} and its twin are not bit-identical at {label}")
            trip = trips[name + "<64>" if name == "lane_shuffle_sum" else name]
            issue_ms = sass_count.loop_issue_lower_bound_ms(
                trip, warp_trips, issue_per_s)
            smem_ms = None if gathers is None \
                else smem_bound_ms(gathers, sms, mhz)
            resident_ms = None if resident is None \
                else 1e3 * resident / rate
            ms = median_ms(fn)
            print(f"# {name} at {label}: median device time over "
                  f"{TIMED_RUNS} runs {ms:.4f} ms (launch floor {floor:.4f});"
                  f" byte bound {b_ms:.5f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f} % of it; issue lower bound "
                  f"{issue_ms:.5f} ms ({trip} instructions x {warp_trips} "
                  f"warp-trips), {100 * issue_ms / ms:.1f} % of it"
                  + ("" if smem_ms is None else
                     f"; shared-memory bound {smem_ms:.5f} ms, "
                     f"{100 * smem_ms / ms:.1f} % of it")
                  + ("" if resident_ms is None else
                     f"; its distinct slabs at the resident read rate "
                     f"{resident_ms:.5f} ms, {100 * resident_ms / ms:.1f} % "
                     f"of it"))
            held.append(dict(shape=label, max_abs_err=max_err, ms=ms,
                             bound_ms=b_ms, bound_by=b_by, issue_ms=issue_ms,
                             smem_ms=smem_ms, resident_ms=resident_ms))
        # the twin and the one PyTorch call at the probe's shape
        probe_shape, scale = held
        if name == "slab_row_sum":
            # one column tile of the probe's rows (a cluster for each slab
            # row): whether the card or each CTA sets the time
            d = probe.make_data()
            rows = probe.rows_inputs(d, 1, dev)[0]
            tile = probe.table16(d, dev)[:, :gp.TILE_COLS].contiguous()
            scale["one_tile_ms"] = median_ms(
                lambda: gp.slab_row_sum(rows, tile))
            print(f"# slab_row_sum at {probe_shape['shape']} on one "
                  f"{gp.TILE_COLS}-column tile ({gp.slab_grid(gp.TILE_COLS)}"
                  f" CTAs): {scale['one_tile_ms']:.4f} ms")
        plain_ms = median_ms(shapes[0][2])
        library_ms = None if library is None else median_ms(library[0])
        print(f"# {name} at {probe_shape['shape']}: plain twin "
              f"{plain_ms:.4f} ms, one PyTorch call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}")
        scale["plain_ms"] = median_ms(shapes[1][2])
        scale["library_ms"] = None if library is None \
            else median_ms(library[1])
        print(f"# {name} at {scale['shape']}: plain twin "
              f"{scale['plain_ms']:.4f} ms, one PyTorch call "
              + ("none" if library is None
                 else f"{scale['library_ms']:.4f} ms"))
        kernels[name] = dict(
            name=name, route="cuda",
            source="supereight_tpu_torch/csrc/gather_probe.cu",
            replaces=replaces,
            max_abs_err=max(h["max_abs_err"] for h in held),
            ms=probe_shape["ms"], plain_ms=plain_ms,
            bound_ms=probe_shape["bound_ms"],
            bound_by=probe_shape["bound_by"], library_ms=library_ms,
            issue_ms=probe_shape["issue_ms"], smem_ms=probe_shape["smem_ms"],
            resident_ms=probe_shape["resident_ms"],
            resident_read_tb_s=None if rate is None else rate / 1e12,
            launch_floor_ms=floor, at_scale=scale)

    for k in gp.LAUNCHES:
        gp.LAUNCHES[k] = 0
    res = probe.measure(dev)
    for name, kernel in kernels.items():
        kernel["launches"] = gp.LAUNCHES[name]
        if kernel["launches"] == 0:
            fail(f"the probe did not launch {name}")
    for name, m in res.items():
        print(f"# probe {name}: {m['ms']:.4f} ms, {m['ns_per_elem']:.4f} "
              "ns/elem")
    return kernels


def icp_operands(torch, depths, poses, dev):
    """The headline's tracking operands at frame ICP_FRAME on the card, as
    ``tracking_stage`` takes them: the system after the frames before it,
    that frame's preprocessing and pyramid, the reference maps, the view
    and the start pose."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing, system
    cfg = preset_config("headline")
    slam = warm_map(cfg, depths, poses, dev, ICP_FRAME)
    kd, neg_y = slam._k(K)
    st = system.preprocessing_stage(slam.state, slam._depth(
        depths[ICP_FRAME]), cfg)
    pyr = preprocessing.build_pyramid(st.scaled_depth, kd, len(cfg.pyramid),
                                      neg_y=neg_y)
    return dict(cfg=cfg, depths=pyr[0], vertices=pyr[1], normals=pyr[2],
                ref_v=st.ref_vertex, ref_n=st.ref_normal,
                rpose=st.raycast_pose, k=kd, start=st.pose,
                view=camera.camera_matrix(kd) @ numerics.inv(
                    st.raycast_pose))


def icp_level(ops, shape):
    """The input maps of ``ICP_SHAPES[shape]`` (views: strided, a strip)."""
    level, d, strip = ICP_SHAPES[shape]
    iv, inm = ops["vertices"][level], ops["normals"][level]
    iv, inm = iv[::d, ::d], inm[::d, ::d]
    if strip is not None:
        rank, n = strip
        rows = iv.shape[0] // n
        iv, inm = (a[rank * rows:(rank + 1) * rows] for a in (iv, inm))
    return iv, inm


def icp_carry(torch, pose):
    """A level's carry at its start: ``pose``, no sums, no trip run."""
    from supereight_tpu_torch.pipeline import tracking
    dev = pose.device
    return tracking.TrackState(
        pose=pose.clone(), error2=torch.zeros((), device=dev),
        count=torch.zeros((), device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        iteration=torch.zeros((), dtype=torch.int32, device=dev))


def icp_knobs(torch, knobs, dev):
    """A knob group of ICP_KNOBS as the kernels take it (the gate: a bool
    on the device)."""
    sym = {"off": False, "on": True,
           "gate": torch.tensor(True, device=dev)}[knobs["symmetric"]]
    return dict(knobs, symmetric=sym)


def reached_rows(torch, ops, iv, inm, knobs):
    """The reference rows the level's in-frame pixels with an input normal
    reach from the start pose (one a pixel, four with the bilinear
    association), with repeats."""
    from supereight_tpu_torch.pipeline import tracking
    from supereight_tpu_torch.core.numerics import trunc_i32
    rH, rW = ops["ref_v"].shape[:2]
    _, px, py, in_frame = tracking._project(ops["start"], ops["view"], iv,
                                            rH, rW)
    need = in_frame & (inm[..., 0] != -2.0)
    if knobs["assoc"] == "nearest":
        rows = [trunc_i32(py).clamp(0, rH - 1) * rW
                + trunc_i32(px).clamp(0, rW - 1)]
    else:
        x0 = trunc_i32(torch.floor(px - 0.5)).clamp(0, rW - 1)
        y0 = trunc_i32(torch.floor(py - 0.5)).clamp(0, rH - 1)
        x1, y1 = (x0 + 1).clamp(max=rW - 1), (y0 + 1).clamp(max=rH - 1)
        rows = [y * rW + x for y in (y0, y1) for x in (x0, x1)]
    return torch.cat([r[need] for r in rows])


def icp_bytes(torch, ops, iv, inm, knobs) -> int:
    """Bytes kernel A must move at these operands: the level's input maps
    read once, the reference rows its in-frame pixels with an input normal
    reach (each distinct row's 24 bytes once), the status image and the
    sums written, the pose, the view and the carry's flags read."""
    distinct = int(torch.unique(reached_rows(torch, ops, iv, inm,
                                             knobs)).numel())
    n_px = iv.shape[0] * iv.shape[1]
    return n_px * 24 + distinct * 24 + n_px * 4 + 29 * 4 + 2 * 64 + 5


def icp_level_set(ops, d):
    """The pyramid's levels by index as ``icp_track_levels`` takes them,
    the finest strided by ``d``."""
    levels = list(zip(ops["vertices"], ops["normals"]))
    levels[0] = tuple(a[::d, ::d] for a in levels[0])
    return levels


def icp_levels_bytes(torch, ops, levels, knobs) -> int:
    """Bytes ``icp_track_levels`` must move at these operands: every
    level's input maps read once, the distinct reference rows all its
    levels' pixels reach, the finest level's status image and the carry
    written, the start pose, the raycast pose and the intrinsics read."""
    distinct = int(torch.unique(torch.cat([
        reached_rows(torch, ops, iv, inm, knobs) for iv, inm in levels
    ])).numel())
    n_px = [iv.shape[0] * iv.shape[1] for iv, _ in levels]
    return 24 * sum(n_px) + 24 * distinct + 4 * n_px[0] + 4 * 20 + 2 * 64 \
        + 16


def level_trips(torch, ops, levels, iterations, threshold) -> list:
    """The trips each level runs from the start pose (``_level_loop`` on
    CPU copies, the twins, level by level), by level index."""
    from supereight_tpu_torch.pipeline import tracking
    cpu = lambda t: t.cpu()
    st = icp_carry(torch, cpu(ops["start"]))
    trips = [0] * len(levels)
    for level in range(len(levels) - 1, -1, -1):
        st, _ = tracking._level_loop(
            st, iterations[level], *map(cpu, levels[level]),
            cpu(ops["ref_v"]), cpu(ops["ref_n"]), cpu(ops["view"]),
            threshold)
        trips[level] = int(st.iteration)
    return trips


def hold_icp(torch, ops, shape, knobs):
    """Kernel A and its twin at one level shape and knob group, from the
    start carry, then kernel B and its twin on kernel A's sums, each from
    its own copy of the carry.  Fails unless the status images are equal
    and the sums, twists and poses agree within the ICP tolerances.
    Returns (largest sum difference, largest twist or pose difference,
    ok pixels)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    dev = ops["start"].device
    iv, inm = icp_level(ops, shape)
    kn = icp_knobs(torch, knobs, dev)
    args = (iv, inm, ops["ref_v"], ops["ref_n"], ops["view"])
    st = icp_carry(torch, ops["start"])
    res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=dev)
    sums = torch.zeros(icp.N_SUMS, device=dev)
    _, got_res, got_sums = icp.icp_track_reduce(*args, st, 4, res.clone(),
                                                sums.clone(), **kn)
    _, want_res, want_sums = icp.icp_track_reduce_twin(*args, st, 4, res,
                                                       sums, **kn)
    g, w, beyond = sums_beyond(torch, args, st.pose, kn, got_sums, want_sums)
    flips = int((got_res != want_res).sum())
    x_k, x_t = (torch.zeros(6, device=dev) for _ in range(2))
    k_st = icp.icp_update(got_sums, icp_carry(torch, ops["start"]), 4, 1e-5,
                          twist=x_k)
    t_st = icp.icp_update_twin(got_sums, icp_carry(torch, ops["start"]), 4,
                               1e-5, twist=x_t)
    d_x = float((x_k - x_t).abs().max())
    d_pose = float((k_st.pose - t_st.pose).abs().max())
    tol_x, exact = solve_tolerance(torch, got_sums)
    tol_pose = ICP_UPDATE_ATOL + (tol_x - ICP_UPDATE_ATOL) * float(
        ops["start"].abs().sum(0).max())
    same = all(torch.equal(getattr(k_st, f), getattr(t_st, f))
               for f in ("error2", "count", "converged", "iteration"))
    if flips or beyond or d_x > tol_x or d_pose > tol_pose or not same:
        fail(f"ICP kernels vs twins at {shape} {knobs}: {flips} statuses "
             f"differ, {beyond} sums beyond the tolerance, twist {d_x:.3g} "
             f"(tolerance {tol_x:.3g}), pose {d_pose:.3g} (tolerance "
             f"{tol_pose:.3g}), carry fields equal {same}")
    hold_merged_trip(torch, ops, shape, knobs, args, kn, got_sums, k_st)
    to_exact = [float((x.double().cpu() - exact).abs().max())
                for x in (x_k, x_t)]
    return (float((g - w).abs().max()), max(d_x, d_pose),
            int((got_res == 1).sum()), to_exact)


def sums_beyond(torch, args, pose, kn, got, want):
    """(kernel sums, twin sums, float64, and how many differ beyond the
    ICP tolerances) of one trip at ``pose``."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    td = tracking.track_kernel(*args[:4], pose, args[4],
                               symmetric=kn["symmetric"], assoc=kn["assoc"])
    mag = icp.term_magnitudes(td, tracking.robust_weights(
        td, kn["robust"], kn["robust_delta"]))
    g, w = got.double(), want.double()
    return g, w, int((torch.abs(g - w) > ICP_SUM_RTOL * w.abs()
                      + ICP_SUM_MAG * mag).sum())


def hold_merged_trip(torch, ops, shape, knobs, args, kn, pending, b_st):
    """The merged trip: kernel A with ``pending`` (a first trip's sums) to
    apply, from the start carry.  Its carry must be kernel B's on the same
    sums (``b_st``) bit for bit, its status image and sums kernel A's from
    that carry with nothing pending bit for bit, and its sums within the
    ICP tolerances of the twin's (the twin's pass at the same pose)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    dev = ops["start"].device
    st = icp_carry(torch, ops["start"])
    res = torch.zeros(args[0].shape[:2], dtype=torch.int32, device=dev)
    sums = torch.zeros(icp.N_SUMS, device=dev)
    st, res, sums = icp.icp_track_reduce(*args, st, 4, res, sums,
                                         pending=pending.clone(),
                                         icp_threshold=1e-5, **kn)
    carry = all(torch.equal(a, b) for a, b in zip(st, b_st))
    ref = icp.icp_track_reduce(*args, icp_carry(torch, b_st.pose), 4,
                               torch.zeros_like(res), torch.zeros_like(sums),
                               **kn)
    twin = icp.icp_track_reduce_twin(*args, icp_carry(torch, b_st.pose), 4,
                                     torch.zeros_like(res),
                                     torch.zeros_like(sums), **kn)
    _, _, beyond = sums_beyond(torch, args, b_st.pose, kn, sums, twin[2])
    if not carry or not torch.equal(res, ref[1]) or \
            not torch.equal(sums, ref[2]) or not torch.equal(res, twin[1]) \
            or beyond:
        fail(f"the merged trip at {shape} {knobs}: carry kernel B's "
             f"{carry}, status image and sums kernel A's "
             f"{torch.equal(res, ref[1])} {torch.equal(sums, ref[2])}, "
             f"status image the twin's {torch.equal(res, twin[1])}, "
             f"{beyond} sums beyond the tolerance")


def solve_tolerance(torch, sums):
    """(ICP_UPDATE_ATOL + 2 eps cond(JTJ) |x|_inf, the float64 solve x) of
    the system of the sums (float64 on the host)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    _, JTe, JTJ, _ = icp.unpack_sums(sums)
    A, b = JTJ.double().cpu(), JTe.double().cpu()
    x = torch.linalg.solve(A, b)
    return (ICP_UPDATE_ATOL + 2 * FP32_EPS * float(torch.linalg.cond(A))
            * float(x.abs().max())), x


def hold_icp_levels(torch, ops, level_set, knobs):
    """``icp_track_levels`` against its twin (plain PyTorch on the card) at
    one level set of ICP_LEVEL_SETS and knob group: one trip at the finest
    level from the start pose, the status image bit for bit and the sums
    within the ICP tolerances; then the headline's pyramid, the pose within
    ICP_TRACK_ATOL, a whole ``track``'s tolerance (the sums add in another
    order, which ICP amplifies from trip to trip).  The pyramid's status
    image is the last trip's at a pose that parts from the twin's by that
    much, so its flipped pixels are counted, not held (on an H100 the
    bilinear association's gates flipped 0.15 % of the headline's pixels
    at 3.6e-5 m).  Returns (largest sum difference, pose difference, status pixels
    flipped, ok pixels, the finest level's trips: kernel, twin)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    dev = ops["start"].device
    cfg = ops["cfg"]
    levels = icp_level_set(ops, ICP_LEVEL_SETS[level_set])
    kn = icp_knobs(torch, knobs, dev)
    args = (levels, ops["ref_v"], ops["ref_n"], ops["view"])
    kargs = (*args[:3], ops["rpose"], ops["k"])
    one = (1,) + (0,) * (len(cfg.pyramid) - 1)
    sums = [torch.zeros(icp.N_SUMS, device=dev) for _ in range(2)]
    got = icp.icp_track_levels(ops["start"], *kargs, one, cfg.icp_threshold,
                               sums=sums[0], **kn)
    want = icp.icp_track_levels_twin(ops["start"], *args, one,
                                     cfg.icp_threshold, sums=sums[1], **kn)
    td = tracking.track_kernel(*levels[0], *args[1:3], ops["start"],
                               args[3], symmetric=kn["symmetric"],
                               assoc=kn["assoc"])
    mag = icp.term_magnitudes(td, tracking.robust_weights(
        td, kn["robust"], kn["robust_delta"]))
    g, w = sums[0].double(), sums[1].double()
    beyond = int((torch.abs(g - w) > ICP_SUM_RTOL * w.abs()
                  + ICP_SUM_MAG * mag).sum())
    flips_one = int((got[1] != want[1]).sum())
    n_ok = int((got[1] == 1).sum())
    got = icp.icp_track_levels(ops["start"], *kargs, cfg.pyramid,
                               cfg.icp_threshold, **kn)
    want = icp.icp_track_levels_twin(ops["start"], *args, cfg.pyramid,
                                     cfg.icp_threshold, **kn)
    d_pose = float((got[0].pose - want[0].pose).abs().max())
    flips = int((got[1] != want[1]).sum())
    if flips_one or beyond or d_pose > ICP_TRACK_ATOL:
        fail(f"icp_track_levels vs its twin at {level_set} {knobs}: one "
             f"trip: {flips_one} statuses differ, {beyond} sums beyond the "
             f"tolerance; the pyramid: pose {d_pose:.3g} (tolerance "
             f"{ICP_TRACK_ATOL}), {flips} statuses flipped")
    return (float((g - w).abs().max()), d_pose, flips, n_ok,
            (int(got[0].iteration), int(want[0].iteration)))


def levels_shape(ops, dev) -> dict:
    """``icp_track_levels``' launch at the headline's level set: its CTAs,
    threads a CTA and registers (``-Xptxas -v``), and a line saying so."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.probes import sass_count
    cfg = ops["cfg"]
    levels = icp_level_set(ops, cfg.icp_finest_decimate)
    n_cta = icp.levels_launch(dev, levels, cfg.pyramid)
    regs = {sass_count.kernel_name(f): p for f, p in
            sass_count.ptxas_properties(sass_count.ptxas_log("icp")).items()}
    registers = regs.get("icp_track_levels", {}).get("registers")
    return dict(ctas=n_cta, threads=icp.LEVEL_THREADS, registers=registers,
                text=f"a cooperative grid of {n_cta} CTAs (those owning "
                     f"pixels at the largest level; the card holds "
                     f"{icp.levels_grid(dev)} at once) of "
                     f"{icp.LEVEL_THREADS} threads, {registers} registers; "
                     "no grid barrier (tagged words), the solve on a warp, "
                     "the view inside the launch")


def check_icp_levels(torch, ops, dev, a_ms, b_ms, floor):
    """``icp_track_levels`` at every level set of ICP_LEVEL_SETS in every
    knob group of ICP_KNOBS against its twin; two launches bit for bit; at
    the headline's level set and knobs, its device time a frame (CUDA
    events, median of TIMED_RUNS) and host time beside its bound, its
    twin's, the pair's for the same trips (the trips each level runs times
    kernel A's time at that level with an update inside, ``a_ms``, plus
    kernel B's once a level, ``b_ms``, and the pair's level loops timed as
    ``_level_loop`` runs them) and the launch floor.  Returns its JSON
    entry (launches 0)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    cfg = ops["cfg"]
    shape = levels_shape(ops, dev)
    print(f"# icp_track_levels: {shape['text']}")
    sum_err = pose_err = 0.0
    for level_set, d in ICP_LEVEL_SETS.items():
        oks, flipped, trips = [], 0, set()
        for knobs in ICP_KNOBS:
            e_sum, e_pose, flips, n_ok, its = hold_icp_levels(
                torch, ops, level_set, knobs)
            sum_err, pose_err = max(sum_err, e_sum), max(pose_err, e_pose)
            flipped = max(flipped, flips)
            oks.append(n_ok)
            trips.add(its)
        iv = icp_level_set(ops, d)[0][0]
        print(f"# icp_track_levels vs its twin at {level_set} (finest level "
              f"{iv.shape[0]}x{iv.shape[1]}, headline frame {ICP_FRAME}), "
              f"{len(ICP_KNOBS)} knob groups: one trip: status images equal, "
              f"ok pixels {min(oks)}-{max(oks)}, largest sum difference so "
              f"far {sum_err:.3g}; pyramid {cfg.pyramid}: pose {pose_err:.3g}"
              f" so far (tolerance {ICP_TRACK_ATOL}), at most {flipped} of "
              f"{iv.numel() // 3} statuses flipped, finest level trips "
              f"(kernel, twin) {sorted(trips)}")

    # two launches, the same bits
    levels = icp_level_set(ops, cfg.icp_finest_decimate)
    args = (ops["start"], levels, ops["ref_v"], ops["ref_n"], ops["view"],
            cfg.pyramid, cfg.icp_threshold)
    kargs = (*args[:4], ops["rpose"], ops["k"], *args[5:])
    runs = []
    for _ in range(2):
        sums = torch.zeros(icp.N_SUMS, device=dev)
        st, res = icp.icp_track_levels(*kargs, sums=sums)
        runs.append((*st, res, sums))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("icp_track_levels: two launches on the same operands differ")
    print("# icp_track_levels: two launches on the same operands give the "
          "same bits (carry, status image, sums)")

    # times a headline frame
    run = lambda: icp.icp_track_levels(*kargs)
    plain = lambda: icp.icp_track_levels_twin(*args)

    def pair():
        st = icp_carry(torch, ops["start"])
        for level in range(len(levels) - 1, -1, -1):
            st, _ = tracking._level_loop(st, cfg.pyramid[level],
                                         *levels[level], *args[2:5],
                                         cfg.icp_threshold)

    k_ms, t_ms, pair_dev = median_ms(run), median_ms(plain), median_ms(pair)
    k_host, pair_host = host_ms(torch, run), host_ms(torch, pair)
    trips = level_trips(torch, ops, levels, cfg.pyramid, cfg.icp_threshold)
    shapes = ("160x120 decimated", "160x120", "80x60")
    pair_sum = sum(n * a_ms[shapes[l]] + b_ms
                   for l, n in enumerate(cfg.pyramid) if n)
    main = dict(ICP_KNOBS[0])
    n_px = [iv.shape[0] * iv.shape[1] for iv, _ in levels]
    nbytes = icp_levels_bytes(torch, ops, levels, main)
    flops = (sum(t * n for t, n in zip(trips, n_px)) * ICP_PIXEL_FLOPS
             + sum(trips) * ICP_UPDATE_FLOPS)
    b = bound(nbytes, flops)
    print(f"# icp_track_levels a headline frame (frame {ICP_FRAME}, pyramid "
          f"{cfg.pyramid}, trips run by level {trips}): median device time "
          f"over {TIMED_RUNS} runs {k_ms:.4f} ms (host clock, synchronised, "
          f"{k_host:.4f} ms), plain twin {t_ms:.4f} ms; bound "
          f"{b[0]:.6f} ms ({b[1]}: {nbytes / 1e6:.3f} MB, "
          f"{flops / 1e6:.1f} MFLOP); the pair for the same "
          f"{sum(cfg.pyramid)} trips: {pair_sum:.4f} ms (each trip's "
          f"kernel A with its update at its level, a level's kernel B), its "
          f"level loops {pair_dev:.4f} ms of device time and "
          f"{pair_host:.4f} ms on the host clock "
          f"({sum(cfg.pyramid) + sum(1 for n in cfg.pyramid if n)} "
          f"launches); launch floor "
          f"{floor:.4f} ms; {card()}")
    return dict(
        name="icp_track_levels", route="cuda",
        source="supereight_tpu_torch/csrc/icp.cu",
        replaces="supereight_tpu/pipeline/tracking.py:309", launches=0,
        max_abs_err=sum_err, ms=k_ms, plain_ms=t_ms, bound_ms=b[0],
        bound_by=b[1], library_ms=None, launch_floor_ms=floor,
        host_ms=k_host, pose_err=pose_err, pair_ms=pair_sum,
        pair_levels_ms=pair_dev, pair_levels_host_ms=pair_host,
        **{k: v for k, v in shape.items() if k != "text"})


def host_ms(torch, fn) -> float:
    """Median host time (ms) of ``fn`` over TIMED_RUNS runs, the device
    synchronised before and after each."""
    out = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip(
                          ).splitlines()[0]


def check_icp_kernels(torch, depths, poses, dev):
    """The ICP kernels against their twins on the operands of the headline
    frame ICP_FRAME: every shape of ICP_SHAPES in every knob group of
    ICP_KNOBS (kernel A, then kernel B on its sums); both timed at ICP_MAIN
    with the headline's knobs beside their twins, the launch floor and
    their bounds; a whole ``track`` on the kernels against one on the
    twins (CPU copies of the operands); and the level loops of ``track``
    under
    ``torch.cuda.set_sync_debug_mode("error")`` in each symmetric mode.
    Returns the two kernels' JSON entries (launches 0)."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    ops = icp_operands(torch, depths, poses, dev)
    cfg = ops["cfg"]
    sum_err = upd_err = 0.0
    for shape in ICP_SHAPES:
        oks, k_exact, t_exact = [], 0.0, 0.0
        for knobs in ICP_KNOBS:
            e_sum, e_upd, n_ok, (k_x, t_x) = hold_icp(torch, ops, shape,
                                                       knobs)
            sum_err, upd_err = max(sum_err, e_sum), max(upd_err, e_upd)
            k_exact, t_exact = max(k_exact, k_x), max(t_exact, t_x)
            oks.append(n_ok)
        iv, _ = icp_level(ops, shape)
        print(f"# ICP kernels vs twins at {shape} ({iv.shape[0]}x"
              f"{iv.shape[1]} pixels, headline frame {ICP_FRAME}), "
              f"{len(ICP_KNOBS)} knob groups: status images equal, ok pixels "
              f"{min(oks)}-{max(oks)}; largest sum difference so far "
              f"{sum_err:.3g} (tolerance rtol {ICP_SUM_RTOL} + {ICP_SUM_MAG}"
              f" x the terms' absolute sum), twist/pose {upd_err:.3g} "
              f"(tolerance {ICP_UPDATE_ATOL} + 2 eps cond(JTJ) |x|); twist "
              f"from the float64 solve: kernel {k_exact:.3g}, twin "
              f"{t_exact:.3g}")

    # times at the headline's level 0 with its knobs
    main = dict(ICP_KNOBS[0])
    iv, inm = icp_level(ops, ICP_MAIN)
    args = (iv, inm, ops["ref_v"], ops["ref_n"], ops["view"])
    kn = icp_knobs(torch, main, dev)
    floor = median_ms(lambda: gp.empty_launch(dev))
    # a trip as the sharded loop runs it: the previous trip's update
    # (another trip's sums) then the pass, the threshold 0 so that the
    # pass runs; the carry restored before each run
    a_times, pending = {}, {}
    for shape in ICP_SHAPES:
        lv = icp_level(ops, shape)
        r2 = torch.zeros(lv[0].shape[:2], dtype=torch.int32, device=dev)
        first = icp.icp_track_reduce(
            *lv, ops["ref_v"], ops["ref_n"], ops["view"],
            icp_carry(torch, ops["start"]), 4, r2,
            torch.zeros(icp.N_SUMS, device=dev), **kn)[2]
        carry, out = icp_carry(torch, ops["start"]), torch.zeros_like(first)
        start = icp_carry(torch, ops["start"])
        scratch = icp.make_scratch(r2.numel(), dev)
        a_times[shape] = median_ms(
            lambda: icp.icp_track_reduce(
                *lv, ops["ref_v"], ops["ref_n"], ops["view"], carry, 4, r2,
                out, scratch=scratch, pending=first, icp_threshold=0.0,
                **kn),
            lambda: [a.copy_(b) for a, b in zip(carry, start)])
        pending[shape] = first
        print(f"# icp_track_reduce (the previous trip's update inside) at "
              f"{shape} ({lv[0].shape[0]}x{lv[0].shape[1]} pixels): median "
              f"device time over {TIMED_RUNS} runs {a_times[shape]:.4f} ms")
    a_ms = a_times[ICP_MAIN]
    st = icp_carry(torch, ops["start"])
    res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=dev)
    sums = torch.zeros(icp.N_SUMS, device=dev)
    plain_a = lambda: icp.icp_track_reduce_twin(
        *args, st, 4, res, sums, pending=pending[ICP_MAIN],
        icp_threshold=0.0, **kn)
    carry = icp_carry(torch, ops["start"])
    reset = lambda: [a.copy_(b) for a, b in zip(
        carry, icp_carry(torch, ops["start"]))]
    run_b = lambda: icp.icp_update(pending[ICP_MAIN], carry, 4, 1e-5)
    plain_b = lambda: icp.icp_update_twin(pending[ICP_MAIN], carry, 4, 1e-5)
    a_plain = median_ms(plain_a, reset)
    b_ms, b_plain = median_ms(run_b, reset), median_ms(plain_b, reset)
    a_bytes = icp_bytes(torch, ops, iv, inm, main) + icp.N_SUMS * 4 + 4 * 4
    a_bound = bound(a_bytes, iv.shape[0] * iv.shape[1] * ICP_PIXEL_FLOPS
                    + ICP_UPDATE_FLOPS)
    b_bound = bound(icp.N_SUMS * 4 + 2 * 64 + 4 * 4, ICP_UPDATE_FLOPS)
    print(f"# icp_track_reduce at {ICP_MAIN} (nearest, plain residual, no "
          f"weights, the previous trip's update inside): median device time "
          f"over {TIMED_RUNS} runs {a_ms:.4f} ms, plain twin {a_plain:.4f} "
          f"ms, launch floor {floor:.4f} ms; bound {a_bound[0]:.6f} ms "
          f"({a_bound[1]}: {a_bytes / 1e6:.3f} MB)")
    print(f"# icp_update (a level's last update alone): {b_ms:.4f} ms, plain "
          f"twin {b_plain:.4f} ms; bound {b_bound[0]:.2e} ms ({b_bound[1]})")
    levels_entry = check_icp_levels(torch, ops, dev, a_times, b_ms, floor)

    # a whole track on the card against one on the twins (the CPU path)
    targs = (ops["depths"], ops["vertices"], ops["normals"], ops["ref_v"],
             ops["ref_n"], ops["rpose"], ops["k"])
    kw = dict(finest_decimate=cfg.icp_finest_decimate)
    got = tracking.track(ops["start"], *targs, cfg.pyramid,
                         cfg.icp_threshold, **kw)
    want = tracking.track(*to_device(
        [ops["start"], *targs], "cpu"), cfg.pyramid, cfg.icp_threshold, **kw)
    d_pose = float((got[0].cpu() - want[0]).abs().max())
    flips = float((got[2].cpu() != want[2]).float().mean())
    print(f"# track at headline frame {ICP_FRAME}, icp_track_levels vs the "
          f"twins on the CPU: pose "
          f"{d_pose:.3g} (tolerance {ICP_TRACK_ATOL}), tracked "
          f"{bool(got[1])} / {bool(want[1])}, status flips {flips:.5f} "
          f"(tolerance {ICP_TRACK_FLIPS})")
    if d_pose > ICP_TRACK_ATOL or bool(got[1]) != bool(want[1]) or \
            flips > ICP_TRACK_FLIPS:
        fail("track on the card parts from track on the twins")

    # the level loops read nothing back: one launch a frame
    lv = (ops["vertices"], ops["normals"], ops["ref_v"], ops["ref_n"],
          ops["rpose"], ops["k"])
    for sym in ("off", "on", "gate"):
        kn = icp_knobs(torch, dict(ICP_KNOBS[0], symmetric=sym), dev)
        torch.cuda.synchronize()
        before = dict(icp.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            tracking.track_levels(ops["start"], *lv, cfg.pyramid,
                                  cfg.icp_threshold, **kw, **kn)
        except RuntimeError as e:
            fail(f"the level loops synchronised (symmetric {sym}): {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ran = {k: icp.LAUNCHES[k] - n for k, n in before.items()}
        if ran != dict(icp_track_levels=1, icp_track_reduce=0,
                       icp_update=0):
            fail(f"track_levels on one device launched {ran}")
    print("# track_levels under set_sync_debug_mode('error') (symmetric off,"
          " on, the gate): no synchronising call, one icp_track_levels "
          "launch and none of the pair each")

    src = "supereight_tpu_torch/csrc/icp.cu"
    regs = select_trip_registers()
    return {
        "icp_track_reduce": dict(
            name="icp_track_reduce", route="cuda", source=src,
            replaces="supereight_tpu/pipeline/tracking.py:235", launches=0,
            max_abs_err=sum_err, ms=a_ms, plain_ms=a_plain,
            bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=None,
            launch_floor_ms=floor, ms_by_shape=a_times,
            registers=regs["icp_track_reduce"].get("registers"),
            stack_bytes=regs["icp_track_reduce"]["stack"],
            levels_host_ms=levels_entry["pair_levels_host_ms"],
            levels_device_ms=levels_entry["pair_levels_ms"]),
        "icp_update": dict(
            name="icp_update", route="cuda", source=src,
            replaces="supereight_tpu/pipeline/tracking.py:254", launches=0,
            max_abs_err=upd_err, ms=b_ms, plain_ms=b_plain,
            bound_ms=b_bound[0], bound_by=b_bound[1], library_ms=None,
            launch_floor_ms=floor),
        "icp_track_levels": levels_entry}


def icp_frames(cfg, n_frames: int) -> int:
    """The frames of ``n_frames`` on which ICP runs outside ground-truth
    mode: every frame with ``frame % tracking_rate == 0``, whether or not
    it ends tracked."""
    return sum(1 for f in range(n_frames) if f % cfg.tracking_rate == 0)


def icp_expected(cfg, n_frames: int):
    """Launches of the pair on a rank of the sharded frame over
    ``n_frames`` frames: kernel A every trip of every level of each frame
    on which ICP runs, kernel B once each level that runs a trip."""
    frames = icp_frames(cfg, n_frames)
    return (sum(cfg.pyramid) * frames,
            sum(1 for n in cfg.pyramid if n) * frames)


def launch_view(torch, rpose, k):
    """The tracking view ``icp_track_levels`` forms inside its launch from
    the raycast pose and the intrinsics ``k`` (a launch of no trip on a
    1x1 level; not counted on any path)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    dev = rpose.device
    z = torch.zeros((1, 1, 3), device=dev)
    view = torch.empty((4, 4), device=dev)
    icp.icp_track_levels(torch.eye(4, device=dev), [(z, z)], z, z, rpose, k,
                         (0,), 0.0, view=view)
    return view


def hold_view(torch, label, rposes):
    """The view of each raycast pose of a run (those its ICP frames saw),
    formed inside ``icp_track_levels``' launch, against the card's
    ``camera_matrix(k) @ inv(raycast_pose)`` (``pose_inv`` and PyTorch's
    product), bit for bit."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera
    if not rposes:
        return
    k = torch.from_numpy(np.asarray(K, np.float32)).to(rposes[0].device)
    bad = 0
    for rp in rposes:
        _, same = bits_err(torch, launch_view(torch, rp, k),
                           camera.camera_matrix(k) @ numerics.inv(rp))
        bad += not same
    print(f"# {label}: the view inside icp_track_levels equals the card's "
          f"camera_matrix(k) @ inv(raycast_pose) bit for bit at "
          f"{len(rposes) - bad} of {len(rposes)} raycast poses")
    if bad:
        fail(f"{label}: the view inside icp_track_levels differs at {bad} "
             "raycast poses")


def check_icp_launched(label, counts, frames=None):
    """A one-device path's ICP went through ``icp_track_levels``: one launch
    a frame on which ICP runs (``frames``, where it is known; else above
    0), and none of the pair."""
    n = counts["icp_track_levels"]
    a, b = (counts[k] for k in ICP_PAIR)
    print(f"# {label}: ICP LAUNCHES icp_track_levels {n}"
          + ("" if frames is None else f" (one a frame with ICP: {frames})")
          + f", icp_track_reduce {a}, icp_update {b}")
    if n == 0 or (frames is not None and n != frames) or a or b:
        fail(f"{label}: ICP launches icp_track_levels {n}, the pair {a} / "
             f"{b}, expected {frames or 'above 0'} and 0: the path did not "
             "go through icp_track_levels once a frame")


def check_icp_pair_launched(label, counts, expected):
    """A rank of the sharded frame ran every trip through the pair:
    ``expected`` = (kernel A's launches, one a trip of every level of every
    frame with ICP, each with the previous trip's update inside; kernel
    B's, one a level), and ``icp_track_levels`` never."""
    a, b = (counts[k] for k in ICP_PAIR)
    n = counts["icp_track_levels"]
    print(f"# {label}: ICP LAUNCHES icp_track_reduce {a} (one a trip: "
          f"{expected[0]}), icp_update {b} (one a level: {expected[1]}), "
          f"icp_track_levels {n}")
    if (a, b) != tuple(expected) or n:
        fail(f"{label}: ICP launches {a} / {b}, icp_track_levels {n}, "
             f"expected {expected[0]} / {expected[1]} and 0: the rank did "
             "not go through the ICP kernels every trip")


def run_slam(torch, cfg, depths, poses, dev):
    """A main path: every cached frame through DenseSLAMSystem.step, with
    the fusion and ICP kernels' counts set to 0 just before and read just
    after."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    est, tracked, integrated, ms, rposes = [], [], [], [], []
    reset_launches()
    t0 = time.perf_counter()
    with counting_raycasts() as raycasts:
        for f in range(len(depths)):
            t1 = time.perf_counter()
            if f % cfg.tracking_rate == 0:
                # the raycast pose this frame's ICP sees
                rposes.append(slam.state.raycast_pose.clone())
            st = slam.step(depths[f], K, f)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            est.append(st.pose.cpu().numpy())
            tracked.append(st.tracked)
            integrated.append(st.integrated)
    counts = launches()
    st = slam.state
    return dict(slam=slam, cfg=cfg, est=np.stack(est), tracked=sum(tracked),
                integrated=sum(integrated), ms=ms, launches=counts,
                raycasts=raycasts[0],
                icp_frames=icp_frames(cfg, len(depths)),
                wall=time.perf_counter() - t0,
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
                ref_vertex=st.ref_vertex, ref_normal=st.ref_normal,
                rposes=rposes)


def check_run(torch, name, r, poses, record, max_ate, counter):
    """Print a run beside its JAX record and apply the gates."""
    n = len(r["est"])
    ate = ate_rmse(r["est"], poses[:n])
    launches = r["launches"][counter]
    cpu_ate, cpu_blocks = jax_cpu(name)
    print(f"# {name}, {n} frames in {r['wall']:.1f} s: tracked "
          f"{r['tracked']}/{n} (TPU record {record['tracked']}), ATE "
          f"{100 * ate:.2f} cm (JAX on the CPU {cpu_ate:.2f}, TPU record "
          f"{record['ate_cm']:.2f}, gate {100 * max_ate:.2f}), blocks "
          f"{r['blocks']} (JAX on the CPU {cpu_blocks}, TPU record "
          f"{record['blocks']}), overflow {r['overflow']} (TPU record "
          f"{record['overflow']})")
    print(f"# {name}: {counter} LAUNCHES {launches} over "
          f"{r['integrated']} integrated frames")
    check_icp_launched(name, r["launches"], r["icp_frames"])
    check_glue_launched(name, r["launches"], r["cfg"], r["icp_frames"],
                        r["integrated"])
    check_raycast_launched(name, r["launches"], r["raycasts"],
                           r["cfg"].raycast_second_window
                           or r["cfg"].raycast_midsolve)
    hold_view(torch, name, r["rposes"])
    print(f"# {name}: median ms/frame after the first 16 frames: "
          f"{statistics.median(r['ms'][16:]):.2f} (first frame "
          f"{r['ms'][0]:.1f} ms)")

    hit = r["ref_vertex"].abs().sum(-1) > 0
    if r["ref_vertex"].shape != (240, 320, 3) or \
            not bool(torch.isfinite(r["ref_vertex"]).all()) or \
            not bool(torch.isfinite(r["ref_normal"]).all()):
        fail(f"{name}: reference maps are not finite [240, 320, 3] maps")
    hit_share = float(hit.float().mean())
    print(f"# {name}: the last raycast hit {hit_share:.3f} of the pixels")
    if hit_share < MIN_HIT.get(name, 0.5):
        fail(f"{name}: the last raycast hit only {hit_share:.3f} of the "
             "pixels")
    if not np.isfinite(r["est"]).all():
        fail(f"{name}: non-finite pose")
    if r["integrated"] == 0 or launches < r["integrated"]:
        fail(f"{name}: {counter} LAUNCHES {launches} < "
             f"{r['integrated']} integrated frames: the main path did not "
             "go through the kernel")
    if r["tracked"] < MIN_TRACKED:
        fail(f"{name}: tracked {r['tracked']} < {MIN_TRACKED}")
    if record["overflow"] == 0 and r["overflow"] != 0:
        fail(f"{name}: overflow {r['overflow']} != 0")
    if ate > max_ate:
        fail(f"{name}: ATE {100 * ate:.2f} cm > {100 * max_ate:.2f} cm")
    want = REPEAT.get(name)
    if want is not None:
        got = dict(tracked=r["tracked"], ate_cm=round(100 * ate, 2),
                   blocks=r["blocks"], overflow=r["overflow"])
        if got != want:
            fail(f"{name}: {got} does not repeat the earlier runs' {want}")
        print(f"# {name}: repeats the earlier runs' counts {want}")


def check_path_kernel(torch, name, slam, cfg):
    """The run's fusion kernel against its twin on clones of the run's map
    (and held SDF view), with the slots its fusion takes at the last frame
    (`integration.fusion_operands`): every live slot when the budget is 0
    or the capacity, else the budget's frustum candidates.  The device
    time of that launch is the fusion step's.  When the candidates are
    fewer than the budget, the kernel is held again at the budget's shape:
    a table of ``budget`` distinct slots repeating the candidates' blocks
    (`synthetic_table`).  The node update rides in each launch, held on
    the run's own node tables.  Returns (kernel, max abs err)."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, integration

    st, field = slam.state, slam.field
    m = st.map
    depth = (st.scaled_depth if cfg.fuse_filtered else st.float_depth) \
        .contiguous()
    Km = camera.camera_matrix(torch.from_numpy(K).to(depth.device)) \
        .contiguous()
    slots, _, T_cw = integration.fusion_operands(m, st.pose, Km, depth.shape,
                                                 cfg.integrate_budget)
    now = float(np.float32(1.0 / 30.0) * np.float32(95))
    kernel = "fuse_ofusion" if field.name == "ofusion" else "fuse_sdf"
    view = st.view if kernel == "fuse_sdf" else None
    frame = (depth, T_cw, Km)
    r = hold_kernel(torch, name, kernel, m, field, frame, now, slots, view)
    print(f"# {name}: fusion step (in-place {kernel} on the run's "
          f"{r['rows']} {'live' if slots is None else 'listed'} slots"
          f"{', held view' if view is not None else ''}, the node update "
          f"inside) device time {r['ms']:.4f} ms (two launches apart "
          f"{r['rows_ms'] + r['nodes_ms']:.4f}), bound "
          f"{r['bound_ms']:.4f} ms")
    max_err = r["max_abs_err"]
    listed = None if slots is None else slots[slots >= 0]
    if listed is not None and listed.numel() < cfg.integrate_budget:
        table, budget_slots = synthetic_table(torch, m, cfg.integrate_budget,
                                              listed)
        r = hold_kernel(torch, f"{name} (budget shape: {cfg.integrate_budget}"
                        f" slots repeating the {listed.numel()} candidates)",
                        kernel, table, field, frame, now, budget_slots, view)
        max_err = max(max_err, r["max_abs_err"])
        del table
    # the glue on the run's own map: the frustum selection at the
    # preset's budget and at one its candidates overflow, the node update
    if cfg.integrate_budget > 0:
        cand, _ = hold_select(torch, name, m, st.pose, Km, depth.shape,
                              cfg.integrate_budget)
        hold_select(torch, name, m, st.pose, Km, depth.shape,
                    max(cand // 2, 1))
    return kernel, max_err


def check_held_view(torch, name, slam):
    """The held SDF view against a full ``pack_view`` of the same map, bit
    for bit."""
    from supereight_tpu_torch.pipeline import raycast
    view = slam.state.view
    rebuilt = raycast.pack_view(slam.state.map, slam.field)["F"]
    same = torch.equal(torch.isnan(view), torch.isnan(rebuilt)) and \
        torch.equal(torch.nan_to_num(view), torch.nan_to_num(rebuilt))
    print(f"# {name}: held view {tuple(view.shape)} {view.dtype} equals a "
          f"full pack_view rebuild bit for bit: {same}")
    if not same:
        fail(f"{name}: the held view differs from pack_view of its map")


def print_stage_times(name, cfg, depths, poses, dev):
    """Median host time per stage (device synchronised after each) over
    the frames after the first 16, from a second run with step_staged,
    and each of the port's spans' median host and self ms from a third
    run through ``step`` with tracing on
    (``probes/stage_times.span_medians``)."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    from supereight_tpu_torch.probes import stage_times
    from supereight_tpu_torch.utils.perfstats import Stats
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    t0 = time.perf_counter()
    stages = stage_times.staged_run(slam, depths, K)
    print(f"# {name}: median ms per stage after the first 16 frames "
          f"(step_staged, {time.perf_counter() - t0:.1f} s): " + ", ".join(
              f"{k} {v:.2f}" for k, v in stages.items()))
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    with Stats.tracing() as spans:
        run = stage_times.step_run(slam, depths, poses, K, ate_rmse)
    print(f"# {name}: spans of a step run with tracing on ({run['step']:.2f}"
          " ms a frame), median host / self ms (spans): " + ", ".join(
              f"{n} {h:.3f} / {s:.3f} ({c})" for n, (h, s, c) in
              stage_times.span_medians(spans).items()))


def run_preset(torch, name, dev, kernels):
    """One preset over its sequence: the run and its gates, the kernel of
    its fusion path against the twin, and its stage medians."""
    sequence, record_file, max_ate = RUNS[name]
    cfg = preset_config(name)
    depths, poses = load_sequence(sequence)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r = run_slam(torch, cfg, depths, poses, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    counter = "fuse_ofusion" if cfg.field_type == "ofusion" else "fuse_sdf"
    for k, n in r["launches"].items():
        kernels[k]["launches"] += n
    print(f"# {name}: {cfg.volume_resolution[0]}^3, capacity "
          f"{cfg.block_capacity}, budget {cfg.integrate_budget}, sequence "
          f"{sequence}; peak device memory {peak / 2 ** 30:.2f} GiB")
    check_run(torch, name, r, poses, load_record(record_file), max_ate,
              counter)
    if cfg.incremental_view and cfg.field_type == "sdf":
        check_held_view(torch, name, r["slam"])
    kernel, err = check_path_kernel(torch, name, r["slam"], cfg)
    kernels[kernel]["max_abs_err"] = max(kernels[kernel]["max_abs_err"], err)
    check_path_raycast(torch, name, r["slam"], cfg, kernels)
    if name == MESH_AT_SCALE:
        mesh_whole_map(torch, name, r["slam"], dev)
    del r
    torch.cuda.empty_cache()
    print_stage_times(name, cfg, depths, poses, dev)


def to_device(x, dev):
    """A map (its tensors, nested in dataclasses, lists and dicts) on
    ``dev``."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, dev) for v in x]
    return x


def check_held_grad(torch, name, slam):
    """The stored gradient table the run holds against ``build_table`` of
    its final map on the card, and that against the CPU's table of the
    same map: bit for bit, the NaN pattern included."""
    from supereight_tpu_torch.pipeline import gradmap
    st = slam.state
    built = gradmap.build_table(st.map, slam.field)
    cpu = gradmap.build_table(to_device(st.map, "cpu"), slam.field)

    def same(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return torch.equal(torch.isnan(a), torch.isnan(b)) and \
            torch.equal(a.nan_to_num(), b.nan_to_num())

    held_ok, cpu_ok = same(st.grad, built), same(built, cpu)
    print(f"# {name}: held gradient table {tuple(st.grad.shape)} "
          f"{st.grad.dtype} equals build_table of the final map on the card "
          f"bit for bit: {held_ok}; the card's table equals the CPU's: "
          f"{cpu_ok}")
    if not (held_ok and cpu_ok):
        fail(f"{name}: the stored gradient table differs")


def f_config(name: str):
    """Phase F's run ``name``: the headline preset on BASE with its knob
    group over it."""
    import dataclasses
    return dataclasses.replace(preset_config("headline"), **F_RUNS[name][0])


def run_phase_f(torch, dev, kernels):
    """Phase F: the headline preset over the base sequence with each knob
    group of F_RUNS over it, held to the presets' gates; with stored
    normals the held gradient table is checked too."""
    depths, poses = load_sequence("synthetic_256_frames")
    for name, (knobs, record_file) in F_RUNS.items():
        cfg = f_config(name)
        print(f"# {name}: headline + {knobs}")
        r = run_slam(torch, cfg, depths, poses, dev)
        for k, n in r["launches"].items():
            kernels[k]["launches"] += n
        check_run(torch, name, r, poses, load_record(record_file),
                  ate_gate(name), "fuse_sdf")
        if cfg.raycast_normals == "stored":
            check_held_grad(torch, name, r["slam"])
        check_path_raycast(torch, name, r["slam"], cfg, kernels)
        del r
        print_stage_times(name, cfg, depths, poses, dev)


#: the JAX package's sharded frame on a 2-device CPU mesh at G1's and G2's
#: configurations (`jax_cpu_reference.py --parts sharded`): tracked, ATE
#: cm, blocks, overflow, part_counts
JAX_CPU_G = {"G1": (92, 0.97, 2762, 0, [1982, 780]),
             "G2": (92, 0.92, 3675, 0, [2603, 1072])}
#: seconds a phase-G spawn may take in all, and a collective at most
G_TIMEOUT, G_GROUP_TIMEOUT = 600, 300


def g_backend(torch, ranks: int):
    """(backend, ranks a card): nccl with one rank a card where the host
    has a card for every rank, else gloo on CUDA tensors of ranks that
    share the cards."""
    count = torch.cuda.device_count()
    if count >= ranks:
        return "nccl", 1
    return "gloo", -(-ranks // count)


def hold_rank_kernel(torch, name, ops, dev):
    """The fusion kernel a rank launched, against its twin on that rank's
    operands: rank 0's local table (its slot range, its keys and active
    flags, its partition's count), depth, T_cw and K at the run's end."""
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.pipeline.system import config_field
    field = config_field(apply_preset(G_RUNS[name][0], SlamConfig(**BASE)))
    chans = octree.channel_specs(ops["channels"])
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt,
                                           device=dev)
    m = octree.init(ops["size"], ops["dim"], chans, dev,
                    capacity=len(ops["keys"]))
    m = m.replace(keys=t(ops["keys"]), active=t(ops["active"]),
                  n_blocks=t(ops["n_blocks"], torch.int32),
                  voxels={k: t(v) for k, v in ops["voxels"].items()})
    kernel = "fuse_ofusion" if ops["field"] == "ofusion" else "fuse_sdf"
    frame = (t(ops["depth"]), t(ops["T_cw"]), t(ops["K"]))
    r = hold_kernel(torch, f"{name} rank 0's operands ({m.capacity}-slot "
                    f"range, {ops['n_blocks']} live)", kernel, m, field,
                    frame, ops["timestamp"])
    return kernel, r["max_abs_err"]


def run_phase_g(torch, dev, kernels):
    """Phase G: the multi-device map through ``multihost.launch_jobs`` at
    full size, D ranks on the host's cards (nccl with a card a rank, else
    gloo with ranks sharing a card); G1/G2 gated against the JAX package's
    sharded CPU run, G3 held against the one-device partitioned frame on
    the card; each fusion kernel held against its twin on rank 0's
    operands; launches summed over the ranks."""
    from supereight_tpu_torch.parallel import multihost
    for name, (preset, ranks, max_visible, n_frames) in G_RUNS.items():
        backend, per_card = g_backend(torch, ranks)
        timed = name != "G3"
        job = dict(kind="frames", preset=preset, config=BASE, frames=FRAMES,
                   n_frames=n_frames, max_visible=max_visible, timed=timed,
                   dump_operands=timed)
        print(f"# {name}: {preset}, map_partitions={ranks}, "
              f"{max_visible} exchange rows a rank, {n_frames} frames: "
              f"{ranks} ranks over {backend}, {per_card} rank(s) a card "
              f"({torch.cuda.device_count()} card(s))")
        t0 = time.perf_counter()
        res = multihost.launch_jobs(ranks, [job], device="cuda",
                                    backend=backend, timeout=G_TIMEOUT,
                                    group_timeout=G_GROUP_TIMEOUT)[0]
        wall = time.perf_counter() - t0
        multi = multihost.gather_ranks(res)
        st = multi["state"]
        counter = "fuse_ofusion" if preset == "ofusion" else "fuse_sdf"
        integrated = sum(multi["integrated"])
        for k, n in multi["launches"].items():
            kernels[k]["launches"] += n
        per_rank = [r[counter] for r in multi["launches_per_rank"]]
        print(f"# {name}: {counter} LAUNCHES {per_rank} (ranks) over "
              f"{integrated} integrated frames; spawn and run {wall:.1f} s")
        if integrated == 0 or min(per_rank) < integrated:
            fail(f"{name}: a rank launched {counter} fewer times than the "
                 f"{integrated} integrated frames")
        want_icp = icp_expected(preset_config(preset), n_frames)
        for rank, counts in enumerate(multi["icp_launches_per_rank"]):
            check_icp_pair_launched(f"{name} rank {rank}", counts, want_icp)
        for rank, counts in enumerate(multi["launches_per_rank"]):
            check_raycast_launched(f"{name} rank {rank}", counts,
                                   counts.get("splat_bounds", 0))
        for k, n in multi["icp_launches"].items():
            kernels[k]["launches"] += n
        if int(st["part_counts"].sum()) != st["n_blocks"]:
            fail(f"{name}: part_counts {st['part_counts']} do not sum to "
                 f"{st['n_blocks']} blocks")
        if not np.isfinite(multi["est"]).all() or \
                not np.isfinite(st["ref_vertex"]).all():
            fail(f"{name}: non-finite pose or reference map")
        if name == "G3":
            reset_launches()
            with counting_raycasts() as raycasts:
                single = multihost.run_single(job, ranks, "cuda")
            counts = launches()
            check_raycast_launched("G3 one-device frame", counts,
                                   raycasts[0])
            check_icp_launched("G3 one-device frame", counts,
                               icp_frames(preset_config(preset), n_frames))
            for k, n in counts.items():
                kernels[k]["launches"] += n
            try:
                diffs = multihost.compare(multi, single)
            except AssertionError as e:
                fail(f"G3: {ranks} ranks != the one-device frame: {e}")
            print(f"# G3: {ranks} ranks == the one-device partitioned frame "
                  f"on the card: blocks {st['n_blocks']} "
                  f"{st['part_counts'].tolist()}, largest differences pose "
                  f"{diffs['pose']:.3g}, ref_vertex {diffs['ref_vertex']:.3g}"
                  f", live voxels {diffs['voxels']:.3g}")
            continue
        _, poses = load_sequence("synthetic_256_frames")
        ate = ate_rmse(multi["est"], poses[:n_frames])
        want = JAX_CPU_G[name]
        tracked = sum(multi["tracked"])
        print(f"# {name}: tracked {tracked}/{n_frames}, ATE "
              f"{100 * ate:.2f} cm, blocks {st['n_blocks']} "
              f"{st['part_counts'].tolist()}, overflow {st['overflow']}; "
              f"JAX sharded on the CPU: {want}")
        ms = multi["ms"][16:]
        stages = multi["stages"]
        coll = multi["collectives"]
        n_t = len(stages)
        ex = multi["exchange"] or {}
        refresh = max(ex.get("refreshes", 0), 1)
        print(f"# {name}: median ms/frame after frame 16: "
              f"{statistics.median(ms):.2f} (rank 0, host clock, device "
              f"synchronised; {backend}, {per_card} rank(s) a card)")
        print(f"# {name}: rank 0 median ms per stage after frame 16: " +
              ", ".join(f"{k} {1e3 * statistics.median(t[k] for t in stages):.2f}"
                        for k in stages[0]))
        print(f"# {name}: rank 0 in collectives after frame 16 (host clock "
              f"around each call, synchronised): all_reduce "
              f"{1e3 * coll['seconds']['all_reduce'] / n_t:.2f} ms/frame "
              f"({coll['calls']['all_reduce'] / n_t:.1f} calls, "
              f"{coll['bytes']['all_reduce'] / n_t / 1e3:.1f} kB), "
              f"all_gather {1e3 * coll['seconds']['all_gather'] / n_t:.2f} "
              f"ms/frame ({coll['calls']['all_gather'] / n_t:.1f} calls, "
              f"{coll['bytes']['all_gather'] / n_t / 1e6:.2f} MB sent)")
        print(f"# {name}: exchange: {ex.get('refreshes', 0)} refreshes after "
              f"frame 16, {ex.get('rows', 0) / refresh:.0f} visible rows of "
              f"{ex.get('budget_rows', 0) / refresh:.0f} shipped a refresh, "
              f"{ex.get('bytes', 0) / refresh / 1e6:.2f} MB received a rank "
              f"a refresh")
        if want is None:
            fail(f"{name}: no JAX CPU figures (jax_cpu_reference.py)")
        if tracked < MIN_TRACKED:
            fail(f"{name}: tracked {tracked} < {MIN_TRACKED}")
        if ate > 0.01 * (want[1] + ATE_MARGIN_DEFAULT_CM):
            fail(f"{name}: ATE {100 * ate:.2f} cm > JAX's {want[1]} + "
                 f"{ATE_MARGIN_DEFAULT_CM}")
        check_blocks(name, st["n_blocks"], want[2])
        if st["overflow"] != want[3]:
            fail(f"{name}: overflow {st['overflow']} != JAX's {want[3]}")
        kernel, err = hold_rank_kernel(torch, name, multi["operands"], dev)
        kernels[kernel]["max_abs_err"] = max(kernels[kernel]["max_abs_err"],
                                             err)


def _counters():
    from supereight_tpu_torch.ops import (icp_kernel, numerics_kernel,
                                          pyramid_kernel, raycast_kernel)
    from supereight_tpu_torch.ops import integrate_kernel as ik
    return (ik.LAUNCHES, icp_kernel.LAUNCHES, pyramid_kernel.LAUNCHES,
            numerics_kernel.LAUNCHES, raycast_kernel.LAUNCHES)


def reset_launches():
    """Every kernel count of the SLAM paths (fusion, ICP, the glue and the
    raycast) set to 0."""
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def launches():
    """The fusion, ICP, glue and raycast kernels' counts."""
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def check_blocks(label, blocks, want):
    """Blocks within BLOCKS_RTOL of the JAX run's ``want``."""
    if abs(blocks - want) > BLOCKS_RTOL * want:
        fail(f"{label}: {blocks} blocks, not within "
             f"{100 * BLOCKS_RTOL:.1f} % of the JAX run's {want}")


def check_launched(label, counts, integrated):
    """The fusion kernels launched at least once per integrated frame."""
    counts = {k: n for k, n in counts.items() if k in FUSION}
    n = sum(counts.values())
    print(f"# {label}: fusion LAUNCHES {counts} over {integrated} "
          "integrated frames")
    if integrated == 0 or n < integrated:
        fail(f"{label}: {n} fusion launches < {integrated} integrated "
             "frames: the path did not go through the kernel")


def write_sequence(tmp, depths, poses):
    """The cached frames as ``seq.raw`` and ``seq.gt`` in ``tmp``, written
    with the port's io."""
    from supereight_tpu_torch.io import groundtruth, raw
    w = raw.RawWriter(os.path.join(tmp, "seq.raw"), depths.shape[2],
                      depths.shape[1])
    for d in depths:
        w.write(d)
    w.close()
    groundtruth.write_poses(os.path.join(tmp, "seq.gt"), poses)
    return os.path.join(tmp, "seq.raw"), os.path.join(tmp, "seq.gt")


def app_phase(torch, label, argv, poses, tmp, icp=False):
    """``apps.benchmark`` over the sequence with ``argv``, its kernel
    counts set to 0 just before: returns the run's figures from its TSV
    log, its state and its last images, and its counts.  With ``icp`` the
    run tracks every frame with ICP, every trip through the kernels."""
    from supereight_tpu_torch.apps import benchmark
    log = os.path.join(tmp, label + ".tsv")
    reset_launches()
    t0 = time.perf_counter()
    with counting_raycasts() as raycasts:
        r = benchmark.run(argv + ["-q", "-o", log, "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = launches()
    from supereight_tpu_torch.io import native
    print(f"# {label}: the .raw reader is {type(r.reader).__module__}."
          f"{type(r.reader).__name__}")
    if not isinstance(r.reader, native.NativeRawReader):
        fail(f"{label}: the app did not read through the native reader")
    rows = np.loadtxt(log, delimiter="\t", skiprows=1, ndmin=2)
    st = r.system.state
    out = dict(rows=len(rows), tracked=int(rows[:, 12].sum()),
               integrated=int(rows[:, 13].sum()),
               ate=ate_rmse(np.stack(r.est_poses), poses[:len(r.est_poses)]),
               blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
               ms=statistics.median(1e3 * rows[16:, 7]), wall=wall,
               images=r.images, system=r.system)
    print(f"# {label}: {out['rows']} TSV rows in {wall:.1f} s, tracked "
          f"{out['tracked']}, integrated {out['integrated']}, ATE "
          f"{100 * out['ate']:.4f} cm, blocks {out['blocks']}, overflow "
          f"{out['overflow']}; median computation {out['ms']:.2f} ms/frame "
          "after the first 16 frames")
    check_launched(label, counts, out["integrated"])
    check_raycast_launched(label, counts, raycasts[0])
    if icp:
        check_icp_launched(label, counts, icp_frames(r.system.config,
                                                     len(poses)))
    out["launches"] = counts
    if out["rows"] != len(poses):
        fail(f"{label}: {out['rows']} TSV rows for {len(poses)} frames")
    if out["overflow"]:
        fail(f"{label}: overflow {out['overflow']}")
    return out


def check_apps(torch, depths, poses, dev):
    """Phases A-C, the ground-truth mode and the app: the benchmark app in
    ground-truth mode (A) and ICP mode with the renderers every 4th frame
    (B) on the cached base sequence, written as a .raw stream and a TUM
    trajectory; then the facade in ground-truth mode at the configuration
    of the TPU record bench_data/ate_icp_256_gt.json (C).  Returns the
    fusion launches and the phases' figures."""
    import tempfile
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    total = dict.fromkeys(KERNEL_ORDER, 0)
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        rawp, gtp = write_sequence(tmp, depths, poses)
        a = app_phase(torch, "A app ground truth",
                      ["-i", rawp] + APP_ARGS + ["-c", "0", "-g", gtp],
                      poses, tmp)
        total = {k: total[k] + n for k, n in a["launches"].items()}
        print(f"# A: blocks {a['blocks']} (JAX on the CPU "
              f"{JAX_CPU_APP['gt_blocks']})")
        if a["tracked"] != len(poses):
            fail(f"A: tracked {a['tracked']} of {len(poses)} frames")
        if a["ate"] >= GT_MAX_ATE_M:
            fail(f"A: ATE {a['ate']:.3g} m >= {GT_MAX_ATE_M} m")
        check_blocks("A", a["blocks"], JAX_CPU_APP["gt_blocks"])

        b = app_phase(torch, "B app ICP",
                      ["-i", rawp] + APP_ARGS + APP_ICP_START, poses, tmp,
                      icp=True)
        total = {k: total[k] + n for k, n in b["launches"].items()}
        gate = JAX_CPU_APP["icp_ate_cm"] + APP_ICP_ATE_MARGIN_CM
        print(f"# B: ATE {100 * b['ate']:.2f} cm (JAX on the CPU "
              f"{JAX_CPU_APP['icp_ate_cm']}, gate {gate:.2f}), blocks "
              f"{b['blocks']} (JAX on the CPU {JAX_CPU_APP['icp_blocks']})")
        if b["tracked"] < MIN_TRACKED:
            fail(f"B: tracked {b['tracked']} < {MIN_TRACKED}")
        if 100 * b["ate"] > gate:
            fail(f"B: ATE {100 * b['ate']:.2f} cm > {gate:.2f} cm")
        if b["images"] is None:
            fail("B: the renderers did not run")
        depth_img, track_img, volume = b["images"]
        for name, img in zip(("depth", "track", "volume"), b["images"]):
            if img.dtype != torch.uint8 or tuple(img.shape) != (240, 320, 4):
                fail(f"B: render{name} gave {img.dtype} "
                     f"{tuple(img.shape)}, not uint8 (240, 320, 4)")
        shaded = float((volume[..., :3].amax(-1) > 0).float().mean())
        print(f"# B: the last renderVolume shades {shaded:.3f} of the "
              "pixels")
        if shaded < MIN_SHADED:
            fail(f"B: renderVolume shades only {shaded:.3f} of the pixels")

    cfg = SlamConfig(**BASE, integration_rate=1)
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    reset_launches()
    t0 = time.perf_counter()
    est, integrated = [], 0
    with counting_raycasts() as raycasts:
        for f in range(len(depths)):
            st = slam.step(depths[f], K, f, gt_pose=poses[f])
            integrated += st.integrated
            est.append(st.pose.cpu().numpy())
    wall = time.perf_counter() - t0
    counts = launches()
    check_raycast_launched("C", counts, raycasts[0])
    total = {k: total[k] + n for k, n in counts.items()}
    c = dict(blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
             ate=ate_rmse(np.stack(est), poses))
    print(f"# C facade ground truth (SDF, volume normals, every frame "
          f"fused and raycast, no budget, capacity 6144), "
          f"{len(depths)} frames in {wall:.1f} s: blocks {c['blocks']} "
          f"(JAX on the CPU {JAX_CPU_APP['facade_gt_blocks']}, TPU record "
          f"{TPU_GT_BLOCKS}), overflow {c['overflow']}, ATE "
          f"{c['ate']:.3g} m")
    check_launched("C", counts, integrated)
    check_blocks("C", c["blocks"], JAX_CPU_APP["facade_gt_blocks"])
    if c["overflow"] or c["ate"] >= GT_MAX_ATE_M:
        fail(f"C: overflow {c['overflow']}, ATE {c['ate']:.3g} m")
    for name, r in (("A", a), ("B", b), ("C", c)):
        figures[name] = {k: v for k, v in r.items()
                         if k not in ("images", "system", "launches")}
    return total, figures


def check_runner(torch, dev):
    """Phase D: ``apps.runner.run`` on the synthetic room at 256^3, its 120
    frames rendered by the port's sphere trace on the card; the trace is
    timed on its own first."""
    import tempfile
    from supereight_tpu_torch.apps import runner
    from supereight_tpu_torch.io import synthetic
    from supereight_tpu_torch.probes.timing import device_times_ms

    spec = runner.DATASETS["synthetic-room"]
    H, W = spec["hw"]
    pose = torch.from_numpy(synthetic.orbit_poses(spec["n_frames"],
                                                  spec["volume"])[60]).to(dev)
    k = torch.tensor([synthetic.DEFAULT_K[0] * W / 320.0,
                      synthetic.DEFAULT_K[1] * H / 240.0, W / 2.0, H / 2.0],
                     device=dev)
    trace = lambda: synthetic.render_depth(pose, k, spec["volume"], H, W)
    dev_ms = statistics.median(device_times_ms(trace, TRACE_RUNS))
    t0 = time.perf_counter()
    for _ in range(TRACE_RUNS):
        trace()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TRACE_RUNS
    print(f"# D: sphere trace ({H}x{W}, 160 steps) {dev_ms:.2f} ms a frame "
          f"of device time (CUDA events, median of {TRACE_RUNS}), "
          f"{host_ms:.2f} ms a frame on the host clock")
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp, counting_raycasts() as calls:
        t0 = time.perf_counter()
        res = runner.run("synthetic-room", resolution=256, out=tmp,
                         device=dev)
        wall = time.perf_counter() - t0
        passes = [""] + (["regime_rerun"] if "auto_regime" in res else [])
        logs = [np.loadtxt(os.path.join(tmp, p, "benchmark.log"),
                           delimiter="\t", skiprows=1, ndmin=2)
                for p in passes]
        integrated = int(logs[-1][:, 13].sum())
        # the runner tracks every frame of each pass with ICP
        icp_runs = sum(len(rows) for rows in logs)
    gate = JAX_CPU_APP["runner_ate_cm"] + RUNNER_ATE_MARGIN_CM
    print(f"# D runner synthetic-room 256^3, {res['frames']} frames in "
          f"{wall:.1f} s: tracked {res['tracked_ratio']} (JAX on the CPU "
          f"{JAX_CPU_APP['runner_tracked']}), ATE "
          f"{100 * res['ate_rmse_m']:.2f} cm (JAX on the CPU "
          f"{JAX_CPU_APP['runner_ate_cm']}, gate {gate:.2f}), RPE "
          f"{1e3 * res['rpe_trans_rmse_m']:.2f} mm / "
          f"{res['rpe_rot_rmse_deg']:.3f} deg, rerun "
          f"{res.get('auto_regime', 'none')}")
    check_launched("D", launches(), integrated)
    check_icp_launched("D", launches(), icp_runs)
    check_raycast_launched("D", launches(), calls[0])
    if res["tracked_ratio"] < RUNNER_MIN_TRACKED:
        fail(f"D: tracked ratio {res['tracked_ratio']} < "
             f"{RUNNER_MIN_TRACKED}")
    if 100 * res["ate_rmse_m"] > gate:
        fail(f"D: ATE {100 * res['ate_rmse_m']:.2f} cm > {gate:.2f} cm")
    return launches(), dict(trace_ms=dev_ms, trace_host_ms=host_ms,
                            wall=wall, **res)


def timed_mesh(torch, slam):
    """``marching_cubes`` over the system's map as ``dump_mesh`` runs it:
    (triangles, CUDA-event ms, host-clock ms)."""
    from supereight_tpu_torch.core import meshing
    field = slam.field
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    tris = meshing.marching_cubes(slam.state.map, field.select_channel,
                                  inside=field.is_inside)
    end.record()
    torch.cuda.synchronize()
    return tris, start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def same_tables(torch, a, b, n=None) -> bool:
    """Whether two maps hold the same blocks (block index, counter, keys)
    and voxel tables bit for bit: the first ``n`` slots if given (a
    reference binary keeps no ``active`` flags and no empty slots), else
    every table of the map, the node pyramid included."""
    cut = (lambda t: t) if n is None else (lambda t: t[:n])
    same = torch.equal(a.block_index, b.block_index) and \
        torch.equal(a.n_blocks, b.n_blocks) and \
        torch.equal(cut(a.keys), cut(b.keys)) and \
        all(torch.equal(cut(a.voxels[k]), cut(b.voxels[k]))
            for k in a.voxels)
    if n is None:
        same = same and torch.equal(a.active, b.active) and \
            torch.equal(a.overflow, b.overflow) and \
            all(torch.equal(x, y) for x, y in zip(a.node_alloc, b.node_alloc)) \
            and all(torch.equal(x[k], y[k]) for x, y in
                    zip(a.node_values, b.node_values) for k in x)
    return same


def check_map_outputs(torch, depths, poses, dev):
    """Phase E: the app in ground-truth mode with ``-d`` and
    ``--dump-mesh``, then the mesh, the checkpoint and the reference binary
    held as the docstring says.  Returns the fusion launches and the
    figures."""
    import tempfile
    from supereight_tpu_torch.core import meshing
    from supereight_tpu_torch.io import serialise, vtk

    with tempfile.TemporaryDirectory() as tmp:
        rawp, gtp = write_sequence(tmp, depths, poses)
        npz, vtk_path, se_path = (os.path.join(tmp, f) for f in
                                  ("E.npz", "E.vtk", "E.bin"))
        e = app_phase(torch, "E app map outputs",
                      ["-i", rawp] + APP_ARGS + ["-c", "0", "-g", gtp,
                                                 "-d", npz,
                                                 "--dump-mesh", vtk_path],
                      poses, tmp)
        counts = e.pop("launches")
        slam = e.pop("system")
        m = slam.state.map
        with open(vtk_path) as f:
            dumped = int(next(ln for ln in f
                              if ln.startswith("POLYGONS")).split()[1])
        tris, dev_ms, host_ms = timed_mesh(torch, slam)
        t0 = time.perf_counter()
        vtk.write_vtk_mesh(os.path.join(tmp, "again.vtk"), tris)
        vtk_ms = 1e3 * (time.perf_counter() - t0)
        want = JAX_CPU_APP["gt_triangles"]
        print(f"# E: {e['blocks']} blocks, mesh of {tris.shape[0]} "
              f"triangles (the app's file {dumped}; JAX on the CPU {want}): "
              f"marching_cubes {dev_ms:.2f} ms (CUDA events), "
              f"{host_ms:.2f} ms (host clock); VTK write {vtk_ms:.1f} ms")
        if tris.shape[0] != dumped or not bool(torch.isfinite(tris).all()):
            fail(f"E: the mesh ({tris.shape[0]} triangles) is not finite or "
                 f"differs from the app's file ({dumped})")
        if abs(dumped - want) > BLOCKS_RTOL * want:
            fail(f"E: {dumped} triangles, not within "
                 f"{100 * BLOCKS_RTOL:.1f} % of the JAX run's {want}")

        # the first MESH_HOLD_BLOCKS live blocks on the card and on the CPU
        n_hold = min(int(m.n_blocks), MESH_HOLD_BLOCKS)
        sub = m.replace(n_blocks=torch.tensor(n_hold, dtype=torch.int32,
                                              device=dev))
        on_card = meshing.marching_cubes(sub, slam.field.select_channel,
                                         inside=slam.field.is_inside)
        cpu = sub.replace(
            block_index=sub.block_index.cpu(), keys=sub.keys.cpu(),
            n_blocks=sub.n_blocks.cpu(), active=sub.active.cpu(),
            overflow=sub.overflow.cpu(),
            voxels={k: v.cpu() for k, v in sub.voxels.items()},
            node_values=[{k: v.cpu() for k, v in lv.items()}
                         for lv in sub.node_values],
            node_alloc=[a.cpu() for a in sub.node_alloc])
        on_cpu = meshing.marching_cubes(cpu, slam.field.select_channel,
                                        inside=slam.field.is_inside)
        same = on_card.shape == on_cpu.shape and \
            torch.equal(on_card.cpu(), on_cpu)
        err = float((on_card.cpu() - on_cpu).abs().max()) \
            if on_card.shape == on_cpu.shape else float("inf")
        print(f"# E: the first {n_hold} live blocks meshed on the card "
              f"({on_card.shape[0]} triangles) and on the CPU "
              f"({on_cpu.shape[0]}): equal bit for bit {same}, max abs err "
              f"{err:.3g} m")
        if not same:
            fail("E: the card's mesh differs from the CPU's")

        loaded = serialise.load_map(npz, device=dev)
        same_ckpt = same_tables(torch, loaded, m)
        serialise.save_se(se_path, m)
        back = serialise.load_se(se_path, slam.field.channels,
                                 capacity=m.capacity, device=dev)
        n = int(m.n_blocks)
        same_se = same_tables(torch, back, m, n)
        print(f"# E: load_map of the checkpoint ({os.path.getsize(npz)} B) "
              f"equals the live map bit for bit: {same_ckpt}; save_se -> "
              f"load_se on the card ({os.path.getsize(se_path)} B) gives "
              f"back its {n} blocks, slots and voxel tables: {same_se}")
        if not (same_ckpt and same_se):
            fail("E: a checkpoint does not give back the live map")
    check_launched("E", counts, e["integrated"])
    return counts, dict(e, triangles=int(tris.shape[0]), mesh_ms=dev_ms,
                        mesh_host_ms=host_ms, vtk_ms=vtk_ms)


def mesh_whole_map(torch, name, slam, dev):
    """``marching_cubes`` over a preset's whole map on the card: blocks,
    triangles, device and host time, and the peak device memory over what
    the run's state already held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tris, dev_ms, host_ms = timed_mesh(torch, slam)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"# {name}: marching_cubes over the whole map, "
          f"{int(slam.state.map.n_blocks)} blocks -> {tris.shape[0]} "
          f"triangles: {dev_ms:.1f} ms (CUDA events), {host_ms:.1f} ms "
          f"(host clock); peak device memory {peak / 2 ** 30:.2f} GiB "
          f"({held / 2 ** 30:.2f} GiB held before)")
    if tris.shape[0] == 0 or not bool(torch.isfinite(tris).all()):
        fail(f"{name}: the whole map's mesh is empty or not finite")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(card())
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    for need in (FRAMES, os.path.join(HERE, "supereight_tpu_torch")):
        if not os.path.exists(need):
            fail(f"{need} is missing: run from the root of a checkout")
    depths, poses = load_sequence("synthetic_256_frames")

    build_kernels()
    kernels = check_icp_kernels(torch, depths, poses, dev)
    kernels.update(check_glue_kernels(torch, depths, poses, dev))
    kernels.update(check_raycast_kernels(torch, depths, poses, dev))
    kernels.update({
        "fuse_sdf": check_fusion_kernel(torch, "fuse_sdf", "headline", 6,
                                        depths, poses, dev),
        "fuse_ofusion": check_fusion_kernel(torch, "fuse_ofusion", "ofusion",
                                            8, depths, poses, dev)})
    kernels.update(check_probe_kernels(torch, dev))
    app_launches, _ = check_apps(torch, depths, poses, dev)
    runner_launches, _ = check_runner(torch, dev)
    map_launches, _ = check_map_outputs(torch, depths, poses, dev)
    for counts in (app_launches, runner_launches, map_launches):
        for k, n in counts.items():
            kernels[k]["launches"] += n
    for name in RUNS:
        run_preset(torch, name, dev, kernels)
    run_phase_f(torch, dev, kernels)
    run_phase_g(torch, dev, kernels)
    print(f"# all runs done in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [kernels[k] for k in KERNEL_ORDER]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
